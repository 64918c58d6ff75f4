"""Packed-dataset manifest: the JSON contract between packer and loader.

``manifest.json`` sits next to the shard files and is the only thing a
consumer needs to open a packed dataset:

  format / version     "dexiraft-records" / 1
  stage, image_size,   provenance: which fetch_dataset stage was packed,
  train_ds             at which crop recipe (train_cli cross-checks them
                       against the run's config before trusting the pack)
  num_records          distinct decoded samples across all shards
  num_samples          LOGICAL epoch length — repeats expanded, i.e.
                       len(fetch_dataset(...)) of the packed stage
  shards               [{file, records, bytes}] in record-id order;
                       record ids are contiguous across the list
  members              the mixture structure, in sample-index order:
                       [{name, records: [lo, hi), repeat, sparse,
                         aug: {crop_size, min_scale, max_scale, do_flip}
                         | null}] — enough to rebuild per-member
                       augmentors bit-identical to the raw stage's
  keys                 {name: {dtype, shape|null}} from the first record
                       (shape null when it varies across records)
  fingerprint          sha1 over the member structure + source file
                       basenames, so two packs of the same dataset tree
                       agree and a pack of a DIFFERENT tree is loudly
                       distinguishable in logs and bench records

The manifest is written atomically (tmp + rename) after every shard has
been closed, so a directory with a manifest is complete by construction.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import os.path as osp
from typing import Dict, List, Optional

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = "dexiraft-records"
MANIFEST_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    file: str
    records: int
    bytes: int


@dataclasses.dataclass(frozen=True)
class MemberInfo:
    name: str
    records: "tuple[int, int]"  # [lo, hi) record-id range
    repeat: int
    sparse: bool
    aug: Optional[dict]  # FlowAugmentor kwargs, None = no augmentation

    @property
    def n_raw(self) -> int:
        return self.records[1] - self.records[0]

    def __len__(self) -> int:
        return self.n_raw * self.repeat


@dataclasses.dataclass(frozen=True)
class Manifest:
    num_records: int
    num_samples: int
    shards: "tuple[ShardInfo, ...]"
    members: "tuple[MemberInfo, ...]"
    keys: Dict[str, dict]
    fingerprint: str
    stage: Optional[str] = None
    image_size: Optional["tuple[int, int]"] = None
    train_ds: Optional[str] = None

    def as_dict(self) -> dict:
        return {
            "format": MANIFEST_FORMAT,
            "version": MANIFEST_VERSION,
            "stage": self.stage,
            "image_size": (list(self.image_size)
                           if self.image_size is not None else None),
            "train_ds": self.train_ds,
            "num_records": self.num_records,
            "num_samples": self.num_samples,
            "shards": [dataclasses.asdict(s) for s in self.shards],
            "members": [{
                "name": m.name, "records": list(m.records),
                "repeat": m.repeat, "sparse": m.sparse, "aug": m.aug,
            } for m in self.members],
            "keys": self.keys,
            "fingerprint": self.fingerprint,
        }


def dataset_fingerprint(entries: List[dict]) -> str:
    """sha1 over the flattened member structure. ``entries`` carries one
    dict per member: name, counts, repeat, sparse, and source-file
    basenames (not absolute paths — the same tree mounted elsewhere must
    fingerprint identically)."""
    blob = json.dumps(entries, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()


def save_manifest(records_dir: str, manifest: Manifest) -> str:
    path = osp.join(records_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest.as_dict(), f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_manifest(records_dir: str) -> Manifest:
    path = osp.join(records_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            raw = json.load(f)
    except OSError as e:
        raise FileNotFoundError(
            f"no record manifest at {path} — is {records_dir!r} a "
            f"directory produced by pack_records?") from e
    if raw.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{path}: not a {MANIFEST_FORMAT} manifest "
                         f"(format={raw.get('format')!r})")
    if raw.get("version") != MANIFEST_VERSION:
        raise ValueError(f"{path}: unsupported manifest version "
                         f"{raw.get('version')!r}")
    return Manifest(
        num_records=int(raw["num_records"]),
        num_samples=int(raw["num_samples"]),
        shards=tuple(ShardInfo(s["file"], int(s["records"]), int(s["bytes"]))
                     for s in raw["shards"]),
        members=tuple(MemberInfo(m["name"], tuple(m["records"]),
                                 int(m["repeat"]), bool(m["sparse"]),
                                 m.get("aug"))
                      for m in raw["members"]),
        keys=raw["keys"],
        fingerprint=raw["fingerprint"],
        stage=raw.get("stage"),
        image_size=(tuple(raw["image_size"])
                    if raw.get("image_size") else None),
        train_ds=raw.get("train_ds"),
    )
