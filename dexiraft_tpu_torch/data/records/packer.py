"""Offline packer: any fetch_dataset stage -> shard files + manifest.

Packing walks the stage's mixture structure member by member and writes
each DISTINCT raw sample exactly once — curriculum replication factors
(``100 * clean`` etc.) stay in the manifest as per-member ``repeat``
entries, so a stage whose logical epoch is 2.6 M samples packs only the
~20 k distinct decodes behind it. What goes into a record is the output
of ``FlowDataset._load_raw``: the DECODED arrays (uint8 images, float32
flow, sparse valid) with augmentation still unapplied — augmentation is
per-(seed, epoch, index) and must keep drawing fresh per epoch, so it
stays in the loader's worker pool where the raw path runs it too. That
split is what makes pack->read bit-exact: RecordDataset rebuilds the
same augmentors from the manifest and replays the same RNG stream over
byte-identical raw arrays.

``verify_records`` is the packer's trust-but-verify pass: re-read every
record of every shard (CRC-checked), cross-check per-shard counts,
totals, member ranges, and key dtypes against the manifest. The CLI
(``python -m dexiraft_tpu_torch pack_records --verify``) exits nonzero
on any mismatch, so a pack that survives it is safe to train from.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, List, Optional

from dexiraft_tpu_torch.data.datasets import ConcatFlowDataset, FlowDataset
from dexiraft_tpu_torch.data.records.format import (
    RecordCorruptError,
    RecordShardReader,
    RecordShardWriter,
)
from dexiraft_tpu_torch.data.records.manifest import (
    Manifest,
    MemberInfo,
    ShardInfo,
    dataset_fingerprint,
    load_manifest,
    save_manifest,
)

_AUG_FIELDS = ("crop_size", "min_scale", "max_scale", "do_flip")


def _flatten(ds) -> List[FlowDataset]:
    if isinstance(ds, ConcatFlowDataset):
        return [m for sub in ds.members for m in _flatten(sub)]
    return [ds]


def _member_aug(member: FlowDataset) -> Optional[dict]:
    if member.augmentor is None:
        return None
    a = member.augmentor
    return {"crop_size": list(a.crop_size), "min_scale": a.min_scale,
            "max_scale": a.max_scale, "do_flip": a.do_flip}


def _member_entries(members: List[FlowDataset]) -> List[dict]:
    entries = []
    for m in members:
        paths = [osp.basename(p) for pair in m.image_list for p in pair]
        paths += [osp.basename(p) for p in m.flow_list]
        # aug participates in the fingerprint: two packs of the same
        # tree at different crop recipes produce different sample
        # sequences, and the resume-time fingerprint check (stream
        # sidecar) must tell them apart
        entries.append({"name": type(m).__name__,
                        "n_raw": len(m.image_list), "repeat": m.repeat,
                        "sparse": m.sparse, "aug": _member_aug(m),
                        "files": paths})
    return entries


def shard_name(index: int, num_shards: int) -> str:
    return f"shard-{index:05d}-of-{num_shards:05d}.rec"


def pack_dataset(dataset, records_dir: str, num_shards: int = 1, *,
                 stage: Optional[str] = None,
                 image_size: Optional["tuple[int, int]"] = None,
                 train_ds: Optional[str] = None,
                 progress: Optional[Callable[[int, int], None]] = None,
                 ) -> Manifest:
    """Walk ``dataset`` (a FlowDataset or mixture) and write ``num_shards``
    shard files + manifest.json into ``records_dir``."""
    members = _flatten(dataset)
    for m in members:
        if not isinstance(m, FlowDataset):
            raise TypeError(f"cannot pack {type(m).__name__}: not a "
                            f"FlowDataset")
        if type(m).__name__ == "EdgePairDataset":
            raise NotImplementedError(
                "edge-paired stages carry a second image tree that "
                "_load_raw does not cover; pack the base stage and keep "
                "--edge_root on the raw loader")
        if m.is_test:
            raise ValueError("test-split datasets (extra_info, no flow) "
                             "are not packable — pack training stages")

    total = sum(len(m.image_list) for m in members)
    if total == 0:
        raise ValueError("dataset has no samples to pack")
    num_shards = max(1, min(int(num_shards), total))
    os.makedirs(records_dir, exist_ok=True)
    # drop any previous pack FIRST — the manifest before the shards:
    # the manifest is written last, so "manifest present => pack
    # complete" stays true even when a repack over an old directory
    # crashes halfway (the half-written shards are then unopenable as a
    # set, instead of being served under the stale manifest's counts
    # and fingerprint); stale shard files go too, so a repack at a
    # different --shards count can't leave old -of-NNNNN files that a
    # human globbing *.rec would mistake for part of this pack
    from glob import glob as _glob

    old_manifest = osp.join(records_dir, "manifest.json")
    if osp.exists(old_manifest):
        os.remove(old_manifest)
    for stale in _glob(osp.join(records_dir, "shard-*-of-*.rec")):
        os.remove(stale)

    per_shard = -(-total // num_shards)  # ceil
    # re-derive the count that per_shard actually produces, so the
    # -of-NNNNN in every file name is the true shard count (9 records
    # at --shards 4 packs 3 files of 3, never 3 files "of 4")
    num_shards = -(-total // per_shard)
    writers = []
    shard_infos: List[ShardInfo] = []
    member_infos: List[MemberInfo] = []
    keys: dict = {}
    try:
        record_id = 0
        shard_ix = -1
        writer = None
        for m in members:
            lo = record_id
            for i in range(len(m.image_list)):
                if record_id // per_shard != shard_ix:
                    shard_ix = record_id // per_shard
                    writer = RecordShardWriter(
                        osp.join(records_dir,
                                 shard_name(shard_ix, num_shards)))
                    writers.append(writer)
                raw = m._load_raw(i)
                if not keys:
                    first_shapes = {k: list(v.shape) for k, v in raw.items()}
                    keys = {k: {"dtype": str(v.dtype),
                                "shape": first_shapes[k]}
                            for k, v in raw.items()}
                else:
                    for k, v in raw.items():
                        spec = keys.setdefault(
                            k, {"dtype": str(v.dtype), "shape": None})
                        if spec["shape"] != list(v.shape):
                            spec["shape"] = None  # variable geometry
                writer.append(raw)
                record_id += 1
                if progress is not None:
                    progress(record_id, total)
            member_infos.append(MemberInfo(
                name=type(m).__name__, records=(lo, record_id),
                repeat=m.repeat, sparse=m.sparse, aug=_member_aug(m)))
    finally:
        for w in writers:
            w.close()

    shard_infos = [ShardInfo(osp.basename(w.path), w.num_records,
                             osp.getsize(w.path)) for w in writers]
    manifest = Manifest(
        num_records=total,
        num_samples=sum(len(m) for m in members),
        shards=tuple(shard_infos),
        members=tuple(member_infos),
        keys=keys,
        fingerprint=dataset_fingerprint(_member_entries(members)),
        stage=stage,
        image_size=tuple(image_size) if image_size is not None else None,
        train_ds=train_ds,
    )
    save_manifest(records_dir, manifest)
    return manifest


def verify_records(records_dir: str) -> List[str]:
    """Re-read every shard against the manifest; returns a list of
    human-readable problems (empty = the pack is sound)."""
    problems: List[str] = []
    try:
        manifest = load_manifest(records_dir)
    except (OSError, ValueError, KeyError) as e:
        return [f"manifest unreadable: {e}"]

    total = 0
    for info in manifest.shards:
        path = osp.join(records_dir, info.file)
        try:
            with RecordShardReader(path) as reader:
                n = len(reader)
                if n != info.records:
                    problems.append(
                        f"{info.file}: {n} records on disk, manifest "
                        f"says {info.records}")
                for i in range(n):
                    try:
                        sample = reader.read(i)
                    except RecordCorruptError as e:
                        problems.append(str(e))
                        continue
                    for k, v in sample.items():
                        spec = manifest.keys.get(k)
                        if spec is None:
                            problems.append(
                                f"{info.file} record {i}: key {k!r} "
                                f"absent from manifest keys")
                        elif spec["dtype"] != str(v.dtype):
                            problems.append(
                                f"{info.file} record {i}: key {k!r} is "
                                f"{v.dtype}, manifest says {spec['dtype']}")
                total += n
        except (OSError, RecordCorruptError) as e:
            problems.append(f"{info.file}: {e}")
    if total != manifest.num_records:
        problems.append(f"{total} records across shards, manifest says "
                        f"{manifest.num_records}")
    if manifest.members:
        hi = max(m.records[1] for m in manifest.members)
        covered = sum(m.n_raw for m in manifest.members)
        if hi != manifest.num_records or covered != manifest.num_records:
            problems.append(
                f"member ranges cover {covered} records ending at {hi}, "
                f"manifest says {manifest.num_records}")
    return problems
