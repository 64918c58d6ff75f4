"""Offline packer CLI: fetch_dataset stage -> packed-record directory.

  python -m dexiraft_tpu_torch pack_records --stage chairs \\
      --out /data/records/chairs [--image_size 368 496] [--shards 16] \\
      [--train_ds C+T+K+S+H] [--verify]
  python -m dexiraft_tpu_torch pack_records --verify_only \\
      --out /data/records/chairs

The port's counterpart of the JAX package's ``scripts/pack_records.py``,
with the same flags. Decodes every distinct raw sample of a training
stage ONCE and writes the sharded record files + manifest that
``train --records_dir`` and ``data.records.RecordLoader`` consume. The
pack is byte for byte the one the JAX package writes from the same tree
(up to the zip timestamps np.savez stamps), and either package trains
from the other's. Curriculum replication factors stay symbolic in the
manifest, so the sintel mixture's 2.6 M logical epoch packs only its
distinct decodes.

--verify re-reads every record of every shard against the manifest
(CRC, counts, member ranges, dtypes) and exits nonzero on any mismatch
— run it after packing to a new filesystem before training from it.
--verify_only skips packing and just audits an existing directory.

Dataset roots come from DEXIRAFT_DATA_DIR exactly like training; no
torch import anywhere on this path, so it runs on any CPU box near the
data.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("dexiraft-torch-pack-records")
    ap.add_argument("--stage",
                    choices=["chairs", "things", "sintel", "kitti"],
                    help="fetch_dataset stage to pack (omit with "
                         "--verify_only)")
    ap.add_argument("--out", required=True,
                    help="output records directory (shards + manifest.json)")
    ap.add_argument("--image_size", type=int, nargs=2, default=None,
                    help="crop recipe to bake into the pack's augmentor "
                         "params (default: the stage's training default "
                         "from config.STANDARD_STAGES)")
    ap.add_argument("--train_ds", default=None,
                    help="sintel-stage mixture selector (default: "
                         "datasets.DEFAULT_TRAIN_DS — the one train trains "
                         "with; NOTE: train --records_dir REFUSES sintel "
                         "packs made with any other selector)")
    ap.add_argument("--shards", type=int, default=8,
                    help="shard-file count (clamped to the record count)")
    ap.add_argument("--verify", action="store_true",
                    help="after packing, re-read every shard against the "
                         "manifest; nonzero exit on any mismatch")
    ap.add_argument("--verify_only", action="store_true",
                    help="skip packing; audit an existing --out directory")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    from dexiraft_tpu_torch.data.records import pack_dataset, verify_records

    if not args.verify_only:
        if args.stage is None:
            ap.error("--stage is required unless --verify_only")
        # the defaults come from the SAME source train trains with, so a
        # default pack always passes its provenance gate
        from dexiraft_tpu_torch.config import STANDARD_STAGES
        from dexiraft_tpu_torch.data.datasets import (DEFAULT_TRAIN_DS,
                                                      fetch_dataset)

        train_ds = args.train_ds or DEFAULT_TRAIN_DS
        if args.stage == "sintel" and train_ds != DEFAULT_TRAIN_DS:
            # say it BEFORE the hours of decoding, not after the pack
            # is refused at train time
            print(f"[pack] WARNING: train_ds={train_ds!r} differs from "
                  f"the default {DEFAULT_TRAIN_DS!r} — train "
                  f"--records_dir will refuse this sintel pack "
                  f"(provenance gate); it remains usable for offline "
                  f"tooling only", file=sys.stderr)
        image_size = tuple(args.image_size or next(
            tc.image_size for tc in STANDARD_STAGES
            if tc.stage == args.stage))
        dataset = fetch_dataset(args.stage, image_size, train_ds=train_ds)
        t0 = time.perf_counter()
        last = [0.0]

        def progress(done: int, total: int) -> None:
            now = time.perf_counter()
            if now - last[0] > 10 or done == total:
                last[0] = now
                print(f"[pack] {done}/{total} records "
                      f"({done / (now - t0):.1f} rec/s)", flush=True)

        manifest = pack_dataset(
            dataset, args.out, num_shards=args.shards, stage=args.stage,
            image_size=image_size, train_ds=train_ds,
            progress=progress)
        dt = time.perf_counter() - t0
        nbytes = sum(s.bytes for s in manifest.shards)
        print(f"[pack] {manifest.num_records} records "
              f"({manifest.num_samples} logical samples) -> "
              f"{len(manifest.shards)} shard(s), {nbytes / 1e6:.1f} MB "
              f"in {dt:.1f}s; fingerprint {manifest.fingerprint[:12]} "
              f"-> {args.out}")

    if args.verify or args.verify_only:
        problems = verify_records(args.out)
        if problems:
            for p in problems:
                print(f"[verify] FAIL: {p}", file=sys.stderr)
            print(f"[verify] {len(problems)} problem(s) in {args.out}",
                  file=sys.stderr)
            return 1
        print(f"[verify] OK: every shard matches the manifest in "
              f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
