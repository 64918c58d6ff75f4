#!/usr/bin/env python3
"""Time the port's correlation kernels on one CUDA card.

    python3 time_corr_kernels.py [--root DIR] [--kernels flash,pallas]
                                 [--out record.json]

Times the kernels of the ``dexiraft_tpu_torch`` package under ``--root`` (a
checkout of this repository; by default the one holding this script):

  flash   B1 ``flash_fused_step`` and B2 ``flash_local_corr_level`` (every
          level) at v1's kernel batch 1 and v5's kernel batch 2 (one pair's
          image and edge stream);
  pallas  B3 ``pallas_fused_step`` and B4 ``pallas_local_corr_level``
          (every level) at v5's kernel batch 2.

Shapes: the Sintel bucket's 55x128 query grid, C=F=256, 4 levels, r=4; a
lookup level gets its coords in level pixels, as the model passes them.
Each field of chip_smoke's ``make_coords`` (jitter, smooth, scattered,
edge) and each storage dtype gets the same inputs from the same seed
whichever checkout is timed, so two checkouts run in one call compare like
with like (run them in turns: A, B, B, A). Three times per kernel: CUDA
events around 10 back-to-back calls (median of 10; what a caller waits, the
Python wrapper included), the device time of the kernel alone from
torch.profiler over 10 calls, and the host time of one call (wall time of
50 calls enqueued without a synchronise, which never fill the launch
queue). Prints one JSON line per (batch, field, dtype), then the
nvidia-smi line, then a summary line. Needs a card: it fails without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIELDS = ("jitter", "smooth", "scattered", "edge")
DTYPES = ("fp32", "bf16", "int8")
# kernel family -> (kernel batches, fused wrapper, lookup wrapper, profiler
# key, record prefixes of the fused and the lookup kernel)
FAMILIES = {
    "flash": ((1, 2), "flash_fused_step", "flash_local_corr_level", "flash_",
              "b1", "b2"),
    "pallas": ((2,), "pallas_fused_step", "pallas_local_corr_level",
               "pallas_", "b3", "b4"),
}


def load_smoke():
    """chip_smoke.py beside this script: the inputs and the event timer."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_us(torch, fn, key: str, calls: int = 10) -> float:
    """Device time per call of the kernels whose name holds ``key``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and key in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / calls


def host_us(torch, fn, calls: int = 50) -> float:
    """Wall time per call of enqueueing ``calls`` calls (no synchronise
    between them): the host's cost of one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_family(torch, ck, cs, dev, family, b, field, dtype, seed, rec):
    """Events, device and host time of one family's fused kernel and of its
    lookup at every level, into ``rec``."""
    _, fused_name, lookup_name, key, fp, lp = FAMILIES[family]
    fused, lookup = getattr(ck, fused_name), getattr(ck, lookup_name)
    h, w, c, levels, r, feat = 55, 128, 256, 4, 4, 256
    gen = torch.Generator(device=dev).manual_seed(seed)
    pyr, co, weight, bias = cs.make_inputs(gen, b, h, w, c, levels, r, feat,
                                           dtype, dev, field=field)
    fmap1, lv = pyr.fmap1, pyr.fmap2_pyramid

    def one(prefix, fn):
        rec[f"{prefix}_us"] = 1e3 * cs.cuda_time_ms(fn, reps=10, inner=10)
        rec[f"{prefix}_device_us"] = device_us(torch, fn, key)
        rec[f"{prefix}_host_us"] = host_us(torch, fn)

    one(fp, lambda: fused(fmap1, lv, co, weight, bias, r))
    for lvl, f2 in enumerate(lv):
        c_l = co / 2.0 ** lvl
        one(f"{lp}_level{lvl}", lambda: lookup(fmap1, f2, c_l, r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose dexiraft_tpu_torch is timed")
    ap.add_argument("--kernels", default="flash,pallas",
                    help="comma-separated kernel families: flash, pallas")
    ap.add_argument("--out", default=None, help="also write the records here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    families = [f for f in args.kernels.split(",") if f]
    unknown = sorted(set(families) - set(FAMILIES))
    if unknown:
        ap.error(f"unknown kernel families {unknown}; expected {sorted(FAMILIES)}")

    import torch

    if not torch.cuda.is_available():
        print("time_corr_kernels: FAILED: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from dexiraft_tpu_torch.ops import corr_kernels as ck

    if not os.path.abspath(ck.__file__).startswith(root + os.sep):
        print(f"time_corr_kernels: FAILED: imported {ck.__file__}, not the "
              f"package under {root}", file=sys.stderr)
        return 1
    cs = load_smoke()
    ck.build_kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    records = []
    for b in (1, 2):
        for fi, field in enumerate(FIELDS):
            for di, dtype in enumerate(DTYPES):
                rec = {"root": root, "field": field, "dtype": dtype,
                       "shape": [b, 55, 128, 256]}
                for family in families:
                    if b in FAMILIES[family][0]:
                        time_family(torch, ck, cs, dev, family, b, field,
                                    dtype, 1000 + 100 * b + 10 * fi + di, rec)
                if len(rec) > 4:
                    records.append(rec)
                    print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records}, f, indent=1)
    print(json.dumps({"ok": True, "root": root, "card": smi,
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
