#!/usr/bin/env python3
"""Time the port's B3/B4 correlation kernels on one CUDA card.

    python3 time_corr_kernels.py [--root DIR] [--out record.json]

Times ``pallas_fused_step`` (B3) and ``pallas_local_corr_level`` (B4, every
level) of the ``dexiraft_tpu_torch`` package under ``--root`` (a checkout
of this repository; by default the one holding this script) at v5's kernel
shapes: batch 2 (one pair's image and edge stream), the Sintel bucket's
55x128 query grid, C=F=256, 4 levels, r=4. Each field of chip_smoke's
``make_coords`` (jitter, smooth, scattered, edge) and each storage dtype
gets the same inputs from the same seed whichever checkout is timed, so two
checkouts run in one call compare like with like (run them in turns: A, B,
B, A). Three times per kernel: CUDA events around 10 back-to-back calls
(median of 10; what a caller waits, the Python wrapper included), the
device time of the kernel alone from torch.profiler over 10 calls, and the
host time of one call (wall time of 50 calls enqueued without a
synchronise, which never fill the launch queue). B2
``flash_local_corr_level``, the same wrapper on another kernel, is timed
beside B4 by events as a control. Prints
one JSON line per (field, dtype), then the nvidia-smi line, then a summary
line. Needs a card: it fails without one.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose dexiraft_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="also write the records here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

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
    b, h, w, c, levels, r, feat = 2, 55, 128, 256, 4, 4, 256
    records = []
    for fi, field in enumerate(FIELDS):
        for di, dtype in enumerate(DTYPES):
            gen = torch.Generator(device=dev).manual_seed(1000 + 10 * fi + di)
            pyr, co, weight, bias = cs.make_inputs(gen, b, h, w, c, levels, r,
                                                   feat, dtype, dev,
                                                   field=field)
            fmap1, lv = pyr.fmap1, pyr.fmap2_pyramid

            def b3():
                ck.pallas_fused_step(fmap1, lv, co, weight, bias, r)

            rec = {"root": root, "field": field, "dtype": dtype,
                   "shape": [b, h, w, c],
                   "b3_us": 1e3 * cs.cuda_time_ms(b3, reps=10, inner=10),
                   "b3_device_us": device_us(torch, b3, "pallas_"),
                   "b3_host_us": host_us(torch, b3)}
            for lvl, f2 in enumerate(lv):
                c_l = co / 2.0 ** lvl

                def b4():
                    ck.pallas_local_corr_level(fmap1, f2, c_l, r)

                rec[f"b4_us_level{lvl}"] = 1e3 * cs.cuda_time_ms(
                    b4, reps=10, inner=10)
                rec[f"b4_device_us_level{lvl}"] = device_us(torch, b4,
                                                            "pallas_")
                rec[f"b4_host_us_level{lvl}"] = host_us(torch, b4)
                rec[f"b2_us_level{lvl}"] = 1e3 * cs.cuda_time_ms(
                    lambda: ck.flash_local_corr_level(fmap1, f2, c_l, r),
                    reps=10, inner=10)
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
