#!/usr/bin/env python3
"""How cuDNN's algorithm pick moves the v1 train step on one CUDA card.

    python3 train_conv_picks.py [--rounds 1] [--out record.json]

The train step's convolutions (v1 on B1, ``--corr_impl flash
--fused_update``, the chairs preset at 368x496, batch 10, 12 iterations,
seed-0 weights, a seeded random batch) under three picks, each in a
process of its own (cuDNN keeps its picks per process), in the order
search, mode B, instant, mode B, search:

  * ``search``: cuDNN times its deterministic algorithms at the first
    call of each shape (``train.step.eval_arithmetic``, the train step's
    arithmetic until C13 was closed);
  * ``mode_b``: the untimed pick by cuDNN's mode-B heuristic
    (``train.step.train_arithmetic`` as the package sets it);
  * ``instant``: the untimed pick by cuDNN's default (instant) heuristic
    (``TORCH_CUDNN_USE_HEURISTIC_MODE_B=0``).

For each: the first step's seconds (the search, where there is one), ms
per step (CUDA events, median of 5 after 2 more), the losses, and one
profiled step's ten convolution calls with the most device time (op,
input shapes, calls, ms) and its ten kernels with the most. One JSON line
per process, then the card's name and power limit. Needs a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
ORDER = ("search", "mode_b", "instant", "mode_b", "search")

CHILD = r"""
import dataclasses, json, statistics, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import dexiraft_tpu_torch.train.step as step_mod
from dexiraft_tpu_torch.config import STANDARD_STAGES, raft_v1
from dexiraft_tpu_torch.models.raft import create_model
from dexiraft_tpu_torch.ops import corr_kernels as ck
from dexiraft_tpu_torch.train.state import create_state

pick = sys.argv[1]
if pick == "search":
    step_mod.train_arithmetic = step_mod.eval_arithmetic
ck.build_kernels()
dev = torch.device("cuda:0")
tc = dataclasses.replace(STANDARD_STAGES[0], iters=12)
cfg = raft_v1(corr_impl="flash", fused_update=True)
g = torch.Generator(device=dev).manual_seed(1)
h, w, b = 368, 496, tc.batch_size
batch = {"image1": torch.rand(b, h, w, 3, generator=g, device=dev) * 255,
         "image2": torch.rand(b, h, w, 3, generator=g, device=dev) * 255,
         "flow": torch.randn(b, h, w, 2, generator=g, device=dev) * 4,
         "valid": torch.ones(b, h, w, device=dev)}
state = create_state(cfg, tc, device=dev,
                     model=create_model(cfg, seed=0, device=dev))
step = step_mod.make_train_step(cfg, tc)
t0 = time.perf_counter()
losses = [float(step(state, batch)[1]["loss"])]
first_s = time.perf_counter() - t0
for _ in range(2):
    losses.append(float(step(state, batch)[1]["loss"]))
times = []
for _ in range(5):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    m = step(state, batch)[1]
    e.record()
    torch.cuda.synchronize()
    times.append(s.elapsed_time(e))
    losses.append(float(m["loss"]))
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
             record_shapes=True) as prof:
    step(state, batch)
    torch.cuda.synchronize()


def dev_ms(e, total):
    name = "device_time_total" if total else "self_device_time_total"
    old = "cuda_time_total" if total else "self_cuda_time_total"
    return getattr(e, name, getattr(e, old, 0.0)) / 1e3


convs = sorted(
    ([dev_ms(e, True), e.key, e.count, str(e.input_shapes)[:120]]
     for e in prof.key_averages(group_by_input_shape=True)
     if e.device_type == DeviceType.CPU
     and e.key in ("aten::cudnn_convolution", "aten::convolution_backward")),
    reverse=True)[:10]
kernels = sorted(([dev_ms(e, False), e.key[:100], e.count]
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)[:10]
print(json.dumps({"pick": pick, "first_step_s": first_s,
                  "ms_per_step": statistics.median(times), "ms": times,
                  "losses": losses, "top_convs_ms": convs,
                  "top_kernels_ms": kernels}), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1,
                    help="times through the search/mode_b/instant order")
    ap.add_argument("--out", default=None,
                    help="also write every record to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_conv_picks: needs a CUDA card", file=sys.stderr)
        return 1
    records = []
    for _ in range(args.rounds):
        for pick in ORDER:
            env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""),
                       TORCH_CUDNN_USE_HEURISTIC_MODE_B=(
                           "0" if pick == "instant" else "1"))
            out = subprocess.run([sys.executable, "-c", CHILD, pick],
                                 cwd=REPO, env=env, capture_output=True,
                                 text=True, timeout=600)
            if out.returncode:
                print(f"train_conv_picks: {pick} exited {out.returncode}: "
                      f"{out.stderr[-3000:]}", file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            records.append(rec)
            print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "records": records}, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
