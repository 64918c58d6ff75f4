#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out record.json]

Drives the port's paths on the card at full width with seeded random
weights: RAFT v1 and the v5 dual-stream Dexi-RAFT with its embedded
DexiNed through the bucketed InferenceEngine, v2, v3 and v4 through the
eval step, v5's convergence-gated loop, a v5 VideoEngine stream over
the encode/refine split, the flow service (scheduler, sessions, HTTP
server and its CLI) on v5's main path, and training (the train step at
the chairs geometry, the exact-GT demo, the train CLI with --resume). It
builds the
hand-written CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version (and each of the two
formulations against the other), shows from the launch counters that
each path went through its kernels, and times them. Imports nothing of
JAX or of the JAX package (dexiraft_tpu).

Phases, one JSON line each:
  1 device    nvidia-smi name and power limit, torch and CUDA versions
  2 build     the kernel libraries, one nvcc each, started together
  3 kernels   B1 flash_fused_step and B2 flash_local_corr_level against
              fused_reference / local_corr_level at the v1 shapes (B=1 and
              B=2, fp32/bf16/int8 storage, far out-of-frame coords, a
              degenerate level); B1 on a smooth field (every tile stages
              one f2 patch) and a scattered one (level-0 tiles read each
              pixel's lattice) at 55x128, B=1 and 2, against
              fused_reference and B3; B2 on the jitter field with NaN
              pixels and on the smooth, scattered and edge fields at every
              v1 case, against local_corr_level and B4 (NaN pixels and
              0-row levels exact zeros), with B2's staged boxes and
              per-pixel tiles per level; then B3 pallas_fused_step and B4
              pallas_local_corr_level at the v5 shapes (the same cases with
              the batch doubled, as the dual stream has it, and the 5x8
              map of a 40x64 image) against their plain versions and
              against B1 / B2, NaN coords included, on the jitter field
              and on the smooth, scattered and edge fields (clip limits,
              integer centers half out of the frame), with B3's and B4's
              TMA box sizes and per-pixel tiles per level; max abs error
              <= 1e-3, TF32 off
  4 slice v1  4 frame pairs (2 Sintel 436x1024, 2 KITTI 375x1242) through
              the engine at batch 2, 32 iterations: path "fused" (B1) and
              "lookup" (B2), launch counts set to 0 before and read after
              each; flow_low against the plain-lookup model on the same
              weights, <= 1e-2 px, TF32 off
  5 slice v5  the same requests through v5: paths "pallas_fused" (B3),
              "pallas_lookup" (B4) and "flash_fused" (B1), checked the
              same way
  conv_search the motion encoder's 3x3 convs at v5's loop batches with
              cuDNN's heuristic algorithm and with the eval step's
              algorithm search (run before any other convolution)
  conv_threads the same convs at batch 3: wall ms of the first and second
              call on the main thread, a fresh thread and a DeviceThread
              (cuDNN's search results are kept per thread)
  tf32        the eval step's arithmetic: flow_low of v1's and v5's main
              paths through make_eval_step with TF32 convolutions on
              (PyTorch's default flags) and off, and with the step's
              default, against the TF32-off plain-lookup path, <= 1e-2 px
              for the default; the global flags as they were
  variants    v2, v3 and v4 at batch 1 in the Sintel bucket (v2/v3 with
              seeded uint8 edge frames): B1's path against the plain path
              on the same weights, <= 1e-2 px, ITERS B1 launches, ms
  adaptive    v5 on B1, batch 2: the convergence-gated loop at tol 0
              against the fixed step (<= 1e-6 px), with damped weights
              each item against a fixed forward of its iters_used (<=
              1e-5 px), a budget of 8, B1's launches, ms, and the cost of
              the per-iteration host read of the done mask
  video       a v5 VideoEngine stream of 6 frames in two chunks: each
              flow against the pair forward with the same warm start
              (<= 1e-2 px), B1's launches, bytes per stream, ms per warm
              frame against the pair engine's per pair, and
              forward_interpolate on the card against the CPU
  serve       the flow service on v5's main path (B1), built by the
              CLI's builders (python -m dexiraft_tpu_torch serve):
              warm-up of the Sintel and KITTI buckets, then 8 client
              threads with 24 pair requests over HTTP, a session of 3
              chained requests (device carry) and a 3-frame
              /v1/flow/stream chunk at the same time; B1 launched ITERS x
              (batches + stream flows) and nothing else; HTTP flows
              against engine.run_batch, the warm request against the eval
              step on the splatted seed, the chunk against its solo run,
              <= 1e-2 px; global flags unchanged; no admitted request
              dropped on drain; requests/s, p50/p99 latency, fetch and
              dispatch seconds (and engine.stream at inflight 1 and 2),
              carry bytes, device memory
  serve_cli   the CLI in a child process (v1, --warmup 440x1024): 2
              requests, then SIGTERM, exit 0 within 60 s
  train       the train step at the chairs preset's geometry (368x496,
              12 iterations, fp32, seed-0 weights, a random batch): v1 on
              allpairs and on B1 at batch 10, v5 on B1 at the largest
              batch <= 10 that fits without remat; ms per step (median of
              5 after 2, CUDA events), peak allocated memory, B1 launches
              per step (12), every loss finite and state_finite, and one
              profiled step with the share of B1's backward recompute
              (fused_reference); each B1 step against the corr_impl=
              "local" step on the same weights and batch: loss within
              1e-4 relative, flattened gradient within 1e-3 relative L2
  train_demo  RAFT-small v1 on B1, 192x256, batch 4, 12 iterations, 200
              steps on exact-GT warped-texture pairs: mean EPE of the
              last 25 steps <= 0.5x the first 25; 2400 B1 launches
  train_cli   python -m dexiraft_tpu_torch train --stage chairs
              --corr_impl flash --fused_update on a synthetic
              FlyingChairs_release tree in a temporary directory: 6 steps,
              a checkpoint every 3, then --resume from a copy of step 3:
              the resumed run starts at step 3 and logs the full run's
              losses within 1e-5 relative
  6 times     CUDA-event medians: v1 and v5 forward ms at 440x1024, B=1
              (TF32 off and PyTorch's default, and the main paths under
              the eval step's arithmetic), v5's DexiNed and prelude
              alone, kernel and plain-version times per call at each
              path's shapes (B1 also on the smooth and scattered fields,
              B3 and B4 on the smooth, scattered and edge fields, every
              storage dtype; B2 on every field and dtype at v5's batch),
              torch.profiler breakdowns of v1 fused, v5
              pallas fused, v5 pallas lookup and v5 flash fused (the main
              path, B1 on the model's coords)
Then the {"kernels": [...]} line (each entry with its launches on the
slices' paths, the service's for B1, and the train phases' counted steps
as train_launches), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed phase exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = 1e-3      # max abs error, kernel vs plain version
TOL_FLOW_PX = 1e-2     # max abs flow_low difference, fused vs plain model
ITERS = 32
# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32
# (non-tensor-core) rate; every product in these kernels has an fp32
# operand, so no 16-bit tensor-core rate applies
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
SOURCES = {"flash_corr": "dexiraft_tpu_torch/csrc/flash_corr.cu",
           "pallas_corr": "dexiraft_tpu_torch/csrc/pallas_corr.cu"}
# kernel-check cases: (label, B, H/8, W/8, levels, r, C, F)
KERNEL_CASES = (
    ("sintel_b1", 1, 55, 128, 4, 4, 256, 256),
    ("sintel_b2", 2, 55, 128, 4, 4, 256, 256),
    ("kitti_b2", 2, 47, 156, 4, 4, 256, 256),
    ("degenerate_48x64", 2, 6, 8, 4, 4, 256, 256),
)
# v5's kernel batch is twice the engine's: image and edge stream
V5_KERNEL_CASES = (
    ("sintel_b2", 2, 55, 128, 4, 4, 256, 256),
    ("sintel_b4", 4, 55, 128, 4, 4, 256, 256),
    ("kitti_b4", 4, 47, 156, 4, 4, 256, 256),
    ("degenerate_48x64_b4", 4, 6, 8, 4, 4, 256, 256),
    ("crop_40x64_b4", 4, 5, 8, 4, 4, 256, 256),
)
# B1's extra coordinate fields (make_coords), checked at the first two
# KERNEL_CASES and timed beside the jitter field
B1_FIELDS = ("smooth", "scattered")
# B3/B4's extra fields, checked at every V5_KERNEL_CASES case but sintel_b4
# and timed beside the jitter field
V5_FIELDS = ("smooth", "scattered", "edge")
B1_KERNEL = "flash_tile"  # B1's (and B2's) name in a torch.profiler trace
B3_KERNEL = "pallas_tile"  # B3's and B4's
# the slice's requests: ((H, W), horizontal shift in px)
PAIRS = (((436, 1024), 3), ((436, 1024), -5), ((375, 1242), 4),
         ((375, 1242), 2))
SINTEL_BUCKET = (440, 1024)


RECORDS: list = []  # every emitted line, for --out


def emit(obj) -> None:
    RECORDS.append(obj)
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 10, inner: int = 1, warmup: int = 2) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call, after ``warmup`` calls."""
    return statistics.median(cuda_times_ms(fn, reps, inner, warmup))


def cuda_times_ms(fn, reps: int = 10, inner: int = 1, warmup: int = 2):
    """The ``reps`` CUDA-event timings (ms per call) behind cuda_time_ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return times


def make_coords(gen, b, h, w, field, device, radius=4, levels=4):
    """Level-0 coords (B, H, W, 2) of one field:
      jitter     grid + U(-6, 6), one row far out of frame;
      smooth     grid + one constant sub-pixel shift per batch item (every
                 B1 tile stages one small f2 patch);
      scattered  uniform over the frame (B1's level-0 tiles read each
                 pixel's own lattice rows);
      edge       integer centers on the edges of each level's frame, one
                 target per 4x8 block of query pixels (so the kernels'
                 tiles keep small boxes and stage them by TMA): on each
                 axis half of the blocks on an in-frame position, half on
                 a clip limit -r-1 or size+r, a half level pixel inside
                 one, -r, -1, 0, size-1 or size (in level pixels, times
                 2^l); the block's pixels step from the target toward the
                 frame, so a block on -r-1 runs from the clip limit across
                 the frame's edge. There TMA's zero fill at negative
                 coordinates must agree with the plain version."""
    import torch
    from dexiraft_tpu_torch.ops.grid import coords_grid

    if field == "edge":
        nty, ntx = -(-h // 4), -(-w // 8)

        def axis(size, n):
            cands = []
            for lvl in range(levels):
                s, sz = 2 ** lvl, size >> lvl
                half = [-(radius + 0.5) * s, (sz + radius - 0.5) * s] \
                    if lvl else []
                cands += [-(radius + 1.0) * s, -radius * s, -s, 0.0,
                          (sz - 1.0) * s, sz * s, (sz + radius) * s] + half
            cands = torch.tensor(cands, device=device)
            pick = cands[torch.randint(len(cands), (n,), generator=gen,
                                       device=device)]
            inside = torch.randint(size, (n,), generator=gen,
                                   device=device).float()
            keep = torch.rand(n, generator=gen, device=device) < 0.5
            return torch.where(keep, inside, pick)

        def spread(target, size, offs):
            # blocks -> pixels; step toward the frame from the target
            t = target.reshape(b, nty, ntx).repeat_interleave(4, 1)
            t = t.repeat_interleave(8, 2)[:, :h, :w]
            return t + torch.where(t < size / 2, 1.0, -1.0) * offs

        dx = (torch.arange(w, device=device) % 8).float().expand(h, w)
        dy = (torch.arange(h, device=device) % 4).float()[:, None].expand(h, w)
        x = spread(axis(w, b * nty * ntx), w, dx)
        y = spread(axis(h, b * nty * ntx), h, dy)
        return torch.stack([x, y], -1)
    if field == "scattered":
        u = torch.rand(b, h, w, 2, generator=gen, device=device)
        return u * torch.tensor([w, h], dtype=torch.float32, device=device)
    grid = coords_grid(b, h, w, device=device)
    if field == "smooth":
        shift = torch.rand(b, 1, 1, 2, generator=gen, device=device) * 6 - 3
        return grid + shift
    co = grid + torch.rand(b, h, w, 2, generator=gen, device=device) * 12 - 6
    co[:, 0, :, 0] += 1.0e4
    co[:, 0, : w // 2, 1] -= 3.0e4
    return co


def make_inputs(gen, b, h, w, c, levels, radius, feat, dtype, device,
                field="jitter"):
    """fmap1/fmap2 ~ N(0, 1), coords of ``field`` (make_coords), the pooled
    pyramid in ``dtype``, weight (with the int8 scales folded in, as the
    model does) and bias."""
    import torch
    from dexiraft_tpu_torch.ops.local_corr import build_local_corr

    f1 = torch.randn(b, h, w, c, generator=gen, device=device)
    f2 = torch.randn(b, h, w, c, generator=gen, device=device)
    co = make_coords(gen, b, h, w, field, device)
    pyr = build_local_corr(f1, f2, levels, radius, dtype=dtype, kernel="flash")
    kk = (2 * radius + 1) ** 2
    weight = torch.randn(levels * kk, feat, generator=gen, device=device) * 0.05
    if pyr.scales is not None:
        weight = torch.cat([weight[i * kk:(i + 1) * kk] * s
                            for i, s in enumerate(pyr.scales)])
    bias = torch.randn(feat, generator=gen, device=device) * 0.1
    return pyr, co, weight.contiguous(), bias


def valid_lattice_points(co, shape, scale, radius):
    """In-frame (2r+2)^2 lattice points this run's coords need at one
    level (the dots the kernel actually takes)."""
    import torch

    h2, w2 = shape
    k1 = 2 * radius + 2
    offs = torch.arange(k1, device=co.device) - radius

    def axis(t, size):
        t = torch.clamp(t * scale, -(radius + 1.0), size + float(radius))
        g = torch.floor(t).long()[..., None] + offs
        return ((g >= 0) & (g < size)).sum(-1)

    return int((axis(co[..., 0], w2) * axis(co[..., 1], h2)).sum())


def box_summary(co, shape, scale, radius, limit=None, tma=True):
    """B1's (smallest, largest) box in positions over its 4x8 tiles at one
    level (``limit`` None), or, for a stage of ``limit`` positions, B3/B4's
    (``tma``) or B1/B2's [smallest, largest staged positions, tiles on the
    per-pixel branch, tiles with a live pixel] (ops/tiles.py)."""
    from dexiraft_tpu_torch.ops.tiles import (flash_staging, tile_boxes,
                                              tma_staging)

    whole = limit is not None and tma
    cols, rows = tile_boxes(co, shape, scale, radius, whole=whole)
    if limit is None:
        box = cols * rows
        return [int(box.min()), int(box.max())] if box.numel() else [0, 0]
    staged, per_pixel = (tma_staging if tma else flash_staging)(cols, rows,
                                                                limit)
    on_patch = staged[~per_pixel]
    return [int(on_patch.min()) if on_patch.numel() else 0,
            int(on_patch.max()) if on_patch.numel() else 0,
            int(per_pixel.sum()), int(cols.numel())]


def work_b1(pyr, co, weight, radius):
    """(bytes, flops) of one fused call: each input read once, the output
    written once; the dots of the in-frame lattice, the corner blend and
    window @ W of the non-degenerate levels."""
    b, h, w, c = pyr.fmap1.shape
    n = b * h * w
    kk = (2 * radius + 1) ** 2
    feat = weight.shape[1]
    nbytes = (pyr.fmap1.numel() * 4 + co.numel() * 4 + weight.numel() * 4
              + feat * 4 + n * feat * 4
              + sum(x.numel() * x.element_size() for x in pyr.fmap2_pyramid))
    flops = 0
    for lvl, f2 in enumerate(pyr.fmap2_pyramid):
        if f2.shape[1] == 0 or f2.shape[2] == 0:
            continue
        flops += 2 * c * valid_lattice_points(co, f2.shape[1:3], 2.0 ** -lvl,
                                              radius)
        flops += n * kk * (8 + 2 * feat)
    return nbytes, flops


def work_b2(f1, f2, co, radius):
    b, h, w, c = f1.shape
    n = b * h * w
    kk = (2 * radius + 1) ** 2
    nbytes = (f1.numel() * 4 + f2.numel() * f2.element_size()
              + co.numel() * 4 + n * kk * 4)
    flops = 2 * c * valid_lattice_points(co, f2.shape[1:3], 1.0, radius) \
        + n * kk * 8
    return nbytes, flops


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_diff(a, b, keep=None) -> float:
    """Max abs difference, over the ``keep`` mask where one is given."""
    d = (a - b).abs()
    if keep is not None:
        d = d.masked_fill(~keep, 0.0)
    return float(d.max())


def phase_kernels(torch, ck, gen, dev):
    """B1 and B2 against their plain versions at the v1 shapes."""
    from dexiraft_tpu_torch.ops.local_corr import local_corr_level

    worst = {"flash_fused_step": 0.0, "flash_local_corr_level": 0.0}
    for label, b, h, w, levels, r, c, feat in KERNEL_CASES:
        for dtype in ("fp32", "bf16", "int8"):
            pyr, co, weight, bias = make_inputs(gen, b, h, w, c, levels, r,
                                                feat, dtype, dev)
            out = ck.flash_fused_step(pyr.fmap1, pyr.fmap2_pyramid, co,
                                      weight, bias, r)
            torch.cuda.synchronize()
            ref = ck.fused_reference(pyr.fmap1, pyr.fmap2_pyramid, co,
                                     weight, bias, r, 8)
            err_b1 = max_diff(out, ref)
            errs_b2 = []
            for lvl, f2 in enumerate(pyr.fmap2_pyramid):
                c_l = co / 2.0 ** lvl
                s = pyr.level_scale(lvl)
                o = ck.flash_local_corr_level(pyr.fmap1, f2, c_l, r)
                torch.cuda.synchronize()
                rr = local_corr_level(pyr.fmap1, f2.float(), c_l, r, 8)
                if s is not None:  # the scale the lookup path applies
                    o, rr = o * s, rr * s
                errs_b2.append(max_diff(o, rr))
            emit({"phase": "kernels", "kernels": "B1/B2", "case": label,
                  "dtype": dtype, "shape": [b, h, w, c],
                  "levels": [list(x.shape[1:3]) for x in pyr.fmap2_pyramid],
                  "tf32": False, "b1_max_abs_err": err_b1,
                  "b2_max_abs_err_per_level": errs_b2, "tol": TOL_KERNEL})
            worst["flash_fused_step"] = max(worst["flash_fused_step"], err_b1)
            worst["flash_local_corr_level"] = max(
                worst["flash_local_corr_level"], max(errs_b2))
            if err_b1 > TOL_KERNEL or max(errs_b2) > TOL_KERNEL:
                raise AssertionError(
                    f"kernel disagrees with its plain version: {label} "
                    f"{dtype} B1 {err_b1} B2 {errs_b2} (tol {TOL_KERNEL})")
    # B1's two branches: a smooth field stages one f2 patch per tile, a
    # scattered one reads level 0's lattices pixel by pixel; both against
    # the plain version and against B3, the independent formulation
    for field in B1_FIELDS:
        for label, b, h, w, levels, r, c, feat in KERNEL_CASES[:2]:
            for dtype in ("fp32", "bf16", "int8"):
                pyr, co, weight, bias = make_inputs(gen, b, h, w, c, levels,
                                                    r, feat, dtype, dev,
                                                    field=field)
                args = (pyr.fmap1, pyr.fmap2_pyramid, co, weight, bias, r)
                out = ck.flash_fused_step(*args)
                torch.cuda.synchronize()
                b3 = ck.pallas_fused_step(*args)
                ref = ck.fused_reference(*args, 8)
                err = max(max_diff(out, ref), max_diff(out, b3))
                emit({"phase": "kernels", "kernels": "B1 branches",
                      "case": label, "field": field, "dtype": dtype,
                      "b1_vs_plain": max_diff(out, ref),
                      "b1_vs_b3": max_diff(out, b3),
                      "tile_boxes_min_max_per_level": [
                          box_summary(co, f.shape[1:3], 2.0 ** -lvl, r)
                          for lvl, f in enumerate(pyr.fmap2_pyramid)],
                      "tf32": False, "tol": TOL_KERNEL})
                worst["flash_fused_step"] = max(worst["flash_fused_step"], err)
                if err > TOL_KERNEL:
                    raise AssertionError(
                        f"B1 disagrees on the {field} field: {label} {dtype} "
                        f"{err} (tol {TOL_KERNEL})")
    worst["flash_local_corr_level"] = max(worst["flash_local_corr_level"],
                                          check_b2_fields(torch, ck, gen, dev))
    return worst


def check_b2_fields(torch, ck, gen, dev) -> float:
    """B2's branches on every field at every KERNEL_CASES case: against the
    plain version (NaN pixels left out) and against B4, the TMA-staged
    formulation; row 1's first 3 pixels NaN and 0-row levels must come out
    exactly zero. Each record gives B2's staged boxes per level
    (box_summary with flash_box_limit). Returns the worst error."""
    from dexiraft_tpu_torch.ops.local_corr import local_corr_level

    worst = 0.0
    for field in ("jitter",) + V5_FIELDS:
        for label, b, h, w, levels, r, c, feat in KERNEL_CASES:
            for dtype in ("fp32", "bf16", "int8"):
                pyr, co, _, _ = make_inputs(gen, b, h, w, c, levels, r, feat,
                                            dtype, dev, field=field)
                co[:, 1, :3] = float("nan")
                keep = torch.ones(b, h, w, 1, dtype=torch.bool, device=dev)
                keep[:, 1, :3] = False
                vs_plain, vs_b4, nan_px, zero_levels = [], [], [], []
                for lvl, f2 in enumerate(pyr.fmap2_pyramid):
                    c_l = co / 2.0 ** lvl
                    s = pyr.level_scale(lvl)
                    o = ck.flash_local_corr_level(pyr.fmap1, f2, c_l, r)
                    torch.cuda.synchronize()
                    o4 = ck.pallas_local_corr_level(pyr.fmap1, f2, c_l, r)
                    rr = local_corr_level(pyr.fmap1, f2.float(), c_l, r, 8)
                    if s is not None:  # the scale the lookup path applies
                        o, o4, rr = o * s, o4 * s, rr * s
                    vs_plain.append(max_diff(o, rr, keep))
                    vs_b4.append(max_diff(o, o4))
                    nan_px.append(float(o[:, 1, :3].abs().max()))
                    if 0 in f2.shape[1:3]:
                        zero_levels.append(float(o.abs().max()))
                limit = ck.flash_box_limit(pyr.fmap2_pyramid[0].dtype, False,
                                           r, c)
                emit({"phase": "kernels", "kernels": "B2 branches",
                      "case": label, "field": field, "dtype": dtype,
                      "b2_vs_plain_per_level": vs_plain,
                      "b2_vs_b4_per_level": vs_b4,
                      "b2_nan_pixels_max_abs_per_level": nan_px,
                      "b2_zero_levels_max_abs": zero_levels,
                      "box_limit": limit,
                      "b2_boxes_per_level": [
                          box_summary(co, f.shape[1:3], 2.0 ** -lvl, r, limit,
                                      tma=False)
                          for lvl, f in enumerate(pyr.fmap2_pyramid)],
                      "tf32": False, "tol": TOL_KERNEL})
                err = max(vs_plain + vs_b4)
                worst = max(worst, err)
                if err > TOL_KERNEL or any(nan_px) or any(zero_levels):
                    raise AssertionError(
                        f"B2 disagrees on the {field} field: {label} {dtype} "
                        f"vs plain {vs_plain} vs B4 {vs_b4} NaN pixels "
                        f"{nan_px} 0-row levels {zero_levels} (tol "
                        f"{TOL_KERNEL}, zeros exact)")
    return worst


def phase_kernels_v5(torch, ck, gen, dev):
    """B3 and B4 against their plain versions and against B1 / B2 (the
    other formulation, an independent kernel) at the v5 shapes, on the
    jitter field and, for every case but the largest, the smooth,
    scattered and edge fields. Row 1 of the coords is NaN for 3 pixels:
    both kernels clip a NaN center to the low edge, an all-zero window (B3
    gives the bias, B4 zeros), where the plain version gives NaN; those
    pixels are held to that and left out of the plain comparison. Each
    record also gives B3's and B4's TMA boxes per level (box_summary)."""
    from dexiraft_tpu_torch.ops.local_corr import local_corr_level

    worst = {"pallas_fused_step": 0.0, "pallas_local_corr_level": 0.0}
    cases = [(case, "jitter") for case in V5_KERNEL_CASES]
    cases += [(case, field) for field in V5_FIELDS for case in V5_KERNEL_CASES
              if case[0] != "sintel_b4"]
    for (label, b, h, w, levels, r, c, feat), field in cases:
        for dtype in ("fp32", "bf16", "int8"):
            pyr, co, weight, bias = make_inputs(gen, b, h, w, c, levels, r,
                                                feat, dtype, dev, field=field)
            co[:, 1, :3] = float("nan")
            keep = torch.ones(b, h, w, 1, dtype=torch.bool, device=dev)
            keep[:, 1, :3] = False
            b3 = ck.pallas_fused_step(pyr.fmap1, pyr.fmap2_pyramid, co,
                                      weight, bias, r)
            torch.cuda.synchronize()
            b1 = ck.flash_fused_step(pyr.fmap1, pyr.fmap2_pyramid, co,
                                     weight, bias, r)
            ref = ck.fused_reference(pyr.fmap1, pyr.fmap2_pyramid, co,
                                     weight, bias, r, 8)
            rec = {"b3_vs_plain": max_diff(b3, ref, keep),
                   "b3_vs_b1": max_diff(b3, b1),
                   "b3_nan_pixels_vs_bias": max_diff(b3[:, 1, :3], bias)}
            b4_plain, b4_b2, b4_nan = [], [], []
            for lvl, f2 in enumerate(pyr.fmap2_pyramid):
                c_l = co / 2.0 ** lvl
                s = pyr.level_scale(lvl)
                o = ck.pallas_local_corr_level(pyr.fmap1, f2, c_l, r)
                torch.cuda.synchronize()
                o2 = ck.flash_local_corr_level(pyr.fmap1, f2, c_l, r)
                rr = local_corr_level(pyr.fmap1, f2.float(), c_l, r, 8)
                if s is not None:  # the scale the lookup path applies
                    o, o2, rr = o * s, o2 * s, rr * s
                b4_plain.append(max_diff(o, rr, keep))
                b4_b2.append(max_diff(o, o2))
                b4_nan.append(float(o[:, 1, :3].abs().max()))
            rec.update(b4_vs_plain_per_level=b4_plain,
                       b4_vs_b2_per_level=b4_b2,
                       b4_nan_pixels_max_abs_per_level=b4_nan)
            limits = {kind: ck.pallas_box_limit(pyr.fmap2_pyramid[0].dtype,
                                                kind == "b3", r, c, feat)
                      for kind in ("b3", "b4")}
            for kind, limit in limits.items():
                rec[f"{kind}_boxes_per_level"] = [
                    box_summary(co, f.shape[1:3], 2.0 ** -lvl, r, limit)
                    for lvl, f in enumerate(pyr.fmap2_pyramid)]
            emit({"phase": "kernels", "kernels": "B3/B4", "case": label,
                  "field": field, "dtype": dtype, "shape": [b, h, w, c],
                  "levels": [list(x.shape[1:3]) for x in pyr.fmap2_pyramid],
                  "box_limit": limits, "tf32": False, **rec,
                  "tol": TOL_KERNEL})
            err_b3 = max(rec["b3_vs_plain"], rec["b3_vs_b1"],
                         rec["b3_nan_pixels_vs_bias"])
            err_b4 = max(b4_plain + b4_b2 + b4_nan)
            worst["pallas_fused_step"] = max(worst["pallas_fused_step"], err_b3)
            worst["pallas_local_corr_level"] = max(
                worst["pallas_local_corr_level"], err_b4)
            if err_b3 > TOL_KERNEL or err_b4 > TOL_KERNEL:
                raise AssertionError(
                    f"B3/B4 disagree with their plain versions or with B1/B2: "
                    f"{label} {field} {dtype} {rec} (tol {TOL_KERNEL})")
    return worst


def frame_pairs(seed):
    """Two Sintel-shaped and two KITTI-shaped frame pairs: a smooth random
    scene and the same scene shifted by a few pixels, plus noise."""
    rng = np.random.default_rng(seed)
    items = []
    for (h, w), shift in PAIRS:
        base = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3))
        im = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
        im2 = np.roll(im, shift, axis=1) + rng.normal(0, 2, im.shape)
        items.append({"image1": im.astype(np.float32),
                      "image2": np.clip(im2, 0, 255).astype(np.float32)})
    return items


def phase_slice(torch, ck, dev, model_name, variant, paths, expect):
    """Drive one model's paths through the engine. ``paths``: path ->
    config kwargs of ``variant`` (the first path's model is seeded, the
    others load its weights; "plain" is added as corr_impl="local").
    ``expect``: path -> (kernel, launches that path must make, and no
    launch of any other kernel)."""
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.models.raft import RAFT, create_model
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from dexiraft_tpu_torch.train.step import make_eval_step

    names = list(paths)
    seeded = create_model(variant(**paths[names[0]]), seed=0, device=dev)
    state = seeded.state_dict()

    def sibling(kw):
        m = RAFT(variant(**kw))
        m.load_state_dict(state, strict=True)
        return m.to(dev).eval()

    models = {names[0]: seeded}
    models.update({p: sibling(paths[p]) for p in names[1:]})
    models["plain"] = sibling({"corr_impl": "local"})
    items = frame_pairs(seed=0)
    launches = {}
    results = {}
    for path in names:
        engine = InferenceEngine(
            make_eval_step(models[path], ITERS, dev, tf32=False),
            ServeConfig(batch_size=2, mode="sintel"))
        ck.reset_launches()
        res = sorted(engine.stream([dict(it) for it in items]),
                     key=lambda r: r.index)
        torch.cuda.synchronize()
        launches[path] = dict(ck.LAUNCHES)
        results[path] = res
        for r, it in zip(res, items):
            h, w = it["image1"].shape[:2]
            if r.flow_up.shape != (h, w, 2):
                raise AssertionError(f"{model_name} {path}: flow_up "
                                     f"{r.flow_up.shape} for a {h}x{w} pair")
            if not np.isfinite(r.flow_up).all() or not np.isfinite(
                    r.flow_low).all():
                raise AssertionError(f"{model_name} {path}: non-finite flow")
        emit({"phase": "slice", "model": model_name, "path": path,
              "requests": len(res), "batches": engine.stats.batches,
              "buckets": engine.registry.stats()["buckets"],
              "launches": launches[path],
              "flow_up_shapes": [list(r.flow_up.shape) for r in res],
              "mean_abs_flow_px": [float(np.abs(r.flow_up).mean()) for r in res]})
    for path, (kernel, count) in expect.items():
        got = launches[path]
        stray = {k: v for k, v in got.items() if k != kernel and v}
        if got[kernel] != count or stray:
            raise AssertionError(
                f"{model_name} path {path!r} launched {kernel} {got[kernel]} "
                f"times (expected {count}) and other kernels {stray}")

    # the same forward with the kernel swapped for its plain version
    # (corr_impl="local", same weights), on the Sintel bucket's batch
    pads = [InputPadder(it["image1"].shape, "sintel", target=SINTEL_BUCKET)
            for it in items[:2]]
    im1 = torch.from_numpy(np.stack([p.pad(it["image1"])[0]
                                     for p, it in zip(pads, items)]))
    im2 = torch.from_numpy(np.stack([p.pad(it["image2"])[0]
                                     for p, it in zip(pads, items)]))
    x1 = im1.to(dev).permute(0, 3, 1, 2)
    x2 = im2.to(dev).permute(0, 3, 1, 2)
    lows = {}
    with torch.inference_mode():
        for path in names + ["plain"]:
            lows[path] = models[path](x1, x2, iters=ITERS)[0]
    diff = {p: float((lows[p] - lows["plain"]).abs().max()) for p in names}
    engine_vs_direct = max(
        float(np.abs(r.flow_low - lows[names[0]][i].permute(1, 2, 0)
                     .cpu().numpy()).max())
        for i, r in enumerate(results[names[0]][:2]))
    emit({"phase": "slice", "model": model_name,
          "check": "kernel paths vs plain path, same weights",
          "tf32": False, "flow_low_max_abs_diff_px": diff,
          "engine_vs_direct_flow_low_px": engine_vs_direct,
          "flow_low_max_abs_px": float(lows["plain"].abs().max()),
          "tol_px": TOL_FLOW_PX})
    if max(diff.values()) > TOL_FLOW_PX or engine_vs_direct > TOL_FLOW_PX:
        raise AssertionError(f"{model_name}: kernel path flow differs from "
                             f"the plain path: {diff}, engine vs direct "
                             f"{engine_vs_direct}")
    batch = (np.stack([p.pad(it["image1"])[0] for p, it in zip(pads, items)]),
             np.stack([p.pad(it["image2"])[0] for p, it in zip(pads, items)]),
             lows["plain"])
    return models, launches, batch


def phase_tf32(torch, dev, model_name, model, batch) -> dict:
    """The eval step's arithmetic: flow_low of ``model`` (a kernel path)
    through make_eval_step with TF32 convolutions on (PyTorch's default
    flags: cuDNN TF32 on, matmuls fp32) and off, and with the step's
    default, against ``batch``'s TF32-off plain-lookup flow_low after
    ITERS iterations. Fails if the default setting is over TOL_FLOW_PX or
    the step leaves the global flags changed."""
    from dexiraft_tpu_torch.train.step import EVAL_TF32, make_eval_step

    im1, im2, plain_low = batch
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    diff = {}
    for key, kw in (("tf32_on", {"tf32": True}), ("tf32_off", {"tf32": False}),
                    ("default", {})):
        low, _ = make_eval_step(model, ITERS, dev, **kw)(im1, im2)
        diff[key] = float((low.permute(0, 3, 1, 2) - plain_low).abs().max())
    after = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    rec = {"phase": "tf32", "model": model_name,
           "check": "eval step vs TF32-off plain path, same weights",
           "flow_low_max_abs_diff_px": diff, "default_tf32": EVAL_TF32,
           "flags_before_after": [list(flags), list(after)],
           "tol_px": TOL_FLOW_PX}
    emit(rec)
    if after != flags:
        raise AssertionError(f"the eval step left the TF32 flags changed: "
                             f"{flags} -> {after}")
    if diff["default"] > TOL_FLOW_PX:
        raise AssertionError(f"{model_name}: the eval step's default "
                             f"arithmetic (tf32={EVAL_TF32}) is "
                             f"{diff['default']} px from the plain path")
    return rec


def sintel_frames(seed, n, shift=3, edges=False):
    """``n`` chained Sintel-shaped frames (436x1024): a smooth random scene
    moved ``shift`` px to the right per frame, plus noise. With ``edges``,
    also one seeded uint8 edge frame per frame (sparse 0/255 lines, as an
    edge detector's output looks), moved with the scene."""
    rng = np.random.default_rng(seed)
    (h, w), _ = PAIRS[0]
    base = np.kron(rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3)),
                   np.ones((8, 8, 1)))[:h, :w]
    lines = (rng.uniform(0, 1, (h, w, 3)) > 0.9).astype(np.uint8) * 255
    frames, edge_frames = [], []
    for i in range(n):
        im = np.roll(base, shift * i, axis=1) + rng.normal(0, 2, base.shape)
        frames.append(np.clip(im, 0, 255).astype(np.float32))
        edge_frames.append(np.roll(lines, shift * i, axis=1))
    return (frames, edge_frames) if edges else frames


def pad_batch(pad, arrays):
    return np.stack([pad.pad(np.asarray(a, np.float32))[0] for a in arrays])


def timed_ms(torch, fn, reps=10, warmup=2) -> dict:
    """CUDA-event median ms per call over ``reps`` (min and max beside)."""
    ts = sorted(cuda_times_ms(fn, reps=reps, warmup=warmup))
    return {"median": statistics.median(ts), "min": ts[0], "max": ts[-1]}


def phase_conv_search(torch, dev) -> dict:
    """The motion encoder's two 3x3 convs over 256 channels (convc2 to
    192, conv to 126) at the 55x128 map, batch 2 and 4 (v5's loop at
    engine batches 1 and 2), TF32 off: ms with cuDNN's heuristic
    algorithm (PyTorch's default flags) and with the eval step's
    algorithm search (train.step.eval_arithmetic). Runs before any other
    convolution: cuDNN keeps the algorithm a search found for a shape and
    uses it with the heuristics too."""
    import torch.nn as nn

    from dexiraft_tpu_torch.train.step import eval_arithmetic

    rec = {"phase": "conv_search", "tf32": False,
           "map": [SINTEL_BUCKET[0] // 8, SINTEL_BUCKET[1] // 8]}
    with torch.inference_mode():
        for name, out_ch in (("convc2", 192), ("conv", 126)):
            conv = nn.Conv2d(256, out_ch, 3, padding=1).to(dev)
            for n in (2, 4):
                x = torch.randn(n, 256, *rec["map"], device=dev)
                rec[f"{name}_batch{n}_heuristic_ms"] = timed_ms(
                    torch, lambda: conv(x), reps=3, warmup=1)
                with eval_arithmetic(False):
                    rec[f"{name}_batch{n}_search_ms"] = timed_ms(
                        torch, lambda: conv(x), reps=3, warmup=1)
    emit(rec)
    return rec


def phase_conv_threads(torch, dev) -> dict:
    """Where cuDNN's search results live: the motion encoder's two 3x3
    convs at the 55x128 map and batch 3 (a shape no other phase runs),
    under the eval step's arithmetic, wall ms (synchronized) of the first
    and second call on the main thread, on a fresh thread, and on a
    device.DeviceThread after one call there. A first call on a fresh
    thread as slow as the main thread's first says the search is kept per
    thread, which is why the service runs its forwards on DeviceThreads."""
    import threading

    import torch.nn as nn

    from dexiraft_tpu_torch.device import DeviceThread
    from dexiraft_tpu_torch.train.step import eval_arithmetic

    convs = [nn.Conv2d(256, c, 3, padding=1).to(dev) for c in (192, 126)]
    x = torch.randn(3, 256, SINTEL_BUCKET[0] // 8, SINTEL_BUCKET[1] // 8,
                    device=dev)

    @torch.inference_mode()
    def call_ms():
        with eval_arithmetic(False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for conv in convs:
                conv(x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    rec = {"phase": "conv_threads", "tf32": False, "batch": 3,
           "main_first_ms": call_ms(), "main_again_ms": call_ms()}
    fresh = {}

    def on_fresh_thread():
        fresh["first"] = call_ms()
        fresh["again"] = call_ms()

    t = threading.Thread(target=on_fresh_thread)
    t.start()
    t.join()
    rec["fresh_thread_first_ms"] = fresh["first"]
    rec["fresh_thread_again_ms"] = fresh["again"]
    worker = DeviceThread("conv-threads")
    rec["device_thread_first_ms"] = worker.call(call_ms)
    rec["device_thread_again_ms"] = worker.call(call_ms)
    emit(rec)
    return rec


def phase_variants(torch, ck, dev) -> dict:
    """v2, v3 and v4 at full width, batch 1, one Sintel pair padded to the
    440x1024 bucket (v2/v3 with seeded uint8 edge frames), ITERS
    iterations: the flash fused path (B1) through the eval step against
    the plain path (corr_impl="local") on the same weights, flow_low <=
    TOL_FLOW_PX; B1's launches in that forward (ITERS: one per iteration,
    v3's two streams on one 2B batch) and no other kernel; the forward's
    ms (CUDA events, the eval step's arithmetic: TF32 off)."""
    from dexiraft_tpu_torch.config import raft_v2, raft_v3, raft_v4
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.models.raft import RAFT, create_model
    from dexiraft_tpu_torch.train.step import eval_arithmetic, make_eval_step

    frames, edges = sintel_frames(seed=1, n=2, edges=True)
    pad = InputPadder(frames[0].shape, "sintel", target=SINTEL_BUCKET)
    im1, im2 = pad_batch(pad, frames[:1]), pad_batch(pad, frames[1:])
    e1, e2 = pad_batch(pad, edges[:1]), pad_batch(pad, edges[1:])
    out = {}
    for name, variant in (("v2", raft_v2), ("v3", raft_v3), ("v4", raft_v4)):
        flash = create_model(variant(corr_impl="flash", fused_update=True),
                             seed=0, device=dev)
        plain = RAFT(variant(corr_impl="local"))
        plain.load_state_dict(flash.state_dict(), strict=True)
        plain = plain.to(dev).eval()
        kw = {} if name == "v4" else {"edges1": e1, "edges2": e2}
        ck.reset_launches()
        low, up = make_eval_step(flash, ITERS, dev, tf32=False)(im1, im2,
                                                                **kw)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        low_p, up_p = make_eval_step(plain, ITERS, dev, tf32=False)(im1, im2,
                                                                    **kw)
        x1, x2 = (torch.from_numpy(x).to(dev).permute(0, 3, 1, 2)
                  for x in (im1, im2))
        xe = {k: torch.from_numpy(v).to(dev).permute(0, 3, 1, 2)
              for k, v in kw.items()}
        with torch.inference_mode(), eval_arithmetic(False):
            ms = timed_ms(torch, lambda: flash(x1, x2, iters=ITERS, **xe))
        rec = {"phase": "variants", "variant": name, "batch": 1,
               "bucket": list(SINTEL_BUCKET), "iters": ITERS, "tf32": False,
               "launches": launches,
               "flow_low_vs_plain_px": float((low - low_p).abs().max()),
               "flow_up_vs_plain_px": float((up - up_p).abs().max()),
               "flow_low_max_abs_px": float(low_p.abs().max()),
               "finite": bool(torch.isfinite(up).all()),
               "forward_ms_flash_fused": ms, "tol_px": TOL_FLOW_PX}
        emit(rec)
        out[name] = rec
        stray = {k: v for k, v in launches.items()
                 if k != "flash_fused_step" and v}
        if launches["flash_fused_step"] != ITERS or stray:
            raise AssertionError(f"{name}: B1 launched "
                                 f"{launches['flash_fused_step']} times "
                                 f"(expected {ITERS}), other kernels {stray}")
        if rec["flow_low_vs_plain_px"] > TOL_FLOW_PX or not rec["finite"]:
            raise AssertionError(f"{name}: flash fused flow_low "
                                 f"{rec['flow_low_vs_plain_px']} px from the "
                                 f"plain path (tol {TOL_FLOW_PX}), finite "
                                 f"{rec['finite']}")
        del flash, plain
    return out


def damped_state(state):
    """The contraction fixture of tests/test_zzzadaptive.py: the flow
    head's parameters x 0.01, so each update moves the flow little and the
    convergence gate fires."""
    return {k: v * 0.01 if k.startswith("update_block.flow_head.") else v
            for k, v in state.items()}


def phase_adaptive(torch, ck, dev) -> dict:
    """v5 flash fused, batch 2 (two different Sintel pairs in the 440x1024
    bucket), ITERS iterations, the convergence-gated loop:
      * converge_tol=0 with the full budget against the fixed eval step
        (<= 1e-6 px; the gate never fires, so 0 is expected);
      * the damped weights at tol 0.02: every item stops before ITERS, and
        each item's flow_low equals a fixed forward of its iters_used on
        the same batch (<= 1e-5 px);
      * a budget of 8: iters_used <= 8;
      * B1's launches per adaptive forward (one per iteration run);
      * ms of the fixed and adaptive forwards (the eval step's
        arithmetic), and the cost of the per-iteration host read of the
        done mask: adaptive at tol 0 reading it every iteration against
        never reading it."""
    import dataclasses

    from dexiraft_tpu_torch.config import raft_v5
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.models.raft import RAFT, create_model
    from dexiraft_tpu_torch.train.step import eval_arithmetic, make_eval_step

    base = create_model(raft_v5(corr_impl="flash", fused_update=True),
                        seed=0, device=dev)
    state = base.state_dict()

    def model(tol, sd):
        m = RAFT(dataclasses.replace(base.cfg, converge_tol=tol))
        m.load_state_dict(sd, strict=True)
        return m.to(dev).eval()

    items = frame_pairs(seed=2)[:2]
    pad = InputPadder(items[0]["image1"].shape, "sintel",
                      target=SINTEL_BUCKET)
    im1 = pad_batch(pad, [it["image1"] for it in items])
    im2 = pad_batch(pad, [it["image2"] for it in items])
    rec = {"phase": "adaptive", "model": "v5", "path": "flash_fused",
           "batch": 2, "iters": ITERS, "tf32": False}

    fixed = make_eval_step(base, ITERS, dev)
    low_fixed, _ = fixed(im1, im2)
    tol0 = model(0.0, state)
    ck.reset_launches()
    low0, _, iu0, fd0 = make_eval_step(tol0, ITERS, dev, adaptive=True)(
        im1, im2, None, ITERS)
    torch.cuda.synchronize()
    rec["tol0_launches"] = dict(ck.LAUNCHES)
    rec["tol0_iters_used"] = iu0.tolist()
    rec["tol0_vs_fixed_px"] = float((low0 - low_fixed).abs().max())
    _, _, iu8, _ = make_eval_step(tol0, ITERS, dev, adaptive=True)(
        im1, im2, None, 8)
    rec["budget8_iters_used"] = iu8.tolist()

    damped = damped_state(state)
    gated = model(0.02, damped)
    ck.reset_launches()
    low_g, _, iu_g, fd_g = make_eval_step(gated, ITERS, dev, adaptive=True)(
        im1, im2, None, None)
    torch.cuda.synchronize()
    rec["gated_launches"] = dict(ck.LAUNCHES)
    rec["gated_iters_used"] = iu_g.tolist()
    rec["gated_final_delta"] = fd_g.tolist()
    per_item = []
    for i, n in enumerate(iu_g.tolist()):
        low_n, _ = make_eval_step(gated, n, dev)(im1, im2)
        per_item.append(float((low_g[i] - low_n[i]).abs().max()))
    rec["gated_vs_fixed_at_iters_used_px"] = per_item

    x1, x2 = (torch.from_numpy(x).to(dev).permute(0, 3, 1, 2)
              for x in (im1, im2))
    with torch.inference_mode(), eval_arithmetic(False):
        rec["fixed_ms"] = timed_ms(torch, lambda: base(x1, x2, iters=ITERS))
        rec["adaptive_tol0_ms"] = timed_ms(
            torch, lambda: tol0(x1, x2, iters=ITERS, adaptive=True))
        rec["adaptive_tol0_no_exit_read_ms"] = timed_ms(
            torch, lambda: tol0(x1, x2, iters=ITERS, adaptive=True,
                                exit_check_every=ITERS))
        rec["fixed_damped_ms"] = timed_ms(
            torch, lambda: gated(x1, x2, iters=ITERS))
        rec["adaptive_gated_ms"] = timed_ms(
            torch, lambda: gated(x1, x2, iters=ITERS, adaptive=True))
    rec["exit_read_ms_per_iteration"] = (
        rec["adaptive_tol0_ms"]["median"]
        - rec["adaptive_tol0_no_exit_read_ms"]["median"]) / (ITERS - 1)
    rec["select_ms_per_iteration"] = (
        rec["adaptive_tol0_no_exit_read_ms"]["median"]
        - rec["fixed_ms"]["median"]) / ITERS
    emit(rec)
    if rec["tol0_vs_fixed_px"] > 1e-6 or iu0.tolist() != [ITERS, ITERS]:
        raise AssertionError(f"adaptive tol=0 differs from the fixed step: "
                             f"{rec['tol0_vs_fixed_px']} px, iters_used "
                             f"{iu0.tolist()}")
    if rec["tol0_launches"]["flash_fused_step"] != ITERS:
        raise AssertionError(f"adaptive tol=0 launched B1 "
                             f"{rec['tol0_launches']} (expected {ITERS})")
    if not all(n < ITERS for n in iu_g.tolist()) or max(per_item) > 1e-5:
        raise AssertionError(f"the gated loop: iters_used {iu_g.tolist()}, "
                             f"vs fixed at those iters {per_item} px")
    if rec["gated_launches"]["flash_fused_step"] != max(iu_g.tolist()):
        raise AssertionError(f"the gated loop launched B1 "
                             f"{rec['gated_launches']} times, ran "
                             f"{max(iu_g.tolist())} iterations")
    if max(iu8.tolist()) > 8:
        raise AssertionError(f"budget 8 ran {iu8.tolist()} iterations")
    return rec


def phase_video(torch, ck, dev) -> dict:
    """A v5 (flash fused) VideoEngine over one session: 6 chained Sintel
    frames in two chunks of 3 (the second warm: 2 + 3 flows). Each flow's
    flow_low against the pair forward (the eval step) of the same two
    frames with the same splatted warm start, <= TOL_FLOW_PX; B1's
    launches (ITERS per flow); the session's bytes; ms per warm frame
    against the pair engine's ms per pair (host pad, upload and fetch
    included in both); and forward_interpolate on the card against its CPU
    run on a collision-free 55x128 field (<= 1e-6), with its ms."""
    from dexiraft_tpu_torch.config import raft_v5
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.eval.interpolate import forward_interpolate
    from dexiraft_tpu_torch.models.raft import create_model
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from dexiraft_tpu_torch.serve.sessions import (DeviceSessionStore,
                                                   carry_nbytes)
    from dexiraft_tpu_torch.serve.video import VideoEngine
    from dexiraft_tpu_torch.train.step import (make_encode_step,
                                               make_eval_step,
                                               make_refine_step)

    model = create_model(raft_v5(corr_impl="flash", fused_update=True),
                         seed=0, device=dev)
    encode = make_encode_step(model, dev)
    refine = make_refine_step(model, ITERS, dev)
    seen = []  # (flow_init, flow_low) of every refinement the engine ran

    def recorded_refine(f1, f2, fi):
        low, up = refine(f1, f2, fi)
        seen.append((fi, low))
        return low, up

    def splat(low):
        return forward_interpolate(low[0])[None]

    def put(x):
        return torch.from_numpy(x).to(dev)

    video = VideoEngine(encode, recorded_refine, splat,
                        sessions=DeviceSessionStore(), put=put)
    (h, w), _ = PAIRS[0]
    video.warmup([f"{h}x{w}"])
    seen.clear()
    frames = sintel_frames(seed=3, n=9)
    ck.reset_launches()
    res1 = video.process_chunk("cam", np.stack(frames[:3]))
    res2 = video.process_chunk("cam", np.stack(frames[3:6]))
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    rec = {"phase": "video", "model": "v5", "path": "flash_fused",
           "iters": ITERS, "tf32": False, "launches": launches,
           "flows": [len(res1.flows), len(res2.flows)],
           "warm": [res1.warm, res2.warm]}

    pad = InputPadder(frames[0].shape, "sintel", target=SINTEL_BUCKET)
    step = make_eval_step(model, ITERS, dev)
    low_diff, up_diff = [], []
    for i, (fi, low) in enumerate(seen):
        low_p, up_p = step(pad_batch(pad, frames[i:i + 1]),
                           pad_batch(pad, frames[i + 1:i + 2]), fi)
        low_diff.append(float((low - low_p).abs().max()))
        flow = (res1.flows + res2.flows)[i]
        up_diff.append(float(np.abs(flow - pad.unpad(
            up_p[0].cpu().numpy())).max()))
    rec["split_vs_pair_flow_low_px"] = low_diff
    rec["split_vs_pair_flow_up_px"] = up_diff
    feats, seed = video.sessions.get("cam", SINTEL_BUCKET)
    rec["bytes_per_stream"] = carry_nbytes(feats, seed)
    rec["carry_shapes"] = {k: list(v.shape) for k, v in feats.items()}
    rec["store"] = video.sessions.stats_record()

    # ms per warm frame (a warm chunk of 3) against ms per pair through
    # the pair engine, wall clock with the fetch of flow_up included
    def wall_ms(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)

    ts = wall_ms(lambda: video.process_chunk("cam", np.stack(frames[6:9])))
    rec["warm_ms_per_frame"] = {"median": statistics.median(ts) / 3,
                                "min": ts[0] / 3, "max": ts[-1] / 3}
    engine = InferenceEngine(step, ServeConfig(batch_size=1))
    pair = [{"image1": frames[0], "image2": frames[1]}]
    engine.run_batch(pair)
    ts = wall_ms(lambda: engine.run_batch(pair))
    rec["pair_engine_ms_per_pair"] = {"median": statistics.median(ts),
                                      "min": ts[0], "max": ts[-1]}
    x = pad_batch(pad, frames[:1])
    with torch.inference_mode():
        feats = encode(x)
        rec["encode_ms"] = timed_ms(torch, lambda: encode(x))
        zeros = torch.zeros(1, SINTEL_BUCKET[0] // 8, SINTEL_BUCKET[1] // 8,
                            2, device=dev)
        rec["refine_ms"] = timed_ms(torch, lambda: refine(feats, feats, zeros))

    field = torch.zeros(SINTEL_BUCKET[0] // 8, SINTEL_BUCKET[1] // 8, 2)
    field += torch.tensor([1.3, -0.7])  # a uniform shift: no collisions
    on_card = forward_interpolate(field.to(dev))
    rec["splat_card_vs_cpu"] = float((on_card.cpu()
                                      - forward_interpolate(field)).abs().max())
    rec["splat_ms"] = timed_ms(torch,
                               lambda: forward_interpolate(field.to(dev)))
    emit(rec)
    if launches["flash_fused_step"] != 5 * ITERS or rec["flows"] != [2, 3] \
            or rec["warm"] != [False, True]:
        raise AssertionError(f"video: flows {rec['flows']} warm "
                             f"{rec['warm']} launches {launches} (expected "
                             f"[2, 3], [False, True], {5 * ITERS} B1)")
    if max(low_diff) > TOL_FLOW_PX or rec["splat_card_vs_cpu"] > 1e-6:
        raise AssertionError(f"video: split vs pair {low_diff} px (tol "
                             f"{TOL_FLOW_PX}), splat card vs CPU "
                             f"{rec['splat_card_vs_cpu']}")
    return rec


# the serve phase's traffic
SERVE_CLIENTS = 8
SERVE_REQUESTS = 24
SERVE_GEOMS = ((436, 1024), (375, 1242))  # Sintel 440x1024, KITTI 376x1248
SERVE_BATCH = 2
SERVE_CLI_GEOM = "440x1024"


def arithmetic_flags(torch) -> dict:
    """The process-global flags the eval step sets while it runs."""
    c = torch.backends.cudnn
    return {"cudnn_enabled": c.enabled, "cudnn_benchmark": c.benchmark,
            "cudnn_deterministic": c.deterministic,
            "cudnn_allow_tf32": c.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def http_post(url, path, body, session=None, timeout=300.0):
    """POST an npz body; (response body, headers)."""
    import urllib.request

    headers = {"Content-Type": "application/x-npz"}
    if session:
        headers["X-Session-Id"] = session
    req = urllib.request.Request(url + path, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), dict(r.headers)


def http_json(url, path):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.load(r)


def phase_serve(torch, ck, dev) -> dict:
    """The flow service on v5's main path (flash fused, B1) through the
    CLI's builders (serve_cli: synthetic init, eval step, engine with
    device carry, carry splat, VideoEngine, warmup) and a FlowService on
    an ephemeral port, under the eval step's own arithmetic. Warm-up of
    the Sintel and KITTI buckets, then with B1's count set to 0: 8 client
    threads send 24 pair requests over HTTP, one session sends 3 chained
    requests, and one 3-frame /v1/flow/stream chunk runs while the pair
    traffic does. Checked: every flow_up of its input's (H, W, 2) and
    finite; B1 launched ITERS x (dispatched batches + stream flows) and no
    other kernel; an HTTP flow_up against engine.run_batch on the same
    pair, the warm session request against the eval step with flow_init =
    forward_interpolate(the previous flow_low), and the stream chunk
    against the same chunk run alone, each <= TOL_FLOW_PX; the global
    cuDNN/matmul flags as before; every admitted request completed after
    drain_and_stop. Measured: requests/s and the scheduler's p50/p99
    latency at concurrency 8, the engine's fetch and dispatch seconds
    (also of an engine.stream at inflight 1 and 2), carry bytes per warm
    request, device memory."""
    import threading

    from dexiraft_tpu_torch import serve_cli
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.eval.interpolate import forward_interpolate
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from dexiraft_tpu_torch.serve.server import (FlowService, decode_response,
                                                 decode_stream_response,
                                                 encode_request,
                                                 encode_stream_request)
    from dexiraft_tpu_torch.train.step import make_eval_step

    flags_before = arithmetic_flags(torch)
    args = serve_cli.build_parser().parse_args(
        ["--synthetic_init", "--variant", "v5", "--corr_impl", "flash",
         "--fused_update", "--batch_size", str(SERVE_BATCH), "--iters",
         str(ITERS), "--bucket_multiple", "8", "--port", "0"])
    cfg, model = serve_cli._load(args, dev)
    eval_fn = serve_cli._make_eval_fn(args, model, args.iters, dev)
    engine = InferenceEngine(
        eval_fn, ServeConfig.from_args(args, mode=args.mode, warm_start=True,
                                       device_carry=True), device=dev)
    splat = serve_cli._make_carry_fn(dev, device=True)
    carries = []  # (flow_low, carry) of every splat, in order

    def carry_fn(low):
        out = splat(low)
        carries.append((low.clone(), out))
        return out

    video = serve_cli._make_video_engine(args, cfg, model, dev, True)
    geoms = [f"{h}x{w}" for h, w in SERVE_GEOMS]
    t0 = time.perf_counter()
    search_s = serve_cli._warmup(engine, geoms, carry_fn, video)
    rec = {"phase": "serve", "model": "v5", "path": "flash_fused",
           "iters": ITERS, "batch_size": SERVE_BATCH, "tf32": False,
           "warmup_s": time.perf_counter() - t0,
           "warmup_pair_search_s": search_s, "warmup_geoms": geoms}
    carries.clear()
    svc = FlowService(engine, port=0, slo_ms=args.slo_ms,
                      max_queue=args.max_queue, max_iters=args.iters,
                      min_iters=args.min_iters,
                      session_ttl_s=args.session_ttl_s, carry_fn=carry_fn,
                      request_timeout_s=args.request_timeout_s,
                      video=video).start()
    try:
        items = [it for k in range(SERVE_REQUESTS // len(PAIRS))
                 for it in frame_pairs(seed=100 + k)]
        chain = sintel_frames(seed=7, n=4)
        chunk = sintel_frames(seed=9, n=3)
        flows = [None] * len(items)
        session_flows, errors = [], []
        stream_out = {}
        started = threading.Event()
        ck.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)

        def client(k):
            try:
                for i in range(k, len(items), SERVE_CLIENTS):
                    started.set()
                    body, _ = http_post(svc.url, "/v1/flow", encode_request(
                        items[i]["image1"], items[i]["image2"]))
                    flows[i] = decode_response(body)
            except Exception as e:  # reported below, fails the phase
                errors.append(f"client {k}: {type(e).__name__}: {e}")

        def session():
            try:
                for j in range(3):
                    body, hdr = http_post(
                        svc.url, "/v1/flow",
                        encode_request(chain[j], chain[j + 1]), session="cam")
                    session_flows.append((decode_response(body),
                                          hdr["X-Warm-Start"]))
            except Exception as e:
                errors.append(f"session: {type(e).__name__}: {e}")

        def stream():
            started.wait(60)
            try:
                body, hdr = http_post(svc.url, "/v1/flow/stream",
                                      encode_stream_request(np.stack(chunk)),
                                      session="stream")
                stream_out["flows"] = decode_stream_response(body)
                stream_out["headers"] = {k: hdr[k] for k in (
                    "X-Warm-Start", "X-Frames-In", "X-Flows-Out")}
            except Exception as e:
                errors.append(f"stream: {type(e).__name__}: {e}")

        threads = ([threading.Thread(target=client, args=(k,))
                    for k in range(SERVE_CLIENTS)]
                   + [threading.Thread(target=session),
                      threading.Thread(target=stream)])
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        stats = http_json(svc.url, "/stats")
        health = http_json(svc.url, "/healthz")
    finally:
        drained = svc.drain_and_stop(timeout=300.0)
    sched = stats["scheduler"]
    requests = len(items) + 3
    rec.update(
        launches=launches, wall_s=wall, requests=requests,
        requests_per_s=requests / wall,
        latency_p50_ms=sched["latency_p50_ms"],
        latency_p99_ms=sched["latency_p99_ms"],
        wait_p50_ms=sched["wait_p50_ms"], wait_p99_ms=sched["wait_p99_ms"],
        dispatch_full=sched["dispatch_full"],
        dispatch_slo=sched["dispatch_slo"],
        mean_batch_fill=sched["mean_batch_fill"],
        fetch_s=engine.stats.fetch_s, dispatch_s=engine.stats.dispatch_s,
        engine=stats["engine"], health=health, locks=stats["locks"],
        video=stats["video"], stream_headers=stream_out.get("headers"),
        session_warm=[w for _, w in session_flows],
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev),
        memory_reserved_bytes=torch.cuda.memory_reserved(dev),
        drained=drained, completed=svc.scheduler.stats.completed)
    warm = sum(w == "1" for _, w in session_flows)
    rec["carry_bytes_per_warm_request"] = (
        (engine.stats.carry_h2d_bytes + engine.stats.carry_d2h_bytes)
        / max(warm, 1))
    if errors:
        emit(rec)
        raise AssertionError(f"serve: {errors}")

    # every flow_up of its input's shape and finite
    bad = [i for i, (f, it) in enumerate(zip(flows, items))
           if f is None or f.shape != it["image1"].shape[:2] + (2,)
           or not np.isfinite(f).all()]
    bad += [f"session {j}" for j, (f, _) in enumerate(session_flows)
            if f.shape != chain[0].shape[:2] + (2,)
            or not np.isfinite(f).all()]
    sflows = stream_out["flows"]
    if sflows.shape != (2,) + chunk[0].shape[:2] + (2,) \
            or not np.isfinite(sflows).all():
        bad.append(f"stream {sflows.shape}")
    batches = engine.stats.batches
    expect = ITERS * (batches + len(sflows))
    rec["b1_launches_expected"] = expect

    # HTTP against the engine and the eval step, the stream against a solo
    # run of the same chunk (the service is stopped: nothing else runs)
    (direct,) = engine.run_batch([dict(items[0])])
    rec["http_vs_run_batch_px"] = float(np.abs(flows[0]
                                               - direct.flow_up).max())
    step = make_eval_step(model, ITERS, dev)
    pad = InputPadder(chain[0].shape, args.mode, target=SINTEL_BUCKET)
    prev_low = carries[1][0]
    low, up = step(pad_batch(pad, chain[2:3]), pad_batch(pad, chain[3:4]),
                   forward_interpolate(prev_low)[None])
    rec["warm_session_vs_eval_step_px"] = float(np.abs(
        session_flows[2][0] - pad.unpad(up[0].cpu().numpy())).max())
    solo = video.process_chunk(None, np.stack(chunk))
    rec["stream_vs_solo_px"] = float(max(
        np.abs(a - b).max() for a, b in zip(sflows, solo.flows)))
    rec["flags_before"], rec["flags_after"] = (flags_before,
                                               arithmetic_flags(torch))

    # the in-flight window: engine.stream over Sintel pairs at 1 and 2
    sintel = [it for it in items
              if it["image1"].shape[:2] == PAIRS[0][0]][:8]
    for inflight in (1, 2):
        eng = InferenceEngine(eval_fn, ServeConfig(
            batch_size=SERVE_BATCH, inflight=inflight), device=dev)
        list(eng.stream([dict(it) for it in sintel[:SERVE_BATCH]]))
        eng.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(list(eng.stream([dict(it) for it in sintel])))
        rec[f"stream_inflight{inflight}"] = {
            "pairs": n, "batches": eng.stats.batches,
            "wall_s": time.perf_counter() - t0,
            "fetch_s": eng.stats.fetch_s,
            "dispatch_s": eng.stats.dispatch_s,
            "peak_inflight": eng.stats.peak_inflight}
    emit(rec)

    others = {k: v for k, v in launches.items() if k != "flash_fused_step"}
    if bad:
        raise AssertionError(f"serve: bad flows {bad}")
    if launches["flash_fused_step"] != expect or any(others.values()):
        raise AssertionError(f"serve: launches {launches}, expected "
                             f"{expect} B1 ({batches} batches + "
                             f"{len(sflows)} stream flows) and no other")
    worst = max(rec["http_vs_run_batch_px"],
                rec["warm_session_vs_eval_step_px"], rec["stream_vs_solo_px"])
    if worst > TOL_FLOW_PX:
        raise AssertionError(f"serve: HTTP vs direct {worst} px (tol "
                             f"{TOL_FLOW_PX})")
    if rec["session_warm"] != ["0", "1", "1"]:
        raise AssertionError(f"serve: session warm {rec['session_warm']}")
    if rec["flags_after"] != flags_before:
        raise AssertionError(f"serve: global flags moved: {flags_before} -> "
                             f"{rec['flags_after']}")
    if not drained or rec["completed"] != requests:
        raise AssertionError(f"serve: completed {rec['completed']} of "
                             f"{requests} (drained {drained})")
    return rec


def phase_serve_cli(torch) -> dict:
    """``python -m dexiraft_tpu_torch serve --synthetic_init --variant v1
    --port 0 --warmup 440x1024`` in a child process: its ``listening on``
    line, 2 POSTed pairs (200, flows of the input's shape, finite), the
    child's device memory (its /stats), then SIGTERM: exit 0 within 60
    s."""
    import re
    import signal
    import threading

    from dexiraft_tpu_torch.serve.server import decode_response, encode_request

    cmd = [sys.executable, "-m", "dexiraft_tpu_torch", "serve",
           "--synthetic_init", "--variant", "v1", "--port", "0",
           "--warmup", SERVE_CLI_GEOM]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    lines = []
    rec = {"phase": "serve_cli", "cmd": " ".join(cmd[1:])}
    try:
        url = None
        watchdog = threading.Timer(600, child.kill)  # a hung start fails
        watchdog.start()
        for line in child.stdout:
            lines.append(line.rstrip())
            m = re.search(r"listening on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
        watchdog.cancel()
        if url is None:
            raise AssertionError(f"serve_cli: no 'listening on' line: "
                                 f"{lines[-20:]}")
        rec["startup_s"] = time.perf_counter() - t0
        reader = threading.Thread(
            target=lambda: lines.extend(ln.rstrip() for ln in child.stdout),
            daemon=True)
        reader.start()
        shapes = []
        for seed in (1, 2):
            it = frame_pairs(seed)[0]
            body, hdr = http_post(url, "/v1/flow",
                                  encode_request(it["image1"], it["image2"]))
            f = decode_response(body)
            if f.shape != it["image1"].shape[:2] + (2,) \
                    or not np.isfinite(f).all():
                raise AssertionError(f"serve_cli: flow {f.shape}")
            shapes.append(list(f.shape))
        rec["flows"] = shapes
        rec["health"] = http_json(url, "/healthz")
        rec["child_device_memory_reserved_bytes"] = http_json(
            url, "/stats")["service"]["device_memory_reserved_bytes"]
        t1 = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=60)
        rec["sigterm_to_exit_s"] = time.perf_counter() - t1
        rec["rc"] = rc
        reader.join(5)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    rec["log_tail"] = lines[-6:]
    emit(rec)
    if rc != 0:
        raise AssertionError(f"serve_cli: exit {rc}: {lines[-20:]}")
    return rec


TRAIN_BATCH = 10            # STANDARD_STAGES chairs: batch 10, 368x496
TRAIN_SIZE = (368, 496)
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
TOL_TRAIN_LOSS_REL = 1e-4   # B1 step vs corr_impl="local" step
TOL_TRAIN_GRAD_REL_L2 = 1e-3
TOL_RESUME_REL = 1e-5       # resumed train_cli losses vs the full run's


def train_batch(torch, dev, b, seed):
    """A random chairs-geometry batch on the card: uniform frames, a
    smooth-free random GT flow (N(0, 4) px), every pixel valid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = TRAIN_SIZE
    return {"image1": torch.rand(b, h, w, 3, generator=g, device=dev) * 255,
            "image2": torch.rand(b, h, w, 3, generator=g, device=dev) * 255,
            "flow": torch.randn(b, h, w, 2, generator=g, device=dev) * 4,
            "valid": torch.ones(b, h, w, device=dev)}


def flat_grads(torch, model):
    return torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in model.parameters()])


def profile_train_step(torch, step_fn, state, batch, range_name) -> dict:
    """One train step under torch.profiler: the step's device time, and
    the device time of the kernels launched inside ``range_name`` (the
    fused steps' backward recompute through fused_reference)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e, total=False):
        if total:
            return getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the range appears twice: as a host event whose total device time is
    # that of the kernels launched inside it, and as a device-side
    # annotation spanning them, which is not a kernel and is left out
    averages = prof.key_averages()
    device_ms = sum(dev_us(e) for e in averages
                    if e.device_type == DeviceType.CUDA
                    and e.key != range_name) / 1e3
    recompute_ms = sum(dev_us(e, total=True) for e in averages
                       if e.key == range_name
                       and e.device_type == DeviceType.CPU) / 1e3
    span_ms = sum(dev_us(e) for e in averages
                  if e.key == range_name
                  and e.device_type == DeviceType.CUDA) / 1e3
    if device_ms == 0:
        return {"device_time": "not measured (profiler saw no device time)",
                "wall_ms": wall_ms}
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms}
    if recompute_ms:
        out.update(recompute_ms=recompute_ms,
                   recompute_share=recompute_ms / device_ms,
                   recompute_span_ms=span_ms)
    else:
        out["recompute_share"] = "not measured (no device time in range)"
    return out


def train_case(torch, ck, dev, name, cfg, tc, batch, card) -> dict:
    """ms per step (median of TRAIN_TIMED after TRAIN_WARMUP, CUDA
    events), peak allocated memory, B1 launches per step, every step's
    loss finite and state_finite true, and one profiled step."""
    from dexiraft_tpu_torch.models.raft import create_model
    from dexiraft_tpu_torch.train.state import create_state
    from dexiraft_tpu_torch.train.step import make_train_step

    state = create_state(cfg, tc, device=dev,
                         model=create_model(cfg, seed=0, device=dev))
    step_fn = make_train_step(cfg, tc)
    metrics = []
    for _ in range(TRAIN_WARMUP):
        metrics.append(step_fn(state, batch)[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launches()
    times = []
    for _ in range(TRAIN_TIMED):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        metrics.append(step_fn(state, batch)[1])
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in metrics]
    finite = [bool(m["state_finite"]) for m in metrics]
    if not all(np.isfinite(losses)) or not all(finite):
        raise AssertionError(f"train {name}: losses {losses}, state_finite "
                             f"{finite}")
    per_step = {k: v / TRAIN_TIMED for k, v in launches.items() if v}
    expect = tc.iters if cfg.corr_impl == "flash" and cfg.fused_update else 0
    if per_step.get("flash_fused_step", 0) != expect or any(
            k != "flash_fused_step" for k in per_step):
        raise AssertionError(f"train {name}: launches per step {per_step}, "
                             f"expected {expect} of flash_fused_step only")
    prof = profile_train_step(torch, step_fn, state, batch,
                              ck.RECOMPUTE_RANGE)
    rec = {"phase": "train", "case": name, "card": card,
           "batch": tc.batch_size, "size": list(TRAIN_SIZE),
           "iters": tc.iters, "ms_per_step": statistics.median(times),
           "ms_per_step_min_max": [min(times), max(times)],
           "peak_allocated_gib": peak / 2 ** 30,
           "launches_per_step": per_step, "losses": losses,
           "state_finite": all(finite), "profile": prof}
    emit(rec)
    del state, step_fn
    torch.cuda.empty_cache()
    return {"rec": rec, "launches": launches}


def hold_b1_step_against_local(torch, ck, dev, name, make, tc, batch):
    """One step of B1's path and one of the plain lookup on the same seed-0
    weights and batch: the loss within TOL_TRAIN_LOSS_REL, the flattened
    gradient within TOL_TRAIN_GRAD_REL_L2 (relative L2); B1 launched
    tc.iters times by the first and never by the second."""
    from dexiraft_tpu_torch.models.raft import RAFT, create_model
    from dexiraft_tpu_torch.train.state import create_state
    from dexiraft_tpu_torch.train.step import make_train_step

    out = {}
    weights = create_model(make(corr_impl="local"), seed=0,
                           device="cpu").state_dict()
    for path, kw in (("flash_fused", dict(corr_impl="flash",
                                          fused_update=True)),
                     ("local", dict(corr_impl="local"))):
        cfg = make(**kw)
        model = RAFT(cfg)
        model.load_state_dict(weights, strict=True)
        state = create_state(cfg, tc, device=dev, model=model)
        ck.reset_launches()
        _, m = make_train_step(cfg, tc)(state, batch)
        torch.cuda.synchronize()
        b1 = ck.LAUNCHES["flash_fused_step"]
        if b1 != (tc.iters if path == "flash_fused" else 0):
            raise AssertionError(f"train {name} {path}: {b1} B1 launches")
        out[path] = (float(m["loss"]), flat_grads(torch, state.model))
        del state, model
        torch.cuda.empty_cache()
    (l_b1, g_b1), (l_ref, g_ref) = out["flash_fused"], out["local"]
    loss_rel = abs(l_b1 - l_ref) / abs(l_ref)
    grad_rel = float((g_b1 - g_ref).norm() / g_ref.norm())
    rec = {"phase": "train", "case": name,
           "check": "B1 step vs local step, same weights and batch",
           "loss_b1": l_b1, "loss_local": l_ref, "loss_rel_diff": loss_rel,
           "grad_rel_l2": grad_rel, "tol_loss_rel": TOL_TRAIN_LOSS_REL,
           "tol_grad_rel_l2": TOL_TRAIN_GRAD_REL_L2}
    emit(rec)
    if not (loss_rel <= TOL_TRAIN_LOSS_REL
            and grad_rel <= TOL_TRAIN_GRAD_REL_L2):
        raise AssertionError(f"train {name}: B1 step differs from the "
                             f"local step: {rec}")


def phase_train(torch, ck, dev, card) -> dict:
    """The train step at the chairs geometry: v1 on allpairs (the CLI
    default) and on B1 at batch 10, v5 on B1 at the largest batch <= 10
    that fits without remat; each B1 step held against the local step."""
    import dataclasses

    from dexiraft_tpu_torch.config import STANDARD_STAGES, raft_v1, raft_v5

    tc = dataclasses.replace(STANDARD_STAGES[0], iters=12)
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=1)
    launches = {k: 0 for k in ck.LAUNCHES}
    records = {}

    def add(res):
        for k, v in res["launches"].items():
            launches[k] += v
        records[res["rec"]["case"]] = res["rec"]

    add(train_case(torch, ck, dev, "v1_allpairs",
                   raft_v1(corr_impl="allpairs"), tc, batch, card))
    add(train_case(torch, ck, dev, "v1_flash_fused",
                   raft_v1(corr_impl="flash", fused_update=True), tc, batch,
                   card))
    hold_b1_step_against_local(torch, ck, dev, "v1", raft_v1, tc, batch)
    v5_cfg = raft_v5(corr_impl="flash", fused_update=True)
    fitted = None
    for b in (10, 8, 6, 4, 2):
        tb = dataclasses.replace(tc, batch_size=b)
        try:
            add(train_case(torch, ck, dev, "v5_flash_fused", v5_cfg, tb,
                           {k: v[:b] for k, v in batch.items()}, card))
            fitted = b
        except torch.cuda.OutOfMemoryError:
            emit({"phase": "train", "case": "v5_flash_fused", "batch": b,
                  "fits": False})
        # outside the handler: the exception's frames hold the tensors
        gc.collect()
        torch.cuda.empty_cache()
        if fitted is not None:
            break
    if fitted is None:
        raise AssertionError("train v5: no batch <= 10 fits without remat")
    emit({"phase": "train", "case": "v5_flash_fused",
          "largest_batch_without_remat": fitted})
    hold_b1_step_against_local(
        torch, ck, dev, "v5", raft_v5, dataclasses.replace(tc, batch_size=2),
        {k: v[:2] for k, v in batch.items()})
    return {"launches": launches, "records": records, "v5_batch": fitted}


def phase_train_demo(torch, ck, dev, card) -> dict:
    """RAFT-small v1 on B1, 192x256, batch 4, 12 iterations, 200 steps on
    exact-GT synthetic pairs: the mean EPE of the last 25 steps must be at
    most half that of the first 25."""
    from dexiraft_tpu_torch.train_demo import run_demo

    ck.reset_launches()
    out = run_demo(steps=200, batch=4, size=(192, 256), corr_impl="flash",
                   fused_update=True, device=str(dev), log=lambda m: None)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    epe = out["epe"]
    first, last = float(np.mean(epe[:25])), float(np.mean(epe[-25:]))
    rec = {"phase": "train_demo", "card": card, "steps": len(epe),
           "epe_first25": first, "epe_last25": last,
           "epe_every_25": [float(np.mean(epe[i:i + 25]))
                            for i in range(0, len(epe), 25)],
           "steps_per_s": out["steps_per_s"],
           "first_step_s": out["first_step_s"], "launches": launches}
    emit(rec)
    if launches["flash_fused_step"] != 200 * 12 or not last <= 0.5 * first:
        raise AssertionError(f"train_demo: {rec}")
    return {"launches": launches, "rec": rec}


def phase_train_cli(torch, card) -> dict:
    """python -m dexiraft_tpu_torch train --stage chairs --corr_impl flash
    --fused_update on a synthetic FlyingChairs_release tree in a temporary
    directory, 6 steps with a checkpoint every 3; then --resume from a copy
    of the step-3 checkpoint: the resumed run starts at step 3 and its
    losses match the full run's within TOL_RESUME_REL."""
    import shutil
    import tempfile

    from dexiraft_tpu_torch.data.flow_io import write_flo, write_ppm

    common = ["--stage", "chairs", "--corr_impl", "flash", "--fused_update",
              "--num_steps", "6", "--val_freq", "3", "--sum_freq", "1",
              "--num_workers", "4"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data = os.path.join(tmp, "FlyingChairs_release", "data")
        os.makedirs(data)
        rng = np.random.default_rng(0)
        n = 20
        for i in range(n):
            for k in (1, 2):
                write_ppm(os.path.join(data, f"{i:05d}_img{k}.ppm"),
                          rng.integers(0, 256, (384, 512, 3), np.uint8))
            write_flo(os.path.join(data, f"{i:05d}_flow.flo"),
                      rng.normal(0, 4, (384, 512, 2)).astype(np.float32))
        with open(os.path.join(tmp, "FlyingChairs_release",
                               "chairs_split.txt"), "w") as f:
            f.write("\n".join(["1"] * n))
        env = dict(os.environ, DEXIRAFT_DATA_DIR=tmp,
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))

        def run(name, extra):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "dexiraft_tpu_torch", "train",
                 "--name", name, "--log_dir", "runs"] + common + extra,
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=420)
            if proc.returncode != 0:
                raise AssertionError(
                    f"train_cli {name} exited {proc.returncode}: "
                    f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
            with open(os.path.join(tmp, "runs", name, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            return ({r["step"]: r["loss"] for r in rows if "loss" in r},
                    proc.stdout, time.perf_counter() - t0)

        full, out_full, s_full = run("full", [])
        shutil.copytree(os.path.join(tmp, "checkpoints", "full", "3"),
                        os.path.join(tmp, "checkpoints", "resumed", "3"))
        resumed, out_res, s_res = run("resumed", ["--resume"])
    rel = {s: abs(resumed[s] - full[s]) / abs(full[s]) for s in resumed}
    rec = {"phase": "train_cli", "card": card, "full_losses": full,
           "resumed_losses": resumed, "rel_diff": rel,
           "resumed_from_step_3": "Resumed full state at step 3" in out_res,
           "seconds": [s_full, s_res], "tol_rel": TOL_RESUME_REL}
    emit(rec)
    if (sorted(full) != [1, 2, 3, 4, 5, 6] or sorted(resumed) != [4, 5, 6]
            or not rec["resumed_from_step_3"]
            or not all(np.isfinite(list(full.values())))
            or max(rel.values()) > TOL_RESUME_REL):
        raise AssertionError(f"train_cli: {rec}")
    return rec


def profile_forward(torch, forward, kernel_key: str) -> dict:
    """One forward under torch.profiler: device time by kernel (the eight
    largest), the share of the correlation kernels whose name holds
    ``kernel_key``, and device-busy time over the host wall time of the
    same forward. Only device-side (kernel, memcpy, memset) events are
    summed: host operators also carry the device time of the kernels they
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        forward()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    if total_ms == 0:
        return {"device_time": "not measured (profiler saw no device time)",
                "wall_ms": wall_ms}
    top = sorted(events, key=dev_us, reverse=True)[:8]
    kernel_ms = sum(dev_us(e) for e in events if kernel_key in e.key) / 1e3
    return {"wall_ms": wall_ms, "device_ms": total_ms,
            "device_busy_share": total_ms / wall_ms,
            "corr_kernel": kernel_key, "corr_kernel_ms": kernel_ms,
            "corr_kernel_share": kernel_ms / total_ms,
            "top_kernels_ms": {e.key[:80]: dev_us(e) / 1e3 for e in top}}


def time_forwards(torch, models, paths, x1, x2, rec, prefix) -> None:
    """CUDA-event median forward ms of each path, TF32 off and default."""
    bh, bw = x1.shape[2:]
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        key = "tf32_default" if tf32 else "tf32_off"
        with torch.inference_mode():
            for path in paths:
                ts = sorted(cuda_times_ms(
                    lambda: models[path](x1, x2, iters=ITERS), reps=10,
                    warmup=2))
                name = f"{prefix}forward_ms_{bh}x{bw}_{path}_{key}"
                rec[name] = statistics.median(ts)
                rec[name + "_min_max"] = [ts[0], ts[-1]]
    torch.backends.cudnn.allow_tf32 = False


def time_kernels(torch, ck, gen, dev, b, rec, prefix, fused, level,
                 fields=(), lookup_fields=False) -> None:
    """Per-call µs of a fused kernel (``{prefix}_fused_*``) and a lookup
    kernel at every level (``{prefix}_lookup_*``), and of their plain
    versions, at batch ``b`` of the Sintel bucket, with each one's bound
    from the bytes and FLOPs these inputs need. The fused kernel is also
    timed on each of ``fields`` (``{prefix}_fused_{field}_us_*``, with
    the bound of those coords); with ``lookup_fields`` the lookup too, on
    every field and storage dtype (``{prefix}_lookup_{field}_us_{dtype}_
    level{l}``, jitter without the field)."""
    from dexiraft_tpu_torch.ops.local_corr import local_corr_level

    bh, bw = SINTEL_BUCKET
    fp, lp = prefix + "_fused", prefix + "_lookup"

    def time_lookup(pyr, co, key):
        for lvl, f2 in enumerate(pyr.fmap2_pyramid):
            c_l = co / 2.0 ** lvl
            rec[f"{key}_level{lvl}"] = 1e3 * cuda_time_ms(
                lambda: level(pyr.fmap1, f2, c_l, 4), reps=10, inner=10)

    for field in fields:
        for dtype in ("fp32", "bf16", "int8"):
            pyr, co, w, bias = make_inputs(gen, b, bh // 8, bw // 8, 256, 4,
                                           4, 256, dtype, dev, field=field)
            rec[f"{fp}_{field}_us_{dtype}"] = 1e3 * cuda_time_ms(
                lambda: fused(pyr.fmap1, pyr.fmap2_pyramid, co, w, bias, 4),
                reps=10, inner=10)
            if dtype == "fp32":
                rec[f"{fp}_{field}_bound_us"] = 1e3 * bound_ms(
                    *work_b1(pyr, co, w, 4))[0]
            if lookup_fields:
                time_lookup(pyr, co, f"{lp}_{field}_us_{dtype}")
    inputs = {}
    for dtype in ("fp32", "bf16", "int8"):
        pyr, co, w, bias = make_inputs(gen, b, bh // 8, bw // 8, 256, 4, 4,
                                       256, dtype, dev)
        inputs[dtype] = (pyr, co, w, bias)
        rec[f"{fp}_us_{dtype}"] = 1e3 * cuda_time_ms(
            lambda: fused(pyr.fmap1, pyr.fmap2_pyramid, co, w, bias, 4),
            reps=10, inner=10)
        if lookup_fields and dtype != "fp32":
            time_lookup(pyr, co, f"{lp}_us_{dtype}")
    pyr, co, w, bias = inputs["fp32"]
    rec[f"{fp}_plain_us_fp32"] = 1e3 * cuda_time_ms(
        lambda: ck.fused_reference(pyr.fmap1, pyr.fmap2_pyramid, co, w, bias,
                                   4, 8), reps=10, inner=2)
    nbytes, flops = work_b1(pyr, co, w, 4)
    bm, rec[f"{fp}_bound_by"] = bound_ms(nbytes, flops)
    rec[f"{fp}_bound_us"] = bm * 1e3
    rec[f"{fp}_bytes"], rec[f"{fp}_flops"] = nbytes, flops
    time_lookup(pyr, co, f"{lp}_us")
    for lvl, f2 in enumerate(pyr.fmap2_pyramid):
        c_l = co / 2.0 ** lvl
        rec[f"{lp}_plain_us_level{lvl}"] = 1e3 * cuda_time_ms(
            lambda: local_corr_level(pyr.fmap1, f2, c_l, 4, 8), reps=10,
            inner=2)
        bm, by = bound_ms(*work_b2(pyr.fmap1, f2, c_l, 4))
        rec[f"{lp}_bound_us_level{lvl}"] = bm * 1e3
        rec[f"{lp}_bound_by_level{lvl}"] = by


def phase_times(torch, ck, gen, dev, v1_models, v5_models, card):
    rec = {"phase": "times", "card": card}
    bh, bw = SINTEL_BUCKET
    x1 = torch.rand(1, 3, bh, bw, generator=gen, device=dev) * 255
    x2 = torch.rand(1, 3, bh, bw, generator=gen, device=dev) * 255

    time_forwards(torch, v1_models, ("fused", "lookup", "plain"), x1, x2,
                  rec, "")
    time_forwards(torch, v5_models, ("pallas_fused", "pallas_lookup",
                                     "flash_fused", "plain"), x1, x2, rec,
                  "v5_")
    # the main paths under the eval step's arithmetic (cuDNN's search)
    from dexiraft_tpu_torch.train.step import eval_arithmetic

    with torch.inference_mode(), eval_arithmetic(False):
        for prefix, model in (("", v1_models["fused"]),
                              ("v5_", v5_models["flash_fused"])):
            path = "fused" if not prefix else "flash_fused"
            rec[f"{prefix}forward_ms_{bh}x{bw}_{path}_eval_step"] = timed_ms(
                torch, lambda: model(x1, x2, iters=ITERS))
    # v5's prelude: DexiNed on both frames, and everything but the loop
    # (iters=0: DexiNed, the four encoders, the pyramid, the upsampling)
    v5 = v5_models["pallas_fused"]
    both = torch.cat([x1, x2]) / 255.0 * 2.0 - 1.0
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        key = "tf32_default" if tf32 else "tf32_off"
        with torch.inference_mode():
            rec[f"v5_dexined_ms_{bh}x{bw}_{key}"] = cuda_time_ms(
                lambda: v5.dexined(both))
            rec[f"v5_prelude_ms_{bh}x{bw}_{key}"] = cuda_time_ms(
                lambda: v5(x1, x2, iters=0))
    rec["profile_v1_fused_tf32_default"] = profile_forward(
        torch, lambda: v1_models["fused"](x1, x2, iters=ITERS), B1_KERNEL)
    rec["profile_v5_pallas_fused_tf32_default"] = profile_forward(
        torch, lambda: v5(x1, x2, iters=ITERS), B3_KERNEL)
    rec["profile_v5_pallas_lookup_tf32_default"] = profile_forward(
        torch, lambda: v5_models["pallas_lookup"](x1, x2, iters=ITERS),
        B3_KERNEL)
    # the main path: B1 with the model's own coords
    rec["profile_v5_flash_fused_tf32_default"] = profile_forward(
        torch, lambda: v5_models["flash_fused"](x1, x2, iters=ITERS),
        B1_KERNEL)
    torch.backends.cudnn.allow_tf32 = False

    # kernels at each path's shapes: v1 batch 1 (B1, B2); v5 batch 2, the
    # image and edge stream of one pair (B3, B4, and B1/B2 beside them)
    time_kernels(torch, ck, gen, dev, 1, rec, "v1_flash",
                 ck.flash_fused_step, ck.flash_local_corr_level, B1_FIELDS)
    time_kernels(torch, ck, gen, dev, 2, rec, "v5_pallas",
                 ck.pallas_fused_step, ck.pallas_local_corr_level, V5_FIELDS,
                 lookup_fields=True)
    time_kernels(torch, ck, gen, dev, 2, rec, "v5_flash",
                 ck.flash_fused_step, ck.flash_local_corr_level, V5_FIELDS,
                 lookup_fields=True)
    emit(rec)
    return rec


def kernel_entry(name, lib, replaces, launches, err, rec, prefix, fused):
    """One entry of the kernels line: the times of time_kernels' ``prefix``
    at the path's shapes, fp32 storage, level 0 for a lookup kernel."""
    if fused:
        key, suffix = prefix + "_fused", "fp32"
        bound, by = rec[f"{key}_bound_us"], rec[f"{key}_bound_by"]
    else:
        key, suffix = prefix + "_lookup", "level0"
        bound = rec[f"{key}_bound_us_level0"]
        by = rec[f"{key}_bound_by_level0"]
    return {"name": name, "route": "cuda", "source": SOURCES[lib],
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": rec[f"{key}_us_{suffix}"] / 1e3,
            "plain_ms": rec[f"{key}_plain_us_{suffix}"] / 1e3,
            "bound_ms": bound / 1e3, "bound_by": by, "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's record to this JSON file")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError as e:
        return fail(f"cannot import torch: {e}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke test "
                    "runs only on a CUDA card, never on the CPU")
    if not os.path.isdir(os.path.join(REPO, "dexiraft_tpu_torch", "csrc")):
        return fail(f"no dexiraft_tpu_torch package beside {__file__}: run "
                    "from a checkout of the repository")
    sys.path.insert(0, REPO)

    from dexiraft_tpu_torch.config import raft_v1, raft_v5
    from dexiraft_tpu_torch.ops import corr_kernels as ck

    dev = torch.device("cuda:0")

    # 1. device
    smi = nvidia_smi_line()
    card = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "count": torch.cuda.device_count()}
    emit({"phase": "device", **card})

    # 2. build: one nvcc per kernel library, started together
    t0 = time.perf_counter()
    libs = ck.build_kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(v, REPO) for k, v in libs.items()}})

    # parity phases run with TF32 off: the reference arithmetic is fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    phase_conv_search(torch, dev)  # before any other convolution
    phase_conv_threads(torch, dev)

    worst = phase_kernels(torch, ck, gen, dev)
    worst.update(phase_kernels_v5(torch, ck, gen, dev))
    v1_models, v1_launches, v1_batch = phase_slice(
        torch, ck, dev, "v1", raft_v1,
        {"fused": dict(corr_impl="flash", fused_update=True),
         "lookup": dict(corr_impl="flash")},
        {"fused": ("flash_fused_step", 2 * ITERS),
         "lookup": ("flash_local_corr_level", 2 * ITERS * 4)})
    v5_models, v5_launches, v5_batch = phase_slice(
        torch, ck, dev, "v5", raft_v5,
        {"pallas_fused": dict(corr_impl="pallas", fused_update=True),
         "pallas_lookup": dict(corr_impl="pallas"),
         "flash_fused": dict(corr_impl="flash", fused_update=True)},
        {"pallas_fused": ("pallas_fused_step", 2 * ITERS),
         "pallas_lookup": ("pallas_local_corr_level", 2 * ITERS * 4),
         "flash_fused": ("flash_fused_step", 2 * ITERS)})
    # the eval step's own arithmetic, on each model's main path
    phase_tf32(torch, dev, "v1", v1_models["fused"], v1_batch)
    phase_tf32(torch, dev, "v5", v5_models["flash_fused"], v5_batch)
    # the rest of the model family, the adaptive loop and the streaming
    # engine, each on B1, the production kernel
    phase_variants(torch, ck, dev)
    phase_adaptive(torch, ck, dev)
    phase_video(torch, ck, dev)
    # the flow service on the main path, in process and as the CLI
    serve = phase_serve(torch, ck, dev)
    phase_serve_cli(torch)
    # training: the train step at the chairs geometry, the demo that
    # learns, and the CLI with --resume, each through B1 where fused
    train = phase_train(torch, ck, dev, smi)
    demo = phase_train_demo(torch, ck, dev, smi)
    phase_train_cli(torch, smi)
    times = phase_times(torch, ck, gen, dev, v1_models, v5_models, smi)

    pc = "dexiraft_tpu/ops/pallas_corr.py"
    kernels = [
        kernel_entry("flash_fused_step", "flash_corr", f"{pc}:867",
                     v1_launches["fused"]["flash_fused_step"],
                     worst["flash_fused_step"], times, "v1_flash", True),
        kernel_entry("flash_local_corr_level", "flash_corr", f"{pc}:847",
                     v1_launches["lookup"]["flash_local_corr_level"],
                     worst["flash_local_corr_level"], times, "v1_flash",
                     False),
        kernel_entry("pallas_fused_step", "pallas_corr", f"{pc}:542",
                     v5_launches["pallas_fused"]["pallas_fused_step"],
                     worst["pallas_fused_step"], times, "v5_pallas", True),
        kernel_entry("pallas_local_corr_level", "pallas_corr", f"{pc}:276",
                     v5_launches["pallas_lookup"]["pallas_local_corr_level"],
                     worst["pallas_local_corr_level"], times, "v5_pallas",
                     False),
    ]
    # B1's launches on the service's path, and each kernel's on the train
    # phases' counted steps (the timed train steps and the demo)
    kernels[0]["serve_launches"] = serve["launches"]["flash_fused_step"]
    for entry in kernels:
        entry["train_launches"] = (train["launches"][entry["name"]]
                                   + demo["launches"][entry["name"]])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "times": times,
                       "launches": {"v1": v1_launches, "v5": v5_launches},
                       "kernels": kernels, "records": RECORDS}, f, indent=1)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
