#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out record.json]

Drives the port's two paths on the card through the bucketed
InferenceEngine, at full width with seeded random weights: RAFT v1 and
the v5 dual-stream Dexi-RAFT with its embedded DexiNed. It builds the
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
  tf32        the eval step's arithmetic: flow_low of v1's and v5's main
              paths through make_eval_step with TF32 convolutions on
              (PyTorch's default flags) and off, and with the step's
              default, against the TF32-off plain-lookup path, <= 1e-2 px
              for the default; the global flags as they were
  6 times     CUDA-event medians: v1 and v5 forward ms at 440x1024, B=1
              (TF32 off and PyTorch's default), v5's DexiNed and prelude
              alone, kernel and plain-version times per call at each
              path's shapes (B1 also on the smooth and scattered fields,
              B3 and B4 on the smooth, scattered and edge fields, every
              storage dtype; B2 on every field and dtype at v5's batch),
              torch.profiler breakdowns of v1 fused, v5
              pallas fused, v5 pallas lookup and v5 flash fused (the main
              path, B1 on the model's coords)
Then the {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed phase exits non-zero.
"""

from __future__ import annotations

import argparse
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
