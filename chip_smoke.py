#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out record.json]

Drives the port's main path (RAFT v1 at full width, test mode, through
the bucketed InferenceEngine) on the card, builds the hand-written CUDA
kernels from the sources in this checkout, holds each kernel against its
plain PyTorch version, shows from the launch counters that the main path
went through the kernels, and times them. Imports nothing of JAX or of
the JAX package (dexiraft_tpu).

Phases, one JSON line each:
  1 device   nvidia-smi name and power limit, torch and CUDA versions
  2 build    nvcc build of the kernel library, seconds
  3 kernels  B1 flash_fused_step and B2 flash_local_corr_level against
             fused_reference / local_corr_level at the v1 shapes (B=1 and
             B=2, fp32/bf16/int8 storage, far out-of-frame coords, a
             degenerate level), max abs error <= 1e-3, TF32 off
  4 slice    4 frame pairs (2 Sintel 436x1024, 2 KITTI 375x1242) through
             the engine at batch 2, 32 iterations, seeded random weights:
             path "fused" (B1) and path "lookup" (B2), launch counts read
             around each; flow_low against the plain-lookup model on the
             same weights, <= 1e-2 px, TF32 off
  5 times    CUDA-event medians: forward ms at 440x1024 (TF32 off and
             PyTorch's default), kernel and plain-version times per call
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
SOURCE = "dexiraft_tpu_torch/csrc/flash_corr.cu"
# kernel-check cases: (label, B, H/8, W/8, levels, r, C, F)
KERNEL_CASES = (
    ("sintel_b1", 1, 55, 128, 4, 4, 256, 256),
    ("sintel_b2", 2, 55, 128, 4, 4, 256, 256),
    ("kitti_b2", 2, 47, 156, 4, 4, 256, 256),
    ("degenerate_48x64", 2, 6, 8, 4, 4, 256, 256),
)
# the slice's requests: ((H, W), horizontal shift in px)
PAIRS = (((436, 1024), 3), ((436, 1024), -5), ((375, 1242), 4),
         ((375, 1242), 2))
SINTEL_BUCKET = (440, 1024)


def emit(obj) -> None:
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


def make_inputs(gen, b, h, w, c, levels, radius, feat, dtype, device):
    """fmap1/fmap2 ~ N(0, 1), coords = grid + U(-6, 6) with one row far out
    of frame, the pooled pyramid in ``dtype``, weight (with the int8 scales
    folded in, as the model does) and bias."""
    import torch
    from dexiraft_tpu_torch.ops.grid import coords_grid
    from dexiraft_tpu_torch.ops.local_corr import build_local_corr

    f1 = torch.randn(b, h, w, c, generator=gen, device=device)
    f2 = torch.randn(b, h, w, c, generator=gen, device=device)
    co = coords_grid(b, h, w, device=device) + (
        torch.rand(b, h, w, 2, generator=gen, device=device) * 12 - 6)
    co[:, 0, :, 0] += 1.0e4
    co[:, 0, : w // 2, 1] -= 3.0e4
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


def phase_kernels(torch, ck, gen, dev):
    """B1 and B2 against their plain versions at the main path's shapes."""
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
            err_b1 = float((out - ref).abs().max())
            errs_b2 = []
            for lvl, f2 in enumerate(pyr.fmap2_pyramid):
                c_l = co / 2.0 ** lvl
                s = pyr.level_scale(lvl)
                o = ck.flash_local_corr_level(pyr.fmap1, f2, c_l, r)
                torch.cuda.synchronize()
                rr = local_corr_level(pyr.fmap1, f2.float(), c_l, r, 8)
                if s is not None:  # the scale the lookup path applies
                    o, rr = o * s, rr * s
                errs_b2.append(float((o - rr).abs().max()))
            emit({"phase": "kernels", "case": label, "dtype": dtype,
                  "shape": [b, h, w, c], "levels": [list(x.shape[1:3]) for x in
                                                    pyr.fmap2_pyramid],
                  "tf32": False, "b1_max_abs_err": err_b1,
                  "b2_max_abs_err_per_level": errs_b2, "tol": TOL_KERNEL})
            worst["flash_fused_step"] = max(worst["flash_fused_step"], err_b1)
            worst["flash_local_corr_level"] = max(
                worst["flash_local_corr_level"], max(errs_b2))
            if err_b1 > TOL_KERNEL or max(errs_b2) > TOL_KERNEL:
                raise AssertionError(
                    f"kernel disagrees with its plain version: {label} "
                    f"{dtype} B1 {err_b1} B2 {errs_b2} (tol {TOL_KERNEL})")
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


def phase_slice(torch, ck, dev):
    from dexiraft_tpu_torch.config import raft_v1
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.models.raft import RAFT, create_model
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from dexiraft_tpu_torch.train.step import make_eval_step

    fused_cfg = raft_v1(corr_impl="flash", fused_update=True)
    model = create_model(fused_cfg, seed=0, device=dev)
    state = model.state_dict()

    def sibling(cfg):
        m = RAFT(cfg)
        m.load_state_dict(state, strict=True)
        return m.to(dev).eval()

    models = {"fused": model,
              "lookup": sibling(raft_v1(corr_impl="flash")),
              "plain": sibling(raft_v1(corr_impl="local"))}
    items = frame_pairs(seed=0)
    launches = {}
    results = {}
    for path in ("fused", "lookup"):
        engine = InferenceEngine(make_eval_step(models[path], ITERS, dev),
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
                raise AssertionError(f"{path}: flow_up {r.flow_up.shape} "
                                     f"for a {h}x{w} pair")
            if not np.isfinite(r.flow_up).all() or not np.isfinite(
                    r.flow_low).all():
                raise AssertionError(f"{path}: non-finite flow")
        emit({"phase": "slice", "path": path, "requests": len(res),
              "batches": engine.stats.batches,
              "buckets": engine.registry.stats()["buckets"],
              "launches": launches[path],
              "flow_up_shapes": [list(r.flow_up.shape) for r in res],
              "mean_abs_flow_px": [float(np.abs(r.flow_up).mean()) for r in res]})
    if launches["fused"]["flash_fused_step"] != 2 * ITERS:
        raise AssertionError(f"fused path launched B1 "
                             f"{launches['fused']['flash_fused_step']} times, "
                             f"expected {2 * ITERS}")
    if launches["lookup"]["flash_local_corr_level"] != 2 * ITERS * 4:
        raise AssertionError("lookup path launched B2 "
                             f"{launches['lookup']['flash_local_corr_level']} "
                             f"times, expected {2 * ITERS * 4}")

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
        for path in ("fused", "lookup", "plain"):
            lows[path] = models[path](x1, x2, iters=ITERS)[0]
    diff = {p: float((lows[p] - lows["plain"]).abs().max())
            for p in ("fused", "lookup")}
    engine_vs_direct = max(
        float(np.abs(r.flow_low - lows["fused"][i].permute(1, 2, 0)
                     .cpu().numpy()).max())
        for i, r in enumerate(results["fused"][:2]))
    emit({"phase": "slice", "check": "kernel path vs plain path, same weights",
          "tf32": False, "flow_low_max_abs_diff_px": diff,
          "engine_vs_direct_flow_low_px": engine_vs_direct,
          "flow_low_max_abs_px": float(lows["plain"].abs().max()),
          "tol_px": TOL_FLOW_PX})
    if max(diff.values()) > TOL_FLOW_PX or engine_vs_direct > TOL_FLOW_PX:
        raise AssertionError(f"kernel path flow differs from the plain path: "
                             f"{diff}, engine vs direct {engine_vs_direct}")
    return models, launches


def profile_forward(torch, forward) -> dict:
    """One forward under torch.profiler: device time by kernel (the eight
    largest), the flash kernel's share, and device-busy time over the
    host wall time of the same forward. Only device-side (kernel, memcpy,
    memset) events are summed: host operators also carry the device time
    of the kernels they launched."""
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
    flash_ms = sum(dev_us(e) for e in events if "flash_corr" in e.key) / 1e3
    return {"wall_ms": wall_ms, "device_ms": total_ms,
            "device_busy_share": total_ms / wall_ms,
            "flash_kernel_ms": flash_ms, "flash_kernel_share": flash_ms / total_ms,
            "top_kernels_ms": {e.key[:80]: dev_us(e) / 1e3 for e in top}}


def phase_times(torch, ck, gen, dev, models, card):
    from dexiraft_tpu_torch.ops.local_corr import local_corr_level

    rec = {"phase": "times", "card": card}
    bh, bw = SINTEL_BUCKET
    x1 = torch.rand(1, 3, bh, bw, generator=gen, device=dev) * 255
    x2 = torch.rand(1, 3, bh, bw, generator=gen, device=dev) * 255
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        key = "tf32_default" if tf32 else "tf32_off"
        with torch.inference_mode():
            for path in ("fused", "lookup", "plain"):
                ts = sorted(cuda_times_ms(
                    lambda: models[path](x1, x2, iters=ITERS), reps=10,
                    warmup=2))
                name = f"forward_ms_{bh}x{bw}_{path}_{key}"
                rec[name] = statistics.median(ts)
                rec[name + "_min_max"] = [ts[0], ts[-1]]
    rec["profile_fused_tf32_default"] = profile_forward(
        torch, lambda: models["fused"](x1, x2, iters=ITERS))
    torch.backends.cudnn.allow_tf32 = False

    b1 = {}
    for dtype in ("fp32", "bf16", "int8"):
        pyr, co, w, b = make_inputs(gen, 1, bh // 8, bw // 8, 256, 4, 4, 256,
                                    dtype, dev)
        b1[dtype] = (pyr, co, w, b)
        rec[f"b1_us_{dtype}"] = 1e3 * cuda_time_ms(
            lambda: ck.flash_fused_step(pyr.fmap1, pyr.fmap2_pyramid, co, w,
                                        b, 4), reps=10, inner=10)
    pyr, co, w, b = b1["fp32"]
    rec["plain_fused_reference_us_fp32"] = 1e3 * cuda_time_ms(
        lambda: ck.fused_reference(pyr.fmap1, pyr.fmap2_pyramid, co, w, b, 4, 8),
        reps=10, inner=2)
    nbytes, flops = work_b1(pyr, co, w, 4)
    rec["b1_bound_us"], rec["b1_bound_by"] = bound_ms(nbytes, flops)
    rec["b1_bound_us"] *= 1e3
    rec["b1_bytes"], rec["b1_flops"] = nbytes, flops
    for lvl, f2 in enumerate(pyr.fmap2_pyramid):
        c_l = co / 2.0 ** lvl
        rec[f"b2_us_level{lvl}"] = 1e3 * cuda_time_ms(
            lambda: ck.flash_local_corr_level(pyr.fmap1, f2, c_l, 4),
            reps=10, inner=10)
        rec[f"plain_b2_us_level{lvl}"] = 1e3 * cuda_time_ms(
            lambda: local_corr_level(pyr.fmap1, f2, c_l, 4, 8), reps=10, inner=2)
        nb, fl = work_b2(pyr.fmap1, f2, c_l, 4)
        bm, by = bound_ms(nb, fl)
        rec[f"b2_bound_us_level{lvl}"], rec[f"b2_bound_by_level{lvl}"] = bm * 1e3, by
    emit(rec)
    return rec


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

    from dexiraft_tpu_torch.ops import corr_kernels as ck

    dev = torch.device("cuda:0")

    # 1. device
    smi = nvidia_smi_line()
    card = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "count": torch.cuda.device_count()}
    emit({"phase": "device", **card})

    # 2. build
    t0 = time.perf_counter()
    lib = ck.build_kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib, REPO)})

    # parity phases run with TF32 off: the reference arithmetic is fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    worst = phase_kernels(torch, ck, gen, dev)
    models, launches = phase_slice(torch, ck, dev)
    times = phase_times(torch, ck, gen, dev, models, smi)

    kernels = [
        {"name": "flash_fused_step", "route": "cuda", "source": SOURCE,
         "replaces": "dexiraft_tpu/ops/pallas_corr.py:867",
         "launches": launches["fused"]["flash_fused_step"],
         "max_abs_err": worst["flash_fused_step"],
         "ms": times["b1_us_fp32"] / 1e3,
         "plain_ms": times["plain_fused_reference_us_fp32"] / 1e3,
         "bound_ms": times["b1_bound_us"] / 1e3,
         "bound_by": times["b1_bound_by"], "library_ms": None},
        {"name": "flash_local_corr_level", "route": "cuda", "source": SOURCE,
         "replaces": "dexiraft_tpu/ops/pallas_corr.py:847",
         "launches": launches["lookup"]["flash_local_corr_level"],
         "max_abs_err": worst["flash_local_corr_level"],
         "ms": times["b2_us_level0"] / 1e3,
         "plain_ms": times["plain_b2_us_level0"] / 1e3,
         "bound_ms": times["b2_bound_us_level0"] / 1e3,
         "bound_by": times["b2_bound_by_level0"], "library_ms": None},
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "times": times, "launches": launches,
                       "kernels": kernels}, f, indent=1)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
