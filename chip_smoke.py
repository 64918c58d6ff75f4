#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--out record.json]

Drives the port's paths on the card at full width with seeded random
weights: RAFT v1 and the v5 dual-stream Dexi-RAFT with its embedded
DexiNed through the bucketed InferenceEngine, v2, v3 and v4 through the
eval step, v5's convergence-gated loop, a v5 VideoEngine stream over
the encode/refine split, the flow service (scheduler, sessions, HTTP
server and its CLI) on v5's main path, evaluation on the same path (the
validators and the Sintel submission over synthetic dataset trees, the
eval and viz CLIs), and training (the train step at the chairs
geometry, the exact-GT demo, the train CLI with validation, --keep_best
and --resume), and the packed-record plane with the native decode bridge
and the trainer's recovery paths (a kill mid-flush, a verified resume, a
truncated step), the fleet router over two serve replicas (a replica
killed, respawned and drained under traffic), and the standalone DexiNed
edge workload (its train step, its train and test CLI). It builds the hand-written CUDA kernels from the
sources in this checkout, holds each kernel against its plain PyTorch
version (and each of the two formulations against the other), shows from
the launch counters that each path went through its kernels, and times
them. Imports nothing of
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
              TMA box sizes and per-pixel tiles per level; each pair on a
              row block of queries as the fence step on row slabs calls
              it (rows [h/2, h) of level 0, global coords, full-height
              levels) against its plain version and the same rows of the
              full-height call; max abs error <= 1e-3, TF32 off
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
              for the default; the global flags as they were; then, on
              v1's main path, strict mode (analysis.guards.strict_mode):
              an implicit .item() raises inside the region and
              guards.fetch of the same tensor passes, a warm forward on B1
              passes with its 32 launches, a new shape after mark_warm()
              makes check() raise, and the sync mode is the caller's
              again after the region
  mixed       mixed precision (bf16 over fp32 weights, B1 in fp32): v1's
              and v5's flash fused paths at 440x1024, B=1, 32 iterations
              through make_eval_step, fp32 and bf16: ms per forward
              (median of 5 after 2), B1 32 a forward; the bf16 flow_low's
              relative L2 and max px from the fp32 forward's, within 1.5x
              JAX's own bf16 error at these weights; B1's bf16 forward no
              farther from the fp32 plain-lookup forward than 1.5x the
              plain-lookup bf16 forward is
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
  serve_cli   the CLI in a child process (v1, --warmup 440x1024,
              --strict): 2 requests (200, no drift, no
              RecompileBudgetExceeded), then SIGTERM, exit 0 within 60 s
  eval        v5 on B1, seed-0 weights, over synthetic trees written by
              the port's codecs (Sintel training 2 scenes x 3 frames of
              436x1024, clean and final, PNG rows in all five filters;
              Sintel test 2 x 3; KITTI training 3 frames of 375x1242,
              ~30% valid, one empty): validate_sintel and validate_kitti
              per image and through the engine at batch 2 (EPE within
              1e-3 px, fractions within 2 pixels' share; the plain-lookup
              model within 1e-2 px; B1 launched 32 x Sintel forwards + 24
              x KITTI forwards per path, nothing else; KITTI's empty-mask
              note); the warm-start Sintel submission per image and 2
              sequences abreast (the same files, flows within 1e-2 px,
              every splat on the card, B1 32 x forwards); ms per frame of
              each, the host PNG decode ms of one frame
  eval_cli    python -m dexiraft_tpu_torch eval --variant v5 --model <the
              eval phase's weights> --dataset sintel --submission sintel
              --warm_start --strict in a child: its EPEs equal the
              in-process (non-strict) per-image run's within 1e-3 px, no
              drift; then viz over that
              submission: each PNG decodes to flow_to_image of its .flo;
              then eval --mixed_precision --dataset sintel in a child:
              its EPEs within the argued bf16 bound of the fp32 child's;
              and eval --data_parallel 1 --batch_size 2 --strict in a
              child: its EPEs equal phase eval's engine at batch 2 within
              1e-3 px, no drift
  data_parallel  v5 on B1 over a serve mesh of two entries on the card
              (make_serve_mesh(devices=("cuda:0", "cuda:0"))), engine
              batch 4 over 4 Sintel and 4 KITTI pairs, 32 iterations: the
              replicas equal the source to the bit (the first is the
              source: one copy on the card), every row within
              1e-4 px of the one-device engine at batch 2, B1 launched 32
              x 2 shards x 2 dispatches and no other kernel,
              make_serve_mesh(2) refused on one card; the serve CLI's
              builders at --data_parallel 1 (v1 on B1): HTTP pairs and a
              warm session request within 1e-2 px of the eval step, host
              carry, the streaming endpoint disabled
  train       the train step at the chairs preset's geometry (368x496,
              12 iterations, fp32, seed-0 weights, a random batch): v1 on
              allpairs and on B1 at batch 10, v5 on B1 at the largest
              batch <= 10 that fits without remat; ms per step (median of
              TRAIN_TIMED after 1, CUDA events), peak allocated memory, B1 launches
              per step (12), every loss finite and state_finite, and one
              profiled step with the share of B1's backward recompute
              (fused_reference); each B1 step against the corr_impl=
              "local" step on the same weights and batch: loss within
              1e-4 relative, flattened gradient within 1e-3 relative L2
  train_precision_remat  v5 on B1 at the train phase's geometry, batch
              and seed-0 weights: precision bf16, remat per_iter and
              dots_saveable (fp32): ms per step (median of TRAIN_TIMED
              after 1), peak allocated memory, B1 launches per step (12 in bf16,
              24 under remat: the backward re-runs B1); each remat step's
              loss and gradients against the no-remat step (1e-4, 1e-3
              relative L2), the bf16 step's against the fp32 step within
              1.5x JAX's own bf16 error; v1 on allpairs with remat_lookup:
              its peak beside the no-remat step's, the same equality
  train_demo  RAFT-small v1 on B1, 192x256, batch 4, 12 iterations, 200
              steps on exact-GT warped-texture pairs: mean EPE of the
              last 25 steps <= 0.5x the first 25; 2400 B1 launches
  train_cli   python -m dexiraft_tpu_torch train --stage chairs
              --corr_impl flash --fused_update on a synthetic
              FlyingChairs_release tree (20 training, 4 validation pairs)
              in a temporary directory: 6 steps, a checkpoint every 3
              with --validation chairs --keep_best --keep 1 (a chairs EPE
              logged at 3 and 6, retention.json with both, the best step
              kept beside the newest), then --resume from a copy of step
              3 with --strict: the resumed run starts at step 3, logs the
              full (non-strict) run's losses within 1e-5 relative and
              reports no drift
  records     the packed-record plane on the train_cli phase's tree: the
              native decode library built from native/dexiraft_native.cpp
              and bit-equal to the pure-Python codecs on every file, host
              ms per sample (pure-Python, native, ShardedRecordSet),
              pack_records --shards 4 --verify in a child (seconds,
              bytes); train --records_dir --chaos kill_mid_flush@4 dies in
              step 6's flush (6.tmp-* debris, step 3 the newest), every
              loss the raw full run's within 1e-5 relative; --resume
              --records_dir sweeps the debris, restores step 3, steps 4-6
              within 1e-5, 36 B1 launches; --resume without --records_dir
              refused; step 6 truncated: restore_verified on the card
              falls back to step 3 and deletes 6, an all-truncated copy
              raises and keeps its files
  router      python -m dexiraft_tpu_torch router --port 0 --spawn 2 in
              a child over two serve replicas of seed-0 v1 weights on B1
              (flash fused), spawned and supervised by it: 24 Sintel
              pairs from 8 threads (half in 4 sessions) straight to one
              replica, through the router, and through the router with
              the session-0 replica SIGKILLed mid-traffic; every answer
              200 and within 1e-2 px of the same request run directly
              here; the failover and a sticky miss counted; the replica
              respawned and its breaker closed again; /admin/drain 202,
              0 in flight, the drained replica respawned; SIGTERM stops the
              router and both replicas; requests/s, p50/p99 of each
              round, failover and respawn seconds; B1 = 32 x the
              replicas' forwards
  dexined     the standalone DexiNed workload on a synthetic BIPED tree
              at 720x1280: the CLI's train step at batch 8, 352x352,
              fp32 timed with its peak memory; a card step against the
              CPU step on the same weights and batch (loss 1e-4
              relative, parameters and running variances 1e-3 relative
              L2); the cofusion head's forward against the CPU's; no
              corr kernel launched; the CLI in children: --train (2
              epochs x 3 steps at batch 2, 176x176, two checkpoints),
              then --test --test_pich --gt_root on 4 images of 720x1280
              (per-image ms, ODS/OIS/AP, the PNGs)
  ddp         data-parallel training, v1 on B1 at the chairs crop,
              global batch 4, on the train_cli phase's synthetic tree:
              one process and two ranks on the card (torchrun, gloo)
              for 4 steps, per-step losses within 1e-4 relative, the
              states at steps 2 and 4 within 7e-5 and 3e-4 relative L2
              and each BatchNorm running stat on its own, 12 B1
              launches a step on each rank; rank 1 alone SIGTERMed after
              step 2:
              both stop at step 2 with one checkpoint, and a 2-rank
              --resume logs the uninterrupted 2-rank run's losses within
              1e-5 relative; two ranks with --stall_timeout 20, rank 1
              SIGSTOPped after step 1: rank 0 exits 98 within 50 s with
              a dump naming the step and the region; a 1-rank NCCL
              group: an all_reduce and one synced-BatchNorm step against
              the one-process step; an fsdp pair (--fsdp 2, two ranks
              on cuda:0) beside them: its losses and gathered states at
              steps 2 and 4 against the one process within the same
              bounds, 12 B1 launches a step on each rank, each rank's
              bytes of parameters plus Adam moments under 0.75 of the
              one process's (the figure printed with the card's line),
              a 2-rank --resume from its step-2 per-shard checkpoint
              within 1e-5 relative of the uninterrupted pair, and
              read_model_weights of its step 4 equal to the state two
              ranks gather from that step to the bit
  halo        halo compute sharding, the row-block correlation and the
              fence step on row slabs, v1 full width, ranks on cuda:0
              (gloo): two ranks (data 1 x fsdp 1 x seq 2) take 2 halo
              steps (corr_impl allpairs, fp32, frozen BatchNorm) at
              368x496, batch 2, 12 iterations, then 2 fence steps on row
              slabs (v1 on B1, train-mode BatchNorm, noise), and four
              (data 1 x fsdp 2 x seq 2) one of each, beside the
              one-process steps of the same configs on the same seeded
              states and batches: per-step losses and the gathered
              parameters within atol 1e-4 / rtol 1e-3 of them, B1 12 a
              fence step on every rank; the pair's halo eval step and
              its fence eval step (v1 on B1) on a Sintel pair padded
              with InputPadder(seq=2) to 448x1024, 32 iterations,
              flow_low and flow_up (the fence step's row slabs put back
              together) within 1e-3 px of the one-process eval steps, B1
              32 a fence forward on every rank; each rank's peak
              allocated bytes beside the one process's, the halo
              pyramid's bytes beside the estimate; no kernel launched on
              the halo path
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
  processes   the processes found below the smoke after each phase (none
              should be), each SIGKILLed, reaped and named on stderr: the
              smoke is the subreaper of all it starts, so the children of
              a SIGKILLed rank or replica come back to it and are stopped
  strict      strict mode's checks, gathered: the in-process region's (tf32
              above: the implicit sync that raised, the fetch, the warm
              B1 forward, the new shape's check, the restored mode), the
              strict serve_cli, eval_cli and train_cli children, this
              process's compile and sync-window counts (guards.counts())
              and the in-process checks' seconds
Then the {"kernels": [...]} line (each entry with its launches on the
slices' paths, the service's, the eval phase's, the router phase's and
the mixed phase's for B1 as serve_launches, eval_launches,
router_launches and mixed_launches, the train, train_precision_remat and
records phases' counted steps as train_launches, the dexined phase's
as dexined_launches, and the ddp phase's runs, every rank's, as
ddp_launches), the nvidia-smi line, and last
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
# CUDA-event timings per forward of the times, adaptive, variants and
# video phases (few: the whole smoke stays inside its time limit)
FORWARD_REPS = 2
SINTEL_BUCKET = (440, 1024)


RECORDS: list = []  # every emitted line, for --out
STRICT: dict = {}   # strict mode's checks, gathered from the phases
T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's record gains ``t_s``, the seconds
    since the smoke started (where the time goes, phase by phase)."""
    if "phase" in obj:
        obj["t_s"] = time.perf_counter() - T0
    RECORDS.append(obj)
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


# ---- the processes the smoke starts ----

STRAYS: list = []  # {"after": phase, "pid", "cmd"} of each stray stopped


def adopt_orphans() -> bool:
    """Make this process the subreaper of everything it starts (Linux
    prctl PR_SET_CHILD_SUBREAPER): a descendant whose parent dies, a
    SIGKILLed rank's or a replica's, is re-parented here and not to
    init, so stop_strays finds it. False where the call is refused."""
    import ctypes

    try:
        return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def descendants() -> list:
    """(pid, state, command line) of every process below this one, by
    /proc's parent links, parents before their children."""
    children = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue  # it ended while we looked
        children.setdefault(int(ppid), []).append((int(name), state,
                                                   cmd.strip()))
    out, todo = [], [os.getpid()]
    while todo:
        for proc in children.get(todo.pop(0), []):
            out.append(proc)
            todo.append(proc[0])
    return out


def stop_strays(after: str) -> list:
    """SIGKILL and reap every process still below this one once a phase
    has ended, where none should be left; each is recorded in STRAYS
    and named on stderr. -> the strays' records."""
    import signal

    found = []
    for _ in range(50):
        live = [p for p in descendants() if p[1] != "Z"]
        for pid, _, cmd in live:
            if all(s["pid"] != pid for s in found):
                found.append({"after": after, "pid": pid, "cmd": cmd[:300]})
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        while True:  # reap whatever has ended below us
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
        if not live:
            break
        time.sleep(0.1)
    for s in found:
        print(f"chip_smoke: stray process after {after}, stopped: "
              f"{s['pid']} {s['cmd']}", file=sys.stderr, flush=True)
    STRAYS.extend(found)
    return found


def contained(phase):
    """``phase``, then stop_strays: no process outlives the phase that
    started it."""
    import functools

    @functools.wraps(phase)
    def run(*args, **kwargs):
        try:
            return phase(*args, **kwargs)
        finally:
            stop_strays(phase.__name__)

    return run


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
    rows = row_block_errors(torch, ck, gen, dev, KERNEL_CASES[0],
                            "flash_fused_step", "flash_local_corr_level")
    return {k: max(v, rows[k]) for k, v in worst.items()}


def row_block_errors(torch, ck, gen, dev, case, fused, level) -> dict:
    """The fused kernel ``fused`` (B1 or B3) and the level kernel
    ``level`` (B2 or B4) on a row block of queries, as the fence step on
    row slabs calls them: rows [h/2, h) of level 0's queries with their
    global coords against the full-height levels, held against each
    kernel's plain version on the same block and against the same rows of
    the kernel's full-height call (fp32, jitter field)."""
    from dexiraft_tpu_torch.ops.local_corr import local_corr_level

    label, b, h, w, levels, r, c, feat = case
    pyr, co, weight, bias = make_inputs(gen, b, h, w, c, levels, r, feat,
                                        "fp32", dev)
    h0 = h // 2
    q, cq = pyr.fmap1[:, h0:].contiguous(), co[:, h0:].contiguous()
    fn = getattr(ck, fused)
    full = fn(pyr.fmap1, pyr.fmap2_pyramid, co, weight, bias, r)
    block = fn(q, pyr.fmap2_pyramid, cq, weight, bias, r)
    torch.cuda.synchronize()
    ref = ck.fused_reference(q, pyr.fmap2_pyramid, cq, weight, bias, r, 8)
    rec = {fused: {"vs_plain": max_diff(block, ref),
                   "vs_full_rows": max_diff(block, full[:, h0:])},
           level: {"vs_plain": 0.0, "vs_full_rows": 0.0}}
    for lvl, f2 in enumerate(pyr.fmap2_pyramid):
        c_l = cq / 2.0 ** lvl
        o = getattr(ck, level)(q, f2, c_l, r)
        o_full = getattr(ck, level)(pyr.fmap1, f2, co / 2.0 ** lvl, r)
        torch.cuda.synchronize()
        rr = local_corr_level(q, f2, c_l, r, 8)
        rec[level]["vs_plain"] = max(rec[level]["vs_plain"], max_diff(o, rr))
        rec[level]["vs_full_rows"] = max(rec[level]["vs_full_rows"],
                                         max_diff(o, o_full[:, h0:]))
    emit({"phase": "kernels", "kernels": f"{fused}/{level} row block",
          "case": label, "query_rows": [h0, h],
          "levels": [list(x.shape[1:3]) for x in pyr.fmap2_pyramid],
          "dtype": "fp32", **rec, "tol": TOL_KERNEL})
    worst = {k: max(v.values()) for k, v in rec.items()}
    if max(worst.values()) > TOL_KERNEL:
        raise AssertionError(f"a kernel on a row block of queries disagrees: "
                             f"{label} {rec} (tol {TOL_KERNEL})")
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
    rows = row_block_errors(torch, ck, gen, dev, V5_KERNEL_CASES[0],
                            "pallas_fused_step", "pallas_local_corr_level")
    return {k: max(v, rows[k]) for k, v in worst.items()}


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
    from dexiraft_tpu_torch.train.step import eval_arithmetic, make_eval_step

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
    # (corr_impl="local", same weights), on the Sintel bucket's batch,
    # under the eval step's arithmetic (TF32 off): the convs run the
    # algorithms the engine's search found, where cuDNN's heuristic for
    # v5's motion encoder at this batch is an FFT of hundreds of ms a call
    pads = [InputPadder(it["image1"].shape, "sintel", target=SINTEL_BUCKET)
            for it in items[:2]]
    im1 = torch.from_numpy(np.stack([p.pad(it["image1"])[0]
                                     for p, it in zip(pads, items)]))
    im2 = torch.from_numpy(np.stack([p.pad(it["image2"])[0]
                                     for p, it in zip(pads, items)]))
    x1 = im1.to(dev).permute(0, 3, 1, 2)
    x2 = im2.to(dev).permute(0, 3, 1, 2)
    lows = {}
    with torch.inference_mode(), eval_arithmetic(False):
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


def strict_region_checks(torch, ck, dev, model, batch) -> dict:
    """Strict mode on the card, over ``model`` (v1's main path, B1) and
    ``batch`` (phase_slice's Sintel-bucket pair): inside
    guards.strict_mode() an implicit .item() on a CUDA tensor raises and
    guards.fetch of it passes; a forward at a warm shape passes with
    ITERS B1 launches per item batch; after mark_warm() a forward at a
    new shape makes check() raise RecompileBudgetExceeded; the sync
    debug mode is the caller's again after the region."""
    from dexiraft_tpu_torch.analysis import guards
    from dexiraft_tpu_torch.train.step import make_eval_step

    t0 = time.perf_counter()
    im1, im2, _ = batch
    step = make_eval_step(model, ITERS, dev)
    step(im1, im2)                       # this step's search: the warm-up
    torch.cuda.synchronize()
    mode_before = torch.cuda.get_sync_debug_mode()
    x = torch.arange(4.0, device=dev)
    rec = {"phase": "tf32", "check": "strict mode, v1 on B1"}
    with guards.strict_mode(label="smoke", device=dev) as watch:
        try:
            x.sum().item()
            rec["implicit_item_raised"] = None
        except RuntimeError as e:
            rec["implicit_item_raised"] = str(e).splitlines()[0][:160]
        rec["fetched"] = float(guards.fetch(x.sum()))
        ck.reset_launches()
        low, up = step(im1, im2)
        rec["warm_forward_finite"] = bool(np.isfinite(
            guards.fetch(up)).all())
        rec["warm_forward_b1_launches"] = ck.LAUNCHES["flash_fused_step"]
        watch.check()                    # a warm shape: no compile
        rec["warm_forward_drift"] = watch.drift
        watch.mark_warm()
        step(im1[:, :-8], im2[:, :-8])   # 432x1024: a new shape
        rec["new_shape_drift"] = watch.drift
        try:
            watch.check()
            rec["new_shape_check_raised"] = False
        except guards.RecompileBudgetExceeded:
            rec["new_shape_check_raised"] = True
        watch.mark_warm()                # expected: the region exits clean
    rec["sync_mode_before_after"] = [mode_before,
                                     torch.cuda.get_sync_debug_mode()]
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    STRICT["region"] = {k: v for k, v in rec.items() if k != "phase"}
    if (rec["implicit_item_raised"] is None or rec["fetched"] != 6.0
            or not rec["warm_forward_finite"]
            or rec["warm_forward_b1_launches"] != ITERS
            or rec["warm_forward_drift"] != 0
            or not rec["new_shape_check_raised"]
            or rec["sync_mode_before_after"][1] != mode_before):
        raise AssertionError(f"strict: {rec}")
    return rec


# mixed precision: the argued factor (tests/test_torch_mixed_precision_
# model.py) and JAX's own bf16 error of flow_low / flow_up (relative L2 from
# its fp32 forward) at this smoke's seed-0 weights, 32 iterations, on
# frame_pairs-like scenes at 128x256, the largest of seeds 0-2 (a CPU run:
# python tests/test_torch_bf16_readings.py card_forward)
MIXED_A = 1.5
E_J_FLOW = {"v1": (6.48e-3, 2.90e-3), "v5": (1.40e-2, 1.16e-2)}
MIXED_REPS, MIXED_WARMUP = 5, 2


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def phase_mixed(torch, ck, dev, card, models, batches) -> dict:
    """v1's and v5's flash fused paths in fp32 (``models``, the slices'
    seeded models) and in mixed precision (the same weights), B=1 on the
    first Sintel pair of ``batches``, through make_eval_step: ms per
    forward, B1's launches over the timed bf16 forwards (counts set to 0
    before them), the bf16 flow's distance from the fp32 flow, and B1's
    bf16 forward against the plain-lookup model's in fp32 and bf16."""
    import dataclasses

    from dexiraft_tpu_torch.models.raft import RAFT
    from dexiraft_tpu_torch.train.step import make_eval_step

    out = {"launches": 0}
    for name in ("v1", "v5"):
        fp32 = models[name]["fused" if name == "v1" else "flash_fused"]
        sd = fp32.state_dict()

        def sibling(**kw):
            m = RAFT(dataclasses.replace(fp32.cfg, **kw))
            m.load_state_dict(sd, strict=True)
            return m.to(dev).eval()

        paths = {"fp32": fp32, "bf16": sibling(mixed_precision=True),
                 "plain_fp32": sibling(corr_impl="local",
                                       fused_update=False),
                 "plain_bf16": sibling(corr_impl="local", fused_update=False,
                                       mixed_precision=True)}
        im1, im2 = batches[name][0][:1], batches[name][1][:1]
        flows, times, launches = {}, {}, {}
        for path, model in paths.items():
            step = make_eval_step(model, ITERS, dev)
            ck.reset_launches()
            flows[path] = step(im1, im2)  # the first call searches cuDNN
            torch.cuda.synchronize()
            launches[path] = dict(ck.LAUNCHES)
            if path in ("fp32", "bf16"):
                ck.reset_launches()
                times[path] = timed_ms(torch, lambda: step(im1, im2),
                                       reps=MIXED_REPS, warmup=MIXED_WARMUP)
                torch.cuda.synchronize()
                if path == "bf16":
                    launches["bf16_timed"] = dict(ck.LAUNCHES)
        low = {p: f[0] for p, f in flows.items()}
        up = {p: f[1] for p, f in flows.items()}
        e_low, e_up = E_J_FLOW[name]
        rel = rel_l2(low["bf16"], low["fp32"])
        d_b1 = rel_l2(low["bf16"], low["plain_fp32"])
        d_plain = rel_l2(low["plain_bf16"], low["plain_fp32"])
        timed = (MIXED_REPS + MIXED_WARMUP) * ITERS
        b1 = launches["bf16_timed"]["flash_fused_step"]
        rec = {"phase": "mixed", "card": card, "model": name,
               "path": "flash_fused", "batch": 1, "size": list(SINTEL_BUCKET),
               "iters": ITERS, "ms_per_forward": times,
               "bf16_speedup": times["fp32"]["median"]
               / times["bf16"]["median"],
               "flow_low_rel_l2": rel,
               "flow_low_max_px": float((low["bf16"] - low["fp32"]).abs()
                                        .max()),
               "flow_up_rel_l2": rel_l2(up["bf16"], up["fp32"]),
               "flow_up_max_px": float((up["bf16"] - up["fp32"]).abs().max()),
               "flow_up_rms_px": float(up["fp32"].double().square().sum(-1)
                                       .mean().sqrt()),
               "flow_up_mean_endpoint_px": float(
                   (up["bf16"] - up["fp32"]).double().square().sum(-1)
                   .sqrt().mean()),
               "bound_rel_l2": MIXED_A * e_low, "e_j_flow_low": e_low,
               "b1_bf16_vs_plain_fp32": d_b1,
               "plain_bf16_vs_plain_fp32": d_plain,
               "b1_launches_timed": b1, "b1_expected": timed,
               "launches_first_call": launches}
        emit(rec)
        stray = {k: v for p in ("bf16", "fp32", "bf16_timed")
                 for k, v in launches[p].items()
                 if k != "flash_fused_step" and v}
        plain_b1 = launches["plain_bf16"]["flash_fused_step"] + launches[
            "plain_fp32"]["flash_fused_step"]
        if (b1 != timed or launches["bf16"]["flash_fused_step"] != ITERS
                or stray or plain_b1):
            raise AssertionError(f"mixed {name}: launches {launches}")
        if not all(bool(torch.isfinite(f).all()) for f in low.values()):
            raise AssertionError(f"mixed {name}: non-finite flow")
        if not (0 < rel <= MIXED_A * e_low):
            raise AssertionError(f"mixed {name}: bf16 flow_low {rel} from "
                                 f"fp32, bound {MIXED_A * e_low}")
        if not d_b1 <= MIXED_A * d_plain:
            raise AssertionError(f"mixed {name}: B1 bf16 {d_b1} from fp32, "
                                 f"plain bf16 {d_plain}")
        out[name] = rec
        out["launches"] += b1 + launches["bf16"]["flash_fused_step"] + \
            launches["fp32"]["flash_fused_step"]
        del paths
        torch.cuda.empty_cache()
    return out


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
            ms = timed_ms(torch, lambda: flash(x1, x2, iters=ITERS, **xe),
                          reps=FORWARD_REPS)
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
        rec["fixed_ms"] = timed_ms(torch, lambda: base(x1, x2, iters=ITERS),
                                   reps=FORWARD_REPS)
        rec["adaptive_tol0_ms"] = timed_ms(
            torch, lambda: tol0(x1, x2, iters=ITERS, adaptive=True),
            reps=FORWARD_REPS)
        rec["adaptive_tol0_no_exit_read_ms"] = timed_ms(
            torch, lambda: tol0(x1, x2, iters=ITERS, adaptive=True,
                                exit_check_every=ITERS), reps=FORWARD_REPS)
        rec["fixed_damped_ms"] = timed_ms(
            torch, lambda: gated(x1, x2, iters=ITERS), reps=FORWARD_REPS)
        rec["adaptive_gated_ms"] = timed_ms(
            torch, lambda: gated(x1, x2, iters=ITERS, adaptive=True),
            reps=FORWARD_REPS)
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
        rec["encode_ms"] = timed_ms(torch, lambda: encode(x),
                                    reps=FORWARD_REPS)
        zeros = torch.zeros(1, SINTEL_BUCKET[0] // 8, SINTEL_BUCKET[1] // 8,
                            2, device=dev)
        rec["refine_ms"] = timed_ms(torch, lambda: refine(feats, feats, zeros),
                                    reps=FORWARD_REPS)

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
    --port 0 --warmup 440x1024 --strict`` in a child process: its
    ``listening on`` line, 2 POSTed pairs (200, flows of the input's
    shape, finite), the child's device memory (its /stats), then SIGTERM:
    exit 0 within 60 s, both requests served, no drift warning and no
    RecompileBudgetExceeded in its log."""
    import re
    import signal
    import threading

    from dexiraft_tpu_torch.serve.server import decode_response, encode_request

    cmd = [sys.executable, "-m", "dexiraft_tpu_torch", "serve",
           "--synthetic_init", "--variant", "v1", "--port", "0",
           "--warmup", SERVE_CLI_GEOM, "--strict"]
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
    log = "\n".join(lines)
    rec["strict_clean"] = ("[guards]" not in log
                           and "RecompileBudgetExceeded" not in log
                           and bool(re.search(r"2 served, 0 shed, 0 failed",
                                              log)))
    STRICT["serve_cli"] = {"strict": True, "clean": rec["strict_clean"],
                           "flows": rec["flows"]}
    emit(rec)
    if rc != 0 or not rec["strict_clean"]:
        raise AssertionError(f"serve_cli: exit {rc}: {lines[-20:]}")
    return rec


TRAIN_BATCH = 10            # STANDARD_STAGES chairs: batch 10, 368x496
TRAIN_SIZE = (368, 496)
# steps timed per train case (few: the smoke's time limit)
TRAIN_WARMUP, TRAIN_TIMED = 1, 2
TOL_TRAIN_LOSS_REL = 1e-4   # B1 step vs corr_impl="local" step
TOL_TRAIN_GRAD_REL_L2 = 1e-3
TOL_RESUME_REL = 1e-5       # resumed train_cli losses vs the full run's
# the train CLI's arguments in the train_cli and records phases
TRAIN_CLI_COMMON = ["--stage", "chairs", "--corr_impl", "flash",
                    "--fused_update", "--num_steps", "6", "--val_freq", "3",
                    "--sum_freq", "1", "--num_workers", "4"]


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


def train_case(torch, ck, dev, name, cfg, tc, batch, card, b1_per_iter=1,
               profile=True, phase="train") -> dict:
    """ms per step (median of TRAIN_TIMED after TRAIN_WARMUP, CUDA
    events), peak allocated memory, B1 launches per step (``b1_per_iter``
    an iteration on B1's path: 2 under remat, whose backward re-runs it),
    every step's loss finite and state_finite true, and one profiled
    step (``profile``)."""
    from dexiraft_tpu_torch.models.raft import create_model
    from dexiraft_tpu_torch.train.state import create_state, train_model_config
    from dexiraft_tpu_torch.train.step import make_train_step

    state = create_state(cfg, tc, device=dev, model=create_model(
        train_model_config(cfg, tc), seed=0, device=dev))
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
    expect = (b1_per_iter * tc.iters
              if cfg.corr_impl == "flash" and cfg.fused_update else 0)
    if per_step.get("flash_fused_step", 0) != expect or any(
            k != "flash_fused_step" for k in per_step):
        raise AssertionError(f"train {name}: launches per step {per_step}, "
                             f"expected {expect} of flash_fused_step only")
    prof = (profile_train_step(torch, step_fn, state, batch,
                               ck.RECOMPUTE_RANGE) if profile
            else "not measured (not profiled in this phase)")
    rec = {"phase": phase, "case": name, "card": card,
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
    return {"launches": launches, "records": records, "v5_batch": fitted,
            "batch": batch}


# the bf16 train step against the fp32 one: MIXED_A x JAX's own bf16 error
# of v5's train step at this smoke's seed-0 weights (loss as a relative
# error, floored at 2^-9: read 1.51e-3 and 1.56e-3; the gradients as one
# vector's relative L2), read at 96x128, batch 2, 12 iterations, on
# train_batch-like inputs, the larger of seeds 0-1 (a CPU run: python
# tests/test_torch_bf16_readings.py card_train; the port's own bf16 gradients sat
# 2.8e-2 to 2.9e-2 from its fp32 ones there)
E_J_TRAIN = {"loss": 2.0 ** -9, "grad": 1.548e-1}


def one_step(torch, ck, dev, cfg, tc, batch, weights):
    """(loss, flattened gradient, B1 launches, peak allocated bytes) of one
    step from ``weights`` on ``batch``."""
    from dexiraft_tpu_torch.models.raft import RAFT
    from dexiraft_tpu_torch.train.state import create_state, train_model_config
    from dexiraft_tpu_torch.train.step import make_train_step

    model = RAFT(train_model_config(cfg, tc))
    model.load_state_dict(weights, strict=True)
    state = create_state(cfg, tc, device=dev, model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launches()
    _, m = make_train_step(cfg, tc)(state, batch)
    torch.cuda.synchronize()
    out = (float(m["loss"]), flat_grads(torch, state.model),
           ck.LAUNCHES["flash_fused_step"],
           torch.cuda.max_memory_allocated(dev))
    del state, model
    torch.cuda.empty_cache()
    return out


def phase_train_precision_remat(torch, ck, dev, card, batch) -> dict:
    """v5 on B1 at the train phase's geometry and batch (10 at 368x496,
    12 iterations, seed-0 weights): the bf16 step and the two remat
    policies timed (train_case), then one step of each from the same
    weights held against the fp32 no-remat step; v1 on allpairs with
    remat_lookup against its no-remat step, peak memory beside it."""
    import dataclasses

    from dexiraft_tpu_torch.config import STANDARD_STAGES, raft_v1, raft_v5
    from dexiraft_tpu_torch.models.raft import create_model

    tc = dataclasses.replace(STANDARD_STAGES[0], iters=12,
                             batch_size=TRAIN_BATCH)
    v5 = raft_v5(corr_impl="flash", fused_update=True)
    cases = {"v5_bf16": (dataclasses.replace(tc, precision="bf16"), 1),
             "v5_remat_per_iter": (dataclasses.replace(tc, remat="per_iter"),
                                   2),
             "v5_remat_dots_saveable": (dataclasses.replace(
                 tc, remat="dots_saveable"), 2)}
    launches = {k: 0 for k in ck.LAUNCHES}
    records = {}
    for name, (tcase, per_iter) in cases.items():
        res = train_case(torch, ck, dev, name, v5, tcase, batch, card,
                         b1_per_iter=per_iter, profile=False,
                         phase="train_precision_remat")
        records[name] = res["rec"]
        for k, v in res["launches"].items():
            launches[k] += v

    holds = {}
    weights = create_model(v5, seed=0, device="cpu").state_dict()
    ref = one_step(torch, ck, dev, v5, tc, batch, weights)
    steps = {name: one_step(torch, ck, dev, v5, tcase, batch, weights)
             for name, (tcase, _) in cases.items()}
    for name, (loss, grad, b1, peak) in steps.items():
        loss_rel = abs(loss - ref[0]) / abs(ref[0])
        grad_rel = rel_l2(grad, ref[1])
        if name == "v5_bf16":
            tol = (MIXED_A * E_J_TRAIN["loss"], MIXED_A * E_J_TRAIN["grad"])
        else:
            tol = (TOL_TRAIN_LOSS_REL, TOL_TRAIN_GRAD_REL_L2)
        holds[name] = {"loss_rel_diff": loss_rel, "grad_rel_l2": grad_rel,
                       "tol": list(tol), "b1_launches": b1,
                       "peak_allocated_gib": peak / 2 ** 30}
        launches["flash_fused_step"] += b1
    launches["flash_fused_step"] += ref[2]
    holds["v5_fp32"] = {"b1_launches": ref[2],
                        "peak_allocated_gib": ref[3] / 2 ** 30}

    v1 = raft_v1(corr_impl="allpairs")
    w1 = create_model(v1, seed=0, device="cpu").state_dict()
    # the no-remat step twice: the peak of a shape's first step holds
    # cuDNN's search workspaces, which neither measured step may carry
    one_step(torch, ck, dev, v1, tc, batch, w1)
    lookup = one_step(torch, ck, dev, dataclasses.replace(
        v1, remat_lookup=True), tc, batch, w1)
    plain = one_step(torch, ck, dev, v1, tc, batch, w1)
    holds["v1_allpairs_remat_lookup"] = {
        "loss_rel_diff": abs(lookup[0] - plain[0]) / abs(plain[0]),
        "grad_rel_l2": rel_l2(lookup[1], plain[1]),
        "tol": [TOL_TRAIN_LOSS_REL, TOL_TRAIN_GRAD_REL_L2],
        "peak_allocated_gib": lookup[3] / 2 ** 30,
        "peak_allocated_gib_no_remat": plain[3] / 2 ** 30}
    rec = {"phase": "train_precision_remat", "card": card,
           "check": "one step from the same weights and batch against the "
                    "fp32 no-remat step", "holds": holds}
    emit(rec)
    for name, h in holds.items():
        if "tol" in h and not (h["loss_rel_diff"] <= h["tol"][0]
                               and h["grad_rel_l2"] <= h["tol"][1]):
            raise AssertionError(f"train_precision_remat {name}: {h}")
        want = {"v5_bf16": 12, "v5_fp32": 12}.get(
            name, 0 if name.startswith("v1") else 24)
        if h.get("b1_launches", want) != want:
            raise AssertionError(f"train_precision_remat {name}: B1 "
                                 f"launched {h['b1_launches']}, not {want}")
    if holds["v5_bf16"]["grad_rel_l2"] == 0:
        raise AssertionError("train_precision_remat: the bf16 step equals "
                             "the fp32 step")
    return {"launches": launches, "records": records, "holds": holds}


# the demo's steps (few: the smoke's time limit; its EPE has fallen to
# under a third of the first 25 steps' by the fourth 25)
DEMO_STEPS = 100


def phase_train_demo(torch, ck, dev, card) -> dict:
    """RAFT-small v1 on B1, 192x256, batch 4, 12 iterations, DEMO_STEPS
    steps on exact-GT synthetic pairs: the mean EPE of the last 25 steps
    must be at most half that of the first 25."""
    from dexiraft_tpu_torch.train_demo import run_demo

    ck.reset_launches()
    out = run_demo(steps=DEMO_STEPS, batch=4, size=(192, 256), corr_impl="flash",
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
    if (launches["flash_fused_step"] != DEMO_STEPS * 12
            or not last <= 0.5 * first):
        raise AssertionError(f"train_demo: {rec}")
    return {"launches": launches, "rec": rec}


def phase_train_cli(torch, card) -> dict:
    """python -m dexiraft_tpu_torch train --stage chairs --corr_impl flash
    --fused_update on a synthetic FlyingChairs_release tree (20 training
    and 4 validation pairs) in a temporary directory, 6 steps with a
    checkpoint every 3, validating chairs at each (--validation chairs
    --keep_best --keep 1): each checkpoint logs a chairs EPE,
    retention.json holds the scores of steps 3 and 6, and the best step
    survives GC beside the newest. Then --resume from a copy of the step-3
    checkpoint, without validation and with --strict (strict mode armed
    after its first step): the resumed run starts at step 3, its losses
    match the full (non-strict) run's within TOL_RESUME_REL, and it
    prints no drift warning."""
    import shutil
    import tempfile

    from dexiraft_tpu_torch.data.synthetic import write_chairs_tree
    from dexiraft_tpu_torch.train import checkpoint as ckpt

    common = TRAIN_CLI_COMMON
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        write_chairs_tree(tmp, n_train=20, n_val=4, hw=(384, 512), seed=0)
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
                    {r["step"]: r["chairs"] for r in rows if "chairs" in r},
                    proc.stdout + proc.stderr, time.perf_counter() - t0)

        full, epe, out_full, s_full = run(
            "full", ["--validation", "chairs", "--keep_best", "--keep", "1"])
        full_dir = os.path.join(tmp, "checkpoints", "full")
        with open(os.path.join(full_dir, "retention.json")) as f:
            scores = {int(k): v for k, v in json.load(f).items()}
        kept = ckpt.all_steps(full_dir)
        shutil.copytree(os.path.join(full_dir, "3"),
                        os.path.join(tmp, "checkpoints", "resumed", "3"))
        resumed, _, out_res, s_res = run("resumed", ["--resume",
                                                     "--strict"])
    rel = {s: abs(resumed[s] - full[s]) / abs(full[s]) for s in resumed}
    best = min(epe, key=epe.get) if epe else None
    rec = {"phase": "train_cli", "card": card, "full_losses": full,
           "resumed_losses": resumed, "rel_diff": rel,
           "resumed_from_step_3": "Resumed full state at step 3" in out_res,
           "chairs_epe": epe, "retention_scores": scores,
           "kept_steps": kept, "best_step": best,
           "seconds": [s_full, s_res], "tol_rel": TOL_RESUME_REL,
           "resumed_strict_no_drift": "[guards]" not in out_res}
    STRICT["train_cli"] = {"strict": "resumed", "max_rel_diff": max(
        rel.values()) if rel else None,
        "no_drift": rec["resumed_strict_no_drift"]}
    emit(rec)
    if (sorted(full) != [1, 2, 3, 4, 5, 6] or sorted(resumed) != [4, 5, 6]
            or not rec["resumed_from_step_3"]
            or not all(np.isfinite(list(full.values())))
            or max(rel.values()) > TOL_RESUME_REL
            or sorted(epe) != [3, 6]
            or not all(np.isfinite(list(epe.values())))
            or sorted(scores) != [3, 6] or best not in kept
            or 6 not in kept or not rec["resumed_strict_no_drift"]):
        raise AssertionError(f"train_cli: {rec}")
    return rec


# ---- records: the packed-record plane, the native bridge, recovery ----


def decode_ms(paths_per_sample, decode) -> "tuple[float, list]":
    """Median host ms of ``decode`` over the samples (each a tuple of
    paths decoded together), and the decoded arrays."""
    times, out = [], []
    for paths in paths_per_sample:
        t0 = time.perf_counter()
        arrays = [decode(p) for p in paths]
        times.append((time.perf_counter() - t0) * 1e3)
        out.append(arrays)
    return statistics.median(times), out


def phase_records(torch, dev, card, raw_losses) -> dict:
    """The packed-record plane and the trainer's recovery paths, on the
    train_cli phase's synthetic chairs tree (20 training and 4 validation
    pairs of 384x512, seed 0):

      * the native decode bridge builds from native/dexiraft_native.cpp
        (a failed build fails the phase) and decodes every PPM and .flo
        of the tree bit-equal to the pure-Python codecs; host ms per
        sample (two frames and a flow), median over the tree, for the
        pure-Python codecs, the native ones and ShardedRecordSet reads;
      * python -m dexiraft_tpu_torch pack_records --stage chairs
        --image_size 368 496 --shards 4 --verify in a child: seconds,
        bytes on disk;
      * train --records_dir with --chaos kill_mid_flush@4 (the train_cli
        phase's arguments, no validation) dies while step 6's flush is in
        flight: a non-zero exit, a 6.tmp-* directory, step 3 the newest
        committed step, and every logged loss the raw full run's
        (``raw_losses``, from phase_train_cli) within TOL_RESUME_REL;
      * --resume --records_dir sweeps the debris, restores step 3 and
        logs the raw run's losses at steps 4-6 within TOL_RESUME_REL;
        step 6 commits; its "[kernels] launches" line gives B1's 12
        launches per counted step; --resume without --records_dir exits
        naming the loader mismatch;
      * step 6 truncated: restore_verified against a v1 template on the
        card falls back to step 3 and deletes step 6; a copy whose every
        step is truncated raises CheckpointIntegrityError and keeps its
        files."""
    import shutil
    import tempfile

    from dexiraft_tpu_torch import train_cli
    from dexiraft_tpu_torch.data import flow_io, native
    from dexiraft_tpu_torch.data.records import ShardedRecordSet
    from dexiraft_tpu_torch.data.synthetic import write_chairs_tree
    from dexiraft_tpu_torch.resilience import chaos
    from dexiraft_tpu_torch.resilience.verify import (
        CheckpointIntegrityError, restore_verified, uncommitted_flushes)
    from dexiraft_tpu_torch.train import checkpoint as ckpt
    from dexiraft_tpu_torch.train.state import create_state

    with tempfile.TemporaryDirectory(prefix="chip_smoke_records_") as tmp:
        data = write_chairs_tree(tmp, n_train=20, n_val=4, hw=(384, 512),
                                 seed=0)
        env = dict(os.environ, DEXIRAFT_DATA_DIR=tmp,
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))

        # the native bridge: built here, from the checkout's source
        if native.get_lib() is None:
            raise AssertionError(
                f"records: the native decode library did not build from "
                f"{native._SRC} (g++ {shutil.which('g++')!r}) into "
                f"{native._SO}")
        samples = [(os.path.join(data, f"{i:05d}_img1.ppm"),
                    os.path.join(data, f"{i:05d}_img2.ppm"),
                    os.path.join(data, f"{i:05d}_flow.flo"))
                   for i in range(24)]

        def native_decode(p):
            return (native.read_flo_native(p) if p.endswith(".flo")
                    else native.read_ppm_native(p))

        def python_decode(p):
            os.environ["DEXIRAFT_NO_NATIVE"] = "1"
            try:
                return (flow_io.read_flo(p) if p.endswith(".flo")
                        else flow_io.read_ppm(p))
            finally:
                del os.environ["DEXIRAFT_NO_NATIVE"]

        ms_python, py_arrays = decode_ms(samples, python_decode)
        ms_native, nat_arrays = decode_ms(samples, native_decode)
        mismatched = [p for sample, a, b in zip(samples, py_arrays,
                                                nat_arrays)
                      for p, x, y in zip(sample, a, b)
                      if y is None or x.dtype != y.dtype
                      or not np.array_equal(x, y)]

        def child(args, timeout=420):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "dexiraft_tpu_torch"] + args,
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=timeout)
            return proc, time.perf_counter() - t0

        def train_losses(name):
            with open(os.path.join(tmp, "runs", name, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            return {r["step"]: r["loss"] for r in rows if "loss" in r}

        # the pack
        rec_dir = os.path.join(tmp, "records")
        proc, s_pack = child(["pack_records", "--stage", "chairs",
                              "--image_size", "368", "496", "--shards", "4",
                              "--out", rec_dir, "--verify"])
        if proc.returncode != 0:
            raise AssertionError(f"records: pack_records exited "
                                 f"{proc.returncode}: {proc.stdout[-2000:]} "
                                 f"{proc.stderr[-2000:]}")
        pack_bytes = sum(os.path.getsize(os.path.join(rec_dir, n))
                         for n in os.listdir(rec_dir))
        rs = ShardedRecordSet(rec_dir)
        ms_records, rec_arrays = decode_ms(
            [(i,) for i in range(len(rs))], rs.read)
        rs.close()
        records_equal = all(
            np.array_equal(r[0][k], x)
            for r, sample in zip(rec_arrays, nat_arrays)
            for k, x in zip(("image1", "image2", "flow"), sample))

        # a records run killed while step 6's flush is in flight
        run_dir = os.path.join(tmp, "checkpoints", "rec")
        train = ["train", "--name", "rec", "--log_dir", "runs",
                 "--records_dir", rec_dir] + TRAIN_CLI_COMMON
        crash, s_crash = child(train + ["--chaos", "kill_mid_flush@4"])
        crash_losses = train_losses("rec")
        debris = uncommitted_flushes(run_dir)
        committed = ckpt.all_steps(run_dir)

        # the verified resume of that directory, under the same pack
        resume, s_resume = child(train + ["--resume"])
        if resume.returncode != 0:
            raise AssertionError(f"records: the resume exited "
                                 f"{resume.returncode}: "
                                 f"{resume.stdout[-2000:]} "
                                 f"{resume.stderr[-3000:]}")
        all_losses = train_losses("rec")
        resumed_losses = {s: all_losses[s] for s in (4, 5, 6)
                          if s in all_losses}
        launch_lines = [line for line in resume.stdout.splitlines()
                        if line.startswith("[kernels] launches ")]
        launches = (json.loads(launch_lines[-1].split(" ", 2)[2])
                    if launch_lines else {})
        steps_after_resume = ckpt.all_steps(run_dir)
        # the same directory without --records_dir: refused
        swap, s_swap = child(["train", "--name", "rec", "--log_dir",
                              "runs_swap", "--resume"] + TRAIN_CLI_COMMON)

        # a truncated newest step: verified restore on the card
        args = train_cli.build_parser().parse_args(TRAIN_CLI_COMMON)
        cfg, tc = train_cli.resolve_configs(args)
        truncated = chaos.truncate_checkpoint(run_dir, 6)
        template = create_state(cfg, tc, device=dev)
        _, fell_back_to, extra = restore_verified(run_dir, template,
                                                  clean_debris=True)
        steps_after_fallback = ckpt.all_steps(run_dir)
        all_bad = os.path.join(tmp, "checkpoints", "all_bad")
        shutil.copytree(run_dir, all_bad)
        for s in ckpt.all_steps(all_bad):
            chaos.truncate_checkpoint(all_bad, s)
        before = sorted(os.listdir(all_bad))
        try:
            restore_verified(all_bad, template, verbose=False)
            all_bad_raised = False
        except CheckpointIntegrityError:
            all_bad_raised = True
        all_bad_kept = sorted(os.listdir(all_bad)) == before
        del template

    def rel(losses):
        return {s: abs(v - raw_losses[s]) / abs(raw_losses[s])
                for s, v in losses.items()}

    rec = {"phase": "records", "card": card,
           "native_library": os.path.relpath(native._SO, REPO),
           "decode_ms_per_sample": {"python": ms_python,
                                    "native": ms_native,
                                    "records": ms_records},
           "native_mismatched_files": mismatched,
           "records_equal_native": records_equal,
           "pack_seconds": s_pack, "pack_bytes": pack_bytes,
           "pack_records": len(rec_arrays),
           "crash_exit": crash.returncode,
           "crash_said": [line for line in crash.stdout.splitlines()
                          if line.startswith("[chaos]")],
           "crash_debris": debris, "crash_committed_steps": committed,
           "crash_losses": crash_losses, "crash_rel_diff": rel(crash_losses),
           "resumed_from_step_3": "Resumed full state at step 3"
                                  in resume.stdout,
           "debris_swept": "removed 1 uncommitted flush" in resume.stdout,
           "resumed_losses": resumed_losses,
           "resumed_rel_diff": rel(resumed_losses),
           "steps_after_resume": steps_after_resume,
           "b1_launches": launches.get("flash_fused_step"),
           "launches": launches, "counted_steps": 3,
           "swap_exit": swap.returncode,
           "swap_refused": "saved by the 'records' loader" in swap.stderr,
           "truncated": [os.path.relpath(p, tmp) for p in truncated],
           "fell_back_to": fell_back_to,
           "fallback_stream": list(extra.get("stream", ())),
           "steps_after_fallback": steps_after_fallback,
           "all_bad_raised": all_bad_raised, "all_bad_kept": all_bad_kept,
           "seconds": {"crash": s_crash, "resume": s_resume,
                       "swap": s_swap},
           "tol_rel": TOL_RESUME_REL}
    emit(rec)
    crash_rel = list(rec["crash_rel_diff"].values())
    resumed_rel = list(rec["resumed_rel_diff"].values())
    if (mismatched or not records_equal or rec["pack_records"] != 20
            or crash.returncode == 0
            or len(debris) != 1 or not debris[0].startswith("6.tmp-")
            or committed != [3]
            or sorted(crash_losses) != [1, 2, 3, 4, 5, 6]
            or max(crash_rel) > TOL_RESUME_REL
            or not rec["resumed_from_step_3"] or not rec["debris_swept"]
            or sorted(resumed_losses) != [4, 5, 6]
            or max(resumed_rel) > TOL_RESUME_REL
            or steps_after_resume != [3, 6]
            or rec["b1_launches"] != 12 * rec["counted_steps"]
            or swap.returncode == 0 or not rec["swap_refused"]
            or fell_back_to != 3 or steps_after_fallback != [3]
            or not all_bad_raised or not all_bad_kept):
        raise AssertionError(f"records: {rec}")
    return rec


# ---- eval: validators, submissions and the eval CLI on v5's main path ----

EVAL_SINTEL_HW = (436, 1024)
EVAL_KITTI_HW = (375, 1242)
TOL_EVAL_PATHS_PX = 1e-3   # EPE, per image vs the engine at batch 2
TOL_EVAL_LOCAL_PX = 1e-2   # EPE, B1 vs the plain-lookup model
TOL_SUBMISSION_PX = 1e-2   # written flows, per image vs sequences abreast


def write_eval_trees(root: str) -> None:
    """The eval phases' datasets, in their own layouts and formats: Sintel
    training (2 scenes x 3 frames, clean and final, .flo ground truth)
    with frames whose PNG rows cycle through all five row filters (the
    decoder's slowest case), Sintel test (2 scenes x 3 frames), KITTI
    training (3 frames, flow_occ 16-bit ~30% valid, frame 1 empty)."""
    from dexiraft_tpu_torch.data.synthetic import write_kitti_tree, \
        write_sintel_tree

    h = EVAL_SINTEL_HW[0]
    write_sintel_tree(root, "training", scenes=2, n_frames=3,
                      hw=EVAL_SINTEL_HW, seed=0, filters=np.arange(h) % 5)
    write_sintel_tree(root, "test", scenes=2, n_frames=3,
                      hw=EVAL_SINTEL_HW, seed=1)
    write_kitti_tree(root, "training", n=3, hw=EVAL_KITTI_HW, empty=1,
                     seed=2)


def png_decode_ms(root: str = None, reps: int = 5) -> dict:
    """Host ms to decode one 436x1024 RGB frame with the port's PNG codec
    (median of ``reps``): a seeded synthetic frame written by the port with
    its rows cycling through all five filters, and the same frame written
    by PIL (adaptive filters) where PIL is installed.

        python3 -c "import chip_smoke; print(chip_smoke.png_decode_ms())"
    """
    import tempfile

    sys.path.insert(0, REPO)
    from dexiraft_tpu_torch.data.png import read_png, write_png
    from dexiraft_tpu_torch.data.synthetic import frames

    img = frames(np.random.default_rng(0), 1, EVAL_SINTEL_HW)[0]
    out = {"hw": list(EVAL_SINTEL_HW)}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        files = {"port_all_filters": os.path.join(tmp, "port.png")}
        write_png(files["port_all_filters"], img,
                  filters=np.arange(img.shape[0]) % 5)
        try:
            from PIL import Image
        except ImportError:
            out["pil_adaptive_ms"] = "not measured (no PIL here)"
        else:
            files["pil_adaptive"] = os.path.join(tmp, "pil.png")
            Image.fromarray(img).save(files["pil_adaptive"])
        for name, path in files.items():
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                got = read_png(path)
                times.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(got, img):
                raise AssertionError(f"png decode of {name} is wrong")
            out[f"{name}_ms"] = statistics.median(times)
    return out


def _quiet(fn, *a, **kw):
    """fn(*a, **kw) with its printed lines captured: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def phase_eval(torch, ck, dev, card, root) -> dict:
    """The evaluation layer on v5's main path (flash fused, B1), seed-0
    weights, under the eval step's arithmetic, over the trees of
    write_eval_trees under ``root``: validate_sintel (32 iterations) and
    validate_kitti (24) per image and through the engine at batch 2, with
    B1's count set to 0 before each path and read after it (32 x Sintel
    forwards + 24 x KITTI forwards, no other kernel); the two paths'
    metrics agree (EPE <= TOL_EVAL_PATHS_PX, px1/3/5 and F1 within two
    pixels' share); the plain-lookup model on the same weights gives EPEs
    within TOL_EVAL_LOCAL_PX; KITTI notes its empty-mask frame. Then the
    Sintel test split's warm-start submission per image and with 2
    sequences abreast: the same .flo files, flows within
    TOL_SUBMISSION_PX, every forward_interpolate on the card, B1 launched
    32 x forwards. Measured: ms per frame of each dataset and path (host
    wall time, data decoding included), the host PNG decode ms of one
    Sintel frame."""
    from dexiraft_tpu_torch.config import raft_v5
    from dexiraft_tpu_torch.data.flow_io import read_flo
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.eval import submission, validate
    from dexiraft_tpu_torch.models.raft import RAFT, create_model
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from dexiraft_tpu_torch.train.step import make_eval_step

    t0 = time.perf_counter()
    write_eval_trees(root)
    os.environ["DEXIRAFT_DATA_DIR"] = root
    rec = {"phase": "eval", "card": card, "model": "v5",
           "path": "flash_fused", "tf32": False,
           "trees_s": time.perf_counter() - t0,
           "png_decode": png_decode_ms(root)}
    model = create_model(raft_v5(corr_impl="flash", fused_update=True),
                         seed=0, device=dev)
    plain = RAFT(raft_v5(corr_impl="local"))
    plain.load_state_dict(model.state_dict(), strict=True)
    plain = plain.to(dev).eval()
    steps = {n: make_eval_step(model, iters, dev)
             for n, iters in (("sintel", 32), ("kitti", 24))}
    n_pairs = {"sintel": 8, "kitti": 3}  # clean + final: 2 x 2 x 2

    def run(path, name):
        engine = None
        if path == "engine":
            engine = InferenceEngine(
                steps[name], ServeConfig(batch_size=2, mode=(
                    "kitti" if name == "kitti" else "sintel")), device=dev)
        ck.reset_launches()
        t0 = time.perf_counter()
        res, text = _quiet(validate.run_validation, name, steps[name],
                           engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forwards = engine.stats.batches if engine else n_pairs[name]
        return {"metrics": res, "printed": text.strip().splitlines(),
                "launches": dict(ck.LAUNCHES), "forwards": forwards,
                "ms_per_frame": wall * 1e3 / n_pairs[name]}

    # one forward of each shape the paths run (batch 1 per image, 2 in
    # the engine) lets cuDNN search it first; then each path runs once,
    # checked and measured
    for name, hw, mode in (("sintel", EVAL_SINTEL_HW, "sintel"),
                           ("kitti", EVAL_KITTI_HW, "kitti")):
        bh, bw = InputPadder(hw + (3,), mode).padded_shape
        for b in (1, 2):
            frame = np.zeros((b, bh, bw, 3), np.float32)
            steps[name](frame, frame)
    results = {path: {n: run(path, n) for n in steps}
               for path in ("per_image", "engine")}
    launches = 0
    for path, per in results.items():
        b1 = sum(r["launches"]["flash_fused_step"] for r in per.values())
        want = 32 * per["sintel"]["forwards"] + 24 * per["kitti"]["forwards"]
        stray = {k: v for r in per.values() for k, v in r["launches"].items()
                 if k != "flash_fused_step" and v}
        rec[f"{path}_b1_launches"] = b1
        rec[f"{path}_b1_expected"] = want
        if b1 != want or stray:
            raise AssertionError(f"eval {path}: B1 launched {b1} times, "
                                 f"expected {want}; others {stray}")
        launches += b1
    share = {"sintel": 2.0 / (4 * EVAL_SINTEL_HW[0] * EVAL_SINTEL_HW[1]),
             "kitti": 100.0 * 2 / (0.8 * 2 * 0.3 * EVAL_KITTI_HW[0]
                                   * EVAL_KITTI_HW[1])}
    local = {n: _quiet(validate.run_validation, n,
                       make_eval_step(plain, 32 if n == "sintel" else 24,
                                      dev))[0] for n in steps}
    worst = {"paths": 0.0, "local": 0.0}
    for name in steps:
        a = results["per_image"][name]["metrics"]
        b = results["engine"][name]["metrics"]
        for k, v in a.items():
            if not np.isfinite(v):
                raise AssertionError(f"eval {name}: {k} = {v}")
            d = abs(b[k] - v)
            epe_like = "px" not in k and not k.endswith("-f1")
            if epe_like:
                worst["paths"] = max(worst["paths"], d)
                worst["local"] = max(worst["local"], abs(local[name][k] - v))
            if d > (TOL_EVAL_PATHS_PX if epe_like else share[name]):
                raise AssertionError(f"eval {name} {k}: per image {v}, "
                                     f"engine {b[k]}")
    rec.update({
        "metrics": {p: {n: r["metrics"] for n, r in per.items()}
                    for p, per in results.items()},
        "local_metrics": local,
        "printed": {p: {n: r["printed"] for n, r in per.items()}
                    for p, per in results.items()},
        "ms_per_frame": {p: {n: r["ms_per_frame"] for n, r in per.items()}
                         for p, per in results.items()},
        "forwards": {p: {n: r["forwards"] for n, r in per.items()}
                     for p, per in results.items()},
        "epe_paths_max_diff_px": worst["paths"],
        "epe_local_max_diff_px": worst["local"]})
    if worst["local"] > TOL_EVAL_LOCAL_PX:
        raise AssertionError(f"eval: B1 vs plain lookup EPE {worst['local']}")
    if not all("(1 empty-mask frames skipped)" in results[p]["kitti"][
            "printed"][-1] for p in results):
        raise AssertionError(f"eval: no empty-mask note: {rec['printed']}")

    # the warm-start submission, per image and 2 sequences abreast
    splats = []
    real_splat = submission.forward_interpolate

    def splat(flow):
        out = real_splat(flow)
        splats.append((flow.device.type, out.device.type))
        return out

    submission.forward_interpolate = splat
    sub = {}
    try:
        for path, batch in (("per_image", 1), ("abreast", 2)):
            out_dir = os.path.join(root, f"submission_{path}")
            splats.clear()
            ck.reset_launches()
            t0 = time.perf_counter()
            _quiet(submission.create_sintel_submission, steps["sintel"],
                   out_dir, warm_start=True, batch_size=batch, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sub[path] = {"dir": out_dir, "splats": list(splats),
                         "b1_launches": ck.LAUNCHES["flash_fused_step"],
                         "ms_per_frame": wall * 1e3 / 8}
    finally:
        submission.forward_interpolate = real_splat
    files = {p: sorted(os.path.relpath(os.path.join(d, f), s["dir"])
                       for d, _, fs in os.walk(s["dir"]) for f in fs)
             for p, s in sub.items()}
    diff = max(float(np.abs(
        read_flo(os.path.join(sub["per_image"]["dir"], f))
        - read_flo(os.path.join(sub["abreast"]["dir"], f))).max())
        for f in files["per_image"])
    rec["submission"] = {
        "files": len(files["per_image"]), "flow_max_diff_px": diff,
        "splat_devices": sorted({d for s in sub.values()
                                 for pair in s["splats"] for d in pair}),
        "splats": {p: len(s["splats"]) for p, s in sub.items()},
        "b1_launches": {p: s["b1_launches"] for p, s in sub.items()},
        "ms_per_frame": {p: s["ms_per_frame"] for p, s in sub.items()}}
    launches += sum(s["b1_launches"] for s in sub.values())
    rec["b1_launches_total"] = launches
    emit(rec)
    s = rec["submission"]
    # per image: one forward per frame; abreast: 2 positions x 2 passes
    if (files["per_image"] != files["abreast"] or s["files"] != 8
            or diff > TOL_SUBMISSION_PX or s["splat_devices"] != [dev.type]
            or s["splats"] != {"per_image": 8, "abreast": 8}
            or s["b1_launches"] != {"per_image": 8 * 32, "abreast": 4 * 32}):
        raise AssertionError(f"eval submission: {s}")
    rec["weights"] = model.state_dict()
    return rec


def _start_child(args, env) -> subprocess.Popen:
    """python -m dexiraft_tpu_torch ``args`` in a child, started."""
    return subprocess.Popen([sys.executable, "-m", "dexiraft_tpu_torch"]
                            + args, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish_child(proc, timeout=420) -> str:
    """Wait for a child of _start_child; it must exit 0. -> its stdout."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{proc.args[3]} exited {proc.returncode}: "
                             f"{out[-2000:]} {err[-3000:]}")
    return out


def _child(args, env, timeout=420):
    return _finish_child(_start_child(args, env), timeout)


def phase_eval_cli(torch, card, root, ev, mixed_rms_px) -> dict:
    """python -m dexiraft_tpu_torch eval --variant v5 --model <phase
    eval's seed-0 weights as a state-dict file> --dataset sintel
    --submission sintel --warm_start --strict in a child process
    (corr_impl auto: B1 on the card; every forward in a strict region):
    exit 0, no drift, its clean and final EPEs equal phase eval's
    (non-strict) per-image run within TOL_EVAL_PATHS_PX (and the printed
    rounding);
    then python -m dexiraft_tpu_torch viz over that submission: one PNG
    per .flo, each decoding (read_png) to flow_to_image of its .flo.
    Beside the fp32 child, the same evaluation with --mixed_precision:
    each EPE within the argued bound of the fp32 child's."""
    import re

    from dexiraft_tpu_torch.data.flow_io import read_flo
    from dexiraft_tpu_torch.data.png import read_png
    from dexiraft_tpu_torch.eval.flow_viz import flow_to_image

    weights = os.path.join(root, "v5_seed0.pth")
    torch.save({k: v.cpu() for k, v in ev.pop("weights").items()}, weights)
    out_dir = os.path.join(root, "cli_submission")
    env = dict(os.environ, DEXIRAFT_DATA_DIR=root,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t0 = time.perf_counter()
    # the mixed-precision child (below) and the data-parallel one (one
    # entry, the engine at batch 2, both halves of strict mode armed on
    # the mesh path) run beside the fp32 one
    mixed_child = _start_child(["eval", "--variant", "v5", "--model",
                                weights, "--dataset", "sintel",
                                "--mixed_precision"], env)
    dp_child = _start_child(["eval", "--variant", "v5", "--model", weights,
                             "--dataset", "sintel", "--data_parallel", "1",
                             "--batch_size", "2", "--strict"], env)
    proc = _start_child(["eval", "--variant", "v5", "--model", weights,
                         "--dataset", "sintel", "--submission", "sintel",
                         "--warm_start", "--output", out_dir, "--strict"],
                        env)
    try:
        out, err = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"eval --strict exited {proc.returncode}: "
                             f"{out[-2000:]} {err[-3000:]}")
    eval_s = time.perf_counter() - t0
    printed = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"Validation \((\w+)\) EPE: ([\d.]+)", out)}
    want = ev["metrics"]["per_image"]["sintel"]
    diff = {k: abs(printed.get(k, np.inf) - want[k])
            for k in ("clean", "final")}
    t1 = time.perf_counter()
    viz_out = _child(["viz", "--input", out_dir], env)
    viz_s = time.perf_counter() - t1
    flos = sorted(os.path.join(d, f) for d, _, fs in os.walk(out_dir)
                  for f in fs if f.endswith(".flo"))
    pngs_equal = [np.array_equal(read_png(f[:-4] + ".png"),
                                 flow_to_image(read_flo(f))) for f in flos]
    # the same evaluation in mixed precision (no submission): each EPE
    # within the argued bound of the fp32 child's, |dEPE| <= the mean
    # endpoint distance of the two flows <= their RMS distance, taken as
    # MIXED_A x JAX's bf16 error x the RMS of v5's fp32 flow_up (phase
    # mixed, the same weights at the same geometry), plus the rounding
    mixed_out = _finish_child(mixed_child)
    mixed_s = time.perf_counter() - t0
    # --data_parallel 1 against phase eval's engine at batch 2
    try:
        dp_out, dp_err = dp_child.communicate(timeout=420)
    finally:
        if dp_child.poll() is None:
            dp_child.kill()
            dp_child.wait()
    if dp_child.returncode != 0:
        raise AssertionError(f"eval --data_parallel 1 exited "
                             f"{dp_child.returncode}: {dp_out[-2000:]} "
                             f"{dp_err[-3000:]}")
    dp_s = time.perf_counter() - t0
    dp_epe = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"Validation \((\w+)\) EPE: ([\d.]+)", dp_out)}
    engine_epe = ev["metrics"]["engine"]["sintel"]
    dp_diff = {k: abs(dp_epe.get(k, np.inf) - engine_epe[k])
               for k in ("clean", "final")}
    mixed_epe = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"Validation \((\w+)\) EPE: ([\d.]+)", mixed_out)}
    mixed_bound = (MIXED_A * E_J_FLOW["v5"][1] * mixed_rms_px + 1e-3)
    mixed_diff = {k: abs(mixed_epe.get(k, np.inf) - printed.get(k, np.inf))
                  for k in ("clean", "final")}
    rec = {"phase": "eval_cli", "card": card, "printed_epe": printed,
           "mixed_precision_epe": mixed_epe, "mixed_epe_diff": mixed_diff,
           "mixed_epe_bound": mixed_bound, "mixed_seconds": mixed_s,
           "data_parallel_epe": dp_epe, "data_parallel_epe_diff": dp_diff,
           "data_parallel_seconds": dp_s,
           "data_parallel_mesh": "data-parallel over 1 entries: cuda:0"
           in dp_out, "data_parallel_strict_no_drift": "[guards]"
           not in dp_err,
           "in_process_epe": {k: want[k] for k in ("clean", "final")},
           "epe_diff_px": diff, "auto_resolved": "[eval] corr_impl auto -> "
           "flash + fused_update" in out,
           "flo_files": len(flos), "pngs_equal": sum(pngs_equal),
           "viz_lines": viz_out.count(" -> "), "seconds": [eval_s, viz_s],
           "strict_no_drift": "[guards]" not in err}
    STRICT["eval_cli"] = {"strict": True, "epe": printed,
                          "in_process_epe": rec["in_process_epe"],
                          "epe_diff_px": diff,
                          "no_drift": rec["strict_no_drift"],
                          "data_parallel_epe": dp_epe,
                          "data_parallel_no_drift":
                              rec["data_parallel_strict_no_drift"]}
    emit(rec)
    # the printed EPE is rounded to 3 decimals
    if (max(diff.values()) > TOL_EVAL_PATHS_PX + 5e-4 or len(flos) != 8
            or not all(pngs_equal) or not rec["auto_resolved"]
            or not max(mixed_diff.values()) <= mixed_bound
            or max(dp_diff.values()) > TOL_EVAL_PATHS_PX + 5e-4
            or not rec["data_parallel_mesh"]
            or not rec["data_parallel_strict_no_drift"]
            or not rec["strict_no_drift"]):
        raise AssertionError(f"eval_cli: {rec}")
    return rec


DP_SHARDS = ("cuda:0", "cuda:0")  # the serve mesh's entries: one card
DP_BATCH = 4                       # engine batch: 2 rows a shard
TOL_DP_PX = 1e-4                   # a shard's row vs the one-device engine


def phase_data_parallel(torch, ck, dev, card) -> dict:
    """Data-parallel inference (``--data_parallel``; JAX's serve mesh) on
    v5's main path (flash fused, B1), seed-0 weights, 32 iterations, under
    the eval step's arithmetic: ``make_serve_mesh(devices=DP_SHARDS)``
    (two entries on the one card), the model replicated onto both, and an
    engine at batch DP_BATCH over 4 Sintel (440x1024) and 4 KITTI
    (376x1248) pairs, so each shard's batch of 2 is phase eval's engine
    batch and reuses its cuDNN searches on this thread. Checked: the
    replicas' parameters and buffers equal the source's to the bit, the
    first replica the source itself (no second copy on the card); every
    row's flow_low and flow_up within TOL_DP_PX of the one-device engine
    at batch 2 on the same pairs; B1 launched ITERS x 2 shards x 2
    dispatches with B1's count set to 0 just before and read just after,
    no other kernel; ``make_serve_mesh(2)`` without ``devices=`` refused
    on a one-card machine (JAX's range message). Then the serve CLI's own
    builders with ``--data_parallel 1`` (v1 on B1, ``serve_cli.main`` up
    to its service loop): two HTTP pair requests and a session's cold and
    warm request, each within TOL_FLOW_PX of the eval step (the warm one
    with forward_interpolate of the cold one's flow_low), host carry,
    the streaming endpoint disabled with JAX's reason. Measured: host ms
    per pair of each engine (the shards share one card: no gain is
    expected or claimed), the replicas' device bytes."""
    from dexiraft_tpu_torch import serve_cli
    from dexiraft_tpu_torch.config import raft_v1, raft_v5
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.eval.interpolate import forward_interpolate
    from dexiraft_tpu_torch.models.raft import create_model
    from dexiraft_tpu_torch.parallel.layout import make_serve_mesh, replicate
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from dexiraft_tpu_torch.serve.server import decode_response, encode_request
    from dexiraft_tpu_torch.train.step import make_eval_step

    t_phase = time.perf_counter()
    rec = {"phase": "data_parallel", "card": card, "model": "v5",
           "path": "flash_fused", "iters": ITERS, "entries": list(DP_SHARDS),
           "engine_batch": DP_BATCH}
    try:
        make_serve_mesh(2)
        rec["mesh_2_refused"] = None
    except ValueError as e:
        rec["mesh_2_refused"] = str(e)
    model = create_model(raft_v5(corr_impl="flash", fused_update=True),
                         seed=0, device=dev)
    mesh = make_serve_mesh(devices=DP_SHARDS)
    mem0 = torch.cuda.memory_allocated(dev)
    reps = replicate(model, mesh)
    rec["replica_bytes"] = torch.cuda.memory_allocated(dev) - mem0
    src = model.state_dict()
    rec["replicas_equal"] = all(
        r.state_dict().keys() == src.keys()
        and all(torch.equal(v, src[k]) for k, v in r.state_dict().items())
        and r.state_dict()[next(iter(src))].device == torch.device(d)
        for r, d in zip(reps, DP_SHARDS))
    # the first entry on the source's card is the source: one copy there
    rec["replica_0_is_source"] = reps[0] is model
    items = [it for seed in (200, 201) for it in frame_pairs(seed)]

    def run(engine):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = {r.index: r for r in engine.stream(dict(it) for it in items)}
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / len(items)

    one = InferenceEngine(make_eval_step(model, ITERS, dev),
                          ServeConfig(batch_size=2), device=dev)
    want, rec["one_device_ms_per_pair"] = run(one)
    sharded = InferenceEngine(make_eval_step(reps, ITERS, mesh=mesh),
                              ServeConfig(batch_size=DP_BATCH), mesh=mesh)
    ck.reset_launches()
    got, rec["mesh_ms_per_pair"] = run(sharded)
    launches = dict(ck.LAUNCHES)
    rec.update(launches=launches, dispatches=sharded.stats.batches,
               b1_launches=launches["flash_fused_step"],
               b1_expected=ITERS * mesh.size * sharded.stats.batches)
    rec["row_max_diff_px"] = {
        key: max(float(np.abs(np.asarray(getattr(got[i], key))
                              - np.asarray(getattr(want[i], key))).max())
                 for i in want) for key in ("flow_low", "flow_up")}
    rec["finite"] = all(np.isfinite(r.flow_up).all() for r in got.values())
    del reps, sharded, one

    # the serve CLI's builders at --data_parallel 1, up to its loop
    frames = sintel_frames(seed=31, n=3)
    pairs = frame_pairs(seed=32)[:2]
    answers = {}

    def serve_loop(args, cfg, dev_, engine, service, sessions_on):
        service.start()
        try:
            answers["pairs"] = [decode_response(http_post(
                service.url, "/v1/flow", encode_request(
                    it["image1"], it["image2"]))[0]) for it in pairs]
            answers["session"] = []
            for j in range(2):
                body, hdr = http_post(service.url, "/v1/flow", encode_request(
                    frames[j], frames[j + 1]), session="dp")
                answers["session"].append((decode_response(body),
                                           hdr["X-Warm-Start"]))
        finally:
            answers["drained"] = service.drain_and_stop(timeout=120.0)
        answers["device_carry"] = engine.config.device_carry
        answers["mesh"] = [str(d) for d in engine.mesh.devices]
        answers["video"] = service.video is not None

    real_loop = serve_cli._run_service
    serve_cli._run_service = serve_loop
    t0 = time.perf_counter()
    try:
        _, printed = _quiet(serve_cli.main, [
            "--synthetic_init", "--variant", "v1", "--corr_impl", "flash",
            "--fused_update", "--iters", str(ITERS), "--batch_size", "2",
            "--bucket_multiple", "8", "--port", "0", "--data_parallel", "1",
            "--warmup", f"{SINTEL_BUCKET[0]}x{SINTEL_BUCKET[1]}"])
    finally:
        serve_cli._run_service = real_loop
    rec["serve_cli_s"] = time.perf_counter() - t0
    v1 = create_model(raft_v1(corr_impl="flash", fused_update=True), seed=0,
                      device=dev)
    step = make_eval_step(v1, ITERS, dev)
    pad = InputPadder(frames[0].shape, "sintel", target=SINTEL_BUCKET)
    diffs = []
    for it, flow in zip(pairs, answers["pairs"]):
        _, up = step(pad_batch(pad, [it["image1"]]),
                     pad_batch(pad, [it["image2"]]))
        diffs.append(float(np.abs(flow - pad.unpad(up[0].cpu().numpy()))
                           .max()))
    low, up = step(pad_batch(pad, frames[0:1]), pad_batch(pad, frames[1:2]))
    diffs.append(float(np.abs(answers["session"][0][0]
                              - pad.unpad(up[0].cpu().numpy())).max()))
    _, up = step(pad_batch(pad, frames[1:2]), pad_batch(pad, frames[2:3]),
                 forward_interpolate(low[0])[None])
    diffs.append(float(np.abs(answers["session"][1][0]
                              - pad.unpad(up[0].cpu().numpy())).max()))
    reason = ("[serve] streaming endpoint disabled: --data_parallel "
              "(batch-1 chunks do not shard)")
    rec["serve_cli"] = {
        "vs_eval_step_px": diffs, "mesh": answers["mesh"],
        "device_carry": answers["device_carry"],
        "session_warm": [w for _, w in answers["session"]],
        "streaming_disabled": reason in printed and not answers["video"],
        "drained": answers["drained"]}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    others = {k: v for k, v in launches.items()
              if k != "flash_fused_step" and v}
    if (not rec["replicas_equal"] or not rec["replica_0_is_source"]
            or not rec["finite"]
            or max(rec["row_max_diff_px"].values()) > TOL_DP_PX
            or rec["b1_launches"] != rec["b1_expected"] or others
            or rec["dispatches"] != 2
            or (torch.cuda.device_count() < 2 and not (
                rec["mesh_2_refused"] or "").startswith(
                    "n_chips 2 out of range"))):
        raise AssertionError(f"data_parallel: {rec}")
    cli = rec["serve_cli"]
    if (max(diffs) > TOL_FLOW_PX or cli["device_carry"]
            or cli["mesh"] != ["cuda:0"] or cli["session_warm"] != ["0", "1"]
            or not cli["streaming_disabled"] or not cli["drained"]):
        raise AssertionError(f"data_parallel serve_cli: {cli}")
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
                    lambda: models[path](x1, x2, iters=ITERS),
                    reps=FORWARD_REPS, warmup=1))
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
                torch, lambda: model(x1, x2, iters=ITERS), reps=FORWARD_REPS)
    # v5's prelude: DexiNed on both frames, and everything but the loop
    # (iters=0: DexiNed, the four encoders, the pyramid, the upsampling)
    v5 = v5_models["pallas_fused"]
    both = torch.cat([x1, x2]) / 255.0 * 2.0 - 1.0
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        key = "tf32_default" if tf32 else "tf32_off"
        with torch.inference_mode():
            rec[f"v5_dexined_ms_{bh}x{bw}_{key}"] = cuda_time_ms(
                lambda: v5.dexined(both), reps=FORWARD_REPS)
            rec[f"v5_prelude_ms_{bh}x{bw}_{key}"] = cuda_time_ms(
                lambda: v5(x1, x2, iters=0), reps=FORWARD_REPS)
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


# ---- the fleet router (python -m dexiraft_tpu_torch router) ---------------

ROUTER_HW = (436, 1024)      # Sintel pairs, the 440x1024 bucket
ROUTER_REQUESTS = 24         # per round, from ROUTER_CLIENTS threads
ROUTER_CLIENTS = 8
ROUTER_SESSIONS = 4          # threads 0..3 each send one session's requests
ROUTER_KILL_AFTER = 6        # answers of the kill round before the SIGKILL
ROUTER_BOOT_S = 900          # the replicas' load + warm-up, and a respawn's
# the replicas' serve flags after `--` (the router CLI forwards them)
ROUTER_SERVE_ARGS = ["--variant", "v1", "--corr_impl", "flash",
                     "--fused_update", "--iters", str(ITERS),
                     "--batch_size", "2", "--warmup", "440x1024"]


def free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def free_port_pair():
    """Two consecutive free ports (the router CLI spawns replica i on
    --port_base + i)."""
    import socket

    for _ in range(50):
        base = free_ports(1)[0]
        if base + 1 > 65535:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", base + 1))
            except OSError:
                continue
        return base
    raise AssertionError("router: no two consecutive free ports")


def port_open(port) -> bool:
    import socket

    with socket.socket() as s:
        s.settimeout(2.0)
        return s.connect_ex(("127.0.0.1", port)) == 0


def router_items(seed):
    """ROUTER_REQUESTS Sintel-sized pairs (frame_pairs' scene and shift)."""
    rng = np.random.default_rng(seed)
    h, w = ROUTER_HW
    items = []
    for k in range(ROUTER_REQUESTS):
        base = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3))
        im = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
        im2 = np.roll(im, (k % 7) - 3, axis=1) + rng.normal(0, 2, im.shape)
        items.append({"image1": im.astype(np.float32),
                      "image2": np.clip(im2, 0, 255).astype(np.float32)})
    return items


def replica_pids(ports):
    """{port: pid} of the serve processes listening on ``ports``, from
    /proc (each one's command line names its --port): the router's
    children, and any a failed router left behind (the replicas run in
    sessions of their own)."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
        except OSError:
            continue
        if "dexiraft_tpu_torch" in argv and "serve" in argv \
                and "--port" in argv:
            port = int(argv[argv.index("--port") + 1])
            if port in ports:
                out[port] = int(d)
    return out


def router_round(url, items, sessions, on_answer=None):
    """ROUTER_REQUESTS POSTs from ROUTER_CLIENTS threads: the first half
    of the requests go in order in ``sessions`` (thread k < ROUTER_SESSIONS
    sends sessions[k]'s), the rest stateless. Returns (answers [(index,
    status, headers, body, t_done, latency_s)], wall seconds, the session
    of each session request)."""
    import threading
    import urllib.error

    from dexiraft_tpu_torch.serve.server import encode_request

    bodies = [encode_request(it["image1"], it["image2"]) for it in items]
    answers, lock = [], threading.Lock()
    session_of = {i: sessions[i % ROUTER_SESSIONS]
                  for i in range(ROUTER_REQUESTS // 2)}
    stateless = list(range(ROUTER_REQUESTS // 2, ROUTER_REQUESTS))
    work = [[i for i in session_of if i % ROUTER_SESSIONS == k]
            for k in range(ROUTER_SESSIONS)]
    n_free = ROUTER_CLIENTS - ROUTER_SESSIONS
    work += [stateless[k::n_free] for k in range(n_free)]

    def client(k):
        for i in work[k]:
            t0 = time.perf_counter()
            try:
                body, hdr = http_post(url, "/v1/flow", bodies[i],
                                      session=session_of.get(i))
                status = 200
            except urllib.error.HTTPError as e:
                body, hdr, status = e.read(), dict(e.headers), e.code
            t1 = time.perf_counter()
            with lock:
                answers.append((i, status, hdr, body, t1, t1 - t0))
                n = len(answers)
            if on_answer is not None:
                on_answer(n)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(ROUTER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("router: a client thread is still waiting")
    return answers, time.perf_counter() - t0, session_of


def round_stats(answers, wall_s) -> dict:
    lat = [a[5] * 1e3 for a in answers]
    return {"requests": len(answers), "wall_s": wall_s,
            "requests_per_s": len(answers) / wall_s,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "statuses": sorted({a[1] for a in answers})}


def check_router_answers(answers, items, session_of, direct) -> float:
    """Every 200 answer against the same request run directly in this
    process (``direct(item, flow_init)`` -> (flow_low, flow_up)); a
    session request the replica answered warm (X-Warm-Start) is run with
    the splat of the direct run of the session's previous request, a cold
    one without. Returns the max abs flow_up difference (px)."""
    from dexiraft_tpu_torch.serve.server import decode_response

    worst = 0.0
    prev_low = {}
    for i, status, hdr, body, _, _ in sorted(answers, key=lambda a: a[0]):
        if status != 200:
            raise AssertionError(f"router: request {i} answered {status}")
        sid = session_of.get(i)
        warm = hdr.get("X-Warm-Start", "0") in ("1", "true", "True")
        low, up = direct(items[i], prev_low.get(sid) if warm else None)
        if sid is not None:
            prev_low[sid] = low
        got = decode_response(body)
        if got.shape != up.shape or not np.isfinite(got).all():
            raise AssertionError(f"router: request {i} flow {got.shape}")
        worst = max(worst, float(np.abs(got - up).max()))
    return worst


def phase_router(torch, dev, card) -> dict:
    """The fleet router (python -m dexiraft_tpu_torch router --port 0
    --spawn 2) in a child, over two serve replicas of seed-0 v1 weights on
    B1 (flash fused) that it spawns and supervises. Three rounds of
    ROUTER_REQUESTS Sintel pairs from ROUTER_CLIENTS threads, half in 4
    sessions (X-Session-Id): straight to one replica, through the router,
    and through the router with one replica SIGKILLed after
    ROUTER_KILL_AFTER answers. Checked: every answer 200 (no 5xx across
    the kill) and within TOL_FLOW_PX of the same request run directly in
    this process (warm answers on the splat of the session's previous
    flow); the router counts the failover and a sticky miss; the
    supervisor respawns the killed replica and its breaker closes again;
    POST /admin/drain gives 202 and the drain reaches 0 in flight, and
    the drained replica comes back; SIGTERM stops the router and every
    replica (exit 0, ports closed). Measured: requests/s and p50/p99 of
    each round, the failover seconds (kill to the next 200) and the
    respawn seconds (kill to the breaker closed). B1's launches are the
    replicas' own counts (/stats' kernel_launches, zeroed after their
    warm-up), read from each process just before it is killed or drained
    and at the end, each held against its /stats engine batches x ITERS."""
    import re
    import signal
    import tempfile
    import threading

    from dexiraft_tpu_torch import serve_cli
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from dexiraft_tpu_torch.serve.router import HashRing

    serve_args = ROUTER_SERVE_ARGS
    rec = {"phase": "router", "card": card, "replicas": 2,
           "serve_args": serve_args, "hw": list(ROUTER_HW)}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_router_")
    weights = os.path.join(tmp.name, "raft_v1_seed0.pt")
    # seed-0 weights of the replicas' config, saved for their --model;
    # the same model runs the direct requests here, through the
    # replicas' own builders
    args = serve_cli.build_parser().parse_args(
        ["--synthetic_init", "--port", "0"] + serve_args)
    _, model = serve_cli._load(args, dev)
    torch.save(model.state_dict(), weights)
    engine = InferenceEngine(
        serve_cli._make_eval_fn(args, model, args.iters, dev),
        ServeConfig.from_args(args, mode=args.mode, warm_start=True,
                              device_carry=True), device=dev)
    splat = serve_cli._make_carry_fn(dev, device=True)

    def direct(item, prev_low):
        it = dict(item) if prev_low is None else dict(
            item, flow_init=splat(prev_low))
        (res,) = engine.run_batch([it])
        return res.flow_low, np.asarray(res.flow_up)

    port_base = free_port_pair()
    cmd = [sys.executable, "-m", "dexiraft_tpu_torch", "router", "--port",
           "0", "--spawn", "2", "--port_base", str(port_base),
           "--boot_timeout_s", str(ROUTER_BOOT_S), "--", "--model", weights,
           *serve_args]
    rec["cmd"] = " ".join(cmd[2:])
    lines = []
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    replica_ports = [port_base, port_base + 1]
    try:
        url = None
        watchdog = threading.Timer(ROUTER_BOOT_S, child.kill)
        watchdog.start()
        for line in child.stdout:
            lines.append(line.rstrip())
            m = re.search(r"\[router\] listening on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
        watchdog.cancel()
        if url is None:
            raise AssertionError(f"router: no 'listening on' line: "
                                 f"{lines[-30:]}")
        rec["startup_s"] = time.perf_counter() - t0
        reader = threading.Thread(
            target=lambda: lines.extend(ln.rstrip() for ln in child.stdout),
            daemon=True)
        reader.start()
        pids = replica_pids(replica_ports)
        rids = {port_base: "r0", port_base + 1: "r1"}
        if sorted(pids) != replica_ports:
            raise AssertionError(f"router: replica processes {pids}")

        def pool():
            return http_json(url, "/stats")["pool"]

        def replica_counts(rid):
            """(engine batches, kernel launches) of replica ``rid``'s
            /stats, through the router."""
            scraped = http_json(url, "/stats?replicas=1")["replica_stats"]
            if "engine" not in scraped[rid]:
                raise AssertionError(f"router: /stats of {rid}: "
                                     f"{scraped[rid]}")
            return (scraped[rid]["engine"]["batches"],
                    scraped[rid]["service"]["kernel_launches"])

        worst = 0.0
        # round 1: straight to one replica; round 2: through the router
        for name, target, seed in (("direct_r0",
                                    f"http://127.0.0.1:{port_base}", 300),
                                   ("router", url, 301)):
            items = router_items(seed)
            sessions = [f"{name}-s{k}" for k in range(ROUTER_SESSIONS)]
            answers, wall, session_of = router_round(target, items, sessions)
            worst = max(worst, check_router_answers(
                answers, items, session_of, direct))
            rec[name] = round_stats(answers, wall)
        # each replica process's counts, read last just before it dies
        counts = {}

        def note_counts(rid):
            batches, launches = replica_counts(rid)
            counts[f"{rid}@{len(counts)}"] = {"batches": batches,
                                              "launches": launches}

        # round 3: through the router, one replica SIGKILLed mid-traffic
        aff0 = pool()["affinity"]
        items = router_items(302)
        sessions = [f"kill-s{k}" for k in range(ROUTER_SESSIONS)]
        # the victim is session 0's home on the router's ring (64 virtual
        # nodes, RouterConfig's default), so the kill moves a live session
        victim = HashRing(["r0", "r1"]).lookup(sessions[0])
        victim_port = {v: k for k, v in rids.items()}[victim]
        killed = {}

        def on_answer(n):
            if n == ROUTER_KILL_AFTER and not killed:
                note_counts(victim)
                killed["t"] = time.perf_counter()
                os.kill(pids[victim_port], signal.SIGKILL)

        answers, wall, session_of = router_round(url, items, sessions,
                                                 on_answer)
        worst = max(worst, check_router_answers(
            answers, items, session_of, direct))
        rec["router_kill"] = round_stats(answers, wall)
        after_kill = [a for a in answers if a[4] > killed["t"]
                      and a[1] == 200]
        rec["failover_s"] = (min(a[4] for a in after_kill) - killed["t"]
                             if after_kill else None)
        st = http_json(url, "/stats")
        rec["router_stats_after_kill"] = st["router"]
        aff = st["pool"]["affinity"]
        rec["sticky_misses"] = aff["sticky_misses"] - aff0["sticky_misses"]
        rec["max_abs_flow_px"] = worst
        if st["router"]["upstream_errors"] or rec["failover_s"] is None:
            raise AssertionError(f"router: kill round {st['router']}")
        if rec["sticky_misses"] < 1 or st["router"]["failovers"] < 1:
            raise AssertionError(f"router: no failover / sticky miss counted:"
                                 f" {st['router']} {aff}")

        # the supervisor respawns the victim; its breaker closes again
        seen_open = False
        while True:
            r = pool()["replicas"][victim]
            seen_open = seen_open or r["state"] != "closed"
            if (seen_open and r["state"] == "closed" and r["ready"]
                    and r["health"].get("uptime_s", 1e9)
                    < time.perf_counter() - killed["t"]):
                break
            if time.perf_counter() - killed["t"] > ROUTER_BOOT_S:
                raise AssertionError(f"router: {victim} never came back: {r}")
            time.sleep(0.2)
        rec["respawn_s"] = time.perf_counter() - killed["t"]
        rec["victim_breaker_opened"] = seen_open

        # zero-drop drain of the survivor, with traffic on the fleet
        drained = "r1" if victim == "r0" else "r0"
        note_counts(drained)
        body, _ = http_post(url, f"/admin/drain?replica={drained}", b"")
        code = json.loads(body)
        t_drain = time.perf_counter()
        answers, _, _ = router_round(url, router_items(303),
                                     [f"drain-s{k}" for k in range(4)])
        rec["drain"] = {"response": code,
                        "statuses": sorted({a[1] for a in answers})}
        if code.get("status") != "draining" or rec["drain"]["statuses"] != [
                200]:
            raise AssertionError(f"router: drain {rec['drain']}")
        while not any(f"drain {drained}: complete" in ln for ln in lines):
            if time.perf_counter() - t_drain > ROUTER_BOOT_S:
                raise AssertionError(f"router: drain never completed: "
                                     f"{lines[-20:]}")
            time.sleep(0.2)
        done = [ln for ln in lines if f"drain {drained}: complete" in ln][0]
        rec["drain"]["log"] = done
        m = re.search(r"last inflight (\d+)", done)
        if "replica restarted" not in done or not m or int(m.group(1)):
            raise AssertionError(f"router: drain outcome {done}")
        # the restart hook has spawned the new process (the supervisor
        # owns it, so the router's SIGTERM below stops it too)
        while not any(f"replica {drained} drained and respawned" in ln
                      for ln in lines):
            if time.perf_counter() - t_drain > ROUTER_BOOT_S:
                raise AssertionError(f"router: {drained} not respawned")
            time.sleep(0.2)
        rec["drain"]["respawned_s"] = time.perf_counter() - t_drain
        # the respawned victim served the drain round; the drained
        # replica's count was read before its drain
        note_counts(victim)
        rec["replica_counts"] = counts
        # B1 runs ITERS times a forward (a batch of the engine), and no
        # other kernel runs. A forward counts its launches as it enqueues
        # them and its batch after, and /stats reads the batches first:
        # the quiet readings hold exactly ITERS a batch; the one under
        # traffic (the victim's, just before the kill) may also hold the
        # launches of a forward still being enqueued, and of the next if
        # the dispatcher started it between the two reads
        for key, c in counts.items():
            n, b = c["launches"]["flash_fused_step"], c["batches"]
            stray = {k: v for k, v in c["launches"].items()
                     if k != "flash_fused_step" and v}
            quiet = key != f"{victim}@0"
            if (stray or not ITERS * b <= n < ITERS * (b + 2)
                    or (quiet and n != ITERS * b)):
                raise AssertionError(f"router: replica {key} launched {n} "
                                     f"B1 for {c['batches']} forwards, other "
                                     f"kernels {stray}")
        rec["launches"] = {"flash_fused_step": sum(
            c["launches"]["flash_fused_step"] for c in counts.values())}
        if not rec["launches"]["flash_fused_step"]:
            raise AssertionError("router: the replicas launched no B1")
        rec["lock_order_violations"] = http_json(
            url, "/stats")["locks"]["order_violations"]
        if rec["lock_order_violations"]:
            raise AssertionError(f"router: lock order violations "
                                 f"{rec['lock_order_violations']}")

        t1 = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=180)
        rec["sigterm_to_exit_s"] = time.perf_counter() - t1
        rec["rc"] = rc
        reader.join(5)
    finally:
        if child.poll() is None:
            # a failed phase: the router first, then its replicas by pid
            # (they run in sessions of their own; a respawn in flight may
            # have started one just before the router died)
            child.kill()
            child.wait()
            time.sleep(1.0)
            for pid in replica_pids(replica_ports).values():
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        tmp.cleanup()
    rec["log_tail"] = lines[-6:]
    rec["ports_open_after_exit"] = [p for p in replica_ports if port_open(p)]
    emit(rec)
    if rc != 0 or rec["ports_open_after_exit"]:
        raise AssertionError(f"router: exit {rc}, replica ports still open "
                             f"{rec['ports_open_after_exit']}: {lines[-20:]}")
    if worst > TOL_FLOW_PX:
        raise AssertionError(f"router: flows {worst} px from the direct run")
    return rec


# ---- the standalone DexiNed workload (python -m dexiraft_tpu_torch dexined)

DEXINED_HW = (720, 1280)     # BIPED's registry resolution
DEXINED_TRAIN_IMAGES = 8     # one batch at the CLI default
DEXINED_TEST_IMAGES = 4
DEXINED_BATCH, DEXINED_SIZE = 8, 352   # the CLI's --batch_size, --img_size
DEXINED_CPU_BATCH = 2        # the card step held against the CPU step
TOL_DEXINED_LOSS_REL = 1e-4
TOL_DEXINED_STATE_REL_L2 = 1e-3
TOL_DEXINED_GRAD_REL_L2 = 1e-6   # each parameter's fp64 gradient, card vs CPU
TOL_DEXINED_FORWARD = 1e-4   # of the largest logit, card vs CPU


def write_biped_tree(root, seed=0):
    """A synthetic BIPED tree from ``seed`` at DEXINED_HW: training pairs
    (imgs/train/rgbr/aug/seq0/*.jpg, edge_maps/.../*.png) and a test
    directory of .jpg images with a gt/ directory of edge maps. Each
    image is an 8x8-block random texture with its edges drawn in; each
    edge map holds a few hundred edge pixels (segments), so the metrics'
    matching stays cheap. The values mean nothing."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = DEXINED_HW
    dirs = {k: os.path.join(root, *p) for k, p in (
        ("img", ("imgs", "train", "rgbr", "aug", "seq0")),
        ("gt", ("edge_maps", "train", "rgbr", "aug", "seq0")),
        ("test", ("test",)), ("test_gt", ("test_gt",)))}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    def pair():
        base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(base, np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
        gt = np.zeros((h, w), np.uint8)
        for _ in range(6):
            x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
            x1 = int(np.clip(x0 + rng.integers(-120, 120), 0, w - 1))
            y1 = int(np.clip(y0 + rng.integers(-120, 120), 0, h - 1))
            cv2.line(gt, (x0, y0), (x1, y1), 255, 1)
            cv2.line(img, (x0, y0), (x1, y1), (255, 255, 255), 1)
        return img, gt

    for i in range(DEXINED_TRAIN_IMAGES):
        img, gt = pair()
        cv2.imwrite(os.path.join(dirs["img"], f"{i}.jpg"), img)
        cv2.imwrite(os.path.join(dirs["gt"], f"{i}.png"), gt)
    for i in range(DEXINED_TEST_IMAGES):
        img, gt = pair()
        cv2.imwrite(os.path.join(dirs["test"], f"t{i}.jpg"), img)
        cv2.imwrite(os.path.join(dirs["test_gt"], f"t{i}.png"), gt)
    return dirs


def phase_dexined(torch, ck, dev, card) -> dict:
    """The standalone DexiNed workload on a synthetic BIPED tree (8
    training and 4 test images of 720x1280, written from a seed).
    In-process, with the corr kernels' counts set to 0: the CLI's train
    step (dexined_cli.make_train_step: train-mode BatchNorm, the
    multiscale bdcn loss, AdamW) at its defaults, batch 8 at 352x352,
    fp32, timed (CUDA events, median of 5 after 2) with its peak memory;
    the step on the card, in fp32 and in fp64, held against the CPU's
    fp64 step from the same weights and the first DEXINED_CPU_BATCH
    samples (each: loss within TOL_DEXINED_LOSS_REL relative, the
    parameters and the BatchNorm running variances after the AdamW step
    within TOL_DEXINED_STATE_REL_L2 relative L2; the fp64 step's
    gradients, each parameter's within TOL_DEXINED_GRAD_REL_L2 relative
    L2, the pre-BatchNorm conv biases left out, whose gradients are
    rounding noise, and those of the parameters no loss reaches exactly
    0: Adam's first update is about lr times the gradient's sign, so the
    state holds the step and the gradients its size); the cofusion
    head's forward on the card against the CPU's
    (within TOL_DEXINED_FORWARD of the largest logit); no corr kernel
    launched. The CLI in children: --train --epochs 2
    --steps_per_epoch 3 --batch_size 2 --img_size 176 (two checkpoints,
    finite losses), beside the held steps, then --test --test_pich
    --gt_root over the 4 test images (per-image ms at 720x1280, ODS/OIS/AP
    with the dilation matching, every PNG written)."""
    import re
    import tempfile

    from dexiraft_tpu_torch import dexined_cli as cli
    from dexiraft_tpu_torch.dexined.data import BipedDataset
    from dexiraft_tpu_torch.models.dexined import (PRE_BN_BIAS, DexiNed,
                                                   create_dexined)

    rec = {"phase": "dexined", "card": card, "hw": list(DEXINED_HW),
           "batch": DEXINED_BATCH, "img_size": DEXINED_SIZE}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dexined_") as root:
        t0 = time.perf_counter()
        dirs = write_biped_tree(root)
        rec["tree_s"] = time.perf_counter() - t0
        ds = BipedDataset(root, img_size=DEXINED_SIZE)
        samples = [ds.sample(i, np.random.default_rng((42, 0, i)))
                   for i in range(DEXINED_BATCH)]
        images = np.stack([s["images"] for s in samples])
        labels = np.stack([s["labels"] for s in samples])
        ck.reset_launches()
        seconds = rec["seconds"] = {}
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            t1 = time.perf_counter()
            seconds[name] = t1 - t0
            t0 = t1

        # the train step at the CLI defaults, timed
        model = create_dexined(42).to(dev)
        opt = cli.make_optimizer(model, 1e-4, 0.0)
        step = cli.make_train_step(model, opt)
        x, y = cli.to_nchw(images, dev), cli.to_nchw(labels, dev)
        losses = []
        torch.cuda.reset_peak_memory_stats(dev)
        times = cuda_times_ms(lambda: losses.append(step(x, y)[0]), reps=5,
                              warmup=2)
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"dexined: train losses {losses}")
        rec.update(train_ms_per_step=statistics.median(times),
                   train_ms_min_max=[min(times), max(times)],
                   train_peak_allocated_gib=peak / 2 ** 30,
                   train_losses=losses)
        del model, opt, step, x, y
        torch.cuda.empty_cache()
        lap("train_timed")
        # the CLI's --train child (below) runs beside the held steps; the
        # timed step above ran alone
        env = dict(os.environ)
        ckpt = os.path.join(root, "ck")
        t_cli = time.perf_counter()
        # batch 2 at 176x176: the child's first step searches cuDNN's
        # algorithms for its shapes again, and batch 8's step was timed
        # above
        cli_train = _start_child(["dexined", "--train", "--data_root", root,
                                  "--epochs", "2", "--steps_per_epoch", "3",
                                  "--batch_size", "2", "--img_size", "176",
                                  "--checkpoint", ckpt], env)

        # one step on the card against the same step on the CPU, same
        # weights and batch. At these random weights the fp32 gradients
        # sit ~1% from the fp64 ones (median leaf 5e-3 relative L2, worst
        # 1e-2, on the CPU at any thread count), so the card's fp32 step
        # (the CLI's arithmetic) is held on its loss and state against the
        # CPU's fp64 step, and the card's fp64 step on every gradient
        n = DEXINED_CPU_BATCH
        weights = create_dexined(43).state_dict()
        after = {}
        for name, where, dtype in (("cpu_fp64", "cpu", torch.float64),
                                   ("card_fp64", dev, torch.float64),
                                   ("card_fp32", dev, torch.float32)):
            m = DexiNed()
            m.load_state_dict(weights, strict=True)
            m = m.to(where, dtype)
            loss, ok = cli.make_train_step(m, cli.make_optimizer(
                m, 1e-4, 0.0))(cli.to_nchw(images[:n], where).to(dtype),
                               cli.to_nchw(labels[:n], where).to(dtype))
            sd = {k: v.detach().cpu().double()
                  for k, v in m.state_dict().items()}
            after[name] = {
                "loss": float(loss), "finite": bool(ok),
                "params": torch.cat([sd[k].reshape(-1)
                                     for k, _ in m.named_parameters()]),
                "running_var": torch.cat([v.reshape(-1) for k, v in sd.items()
                                          if k.endswith("running_var")]),
                "grads": {k: p.grad.detach().cpu().double()
                          for k, p in m.named_parameters()}}
            del m
            lap(f"step_{name}")
        ref = after["cpu_fp64"]

        def held(got):
            """``got``'s step against the CPU's fp64 step: the loss, the
            state after it, and each gradient (the pre-BatchNorm conv
            biases left out; the largest gradient of the parameters the
            loss does not reach, which are 0 on the CPU)."""
            rel, unreached, noise = {}, [], []
            for k, g in ref["grads"].items():
                mine = got["grads"][k]
                if PRE_BN_BIAS.match(k):
                    noise.append(float(mine.abs().max()))
                elif float(g.norm()) == 0.0:
                    unreached.append(float(mine.abs().max()))
                else:
                    rel[k] = rel_l2(mine, g)
            worst = max(rel, key=rel.get)
            return {"loss_rel_diff": abs(got["loss"] - ref["loss"])
                    / abs(ref["loss"]),
                    "params_rel_l2": rel_l2(got["params"], ref["params"]),
                    "running_var_rel_l2": rel_l2(got["running_var"],
                                                 ref["running_var"]),
                    "finite": got["finite"], "grad_leaves": len(rel),
                    "grad_worst_rel_l2": rel[worst], "grad_worst_leaf": worst,
                    "grad_median_rel_l2": statistics.median(rel.values()),
                    "grad_unreached_max": max(unreached),
                    "pre_bn_bias_grad_max": max(noise)}

        hold = {"batch": n, "loss_cpu_fp64": ref["loss"],
                "loss_card_fp32": after["card_fp32"]["loss"],
                "cpu_fp64_finite": ref["finite"],
                "card_fp32": held(after["card_fp32"]),
                "card_fp64": held(after["card_fp64"])}
        rec["card_vs_cpu_step"] = hold
        c64 = hold["card_fp64"]
        if not (ref["finite"]
                and all(h["loss_rel_diff"] <= TOL_DEXINED_LOSS_REL
                        and h["params_rel_l2"] <= TOL_DEXINED_STATE_REL_L2
                        and h["running_var_rel_l2"] <= TOL_DEXINED_STATE_REL_L2
                        and h["finite"] and h["grad_unreached_max"] == 0.0
                        for h in (hold["card_fp32"], c64))
                and c64["grad_worst_rel_l2"] <= TOL_DEXINED_GRAD_REL_L2):
            raise AssertionError(f"dexined: card step vs CPU step {hold}")

        # the cofusion head: card forward against the CPU forward
        co = create_dexined(44, fusion="cofusion").eval()
        xc = cli.to_nchw(images[:1], "cpu")
        with torch.inference_mode():
            maps_c = torch.cat(co(xc), 1)
            maps_g = torch.cat(co.to(dev)(xc.to(dev)), 1).cpu()
        err = float((maps_g - maps_c).abs().max())
        scale = float(maps_c.abs().max())
        rec["cofusion"] = {"max_abs_logit_err": err, "max_abs_logit": scale}
        if err > TOL_DEXINED_FORWARD * max(1.0, scale):
            raise AssertionError(f"dexined: cofusion card vs CPU "
                                 f"{rec['cofusion']}")
        del co
        lap("cofusion")

        rec["launches"] = {k: v for k, v in ck.LAUNCHES.items()}
        if any(rec["launches"].values()):
            raise AssertionError(f"dexined: corr kernels launched "
                                 f"{rec['launches']}")

        # the CLI in children: train (started above), then test
        out = _finish_child(cli_train)
        rec["cli_train_s"] = time.perf_counter() - t_cli
        cli_losses = [float(v) for v in re.findall(r"Loss: (\S+)", out)]
        steps = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
        rec["cli_train"] = {"losses": cli_losses, "checkpoints": steps,
                            "log": out.strip().splitlines()[-6:]}
        if steps != [3, 6] or not cli_losses or not all(
                np.isfinite(cli_losses)):
            raise AssertionError(f"dexined: CLI train {rec['cli_train']}: "
                                 f"{out[-2000:]}")
        outdir = os.path.join(root, "out")
        t0 = time.perf_counter()
        out = _child(["dexined", "--test", "--test_pich", "--data_root",
                      dirs["test"], "--gt_root", dirs["test_gt"],
                      "--matching", "dilation", "--checkpoint", ckpt,
                      "--output_dir", outdir], env)
        rec["cli_test_s"] = time.perf_counter() - t0
        per_image = [float(v) for v in re.findall(r"\.jpg: (\S+) ms", out)]
        metrics = re.search(r"ODS: (\S+)\s+OIS: (\S+)\s+AP: (\S+)", out)
        files = sorted(os.path.relpath(os.path.join(d, f), outdir)
                       for d, _, fs in os.walk(outdir) for f in fs)
        expect = sorted(f"BIPED/{sub}t{i}.png"
                        for i in range(DEXINED_TEST_IMAGES)
                        for sub in ("", "fusedCH/", "avgCH/"))
        rec["cli_test"] = {"ms_per_image": per_image,
                           "metrics": (dict(zip(("ODS", "OIS", "AP"),
                                                map(float, metrics.groups())))
                                       if metrics else None),
                           "files": len(files)}
        if (len(per_image) != DEXINED_TEST_IMAGES or metrics is None
                or files != expect):
            raise AssertionError(f"dexined: CLI test {rec['cli_test']} "
                                 f"{files}: {out[-2000:]}")
    emit(rec)
    return rec


# ---- ddp: multi-process data-parallel training on one card ----

DDP_STEPS = 4                # global batch DDP_BATCH, chairs crop, v1 on B1
DDP_BATCH = 4
DDP_STALL_TIMEOUT = 20.0     # --stall_timeout of the stalled run
TOL_DDP_LOSS_REL = 1e-4      # 2-rank vs 1-process per-step losses
# 2-rank vs 1-process states, relative L2, from the two runs' checkpoints
# at steps 2 and DDP_STEPS. They are not bitwise equal even where the
# losses are: a conv bias that feeds a BatchNorm has a gradient of pure
# rounding noise, and Adam's first updates, ~lr x sign(gradient), turn it
# into a +-lr step that differs between the runs. Each bound is 3-4x the
# larger of two readings (H100, PERF.md).
# every floating tensor together, at step 2: read 2.23e-5, 2.25e-5
TOL_DDP_STATE2_REL_L2 = 7e-5
# ... and at step DDP_STEPS: read 8.68e-5, 8.68e-5 (8.66e-5, 8.70e-5
# before); the per-step spread of the card's own step grows through Adam
TOL_DDP_STATE_REL_L2 = 3e-4
# each BatchNorm running mean and variance on its own: local statistics
# (a rank's 2 rows, not the global 4) would move them by the spread
# between the batch's halves. The means carry the biases' +-lr steps,
# the variances do not. Read: step 2 means 3.00e-5, 3.00e-5, variances
# 2.44e-7, 2.44e-7; step 4 means 4.97e-4, 5.46e-4, variances 1.21e-5,
# 1.19e-5
TOL_DDP_BN_REL_L2 = {(2, "running_mean"): 1e-4, (2, "running_var"): 1e-6,
                     (DDP_STEPS, "running_mean"): 2e-3,
                     (DDP_STEPS, "running_var"): 5e-5}
# the 1-rank NCCL step against the one-process step: one step, 1.3e-6 read
TOL_DDP_NCCL_STATE_REL_L2 = 1e-4
DDP_CLI = ["--stage", "chairs", "--corr_impl", "flash", "--fused_update",
           "--batch_size", str(DDP_BATCH), "--sum_freq", "1",
           "--num_workers", "2", "--val_freq", "1000", "--log_dir", "runs"]


def launch_ranks(cwd, env, world, extra, per_rank=None,
                 stderr=subprocess.PIPE):
    """``world`` ranks of python -m dexiraft_tpu_torch train, each with
    torchrun's variables, all on cuda:0 (so the backend is gloo)."""
    port = free_ports(1)[0]
    procs = []
    for r in range(world):
        renv = dict(env, RANK=str(r), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dexiraft_tpu_torch", "train"] + DDP_CLI
            + ["--device", "cuda:0"] + extra + (per_rank or {}).get(r, []),
            cwd=cwd, env=renv, stdout=subprocess.PIPE, stderr=stderr,
            text=True))
    return procs


def finish(procs, what, timeout=600):
    """Wait for ``procs``; every one must exit 0. -> their stdouts."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                raise AssertionError(f"ddp: {what} exited {p.returncode}: "
                                     f"{out[-2000:]} {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_launches(outs):
    """Each process's ``[kernels] launches`` line of its stdout."""
    found = []
    for out in outs:
        found += [json.loads(line.split("launches ", 1)[1])
                  for line in out.splitlines()
                  if line.startswith("[kernels] launches ")]
    return found


def state_line(out) -> dict:
    """The train CLI's ``[state]`` line: bytes of parameters plus Adam
    moments the process held at its end, of the whole, and the bytes its
    model's sharded parameters still held."""
    import re

    m = re.search(r"\[state\] parameters \+ Adam moments held (\d+) of "
                  r"(\d+) bytes .*resident bytes (\d+)", out)
    if m is None:
        raise AssertionError(f"ddp: no [state] line in {out[-1500:]}")
    held, full, resident = (int(g) for g in m.groups())
    return {"held": held, "full": full, "resident_sharded": resident}


def run_losses(root, name):
    with open(os.path.join(root, "runs", name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def saved_model(root, name, step) -> dict:
    """The model state dict of run ``name``'s checkpoint at ``step``
    (a sharded step's assembled whole)."""
    from dexiraft_tpu_torch.train import checkpoint as ckpt

    return ckpt.read_model_weights(os.path.join(root, "checkpoints", name,
                                                str(step)))


#: ``python -c GATHER_CHECK DIR STEP OUT ARGS...``: one rank (torchrun's
#: variables) restores the sharded checkpoint DIR at STEP into the train
#: CLI's state for ARGS, prints its live plan's placement audit section
#: (``[audit] {...}``, analysis.shardaudit.plan_section of its real
#: ShardPlan on the card), gathers its parameters over the fsdp group,
#: and rank 0 saves the gathered state dict to OUT
GATHER_CHECK = """
import json, sys, torch
from dexiraft_tpu_torch import train_cli
from dexiraft_tpu_torch.analysis.shardaudit import plan_section
from dexiraft_tpu_torch.parallel import distributed, make_train_mesh
from dexiraft_tpu_torch.parallel.fsdp import shard_state
from dexiraft_tpu_torch.resilience.verify import restore_verified
from dexiraft_tpu_torch.train.state import create_state

directory, step, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
args = train_cli.build_parser().parse_args(sys.argv[4:])
cfg, tc = train_cli.resolve_configs(args)
world = distributed.initialize(args.device)
mesh = make_train_mesh(tc.batch_size, world, tc.accum_steps, fsdp=args.fsdp)
state = shard_state(create_state(cfg, tc, device=world.device), mesh)
state, got, _ = restore_verified(directory, state, step=step,
                                 delete_bad=False)
assert got == step, got
print("[audit] " + json.dumps(plan_section(state.shards)), flush=True)
with state.shards.gathered_params() as model:
    if world.is_writer:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, out)
distributed.teardown()
"""


def flat_state(torch, sd):
    """Every floating tensor of a state dict, joined, in fp64."""
    return torch.cat([v.double().reshape(-1) for v in sd.values()
                      if v.is_floating_point()])


def state_parity(torch, ours: dict, ref: dict) -> dict:
    """``ours`` against ``ref``: bitwise, relative L2 over every floating
    tensor, each BatchNorm running stat's own relative L2, and whether
    the BatchNorm step counts agree."""
    stats = [k for k in ref if "running_" in k]
    return {"bitwise": all(torch.equal(v, ours[k]) for k, v in ref.items()),
            "rel_l2": rel_l2(flat_state(torch, ours), flat_state(torch, ref)),
            "bn_tensors": len(stats),
            "bn_rel_l2": {k: rel_l2(ours[k].double(), ref[k].double())
                          for k in stats},
            "bn_counts_equal": all(
                torch.equal(ours[k], v) for k, v in ref.items()
                if k.endswith("num_batches_tracked"))}


def nccl_check(torch, dev) -> dict:
    """A 1-rank NCCL process group on the card (parallel.distributed.
    initialize under torchrun's variables): an all_reduce, and one
    data-parallel v1 train step on B1 (synced BatchNorm, the gradient
    all-reduce) against the one-process step on the same weights and
    batch. The variables are restored and the group destroyed after."""
    from dexiraft_tpu_torch.config import TrainConfig, raft_v1
    from dexiraft_tpu_torch.models.raft import RAFT
    from dexiraft_tpu_torch.ops import corr_kernels as ck
    from dexiraft_tpu_torch.parallel import distributed, make_train_mesh
    from dexiraft_tpu_torch.train.state import create_state
    from dexiraft_tpu_torch.train.step import make_train_step

    names = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_ports(1)[0]))
    try:
        world = distributed.initialize("cuda")
        t = torch.arange(4.0, device=world.device)
        torch.distributed.all_reduce(t)
        reduced = t.tolist()
        cfg = raft_v1(corr_impl="flash", fused_update=True)
        tc = TrainConfig(batch_size=2, num_steps=100)
        batch = train_batch(torch, world.device, 2, seed=7)
        weights = create_state(cfg, tc, device=world.device).model.state_dict()
        out = {}
        for name, mesh in (("nccl", make_train_mesh(2, world)),
                           ("one_process", None)):
            model = RAFT(cfg)
            model.load_state_dict(weights)
            state = create_state(cfg, tc, device=world.device, model=model)
            ck.reset_launches()
            state, m = make_train_step(cfg, tc, mesh=mesh)(state, batch)
            torch.cuda.synchronize()
            out[name] = {"loss": float(m["loss"]), "epe": float(m["epe"]),
                         "finite": bool(m["state_finite"]),
                         "b1": ck.LAUNCHES["flash_fused_step"],
                         "state": torch.cat([
                             v.double().reshape(-1) for v in
                             state.model.state_dict().values()
                             if v.is_floating_point()])}
        backend = world.backend
    finally:
        distributed.teardown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    a, b = out["nccl"], out["one_process"]
    return {"backend": backend, "all_reduce": reduced,
            "loss": [a["loss"], b["loss"]], "epe": [a["epe"], b["epe"]],
            "loss_rel_diff": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "state_rel_l2": rel_l2(a["state"], b["state"]),
            "finite": a["finite"] and b["finite"],
            "b1_launches": [a["b1"], b["b1"]]}


def phase_ddp(torch, dev, card) -> dict:
    """Data-parallel training (parallel/, the synced train step, the
    coordinator, preemption and the hang watchdog) on one card: two
    ranks share cuda:0 (so the process group's backend is gloo), v1 on
    B1 at the chairs crop, global batch DDP_BATCH, on phase_train_cli's
    synthetic FlyingChairs tree (20 training pairs, 384x512).
      * parity: one process (--device cuda) and two ranks under torchrun
        (python -m torch.distributed.run --standalone --nproc_per_node 2
        ... --device cuda:0), DDP_STEPS steps, beside the preempted pair
        below: per-step losses within TOL_DDP_LOSS_REL relative; from
        both runs' checkpoints (--val_freq 2), the states at step 2
        within TOL_DDP_STATE2_REL_L2 relative L2 and at step DDP_STEPS
        within TOL_DDP_STATE_REL_L2, each BatchNorm running mean and
        variance at both steps on its own within TOL_DDP_BN_REL_L2, equal
        BatchNorm step counts; each rank's B1 launches 12 a step;
      * preemption: rank 1 alone takes a SIGTERM after step 2 (--chaos
        sigterm@2): both ranks stop at step 2, exit 0, one checkpoint
        (step 2); a 2-rank --resume, started as soon as they end, takes
        steps 3-4, and the run's log (steps 1-4) holds the uninterrupted
        2-rank run's losses within TOL_RESUME_REL;
      * stall: beside the parity runs, two ranks with --stall_timeout
        DDP_STALL_TIMEOUT; rank 1 is SIGSTOPped at its step-1 log line:
        rank 0 exits 98 within the timeout + 30 s, its dump naming the
        step and the region, and rank 1 is SIGKILLed;
      * fsdp: beside the parity runs, an fsdp pair (--fsdp 2 --val_freq
        2, data 1 x fsdp 2): its losses and its per-shard checkpoints'
        states (read whole) at steps 2 and DDP_STEPS against the one
        process within the parity bounds above, B1 12 a step on each
        rank, each rank's bytes of parameters plus Adam moments (its
        ``[state]`` line) under 0.75 of the one process's with no
        storage left in the model's sharded parameters (emitted with the
        card's line); then a 2-rank --resume from a copy of its step-2
        checkpoint (steps 3-4 within TOL_RESUME_REL of the pair's) and,
        beside it, two ranks that restore its step DDP_STEPS and gather
        it (GATHER_CHECK): read_model_weights of that step equals the
        gathered state dict to the bit, and each rank's live plan's
        audit section equals the placement audit's golden for
        full-width v1 at 2 ways;
      * resharded resumes, beside those: fsdp_to_one, one process
        (--device cuda, no --fsdp) resuming a copy of the fsdp pair's
        step-2 per-shard checkpoint (steps 3-4 within TOL_RESUME_REL of
        the fsdp resume's, its step DDP_STEPS against that resume's read
        whole within the parity bounds, B1 12 a step); one_to_fsdp, two
        ranks --fsdp 2 resuming a copy of the one process's step-2
        checkpoint (steps 3-4 within TOL_RESUME_REL of the one
        process's, each rank's ``[state]`` bytes under 0.75 of the one
        process's, B1 12 a step on each rank);
      * nccl: a 1-rank NCCL group in this process (nccl_check)."""
    import re
    import shutil
    import signal
    import tempfile
    import threading

    from dexiraft_tpu_torch.data.synthetic import write_chairs_tree

    rec = {"phase": "ddp", "card": card, "batch": DDP_BATCH,
           "steps": DDP_STEPS}
    seconds = rec["seconds"] = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
        write_chairs_tree(tmp, n_train=20, n_val=4, hw=(384, 512), seed=0)
        env = dict(os.environ, DEXIRAFT_DATA_DIR=tmp, OMP_NUM_THREADS="2",
                   PYTHONUNBUFFERED="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        steps = ["--num_steps", str(DDP_STEPS)]
        # the parity runs checkpoint at step 2 too
        every2 = steps + ["--val_freq", "2"]
        started = []
        try:
            one = subprocess.Popen(
                [sys.executable, "-m", "dexiraft_tpu_torch", "train"]
                + DDP_CLI + every2 + ["--name", "one", "--device", "cuda"],
                cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            started.append(one)
            pair = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "2", "-m",
                 "dexiraft_tpu_torch", "train"] + DDP_CLI + every2
                + ["--name", "pair", "--device", "cuda:0"],
                cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            started.append(pair)
            # beside them the preempted pair (rank 1's SIGTERM stops both
            # at step 2) and the stalled pair
            pre = launch_ranks(tmp, env, 2, steps + ["--name", "pre",
                                                     "--coord_every", "2"],
                               {1: ["--chaos", "sigterm@2"]})
            started += pre
            stall = launch_ranks(tmp, env, 2, [
                "--num_steps", "200", "--name", "stall", "--stall_timeout",
                str(DDP_STALL_TIMEOUT)], stderr=subprocess.STDOUT)
            started += stall
            # and the fsdp pair: parameters and moments stored sharded
            fsdp = launch_ranks(tmp, env, 2, every2 + ["--name", "fsdp",
                                                       "--fsdp", "2"])
            started += fsdp
            stopped = {}

            def watch_rank1():
                for line in stall[1].stdout:
                    if line.startswith("[     1,"):
                        os.kill(stall[1].pid, signal.SIGSTOP)
                        stopped["t"] = time.perf_counter()
                        break

            watcher = threading.Thread(target=watch_rank1, daemon=True)
            watcher.start()
            outs = finish(pre, "preempted ranks")
            pre_ckpts = sorted(os.listdir(os.path.join(tmp, "checkpoints",
                                                       "pre")))
            lap("preempt")
            # the resume, as soon as the preempted pair has saved
            res = launch_ranks(tmp, env, 2, steps + ["--name", "pre",
                                                     "--resume"])
            started += res
            outs_fsdp = finish(fsdp, "fsdp pair")
            lap("fsdp")
            # the fsdp pair's resume from its step-2 per-shard checkpoint,
            # and two ranks gathering its step 4, as soon as it has saved
            ck_dir = os.path.join(tmp, "checkpoints")
            os.makedirs(os.path.join(ck_dir, "fsdp_res"))
            shutil.copytree(os.path.join(ck_dir, "fsdp", "2"),
                            os.path.join(ck_dir, "fsdp_res", "2"))
            res_fsdp = launch_ranks(tmp, env, 2, steps + [
                "--name", "fsdp_res", "--fsdp", "2", "--resume"])
            started += res_fsdp
            # beside it the resharded resumes: the pair's step 2 on one
            # process, and the one process's step 2 on an fsdp pair
            os.makedirs(os.path.join(ck_dir, "fsdp_to_one"))
            shutil.copytree(os.path.join(ck_dir, "fsdp", "2"),
                            os.path.join(ck_dir, "fsdp_to_one", "2"))
            to_one = subprocess.Popen(
                [sys.executable, "-m", "dexiraft_tpu_torch", "train"]
                + DDP_CLI + steps + ["--name", "fsdp_to_one", "--device",
                                     "cuda", "--resume"],
                cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            started.append(to_one)
            one_2 = os.path.join(ck_dir, "one", "2")
            deadline = time.perf_counter() + 300
            while not os.path.isfile(os.path.join(one_2, "state.pt")):
                if one.poll() is not None or time.perf_counter() > deadline:
                    raise AssertionError(
                        f"ddp: the one process saved no step 2 (exit "
                        f"{one.poll()})")
                time.sleep(0.5)
            os.makedirs(os.path.join(ck_dir, "one_to_fsdp"))
            shutil.copytree(one_2, os.path.join(ck_dir, "one_to_fsdp", "2"))
            to_fsdp = launch_ranks(tmp, env, 2, steps + [
                "--name", "one_to_fsdp", "--fsdp", "2", "--resume"])
            started += to_fsdp
            gathered = os.path.join(tmp, "gathered.pt")
            port = free_ports(1)[0]
            gather = [subprocess.Popen(
                [sys.executable, "-c", GATHER_CHECK,
                 os.path.join(ck_dir, "fsdp"), str(DDP_STEPS), gathered]
                + DDP_CLI + steps + ["--device", "cuda:0", "--fsdp", "2"],
                cwd=tmp, env=dict(env, RANK=str(r), WORLD_SIZE="2",
                                  LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                                  MASTER_ADDR="127.0.0.1",
                                  MASTER_PORT=str(port)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(2)]
            started += gather
            err0 = stall[0].communicate(timeout=600)[0]
            t_exit = time.perf_counter()
            os.kill(stall[1].pid, signal.SIGKILL)
            stall[1].wait()
            watcher.join(timeout=10)
            out_one, out_pair = finish([one, pair], "parity runs")
            lap("parity_and_stall")
            outs_res = finish(res, "resumed ranks")
            lap("resume")
            outs_res_fsdp = finish(res_fsdp, "resumed fsdp pair")
            outs_gather = finish(gather, "fsdp gather")
            outs_to_one = finish([to_one], "fsdp_to_one resume")
            outs_to_fsdp = finish(to_fsdp, "one_to_fsdp resume")
            lap("fsdp_resume_gather_and_reshard")
        finally:
            for p in started:
                if p.poll() is None:
                    p.kill()
                p.wait()
        rec["backend_line"] = [line for line in out_pair.splitlines()
                               if line.startswith("[dist] ")]
        one_l, pair_l = run_losses(tmp, "one"), run_losses(tmp, "pair")
        rec["losses_one_process"], rec["losses_two_ranks"] = one_l, pair_l
        rec["loss_rel_diff"] = {s: abs(pair_l[s] - one_l[s]) / abs(one_l[s])
                                for s in one_l if s in pair_l}
        rec["state"] = {step: state_parity(torch,
                                           saved_model(tmp, "pair", step),
                                           saved_model(tmp, "one", step))
                        for step in (2, DDP_STEPS)}
        rec["launches_one_process"] = run_launches([out_one])
        rec["launches_per_rank"] = run_launches([out_pair])
        # the logger's per-step rate (--sum_freq 1; both ranks' lines in
        # the pair's): the card's own numbers, with up to seven processes
        # sharing it
        rec["steps_per_s"] = {
            name: [float(v) for v in re.findall(r"\(([\d.]+) steps/s\)",
                                                out)]
            for name, out in (("one_process", out_one),
                              ("two_ranks", out_pair))}
        rec["preempt"] = {
            "stopped_at_2": ["Preempted at step 2" in o for o in outs],
            "sigterm_seen": ["received SIGTERM" in o for o in outs],
            "checkpoints": pre_ckpts,
            "launches_per_rank": run_launches(outs)}
        dump = [line for line in err0.splitlines() if "STALL" in line]
        rec["stall"] = {
            "rank0_exit": stall[0].returncode,
            "seconds_after_sigstop": (t_exit - stopped["t"]
                                      if "t" in stopped else None),
            "stall_line": dump[:1],
            "dump_has_stacks": "most recent call first" in err0,
            "rank1_exit": stall[1].returncode}
        # the fsdp pair against the one process, and its storage
        fsdp_l = run_losses(tmp, "fsdp")
        held = [state_line(o) for o in outs_fsdp]
        held_one = state_line(out_one)
        res_fsdp_l = run_losses(tmp, "fsdp_res")
        whole = saved_model(tmp, "fsdp", DDP_STEPS)
        gathered_sd = torch.load(gathered, weights_only=True)
        rec["fsdp"] = {
            "mesh_line": [line for o in outs_fsdp for line in o.splitlines()
                          if line.startswith("[mesh] ")],
            "losses": fsdp_l,
            "loss_rel_diff": {s: abs(fsdp_l[s] - one_l[s]) / abs(one_l[s])
                              for s in one_l if s in fsdp_l},
            "state": {step: state_parity(torch,
                                         saved_model(tmp, "fsdp", step),
                                         saved_model(tmp, "one", step))
                      for step in (2, DDP_STEPS)},
            "launches_per_rank": run_launches(outs_fsdp),
            "state_bytes_per_rank": held,
            "state_bytes_one_process": held_one,
            "held_share_of_one_process": [h["held"] / held_one["held"]
                                          for h in held],
            "resume": {
                "resumed_at_2": ["Resumed full state at step 2" in o
                                 for o in outs_res_fsdp],
                "losses": res_fsdp_l,
                "rel_diff": {s: abs(res_fsdp_l[s] - fsdp_l[s])
                             / abs(fsdp_l[s]) for s in res_fsdp_l},
                "launches_per_rank": run_launches(outs_res_fsdp)},
            "read_model_weights_equals_gathered": (
                list(whole) == list(gathered_sd) and all(
                    torch.equal(whole[k], v)
                    for k, v in gathered_sd.items()))}
        # the live plans' audit sections against the placement audit's
        # golden (full-width v1 at 2 ways)
        from dexiraft_tpu_torch.analysis import shardaudit

        golden = shardaudit.load_golden(os.path.join(
            os.path.dirname(shardaudit.__file__),
            shardaudit.FSDP_GOLDEN))["plans"]["v1@2"]
        live = [json.loads(line.split(" ", 1)[1]) for o in outs_gather
                for line in o.splitlines() if line.startswith("[audit] ")]
        rec["fsdp"]["live_audit"] = {
            "ranks": len(live), "equals_golden": [x == golden for x in live],
            "params": [x["params"] for x in live],
            "sharded_keys": [len(x["layout"]["dims"]) for x in live]}
        # the resharded resumes
        to_one_l = run_losses(tmp, "fsdp_to_one")
        to_fsdp_l = run_losses(tmp, "one_to_fsdp")
        held_to_fsdp = [state_line(o) for o in outs_to_fsdp]
        rec["reshard"] = {
            "fsdp_to_one": {
                "restored_line": [
                    "step 2 was saved sharded 2-way over fsdp; restored "
                    "into this run's layout (replicated)" in o
                    for o in outs_to_one],
                "resumed_at_2": ["Resumed full state at step 2" in o
                                 for o in outs_to_one],
                "losses": to_one_l,
                "rel_diff": {s: abs(to_one_l[s] - res_fsdp_l[s])
                             / abs(res_fsdp_l[s]) for s in to_one_l},
                "state": state_parity(torch,
                                      saved_model(tmp, "fsdp_to_one",
                                                  DDP_STEPS),
                                      saved_model(tmp, "fsdp_res",
                                                  DDP_STEPS)),
                "launches_per_rank": run_launches(outs_to_one)},
            "one_to_fsdp": {
                "restored_line": [
                    "step 2 was saved replicated; restored into this "
                    "run's layout (sharded 2-way over fsdp)" in o
                    for o in outs_to_fsdp],
                "resumed_at_2": ["Resumed full state at step 2" in o
                                 for o in outs_to_fsdp],
                "mesh_line": [line for o in outs_to_fsdp
                              for line in o.splitlines()
                              if line.startswith("[mesh] ")],
                "losses": to_fsdp_l,
                "rel_diff": {s: abs(to_fsdp_l[s] - one_l[s]) / abs(one_l[s])
                             for s in to_fsdp_l},
                "state_bytes_per_rank": held_to_fsdp,
                "held_share_of_one_process": [h["held"] / held_one["held"]
                                              for h in held_to_fsdp],
                "launches_per_rank": run_launches(outs_to_fsdp)}}
        emit({"phase": "ddp", "case": "resharded_resume", "card": card,
              **rec["reshard"], "live_audit": rec["fsdp"]["live_audit"]})
        emit({"phase": "ddp", "case": "fsdp_storage", "card": card,
              "what": "bytes of parameters plus Adam moments held between "
                      "steps, each rank of the fsdp pair against the one "
                      "process",
              "per_rank": held, "one_process": held_one,
              "share": rec["fsdp"]["held_share_of_one_process"]})
        res_l = run_losses(tmp, "pre")
        rec["resume"] = {
            "resumed_at_2": ["Resumed full state at step 2" in o
                             for o in outs_res],
            "losses": res_l,
            "rel_diff": {s: abs(res_l[s] - pair_l[s]) / abs(pair_l[s])
                         for s in res_l},
            "launches_per_rank": run_launches(outs_res)}
        lap("read")
    rec["nccl"] = nccl_check(torch, dev)
    lap("nccl")
    rec["seconds"]["total"] = sum(seconds.values())
    b1 = {"two_ranks": [x["flash_fused_step"]
                        for x in rec["launches_per_rank"]],
          "preempt": [x["flash_fused_step"]
                      for x in rec["preempt"]["launches_per_rank"]],
          "resume": [x["flash_fused_step"]
                     for x in rec["resume"]["launches_per_rank"]]}
    b1["fsdp"] = [x["flash_fused_step"]
                  for x in rec["fsdp"]["launches_per_rank"]]
    b1["fsdp_resume"] = [x["flash_fused_step"] for x in
                         rec["fsdp"]["resume"]["launches_per_rank"]]
    rs = rec["reshard"]
    for name in ("fsdp_to_one", "one_to_fsdp"):
        b1[name] = [x["flash_fused_step"]
                    for x in rs[name]["launches_per_rank"]]
    rec["b1_launches"] = b1
    runs = (rec["launches_per_rank"] + rec["preempt"]["launches_per_rank"]
            + rec["resume"]["launches_per_rank"]
            + rec["fsdp"]["launches_per_rank"]
            + rec["fsdp"]["resume"]["launches_per_rank"]
            + rs["fsdp_to_one"]["launches_per_rank"]
            + rs["one_to_fsdp"]["launches_per_rank"])
    launches = {k: sum(x[k] for x in runs) for k in runs[0]}
    launches["flash_fused_step"] += rec["nccl"]["b1_launches"][0]
    rec["launches"] = launches
    emit(rec)
    st, nc, sp = rec["stall"], rec["nccl"], rec["state"]
    fs = rec["fsdp"]
    if not (sorted(fs["losses"]) == list(range(1, DDP_STEPS + 1))
            and any("data=1 fsdp=2" in x for x in fs["mesh_line"])
            and max(fs["loss_rel_diff"].values()) <= TOL_DDP_LOSS_REL
            and fs["state"][2]["rel_l2"] <= TOL_DDP_STATE2_REL_L2
            and fs["state"][DDP_STEPS]["rel_l2"] <= TOL_DDP_STATE_REL_L2
            and all(x["bn_tensors"] > 0 and x["bn_counts_equal"]
                    for x in fs["state"].values())
            and all(v <= TOL_DDP_BN_REL_L2[step, k.rsplit(".", 1)[1]]
                    for step, x in fs["state"].items()
                    for k, v in x["bn_rel_l2"].items())
            and b1["fsdp"] == [12 * DDP_STEPS] * 2
            and all(h["resident_sharded"] == 0 for h in held)
            and all(v < 0.75 for v in fs["held_share_of_one_process"])
            and fs["resume"]["resumed_at_2"] == [True, True]
            and sorted(fs["resume"]["losses"]) == [3, 4]
            and max(fs["resume"]["rel_diff"].values()) <= TOL_RESUME_REL
            and b1["fsdp_resume"] == [24, 24]
            and fs["read_model_weights_equals_gathered"]
            and fs["live_audit"]["equals_golden"] == [True, True]):
        raise AssertionError(f"ddp fsdp: {fs}")
    to_one, to_fsdp = rs["fsdp_to_one"], rs["one_to_fsdp"]
    if not (to_one["restored_line"] == to_one["resumed_at_2"] == [True]
            and sorted(to_one["losses"]) == [3, 4]
            and max(to_one["rel_diff"].values()) <= TOL_RESUME_REL
            and to_one["state"]["rel_l2"] <= TOL_DDP_STATE_REL_L2
            and to_one["state"]["bn_tensors"] > 0
            and to_one["state"]["bn_counts_equal"]
            and all(v <= TOL_DDP_BN_REL_L2[DDP_STEPS, k.rsplit(".", 1)[1]]
                    for k, v in to_one["state"]["bn_rel_l2"].items())
            and b1["fsdp_to_one"] == [24]
            and to_fsdp["restored_line"] == [True, True]
            and to_fsdp["resumed_at_2"] == [True, True]
            and any("data=1 fsdp=2" in x for x in to_fsdp["mesh_line"])
            and sorted(to_fsdp["losses"]) == [3, 4]
            and max(to_fsdp["rel_diff"].values()) <= TOL_RESUME_REL
            and all(h["resident_sharded"] == 0
                    for h in to_fsdp["state_bytes_per_rank"])
            and all(v < 0.75 for v in to_fsdp["held_share_of_one_process"])
            and b1["one_to_fsdp"] == [24, 24]):
        raise AssertionError(f"ddp resharded resume: {rs}")
    if not (sorted(one_l) == sorted(pair_l) == list(range(1, DDP_STEPS + 1))
            and all(np.isfinite(list(pair_l.values())))
            and max(rec["loss_rel_diff"].values()) <= TOL_DDP_LOSS_REL
            and sp[2]["rel_l2"] <= TOL_DDP_STATE2_REL_L2
            and sp[DDP_STEPS]["rel_l2"] <= TOL_DDP_STATE_REL_L2
            and all(x["bn_tensors"] > 0 and x["bn_counts_equal"]
                    for x in sp.values())
            and all(v <= TOL_DDP_BN_REL_L2[step, k.rsplit(".", 1)[1]]
                    for step, x in sp.items()
                    for k, v in x["bn_rel_l2"].items())
            and any("backend=gloo world=2" in x for x in rec["backend_line"])
            and b1["two_ranks"] == [12 * DDP_STEPS] * 2
            and [x["flash_fused_step"] for x in
                 rec["launches_one_process"]] == [12 * DDP_STEPS]
            and rec["preempt"]["stopped_at_2"] == [True, True]
            and rec["preempt"]["sigterm_seen"] == [False, True]
            and rec["preempt"]["checkpoints"] == ["2"]
            and b1["preempt"] == [24, 24]
            and rec["resume"]["resumed_at_2"] == [True, True]
            and sorted(res_l) == list(range(1, DDP_STEPS + 1))
            and max(rec["resume"]["rel_diff"].values()) <= TOL_RESUME_REL
            and b1["resume"] == [24, 24]
            and st["rank0_exit"] == 98
            and st["seconds_after_sigstop"] is not None
            and st["seconds_after_sigstop"] <= DDP_STALL_TIMEOUT + 30
            and st["stall_line"] and "step+data at step" in st["stall_line"][0]
            and st["dump_has_stacks"]
            and nc["backend"] == "nccl" and nc["all_reduce"] == [0, 1, 2, 3]
            and nc["finite"] and nc["b1_launches"] == [12, 12]
            and nc["loss_rel_diff"] <= TOL_DDP_LOSS_REL
            and nc["state_rel_l2"] <= TOL_DDP_NCCL_STATE_REL_L2
            and not any(v for k, v in launches.items()
                        if k != "flash_fused_step")):
        raise AssertionError(f"ddp: {rec}")
    return rec


HALO_BATCH = 2                # the train pair's global batch at 368x496
HALO_STEPS = 2                # the pair's steps; the fsdp x seq run takes 1
HALO_ITERS = 12               # the train steps' iterations
HALO_EVAL_ITERS = 32
# JAX's fence-vs-halo bounds (tests/test_zzzhalo.py): losses and
# parameters, halo against the one-process fence step
TOL_HALO_ATOL, TOL_HALO_RTOL = 1e-4, 1e-3
TOL_HALO_EVAL_PX = 1e-3       # flow_low / flow_up, halo vs one process
# the fence step on row slabs: v1 on B1, the chairs state with train-mode
# BatchNorm and noise
FENCE_CFG = dict(corr_impl="flash", fused_update=True)
FENCE_TC = dict(freeze_bn=False, add_noise=True)

#: ``python -c HALO_CHILD SPEC OUT``: one rank (torchrun's variables, on
#: cuda:0, so gloo) of the halo phase, on a (data 1, fsdp SPEC["fsdp"],
#: seq 2) mesh. With SPEC["batches"] it trains the seeded v1 state
#: (``create_state``: the same weights as the parent's) with the halo
#: train step on them (global batch, full height; the step keeps its
#: rows) and writes OUT/rank<r>.json: per-step losses and EPEs, its peak
#: allocated bytes over what it held before the steps (the state), that
#: state, kernel launches and seconds; rank 0 saves the gathered state
#: dict. With SPEC["eval"]: the halo eval step of the seed-0 model on the
#: padded pair (a warm call, then a measured one), its peak bytes over
#: what it held before the call and each pyramid level's bytes on this
#: rank; rank 0 saves the flows. With SPEC["fence"] (cfg, tc, batches):
#: the fence train step on the same mesh (row slabs, B1), its losses, B1
#: launches per step, peak bytes and seconds, rank 0 saving the gathered
#: state dict; with SPEC["fence_eval"]: the fence eval step of the seed-0
#: model (a warm call, then a measured one), its B1 launches, peak bytes
#: and seconds, each rank saving its slabs.
HALO_CHILD = """
import json, sys, time, torch
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.models.raft import create_model
from dexiraft_tpu_torch.ops import corr_kernels as ck
from dexiraft_tpu_torch.parallel import distributed, halo, make_train_mesh
from dexiraft_tpu_torch.parallel.fsdp import shard_state
from dexiraft_tpu_torch.train.state import create_state
from dexiraft_tpu_torch.train.step import make_eval_step, make_train_step

spec, out = torch.load(sys.argv[1], weights_only=False), sys.argv[2]
world = distributed.initialize("cuda:0")
dev = world.device
cfg, tc = raft_v1(), TrainConfig(**spec["tc"])
mesh = make_train_mesh(tc.batch_size, world, fsdp=spec["fsdp"], seq=2)
volumes = []
row_block_pyramid = halo.row_block_pyramid
def recorded(*a, **k):
    pyr = row_block_pyramid(*a, **k)
    volumes.append([t.numel() * t.element_size() for t in pyr.levels])
    return pyr
halo.row_block_pyramid = recorded
rec = {"rank": world.rank, "backend": world.backend,
       "mesh": [mesh.data_index, mesh.fsdp_index, mesh.seq_index]}
def train(cfg, tc, batches, sharding):
    state = shard_state(create_state(cfg, tc, device=dev), mesh)
    step = make_train_step(cfg, tc, mesh=mesh, compute_sharding=sharding)
    r = {"losses": [], "epe": [], "finite": [], "b1": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    r["base_bytes"] = torch.cuda.memory_allocated(dev)
    ck.reset_launches()
    t0 = time.perf_counter()
    for b in batches:
        before = ck.LAUNCHES["flash_fused_step"]
        state, m = step(state, {k: v.to(dev) for k, v in b.items()})
        r["losses"].append(float(m["loss"]))
        r["epe"].append(float(m["epe"]))
        r["finite"].append(bool(m["state_finite"]))
        r["b1"].append(ck.LAUNCHES["flash_fused_step"] - before)
    torch.cuda.synchronize()
    r["s"] = time.perf_counter() - t0
    r["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - r["base_bytes"]
    r["state_bytes"] = state.shards.state_bytes(state.optimizer)
    r["launches"] = dict(ck.LAUNCHES)
    with state.shards.gathered_params() as model:
        if world.rank == 0:
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       out + "/state_" + sharding + ".pt")
    return r
def evaluate(ev, e):
    ev(e["image1"], e["image2"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    del volumes[:]
    ck.reset_launches()
    t0 = time.perf_counter()
    low, up = ev(e["image1"], e["image2"])
    torch.cuda.synchronize()
    return low, up, {"s": time.perf_counter() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
                     "launches": dict(ck.LAUNCHES)}
if spec["batches"]:
    r = train(cfg, tc, spec["batches"], "halo")
    rec.update({k: r[k] for k in ("losses", "epe", "finite", "state_bytes")},
               train_s=r["s"], train_peak_bytes=r["peak_bytes"],
               train_base_bytes=r["base_bytes"],
               train_volume_bytes=volumes[0], launches=r["launches"])
if "eval" in spec:
    e = spec["eval"]
    ev = make_eval_step(create_model(cfg, seed=e["seed"], device=dev),
                        iters=e["iters"], device=dev, mesh=mesh,
                        compute_sharding="halo")
    low, up, r = evaluate(ev, e)
    rec.update(eval_s=r["s"], eval_peak_bytes=r["peak_bytes"],
               eval_volume_bytes=volumes[0], eval_launches=r["launches"])
    if world.rank == 0:
        torch.save({"low": low.cpu(), "up": up.cpu()}, out + "/eval.pt")
if "fence" in spec:
    f = spec["fence"]
    rec["fence"] = train(raft_v1(**f["cfg"]), TrainConfig(**f["tc"]),
                         f["batches"], "fence")
if "fence_eval" in spec:
    e = spec["fence_eval"]
    ev = make_eval_step(create_model(raft_v1(**e["cfg"]), seed=e["seed"],
                                     device=dev),
                        iters=e["iters"], device=dev, mesh=mesh)
    low, up, rec["fence_eval"] = evaluate(ev, e)
    torch.save({"low": low.cpu(), "up": up.cpu()},
               out + "/fence_eval%d.pt" % mesh.seq_index)
with open(out + "/rank%d.json" % world.rank, "w") as f:
    json.dump(rec, f)
distributed.teardown()
"""


def bound_excess(torch, ours, ref, atol, rtol) -> float:
    """max |ours - ref| / (atol + rtol |ref|) over every element: <= 1
    is within the bounds."""
    ours, ref = torch.as_tensor(ours).double(), torch.as_tensor(ref).double()
    return float(((ours - ref).abs() / (atol + rtol * ref.abs())).max())


def phase_halo(torch, dev, card) -> dict:
    """Halo compute sharding (A12.2), the row-block correlation (A12.3)
    and the fence step on row slabs (A12.2b): v1 full width (basic
    encoders, hidden 128), on ranks that share cuda:0 (gloo).
      * halo train: two ranks, data 1 x fsdp 1 x seq 2, corr_impl
        allpairs, fp32, frozen BatchNorm, the seeded chairs state,
        HALO_STEPS halo steps at 368x496, batch HALO_BATCH, 12
        iterations; per-step losses and the gathered parameters after
        the last step against the one-process fence step of the same
        config on the same batches, at JAX's fence-halo bounds
        (TOL_HALO_ATOL / TOL_HALO_RTOL);
      * fence train on row slabs: the same two ranks, v1 on B1
        (FENCE_CFG), the chairs state with train-mode BatchNorm and
        noise (FENCE_TC), HALO_STEPS fence steps on the same batches, B1
        HALO_ITERS times a step on every rank; losses and parameters
        against the one-process B1 step at the same bounds;
      * fsdp inside both: four ranks, data 1 x fsdp 2 x seq 2, one halo
        step and one fence step, the same bounds against the one-process
        steps' first;
      * halo eval: the pair ranks' halo eval step of the seed-0 model on
        a Sintel-shaped pair padded with InputPadder(seq=2) to 448x1024,
        HALO_EVAL_ITERS iterations, flow_low and flow_up within
        TOL_HALO_EVAL_PX of the one-process eval step on the same
        padding;
      * fence eval on row slabs: the pair ranks' fence eval step of the
        seed-0 v1 on B1 on the same pair, each rank's slabs put back
        together within TOL_HALO_EVAL_PX of the one-process B1 eval step,
        B1 HALO_EVAL_ITERS times a forward on every rank.
    Printed: each rank's peak allocated bytes over what it held before
    the steps (its state) or the eval call, beside the one process's
    (whose earlier phases' models stay allocated), with the states'
    bytes; the halo pyramid's bytes beside the estimate (B·(H/8/2)·(W/8)
    queries x (H/8)·(W/8) targets x 4 B at level 0); B1 launches;
    seconds. The halo path launches no kernel (all-pairs lookup). The
    runs start together and the one-process references run beside them:
    what this checks is parity and memory, not speed on one card."""
    import tempfile

    from dexiraft_tpu_torch.config import TrainConfig, raft_v1
    from dexiraft_tpu_torch.data.padder import InputPadder
    from dexiraft_tpu_torch.models.raft import create_model
    from dexiraft_tpu_torch.ops import corr_kernels as ck
    from dexiraft_tpu_torch.train.state import create_state
    from dexiraft_tpu_torch.train.step import make_eval_step, make_train_step

    t_start = time.perf_counter()
    cfg, fence_cfg = raft_v1(), raft_v1(**FENCE_CFG)
    tc_kw = dict(batch_size=HALO_BATCH, image_size=TRAIN_SIZE,
                 iters=HALO_ITERS, freeze_bn=True)
    fence_kw = dict(tc_kw, **FENCE_TC)
    batches = [{k: v.cpu() for k, v in train_batch(
        torch, dev, HALO_BATCH, seed=40 + i).items()}
        for i in range(HALO_STEPS)]
    frames = sintel_frames(5, 2)
    pad = InputPadder(frames[0].shape, seq=2)
    im1, im2 = (pad_batch(pad, [f]) for f in frames)
    rec = {"phase": "halo", "padded": list(pad.padded_shape),
           "mesh_pair": "data 1 x fsdp 1 x seq 2",
           "mesh_fsdp": "data 1 x fsdp 2 x seq 2"}
    procs, outs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_halo_") as root:
        specs = {2: dict(tc=tc_kw, fsdp=1, batches=batches,
                         eval=dict(seed=0, iters=HALO_EVAL_ITERS,
                                   image1=im1, image2=im2),
                         fence=dict(cfg=FENCE_CFG, tc=fence_kw,
                                    batches=batches),
                         fence_eval=dict(cfg=FENCE_CFG, seed=0,
                                         iters=HALO_EVAL_ITERS, image1=im1,
                                         image2=im2)),
                 4: dict(tc=tc_kw, fsdp=2, batches=batches[:1],
                         fence=dict(cfg=FENCE_CFG, tc=fence_kw,
                                    batches=batches[:1]))}
        for world, spec in specs.items():
            d = os.path.join(root, f"w{world}")
            os.makedirs(d)
            torch.save(spec, os.path.join(d, "spec.pt"))
            port = free_ports(1)[0]
            procs[world] = [subprocess.Popen(
                [sys.executable, "-c", HALO_CHILD,
                 os.path.join(d, "spec.pt"), d], cwd=REPO,
                env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(world)]
        try:
            # the one-process references, beside the ranks
            one = {}
            for name, c, kw in (("halo", cfg, tc_kw),
                                ("fence", fence_cfg, fence_kw)):
                tc = TrainConfig(**kw)
                state = create_state(c, tc, device=dev)
                step = make_train_step(c, tc)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                losses, states = [], []
                for b in batches:
                    state, m = step(state, {k: v.to(dev)
                                            for k, v in b.items()})
                    losses.append(float(m["loss"]))
                    states.append({k: v.detach().cpu().clone() for k, v in
                                   state.model.state_dict().items()})
                torch.cuda.synchronize()
                one[name] = dict(losses=losses, states=states,
                                 peak=torch.cuda.max_memory_allocated(dev)
                                 - base)
                del state, step
            for name, c in (("halo", cfg), ("fence", fence_cfg)):
                ev = make_eval_step(create_model(c, seed=0, device=dev),
                                    iters=HALO_EVAL_ITERS, device=dev)
                ev(im1, im2)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                ck.reset_launches()
                one[name]["flows"] = [t.cpu() for t in ev(im1, im2)]
                torch.cuda.synchronize()
                one[name].update(
                    eval_peak=torch.cuda.max_memory_allocated(dev) - base,
                    eval_b1=ck.LAUNCHES["flash_fused_step"])
                del ev
            torch.cuda.empty_cache()
            for world, ps in procs.items():
                for p in ps:
                    out, err = p.communicate(timeout=600)
                    if p.returncode != 0:
                        raise AssertionError(
                            f"halo: a rank of {world} exited "
                            f"{p.returncode}: {out[-2000:]} {err[-3000:]}")
                outs[world] = [json.load(open(os.path.join(
                    root, f"w{world}", f"rank{r}.json")))
                    for r in range(world)]
            saved = {(world, name): torch.load(os.path.join(
                root, f"w{world}", f"state_{name}.pt"))
                for world in (2, 4) for name in ("halo", "fence")}
            flows = torch.load(os.path.join(root, "w2", "eval.pt"))
            slabs = [torch.load(os.path.join(root, "w2", f"fence_eval{i}.pt"))
                     for i in range(2)]
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()

    def params_excess(ours, ref):
        return max(bound_excess(torch, ours[k], v, TOL_HALO_ATOL,
                                TOL_HALO_RTOL) for k, v in ref.items()
                   if v.is_floating_point())

    def loss_excess(runs, ref):
        return max(bound_excess(torch, r, ref[:len(r)], TOL_HALO_ATOL,
                                TOL_HALO_RTOL) for r in runs)

    pair, fsdp = outs[2], outs[4]
    fence_low, fence_up = (torch.cat([s[k] for s in slabs], dim=1)
                           for k in ("low", "up"))
    h8, w8 = pad.padded_shape[0] // 8, pad.padded_shape[1] // 8
    rec.update(
        seconds=time.perf_counter() - t_start,
        backend=[r["backend"] for r in pair + fsdp],
        ranks_mesh={2: [r["mesh"] for r in pair],
                    4: [r["mesh"] for r in fsdp]},
        pair_losses=[r["losses"] for r in pair],
        fsdp_losses=[r["losses"] for r in fsdp],
        one_process_losses=one["halo"]["losses"],
        pair_loss_excess=loss_excess([r["losses"] for r in pair],
                                     one["halo"]["losses"]),
        fsdp_loss_excess=loss_excess([r["losses"] for r in fsdp],
                                     one["halo"]["losses"]),
        pair_params_excess=params_excess(saved[2, "halo"],
                                         one["halo"]["states"][-1]),
        fsdp_params_excess=params_excess(saved[4, "halo"],
                                         one["halo"]["states"][0]),
        finite=all(all(r["finite"]) and all(r["fence"]["finite"])
                   for r in pair + fsdp),
        eval_low_px=float((flows["low"] - one["halo"]["flows"][0])
                          .abs().max()),
        eval_up_px=float((flows["up"] - one["halo"]["flows"][1]).abs().max()),
        fence={
            "config": "v1 on B1 (flash fused), chairs state: train-mode "
                      "BatchNorm, add_noise",
            "pair_losses": [r["fence"]["losses"] for r in pair],
            "fsdp_losses": [r["fence"]["losses"] for r in fsdp],
            "one_process_losses": one["fence"]["losses"],
            "pair_loss_excess": loss_excess(
                [r["fence"]["losses"] for r in pair],
                one["fence"]["losses"]),
            "fsdp_loss_excess": loss_excess(
                [r["fence"]["losses"] for r in fsdp],
                one["fence"]["losses"]),
            "pair_params_excess": params_excess(
                saved[2, "fence"], one["fence"]["states"][-1]),
            "fsdp_params_excess": params_excess(
                saved[4, "fence"], one["fence"]["states"][0]),
            "b1_per_step": [r["fence"]["b1"] for r in pair + fsdp],
            "eval_b1": [r["fence_eval"]["launches"]["flash_fused_step"]
                        for r in pair],
            "one_process_eval_b1": one["fence"]["eval_b1"],
            "eval_low_px": float((fence_low - one["fence"]["flows"][0])
                                 .abs().max()),
            "eval_up_px": float((fence_up - one["fence"]["flows"][1])
                                .abs().max()),
            "eval_slab_rows": [list(s["up"].shape[1:3]) for s in slabs],
            "train_peak_bytes": {
                "pair": [r["fence"]["peak_bytes"] for r in pair],
                "fsdp": [r["fence"]["peak_bytes"] for r in fsdp],
                "one_process": one["fence"]["peak"]},
            "eval_peak_bytes": {
                "pair": [r["fence_eval"]["peak_bytes"] for r in pair],
                "one_process": one["fence"]["eval_peak"]},
            "rank_seconds": {
                "pair_train": [r["fence"]["s"] for r in pair],
                "pair_eval": [r["fence_eval"]["s"] for r in pair],
                "fsdp_train": [r["fence"]["s"] for r in fsdp]},
            "launches": [r["fence"]["launches"] for r in pair + fsdp]},
        train_peak_bytes={"pair": [r["train_peak_bytes"] for r in pair],
                          "fsdp": [r["train_peak_bytes"] for r in fsdp],
                          "one_process": one["halo"]["peak"]},
        train_base_bytes={"pair": [r["train_base_bytes"] for r in pair],
                          "fsdp": [r["train_base_bytes"] for r in fsdp]},
        eval_peak_bytes={"pair": [r["eval_peak_bytes"] for r in pair],
                         "one_process": one["halo"]["eval_peak"]},
        eval_volume_bytes=[r["eval_volume_bytes"] for r in pair],
        volume_level0_estimate_bytes={
            "rank": (h8 // 2) * w8 * h8 * w8 * 4,
            "whole": h8 * w8 * h8 * w8 * 4},
        state_bytes={"pair": pair[0]["state_bytes"],
                     "fsdp": [r["state_bytes"] for r in fsdp]},
        rank_seconds={"pair_train": [r["train_s"] for r in pair],
                      "pair_eval": [r["eval_s"] for r in pair],
                      "fsdp_train": [r["train_s"] for r in fsdp]},
        launches=[r["launches"] for r in pair + fsdp]
        + [r["eval_launches"] for r in pair],
        card=card)
    emit(rec)
    fence = rec["fence"]
    if not (rec["pair_loss_excess"] <= 1 and rec["fsdp_loss_excess"] <= 1
            and rec["pair_params_excess"] <= 1
            and rec["fsdp_params_excess"] <= 1 and rec["finite"]
            and rec["eval_low_px"] <= TOL_HALO_EVAL_PX
            and rec["eval_up_px"] <= TOL_HALO_EVAL_PX
            and fence["pair_loss_excess"] <= 1
            and fence["fsdp_loss_excess"] <= 1
            and fence["pair_params_excess"] <= 1
            and fence["fsdp_params_excess"] <= 1
            and fence["eval_low_px"] <= TOL_HALO_EVAL_PX
            and fence["eval_up_px"] <= TOL_HALO_EVAL_PX
            and fence["b1_per_step"] == [[HALO_ITERS] * HALO_STEPS] * 2
            + [[HALO_ITERS]] * 4
            and fence["eval_b1"] == [HALO_EVAL_ITERS] * 2
            and fence["one_process_eval_b1"] == HALO_EVAL_ITERS
            and not any(n for counts in fence["launches"]
                        for k, n in counts.items()
                        if k != "flash_fused_step")
            and rec["backend"] == ["gloo"] * 6
            and rec["ranks_mesh"] == {2: [[0, 0, 0], [0, 0, 1]],
                                      4: [[0, 0, 0], [0, 0, 1], [0, 1, 0],
                                          [0, 1, 1]]}
            and all(len(r["losses"]) == HALO_STEPS for r in pair)
            and not any(n for counts in rec["launches"]
                        for n in counts.values())
            and all(v[0] == rec["volume_level0_estimate_bytes"]["rank"]
                    for v in rec["eval_volume_bytes"])
            and all(s["resident_sharded"] == 0 for s in
                    rec["state_bytes"]["fsdp"])):
        raise AssertionError(f"halo: {rec}")
    return rec


# every phase: no process outlives the phase that started it
for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = contained(globals()[_name])


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
    adopted = adopt_orphans()

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
    # strict mode (A13's runtime guards) on v1's main path
    strict_region_checks(torch, ck, dev, v1_models["fused"], v1_batch)
    # mixed precision on the main paths
    mixed = phase_mixed(torch, ck, dev, smi,
                        {"v1": v1_models, "v5": v5_models},
                        {"v1": v1_batch, "v5": v5_batch})
    # the rest of the model family, the adaptive loop and the streaming
    # engine, each on B1, the production kernel
    phase_variants(torch, ck, dev)
    phase_adaptive(torch, ck, dev)
    phase_video(torch, ck, dev)
    # the flow service on the main path, in process and as the CLI
    serve = phase_serve(torch, ck, dev)
    phase_serve_cli(torch)
    # evaluation on the main path: validators, submissions, the CLIs
    import tempfile

    data_dir = os.environ.get("DEXIRAFT_DATA_DIR")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as root:
        try:
            ev = phase_eval(torch, ck, dev, smi, root)
            phase_eval_cli(torch, smi, root, ev,
                           mixed["v5"]["flow_up_rms_px"])
        finally:
            if data_dir is None:
                os.environ.pop("DEXIRAFT_DATA_DIR", None)
            else:
                os.environ["DEXIRAFT_DATA_DIR"] = data_dir
    # data-parallel inference over a serve mesh of two entries on the card
    dp = phase_data_parallel(torch, ck, dev, smi)
    # training: the train step at the chairs geometry, the demo that
    # learns, and the CLI with --resume, each through B1 where fused
    train = phase_train(torch, ck, dev, smi)
    # bf16 and remat on the same step (A2, A10)
    precision_remat = phase_train_precision_remat(torch, ck, dev, smi,
                                                  train.pop("batch"))
    demo = phase_train_demo(torch, ck, dev, smi)
    tcli = phase_train_cli(torch, smi)
    # the packed-record plane, the native bridge and the trainer's
    # recovery paths, against the train_cli phase's full run
    recs = phase_records(torch, dev, smi, tcli["full_losses"])
    # the fleet router over two serve replicas on B1, and the standalone
    # DexiNed workload (no corr kernel)
    router = phase_router(torch, dev, smi)
    dexined = phase_dexined(torch, ck, dev, smi)
    # data-parallel training on two ranks sharing the card, and a 1-rank
    # NCCL group (A12's first half)
    ddp = phase_ddp(torch, dev, smi)
    # halo compute sharding, the row-block correlation and the fence step
    # on row slabs (A12.2, A12.3, A12.2b): v1 over a seq axis of two ranks
    # sharing the card, and fsdp x seq
    halo_rec = phase_halo(torch, dev, smi)
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
    # phases' counted steps (the timed train steps, the demo and the
    # records phase's resumed run)
    kernels[0]["serve_launches"] = serve["launches"]["flash_fused_step"]
    # and on the eval phase's validators and submissions
    kernels[0]["eval_launches"] = ev["b1_launches_total"]
    # the data-parallel leg's two shards (ITERS a shard a dispatch)
    kernels[0]["data_parallel_launches"] = dp["b1_launches"]
    # the router phase's replicas, as they counted them
    kernels[0]["router_launches"] = router["launches"]["flash_fused_step"]
    # the mixed phase's forwards
    kernels[0]["mixed_launches"] = mixed["launches"]
    for entry in kernels:
        entry["train_launches"] = (train["launches"][entry["name"]]
                                   + precision_remat["launches"][entry["name"]]
                                   + demo["launches"][entry["name"]]
                                   + recs["launches"][entry["name"]])
        entry["dexined_launches"] = dexined["launches"][entry["name"]]
        # every rank's launches in the ddp phase's runs
        entry["ddp_launches"] = ddp["launches"][entry["name"]]
        # every rank's launches on the fence step on row slabs: the
        # train steps and the measured eval forward
        entry["fence_seq_launches"] = sum(
            counts[entry["name"]] for counts in halo_rec["fence"]["launches"]
        ) + (sum(halo_rec["fence"]["eval_b1"])
             if entry["name"] == "flash_fused_step" else 0)
    # strict mode's checks: the in-process region's and the children's
    from dexiraft_tpu_torch.analysis import guards

    emit({"phase": "strict", **STRICT, "counts": guards.counts()})
    # the processes every phase left behind, each stopped after it
    stop_strays("main")
    emit({"phase": "processes", "subreaper": adopted, "strays": STRAYS})
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
    try:
        code = main()
    finally:
        stop_strays("exit")
    sys.exit(code)
