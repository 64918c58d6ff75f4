"""The train step and the test-mode steps the inference engines drive.

Counterpart of ``make_train_step``, ``make_eval_step``, ``make_encode_step``
and ``make_refine_step`` in ``dexiraft_tpu/train/step.py``, on one device;
the train step also runs data-parallel over ranks, and with its
parameters and Adam moments stored sharded over an fsdp axis (its
``mesh=``).
PyTorch runs eagerly, so there is nothing to compile: a test-mode step
moves host arrays to the device, runs the model under
``torch.inference_mode()`` and returns device tensors; the train step runs
forward, sequence loss, backward and the optimizer update in place on a
:class:`~dexiraft_tpu_torch.train.state.TrainState`.

Each step states its own arithmetic rather than inheriting PyTorch's
global flags: cuDNN's TF32 convolutions follow ``tf32`` (``EVAL_TF32``
unless the caller says otherwise; the train step's are fp32,
``TRAIN_TF32``), matmuls run in full fp32, and cuDNN runs only its
deterministic algorithms. The test-mode steps pick each convolution's
algorithm by timing those candidates at the first call of a shape
(``benchmark``; ``eval_arithmetic``); the train step takes cuDNN's
heuristic pick among them, which no timing moves
(``train_arithmetic``), so two processes that share a card train the
same steps bit for bit. The flags hold while any call runs, on any
thread; the global flags are restored when the last one returns.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from dexiraft_tpu_torch.analysis import guards
from dexiraft_tpu_torch.config import RAFTConfig, TrainConfig
from dexiraft_tpu_torch.device import resolve_device
from dexiraft_tpu_torch.models.layers import set_data_mesh
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.ops.losses import (METRIC_KEYS, metrics_from_sums,
                                           sequence_loss_sums)
from dexiraft_tpu_torch.parallel.distributed import World
from dexiraft_tpu_torch.parallel.layout import FsdpMesh, data_axis, local_rows
from dexiraft_tpu_torch.train.state import TrainState, train_model_config

# The eval step's convolutions: fp32 (TF32 off). On an H100 at 440x1024,
# 32 iterations, seeded weights, TF32 convolutions moved v5's flow_low
# 9.7e-3 to 1.02e-2 px from the fp32 plain-lookup path from one run to the
# next, across the 1e-2 px parity guard (v1: 5.1e-3; PERF.md). Re-measured
# by chip_smoke.py's "tf32" phase.
EVAL_TF32 = False
# The train step's convolutions: fp32, the JAX package's fp32 train step.
TRAIN_TF32 = False

Features = Dict[str, torch.Tensor]


class _Arithmetic:
    """Who is inside :func:`eval_arithmetic` or :func:`train_arithmetic`,
    process-wide.

    The flags it sets are process-global, and forwards run on several
    threads at once (the scheduler's dispatcher and the streaming
    handlers of serve/server.py). So the flags are set when the first
    forward enters (depth 0 -> 1) and restored when the last one leaves
    (1 -> 0); a forward that asks for another setting (TF32, or the
    timed search) waits until the forwards of the current setting have
    left. The mutex guards this bookkeeping only; forwards of one setting
    run concurrently."""

    def __init__(self):
        self.cv = threading.Condition(threading.Lock())
        self.depth = 0
        self.setting: Optional[Tuple[bool, bool]] = None
        self.saved = None

    def enter(self, tf32: bool, search: bool = True) -> None:
        setting = (tf32, search)
        with self.cv:
            while self.depth and self.setting != setting:
                self.cv.wait()
            if not self.depth:
                matmul = torch.backends.cuda.matmul
                cudnn = torch.backends.cudnn
                self.saved = (matmul.allow_tf32, cudnn.set_flags(
                    _enabled=cudnn.enabled, _benchmark=search,
                    _deterministic=True, _allow_tf32=tf32))
                matmul.allow_tf32 = False
                self.setting = setting
            self.depth += 1

    def leave(self) -> None:
        with self.cv:
            self.depth -= 1
            if not self.depth:
                matmul_tf32, cudnn_flags = self.saved
                torch.backends.cudnn.set_flags(*cudnn_flags)
                torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
                self.setting = self.saved = None
                self.cv.notify_all()


_ARITHMETIC = _Arithmetic()


@contextlib.contextmanager
def eval_arithmetic(tf32: bool):
    """cuDNN's TF32 flag set to ``tf32``, fp32 matmuls, and cuDNN's
    algorithm search over its deterministic algorithms (``benchmark``,
    ``deterministic``) for the body; the global flags as they were
    afterwards. Safe across threads (:class:`_Arithmetic`): the flags
    hold for every body running on any thread, and are restored when the
    last one leaves.

    The search matters: with TF32 off, cuDNN's heuristic choice for the
    motion encoder's 3x3 convs (256 -> 192 and 256 -> 126 channels) at
    the 55x128 map and batch 4, v5's loop at an engine batch of 2, is an
    FFT algorithm that takes hundreds of ms a call on an H100, where the
    search finds one that takes under a ms (PERF.md; chip_smoke.py's
    ``conv_search`` phase). The search costs the first call of each shape
    a few hundred ms. Restricting it to deterministic algorithms makes
    the step's output the same from call to call: an unrestricted search
    may pick one that is not, and two calls then differ in the last bit
    of the flow."""
    _ARITHMETIC.enter(tf32)
    try:
        yield
    finally:
        _ARITHMETIC.leave()


@contextlib.contextmanager
def train_arithmetic(tf32: bool = TRAIN_TF32):
    """:func:`eval_arithmetic` without the timed search: cuDNN's
    heuristic pick among its deterministic algorithms (``benchmark``
    off, ``deterministic`` on), by its mode-B heuristic (the package
    sets ``TORCH_CUDNN_USE_HEURISTIC_MODE_B``; dexiraft_tpu_torch/
    __init__.py). A timed pick depends on what else runs on the card at
    that moment, so processes sharing a card (the ranks of a
    data-parallel run, twin runs) picked differently and their steps
    parted from step 3 (up to 8.83e-6 in a resumed 2-rank run's loss on
    an H100; PERF.md). A pick that no timing moves is the same in every
    process. cuDNN's default (instant) heuristic picks an FFT algorithm
    for the motion encoder's 3x3 convolutions (256 -> 126 and 256 -> 192
    channels) at the chairs crop's 46x62 map and batch 10, 32-39 ms a
    call on an H100 (a v1 step 973 ms against 566 under the search);
    mode B picks implicit GEMMs there (596 ms; PERF.md,
    train_conv_picks.py)."""
    _ARITHMETIC.enter(tf32, search=False)
    try:
        yield
    finally:
        _ARITHMETIC.leave()


def _nchw(dev: torch.device):
    """Batched NHWC host array or tensor -> float32 NCHW tensor on dev."""

    def convert(x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(dev, torch.float32, non_blocking=True).permute(0, 3, 1, 2)

    return convert


def _nhwc(*tensors: torch.Tensor):
    return tuple(t.permute(0, 2, 3, 1) for t in tensors)


def _signature(*arrays) -> tuple:
    """(shape, dtype) of each array or tensor (None passes): the part of a
    step's compile key that the inputs give (analysis.guards)."""
    return tuple(None if a is None else (tuple(a.shape), str(a.dtype))
                 for a in arrays)


def make_eval_step(model: RAFT, iters: int = 24,
                   device: Union[str, torch.device] = "cuda",
                   tf32: bool = EVAL_TF32, adaptive: bool = False
                   ) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """step(image1, image2, flow_init=None[, iter_budget], *, edges1=None,
    edges2=None) -> (flow_low, flow_up).

    Inputs are batched NHWC arrays (or tensors) in [0, 255] (the engine's
    host layout); edges1/edges2 are v2/v3's (B, H, W, 3) edge images;
    flow_init is None or (B, H/8, W/8, 2). Outputs are NHWC device
    tensors: flow_low (B, H/8, W/8, 2), flow_up (B, H, W, 2). A flow_init
    row of zeros is the same as no warm start. ``tf32`` turns cuDNN's TF32
    convolutions on for the step's calls.

    ``adaptive=True``: the convergence-gated loop (RAFT.refine); the step
    takes a trailing ``iter_budget`` (None = ``iters``) and returns
    (flow_low, flow_up, iters_used (B,), final_delta (B,)).
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    to_dev = _nchw(dev)
    # this step's compile keys (analysis.guards): a new step searches anew,
    # as a new jitted function compiles anew; cuDNN searches per thread
    token, per_thread = object(), dev.type == "cuda"

    def run(image1, image2, flow_init, edges1, edges2, **kw):
        guards.note_new_key("eval_step", (
            token, _signature(image1, image2, flow_init, edges1, edges2),
            tf32, iters, adaptive, model.cfg.mixed_precision), per_thread)
        with eval_arithmetic(tf32):
            out = model(to_dev(image1), to_dev(image2), iters=iters,
                        flow_init=to_dev(flow_init), test_mode=True,
                        edges1=to_dev(edges1), edges2=to_dev(edges2), **kw)
        return _nhwc(*out[:2]) + tuple(out[2:])

    if adaptive:
        @torch.inference_mode()
        def adaptive_step(image1, image2, flow_init=None, iter_budget=None,
                          *, edges1=None, edges2=None):
            return run(image1, image2, flow_init, edges1, edges2,
                       adaptive=True,
                       iter_budget=None if iter_budget is None
                       else int(iter_budget))

        return adaptive_step

    @torch.inference_mode()
    def step(image1, image2, flow_init=None, *, edges1=None, edges2=None):
        return run(image1, image2, flow_init, edges1, edges2)

    return step


def make_encode_step(model: RAFT, device: Union[str, torch.device] = "cuda"
                     ) -> Callable[..., Features]:
    """encode(frame, edges=None) -> the frame's feature dict {fmap, ctx[,
    efmap, ectx]} (RAFT.encode_frame: NCHW device tensors at 1/8
    resolution).

    frame is a batched NHWC array or tensor in [0, 255]; edges is v2/v3's
    (B, H, W, 3) edge image. The streaming engine runs this once per new
    frame; composed with :func:`make_refine_step` it gives the eval step's
    flow.
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    to_dev = _nchw(dev)
    token, per_thread = object(), dev.type == "cuda"

    @torch.inference_mode()
    def encode(frame, edges=None) -> Features:
        guards.note_new_key("encode", (token, _signature(frame, edges),
                                       EVAL_TF32, model.cfg.mixed_precision),
                            per_thread)
        with eval_arithmetic(EVAL_TF32):
            return model.encode_frame(to_dev(frame), to_dev(edges))

    return encode


def make_refine_step(model: RAFT, iters: int = 24,
                     device: Union[str, torch.device] = "cuda",
                     adaptive: bool = False
                     ) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """refine(features1, features2, flow_init[, iter_budget]) ->
    (flow_low, flow_up), NHWC device tensors.

    features1 is the earlier frame's dict (its ctx seeds the GRU).
    flow_init, (B, H/8, W/8, 2), is always materialized: zeros are a cold
    start (None is taken as zeros). ``adaptive=True``: a trailing
    ``iter_budget`` and (flow_low, flow_up, iters_used, final_delta), as
    :func:`make_eval_step`.
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    to_dev = _nchw(dev)
    token, per_thread = object(), dev.type == "cuda"

    @torch.inference_mode()
    def refine(features1: Features, features2: Features, flow_init=None,
               iter_budget=None):
        if iter_budget is not None and not adaptive:
            raise ValueError(
                "iter_budget only has meaning with adaptive=True (the "
                "fixed path compiles its iteration count statically)")
        fmap = features1["fmap"]
        if flow_init is None:
            fi = fmap.new_zeros((fmap.shape[0], 2) + tuple(fmap.shape[2:]))
        else:
            fi = to_dev(flow_init)
        kw = {}
        if adaptive:
            kw = dict(adaptive=True, iter_budget=None if iter_budget is None
                      else int(iter_budget))
        guards.note_new_key("refine", (
            token, _signature(*(features1[k] for k in sorted(features1))),
            _signature(fi), EVAL_TF32, iters, adaptive,
            model.cfg.mixed_precision), per_thread)
        with eval_arithmetic(EVAL_TF32):
            out = model.refine(features1, features2, iters, fi, **kw)
        return _nhwc(*out[:2]) + tuple(out[2:])

    return refine


Batch = Dict[str, object]  # image1, image2, flow, valid [, edges1, edges2]


def all_finite(tensors) -> torch.Tensor:
    """0-d bool tensor: every floating element of every tensor is finite
    (the checkpoint gate's verdict on the state AFTER the update, which
    the loss, computed before it, cannot give)."""
    flat = [t.detach().reshape(-1) for t in tensors
            if t.is_floating_point() and t.numel()]
    if not flat:
        return torch.ones((), dtype=torch.bool)
    by_dtype: Dict[torch.dtype, list] = {}
    for t in flat:
        by_dtype.setdefault(t.dtype, []).append(t)
    oks = [torch.isfinite(torch.cat(ts)).all() for ts in by_dtype.values()]
    return torch.stack(oks).all()


def _state_tensors(state: TrainState):
    # the optimizer's parameters: the model's, or under fsdp this rank's
    # slices of the sharded ones (their full storage is freed)
    yield from state.optimizer.param_groups[0]["params"]
    yield from state.model.buffers()
    for st in state.optimizer.state.values():
        yield from (v for v in st.values() if isinstance(v, torch.Tensor))


def _add_noise(image: torch.Tensor, stdv: torch.Tensor,
               generator: torch.Generator,
               rows: Optional[torch.Tensor] = None,
               batch: int = 0) -> torch.Tensor:
    """Gaussian noise at ``stdv``, clipped to [0, 255]. ``rows``: the
    image holds those rows of a global batch of ``batch`` rows; the
    global batch's noise is drawn and its ``rows`` kept, so every rank
    draws what one process draws."""
    shape = image.shape if rows is None else (batch,) + image.shape[1:]
    noise = torch.randn(shape, device=image.device, generator=generator)
    if rows is not None:
        noise = noise[rows.to(image.device)]
    return (image + stdv * noise).clamp(0.0, 255.0)


def _all_reduce_grads_(model: RAFT, size: int, group=None) -> None:
    """Average the gradients over the ``size`` ranks of ``group`` (None:
    every rank): one all-reduce of one flat buffer."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(cfg: RAFTConfig, tc: TrainConfig, mesh=None,
                    compute_sharding: str = "fence"
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, object]]]:
    """step(state, batch) -> (state, metrics), advancing ``state`` in place.

    ``batch`` holds NHWC host arrays or tensors: image1/image2 (B, H, W,
    3) in [0, 255], flow (B, H, W, 2), valid (B, H, W) [, edges1/edges2
    (B, H, W, 3)]; they are moved to the model's device. The step: noise
    (``add_noise``: one stdv ~ U(0, 5) shared by both frames), the
    train-mode forward of every microbatch (``accum_steps``; BatchNorm's
    running stats move through them in order, as JAX's scan carries
    them) with its gradients summed and divided by ``accum_steps``, then
    clip + AdamW at the schedule's lr for ``state.step``. metrics: loss,
    epe, 1px, 3px, 5px (device tensors; means over the microbatches), lr
    (the update's) and state_finite (a 0-d bool tensor over the updated
    parameters, BatchNorm stats and Adam moments).

    Dropout masks and noise are drawn from ``state.generator``.

    ``mesh`` (a grouped ``parallel.World``, as ``parallel.make_train_mesh``
    returns it): the data-parallel step, which computes what one process
    computes at the global batch. ``batch`` holds this rank's rows of the
    global batch: the rank-th block of each microbatch
    (``parallel.local_rows``; ``Loader(..., microbatches=accum_steps)``
    reads them). The noise and
    dropout masks of the global batch are drawn on every rank (their
    generators stay equal) and each keeps its rows; BatchNorm normalises
    with the global microbatch's statistics (``models.layers.
    set_data_mesh``); the gradients are averaged over the ranks before
    the clip and AdamW; the loss is the mean of the ranks' losses (equal
    row counts), EPE and the px rates are reduced as sums over valid
    pixels, and state_finite is false if it is false on any rank.
    ``mesh`` (a ``parallel.layout.FsdpMesh``, for a state put in its
    storage layout by ``parallel.fsdp.shard_state``): JAX's fence mode.
    Between steps each rank holds its slices of the sharded parameters
    and of their moments; at entry the parameters are all-gathered into
    the model over the fsdp subgroup; the forward and backward are the
    replicated step's, on this rank's rows of the data axis (the data
    index over the data size: ``parallel.layout.data_axis``); the
    gradients are averaged over the data subgroup only (the ranks of an
    fsdp group hold the same rows); the clip norm is taken over the full
    gradient and AdamW updates this rank's slices; the full parameters
    are freed. The loss and metrics reduce over the data subgroup,
    state_finite over every rank (each checks only its own slices). With
    a data axis of one rank every rank computes the one-process step.
    ``edge_sum_fusion`` (v1): the model runs on the image pair and on the
    edge pair, and the per-iteration flows are summed. ``freeze_bn``: every
    BatchNorm runs on its running stats.

    ``precision="bf16"`` and ``remat`` act through the model: the state's
    model must be built from ``train_model_config(cfg, tc)``, as
    ``create_state(cfg, tc)`` builds it (mixed precision, the remat
    policy). The loss, metrics, gradients, clipping, AdamW and BatchNorm
    stats stay fp32, with no loss scaling (bf16 has fp32's exponent
    range), as in JAX.

    Refused, with the ROADMAP item that ports them: any other mesh
    (seq) and ``compute_sharding="halo"`` (A12).
    """
    if tc.precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be fp32|bf16, got {tc.precision!r}")
    if tc.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
    if compute_sharding not in ("fence", "halo"):
        raise ValueError(f"compute_sharding must be fence|halo, "
                         f"got {compute_sharding!r}")
    cfg = train_model_config(cfg, tc)
    if compute_sharding == "halo" or not (
            mesh is None or isinstance(mesh, FsdpMesh)
            or isinstance(mesh, World) and mesh.grouped):
        raise ValueError("seq meshes and compute_sharding='halo' are not "
                         "ported to PyTorch yet (ROADMAP A12); the port "
                         "trains over a process group's data axis and an "
                         "fsdp axis (parallel.make_train_mesh's World or "
                         "FsdpMesh)")
    fsdp = isinstance(mesh, FsdpMesh)
    data = data_axis(mesh)
    n_data = 1 if data is None else data.size
    if tc.edge_sum_fusion and (cfg.variant != "raft" or cfg.embed_dexined):
        raise ValueError(
            "edge_sum_fusion is the v1 (plain 'raft') training fusion — "
            "the model itself consumes edges in the other variants")
    token = object()

    def forward(model: RAFT, mb: Dict[str, torch.Tensor]) -> torch.Tensor:
        if tc.edge_sum_fusion:
            if "edges1" not in mb:
                raise ValueError("edge_sum_fusion needs edge-pair data "
                                 "(edge_root)")
            return (model(mb["image1"], mb["image2"], iters=tc.iters,
                          test_mode=False)
                    + model(mb["edges1"], mb["edges2"], iters=tc.iters,
                            test_mode=False))
        return model(mb["image1"], mb["image2"], iters=tc.iters,
                     test_mode=False, edges1=mb.get("edges1"),
                     edges2=mb.get("edges2"))

    def step(state: TrainState, batch: Batch):
        model, opt, gen = state.model, state.optimizer, state.generator
        if fsdp != (state.shards is not None):
            raise ValueError(
                "an fsdp mesh's step takes a state in its storage layout "
                "(parallel.fsdp.shard_state), and only such a step does")
        if model.cfg != cfg:
            raise ValueError("the state's model was built from another "
                             "RAFTConfig than this step's (build it from "
                             "train_model_config(cfg, tc))")
        dev = state.device
        to_dev = _nchw(dev)
        guards.note_new_key("train_step", (
            token, tuple((k, _signature(v)) for k, v in sorted(batch.items())
                         if v is not None),
            TRAIN_TF32, tc.precision, tc.remat, cfg.remat_lookup, tc.iters,
            tc.accum_steps), dev.type == "cuda")
        b = dict(batch)
        for key in ("image1", "image2", "flow", "edges1", "edges2"):
            if b.get(key) is not None:
                b[key] = to_dev(b[key])
        valid = b["valid"]
        if not isinstance(valid, torch.Tensor):
            valid = torch.from_numpy(np.ascontiguousarray(valid))
        b["valid"] = valid.to(dev, torch.float32, non_blocking=True)
        accum = tc.accum_steps
        n = b["image1"].shape[0]
        if n % accum:
            raise ValueError(
                f"batch {n} not divisible by accum_steps {accum}")
        rows = local_rows(n * n_data, accum, data)
        set_data_mesh(model, data, n // accum)
        if fsdp:
            # the entry fence: the full parameters, for this step only
            state.shards.gather_()
        with train_arithmetic(TRAIN_TF32):
            if tc.add_noise:
                stdv = torch.rand((), device=dev, generator=gen) * 5.0
                b["image1"] = _add_noise(b["image1"], stdv, gen, rows,
                                         n * n_data)
                b["image2"] = _add_noise(b["image2"], stdv, gen, rows,
                                         n * n_data)
            model.train()
            if tc.freeze_bn:
                model.freeze_bn()
            micro = n // accum
            opt.zero_grad(set_to_none=True)
            losses, seq_sums = [], []
            for i in range(accum):
                mb = {k: v[i * micro:(i + 1) * micro] for k, v in b.items()
                      if v is not None}
                with torch.enable_grad():
                    preds = forward(model, mb)
                    loss, sums = sequence_loss_sums(preds, mb["flow"],
                                                    mb["valid"], tc.gamma)
                    loss.backward()
                losses.append(loss.detach())
                seq_sums.append(sums.detach())
            if accum > 1:
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum)
            if data is not None:
                _all_reduce_grads_(model, data.size, data.group)
            lr = opt.current_lr()
            if fsdp:
                # this rank's slices; the full parameters are freed
                state.shards.step_(opt)
            else:
                opt.step()
            state.step += 1
            finite = all_finite(_state_tensors(state))
            losses, seq_sums = torch.stack(losses), torch.stack(seq_sums)
            if fsdp:
                if data is not None:
                    vec = torch.cat([losses, seq_sums.reshape(-1)])
                    dist.all_reduce(vec, group=data.group)
                    losses = vec[:accum] / data.size
                    seq_sums = vec[accum:].reshape(accum, -1)
                # each rank checked only its own slices
                bad = (~finite).to(torch.float32).reshape(1)
                dist.all_reduce(bad)
                finite = bad[0] == 0
            elif mesh is not None:
                # one all-reduce: the ranks' losses, metric sums and
                # non-finite verdicts
                vec = torch.cat([losses, seq_sums.reshape(-1),
                                 (~finite).to(torch.float32).reshape(1)])
                dist.all_reduce(vec)
                losses = vec[:accum] / mesh.size
                seq_sums = vec[accum:-1].reshape(accum, -1)
                finite = vec[-1] == 0
            per_micro = [metrics_from_sums(sums) for sums in seq_sums]
            out = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in METRIC_KEYS}
            out["loss"] = losses.mean()
            out["lr"] = lr
            out["state_finite"] = finite
        return state, out

    return step
