"""The train step and the test-mode steps the inference engines drive.

Counterpart of ``make_train_step``, ``make_eval_step``, ``make_encode_step``
and ``make_refine_step`` in ``dexiraft_tpu/train/step.py``, on one device;
the train step also runs data-parallel over ranks, with its parameters
and Adam moments stored sharded over an fsdp axis, and with its image
rows sharded over a seq axis (its ``mesh=``; the eval step too). The test-mode steps also run data-parallel in one process
over a serve mesh (``parallel.layout.make_serve_mesh``, their
``mesh=``): one replica of the model per entry, each batch's rows cut
into one block per entry, each block's forward launched on its entry's
device in turn (launches return at once, so the shards overlap on the
devices), the outputs ``parallel.layout.RowShards`` in row order.
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
from dexiraft_tpu_torch.models.layers import (SEQ_REFUSAL, seq_mesh,
                                              set_data_mesh)
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.ops.losses import (METRIC_KEYS, metrics_from_sums,
                                           sequence_loss_sums)
from dexiraft_tpu_torch.parallel import halo
from dexiraft_tpu_torch.parallel.distributed import World
from dexiraft_tpu_torch.parallel.layout import (FsdpMesh, RowShards,
                                                ServeMesh, check_serve_mesh,
                                                data_axis, has_seq,
                                                local_rows, replicate,
                                                row_blocks)
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
                   tf32: bool = EVAL_TF32, adaptive: bool = False, *,
                   mesh=None, compute_sharding: str = "fence", shards=None
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

    ``compute_sharding="halo"`` on a seq mesh (``parallel.make_train_mesh
    (..., seq=N)``): the row-sharded forward (:func:`_make_halo_eval_step`).

    ``mesh`` a :class:`~dexiraft_tpu_torch.parallel.layout.ServeMesh`:
    the data-parallel step, this step built once per entry over its
    replica on its device (:func:`_on_mesh`; ``device`` is then the
    mesh's), each output :class:`RowShards`. ``model`` is a RAFT, copied
    onto every entry here, or the replicas of
    ``parallel.layout.replicate``, which steps built over one mesh then
    share. ``iter_budget`` is one value for every block; the gated loop
    freezes each row on its own, so a block whose loop ends early gives
    the rows the whole batch would.

    ``mesh`` a seq mesh (``parallel.make_train_mesh(..., seq=N)``, with
    or without fsdp), ``compute_sharding="fence"``: the row-sharded
    forward of the model itself (:func:`_make_seq_eval_step`), JAX's
    fence eval step on ``P('data', 'seq')``.
    """
    if compute_sharding not in ("fence", "halo"):
        raise ValueError(f"compute_sharding must be fence|halo, "
                         f"got {compute_sharding!r}")
    if compute_sharding == "halo":
        if adaptive:
            raise ValueError(
                "adaptive=True is not supported with "
                "compute_sharding='halo' (the row-slab forward drives the "
                "fixed-iteration halo loop)")
        return _make_halo_eval_step(model, iters, device, tf32, mesh, shards)
    if shards is not None:
        raise ValueError("shards= belongs to compute_sharding='halo'")
    if has_seq(mesh):
        return _make_seq_eval_step(model, iters, device, tf32, adaptive,
                                   mesh)
    if mesh is not None:
        mesh = check_serve_mesh(mesh)
        return _on_mesh([make_eval_step(rep, iters, dev, tf32, adaptive)
                         for rep, dev in zip(_replicas(model, mesh),
                                             mesh.devices)], mesh)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    to_dev = _nchw(dev)
    # this step's compile keys (analysis.guards): a new step searches anew,
    # as a new jitted function compiles anew; cuDNN searches per thread
    token, per_thread = object(), dev.type == "cuda"

    def run(image1, image2, flow_init, edges1, edges2, **kw):
        guards.note_new_key("eval_step", (
            token, str(dev),
            _signature(image1, image2, flow_init, edges1, edges2),
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


def _seq_slab(x, axis, dim: int = 1):
    """This rank's block of image rows (``dim``) of a host array or
    tensor (None passes)."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return halo.slab(x, axis, dim)


def check_seq_fence(cfg: RAFTConfig) -> None:
    """Refuse what the fence steps do not run on row slabs: v4/v5, whose
    embedded DexiNed has no row rule yet (ROADMAP A12.2c)."""
    if cfg.embed_dexined:
        raise ValueError(SEQ_REFUSAL)


def _make_seq_eval_step(model: RAFT, iters: int, device, tf32: bool,
                        adaptive: bool, mesh: FsdpMesh):
    """The fence eval step on a seq mesh: step(image1, image2,
    flow_init=None[, iter_budget], *, edges1=None, edges2=None) ->
    (flow_low, flow_up[, iters_used, final_delta]).

    The inputs are this rank's rows of the batch (its data index's
    block) at full height, NHWC, H divisible by 8·n_seq (pad with
    ``data.padder.InputPadder(shape, seq=n_seq)``); flow_init and v2/v3's
    edges likewise. The step keeps its seq index's block of image rows
    of each and runs the one-device eval step's forward on it, the
    model's layers on row slabs (``models.layers.seq_mesh``). It returns
    this rank's slabs, as JAX's step leaves its outputs sharded
    ``P('data', 'seq')``: flow_low (B, H/8/n_seq, W/8, 2), flow_up (B,
    H/n_seq, W, 2). ``adaptive``: iters_used and final_delta are the same
    on every seq rank (the gate's per-item delta is reduced over seq).
    The model holds whole parameters (gather an fsdp state's with
    ``state.shards.gathered_params()``)."""
    check_seq_fence(model.cfg)
    inner = make_eval_step(model, iters, device, tf32, adaptive)
    seq = mesh.seq

    def step(image1, image2, flow_init=None, *budget, edges1=None,
             edges2=None):
        halo.check_geometry(np.shape(image1)[1], mesh.n_seq)
        with seq_mesh(model, mesh):
            return inner(_seq_slab(image1, seq), _seq_slab(image2, seq),
                         _seq_slab(flow_init, seq), *budget,
                         edges1=_seq_slab(edges1, seq),
                         edges2=_seq_slab(edges2, seq))

    return step


def make_encode_step(model: RAFT, device: Union[str, torch.device] = "cuda",
                     *, mesh: Optional[ServeMesh] = None
                     ) -> Callable[..., Features]:
    """encode(frame, edges=None) -> the frame's feature dict {fmap, ctx[,
    efmap, ectx]} (RAFT.encode_frame: NCHW device tensors at 1/8
    resolution).

    frame is a batched NHWC array or tensor in [0, 255]; edges is v2/v3's
    (B, H, W, 3) edge image. The streaming engine runs this once per new
    frame; composed with :func:`make_refine_step` it gives the eval step's
    flow. ``mesh`` (a serve mesh): every entry encodes its block of rows
    and each feature is :class:`RowShards` (``model`` as in
    :func:`make_eval_step`).
    """
    if mesh is not None:
        mesh = check_serve_mesh(mesh)
        return _on_mesh([make_encode_step(rep, dev) for rep, dev in
                         zip(_replicas(model, mesh), mesh.devices)], mesh)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    to_dev = _nchw(dev)
    token, per_thread = object(), dev.type == "cuda"

    @torch.inference_mode()
    def encode(frame, edges=None) -> Features:
        guards.note_new_key("encode", (token, str(dev),
                                       _signature(frame, edges), EVAL_TF32,
                                       model.cfg.mixed_precision),
                            per_thread)
        with eval_arithmetic(EVAL_TF32):
            return model.encode_frame(to_dev(frame), to_dev(edges))

    return encode


def make_refine_step(model: RAFT, iters: int = 24,
                     device: Union[str, torch.device] = "cuda",
                     adaptive: bool = False, *,
                     mesh: Optional[ServeMesh] = None
                     ) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """refine(features1, features2, flow_init[, iter_budget]) ->
    (flow_low, flow_up), NHWC device tensors.

    features1 is the earlier frame's dict (its ctx seeds the GRU).
    flow_init, (B, H/8, W/8, 2), is always materialized: zeros are a cold
    start (None is taken as zeros). ``adaptive=True``: a trailing
    ``iter_budget`` and (flow_low, flow_up, iters_used, final_delta), as
    :func:`make_eval_step`. ``mesh`` (a serve mesh): the feature dicts are
    the mesh encode step's (:class:`RowShards`), flow_init a host batch or
    RowShards, and the outputs RowShards.
    """
    if mesh is not None:
        mesh = check_serve_mesh(mesh)
        return _on_mesh([make_refine_step(rep, iters, dev, adaptive)
                         for rep, dev in zip(_replicas(model, mesh),
                                             mesh.devices)], mesh)
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
            token, str(dev),
            _signature(*(features1[k] for k in sorted(features1))),
            _signature(fi), EVAL_TF32, iters, adaptive,
            model.cfg.mixed_precision), per_thread)
        with eval_arithmetic(EVAL_TF32):
            out = model.refine(features1, features2, iters, fi, **kw)
        return _nhwc(*out[:2]) + tuple(out[2:])

    return refine


# ---- the test-mode steps on a serve mesh -----------------------------------


def _replicas(model, mesh: ServeMesh) -> Tuple[RAFT, ...]:
    """A mesh step's replicas: ``model`` copied onto every entry
    (``parallel.layout.replicate``), or the replicas ``replicate`` made
    already (a sequence, one per entry on its device), which steps built
    over one mesh then share."""
    if isinstance(model, RAFT):
        return replicate(model, mesh)
    reps = tuple(model)
    devs = [next(r.parameters()).device for r in reps]
    if len(reps) != mesh.size or any(
            d != torch.device(e) for d, e in zip(devs, mesh.devices)):
        raise ValueError(f"{len(reps)} replicas on {[str(d) for d in devs]} "
                         f"do not match the mesh's entries "
                         f"{[str(d) for d in mesh.devices]}")
    return tuple(r.eval() for r in reps)


def _on(dev: torch.device):
    """``dev`` as the current CUDA device (a no-op for the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _rows_of(x) -> int:
    """The batch size of a step's first argument (an input batch, its
    RowShards, or the encode step's feature dict)."""
    if isinstance(x, dict):
        x = x["fmap"]
    return len(x) if isinstance(x, RowShards) else int(np.shape(x)[0])


def _block(x, i: int, rows):
    """Entry ``i``'s block ``rows`` of a step argument: a
    :class:`RowShards`' own shard (put there by
    ``parallel.layout.shard_batch``, cut as this batch is), the rows of a
    host array or tensor, or those of each value of a feature dict; None
    and scalars (``iter_budget``) pass."""
    if isinstance(x, dict):
        return {k: _block(v, i, rows) for k, v in x.items()}
    if isinstance(x, RowShards):
        if x.rows[i] != rows:
            raise ValueError(f"input rows {x.rows} are not the mesh's "
                             "blocks of this batch")
        return x.shards[i]
    if x is None or np.ndim(x) == 0:
        return x
    return x[rows[0]:rows[1]]


def _on_mesh(steps, mesh: ServeMesh):
    """One step over ``mesh`` from the one-device steps ``steps`` (entry
    i's, over its replica on its device; JAX's steps with ``mesh=``).

    A call cuts the batch's rows into one block per entry (a batch the
    mesh size does not divide raises) and calls each entry's step on its
    block, on its device, in entry order: launches return at once, so
    the shards overlap on the devices. Each output comes back as
    :class:`RowShards` in row order (the encode step's dict, one per
    feature). The one-device steps keep their compile keys with their
    device (``guards.note_new_key``): cuDNN's searches are per device
    and thread."""

    def call(*args, **kwargs):
        rows = row_blocks(_rows_of(args[0]), mesh.size)
        outs = []
        for i, (step, dev, r) in enumerate(zip(steps, mesh.devices, rows)):
            a = [_block(x, i, r) for x in args]
            kw = {k: _block(v, i, r) for k, v in kwargs.items()}
            with _on(dev):
                outs.append(step(*a, **kw))
        if isinstance(outs[0], dict):
            return {k: RowShards([o[k] for o in outs], rows)
                    for k in outs[0]}
        return tuple(RowShards(list(o), rows) for o in zip(*outs))

    return call


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

    ``mesh`` a seq mesh (``parallel.make_train_mesh(..., seq=N)``, an
    ``FsdpMesh`` whose fsdp axis may be one rank; the state in its
    storage layout): JAX's fence step on ``P('data', 'seq')``. ``batch``
    holds this rank's rows of the data axis at full height (H divisible
    by 8·n_seq, at least 3 rows of 1/8 resolution a rank); the step draws
    the noise of the global batch at full height, keeps its seq index's
    block of image rows of every array, and runs the model's own forward
    on that slab (``models.layers.seq_mesh``: halo convs, seq-merged
    norms, BatchNorm statistics over (data, seq), the row-block pyramid,
    B1 on a query block). Each rank's loss is its slab's mean and every
    slab is the same size, so the global loss is the mean of the ranks'
    losses over (data, seq) and its gradient the mean of their
    gradients: the gradients are averaged over the (data, seq) group,
    the metric sums summed over it (slabs hold different valid counts),
    and the fsdp fences work as on a (data, fsdp) mesh. v4/v5 are
    refused (ROADMAP A12.2c).

    ``compute_sharding="halo"`` on a mesh with a seq axis
    (``parallel.make_train_mesh(..., seq=N)``): image rows shard over
    the seq ranks and the parameters stay in their fsdp storage layout
    through compute (parallel/halo.py; :func:`_make_halo_train_step`).
    """
    if tc.precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be fp32|bf16, got {tc.precision!r}")
    if tc.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
    if compute_sharding not in ("fence", "halo"):
        raise ValueError(f"compute_sharding must be fence|halo, "
                         f"got {compute_sharding!r}")
    cfg = train_model_config(cfg, tc)
    if compute_sharding == "halo":
        return _make_halo_train_step(cfg, tc, mesh)
    seq = mesh.seq if has_seq(mesh) else None
    if seq is not None:
        check_seq_fence(cfg)
    if not (mesh is None or isinstance(mesh, FsdpMesh)
            or isinstance(mesh, World) and mesh.grouped):
        raise ValueError(f"mesh={mesh!r} is no mesh the port trains over "
                         "(ROADMAP A12): a process group's data axis, an "
                         "fsdp axis and a seq axis, as parallel."
                         "make_train_mesh's World or FsdpMesh")
    fsdp = isinstance(mesh, FsdpMesh)
    data = data_axis(mesh)
    n_data = 1 if data is None else data.size
    # the ranks whose losses and gradients make the global step's: the
    # data axis, or on row slabs every (data, seq) rank of one fsdp index
    reduce_axis = data if seq is None else mesh.data_seq
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
        if seq is not None:
            halo.check_geometry(b["image1"].shape[2], mesh.n_seq)
        rows = local_rows(n * n_data, accum, data)
        set_data_mesh(model, data, n // accum)
        if fsdp:
            # the entry fence: the full parameters, for this step only
            state.shards.gather_()
        with train_arithmetic(TRAIN_TF32), (
                contextlib.nullcontext() if seq is None
                else seq_mesh(model, mesh)):
            if tc.add_noise:
                stdv = torch.rand((), device=dev, generator=gen) * 5.0
                b["image1"] = _add_noise(b["image1"], stdv, gen, rows,
                                         n * n_data)
                b["image2"] = _add_noise(b["image2"], stdv, gen, rows,
                                         n * n_data)
            if seq is not None:  # this rank's image rows of every array
                b = {k: None if v is None else halo.slab(
                    v, seq, dim=1 if k == "valid" else 2)
                    for k, v in b.items()}
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
            if reduce_axis is not None:
                _all_reduce_grads_(model, reduce_axis.size,
                                   reduce_axis.group)
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
                if reduce_axis is not None:
                    vec = torch.cat([losses, seq_sums.reshape(-1)])
                    dist.all_reduce(vec, group=reduce_axis.group)
                    losses = vec[:accum] / reduce_axis.size
                    seq_sums = vec[accum:].reshape(accum, -1)
                # each rank checked only its own slices
                bad = (~finite).to(torch.float32).reshape(1)
                dist.all_reduce(bad, group=mesh.world.group)
                finite = bad[0] == 0
            elif mesh is not None:
                # one all-reduce: the ranks' losses, metric sums and
                # non-finite verdicts
                vec = torch.cat([losses, seq_sums.reshape(-1),
                                 (~finite).to(torch.float32).reshape(1)])
                dist.all_reduce(vec, group=mesh.group)
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


def _halo_slab(b: Batch, dev: torch.device, axis) -> Dict[str, torch.Tensor]:
    """The batch's arrays as NCHW fp32 device tensors (valid (B, H, W)),
    each cut to this rank's block of rows (``axis``: the seq axis)."""
    to_dev = _nchw(dev)
    out = {}
    for key, x in b.items():
        if x is None:
            continue
        if key == "valid":
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            out[key] = halo.slab(x.to(dev, torch.float32, non_blocking=True),
                                 axis, dim=1)
        else:
            out[key] = halo.slab(to_dev(x), axis)
    return out


def _halo_sync_grads_(plan, mesh: FsdpMesh) -> torch.Tensor:
    """After the halo backward: every storage tensor's gradient summed
    over (data, seq) in one all-reduce (a sharded leaf's is already its
    slice, summed over fsdp and divided by n_fsdp); returns the clip's
    global norm, taken over the full gradient (the sharded slices'
    squares summed over fsdp, the replicated leaves' once)."""
    grads = []
    for leaf in plan.leaves:
        if leaf.storage.grad is None:
            leaf.storage.grad = torch.zeros_like(leaf.storage)
        grads.append(leaf.storage.grad)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_seq.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    sq = [g.square().sum() for leaf, g in zip(plan.leaves, grads)
          if leaf.dim is not None]
    sharded = (torch.stack(sq).sum() if sq
               else flat.new_zeros(())).reshape(1)
    if mesh.n_fsdp > 1:
        dist.all_reduce(sharded, group=mesh.fsdp_group)
    whole = [g.square().sum() for leaf, g in zip(plan.leaves, grads)
             if leaf.dim is None]
    return (sharded[0] + torch.stack(whole).sum()).sqrt()


def make_halo_grad_fn(cfg: RAFTConfig, tc: TrainConfig, mesh):
    """The halo step's gradient function (JAX's ``make_halo_train_fn``):
    grad(state, batch) -> (loss, metric sums, clip norm), leaving the
    gradient of every tensor the optimizer updates in its ``.grad``.

    ``mesh``: a seq mesh (``parallel.make_train_mesh(..., seq=N)``);
    ``state``: put in its storage layout by ``parallel.fsdp.shard_state``
    (an fsdp axis of one rank shards nothing). ``batch`` holds this
    rank's rows of the global batch (its data index's block, as on the
    fence step) at full height; the step keeps its seq index's block of
    image rows. The forward and backward run on that slab
    (``parallel.halo.halo_forward``), each block gathering its sharded
    parameters just in time; the loss the backward starts from is this
    rank's contribution to the global loss (its rows' sums over the
    global element count), so its gradient is this rank's share. The
    shares are summed over (data, seq) (a sharded leaf's, a slice, was
    summed over fsdp and divided by n_fsdp in the gather's backward);
    the clip norm is the full gradient's. ``loss`` and the metric sums
    are the global batch's, reduced over (data, seq). BatchNorm stays
    frozen (or absent). The convolutions take cuDNN's untimed mode-B
    pick (``train_arithmetic``), so ranks that share a card pick the
    same algorithms."""
    cfg = train_model_config(cfg, tc)
    halo.check_halo_support(cfg, tc, mesh)
    seq = mesh.seq
    token = object()

    def grad(state: TrainState, batch: Batch):
        model, plan = state.model, state.shards
        if plan is None or plan.mesh.n_fsdp != mesh.n_fsdp:
            raise ValueError(
                "the halo step takes a state in its storage layout on this "
                "mesh (parallel.fsdp.shard_state(state, mesh))")
        if model.cfg != cfg:
            raise ValueError("the state's model was built from another "
                             "RAFTConfig than this step's (build it from "
                             "train_model_config(cfg, tc))")
        dev = state.device
        h = np.shape(batch["image1"])[1]
        halo.check_geometry(h, mesh.n_seq)
        guards.note_new_key("train_step", (
            token, tuple((k, _signature(v)) for k, v in sorted(batch.items())
                         if v is not None),
            TRAIN_TF32, tc.precision, tc.remat, tc.iters, "halo"),
            dev.type == "cuda")
        b = _halo_slab(batch, dev, seq)
        n = b["image1"].shape[0]
        count = n * mesh.n_data * h * b["image1"].shape[3] * 2
        for leaf in plan.sharded:  # the slices are the gradient's leaves
            leaf.storage.requires_grad_(True)
        state.optimizer.zero_grad(set_to_none=True)
        with train_arithmetic(TRAIN_TF32), torch.enable_grad():
            preds = halo.halo_forward(model, plan, b["image1"], b["image2"],
                                      seq, tc.iters, emit=True)
            loss, sums = sequence_loss_sums(preds, b["flow"], b["valid"],
                                            tc.gamma)
            # this rank's contribution: its rows' sums over the global
            # element count; summed over (data, seq) it is the loss
            local = loss * (preds[0].numel() / count)
            local.backward()
        norm = _halo_sync_grads_(plan, mesh)
        vec = torch.cat([local.detach().reshape(1), sums.detach()])
        dist.all_reduce(vec, group=mesh.data_seq.group)
        return vec[0], vec[1:], norm

    return grad


def _make_halo_train_step(cfg: RAFTConfig, tc: TrainConfig, mesh):
    """The compute_sharding="halo" train step (JAX's
    ``_make_halo_train_step``): :func:`make_halo_grad_fn`, then AdamW
    over this rank's slices and the replicated parameters at the full
    gradient's clip norm, outside it; the model's full-size sharded
    parameters are never materialized. state_finite reduces over every
    rank (each checks only its own slices)."""
    grad = make_halo_grad_fn(cfg, tc, mesh)

    def step(state: TrainState, batch: Batch):
        opt = state.optimizer
        loss, sums, norm = grad(state, batch)
        with train_arithmetic(TRAIN_TF32):
            lr = opt.current_lr()
            opt.step(grad_norm=norm)
            for leaf in state.shards.leaves:
                leaf.storage.grad = None
            state.step += 1
            bad = (~all_finite(_state_tensors(state))).to(
                torch.float32).reshape(1)
            dist.all_reduce(bad, group=mesh.world.group)
            out = metrics_from_sums(sums)
            out["loss"] = loss
            out["lr"] = lr
            out["state_finite"] = bad[0] == 0
        return state, out

    return step


def _make_halo_eval_step(model: RAFT, iters: int, device, tf32: bool, mesh,
                         shards) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """The compute_sharding="halo" eval step (JAX's
    ``_make_halo_eval_step``): step(image1, image2, flow_init=None) ->
    (flow_low, flow_up), NHWC device tensors.

    Inputs are this rank's rows of the batch (its data index's block) at
    full height, NHWC in [0, 255], H divisible by 8·n_seq (pad with
    ``data.padder.InputPadder(shape, seq=n_seq)``); flow_init None or (B,
    H/8, W/8, 2). The step runs the test-mode forward on this rank's
    block of rows (``parallel.halo.halo_forward``) and returns the whole
    height, gathered over the seq group. ``shards``: the train state's
    fsdp storage (``state.shards``), whose sharded parameters each block
    gathers just in time; None reads the model's own parameters. v1
    only (``check_halo_support``'s matrix, its train-only knobs aside);
    no edge arguments. The eval step's arithmetic (``eval_arithmetic``)."""
    from dexiraft_tpu_torch.parallel.context import gather_rows

    if not has_seq(mesh):
        raise ValueError(
            "compute_sharding='halo' needs a mesh with a 'seq' axis — "
            "build one with parallel.make_train_mesh(batch_size, world, "
            "fsdp=n_fsdp, seq=n_seq)")
    shell = TrainConfig(batch_size=mesh.n_data,
                        image_size=(8 * mesh.n_seq * 3, 64), freeze_bn=True)
    halo.check_halo_support(model.cfg, shell, mesh)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    seq = mesh.seq
    token, per_thread = object(), dev.type == "cuda"

    @torch.inference_mode()
    def step(image1, image2, flow_init=None):
        halo.check_geometry(np.shape(image1)[1], mesh.n_seq)
        guards.note_new_key("eval_step", (
            token, _signature(image1, image2, flow_init), tf32, iters,
            "halo"), per_thread)
        b = _halo_slab({"image1": image1, "image2": image2,
                        "flow_init": flow_init}, dev, seq)
        with eval_arithmetic(tf32):
            low, up = halo.halo_forward(model, shards, b["image1"],
                                        b["image2"], seq, iters, emit=False,
                                        flow_init=b.get("flow_init"))
            low, up = (gather_rows(t.contiguous(), seq, dim=2)
                       for t in (low, up))
        return _nhwc(low, up)

    return step

