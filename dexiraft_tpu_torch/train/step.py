"""The train step and the test-mode steps the inference engines drive.

Counterpart of ``make_train_step``, ``make_eval_step``, ``make_encode_step``
and ``make_refine_step`` in ``dexiraft_tpu/train/step.py``, on one device;
the train step also runs data-parallel over ranks (its ``mesh=``).
PyTorch runs eagerly, so there is nothing to compile: a test-mode step
moves host arrays to the device, runs the model under
``torch.inference_mode()`` and returns device tensors; the train step runs
forward, sequence loss, backward and the optimizer update in place on a
:class:`~dexiraft_tpu_torch.train.state.TrainState`.

Each step states its own arithmetic rather than inheriting PyTorch's
global flags: cuDNN's TF32 convolutions follow ``tf32`` (``EVAL_TF32``
unless the caller says otherwise; the train step's are fp32,
``TRAIN_TF32``), matmuls run in full fp32, and cuDNN
picks each convolution's algorithm by timing its deterministic candidates
at the first call of a shape (``benchmark``, ``deterministic``), while
any call runs, on any thread; the global flags are restored when the
last one returns (``eval_arithmetic``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from dexiraft_tpu_torch.config import RAFTConfig, TrainConfig
from dexiraft_tpu_torch.device import resolve_device
from dexiraft_tpu_torch.models.layers import set_data_mesh
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.ops.losses import (METRIC_KEYS, metrics_from_sums,
                                           sequence_loss_sums)
from dexiraft_tpu_torch.parallel.distributed import World
from dexiraft_tpu_torch.parallel.layout import local_rows
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
    """Who is inside :func:`eval_arithmetic`, process-wide.

    The flags it sets are process-global, and forwards run on several
    threads at once (the scheduler's dispatcher and the streaming
    handlers of serve/server.py). So the flags are set when the first
    forward enters (depth 0 -> 1) and restored when the last one leaves
    (1 -> 0); a forward that asks for another TF32 setting waits until
    the forwards of the current setting have left. The mutex guards this
    bookkeeping only; forwards of one setting run concurrently."""

    def __init__(self):
        self.cv = threading.Condition(threading.Lock())
        self.depth = 0
        self.tf32: Optional[bool] = None
        self.saved = None

    def enter(self, tf32: bool) -> None:
        with self.cv:
            while self.depth and self.tf32 != tf32:
                self.cv.wait()
            if not self.depth:
                matmul = torch.backends.cuda.matmul
                cudnn = torch.backends.cudnn
                self.saved = (matmul.allow_tf32, cudnn.set_flags(
                    _enabled=cudnn.enabled, _benchmark=True,
                    _deterministic=True, _allow_tf32=tf32))
                matmul.allow_tf32 = False
                self.tf32 = tf32
            self.depth += 1

    def leave(self) -> None:
        with self.cv:
            self.depth -= 1
            if not self.depth:
                matmul_tf32, cudnn_flags = self.saved
                torch.backends.cudnn.set_flags(*cudnn_flags)
                torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
                self.tf32 = self.saved = None
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

    def run(image1, image2, flow_init, edges1, edges2, **kw):
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

    @torch.inference_mode()
    def encode(frame, edges=None) -> Features:
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
    yield from state.model.parameters()
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


def _all_reduce_grads_(model: RAFT, size: int) -> None:
    """Average the gradients over the ``size`` ranks: one all-reduce of
    one flat buffer."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
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
    (fsdp, seq) and ``compute_sharding="halo"`` (A12).
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
            mesh is None or isinstance(mesh, World) and mesh.grouped):
        raise ValueError("fsdp/seq meshes and compute_sharding='halo' are "
                         "not ported to PyTorch yet (ROADMAP A12); the port "
                         "trains data-parallel over a process group "
                         "(parallel.make_train_mesh's World)")
    if tc.edge_sum_fusion and (cfg.variant != "raft" or cfg.embed_dexined):
        raise ValueError(
            "edge_sum_fusion is the v1 (plain 'raft') training fusion — "
            "the model itself consumes edges in the other variants")

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
        if model.cfg != cfg:
            raise ValueError("the state's model was built from another "
                             "RAFTConfig than this step's (build it from "
                             "train_model_config(cfg, tc))")
        dev = state.device
        to_dev = _nchw(dev)
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
        ranks = 1 if mesh is None else mesh.size
        rows = local_rows(n * ranks, accum, mesh)
        set_data_mesh(model, mesh, n // accum)
        with eval_arithmetic(TRAIN_TF32):
            if tc.add_noise:
                stdv = torch.rand((), device=dev, generator=gen) * 5.0
                b["image1"] = _add_noise(b["image1"], stdv, gen, rows,
                                         n * ranks)
                b["image2"] = _add_noise(b["image2"], stdv, gen, rows,
                                         n * ranks)
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
            if mesh is not None:
                _all_reduce_grads_(model, mesh.size)
            lr = opt.current_lr()
            opt.step()
            state.step += 1
            finite = all_finite(_state_tensors(state))
            losses, seq_sums = torch.stack(losses), torch.stack(seq_sums)
            if mesh is not None:
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
