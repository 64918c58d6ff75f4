"""The test-mode steps the inference engines drive.

Counterpart of ``make_eval_step``, ``make_encode_step`` and
``make_refine_step`` in ``dexiraft_tpu/train/step.py`` (the training step
is not ported yet). PyTorch runs eagerly, so there is nothing to compile:
a step moves host arrays to the device, runs the model under
``torch.inference_mode()`` and returns device tensors.

Each step states its own arithmetic rather than inheriting PyTorch's
global flags: cuDNN's TF32 convolutions follow ``tf32`` (``EVAL_TF32``
unless the caller says otherwise), matmuls run in full fp32, and cuDNN
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

from dexiraft_tpu_torch.device import resolve_device
from dexiraft_tpu_torch.models.raft import RAFT

# The eval step's convolutions: fp32 (TF32 off). On an H100 at 440x1024,
# 32 iterations, seeded weights, TF32 convolutions moved v5's flow_low
# 9.7e-3 to 1.02e-2 px from the fp32 plain-lookup path from one run to the
# next, across the 1e-2 px parity guard (v1: 5.1e-3; PERF.md). Re-measured
# by chip_smoke.py's "tf32" phase.
EVAL_TF32 = False

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
