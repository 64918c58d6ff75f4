"""The test-mode forward step the inference engine drives.

Counterpart of ``make_eval_step`` in ``dexiraft_tpu/train/step.py`` (the
training step is not ported yet). PyTorch runs eagerly, so there is
nothing to compile: the step moves a host batch to the device, runs the
model under ``torch.inference_mode()`` and returns device tensors.

The step states its own arithmetic rather than inheriting PyTorch's global
flags: cuDNN's TF32 convolutions follow ``tf32`` (``EVAL_TF32`` unless the
caller says otherwise) and matmuls run in full fp32, for the duration of
each call; both global flags are restored when it returns.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

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


def make_eval_step(model: RAFT, iters: int = 24,
                   device: Union[str, torch.device] = "cuda",
                   tf32: bool = EVAL_TF32
                   ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """step(image1, image2, flow_init=None) -> (flow_low, flow_up).

    Inputs are batched NHWC arrays in [0, 255] (the engine's host
    layout); flow_init is None or (B, H/8, W/8, 2). Outputs are NHWC
    device tensors: flow_low (B, H/8, W/8, 2), flow_up (B, H, W, 2).
    A flow_init row of zeros is the same as no warm start. ``tf32``
    turns cuDNN's TF32 convolutions on for the step's calls.
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def to_nchw(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return t.to(dev, non_blocking=True).permute(0, 3, 1, 2)

    @torch.inference_mode()
    def step(image1: np.ndarray, image2: np.ndarray,
             flow_init: Optional[np.ndarray] = None):
        fi = None if flow_init is None else to_nchw(flow_init)
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        matmul_tf32 = matmul.allow_tf32
        try:
            matmul.allow_tf32 = False
            with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                             benchmark_limit=cudnn.benchmark_limit,
                             deterministic=cudnn.deterministic,
                             allow_tf32=tf32):
                low, up = model(to_nchw(image1), to_nchw(image2),
                                iters=iters, flow_init=fi, test_mode=True)
        finally:
            matmul.allow_tf32 = matmul_tf32
        return low.permute(0, 2, 3, 1), up.permute(0, 2, 3, 1)

    return step
