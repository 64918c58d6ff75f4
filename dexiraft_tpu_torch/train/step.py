"""The test-mode forward step the inference engine drives.

Counterpart of ``make_eval_step`` in ``dexiraft_tpu/train/step.py`` (the
training step is not ported yet). PyTorch runs eagerly, so there is
nothing to compile: the step moves a host batch to the device, runs the
model under ``torch.inference_mode()`` and returns device tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from dexiraft_tpu_torch.device import resolve_device
from dexiraft_tpu_torch.models.raft import RAFT


def make_eval_step(model: RAFT, iters: int = 24,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """step(image1, image2, flow_init=None) -> (flow_low, flow_up).

    Inputs are batched NHWC arrays in [0, 255] (the engine's host
    layout); flow_init is None or (B, H/8, W/8, 2). Outputs are NHWC
    device tensors: flow_low (B, H/8, W/8, 2), flow_up (B, H, W, 2).
    A flow_init row of zeros is the same as no warm start.
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
        low, up = model(to_nchw(image1), to_nchw(image2), iters=iters,
                        flow_init=fi, test_mode=True)
        return low.permute(0, 2, 3, 1), up.permute(0, 2, 3, 1)

    return step
