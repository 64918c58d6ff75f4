"""Convex-combination flow upsampling (the learned 8x upsampler).

Counterpart of ``dexiraft_tpu/ops/upsample.py``. The mask's 576 channels
are viewed as (9, 8, 8): a softmax over the 9 taps of each coarse pixel's
3x3 neighbourhood, for each of the 8x8 fine sub-pixels. Taps are in
F.unfold's row-major (dy, dx) order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_flow_convex_nchw(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow (N, 2, H, W), mask (N, 576, H, W) -> (N, 2, 8H, 8W)."""
    n, _, h, w = flow.shape
    m = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    taps = F.unfold(8.0 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(m * taps, dim=2)              # (N, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The JAX package's NHWC signature: flow (B, H, W, 2), mask
    (B, H, W, 576) -> (B, 8H, 8W, 2)."""
    up = upsample_flow_convex_nchw(flow.permute(0, 3, 1, 2),
                                   mask.permute(0, 3, 1, 2).contiguous())
    return up.permute(0, 2, 3, 1)
