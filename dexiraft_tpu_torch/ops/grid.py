"""Coordinate grids and bilinear resizing.

Counterpart of ``dexiraft_tpu/ops/grid.py``. The public functions keep the
JAX package's NHWC layout, so the tests compare like with like; the model
converts at its boundary.
"""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """Pixel-center coordinate grid, shape (batch, ht, wd, 2), channels (x, y)."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                          torch.arange(wd, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)[None].expand(batch, ht, wd, 2)


def _resize_matrix(n_in: int, n_out: int, device, dtype) -> torch.Tensor:
    """1-D align_corners interpolation matrix (n_out, n_in): the hat kernel
    relu(1 - |p - t|) at t = o * (n_in - 1) / (n_out - 1)."""
    if n_out > 1:
        t = torch.linspace(0.0, n_in - 1.0, n_out, dtype=torch.float32,
                           device=device)
    else:
        t = torch.zeros(1, dtype=torch.float32, device=device)
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    return torch.clamp(1.0 - (pos[None, :] - t[:, None]).abs(), min=0.0).to(dtype)


def resize_bilinear_align_corners(img: torch.Tensor, ht: int,
                                  wd: int) -> torch.Tensor:
    """Bilinear resize of (N, H, W, C) with align_corners=True semantics,
    as two products against static interpolation matrices."""
    h, w = img.shape[1], img.shape[2]
    ry = _resize_matrix(h, ht, img.device, img.dtype)  # (ht, h)
    rx = _resize_matrix(w, wd, img.device, img.dtype)  # (wd, w)
    out = torch.einsum("oy,nyxc->noxc", ry, img)
    return torch.einsum("px,noxc->nopc", rx, out)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsample of a (N, H, W, 2) flow field, vectors scaled by 8."""
    h, w = flow.shape[1], flow.shape[2]
    return 8.0 * resize_bilinear_align_corners(flow, 8 * h, 8 * w)
