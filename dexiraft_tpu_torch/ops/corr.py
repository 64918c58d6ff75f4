"""Correlation building blocks shared by the lookup paths.

Counterpart of ``dexiraft_tpu/ops/corr.py`` (the parts the on-demand
lookup uses): the all-pairs correlation of two feature maps, VALID 2x2
average pooling, and the bilinear window around a real-valued center.

The window channel order is the reference's transposed one: the x offset
varies on the SLOW axis (``index = ix * (2r+1) + iy``). A window in the
"natural" order has the same shape and gives wrong flow with every
converted checkpoint, so the tests pin the order explicitly.
"""

from __future__ import annotations

from typing import Optional

import torch


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """<fmap1[b,i,j,:], fmap2[b,k,l,:]> / sqrt(D) for (B, H, W, D) maps.

    Returns (B*H*W, H2, W2, 1) float32, the JAX package's flattened layout.
    """
    b, h, w, d = fmap1.shape
    h2, w2 = fmap2.shape[1:3]
    f1 = fmap1.reshape(b, h * w, d).to(torch.float32)
    f2 = fmap2.reshape(b, h2 * w2, d).to(torch.float32)
    corr = torch.bmm(f1, f2.transpose(1, 2)) / (float(d) ** 0.5)
    return corr.reshape(b * h * w, h2, w2, 1)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over the spatial dims of (N, H, W, C);
    VALID, so an odd trailing row or column is dropped."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : 2 * h2, : 2 * w2, :]
    return x.reshape(n, h2, 2, w2, 2, c).mean(dim=(2, 4))


def _window_delta(radius: int, dtype=torch.float32) -> torch.Tensor:
    """(2r+1, 2r+1, 2) offset lattice, channels (x-offset, y-offset), with
    the x offset varying along window axis 0 (the reference's order)."""
    d = torch.arange(-radius, radius + 1, dtype=dtype)
    di, dj = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([di, dj], dim=-1)


def _axis_interp_matrix(center: torch.Tensor, radius: int, size: int,
                        offset=0) -> torch.Tensor:
    """Per-pixel 1-D bilinear selection matrix A (N, 2r+1, size),
    A[n, j, p] = relu(1 - |offset + p - (c_n + j - r)|); taps outside the
    axis have empty support, which is the zero padding of the sampler."""
    t = center[:, None] + torch.arange(-radius, radius + 1, dtype=torch.float32,
                                       device=center.device)
    pos = offset + torch.arange(size, dtype=torch.float32,
                                device=center.device)[None, None, :]
    return torch.clamp(1.0 - (pos - t[..., None]).abs(), min=0.0)


def interp_window(vol: torch.Tensor, centers: torch.Tensor, radius: int,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear (2r+1)^2 window of each slab of vol (N, Hl, Wl) around its
    center (N, 2) in level pixels -> (N, (2r+1)^2), x offset slow."""
    win = 2 * radius + 1
    hl, wl = vol.shape[1], vol.shape[2]
    ax = _axis_interp_matrix(centers[:, 0], radius, wl)  # (N, win, Wl)
    ay = _axis_interp_matrix(centers[:, 1], radius, hl)  # (N, win, Hl)
    rows = torch.bmm(ay, vol.to(torch.float32))          # (N, win_y, Wl)
    window = torch.bmm(ax, rows.transpose(1, 2))         # (N, win_x, win_y)
    if scale is not None:
        window = window * scale
    return window.reshape(vol.shape[0], win * win)
