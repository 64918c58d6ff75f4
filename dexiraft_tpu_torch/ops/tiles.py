"""The f2 boxes that the patch-tile kernels stage, computed from the coords.

B1/B2 (``csrc/flash_corr.cu``) and B3/B4 (``csrc/pallas_corr.cu``) take a tile
of query pixels per block and, at each pyramid level, stage one box of
fmap2 that covers the lattices of the tile's live pixels. A pixel is live
when its effective lattice (the rows and columns its bilinear blend weighs
nonzero) meets the frame; far, NaN and tail pixels are not, and a tile
with no live pixel stages nothing. ``tile_boxes`` gives each tile's box
as the kernels take it; ``flash_staging`` and ``tma_staging`` turn B1/B2's
and B3/B4's boxes into the positions their copies stage and the tiles that
go per pixel. Used by ``chip_smoke.py`` to report the branches a field
takes, and tested on the CPU against a box taken pixel by pixel.
"""

from __future__ import annotations

from typing import Tuple

import torch

# B3/B4's TMA boxes (csrc/pallas_corr.cu): 16, 24 or 32 columns, 2 rows
TMA_BOX_WIDTHS = (16, 24, 32)
TMA_BOX_ROWS = 2


def _lattice_axis(t: torch.Tensor, size: int, radius: int, whole: bool):
    """First and end (exclusive) lattice index along one axis, and whether
    the effective lattice meets [0, size). ``t`` holds level-pixel centers."""
    k1 = 2 * radius + 2
    t = torch.nan_to_num(t, nan=-(radius + 1.0))
    t = torch.clamp(t, -(radius + 1.0), size + float(radius))
    fl = torch.floor(t)
    g0 = fl - radius
    end = g0 + k1 - (t == fl).float()  # the last one only at a fraction
    live = (end > 0) & (g0 < size) & (size > 0)
    if whole:
        return g0, g0 + k1, live
    return g0.clamp(min=0), end.clamp(max=size), live


def tile_boxes(co: torch.Tensor, shape: Tuple[int, int], scale: float,
               radius: int, tile: Tuple[int, int] = (4, 8),
               whole: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(columns, rows) of the box of every tile of ``tile`` = (rows, cols)
    query pixels that has a live pixel, at one level of ``shape`` = (h2,
    w2), for level-0 coords ``co`` (B, H, W, 2) scaled by ``scale``; tiles
    in (batch, tile row, tile column) order, as 1-D int64 tensors.

    ``whole=False`` is B1's box: the effective lattices, intersected with
    the frame. ``whole=True`` is B3/B4's: the whole (2r+2)^2 lattices, not
    clipped (TMA stages what lies outside the frame as zeros)."""
    h2, w2 = shape
    th, tw = tile
    b, h, w, _ = co.shape
    lx, hx, livex = _lattice_axis(co[..., 0] * scale, w2, radius, whole)
    ly, hy, livey = _lattice_axis(co[..., 1] * scale, h2, radius, whole)
    live = livex & livey
    pad = (0, -w % tw, 0, -h % th)
    big = float(1 << 30)

    def tiles(t, fill):
        t = torch.nn.functional.pad(torch.where(live, t, fill), pad,
                                    value=fill)
        return t.reshape(b, t.shape[1] // th, th, t.shape[2] // tw, tw)

    def lo(t):
        return tiles(t, big).amin(dim=(2, 4))

    def hi(t):
        return tiles(t, -big).amax(dim=(2, 4))

    any_live = tiles(live.float(), 0.0).amax(dim=(2, 4)) > 0
    cols = (hi(hx) - lo(lx))[any_live]
    rows = (hi(hy) - lo(ly))[any_live]
    return cols.long().flatten(), rows.long().flatten()


def flash_staging(cols: torch.Tensor, rows: torch.Tensor,
                  limit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For B1/B2 boxes (``tile_boxes(..., whole=False)``): the positions
    each tile stages (its columns rounded up to an odd row stride, times
    its rows), and whether it takes the per-pixel branch instead (more
    positions than ``limit``, the stage's capacity)."""
    staged = (cols | 1) * rows
    return staged, staged > limit


def tma_staging(cols: torch.Tensor, rows: torch.Tensor,
                limit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For B3/B4 boxes (``tile_boxes(..., whole=True)``): the positions each
    tile stages (the narrowest TMA box width that spans its columns times
    its rows rounded up to the box height), and whether it takes the
    per-pixel branch instead (wider than the widest box, or more positions
    than ``limit``, the stage's capacity)."""
    width = torch.full_like(cols, -1)
    for bw in reversed(TMA_BOX_WIDTHS):
        width = torch.where(cols <= bw, torch.full_like(cols, bw), width)
    staged = width * ((rows + TMA_BOX_ROWS - 1) // TMA_BOX_ROWS * TMA_BOX_ROWS)
    per_pixel = (width < 0) | (staged > limit)
    return staged.clamp(min=0), per_pixel
