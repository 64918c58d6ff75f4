"""Warm-start flow propagation on the flow's device.

Counterpart of ``dexiraft_tpu/eval/interpolate.py``: the reference's
forward_interpolate (core/utils/utils.py:26-54) splats the previous
frame's low-res flow forward and re-grids it with scipy
griddata(nearest). Here, as in the JAX package, the splat is a scatter
onto a grid ``_SUPERSAMPLE`` times finer and the nearest-neighbor re-grid
a jump-flood Voronoi fill (log2 of the fine grid's larger side, plus one,
rounds of 8 shifted copies), in plain PyTorch on whatever device the flow
lives.

Where two points land in one fine cell, the point with the highest
source index (row-major over the flow field) wins: ``scatter_reduce``
with ``"amax"`` over the source indices, then a gather. The rule is
deterministic on every device (``index_put_`` with repeated indices is
not on CUDA). Without such collisions the result equals the JAX
function's.
"""

from __future__ import annotations

from typing import List

import torch

# scatter-grid supersampling, as in the JAX package: points closer than
# ~1/S px can still collide in one cell
_SUPERSAMPLE = 4
_FAR = 1e9  # sentinel seed coordinate: "no seed here"


def _jfa_steps(h: int, w: int) -> List[int]:
    """Jump-flood step sizes: N/2, ..., 1 plus a final 1 (JFA+1)."""
    n = 1
    while n < max(h, w):
        n *= 2
    steps = []
    k = n // 2
    while k >= 1:
        steps.append(k)
        k //= 2
    return steps + [1]


def forward_interpolate(flow: torch.Tensor) -> torch.Tensor:
    """Propagate (H, W, 2) flow to the next frame's grid, on its device.

    Each pixel's flow vector is carried to its continuous target
    location; every output pixel takes the value of the nearest carried
    point (scipy griddata(nearest) semantics). With no in-frame point at
    all, returns zeros (the reference's fill_value).
    """
    flow = flow.to(torch.float32)
    dev = flow.device
    h, w = flow.shape[:2]
    s = _SUPERSAMPLE
    hs, ws = h * s, w * s
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    x1 = xs + flow[..., 0]
    y1 = ys + flow[..., 1]
    # the reference's strict interior test on the continuous coords
    valid = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    x1f, y1f = x1 * s, y1 * s
    xi = torch.clamp(torch.round(x1f), 0, ws - 1).to(torch.int64)
    yi = torch.clamp(torch.round(y1f), 0, hs - 1).to(torch.int64)
    # invalid points go to a spill cell past the grid
    cell = torch.where(valid, yi * ws + xi, hs * ws).reshape(-1)
    src = torch.arange(h * w, device=dev)
    winner = torch.full((hs * ws + 1,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, cell, src, "amax")[:-1]
    # (seed_x, seed_y, value_x, value_y) per fine cell
    points = torch.cat([x1f.reshape(-1, 1), y1f.reshape(-1, 1),
                        flow.reshape(-1, 2)], dim=1)
    seed = torch.where((winner >= 0)[:, None], points[winner.clamp(min=0)],
                       torch.tensor(_FAR, device=dev)).reshape(hs, ws, 4)

    ysf, xsf = torch.meshgrid(
        torch.arange(hs, dtype=torch.float32, device=dev),
        torch.arange(ws, dtype=torch.float32, device=dev), indexing="ij")

    def dist2(state):
        return (state[..., 0] - xsf) ** 2 + (state[..., 1] - ysf) ** 2

    # each cell's current squared distance rides as a 5th channel
    best = torch.cat([seed, dist2(seed)[..., None]], dim=-1)
    cand = torch.empty_like(best)
    for k in _jfa_steps(hs, ws):
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                # best rolled by (dy, dx), with the cells whose seed would
                # wrap around the grid left at the sentinel (the JAX
                # function's roll and wrap mask, as one shifted copy)
                cand.fill_(_FAR)
                y0, y1 = max(dy, 0), hs + min(dy, 0)
                x0, x1 = max(dx, 0), ws + min(dx, 0)
                if y0 < y1 and x0 < x1:
                    cand[y0:y1, x0:x1, :4] = best[y0 - dy:y1 - dy,
                                                  x0 - dx:x1 - dx, :4]
                cand[..., 4] = dist2(cand)
                best = torch.where((cand[..., 4] < best[..., 4])[..., None],
                                   cand, best)

    # output pixels sit at the fine grid's nodes (s*i, s*j)
    best = best[::s, ::s]
    found = best[..., 0] < _FAR * 0.5
    return torch.where(found[..., None], best[..., 2:4], 0.0)
