"""On-demand local correlation: the plain lookup and the fmap2 pyramid.

Counterpart of ``dexiraft_tpu/ops/local_corr.py``. ``local_corr_level`` is
the plain PyTorch version of the window lookup: per chunk of query rows
it builds the partial all-pairs block f1_chunk . f2^T and windows it with
the separable bilinear matrices of ops.corr.interp_window. Transient
memory is O(row_chunk * W * H2 * W2), never the whole volume.

Like the reference's alternate correlation block, the pyramid pools
FMAP2 (not the volume), and level ``l`` is looked up at ``coords / 2**l``.
Out-of-frame lattice points read zero. Coords get no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from dexiraft_tpu_torch.ops.corr import (
    all_pairs_correlation,
    avg_pool_2x2,
    interp_window,
)
from dexiraft_tpu_torch.ops.quant import store_corr

LOOKUP_KERNELS = ("plain", "flash", "pallas")


def local_corr_level(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     coords: torch.Tensor, radius: int,
                     row_chunk: Optional[int] = None) -> torch.Tensor:
    """Windowed correlation of fmap1 (B, H, W, C) against one fmap2 level
    (B, H2, W2, C) around coords (B, H, W, 2) in LEVEL pixels
    -> (B, H, W, (2r+1)^2) float32. fmap2 may be stored bf16/int8; it is
    upcast here (an int8 scale is the caller's job)."""
    b, h, w, _ = fmap1.shape
    coords = coords.detach()
    step = h if row_chunk is None or row_chunk >= h else row_chunk
    outs = [_local_corr_dense(fmap1[:, r0:r0 + step], fmap2,
                              coords[:, r0:r0 + step], radius)
            for r0 in range(0, h, step)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _local_corr_dense(fmap1, fmap2, coords, radius):
    b, h, w, _ = fmap1.shape
    win = 2 * radius + 1
    vol = all_pairs_correlation(fmap1, fmap2.to(torch.float32))
    flat = coords.reshape(b * h * w, 2).to(torch.float32)
    return interp_window(vol[..., 0], flat, radius).reshape(b, h, w, win * win)


@dataclasses.dataclass
class LocalCorr:
    """fmap1 and the pooled fmap2 pyramid; correlation is computed per
    lookup. ``kernel`` picks the lookup: "plain" (local_corr_level),
    "flash" (B2) or "pallas" (B4), the CUDA kernels of
    ops/corr_kernels.py."""

    fmap1: torch.Tensor            # (B, H, W, C) fp32, contiguous
    fmap2_pyramid: Tuple[torch.Tensor, ...]  # (B, H>>l, W>>l, C) stored
    radius: int
    row_chunk: Optional[int] = None
    kernel: str = "plain"
    # per-level int8 dequantization scales; None for fp32/bf16
    scales: Optional[Tuple[torch.Tensor, ...]] = None

    def level_scale(self, i: int) -> Optional[torch.Tensor]:
        return self.scales[i] if self.scales is not None else None

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        """coords (B, H, W, 2) in level-0 pixels -> (B, H, W, L*(2r+1)^2)."""
        out: List[torch.Tensor] = []
        for i, f2 in enumerate(self.fmap2_pyramid):
            coords_i = coords / (2.0 ** i)
            if self.kernel != "plain":
                from dexiraft_tpu_torch.ops.corr_kernels import LEVEL_LOOKUPS

                corr = LEVEL_LOOKUPS[self.kernel](
                    self.fmap1, f2, coords_i, self.radius, self.row_chunk)
            else:
                corr = local_corr_level(self.fmap1, f2, coords_i,
                                        self.radius, self.row_chunk)
            scale = self.level_scale(i)
            if scale is not None:
                corr = corr * scale
            out.append(corr)
        return torch.cat(out, dim=-1).to(torch.float32)


def build_local_corr(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     num_levels: int = 4, radius: int = 4,
                     row_chunk: Optional[int] = None, dtype: str = "fp32",
                     kernel: str = "plain") -> LocalCorr:
    """Build the pooled fmap2 pyramid from (B, H, W, C) maps. Pooling runs
    in fp32; each level is then stored in ``dtype`` (ops/quant.py)."""
    if kernel not in LOOKUP_KERNELS:
        raise ValueError(f"unknown local-corr kernel {kernel!r}; expected "
                         f"one of {LOOKUP_KERNELS}")
    f1 = fmap1.to(torch.float32).contiguous()
    pooled = [fmap2.to(torch.float32)]
    for _ in range(num_levels - 1):
        pooled.append(avg_pool_2x2(pooled[-1]))
    stored = [store_corr(lvl.contiguous(), dtype) for lvl in pooled]
    return LocalCorr(
        fmap1=f1, fmap2_pyramid=tuple(s[0] for s in stored), radius=radius,
        row_chunk=row_chunk, kernel=kernel,
        scales=tuple(s[1] for s in stored) if dtype == "int8" else None)
