"""Low-precision storage for the fmap2 pyramid.

Counterpart of ``dexiraft_tpu/ops/quant.py``: fp32, bf16, or int8 with one
symmetric fp32 scale per level. Dequantization is linear (x ~ scale * q),
so the scale is folded into whatever linear op consumes the level: the
looked-up window, or the motion encoder's 1x1 conv weight on the fused
path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dexiraft_tpu_torch.config import CORR_DTYPES


def quantize_symmetric(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 values, fp32 scalar scale), scale = max|x| / 127 with the
    max guarded to >= 1e-12; an empty level quantizes with scale 1.0."""
    if x.numel() == 0:
        return x.to(torch.int8), torch.ones((), dtype=torch.float32,
                                            device=x.device)
    amax = x.abs().max().to(torch.float32)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def store_corr(x: torch.Tensor, corr_dtype: str
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cast a pyramid level to its storage dtype -> (stored, scale or None)."""
    if corr_dtype == "fp32":
        return x.to(torch.float32), None
    if corr_dtype == "bf16":
        return x.to(torch.bfloat16), None
    if corr_dtype == "int8":
        return quantize_symmetric(x)
    raise ValueError(
        f"unknown corr_dtype {corr_dtype!r}; expected one of {CORR_DTYPES}")
