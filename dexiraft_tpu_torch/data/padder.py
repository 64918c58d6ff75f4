"""Eval-time padding to stride-8 shapes.

Counterpart of ``dexiraft_tpu/data/padder.py`` (its own copy): 'sintel'
mode centers the pad; other modes (kitti/HD1K) pad the width centered and
all of the height at the bottom, replicate-edge in both. ``target=`` pads
out to a bucket shape with the same placement rules. Arrays are NHWC
numpy, as the engine hands them around.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class InputPadder:
    def __init__(self, shape: Sequence[int], mode: str = "sintel",
                 stride: int = 8, target: Optional[Tuple[int, int]] = None):
        self.ht, self.wd = int(shape[-3]), int(shape[-2])  # NHWC
        if target is None:
            pad_ht = (((self.ht // stride) + 1) * stride - self.ht) % stride
            pad_wd = (((self.wd // stride) + 1) * stride - self.wd) % stride
        else:
            tht, twd = int(target[0]), int(target[1])
            if tht < self.ht or twd < self.wd:
                raise ValueError(
                    f"pad target {tht}x{twd} smaller than input "
                    f"{self.ht}x{self.wd}")
            if tht % stride or twd % stride:
                raise ValueError(
                    f"pad target {tht}x{twd} not stride-{stride} aligned")
            pad_ht, pad_wd = tht - self.ht, twd - self.wd
        if mode == "sintel":
            # [left, right, top, bottom]
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    @property
    def padded_shape(self) -> Tuple[int, int]:
        l, r, t, b = self._pad
        return (self.ht + t + b, self.wd + l + r)

    def pad(self, *inputs: np.ndarray) -> Tuple[np.ndarray, ...]:
        l, r, t, b = self._pad
        width = [(0, 0)] * (inputs[0].ndim - 3) + [(t, b), (l, r), (0, 0)]
        return tuple(np.pad(x, width, mode="edge") for x in inputs)

    def unpad(self, x: np.ndarray) -> np.ndarray:
        l, r, t, b = self._pad
        ht, wd = x.shape[-3], x.shape[-2]
        return x[..., t:ht - b or None, l:wd - r or None, :]
