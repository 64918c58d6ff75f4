"""Flow-field visualization: Middlebury color wheel (core/utils/flow_viz.py).

A copy of ``dexiraft_tpu/eval/flow_viz.py`` (numpy only).

The standard Baker et al. encoding: hue = flow direction from a 55-bin
RY/YG/GC/CB/BM/MR wheel, saturation = magnitude (normalized to the frame's
max by default), out-of-range vectors dimmed by 75%.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def make_colorwheel() -> np.ndarray:
    """(55, 3) uint8-range RGB wheel: RY=15 YG=6 GC=4 CB=11 BM=13 MR=6."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    ramps = [
        (RY, 0, 1, False),  # red -> yellow: G ramps up
        (YG, 1, 0, True),   # yellow -> green: R ramps down
        (GC, 1, 2, False),  # green -> cyan: B ramps up
        (CB, 2, 1, True),   # cyan -> blue: G ramps down
        (BM, 2, 0, False),  # blue -> magenta: R ramps up
        (MR, 0, 2, True),   # magenta -> red: B ramps down
    ]
    col = 0
    for n, hold, ramp, down in ramps:
        wheel[col:col + n, hold] = 255
        vals = np.floor(255 * np.arange(n) / n)
        wheel[col:col + n, ramp] = 255 - vals if down else vals
        col += n
    return wheel


_WHEEL = make_colorwheel()


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Map unit-scaled (u, v) to RGB via wheel interpolation."""
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]

    col = (1 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    in_range = rad[..., None] <= 1
    col = np.where(in_range, 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.floor(255 * col).astype(np.uint8)
    return img[..., ::-1] if convert_to_bgr else img


def flow_to_image(flow: np.ndarray, clip_flow: Optional[float] = None,
                  convert_to_bgr: bool = False, rad_max: Optional[float] = None
                  ) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 visualization.

    rad_max fixes the normalization (for consistent scaling across a
    sequence); default is the frame's own max magnitude.
    """
    flow = np.asarray(flow, np.float32)
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    denom = (rad_max if rad_max is not None else rad.max()) + 1e-5
    return flow_uv_to_colors(u / denom, v / denom, convert_to_bgr)
