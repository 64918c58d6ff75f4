"""Training-time augmentation, numpy-native with explicit PRNG.

Re-implements the reference augmentors (core/utils/augmentor.py) without
torch/torchvision: photometric jitter (brightness/contrast/saturation/hue
in random order, matching torchvision.ColorJitter semantics), occlusion
eraser, random scale+stretch, flips, and crop; plus the sparse variant
that re-splats valid flow vectors after resize
(core/utils/augmentor.py:161-193).

TPU-first difference: every random draw comes from an explicit
numpy Generator passed per sample, so the whole pipeline is replayable
from (seed, epoch, index) — the reference's global np.random state is
only per-worker seeded (core/datasets.py:45-51) and not reproducible.

Edge-lockstep: augmentors accept an optional second image pair that gets
the SAME photometric and spatial transforms. The reference instead runs
its augmentor twice with fresh random draws (core/datasets_seperate.py:85-89),
so its edge maps see different crops than the images — a bug we fix
(documented divergence).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _resize(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    import cv2

    return cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)


class ColorJitter:
    """torchvision-compatible photometric jitter on uint8 RGB.

    Factors: brightness/contrast/saturation ~ U[max(0,1-x), 1+x],
    hue ~ U[-h, h] (fraction of the hue circle); the four ops are applied
    in random order, like torchvision.transforms.ColorJitter.
    """

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _blend(img: np.ndarray, other: np.ndarray, factor: float) -> np.ndarray:
        # in-place over one f32 buffer (same f32 math, value-identical;
        # the naive expression allocates three full-image temporaries)
        out = img.astype(np.float32)
        out *= factor
        out += (1.0 - factor) * other
        np.clip(out, 0, 255, out=out)
        return out.astype(np.uint8)

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        import cv2

        ops = []
        if self.brightness > 0:
            f = rng.uniform(max(0.0, 1 - self.brightness), 1 + self.brightness)
            ops.append(("brightness", f))
        if self.contrast > 0:
            f = rng.uniform(max(0.0, 1 - self.contrast), 1 + self.contrast)
            ops.append(("contrast", f))
        if self.saturation > 0:
            f = rng.uniform(max(0.0, 1 - self.saturation), 1 + self.saturation)
            ops.append(("saturation", f))
        if self.hue > 0:
            ops.append(("hue", rng.uniform(-self.hue, self.hue)))

        # brightness/contrast blend each pixel against a SCALAR, so on
        # uint8 input they are exact 256-entry lookup tables — cv2.LUT
        # replaces two full-image float passes (the profiled hot spot of
        # the whole host pipeline) at bit-identical output: the table is
        # built with the same f32 multiply-add + truncating cast per
        # possible value that _blend applies per pixel
        ramp = np.arange(256, dtype=np.float32)
        for i in rng.permutation(len(ops)):
            name, f = ops[i]
            if name == "brightness":
                lut = np.clip(f * ramp, 0, 255).astype(np.uint8)
                img = cv2.LUT(img, lut)
            elif name == "contrast":
                # cv2.mean agrees with ndarray.mean to fp rounding and
                # is far cheaper
                gray_mean = cv2.mean(cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))[0]
                lut = np.clip(f * ramp + (1.0 - f) * np.float32(gray_mean),
                              0, 255).astype(np.uint8)
                img = cv2.LUT(img, lut)
            elif name == "saturation":
                gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)[..., None]
                img = self._blend(img, gray.astype(np.float32), f)
            else:  # hue: shift in HSV; cv2 uint8 hue is degrees/2 in [0,180)
                hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
                shift = int(round(f * 180.0)) % 180
                # int16 intermediate: uint8 would wrap at 256 before the mod
                hue = (hsv[..., 0].astype(np.int16) + shift) % 180
                hsv[..., 0] = hue.astype(np.uint8)
                img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        return img


Pair = Tuple[np.ndarray, np.ndarray]


class FlowAugmentor:
    """Dense-flow augmentation (core/utils/augmentor.py:15-120)."""

    def __init__(self, crop_size: Sequence[int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.eraser_bounds = (50, 100)

    def color_transform(self, rng, img1, img2) -> Pair:
        if rng.random() < self.asymmetric_color_aug_prob:
            return self.photo_aug(rng, img1), self.photo_aug(rng, img2)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo_aug(rng, stack)
        out1, out2 = np.split(stack, 2, axis=0)
        return out1, out2

    def eraser_transform(self, rng, img1, img2) -> Pair:
        """Occlusion aug: paint random rects of img2 with its mean color."""
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(*self.eraser_bounds)
                dy = rng.integers(*self.eraser_bounds)
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def _sample_scales(self, rng, ht: int, wd: int) -> Tuple[float, float]:
        min_scale = max((self.crop_size[0] + 8) / float(ht),
                        (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return max(sx, min_scale), max(sy, min_scale)

    def spatial_transform(self, rng, img1, img2, flow,
                          extras: Optional[List[np.ndarray]] = None):
        ht, wd = img1.shape[:2]
        sx, sy = self._sample_scales(rng, ht, wd)
        extras = list(extras) if extras else []

        # float32 multipliers: a python-list factor would promote the
        # whole flow map to float64 (2x host memory traffic per pass)
        if rng.random() < self.spatial_aug_prob:
            img1 = _resize(img1, sx, sy)
            img2 = _resize(img2, sx, sy)
            flow = _resize(flow, sx, sy) * np.array([sx, sy], np.float32)
            extras = [_resize(e, sx, sy) for e in extras]

        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
                extras = [e[:, ::-1] for e in extras]
            if rng.random() < self.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * np.array([1.0, -1.0], np.float32)
                extras = [e[::-1] for e in extras]

        y0 = rng.integers(0, img1.shape[0] - self.crop_size[0])
        x0 = rng.integers(0, img1.shape[1] - self.crop_size[1])
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img1, img2, flow = img1[sl], img2[sl], flow[sl]
        extras = [e[sl] for e in extras]
        return img1, img2, flow, extras

    def __call__(self, rng: np.random.Generator, img1, img2, flow,
                 edges: Optional[Pair] = None):
        """Returns (img1, img2, flow[, em1, em2]) contiguous float-ready."""
        img1, img2 = self.color_transform(rng, img1, img2)
        img1, img2 = self.eraser_transform(rng, img1, img2)
        extras = list(edges) if edges is not None else []
        img1, img2, flow, extras = self.spatial_transform(rng, img1, img2, flow, extras)
        out = [np.ascontiguousarray(img1), np.ascontiguousarray(img2),
               np.ascontiguousarray(flow)]
        out += [np.ascontiguousarray(e) for e in extras]
        return tuple(out)


class SparseFlowAugmentor:
    """Sparse-flow (KITTI/HD1K) augmentation (core/utils/augmentor.py:122-246)."""

    def __init__(self, crop_size: Sequence[int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = False):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.photo_aug = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)
        self.eraser_aug_prob = 0.5
        self.eraser_bounds = (50, 100)
        self.margin_y = 20
        self.margin_x = 50

    def color_transform(self, rng, img1, img2) -> Pair:
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo_aug(rng, stack)
        out1, out2 = np.split(stack, 2, axis=0)
        return out1, out2

    eraser_transform = FlowAugmentor.eraser_transform

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx: float, fy: float):
        """Re-splat valid flow vectors onto the scaled integer grid.

        Bilinear resize would smear invalid zeros into valid pixels; the
        reference instead scatters each valid vector to its rounded new
        location (core/utils/augmentor.py:161-193, exclusive-0 bound kept).
        """
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        valid_flat = valid.reshape(-1) >= 1

        coords0 = coords[valid_flat]
        flow0 = flow_flat[valid_flat]

        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))
        # float64 kept deliberately (unlike the dense-path multipliers):
        # np.round on these decides each vector's integer splat
        # destination, and the reference computes them in float64 too —
        # the temporaries are small (valid points only)
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.float32)
        flow_img[yy[keep], xx[keep]] = flow1[keep]
        valid_img[yy[keep], xx[keep]] = 1.0
        return flow_img, valid_img

    def spatial_transform(self, rng, img1, img2, flow, valid,
                          extras: Optional[List[np.ndarray]] = None):
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / float(ht),
                        (self.crop_size[1] + 1) / float(wd))
        scale = max(2 ** rng.uniform(self.min_scale, self.max_scale), min_scale)
        extras = list(extras) if extras else []

        if rng.random() < self.spatial_aug_prob:
            img1 = _resize(img1, scale, scale)
            img2 = _resize(img2, scale, scale)
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale, scale)
            extras = [_resize(e, scale, scale) for e in extras]

        if self.do_flip and rng.random() < self.h_flip_prob:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            # float32 multiplier (sign flip is exact in any dtype; a
            # python list would promote the map to float64)
            flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            valid = valid[:, ::-1]
            extras = [e[:, ::-1] for e in extras]

        # crop window may start above/left of the frame by a margin,
        # then clipped — biases KITTI crops toward the road region
        y0 = rng.integers(0, img1.shape[0] - self.crop_size[0] + self.margin_y)
        x0 = rng.integers(-self.margin_x,
                          img1.shape[1] - self.crop_size[1] + self.margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img1, img2, flow, valid = img1[sl], img2[sl], flow[sl], valid[sl]
        extras = [e[sl] for e in extras]
        return img1, img2, flow, valid, extras

    def __call__(self, rng: np.random.Generator, img1, img2, flow, valid,
                 edges: Optional[Pair] = None):
        img1, img2 = self.color_transform(rng, img1, img2)
        img1, img2 = self.eraser_transform(rng, img1, img2)
        extras = list(edges) if edges is not None else []
        img1, img2, flow, valid, extras = self.spatial_transform(
            rng, img1, img2, flow, valid, extras)
        out = [np.ascontiguousarray(img1), np.ascontiguousarray(img2),
               np.ascontiguousarray(flow), np.ascontiguousarray(valid)]
        out += [np.ascontiguousarray(e) for e in extras]
        return tuple(out)
