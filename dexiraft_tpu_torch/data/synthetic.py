"""Synthetic dataset trees in each dataset's own layout and file format.

For runs without the real datasets (the CPU tests, the card's smoke
test): every file is written by the port's own codecs (data/png.py,
data/flow_io.py) from a numpy seed, under the directory names
data/datasets.py reads (``DEXIRAFT_DATA_DIR`` = ``root``). Frames are a
smooth seeded texture, each frame the previous one shifted by a few
pixels; ground-truth flows are seeded smooth fields. The values mean
nothing: the trees exercise the readers, the padders and the metrics.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np

from dexiraft_tpu_torch.data.flow_io import read_image, write_flo, \
    write_flow_kitti, write_ppm
from dexiraft_tpu_torch.data.png import write_png

HW = Tuple[int, int]


def texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 3) float32 in [0, 255]: a few random sinusoids per channel
    plus noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for ch in range(3):
        f = rng.uniform(0.02, 0.2, 4)
        p = rng.uniform(0, 2 * np.pi, 2)
        img[..., ch] = 127.5 + 50 * np.sin(f[0] * xx + f[1] * yy + p[0]) \
            + 50 * np.sin(f[2] * xx - f[3] * yy + p[1])
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255)


def frames(rng: np.random.Generator, n: int, hw: HW) -> "list[np.ndarray]":
    """``n`` uint8 frames, each the previous one shifted by (2, 1) px."""
    base = texture(rng, hw[0] + 2 * n, hw[1] + 2 * n)
    return [base[k:k + hw[0], 2 * k:2 * k + hw[1]].astype(np.uint8)
            for k in range(n)]


def flow_field(rng: np.random.Generator, hw: HW, scale: float = 4.0
               ) -> np.ndarray:
    """(h, w, 2) float32 smooth flow, components ~ ``scale`` px."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.01, 0.05, 4)
    u = scale * np.sin(f[0] * xx + f[1] * yy) + rng.normal(0, 0.3, (h, w))
    v = scale * np.cos(f[2] * xx - f[3] * yy) + rng.normal(0, 0.3, (h, w))
    return np.stack([u, v], -1).astype(np.float32)


def write_sintel_tree(root: str, split: str = "training", scenes: int = 2,
                      n_frames: int = 3, hw: HW = (436, 1024),
                      dstypes: Sequence[str] = ("clean", "final"),
                      seed: int = 0, filters=2) -> None:
    """Sintel/<split>/<dstype>/scene_<k>/frame_<i>.png (RGB) and, for the
    training split, Sintel/<split>/flow/scene_<k>/frame_<i>.flo.
    ``filters``: the PNG row filter(s) of the frames."""
    rng = np.random.default_rng(seed)
    base = osp.join(root, "Sintel", split)
    for k in range(scenes):
        scene = f"scene_{k}"
        clean = frames(rng, n_frames, hw)
        for dstype in dstypes:
            d = osp.join(base, dstype, scene)
            os.makedirs(d, exist_ok=True)
            for i, img in enumerate(clean):
                if dstype != "clean":  # "final": the same frames, darker
                    img = (img * 0.8).astype(np.uint8)
                write_png(osp.join(d, f"frame_{i + 1:04d}.png"), img,
                          filters=filters)
        if split != "test":
            d = osp.join(base, "flow", scene)
            os.makedirs(d, exist_ok=True)
            for i in range(n_frames - 1):
                write_flo(osp.join(d, f"frame_{i + 1:04d}.flo"),
                          flow_field(rng, hw))


def _sparse_valid(rng, hw: HW, frac: float) -> np.ndarray:
    return (rng.uniform(size=hw) < frac).astype(np.float32)


def write_kitti_tree(root: str, split: str = "training", n: int = 3,
                     hw: HW = (375, 1242), valid_frac: float = 0.3,
                     empty: Optional[int] = None, seed: int = 0) -> None:
    """Kitti_2015/data_scene_flow/<split>/image_2/<i>_10.png and _11.png
    and, for the training split, flow_occ/<i>_10.png (16-bit, about
    ``valid_frac`` of the pixels valid; frame ``empty`` with none)."""
    rng = np.random.default_rng(seed)
    base = osp.join(root, "Kitti_2015", "data_scene_flow", split)
    os.makedirs(osp.join(base, "image_2"), exist_ok=True)
    if split == "training":
        os.makedirs(osp.join(base, "flow_occ"), exist_ok=True)
    for i in range(n):
        pair = frames(rng, 2, hw)
        for img, suffix in zip(pair, ("10", "11")):
            write_png(osp.join(base, "image_2", f"{i:06d}_{suffix}.png"), img)
        if split == "training":
            valid = _sparse_valid(rng, hw, 0.0 if i == empty else valid_frac)
            write_flow_kitti(osp.join(base, "flow_occ", f"{i:06d}_10.png"),
                             flow_field(rng, hw), valid)


def write_hd1k_tree(root: str, sequences: int = 1, n_frames: int = 3,
                    hw: HW = (540, 1280), valid_frac: float = 0.3,
                    empty: Optional[Tuple[int, int]] = None,
                    seed: int = 0) -> None:
    """HD1k/hd1k_input/image_2/<seq>_<i>.png and
    HD1k/hd1k_flow_gt/flow_occ/<seq>_<i>.png (16-bit, sparse; frame
    ``empty`` = (seq, i) with no valid pixel)."""
    rng = np.random.default_rng(seed)
    img_dir = osp.join(root, "HD1k", "hd1k_input", "image_2")
    flow_dir = osp.join(root, "HD1k", "hd1k_flow_gt", "flow_occ")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(flow_dir, exist_ok=True)
    for s in range(sequences):
        for i, img in enumerate(frames(rng, n_frames, hw)):
            write_png(osp.join(img_dir, f"{s:06d}_{i:04d}.png"), img)
            frac = 0.0 if empty == (s, i) else valid_frac
            write_flow_kitti(osp.join(flow_dir, f"{s:06d}_{i:04d}.png"),
                             flow_field(rng, hw),
                             _sparse_valid(rng, hw, frac))


def write_chairs_tree(root: str, n_train: int = 4, n_val: int = 2,
                      hw: HW = (384, 512), seed: int = 0,
                      flow_std: float = 4.0) -> str:
    """FlyingChairs_release/data/<i>_img1.ppm, _img2.ppm, _flow.flo and
    chairs_split.txt: ``n_train`` training pairs (split 1), then
    ``n_val`` validation pairs (split 2). Returns the data directory."""
    rng = np.random.default_rng(seed)
    data = osp.join(root, "FlyingChairs_release", "data")
    os.makedirs(data, exist_ok=True)
    n = n_train + n_val
    for i in range(n):
        for k in (1, 2):
            write_ppm(osp.join(data, f"{i:05d}_img{k}.ppm"),
                      rng.integers(0, 256, hw + (3,), dtype=np.uint8))
        write_flo(osp.join(data, f"{i:05d}_flow.flo"),
                  rng.normal(0, flow_std, hw + (2,)).astype(np.float32))
    with open(osp.join(root, "FlyingChairs_release", "chairs_split.txt"),
              "w") as f:
        f.write("\n".join(["1"] * n_train + ["2"] * n_val))
    return data


def write_edge_tree(image_root: str, edge_root: str, seed: int = 0) -> None:
    """A parallel tree of edge-map PNGs for every .ppm / .png frame under
    ``image_root`` (the path mapping of data.datasets.wrap_with_edge_tree:
    same relative path, extension .png)."""
    rng = np.random.default_rng(seed)
    for dirpath, _, names in os.walk(image_root):
        for name in sorted(names):
            if not name.endswith((".ppm", ".png")):
                continue
            h, w = read_image(osp.join(dirpath, name)).shape[:2]
            rel = osp.relpath(osp.join(dirpath, name), image_root)
            out = osp.join(edge_root, osp.splitext(rel)[0] + ".png")
            os.makedirs(osp.dirname(out), exist_ok=True)
            write_png(out, rng.integers(0, 256, (h, w), dtype=np.uint8))
