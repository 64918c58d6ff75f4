"""Edge-detection datasets (reference core/DexiNed/datasets.py).

A copy of ``dexiraft_tpu/dexined/data.py``: the same reads, resizes, crops
and generator draws, so one seed gives the same sample bit for bit. cv2 is
imported inside the functions that read and resize, never at import.

A registry of the benchmark datasets the reference supports (:9-149) plus
numpy dataset objects:

  BipedDataset  — training pairs (BGR image - mean, edge-map label with
                  the >0.2 += 0.5 ground-truth boost, 50% random 256-crop
                  then resize to the train size; datasets.py:288-433)
  TestDataset   — eval images resized to /16-divisible shapes
                  (datasets.py:254-259), original shape kept for unpadding

Samples are HWC float32 BGR (the DexiNed convention — cv2 imread order,
mean-BGR subtracted); labels are (H, W, 1) in [0, 1].
"""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN_BGR = (103.939, 116.779, 123.68)


@dataclass(frozen=True)
class EdgeDatasetInfo:
    img_height: int
    img_width: int
    mean_bgr: Tuple[float, ...] = IMAGENET_MEAN_BGR
    train_list: Optional[str] = None
    test_list: Optional[str] = None
    data_dir: str = ""


# the 9 datasets of the reference registry (datasets.py:9-149); sizes are
# the /16-divisible eval resolutions it uses
DATASET_INFO: Dict[str, EdgeDatasetInfo] = {
    "BIPED": EdgeDatasetInfo(720, 1280, data_dir="BIPED/edges"),
    "BSDS": EdgeDatasetInfo(512, 512, train_list="train_pair.lst",
                            test_list="test_pair.lst", data_dir="BSDS"),
    "BSDS300": EdgeDatasetInfo(512, 512, test_list="test_pair.lst",
                               data_dir="BSDS300"),
    "CID": EdgeDatasetInfo(512, 512, test_list="test_pair.lst", data_dir="CID"),
    "MDBD": EdgeDatasetInfo(720, 1280, train_list="train_pair.lst",
                            test_list="test_pair.lst", data_dir="MDBD"),
    "NYUD": EdgeDatasetInfo(448, 560, test_list="test_pair.lst", data_dir="NYUD"),
    "PASCAL": EdgeDatasetInfo(416, 512, test_list="test_pair.lst",
                              data_dir="PASCAL"),
    "DCD": EdgeDatasetInfo(352, 480, test_list="test_pair.lst", data_dir="DCD"),
    "CLASSIC": EdgeDatasetInfo(512, 512, data_dir="data"),
}

DATASET_NAMES = sorted(DATASET_INFO)


def _read_bgr(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def _read_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


class BipedDataset:
    """Training pairs for BIPED-style trees:
    <root>/imgs/train/rgbr/aug/<seq>/*.jpg with labels under
    <root>/edge_maps/train/rgbr/aug/<seq>/*.png; list-file datasets
    (BSDS/MDBD) pass train_list with '<img> <gt>' lines."""

    def __init__(self, data_root: str, img_size: int = 352,
                 mean_bgr=IMAGENET_MEAN_BGR, train_list: Optional[str] = None,
                 crop_size: int = 256):
        self.img_size = img_size
        self.mean_bgr = np.asarray(mean_bgr, np.float32)
        self.crop_size = crop_size
        self.pairs: List[Tuple[str, str]] = []
        if train_list:
            with open(osp.join(data_root, train_list)) as f:
                for line in f:
                    if line.strip():
                        img, gt = line.split()[:2]
                        self.pairs.append((osp.join(data_root, img),
                                           osp.join(data_root, gt)))
        else:
            images_path = osp.join(data_root, "imgs", "train", "rgbr", "aug")
            labels_path = osp.join(data_root, "edge_maps", "train", "rgbr", "aug")
            for d in sorted(os.listdir(images_path)):
                for f in sorted(os.listdir(osp.join(images_path, d))):
                    stem = osp.splitext(f)[0]
                    self.pairs.append(
                        (osp.join(images_path, d, f),
                         osp.join(labels_path, d, stem + ".png")))
        if not self.pairs:
            raise FileNotFoundError(f"no training pairs under {data_root}")

    def __len__(self) -> int:
        return len(self.pairs)

    def sample(self, index: int, rng: Optional[np.random.Generator] = None
               ) -> Dict[str, np.ndarray]:
        import cv2

        rng = rng or np.random.default_rng()
        img_path, gt_path = self.pairs[index % len(self.pairs)]
        img = _read_bgr(img_path) - self.mean_bgr
        gt = _read_gray(gt_path) / 255.0

        size = self.img_size
        if rng.random() >= 0.5:  # 50%: random crop then upscale
            h, w = gt.shape[:2]
            c = self.crop_size
            i = rng.integers(0, max(h - c, 1))
            j = rng.integers(0, max(w - c, 1))
            img = img[i:i + c, j:j + c]
            gt = gt[i:i + c, j:j + c]
        img = cv2.resize(img, (size, size))
        gt = cv2.resize(gt, (size, size))

        # ground-truth boost: weak annotations count as edges
        # (datasets.py:419)
        gt = np.where(gt > 0.2, gt + 0.5, gt)
        gt = np.clip(gt, 0.0, 1.0)
        return {"images": img.astype(np.float32),
                "labels": gt[..., None].astype(np.float32)}

    __getitem__ = sample


class TestDataset:
    """Eval images resized to /16-divisible shapes; original size kept so
    predictions can be restored (datasets.py:152-285)."""

    def __init__(self, data_root: str, img_height: Optional[int] = None,
                 img_width: Optional[int] = None, mean_bgr=IMAGENET_MEAN_BGR,
                 test_list: Optional[str] = None):
        self.mean_bgr = np.asarray(mean_bgr, np.float32)
        self.img_height = img_height
        self.img_width = img_width
        if test_list:
            with open(osp.join(data_root, test_list)) as f:
                self.files = [osp.join(data_root, line.split()[0])
                              for line in f if line.strip()]
        else:
            exts = ("*.jpg", "*.png", "*.jpeg", "*.JPG")
            self.files = sorted(sum((glob(osp.join(data_root, e)) for e in exts),
                                    []))
        if not self.files:
            raise FileNotFoundError(f"no test images under {data_root}")

    def __len__(self) -> int:
        return len(self.files)

    def sample(self, index: int, rng=None) -> Dict[str, np.ndarray]:
        import cv2

        path = self.files[index]
        img = _read_bgr(path)
        shape = img.shape[:2]
        if self.img_height and self.img_width:
            h, w = self.img_height, self.img_width
        else:
            h = (shape[0] // 16) * 16
            w = (shape[1] // 16) * 16
        img = cv2.resize(img, (w, h)) - self.mean_bgr
        return {"images": img.astype(np.float32),
                "file_name": osp.basename(path),
                "image_shape": shape}

    __getitem__ = sample
