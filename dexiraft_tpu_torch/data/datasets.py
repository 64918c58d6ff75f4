"""Flow datasets: sample indexing, decoding, curriculum mixtures.

Re-design of core/datasets.py (+ datasets_seperate.py, datasets_sub.py):
datasets are plain indexable objects returning numpy dicts — no torch.
Randomness is explicit: `sample(index, rng)` takes the generator, so an
epoch is replayable from (seed, epoch) and each host of a multi-host
mesh can derive disjoint streams (the reference relies on global
per-worker seeding, core/datasets.py:45-51).

Directory layouts match the reference adapters so the same dataset roots
work; roots come from DEXIRAFT_DATA_DIR (default /mnt/dst_datasets/optical_flow,
the reference's hard-coded prefix, core/datasets.py:104-183).
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dexiraft_tpu_torch.data.augment import FlowAugmentor, SparseFlowAugmentor
from dexiraft_tpu_torch.data.flow_io import read_flow_kitti, read_gen, read_image

Sample = Dict[str, np.ndarray]


def data_root(name: str) -> str:
    base = os.environ.get("DEXIRAFT_DATA_DIR", "/mnt/dst_datasets/optical_flow")
    return osp.join(base, name)


# the sintel-stage mixture selector train_cli implicitly trains with;
# a records pack made with a different one is a different sample
# sequence, which the --records_dir provenance check refuses
DEFAULT_TRAIN_DS = "C+T+K+S+H"


class FlowDataset:
    """Base dataset: (image pair, flow[, valid]) with optional augmentation."""

    def __init__(self, aug_params: Optional[dict] = None, sparse: bool = False):
        self.sparse = sparse
        self.augmentor = None
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params)
        self.is_test = False
        self.flow_list: List[str] = []
        self.image_list: List[Tuple[str, str]] = []
        self.extra_info: List = []
        self.repeat = 1  # curriculum replication factor (cheap __rmul__)

    # -- composition (mirrors torch's ConcatDataset / reference __rmul__) --

    def __mul__(self, v: int) -> "FlowDataset":
        # value semantics: a shallow copy so `100 * ds` never mutates ds
        # (the reference's in-place __rmul__, core/datasets.py:94-97,
        # silently compounds factors when a dataset object is reused)
        import copy

        out = copy.copy(self)
        out.repeat = self.repeat * int(v)
        return out

    __rmul__ = __mul__

    def __add__(self, other: "FlowDataset") -> "ConcatFlowDataset":
        return ConcatFlowDataset([self, other])

    def __len__(self) -> int:
        return len(self.image_list) * self.repeat

    # -- decoding --

    def _load_raw(self, index: int) -> Sample:
        index = index % len(self.image_list)
        img1 = read_image(self.image_list[index][0])
        img2 = read_image(self.image_list[index][1])
        if self.is_test:
            return {"image1": img1.astype(np.float32),
                    "image2": img2.astype(np.float32),
                    "extra_info": self.extra_info[index]}
        if self.sparse:
            flow, valid = read_flow_kitti(self.flow_list[index])
        else:
            flow = np.asarray(read_gen(self.flow_list[index]), np.float32)
            valid = None
        out: Sample = {"image1": img1, "image2": img2,
                       "flow": flow.astype(np.float32)}
        if valid is not None:
            out["valid"] = valid.astype(np.float32)
        return out

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> Sample:
        """One training sample: float32 HWC images, (H,W,2) flow, (H,W) valid."""
        raw = self._load_raw(index)
        if self.is_test:
            return raw
        img1, img2, flow = raw["image1"], raw["image2"], raw["flow"]
        valid = raw.get("valid")

        if self.augmentor is not None:
            if rng is None:
                raise ValueError("augmenting dataset needs an rng")
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(rng, img1, img2, flow, valid)
            else:
                img1, img2, flow = self.augmentor(rng, img1, img2, flow)

        if valid is None:
            # dense data: mask absurd flow (core/datasets.py:88)
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
        return {"image1": img1.astype(np.float32),
                "image2": img2.astype(np.float32),
                "flow": flow.astype(np.float32),
                "valid": np.asarray(valid, np.float32)}

    __getitem__ = sample


class ConcatFlowDataset:
    """Concatenation preserving per-member replication factors."""

    def __init__(self, members: Sequence):
        self.members: List = []
        for m in members:
            if isinstance(m, ConcatFlowDataset):
                self.members.extend(m.members)
            else:
                self.members.append(m)

    def __add__(self, other) -> "ConcatFlowDataset":
        return ConcatFlowDataset([self, other])

    def __len__(self) -> int:
        return sum(len(m) for m in self.members)

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> Sample:
        for m in self.members:
            n = len(m)
            if index < n:
                return m.sample(index, rng)
            index -= n
        raise IndexError(index)

    __getitem__ = sample


class MpiSintel(FlowDataset):
    """Sintel scene walk, clean/final passes (core/datasets.py:103-120)."""

    def __init__(self, aug_params=None, split="training", root=None,
                 dstype="clean", scene: Optional[str] = None,
                 qualitative: bool = False):
        """scene restricts to one scene; qualitative=True additionally
        returns test-style samples (image pair + extra_info, no flow) for
        visualization runs on training scenes — the reference's
        core/datasets_sub.py market_2 workflow."""
        super().__init__(aug_params)
        root = root or data_root("Sintel")
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        if split == "test" or qualitative:
            self.is_test = True
        scenes = [scene] if scene else sorted(os.listdir(image_root))
        for sc in scenes:
            images = sorted(glob(osp.join(image_root, sc, "*.png")))
            for i in range(len(images) - 1):
                self.image_list.append((images[i], images[i + 1]))
                self.extra_info.append((sc, i))
            if split != "test":
                self.flow_list += sorted(glob(osp.join(flow_root, sc, "*.flo")))


class FlyingChairs(FlowDataset):
    """FlyingChairs with the published 1/2 train/val split file
    (core/datasets.py:123-136; chairs_split.txt consumed at :131)."""

    def __init__(self, aug_params=None, split="training", root=None,
                 split_file: Optional[str] = None):
        super().__init__(aug_params)
        root = root or data_root("FlyingChairs_release/data")
        images = sorted(glob(osp.join(root, "*.ppm")))
        flows = sorted(glob(osp.join(root, "*.flo")))
        assert len(images) // 2 == len(flows), (len(images), len(flows))

        if split_file is None:
            for cand in (osp.join(root, "..", "chairs_split.txt"),
                         osp.join(root, "chairs_split.txt"),
                         "chairs_split.txt"):
                if osp.exists(cand):
                    split_file = cand
                    break
        if split_file is None:
            raise FileNotFoundError(
                "chairs_split.txt not found; pass split_file= explicitly")
        split_ids = np.loadtxt(split_file, dtype=np.int32)
        want = 1 if split == "training" else 2
        for i in range(len(flows)):
            if split_ids[i] == want:
                self.flow_list.append(flows[i])
                self.image_list.append((images[2 * i], images[2 * i + 1]))


class FlyingThings3D(FlowDataset):
    """Left camera, both time directions (core/datasets.py:139-160)."""

    def __init__(self, aug_params=None, root=None, dstype="frames_cleanpass"):
        super().__init__(aug_params)
        root = root or data_root("FlyingThings3D")
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
                image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
                flow_dirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted(osp.join(f, direction, cam) for f in flow_dirs)
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list.append((images[i], images[i + 1]))
                            self.flow_list.append(flows[i])
                        else:
                            self.image_list.append((images[i + 1], images[i]))
                            self.flow_list.append(flows[i + 1])


class KITTI(FlowDataset):
    """KITTI-2015 sparse flow (core/datasets.py:163-179)."""

    def __init__(self, aug_params=None, split="training", root=None):
        super().__init__(aug_params, sparse=True)
        root = root or data_root("Kitti_2015")
        if split == "testing":
            self.is_test = True
        root = osp.join(root, "data_scene_flow", split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        for im1, im2 in zip(images1, images2):
            self.extra_info.append([osp.basename(im1)])
            self.image_list.append((im1, im2))
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    """HD1K sparse flow. The reference only walks sequence 000000 (its loop
    never iterates, core/datasets.py:186-199); we walk every sequence and
    keep consecutive-frame pairing within each."""

    def __init__(self, aug_params=None, root=None):
        super().__init__(aug_params, sparse=True)
        root = root or data_root("HD1k")
        seq_ix = 0
        while True:
            flows = sorted(glob(osp.join(root, "hd1k_flow_gt",
                                         "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob(osp.join(root, "hd1k_input",
                                          "image_2/%06d_*.png" % seq_ix)))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append((images[i], images[i + 1]))
            seq_ix += 1


class EdgePairDataset(FlowDataset):
    """Flow samples with precomputed edge-map images for the v2/v3 data-edge
    contract (core/datasets_seperate.py): edge PNGs live in a parallel tree
    and receive the same augmentation as the images (lockstep — the
    reference's independent second augmentor call is a documented bug)."""

    def __init__(self, base: FlowDataset, edge_list: Sequence[Tuple[str, str]]):
        super().__init__(aug_params=None, sparse=base.sparse)
        self.base = base
        self.augmentor = base.augmentor
        self.sparse = base.sparse
        self.is_test = base.is_test
        self.flow_list = base.flow_list
        self.image_list = base.image_list
        self.extra_info = base.extra_info
        self.edge_list = list(edge_list)
        assert len(self.edge_list) == len(self.image_list)

    @classmethod
    def from_parallel_tree(cls, base: FlowDataset, image_root: str,
                           edge_root: str) -> "EdgePairDataset":
        """Map each image path to the same relative path under edge_root."""
        def remap(p: str) -> str:
            rel = osp.relpath(p, image_root)
            return osp.join(edge_root, osp.splitext(rel)[0] + ".png")

        pairs = [(remap(a), remap(b)) for a, b in base.image_list]
        return cls(base, pairs)

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> Sample:
        raw = self._load_raw(index)
        i = index % len(self.image_list)
        em1 = read_image(self.edge_list[i][0])
        em2 = read_image(self.edge_list[i][1])
        img1, img2, flow = raw["image1"], raw["image2"], raw["flow"]
        valid = raw.get("valid")

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid, em1, em2 = self.augmentor(
                    rng, img1, img2, flow, valid, edges=(em1, em2))
            else:
                img1, img2, flow, em1, em2 = self.augmentor(
                    rng, img1, img2, flow, edges=(em1, em2))
        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
        return {"image1": img1.astype(np.float32),
                "image2": img2.astype(np.float32),
                "edges1": em1.astype(np.float32),
                "edges2": em2.astype(np.float32),
                "flow": flow.astype(np.float32),
                "valid": np.asarray(valid, np.float32)}

    __getitem__ = sample


def fetch_dataset(stage: str, image_size: Sequence[int],
                  train_ds: str = DEFAULT_TRAIN_DS,
                  edge_root: Optional[str] = None):
    """Stage-keyed training mixture (core/datasets.py:202-237).

    edge_root: parallel tree of precomputed edge-map PNGs — wraps the
    stage dataset in EdgePairDataset for the v2/v3 data-edge contract
    (core/datasets_seperate.py). Supported for the single-dataset stages
    (chairs, kitti)."""
    ds = _fetch_plain(stage, image_size, train_ds)
    if edge_root is None:
        return ds
    if isinstance(ds, ConcatFlowDataset):
        raise ValueError(
            f"edge_root is only supported for single-dataset stages, "
            f"not the {stage!r} mixture")
    return wrap_with_edge_tree(ds, edge_root)


def wrap_with_edge_tree(ds: "FlowDataset", edge_root: str) -> "EdgePairDataset":
    """Pair every image with its edge map at the same relative path under
    edge_root — the ONE path-mapping convention shared by training
    (fetch_dataset) and edge-sum evaluation (eval_cli)."""
    image_root = osp.dirname(osp.commonprefix(
        [p for pair in ds.image_list for p in pair]))
    return EdgePairDataset.from_parallel_tree(ds, image_root, edge_root)


def _fetch_plain(stage: str, image_size: Sequence[int], train_ds: str):
    if stage == "chairs":
        aug = dict(crop_size=image_size, min_scale=-0.1, max_scale=1.0, do_flip=True)
        return FlyingChairs(aug, split="training")
    if stage == "things":
        aug = dict(crop_size=image_size, min_scale=-0.4, max_scale=0.8, do_flip=True)
        return (FlyingThings3D(aug, dstype="frames_cleanpass")
                + FlyingThings3D(aug, dstype="frames_finalpass"))
    if stage == "sintel":
        aug = dict(crop_size=image_size, min_scale=-0.2, max_scale=0.6, do_flip=True)
        things = FlyingThings3D(aug, dstype="frames_cleanpass")
        clean = MpiSintel(aug, split="training", dstype="clean")
        final = MpiSintel(aug, split="training", dstype="final")
        if train_ds == "C+T+K+S+H":
            kitti = KITTI(dict(crop_size=image_size, min_scale=-0.3,
                               max_scale=0.5, do_flip=True))
            hd1k = HD1K(dict(crop_size=image_size, min_scale=-0.5,
                             max_scale=0.2, do_flip=True))
            return 100 * clean + 100 * final + 200 * kitti + 5 * hd1k + things
        return 100 * clean + 100 * final + things
    if stage == "kitti":
        aug = dict(crop_size=image_size, min_scale=-0.2, max_scale=0.4, do_flip=False)
        return KITTI(aug, split="training")
    raise ValueError(f"unknown stage {stage!r}")
