"""Benchmark submission writers (evaluate.py:22-77).

Counterpart of ``dexiraft_tpu/eval/submission.py``.

Sintel: per-sequence ordered inference with optional WARM START — the
previous frame's low-res flow is propagated by forward_interpolate and
fed as flow_init (evaluate.py:40-44). Unlike the reference (scipy
griddata on host, a device round-trip per frame) and the JAX package
(which fetches flow_low and splats on the host), propagation runs on
flow_low's own device (dexiraft_tpu_torch.eval.interpolate), and the
splatted carry goes back into the next forward without leaving it.

KITTI: per-frame 16-bit PNG encoding through the port's own PNG codec.

Batching (`batch_size>1`): KITTI frames are independent and stream
through the inference engine (dexiraft_tpu_torch.serve) like a
validation set. Sintel's warm start is sequential WITHIN a sequence but
independent ACROSS sequences, so the batched path runs `batch_size`
sequences abreast: position j of each sequence rides one batch, and
each row carries ITS OWN flow_init (the engine materializes zeros for
rows whose sequence just started or already ended — numerically the
cold start). The engine runs with its device carry on: each row's
flow_low stays where the forward left it, is splatted there, and goes
back as that row's flow_init. Frame j+1 still waits for frame j's
flow_low, but the forward amortizes its prelude over a whole batch of
sequences.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dexiraft_tpu_torch.data.flow_io import write_flo, write_flow_kitti
from dexiraft_tpu_torch.data.padder import InputPadder
from dexiraft_tpu_torch.eval.interpolate import forward_interpolate
from dexiraft_tpu_torch.eval.validate import _fetch

EvalFn = Callable[..., Tuple[np.ndarray, np.ndarray]]


def _write_sintel(output_path: str, dstype: str, sequence: str,
                  frame: int, flow: np.ndarray) -> None:
    out_dir = osp.join(output_path, dstype, sequence)
    os.makedirs(out_dir, exist_ok=True)
    write_flo(osp.join(out_dir, f"frame{frame + 1:04d}.flo"), flow)


def _splat(flow_low) -> torch.Tensor:
    """forward_interpolate of one (h, w, 2) flow_low, on its device (a
    host array splats on the CPU)."""
    return forward_interpolate(torch.as_tensor(flow_low))


def _sequence_indices(ds) -> "Dict[str, List[int]]":
    """Dataset index lists per Sintel sequence, in frame order. Reads
    the dataset's extra_info table (never decodes images)."""
    seqs: Dict[str, List[int]] = {}
    for i, (sequence, _frame) in enumerate(ds.extra_info):
        seqs.setdefault(sequence, []).append(i)
    return seqs


def _sintel_batched(eval_fn: EvalFn, ds, dstype: str, output_path: str,
                    warm_start: bool, batch_size: int, engine=None,
                    device=None) -> None:
    """`batch_size` sequences abreast with per-item flow_init carry."""
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig

    if engine is None:
        engine = InferenceEngine(
            eval_fn, ServeConfig(batch_size=batch_size, mode="sintel",
                                 warm_start=warm_start,
                                 device_carry=warm_start),
            device=device)
    if not warm_start:
        # no carry -> frames are independent; the fully pipelined
        # stream() path (async in-flight dispatch) beats the
        # position-synchronous loop below
        def samples():
            for i in range(len(ds)):
                s = ds.sample(i)
                yield {"image1": s["image1"], "image2": s["image2"],
                       "extra_info": s["extra_info"]}

        for r in engine.stream(samples(), mode="sintel"):
            sequence, frame = r.item["extra_info"]
            _write_sintel(output_path, dstype, sequence, frame, r.flow_up)
        return
    batch_size = engine.config.batch_size  # group sequences to its shape
    seqs = list(_sequence_indices(ds).items())
    for g in range(0, len(seqs), batch_size):
        group = seqs[g:g + batch_size]
        carry: Dict[str, Optional[torch.Tensor]] = {s: None for s, _ in group}
        for pos in range(max(len(idxs) for _, idxs in group)):
            items, names = [], []
            for sequence, idxs in group:
                if pos >= len(idxs):
                    continue  # this sequence already ended; row drops out
                s = ds.sample(idxs[pos])
                items.append({"image1": s["image1"], "image2": s["image2"],
                              "flow_init": carry[sequence],
                              "extra_info": s["extra_info"]})
                names.append(sequence)
            for sequence, r in zip(names, engine.run_batch(items)):
                _, frame = r.item["extra_info"]
                _write_sintel(output_path, dstype, sequence, frame, r.flow_up)
                carry[sequence] = _splat(r.flow_low)


def create_sintel_submission(
    eval_fn: EvalFn,
    output_path: str = "sintel_submission",
    warm_start: bool = False,
    datasets=None,
    batch_size: int = 1,
    engine=None,
    device: Optional[Union[str, torch.device]] = None,
) -> None:
    """Write .flo predictions for the Sintel test split (evaluate.py:22-54).

    eval_fn(image1, image2, flow_init=...) -> (flow_low, flow_up), built
    with iters=32. batch_size>1 (or a caller-built engine) runs sequences
    abreast through the serving engine (module docstring) and needs a
    dataset exposing `extra_info` (FlowDataset does). ``device``: where
    the engine this function builds keeps the warm-start carry (the eval
    step's device; None keeps it on the CPU). A caller-built engine for
    warm start needs ``device_carry=True`` and its own device.
    """
    if datasets is None:
        from dexiraft_tpu_torch.data.datasets import MpiSintel
        datasets = {d: MpiSintel(None, split="test", dstype=d)
                    for d in ("clean", "final")}

    if batch_size > 1 or engine is not None:
        for dstype, ds in datasets.items():
            _sintel_batched(eval_fn, ds, dstype, output_path,
                            warm_start, batch_size, engine=engine,
                            device=device)
        return

    for dstype, ds in datasets.items():
        flow_prev, sequence_prev = None, None
        for i in range(len(ds)):
            s = ds.sample(i)
            sequence, frame = s["extra_info"]
            if sequence != sequence_prev:
                flow_prev = None

            padder = InputPadder(s["image1"].shape)
            im1, im2 = padder.pad(s["image1"][None], s["image2"][None])
            flow_low, flow_up = eval_fn(im1, im2, flow_init=flow_prev)
            # the per-frame fetch is the point of this loop
            flow = padder.unpad(_fetch(flow_up))[0]

            if warm_start:
                flow_prev = _splat(flow_low[0])[None]

            _write_sintel(output_path, dstype, sequence, frame, flow)
            sequence_prev = sequence


def create_kitti_submission(
    eval_fn: EvalFn,
    output_path: str = "kitti_submission",
    dataset=None,
    batch_size: int = 1,
    engine=None,
) -> None:
    """Write 16-bit PNG predictions for the KITTI test split
    (evaluate.py:58-77); eval_fn built with iters=24. batch_size>1
    streams the independent frames through the serving engine."""
    if dataset is None:
        from dexiraft_tpu_torch.data.datasets import KITTI
        dataset = KITTI(None, split="testing")
    os.makedirs(output_path, exist_ok=True)

    if batch_size > 1 or engine is not None:
        if engine is None:
            from dexiraft_tpu_torch.serve.engine import (InferenceEngine,
                                                         ServeConfig)

            engine = InferenceEngine(
                eval_fn, ServeConfig(batch_size=batch_size, mode="kitti"))
        samples = (dataset.sample(i) for i in range(len(dataset)))
        for r in engine.stream(samples, mode="kitti"):
            (frame_id,) = r.item["extra_info"]
            write_flow_kitti(osp.join(output_path, frame_id), r.flow_up)
        return

    for i in range(len(dataset)):
        s = dataset.sample(i)
        (frame_id,) = s["extra_info"]
        padder = InputPadder(s["image1"].shape, mode="kitti")
        im1, im2 = padder.pad(s["image1"][None], s["image2"][None])
        _, flow_up = eval_fn(im1, im2)
        flow = padder.unpad(_fetch(flow_up))[0]
        write_flow_kitti(osp.join(output_path, frame_id), flow)
