"""Dataset-metric validators (evaluate.py:81-210).

Counterpart of ``dexiraft_tpu/eval/validate.py``. Each validator consumes
`eval_fn(image1, image2) -> (flow_low, flow_up)` — a test-mode forward
built with the reference iteration counts (chairs/kitti 24, sintel 32)
by dexiraft_tpu_torch.train.step.make_eval_step, whose flows are device
tensors — and a dataset, and returns the reference's metric dict.
Metrics accumulate in numpy on host: each frame's flow is fetched once,
explicitly (`_fetch`), where the JAX package calls jax.device_get.

Batching: `batch_size=1` (the default) is the reference behavior — one
padded frame pair per forward, synchronous fetch. `batch_size>1`
streams the dataset through the throughput-mode inference engine
(dexiraft_tpu_torch.serve): same replicate-edge pad shapes (bucket
multiple == stride), same eval-mode forward, so the metrics match the
per-image path to fp32 tolerance; frames are just grouped, dispatched
ahead, and fetched late. Every per-frame metric is order-invariant under
the engine's bucket-grouped completion order (means over concatenated
per-frame values).

validate_hd1k fixes the reference's undefined-variable crash
(evaluate.py:197 references valid_gt that was never read) by actually
using the dataset's sparse valid mask.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from dexiraft_tpu_torch.data.padder import InputPadder

EvalFn = Callable[..., Tuple[np.ndarray, np.ndarray]]


def _fetch(x) -> np.ndarray:
    """The one device->host copy of a flow (numpy passes through)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _epe(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum((pred - gt) ** 2, axis=-1))


def _run(eval_fn: EvalFn, img1: np.ndarray, img2: np.ndarray,
         mode: str) -> np.ndarray:
    """Pad -> forward -> unpad; returns (H, W, 2) upsampled flow."""
    padder = InputPadder(img1.shape, mode=mode)
    p1, p2 = padder.pad(img1[None], img2[None])
    _, flow_up = eval_fn(p1, p2)
    # this per-frame sync is the reference behavior
    return padder.unpad(_fetch(flow_up))[0]


def _frame_flows(eval_fn: EvalFn, dataset, mode: str,
                 batch_size: int = 1, engine=None) -> Iterator[Tuple[dict, np.ndarray]]:
    """Yield (sample, unpadded flow) for every dataset frame.

    batch_size==1 without an engine is the reference per-image loop;
    otherwise frames stream through the serving engine (completion
    order; metrics below are order-invariant).
    """
    if engine is None and batch_size == 1:
        for i in range(len(dataset)):
            s = dataset.sample(i)
            yield s, _run(eval_fn, s["image1"], s["image2"], mode)
        return
    if engine is None:
        from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig

        engine = InferenceEngine(eval_fn,
                                 ServeConfig(batch_size=batch_size, mode=mode))
    samples = (dataset.sample(i) for i in range(len(dataset)))
    for r in engine.stream(samples, mode=mode):
        yield r.item, r.flow_up


def validate_chairs(eval_fn: EvalFn, dataset=None, *, batch_size: int = 1,
                    engine=None) -> Dict[str, float]:
    """FlyingChairs val EPE (evaluate.py:81-98; iters=24 in the caller)."""
    if dataset is None:
        from dexiraft_tpu_torch.data.datasets import FlyingChairs
        dataset = FlyingChairs(None, split="validation")
    epe_all = []
    for s, flow in _frame_flows(eval_fn, dataset, "sintel", batch_size, engine):
        epe_all.append(_epe(flow, s["flow"]).ravel())
    epe = float(np.concatenate(epe_all).mean())
    print(f"Validation Chairs EPE: {epe:.3f}")
    return {"chairs": epe}


def validate_sintel(eval_fn: EvalFn, datasets=None, *, batch_size: int = 1,
                    engine=None) -> Dict[str, float]:
    """Sintel train-split clean+final EPE / px accuracies (evaluate.py:102-133)."""
    if datasets is None:
        from dexiraft_tpu_torch.data.datasets import MpiSintel
        datasets = {d: MpiSintel(None, split="training", dstype=d)
                    for d in ("clean", "final")}
    results: Dict[str, float] = {}
    for dstype, ds in datasets.items():
        epe_all = []
        for s, flow in _frame_flows(eval_fn, ds, "sintel", batch_size, engine):
            epe_all.append(_epe(flow, s["flow"]).ravel())
        epe = np.concatenate(epe_all)
        results[dstype] = float(epe.mean())
        results[f"{dstype}_px1"] = float((epe < 1).mean())
        results[f"{dstype}_px3"] = float((epe < 3).mean())
        results[f"{dstype}_px5"] = float((epe < 5).mean())
        print(f"Validation ({dstype}) EPE: {results[dstype]:.3f}, "
              f"1px: {results[f'{dstype}_px1']:.3f}, "
              f"3px: {results[f'{dstype}_px3']:.3f}, "
              f"5px: {results[f'{dstype}_px5']:.3f}")
    return results


def _sparse_metrics(eval_fn: EvalFn, dataset, mode: str,
                    batch_size: int = 1, engine=None) -> Tuple[float, float, int]:
    """Sparse EPE over valid pixels + F1 (= % of valid pixels with epe>3
    AND epe/mag>5%, the KITTI outlier definition, evaluate.py:158-166).

    A frame with ZERO valid pixels would make `epe[val].mean()` NaN and
    silently poison the dataset-level mean (np.mean propagates it);
    such frames are skipped and counted — the third return — so the
    dataset EPE stays a mean over frames that actually have ground
    truth.
    """
    epe_list, out_list, skipped = [], [], 0
    for s, flow in _frame_flows(eval_fn, dataset, mode, batch_size, engine):
        val = s["valid"].ravel() >= 0.5
        if not val.any():
            skipped += 1
            continue
        epe = _epe(flow, s["flow"]).ravel()
        mag = np.sqrt(np.sum(s["flow"] ** 2, axis=-1)).ravel()
        out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-12)) > 0.05)
        epe_list.append(epe[val].mean())
        out_list.append(out[val])
    if not epe_list:
        raise ValueError("every frame had an empty valid mask — no sparse "
                         "metrics to report")
    return (float(np.mean(epe_list)),
            100.0 * float(np.concatenate(out_list).mean()),
            skipped)


def _sparse_summary(name: str, epe: float, f1: float, skipped: int) -> None:
    note = f" ({skipped} empty-mask frames skipped)" if skipped else ""
    print(f"Validation {name}: {epe:.3f}, {f1:.3f}{note}")


def validate_kitti(eval_fn: EvalFn, dataset=None, *, batch_size: int = 1,
                   engine=None) -> Dict[str, float]:
    """KITTI-15 train-split EPE + F1 (evaluate.py:137-172; iters=24)."""
    if dataset is None:
        from dexiraft_tpu_torch.data.datasets import KITTI
        dataset = KITTI(None, split="training")
    epe, f1, skipped = _sparse_metrics(eval_fn, dataset, "kitti",
                                       batch_size, engine)
    _sparse_summary("KITTI", epe, f1, skipped)
    return {"kitti-epe": epe, "kitti-f1": f1}


def validate_hd1k(eval_fn: EvalFn, dataset=None, *, batch_size: int = 1,
                  engine=None) -> Dict[str, float]:
    """HD1K sparse EPE + F1 — the reference's version crashes on an
    undefined variable (evaluate.py:197); fixed here."""
    if dataset is None:
        from dexiraft_tpu_torch.data.datasets import HD1K
        dataset = HD1K(None)
    epe, f1, skipped = _sparse_metrics(eval_fn, dataset, "kitti",
                                       batch_size, engine)
    _sparse_summary("HD1K", epe, f1, skipped)
    return {"hd1k-epe": epe, "hd1k-f1": f1}


def validate_edgesum(eval_fn: EvalFn, dataset=None, *, batch_size: int = 1,
                     engine=None) -> Dict[str, float]:
    """v1-lineage summed-fusion validation (alt/evaluate_1.py:84-94):
    the model runs on the image pair AND the edge-image pair; the two
    upsampled flows are summed before EPE. dataset must yield edge pairs
    (EdgePairDataset samples: image1/2, edges1/2, flow) — there is no
    default dataset, since the edge tree location is user-supplied.

    Batched: each frame becomes TWO engine items (image pair, edge pair)
    that batch and pipeline like any others; the flows re-join by frame
    index on fetch."""
    if dataset is None:
        raise ValueError(
            "validate_edgesum needs an edge-pair dataset (build one with "
            "EdgePairDataset.from_parallel_tree); it has no default")
    if engine is None and batch_size == 1:
        epe_all = []
        for i in range(len(dataset)):
            s = dataset.sample(i)
            im_flow = _run(eval_fn, s["image1"], s["image2"], "sintel")
            em_flow = _run(eval_fn, s["edges1"], s["edges2"], "sintel")
            epe_all.append(_epe(im_flow + em_flow, s["flow"]).ravel())
    else:
        if engine is None:
            from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig

            engine = InferenceEngine(
                eval_fn, ServeConfig(batch_size=batch_size, mode="sintel"))

        def both_passes():
            for i in range(len(dataset)):
                s = dataset.sample(i)
                yield {"image1": s["image1"], "image2": s["image2"],
                       "flow": s["flow"], "pair": i}
                yield {"image1": s["edges1"], "image2": s["edges2"],
                       "pair": i}

        halves: Dict[int, np.ndarray] = {}
        epe_all = []
        for r in engine.stream(both_passes(), mode="sintel"):
            pair = r.item["pair"]
            if pair not in halves:
                halves[pair] = r
                continue
            other = halves.pop(pair)
            gt = r.item.get("flow", other.item.get("flow"))
            epe_all.append(_epe(r.flow_up + other.flow_up, gt).ravel())
        if halves:  # must hold even under python -O
            raise RuntimeError(
                f"engine yielded only one pass for frames {sorted(halves)}")
    epe = float(np.concatenate(epe_all).mean())
    print(f"Validation (edge-sum fusion) EPE: {epe:.3f}")
    return {"edgesum": epe}


VALIDATORS = {
    "chairs": validate_chairs,
    "sintel": validate_sintel,
    "kitti": validate_kitti,
    "hd1k": validate_hd1k,
    "edgesum": validate_edgesum,
}


def run_validation(name: str, eval_fn: EvalFn, dataset=None, *,
                   batch_size: int = 1, engine=None) -> Dict[str, float]:
    return VALIDATORS[name](eval_fn, dataset,
                            batch_size=batch_size, engine=engine)
