"""Bucketed, batched inference engine over the test-mode forward step.

Counterpart of ``dexiraft_tpu/serve/engine.py``, without the mesh,
in-flight dispatch, device-carry and strict-guard machinery (not ported
yet):

  * shape buckets (serve.buckets): each frame pair is padded
    (replicate-edge, data.padder) to its bucket shape;
  * micro-batching: same-bucket pairs are grouped into batches of
    ``ServeConfig.batch_size``; a bucket's tail batch is filled up by
    repeating its last item, and the filler results are dropped;
  * one forward per batch on the step's device; each result is unpadded
    back to its item's own (H, W, 2).

eval_fn contract (train.step.make_eval_step): eval_fn(image1, image2,
flow_init) -> (flow_low, flow_up), batched NHWC in [0, 255], flow_init
None or (B, H/8, W/8, 2); outputs NHWC tensors or arrays. Like the JAX
engine, it passes no edge images, so v2/v3 (data-supplied edges) are
driven through the eval step directly.

Adaptive engines (``ServeConfig.adaptive``): the eval_fn takes a trailing
``iter_budget`` (None = the step's full iterations) and returns
(flow_low, flow_up, iters_used (B,), final_delta (B,))
(make_eval_step(adaptive=True)); each Result carries its row's two
values and the stats keep them as samples. A fixed engine refuses a
budget.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from dexiraft_tpu_torch.data.padder import InputPadder
from dexiraft_tpu_torch.serve.buckets import BucketRegistry

EvalFn = Callable[..., Tuple[Any, Any]]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 1
    mode: str = "sintel"         # pad placement (data.padder modes)
    stride: int = 8
    # bucket quantization granule; None -> stride (reference pad shapes)
    bucket_multiple: Optional[int] = None
    # always pass a flow_init (zeros for cold items)
    warm_start: bool = False
    # the eval_fn is adaptive: dispatches thread an iter_budget and
    # Results carry iters_used / final_delta
    adaptive: bool = False

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")


class Result(NamedTuple):
    """One frame pair's output: flow_up unpadded to the item's (H, W, 2);
    flow_low at the bucket's padded 1/8 resolution (the warm-start carry).
    iters_used / final_delta: the adaptive path's refinement updates
    applied and last 1/8-res flow-delta norm; None on fixed engines."""

    index: int
    item: Dict[str, Any]
    flow_low: np.ndarray
    flow_up: np.ndarray
    iters_used: Optional[int] = None
    final_delta: Optional[float] = None


@dataclasses.dataclass
class EngineStats:
    frames: int = 0
    batches: int = 0
    pad_frames: int = 0
    # adaptive engines: one sample per real (non-filler) row
    iters_used: List[int] = dataclasses.field(default_factory=list)
    final_delta: List[float] = dataclasses.field(default_factory=list)


def _host(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


class InferenceEngine:
    """Bucketed, batched runner of a test-mode forward step."""

    def __init__(self, eval_fn: EvalFn, config: ServeConfig = ServeConfig()):
        self.eval_fn = eval_fn
        self.config = config
        self.registry = BucketRegistry(config.stride, config.bucket_multiple)
        self.stats = EngineStats()

    def validate_item(self, index: int, item: Dict[str, Any]) -> None:
        """Reject malformed frames with a clear ValueError; the normalized
        arrays are written back into ``item``."""
        shapes = {}
        for key in ("image1", "image2"):
            im = item.get(key)
            if im is None:
                raise ValueError(f"item {index}: missing {key!r}")
            im = item[key] = np.asarray(im)
            if im.ndim != 3 or im.shape[-1] != 3:
                raise ValueError(f"item {index}: {key!r} must be (H, W, 3), "
                                 f"got shape {im.shape}")
            if not (np.issubdtype(im.dtype, np.floating)
                    or np.issubdtype(im.dtype, np.integer)):
                raise ValueError(f"item {index}: {key!r} dtype {im.dtype} "
                                 "is not a real numeric type")
            shapes[key] = im.shape
        if shapes["image1"] != shapes["image2"]:
            raise ValueError(f"item {index}: image1 {shapes['image1']} and "
                             f"image2 {shapes['image2']} must agree")
        fi = item.get("flow_init")
        if fi is not None:
            fi = item["flow_init"] = np.asarray(fi, np.float32)
            if fi.ndim != 3 or fi.shape[-1] != 2:
                raise ValueError(f"item {index}: flow_init must be "
                                 f"(H/{self.config.stride}, W/"
                                 f"{self.config.stride}, 2), got {fi.shape}")

    def _run(self, bucket: Tuple[int, int],
             group: List[Tuple[int, Dict[str, Any]]], mode: str,
             iter_budget: Optional[int] = None) -> List[Result]:
        cfg = self.config
        if iter_budget is not None and not cfg.adaptive:
            raise ValueError(
                "iter_budget passed to a fixed-iteration engine — build "
                "it with ServeConfig(adaptive=True) and an adaptive "
                "eval_fn (make_eval_step(adaptive=True))")
        padders = [InputPadder(it["image1"].shape, mode=mode,
                               stride=cfg.stride, target=bucket)
                   for _, it in group]
        im1 = [p.pad(np.asarray(it["image1"], np.float32))[0]
               for p, (_, it) in zip(padders, group)]
        im2 = [p.pad(np.asarray(it["image2"], np.float32))[0]
               for p, (_, it) in zip(padders, group)]
        fill = cfg.batch_size - len(group)
        if fill:  # tail: repeat the last item up to the batch shape
            im1 += [im1[-1]] * fill
            im2 += [im2[-1]] * fill
            self.stats.pad_frames += fill
        fi = None
        inits = [it.get("flow_init") for _, it in group]
        if cfg.warm_start or any(x is not None for x in inits):
            bh, bw = bucket
            fi = np.zeros((cfg.batch_size, bh // cfg.stride,
                           bw // cfg.stride, 2), np.float32)
            for row, init in enumerate(inits):
                if init is not None:
                    fi[row] = init
        if cfg.adaptive:
            low, up, iu, fd = self.eval_fn(np.stack(im1), np.stack(im2), fi,
                                           iter_budget)
            iu = [int(x) for x in _host(iu)[:len(group)]]
            fd = [float(x) for x in _host(fd)[:len(group)]]
            self.stats.iters_used += iu
            self.stats.final_delta += fd
        else:
            low, up = self.eval_fn(np.stack(im1), np.stack(im2), fi)
            iu = fd = [None] * len(group)
        low, up = _host(low), _host(up)
        self.stats.batches += 1
        self.stats.frames += len(group)
        # rows past len(group) are the tail filler: dropped here
        return [Result(idx, it, low[row], p.unpad(up[row]), iu[row], fd[row])
                for row, ((idx, it), p) in enumerate(zip(group, padders))]

    def stream(self, items: Iterable[Dict[str, Any]],
               mode: Optional[str] = None,
               iter_budget: Optional[int] = None) -> Iterator[Result]:
        """Run every item through the engine; yields Results as their
        batches complete (bucket-grouped, not input order: each Result
        carries its original index). ``iter_budget`` (adaptive engines
        only) caps every batch's refinement iterations."""
        mode = mode or self.config.mode
        pending: Dict[Tuple[int, int], List[Tuple[int, Dict[str, Any]]]] = {}
        for index, item in enumerate(items):
            self.validate_item(index, item)
            h, w = item["image1"].shape[:2]
            bucket = self.registry.bucket_for(h, w)
            pending.setdefault(bucket, []).append((index, item))
            if len(pending[bucket]) == self.config.batch_size:
                yield from self._run(bucket, pending.pop(bucket), mode,
                                     iter_budget)
        for bucket in sorted(pending):  # partial tails, deterministic order
            yield from self._run(bucket, pending.pop(bucket), mode,
                                 iter_budget)

    def run_batch(self, items: List[Dict[str, Any]],
                  mode: Optional[str] = None,
                  iter_budget: Optional[int] = None) -> List[Result]:
        """One batch of same-bucket items, Results in input order;
        ``iter_budget`` as in :meth:`stream`."""
        if not items:
            return []
        if len(items) > self.config.batch_size:
            raise ValueError(f"{len(items)} items > batch_size "
                             f"{self.config.batch_size}")
        for index, item in enumerate(items):
            self.validate_item(index, item)
        buckets = {self.registry.bucket_for(*it["image1"].shape[:2])
                   for it in items}
        if len(buckets) > 1:
            raise ValueError(f"run_batch items span buckets {buckets}")
        return self._run(buckets.pop(), list(enumerate(items)),
                         mode or self.config.mode, iter_budget)
