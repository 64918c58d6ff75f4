"""Metrics logger: running means -> stdout + JSONL + optional TensorBoard.

A copy of ``dexiraft_tpu/train/logger.py`` whose one host fetch per
window is a ``torch`` device-to-host copy instead of ``jax.device_get``.

Reproduces the reference Logger (train.py:90-134): running means over
SUM_FREQ steps, a formatted "[step, lr] epe 1px 3px 5px" stdout line, and
TensorBoard scalars. Adds a machine-readable metrics.jsonl (the TPU plan's
observability upgrade, SURVEY.md §5) and an iters/sec meter — the
north-star throughput metric the reference never recorded.
"""

from __future__ import annotations

import json
import os
import sys
import time
import types
from typing import Dict, Optional

import torch


def _tensorboard_without_tensorflow() -> None:
    """Have TensorBoard's writer use its own file API, not TensorFlow's.

    The writer reaches files through ``tensorboard.compat.tf``, which
    imports TensorFlow wherever it is installed: ~15 s of CPU at the start
    of every process that logs. A module named ``tensorboard.compat.notf``
    selects TensorBoard's stub instead (``tensorboard/compat/__init__.py``),
    which writes the same event files. No effect once ``tf`` has resolved
    in this process."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))


def _to_host(values: list) -> list:
    """A window of scalars (python numbers or 0-d tensors on any device)
    -> python floats, with one copy per device."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if not tensors:
        return [float(v) for v in values]
    fetched = iter(torch.stack([t.detach().to(torch.float64).reshape(())
                                for t in tensors]).cpu().tolist())
    return [next(fetched) if isinstance(v, torch.Tensor) else float(v)
            for v in values]


class Logger:
    def __init__(
        self,
        sum_freq: int = 100,
        log_dir: Optional[str] = None,
        tensorboard: bool = True,
        model_iters: int = 12,
        pipeline_stats=None,
    ):
        self.sum_freq = sum_freq
        self.log_dir = log_dir
        self.model_iters = model_iters
        # data-pipeline fault counters (data.loader.PipelineStats): read
        # at every emit so skip/restart counts are visible IN the run's
        # log stream, not only in a post-mortem — the silent-degradation
        # analog of the divergence guard's loud rollback
        self.pipeline_stats = pipeline_stats
        self.total_steps = 0
        self.running: Dict[str, list] = {}
        self._tb = None
        self._jsonl = None
        self._t0 = time.perf_counter()
        self._steps_since = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    _tensorboard_without_tensorflow()
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir)
                except Exception:
                    self._tb = None

    def push(self, metrics: Dict[str, float]) -> None:
        """Accumulate one step's metrics; emit every sum_freq steps.

        Device scalars are appended as-is — no device math, no host
        fetch — so push never blocks on the step the device is still
        running. The window is reduced on the host at _emit's one sync.
        """
        self.total_steps += 1
        self._steps_since += 1
        for k, v in metrics.items():
            self.running.setdefault(k, []).append(v)
        if self.total_steps % self.sum_freq == 0:
            self._emit()

    def _emit(self) -> None:
        n = max(self._steps_since, 1)
        # ONE device->host fetch for the whole window: the loop's sync
        # point
        host = {k: _to_host(vs) for k, vs in self.running.items()}
        means = {k: float(sum(host[k])) / n for k in host}
        dt = time.perf_counter() - self._t0
        steps_per_sec = n / dt if dt > 0 else 0.0
        means["steps/sec"] = steps_per_sec
        means["iters/sec"] = steps_per_sec * self.model_iters

        pipeline = ""
        ps = self.pipeline_stats
        if ps is not None and ps.faults:
            # cumulative counts (not per-window deltas): an operator
            # grepping any single line sees the run's full damage
            pipeline = (f"  [pipeline: {ps.skipped_samples} skipped, "
                        f"{ps.retries} retries, {ps.dropped_batches} "
                        f"batches dropped, {ps.worker_restarts} "
                        f"worker restarts]")
            for k, v in ps.as_dict().items():
                means[f"pipeline/{k}"] = v

        lr = means.get("lr", 0.0)
        keys = [k for k in ("epe", "1px", "3px", "5px", "loss") if k in means]
        body = ", ".join(f"{means[k]:10.4f}" for k in keys)
        print(f"[{self.total_steps:6d}, {lr:10.7f}] {body}  ({steps_per_sec:.2f} steps/s){pipeline}")

        self._write(means, self.total_steps)
        self.running = {}
        self._steps_since = 0
        self._t0 = time.perf_counter()

    def rewind(self, step: int) -> None:
        """Align with a trainer rollback: drop the (possibly poisoned)
        accumulation window and rewind the step counter so subsequent
        emitted/checkpointed/validated step numbers agree again."""
        self.total_steps = step
        self.running = {}
        self._steps_since = 0
        self._t0 = time.perf_counter()

    def write_dict(self, results: Dict[str, float], step: Optional[int] = None) -> None:
        """Validation results (train.py:126-131)."""
        self._write(results, self.total_steps if step is None else step)

    def _write(self, scalars: Dict[str, float], step: int) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
