"""Batches copied to the device ahead of the step that consumes them.

Counterpart of ``dexiraft_tpu/data/prefetch.py``. The ``Loader`` already
decodes ahead into host memory; this layer takes the host-to-device copy
off the step's path. On a CUDA device each batch is copied into pinned
host memory and moved with ``non_blocking=True`` on a side stream, with an
event recorded after the copy; the consumer's stream waits on that event
before it uses the batch (and the tensors are marked as used on that
stream, so the allocator does not reuse them early). ``depth`` batches
are kept in flight behind the one handed out (2 is double buffering; 0
copies each batch synchronously when it is asked for). On the CPU the
batch is wrapped as tensors without a copy.

Stall accounting (``PrefetchStats``, as in the JAX package): after the
warm fill, time spent waiting for the HOST iterator is time the device
could have been starved; the copies themselves are not counted.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch


class PrefetchStats:
    """Host-side starvation accounting for a DevicePrefetcher."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        """Zero the counters (warm_fill_s included)."""
        self.batches = 0  # batches yielded (after warm-fill)
        self.stall_s = 0.0  # time blocked on the HOST iterator
        self.stalls = 0  # yields on which the host made us wait
        self.warm_fill_s = 0.0  # initial fill (excluded from stall_s)

    @property
    def stall_per_batch_s(self) -> float:
        return self.stall_s / self.batches if self.batches else 0.0

    def summary(self, pipeline_stats=None) -> str:
        base = (f"{self.batches} batches, prefetch stall "
                f"{self.stall_s * 1e3:.1f} ms total "
                f"({self.stall_per_batch_s * 1e3:.3f} ms/batch, "
                f"{self.stalls} stalled yields; warm fill "
                f"{self.warm_fill_s * 1e3:.1f} ms)")
        if pipeline_stats is not None and pipeline_stats.faults:
            base += f"; {pipeline_stats.summary()}"
        return base


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class DevicePrefetcher:
    """Iterate device-resident batches (dicts of tensors), keeping
    ``depth`` copies in flight (module docstring)."""

    # a host next() faster than this is "the batch was already decoded
    # and waiting": only longer waits count as a stalled yield
    STALL_EPS_S = 1e-3

    def __init__(self, iterable: Iterable[Dict[str, Any]],
                 device: Union[str, torch.device] = "cuda", *, depth: int = 2,
                 pipeline_stats=None):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.device = torch.device(device)
        self.depth = depth
        self.stats = PrefetchStats()
        if pipeline_stats is None:
            pipeline_stats = getattr(iterable, "stats", None)
        self.pipeline_stats = (pipeline_stats
                               if hasattr(pipeline_stats, "faults") else None)
        self._cuda = self.device.type == "cuda"
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device=self.device) if self._cuda else None)
        self._it = iter(iterable)
        self._buf: "collections.deque" = collections.deque()
        self._warm = False
        self._exhausted = False

    def _put(self, batch: Dict[str, Any]):
        host = {k: _tensor(v) for k, v in batch.items()}
        if not self._cuda:
            return host, None
        host = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(self._stream):
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return dev, ready

    def _pull(self) -> bool:
        """Start one more batch's copy; False when the host iterator is
        exhausted. Only the host iterator's next() is timed."""
        if self._exhausted:
            return False
        t0 = time.perf_counter()
        try:
            batch = next(self._it)
        except StopIteration:
            self._exhausted = True
            return False
        dt = time.perf_counter() - t0
        if self._warm:
            self.stats.stall_s += dt
            if dt > self.STALL_EPS_S:
                self.stats.stalls += 1
        else:
            self.stats.warm_fill_s += dt
        self._buf.append(self._put(batch))
        return True

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if not self._warm:
            # depth + 1, so the first yield already leaves `depth` in flight
            for _ in range(self.depth + 1):
                self._pull()
            self._warm = True
        else:
            self._pull()
        if not self._buf:
            raise StopIteration
        self.stats.batches += 1
        batch, ready = self._buf.popleft()
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for v in batch.values():
                v.record_stream(stream)
        return batch

    def summary(self) -> str:
        """One line: prefetch stall accounting + any pipeline faults."""
        return self.stats.summary(self.pipeline_stats)

    def close(self) -> None:
        """Close the host iterator (a Loader generator stops its feeder and
        pool on close) and drop the buffered batches."""
        close = getattr(self._it, "close", None)
        if close is not None:
            close()
        self._buf.clear()
        self._exhausted = True

