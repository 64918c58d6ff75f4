"""Serving accounting for the port's inference engine.

Counterpart of ``ServeStats`` in ``dexiraft_tpu/profiling.py``, copied as
it is (the JAX module's XLA cache and trace helpers have no place here).
On the card, "dispatch" is the host's pad, stack into pinned staging and
enqueue of one batch, and "fetch" the wait on the batch's CUDA event plus
the copy of its results to the host (serve/engine.py).
"""

from __future__ import annotations


class ServeStats:
    """Honest dispatch/fetch accounting for the throughput-mode inference
    engine (serve/engine.py).

    The engine's dispatch is asynchronous: eval_fn() enqueues device work
    and returns device tensors whose work is still queued; the only
    host-blocking operation is the fetch when a ticket leaves the
    in-flight window. So:

      * fetch_s       — wall time the host spent BLOCKED inside fetches
                        (device compute the in-flight window failed to
                        hide; the serving analog of prefetch_stall)
      * dispatch_s    — host-side pad/stack/put/enqueue time (never
                        blocks on device compute)
      * batch_latency — per-batch dispatch→fetch-complete wall time;
                        p50/p99 come from these samples
      * peak_inflight — max dispatched-unfetched batches observed
      * pad_frames    — tail filler items (dispatched for shape
                        stability, masked out of results)

    The latency sample window is BOUNDED (maxlen, default 4096 batches):
    a long-lived server accumulating every batch latency forever would
    grow without bound between /stats scrapes, and percentiles over the
    recent window are what an SLO dashboard wants anyway.
    """

    def __init__(self, maxlen: int = 4096) -> None:
        self.maxlen = maxlen
        self.reset()

    def reset(self) -> None:
        import collections

        self.batches = 0
        self.frames = 0          # real frame pairs yielded
        self.pad_frames = 0      # partial-batch tail filler (masked out)
        self.dispatch_s = 0.0
        self.fetch_s = 0.0
        self.fetches = 0
        self.peak_inflight = 0
        # warm-start carry transfer accounting (the host round-trip the
        # device-resident handoff removes): H2D = host flow_init rows
        # ridden up with a dispatch, D2H = flow_low bytes fetched to
        # host for the carry. Both stay 0 on the device-carry path.
        self.carry_h2d_bytes = 0
        self.carry_d2h_bytes = 0
        self.batch_latency_s: "collections.deque" = collections.deque(
            maxlen=self.maxlen)
        # adaptive-iteration accounting (engine adaptive mode): per-ITEM
        # samples of how many refinement updates each real (non-pad)
        # frame pair actually applied, and its last pre-freeze flow-delta
        # norm — the convergence evidence the /stats adaptive block and
        # the serve_bench frontier record serialize. Bounded like the
        # latency window, and 0-length on fixed-iteration engines.
        self.iters_used: "collections.deque" = collections.deque(
            maxlen=self.maxlen)
        self.final_delta: "collections.deque" = collections.deque(
            maxlen=self.maxlen)

    def latency_ms(self, p: float) -> float:
        import numpy as np

        if not self.batch_latency_s:
            return 0.0
        return float(np.percentile(self.batch_latency_s, p)) * 1e3

    def iters_used_pctl(self, p: float) -> float:
        import numpy as np

        if not self.iters_used:
            return 0.0
        return float(np.percentile(self.iters_used, p))

    def iters_used_mean(self) -> float:
        if not self.iters_used:
            return 0.0
        return sum(self.iters_used) / len(self.iters_used)

    def final_delta_pctl(self, p: float) -> float:
        import numpy as np

        if not self.final_delta:
            return 0.0
        return float(np.percentile(self.final_delta, p))

    def summary(self) -> str:
        return (f"{self.batches} batches / {self.frames} frame pairs "
                f"(+{self.pad_frames} tail pad), peak in-flight "
                f"{self.peak_inflight}, fetch-blocked "
                f"{self.fetch_s * 1e3:.1f} ms total, batch latency "
                f"p50 {self.latency_ms(50):.1f} / "
                f"p99 {self.latency_ms(99):.1f} ms")
