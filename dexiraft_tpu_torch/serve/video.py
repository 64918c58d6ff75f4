"""Streaming video engine: cross-frame feature reuse over the split model.

Counterpart of ``dexiraft_tpu/serve/video.py``. For a chained video
stream the pair engine encodes both frames of every pair, though frame
t+1's ``fmap1`` is frame t's ``fmap2``. This engine serves the chain
through the split model instead:

  * ``encode_fn`` (train.step.make_encode_step) runs once per new frame;
    the previous frame's feature dict comes from the device-resident
    session carry (serve.sessions.DeviceSessionStore), so a warm stream
    encodes each frame once where chained pairs encode it twice;
  * ``refine_fn`` (train.step.make_refine_step) refines from the two
    feature dicts with an always-materialized flow_init (zeros = cold);
  * ``splat_fn`` forward-interpolates flow_low into the next pair's seed
    on the device (eval.interpolate.forward_interpolate), so the per-frame
    host<->device traffic is one frame up and one flow_up down.

Chunk semantics: a chunk of T same-geometry frames under one session id
yields T flows when the session has a carry (pairs (carry, f_0), (f_0,
f_1), ..., (f_{T-2}, f_{T-1})) and T-1 cold; a cold T=1 chunk yields no
flow and only primes the carry. Frames go one at a time, so memory is
constant in T; a bucket change mid-stream restarts that stream cold.

The JAX engine also watches for XLA retraces (analysis/guards.py
RecompileWatch, its ``strict`` mode). The port has no counterpart yet
(ROADMAP A13), so ``strict=True`` is refused. ``warmup`` builds the
kernels and warms cuDNN for each geometry. The chunk logic runs on numpy
stubs without a model, as the JAX engine's does.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from dexiraft_tpu_torch.data.padder import InputPadder
from dexiraft_tpu_torch.serve.buckets import bucket_shape
from dexiraft_tpu_torch.serve.locks import OrderedLock
from dexiraft_tpu_torch.serve.sessions import DeviceSessionStore

EncodeFn = Callable[[Any], Dict[str, Any]]
RefineFn = Callable[[Dict[str, Any], Dict[str, Any], Any], Tuple[Any, ...]]
SplatFn = Callable[[Any], Any]

_PCTL_WINDOW = 4096  # bounded latency window


class StreamOverloaded(RuntimeError):
    """Raised at admission when too many chunks are already queued on the
    engine lock."""


def _to_host(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


class ChunkResult(NamedTuple):
    """One processed chunk: host flows (each unpadded (H, W, 2)), and what
    served it."""

    flows: List[np.ndarray]
    warm: bool                  # the session carry seeded the first pair
    bucket: Tuple[int, int]
    frames_in: int
    # adaptive engines only: mean refinement iterations over the pairs
    iters_used: Optional[float] = None


class VideoEngine:
    """Session-carried streaming driver over the split encode/refine
    steps, one chunk at a time (``_lock``): a stream's frames depend on
    each other, and one in-order device stream keeps it simple."""

    def __init__(
        self,
        encode_fn: EncodeFn,
        refine_fn: RefineFn,
        splat_fn: Optional[SplatFn] = None,
        *,
        sessions: Optional[DeviceSessionStore] = None,
        put: Optional[Callable[[Any], Any]] = None,
        mode: str = "sintel",
        stride: int = 8,
        bucket_multiple: Optional[int] = None,
        max_chunk_frames: int = 64,
        max_pending_chunks: int = 8,
        adaptive: bool = False,
        strict: bool = False,
    ):
        if max_chunk_frames < 1:
            raise ValueError(
                f"max_chunk_frames must be >= 1, got {max_chunk_frames}")
        if max_pending_chunks < 1:
            raise ValueError(
                f"max_pending_chunks must be >= 1, got {max_pending_chunks}")
        if strict:
            raise ValueError(
                "strict=True is not supported by the PyTorch port yet: the "
                "JAX engine's strict mode fails on an XLA retrace "
                "(analysis/guards.py RecompileWatch), and the port's "
                "counterpart, a budget on CUDA-graph recaptures and host "
                "syncs, is ROADMAP item A13")
        self.encode_fn = encode_fn
        self.refine_fn = refine_fn
        # identity splat: the raw flow_low seeds the next pair (stub tests);
        # on the card, the port's forward_interpolate on the device
        self.splat_fn = splat_fn if splat_fn is not None else (lambda x: x)
        self.sessions = sessions
        # identity put suits numpy stubs; torch callers pass a .to(device)
        self.put = put if put is not None else (lambda x: x)
        self.mode = mode
        self.stride = stride
        self.bucket_multiple = bucket_multiple
        self.max_chunk_frames = max_chunk_frames
        self.max_pending_chunks = max_pending_chunks
        # adaptive contract: refine_fn returns (flow_low, flow_up,
        # iters_used, final_delta) and rides its full iteration budget
        self.adaptive = adaptive
        # ranked as in LOCK_ORDER: a chunk's frame loop (_lock) nests the
        # stats lock and the session store's; stats get their own lock so
        # a scrape never waits for a live chunk
        self._lock = OrderedLock("serve.video.chunk")
        self._inflight_lock = OrderedLock("serve.video.inflight")
        self._inflight = 0
        self._stats_lock = OrderedLock("serve.video.stats")
        self._warm_buckets: set = set()
        self._zero_fi: Dict[Tuple[int, int], Any] = {}
        self.chunks = 0
        self.frames_in = 0
        self.flows_out = 0
        self.warm_chunks = 0
        self.cold_chunks = 0
        self.flow_latency_s: "collections.deque" = collections.deque(
            maxlen=_PCTL_WINDOW)
        self.iters_used: "collections.deque" = collections.deque(
            maxlen=_PCTL_WINDOW)
        self.final_delta: "collections.deque" = collections.deque(
            maxlen=_PCTL_WINDOW)

    # ---- input validation ----------------------------------------------

    def validate_frames(self, frames: Any) -> np.ndarray:
        """Reject a malformed chunk with a clear ValueError."""
        frames = np.asarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"frames must be rank-4 (T, H, W, 3) RGB, got shape "
                f"{frames.shape}")
        if frames.shape[0] < 1:
            raise ValueError("frames chunk is empty (T must be >= 1)")
        if frames.shape[0] > self.max_chunk_frames:
            raise ValueError(
                f"frames chunk has T={frames.shape[0]} frames; this "
                f"engine caps chunks at {self.max_chunk_frames} — split "
                f"the stream into smaller chunks (the session carry keeps "
                f"them warm across calls)")
        if not (np.issubdtype(frames.dtype, np.floating)
                or np.issubdtype(frames.dtype, np.integer)):
            raise ValueError(
                f"frames dtype must be a real numeric type castable to "
                f"float32, got {frames.dtype}")
        return frames

    # ---- core ----------------------------------------------------------

    def _zero_flow_init(self, h8: int, w8: int):
        """Cached cold seed at the bucket's 1/8 shape: flow_init is always
        materialized (zeros = no warm start)."""
        key = (h8, w8)
        fi = self._zero_fi.get(key)
        if fi is None:
            fi = self._zero_fi[key] = self.put(
                np.zeros((1, h8, w8, 2), np.float32))
        return fi

    def process_chunk(self, session_id: Optional[str],
                      frames: Any) -> ChunkResult:
        """Run one chunk of same-geometry frames through the stream.

        With a ``session_id`` (and a session store) the carry persists
        across chunks: the previous chunk's last frame pairs with this
        chunk's first, and the newest frame's features and splatted seed
        are stored back on the device. ``session_id=None`` (or "")
        processes the chunk standalone: cold, nothing stored.
        """
        session_id = session_id or None
        frames = self.validate_frames(frames)
        t_frames, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        bucket = bucket_shape(h, w, self.stride, self.bucket_multiple)
        padder = InputPadder((h, w, 3), mode=self.mode, stride=self.stride,
                             target=bucket)
        h8, w8 = bucket[0] // self.stride, bucket[1] // self.stride

        with self._inflight_lock:
            if self._inflight >= self.max_pending_chunks:
                raise StreamOverloaded(
                    f"{self._inflight} chunk(s) already queued "
                    f"(max_pending_chunks={self.max_pending_chunks}); "
                    f"retry with backoff")
            self._inflight += 1
        try:
            return self._process_locked(session_id, frames, t_frames,
                                        bucket, padder, h8, w8)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _process_locked(self, session_id, frames, t_frames, bucket, padder,
                        h8, w8) -> ChunkResult:
        with self._lock:
            feats_prev = flow_init = None
            warm = False
            if session_id is not None and self.sessions is not None:
                carry = self.sessions.get(session_id, bucket)
                if carry is not None:
                    feats_prev, flow_init = carry
                    warm = True

            flows: List[np.ndarray] = []
            chunk_iters: List[int] = []
            for i in range(t_frames):
                t0 = time.perf_counter()
                padded = padder.pad(np.asarray(frames[i], np.float32))[0][None]
                feats = self.encode_fn(self.put(padded))
                if feats_prev is not None:
                    if flow_init is None:
                        flow_init = self._zero_flow_init(h8, w8)
                    if self.adaptive:
                        flow_low, flow_up, pair_iters, pair_delta = \
                            self.refine_fn(feats_prev, feats, flow_init)
                        iu = int(_to_host(pair_iters)[0])
                        fd = float(_to_host(pair_delta)[0])
                    else:
                        flow_low, flow_up = self.refine_fn(
                            feats_prev, feats, flow_init)
                    flow_init = self.splat_fn(flow_low)
                    flows.append(padder.unpad(_to_host(flow_up)[0]))
                    with self._stats_lock:
                        self.flow_latency_s.append(time.perf_counter() - t0)
                        if self.adaptive:
                            chunk_iters.append(iu)
                            self.iters_used.append(iu)
                            self.final_delta.append(fd)
                feats_prev = feats

            if session_id is not None and self.sessions is not None:
                self.sessions.put(
                    session_id, bucket, feats_prev,
                    flow_init if flow_init is not None
                    else self._zero_flow_init(h8, w8))

            with self._stats_lock:
                self.chunks += 1
                self.frames_in += t_frames
                self.flows_out += len(flows)
                if warm:
                    self.warm_chunks += 1
                else:
                    self.cold_chunks += 1
                self._warm_buckets.add(bucket)
        mean_iters = (sum(chunk_iters) / len(chunk_iters)
                      if chunk_iters else None)
        return ChunkResult(flows, warm, bucket, t_frames, mean_iters)

    # ---- lifecycle / observability -------------------------------------

    def inflight(self) -> int:
        """Chunks admitted but unanswered (queued on the engine lock or in
        their frame loop)."""
        with self._inflight_lock:
            return self._inflight

    def warmup(self, geometries) -> None:
        """Drive a 2-frame zero chunk per "HxW" geometry (the first call
        builds the kernels and lets cuDNN pick its algorithms for these
        shapes). Nothing is stored and the counters are reset: warmup is
        not traffic."""
        for geom in geometries:
            h, w = (int(v) for v in geom.split("x"))
            self.process_chunk(None, np.zeros((2, h, w, 3), np.float32))
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the traffic counters; warmed buckets and live session
        carries survive (state, not statistics)."""
        with self._stats_lock:
            self.chunks = self.frames_in = self.flows_out = 0
            self.warm_chunks = self.cold_chunks = 0
            self.flow_latency_s.clear()
            self.iters_used.clear()
            self.final_delta.clear()
        if self.sessions is not None:
            self.sessions.reset_counters()

    def _pctl_ms(self, p: float) -> float:
        if not self.flow_latency_s:
            return 0.0
        return round(float(np.percentile(self.flow_latency_s, p)) * 1e3, 2)

    def stats_record(self) -> dict:
        """Chunk and flow counters, per-flow latency percentiles and the
        session store's record. Takes only the stats lock (and the
        store's): never waits for a live chunk."""
        with self._stats_lock:
            rec = {
                "chunks": self.chunks,
                "frames_in": self.frames_in,
                "flows_out": self.flows_out,
                "warm_chunks": self.warm_chunks,
                "cold_chunks": self.cold_chunks,
                "flow_p50_ms": self._pctl_ms(50),
                "flow_p99_ms": self._pctl_ms(99),
                "warm_buckets": sorted(
                    f"{h}x{w}" for h, w in self._warm_buckets),
            }
            if self.adaptive:
                iu = list(self.iters_used)
                rec.update(
                    adaptive=True,
                    iters_used_mean=(round(sum(iu) / len(iu), 2)
                                     if iu else 0.0),
                    iters_used_p99=(round(float(np.percentile(iu, 99)), 2)
                                    if iu else 0.0),
                    final_delta_p50=(round(float(np.percentile(
                        list(self.final_delta), 50)), 5)
                        if self.final_delta else 0.0),
                )
        rec["sessions"] = (self.sessions.stats_record()
                           if self.sessions is not None else None)
        return rec
