"""Device-resident streaming carry: stream id -> the newest frame's
features and the splatted flow seed.

Counterpart of ``DeviceSessionStore`` and ``carry_nbytes`` in
``dexiraft_tpu/serve/sessions.py``. The carry is bucket-scoped (features
and seed live at the padded bucket's 1/8 resolution), so a stream whose
frames move to another bucket restarts cold, counted; a stream silent
for ``ttl_s`` expires; at most ``max_sessions`` streams live; and on top
of that a byte budget governs admission, since the carry is CUDA memory.
Thread-safe: one lock, no device work under it.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Optional, Tuple

from dexiraft_tpu_torch.serve.locks import OrderedLock


def carry_nbytes(features: Dict[str, Any], flow_init: Any) -> int:
    """Device bytes one stream's carry pins: every feature tensor plus the
    flow seed. Reads only ``.nbytes`` (torch tensors and numpy arrays
    both have it), never the contents."""
    total = 0 if flow_init is None else int(flow_init.nbytes)
    for v in features.values():
        total += int(v.nbytes)
    return total


class _DeviceEntry:
    __slots__ = ("bucket", "features", "flow_init", "nbytes", "t_touch")

    def __init__(self, bucket: Tuple[int, int], features: Dict[str, Any],
                 flow_init: Any, nbytes: int, t_touch: float):
        self.bucket = bucket
        self.features = features
        self.flow_init = flow_init
        self.nbytes = nbytes
        self.t_touch = t_touch


class DeviceSessionStore:
    """Byte-budgeted TTL+LRU map: stream id -> the device-resident
    streaming carry {per-frame feature dict, splatted flow_init}.

    Admitting or growing a carry evicts least-recently-used streams until
    the total fits the byte budget (``budget_evicted``); one stream that
    alone exceeds the budget is kept and counted (``over_budget``) rather
    than thrashed cold. A v5 stream at full width in the Sintel bucket
    (fmap, ctx, efmap, ectx: 4 x 256 x 55 x 128 fp32, plus the 55 x 128 x
    2 seed) pins 28,892,160 bytes (~27.6 MiB; measured on an H100 by
    chip_smoke.py's ``video`` phase), so the 256 MiB default holds 9 such
    streams.

    The tensors are stored as handed in (CUDA tensors from the encode and
    splat steps, numpy arrays in unit tests); only ``.nbytes`` is read.
    """

    def __init__(self, budget_bytes: int = 256 << 20, ttl_s: float = 60.0,
                 max_sessions: int = 1024, clock=None):
        if budget_bytes < 1:
            raise ValueError(f"budget_bytes must be >= 1, got {budget_bytes}")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        if max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, got {max_sessions}")
        self.budget_bytes = budget_bytes
        self.ttl_s = ttl_s
        self.max_sessions = max_sessions
        self.clock = clock if clock is not None else time.monotonic
        self._lock = OrderedLock("serve.sessions.device")
        self._entries: "collections.OrderedDict[str, _DeviceEntry]" = \
            collections.OrderedDict()
        self.bytes_in_use = 0
        self.peak_bytes = 0
        self.hits = 0
        self.misses = 0
        self.expired = 0
        self.lru_evicted = 0       # max_sessions evictions
        self.budget_evicted = 0    # byte-budget evictions
        self.bucket_resets = 0     # geometry moved buckets -> cold restart
        self.over_budget = 0       # single stream alone exceeded the budget

    # ---- internal (lock held) ------------------------------------------

    def _drop(self, sid: str) -> None:
        e = self._entries.pop(sid)
        self.bytes_in_use -= e.nbytes

    def _sweep(self, now: float) -> None:
        dead = [sid for sid, e in self._entries.items()
                if now - e.t_touch > self.ttl_s]
        for sid in dead:
            self._drop(sid)
        self.expired += len(dead)

    def _evict_to_fit(self, keep: str) -> None:
        """Evict LRU streams (never ``keep``) until the budget holds."""
        while self.bytes_in_use > self.budget_bytes:
            victim = next((sid for sid in self._entries if sid != keep),
                          None)
            if victim is None:
                self.over_budget += 1
                return
            self._drop(victim)
            self.budget_evicted += 1

    # ---- API -----------------------------------------------------------

    def get(self, session_id: str, bucket: Tuple[int, int]
            ) -> Optional[Tuple[Dict[str, Any], Any]]:
        """(features, flow_init) for the stream at this bucket, or None
        (cold: unknown id, expired, or the stream changed buckets, which
        drops its carry)."""
        now = self.clock()
        with self._lock:
            e = self._entries.get(session_id)
            if e is None:
                self.misses += 1
                return None
            if now - e.t_touch > self.ttl_s:
                self._drop(session_id)
                self.expired += 1
                return None
            if e.bucket != bucket:
                self._drop(session_id)
                self.bucket_resets += 1
                return None
            e.t_touch = now
            self._entries.move_to_end(session_id)
            self.hits += 1
            return e.features, e.flow_init

    def put(self, session_id: str, bucket: Tuple[int, int],
            features: Dict[str, Any], flow_init: Any) -> None:
        """Record the stream's newest carry, evicting LRU streams if the
        byte budget demands it."""
        nbytes = carry_nbytes(features, flow_init)
        now = self.clock()
        with self._lock:
            self._sweep(now)
            if session_id in self._entries:
                self._drop(session_id)
            while len(self._entries) >= self.max_sessions:
                self._drop(next(iter(self._entries)))
                self.lru_evicted += 1
            self._entries[session_id] = _DeviceEntry(
                bucket, features, flow_init, nbytes, now)
            self.bytes_in_use += nbytes
            self._evict_to_fit(keep=session_id)
            self.peak_bytes = max(self.peak_bytes, self.bytes_in_use)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def reset_counters(self) -> None:
        """Zero the counters; live carries and the byte gauge (state, not
        statistics) survive."""
        with self._lock:
            self.hits = self.misses = self.expired = 0
            self.lru_evicted = self.budget_evicted = 0
            self.bucket_resets = self.over_budget = 0
            self.peak_bytes = self.bytes_in_use

    def stats_record(self) -> dict:
        with self._lock:
            self._sweep(self.clock())
            return {
                "active": len(self._entries),
                "ttl_s": self.ttl_s,
                "max_sessions": self.max_sessions,
                "budget_mb": round(self.budget_bytes / 2**20, 2),
                "bytes_in_use_mb": round(self.bytes_in_use / 2**20, 3),
                "peak_mb": round(self.peak_bytes / 2**20, 3),
                "hits": self.hits,
                "misses": self.misses,
                "expired": self.expired,
                "lru_evicted": self.lru_evicted,
                "budget_evicted": self.budget_evicted,
                "bucket_resets": self.bucket_resets,
                "over_budget": self.over_budget,
            }
