"""Named, ranked locks for the serving tier and the trainer.

A copy of the part of ``dexiraft_tpu/analysis/locks.py`` that the port's
serving tier, its fleet router, the trainer and its resilience layer use: :class:`OrderedLock`, a ``threading.Lock`` (or, with
``reentrant=True``, an ``RLock``) with a name whose rank comes from
:data:`LOCK_ORDER` (the JAX package's order, restricted to the locks the
port takes, names kept). Taking a lock while holding one of a higher
rank, or taking a held non-reentrant lock again on the same thread, is a
violation found before blocking: in strict mode (the default) it raises
:class:`LockOrderViolation`, so an inverted nesting is a stack trace
naming both locks, not a deadlock; with ``set_strict(False)`` it is
counted and warned once. It can back a ``threading.Condition``
(``_is_owned`` / ``_release_save`` / ``_acquire_restore``: a waiting
thread holds nothing). :func:`stats_record` is the ``locks`` block of
the service's /stats.

Not copied: the acquisition graph and its cycle search. Every lock here
has a rank, so a cycle of acquisitions contains an inverted pair, which
the rank check already finds.
"""

from __future__ import annotations

import sys
import threading
import time
import weakref
from typing import Dict, List, Tuple

#: Outermost first: a thread holding LOCK_ORDER[i] may take LOCK_ORDER[j]
#: only for j > i.
LOCK_ORDER: Tuple[str, ...] = (
    "serve.video.chunk",         # VideoEngine._lock: one chunk's frame loop
    "serve.server.stop",         # FlowService._stop_lock: drain idempotence
    "serve.scheduler.cv",        # Scheduler._cv: queues + dispatch decision
    "serve.router.supervisor",   # router_cli._Supervisor._lock: child procs
    "serve.router.autoscale",    # Router._autoscale_lock: scrape-window
                                 # read-and-swap (nests pool + stats records)
    "serve.router.pool",         # ReplicaPool._lock: breaker + ring + affinity
    "serve.router.inflight",     # Router._inflight_lock: admission bound
    "serve.router.stats",        # RouterStats._lock: proxy counters
    "serve.video.inflight",      # VideoEngine._inflight_lock: chunk admission
    "serve.video.stats",         # VideoEngine._stats_lock: chunk counters
    "serve.sessions.store",      # SessionStore._lock: flow-seed carry map
    "serve.sessions.device",     # DeviceSessionStore._lock: device carry map
    "resilience.watchdog.armed", # HangWatchdog._lock: armed-region tuple
    "train.checkpoint.pending",  # checkpoint._LOCK: pending-flush registry
    "data.loader.pool",          # _PoolManager._lock: decode-pool generation
    "resilience.trace.ring",     # CollectiveTrace._lock: flight-recorder ring
)

_RANK = {name: i for i, name in enumerate(LOCK_ORDER)}
_HELD = threading.local()
HELD_WARN_MS = 1000.0  # a span held longer counts as held_too_long
_VIOLATION_WINDOW = 32


class LockOrderViolation(RuntimeError):
    """A lock was taken against the declared order, or re-taken on the
    thread that holds it."""


class _Registry:
    """Strict flag, violation counts and the live locks, by name."""

    def __init__(self):
        self.meta = threading.Lock()   # bookkeeping only, never nested
        self.strict = True
        self.order_violations = 0
        self.violations: List[str] = []
        self.warned: set = set()
        self.locks: Dict[str, "weakref.WeakSet[OrderedLock]"] = {}

    def violation(self, key: Tuple[str, str, str], msg: str) -> None:
        with self.meta:
            self.order_violations += 1
            if len(self.violations) < _VIOLATION_WINDOW:
                self.violations.append(msg)
            fresh = key not in self.warned
            self.warned.add(key)
        if self.strict:
            raise LockOrderViolation(msg)
        if fresh:
            print(f"[locks] {key[0]}: {msg} (warn-once; strict mode "
                  f"raises here)", file=sys.stderr, flush=True)


_REGISTRY = _Registry()


class _Held:
    __slots__ = ("lock", "depth", "t0")

    def __init__(self, lock: "OrderedLock", depth: int, t0: float):
        self.lock = lock
        self.depth = depth
        self.t0 = t0


def _held() -> List[_Held]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


class OrderedLock:
    """A named lock ranked by :data:`LOCK_ORDER`; non-reentrant unless
    ``reentrant=True``."""

    def __init__(self, name: str, *, reentrant: bool = False):
        if name not in _RANK:
            raise ValueError(f"lock {name!r} is not declared in LOCK_ORDER")
        self.name = name
        self.rank = _RANK[name]
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        # mutated only while this lock is held
        self.acquisitions = 0
        self.contended = 0
        self.max_held_ms = 0.0
        self.held_too_long = 0
        with _REGISTRY.meta:
            _REGISTRY.locks.setdefault(name, weakref.WeakSet()).add(self)

    def __repr__(self) -> str:
        return (f"OrderedLock({self.name!r}, rank={self.rank}, "
                f"reentrant={self._reentrant})")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        for entry in held:
            if entry.lock is self:
                if self._reentrant:
                    got = self._inner.acquire(blocking, timeout)
                    if got:
                        entry.depth += 1
                    return got
                if not blocking:
                    # a non-blocking probe by the holder answers False
                    return False
                raise LockOrderViolation(
                    f"re-acquiring non-reentrant lock '{self.name}' on "
                    "the thread that already holds it — guaranteed "
                    "self-deadlock")
        for entry in held:
            if entry.lock.rank > self.rank:
                _REGISTRY.violation(
                    ("rank-inversion", entry.lock.name, self.name),
                    f"'{self.name}' (rank {self.rank}) acquired while "
                    f"holding '{entry.lock.name}' (rank "
                    f"{entry.lock.rank}) — LOCK_ORDER declares the "
                    "opposite nesting")
        waited = False
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            waited = True
            got = (self._inner.acquire(True) if timeout is None
                   or timeout < 0 else self._inner.acquire(True, timeout))
            if not got:
                return False
        self.acquisitions += 1
        self.contended += waited
        held.append(_Held(self, 1, time.monotonic()))
        return True

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry.lock is self:
                entry.depth -= 1
                if entry.depth == 0:
                    del held[i]
                    self._note_span(entry.t0)
                self._inner.release()
                return
        raise RuntimeError(
            f"OrderedLock '{self.name}' released by a thread that does "
            "not hold it")

    def _note_span(self, t0: float) -> None:
        dt_ms = (time.monotonic() - t0) * 1e3
        self.max_held_ms = max(self.max_held_ms, dt_ms)
        self.held_too_long += dt_ms > HELD_WARN_MS

    def locked(self) -> bool:
        if self._reentrant:
            if self._is_owned():
                return True
            if self._inner.acquire(False):
                self._inner.release()
                return False
            return True
        return self._inner.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # ---- threading.Condition protocol ------------------------------------
    # Condition.wait releases the lock fully (every recursion level) and
    # its held-stack entry with it: a waiting thread holds nothing.

    def _is_owned(self) -> bool:
        return any(e.lock is self for e in _held())

    def _release_save(self):
        held = _held()
        depth = 1
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                depth = held[i].depth
                self._note_span(held[i].t0)
                del held[i]
                break
        for _ in range(depth):
            self._inner.release()
        return depth

    def _acquire_restore(self, depth: int) -> None:
        for _ in range(depth):
            self._inner.acquire()
        _held().append(_Held(self, depth, time.monotonic()))


def set_strict(on: bool = True) -> None:
    """Strict mode (the default): a violation raises at the offending
    acquisition. Off: it is counted and warned once per lock pair."""
    _REGISTRY.strict = bool(on)


def stats_record() -> dict:
    """The ``locks`` block of /stats: violation verdicts plus per-lock
    acquisition, contention and held-time gauges."""
    reg = _REGISTRY
    with reg.meta:
        by_lock = {}
        held_too_long = 0
        for name in sorted(reg.locks):
            live = list(reg.locks[name])
            acq = sum(lk.acquisitions for lk in live)
            long = sum(lk.held_too_long for lk in live)
            held_too_long += long
            if acq:
                by_lock[name] = {
                    "acquisitions": acq,
                    "contended": sum(lk.contended for lk in live),
                    "max_held_ms": round(max(lk.max_held_ms
                                             for lk in live), 3),
                    "held_too_long": long,
                }
        return {
            "strict": reg.strict,
            "order_violations": reg.order_violations,
            "held_too_long": held_too_long,
            "violations": list(reg.violations),
            "by_lock": by_lock,
        }
