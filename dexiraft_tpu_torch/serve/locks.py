"""Named, ranked locks for the streaming tier.

A copy of the part of ``dexiraft_tpu/analysis/locks.py`` that the port's
``VideoEngine`` and ``DeviceSessionStore`` use: :class:`OrderedLock`, a
``threading.Lock`` with a name whose rank comes from :data:`LOCK_ORDER`
(the JAX package's order, restricted to these locks, names kept). Taking
a lock while holding one of a higher rank, or taking a held lock again on
the same thread, raises :class:`LockOrderViolation` before blocking, so
an inverted nesting is a stack trace naming both locks, not a deadlock.
The JAX module's acquisition graph, contention gauges and warn-only mode
are not copied.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

#: Outermost first: a thread holding LOCK_ORDER[i] may take LOCK_ORDER[j]
#: only for j > i.
LOCK_ORDER: Tuple[str, ...] = (
    "serve.video.chunk",         # VideoEngine._lock: one chunk's frame loop
    "serve.video.inflight",      # VideoEngine._inflight_lock: chunk admission
    "serve.video.stats",         # VideoEngine._stats_lock: chunk counters
    "serve.sessions.device",     # DeviceSessionStore._lock: device carry map
)

_RANK = {name: i for i, name in enumerate(LOCK_ORDER)}
_HELD = threading.local()


class LockOrderViolation(RuntimeError):
    """A lock was taken against the declared order, or re-taken on the
    thread that holds it."""


def _held() -> List["OrderedLock"]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


class OrderedLock:
    """A named, non-reentrant lock ranked by :data:`LOCK_ORDER`."""

    def __init__(self, name: str):
        if name not in _RANK:
            raise ValueError(f"lock {name!r} is not declared in LOCK_ORDER")
        self.name = name
        self.rank = _RANK[name]
        self._inner = threading.Lock()

    def acquire(self) -> None:
        for held in _held():
            if held is self:
                raise LockOrderViolation(
                    f"re-acquiring non-reentrant lock '{self.name}' on "
                    "the thread that already holds it — guaranteed "
                    "self-deadlock")
            if held.rank > self.rank:
                raise LockOrderViolation(
                    f"'{self.name}' (rank {self.rank}) acquired while "
                    f"holding '{held.name}' (rank {held.rank}) — "
                    "LOCK_ORDER declares the opposite nesting")
        self._inner.acquire()
        _held().append(self)

    def release(self) -> None:
        stack = _held()
        if self not in stack:
            raise RuntimeError(
                f"OrderedLock '{self.name}' released by a thread that does "
                "not hold it")
        stack.remove(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
