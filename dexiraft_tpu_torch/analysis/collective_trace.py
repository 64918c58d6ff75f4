"""collective_trace — the collective flight recorder of the port.

A copy of ``dexiraft_tpu/analysis/collective_trace.py`` over the port's
:class:`~dexiraft_tpu_torch.serve.locks.OrderedLock`. Every collective
op a rank issues (the Coordinator's consensus rounds and barriers over
the ``torch.distributed`` store) is stamped into a bounded ring buffer as
``(namespace, round, op, args_digest)``. Peers cross-check each other's
stamps two ways:

  * **in-band, every round**: ``Coordinator._allgather`` piggybacks
    each rank's ``op|digest`` stamp on the consensus value it already
    posts to the store, and every reader compares the peer's stamp for
    the round against its own. The FIRST round whose ops disagree
    raises :class:`CollectiveDivergence` naming (rank, round,
    expected-vs-seen) as soon as the mismatched key arrives, instead of
    a ``CoordinatorTimeout`` after the full timeout window.
  * **out-of-band, on demand**: each rank publishes its encoded trace
    tail beside its value; :func:`verify_lockstep` is a pure function
    over scripted-or-real traces that names the first divergent op.

The recorder is process-global and always on (a few hundred tuples in a
deque): the hang watchdog dumps its tail next to the faulthandler
stacks. The ring is guarded by the ``resilience.trace.ring``
OrderedLock (the leaf rank of LOCK_ORDER: stamping never nests
outward).

Digests cover only *protocol-identifying* args (namespace, op, round),
never the local values being agreed on, which legitimately differ per
rank (the whole point of ``any_flag`` is that one rank's flag differs).
"""

from __future__ import annotations

import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dexiraft_tpu_torch.serve.locks import OrderedLock

#: entries kept per host — enough for hours of coord cadence; the ring
#: bounds memory on multi-day runs
DEFAULT_CAPACITY = 512

#: entries published to peers / dumped on stall (the interesting part
#: of a divergence is its first op, which lockstep keeps near the tail)
PUBLISH_TAIL = 64


class CollectiveDivergence(RuntimeError):
    """Two hosts issued DIFFERENT collective ops for the same round.

    Raised by the in-band lockstep check the moment the mismatched
    stamp arrives — naming the first divergent (host, round,
    expected-vs-seen) — instead of letting the skewed host pair
    mismatched rounds until a ``CoordinatorTimeout`` fires with no
    attribution.
    """

    def __init__(self, namespace: str, round_id: int, host: int,
                 expected: str, seen: str):
        super().__init__(
            f"collective divergence at namespace '{namespace}' round "
            f"{round_id}: host {host} issued '{seen}' where this host "
            f"issued '{expected}' — the hosts' collective sequences "
            f"split at this round (an identity-dependent branch, a "
            f"mid-protocol bail, or a swallowed error upstream); the "
            f"first divergent op above is the bug's address, fix the "
            f"branch that skipped or added it")
        self.namespace = namespace
        self.round_id = round_id
        self.host = host
        self.expected = expected
        self.seen = seen


def args_digest(*parts) -> str:
    """Stable 8-hex digest of protocol-identifying args — identical on
    every host for a lockstep call, cheap enough for every round."""
    blob = "\x1f".join(str(p) for p in parts).encode()
    return f"{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


class CollectiveTrace:
    """Bounded per-host ring of ``(namespace, round, op, digest, t)``.

    ``clock`` is injectable (tests drive ring/timestamp semantics on a
    fake clock); timestamps are LOCAL diagnostics only and never
    participate in cross-host comparison.
    """

    def __init__(self, host: int = 0, capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.monotonic):
        self.host = int(host)
        self.capacity = int(capacity)
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = OrderedLock("resilience.trace.ring")
        #: per-namespace auto round counters for stamp points that have
        #: no native round id
        self._counters: Dict[str, int] = {}
        self.recorded = 0
        #: rounds whose peer stamps the in-band check compared clean
        self.verified_rounds = 0
        #: divergences DETECTED by this host
        self.divergences = 0

    # -- stamping ----------------------------------------------------------

    def record(self, namespace: str, op: str,
               round_id: Optional[int] = None,
               digest: Optional[str] = None) -> Tuple[str, int, str, str]:
        """Stamp one collective op; returns the entry (sans timestamp).

        round_id=None draws from the per-namespace counter (stamp
        points without a native round).
        digest=None derives it from (namespace, op, round).
        """
        with self._lock:
            if round_id is None:
                round_id = self._counters.get(namespace, 0)
                self._counters[namespace] = round_id + 1
            if digest is None:
                digest = args_digest(namespace, op, round_id)
            entry = (namespace, int(round_id), op, digest)
            self._ring.append(entry + (self._clock(),))
            self.recorded += 1
        return entry

    def note_verified(self, n: int = 1) -> None:
        with self._lock:
            self.verified_rounds += n

    def note_divergence(self) -> None:
        with self._lock:
            self.divergences += 1

    # -- reading -----------------------------------------------------------

    def tail(self, n: int = PUBLISH_TAIL) -> List[Tuple]:
        with self._lock:
            items = list(self._ring)
        return items[-n:]

    def snapshot(self) -> dict:
        """The ``collective_trace`` verdict block (tests pin these
        keys)."""
        with self._lock:
            return {
                "host": self.host,
                "entries": self.recorded,
                "verified_rounds": self.verified_rounds,
                "divergences": self.divergences,
                "last": [list(e[:4]) for e in list(self._ring)[-8:]],
            }

    def render_tail(self, n: int = 16) -> str:
        """Human-readable tail for the watchdog stall dump: a hung
        consensus names the round it died in."""
        rows = [f"  {ns}/{rid}: {op} [{dig}] t={t:.3f}"
                for ns, rid, op, dig, t in self.tail(n)]
        head = (f"[collective-trace host {self.host}] last "
                f"{len(rows)} op(s) (of {self.recorded} recorded, "
                f"{self.verified_rounds} peer-verified, "
                f"{self.divergences} divergence(s)):")
        return "\n".join([head] + (rows or ["  <no collectives yet>"]))

    def dump(self, path: str) -> str:
        """Write the full ring to ``path`` (the CoordinatorTimeout
        message references this file); returns the path."""
        with open(path, "w") as f:
            f.write(self.render_tail(self.capacity) + "\n")
        return path

    # -- publication -------------------------------------------------------

    def encode_tail(self, n: int = PUBLISH_TAIL) -> str:
        """Wire form for store publication: ``ns|round|op|digest`` rows
        joined by ``;`` (namespaces/ops never contain either)."""
        return ";".join(f"{ns}|{rid}|{op}|{dig}"
                        for ns, rid, op, dig, _ in self.tail(n))


def decode_trace(blob: str) -> List[Tuple[str, int, str, str]]:
    """Inverse of :meth:`CollectiveTrace.encode_tail`."""
    out: List[Tuple[str, int, str, str]] = []
    for row in blob.split(";"):
        if not row:
            continue
        ns, rid, op, dig = row.split("|")
        out.append((ns, int(rid), op, dig))
    return out


# --------------------------------------------------------------------------
# the lockstep verifier (pure: scripted-trace tests drive it directly)
# --------------------------------------------------------------------------


def verify_lockstep(traces: Dict[int, Sequence[Sequence]]) -> dict:
    """Cross-check per-host op sequences; name the FIRST divergent op.

    ``traces`` maps host id -> sequence of ``(namespace, round, op,
    digest)`` rows (extra trailing fields like timestamps are
    ignored). The lowest host id is the reference. Hosts are compared
    over their common prefix; a host whose trace ends while the
    reference continues is NOT a divergence (ring capacity and
    publish cadence legitimately skew lengths) — only a row that
    *disagrees* is.

    Returns ``{"ok", "hosts", "compared", "first_divergence"}`` where
    first_divergence is None or ``{"host", "index", "round",
    "namespace", "expected", "seen"}`` (expected = the reference
    host's op at that position).
    """
    if not traces:
        return {"ok": True, "hosts": 0, "compared": 0,
                "first_divergence": None}
    ref_host = min(traces)
    ref = [tuple(r[:4]) for r in traces[ref_host]]
    first: Optional[dict] = None
    compared = 0
    for host in sorted(traces):
        if host == ref_host:
            continue
        rows = [tuple(r[:4]) for r in traces[host]]
        for i in range(min(len(ref), len(rows))):
            compared += 1
            if rows[i] == ref[i]:
                continue
            ns, rid, op, dig = ref[i]
            sns, srid, sop, sdig = rows[i]
            div = {"host": host, "index": i, "round": srid,
                   "namespace": sns,
                   "expected": f"{ns}/{rid}:{op}[{dig}]",
                   "seen": f"{sns}/{srid}:{sop}[{sdig}]"}
            if first is None or i < first["index"]:
                first = div
            break
    return {"ok": first is None, "hosts": len(traces),
            "compared": compared, "first_divergence": first}


# --------------------------------------------------------------------------
# the process-global recorder
# --------------------------------------------------------------------------

_RECORDER: Optional[CollectiveTrace] = None


def install(host: int = 0, capacity: int = DEFAULT_CAPACITY,
            clock: Callable[[], float] = time.monotonic
            ) -> CollectiveTrace:
    """(Re)configure the process recorder: each rank calls this with
    its rank before the first collective (parallel.distributed.
    initialize does); tests with a fake clock."""
    global _RECORDER
    _RECORDER = CollectiveTrace(host=host, capacity=capacity, clock=clock)
    return _RECORDER


def recorder() -> CollectiveTrace:
    """The process recorder, lazily created (host 0) so every wired
    stamp point works without setup."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = CollectiveTrace()
    return _RECORDER


def record(namespace: str, op: str, round_id: Optional[int] = None,
           digest: Optional[str] = None) -> Tuple[str, int, str, str]:
    """Module-level stamp — the one-liner the wiring sites call."""
    return recorder().record(namespace, op, round_id=round_id,
                             digest=digest)
