"""Multi-rank failure consensus: tiny primitives, one shared verdict.

The port of ``dexiraft_tpu/resilience/coord.py``. On a data-parallel
run every failure decision is local unless something makes it
collective: the divergence guard's verdict, the SIGTERM latch and the
verified-restore fallback each decide per process, so one rank could
roll back (or emergency-save, or land on an older checkpoint) while its
peers kept stepping, turning a recoverable fault into a hung
collective. The primitives here make every such decision collective:

  * ``any_flag``   — OR over ranks: a NaN/divergence verdict on ANY rank
    (or one rank's preemption notice) becomes the SAME verdict on ALL
    ranks at the same step.
  * ``min_int``    — min over ranks: the agreed rollback/resume step, so
    a restart never straddles two checkpoints.
  * ``agree_step`` — min_int iterated against what each rank actually
    restored, bounded, so per-rank verified-restore fallbacks converge.
  * ``barrier``    — every rank reaches the same point (the trainer's
    non-writing ranks wait here while rank 0 writes a checkpoint or
    validates).

A single process is the identity: no collective, no store round. On
several ranks each primitive is one tiny exchange over the
``torch.distributed`` store (the ``TCPStore`` the process group
rendezvoused on, ``parallel.distributed.coordination_store``): host
sockets only, no device work and no collective on the process group,
so it works on either backend and never queues behind the train step's
all-reduces. ``warmup()`` performs one exchange up front so
connectivity failures surface at startup, not at the first rollback.

A DEAD or stopped peer makes these exchanges block until their timeout,
which raises :class:`CoordinatorTimeout` naming the silent peer and the
round; the hang watchdog (resilience.watchdog) bounds waits that happen
inside the process group's own collectives.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Optional

import numpy as np

from dexiraft_tpu_torch.analysis import collective_trace as _trace
from dexiraft_tpu_torch.analysis.collective_trace import CollectiveDivergence


#: seconds between the store polls of a wait with no deadline
_POLL_S = 0.05


class CoordinatorTimeout(RuntimeError):
    """A peer's consensus value never arrived within ``timeout_s``.

    Names WHICH peer of WHICH round went silent in one line.
    ``trace_path`` points at the local collective flight-recorder dump
    (analysis.collective_trace) written when the timeout fired: its tail
    names the round this rank died waiting in.
    """

    def __init__(self, namespace: str, round_id: int, peer: int,
                 timeout_s: float, trace_path: Optional[str] = None):
        super().__init__(
            f"consensus timeout: peer {peer} posted no value for round "
            f"{round_id} of namespace '{namespace}' within "
            f"{timeout_s:.0f}s — the rank is dead, stalled, or "
            f"partitioned; restart the job"
            + (f"; local collective trace: {trace_path}"
               if trace_path else ""))
        self.namespace = namespace
        self.round_id = round_id
        self.peer = peer
        self.timeout_s = timeout_s
        self.trace_path = trace_path


def _is_deadline(exc: BaseException) -> bool:
    """The store's wait timed out (vs a real transport failure, which
    keeps its own traceback)."""
    import torch.distributed as dist

    return isinstance(exc, dist.DistStoreError) and "timeout" in str(exc)


class Coordinator:
    """Rank-consensus primitives over the ``torch.distributed`` store.

    Constructed once per process; ``size``/``index`` default to the
    process group's world (1 and 0 without one), ``store`` to the store
    ``parallel.distributed.initialize`` rendezvoused on. Tests inject
    ``allgather_fn`` to exercise the consensus logic without a live
    multi-process runtime. Peers must construct their Coordinators with
    the same ``namespace`` and call the primitives in the same order
    (every call is collective).
    """

    def __init__(self, size: Optional[int] = None,
                 index: Optional[int] = None, allgather_fn=None,
                 namespace: str = "dexiraft/coord",
                 timeout_s: float = 600.0, store=None):
        if size is None or index is None:
            import torch.distributed as dist

            live = dist.is_available() and dist.is_initialized()
            if size is None:
                size = dist.get_world_size() if live else 1
            if index is None:
                index = dist.get_rank() if live else 0
        self.size = int(size)
        self.index = int(index)
        self._allgather_fn = allgather_fn
        self._store = store
        self.namespace = namespace
        self.timeout_s = float(timeout_s)
        self._round = 0

    def _allgather(self, value: np.ndarray, op: str = "exchange",
                   bounded: bool = True) -> np.ndarray:
        """(size, 1) array of every rank's scalar.

        Each rank publishes its value under a per-call round id and
        waits for every peer's. Round ids advance in lockstep because
        every consensus call is itself collective.

        Lockstep is also VERIFIED, not just assumed: every round is
        stamped into the collective flight recorder and the stamp (op +
        args digest) rides on the posted value, so a peer whose round
        counter skewed (an identity branch, a mid-protocol bail, a
        swallowed error) raises CollectiveDivergence naming the first
        divergent (rank, round, op) as soon as its mismatched key
        arrives, instead of pairing mismatched rounds until a timeout.

        One wait covers every peer's key, so the slowest peer bounds the
        round at ``timeout_s`` (``bounded=False``: no deadline); on a
        timeout the keys still missing name the silent peer."""
        tr = _trace.recorder()
        rid = self._round
        self._round += 1
        if self._allgather_fn is not None:
            tr.record(self.namespace, op, round_id=rid)
            return np.asarray(self._allgather_fn(value))
        store = self._store
        if store is None:
            from dexiraft_tpu_torch.parallel.distributed import \
                coordination_store

            store = self._store = coordination_store()
        dig = _trace.args_digest(self.namespace, rid, op)
        tr.record(self.namespace, op, round_id=rid, digest=dig)
        v = int(np.asarray(value).ravel()[0])
        # the recorder tail BEFORE the value (peers diagnosing a wedge
        # can read it even if this rank dies before posting); then the
        # value stamped with this round's op|digest. Diagnostics only:
        # never fail the round for the recorder.
        try:
            store.set(f"{self.namespace}/trace/{rid}/{self.index}",
                      tr.encode_tail())
        except Exception:
            pass
        store.set(f"{self.namespace}/{rid}/{self.index}", f"{v}|{op}|{dig}")
        keys = [f"{self.namespace}/{rid}/{i}" for i in range(self.size)]
        if not bounded:
            # polled, since a store wait that times out leaves its reply
            # owed on the client's connection
            while not store.check(keys):
                time.sleep(_POLL_S)
        else:
            try:
                store.wait(keys, datetime.timedelta(
                    seconds=max(1.0, self.timeout_s)))
            except Exception as e:
                if not _is_deadline(e):
                    raise
                silent = [i for i, k in enumerate(keys)
                          if not store.check([k])]
                raise CoordinatorTimeout(
                    self.namespace, rid, silent[0] if silent else -1,
                    self.timeout_s, trace_path=self._dump_trace()) from None
        vals = []
        for i, key in enumerate(keys):
            parts = store.get(key).decode().split("|")
            if len(parts) == 3 and i != self.index:
                peer_op, peer_dig = parts[1], parts[2]
                if (peer_op, peer_dig) != (op, dig):
                    tr.note_divergence()
                    self._dump_trace()
                    raise CollectiveDivergence(
                        self.namespace, rid, i,
                        expected=f"{op}[{dig}]",
                        seen=f"{peer_op}[{peer_dig}]")
            vals.append(int(parts[0]))
        if self.size > 1:
            tr.note_verified()
        # bounded store footprint over multi-day runs: completing round
        # rid proves every rank finished READING round rid-1 (the calls
        # are lockstep), so this rank's own rid-1 keys are consumed.
        # Best-effort: stale keys are only memory, never correctness.
        if rid > 0:
            try:
                store.delete_key(f"{self.namespace}/{rid - 1}/{self.index}")
                store.delete_key(
                    f"{self.namespace}/trace/{rid - 1}/{self.index}")
            except Exception:
                pass
        return np.asarray(vals).reshape(self.size, 1)

    def _dump_trace(self) -> str:
        """Write the local flight-recorder ring next to the system tmp
        dir; the CoordinatorTimeout message points here."""
        path = os.path.join(
            tempfile.gettempdir(),
            f"dexiraft_collective_trace_h{self.index}.log")
        try:
            return _trace.recorder().dump(path)
        except Exception:
            return "<trace dump failed>"

    def warmup(self) -> None:
        """One throwaway exchange at startup: an unreachable store fails
        HERE, loudly, instead of at the first rollback or preemption
        broadcast mid-run."""
        if self.size > 1:
            self.any_flag(False)

    def any_flag(self, flag: bool) -> bool:
        """True iff ANY rank raised the flag (identity single-process)."""
        if self.size == 1:
            return bool(flag)
        return bool(self._allgather(np.asarray([bool(flag)]),
                                    op="any_flag").any())

    def min_int(self, value: int) -> int:
        """Min over ranks (identity single-process). Callers encode "I
        have nothing" as a sentinel smaller than any real value (e.g. -1
        for checkpoint steps): the poorest rank then pulls the agreement
        down to a step everyone has, or to the sentinel, which the
        caller must treat as "no agreed target"."""
        if self.size == 1:
            return int(value)
        return int(self._allgather(np.asarray([int(value)]),
                                   op="min_int").min())

    def barrier(self, tag: str, bounded: bool = True) -> None:
        """Every rank reaches this call before any returns (identity
        single-process). ``tag`` names the barrier in the trace and is
        part of the lockstep check: ranks waiting at different barriers
        raise CollectiveDivergence. ``bounded=False`` waits with no
        deadline, for a window that the hang watchdog bounds, or nothing
        does."""
        if self.size > 1:
            self._allgather(np.asarray([0]), op=f"barrier:{tag}",
                            bounded=bounded)

    def agree_step(self, restore_fn, step: Optional[int],
                   max_rounds: int = 4):
        """Restore the SAME checkpoint step on every rank.

        restore_fn(step_or_None) -> (state, restored_step) is the rank's
        verified restore (resilience.verify.restore_verified bound to its
        directory/template). Each rank restores its best candidate at or
        below the agreed bound, ranks exchange what they actually landed
        on, and any rank above the global min re-restores at that min,
        converging because the agreed bound is monotonically decreasing.
        Returns (state, step). Raises RuntimeError if the ranks still
        disagree after max_rounds.

        Every rank runs every round in lockstep: a rank that already
        sits on the agreed step re-restores it rather than leaving its
        peers blocked in a round it no longer joins."""
        bound = step
        state = restored = None
        for _ in range(max_rounds):
            state, raw = restore_fn(bound)
            restored = int(raw)
            agreed = self.min_int(restored)
            if not self.any_flag(restored != agreed):
                return state, restored
            bound = agreed
        raise RuntimeError(
            f"host {self.index}: no checkpoint step agreement after "
            f"{max_rounds} rounds (last restored {restored}); the ranks' "
            f"views of the checkpoint directory have diverged — inspect it")
