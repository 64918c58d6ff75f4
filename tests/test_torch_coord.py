"""The port's multi-rank resilience layer against the JAX package's:
``resilience.coord.Coordinator``, ``resilience.watchdog.HangWatchdog``,
``resilience.preemption.PreemptionHandler`` and
``analysis.collective_trace``, then the data-parallel train CLI.

  * The scripts of tests/test_zzresilience.py's ``TestCoordinator`` and
    ``TestHangWatchdog`` (an injected allgather, a fake clock) run
    through both packages' classes: the same verdicts, exceptions, fire
    steps, regions, exit codes and straggler warnings.
  * The port's store path: 3 ranks as threads over one ``TCPStore``:
    ``any_flag``, ``min_int``, ``barrier`` and ``agree_step`` agree; a
    silent rank raises ``CoordinatorTimeout`` naming it within ~1 s; a
    barrier with no deadline outlasts the timeout; ranks calling
    different primitives raise ``CollectiveDivergence``.
  * ``verify_lockstep``, the trace tail's encode/decode and the snapshot
    on the same rows in both packages; both preemption handlers on real
    signals.

The 2-rank train CLI (preempted on one rank, then resumed) runs in
tests/test_torch_parallel.py, beside the JAX compiles there.
"""

import datetime
import os
import signal
import threading
import time
import uuid

import numpy as np
import pytest

from dexiraft_tpu.analysis import collective_trace as j_trace
from dexiraft_tpu.resilience.coord import Coordinator as JCoordinator
from dexiraft_tpu.resilience.preemption import \
    PreemptionHandler as JPreemptionHandler
from dexiraft_tpu.resilience.watchdog import HangWatchdog as JHangWatchdog
from dexiraft_tpu_torch.analysis import collective_trace as trace
from dexiraft_tpu_torch.resilience import (STALL_EXIT_CODE,
                                           CollectiveDivergence, Coordinator,
                                           CoordinatorTimeout, HangWatchdog,
                                           PreemptionHandler)

# ---- the Coordinator on JAX's scripts --------------------------------------


def _identity(C):
    calls = []
    coord = C(size=1, index=0, allgather_fn=lambda v: calls.append(v))
    out = [coord.any_flag(True), coord.any_flag(False), coord.min_int(7),
           coord.agree_step(lambda b: (("state", b), 4), None)]
    coord.warmup()
    return out, calls


def _any_and_min(C):
    peers = {"flags": [False, True], "steps": [40, 20]}

    def fake_allgather(v):
        if v.dtype == bool:
            return np.asarray([[f] for f in peers["flags"]])
        return np.asarray([[s] for s in peers["steps"]])

    coord = C(size=2, index=0, allgather_fn=fake_allgather)
    return coord.any_flag(False), coord.min_int(40)


def _agree_converges(C):
    script = iter([np.asarray([[4], [2]]), np.asarray([[True], [False]]),
                   np.asarray([[2], [2]]), np.asarray([[False], [False]])])
    coord = C(size=2, index=0, allgather_fn=lambda v: next(script))
    restores = []

    def restore_fn(bound):
        restores.append(bound)
        step = 4 if bound is None else min(4, bound)
        return f"state@{step}", step

    return coord.agree_step(restore_fn, None), restores


def _agree_gives_up(C):
    coord = C(size=2, index=1, allgather_fn=lambda v: (
        np.asarray([[True], [True]]) if v.dtype == bool
        else np.asarray([[0], [1]])))
    return coord.agree_step(lambda b: ("s", 1), None, max_rounds=2)


def _outcome(script, C):
    try:
        return "ok", script(C)
    except Exception as e:
        return "raise", type(e).__name__, "no checkpoint step" in str(e)


@pytest.mark.parametrize("script", [_identity, _any_and_min,
                                    _agree_converges, _agree_gives_up])
def test_coordinator_decisions_equal_jax(script):
    ours = _outcome(script, Coordinator)
    assert ours == _outcome(script, JCoordinator)
    if script is _agree_gives_up:
        assert ours == ("raise", "RuntimeError", True)


# ---- the Coordinator over a TCPStore, 3 ranks as threads -------------------


def _store_ranks(body, n=3, timeout_s=10.0):
    """body(rank, Coordinator) on n threads, each with its own store
    client; -> [("ok", value) | ("raise", exc, seconds)] per rank."""
    import torch.distributed as dist

    master = dist.TCPStore("127.0.0.1", 0, world_size=n, is_master=True,
                           wait_for_workers=False)
    namespace = f"test/{uuid.uuid4().hex[:8]}"
    results = [None] * n

    def run(i):
        store = dist.TCPStore("127.0.0.1", master.port, world_size=n,
                              is_master=False,
                              timeout=datetime.timedelta(seconds=30))
        coord = Coordinator(size=n, index=i, store=store,
                            namespace=namespace, timeout_s=timeout_s)
        t0 = time.monotonic()
        try:
            results[i] = ("ok", body(i, coord))
        except Exception as e:
            results[i] = ("raise", e, time.monotonic() - t0)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return results


def test_store_primitives_agree_over_three_ranks():
    have = [6, 4, 6]  # rank 1's disk holds only up to step 4

    def body(i, coord):
        coord.warmup()
        flag = coord.any_flag(i == 1)
        low = coord.min_int([5, 3, 9][i])
        coord.barrier("save@3")

        def restore(bound):
            step = have[i] if bound is None else min(have[i], bound)
            return f"state@{step}", step

        return flag, low, coord.agree_step(restore, None)

    results = _store_ranks(body)
    assert results == [("ok", (True, 3, ("state@4", 4)))] * 3


def test_store_timeout_names_the_silent_rank():
    def body(i, coord):
        if i == 2:
            return "silent"
        return coord.any_flag(False)

    results = _store_ranks(body, timeout_s=1.0)
    assert results[2] == ("ok", "silent")
    for kind, exc, seconds in results[:2]:
        assert kind == "raise" and isinstance(exc, CoordinatorTimeout)
        assert (exc.peer, exc.round_id) == (2, 0)
        assert "peer 2" in str(exc) and seconds < 5.0


def test_store_barrier_without_deadline_outlasts_the_timeout():
    """barrier(bounded=False) waits out a peer that arrives long
    after the coordinator's timeout (rank 0's validation window), and the
    next round still agrees."""
    def body(i, coord):
        if i == 1:
            time.sleep(2.0)
        coord.barrier("validation@4", bounded=False)
        return coord.any_flag(i == 1)

    assert _store_ranks(body, n=2, timeout_s=0.5) == [("ok", True)] * 2


def test_store_divergence_names_the_first_divergent_rank():
    """Rank 1 calls min_int where ranks 0 and 2 call any_flag: every rank
    names the first rank whose op differs from its own, at round 0."""
    def body(i, coord):
        return coord.min_int(1) if i == 1 else coord.any_flag(False)

    results = _store_ranks(body)
    for i, (kind, exc, _) in enumerate(results):
        assert kind == "raise" and isinstance(exc, CollectiveDivergence)
        assert (exc.host, exc.round_id) == ({0: 1, 1: 0, 2: 1}[i], 0)
    assert "min_int" in results[0][1].seen
    assert "any_flag" in results[1][1].seen


# ---- the HangWatchdog on JAX's fake-clock scripts --------------------------


def _wd(cls, path, timeout, **kw):
    clk = [0.0]
    exits = []
    out = open(path, "w+")
    return cls(timeout, clock=lambda: clk[0], exit_fn=exits.append,
               stream=out, **kw), clk, exits, out


def _stall(cls, path):
    wd, clk, exits, out = _wd(cls, path, 10.0)
    wd.arm(42, "step+data")
    clk[0] = 9.0
    seen = [wd.check_once()]
    clk[0] = 10.5
    seen.append(wd.check_once())
    out.seek(0)
    dump = out.read()
    out.close()
    return (seen, exits, wd.fired, "step 42" in dump, "step+data" in dump,
            "most recent call first" in dump)  # faulthandler's stacks


def _straggler(cls, path):
    wd, clk, exits, out = _wd(cls, path, 100.0, straggler_factor=10.0)
    for step in range(4):
        wd.arm(step)
        clk[0] += 1.0
        wd.disarm()
    ewma = wd.ewma_s
    wd.arm(5)
    clk[0] += 11.0
    seen = [wd.check_once(), wd.check_once()]
    out.seek(0)
    warned = "straggler" in out.read()
    out.close()
    return ewma, seen, wd.straggler_warnings, exits, warned


def _sanctioned(cls, path):
    wd, clk, exits, out = _wd(cls, path, 100.0)
    for step in range(3):
        wd.arm(step)
        clk[0] += 0.5
        wd.disarm()
    wd.arm(9, "checkpoint+validation", steady=False)
    clk[0] += 500.0
    seen = [wd.check_once(), wd.straggler_warnings, wd.disarm(), wd.ewma_s]
    wd.arm(10, "checkpoint+validation", steady=False)
    clk[0] += 1001.0
    seen += [wd.check_once(), list(exits)]
    out.close()
    return seen


def _inert(cls, path):
    wd, clk, exits, out = _wd(cls, path, 0.0)
    wd.arm(1)
    clk[0] = 1e9
    seen = (wd.enabled, wd.check_once(), exits, wd.start()._thread)
    out.close()
    return seen


@pytest.mark.parametrize("script", [_stall, _straggler, _sanctioned, _inert])
def test_watchdog_decisions_equal_jax(script, tmp_path):
    ours = script(HangWatchdog, tmp_path / "port.log")
    assert ours == script(JHangWatchdog, tmp_path / "jax.log")
    if script is _stall:
        assert ours == ([None, "stall"],
                        [STALL_EXIT_CODE], True, True, True, True)
    assert STALL_EXIT_CODE == 98


# ---- preemption and the collective trace -----------------------------------


@pytest.mark.parametrize("cls", [PreemptionHandler, JPreemptionHandler])
def test_preemption_latches_first_signal_and_aborts_on_second(cls):
    previous = signal.getsignal(signal.SIGTERM)
    handler = cls()
    with handler:
        # installed (main thread), so the signal below cannot kill the run
        assert signal.getsignal(signal.SIGTERM) == handler._handle
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if handler.triggered:
                break
            time.sleep(0.01)
        assert (handler.triggered, handler.signal_name) == (True, "SIGTERM")
        with pytest.raises(KeyboardInterrupt, match="second SIGTERM"):
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(1.0)
    assert signal.getsignal(signal.SIGTERM) is previous


def _rows(mod):
    clock = iter(np.arange(100.0)).__next__
    tr = mod.CollectiveTrace(host=1, capacity=4, clock=clock)
    for i, op in enumerate(["any_flag", "min_int", "barrier:save@3",
                            "any_flag", "min_int"]):
        tr.record("dexiraft/coord", op, round_id=i)
    tr.record("dexiraft/other", "op")
    tr.note_verified(2)
    good = [("c", i, op, mod.args_digest("c", i, op))
            for i, op in enumerate(["any_flag", "min_int", "any_flag"])]
    bad = good[:1] + [("c", 1, "any_flag", mod.args_digest("c", 1,
                                                           "any_flag"))]
    blob = tr.encode_tail()
    return (blob, mod.decode_trace(blob), tr.snapshot(), tr.render_tail(),
            mod.verify_lockstep({0: good, 1: good[:2], 2: bad}),
            mod.verify_lockstep({0: good, 1: list(good)}))


def test_collective_trace_equals_jax():
    ours = _rows(trace)
    assert ours == _rows(j_trace)
    assert ours[4]["first_divergence"]["host"] == 2 and ours[5]["ok"]
