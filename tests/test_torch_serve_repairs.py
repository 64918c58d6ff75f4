"""Two repairs the port's flow service runs on.

The eval step's arithmetic (train/step.py ``eval_arithmetic``) sets
process-global flags, and the service runs forwards on several threads
(the scheduler's dispatcher, the streaming handlers): the flags must hold
for every forward while any runs, and come back as they were when the
last one leaves. The port's OrderedLock (serve/locks.py) must back a
``threading.Condition`` like the JAX package's lock does
(dexiraft_tpu/analysis/locks.py), under the JAX lock order.
"""

import threading

import pytest
import torch

from dexiraft_tpu.analysis.locks import LOCK_ORDER as J_LOCK_ORDER
from dexiraft_tpu_torch.serve import locks
from dexiraft_tpu_torch.serve.locks import (LOCK_ORDER, LockOrderViolation,
                                            OrderedLock)
from dexiraft_tpu_torch.train.step import eval_arithmetic
from test_torch_lock_registry import preserved_lock_registry

WAIT = 10.0  # seconds an event may take; a hang fails instead of blocking


def _flags():
    c = torch.backends.cudnn
    return (c.benchmark, c.deterministic, c.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture()
def pytorch_default_flags():
    """PyTorch's defaults (benchmark off, not deterministic, TF32 on for
    cuDNN and matmuls), restored afterwards."""
    c, m = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = c.set_flags(_benchmark=False, _deterministic=False,
                        _allow_tf32=True)
    saved_matmul = m.allow_tf32
    m.allow_tf32 = True
    try:
        yield _flags()
    finally:
        c.set_flags(*saved)
        m.allow_tf32 = saved_matmul


def _run(fn):
    t = threading.Thread(target=fn)
    t.start()
    return t


def test_eval_arithmetic_holds_across_overlapping_threads(
        pytorch_default_flags):
    """A enters, B enters, A leaves while B is inside: B still runs with
    the eval step's flags (search over deterministic algorithms, TF32
    off), and after both left the flags are PyTorch's again."""
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def thread_a():
        with eval_arithmetic(False):
            a_in.set()
            assert b_in.wait(WAIT)
        a_out.set()

    def thread_b():
        assert a_in.wait(WAIT)
        with eval_arithmetic(False):
            b_in.set()
            assert a_out.wait(WAIT)
            seen["inside_b"] = _flags()

    ta, tb = _run(thread_a), _run(thread_b)
    ta.join(WAIT)
    tb.join(WAIT)
    assert seen["inside_b"] == (True, True, False, False)
    assert _flags() == pytorch_default_flags == (False, False, True, True)


def test_eval_arithmetic_other_setting_waits_for_the_first(
        pytorch_default_flags):
    """A forward asking for TF32 convolutions does not enter while a
    TF32-off forward runs (it would change the flags under it); it
    enters once that one has left, with its own setting."""
    a_in, a_release, b_entered = (threading.Event() for _ in range(3))
    seen = {}

    def thread_a():
        with eval_arithmetic(False):
            a_in.set()
            assert a_release.wait(WAIT)
            seen["inside_a"] = _flags()

    def thread_b():
        with eval_arithmetic(True):
            b_entered.set()
            seen["inside_b"] = _flags()

    ta = _run(thread_a)
    assert a_in.wait(WAIT)
    tb = _run(thread_b)
    assert not b_entered.wait(0.2)     # held out while A runs
    a_release.set()
    assert b_entered.wait(WAIT)
    ta.join(WAIT)
    tb.join(WAIT)
    assert seen["inside_a"] == (True, True, False, False)
    assert seen["inside_b"] == (True, True, True, False)
    assert _flags() == pytorch_default_flags


def test_eval_arithmetic_restores_after_an_error(pytorch_default_flags):
    with pytest.raises(RuntimeError, match="boom"):
        with eval_arithmetic(False):
            raise RuntimeError("boom")
    assert _flags() == pytorch_default_flags
    with eval_arithmetic(True):  # the depth count went back to 0
        assert _flags() == (True, True, True, False)


# ---- the OrderedLock interface ------------------------------------------


def test_lock_order_is_the_jax_order_restricted():
    assert LOCK_ORDER == tuple(n for n in J_LOCK_ORDER if n in LOCK_ORDER)
    for name in ("serve.server.stop", "serve.scheduler.cv",
                 "serve.sessions.store"):
        assert name in LOCK_ORDER
    router = ("serve.router.supervisor", "serve.router.autoscale",
              "serve.router.pool", "serve.router.inflight",
              "serve.router.stats")
    assert all(name in LOCK_ORDER for name in router)


def test_condition_wait_notify_over_ordered_lock():
    """Condition.wait releases the lock (another thread takes it and
    notifies) and the waiter holds it again afterwards; a reentrant lock
    is released through every level."""
    cv = threading.Condition(OrderedLock("serve.scheduler.cv",
                                         reentrant=True))
    state = {"ready": False}

    def producer():
        with cv:
            state["ready"] = True
            cv.notify()

    with cv:
        with cv:  # reentrant: two levels held
            t = _run(producer)
            assert cv.wait_for(lambda: state["ready"], timeout=WAIT)
            assert cv._is_owned()
    t.join(WAIT)
    assert not cv._lock.locked() and not cv._is_owned()
    with cv:  # timed wait with nobody notifying
        assert not cv.wait(timeout=0.01)


def test_acquire_blocking_and_timeout():
    lock = OrderedLock("serve.server.stop")
    got = {}
    with lock:
        assert not lock.acquire(blocking=False)  # the holder's probe

        def other():
            got["nonblocking"] = lock.acquire(blocking=False)
            got["timeout"] = lock.acquire(timeout=0.01)

        _run(other).join(WAIT)
    assert got == {"nonblocking": False, "timeout": False}
    assert lock.acquire(blocking=False)
    lock.release()


def test_inverted_nesting_still_raises():
    """The inversion is counted in the process-global registry even though
    it raises; the count is given back on exit."""
    with preserved_lock_registry():
        store = OrderedLock("serve.sessions.store")
        cv = OrderedLock("serve.scheduler.cv", reentrant=True)
        with cv:
            with store:
                pass
        with store:
            with pytest.raises(LockOrderViolation, match="opposite nesting"):
                cv.acquire()
            with pytest.raises(LockOrderViolation, match="self-deadlock"):
                store.acquire()
        assert not store.locked() and not cv.locked()


def test_set_strict_and_stats_record():
    """Non-strict: an inverted nesting is counted and let through; the
    locks block reports the count and each lock's gauges."""
    reg = locks._REGISTRY
    saved = (reg.strict, reg.order_violations, list(reg.violations),
             set(reg.warned))
    store = OrderedLock("serve.sessions.store")
    stop = OrderedLock("serve.server.stop")
    try:
        locks.set_strict(False)
        with store:
            with stop:  # inverted, warned and counted
                pass
        rec = locks.stats_record()
        assert rec["strict"] is False
        assert rec["order_violations"] == saved[1] + 1
        assert "serve.server.stop" in rec["violations"][-1]
        assert set(rec) == {"strict", "order_violations", "held_too_long",
                            "violations", "by_lock"}
        assert rec["by_lock"]["serve.server.stop"]["acquisitions"] >= 1
        assert set(rec["by_lock"]["serve.server.stop"]) == {
            "acquisitions", "contended", "max_held_ms", "held_too_long"}
        locks.set_strict(True)
        with store:
            with pytest.raises(LockOrderViolation):
                stop.acquire()
    finally:
        reg.strict, reg.order_violations = saved[0], saved[1]
        reg.violations[:] = saved[2]
        reg.warned = saved[3]
