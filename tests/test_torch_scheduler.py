"""The port's SLO scheduler, session store and engine accounting against
the JAX package's.

One fake-clock arrival trace and the same numpy stub engine go through
``dexiraft_tpu.serve.scheduler.Scheduler.poll_once`` and the port's copy:
every dispatch decision (bucket, group, full/SLO/drain, iteration budget)
and the counters must be equal. The session store runs one operation
sequence through both packages (TTL, LRU, bucket change). The pipelined
engine's accounting (in-flight window, searched signatures, carry bytes)
is pinned on stubs.
"""

import types

import numpy as np
import pytest
import torch

import dexiraft_tpu.serve.engine as j_engine_mod
import dexiraft_tpu_torch.serve.engine as t_engine_mod
from dexiraft_tpu.serve import InferenceEngine as JEngine
from dexiraft_tpu.serve import QueueFull as JQueueFull
from dexiraft_tpu.serve import Scheduler as JScheduler
from dexiraft_tpu.serve import ServeConfig as JConfig
from dexiraft_tpu.serve import SessionStore as JSessionStore
from dexiraft_tpu_torch.serve import (InferenceEngine, QueueFull, Scheduler,
                                      SchedulerClosed, ServeConfig,
                                      SessionStore)

SERVICE_S = 0.030   # fake-clock seconds one stub batch takes
FULL = 32


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _item(h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (h, w, 3)).astype(np.float32)}


def _stub(clock, log, adaptive):
    """A batch takes SERVICE_S on the fake clock; logs each dispatch's
    (batch shape, budget)."""

    def fixed(im1, im2, flow_init=None):
        clock.advance(SERVICE_S)
        log.append((tuple(im1.shape), None))
        b, h, w = im1.shape[:3]
        return (np.zeros((b, h // 8, w // 8, 2), np.float32),
                np.ones((b, h, w, 2), np.float32))

    def budgeted(im1, im2, flow_init=None, iter_budget=None):
        n = FULL if iter_budget is None else int(iter_budget)
        clock.advance(SERVICE_S * n / FULL)
        log.append((tuple(im1.shape), n))
        b, h, w = im1.shape[:3]
        return (np.zeros((b, h // 8, w // 8, 2), np.float32),
                np.ones((b, h, w, 2), np.float32),
                np.full((b,), n, np.int32), np.full((b,), 1e-3, np.float32))

    return budgeted if adaptive else fixed


# the trace: (advance seconds, action, argument)
TRACE = (
    (0.0, "submit", (40, 56)),
    (0.0, "poll", None),          # 1 < batch 4: held (SLO not due)
    (0.040, "submit", (40, 56)),
    (0.0, "submit", (64, 80)),
    (0.0, "poll", None),
    (0.061, "poll", None),        # 40x56 head past slo/2 = 100 ms: SLO
    (0.0, "poll", None),          # 64x80 not due yet
    (0.050, "poll", None),        # now it is
    (0.0, "submit", (40, 56)),
    (0.0, "submit", (40, 56)),
    (0.0, "submit", (40, 56)),
    (0.0, "submit", (40, 56)),    # batch full: goes now
    (0.0, "submit", (48, 64)),
    (0.0, "poll", None),
    (0.0, "poll", None),
    (0.150, "poll", None),        # hold = slo - learned estimate
    (0.0, "submit", (40, 56)),
    (0.0, "submit", (40, 56)),
    (0.0, "submit", (40, 56)),
    (0.005, "submit", (64, 80)),  # heads 5 ms apart: no ties between
    (0.0, "submit", (64, 80)),    # buckets whose estimates are equal
    (0.005, "submit", (48, 64)),  # the 6th: the queue is full
    (0.0, "submit", (48, 64)),    # refused
    (0.100, "poll", None),
    (0.100, "poll", None),
    (0.0, "drain", None),         # the rest leaves at once
    (0.0, "poll", None),
    (0.0, "poll", None),
    (0.0, "poll", None),
)


def _run_trace(sched_cls, engine_cls, config_cls, queue_full, adaptive,
               engine_mod, monkeypatch):
    clock, log = FakeClock(), []
    # the engine times its dispatches (compile_s, which the scheduler
    # subtracts from its service estimates) with time.perf_counter: read
    # the trace's clock there too, so no real seconds reach the decisions
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(perf_counter=clock))
    engine = engine_cls(_stub(clock, log, adaptive),
                        config_cls(batch_size=4, adaptive=adaptive))
    s = sched_cls(engine, slo_ms=200.0, max_queue=6, adaptive=adaptive,
                  max_iters=FULL, min_iters=4, clock=clock)
    decisions, seed = [], 0
    for dt, action, arg in TRACE:
        clock.advance(dt)
        if action == "submit":
            seed += 1
            try:
                s.submit_async(_item(*arg, seed=seed))
                decisions.append(("admitted", arg))
            except queue_full:
                decisions.append(("refused", arg))
        elif action == "drain":
            s.drain(timeout=0)
        else:
            before = dict(s.stats.record())
            went = s.poll_once()
            after = s.stats.record()
            why = [k for k in ("dispatch_full", "dispatch_slo",
                               "dispatch_drain") if after[k] != before[k]]
            decisions.append(("poll", went, why,
                              log[-1] if went else None))
    rec = s.stats_record()
    est = rec.pop("service_est_ms")
    rec.pop("iter_est_ms", None)
    return decisions, rec, est


@pytest.mark.parametrize("adaptive", [False, True])
def test_scheduler_decisions_equal_jax(adaptive, monkeypatch):
    j_dec, j_rec, j_est = _run_trace(JScheduler, JEngine, JConfig,
                                     JQueueFull, adaptive, j_engine_mod,
                                     monkeypatch)
    t_dec, t_rec, t_est = _run_trace(Scheduler, InferenceEngine, ServeConfig,
                                     QueueFull, adaptive, t_engine_mod,
                                     monkeypatch)
    assert t_dec == j_dec
    assert t_rec == j_rec
    # both engines and schedulers read the one fake clock: the learned
    # estimates are the same arithmetic on the same seconds
    assert t_est == j_est
    polls = [d for d in t_dec if d[0] == "poll" and d[1]]
    assert {tuple(d[2]) for d in polls} == {("dispatch_full",),
                                            ("dispatch_slo",),
                                            ("dispatch_drain",)}
    assert ("refused", (48, 64)) in t_dec
    if adaptive:
        assert len({d[3][1] for d in polls}) > 1  # budgets moved


def test_scheduler_engine_error_reaches_every_caller():
    def broken(im1, im2, flow_init=None):
        raise RuntimeError("kernel launch failed")

    s = Scheduler(InferenceEngine(broken, ServeConfig(batch_size=2)),
                  slo_ms=100.0, clock=FakeClock())
    r1, r2 = s.submit_async(_item()), s.submit_async(_item(seed=1))
    assert s.poll_once()
    assert isinstance(r1.error, RuntimeError) and r2.error is r1.error
    assert s.stats.failed == 2


def test_scheduler_drain_through_the_dispatcher_thread():
    s = Scheduler(InferenceEngine(_stub(FakeClock(), [], False),
                                  ServeConfig(batch_size=4)),
                  slo_ms=100_000.0).start()
    r1, r2 = s.submit_async(_item()), s.submit_async(_item(seed=1))
    assert s.drain(timeout=10.0)
    assert r1.event.wait(5.0) and r2.event.wait(5.0)
    assert r1.result.flow_up.shape == (40, 56, 2)
    assert s.stats.dispatch_drain == 1
    with pytest.raises(SchedulerClosed):
        s.submit_async(_item())
    s.close()


# ---- sessions -------------------------------------------------------------


SESSION_OPS = (
    (0.0, "put", "a", (40, 56)),
    (0.0, "put", "b", (40, 56)),
    (1.0, "get", "a", (40, 56)),
    (0.0, "put", "c", (40, 56)),      # max 2: evicts b (a was touched)
    (0.0, "get", "b", (40, 56)),
    (0.0, "get", "c", (64, 80)),      # bucket change: cold, dropped
    (0.0, "get", "c", (40, 56)),
    (5.0, "put", "d", (40, 56)),
    (6.0, "get", "a", (40, 56)),      # silent 11 s > ttl 10: expired
    (0.0, "get", "d", (40, 56)),
    (0.0, "get", "zz", (40, 56)),     # never seen
)


def _run_sessions(store_cls):
    clock = FakeClock()
    st = store_cls(ttl_s=10.0, max_sessions=2, clock=clock)
    out = []
    for i, (dt, op, sid, bucket) in enumerate(SESSION_OPS):
        clock.advance(dt)
        if op == "put":
            st.put(sid, bucket, np.full((5, 7, 2), i, np.float32))
        else:
            got = st.get(sid, bucket)
            out.append(None if got is None else float(got[0, 0, 0]))
    return out, st.stats_record(), len(st)


def test_session_store_equals_jax():
    ours, theirs = _run_sessions(SessionStore), _run_sessions(JSessionStore)
    assert ours == theirs
    out, rec, n = ours
    assert out == [0.0, None, None, None, None, 7.0, None]
    assert rec["lru_evicted"] == 1 and rec["bucket_resets"] == 1
    assert rec["expired"] == 1 and rec["misses"] == 3 and n == 1


def test_session_store_keeps_device_tensors_as_they_are():
    st = SessionStore(ttl_s=10.0, clock=FakeClock())
    carry = torch.ones(5, 7, 2)
    st.put("cam", (40, 56), carry)
    assert st.get("cam", (40, 56)) is carry
    st.reset_counters()
    assert st.stats_record()["hits"] == 0 and len(st) == 1


# ---- the pipelined engine's accounting -----------------------------------


def _stub_carry(im1, im2, flow_init=None):
    """flow_low = flow_init + 0.5 (zeros when cold), as tensors: the
    carry is visible in the output."""
    b, h, w = im1.shape[:3]
    fi = (torch.zeros(b, h // 8, w // 8, 2) if flow_init is None
          else torch.as_tensor(flow_init))
    return fi + 0.5, torch.ones(b, h, w, 2)


def test_engine_inflight_window_and_search_accounting():
    eng = InferenceEngine(_stub_carry, ServeConfig(batch_size=1, inflight=2))
    out = list(eng.stream([_item(seed=i) for i in range(5)]))
    assert sorted(r.index for r in out) == list(range(5))
    assert eng.stats.peak_inflight == 2 and eng.stats.fetches == 5
    assert eng.registry.searches == 1          # one (bucket, cold) key
    rec = eng.stats_record()
    assert rec["searched"] == ["40x56"] and rec["inflight"] == 2
    eng.reset_stats()
    assert eng.stats.frames == 0 and eng.compile_s == 0.0
    list(eng.stream([_item()]))
    assert eng.registry.searches == 1          # no second search
    with pytest.raises(ValueError, match="A13"):
        ServeConfig(strict=True)
    with pytest.raises(ValueError, match="A12"):
        InferenceEngine(_stub_carry, mesh=object())


def test_device_carry_moves_no_host_bytes():
    """A warm row that is a device tensor rides into the batch as it is
    and Result.flow_low stays a tensor: no carry bytes either way. On the
    host path the same carry costs its bytes in both directions."""
    dev = InferenceEngine(_stub_carry, ServeConfig(
        batch_size=2, warm_start=True, device_carry=True), device="cpu")
    (cold,) = dev.run_batch([_item()])
    assert isinstance(cold.flow_low, torch.Tensor)
    (warm,) = dev.run_batch([dict(_item(), flow_init=cold.flow_low)])
    torch.testing.assert_close(warm.flow_low, torch.full((5, 7, 2), 1.0))
    assert dev.stats.carry_h2d_bytes == dev.stats.carry_d2h_bytes == 0

    host = InferenceEngine(_stub_carry, ServeConfig(
        batch_size=2, warm_start=True), device="cpu")
    (cold,) = host.run_batch([_item()])
    assert isinstance(cold.flow_low, np.ndarray)
    host.run_batch([dict(_item(), flow_init=cold.flow_low)])
    assert host.stats.carry_h2d_bytes == 5 * 7 * 2 * 4
    assert host.stats.carry_d2h_bytes == 2 * (2 * 5 * 7 * 2 * 4)
    with pytest.raises(ValueError, match="device_carry"):
        host.run_batch([dict(_item(), flow_init=torch.zeros(5, 7, 2))])
