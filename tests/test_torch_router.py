"""The port's fleet router against the JAX package's.

``dexiraft_tpu_torch/serve/router.py`` is a copy of
``dexiraft_tpu/serve/router.py`` with the port's imports, so every
decision must be the same: the hash ring's owners and failover chains
(1000 keys, across an add and a remove), the breaker's transitions, the
drain's waits, the retry-once and admission answers, and the affinity
counters. Each scenario runs through both packages on the same fake
clock and fake prober (the doubles of ``tests/test_zzfleet_router.py``)
and the recorded decisions must be equal. The ``/stats`` key sets are
compared block by block. One test starts the port's router over two port
replicas (stub engines in child processes), SIGKILLs one under session
traffic and requires zero 5xx.
"""

import json
import os
import os.path as osp
import signal
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

import dexiraft_tpu.serve.router as jr
import dexiraft_tpu_torch.serve.router as tr

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
KEYS = [f"session-{i}" for i in range(1000)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---- the hash ring --------------------------------------------------------


def _ring_trace(mod):
    ring = mod.HashRing(["r0", "r1", "r2", "r3"])
    out = [([ring.lookup(k) for k in KEYS], [ring.chain(k) for k in KEYS])]
    ring.add("r4")
    out.append(([ring.lookup(k) for k in KEYS],
                [ring.chain(k) for k in KEYS]))
    ring.remove("r1")
    out.append(([ring.lookup(k) for k in KEYS],
                [ring.chain(k) for k in KEYS]))
    return out, ring.vnodes, sorted(ring.members)


def test_hash_ring_lookups_and_chains_equal_jax():
    ours, theirs = _ring_trace(tr), _ring_trace(jr)
    assert ours == theirs
    trace, vnodes, members = ours
    assert vnodes == 64 and members == ["r0", "r2", "r3", "r4"]
    (before, _), (added, _), (removed, _) = trace
    moved = [i for i in range(len(KEYS)) if before[i] != added[i]]
    assert moved and all(added[i] == "r4" for i in moved)
    assert all(removed[i] == added[i] for i in range(len(KEYS))
               if added[i] != "r1")


# ---- pool and router scenarios, run through both packages ---------------


def _pool(mod, n=2, payloads=None):
    clock = FakeClock()
    payloads = payloads if payloads is not None else {
        f"r{i}": {"_status": 200, "draining": False, "inflight": 0}
        for i in range(n)}

    def prober(replica):
        v = payloads[replica.rid]
        if isinstance(v, Exception):
            raise v
        return dict(v)

    pool = mod.ReplicaPool(
        {f"r{i}": f"127.0.0.1:{9000 + i}" for i in range(n)},
        mod.RouterConfig(fail_threshold=3, cooldown_s=5.0,
                         probe_interval_s=1.0, vnodes=16),
        clock=clock, prober=prober, sleep=clock.advance)
    return pool, clock, payloads


def _snap(pool):
    return {rid: (r.state, r.fails, r.opened_at, r.ready, r.draining)
            for rid, r in pool.replicas.items()}, sorted(pool.ring.members)


def _breaker(mod):
    pool, clock, payloads = _pool(mod)
    out = []
    for _ in range(2):
        pool.mark_failure("r0")
        out.append(_snap(pool))
    payloads["r0"] = ConnectionRefusedError("down")
    pool.mark_failure("r0")                      # threshold: open
    out.append(_snap(pool))
    for dt in (1.0, 5.0):                        # cooling, then half-open
        clock.advance(dt)
        pool.probe_once()
        out.append(_snap(pool))
    payloads["r0"] = {"_status": 200, "draining": False, "inflight": 0}
    clock.advance(5.5)
    pool.probe_once()                            # the trial succeeds
    out.append(_snap(pool))
    pool.mark_alive("r1", {"_status": 503, "draining": True, "inflight": 4})
    out.append(_snap(pool))
    out.append(pool.record()["breaker_opens"])
    return out


def _affinity(mod):
    pool, clock, _ = _pool(mod, 3)
    out = [pool.route(sid).rid for sid in ("cam-0", "cam-1", "cam-0")]
    out += [pool.route(None).rid for _ in range(6)]
    owner = pool.route("cam-0").rid
    for _ in range(3):
        pool.mark_failure(owner)
    out += [pool.route("cam-0").rid, pool.route("cam-0").rid]
    out.append(pool.alternate(pool.ring.chain("cam-1")[0], "cam-1").rid)
    out.append(pool.alternate("r0", None).rid)
    out.append(pool.affinity_record())
    for rid in list(pool.replicas):
        for _ in range(3):
            pool.mark_failure(rid)
    try:
        pool.route("cam-2")
    except mod.NoHealthyReplica as e:
        out.append(str(e))
    return out


def _drain(mod):
    out = []
    pool, clock, _ = _pool(mod)
    inflight = [3, 2, 1, 0]
    restarted = []
    pool.replicas["r0"].restart = lambda: restarted.append(clock())
    pool.prober = lambda r: {"_status": 503, "draining": True,
                             "inflight": inflight.pop(0) if inflight else 0}
    out += [pool.drain("r0", timeout_s=60.0, poll_s=1.0), restarted,
            _snap(pool)]
    pool, clock, _ = _pool(mod)                 # busy past the timeout
    pool.replicas["r0"].restart = lambda: restarted.append("busy")
    pool.prober = lambda r: {"_status": 200, "draining": False,
                             "inflight": 5}
    out += [pool.drain("r0", timeout_s=3.0, poll_s=1.0), restarted]
    pool, clock, _ = _pool(mod)                 # dead: drained at once

    def dead(r):
        raise ConnectionRefusedError("gone")

    pool.prober = dead
    out += [pool.drain("r0", timeout_s=10.0), pool.record()["drains"]]
    return out


class _Up:
    """Scripted upstream: pops the next outcome per call (an Exception is
    raised, a status becomes the module's _UpstreamResult)."""

    def __init__(self, mod, outcomes, clock=None, burn=0.0):
        self.mod, self.outcomes, self.hits = mod, list(outcomes), []
        self.clock, self.burn = clock, burn

    def __call__(self, replica, body, session_id, content_type, timeout):
        self.hits.append(replica.rid)
        if self.clock is not None:
            self.clock.advance(self.burn)
        out = self.outcomes.pop(0)
        if isinstance(out, Exception):
            raise out
        return self.mod._UpstreamResult(out, b"{}", {})


RETRY_CASES = {
    "refused_then_ok": ([ConnectionRefusedError("dead"), 200], {}),
    "retry_once_then_502": ([ConnectionRefusedError("a"),
                             ConnectionRefusedError("b"), 200], {}),
    "both_shed_503": ([503, 503], {}),
    "reset_then_shed": ([ConnectionResetError("x"), 503], {}),
    "timeout_no_retry_502": ([TimeoutError("slow"), 200], {}),
    "deadline_504": ([ConnectionResetError("mid-flight")],
                     {"deadline_s": 1.0, "burn": 2.0}),
    "admission_503": ([200], {"max_inflight": 1, "parked": 1}),
    "no_healthy_503": ([200], {"all_open": True}),
}


def _retry(mod, case, session):
    outcomes, kw = RETRY_CASES[case]
    kw = dict(kw)
    clock = FakeClock()
    burn, parked = kw.pop("burn", 0.0), kw.pop("parked", 0)
    all_open = kw.pop("all_open", False)
    router = mod.Router({f"r{i}": f"127.0.0.1:{9100 + i}" for i in range(2)},
                        port=0, clock=clock, config=mod.RouterConfig(
                            retry_backoff_s=0.0, vnodes=16, **kw))
    try:
        up = _Up(mod, outcomes, clock, burn)
        router._upstream = up
        router._inflight = parked
        if all_open:
            for rid in list(router.pool.replicas):
                for _ in range(3):
                    router.pool.mark_failure(rid)
        status, body, headers = router.proxy_flow(b"x", session,
                                                  "application/x-npz")
        rec = router.stats.record()
        return (status, json.loads(body) if status != 200 else body,
                headers, up.hits, rec,
                {rid: r.fails for rid, r in router.pool.replicas.items()})
    finally:
        router._inflight = 0
        router._httpd.server_close()


@pytest.mark.parametrize("scenario", ["breaker", "affinity", "drain"])
def test_pool_decisions_equal_jax(scenario):
    run = {"breaker": _breaker, "affinity": _affinity, "drain": _drain}[
        scenario]
    ours, theirs = run(tr), run(jr)
    assert ours == theirs
    if scenario == "breaker":
        assert ours[2][0]["r0"][0] == jr.OPEN
        assert ours[5][0]["r0"][0] == jr.CLOSED and "r0" in ours[5][1]
        assert ours[-1] == 2      # the first open and the half-open retry
    elif scenario == "affinity":
        assert ours[-2]["sticky_misses"] == 1
        assert ours[-1].startswith("0 of 3")
    else:
        assert ours[0]["drained"] and ours[0]["waited_s"] == 3.0
        assert ours[3]["drained"] is False and ours[4] == [3.0]


@pytest.mark.parametrize("session", [None, "cam-0"])
@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_and_admission_equal_jax(case, session):
    ours, theirs = _retry(tr, case, session), _retry(jr, case, session)
    assert ours == theirs
    status, _, headers, hits, rec, _ = ours
    expect = {"refused_then_ok": 200, "retry_once_then_502": 502,
              "both_shed_503": 503, "reset_then_shed": 503,
              "timeout_no_retry_502": 502, "deadline_504": 504,
              "admission_503": 503, "no_healthy_503": 503}[case]
    assert status == expect
    if case == "refused_then_ok":
        assert len(hits) == 2 and hits[0] != hits[1]
        assert headers["X-Router-Retries"] == "1" and rec["failovers"] == 1
    if case == "retry_once_then_502":
        assert len(hits) == 2


def _stats_keys(rec):
    """Nested key sets of a router /stats record (replica health payloads
    and the lock gauges left out: they are the replicas' and the
    process's)."""
    out = {"top": set(rec)}
    for k in ("router", "pool", "autoscale", "locks"):
        out[k] = set(rec[k])
    out["affinity"] = set(rec["pool"]["affinity"])
    out["replica"] = {frozenset(r) for r in rec["pool"]["replicas"].values()}
    return out


def test_stats_key_sets_equal_jax():
    recs = []
    for mod in (tr, jr):
        router = mod.Router({"r0": "127.0.0.1:9200", "r1": "127.0.0.1:9201"},
                            port=0, config=mod.RouterConfig(vnodes=16))
        try:
            recs.append(_stats_keys(router.stats_record()))
        finally:
            router._httpd.server_close()
    ours, theirs = recs
    # the port's lock registry keeps no acquisition graph (serve/locks.py),
    # so its locks block has no cycle count; every other key is JAX's
    assert theirs["locks"] - ours["locks"] == {"cycles"}
    ours.pop("locks"), theirs.pop("locks")
    assert ours == theirs
    assert theirs["top"] == {"router", "pool", "autoscale", "locks"}


# ---- the router over two port replicas in child processes ---------------


# a port replica: the real FlowService (HTTP, scheduler, sessions) over a
# numpy stub engine whose warm rows add their carry, so it boots in about
# a second and a SIGKILL is a real process death
_REPLICA = r"""
import sys
import numpy as np
from dexiraft_tpu_torch.serve import FlowService, InferenceEngine, ServeConfig

def stub(im1, im2, flow_init=None):
    b, h, w = im1.shape[:3]
    up = np.broadcast_to(np.float32([2.0, -1.0]), (b, h, w, 2)).copy()
    low = np.full((b, h // 8, w // 8, 2), 0.5, np.float32)
    if flow_init is not None:
        fi = np.asarray(flow_init)
        up = up + np.repeat(np.repeat(fi, 8, 1), 8, 2)
        low = low + fi
    return low, up

svc = FlowService(InferenceEngine(stub, ServeConfig(batch_size=2,
                                                    warm_start=True),
                                  device="cpu"),
                  host="127.0.0.1", port=int(sys.argv[1]), slo_ms=30.0,
                  max_queue=32, session_ttl_s=60.0)
svc.install_signal_handlers()
svc.start()
while not svc.stopped.wait(0.5):
    pass
"""


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _post(url, body, session):
    req = urllib.request.Request(
        url + "/v1/flow", data=body,
        headers={"Content-Type": "application/x-npz", "X-Session-Id": session})
    with urllib.request.urlopen(req, timeout=15.0) as r:
        return r.status, dict(r.headers), r.read()


def test_port_router_over_port_replicas_kill_one_no_5xx():
    from dexiraft_tpu_torch.router_cli import wait_ready
    from dexiraft_tpu_torch.serve.server import (decode_response,
                                                 encode_request)

    env = {**os.environ,
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    ports = _free_ports(2)
    procs = {f"r{i}": subprocess.Popen(
        [sys.executable, "-c", _REPLICA, str(p)], env=env,
        start_new_session=True) for i, p in enumerate(ports)}
    router = None
    try:
        for i, p in enumerate(ports):
            assert wait_ready("127.0.0.1", p, 60.0), f"replica r{i} not up"
        router = tr.Router(
            {f"r{i}": f"127.0.0.1:{p}" for i, p in enumerate(ports)},
            port=0, config=tr.RouterConfig(probe_interval_s=0.1,
                                           cooldown_s=0.5, fail_threshold=2,
                                           retry_backoff_s=0.01)).start()
        rng = np.random.default_rng(0)
        body = encode_request(
            rng.uniform(0, 255, (40, 56, 3)).astype(np.float32),
            rng.uniform(0, 255, (40, 56, 3)).astype(np.float32))
        sessions = [f"s-{i}" for i in range(4)]
        served_by = {}
        for k in range(3):
            for sid in sessions:
                status, hdr, data = _post(router.url, body, sid)
                assert status == 200
                if k:
                    assert hdr["X-Replica"] == served_by[sid]
                    # the replica's warm carry reached the answer
                    assert decode_response(data)[0, 0, 0] > 2.0
                served_by[sid] = hdr["X-Replica"]
        assert router.pool.affinity_record()["hit_rate"] == 1.0

        victim = served_by["s-0"]
        procs[victim].kill()
        procs[victim].wait()
        survivors = []
        for k in range(3):
            for sid in sessions:
                status, hdr, _ = _post(router.url, body, sid)
                assert status == 200, (sid, k)
                survivors.append(hdr["X-Replica"])
        assert victim not in survivors
        rec = router.stats.record()
        assert rec["upstream_errors"] == 0 and rec["failovers"] >= 1
        assert router.pool.affinity_record()["sticky_misses"] >= 1
        assert router.pool.replicas[victim].state == tr.OPEN
        with urllib.request.urlopen(router.url + "/healthz",
                                    timeout=5.0) as r:
            assert json.load(r)["healthy"] == 1
        assert router.stats_record()["locks"]["order_violations"] == 0
    finally:
        if router is not None:
            router.stop()
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
