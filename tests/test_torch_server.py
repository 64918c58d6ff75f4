"""The port's flow service (serve/server.py) against the JAX package's.

On a numpy stub engine: the HTTP surface (/v1/flow round trip with a
session carry, 400 on malformed bodies, 404), the /healthz and /stats key
sets against the JAX FlowService's with every intended difference listed
below, overload shedding with 503 and a SIGTERM drain that answers every
admitted request. Then the slice as a whole: a JAX FlowService (the JAX
CLI's synthetic init from PRNGKey(0), its eval step) and the port's, on
the same weights through ``raft_state_dict_from_jax``, answer the same
npz ``POST /v1/flow`` (v1 small: a cold request and a session's warm
second request, rtol 5e-3) and ``POST /v1/flow/stream`` (v5 small, rtol
1e-2; docs/parity.md).
"""

import json
import os
import signal
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu import serve_cli as j_cli
from dexiraft_tpu.config import VARIANTS as J_VARIANTS
from dexiraft_tpu.eval_cli import _make_eval_fn as j_make_eval_fn
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu.serve import FlowService as JFlowService
from dexiraft_tpu.serve import InferenceEngine as JEngine
from dexiraft_tpu.serve import ServeConfig as JConfig
from dexiraft_tpu_torch import serve_cli
from dexiraft_tpu_torch.config import VARIANTS
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.ops import corr_kernels
from dexiraft_tpu_torch.serve import (FlowService, InferenceEngine,
                                      ServeConfig)
from dexiraft_tpu_torch.serve.server import (decode_response,
                                             decode_stream_response,
                                             encode_request,
                                             encode_response,
                                             encode_stream_request)
from test_torch_raft import _randomize
from test_torch_train_ops import few_torch_threads  # noqa: F401

ITERS = 2
RTOL, ATOL = 5e-3, 1e-3

# the port's /healthz and /stats against the JAX service's
HEALTH_DIFF = {"device"}   # the step's device
ENGINE_DIFF = {  # the first dispatch of a signature runs cuDNN's search
    "compile_s": "search_s", "compiles": "searches",
    "compiled": "searched"}
LOCKS_DIFF = {"cycles"}  # every port lock is ranked: no graph to search
# the device memory the process holds (None off the card)
SERVICE_DIFF = {"device_memory_reserved_bytes", "kernel_launches"}


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    """2 torch threads: the suite runs 6 workers at once on 8 cores."""
    yield


def _stub_eval(im1, im2, flow_init=None):
    """Constant (2, -1) flow; a warm row adds its upsampled flow_init and
    flow_low = flow_init + 0.5, so the carry shows in the answer."""
    b, h, w = im1.shape[:3]
    up = np.broadcast_to(np.float32([2.0, -1.0]), (b, h, w, 2)).copy()
    low = np.full((b, h // 8, w // 8, 2), 0.5, np.float32)
    if flow_init is not None:
        fi = np.asarray(flow_init)
        up = up + np.repeat(np.repeat(fi, 8, 1), 8, 2)
        low = low + fi
    return low, up


def _item(h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (h, w, 3)).astype(np.float32)}


def _post(url, body, session=None, path="/v1/flow", timeout=120.0):
    headers = {"Content-Type": "application/x-npz"}
    if session:
        headers["X-Session-Id"] = session
    req = urllib.request.Request(url + path, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers)


def _get_json(url, path):
    with urllib.request.urlopen(url + path, timeout=10.0) as r:
        return r.status, json.load(r)


def _stub_service(svc_cls, engine_cls, config_cls, **kw):
    return svc_cls(engine_cls(_stub_eval, config_cls(batch_size=2,
                                                      warm_start=True)),
                   port=0, slo_ms=50.0, max_queue=8, session_ttl_s=30.0,
                   **kw).start()


@pytest.fixture()
def service():
    svc = _stub_service(FlowService, InferenceEngine, ServeConfig)
    yield svc
    if not svc.stopped.is_set():
        svc.drain_and_stop(timeout=10.0)


def test_flow_roundtrip_session_carry_and_errors(service):
    body = encode_request(**_item())
    status, out, hdr = _post(service.url, body, session="cam-1")
    assert status == 200 and hdr["X-Warm-Start"] == "0"
    assert hdr["X-Bucket"] == "40x56"
    flow = decode_response(out)
    np.testing.assert_allclose(flow, np.broadcast_to(
        np.float32([2.0, -1.0]), (40, 56, 2)))
    # the second frame of the stream rides the carry the dispatcher
    # stored (the stub adds its 0.5 px)
    _, out2, hdr2 = _post(service.url, body, session="cam-1")
    assert hdr2["X-Warm-Start"] == "1"
    np.testing.assert_allclose(decode_response(out2), np.broadcast_to(
        np.float32([2.5, -0.5]), (40, 56, 2)))
    _, out3, hdr3 = _post(service.url, body)
    assert hdr3["X-Warm-Start"] == "0"
    np.testing.assert_allclose(decode_response(out3), flow)
    for bad in (b"junk", encode_response(np.zeros((4, 4, 2))),
                encode_request(np.zeros((8, 8), np.float32),
                               np.zeros((8, 8), np.float32))):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(service.url, bad)
        assert ei.value.code == 400 and "error" in json.load(ei.value)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get_json(service.url, "/nope")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:  # no VideoEngine
        _post(service.url, encode_stream_request(np.zeros((2, 8, 8, 3))),
              path="/v1/flow/stream")
    assert ei.value.code == 404


def _key_sets(svc):
    _post(svc.url, encode_request(**_item()))
    _, health = _get_json(svc.url, "/healthz")
    _, stats = _get_json(svc.url, "/stats?reset=1")
    _, after = _get_json(svc.url, "/stats")
    return health, stats, after


def test_healthz_and_stats_keys_equal_jax_but_listed_differences(service):
    jsvc = _stub_service(JFlowService, JEngine, JConfig)
    try:
        j_health, j_stats, _ = _key_sets(jsvc)
    finally:
        jsvc.drain_and_stop(timeout=10.0)
    health, stats, after = _key_sets(service)
    assert set(health) == set(j_health) | HEALTH_DIFF
    assert health["device"] is None    # a stub engine names no device
    assert set(stats) == set(j_stats)
    assert set(stats["service"]) == set(j_stats["service"]) | SERVICE_DIFF
    assert stats["service"]["device_memory_reserved_bytes"] is None
    assert set(stats["service"]["kernel_launches"]) == set(
        corr_kernels.KERNEL_LIBRARY_OF)
    for block in ("scheduler", "sessions"):
        assert set(stats[block]) == set(j_stats[block]), block
    assert stats["video"] is None and j_stats["video"] is None
    assert set(stats["engine"]) == {ENGINE_DIFF.get(k, k)
                                    for k in j_stats["engine"]}
    assert set(stats["locks"]) == set(j_stats["locks"]) - LOCKS_DIFF
    assert stats["locks"]["order_violations"] == 0
    assert stats["engine"]["searched"] == ["40x56+warm"]
    assert stats["scheduler"]["submitted"] == 1
    # ?reset=1 zeroed the window; the searched signatures survive
    assert after["scheduler"]["submitted"] == 0
    assert after["engine"]["frames"] == 0
    assert after["engine"]["searched"] == ["40x56+warm"]
    assert set(ENGINE_DIFF) <= set(j_stats["engine"])


def _gated_service(gate, max_queue):
    def gated(im1, im2, flow_init=None):
        gate.wait(10.0)
        return _stub_eval(im1, im2, flow_init)

    return FlowService(InferenceEngine(gated, ServeConfig(batch_size=1)),
                       port=0, slo_ms=50.0, max_queue=max_queue,
                       session_ttl_s=0.0).start()


def _post_bg(url, body, results, started=None):
    def run():
        if started is not None:
            started.set()
        try:
            results.append(_post(url, body)[0])
        except urllib.error.HTTPError as e:
            results.append(e.code)

    t = threading.Thread(target=run)
    t.start()
    return t


def _wait_for(pred, timeout=10.0):
    ev = threading.Event()
    for _ in range(int(timeout / 0.01)):
        if pred():
            return True
        ev.wait(0.01)
    return pred()


def test_overload_sheds_with_503():
    gate = threading.Event()
    svc = _gated_service(gate, max_queue=2)
    try:
        body = encode_request(**_item())
        results = []
        threads = [_post_bg(svc.url, body, results)]
        # one request inside the engine, then two that fill the queue
        assert _wait_for(lambda: svc.scheduler.inflight() == 1
                         and svc.scheduler.queue_depth() == 0)
        threads += [_post_bg(svc.url, body, results) for _ in range(2)]
        assert _wait_for(lambda: svc.scheduler.queue_depth() == 2)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(svc.url, body)
        assert ei.value.code == 503
        assert "Retry-After" in dict(ei.value.headers)
        gate.set()
        for t in threads:
            t.join(10.0)
        assert results == [200, 200, 200]
        assert svc.scheduler.stats.rejected == 1
    finally:
        gate.set()
        svc.drain_and_stop(timeout=10.0)


def test_sigterm_drains_admitted_requests():
    """A real SIGTERM through the installed handler while one request is
    in the engine and one queued: both answer 200, new work gets 503,
    /healthz says draining while /livez stays alive."""
    gate = threading.Event()
    svc = _gated_service(gate, max_queue=8)
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        assert svc.install_signal_handlers()
        body = encode_request(**_item())
        results = []
        threads = [_post_bg(svc.url, body, results) for _ in range(2)]
        assert _wait_for(lambda: svc.scheduler.inflight() == 2)
        os.kill(os.getpid(), signal.SIGTERM)
        assert _wait_for(lambda: svc.draining)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get_json(svc.url, "/healthz")
        assert ei.value.code == 503
        assert _get_json(svc.url, "/livez") == (200, {"status": "alive"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(svc.url, body)
        assert ei.value.code == 503
        gate.set()
        assert svc.stopped.wait(10.0)
        for t in threads:
            t.join(10.0)
        assert results == [200, 200]
        assert svc.scheduler.stats.completed == 2
    finally:
        gate.set()
        for s, h in prev.items():
            signal.signal(s, h)
        if not svc.stopped.is_set():
            svc.drain_and_stop(timeout=10.0)


# ---- the slice: the JAX service and the port's on the same weights -------


def _frames(n, h=48, w=64, seed=0, shift=2):
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3)),
                   np.ones((8, 8, 1)))[:h, :w]
    return [np.clip(np.roll(base, shift * i, axis=1)
                    + rng.normal(0, 2, base.shape), 0, 255).astype(np.float32)
            for i in range(n)]


def _jax_args(variant, extra=()):
    return j_cli.build_parser().parse_args(
        ["--synthetic_init", "--variant", variant, "--small", "--iters",
         str(ITERS), "--batch_size", "2", "--bucket_multiple", "8",
         "--port", "0", "--cpu", "--no_compile_cache", *extra])


def _port_args(variant, extra=()):
    return serve_cli.build_parser().parse_args(
        ["--synthetic_init", "--variant", variant, "--small", "--iters",
         str(ITERS), "--batch_size", "2", "--bucket_multiple", "8",
         "--port", "0", "--cpu", *extra])


def _port_model(cfg, variables):
    model = RAFT(cfg)
    model.load_state_dict(raft_state_dict_from_jax(variables, cfg=cfg),
                          strict=True)
    return model.eval()


def test_slice_pair_and_warm_session_match_jax():
    """v1 small, the JAX CLI's synthetic init (PRNGKey(0)) and eval step
    (allpairs off the TPU, host carry) against the port's service on the
    bridged weights (flash fused, its plain version on the CPU, device
    carry): a cold request and a session's warm second request."""
    jargs = _jax_args("v1", ["--host_carry"])
    jcfg, variables = j_cli._load(jargs)
    j_eval, mesh = j_make_eval_fn(jargs, jcfg, variables, ITERS)
    jengine = JEngine(j_eval, JConfig.from_args(
        jargs, warm_start=True, device_carry=False), mesh=mesh)
    jsvc = JFlowService(jengine, port=0, slo_ms=50.0, session_ttl_s=30.0,
                        carry_fn=j_cli._make_carry_fn(device=False)).start()

    cfg = VARIANTS["v1"](small=True, corr_impl="flash", fused_update=True)
    model = _port_model(cfg, variables)
    args = _port_args("v1")
    dev = torch.device("cpu")
    engine = InferenceEngine(
        serve_cli._make_eval_fn(args, model, ITERS, dev),
        ServeConfig.from_args(args, warm_start=True, device_carry=True),
        device=dev)
    svc = FlowService(engine, port=0, slo_ms=50.0, session_ttl_s=30.0,
                      carry_fn=serve_cli._make_carry_fn(dev)).start()
    try:
        f = _frames(3, seed=11)
        out = {}
        for name, s in (("jax", jsvc), ("port", svc)):
            flows = []
            for j in range(2):
                _, body, hdr = _post(s.url, encode_request(f[j], f[j + 1]),
                                     session="cam")
                flows.append((decode_response(body), hdr["X-Warm-Start"]))
            out[name] = flows
    finally:
        jsvc.drain_and_stop(timeout=30.0)
        svc.drain_and_stop(timeout=30.0)
    for (jf, jw), (tf, tw) in zip(out["jax"], out["port"]):
        assert (jw, tw) in {("0", "0"), ("1", "1")}
        assert tf.shape == (48, 64, 2)
        assert np.abs(jf).max() > 1e-2
        np.testing.assert_allclose(tf, jf, rtol=RTOL, atol=ATOL)
    assert [w for _, w in out["port"]] == ["0", "1"]
    rec = engine.stats_record()
    assert rec["carry_h2d_bytes"] == rec["carry_d2h_bytes"] == 0


def test_slice_stream_matches_jax():
    """v5 small (seeded weights on the JAX tree): one 3-frame chunk and a
    warm 2-frame chunk through POST /v1/flow/stream of the JAX service
    (its VideoEngine, jitted encode/refine) and of the port's, rtol 1e-2."""
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    jcfg = J_VARIANTS["v5"](small=True, corr_impl="local")
    variables = _randomize(jax.eval_shape(lambda: JRAFT(jcfg).init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False)), 61)
    jargs = _jax_args("v5", ["--corr_impl", "local"])
    jengine = JEngine(_stub_eval, JConfig(batch_size=2, warm_start=True))
    jvideo = j_cli._make_video_engine(jargs, jcfg, variables, None, True,
                                      watch=jengine.watch)
    jsvc = JFlowService(jengine, port=0, session_ttl_s=30.0,
                        video=jvideo).start()

    cfg = VARIANTS["v5"](small=True, corr_impl="flash", fused_update=True)
    model = _port_model(cfg, variables)
    args = _port_args("v5")
    video = serve_cli._make_video_engine(args, cfg, model,
                                         torch.device("cpu"), True)
    svc = FlowService(InferenceEngine(_stub_eval, ServeConfig(batch_size=2)),
                      port=0, session_ttl_s=30.0, video=video).start()
    try:
        f = _frames(5, seed=13)
        out = {}
        for name, s in (("jax", jsvc), ("port", svc)):
            chunks = []
            for part in (f[:3], f[3:]):
                _, body, hdr = _post(s.url, encode_stream_request(
                    np.stack(part)), session="cam", path="/v1/flow/stream")
                chunks.append((decode_stream_response(body),
                               hdr["X-Warm-Start"], hdr["X-Flows-Out"]))
            out[name] = chunks
    finally:
        jsvc.drain_and_stop(timeout=30.0)
        svc.drain_and_stop(timeout=30.0)
    assert [c[1:] for c in out["port"]] == [("0", "2"), ("1", "2")]
    for (jf, *jh), (tf, *th) in zip(out["jax"], out["port"]):
        assert th == jh and tf.shape == jf.shape == (2, 48, 64, 2)
        assert np.abs(jf).max() > 1e-2
        np.testing.assert_allclose(tf, jf, rtol=1e-2, atol=ATOL)
