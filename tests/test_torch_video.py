"""The port's streaming tier: the encode/step split of the model, the
device session store, the VideoEngine's chunk and carry semantics, and
forward_interpolate, against the JAX package where it has a counterpart.

Mirrors tests/test_zzvideo.py (the store and chunk cases over numpy stubs,
the split-vs-monolithic pin, the streamed-vs-chained-pairs pin) and
tests/test_eval.py::TestWarmStartParity (the splat). The model cases run
the small configs on seeded random weights at 48x64.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import VARIANTS as J_VARIANTS
from dexiraft_tpu.eval.interpolate import forward_interpolate as j_splat
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu_torch.config import VARIANTS
from dexiraft_tpu_torch.eval.interpolate import forward_interpolate
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT, create_model
from dexiraft_tpu_torch.serve.locks import LockOrderViolation, OrderedLock
from dexiraft_tpu_torch.serve.sessions import DeviceSessionStore, carry_nbytes
from dexiraft_tpu_torch.serve.video import StreamOverloaded, VideoEngine
from dexiraft_tpu_torch.train.step import (make_encode_step, make_eval_step,
                                           make_refine_step)
from test_eval import _smooth_flow
from test_torch_raft import _randomize


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _feats(kb: int) -> dict:
    """A feature-dict stand-in of `kb` KiB (float32)."""
    return {"fmap": np.zeros((kb * 256,), np.float32)}


_FI = np.zeros((4, 4, 2), np.float32)  # 128 B flow seed


# ---- DeviceSessionStore --------------------------------------------------


class TestDeviceSessionStore:
    def test_byte_budget_evicts_oldest_and_counters_move(self):
        clock = FakeClock()
        st = DeviceSessionStore(budget_bytes=2 * 1024 + 512, ttl_s=60,
                                clock=clock)
        st.put("a", (32, 32), _feats(1), _FI)
        clock.advance(1)
        st.put("b", (32, 32), _feats(1), _FI)
        used = st.bytes_in_use
        assert used == 2 * carry_nbytes(_feats(1), _FI)
        clock.advance(1)
        st.put("c", (32, 32), _feats(1), _FI)
        assert st.get("a", (32, 32)) is None       # evicted
        assert st.get("b", (32, 32)) is not None
        assert st.get("c", (32, 32)) is not None
        rec = st.stats_record()
        assert rec["budget_evicted"] == 1 and rec["active"] == 2
        assert st.bytes_in_use == used

    def test_touch_order_protects_hot_streams(self):
        clock = FakeClock()
        st = DeviceSessionStore(budget_bytes=2 * 1024 + 512, ttl_s=60,
                                clock=clock)
        st.put("a", (32, 32), _feats(1), _FI)
        clock.advance(1)
        st.put("b", (32, 32), _feats(1), _FI)
        clock.advance(1)
        st.get("a", (32, 32))   # a is now most recent
        st.put("c", (32, 32), _feats(1), _FI)
        assert st.get("b", (32, 32)) is None
        assert st.get("a", (32, 32)) is not None

    def test_single_over_budget_stream_kept_and_counted(self):
        st = DeviceSessionStore(budget_bytes=1024, ttl_s=60,
                                clock=FakeClock())
        st.put("big", (64, 64), _feats(4), _FI)
        assert st.get("big", (64, 64)) is not None
        assert st.stats_record()["over_budget"] == 1
        assert st.stats_record()["budget_evicted"] == 0

    def test_bucket_change_resets_exactly_one_stream(self):
        st = DeviceSessionStore(budget_bytes=1 << 20, ttl_s=60,
                                clock=FakeClock())
        st.put("a", (32, 32), _feats(1), _FI)
        st.put("b", (32, 32), _feats(1), _FI)
        assert st.get("a", (64, 64)) is None
        rec = st.stats_record()
        assert rec["bucket_resets"] == 1 and rec["active"] == 1
        assert st.get("b", (32, 32)) is not None

    def test_ttl_expiry_and_update_accounting(self):
        clock = FakeClock()
        st = DeviceSessionStore(budget_bytes=1 << 20, ttl_s=10, clock=clock)
        st.put("a", (32, 32), _feats(1), _FI)
        clock.advance(11)
        assert st.get("a", (32, 32)) is None
        assert st.stats_record()["expired"] == 1
        st.put("b", (32, 32), _feats(1), _FI)
        st.put("b", (32, 32), _feats(2), _FI)
        assert st.bytes_in_use == carry_nbytes(_feats(2), _FI)
        assert len(st) == 1

    def test_counter_reset_keeps_state(self):
        st = DeviceSessionStore(budget_bytes=1 << 20, ttl_s=60,
                                clock=FakeClock())
        st.put("a", (32, 32), _feats(1), _FI)
        st.get("a", (32, 32))
        st.reset_counters()
        rec = st.stats_record()
        assert rec["hits"] == 0 and rec["active"] == 1
        assert rec["bytes_in_use_mb"] > 0
        assert set(rec) == {
            "active", "ttl_s", "max_sessions", "budget_mb",
            "bytes_in_use_mb", "peak_mb", "hits", "misses", "expired",
            "lru_evicted", "budget_evicted", "bucket_resets",
            "over_budget"}

    def test_max_sessions_and_tensor_bytes(self):
        st = DeviceSessionStore(budget_bytes=1 << 20, ttl_s=60,
                                max_sessions=2, clock=FakeClock())
        feats = {"fmap": torch.zeros(1, 4, 2, 3), "ctx": torch.zeros(1, 4, 2, 3)}
        fi = torch.zeros(1, 2, 3, 2)
        assert carry_nbytes(feats, fi) == 2 * 96 + 48
        for sid in "abc":
            st.put(sid, (16, 24), feats, fi)
        assert st.get("a", (16, 24)) is None
        assert st.stats_record()["lru_evicted"] == 1


# ---- VideoEngine over numpy stubs -----------------------------------------


def _stub_encode(frame):
    return {"fmap": np.asarray(frame)[..., :1].copy()}


def _stub_refine(f1, f2, fi):
    """flow_low = flow_init + 1 (chaining visible); flow_up broadcasts its
    mean so the test reads the chain depth off the result."""
    b, h, w = f1["fmap"].shape[:3]
    low = np.asarray(fi) + 1.0
    up = np.full((b, h, w, 2), float(np.mean(low)), np.float32)
    return low, up


def _stub_refine_adaptive(f1, f2, fi):
    low, up = _stub_refine(f1, f2, fi)
    return low, up, np.array([3], np.int32), np.array([0.01], np.float32)


def _video(**kw):
    kw.setdefault("sessions", DeviceSessionStore(budget_bytes=1 << 20,
                                                 ttl_s=60, clock=FakeClock()))
    refine = kw.pop("refine", _stub_refine)
    return VideoEngine(_stub_encode, refine, bucket_multiple=16, **kw)


def _chunk(t=3, h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (t, h, w, 3)).astype(np.float32)


class TestVideoEngine:
    def test_cold_chunk_yields_t_minus_1_flows(self):
        res = _video().process_chunk("cam", _chunk(3))
        assert not res.warm
        assert res.frames_in == 3 and len(res.flows) == 2
        assert res.flows[0].shape == (40, 56, 2)
        assert float(res.flows[0].mean()) == pytest.approx(1.0)
        assert float(res.flows[1].mean()) == pytest.approx(2.0)

    def test_warm_chunk_pairs_carry_with_first_frame(self):
        v = _video()
        v.process_chunk("cam", _chunk(3))
        res = v.process_chunk("cam", _chunk(3, seed=1))
        assert res.warm and len(res.flows) == 3
        assert [float(f.mean()) for f in res.flows] == [
            pytest.approx(3.0), pytest.approx(4.0), pytest.approx(5.0)]

    def test_cold_single_frame_primes_carry_only(self):
        v = _video()
        res = v.process_chunk("cam", _chunk(1))
        assert res.frames_in == 1 and len(res.flows) == 0
        res = v.process_chunk("cam", _chunk(1, seed=1))
        assert res.warm and len(res.flows) == 1

    @pytest.mark.parametrize("sid", [None, ""])
    def test_no_session_id_is_standalone(self, sid):
        v = _video()
        v.process_chunk(sid, _chunk(3))
        assert len(v.sessions) == 0
        assert not v.process_chunk(sid, _chunk(3)).warm

    def test_chunk_cap_rejects_oversize(self):
        v = _video(max_chunk_frames=4)
        with pytest.raises(ValueError, match="caps chunks at 4"):
            v.process_chunk("cam", _chunk(5))
        assert v.process_chunk("cam", _chunk(4)).frames_in == 4
        with pytest.raises(ValueError):
            _video(max_chunk_frames=0)

    def test_admission_sheds_past_max_pending_chunks(self):
        v = _video(max_pending_chunks=2)
        assert v.inflight() == 0
        with v._inflight_lock:
            v._inflight = 2   # two chunks already queued on the lock
        try:
            with pytest.raises(StreamOverloaded, match="retry"):
                v.process_chunk("cam", _chunk(2))
        finally:
            with v._inflight_lock:
                v._inflight = 0
        assert v.process_chunk("cam", _chunk(2)).frames_in == 2
        assert v.inflight() == 0
        with pytest.raises(ValueError):
            _video(max_pending_chunks=0)

    def test_stats_scrape_never_blocks_behind_a_live_chunk(self):
        v = _video()
        v.process_chunk("cam", _chunk(3))
        out = {}
        with v._lock:   # a chunk is mid-flight
            t = threading.Thread(target=lambda: out.update(
                rec=v.stats_record()))
            t.start()
            t.join(timeout=5)
            assert not t.is_alive(), "stats_record blocked on _lock"
        assert out["rec"]["chunks"] == 1

    def test_bucket_change_restarts_cold(self):
        v = _video()
        v.process_chunk("cam", _chunk(3))
        res = v.process_chunk("cam", _chunk(3, h=72, w=88))
        assert not res.warm and len(res.flows) == 2
        assert v.sessions.stats_record()["bucket_resets"] == 1

    def test_validation_rejects_malformed(self):
        v = _video()
        for bad in (np.zeros((40, 56, 3)), np.zeros((0, 40, 56, 3)),
                    np.zeros((2, 40, 56, 4)), np.zeros((2, 4, 4, 3), bool)):
            with pytest.raises(ValueError):
                v.process_chunk("cam", bad)

    def test_stats_record_and_reset(self):
        v = _video()
        v.process_chunk("cam", _chunk(3))
        v.process_chunk("cam", _chunk(3))
        rec = v.stats_record()
        assert rec["chunks"] == 2 and rec["frames_in"] == 6
        assert rec["flows_out"] == 5
        assert rec["warm_chunks"] == 1 and rec["cold_chunks"] == 1
        assert rec["warm_buckets"] == ["48x64"]
        assert rec["sessions"]["active"] == 1
        assert "adaptive" not in rec
        v.reset_stats()
        rec = v.stats_record()
        assert rec["chunks"] == 0 and rec["flow_p50_ms"] == 0.0
        assert rec["warm_buckets"] == ["48x64"]   # state survives
        assert rec["sessions"]["active"] == 1

    def test_warmup_is_not_traffic(self):
        v = _video()
        v.warmup(["40x56", "72x88"])
        rec = v.stats_record()
        assert rec["chunks"] == 0 and rec["sessions"]["active"] == 0
        assert rec["warm_buckets"] == ["48x64", "80x96"]

    def test_adaptive_refine_samples(self):
        v = _video(refine=_stub_refine_adaptive, adaptive=True)
        res = v.process_chunk("cam", _chunk(3))
        assert res.iters_used == 3.0
        rec = v.stats_record()
        assert rec["adaptive"] is True and rec["iters_used_mean"] == 3.0
        assert rec["final_delta_p50"] == pytest.approx(0.01)

    def test_strict_refused_naming_the_roadmap_item(self):
        with pytest.raises(ValueError, match="A13"):
            _video(strict=True)


def test_ordered_lock_refuses_inverted_nesting_and_reentry():
    chunk = OrderedLock("serve.video.chunk")
    store = OrderedLock("serve.sessions.device")
    with chunk:
        with store:
            pass
    with store:
        with pytest.raises(LockOrderViolation, match="opposite nesting"):
            chunk.acquire()
        with pytest.raises(LockOrderViolation, match="self-deadlock"):
            store.acquire()
    assert not store.locked() and not chunk.locked()
    with pytest.raises(ValueError, match="LOCK_ORDER"):
        OrderedLock("serve.scratch")


# ---- the split model: encode + refine == the pair forward ----------------


def _frames(n, seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (1, h, w, 3))
    return [np.clip(np.roll(base, 2 * i, axis=2) + rng.normal(0, 3, base.shape),
                    0, 255).astype(np.float32) for i in range(n)]


def _t(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("variant", ["v1", "v4", "v5"])
def test_split_matches_pair_forward(variant):
    """encode_frame + refine equals the pair forward on the same weights,
    cold and warm, to <= 1e-4 (the per-frame encoder calls against the
    pair's batched one; DexiNed per frame in v4/v5)."""
    model = create_model(VARIANTS[variant](small=True, corr_impl="local"),
                         seed=3, device="cpu")
    im1, im2 = (_t(x) for x in _frames(2, seed=4))
    fi = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (1, 2, 6, 8)).astype(np.float32))
    with torch.inference_mode():
        f1 = model(im1, mode="encode")
        f2 = model(im2, mode="encode")
        assert set(f1) == ({"fmap", "ctx", "efmap", "ectx"}
                           if variant == "v5" else {"fmap", "ctx"})
        for init in (None, fi):
            low_m, up_m = model(im1, im2, iters=2, flow_init=init)
            low_s, up_s = model(iters=2, flow_init=init, mode="step",
                                features1=f1, features2=f2)
            assert float((low_m - low_s).abs().max()) <= 1e-4
            assert float((up_m - up_s).abs().max()) <= 1e-4
        with pytest.raises(ValueError, match="mode='pair' needs"):
            model(im1, iters=1)
        with pytest.raises(ValueError, match="mode='step' needs"):
            model(iters=1, mode="step", features1=f1)
        with pytest.raises(ValueError, match="unknown mode"):
            model(im1, im2, mode="triple")


@pytest.mark.parametrize("variant", ["v1", "v5"])
def test_split_matches_jax_step(variant):
    """The port's encode + refine against JAX mode="encode" / "step" on
    the same weights, with a warm start (rtol 5e-3 for v1, 1e-2 for v5)."""
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    jcfg = J_VARIANTS[variant](small=True, corr_impl="local")
    jm = JRAFT(jcfg)
    v = _randomize(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False)), 51)
    im1, im2 = _frames(2, seed=6)
    fi = np.random.default_rng(7).uniform(-1, 1, (1, 6, 8, 2)).astype(
        np.float32)

    @jax.jit
    def jax_split(a, b, init):
        f1 = jm.apply(v, a, mode="encode")
        f2 = jm.apply(v, b, mode="encode")
        return jm.apply(v, None, iters=2, test_mode=True, mode="step",
                        features1=f1, features2=f2, flow_init=init)

    j_low, j_up = jax_split(jnp.asarray(im1), jnp.asarray(im2),
                            jnp.asarray(fi))
    cfg = VARIANTS[variant](small=True, corr_impl="local")
    model = RAFT(cfg)
    model.load_state_dict(raft_state_dict_from_jax(v, cfg=cfg), strict=True)
    encode = make_encode_step(model, "cpu")
    refine = make_refine_step(model, 2, "cpu")
    low, up = refine(encode(im1), encode(im2), fi)
    rtol = 5e-3 if variant == "v1" else 1e-2
    assert np.abs(np.asarray(j_low)).max() > 1e-2
    np.testing.assert_allclose(low.numpy(), np.asarray(j_low), rtol=rtol,
                               atol=1e-3)
    np.testing.assert_allclose(up.numpy(), np.asarray(j_up), rtol=rtol,
                               atol=1e-3)


def _splat(low):
    return forward_interpolate(low[0])[None]


def test_streamed_frames_equal_chained_pairs():
    """Frames f0..f4 through the VideoEngine in two chunks (3 cold, then 2
    warm) equal the chained pair forwards (f_i, f_i+1), each seeded with
    the splat of the previous pair's flow_low: frame i is encoded once in
    the stream, twice in the chain."""
    model = create_model(VARIANTS["v1"](small=True, corr_impl="local"),
                         seed=8, device="cpu")
    frames = _frames(5, seed=9, h=44, w=60)
    video = VideoEngine(make_encode_step(model, "cpu"),
                        make_refine_step(model, 2, "cpu"), _splat,
                        sessions=DeviceSessionStore(), bucket_multiple=16)
    streamed = video.process_chunk("s", np.concatenate(frames[:3])).flows
    res = video.process_chunk("s", np.concatenate(frames[3:]))
    assert res.warm and len(res.flows) == 2
    streamed += res.flows

    from dexiraft_tpu_torch.data.padder import InputPadder

    step = make_eval_step(model, 2, "cpu")
    pad = InputPadder((44, 60, 3), mode="sintel", target=(48, 64))
    fi = None
    for i, flow in enumerate(streamed):
        low, up = step(pad.pad(frames[i][0])[0][None],
                       pad.pad(frames[i + 1][0])[0][None], fi)
        np.testing.assert_allclose(flow, pad.unpad(up[0].numpy()), rtol=0,
                                   atol=1e-4)
        fi = _splat(low)
    rec = video.stats_record()
    assert rec["flows_out"] == 4 and rec["sessions"]["active"] == 1
    # the stored carry: the last frame's fmap (128 channels, small) and
    # ctx (96 + 64), and the seed
    feats, seed = video.sessions.get("s", (48, 64))
    assert video.sessions.bytes_in_use == carry_nbytes(feats, seed) == (
        (128 + 160) * 6 * 8 * 4 + 6 * 8 * 2 * 4)


# ---- forward_interpolate against JAX --------------------------------------


def _collisions(flow, s=4):
    h, w = flow.shape[:2]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x1, y1 = xs + flow[..., 0], ys + flow[..., 1]
    valid = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    cells = (np.clip(np.round(y1 * s), 0, h * s - 1) * w * s
             + np.clip(np.round(x1 * s), 0, w * s - 1))[valid]
    return cells.size - np.unique(cells).size


@pytest.mark.parametrize("shift", [(1.3, -0.7), (-2.25, 0.5)])
def test_splat_equals_jax_without_collisions(shift):
    """A uniform shift lands every point in a cell of its own: the port's
    splat equals JAX's at the Sintel 1/8 geometry."""
    flow = np.zeros((55, 128, 2), np.float32) + np.float32(shift)
    assert _collisions(flow) == 0
    ours = forward_interpolate(torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_splat(flow)), rtol=0,
                               atol=1e-6)


def test_splat_within_warm_start_bounds_on_colliding_fields():
    """Smooth fields with folds (points colliding in a fine cell): the
    port against JAX within the bounds test_eval.py's TestWarmStartParity
    holds JAX to against scipy (mean < 0.05 px, < 1% of pixels > 0.5 px)."""
    means, fracs = [], []
    h, w = 55, 128
    xs = np.arange(w, dtype=np.float32)[None, :]
    for seed in range(4):
        flow = _smooth_flow(np.random.default_rng(seed), h, w)
        # a fold: the right half converges 5x toward its middle column
        flow[:, w // 2:, 0] += (-0.8 * (xs - 0.75 * w))[:, w // 2:]
        assert _collisions(flow) > 100
        d = np.linalg.norm(forward_interpolate(torch.from_numpy(flow)).numpy()
                           - np.asarray(j_splat(flow)), axis=-1)
        means.append(d.mean())
        fracs.append((d > 0.5).mean())
    assert np.mean(means) < 0.05, means
    assert np.mean(fracs) < 0.01, fracs


def test_splat_everything_out_of_frame_is_zero():
    flow = np.full((6, 8, 2), 50.0, np.float32)
    out = forward_interpolate(torch.from_numpy(flow))
    assert out.shape == (6, 8, 2) and float(out.abs().max()) == 0.0
