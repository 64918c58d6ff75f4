"""The port's inference engine: bucketing, tail-batch filler, unpadding.

A stub eval_fn (numpy, records what it was given) pins the engine's
mechanics; a small seeded model on the CPU pins that a frame pair through
the engine gives the same flow as the model called on the padded pair
directly, and the padder against the JAX package's.
"""

import numpy as np
import pytest
import torch

from dexiraft_tpu.data.padder import InputPadder as JPadder
from dexiraft_tpu_torch.config import raft_v1
from dexiraft_tpu_torch.data.padder import InputPadder
from dexiraft_tpu_torch.models.raft import create_model
from dexiraft_tpu_torch.serve.buckets import BucketRegistry, bucket_shape
from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from dexiraft_tpu_torch.train.step import make_eval_step


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (h, w, 3)).astype(np.float32)}


class StubStep:
    """Encodes each row's identity in its output: flow_up[row] = the mean
    of image1[row], flow_low = that mean too."""

    def __init__(self):
        self.calls = []

    def __call__(self, im1, im2, fi):
        self.calls.append((im1.shape, None if fi is None else fi.shape))
        b, h, w, _ = im1.shape
        m = im1.mean(axis=(1, 2, 3))
        up = np.broadcast_to(m[:, None, None, None], (b, h, w, 2)).copy()
        low = np.broadcast_to(m[:, None, None, None], (b, h // 8, w // 8, 2)).copy()
        return low, up


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("shape", [(436, 1024), (375, 1242), (7, 13)])
def test_padder_matches_jax(mode, shape):
    x = np.random.default_rng(0).standard_normal((1,) + shape + (3,))
    target = bucket_shape(*shape, multiple=16)
    for kw in ({}, {"target": target}):
        t, j = InputPadder(x.shape, mode, **kw), JPadder(x.shape, mode, **kw)
        assert t._pad == j._pad and t.padded_shape == j.padded_shape
        np.testing.assert_array_equal(t.pad(x)[0], j.pad(x)[0])
        np.testing.assert_array_equal(t.unpad(t.pad(x)[0]), x)


def test_buckets():
    assert bucket_shape(436, 1024) == (440, 1024)
    assert bucket_shape(375, 1242) == (376, 1248)
    assert bucket_shape(375, 1242, multiple=64) == (384, 1280)
    with pytest.raises(ValueError):
        bucket_shape(10, 10, multiple=12)
    reg = BucketRegistry()
    reg.bucket_for(436, 1024)
    reg.bucket_for(433, 1020)
    assert reg.stats()["buckets"] == {"440x1024": 2}


def test_bucketing_tail_filler_and_unpad():
    step = StubStep()
    eng = InferenceEngine(step, ServeConfig(batch_size=2))
    items = [_pair(20, 30, 0), _pair(44, 60, 1), _pair(21, 29, 2),
             _pair(43, 57, 3), _pair(17, 31, 4)]
    results = list(eng.stream(items))
    assert sorted(r.index for r in results) == list(range(5))
    # buckets: 24x32 (items 0, 2, 4) and 48x64 (items 1, 3): 3 batches,
    # the 24x32 tail filled by one repeated item whose result is dropped
    assert sorted(c[0] for c in step.calls) == [
        (2, 24, 32, 3), (2, 24, 32, 3), (2, 48, 64, 3)]
    assert eng.stats.batches == 3 and eng.stats.frames == 5
    assert eng.stats.pad_frames == 1
    for r in results:
        h, w, _ = items[r.index]["image1"].shape
        assert r.flow_up.shape == (h, w, 2)
        bh, bw = bucket_shape(h, w)
        assert r.flow_low.shape == (bh // 8, bw // 8, 2)
        padded = InputPadder((h, w, 3), target=(bh, bw)).pad(
            items[r.index]["image1"])[0]
        np.testing.assert_allclose(r.flow_up, padded.mean(), rtol=1e-6)


def test_warm_start_and_validation():
    step = StubStep()
    eng = InferenceEngine(step, ServeConfig(batch_size=2, warm_start=True))
    res = eng.run_batch([_pair(16, 16, 0)])
    assert step.calls == [((2, 16, 16, 3), (2, 2, 2, 2))]
    assert [r.index for r in res] == [0]
    with pytest.raises(ValueError, match="must be \\(H, W, 3\\)"):
        eng.run_batch([{"image1": np.zeros((8, 8)), "image2": np.zeros((8, 8))}])
    with pytest.raises(ValueError, match="span buckets"):
        eng.run_batch([_pair(16, 16, 0), _pair(32, 16, 1)])


def test_engine_matches_model_on_cpu():
    torch.manual_seed(0)
    cfg = raft_v1(small=True, corr_impl="flash", fused_update=True)
    model = create_model(cfg, seed=3, device="cpu")
    step = make_eval_step(model, iters=2, device="cpu")
    eng = InferenceEngine(step, ServeConfig(batch_size=2, mode="kitti"))
    items = [_pair(45, 60, 0), _pair(43, 62, 1), _pair(40, 64, 2)]
    results = sorted(eng.stream(items), key=lambda r: r.index)
    for r, it in zip(results, items):
        padder = InputPadder(it["image1"].shape, "kitti",
                             target=bucket_shape(*it["image1"].shape[:2]))
        p1, p2 = padder.pad(it["image1"], it["image2"])
        x1 = torch.from_numpy(p1).permute(2, 0, 1)[None]
        x2 = torch.from_numpy(p2).permute(2, 0, 1)[None]
        with torch.inference_mode():
            low, up = model(x1, x2, iters=2)
        np.testing.assert_allclose(r.flow_low, low[0].permute(1, 2, 0).numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            r.flow_up, padder.unpad(up[0].permute(1, 2, 0).numpy()),
            rtol=1e-4, atol=1e-4)
        assert np.isfinite(r.flow_up).all()


@pytest.mark.parametrize("tf32", [True, False])
@pytest.mark.parametrize("flags", [(True, False), (False, True)])
def test_eval_step_sets_and_restores_tf32_flags(tf32, flags):
    """The step runs with cuDNN's TF32 convolutions as asked and fp32
    matmuls, whatever the global flags are, and leaves them as it found
    them."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    model = create_model(raft_v1(small=True, corr_impl="local"), seed=1,
                         device="cpu")
    seen = []
    forward = model.forward

    def spy(*a, **k):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        return forward(*a, **k)

    model.forward = spy
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = flags
        step = make_eval_step(model, iters=1, device="cpu", tf32=tf32)
        it = _pair(16, 16, 3)
        low, up = step(it["image1"][None], it["image2"][None])
        assert seen == [(tf32, False)]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == flags
        assert tuple(low.shape) == (1, 2, 2, 2) and torch.isfinite(up).all()
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
