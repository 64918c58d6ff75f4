"""The v5 slice: JAX RAFT v5 against the PyTorch port on the same weights.

JAX side: ``RAFT(raft_v5(corr_impl="pallas", fused_update=...)).apply``,
the dual-stream Dexi-RAFT with its embedded DexiNed, on the per-pixel
Pallas kernels B3 (fused) and B4 (unfused) in interpret mode
(DEXIRAFT_PALLAS_INTERPRET=1). Port side: ``dexiraft_tpu_torch`` RAFT with
the same config on the CPU (the kernel wrappers' plain versions), loaded
through ``raft_state_dict_from_jax``, which is held bitwise against the
JAX package's ``export_raft_state_dict``. Full width (hidden 128, context
128, fnet 256, 4 levels, r=4), at 64x96 and at 40x64 (DexiNed's deepest
outputs are cropped, and the 1/8-res 5x8 map pools to a 0-row 4th
level), 4 iterations, and once with a flow_init.

Every leaf of the JAX variables is a seeded random value
(test_torch_raft._randomize), built on ``jax.eval_shape`` (a real v5 init
takes ~44 s here).

Tolerance: rtol 1e-2 (the v5 row of docs/parity.md) with atol 1e-3 px:
flow_low reaches ~6 px and flow_up ~40 px at these weights, and DexiNed,
the four encoders and 4 update iterations in fp32 in another summation
order differ by ~1e-4 px (measured at 64x96: 8e-5 px flow_low, 3e-4 px
flow_up); the atol covers flow components near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v5 as j_raft_v5
from dexiraft_tpu.interop.torch_convert import export_raft_state_dict
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu_torch.config import raft_v5
from dexiraft_tpu_torch.data.padder import InputPadder
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT, create_model
from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from dexiraft_tpu_torch.train.step import make_eval_step
from test_torch_raft import _images, _randomize

RTOL, ATOL = 1e-2, 1e-3
ITERS = 4


@pytest.fixture(scope="module")
def variables():
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JRAFT(j_raft_v5(corr_impl="local")).init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False))
    return _randomize(shapes, 5)


@pytest.fixture(scope="module")
def state(variables):
    return raft_state_dict_from_jax(variables)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX per-pixel kernels in interpret mode, with a pixel block
    the size of these fixtures (the knob never changes values)."""
    monkeypatch.setenv("DEXIRAFT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DEXIRAFT_PALLAS_PIXEL_BLOCK", "48")


def _port(state, **cfg):
    model = RAFT(raft_v5(**cfg))
    model.load_state_dict(state, strict=True)
    return model.eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _check(low, up, j_low, j_up, b, hw):
    low = low.permute(0, 2, 3, 1).numpy()
    up = up.permute(0, 2, 3, 1).numpy()
    assert low.shape == (b, hw[0] // 8, hw[1] // 8, 2)
    assert up.shape == (b,) + hw + (2,)
    assert np.abs(np.asarray(j_low)).max() > 1e-2  # not a trivial flow
    np.testing.assert_allclose(low, np.asarray(j_low), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(up, np.asarray(j_up), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [(64, 96), (40, 64)])
@pytest.mark.parametrize("fused", [True, False])
def test_slice_matches_jax(variables, state, interpret, fused, hw):
    im1, im2 = _images(*hw, seed=hw[0] + 1)
    j_low, j_up = JRAFT(j_raft_v5(corr_impl="pallas",
                                  fused_update=fused)).apply(
        variables, jnp.asarray(im1), jnp.asarray(im2), iters=ITERS,
        train=False, test_mode=True)
    model = _port(state, corr_impl="pallas", fused_update=fused)
    with torch.inference_mode():
        low, up = model(_nchw(im1), _nchw(im2), iters=ITERS)
    _check(low, up, j_low, j_up, 2, hw)


def test_flow_init_matches_jax(variables, state, interpret):
    """flow_init offsets the image stream only; the edge stream starts at
    the coordinate grid."""
    hw = (64, 96)
    im1, im2 = _images(*hw, seed=9)
    init = np.random.default_rng(9).normal(
        0, 1.5, (2, hw[0] // 8, hw[1] // 8, 2)).astype(np.float32)
    j_low, j_up = JRAFT(j_raft_v5(corr_impl="pallas", fused_update=True)).apply(
        variables, jnp.asarray(im1), jnp.asarray(im2), iters=ITERS,
        flow_init=jnp.asarray(init), train=False, test_mode=True)
    model = _port(state, corr_impl="pallas", fused_update=True)
    with torch.inference_mode():
        low, up = model(_nchw(im1), _nchw(im2), iters=ITERS,
                        flow_init=_nchw(init))
    _check(low, up, j_low, j_up, 2, hw)


def test_bridge_equals_export_bitwise(variables, state):
    """The port's own bridge against the JAX package's exporter, key for
    key and bit for bit (DexiNed's transposed convs flipped), then a
    strict load."""
    model = RAFT(raft_v5(corr_impl="pallas", fused_update=True))
    template = model.state_dict()
    theirs = export_raft_state_dict(variables, template)
    assert list(state) == list(template) and set(theirs) == set(state)
    for k, t in state.items():
        ref = np.asarray(theirs[k])
        assert t.numpy().dtype == ref.dtype and t.numpy().shape == ref.shape, k
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=k)
    assert any(k.startswith("efnet.") for k in state)
    assert "dexined.up_block_6.features.11.weight" in state
    model.load_state_dict(state, strict=True)


def test_one_state_dict_serves_every_path(state):
    """One state dict serves pallas fused (B3), pallas unfused (B4), flash
    fused (B1) and the plain lookup, with the same flow."""
    im1, im2 = _images(40, 64, seed=11)
    outs = []
    for cfg in (dict(corr_impl="pallas", fused_update=True),
                dict(corr_impl="pallas"),
                dict(corr_impl="flash", fused_update=True),
                dict(corr_impl="local")):
        with torch.inference_mode():
            outs.append(_port(state, **cfg)(_nchw(im1), _nchw(im2),
                                            iters=2)[1])
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-4, atol=1e-4)


def test_engine_carries_v5(state):
    """The engine and the eval step run a v5 model unchanged: one padded
    request through them equals the direct model call on its bucket."""
    model = _port(state, corr_impl="pallas", fused_update=True)
    rng = np.random.default_rng(12)
    im1 = rng.uniform(0, 255, (37, 60, 3)).astype(np.float32)
    im2 = np.clip(np.roll(im1, 1, axis=1) + rng.normal(0, 2, im1.shape),
                  0, 255).astype(np.float32)
    engine = InferenceEngine(make_eval_step(model, iters=2, device="cpu"),
                             ServeConfig(batch_size=1))
    (res,) = list(engine.stream([{"image1": im1, "image2": im2}]))
    assert res.flow_up.shape == (37, 60, 2)
    assert np.isfinite(res.flow_up).all()
    pad = InputPadder(im1.shape, mode="sintel", target=(40, 64))
    x1, x2 = (torch.from_numpy(pad.pad(x)[0])[None].permute(0, 3, 1, 2)
              for x in (im1, im2))
    with torch.inference_mode():
        low, _ = model(x1, x2, iters=2)
    np.testing.assert_allclose(res.flow_low, low[0].permute(1, 2, 0).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_seeded_init_is_deterministic():
    """create_model seeds every parameter, the transposed convs and the
    edge encoders included: the same seed gives bit-identical state dicts,
    another seed different ones."""
    cfg = raft_v5(corr_impl="pallas", fused_update=True)
    a = create_model(cfg, seed=3, device="cpu").state_dict()
    b = create_model(cfg, seed=3, device="cpu").state_dict()
    c = create_model(cfg, seed=4, device="cpu").state_dict()
    assert list(a) == list(b) == list(c)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for k in ("dexined.up_block_3.features.2.weight",
              "dexined.up_block_3.features.5.weight",
              "efnet.conv1.weight", "ecnet.layer1.0.conv1.weight",
              "dexined.dblock_4.denselayer2.conv1.weight"):
        assert not torch.equal(a[k], c[k]), k
    # the edge encoders get the encoders' Kaiming init (zero bias), the
    # 1-channel transposed convs normal(0.1)
    assert not a["efnet.conv1.bias"].any()
    assert abs(float(a["dexined.up_block_6.features.11.weight"].std())
               - 0.1) < 0.02
