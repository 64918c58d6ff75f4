"""The port's DexiNed against the JAX package's, on the same weights.

JAX side: ``dexiraft_tpu.models.dexined.DexiNed`` (its default
"subpixel" upconv, the same linear map as a transposed conv) with
variables from ``jax.eval_shape`` filled with seeded random values
(test_torch_raft._randomize: a mis-mapped bias or running stat cannot
hide behind zeros). Port side: ``dexiraft_tpu_torch.models.dexined``
loaded through the port's bridge, ``dexined_state_dict_from_jax`` (the
map ``raft_state_dict_from_jax`` uses for v5's ``dexined.*`` keys), which
is held bitwise against the JAX package's ``export_dexined_state_dict``
first.

The v5 config's ``dexined_upconv="transpose"`` (the JAX package's plain
transposed conv, numerically the "subpixel" default) builds the same port
model: it loads the JAX v5 variables strictly and matches the JAX forward
of that config at the v5 tolerance (rtol 1e-2, atol 1e-3 px;
test_torch_raft_v5.py); an unknown value is refused.

Sizes: 64x96, and 40x64, where the scale-5/6 outputs overshoot by 8 rows
and are cropped by dropping the FIRST rows (the crop is not centred).
Tolerance: rtol 2e-3 (the DexiNed row of docs/parity.md) with atol 1e-5:
the maps reach 0.03-0.3 at these weights, and fp32 arithmetic in another
summation order moves them by <= 2e-7 (measured), so values near zero
need an absolute floor, while a mis-mapped weight moves a map by its own
scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v5 as j_raft_v5
from dexiraft_tpu.interop.torch_convert import export_dexined_state_dict
from dexiraft_tpu.models.dexined import DexiNed as JDexiNed
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu_torch.config import raft_v5
from dexiraft_tpu_torch.interop.jax_weights import (dexined_state_dict_from_jax,
                                                    raft_state_dict_from_jax)
from dexiraft_tpu_torch.models.dexined import DexiNed, stack_edge_maps
from dexiraft_tpu_torch.models.raft import RAFT
from test_torch_raft import _images, _randomize

RTOL, ATOL = 2e-3, 1e-5


@pytest.fixture(scope="module")
def variables():
    img = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JDexiNed().init(
        jax.random.PRNGKey(0), img, train=False))
    return _randomize(shapes, 3)


def test_bridge_equals_export_bitwise(variables):
    template = DexiNed().state_dict()
    ours = dexined_state_dict_from_jax(variables)
    theirs = export_dexined_state_dict(variables, template)
    assert set(theirs) == set(ours) == set(template)
    for k, t in ours.items():
        if k.endswith("num_batches_tracked"):
            continue
        ref = np.asarray(theirs[k])
        assert t.shape == ref.shape, k
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=k)
    # the modules kept only for the weights are in the state dict
    assert "block_cat.bn.running_var" in ours and "side_5.conv.weight" in ours
    DexiNed().load_state_dict(ours, strict=True)


@pytest.mark.parametrize("hw", [(64, 96), (40, 64)])
def test_matches_jax(variables, hw):
    rng = np.random.default_rng(hw[0])
    x = rng.uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    j_maps = jax.jit(lambda v, im: JDexiNed().apply(v, im, train=False))(
        variables, jnp.asarray(x))

    model = DexiNed()
    model.load_state_dict(dexined_state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        maps = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(maps) == len(j_maps) == 7
    for i, (t, j) in enumerate(zip(maps, j_maps)):
        t = t.permute(0, 2, 3, 1).numpy()
        assert t.shape == (2,) + hw + (1,), i
        np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=ATOL,
                                   err_msg=f"map {i}")
    stacked = stack_edge_maps(maps)
    assert tuple(stacked.shape) == (2, 7) + hw
    assert float(stacked.abs().max()) > 0.1  # not a trivial map


def test_transpose_upconv_v5_matches_jax():
    """A v5 config with dexined_upconv="transpose" loads the JAX v5
    variables of that config with strict=True, and its flow matches the
    JAX forward of the same config."""
    hw, iters = (40, 64), 2
    j_cfg = j_raft_v5(corr_impl="local", dexined_upconv="transpose")
    img = jnp.zeros((1, 40, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JRAFT(j_cfg).init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False))
    v5_vars = _randomize(shapes, 7)
    im1, im2 = _images(*hw, seed=13)
    j_low, j_up = jax.jit(lambda v, a, b: JRAFT(j_cfg).apply(
        v, a, b, iters=iters, train=False, test_mode=True))(
            v5_vars, jnp.asarray(im1), jnp.asarray(im2))

    cfg = raft_v5(corr_impl="local", dexined_upconv="transpose")
    assert cfg.dexined_upconv == "transpose"
    model = RAFT(cfg)
    model.load_state_dict(raft_state_dict_from_jax(v5_vars), strict=True)
    with torch.inference_mode():
        low, up = model.eval()(torch.from_numpy(im1).permute(0, 3, 1, 2),
                               torch.from_numpy(im2).permute(0, 3, 1, 2),
                               iters=iters)
    assert np.abs(np.asarray(j_low)).max() > 1e-2  # not a trivial flow
    np.testing.assert_allclose(low.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_low), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(up.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_up), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("upconv", ["transpose", "subpixel"])
def test_upconv_values_build_one_model(upconv):
    """Both values build the same module tree (the same state dict keys
    and shapes); any other value is refused."""
    ref = RAFT(raft_v5(corr_impl="local")).state_dict()
    sd = RAFT(raft_v5(corr_impl="local", dexined_upconv=upconv)).state_dict()
    assert [(k, v.shape) for k, v in sd.items()] == \
        [(k, v.shape) for k, v in ref.items()]
    with pytest.raises(ValueError, match="unknown dexined_upconv"):
        raft_v5(dexined_upconv="nearest")
