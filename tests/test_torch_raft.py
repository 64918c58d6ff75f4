"""The whole slice: JAX RAFT v1 against the PyTorch port on the same weights.

JAX side: ``RAFT(raft_v1(corr_impl="flash", fused_update=True)).apply``
with the Pallas flash kernel in interpret mode
(DEXIRAFT_PALLAS_INTERPRET=1). Port side: ``dexiraft_tpu_torch`` RAFT
with the same config on the CPU (the kernel wrapper's plain version),
loaded through ``raft_state_dict_from_jax``. Full width and small, at
64x96 and at 48x64 (whose 1/8-res 6x8 map pools to a 0-row 4th level),
4 iterations.

Every leaf of the JAX variables is overwritten with seeded random values
first (BN variances kept positive): flax inits biases to zero and BN to
identity stats, which would hide a mis-mapped bias or running stat.

Tolerance: rtol 5e-3 (the v1 row of docs/parity.md) with atol 1e-3 px
(flow components are O(1) px at these random weights; fp32 arithmetic in
another summation order differs by ~1e-5).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.interop.torch_convert import export_raft_state_dict
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu_torch.config import raft_v1
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT, create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 5e-3, 1e-3
ITERS = 4


def _randomize(variables, seed):
    """Seeded random value for every leaf: conv kernels ~ N(0, 1/fan_in),
    biases and BN shifts ~ 0.1 N(0, 1), BN scales ~ 1 + 0.1 N(0, 1), BN
    running variances ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _variables(small, seed):
    """JAX variables of the right tree and shapes (abstract init through
    corr_impl="local", the same tree as the fused flash path), every leaf
    then filled by _randomize."""
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    cfg = j_raft_v1(small=small, corr_impl="local")
    shapes = jax.eval_shape(lambda: JRAFT(cfg).init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False))
    return _randomize(shapes, seed)


@pytest.fixture(scope="module")
def variables():
    return {False: _variables(False, 1), True: _variables(True, 2)}


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    # the second frame: the first shifted right by 2 px plus noise
    im2 = np.roll(im1, 2, axis=2) + rng.normal(0, 4, im1.shape)
    return im1, np.clip(im2, 0, 255).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 96), (48, 64)])
@pytest.mark.parametrize("small", [False, True])
def test_slice_matches_jax(variables, small, hw, monkeypatch):
    monkeypatch.setenv("DEXIRAFT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DEXIRAFT_FLASH_PIXEL_BLOCK", "128")
    monkeypatch.setenv("DEXIRAFT_FLASH_ROWS", "8")
    v = variables[small]
    im1, im2 = _images(*hw, seed=hw[0])
    j_low, j_up = JRAFT(j_raft_v1(small=small, corr_impl="flash",
                                  fused_update=True)).apply(
        v, jnp.asarray(im1), jnp.asarray(im2), iters=ITERS, train=False,
        test_mode=True)

    model = RAFT(raft_v1(small=small, corr_impl="flash", fused_update=True))
    model.load_state_dict(raft_state_dict_from_jax(v, small=small), strict=True)
    model.eval()
    with torch.inference_mode():
        low, up = model(torch.from_numpy(im1).permute(0, 3, 1, 2),
                        torch.from_numpy(im2).permute(0, 3, 1, 2), iters=ITERS)
    low = low.permute(0, 2, 3, 1).numpy()
    up = up.permute(0, 2, 3, 1).numpy()
    assert low.shape == (2, hw[0] // 8, hw[1] // 8, 2)
    assert up.shape == (2,) + hw + (2,)
    assert np.abs(np.asarray(j_low)).max() > 1e-2  # not a trivial flow
    np.testing.assert_allclose(low, np.asarray(j_low), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(up, np.asarray(j_up), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("small", [False, True])
def test_bridge_equals_export_bitwise(variables, small):
    """The port's own bridge against the JAX package's exporter, key for
    key and bit for bit, then a strict load."""
    v = variables[small]
    model = RAFT(raft_v1(small=small, corr_impl="flash", fused_update=True))
    template = model.state_dict()
    ours = raft_state_dict_from_jax(v, small=small)
    theirs = export_raft_state_dict(v, template, small=small)
    assert list(ours) == list(template) and set(theirs) == set(ours)
    for k, t in ours.items():
        ref = np.asarray(theirs[k])
        assert t.numpy().dtype == ref.dtype and t.numpy().shape == ref.shape, k
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=k)
    model.load_state_dict(ours, strict=True)
    # the aliased shortcut norm carries the same stats under both names
    if not small:
        np.testing.assert_array_equal(
            ours["cnet.layer2.0.norm3.running_var"].numpy(),
            ours["cnet.layer2.0.downsample.1.running_var"].numpy())


def test_fused_and_unfused_paths_share_weights(variables):
    """One state dict serves the fused flash path, the unfused flash
    lookup and the plain lookup, with the same flow."""
    sd = raft_state_dict_from_jax(variables[True], small=True)
    im1, im2 = _images(48, 64, seed=7)
    x1 = torch.from_numpy(im1).permute(0, 3, 1, 2)
    x2 = torch.from_numpy(im2).permute(0, 3, 1, 2)
    outs = []
    for cfg in (raft_v1(small=True, corr_impl="flash", fused_update=True),
                raft_v1(small=True, corr_impl="flash"),
                raft_v1(small=True, corr_impl="local")):
        m = RAFT(cfg)
        m.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            outs.append(m.eval()(x1, x2, iters=2)[1])
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-4, atol=1e-4)


def test_refusals():
    with pytest.raises(ValueError, match="not ported"):
        RAFT(raft_v1(corr_impl="allpairs"))
    from dexiraft_tpu_torch.config import (RAFTConfig, raft_v2, raft_v3,
                                           raft_v4, raft_v5)
    # v2-v4 are ported; what JAX refuses stays refused
    for variant in (raft_v2, raft_v3, raft_v4):
        with torch.device("meta"):
            RAFT(variant(corr_impl="flash"))
    with pytest.raises(ValueError, match="requires embed_dexined=True"):
        RAFT(RAFTConfig(variant="dual", corr_impl="flash"))
    with pytest.raises(ValueError, match="not ported"):
        RAFT(raft_v5(corr_impl="allpairs"))
    with torch.device("meta"):
        v5 = RAFT(raft_v5(corr_impl="pallas", fused_update=True))
    assert hasattr(v5, "dexined") and hasattr(v5, "efnet")
    with pytest.raises(ValueError, match="not supported by the PyTorch port"):
        raft_v1(remat=True)
    with pytest.raises(ValueError, match="fused_update=True requires"):
        raft_v1(corr_impl="local", fused_update=True)
    m = create_model(raft_v1(small=True, corr_impl="local"), device="cpu")
    x = torch.zeros(1, 3, 32, 32)
    with pytest.raises(ValueError, match="training mode"):
        m(x, x, test_mode=False)


def test_resolve_corr_impl():
    from dexiraft_tpu_torch.config import resolve_corr_impl
    assert resolve_corr_impl("auto", "cuda") == ("flash", True)
    assert resolve_corr_impl("auto", "cpu") == ("local", False)
    assert resolve_corr_impl("flash", "cuda") == ("flash", False)


def test_package_imports_no_jax():
    """The port's package, model, engine, kernel, bridge, splat, session
    and video modules load neither jax/flax nor any dexiraft_tpu module (a subprocess: this test
    process has jax loaded by conftest)."""
    code = (
        "import sys\n"
        "import dexiraft_tpu_torch\n"
        "import dexiraft_tpu_torch.config, dexiraft_tpu_torch.models.raft\n"
        "import dexiraft_tpu_torch.models.dexined\n"
        "import dexiraft_tpu_torch.serve.engine, dexiraft_tpu_torch.train.step\n"
        "import dexiraft_tpu_torch.ops.corr_kernels\n"
        "import dexiraft_tpu_torch.interop.jax_weights\n"
        "import dexiraft_tpu_torch.eval.interpolate\n"
        "import dexiraft_tpu_torch.serve.locks\n"
        "import dexiraft_tpu_torch.serve.sessions\n"
        "import dexiraft_tpu_torch.serve.video\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'dexiraft_tpu'))\n"
        "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_cuda_entry_points_raise_without_device():
    """Asking for CUDA where there is none raises, naming the device; no
    entry point moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from dexiraft_tpu_torch.train.step import (make_encode_step,
                                               make_eval_step,
                                               make_refine_step)

    cfg = raft_v1(small=True, corr_impl="flash", fused_update=True)
    with pytest.raises(RuntimeError, match="'cuda'"):
        create_model(cfg)
    with pytest.raises(RuntimeError, match="'cuda:0'"):
        make_eval_step(RAFT(cfg).eval(), iters=1, device="cuda:0")
    with pytest.raises(RuntimeError, match="'cuda'"):
        make_encode_step(RAFT(cfg).eval())
    with pytest.raises(RuntimeError, match="'cuda'"):
        make_refine_step(RAFT(cfg).eval(), iters=1, adaptive=True)
