"""v2, v3 and v4: JAX RAFT against the PyTorch port on the same weights.

JAX side: ``RAFT(cfg).apply`` of raft_v2 (6-channel early fusion with
data-supplied edge images), raft_v3 (dual stream over data edges through
the shared fnet/cnet, decoupled updates, RefineFlow) and raft_v4
(10-channel early fusion with the embedded DexiNed's raw logit maps), on
``corr_impl="local"``, and v3 also on the fused flash kernel in interpret
mode (DEXIRAFT_PALLAS_INTERPRET=1; its 2B batch goes through B1's plain
version on the port's side). Port side: ``dexiraft_tpu_torch`` RAFT with
the same config on the CPU, loaded through ``raft_state_dict_from_jax``.
Full width, at 48x64 and at 40x64 (the 0-row 4th level) with a flow_init,
3 iterations; v3 also small (its two streams upsampled by upflow8).

Every leaf of the JAX variables is a seeded random value
(test_torch_raft._randomize) on a ``jax.eval_shape`` tree.

Tolerances (docs/parity.md): v2 rtol 5e-3 (the v1 row: one stream, no
DexiNed), v3 and v4 rtol 1e-2 (the v5 row: a dual stream, or DexiNed in
front of the encoders), each with atol 1e-3 px for flow components near
zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import VARIANTS as J_VARIANTS
from dexiraft_tpu.interop.torch_convert import export_raft_state_dict
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu_torch.config import VARIANTS
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT, _normalize
from dexiraft_tpu_torch.models.dexined import stack_edge_maps
from test_torch_raft import _images, _randomize

ITERS = 3
TOL = {"v2": (5e-3, 1e-3), "v3": (1e-2, 1e-3), "v4": (1e-2, 1e-3)}
SEEDS = {"v2": 21, "v3": 22, "v4": 23}


def _jax_variables(variant, small, seed):
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    cfg = J_VARIANTS[variant](small=small, corr_impl="local")
    shapes = jax.eval_shape(lambda: JRAFT(cfg).init(
        jax.random.PRNGKey(0), img, img, edges1=img, edges2=img, iters=1,
        train=False))
    return _randomize(shapes, seed)


@pytest.fixture(scope="module")
def variables():
    out = {v: _jax_variables(v, False, s) for v, s in SEEDS.items()}
    out["v3_small"] = _jax_variables("v3", True, 24)
    return out


def _edges(h, w, seed):
    """Data-supplied edge images: a sparse bright line pattern in [0, 255]
    (as an edge detector's output looks) on each of the 2 frames."""
    rng = np.random.default_rng(seed)
    e = (rng.uniform(0, 1, (2, h, w, 3)) > 0.8) * 255.0
    return e.astype(np.float32), np.roll(e, 2, axis=2).astype(np.float32)


def _nchw(x):
    return None if x is None else torch.from_numpy(x).permute(0, 3, 1, 2)


def _port(v, variant, small=False, **cfg):
    c = VARIANTS[variant](small=small, **cfg)
    model = RAFT(c)
    model.load_state_dict(raft_state_dict_from_jax(v, cfg=c), strict=True)
    return model.eval()


def _run_both(v, variant, hw, seed, small=False, flow_init=None, **cfg):
    im1, im2 = _images(*hw, seed=seed)
    e1, e2 = _edges(*hw, seed=seed + 100)
    jmodel = JRAFT(J_VARIANTS[variant](small=small, **cfg))
    j_low, j_up = jax.jit(lambda a, b, e1, e2, fi: jmodel.apply(
        v, a, b, edges1=e1, edges2=e2, flow_init=fi, iters=ITERS,
        train=False, test_mode=True))(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(e1), jnp.asarray(e2),
        None if flow_init is None else jnp.asarray(flow_init))
    model = _port(v, variant, small, **cfg)
    with torch.inference_mode():
        low, up = model(_nchw(im1), _nchw(im2), iters=ITERS,
                        flow_init=_nchw(flow_init), edges1=_nchw(e1),
                        edges2=_nchw(e2))
    low = low.permute(0, 2, 3, 1).numpy()
    up = up.permute(0, 2, 3, 1).numpy()
    assert low.shape == (2, hw[0] // 8, hw[1] // 8, 2)
    assert up.shape == (2,) + hw + (2,)
    assert np.abs(np.asarray(j_low)).max() > 1e-2  # not a trivial flow
    rtol, atol = TOL[variant]
    np.testing.assert_allclose(low, np.asarray(j_low), rtol=rtol, atol=atol)
    np.testing.assert_allclose(up, np.asarray(j_up), rtol=rtol, atol=atol)


@pytest.mark.parametrize("hw", [(48, 64), (40, 64)])
@pytest.mark.parametrize("variant", ["v2", "v3", "v4"])
def test_variant_matches_jax(variables, variant, hw):
    """At 40x64 with a flow_init, which offsets the image stream only (v3:
    the edge stream starts at the coordinate grid)."""
    init = None
    if hw == (40, 64):
        init = np.random.default_rng(31).normal(
            0, 1.5, (2, 5, 8, 2)).astype(np.float32)
    _run_both(variables[variant], variant, hw, seed=hw[0] + 3,
              flow_init=init, corr_impl="local")


def test_v3_flash_fused_matches_jax(variables, monkeypatch):
    """v3's 2B batch through the fused flash step: JAX's Pallas kernel in
    interpret mode against the port's B1 wrapper (its plain version on
    CPU tensors)."""
    monkeypatch.setenv("DEXIRAFT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DEXIRAFT_FLASH_PIXEL_BLOCK", "128")
    monkeypatch.setenv("DEXIRAFT_FLASH_ROWS", "8")
    _run_both(variables["v3"], "v3", (40, 64), seed=7, corr_impl="flash",
              fused_update=True)


def test_v3_small_matches_jax(variables):
    """The small v3: both streams upsampled by upflow8 before RefineFlow."""
    _run_both(variables["v3_small"], "v3", (48, 64), seed=8, small=True,
              corr_impl="local")


@pytest.mark.parametrize("variant", ["v2", "v3", "v4"])
def test_bridge_equals_export_bitwise(variables, variant):
    """The bridge against the JAX package's exporter for every key the
    exporter maps, bit for bit; v3's RefineFlow conv (no exporter entry)
    against the transposed flax kernel; then a strict load."""
    v = variables[variant]
    cfg = VARIANTS[variant](corr_impl="local")
    model = RAFT(cfg)
    template = model.state_dict()
    ours = raft_state_dict_from_jax(v, cfg=cfg)
    assert list(ours) == list(template)
    mapped = {k: t for k, t in template.items()
              if not k.startswith("refine_flow.")}
    theirs = export_raft_state_dict(v, mapped)
    assert set(theirs) == set(mapped)
    for k in mapped:
        ref = np.asarray(theirs[k])
        assert ours[k].numpy().dtype == ref.dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), ref, err_msg=k)
    if variant == "v3":
        leaf = v["params"]["ScanRAFTStep_0"]["RefineFlow_0"]["Conv_0"]
        np.testing.assert_array_equal(
            ours["refine_flow.conv.weight"].numpy(),
            np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(ours["refine_flow.conv.bias"].numpy(),
                                      np.asarray(leaf["bias"]))
        assert not any(k.startswith(("efnet.", "ecnet.")) for k in ours)
    model.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("variant", ["v2", "v3", "v4"])
def test_bridge_reads_variant_off_the_tree(variables, variant):
    """Without a cfg the bridge tells v2 (6-channel stem) from v1, v3 (a
    RefineFlow leaf) from v1 and v4 (DexiNed, no efnet) from v5."""
    ours = raft_state_dict_from_jax(variables[variant])
    model = RAFT(VARIANTS[variant](corr_impl="local"))
    assert list(ours) == list(model.state_dict())
    model.load_state_dict(ours, strict=True)


def test_v4_tree_no_longer_read_as_v5(variables):
    """A v4 tree holds DexiNed but no edge encoders. Read as v5 (the rule
    before the variant was read off the tree), its key set asks for
    efnet/ecnet and fails; read as v4, it loads strictly."""
    v = variables["v4"]
    with pytest.raises(KeyError, match="efnet"):
        raft_state_dict_from_jax(v, cfg=VARIANTS["v5"](corr_impl="local"))
    sd = raft_state_dict_from_jax(v)
    assert "dexined.block_1.conv1.weight" in sd
    assert not any(k.startswith("efnet.") for k in sd)
    assert sd["fnet.conv1.weight"].shape[1] == 10
    RAFT(VARIANTS["v4"](corr_impl="local")).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_missing_edges_raise(variant):
    """v2/v3 without edge images raise JAX's error, in the pair forward
    and in the per-frame encoder."""
    with torch.device("meta"):
        model = RAFT(VARIANTS[variant](corr_impl="local")).eval()
    x = torch.zeros(1, 3, 48, 64)
    with pytest.raises(ValueError, match="requires data-supplied "
                                         "edges1/edges2"):
        model(x, x, iters=1)
    with pytest.raises(ValueError, match="requires data-supplied "
                                         "edges1/edges2"):
        model(x, x, iters=1, edges1=x)
    with pytest.raises(ValueError, match="a data-supplied edge frame in "
                                         "mode='encode'"):
        model(x, mode="encode")


def _fnet_input(model, *args, **kw):
    """The tensor the feature encoder's stem conv reads in the pair
    forward."""
    seen = []
    hook = model.fnet.conv1.register_forward_hook(
        lambda m, inp, out: seen.append(inp[0]))
    with torch.inference_mode():
        model(*args, iters=1, **kw)
    hook.remove()
    return seen[0]


def test_v4_input_is_normalized_image_and_raw_logits(variables):
    """v4's encoders read the normalized image beside DexiNed's 7 raw
    (unnormalized) logit maps."""
    model = _port(variables["v4"], "v4", corr_impl="local")
    im1, im2 = (_nchw(x) for x in _images(48, 64, seed=3))
    x = _fnet_input(model, im1, im2)
    assert x.shape == (4, 10, 48, 64)
    norm = _normalize(torch.cat([im1, im2]))
    with torch.inference_mode():
        logits = stack_edge_maps(model.dexined(norm))
    torch.testing.assert_close(x[:, :3], norm, rtol=0, atol=0)
    torch.testing.assert_close(x[:, 3:], logits, rtol=0, atol=0)


def test_v2_input_is_normalized_image_and_edges(variables):
    """v2's encoders read the normalized image beside the normalized
    data edge image."""
    model = _port(variables["v2"], "v2", corr_impl="local")
    im1, im2 = (_nchw(x) for x in _images(48, 64, seed=4))
    e1, e2 = (_nchw(x) for x in _edges(48, 64, seed=4))
    x = _fnet_input(model, im1, im2, edges1=e1, edges2=e2)
    assert x.shape == (4, 6, 48, 64)
    torch.testing.assert_close(x[:, :3], _normalize(torch.cat([im1, im2])),
                               rtol=0, atol=0)
    torch.testing.assert_close(x[:, 3:], _normalize(torch.cat([e1, e2])),
                               rtol=0, atol=0)


def test_variant_refusals():
    """The JAX package's refusals: dual without DexiNed; and the pairings
    outside the five variants."""
    from dexiraft_tpu_torch.config import RAFTConfig

    with pytest.raises(ValueError, match="requires embed_dexined=True"):
        RAFT(RAFTConfig(variant="dual", corr_impl="local"))
    for variant in ("raft", "separate"):
        with pytest.raises(ValueError, match="none of the five"):
            RAFT(RAFTConfig(variant=variant, embed_dexined=True,
                            corr_impl="local"))
    with torch.device("meta"):
        v3 = RAFT(VARIANTS["v3"](corr_impl="flash", fused_update=True))
    with pytest.raises(ValueError, match="does not support "
                                         "variant='separate'"):
        v3.eval()(torch.zeros(1, 3, 48, 64), torch.zeros(1, 3, 48, 64),
                  edges1=torch.zeros(1, 3, 48, 64),
                  edges2=torch.zeros(1, 3, 48, 64), adaptive=True)
