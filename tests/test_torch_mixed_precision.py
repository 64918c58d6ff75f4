"""Mixed precision, module by module: the port's bf16 layers against the
JAX package's flax modules with ``dtype=bfloat16``, on the same weights.

The port rounds where flax rounds (models/layers.py): each conv casts its
input, weight and bias to bf16 and adds the bias after the convolution in
bf16; each norm reduces and normalises in fp32 and rounds its output; the
GRU gates compute jax.nn.sigmoid's 1 / (1 + exp(-x)) op by op in bf16. On
one conv the two sides then differ in 2e-5 of the outputs, by one bf16
ulp: the fp32 accumulation order of the convolution decides a rounding
now and then. Through a deep stack those flips multiply, since every later
rounding and every norm's statistics see them.

The encoders and DexiNed run jitted on the JAX side (op by op they take
~30 s here). Under jit XLA fuses elementwise chains and drops some of
flax's intermediate bf16 roundings around the norms, so jitted JAX in
bf16 is 6-13% closer to fp32 than flax's own op-by-op rounding, which the
port reproduces: against the op-by-op JAX encoders the port's distance
from fp32 was 0.994 to 1.007x JAX's, and the no-norm ``cnet`` equals
jitted JAX on 2 of 6 seeds. What each module is held to, with the worst
reading over seeds 0-5 of this file's inputs (a CPU run, torch 2.13, jax
0.9.0; the tests run seed 0):

  * the update blocks (SmallUpdateBlock; BasicUpdateBlock unfused, and
    fused: B1's plain version against the flash Pallas kernel in
    interpret mode; JAX op by op) and the embedded DexiNed's 7 maps:
    relative L2 <= 1e-2 and max |port - JAX| <= 2^-5 max |JAX|, 8 bf16
    ulps at the tensor's largest value (read: relL2 5.2e-3 (DexiNed),
    3.5e-3 (blocks); max 1.23e-2 of max |JAX|, about 3 ulps; the small
    block was bitwise on 3 of the 6 seeds);
  * the encoders (instance, batch and no norm; v5's 7-channel ``efnet``
    on DexiNed's maps): relative L2 <= 4e-2 from JAX's bf16 (read: 2.42e-2
    ``efnet``, 1.98e-2 ``fnet``, whose instance norms re-spread each flip
    over a whole channel, 7.8e-3 ``cnet``), and, measured from the
    encoder's fp32 JAX output, no farther than 1.5x JAX's own bf16 error,
    the factor the whole model is held to (read: 1.000 to 1.131x for
    ``fnet`` and ``cnet``, 1.173 to 1.218x for ``efnet``; that error is
    1.60e-2 to 1.66e-2 for ``fnet``, 1.82e-2 to 1.97e-2 for ``efnet``,
    5.5e-3 to 6.5e-3 for ``cnet``). The two bf16 results are about
    equally good and their rounding errors are uncorrelated
    (tests/test_torch_mixed_precision_model.py argues the whole model the
    same way);
  * the fused path takes convc1's fp32 master weight and rounds only the
    kernel's output: ``test_fused_path_rounds_only_the_output`` holds it
    against the same computation with a rounded weight or an unrounded
    output, which JAX's ``FusedCorrEncoder`` does not do.

The dtypes of every leaf of ``mode="encode"`` and of the two outputs are
JAX's (``jax.eval_shape``, no JAX forward), and the streaming path (the
encode step, the session store, the refine step) keeps them. The pyramid
and its lookup take the fp32 fmaps and return fp32 in every storage
dtype.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.config import raft_v5 as j_raft_v5
from dexiraft_tpu.models.dexined import DexiNed as JDexiNed
from dexiraft_tpu.models.dexined import stack_edge_maps as j_stack
from dexiraft_tpu.models.extractor import BasicEncoder as JBasicEncoder
from dexiraft_tpu.models.extractor import SmallEncoder as JSmallEncoder
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu.models.update import BasicUpdateBlock as JBasicUpdate
from dexiraft_tpu.models.update import SmallUpdateBlock as JSmallUpdate
from dexiraft_tpu.ops.local_corr import build_local_corr as j_build_local_corr
from dexiraft_tpu_torch.config import raft_v1, raft_v5
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.dexined import stack_edge_maps
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.models.update import fused_corr_conv
from dexiraft_tpu_torch.ops.corr import build_corr_pyramid
from dexiraft_tpu_torch.ops.local_corr import build_local_corr
from test_torch_raft import _randomize
from test_torch_train_ops import few_torch_threads  # noqa: F401

BF16 = jnp.bfloat16
SEED = 0
# update blocks and DexiNed's maps: relative L2, and max |diff| as a share
# of max |JAX| (2^-5: 8 bf16 ulps at the largest value)
BLOCK_REL_L2, BLOCK_MAX = 1e-2, 2.0 ** -5
# encoders: relative L2 from JAX's bf16, and the error from JAX's fp32 as
# a multiple of JAX's own bf16 error
ENCODER_REL_L2, ENCODER_VS_FP32 = 4e-2, 1.5


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    """2 torch threads: the suite runs 6 workers at once."""
    yield


def _variables(jcfg, seed):
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JRAFT(jcfg).init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False))
    return _randomize(shapes, seed)


@pytest.fixture(scope="module")
def v1_models():
    """{small: (jax variables, port RAFT in bf16)} for v1 full and small."""
    out = {}
    for small in (False, True):
        v = _variables(j_raft_v1(small=small, corr_impl="local"), 31 + small)
        cfg = raft_v1(small=small, corr_impl="local", mixed_precision=True)
        m = RAFT(cfg)
        m.load_state_dict(raft_state_dict_from_jax(v, cfg=cfg), strict=True)
        out[small] = (v, m.eval())
    return out


@pytest.fixture(scope="module")
def v5_model():
    v = _variables(j_raft_v5(corr_impl="local"), 35)
    cfg = raft_v5(corr_impl="local", mixed_precision=True)
    m = RAFT(cfg)
    m.load_state_dict(raft_state_dict_from_jax(v, cfg=cfg), strict=True)
    return v, m.eval()


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(x) -> np.ndarray:
    """A JAX array (any float dtype) or an NCHW tensor -> fp32 NHWC."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().permute(0, 2, 3, 1).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_np(x))).permute(0, 3, 1, 2)


def _hold_block(ours, ref, name):
    ours, ref = _np(ours), _np(ref)
    assert rel_l2(ours, ref) <= BLOCK_REL_L2, (name, rel_l2(ours, ref))
    worst = float(np.abs(ours - ref).max() / np.abs(ref).max())
    assert worst <= BLOCK_MAX, (name, worst)


def _block_inputs(small, seed, hw=(6, 8), b=2):
    rng = np.random.default_rng(seed)
    hdim, cdim = (96, 64) if small else (128, 128)
    h, w = hw
    net = jnp.asarray(rng.normal(size=(b, h, w, hdim)), BF16)
    inp = jnp.asarray(np.maximum(rng.normal(size=(b, h, w, cdim)), 0), BF16)
    flow = jnp.asarray(rng.normal(0, 2, (b, h, w, 2)), jnp.float32)
    return net, inp, flow, rng


def _block_params(v, small):
    step = v["params"]["ScanRAFTStep_0"]
    return {"params": step["SmallUpdateBlock_0" if small
                           else "BasicUpdateBlock_0"]}


def _jax_block(small):
    return (JSmallUpdate(96, BF16) if small else JBasicUpdate(128, BF16))


def small_block_outputs(v1_models, seed):
    v, m = v1_models[True]
    net, inp, flow, rng = _block_inputs(True, seed)
    corr = jnp.asarray(rng.normal(size=net.shape[:3] + (196,)), jnp.float32)
    j_net, _, j_delta = _jax_block(True).apply(
        _block_params(v, True), net, inp, corr, flow)
    with torch.no_grad():
        p_net, mask, p_delta = m.update_block(
            _nchw(net).bfloat16(), _nchw(inp).bfloat16(), _nchw(corr),
            _nchw(flow))
    assert mask is None
    return [("net", p_net, j_net), ("delta", p_delta, j_delta)]


def basic_block_outputs(v1_models, seed, fused):
    """The full block's (net, mask, delta) on both sides. Fused: JAX's
    FusedCorrEncoder over the flash Pallas kernel (interpret mode), the
    port's over B1's plain version."""
    v, m = v1_models[False]
    net, inp, flow, rng = _block_inputs(False, seed)
    kw, corr = {}, None
    if fused:
        j_pyr, p_pyr, coords = _pyramids(seed)
        j_kw = dict(pyr=j_pyr, coords=jnp.asarray(coords))
        kw = dict(pyr=p_pyr, coords=torch.from_numpy(coords))
    else:
        corr = jnp.asarray(rng.normal(size=net.shape[:3] + (324,)),
                           jnp.float32)
        j_kw = {}
    j_out = _jax_block(False).apply(_block_params(v, False), net, inp, corr,
                                    flow, **j_kw)
    with torch.no_grad():
        p_out = m.update_block(_nchw(net).bfloat16(), _nchw(inp).bfloat16(),
                               None if corr is None else _nchw(corr),
                               _nchw(flow), **kw)
    return list(zip(("net", "mask", "delta"), p_out, j_out))


def _hold_outputs(outputs):
    for name, ours, ref in outputs:
        assert ours.dtype == torch.bfloat16 and ref.dtype == BF16, name
        _hold_block(ours, ref, name)


def test_small_update_block(v1_models):
    _hold_outputs(small_block_outputs(v1_models, SEED))


def test_basic_update_block_unfused(v1_models):
    _hold_outputs(basic_block_outputs(v1_models, SEED, fused=False))


def test_basic_update_block_fused(v1_models, interpret):
    _hold_outputs(basic_block_outputs(v1_models, SEED, fused=True))


def _pyramids(seed, hw=(6, 8), b=2, c=64):
    """fp32 fmaps -> (JAX flash LocalCorr, port flash LocalCorr, coords)."""
    rng = np.random.default_rng(seed + 100)
    f1 = rng.normal(size=(b,) + hw + (c,)).astype(np.float32)
    f2 = rng.normal(size=(b,) + hw + (c,)).astype(np.float32)
    h, w = hw
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    coords = (grid[None].astype(np.float32)
              + rng.normal(0, 1.5, (b, h, w, 2)).astype(np.float32))
    j_pyr = j_build_local_corr(jnp.asarray(f1), jnp.asarray(f2), 4, 4,
                               row_chunk=8, kernel="flash")
    p_pyr = build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2), 4,
                             4, row_chunk=8, kernel="flash")
    return j_pyr, p_pyr, coords


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DEXIRAFT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DEXIRAFT_FLASH_PIXEL_BLOCK", "128")
    monkeypatch.setenv("DEXIRAFT_FLASH_ROWS", "8")


def test_fused_path_rounds_only_the_output(v1_models):
    """convc1 on the fused path = round_bf16(fp32 kernel over the fp32
    master weight), bit for bit; rounding the weight first, or leaving
    the output fp32, gives another tensor."""
    _, m = v1_models[False]
    conv = m.update_block.encoder.convc1
    _, p_pyr, coords = _pyramids(SEED)
    coords = torch.from_numpy(coords)
    with torch.no_grad():
        ours = fused_corr_conv(conv, p_pyr, coords)
        conv.compute_dtype = None
        exact = fused_corr_conv(conv, p_pyr, coords)
        conv.compute_dtype = torch.bfloat16
        w = conv.weight.clone()
        conv.weight.copy_(w.bfloat16().float())
        rounded_w = fused_corr_conv(conv, p_pyr, coords)
        conv.weight.copy_(w)
    assert ours.dtype == torch.bfloat16 and exact.dtype == torch.float32
    assert torch.equal(ours, exact.bfloat16())
    assert not torch.equal(ours, rounded_w.bfloat16())
    assert not torch.equal(ours.float(), exact)


_ENCODERS = [
    # (small, module name, norm, output dim, input channels)
    (False, "fnet", "instance", 256, 3),
    (False, "cnet", "batch", 256, 3),
    (True, "cnet", "none", 160, 3),
]


def encoder_outputs(v1_models, spec, seed, dtype=BF16):
    """(port bf16, JAX at ``dtype``) outputs of one encoder of _ENCODERS."""
    small, name, norm, dim, cin = spec
    v, m = v1_models[small]
    x = np.random.default_rng(seed).uniform(
        -1, 1, (2, 64, 64, cin)).astype(np.float32)
    enc = (JSmallEncoder if small else JBasicEncoder)(dim, norm, 0.0, dtype)
    jv = {"params": v["params"][name]}
    if name in v.get("batch_stats", {}):
        jv["batch_stats"] = v["batch_stats"][name]
    ref = jax.jit(functools.partial(enc.apply, train=False))(
        jv, jnp.asarray(x).astype(dtype))
    with torch.no_grad():
        ours = getattr(m, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    return ours, ref


@pytest.mark.parametrize("spec", _ENCODERS,
                         ids=[f"{e[1]}-{e[2]}" for e in _ENCODERS])
def test_encoder(v1_models, spec):
    ours, ref = encoder_outputs(v1_models, spec, SEED)
    _, ref32 = encoder_outputs(v1_models, spec, SEED, jnp.float32)
    _hold_encoder(ours, ref, ref32)


def _hold_encoder(ours, ref, ref32):
    assert ours.dtype == torch.bfloat16 and ref.dtype == BF16
    ours, ref, ref32 = _np(ours), _np(ref), _np(ref32)
    assert rel_l2(ours, ref) <= ENCODER_REL_L2
    e_jax = rel_l2(ref, ref32)
    assert 0 < rel_l2(ours, ref32) <= ENCODER_VS_FP32 * e_jax


def dexined_outputs(v5_model, seed):
    """[(name, port, JAX bf16, JAX fp32 or None)] for the embedded
    DexiNed's stacked maps and v5's 7-channel edge encoder on JAX's maps
    (on both sides)."""
    v, m = v5_model
    x = np.random.default_rng(seed).uniform(
        -1, 1, (2, 32, 48, 3)).astype(np.float32)
    jd = {"params": v["params"]["DexiNed_0"],
          "batch_stats": v["batch_stats"]["DexiNed_0"]}
    j_maps = j_stack(jax.jit(functools.partial(
        JDexiNed(dtype=BF16).apply, train=False))(jd, jnp.asarray(x)))
    with torch.no_grad():
        outs = m.dexined(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert all(o.dtype == torch.bfloat16 for o in outs)
    em = _np(j_maps)
    ref, ref32 = (jax.jit(functools.partial(
        JBasicEncoder(256, "instance", 0.0, dt).apply, train=False))(
        {"params": v["params"]["efnet"]}, jnp.asarray(em).astype(dt))
        for dt in (BF16, jnp.float32))
    with torch.no_grad():
        ours = m.efnet(torch.from_numpy(em).permute(0, 3, 1, 2))
    return [("maps", stack_edge_maps(outs), j_maps, None),
            ("efnet", ours, ref, ref32)]


def test_v5_edge_encoder_and_dexined(v5_model):
    """The embedded DexiNed in bf16 (the model casts its 7 maps to fp32,
    as JAX does) and v5's 7-channel edge encoder."""
    (_, maps, j_maps, _), (_, *efnet) = dexined_outputs(v5_model, SEED)
    assert maps.dtype == torch.bfloat16 and j_maps.dtype == BF16
    _hold_block(maps, j_maps, "maps")
    _hold_encoder(*efnet)


def _jax_dtypes(tree):
    return jax.tree.map(lambda a: np.dtype(a.dtype).name, tree)


@pytest.mark.parametrize("variant", ["v1", "v5"])
def test_dtype_tree_matches_jax(v1_models, v5_model, variant):
    """Every leaf of the per-frame feature dict and both outputs: fmap /
    efmap fp32, ctx / ectx bf16, flow_low / flow_up fp32 (JAX's by
    jax.eval_shape; the port's from a 32x48 forward)."""
    v, m = v5_model if variant == "v5" else v1_models[False]
    jcfg = (j_raft_v5 if variant == "v5" else j_raft_v1)(
        corr_impl="local", mixed_precision=True)
    img = jnp.zeros((1, 32, 48, 3), jnp.float32)
    j_enc = _jax_dtypes(jax.eval_shape(lambda: JRAFT(jcfg).apply(
        v, img, mode="encode")))
    j_out = _jax_dtypes(jax.eval_shape(lambda: JRAFT(jcfg).apply(
        v, img, img, iters=2, test_mode=True)))
    x = torch.full((1, 3, 32, 48), 100.0)
    with torch.inference_mode():
        feats = m.encode_frame(x)
        low, up = m(x, x, iters=2)
        low2, up2 = m(mode="step", features1=feats, features2=feats, iters=2)
    ours = {k: str(t.dtype).replace("torch.", "") for k, t in feats.items()}
    assert ours == j_enc
    assert j_enc["fmap"] == "float32" and j_enc["ctx"] == "bfloat16"
    assert {t.dtype for t in (low, up, low2, up2)} == {torch.float32}
    assert list(j_out) == ["float32", "float32"]


def test_encode_step_and_session_carry_keep_the_dtypes(v1_models):
    """Under bf16 the streaming path's per-frame features keep encode's
    dtypes through make_encode_step, the device session store (whose byte
    gauge counts each leaf at its own width: ctx at 2 bytes an element) and
    make_refine_step, which returns fp32 flows."""
    from dexiraft_tpu_torch.serve.sessions import DeviceSessionStore
    from dexiraft_tpu_torch.train.step import make_encode_step, \
        make_refine_step
    _, m = v1_models[True]
    feats = make_encode_step(m, device="cpu")(
        np.full((1, 32, 48, 3), 100.0, np.float32))
    flow = torch.zeros(1, 4, 6, 2)
    store = DeviceSessionStore()
    store.put("s", (32, 48), feats, flow)
    carried, flow_init = store.get("s", (32, 48))
    assert {k: v.dtype for k, v in carried.items()} == {
        "fmap": torch.float32, "ctx": torch.bfloat16}
    assert store.bytes_in_use == flow.nbytes + sum(
        v.numel() * v.element_size() for v in carried.values())
    low, up = make_refine_step(m, iters=2, device="cpu")(carried, feats,
                                                         flow_init)
    assert low.dtype == up.dtype == torch.float32


@pytest.mark.parametrize("corr_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("impl", ["allpairs", "local"])
def test_pyramids_stay_fp32(impl, corr_dtype):
    """The pyramid builds from the fp32 fmaps in its storage dtype and the
    lookup returns fp32, under mixed precision as without it: the model
    hands the correlation the fmaps cast back to fp32."""
    rng = np.random.default_rng(1)
    f1 = torch.from_numpy(rng.normal(size=(1, 6, 8, 32)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(1, 6, 8, 32)).astype(np.float32))
    build = build_corr_pyramid if impl == "allpairs" else build_local_corr
    pyr = build(f1, f2, 4, 3, dtype=corr_dtype)
    coords = torch.from_numpy(rng.uniform(0, 6, (1, 6, 8, 2)).astype(
        np.float32))
    assert pyr(coords).dtype == torch.float32
    m = RAFT(raft_v1(small=True, corr_impl=impl, corr_dtype=corr_dtype,
                     mixed_precision=True)).eval()
    with torch.inference_mode():
        feats = m.encode_frame(torch.zeros(1, 3, 48, 64))
    assert feats["fmap"].dtype == torch.float32


def test_parameters_stay_fp32_and_the_bridge_is_unchanged(v1_models):
    """A mixed-precision model holds fp32 parameters and buffers, takes
    the bridge's fp32 state dict strictly, and its state dict equals an
    fp32 model's loaded from the same tree, key for key and bit for bit."""
    v, m = v1_models[False]
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    assert {b.dtype for b in m.buffers() if b.is_floating_point()} == {
        torch.float32}
    fp32 = RAFT(dataclasses.replace(m.cfg, mixed_precision=False))
    fp32.load_state_dict(raft_state_dict_from_jax(v, cfg=fp32.cfg),
                         strict=True)
    a, b = m.state_dict(), fp32.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
