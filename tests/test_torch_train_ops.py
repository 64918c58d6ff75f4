"""The port's training building blocks against the JAX package's.

  * the all-pairs pyramid and ``corr_lookup`` (fp32 atol 1e-5; bf16 and
    int8 storage at the tolerance of their rounding) and
    ``bilinear_sampler``;
  * ``sequence_loss`` and ``flow_metrics`` (the port computes on NCHW);
  * ``onecycle_lr`` over a whole schedule, past its total too;
  * the optimizer against optax's clip -> AdamW chain over 3 steps on the
    same parameters and gradients, with the global norm on both sides of
    the clip threshold (rtol 1e-6), and a parameter without a gradient
    decayed as optax decays every leaf;
  * the train step on ``local``, ``flash`` and ``pallas``, fused and
    unfused: on the CPU the kernel wrappers run their plain versions, and
    every path gives the same loss and gradients;
  * the refusals: int8 in training, bf16, remat, a mesh.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dexiraft_tpu.ops import corr as jcorr
from dexiraft_tpu.ops.grid import bilinear_sampler as j_bilinear_sampler
from dexiraft_tpu.ops.losses import flow_metrics as j_flow_metrics
from dexiraft_tpu.ops.losses import sequence_loss as j_sequence_loss
from dexiraft_tpu.train.optimizer import make_optimizer as j_make_optimizer
from dexiraft_tpu.train.optimizer import onecycle_lr as j_onecycle_lr
from dexiraft_tpu_torch.config import TrainConfig, raft_v1, raft_v5
from dexiraft_tpu_torch.models.raft import RAFT, create_model
from dexiraft_tpu_torch.ops import corr as pcorr
from dexiraft_tpu_torch.ops.grid import bilinear_sampler
from dexiraft_tpu_torch.ops.losses import flow_metrics, sequence_loss
from dexiraft_tpu_torch.train.optimizer import make_optimizer, onecycle_lr
from dexiraft_tpu_torch.train.state import create_state
from dexiraft_tpu_torch.train.step import make_train_step


@pytest.fixture(autouse=True)
def few_torch_threads():
    """torch's CPU thread pool at 2 threads for each test, restored after:
    the suite runs in several worker processes at once, and a pool of one
    thread per core in each of them oversubscribes the cores (this file's
    train steps ran ~20x slower that way than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _maps(seed, b=2, h=6, w=9, c=32):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
    coords = (coords + rng.normal(0, 3, (b, h, w, 2))).astype(np.float32)
    # a few centers far outside the frame: their windows read zeros
    coords[0, 0, 0] = (-20.0, 40.0)
    return f1, f2, coords


@pytest.mark.parametrize("dtype, atol", [("fp32", 1e-5), ("bf16", 1e-5),
                                         ("int8", 1e-5)])
def test_corr_pyramid_and_lookup_match_jax(dtype, atol):
    """Both sides store each level in ``dtype`` from the same fp32 volume,
    so the stored values agree up to the rounding of the last bit; the
    windows then agree at atol 1e-5 (each tap is a bilinear blend of at
    most four stored values)."""
    f1, f2, coords = _maps(0)
    jp = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, 3,
                                  dtype=dtype)
    pp = pcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2),
                                  4, 3, dtype=dtype)
    assert len(pp.levels) == 4 and (pp.scales is None) == (dtype != "int8")
    for jl, pl in zip(jp.levels, pp.levels):
        assert tuple(pl.shape) == jl.shape
        ref = np.asarray(jnp.asarray(jl, jnp.float32))
        got = pl.to(torch.float32).numpy()
        if dtype == "int8":
            # round-half-even on both sides; the scales agree to 1 ulp
            assert ref.size == 0 or np.abs(got - ref).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-2 if dtype == "bf16"
                                       else 1e-6, atol=1e-6)
    out = pcorr.corr_lookup(pp, torch.from_numpy(coords)).numpy()
    ref = np.asarray(jcorr.corr_lookup(jp, jnp.asarray(coords)))
    assert out.shape == (2, 6, 9, 4 * 49)
    scale = 1.0 if dtype == "fp32" else float(np.abs(ref).max())
    tol = atol if dtype == "fp32" else (4e-3 if dtype == "bf16" else 1e-2)
    np.testing.assert_allclose(out, ref, atol=tol * scale, rtol=0)
    assert np.abs(out[0, 0, 0]).max() == 0.0


def test_allpairs_lookup_equals_local_lookup():
    """The materialized pyramid and the on-demand lookup are one function:
    pooling the volume equals correlating against pooled fmap2."""
    from dexiraft_tpu_torch.ops.local_corr import build_local_corr
    f1, f2, coords = _maps(1, h=12, w=16)
    t = [torch.from_numpy(x) for x in (f1, f2, coords)]
    a = pcorr.build_corr_pyramid(t[0], t[1], 4, 4)(t[2])
    b = build_local_corr(t[0], t[1], 4, 4, row_chunk=5)(t[2])
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_window_channel_order_is_x_slow():
    """Channel ix * (2r+1) + iy of a level's window samples the volume at
    (x + ix - r, y + iy - r): the x offset on the slow axis."""
    b, h, w, c, r = 1, 5, 7, 16, 2
    f1 = torch.zeros(b, h, w, c)
    f1[0, 2, 3, 0] = 1.0
    f2 = torch.zeros(b, h, w, c)
    f2[0, 1, 4, 0] = 4.0  # dy = -1, dx = +1 from pixel (2, 3)
    pyr = pcorr.build_corr_pyramid(f1, f2, 1, r)
    out = pyr(pcorr_coords(b, h, w))[0, 2, 3]
    win = 2 * r + 1
    ix, iy = 1 + r, -1 + r
    assert int(out.argmax()) == ix * win + iy and float(out.max()) == 1.0


def pcorr_coords(b, h, w):
    from dexiraft_tpu_torch.ops.grid import coords_grid
    return coords_grid(b, h, w)


def test_bilinear_sampler_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    coords = rng.uniform(-2, 11, (2, 4, 6, 2)).astype(np.float32)
    coords[0, 0, 0] = (3.0, 4.0)  # an integer point: exactly one pixel
    out = bilinear_sampler(torch.from_numpy(img), torch.from_numpy(coords))
    ref = j_bilinear_sampler(jnp.asarray(img), jnp.asarray(coords))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(out[0, 0, 0].numpy(), img[0, 4, 3])


def test_sequence_loss_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    n, b, h, w = 4, 2, 8, 12
    preds = rng.normal(0, 3, (n, b, h, w, 2)).astype(np.float32)
    gt = rng.normal(0, 3, (b, h, w, 2)).astype(np.float32)
    gt[0, 0, 0] = (500.0, 0.0)  # past max_flow: masked out
    valid = (rng.uniform(size=(b, h, w)) > 0.3).astype(np.float32)
    jl, jm = j_sequence_loss(jnp.asarray(preds), jnp.asarray(gt),
                             jnp.asarray(valid), 0.85)
    tp = torch.from_numpy(preds).permute(0, 1, 4, 2, 3)
    tg = torch.from_numpy(gt).permute(0, 3, 1, 2)
    loss, metrics = sequence_loss(tp, tg, torch.from_numpy(valid), 0.85)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for k in ("epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-6, err_msg=k)
    fm = flow_metrics(tp[1], tg, torch.from_numpy(valid) > 0.5)
    jfm = j_flow_metrics(jnp.asarray(preds[1]), jnp.asarray(gt),
                         jnp.asarray(valid) > 0.5)
    for k in fm:
        np.testing.assert_allclose(float(fm[k]), float(jfm[k]), rtol=1e-6)
    # invalid pixels are zeroed but counted: all-invalid gives loss 0
    zero, _ = sequence_loss(tp, tg, torch.zeros(b, h, w))
    assert float(zero) == 0.0


@pytest.mark.parametrize("max_lr, total", [(4e-4, 100_100), (1.25e-4, 1100),
                                           (1e-3, 20)])
def test_onecycle_lr_matches_jax(max_lr, total):
    ours, theirs = onecycle_lr(max_lr, total), j_onecycle_lr(max_lr, total)
    steps = sorted(set(np.linspace(0, total + 50, 400).astype(int).tolist()
                       + [0, 1, total - 1, total, total + 1000]))
    # both in float32; near the end of the decay the subtraction cancels,
    # so the bar is 1e-6 of the peak rate
    for s in steps:
        np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=0,
                                   atol=1e-6 * max_lr, err_msg=str(s))
    assert ours(total + 1000) == ours(total - 1)  # clamped


@pytest.mark.parametrize("clip", [1.0, 1e3, 0.0])
def test_optimizer_matches_optax(clip):
    """Three updates of clip -> AdamW on the same parameters and
    gradients. With clip 1 the global norm (~5) is above the threshold and
    the gradients are scaled; with 1e3 it is below and they are not; 0 has
    no clip. The third parameter never gets a gradient: optax decays it,
    and so must the port."""
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (5,), (2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    for g in grads:
        g[2][:] = 0.0
    lr, steps, wd = 3e-2, 10, 0.3
    tx = j_make_optimizer(lr, steps, wdecay=wd, clip=clip)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(tp, lr, steps, wdecay=wd, clip=clip)
    norms = []
    for g in grads:
        jg = {str(i): jnp.asarray(x) for i, x in enumerate(g)}
        norms.append(float(optax.global_norm(jg)))
        upd, st = tx.update(jg, st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp[:2], g[:2]):
            p.grad = torch.from_numpy(x.copy())
        tp[2].grad = None
        opt.step()
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[str(i)]), rtol=1e-6,
                                       atol=1e-7, err_msg=str(i))
    if clip == 1.0:
        assert min(norms) > clip
    if clip == 1e3:
        assert max(norms) < clip
    assert not np.allclose(tp[2].detach().numpy(), params[2])
    assert opt.param_groups[0]["count"] == 3


def test_optimizer_state_dict_round_trip():
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], 1e-2, 10)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    sd = copy.deepcopy(opt.state_dict())  # state_dict() shares tensors
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = make_optimizer([q], 1e-2, 10)
    opt2.load_state_dict(sd)
    assert opt2.param_groups[0]["count"] == 1
    for o, par in ((opt, p), (opt2, q)):
        par.grad = torch.full((3,), -0.25)
        o.step()
    torch.testing.assert_close(p, q, rtol=0, atol=0)


def _batch(seed, b=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    return dict(image1=im1, image2=np.roll(im1, 3, axis=2),
                flow=np.tile(np.float32([3.0, 0.0]), (b, h, w, 1)),
                valid=np.ones((b, h, w), np.float32))


@pytest.mark.parametrize("variant", ["v1", "v5"])
def test_every_corr_path_trains_alike(variant):
    """One state dict, one batch, every lookup path: the same loss and
    gradients (on the CPU the kernel wrappers run their plain versions;
    the kernels' backward is the plain version's on every device)."""
    make = raft_v1 if variant == "v1" else raft_v5
    kw = dict(small=True) if variant == "v1" else {}
    sd = create_model(make(corr_impl="local", **kw), seed=3,
                      device="cpu").state_dict()
    tc = TrainConfig(iters=2, batch_size=2, num_steps=50)
    batch = _batch(5, h=64 if variant == "v1" else 48)
    paths = (("local", False), ("allpairs", False), ("flash", False),
             ("flash", True), ("pallas", False), ("pallas", True))
    if variant == "v5":  # the dual stream on the plain, all-pairs and
        # fused lookups (on the CPU B3's plain version is B1's)
        paths = (("local", False), ("allpairs", False), ("flash", True))
    results = []
    for impl, fused in paths:
        cfg = make(corr_impl=impl, fused_update=fused, **kw)
        model = RAFT(cfg)
        model.load_state_dict(sd)
        state = create_state(cfg, tc, device="cpu", model=model)
        state, m = make_train_step(cfg, tc)(state, batch)
        grads = torch.cat([(p.grad if p.grad is not None
                            else torch.zeros_like(p)).reshape(-1)
                           for p in state.model.parameters()])
        results.append((impl, fused, float(m["loss"]), grads))
    _, _, loss0, g0 = results[0]
    for impl, fused, loss, g in results[1:]:
        assert loss == pytest.approx(loss0, rel=1e-5), (impl, fused)
        rel = float((g - g0).norm() / g0.norm())
        assert rel < 1e-4, (impl, fused, rel)


def test_train_mode_forward_and_modes():
    cfg = raft_v5(corr_impl="local", dropout=0.5)
    model = create_model(cfg, device="cpu").train()
    assert not model.dexined.training  # DexiNed stays in eval
    assert model.cnet.norm1.training
    model.freeze_bn()
    assert not model.cnet.norm1.training and model.fnet.dropout.training
    x = torch.zeros(1, 3, 48, 64)
    g = torch.Generator().manual_seed(0)
    model.set_dropout_generator(g)
    out = model(x, x + 1, iters=3, test_mode=False)
    assert out.shape == (3, 1, 2, 48, 64)
    # eval mode: no dropout, running stats; the last prediction is the
    # test-mode flow
    model.eval()
    preds = model(x, x + 1, iters=3, test_mode=False)
    low, up = model(x, x + 1, iters=3, test_mode=True)
    torch.testing.assert_close(preds[-1], up)


def test_channel_dropout_is_per_channel_and_seeded():
    from dexiraft_tpu_torch.models.layers import ChannelDropout
    d = ChannelDropout(0.5).train()
    x = torch.ones(4, 16, 3, 5)
    d.generator = torch.Generator().manual_seed(7)
    a = d(x)
    d.generator = torch.Generator().manual_seed(7)
    torch.testing.assert_close(a, d(x))
    per_channel = a.reshape(4, 16, -1)
    assert bool((per_channel == per_channel[..., :1]).all())
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}
    assert torch.equal(d.eval()(x), x)


def test_batchnorm_running_var_follows_flax():
    """Training-mode BatchNorm folds the BIASED batch variance into its
    running var, as flax does (torch's own folds the unbiased one)."""
    import flax.linen as fnn
    from dexiraft_tpu_torch.models.layers import make_norm
    rng = np.random.default_rng(8)
    x = rng.normal(1.0, 2.0, (2, 3, 3, 4)).astype(np.float32)
    bn = make_norm("batch", 1, 4).train()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jy, mut = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), atol=1e-5)
    stats = mut["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)


def test_refusals():
    x = torch.zeros(1, 3, 32, 32)
    m = create_model(raft_v1(small=True, corr_impl="local",
                             corr_dtype="int8"), device="cpu").train()
    with pytest.raises(ValueError, match="inference format"):
        m(x, x, test_mode=False)
    cfg, tc = raft_v1(corr_impl="local"), TrainConfig()
    # bf16 and both remat modes are ported: the step builds, and a state
    # from another config is refused by name
    for ok in (dict(precision="bf16"), dict(remat="per_iter"),
               dict(remat="dots_saveable")):
        assert callable(make_train_step(cfg, dataclasses.replace(tc, **ok)))
    state = create_state(cfg, tc, device="cpu")
    with pytest.raises(ValueError, match="train_model_config"):
        make_train_step(cfg, dataclasses.replace(tc, precision="bf16"))(
            state, {})
    with pytest.raises(ValueError, match="remat must be"):
        make_train_step(cfg, dataclasses.replace(tc, remat="sometimes"))
    with pytest.raises(ValueError, match="A12"):
        make_train_step(cfg, tc, mesh=object())
    # halo is ported (parallel/halo.py): without a seq mesh it is refused
    with pytest.raises(ValueError, match="'seq' axis"):
        make_train_step(cfg, tc, compute_sharding="halo")
    with pytest.raises(ValueError, match="edge_sum_fusion"):
        make_train_step(raft_v5(corr_impl="local"),
                        dataclasses.replace(tc, edge_sum_fusion=True))
