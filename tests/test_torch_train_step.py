"""The port's train step against ``dexiraft_tpu.train.step.make_train_step``.

Both sides start from the same seeded random variables (test_torch_raft's
``_randomize``; BatchNorm running stats included), carried into the port
through ``raft_state_dict_from_jax``, and take one step on the same batch
(dropout 0, no noise): the loss, every parameter's gradient (the JAX
gradients, from ``jax.grad`` of the same loss, mapped through the same
bridge), the parameters after the update and the BatchNorm running stats
are held at atol 1e-4 / rtol 1e-3 (tests/test_zzzhalo.py's bar).

  * v1 full (BatchNorm in the context encoder) on ``allpairs``, the CLI
    default, at 64x64, 3 iterations; also with ``accum_steps=2`` and with
    ``freeze_bn``. Frozen, the BatchNorms run on the fixture's random
    running stats, the features are no longer normalized and the
    correlation branch's gradients reach ~1.4 (against ~1e-2 in batch-stat
    mode); there each gradient is held at 1e-3 of its tensor's largest
    JAX value (measured: 2e-4 of it, on 701 of 442368 elements of
    ``convc2``; the loss agrees to 1e-7), the rest as above;
  * v1 small and v5: tests/test_torch_train_small.py and
    tests/test_torch_train_v5.py, with this file's helpers.

On one batch (``make_batch(5)``) the JAX gradients of the small encoder
itself are ~1% off: against the port's float64 gradients, the JAX fp32
ones differ by 7.7 (of 783) in ``layer1.0.conv1``, the port's fp32 ones by
1.1e-3, on the same weights, with forwards that agree to 4e-5. That is a
property of the reference's arithmetic on the CPU, not of the port, and
``test_encoder_gradients_agree_with_float64`` pins the port's side on that
batch; the JAX comparisons use other batches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import TrainConfig as JTrainConfig
from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu.ops.losses import sequence_loss as j_sequence_loss
from dexiraft_tpu.train.state import TrainState as JTrainState
from dexiraft_tpu.train.state import make_optimizer_from as j_optimizer
from dexiraft_tpu.train.step import make_train_step as j_make_train_step
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.train.state import create_state
from dexiraft_tpu_torch.train.step import make_train_step
from test_torch_raft import _randomize

ATOL, RTOL = 1e-4, 1e-3
H, W, B, ITERS = 64, 64, 2, 3


@pytest.fixture(autouse=True)
def pinned_torch_threads():
    """torch's CPU thread pool pinned at 4 threads for each comparison,
    restored after. At these seeded random weights some gradients of the
    encoders' norm layers are ill-conditioned in fp32, and the port's own
    result moves with the thread count (the order of its sums): with
    accum_steps=2 the context encoder's gradients are 3.7e-6 from JAX's
    (relative L2) at 4 or 8 threads and 1.5e-3 at 2; with edge_sum_fusion
    the feature encoder's 1.2e-4 at 2 to 8 threads and 6.8e-3 at 1. The
    pin makes the comparison the same on every machine; 4, not 8, because
    the suite runs 6 workers at once on 8 cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def make_batch(seed, h=H, w=W, b=B, edges=False):
    """Images with a known 2 px shift, a random GT flow and a valid mask
    with some invalid pixels (they count in the mean, zeroed)."""
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    im2 = np.clip(np.roll(im1, 2, axis=2) + rng.normal(0, 4, im1.shape),
                  0, 255).astype(np.float32)
    batch = dict(image1=im1, image2=im2,
                 flow=rng.normal(0, 2, (b, h, w, 2)).astype(np.float32),
                 valid=(rng.uniform(size=(b, h, w)) > 0.1).astype(np.float32))
    if edges:
        batch["edges1"] = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
        batch["edges2"] = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    return batch


def jax_variables(jcfg, seed, h=48, w=64):
    img = jnp.zeros((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JRAFT(
        dataclasses.replace(jcfg, corr_impl="local", fused_update=False)).init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False))
    return _randomize(shapes, seed)


def run_jax(jcfg, jtc, variables, batch):
    """(loss, grads, variables after the step) of one JAX train step; the
    gradients from jax.grad of the step's own loss on the same inputs."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    model = JRAFT(jcfg)

    def loss_fn(p, micro):
        def fwd(s, im1, im2, **kw):
            return model.apply({"params": p, "batch_stats": s}, im1, im2,
                               iters=jtc.iters, train=True,
                               freeze_bn=jtc.freeze_bn,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(0)}, **kw)

        s = stats
        total = 0.0
        for mb in micro:
            if jtc.edge_sum_fusion:
                a, mut = fwd(s, mb["image1"], mb["image2"])
                e, mut = fwd(mut["batch_stats"] if mut else s,
                             mb["edges1"], mb["edges2"])
                out = a + e
            else:
                out, mut = fwd(s, mb["image1"], mb["image2"])
            s = mut.get("batch_stats", s) if mut else s
            total = total + j_sequence_loss(out, mb["flow"], mb["valid"],
                                            jtc.gamma)[0]
        return total / len(micro)

    n = jtc.accum_steps
    m = jb["image1"].shape[0] // n
    micro = [{k: v[i * m:(i + 1) * m] for k, v in jb.items()}
             for i in range(n)]
    grads = jax.jit(jax.grad(loss_fn))(params, micro)
    # the jitted step donates its state: hand it copies
    copy = lambda tree: jax.tree.map(jnp.copy, tree)  # noqa: E731
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=copy(params),
                        batch_stats=copy(stats),
                        opt_state=j_optimizer(jtc).init(params),
                        rng=jax.random.PRNGKey(0))
    new, metrics = j_make_train_step(jcfg, jtc)(state, jb)
    return (float(metrics["loss"]), grads,
            {"params": new.params, "batch_stats": new.batch_stats}, metrics)


def run_port(cfg, tc, variables, batch):
    model = RAFT(cfg)
    model.load_state_dict(raft_state_dict_from_jax(variables, cfg=cfg),
                          strict=True)
    state = create_state(cfg, tc, device="cpu", model=model)
    state, metrics = make_train_step(cfg, tc)(state, batch)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in state.model.named_parameters()}
    return state, metrics, grads


def check_against_jax(cfg, tc, jcfg, jtc, variables, batch, jres,
                      grad_atol_of_max=None, rel_l2_roots=()):
    """Hold one port step against the JAX step's results ``jres``; the
    gradients of the modules in ``rel_l2_roots`` are held by their
    relative L2 distance (<= 2e-2 per module), every other one element by
    element."""
    j_loss, j_grads, j_after, j_metrics = jres
    state, metrics, grads = run_port(cfg, tc, variables, batch)
    np.testing.assert_allclose(float(metrics["loss"]), j_loss, rtol=RTOL,
                               atol=ATOL)
    for k in ("epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(metrics["lr"]) == pytest.approx(float(j_metrics["lr"]),
                                                 rel=1e-6)
    assert bool(metrics["state_finite"]) and bool(j_metrics["state_finite"])
    jg = raft_state_dict_from_jax(
        {"params": j_grads, "batch_stats": variables.get("batch_stats", {})},
        cfg=cfg)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-3
    for root in rel_l2_roots:
        names = [n for n in grads if n.startswith(root + ".")]
        ours = torch.cat([grads[n].reshape(-1) for n in names])
        ref = torch.cat([jg[n].reshape(-1) for n in names])
        assert float((ours - ref).norm() / ref.norm()) <= 2e-2, root
    for name, g in grads.items():
        if name.split(".")[0] in rel_l2_roots:
            continue
        ref = jg[name].numpy()
        atol = ATOL if grad_atol_of_max is None else max(
            ATOL, grad_atol_of_max * float(np.abs(ref).max()))
        np.testing.assert_allclose(g.numpy(), ref, rtol=RTOL, atol=atol,
                                   err_msg=f"grad {name}")
    after = raft_state_dict_from_jax(j_after, cfg=cfg)
    before = raft_state_dict_from_jax(variables, cfg=cfg)
    moved = 0
    for name, t in state.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(t.numpy(), after[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"after {name}")
        moved += int(not torch.equal(after[name], before[name]))
    assert moved > 0
    return state, after, before


@pytest.fixture(scope="module")
def v1_full():
    jcfg = j_raft_v1()
    variables = jax_variables(jcfg, 11)
    return jcfg, variables


@pytest.mark.parametrize("accum, freeze", [(1, False), (2, False), (1, True)])
def test_v1_full_allpairs_step_matches_jax(v1_full, accum, freeze):
    jcfg, variables = v1_full
    jtc = JTrainConfig(iters=ITERS, batch_size=B, num_steps=100,
                       accum_steps=accum, freeze_bn=freeze)
    tc = TrainConfig(iters=ITERS, batch_size=B, num_steps=100,
                     accum_steps=accum, freeze_bn=freeze)
    batch = make_batch(3)
    jres = run_jax(jcfg, jtc, variables, batch)
    state, after, before = check_against_jax(
        raft_v1(), tc, jcfg, jtc, variables, batch, jres,
        grad_atol_of_max=1e-3 if freeze else None)
    key = "cnet.norm1.running_var"
    moved = not torch.equal(state.model.state_dict()[key], before[key])
    assert moved != freeze  # the context encoder's BN stats
    if freeze:
        for name, t in state.model.state_dict().items():
            if "running" in name:
                torch.testing.assert_close(t, before[name], rtol=0, atol=0)


def test_encoder_gradients_agree_with_float64():
    """The batch on which the JAX encoder's gradients drift: the port's
    fp32 gradients of the small encoder agree with its float64 ones to
    rtol 1e-3 / 1e-5 of the largest gradient (a conv bias before an
    instance norm has a gradient of ~0)."""
    from dexiraft_tpu_torch.models.extractor import SmallEncoder

    torch.manual_seed(0)
    enc = SmallEncoder(128, "instance", 0.0)
    x = torch.from_numpy(2 * make_batch(5)["image1"] / 255.0 - 1.0
                         ).permute(0, 3, 1, 2)
    r = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, 128, 8, 8)).astype(np.float32))
    grads = {}
    for dt in (torch.float32, torch.float64):
        m = SmallEncoder(128, "instance", 0.0)
        m.load_state_dict(enc.state_dict())
        m = m.to(dt)
        (m(x.to(dt)) * r.to(dt)).sum().backward()
        grads[dt] = {n: p.grad.double() for n, p in m.named_parameters()}
    scale = max(float(g.abs().max()) for g in grads[torch.float64].values())
    for n, g64 in grads[torch.float64].items():
        torch.testing.assert_close(grads[torch.float32][n], g64, rtol=1e-3,
                                   atol=1e-5 * scale, msg=n)
