"""Rematerialisation: ``remat`` with the policies "full" (the trainer's
``per_iter``) and "dots_saveable", and ``remat_lookup``.

  * The port's loss and gradients under each equal its own step without
    remat, bit for bit on the CPU: the recompute runs the same kernels on
    the same inputs (v1 small on the plain lookup, v1 on the fused flash
    path through B1's plain version, v1 small on allpairs for
    remat_lookup).
  * The same steps against JAX's remat steps (``nn.remat(RAFTStep)``,
    ``jax.checkpoint`` of the lookup), at the train-step tests' tolerance
    (atol 1e-4, rtol 1e-3; tests/test_torch_train_step.py).
  * The policies differ in what they recompute: counting ATen's
    ``convolution`` calls made during the backward shows "full" re-running
    every update-block conv of every iteration and "dots_saveable" none,
    while both recompute the lookup, and B1: with the kernel wrappers made
    to count as on the card, a step of N iterations launches B1 N times
    without remat and 2N times under either policy.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu.ops.losses import sequence_loss as j_sequence_loss
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.ops import corr_kernels as ck
from dexiraft_tpu_torch.train.state import create_state, train_model_config
from dexiraft_tpu_torch.train.step import make_train_step
from test_torch_train_step import jax_variables, make_batch
from test_torch_train_ops import few_torch_threads  # noqa: F401

ATOL, RTOL = 1e-4, 1e-3
ITERS = 3
H, W = 32, 48
# (case id, port config kwargs, TrainConfig.remat, corr_impl, fused)
CASES = [
    ("per_iter-local", {"small": True}, "per_iter", "local", False),
    ("dots_saveable-local", {"small": True}, "dots_saveable", "local", False),
    ("per_iter-flash_fused", {}, "per_iter", "flash", True),
    ("dots_saveable-flash_fused", {}, "dots_saveable", "flash", True),
    ("remat_lookup-allpairs", {"small": True, "remat_lookup": True}, "none",
     "allpairs", False),
]


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    """2 torch threads: the suite runs 6 workers at once."""
    yield


@pytest.fixture(scope="module")
def variables():
    return {small: jax_variables(j_raft_v1(small=small), 40 + small)
            for small in (False, True)}


def port_step(variables, kw, remat, impl, fused, batch):
    """(loss, {name: grad}) of one port step from the JAX variables."""
    base = raft_v1(corr_impl=impl, fused_update=fused, **kw)
    tc = TrainConfig(iters=ITERS, remat=remat, batch_size=2)
    cfg = train_model_config(base, tc)
    model = RAFT(cfg)
    model.load_state_dict(raft_state_dict_from_jax(
        variables[cfg.small], cfg=cfg), strict=True)
    state = create_state(base, tc, device="cpu", model=model)
    state, metrics = make_train_step(base, tc)(state, batch)
    return float(metrics["loss"]), {
        n: p.grad.clone() for n, p in state.model.named_parameters()}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_remat_equals_no_remat_bitwise(variables, case):
    _, kw, remat, impl, fused = case
    batch = make_batch(7, H, W)
    loss, grads = port_step(variables, kw, remat, impl, fused, batch)
    plain_kw = {k: v for k, v in kw.items() if k != "remat_lookup"}
    ref_loss, ref = port_step(variables, plain_kw, "none", impl, fused, batch)
    assert loss == ref_loss
    for n, g in grads.items():
        assert torch.equal(g, ref[n]), n


def jax_remat_grads(jcfg, variables, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JRAFT(jcfg)
    stats = variables.get("batch_stats", {})

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": stats},
                             jb["image1"], jb["image2"], iters=ITERS,
                             train=True, mutable=["batch_stats"])
        return j_sequence_loss(out, jb["flow"], jb["valid"], 0.8)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return float(loss), grads


@pytest.mark.parametrize("policy", ["full", "dots_saveable", "lookup"])
def test_remat_matches_jax_remat(variables, policy):
    """v1 small on the plain lookup (JAX "local") against JAX's remat of
    the scanned step, or of the lookup alone."""
    batch = make_batch(8, H, W)
    kw = (dict(remat_lookup=True) if policy == "lookup"
          else dict(remat=True, remat_policy=policy))
    jcfg = j_raft_v1(small=True, corr_impl="local", **kw)
    j_loss, j_grads = jax_remat_grads(jcfg, variables[True], batch)
    remat = {"full": "per_iter", "dots_saveable": "dots_saveable",
             "lookup": "none"}[policy]
    loss, grads = port_step(
        variables, {"small": True, "remat_lookup": policy == "lookup"},
        remat, "local", False, batch)
    np.testing.assert_allclose(loss, j_loss, rtol=RTOL, atol=ATOL)
    ref = raft_state_dict_from_jax(
        {"params": j_grads,
         "batch_stats": variables[True].get("batch_stats", {})},
        cfg=raft_v1(small=True))
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-3
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=n)


class ConvCounter(TorchDispatchMode):
    """Counts ATen convolution calls while active."""

    def __init__(self):
        super().__init__()
        self.convs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.convs += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def counting_kernels(monkeypatch):
    """The kernel wrappers' card behaviour on CPU tensors: each 'launch'
    computes the plain version and moves LAUNCHES, as _launch does."""

    def fake_launch(name, fmap1, levels, coords, coord_scales, radius,
                    weight=None, bias=None):
        assert name == "flash_fused_step"
        out = ck.fused_reference(fmap1, levels, coords, weight, bias, radius)
        ck.LAUNCHES[name] += 1
        return out

    monkeypatch.setattr(ck, "_use_kernel", lambda *t: True)
    monkeypatch.setattr(ck, "_launch", fake_launch)
    ck.reset_launches()
    yield ck.LAUNCHES
    ck.reset_launches()


@pytest.mark.parametrize("policy, convs_per_iter, b1_per_iter", [
    (None, 0, 1), ("full", 14, 2), ("dots_saveable", 0, 2)])
def test_policies_recompute_what_they_say(counting_kernels, policy,
                                          convs_per_iter, b1_per_iter):
    """v1 on the fused flash path: convs in the backward and B1 launches of
    one forward + backward. The update block has 15 convs; on the fused
    path convc1 runs inside B1, so "full" re-runs 14 an iteration."""
    kw = {} if policy is None else dict(remat=True, remat_policy=policy)
    torch.manual_seed(0)
    model = RAFT(raft_v1(corr_impl="flash", fused_update=True, **kw)).train()
    x1 = torch.rand(1, 3, H, W) * 255
    x2 = torch.rand(1, 3, H, W) * 255
    preds = model(x1, x2, iters=ITERS, test_mode=False)
    assert counting_kernels["flash_fused_step"] == ITERS
    counter = ConvCounter()
    with counter:
        preds.square().mean().backward()
    assert counter.convs == convs_per_iter * ITERS
    assert counting_kernels["flash_fused_step"] == b1_per_iter * ITERS


def test_no_checkpoint_without_autograd(counting_kernels):
    """Eval and serve run under inference_mode: remat changes nothing
    there (one B1 launch an iteration, the same flow)."""
    x = torch.rand(1, 3, H, W) * 255
    outs = []
    for kw in ({}, dict(remat=True), dict(remat=True,
                                          remat_policy="dots_saveable")):
        torch.manual_seed(0)
        model = RAFT(raft_v1(corr_impl="flash", fused_update=True,
                             **kw)).eval()
        ck.reset_launches()
        with torch.inference_mode():
            outs.append(model(x, x, iters=ITERS)[1])
        assert counting_kernels["flash_fused_step"] == ITERS
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
