"""The bf16 train step (``TrainConfig(precision="bf16")``) argued against
JAX's, and what it leaves behind.

References: the gradients of JAX's train loss with the model in fp32
(``J32``) and in ``mixed_precision`` (``J16``, what ``make_train_step``
with ``precision="bf16"`` differentiates: the forward in bf16, the loss
in fp32), both jitted, on v1 full over ``allpairs`` at 64x64, 3
iterations, on tests/test_torch_train_step.py's chairs-like batch, from
the same seeded variables; ``P16`` is one port step with
``precision="bf16"``. As for the forward (tests/test_torch_mixed_
precision_model.py), with e_J = max(relL2(J16, J32), 2^-9):

  relL2(P16, J32) <= A * e_J  and  relL2(P16, J16) <= B * e_J

for the loss (a relative error), for all gradients at once (one vector,
A = B = 1.5) and for each gradient tensor whose largest JAX value is
above 1e-3 of the largest gradient (A = B = 3: a small tensor's e_J is a
noisier estimate).

Readings over 6 seeds (variables ``_randomize(10..15)``, batches
``make_batch(20..25)``; a CPU run, torch 2.13, jax 0.9.0, 8 threads; the
test runs the first): the loss's e_J was 4.4e-5 to 8.9e-4, under the
floor, and the port's loss sat 2.1e-4 to 2.3e-3 from J32 and 7.1e-5 to
1.9e-3 from J16 (at most 1.19 floors). The gradients' global e_J was
2.5e-2 to 3.3e-2, and relL2(P16, J32) / e_J 1.049 to 1.101,
relL2(P16, J16) / e_J 0.994 to 1.117. Per tensor the worst ratios were
2.51 (from J32) and 1.92 (from J16), both on ``update_block.flow_head.
conv2.bias``, whose e_J (3.1e-3) is just above the floor; every other
seed stayed under 1.37.

Parameters, gradients and Adam moments stay fp32, as in JAX (whose
``make_train_step`` casts the BatchNorm stats back and keeps fp32
masters), and a checkpoint of a bf16 run loads strictly into an fp32
eval model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu.ops.losses import sequence_loss as j_sequence_loss
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.train import checkpoint as ckpt
from dexiraft_tpu_torch.train.state import create_state
from dexiraft_tpu_torch.train.step import make_eval_step, make_train_step
from test_torch_train_ops import few_torch_threads  # noqa: F401
from test_torch_train_step import ITERS, jax_variables, make_batch, run_port

A = B = 1.5
A_LEAF = B_LEAF = 3.0
E_FLOOR = 2.0 ** -9


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    """2 torch threads: the suite runs 6 workers at once (the readings
    were taken at 8; the bounds hold at both)."""
    yield


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_loss_and_grads(jcfg, variables, batch):
    """(loss, port-keyed gradient arrays) of JAX's train loss."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JRAFT(jcfg)
    stats = variables.get("batch_stats", {})

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": stats},
                             jb["image1"], jb["image2"], iters=ITERS,
                             train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return j_sequence_loss(out.astype(jnp.float32), jb["flow"],
                               jb["valid"], 0.8)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    sd = raft_state_dict_from_jax({"params": grads, "batch_stats": stats},
                                  cfg=raft_v1(corr_impl="allpairs"))
    return float(loss), {k: v.numpy() for k, v in sd.items()}


def test_bf16_train_step_meets_the_argued_bound():
    jcfg = j_raft_v1(corr_impl="allpairs")
    variables = jax_variables(jcfg, 10)
    batch = make_batch(20)
    j32 = jax_loss_and_grads(jcfg, variables, batch)
    j16 = jax_loss_and_grads(dataclasses.replace(jcfg, mixed_precision=True),
                             variables, batch)
    cfg = raft_v1(corr_impl="allpairs", mixed_precision=True)
    state, metrics, grads = run_port(
        cfg, TrainConfig(iters=ITERS, precision="bf16"), variables, batch)
    p16 = (float(metrics["loss"]), {k: g.numpy() for k, g in grads.items()})

    e = max(abs(j16[0] - j32[0]) / abs(j32[0]), E_FLOOR)
    assert abs(p16[0] - j32[0]) / abs(j32[0]) <= A * e
    assert abs(p16[0] - j16[0]) / abs(j32[0]) <= B * e

    names = list(p16[1])
    flat = {k: np.concatenate([r[1][n].reshape(-1) for n in names])
            for k, r in (("J32", j32), ("J16", j16), ("P16", p16))}
    e = max(rel_l2(flat["J16"], flat["J32"]), E_FLOOR)
    assert rel_l2(flat["P16"], flat["J32"]) <= A * e
    assert rel_l2(flat["P16"], flat["J16"]) <= B * e
    assert rel_l2(flat["P16"], flat["J32"]) > 0  # the port really rounds
    gmax = float(np.abs(flat["J32"]).max())
    held = 0
    for n in names:
        ref = j32[1][n]
        if np.abs(ref).max() <= 1e-3 * gmax:
            continue
        e = max(rel_l2(j16[1][n], ref), E_FLOOR)
        assert rel_l2(p16[1][n], ref) <= A_LEAF * e, n
        assert rel_l2(p16[1][n], j16[1][n]) <= B_LEAF * e, n
        held += 1
    assert held > 50

    # the step's state stays fp32: parameters, gradients, Adam moments
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert {g.dtype for g in grads.values()} == {torch.float32}
    moments = [v for st in state.optimizer.state.values()
               for v in st.values()
               if isinstance(v, torch.Tensor) and v.numel() > 1]
    assert moments and {m.dtype for m in moments} == {torch.float32}
    assert metrics["loss"].dtype == torch.float32


def test_bf16_checkpoint_loads_into_fp32_eval(tmp_path):
    """A bf16 run's checkpoint holds fp32 parameters and fp32 moments; its
    weights load strictly into an fp32 model, whose eval step runs."""
    cfg = raft_v1(small=True, corr_impl="local")
    tc = TrainConfig(iters=2, precision="bf16", batch_size=2)
    state = create_state(cfg, tc, device="cpu")
    assert state.model.cfg.mixed_precision
    state, _ = make_train_step(cfg, tc)(state, make_batch(3, 32, 48))
    ckpt.save_checkpoint(str(tmp_path / "run"), state)
    payload = ckpt.load_payload(str(tmp_path / "run"))
    floats = [v for v in payload["model"].values() if v.is_floating_point()]
    moments = [v for st in payload["optimizer"]["state"].values()
               for v in st.values()
               if isinstance(v, torch.Tensor) and v.numel() > 1]
    assert {v.dtype for v in floats + moments} == {torch.float32}
    sd = ckpt.read_model_weights(str(tmp_path / "run"))
    fp32 = RAFT(cfg)
    fp32.load_state_dict(sd, strict=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fp32.state_dict()[k], v), k
    im = make_batch(4, 32, 48)
    low, up = make_eval_step(fp32, iters=2, device="cpu")(im["image1"],
                                                          im["image2"])
    assert low.dtype == up.dtype == torch.float32
    assert bool(torch.isfinite(up).all())
