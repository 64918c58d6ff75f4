"""The port's v5 train step against JAX's ``make_train_step``.

Dexi-RAFT v5 (dual stream, embedded DexiNed) at 64x64, 2 iterations, on
``local``: the helpers and the bar (atol 1e-4 / rtol 1e-3 on the loss,
every gradient, the parameters after the step and the BatchNorm running
stats) are tests/test_torch_train_step.py's. On top of them, what v5
adds: the frozen DexiNed gets no gradient, and both sides still decay its
weights by lr * wd * p (optax decays every leaf), while its BatchNorm
stats stay as they were (it runs in eval mode).

The edge encoders' gradients are held by relative L2 (<= 2e-2 per
encoder), not element by element. Their input is the seeded random
DexiNed's seven logit maps, whose per-channel spread falls to 1.4e-3
around much larger means, so the encoders' norms amplify fp32 rounding:
on this batch the port's fp32 ``efnet`` gradients differ from its own
float64 ones by 0.7% of the largest value in ``conv1`` and by 12% in
``layer3.1.conv2``, and JAX's by as much (the JAX package's fp32 is no
closer to float64). Measured against JAX: relative L2 8.2e-3 (efnet) and
3.5e-3 (ecnet); every other gradient ~1e-6, the parameters after the step
and the BatchNorm stats within 3.2e-5.
"""

import numpy as np
import pytest
import torch

from dexiraft_tpu.config import TrainConfig as JTrainConfig
from dexiraft_tpu.config import raft_v5 as j_raft_v5
from dexiraft_tpu_torch.config import TrainConfig, raft_v5
from test_torch_train_step import (check_against_jax,  # noqa: F401
                                   jax_variables, pinned_torch_threads,
                                   make_batch, run_jax)

ITERS = 2


@pytest.fixture(scope="module")
def v5_result():
    jcfg = j_raft_v5(corr_impl="local")
    variables = jax_variables(jcfg, 21)
    # a large weight decay, so the decay of the frozen weights is plain
    # beside fp32 rounding
    jtc = JTrainConfig(iters=ITERS, batch_size=2, num_steps=100, wdecay=10.0)
    tc = TrainConfig(iters=ITERS, batch_size=2, num_steps=100, wdecay=10.0)
    batch = make_batch(6)
    jres = run_jax(jcfg, jtc, variables, batch)
    state, after, before = check_against_jax(
        raft_v5(corr_impl="local"), tc, jcfg, jtc, variables, batch, jres,
        rel_l2_roots=("efnet", "ecnet"))
    return state, after, before, jres[3]


def test_v5_step_matches_jax(v5_result):
    state, after, before, _ = v5_result
    key = "ecnet.norm1.running_mean"
    assert not torch.equal(state.model.state_dict()[key], before[key])


def test_v5_frozen_dexined_decayed_and_stats_kept(v5_result):
    state, after, before, j_metrics = v5_result
    lr, wd = float(j_metrics["lr"]), 10.0
    sd = state.model.state_dict()
    dexined = [k for k in sd if k.startswith("dexined.")]
    assert dexined
    for name, p in state.model.named_parameters():
        if name.startswith("dexined."):
            assert p.grad is None, name
    for k in dexined:
        if "running" in k or k.endswith("num_batches_tracked"):
            torch.testing.assert_close(sd[k].float(), before[k].float(),
                                       rtol=0, atol=0, msg=k)
        else:
            expect = before[k] * (1.0 - lr * wd)
            np.testing.assert_allclose(sd[k].numpy(), expect.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(after[k].numpy(), expect.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
