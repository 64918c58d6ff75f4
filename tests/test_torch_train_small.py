"""The port's train step against JAX's ``make_train_step``, small model:
v1 small on ``flash`` + fused (JAX: the Pallas kernel in interpret mode;
the port: B1's plain version on the CPU), and v1 small with
``edge_sum_fusion`` on ``local``; the helpers and the bar (atol 1e-4 /
rtol 1e-3) are tests/test_torch_train_step.py's.
"""

from dexiraft_tpu.config import TrainConfig as JTrainConfig
from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from test_torch_train_step import (B, ITERS, check_against_jax,  # noqa: F401
                                   jax_variables, pinned_torch_threads,
                                   make_batch, run_jax)


def test_v1_small_flash_fused_step_matches_jax(monkeypatch):
    monkeypatch.setenv("DEXIRAFT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DEXIRAFT_FLASH_PIXEL_BLOCK", "128")
    monkeypatch.setenv("DEXIRAFT_FLASH_ROWS", "8")
    jcfg = j_raft_v1(small=True, corr_impl="flash", fused_update=True)
    variables = jax_variables(jcfg, 12)
    jtc = JTrainConfig(iters=ITERS, batch_size=B, num_steps=100)
    tc = TrainConfig(iters=ITERS, batch_size=B, num_steps=100)
    batch = make_batch(4)
    check_against_jax(raft_v1(small=True, corr_impl="flash",
                              fused_update=True), tc, jcfg, jtc, variables,
                      batch, run_jax(jcfg, jtc, variables, batch))


def test_v1_edge_sum_fusion_step_matches_jax():
    jcfg = j_raft_v1(small=True, corr_impl="local")
    variables = jax_variables(jcfg, 13)
    jtc = JTrainConfig(iters=2, batch_size=B, num_steps=100,
                       edge_sum_fusion=True)
    tc = TrainConfig(iters=2, batch_size=B, num_steps=100,
                     edge_sum_fusion=True)
    batch = make_batch(4, edges=True)
    check_against_jax(raft_v1(small=True, corr_impl="local"), tc, jcfg, jtc,
                      variables, batch, run_jax(jcfg, jtc, variables, batch))
