"""Data-parallel training of the port (``dexiraft_tpu_torch.parallel``)
against its one-process step and against JAX's data-parallel step.

One 2-rank gloo run on the CPU (tests/torch_parallel_child.py, two
processes) trains v1 full, whose context encoder carries BatchNorm, at
global batch 4, 64x64, 2 iterations, for 2 steps from the seeded random
weights of tests/test_torch_train_step.py, in three scenarios:
``accum_steps`` 1, 2, and 2 with noise and dropout. The second half of
each batch has ~60% of its pixels invalid, so the ranks' valid-pixel
counts differ (the EPE must be reduced as sums and counts).

  * Against the port's one-process step at batch 4, same weights, same
    batches: loss and metrics at rtol 1e-5, parameters and BatchNorm
    running stats at rtol 1e-4 / atol 3e-5. The two runs differ only in
    the order of their sums (measured: loss 2e-7 relative; the largest
    parameter difference is an Adam step on a ~0 gradient whose rounding
    flipped, a few 1e-6). Both ranks end bitwise equal.
  * Against JAX's ``make_train_step(cfg, tc, mesh=2-device data mesh)``
    (the conftest's virtual CPU devices), accum_steps 1 and 2 without
    noise or dropout (their draws are torch's, not JAX's): loss and
    metrics at rtol 1e-4 and the parameters and running stats at rtol
    3e-3 / atol 3e-5, the bounds tests/test_train.py holds JAX's own
    data-parallel step to against its one-device step; and the update
    (parameters after minus before) at 3e-2 relative L2 (measured 6e-3
    and 8e-3).
  * The CLI: ``python -m dexiraft_tpu_torch train --device cpu`` on 2
    ranks (gloo) and a synthetic chairs tree, v1 small at 64x96, global
    batch 2; rank 1 alone takes a real SIGTERM after step 2 (``--chaos
    sigterm@2``): both ranks stop at step 2 with exit 0 and one emergency
    checkpoint; a 2-rank ``--resume`` then logs the losses of an
    uninterrupted one-process run, and rank 0's chairs validation EPE at
    step 4, within 1e-5 relative (chip_smoke's TOL_RESUME_REL). The
    resumed ranks carry ``--coord_timeout_s 4`` while rank 0's validation
    is held over 9 s: rank 1 waits it out, with no consensus deadline on
    that window.

The child processes (the 2-rank step, the CLI runs) start with the first
test and run while this process compiles the JAX steps; the tests are
ordered so that each waits only for what it reads.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.data.loader import Loader
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.ops.losses import (flow_metric_sums, flow_metrics,
                                           metrics_from_sums)
from dexiraft_tpu_torch.parallel import (World, initialize, local_rows,
                                         make_train_mesh)
from dexiraft_tpu_torch.resilience.chaos import SyntheticFlowDataset
from dexiraft_tpu_torch.train.step import make_train_step
from test_torch_train_cli import BASE, write_chairs_tree
from test_torch_train_step import jax_variables, make_batch
import torch_parallel_child as child

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SCENARIOS = {
    "accum1": dict(accum=1, add_noise=False, dropout=0.0),
    "accum2": dict(accum=2, add_noise=False, dropout=0.0),
    "accum2_noise_dropout": dict(accum=2, add_noise=True, dropout=0.1),
}
LR, NUM_STEPS = 1e-4, 200
TOL_RESUME_REL = 1e-5
#: the resumed run's consensus deadline, and how long rank 0's validation
#: is held past its own pass
COORD_TIMEOUT_S, SLOW_VALIDATION_S = 4.0, 9.0
#: ``python -c SLOW_VALIDATION SECONDS ARGS...``: the train CLI on ARGS,
#: each validation set's pass held SECONDS longer
SLOW_VALIDATION = """
import sys, time
from dexiraft_tpu_torch import train_cli

make, delay = train_cli._make_validators, float(sys.argv[1])


def slow(model_fn, dev):
    run = make(model_fn, dev)

    def run_slowly(name):
        t0 = time.monotonic()
        out = run(name)
        time.sleep(delay)
        print(f"[test] validation {name} took {time.monotonic() - t0:.1f} s",
              flush=True)
        return out

    return run_slowly


train_cli._make_validators = slow
train_cli.main(sys.argv[2:])
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, **extra) -> dict:
    """torchrun's variables for ``rank`` of a one-host ``world``."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                PYTHONPATH=REPO, **extra)


def batches():
    out = []
    for seed in (3, 4):
        b = make_batch(seed, b=4)
        drop = np.random.default_rng(seed).uniform(size=b["valid"][2:].shape)
        b["valid"][2:] *= drop > 0.6
        out.append(b)
    return out


def _train(root, world, name, extra, per_rank=None, slow_validation_s=0):
    """``world`` ranks (or one process) of the train CLI on the CPU
    (``slow_validation_s``: each validation pass held that much longer)."""
    port = free_port()
    cli = ([sys.executable, "-c", SLOW_VALIDATION, str(slow_validation_s)]
           if slow_validation_s else
           [sys.executable, "-m", "dexiraft_tpu_torch", "train"])
    procs = []
    for r in range(world):
        env = (rank_env(r, world, port) if world > 1
               else dict(os.environ, PYTHONPATH=REPO))
        env.update(DEXIRAFT_DATA_DIR=str(root), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            cli + BASE
            + ["--name", name, "--num_steps", "4", "--val_freq", "4",
               "--validation", "chairs"]
            + extra + (per_rank or {}).get(r, []),
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


class _Children:
    """The child processes, started at construction: the 2-rank step
    (torch_parallel_child.py), and beside it the CLI's uninterrupted
    one-process run and the 2-rank run preempted on rank 1. The 2-rank
    --resume starts once the preempted run has ended."""

    def __init__(self, spec, d):
        torch.save(spec, d / "spec.pt")
        port = free_port()
        self.d = d
        self.ranks = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_child.py"),
             str(d / "spec.pt"), str(d)], env=rank_env(r, 2, port),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        self.root = d / "chairs"
        write_chairs_tree(str(self.root), n=8, n_val=2)
        self.cli = (_train(self.root, 1, "full", [])
                    + _train(self.root, 2, "dp", ["--coord_every", "2"],
                             {1: ["--chaos", "sigterm@2"]}))
        self.resumed = None
        self._done = {}

    def _wait(self, key, procs):
        if key not in self._done:
            outs = [p.communicate(timeout=300)[0] for p in procs]
            self._done[key] = ([p.returncode for p in procs], outs)
        return self._done[key]

    def step_results(self):
        rcs, outs = self._wait("ranks", self.ranks)
        assert rcs == [0, 0], outs
        return [torch.load(self.d / f"rank{r}.pt", weights_only=False)
                for r in range(2)]

    def preempted(self):
        """(exit codes, outputs) of the one-process run and the 2 ranks."""
        return self._wait("cli", self.cli)

    def start_resume(self):
        if self.resumed is None:
            self.preempted()
            self.resumed = _train(
                self.root, 2, "dp",
                ["--resume", "--coord_timeout_s", str(COORD_TIMEOUT_S)],
                slow_validation_s=SLOW_VALIDATION_S)

    def resume(self):
        self.start_resume()
        return self._wait("resume", self.resumed)

    def kill(self):
        for p in self.ranks + self.cli + (self.resumed or []):
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX variables, spec, the running children)."""
    jvars = jax_variables(j_raft_v1(), 11)
    spec = dict(state_dict=raft_state_dict_from_jax(jvars, cfg=raft_v1()),
                iters=2, batches=batches(),
                scenarios=[dict(sc, lr=LR, num_steps=NUM_STEPS)
                           for sc in SCENARIOS.values()])
    children = _Children(spec, tmp_path_factory.mktemp("dp"))
    yield jvars, spec, children
    children.kill()


@pytest.fixture(scope="module")
def one_process(runs):
    """The port's one-process steps on the same weights and batches."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        return child.run(runs[1], None)
    finally:
        torch.set_num_threads(n)


def _close(ours, ref, rtol, atol, what, counters=True):
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(ours[k], v) or not counters, k
            continue
        torch.testing.assert_close(ours[k], v, rtol=rtol, atol=atol,
                                   msg=f"{what} {k}")


def check_against_jax(runs, accum):
    """The 2-rank run's scenario ``accum{accum}`` against JAX's step on a
    2-device data mesh (module docstring)."""
    import jax
    import jax.numpy as jnp

    from dexiraft_tpu.config import TrainConfig as JTrainConfig
    from dexiraft_tpu.parallel.layout import (make_mesh, shard_batch,
                                              shard_state)
    from dexiraft_tpu.train.state import TrainState as JTrainState
    from dexiraft_tpu.train.state import make_optimizer_from
    from dexiraft_tpu.train.step import make_train_step as j_make_train_step

    jvars, spec, children = runs
    mesh = make_mesh(jax.devices()[:2])
    jtc = JTrainConfig(iters=2, batch_size=4, num_steps=NUM_STEPS, lr=LR,
                       accum_steps=accum)
    copy = lambda tree: jax.tree.map(jnp.copy, tree)  # noqa: E731
    state = shard_state(JTrainState(
        step=jnp.zeros((), jnp.int32), params=copy(jvars["params"]),
        batch_stats=copy(jvars["batch_stats"]),
        opt_state=make_optimizer_from(jtc).init(jvars["params"]),
        rng=jax.random.PRNGKey(0)), mesh)
    step = j_make_train_step(j_raft_v1(), jtc, mesh=mesh)
    jax_metrics = []
    for b in spec["batches"]:
        state, m = step(state, shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}, mesh))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    ours = children.step_results()[0][list(SCENARIOS).index(
        f"accum{accum}")]
    for m, got in zip(jax_metrics, ours["metrics"]):
        assert got["loss"] == pytest.approx(m["loss"], rel=1e-4)
        for k in ("epe", "1px", "3px", "5px"):
            assert got[k] == pytest.approx(m[k], rel=1e-4, abs=1e-6), k
    after = raft_state_dict_from_jax(
        {"params": state.params, "batch_stats": state.batch_stats},
        cfg=raft_v1())
    # JAX keeps no num_batches_tracked (the bridge fills zeros)
    _close(ours["state_dict"], after, 3e-3, 3e-5, f"jax accum {accum}",
           counters=False)
    keys = [k for k in after if "running" not in k
            and not k.endswith("num_batches_tracked")]
    before = spec["state_dict"]
    du = torch.cat([(ours["state_dict"][k] - before[k]).reshape(-1)
                    for k in keys])
    dj = torch.cat([(after[k] - before[k]).reshape(-1) for k in keys])
    assert float((du - dj).norm() / dj.norm()) <= 3e-2


def _logged(root, name, key):
    with open(os.path.join(root, "runs", name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r[key] for r in rows if key in r}


def test_two_ranks_equal_jax_data_parallel_step_accum1(runs):
    check_against_jax(runs, 1)


def test_sigterm_to_one_rank_stops_both_at_one_checkpoint(runs):
    children = runs[2]
    rcs, (full, rank0, rank1) = children.preempted()
    children.start_resume()
    assert rcs == [0, 0, 0], (full, rank0, rank1)
    assert "[dist] backend=gloo world=2 rank=1 device=cpu" in rank1
    # the signal reached rank 1 only; the verdict stopped both at step 2
    assert "received SIGTERM" in rank1 and "received SIGTERM" not in rank0
    for out in (rank0, rank1):
        assert "Preempted at step 2" in out
        assert "[preempt] emergency checkpoint" in out
    assert sorted(os.listdir(os.path.join(
        children.root, "checkpoints", "dp"))) == ["2"]
    assert "Done: 4 steps" in full


def test_two_ranks_equal_jax_data_parallel_step_accum2(runs):
    check_against_jax(runs, 2)


def test_resume_on_two_ranks_equals_the_uninterrupted_run(runs):
    children = runs[2]
    assert children.preempted()[0] == [0, 0, 0]
    rcs, outs = children.resume()
    assert rcs == [0, 0], outs
    for out in outs:
        assert "Resumed full state at step 2" in out
    root = children.root
    full, dp = _logged(root, "full", "loss"), _logged(root, "dp", "loss")
    assert sorted(dp) == sorted(full) == [1, 2, 3, 4]
    for step, loss in full.items():
        assert abs(dp[step] - loss) <= TOL_RESUME_REL * abs(loss), step
    # rank 0 validated at step 4 on the model the one process validated
    epe, epe_dp = _logged(root, "full", "chairs"), _logged(root, "dp",
                                                           "chairs")
    assert sorted(epe) == sorted(epe_dp) == [4]
    assert abs(epe_dp[4] - epe[4]) <= TOL_RESUME_REL * abs(epe[4])


def test_rank0_validation_outlasts_the_consensus_deadline(runs):
    """In the resumed run rank 0's validation at step 4 lasts over twice
    --coord_timeout_s; rank 1 waits it out at the validation barrier and
    both ranks finish."""
    rcs, (rank0, rank1) = runs[2].resume()
    assert rcs == [0, 0], (rank0, rank1)
    took = re.findall(r"\[test\] validation chairs took ([\d.]+) s", rank0)
    assert len(took) == 1 and float(took[0]) > 2 * COORD_TIMEOUT_S, rank0
    assert "[test] validation" not in rank1
    for out in (rank0, rank1):
        assert "Done: 4 steps" in out and "CoordinatorTimeout" not in out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_two_ranks_equal_one_process(runs, one_process, name):
    _, spec, children = runs
    ranks, one = children.step_results(), one_process
    i = list(SCENARIOS).index(name)
    r0, r1 = ranks[0][i], ranks[1][i]
    # the replicas stay equal to the bit
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k
    assert r0["metrics"] == r1["metrics"]
    for got, ref in zip(r0["metrics"], one[i]["metrics"]):
        for k in ("loss", "epe", "1px", "3px", "5px", "lr"):
            assert got[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-7), k
        assert got["state_finite"] == ref["state_finite"] == 1.0
    _close(r0["state_dict"], one[i]["state_dict"], 1e-4, 3e-5, name)
    moved = [k for k, v in one[i]["state_dict"].items()
             if "running_var" in k and not torch.equal(
                 v, spec["state_dict"][k])]
    assert moved  # the context encoder's BatchNorm trained


def test_uneven_valid_counts_reduce_as_sums():
    """Ranks whose valid-pixel counts differ: the summed numerators over
    the summed count give the whole batch's masked means (what the step
    reports), and the mean of the ranks' own means does not."""
    b = batches()[0]
    pred = torch.from_numpy(make_batch(9, b=4)["flow"]).permute(0, 3, 1, 2)
    gt = torch.from_numpy(b["flow"]).permute(0, 3, 1, 2)
    valid = torch.from_numpy(b["valid"])
    assert valid[:2].sum() > 1.5 * valid[2:].sum()
    whole = flow_metrics(pred, gt, valid)
    halves = [flow_metric_sums(pred[s], gt[s], valid[s])
              for s in (slice(0, 2), slice(2, 4))]
    summed = metrics_from_sums(halves[0] + halves[1])
    for k, v in whole.items():
        torch.testing.assert_close(summed[k], v, rtol=1e-6, atol=0)
    naive = (flow_metrics(pred[:2], gt[:2], valid[:2])["epe"]
             + flow_metrics(pred[2:], gt[2:], valid[2:])["epe"]) / 2
    assert abs(float(naive - whole["epe"])) > 1e-3


@pytest.mark.parametrize("world, accum", [(2, 1), (2, 2), (4, 2)])
def test_loader_reads_each_ranks_rows_of_every_microbatch(world, accum):
    """Loader(process_index=r, process_count=world, microbatches=accum)
    yields rows ``local_rows`` of the one-process loader's global batch,
    for every rank, over two epochs."""
    ds = SyntheticFlowDataset(n=16, size=(8, 8))
    ref = Loader(ds, 8, num_workers=1, seed=3).batches()
    got = [Loader(ds, 8, num_workers=1, seed=3, process_index=r,
                  process_count=world, microbatches=accum).batches()
           for r in range(world)]
    for _ in range(4):
        full = next(ref)
        for r in range(world):
            mesh = make_train_mesh(8, World(r, world, r, torch.device("cpu"),
                                            "gloo"), accum)
            rows = local_rows(8, accum, mesh)
            np.testing.assert_array_equal(next(got[r])["image1"],
                                          full["image1"][rows.numpy()])


def test_mesh_refusals_and_single_process():
    cpu = torch.device("cpu")
    assert make_train_mesh(4, World(0, 1, 0, cpu)) is None
    mesh = make_train_mesh(4, World(1, 2, 1, cpu, "gloo"), 2)
    assert (mesh.rank, mesh.size) == (1, 2)
    np.testing.assert_array_equal(local_rows(4, 2, mesh), [1, 3])
    with pytest.raises(ValueError, match="global batch 6 must divide over "
                                         "4 hosts"):
        make_train_mesh(6, World(0, 4, 0, cpu, "gloo"))
    with pytest.raises(ValueError, match="microbatch.* of 2 must divide"):
        make_train_mesh(8, World(0, 4, 0, cpu, "gloo"), 4)
    # any other mesh (seq) is refused by the step, naming A12
    with pytest.raises(ValueError, match="A12"):
        make_train_step(raft_v1(), TrainConfig(batch_size=4), mesh="fsdp")


def test_initialize_without_torchrun_is_one_process(monkeypatch):
    """No torchrun variable set: no process group, the asked device; the
    card is never chosen behind the caller's back."""
    from dexiraft_tpu_torch.parallel.distributed import ENV_VARS, rank_device

    for name in ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    w = initialize("cpu")
    assert (w.rank, w.size, w.device.type, w.grouped) == (0, 1, "cpu", False)
    assert rank_device("cpu", 1, 2) == (torch.device("cpu"), False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda:1"):
            rank_device("cuda", 1, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            initialize("cuda")
