"""fsdp storage sharding of the port (``dexiraft_tpu_torch.parallel.fsdp``)
against its one-process step and against JAX's fsdp step.

The runs (tests/torch_parallel_child.py, gloo on the CPU) train v1 full at
64x64, global batch 4, 2 iterations, from the seeded random weights of
tests/test_torch_train_step.py carried through the weight bridge. v1 full,
not v1 small: its context encoder carries BatchNorm, whose statistics
must reduce over the data subgroup only (the ranks of one fsdp group read
the same rows). The second half of each batch has ~60% of its pixels
invalid, as in tests/test_torch_parallel.py.

  * 2 ranks, fsdp 2 (data 1): fp32 for 4 steps with a per-shard
    checkpoint after steps 2 and 4 and a resume from step 2; bf16
    (``precision="bf16"``) and remat (``remat="per_iter"``) for 2 steps.
    With one data index every rank computes the one-process step, so
    each scenario equals the port's one-process step to the bit (same
    thread count). The resumed steps equal the uninterrupted ones to the
    bit; ``read_model_weights`` of a sharded step equals the gathered
    state dict.
  * 4 ranks, data 2 x fsdp 2: accum_steps 1, and 2 with noise and
    dropout, for 2 steps, against the one-process step at
    tests/test_torch_parallel.py's bounds (loss rtol 1e-5, states rtol
    1e-4 / atol 3e-5): the gradient all-reduce and BatchNorm's merge of
    the two data indices' statistics sum in another order than one
    process does.
  * Both layouts against JAX's ``make_train_step(cfg, tc,
    mesh=make_train_mesh(4, fsdp=2))`` (the conftest's virtual CPU
    devices, data 4 x fsdp 2): losses at rtol 1e-4, parameters and
    running stats at rtol 3e-3 / atol 3e-5, the bounds
    tests/test_torch_parallel.py holds the data-parallel step to.
  * Storage: each rank's parameters plus Adam moments between steps are
    under 0.75 of the whole (JAX's ``test_state_stored_sharded`` bound)
    and the model's sharded parameters hold no storage.
  * The leaf policy (which leaves shard, along which logical dim) equals
    JAX's ``LAYOUT.param_leaf_spec`` leaf for leaf on v1 and v5 at 2 and
    4 ways; the mesh shapes equal JAX's ``make_train_mesh`` wherever JAX
    uses every device, and the port refuses where it would not.
  * The CLI: ``train --device cpu --fsdp 2 --records_dir`` on 2 ranks,
    preempted (rank 1's SIGTERM) after 2 steps, then ``--resume`` to step
    4 (JAX's ``TestFsdpCLI``): the logged losses equal the one-process
    step's on the pack's batches, and rank 0's validation at step 4 (on
    the gathered model) equals the one-process model's.

The children start with the first test and run while this process
compiles JAX's step.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.config import raft_v5 as j_raft_v5
from dexiraft_tpu_torch.config import TrainConfig, raft_v1, raft_v5
from dexiraft_tpu_torch.interop.jax_weights import (flax_source,
                                                    raft_state_dict_from_jax)
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.parallel import World, make_train_mesh
from dexiraft_tpu_torch.parallel.fsdp import _param_leaves, shard_state
from dexiraft_tpu_torch.parallel.layout import (FsdpMesh, fsdp_mesh_shape,
                                                param_shard_dim)
from dexiraft_tpu_torch.resilience.verify import restore_verified
from dexiraft_tpu_torch.train import checkpoint as ckpt
from dexiraft_tpu_torch.train.state import create_state
from test_torch_parallel import _close, free_port, rank_env
from test_torch_train_cli import BASE, write_chairs_tree
from test_torch_train_ops import few_torch_threads  # noqa: F401
from test_torch_train_step import jax_variables, make_batch
import torch_parallel_child as child

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LR, NUM_STEPS = 1e-4, 200
TOL_RESUME_REL = 1e-5
BASE_SC = dict(accum=1, add_noise=False, dropout=0.0, lr=LR,
               num_steps=NUM_STEPS)
#: (world, scenario name) -> scenario; fsdp 2 throughout
LAYOUTS = {
    2: {"fp32": dict(BASE_SC, save_at=2),
        "bf16": dict(BASE_SC, precision="bf16", steps=2),
        "remat": dict(BASE_SC, remat="per_iter", steps=2)},
    4: {"accum1": dict(BASE_SC, steps=2),
        "accum2_noise_dropout": dict(BASE_SC, accum=2, add_noise=True,
                                     dropout=0.1, steps=2)},
}
CLI = BASE + ["--name", "f", "--fsdp", "2", "--val_freq", "2",
              "--validation", "chairs"]
#: the resumes of a step-2 checkpoint onto another layout: name ->
#: (world, fsdp, the checkpoint: "one" the one process's, "w2/ckpt-0"
#: the 2-rank fsdp run's)
RESHARD = {"one_to_fsdp2": (2, 2, "one"),
           "fsdp2_to_fsdp4": (4, 4, "w2/ckpt-0"),
           "fsdp2_to_data2": (2, None, "w2/ckpt-0")}


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    yield


def batches():
    out = []
    for seed in (3, 4, 5, 6):
        b = make_batch(seed, b=4)
        drop = np.random.default_rng(seed).uniform(size=b["valid"][2:].shape)
        b["valid"][2:] *= drop > 0.6
        out.append(b)
    return out


def _pack(root):
    """The chairs tree's training pairs packed in this process (2 shards)."""
    from dexiraft_tpu_torch.data import records
    from dexiraft_tpu_torch.data.datasets import FlyingChairs

    ds = FlyingChairs(dict(crop_size=(64, 96), min_scale=-0.2,
                           max_scale=0.5, do_flip=True), split="training",
                      root=os.path.join(root, "FlyingChairs_release", "data"))
    out = os.path.join(root, "pack")
    records.pack_dataset(ds, out, num_shards=2, stage="chairs",
                         image_size=(64, 96))
    return out


class _Children:
    """The 2-rank and 4-rank step runs and the CLI's first 2-rank run,
    started at construction; the CLI's --resume once that run ended; the
    resharded resumes (RESHARD) once the 2-rank runs ended."""

    def __init__(self, spec, d):
        self.spec, self.d, self.procs, self._done = spec, d, {}, {}
        for world, scenarios in LAYOUTS.items():
            self._start(world, world, dict(
                spec, fsdp=2, scenarios=list(scenarios.values())))
        self.root = str(d / "chairs")
        write_chairs_tree(self.root, n=8, n_val=2)
        self.pack = _pack(self.root)
        # rank 1 alone takes a SIGTERM after step 2: both ranks stop there
        # with one emergency checkpoint, saved per shard
        self.procs["cli"] = self._cli(["--coord_every", "2"],
                                      {1: ["--chaos", "sigterm@2"]})

    def _start(self, key, world, spec):
        out = self.d / (f"w{key}" if isinstance(key, int) else key)
        out.mkdir()
        torch.save(spec, out / "spec.pt")
        port = free_port()
        self.procs[key] = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_child.py"),
             str(out / "spec.pt"), str(out)],
            env=rank_env(r, world, port), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def _reshard(self):
        """The one-process step-2 checkpoint (the 2-rank run's step 2,
        restored whole and saved replicated), then every RESHARD run."""
        cfg, tc = child.configs(self.spec, LAYOUTS[2]["fp32"])
        state, _, _ = restore_verified(
            str(self.d / "w2" / "ckpt-0"),
            child.fresh_state(self.spec, cfg, tc, None), step=2,
            delete_bad=False)
        ckpt.save_checkpoint(str(self.d / "one"), state)
        for name, (world, fsdp, source) in RESHARD.items():
            self._start(name, world, dict(
                self.spec, fsdp=fsdp, scenarios=[LAYOUTS[2]["fp32"]],
                resume={"dir": str(self.d / source), "step": 2}))

    def _cli(self, extra, per_rank=None):
        port, procs = free_port(), []
        for r in range(2):
            env = rank_env(r, 2, port, DEXIRAFT_DATA_DIR=self.root,
                           OMP_NUM_THREADS="2")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dexiraft_tpu_torch", "train"] + CLI
                + ["--records_dir", self.pack, "--num_steps", "4"] + extra
                + (per_rank or {}).get(r, []), env=env,
                cwd=self.root, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        return procs

    def wait(self, key):
        if key in RESHARD and key not in self.procs:
            self.results(2)
        if key == "resume" and "resume" not in self.procs:
            assert self.wait("cli")[0] == [0, 0]
            self.procs["resume"] = self._cli(["--resume"])
        if key not in self._done:
            procs = self.procs[key]
            outs = [p.communicate(timeout=400)[0] for p in procs]
            self._done[key] = ([p.returncode for p in procs], outs)
        return self._done[key]

    def results(self, key):
        rcs, outs = self.wait(key)
        assert rcs == [0] * len(rcs), outs
        if key == 2 and RESHARD.keys() - self.procs.keys():
            self._reshard()
        out = self.d / (f"w{key}" if isinstance(key, int) else key)
        return [torch.load(out / f"rank{r}.pt", weights_only=False)
                for r in range(len(rcs))]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX variables, spec, the running children)."""
    jvars = jax_variables(j_raft_v1(), 11)
    spec = dict(state_dict=raft_state_dict_from_jax(jvars, cfg=raft_v1()),
                iters=2, batches=batches())
    children = _Children(spec, tmp_path_factory.mktemp("fsdp"))
    yield jvars, spec, children
    children.kill()


@pytest.fixture(scope="module")
def one_process(runs):
    """The port's one-process steps on the same weights and batches, per
    scenario name, at the children's 2 threads."""
    spec = runs[1]
    scenarios = {name: {k: v for k, v in sc.items() if k != "save_at"}
                 for layout in LAYOUTS.values() for name, sc in layout.items()}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = child.run(dict(spec, scenarios=list(scenarios.values())), None)
    finally:
        torch.set_num_threads(n)
    return dict(zip(scenarios, out))


@pytest.fixture(scope="module")
def jax_run(runs):
    """JAX's fsdp step on data 4 x fsdp 2: per-step losses and metrics,
    and the state dicts (through the bridge) after steps 2 and 4."""
    import jax
    import jax.numpy as jnp

    from dexiraft_tpu.config import TrainConfig as JTrainConfig
    from dexiraft_tpu.parallel.layout import (LAYOUT, make_train_mesh as
                                              j_make_train_mesh, shard_batch,
                                              shard_state as j_shard_state)
    from dexiraft_tpu.train.state import TrainState as JTrainState
    from dexiraft_tpu.train.state import make_optimizer_from
    from dexiraft_tpu.train.step import make_train_step as j_make_train_step

    jvars, spec, _ = runs
    mesh = j_make_train_mesh(4, fsdp=2)
    assert LAYOUT.fsdp_size(mesh) == 2 and LAYOUT.data_size(mesh) == 4
    jtc = JTrainConfig(iters=2, batch_size=4, num_steps=NUM_STEPS, lr=LR)
    copy = lambda tree: jax.tree.map(jnp.copy, tree)  # noqa: E731
    state = j_shard_state(JTrainState(
        step=jnp.zeros((), jnp.int32), params=copy(jvars["params"]),
        batch_stats=copy(jvars["batch_stats"]),
        opt_state=make_optimizer_from(jtc).init(jvars["params"]),
        rng=jax.random.PRNGKey(0)), mesh)
    step = j_make_train_step(j_raft_v1(), jtc, mesh=mesh)
    metrics, states = [], {}
    for n, b in enumerate(spec["batches"], start=1):
        state, m = step(state, shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
        if n in (2, 4):
            states[n] = raft_state_dict_from_jax(
                {"params": state.params, "batch_stats": state.batch_stats},
                cfg=raft_v1())
    return metrics, states


def _sharded_template(n_fsdp, fsdp_index=0):
    """A fresh v1 state in an n_fsdp-way storage layout, as rank
    ``fsdp_index`` holds it (no process group: building the layout
    needs none)."""
    world = World(fsdp_index, n_fsdp, fsdp_index, torch.device("cpu"), "gloo")
    tc = TrainConfig(iters=2, batch_size=4, num_steps=NUM_STEPS, lr=LR)
    return shard_state(create_state(raft_v1(), tc, device="cpu"),
                       FsdpMesh(world, 1, n_fsdp))


def _losses(ms):
    return [m["loss"] for m in ms]


# ---- (a), (b): the leaf policy and the mesh, pure ----------------------


@pytest.mark.parametrize("variant", ["v1", "v5"])
@pytest.mark.parametrize("n_fsdp", [2, 4])
def test_leaf_policy_equals_jax_param_leaf_spec(variant, n_fsdp):
    """For every parameter of the variant, the port's decision (torch dim
    and logical dim) equals JAX's ``param_leaf_spec`` on the flax leaf."""
    from dexiraft_tpu.parallel.layout import LAYOUT, make_mesh_fsdp

    jcfg, cfg = {"v1": (j_raft_v1(), raft_v1()),
                 "v5": (j_raft_v5(), raft_v5())}[variant]
    jvars = jax_variables(jcfg, 0)
    mesh = make_mesh_fsdp(8 // n_fsdp, n_fsdp)
    with torch.device("meta"):
        model = RAFT(cfg)
    sharded = 0
    for p, module, attr, keys in _param_leaves(model):
        coll, path = flax_source(keys[0], cfg.small)
        leaf = jvars[coll]
        for part in path:
            leaf = leaf[part]
        spec = tuple(LAYOUT.param_leaf_spec(mesh, np.shape(leaf)))
        want = (spec.index(LAYOUT.fsdp_axis) if LAYOUT.fsdp_axis in spec
                else None)
        dim, logical = param_shard_dim(module, attr, tuple(p.shape), n_fsdp)
        assert logical == want, (keys, np.shape(leaf), spec)
        if dim is not None:
            assert p.shape[dim] == np.shape(leaf)[logical]
            sharded += 1
    assert sharded > 20


MESH_CASES = [(8, 8, None), (8, 8, 1), (8, 8, 4), (2, 8, "auto"),
              (8, 8, "auto"), (4, 4, 2), (4, 2, 2), (2, 2, 2), (4, 8, 2),
              (2, 4, "auto"), (6, 8, 2), (3, 4, "auto"), (2, 8, 2),
              (10, 8, "auto"), (4, 4, 16)]


@pytest.mark.parametrize("batch, world, fsdp", MESH_CASES)
def test_mesh_shape_equals_jax_where_every_device_works(batch, world, fsdp):
    """fsdp_mesh_shape gives JAX's (data, fsdp) wherever JAX's mesh uses
    every device, and refuses where JAX's would leave devices idle or is
    refused itself (the conftest's host holds 8 devices)."""
    import jax

    from dexiraft_tpu.parallel.layout import LAYOUT
    from dexiraft_tpu.parallel.layout import make_train_mesh as j_mesh

    try:
        jm = j_mesh(batch, devices=jax.devices()[:world], fsdp=fsdp)
        want = (LAYOUT.data_size(jm), LAYOUT.fsdp_size(jm))
    except ValueError:
        want = None
    if want is not None and want[0] * want[1] == world:
        assert fsdp_mesh_shape(batch, world, fsdp, local_size=8) == want
    else:
        with pytest.raises(ValueError, match="idle|need between"):
            fsdp_mesh_shape(batch, world, fsdp, local_size=8)


def test_make_train_mesh_refuses_idle_ranks_and_keeps_the_data_path():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="2 of 8 ranks idle"):
        make_train_mesh(6, World(0, 8, 0, cpu, "gloo", 8), fsdp=2)
    with pytest.raises(ValueError, match="need between 1 and 1"):
        make_train_mesh(4, World(0, 1, 0, cpu), fsdp=2)
    # an fsdp axis of one rank is the data-parallel World
    world = World(1, 2, 1, cpu, "gloo", 2)
    assert make_train_mesh(4, world, fsdp=1) is world
    assert make_train_mesh(4, World(0, 1, 0, cpu), fsdp="auto") is None


# ---- (c): the step, two layouts ----------------------------------------


def test_two_ranks_fsdp2_equal_the_one_process_step_bitwise(runs,
                                                           one_process):
    ranks = runs[2].results(2)
    for i, name in enumerate(LAYOUTS[2]):
        r0, r1, one = ranks[0][i], ranks[1][i], one_process[name]
        assert r0["metrics"] == r1["metrics"] == one["metrics"], name
        for k, v in one["state_dict"].items():
            assert torch.equal(r0["state_dict"][k], v), (name, k)
            assert torch.equal(r1["state_dict"][k], v), (name, k)


@pytest.mark.parametrize("name", list(LAYOUTS[4]))
def test_four_ranks_data2_fsdp2_equal_the_one_process_step(runs, one_process,
                                                          name):
    ranks = runs[2].results(4)
    i = list(LAYOUTS[4]).index(name)
    one = one_process[name]
    for r in ranks[1:]:  # every rank ends with the same gathered state
        assert r[i]["metrics"] == ranks[0][i]["metrics"]
        for k, v in ranks[0][i]["state_dict"].items():
            assert torch.equal(r[i]["state_dict"][k], v), k
    got = ranks[0][i]
    for g, ref in zip(got["metrics"], one["metrics"]):
        for k in ("loss", "epe", "1px", "3px", "5px", "lr"):
            assert g[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-7), k
        assert g["state_finite"] == ref["state_finite"] == 1.0
    _close(got["state_dict"], one["state_dict"], 1e-4, 3e-5, name)
    moved = [k for k, v in one["state_dict"].items()
             if "running_var" in k
             and not torch.equal(v, runs[1]["state_dict"][k])]
    assert moved  # the context encoder's BatchNorm trained


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_step_within_jax_fsdp_step_bounds(runs, jax_run, world):
    metrics, states = jax_run
    got = runs[2].results(world)[0][0]
    steps = len(got["metrics"])
    for g, m in zip(got["metrics"], metrics):
        assert g["loss"] == pytest.approx(m["loss"], rel=1e-4)
        for k in ("epe", "1px", "3px", "5px"):
            assert g[k] == pytest.approx(m[k], rel=1e-4, abs=1e-6), k
    # JAX keeps no num_batches_tracked (the bridge fills zeros)
    _close(got["state_dict"], states[steps], 3e-3, 3e-5,
           f"jax fsdp, {world} ranks", counters=False)
    if "saved" in got:
        _close(got["saved"][2], states[2], 3e-3, 3e-5, "jax fsdp step 2",
               counters=False)


# ---- (d): storage ------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_stores_under_three_quarters_of_the_state(runs, world):
    for rank in runs[2].results(world):
        for rec in rank:
            held = rec["bytes"]
            assert held["held"] < 0.75 * held["full"], held
            assert held["resident_sharded"] == 0, held


# ---- (e), (f), (g), (h): per-shard checkpoints -------------------------


def test_per_shard_resume_is_bitwise(runs):
    rec = runs[2].results(2)[0][0]
    assert rec["restored_step"] == 2
    assert rec["resumed_metrics"] == rec["metrics"][2:]


def test_read_model_weights_assembles_a_sharded_step(runs):
    rec = runs[2].results(2)[0][0]
    directory = runs[2].d / "w2" / "ckpt-0"
    assert sorted(os.listdir(directory / "4")) == [
        "shard-0-of-2.pt", "shard-1-of-2.pt", "state.pt"]
    for step in (2, 4):
        whole = ckpt.read_model_weights(str(directory / str(step)))
        assert list(whole) == list(rec["saved"][step])
        for k, v in rec["saved"][step].items():
            assert torch.equal(whole[k], v), (step, k)
    assert ckpt.read_model_weights(str(directory)).keys() == \
        rec["saved"][4].keys()


def test_truncated_shard_falls_back_a_step(runs, tmp_path):
    runs[2].results(2)
    directory = tmp_path / "ck"
    shutil.copytree(runs[2].d / "w2" / "ckpt-0", directory)
    shard = directory / "4" / "shard-1-of-2.pt"
    shard.write_bytes(shard.read_bytes()[:4096])
    for index in (0, 1):  # each rank checks every shard
        state, step, _ = restore_verified(str(directory),
                                          _sharded_template(2, index),
                                          delete_bad=False)
        assert step == 2 and state.step == 2
    (directory / "2" / "shard-0-of-2.pt").unlink()
    with pytest.raises(Exception, match="no restorable checkpoint"):
        restore_verified(str(directory), _sharded_template(2))


def _storage_equal(got, want, what):
    """Storage-form state dicts (model entries, optimizer state) equal
    to the bit."""
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        if isinstance(v, dict):
            _storage_equal(got[k], v, f"{what}.{k}")
        elif isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), (what, k)
        else:
            assert got[k] == v, (what, k)


def _restricted(whole, n_fsdp, index):
    """The whole state's storage under the n_fsdp-way plan of rank
    ``index``: (model, optimizer state)."""
    model, optim = _sharded_template(n_fsdp, index).shards.restrict(
        whole.model.state_dict(), whole.optimizer.state_dict())
    return model, optim["state"]


def test_resume_onto_another_layout(runs, monkeypatch, tmp_path):
    """The 2-way step 2 resumed on one process: the restored weights are
    the step's whole ones, and the losses of steps 3-4 and the state
    after step 4 equal the 2-way resume's to the bit (at the children's
    2 threads); restored into a 4-way template, each slice and moment is
    the whole's restriction. Through the CLI, one process resumes the
    2-way run of the CLI test and trains a step."""
    rec = runs[2].results(2)[0][0]
    spec = runs[1]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = child.resume(dict(spec, scenarios=[LAYOUTS[2]["fp32"]],
                                resume={"dir": str(runs[2].d / "w2" /
                                                   "ckpt-0"), "step": 2}),
                           None)
    finally:
        torch.set_num_threads(n)
    assert one["restored_step"] == 2
    _storage_equal(one["storage"]["model"], rec["saved"][2], "weights")
    assert one["metrics"] == rec["resumed_metrics"]
    _storage_equal(one["state_dict"], rec["state_dict"], "step 4")
    directory = str(runs[2].d / "w2" / "ckpt-0")
    tc = TrainConfig(iters=2, batch_size=4, num_steps=NUM_STEPS, lr=LR)
    whole, _, _ = restore_verified(directory, create_state(raft_v1(), tc,
                                                           device="cpu"),
                                   step=2, delete_bad=False)
    for index in range(4):
        state, step, _ = restore_verified(directory,
                                          _sharded_template(4, index),
                                          step=2, delete_bad=False)
        model, optim = state.state_dicts()
        want_model, want_optim = _restricted(whole, 4, index)
        _storage_equal(model, want_model, f"4-way rank {index}")
        _storage_equal(optim["state"], want_optim, f"4-way rank {index}")
    # and through the CLI: one process resuming the 2-way run
    from dexiraft_tpu_torch import train_cli

    assert runs[2].wait("resume")[0] == [0, 0]
    shutil.copytree(os.path.join(runs[2].root, "checkpoints", "f"),
                    tmp_path / "checkpoints" / "f")
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", runs[2].root)
    monkeypatch.chdir(tmp_path)
    i = CLI.index("--fsdp")
    train_cli.main(CLI[:i] + CLI[i + 2:] + [
        "--records_dir", runs[2].pack, "--num_steps", "5", "--resume"])
    assert ckpt.all_steps("checkpoints/f") == [2, 4, 5]
    payload = ckpt.load_payload("checkpoints/f", 5)
    assert payload["step"] == 5 and "fsdp" not in payload
    assert _logged(str(tmp_path), "loss").keys() == {5}


@pytest.mark.parametrize("name", list(RESHARD))
def test_resume_resharded_over_ranks(runs, name):
    """A step-2 checkpoint resumed on ranks of another layout: each
    rank's restored slices and moments are the whole step's restriction
    (the whole weights for a replicated rank), and the steps after it
    equal the resume onto the saved layout: to the bit with one data
    index, at the data-parallel bounds over data 2 x fsdp 1."""
    world, fsdp, _ = RESHARD[name]
    ranks = runs[2].results(name)
    rec = runs[2].results(2)[0][0]
    tc = TrainConfig(iters=2, batch_size=4, num_steps=NUM_STEPS, lr=LR)
    whole, _, _ = restore_verified(str(runs[2].d / "one"),
                                   create_state(raft_v1(), tc, device="cpu"),
                                   delete_bad=False)
    _storage_equal(whole.model.state_dict(), rec["saved"][2], "one")
    for r, got in enumerate(ranks):
        assert got["restored_step"] == 2
        assert got["storage"]["count"] == 2
        if fsdp is None:
            want_model = whole.model.state_dict()
            want_optim = whole.optimizer.state_dict()["state"]
        else:
            want_model, want_optim = _restricted(whole, fsdp, r)
        _storage_equal(got["storage"]["model"], want_model, (name, r))
        _storage_equal(got["storage"]["optimizer"], want_optim, (name, r))
        _storage_equal(got["state_dict"], ranks[0]["state_dict"], (name, r))
        assert got["metrics"] == ranks[0]["metrics"]
    got = ranks[0]
    if fsdp is not None:  # one data index: the one-process step
        assert got["metrics"] == rec["resumed_metrics"]
        _storage_equal(got["state_dict"], rec["state_dict"], name)
        return
    for g, ref in zip(got["metrics"], rec["resumed_metrics"]):
        for k in ("loss", "epe", "1px", "3px", "5px", "lr"):
            assert g[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-7), k
    _close(got["state_dict"], rec["state_dict"], 1e-4, 3e-5, name)


def test_resume_onto_other_dims_at_the_same_size(tmp_path, monkeypatch):
    """A 2-way step whose plan sharded its leaves on other dims (the
    smallest dividing one) restores into the policy's 2-way plan as the
    whole's restriction; the saved and restored layouts differ."""
    from dexiraft_tpu_torch.parallel import fsdp as fsdp_mod
    from dexiraft_tpu_torch.parallel import layout as layout_mod

    tc = TrainConfig(iters=2, batch_size=4, num_steps=NUM_STEPS, lr=LR)
    whole = create_state(raft_v1(small=True), tc, device="cpu")
    g = torch.Generator().manual_seed(0)
    for p in whole.model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    whole.optimizer.step()
    whole.step = 1

    def smallest(module, name, shape, n):
        dim, logical = layout_mod.param_shard_dim(module, name, shape, n)
        if dim is None:
            return dim, logical
        dims = [d for d, s in enumerate(shape) if s % n == 0]
        return min(dims, key=lambda d: (shape[d], d)), None

    def plan(index, n=2):
        world = World(index, n, index, torch.device("cpu"), "gloo")
        model = create_state(raft_v1(small=True), tc, device="cpu")
        model.model.load_state_dict(whole.model.state_dict())
        model.optimizer.load_state_dict(whole.optimizer.state_dict())
        model.step = whole.step
        return shard_state(model, FsdpMesh(world, 1, n))

    with monkeypatch.context() as m:
        m.setattr(fsdp_mod, "param_shard_dim", smallest)
        saving = [plan(1), plan(0)]
        for state in saving:  # rank 1's shard, then rank 0's commit
            ckpt.save_sharded(str(tmp_path), state)
    for index in range(2):
        template = plan(index)
        assert template.shards.layout() != saving[0].shards.layout()
        state, step, _ = restore_verified(str(tmp_path), template,
                                          delete_bad=False)
        model, optim = state.state_dicts()
        want_model, want_optim = template.shards.restrict(
            whole.model.state_dict(), whole.optimizer.state_dict())
        _storage_equal(model, want_model, index)
        _storage_equal(optim["state"], want_optim["state"], index)
        assert step == 1 and optim["param_groups"][0]["count"] == 1


# ---- (i): the CLI ------------------------------------------------------


def _logged(root, key):
    with open(os.path.join(root, "runs", "f", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r[key] for r in rows if key in r}


def test_cli_fsdp_with_records_trains_resumes_and_equals_one_process(
        runs, monkeypatch):
    """--fsdp 2 on 2 ranks over a records pack: preempted after 2 steps,
    then --resume to 4; the losses equal the one-process step's on the
    pack's batches, and rank 0's step-4 validation the one-process
    model's."""
    from dexiraft_tpu_torch import train_cli
    from dexiraft_tpu_torch.data.records import RecordLoader
    from dexiraft_tpu_torch.eval.validate import VALIDATORS
    from dexiraft_tpu_torch.train.step import make_eval_step, make_train_step

    children = runs[2]
    rcs, outs = children.wait("cli")
    assert rcs == [0, 0], outs
    for out in outs:
        assert "Preempted at step 2" in out
    rcs, outs = children.wait("resume")
    assert rcs == [0, 0], outs
    for out in outs:
        assert "[mesh] world=2 data=1 fsdp=2" in out
        assert "Resumed full state at step 2" in out
        assert "sharded parameters' resident bytes 0" in out
    assert ckpt.all_steps(os.path.join(children.root, "checkpoints",
                                       "f")) == [2, 4]
    cfg, tc = train_cli.resolve_configs(train_cli.build_parser().parse_args(
        CLI + ["--num_steps", "4"]))
    state = create_state(cfg, tc, device="cpu")
    step = make_train_step(cfg, tc)
    loader = RecordLoader(children.pack, tc.batch_size, seed=tc.seed,
                          num_workers=1)
    it = loader.batches()
    try:
        one = [float(step(state, next(it))[1]["loss"]) for _ in range(4)]
    finally:
        it.close()
    logged = _logged(children.root, "loss")
    assert sorted(logged) == [1, 2, 3, 4]
    for s, loss in enumerate(one, start=1):
        assert abs(logged[s] - loss) <= TOL_RESUME_REL * abs(loss), s
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", children.root)
    epe = VALIDATORS["chairs"](make_eval_step(state.model, iters=24,
                                              device="cpu"))["chairs"]
    logged_epe = _logged(children.root, "chairs")
    assert abs(logged_epe[4] - epe) <= TOL_RESUME_REL * abs(epe)
