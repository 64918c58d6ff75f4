"""The fence train and eval steps on a mesh with a seq axis: the model's
own forward on row slabs (``models.layers.set_seq_mesh``), held against
the port's one-process steps and JAX's one-device steps.

The ranks (tests/torch_parallel_child.py, gloo on the CPU, 2 torch
threads) run at 48x64 (6 rows of 1/8 resolution: 3 a rank on seq 2, the
fewest the update block's 7x7 support allows), 2 iterations, from JAX's
seeded random variables carried through the weight bridge. Three process
groups, started together by the first test that needs them:

  * the pair, data 1 x seq 2 (batch 2): the train step of v1 small on
    the plain lookup (2 steps); of v1 basic with train-mode BatchNorm,
    dropout 0.1, ``add_noise`` and ``accum_steps=2`` (2 steps); one step
    in bf16 and one under ``remat="per_iter"`` (v1 small on B1's plain
    version); the eval step of v1 small flash fused (B1's plain version),
    small v2 and small v3 with edges: plain, warm-started and, for v1 and
    v2, adaptive with an ``iter_budget``;
  * data 2 x seq 2 (batch 4) and data 1 x fsdp 2 x seq 2 (batch 2): one
    step of the v1 basic scenario each.

Held: per-step losses and metrics, the gathered parameters and BatchNorm
running statistics after the last step at atol 1e-4 / rtol 1e-3 of the
port's one-process step (JAX's fence-halo bounds); the first step's loss
and metrics of v1 small against JAX's one-device ``make_train_step``
(dropout 0, no noise, no BatchNorm); the eval slabs, put back together,
within 1e-4 px of the one-process eval step, ``iters_used`` equal on every
rank and to one process's, and within docs/parity.md's tolerances of JAX's
one-device ``make_eval_step`` (rtol 5e-3 for v1 and v2, 1e-2 for v3, atol
1e-3 px). bf16 is held against the one-process bf16 step at 1.5 times the
one process's own bf16 error (its distance from the fp32 step), as the
mixed-precision tests bound it. In this process: the refusals (v4/v5
naming ROADMAP A12.2c, a height not divisible by 8·seq), the layers'
bits outside a seq context, and B1-B4's plain versions on a row block of
queries with global coords against the same rows of the full-height
call.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import VARIANTS as J_VARIANTS
from dexiraft_tpu.config import TrainConfig as JTrainConfig
from dexiraft_tpu.train.state import TrainState as JTrainState
from dexiraft_tpu.train.state import make_optimizer_from as j_optimizer
from dexiraft_tpu.train.step import make_eval_step as j_make_eval_step
from dexiraft_tpu.train.step import make_train_step as j_make_train_step
from dexiraft_tpu_torch.config import VARIANTS, TrainConfig
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.layers import seq_mesh, set_seq_mesh
from dexiraft_tpu_torch.models.raft import RAFT, create_model
from dexiraft_tpu_torch.ops import corr_kernels as ck
from dexiraft_tpu_torch.parallel.fsdp import shard_state
from dexiraft_tpu_torch.parallel.layout import virtual_mesh
from dexiraft_tpu_torch.train.state import create_state, train_model_config
from dexiraft_tpu_torch.train.step import make_eval_step, make_train_step
from test_torch_parallel import _close, free_port, rank_env
from test_torch_train_ops import few_torch_threads  # noqa: F401
from test_torch_train_step import jax_variables, make_batch
from test_torch_variants import _edges, _jax_variables

HERE = os.path.dirname(os.path.abspath(__file__))
H, W, ITERS = 48, 64, 2
ATOL, RTOL = 1e-4, 1e-3
EVAL_PX = 1e-4
JAX_TOL = {"v1": 5e-3, "v2": 5e-3, "v3": 1e-2}
BF16_A = 1.5
LR, NUM_STEPS = 1e-4, 100

TRAIN = {
    "small_local": dict(variant="v1", cfg=dict(small=True, corr_impl="local"),
                        tc=dict(), seed=11, steps=2),
    "basic_bn": dict(variant="v1", cfg=dict(dropout=0.1),
                     tc=dict(freeze_bn=False, add_noise=True, accum_steps=2),
                     seed=12, steps=2),
    "bf16": dict(variant="v1", cfg=dict(small=True, corr_impl="flash",
                                        fused_update=True),
                 tc=dict(precision="bf16"), seed=11, steps=1),
    "remat": dict(variant="v1", cfg=dict(small=True, corr_impl="flash",
                                         fused_update=True),
                  tc=dict(remat="per_iter"), seed=11, steps=1),
}
EVAL_VARIANTS = {
    "v1": dict(small=True, corr_impl="flash", fused_update=True),
    "v2": dict(small=True, corr_impl="local"),
    "v3": dict(small=True, corr_impl="local"),
}
EVAL_CASES = ["v1_plain", "v1_warm", "v1_adaptive", "v2_plain", "v2_warm",
              "v2_adaptive", "v3_plain", "v3_warm"]
ADAPTIVE_ITERS, ADAPTIVE_BUDGET = 4, 3


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    yield


def _tc(case, batch):
    return TrainConfig(iters=ITERS, batch_size=batch, image_size=(H, W),
                       num_steps=NUM_STEPS, lr=LR, **TRAIN[case]["tc"])


def _cfg(variant, **kw):
    return VARIANTS[variant](**kw)


def _batches(batch, steps, seed0=3):
    return [make_batch(seed0 + i, h=H, w=W, b=batch) for i in range(steps)]


def _weights():
    """JAX variables (seeded) and the port's state dict of each config."""
    out = {}
    for name, case in TRAIN.items():
        jcfg = J_VARIANTS[case["variant"]](small=case["cfg"].get("small",
                                                                 False))
        jv = jax_variables(jcfg, case["seed"])
        out[name] = (jv, raft_state_dict_from_jax(
            jv, cfg=_cfg(case["variant"], **case["cfg"])))
    for variant, kw in EVAL_VARIANTS.items():
        jv = (jax_variables(J_VARIANTS["v1"](small=True), 21)
              if variant == "v1" else _jax_variables(variant, True, 22))
        out[variant] = (jv, raft_state_dict_from_jax(
            jv, cfg=_cfg(variant, **kw)))
    return out


def _eval_inputs(variant, seed=5):
    b = make_batch(seed, h=H, w=W, b=2)
    x = {"image1": b["image1"], "image2": b["image2"]}
    if variant in ("v2", "v3"):
        x["edges1"], x["edges2"] = _edges(H, W, seed + 100)
    return x


def _warm(seed=6):
    return np.random.default_rng(seed).normal(
        0, 1.5, (2, H // 8, W // 8, 2)).astype(np.float32)


def _adaptive_tol(model, x):
    """A gate threshold under which the two items freeze on different
    iterations, one of them before the budget: from each item's delta
    per iteration with the gate off, the threshold farthest (in log) from
    every delta among those that part the items."""
    ev = make_eval_step(model, ADAPTIVE_ITERS, device="cpu", adaptive=True)
    dn = torch.stack([ev(x["image1"], x["image2"], None, k,
                         edges1=x.get("edges1"), edges2=x.get("edges2"))[3]
                      for k in range(1, ADAPTIVE_ITERS + 1)]).log()

    def used(tol):
        below = dn < tol
        first = torch.where(below.any(0), below.int().argmax(0) + 1,
                            ADAPTIVE_ITERS)
        return first.clamp(max=ADAPTIVE_BUDGET).tolist()

    vals = dn.reshape(-1).sort().values
    best = max(((float(a + b) / 2, float(b - a)) for a, b in
                zip(vals[:-1], vals[1:])
                if len(set(used((a + b) / 2))) == 2),
               key=lambda t: t[1])
    return float(np.exp(best[0]))


def _eval_cases(weights):
    cases = []
    for name in EVAL_CASES:
        variant, mode = name.split("_")
        kw = dict(EVAL_VARIANTS[variant])
        x = _eval_inputs(variant)
        if mode == "warm":
            x["flow_init"] = _warm()
        iters = ITERS
        if mode == "adaptive":
            probe = RAFT(_cfg(variant, converge_tol=0.0, **kw))
            probe.load_state_dict(weights[variant][1], strict=True)
            kw["converge_tol"] = _adaptive_tol(probe, x)
            iters = ADAPTIVE_ITERS
        cases.append(dict(kind="eval", name=name, variant=variant, cfg=kw,
                          state_dict=weights[variant][1], iters=iters,
                          adaptive=mode == "adaptive", inputs=x,
                          iter_budget=ADAPTIVE_BUDGET))
    return cases


def _train_case(name, weights, batch, steps=None):
    case = TRAIN[name]
    tc = dataclasses.asdict(_tc(name, batch))
    return dict(kind="train", name=name, variant=case["variant"],
                cfg=case["cfg"], tc=tc, state_dict=weights[name][1],
                batches=_batches(batch, steps or case["steps"]))


def _group_norm_case():
    rng = np.random.default_rng(13)
    # a channel mean far from its spread: the merge must stay two-pass
    x = (rng.normal(size=(2, 8, 12, 5)) + 50.0).astype(np.float32)
    return dict(kind="group_norm", name="group_norm", x=x, groups=4,
                weight=rng.normal(size=8).astype(np.float32),
                bias=rng.normal(size=8).astype(np.float32))


#: group -> (world, fsdp, global batch)
GROUPS = {"pair": (2, 1, 2), "data2": (4, 1, 4), "fsdp2": (4, 2, 2)}


class _Children:
    """The three process groups, started at construction."""

    def __init__(self, specs, d):
        self.d, self.procs, self._done = d, {}, {}
        for group, spec in specs.items():
            world = GROUPS[group][0]
            out = d / group
            out.mkdir()
            torch.save(spec, out / "spec.pt")
            port = free_port()
            self.procs[group] = [subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_parallel_child.py"),
                 str(out / "spec.pt"), str(out)],
                env=rank_env(r, world, port), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self, group):
        if group not in self._done:
            procs = self.procs[group]
            outs = [p.communicate(timeout=400)[0] for p in procs]
            assert [p.returncode for p in procs] == [0] * len(procs), outs
            self._done[group] = [torch.load(self.d / group / f"rank{r}.pt",
                                            weights_only=False)
                                 for r in range(len(procs))]
        return self._done[group]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(weights, specs, the running children)."""
    weights = _weights()
    pair = ([_train_case(n, weights, 2) for n in TRAIN]
            + _eval_cases(weights) + [_group_norm_case()])
    specs = {
        "pair": dict(fence_seq=dict(fsdp=1, batch=2), cases=pair),
        "data2": dict(fence_seq=dict(fsdp=1, batch=4),
                      cases=[_train_case("basic_bn", weights, 4, 1)]),
        "fsdp2": dict(fence_seq=dict(fsdp=2, batch=2),
                      cases=[_train_case("basic_bn", weights, 2, 1)]),
    }
    children = _Children(specs, tmp_path_factory.mktemp("fence_seq"))
    yield weights, specs, children
    children.kill()


def one_process_train(case: dict, **tc_changes):
    """The port's one-process fence step on the case's weights and
    batches: (per-step metrics, state dict after the last step, the
    state dict before)."""
    cfg = _cfg(case["variant"], **case["cfg"])
    tc = TrainConfig(**dict(case["tc"], **tc_changes))
    model = RAFT(train_model_config(cfg, tc))
    model.load_state_dict(case["state_dict"], strict=True)
    state = create_state(cfg, tc, device="cpu", model=model)
    step = make_train_step(cfg, tc)
    metrics = []
    for b in case["batches"]:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state.model.state_dict()


def _case(specs, group, name):
    return next(c for c in specs[group]["cases"] if c["name"] == name)


def _hold_train(recs, ref_metrics, ref_sd, name):
    for rec in recs:
        got = rec[name]
        assert len(got["metrics"]) == len(ref_metrics)
        for m, r in zip(got["metrics"], ref_metrics):
            for k in ("loss", "epe", "1px", "3px", "5px"):
                np.testing.assert_allclose(m[k], r[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} {k}")
            assert m["lr"] == pytest.approx(r["lr"], rel=1e-6)
            assert m["state_finite"] == 1.0
        _close(got["state_dict"], ref_sd, RTOL, ATOL, name)


@pytest.mark.parametrize("name", ["small_local", "basic_bn"])
def test_pair_train_steps_equal_one_process(runs, name):
    """Two steps on data 1 x seq 2: losses, metrics, parameters and (v1
    basic, train-mode BatchNorm merged over seq) the running statistics;
    dropout and noise are the global batch's on both ranks."""
    _, specs, children = runs
    metrics, sd = one_process_train(_case(specs, "pair", name))
    recs = children.results("pair")
    _hold_train(recs, metrics, sd, name)
    if name == "basic_bn":  # the running stats moved, as one process's
        key = "cnet.norm1.running_var"
        assert not torch.equal(sd[key],
                               _case(specs, "pair", name)["state_dict"][key])


def _jax_first_step(case, jv):
    jcfg = J_VARIANTS[case["variant"]](**case["cfg"])
    jtc = JTrainConfig(**{k: v for k, v in case["tc"].items()
                          if k in JTrainConfig.__dataclass_fields__})
    params, stats = jv["params"], jv.get("batch_stats", {})
    copy = lambda tree: jax.tree.map(jnp.copy, tree)  # noqa: E731
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=copy(params),
                        batch_stats=copy(stats),
                        opt_state=j_optimizer(jtc).init(params),
                        rng=jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in case["batches"][0].items()}
    return j_make_train_step(jcfg, jtc)(state, b)[1]


def test_pair_first_step_equals_jax_one_device(runs):
    """v1 small on the plain lookup, no dropout, noise or BatchNorm: the
    first step's loss and metrics against JAX's one-device step (JAX's
    fp32 gradients drift on some inputs, so parameters are held against
    the port's one process only)."""
    weights, specs, children = runs
    case = _case(specs, "pair", "small_local")
    j = _jax_first_step(case, weights["small_local"][0])
    for rec in children.results("pair"):
        m = rec["small_local"]["metrics"][0]
        for k in ("loss", "epe", "1px", "3px", "5px"):
            np.testing.assert_allclose(m[k], float(j[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("group", ["data2", "fsdp2"])
def test_wider_meshes_equal_one_process(runs, group):
    """One v1 basic step (train-mode BatchNorm over (data, seq), dropout,
    noise, two microbatches) on data 2 x seq 2 and data 1 x fsdp 2 x seq
    2."""
    _, specs, children = runs
    recs = children.results(group)
    assert sorted(r["mesh"] for r in recs) == (
        [[0, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 1]] if group == "data2"
        else [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1]])
    metrics, sd = one_process_train(_case(specs, group, "basic_bn"))
    _hold_train(recs, metrics, sd, "basic_bn")


def _delta(after, before):
    return torch.cat([(after[k] - before[k]).reshape(-1).double()
                      for k in before if before[k].is_floating_point()])


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_pair_bf16_step_within_the_one_process_bf16_error(runs):
    """bf16 rounds differently on a slab (other conv shapes, the norms'
    merged moments): held at 1.5 times the one process's own bf16 error,
    its distance from the fp32 step, in the loss and in the parameters'
    update."""
    _, specs, children = runs
    case = _case(specs, "pair", "bf16")
    m16, sd16 = one_process_train(case)
    m32, sd32 = one_process_train(case, precision="fp32")
    before = case["state_dict"]
    err_loss = abs(m16[0]["loss"] - m32[0]["loss"])
    err_update = _rel(_delta(sd16, before), _delta(sd32, before))
    assert err_loss > 0 and err_update > 0
    for rec in children.results("pair"):
        got = rec["bf16"]
        assert got["metrics"][0]["state_finite"] == 1.0
        assert abs(got["metrics"][0]["loss"] - m16[0]["loss"]) <= \
            BF16_A * err_loss
        assert _rel(_delta(got["state_dict"], before),
                    _delta(sd16, before)) <= BF16_A * err_update


def test_pair_remat_step_equals_one_process(runs):
    """``remat="per_iter"``: every iteration, its halo exchanges and its
    B1 call recomputed in the backward, against the one-process remat
    step."""
    _, specs, children = runs
    metrics, sd = one_process_train(_case(specs, "pair", "remat"))
    _hold_train(children.results("pair"), metrics, sd, "remat")


def _joined(recs, name):
    """The pair's eval outputs with the rows put back together (seq
    order), and each rank's trailing (B,) outputs."""
    recs = sorted(recs, key=lambda r: r["mesh"][2])
    outs = [r[name] for r in recs]
    low = torch.cat([o[0] for o in outs], dim=1)
    up = torch.cat([o[1] for o in outs], dim=1)
    return low, up, [o[2:] for o in outs]


def _one_process_eval(case):
    model = RAFT(_cfg(case["variant"], **case["cfg"]))
    model.load_state_dict(case["state_dict"], strict=True)
    ev = make_eval_step(model, case["iters"], device="cpu",
                        adaptive=case["adaptive"])
    x = case["inputs"]
    budget = (case["iter_budget"],) if case["adaptive"] else ()
    return ev(x["image1"], x["image2"], x.get("flow_init"), *budget,
              edges1=x.get("edges1"), edges2=x.get("edges2"))


@pytest.mark.parametrize("name", EVAL_CASES)
def test_pair_eval_equals_one_process(runs, name):
    _, specs, children = runs
    case = _case(specs, "pair", name)
    low, up, rest = _joined(children.results("pair"), name)
    ref = _one_process_eval(case)
    assert low.shape == ref[0].shape and up.shape == ref[1].shape
    assert float((low - ref[0]).abs().max()) <= EVAL_PX
    assert float((up - ref[1]).abs().max()) <= EVAL_PX
    assert float(ref[0].abs().max()) > 1e-2  # not a trivial flow
    if case["adaptive"]:
        used = [r[0] for r in rest]
        assert all(torch.equal(u, ref[2]) for u in used), (used, ref[2])
        # the gate froze the items on different iterations
        assert len(set(ref[2].tolist())) == 2, ref[2]
        for r in rest:
            torch.testing.assert_close(r[1], ref[3], rtol=1e-4, atol=1e-6)


def _jax_eval(case, jv):
    jcfg = J_VARIANTS[case["variant"]](
        small=True, corr_impl="local",
        converge_tol=case["cfg"].get("converge_tol", 0.02))
    step = j_make_eval_step(jcfg, case["iters"], adaptive=case["adaptive"])
    x = {k: jnp.asarray(v) for k, v in case["inputs"].items()}
    kw = dict(edges1=x.get("edges1"), edges2=x.get("edges2"),
              flow_init=x.get("flow_init"))
    if case["adaptive"]:
        kw["iter_budget"] = jnp.int32(case["iter_budget"])
    return step(jv, x["image1"], x["image2"], **kw)


@pytest.mark.parametrize("name", EVAL_CASES)
def test_pair_eval_equals_jax_one_device(runs, name):
    """The joined slabs against JAX's one-device eval step (its plain
    lookup: the function B1 computes) at docs/parity.md's tolerances."""
    weights, specs, children = runs
    case = _case(specs, "pair", name)
    low, up, rest = _joined(children.results("pair"), name)
    j = _jax_eval(case, weights[case["variant"]][0])
    rtol = JAX_TOL[case["variant"]]
    np.testing.assert_allclose(low.numpy(), np.asarray(j[0]), rtol=rtol,
                               atol=1e-3)
    np.testing.assert_allclose(up.numpy(), np.asarray(j[1]), rtol=rtol,
                               atol=1e-3)
    if case["adaptive"]:
        for r in rest:
            assert r[0].tolist() == np.asarray(j[2]).tolist()


def test_group_norm_on_row_slabs_equals_the_whole_image(runs):
    """The seq-aware GroupNorm (the model builds none; the layer must
    hold all the same): its moments over (C/G, H, W) merged over seq, the
    slabs put back together against ``nn.GroupNorm`` of the whole map."""
    _, specs, children = runs
    case = _case(specs, "pair", "group_norm")
    gn = torch.nn.GroupNorm(case["groups"], case["x"].shape[1])
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(case["weight"]))
        gn.bias.copy_(torch.from_numpy(case["bias"]))
        want = gn(torch.from_numpy(case["x"]))
    recs = sorted(children.results("pair"), key=lambda r: r["mesh"][2])
    got = torch.cat([r["group_norm"] for r in recs], dim=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---- in this process ------------------------------------------------------


def _seq_mesh():
    return virtual_mesh(0, 1, 1, 2)


@pytest.mark.parametrize("variant", ["v4", "v5"])
def test_v4_v5_refused_on_a_seq_mesh(variant):
    cfg = _cfg(variant, small=True)
    tc = TrainConfig(iters=ITERS, batch_size=2, image_size=(H, W))
    msg = ("a fence step on a seq mesh runs v1, v2 and v3 only: v4/v5's "
           "embedded DexiNed is not row-sharded yet (ROADMAP A12.2c, "
           "DexiNed on row slabs)")
    with pytest.raises(ValueError, match=re.escape(msg)):
        make_train_step(cfg, tc, mesh=_seq_mesh())
    with pytest.raises(ValueError, match="ROADMAP A12.2c"):
        make_eval_step(RAFT(cfg), device="cpu", mesh=_seq_mesh())
    with pytest.raises(ValueError, match=re.escape(msg) + r" \(dexined\."):
        set_seq_mesh(RAFT(cfg), _seq_mesh())


def test_height_not_divisible_by_8_seq_is_refused():
    cfg = _cfg("v1", small=True)
    msg = ("image height 40 must be divisible by 8*n_seq=16 so every "
           "device owns whole 1/8-resolution rows")
    tc = TrainConfig(iters=ITERS, batch_size=2, image_size=(40, W))
    state = shard_state(create_state(cfg, tc, device="cpu"), _seq_mesh())
    with pytest.raises(ValueError, match=re.escape(msg)):
        make_train_step(cfg, tc, mesh=_seq_mesh())(
            state, make_batch(1, h=40, w=W, b=2))
    ev = make_eval_step(create_model(cfg, device="cpu"), ITERS,
                        device="cpu", mesh=_seq_mesh())
    b = make_batch(1, h=40, w=W, b=2)
    with pytest.raises(ValueError, match=re.escape(msg)):
        ev(b["image1"], b["image2"])


@pytest.mark.parametrize("variant", ["v1", "v5"])
def test_layers_outside_a_seq_context_are_untouched(variant):
    """A forward after a seq context (v1) or a refused one (v5) gives the
    bits of a model that never had a seq axis; every layer is left with
    none."""
    cfg = _cfg(variant, small=True, corr_impl="flash", fused_update=True)
    fresh = create_model(cfg, seed=3, device="cpu")
    used = create_model(cfg, seed=3, device="cpu")
    if variant == "v1":
        with seq_mesh(used, _seq_mesh()):
            assert used.fnet.conv1.seq is not None
    else:
        with pytest.raises(ValueError, match="A12.2c"):
            set_seq_mesh(used, _seq_mesh())
    assert all(getattr(m, "seq", None) is None for m in used.modules())
    b = make_batch(2, h=H, w=W, b=1)
    want = make_eval_step(fresh, ITERS, device="cpu")(b["image1"],
                                                      b["image2"])
    got = make_eval_step(used, ITERS, device="cpu")(b["image1"],
                                                    b["image2"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", ["flash_fused_step", "pallas_fused_step",
                                  "flash_local_corr_level",
                                  "pallas_local_corr_level"])
def test_kernels_on_a_row_block_equal_full_height_rows(name):
    """B1-B4's wrappers (their plain versions on the CPU) with the query
    rows [h/2, h) of level 0, their global coords and the full-height
    levels: the same rows as the full-height call, as the fence step on
    row slabs calls them."""
    from dexiraft_tpu_torch.ops.corr import avg_pool_2x2
    from dexiraft_tpu_torch.ops.grid import coords_grid

    rng = np.random.default_rng(9)
    b, h, w, c, r, levels, feat = 2, 12, 10, 32, 3, 3, 24
    f1 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    coords = coords_grid(b, h, w) + torch.from_numpy(
        rng.uniform(-3, 3, (b, h, w, 2)).astype(np.float32))
    pyr = [f2]
    for _ in range(levels - 1):
        pyr.append(avg_pool_2x2(pyr[-1]))
    fn = getattr(ck, name)
    if "fused" in name:
        kk = (2 * r + 1) ** 2
        wt = torch.from_numpy(rng.normal(
            size=(levels * kk, feat)).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=(feat,)).astype(np.float32))

        def call(q, co):
            return fn(q, pyr, co, wt, bias, r)
    else:
        def call(q, co):
            return fn(q, pyr[1], co / 2.0, r)  # level 1 in its own pixels
    full = call(f1, coords)
    block = call(f1[:, h // 2:].contiguous(), coords[:, h // 2:].contiguous())
    assert block.shape[1] == h - h // 2
    torch.testing.assert_close(block, full[:, h // 2:], rtol=0, atol=1e-5)
