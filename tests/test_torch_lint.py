"""The port's static half of strict mode: synclint (SL001-SL004) with the
sharding contract of its shardlint (JL010-JL013), the lock-discipline
rules of its threadlint (JL020-JL024) and the collective divergence of
its distlint (JL030-JL034).

One flagged and one clean fixture per synclint, shardlint and distlint
rule (the last two on torch collectives); the port's threadlint and
distlint against the JAX package's jaxlint on the JAX package's own
fixtures (tests/test_zzzthreadlint.py, tests/test_zzzdistlint.py), both
linters loaded by file path; the whole port package clean against its
reviewed baseline, every entry with a reason; LOCK_ORDER holding every
name an OrderedLock of the port uses, its static mirror equal to the
live registry; and shardlint's LAYOUT_AXES equal to the live layout's.
"""

from __future__ import annotations

import ast
import importlib.util
import os.path as osp
import sys
import textwrap

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
THREAD_RULES = {"JL020", "JL021", "JL022", "JL023", "JL024"}
DIST_RULES = {"JL030", "JL031", "JL032", "JL033", "JL034"}


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, osp.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


synclint = _load("dexiraft_tpu_torch/analysis/synclint.py", "_t_synclint")
jaxlint = _load("dexiraft_tpu/analysis/jaxlint.py", "_t_jaxlint")


def rules_of(src: str, path: str = "dexiraft_tpu_torch/train/fixture.py"):
    return {f.rule for f in synclint.lint_source(textwrap.dedent(src), path)}


SYNC_FIXTURES = {
    "SL001": ("""
        from dexiraft_tpu_torch.train.step import make_train_step

        def loop(state, batches, cfg, tc):
            step_fn = make_train_step(cfg, tc)
            for batch in batches:
                state, metrics = step_fn(state, batch)
                if state.step % 10 == 0:
                    print(float(metrics["loss"]))
    """, """
        from dexiraft_tpu_torch.analysis import guards
        from dexiraft_tpu_torch.train.step import make_train_step

        def loop(state, batches, cfg, tc):
            step_fn = make_train_step(cfg, tc)
            for batch in batches:
                state, metrics = step_fn(state, batch)
                if state.step % 10 == 0:
                    print(float(guards.fetch(metrics["loss"])))
                n = int(metrics["loss"].shape[0])
    """),
    "SL002": ("""
        def drain(model, frames):
            out = []
            for f in frames:
                flow = model(f, f)
                out.append(flow.cpu())
            return out
    """, """
        from dexiraft_tpu_torch.analysis import guards

        def drain(model, frames):
            out = []
            for i, f in enumerate(frames):
                out.append(model(f, f))
                if i % 8 == 7:
                    guards.fetch(out[-1])
            return out
    """),
    "SL003": ("""
        import time

        def timed(step, x):
            t0 = time.perf_counter()
            y = step(x, x)
            return y, time.perf_counter() - t0
    """, """
        import time

        import torch

        def timed(step, x):
            t0 = time.perf_counter()
            y = step(x, x)
            torch.cuda.synchronize()
            return y, time.perf_counter() - t0
    """),
    "SL004": ("""
        import triton
        from dexiraft_tpu_torch.ops.cuda_build import load_library

        LIB = load_library("flash_corr", ("flash_corr.cu",))
    """, """
        from dexiraft_tpu_torch.ops.cuda_build import load_library

        def launch():
            import triton

            return load_library("flash_corr", ("flash_corr.cu",)), triton
    """),
}


@pytest.mark.parametrize("rule", sorted(SYNC_FIXTURES))
def test_sync_rule_flags_its_fixture_and_passes_the_clean_one(rule):
    flagged, clean = SYNC_FIXTURES[rule]
    assert rule in rules_of(flagged)
    assert not rules_of(clean) & set(synclint.RULES)


def test_suppression_and_loop_scope():
    src = SYNC_FIXTURES["SL002"][0].replace(
        "out.append(flow.cpu())",
        "out.append(flow.cpu())  # synclint: disable=SL002")
    assert "SL002" not in rules_of(src)
    # SL002 holds only the train/eval/serve loops and the CLIs to a cadence
    assert "SL002" not in rules_of(SYNC_FIXTURES["SL002"][0],
                                   "dexiraft_tpu_torch/ops/fixture.py")


def _jax_fixtures(name: str = "test_zzzthreadlint.py"):
    """Every source string of a JAX lint test file's TestRuleFixtures
    that parses as a module holding a class or a function."""
    with open(osp.join(REPO, "tests", name)) as f:
        tree = ast.parse(f.read())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "TestRuleFixtures")
    out = []
    for node in ast.walk(cls):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            src = textwrap.dedent(node.value)
            try:
                body = ast.parse(src).body
            except SyntaxError:
                continue
            if any(isinstance(b, (ast.ClassDef, ast.FunctionDef))
                   for b in body):
                out.append(src)
    return out


def test_threadlint_matches_jax_on_its_fixtures():
    fixtures = _jax_fixtures()
    assert len(fixtures) >= 20
    flagged = set()
    for src in fixtures:
        want = [(f.rule, f.line, f.col) for f in jaxlint.lint_source(
            src, "dexiraft_tpu/serve/fixture.py", THREAD_RULES)]
        # the port spells the same suppression with its linter's name
        got = [(f.rule, f.line, f.col) for f in synclint.lint_source(
            src.replace("jaxlint: disable", "synclint: disable"),
            "dexiraft_tpu_torch/serve/fixture.py", THREAD_RULES)]
        assert got == want, src
        flagged.update(r for r, _, _ in want)
    assert flagged == THREAD_RULES


@pytest.mark.parametrize("tier", ["serve", "resilience"])
def test_distlint_matches_jax_on_its_fixtures(tier):
    """The port's distlint flags what JAX's jaxlint flags with JL030-JL034
    at the same (rule, line, col) on every fixture of
    tests/test_zzzdistlint.py's TestRuleFixtures, at a neutral path and
    on the distributed tier (where JL032 applies)."""
    fixtures = _jax_fixtures("test_zzzdistlint.py")
    assert len(fixtures) >= 20
    flagged = set()
    for src in fixtures:
        want = [(f.rule, f.line, f.col) for f in jaxlint.lint_source(
            src, f"dexiraft_tpu/{tier}/fixture.py", DIST_RULES)]
        got = [(f.rule, f.line, f.col) for f in synclint.lint_source(
            src.replace("jaxlint: disable", "synclint: disable"),
            f"dexiraft_tpu_torch/{tier}/fixture.py", DIST_RULES)]
        assert got == want, src
        flagged.update(r for r, _, _ in want)
    assert flagged == (DIST_RULES if tier == "resilience"
                       else DIST_RULES - {"JL032"})


#: rule -> (flagged, clean, path): torch-collective fixtures of the
#: port's shardlint and distlint rules
PORT_FIXTURES = {
    "JL010": ("""
        import torch.distributed as dist

        def groups(world, n):
            return [dist.new_group(list(range(i, i + n)))
                    for i in range(0, world.size, n)]
    """, """
        from dexiraft_tpu_torch.parallel import make_train_mesh

        def mesh_of(world):
            return make_train_mesh(8, world, fsdp=2)
    """, "dexiraft_tpu_torch/train/fixture.py"),
    "JL011": ("""
        from dexiraft_tpu_torch.parallel.layout import FsdpMesh, \
            virtual_mesh

        def meshes(world):
            return (FsdpMesh(world, 1, 2),
                    virtual_mesh(0, 2, 2, mesh_axes=("data", "fsdp")))
    """, """
        from dexiraft_tpu_torch.parallel.layout import DATA_AXIS, \
            virtual_mesh

        def meshes(world):
            print("data", DATA_AXIS)
            return virtual_mesh(0, 2, 2).fsdp
    """, "dexiraft_tpu_torch/analysis/fixture.py"),
    "JL012": ("""
        import torch.distributed as dist

        def save(world, write):
            if world.rank == 0 or dist.get_rank() != 0:
                write()
    """, """
        def save(world, write):
            if world.is_writer:
                write()
    """, "dexiraft_tpu_torch/train/fixture.py"),
    "JL013": ("""
        import torch.distributed as dist

        def make_step(cfg, mesh=None):
            def step(x):
                if mesh is None:
                    dist.all_reduce(x)
                dist.all_reduce(x)
                return x
            return step
    """, """
        import torch.distributed as dist

        def make_step(cfg, mesh=None):
            def step(x):
                if mesh is None:
                    dist.all_reduce(x)
                else:
                    dist.all_reduce(x, group=mesh.data.group)
                return x
            return step
    """, "dexiraft_tpu_torch/train/fixture.py"),
    "JL030": ("""
        import torch.distributed as dist

        def verdict(bad, mesh):
            if mesh.fsdp_index == 0:
                dist.all_reduce(bad, group=mesh.data.group)
            return bad
    """, """
        import torch

        from dexiraft_tpu_torch.parallel.fsdp import all_gather_flat

        def swap(up, down, axis):
            every = all_gather_flat(torch.cat([down, up]), axis.size,
                                    axis.group)
            if axis.rank > 0:
                prev = every[axis.rank - 1, :down.numel()]
            else:
                prev = torch.zeros_like(down)
            return prev
    """, "dexiraft_tpu_torch/parallel/fixture.py"),
    "JL031": ("""
        def restore(coord, load, ok):
            coord.barrier("restore")
            if not ok:
                return None
            return coord.agree_step(load, None)
    """, """
        def restore(coord, load, ok):
            coord.barrier("restore")
            if coord.any_flag(not ok):
                return None
            return coord.agree_step(load, None)
    """, "dexiraft_tpu_torch/resilience/fixture.py"),
    "JL032": ("""
        import torch.distributed as dist

        def finish(t, group):
            work = dist.all_reduce(t, group=group, async_op=True)
            work.wait()
    """, """
        import datetime

        import torch.distributed as dist

        def finish(t, group):
            work = dist.all_reduce(t, group=group, async_op=True)
            work.wait(timeout=datetime.timedelta(seconds=30))
    """, "dexiraft_tpu_torch/parallel/fixture.py"),
    "JL033": ("""
        import torch.distributed as dist

        def verdict(bad, group):
            try:
                dist.all_reduce(bad, group=group)
            except RuntimeError:
                return False
            return bad
    """, """
        import torch.distributed as dist

        def verdict(bad, group):
            try:
                dist.all_reduce(bad, group=group)
            except RuntimeError as e:
                raise RuntimeError("the verdict's all-reduce failed") from e
            return bad
    """, "dexiraft_tpu_torch/resilience/fixture.py"),
    "JL034": ("""
        def restore(wd, coord, load):
            wd.arm(0, "resume-restore", steady=False)
            out = coord.agree_step(load, None)
            wd.disarm()
            return out
    """, """
        def restore(wd, coord, load):
            wd.arm(0, "resume-restore", steady=False)
            try:
                return coord.agree_step(load, None)
            finally:
                wd.disarm()
    """, "dexiraft_tpu_torch/train/fixture.py"),
}


@pytest.mark.parametrize("rule", sorted(PORT_FIXTURES))
def test_port_rule_flags_its_torch_fixture_and_passes_the_clean_one(rule):
    flagged, clean, path = PORT_FIXTURES[rule]
    assert rule in rules_of(flagged, path)
    assert rule not in rules_of(clean, path)


def test_port_rule_scopes():
    """Where the contract places things, the same source is clean: the
    layout and the process-group module build groups and meshes, rank
    literals belong to parallel/ and the coordinator, and JL032 holds
    the distributed tier only."""
    groups = PORT_FIXTURES["JL010"][0]
    assert "JL010" not in rules_of(
        groups, "dexiraft_tpu_torch/parallel/distributed.py")
    assert "JL011" not in rules_of(PORT_FIXTURES["JL011"][0],
                                   "dexiraft_tpu_torch/parallel/layout.py")
    for path in ("dexiraft_tpu_torch/parallel/fixture.py",
                 "dexiraft_tpu_torch/resilience/coord.py"):
        assert "JL012" not in rules_of(PORT_FIXTURES["JL012"][0], path)
    assert "JL032" not in rules_of(PORT_FIXTURES["JL032"][0],
                                   "dexiraft_tpu_torch/serve/fixture.py")
    assert "JL032" in rules_of(PORT_FIXTURES["JL032"][0],
                               "dexiraft_tpu_torch/train/checkpoint.py")


def test_layout_axes_mirror_equals_the_live_layout():
    from dexiraft_tpu_torch.parallel import layout

    shardlint = _load("dexiraft_tpu_torch/analysis/shardlint.py",
                      "_t_shardlint")
    assert shardlint.LAYOUT_AXES == frozenset(layout.LAYOUT_AXES)
    assert layout.LAYOUT_AXES == (layout.DATA_AXIS, layout.FSDP_AXIS,
                                  layout.SEQ_AXIS)
    assert {"JL010", "JL013", "JL030", "JL034"} <= set(synclint.RULES)


def test_port_package_lints_clean_against_its_baseline():
    baseline = synclint.Baseline.load()
    assert all(e.get("reason") and "<" not in e["reason"]
               for e in baseline.allow)
    kept, allowed, stale, n_files = synclint.lint_tree(REPO,
                                                       baseline=baseline)
    assert n_files > 80
    assert kept == [], "\n".join(map(str, kept))
    assert stale == []


def _ordered_lock_names():
    """(path, name) of every OrderedLock("name") the port constructs."""
    out = []
    for ab, rel in synclint.iter_py_files(REPO):
        with open(ab) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", getattr(node.func, "attr",
                                                         None))
                    == "OrderedLock"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                out.append((rel, node.args[0].value))
    return out


def test_lock_order_declares_every_ordered_lock_name():
    from dexiraft_tpu_torch.serve.locks import LOCK_ORDER

    names = _ordered_lock_names()
    assert {n for _, n in names} >= {"analysis.guards.watch",
                                     "analysis.guards.listener",
                                     "serve.video.chunk"}
    missing = [(p, n) for p, n in names if n not in LOCK_ORDER]
    assert missing == []
    threadlint = _load("dexiraft_tpu_torch/analysis/threadlint.py",
                       "_t_threadlint")
    assert threadlint.LOCK_ORDER == LOCK_ORDER
    # a nesting of an undeclared name is a finding
    assert "JL024" in rules_of("""
        from dexiraft_tpu_torch.serve.locks import OrderedLock

        class S:
            def __init__(self):
                self._a = OrderedLock("serve.video.chunk")
                self._b = OrderedLock("serve.scratch")

            def both(self):
                with self._a:
                    with self._b:
                        pass
    """)
