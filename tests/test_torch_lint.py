"""The port's static half of strict mode: synclint (SL001-SL004) and the
lock-discipline rules of its threadlint (JL020-JL024).

One flagged and one clean fixture per synclint rule; the port's
threadlint against the JAX package's on the JAX package's own fixtures
(tests/test_zzzthreadlint.py), both linters loaded by file path; the
whole port package clean against its reviewed baseline, every entry with
a reason; and LOCK_ORDER holding every name an OrderedLock of the port
uses, its static mirror equal to the live registry.
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


def _jax_fixtures():
    """Every source string of the JAX threadlint tests' TestRuleFixtures
    that parses as a module holding a class or a function."""
    with open(osp.join(REPO, "tests", "test_zzzthreadlint.py")) as f:
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
