"""The port's runtime guards (dexiraft_tpu_torch.analysis.guards).

RecompileWatch and strict_mode hold the JAX module's semantics: drift
from mark_warm, check/warn deferring while a sanctioned window is open,
windows on two threads merging into one shift, the shift capped at the
current count, the drift warning printed once, and the region's exit
check. The sync half is driven through an injected setter (a CPU run
has no card): the transfer levels map onto torch.cuda's sync debug
modes, sync windows lower the mode while any is open, and the caller's
mode comes back on exit and on an exception. The parity case runs the
same signature sequence through JAX's strict_mode over a jitted function
and through the port's over its tiny eval step.
"""

from __future__ import annotations

import io
import threading

import jax
import numpy as np
import pytest
import torch

from dexiraft_tpu.analysis import guards as jguards
from dexiraft_tpu_torch.analysis import guards
from dexiraft_tpu_torch.analysis.guards import (RecompileBudgetExceeded,
                                                RecompileWatch, strict_mode)
from dexiraft_tpu_torch.config import raft_v1
from dexiraft_tpu_torch.models.raft import create_model
from dexiraft_tpu_torch.train.step import make_eval_step
from test_torch_train_ops import few_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    """2 torch threads: the suite runs 6 workers at once on 8 cores."""
    yield


@pytest.fixture
def modes(monkeypatch):
    """The sync debug modes strict_mode sets, on a fake card whose mode
    starts at "warn" (the caller's own choice, to be restored)."""
    state = {"mode": "warn", "log": []}

    def set_mode(mode):
        state["mode"] = mode
        state["log"].append(mode)

    monkeypatch.setattr(guards, "_get_sync_mode", lambda: state["mode"])
    monkeypatch.setattr(guards, "_set_sync_mode", set_mode)
    return state


def test_watch_drift_check_and_budget():
    w = RecompileWatch("t", budget=1)
    guards.note_compile("test")
    assert w.drift == 0                 # not warm yet
    w.check()
    w.mark_warm()
    guards.note_compile("test")
    assert w.drift == 1
    w.check()                           # within the budget of 1
    with pytest.raises(RecompileBudgetExceeded, match="budget 0"):
        w.check(budget=0)
    guards.note_compile("test")
    with pytest.raises(RecompileBudgetExceeded, match="2 compile"):
        w.check()
    w.mark_warm()
    assert w.drift == 0


def test_sanctioned_absorbs_and_defers_and_caps():
    w = RecompileWatch("t")
    w.mark_warm()
    with w.sanctioned():
        guards.note_compile("test")
        w.check()                       # defers inside the window
        assert w.warn_if_drifted(file=io.StringIO()) is False
        w.mark_warm()                   # inside: must not compound
    assert w.drift == 0                 # capped at the current count
    guards.note_compile("test")         # outside: still drift
    assert w.drift == 1
    with pytest.raises(RecompileBudgetExceeded):
        w.check()


def test_sanctioned_windows_merge_across_two_threads():
    """Overlapping windows on two threads shift the baseline once, by
    every compile inside their span; a check on either thread defers
    while either is open."""
    w = RecompileWatch("t")
    w.mark_warm()
    a_open, b_open, a_closed = (threading.Event() for _ in range(3))
    errors = []

    def thread_a():
        try:
            with w.sanctioned():
                guards.note_compile("test")
                a_open.set()
                assert b_open.wait(10)
            a_closed.set()
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    def thread_b():
        try:
            assert a_open.wait(10)
            with w.sanctioned():
                b_open.set()
                guards.note_compile("test")
                assert a_closed.wait(10)
                w.check()               # A closed, B open: defers
        except BaseException as e:
            errors.append(e)

    ts = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert not any(t.is_alive() for t in ts) and not errors, errors
    assert w.drift == 0
    w.check()


def test_warn_if_drifted_prints_once():
    w = RecompileWatch("once")
    w.mark_warm()
    out = io.StringIO()
    assert w.warn_if_drifted(file=out) is False
    guards.note_compile("test")
    assert w.warn_if_drifted(file=out) is True
    guards.note_compile("test")
    assert w.warn_if_drifted(file=out) is True
    assert out.getvalue().count("[guards] once: ") == 1


def test_note_new_key_counts_each_key_per_thread():
    key = ("a-key-of-this-test", object())
    n0 = guards.compile_count()
    assert guards.note_new_key("test", key) is True
    assert guards.note_new_key("test", key) is False
    other = []
    t = threading.Thread(target=lambda: other.append(
        guards.note_new_key("test", key)))
    t.start()
    t.join(10)
    assert other == [True]              # cuDNN searches anew on a thread
    assert guards.compile_count() == n0 + 2
    assert guards.counts()["by_kind"]["test"] >= 2
    # off a card (per_thread=False) the thread is no part of the key
    assert guards.note_new_key("test", key, per_thread=False) is True
    t = threading.Thread(target=lambda: other.append(
        guards.note_new_key("test", key, per_thread=False)))
    t.start()
    t.join(10)
    assert other == [True, False]


@pytest.mark.parametrize("transfer, mode", [
    ("disallow", "error"), ("log", "warn"), ("allow", "default")])
def test_strict_mode_sets_the_sync_level_and_restores_it(modes, transfer,
                                                          mode):
    with strict_mode(transfer=transfer, device="cuda") as w:
        assert modes["mode"] == mode
        with guards.sync_window():
            assert modes["mode"] == "default"
        assert modes["mode"] == mode
        assert w.drift == 0
    assert modes["mode"] == "warn"      # the caller's mode
    with pytest.raises(ValueError, match="transfer"):
        with strict_mode(transfer="sometimes", device="cuda"):
            pass


def test_strict_mode_restores_after_an_exception(modes):
    with pytest.raises(KeyError):
        with strict_mode(device="cuda"):
            assert modes["mode"] == "error"
            guards.note_compile("test")   # no exit check on this path
            raise KeyError("body")
    assert modes["mode"] == "warn" and not guards._armed
    with pytest.raises(RecompileBudgetExceeded):
        with strict_mode(device="cuda"):
            guards.note_compile("test")
    assert modes["mode"] == "warn" and not guards._armed


def test_sync_windows_on_two_threads_keep_the_mode_low(modes):
    """The mode is process-global: it stays lowered while any thread's
    window is open and returns to the strict level with the last."""
    inside, release = threading.Event(), threading.Event()

    def other():
        with guards.sync_window():
            inside.set()
            release.wait(10)

    with strict_mode(device="cuda"):
        t = threading.Thread(target=other)
        t.start()
        assert inside.wait(10)
        with guards.sync_window():
            pass
        assert modes["mode"] == "default"   # the other window is open
        release.set()
        t.join(10)
        assert not t.is_alive()
        assert modes["mode"] == "error"
    assert modes["mode"] == "warn"


def test_cpu_region_arms_only_the_recompile_half(modes):
    with strict_mode(device="cpu") as w:
        guards.note_compile("test")
        assert w.drift == 1
        with pytest.raises(RecompileBudgetExceeded):
            w.check()
        w.mark_warm()
    assert modes["log"] == []


def test_fetch_and_put_on_the_cpu():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tree = guards.fetch({"a": t, "b": (t.to(torch.bfloat16), 3),
                         "c": [None]})
    assert isinstance(tree["a"], np.ndarray)
    assert tree["b"][0].dtype == np.float32 and tree["b"][1] == 3
    assert tree["c"] == [None]
    np.testing.assert_array_equal(tree["a"], t.numpy())
    arr = np.ones((2, 2), np.float32)
    put = guards.put(arr, "cpu")
    arr[0, 0] = 5.0                     # shares the host memory on the CPU
    assert put.device.type == "cpu" and float(put[0, 0]) == 5.0


def test_watch_matches_jax_on_one_signature_sequence():
    """A, A, B, B under one strict region, warm at the first A: the JAX
    strict_mode over a jitted function and the port's over its eval step
    give the same drift after each call and the same verdicts."""
    sig_a, sig_b = (1, 32, 48, 3), (1, 40, 48, 3)
    rng = np.random.default_rng(0)
    frames = {s: rng.uniform(0, 255, s).astype(np.float32)
              for s in (sig_a, sig_b)}

    budget_errors = (RecompileBudgetExceeded,
                     jguards.RecompileBudgetExceeded)

    def run(call, region):
        call(sig_a)                     # warm-up, before the region
        drifts, verdicts = [], []
        with pytest.raises(budget_errors):
            with region() as w:
                for s in (sig_a, sig_b, sig_b):
                    call(s)
                    drifts.append(w.drift)
                    try:
                        w.check()
                        verdicts.append("pass")
                    except budget_errors:
                        verdicts.append("raise")
        return drifts, verdicts

    f = jax.jit(lambda x, y: (x - y).sum(axis=-1))
    jframes = {s: jax.device_put(v) for s, v in frames.items()}
    jax_out = run(lambda s: jax.block_until_ready(f(jframes[s], jframes[s])),
                  lambda: jguards.strict_mode(label="parity"))

    model = create_model(raft_v1(small=True), seed=0, device="cpu")
    step = make_eval_step(model, iters=1, device="cpu")
    port_out = run(lambda s: step(frames[s], frames[s]),
                   lambda: strict_mode(label="parity", device="cpu"))
    assert jax_out == port_out == ([0, 1, 1], ["pass", "raise", "raise"])
