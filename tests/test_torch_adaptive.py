"""The adaptive (convergence-gated) refinement loop of the port, against
the port's fixed loop and the JAX package's adaptive step.

Mirrors tests/test_zzzadaptive.py: converge_tol=0 with the full budget is
bit-exact against the fixed loop (the strict ``dn < tol`` never fires);
the budget is clamped to [0, iters]; a partial budget runs exactly that
many iterations; a converged item freezes early (the contraction
fixture: the flow head's parameters x 0.01); the rows of a mixed batch
freeze on their own (v1 and v5). Against JAX ``make_eval_step(...,
adaptive=True)`` on the same weights: iters_used exactly, final_delta
within 1e-5, the flows within the variant's parity tolerance. Then the
engine's budget plumbing over numpy stubs and a real adaptive step.

v1 small and v5 small, seeded random weights on a ``jax.eval_shape``
tree (test_torch_raft._randomize), 40x56 frames, 4 iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_map_with_path

from dexiraft_tpu.config import VARIANTS as J_VARIANTS
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu.train.step import make_eval_step as j_make_eval_step
from dexiraft_tpu_torch.config import VARIANTS
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from dexiraft_tpu_torch.train.step import make_eval_step, make_refine_step
from test_torch_raft import _randomize

H, W = 40, 56
ITERS = 4
# the flow-delta norm dn of the first update, undamped weights (seed 41):
# v1 small 0.411 (pair 1) and 0.436 (pair 2) at every iteration within
# ~0.04; v5 small 1.042 (pair 1) and 1.017 (pair 3). A gate between them
# stops one row after its first update and lets the other run the budget.
MIXED = {"v1": (0.42, ((1, 2), (3, 4)), [1, ITERS]),
         "v5": (1.03, ((1, 2), (5, 6)), [ITERS, 1])}
RTOL = {"v1": 5e-3, "v5": 1e-2}


def _frame(seed):
    rng = np.random.default_rng(seed)
    if seed == 6:  # the second frame of pair 3: frame 5 moved by 1 px
        return np.roll(_frame(5), 1, axis=1)
    return rng.uniform(0, 255, (H, W, 3)).astype(np.float32)


def _pair(pairs):
    return (np.stack([_frame(a) for a, _ in pairs]),
            np.stack([_frame(b) for _, b in pairs]))


def _damp(path, leaf):
    keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
    return leaf * 0.01 if "FlowHead_0" in keys else leaf


@pytest.fixture(scope="module")
def variables():
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    out = {}
    for variant in ("v1", "v5"):
        cfg = J_VARIANTS[variant](small=True, corr_impl="local")
        v = _randomize(jax.eval_shape(lambda: JRAFT(cfg).init(
            jax.random.PRNGKey(0), img, img, iters=1, train=False)), 41)
        out[variant] = v
        out[variant + "_damped"] = {**v, "params": tree_map_with_path(
            _damp, v["params"])}
    return out


def _model(variables, key, tol):
    variant = key.split("_")[0]
    cfg = VARIANTS[variant](small=True, corr_impl="local", converge_tol=tol)
    model = RAFT(cfg)
    model.load_state_dict(raft_state_dict_from_jax(variables[key], cfg=cfg),
                          strict=True)
    return model.eval()


def _steps(variables, key, tol):
    model = _model(variables, key, tol)
    return (make_eval_step(model, ITERS, "cpu"),
            make_eval_step(model, ITERS, "cpu", adaptive=True))


class TestAdaptiveRefine:
    def test_tol_zero_full_budget_bit_exact_vs_fixed(self, variables):
        fixed, adapt0 = _steps(variables, "v1", 0.0)
        a, b = _pair(((1, 2),))
        low_f, up_f = fixed(a, b)
        low_a, up_a, iu, fd = adapt0(a, b, None, ITERS)
        assert torch.equal(up_f, up_a) and torch.equal(low_f, low_a)
        assert iu.tolist() == [ITERS]
        assert float(fd[0]) > 0.0

    def test_budget_clamped_to_configured_iters(self, variables):
        _, adapt0 = _steps(variables, "v1", 0.0)
        a, b = _pair(((1, 2),))
        _, up_full, _, _ = adapt0(a, b, None, ITERS)
        _, up_hi, iu_hi, _ = adapt0(a, b, None, 100)
        assert iu_hi.tolist() == [ITERS]
        assert torch.equal(up_full, up_hi)
        low0, _, iu0, fd0 = adapt0(a, b, None, -3)
        assert iu0.tolist() == [0] and fd0.tolist() == [0.0]
        assert float(low0.abs().max()) == 0.0  # no update ran

    def test_partial_budget_runs_exactly_budget_iters(self, variables):
        fixed_model = _model(variables, "v1", 0.0)
        _, adapt0 = _steps(variables, "v1", 0.0)
        a, b = _pair(((1, 2),))
        _, up2, iu, _ = adapt0(a, b, None, 2)
        assert iu.tolist() == [2]
        _, up4, _, _ = adapt0(a, b, None, ITERS)
        assert not torch.equal(up2, up4)
        _, up_fixed2 = make_eval_step(fixed_model, 2, "cpu")(a, b)
        assert torch.equal(up2, up_fixed2)

    def test_converged_item_freezes_early(self, variables):
        _, adapt = _steps(variables, "v1_damped", 0.02)
        _, adapt0 = _steps(variables, "v1_damped", 0.0)
        a, b = _pair(((1, 2),))
        _, up, iu, fd = adapt(a, b, None, ITERS)
        used = int(iu[0])
        assert used < ITERS, "early exit never fired"
        assert float(fd[0]) < 0.02
        _, up_ref, _, _ = adapt0(a, b, None, used)
        torch.testing.assert_close(up, up_ref, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("variant", ["v1", "v5"])
    def test_mixed_batch_rows_freeze_independently(self, variables, variant):
        """Batched, each row converges as it does alone (iterations applied
        and flow); in v5 the edge row freezes with its image row."""
        tol, pairs, expect = MIXED[variant]
        _, adapt = _steps(variables, variant, tol)
        a, b = _pair(pairs)
        _, up_b, iu_b, fd_b = adapt(a, b, None, ITERS)
        assert iu_b.tolist() == expect
        for row in range(2):
            _, up_s, iu_s, fd_s = adapt(a[row:row + 1], b[row:row + 1], None,
                                        ITERS)
            assert int(iu_b[row]) == int(iu_s[0])
            assert abs(float(fd_b[row]) - float(fd_s[0])) <= 1e-6
            torch.testing.assert_close(up_b[row], up_s[0], rtol=0, atol=1e-4)

    @pytest.mark.parametrize("key", ["v1", "v5", "v1_damped"])
    def test_matches_jax_adaptive_step(self, variables, key):
        """The port's adaptive step against JAX's on the same weights and
        the mixed batch: the same iters_used, final_delta within 1e-5."""
        variant = key.split("_")[0]
        tol, pairs, _ = MIXED[variant]
        if key.endswith("damped"):
            tol = 0.02
        a, b = _pair(pairs)
        jcfg = dataclasses.replace(
            J_VARIANTS[variant](small=True, corr_impl="local"),
            converge_tol=tol)
        j_low, j_up, j_iu, j_fd = j_make_eval_step(
            jcfg, iters=ITERS, adaptive=True)(
            variables[key], a, b, iter_budget=np.int32(ITERS))
        _, adapt = _steps(variables, key, tol)
        low, up, iu, fd = adapt(a, b, None, ITERS)
        assert iu.tolist() == np.asarray(j_iu).tolist()
        np.testing.assert_allclose(fd.numpy(), np.asarray(j_fd), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(low.numpy(), np.asarray(j_low),
                                   rtol=RTOL[variant], atol=1e-3)
        np.testing.assert_allclose(up.numpy(), np.asarray(j_up),
                                   rtol=RTOL[variant], atol=1e-3)

    def test_exit_check_cadence_changes_nothing(self, variables):
        """Reading the done mask on the host less often runs iterations
        after every row is done, which the select makes no-ops."""
        model = _model(variables, "v5", MIXED["v5"][0])
        a, b = (torch.from_numpy(x).permute(0, 3, 1, 2)
                for x in _pair(((5, 6),)))
        with torch.inference_mode():
            every = model(a, b, iters=ITERS, adaptive=True)
            never = model(a, b, iters=ITERS, adaptive=True,
                          exit_check_every=ITERS)
        assert every[2].tolist() == never[2].tolist() == [1]
        for x, y in zip(every, never):
            assert torch.equal(x, y)

    def test_refine_step_budget_contract(self, variables):
        """make_refine_step: the split twin of the adaptive eval step; a
        fixed refine step refuses a budget."""
        model = _model(variables, "v1", MIXED["v1"][0])
        a, b = _pair(MIXED["v1"][1])
        x1, x2 = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in (a, b))
        with torch.inference_mode():
            f1, f2 = model.encode_frame(x1), model.encode_frame(x2)
        refine = make_refine_step(model, ITERS, "cpu", adaptive=True)
        zeros = np.zeros((2, H // 8, W // 8, 2), np.float32)
        low, up, iu, fd = refine(f1, f2, zeros, ITERS)
        e_low, e_up, e_iu, e_fd = make_eval_step(
            model, ITERS, "cpu", adaptive=True)(a, b, None, ITERS)
        assert iu.tolist() == e_iu.tolist() == MIXED["v1"][2]
        torch.testing.assert_close(up, e_up, rtol=0, atol=1e-4)
        with pytest.raises(ValueError, match="iter_budget only has meaning"):
            make_refine_step(model, ITERS, "cpu")(f1, f2, zeros, 2)

    def test_separate_refused(self):
        with torch.device("meta"):
            v3 = RAFT(VARIANTS["v3"](corr_impl="local")).eval()
        x = torch.zeros(1, 3, 48, 64)
        with pytest.raises(ValueError, match="variant='separate'"):
            v3(x, x, edges1=x, edges2=x, adaptive=True)
        with pytest.raises(ValueError, match="variant='separate'"):
            v3.refine({}, {}, adaptive=True)


# ---- engine: numpy stubs and one real adaptive step ---------------------

_FULL = 8


def _stub_fixed(im1, im2, flow_init=None):
    b, h, w = im1.shape[:3]
    up = np.broadcast_to(np.float32([2.0, -1.0]), (b, h, w, 2)).copy()
    low = np.zeros((b, h // 8, w // 8, 2), np.float32)
    return low, up


def _stub_adaptive(im1, im2, flow_init=None, iter_budget=None):
    low, up = _stub_fixed(im1, im2, flow_init)
    b = im1.shape[0]
    n = _FULL if iter_budget is None else int(iter_budget)
    return (low, up, np.full((b,), n, np.int32),
            np.full((b,), 1e-4, np.float32))


def _item(seed=0):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (H, W, 3)).astype(np.float32)}


class TestAdaptiveEngine:
    def test_results_carry_convergence_evidence(self):
        eng = InferenceEngine(_stub_adaptive,
                              ServeConfig(batch_size=2, adaptive=True))
        r1, r2 = eng.run_batch([_item(), _item(1)])
        assert r1.iters_used == _FULL and r2.iters_used == _FULL
        assert abs(r1.final_delta - 1e-4) < 1e-9
        (r3,) = eng.run_batch([_item()], iter_budget=3)
        assert r3.iters_used == 3
        # the tail filler row of the last batch is not sampled
        assert eng.stats.iters_used == [_FULL, _FULL, 3]
        assert len(eng.stats.final_delta) == 3

    def test_fixed_engine_refuses_budget(self):
        eng = InferenceEngine(_stub_fixed, ServeConfig(batch_size=1))
        with pytest.raises(ValueError, match="fixed-iteration engine"):
            eng.run_batch([_item()], iter_budget=4)
        with pytest.raises(ValueError, match="fixed-iteration engine"):
            list(eng.stream([_item()], iter_budget=4))
        (r,) = eng.run_batch([_item()])
        assert r.iters_used is None and r.final_delta is None
        assert eng.stats.iters_used == []

    def test_stream_threads_budget_through(self):
        eng = InferenceEngine(_stub_adaptive,
                              ServeConfig(batch_size=2, adaptive=True))
        out = list(eng.stream([_item(i) for i in range(3)], iter_budget=5))
        assert [r.iters_used for r in out] == [5] * 3

    def test_real_adaptive_step_through_engine(self, variables):
        """A mixed batch through the engine gives each row the model's own
        iters_used, and a budget caps it."""
        tol, pairs, expect = MIXED["v1"]
        model = _model(variables, "v1", tol)
        eng = InferenceEngine(make_eval_step(model, ITERS, "cpu",
                                             adaptive=True),
                              ServeConfig(batch_size=2, adaptive=True))
        items = [{"image1": _frame(a), "image2": _frame(b)} for a, b in pairs]
        res = eng.run_batch(items)
        assert [r.iters_used for r in res] == expect
        assert all(r.flow_up.shape == (H, W, 2) for r in res)
        res = eng.run_batch(items, iter_budget=2)
        assert [r.iters_used for r in res] == [1, 2]
