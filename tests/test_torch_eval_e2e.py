"""End-to-end evaluation: the JAX package's validators over its
``make_eval_step`` (``RAFT.apply``) against the port's validators over
its eval step, on the same bridged weights and the same synthetic
dataset trees (data/synthetic.py: Sintel, KITTI and FlyingChairs in
their own layouts and formats, each side reading them with its own
codecs).

Models: v1 small and v5 at full width, 2 iterations, frames of 64x96
(KITTI's 60x90 pad to it), ``corr_impl="flash", fused_update=True`` on
both sides (JAX's Pallas kernel in interpret mode, the port's plain
version on the CPU), weights seeded as in tests/test_torch_raft.py.

Tolerances: EPE rtol 5e-3 (v1) and 1e-2 (v5), the slice tests' rows of
docs/parity.md, with atol 1e-4 px. The fraction metrics count pixels
against thresholds: the two forwards differ by ~1e-4 px, which moves a
pixel across a threshold only when its EPE lies that close to it, so
px1/px3/px5 agree within 2 pixels' share of the 2 x 64 x 96 pixels of a
Sintel pass, and KITTI's F1 (percent) within 2 of its valid pixels'.
The port's engine at batch 2 is held to the same bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.config import raft_v5 as j_raft_v5
from dexiraft_tpu.data.flow_io import read_flo as j_read_flo
from dexiraft_tpu.eval import submission as j_sub
from dexiraft_tpu.eval import validate as j_val
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu.train.step import make_eval_step as j_make_eval_step
from dexiraft_tpu_torch.config import raft_v1, raft_v5
from dexiraft_tpu_torch.data.flow_io import read_flo
from dexiraft_tpu_torch.data.synthetic import write_chairs_tree, \
    write_kitti_tree, write_sintel_tree
from dexiraft_tpu_torch.eval import submission, validate
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.train.step import make_eval_step
from test_torch_raft import _randomize
from test_torch_train_ops import few_torch_threads  # noqa: F401

ITERS = 2
HW = (64, 96)
SINTEL_PIXELS = 2 * HW[0] * HW[1]  # 2 pairs per pass
_MODELS = {
    "v1_small": (lambda **k: j_raft_v1(small=True, **k),
                 lambda **k: raft_v1(small=True, **k), 5e-3),
    "v5": (j_raft_v5, raft_v5, 1e-2),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_trees"))
    write_sintel_tree(root, "training", scenes=1, n_frames=3, hw=HW, seed=1)
    write_sintel_tree(root, "test", scenes=2, n_frames=3, hw=HW, seed=2)
    write_kitti_tree(root, "training", n=3, hw=(60, 90), empty=1, seed=3)
    write_chairs_tree(root, n_train=0, n_val=2, hw=HW, seed=4)
    return root


@pytest.fixture(scope="module", params=sorted(_MODELS))
def pair(request):
    """(name, JAX eval fn factory, port eval fn factory, rtol)."""
    j_cfg, t_cfg, rtol = _MODELS[request.param]
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JRAFT(j_cfg(corr_impl="local")).init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False))
    variables = _randomize(shapes, 7)
    cfg = t_cfg(corr_impl="flash", fused_update=True)
    model = RAFT(cfg)
    model.load_state_dict(raft_state_dict_from_jax(variables, cfg=cfg),
                          strict=True)
    j_step = j_make_eval_step(j_cfg(corr_impl="flash", fused_update=True),
                              iters=ITERS)

    def j_fn(im1, im2, flow_init=None):
        return j_step(variables, jnp.asarray(im1), jnp.asarray(im2),
                      flow_init=None if flow_init is None
                      else jnp.asarray(flow_init))

    t_fn = make_eval_step(model, iters=ITERS, device="cpu")
    return request.param, j_fn, t_fn, rtol


@pytest.fixture
def env(trees, monkeypatch, few_torch_threads):  # noqa: F811
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", trees)
    monkeypatch.setenv("DEXIRAFT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DEXIRAFT_FLASH_PIXEL_BLOCK", "128")
    monkeypatch.setenv("DEXIRAFT_FLASH_ROWS", "8")
    return trees


def _check(got, want, rtol, share):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if "px" in k or k.endswith("-f1"):
            assert abs(got[k] - v) <= share, (k, got[k], v)
        else:
            assert got[k] == pytest.approx(v, rel=rtol, abs=1e-4), k
            assert np.isfinite(v) and v > 0


@pytest.mark.parametrize("dataset", ["sintel", "kitti", "chairs"])
def test_validation_matches_jax(env, pair, dataset, capsys):
    name, j_fn, t_fn, rtol = pair
    want = j_val.VALIDATORS[dataset](j_fn)
    per_image = validate.run_validation(dataset, t_fn)
    batched = validate.run_validation(dataset, t_fn, batch_size=2)
    out = capsys.readouterr().out
    if dataset == "kitti":
        valid = 2 * int(0.3 * 60 * 90)  # ~ the two non-empty frames'
        share = 100.0 * 2 / (0.8 * valid)
        assert out.count("(1 empty-mask frames skipped)") == 3
    else:
        share = 2.0 / SINTEL_PIXELS
    _check(per_image, want, rtol, share)
    _check(batched, want, rtol, share)


def test_sintel_warm_start_submission_matches_jax(env, pair, tmp_path):
    """Per-image and sequences-abreast (batch 2) warm-start submissions
    against JAX's per-image one: the same files, flows within the slice
    tolerance."""
    name, j_fn, t_fn, rtol = pair
    j_sub.create_sintel_submission(j_fn, str(tmp_path / "j"),
                                   warm_start=True)
    for b in (1, 2):
        submission.create_sintel_submission(t_fn, str(tmp_path / f"t{b}"),
                                            warm_start=True, batch_size=b)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert len(files) == 2 * 2 * 2  # passes x scenes x pairs
    for b in (1, 2):
        for rel in files:
            got = read_flo(tmp_path / f"t{b}" / rel)
            want = j_read_flo(str(tmp_path / "j" / rel))
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-3,
                                       err_msg=f"batch {b} {rel}")
