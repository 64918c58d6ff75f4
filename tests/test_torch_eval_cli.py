"""The port's ``eval`` and ``viz`` CLIs and its retention policy, on the
CPU.

``python -m dexiraft_tpu_torch eval --device cpu`` on synthetic trees
(data/synthetic.py) of every dataset, with ``--model`` a state-dict file
bridged from seeded JAX variables (v1 small) or a checkpoint directory of
the port's trainer: its printed metrics against the JAX package's
validators over ``make_eval_step`` on the same weights (EPE rtol 5e-3,
the v1 row of docs/parity.md, plus 1e-3 for the printed rounding;
fractions within 2 pixels' share plus the rounding). Both sides use the
plain local lookup (``--corr_impl auto`` on the CPU), 2 iterations.
Submissions, the engine path, the adaptive frontier record (its keys are
JAX's), the refused flags, the missing card, v2's missing edges, ``viz``
against JAX's ``viz_cli`` (imageio), and ``RetentionPolicy`` against
JAX's decisions.
"""

import json
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.data.datasets import FlyingChairs as JChairs
from dexiraft_tpu.data.datasets import wrap_with_edge_tree as j_wrap
from dexiraft_tpu.eval import validate as j_val
from dexiraft_tpu.train.step import make_eval_step as j_make_eval_step
from dexiraft_tpu_torch import eval_cli, viz_cli
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.data.flow_io import read_flo, read_flow_kitti
from dexiraft_tpu_torch.data.png import read_png
from dexiraft_tpu_torch.data.synthetic import write_chairs_tree, \
    write_edge_tree, write_hd1k_tree, write_kitti_tree, write_sintel_tree
from dexiraft_tpu_torch.eval.flow_viz import flow_to_image
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.resilience.retention import RetentionPolicy
from dexiraft_tpu_torch.train import checkpoint as ckpt
from dexiraft_tpu_torch.train.state import create_state
from test_torch_raft import _variables
from test_torch_train_ops import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
ITERS = ["--iters", "2"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Trees of every dataset, seeded v1-small JAX variables and the
    bridged state-dict file."""
    root = str(tmp_path_factory.mktemp("eval_cli"))
    write_sintel_tree(root, "training", scenes=1, n_frames=3, hw=HW, seed=1)
    write_sintel_tree(root, "test", scenes=2, n_frames=3, hw=HW, seed=2)
    write_kitti_tree(root, "training", n=3, hw=(60, 90), empty=1, seed=3)
    write_kitti_tree(root, "testing", n=2, hw=(60, 90), seed=4)
    write_hd1k_tree(root, sequences=1, n_frames=3, hw=(60, 90),
                    empty=(0, 0), seed=5)
    data = write_chairs_tree(root, n_train=0, n_val=2, hw=HW, seed=6)
    write_edge_tree(data, os.path.join(root, "edges"), seed=7)
    variables = _variables(True, 2)
    weights = os.path.join(root, "weights.pth")
    torch.save(raft_state_dict_from_jax(variables, small=True), weights)
    return types.SimpleNamespace(root=root, variables=variables,
                                 weights=weights,
                                 edges=os.path.join(root, "edges"))


@pytest.fixture
def env(world, monkeypatch, tmp_path, few_torch_threads):  # noqa: F811
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", world.root)
    monkeypatch.chdir(tmp_path)
    return world


def _run(world, capsys, *flags, model=None):
    eval_cli.main(["--device", "cpu", "--small", "--model",
                   model or world.weights] + ITERS + list(flags))
    return capsys.readouterr().out


_LINE = re.compile(r"^Validation (.*?): (.*)$", re.M)


def _numbers(out):
    """Every number of the validators' printed lines, in order."""
    return [float(x) for _, rest in _LINE.findall(out)
            for x in re.findall(r"-?\d+\.\d+", rest)]


def _jax_metrics(world, name):
    step = j_make_eval_step(j_raft_v1(small=True, corr_impl="local"),
                            iters=2)

    def fn(im1, im2, flow_init=None):
        return step(world.variables, jnp.asarray(im1), jnp.asarray(im2),
                    flow_init=flow_init)

    dataset = None
    if name == "edgesum":
        dataset = j_wrap(JChairs(None, split="validation"), world.edges)
    return j_val.VALIDATORS[name](fn, dataset)


@pytest.mark.parametrize("dataset", ["chairs", "sintel", "kitti", "hd1k",
                                     "edgesum"])
def test_eval_cli_dataset_matches_jax(env, capsys, dataset):
    flags = ["--dataset", dataset]
    if dataset == "edgesum":
        flags += ["--edge_root", env.edges]
    out = _run(env, capsys, *flags)
    assert "[eval] corr_impl auto -> local" in out
    want = _jax_metrics(env, dataset)
    capsys.readouterr()
    got = _numbers(out)
    assert len(got) == len(want)
    for g, (k, w) in zip(got, want.items()):
        if "px" in k:
            tol = 2.0 / (2 * HW[0] * HW[1]) + 1e-3
        elif k.endswith("-f1"):
            tol = 100.0 * 2 / 1000 + 1e-3
        else:
            tol = 5e-3 * abs(w) + 1e-3
        assert abs(g - w) <= tol, (k, g, w)
    if dataset in ("kitti", "hd1k"):
        assert "(1 empty-mask frames skipped)" in out


def test_eval_cli_engine_and_checkpoint_directory(env, capsys):
    """--batch_size 2 (the engine) prints the per-image numbers, and a
    checkpoint directory of the port's trainer loads like the file."""
    per_image = _numbers(_run(env, capsys, "--dataset", "sintel"))
    out = _run(env, capsys, "--dataset", "sintel", "--batch_size", "2")
    assert "engine:" in out
    np.testing.assert_allclose(_numbers(out), per_image, atol=1e-3)
    state = create_state(raft_v1(small=True), TrainConfig(), device="cpu")
    state.model.load_state_dict(torch.load(env.weights), strict=True)
    ckpt.save_checkpoint("ck", state, step=7)
    out = _run(env, capsys, "--dataset", "sintel", model="ck")
    assert _numbers(out) == per_image


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_eval_cli_submissions(env, capsys):
    """Sintel with --warm_start per image and at --batch_size 2 (the same
    .flo files, flows within 1e-4 px), and KITTI's 16-bit PNGs."""
    _run(env, capsys, "--submission", "sintel", "--warm_start",
         "--output", "s1")
    _run(env, capsys, "--submission", "sintel", "--warm_start",
         "--batch_size", "2", "--output", "s2")
    files = _tree("s1")
    assert files == _tree("s2") and len(files) == 8
    for rel in files:
        a, b = read_flo(os.path.join("s1", rel)), read_flo(
            os.path.join("s2", rel))
        assert a.shape == HW + (2,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=rel)
    _run(env, capsys, "--submission", "kitti", "--output", "k")
    assert _tree("k") == ["000000_10.png", "000001_10.png"]
    flow, valid = read_flow_kitti("k/000000_10.png")
    assert flow.shape == (60, 90, 2) and valid.all()


def test_eval_cli_frontier_record_has_jax_keys(env, capsys):
    from dexiraft_tpu.eval_cli import FRONTIER_LEG_KEYS, \
        FRONTIER_RECORD_KEYS
    assert eval_cli.FRONTIER_RECORD_KEYS == FRONTIER_RECORD_KEYS
    assert eval_cli.FRONTIER_LEG_KEYS == FRONTIER_LEG_KEYS
    out = _run(env, capsys, "--dataset", "kitti", "--adaptive_iters", "1,2",
               "--frontier_out", "f.json")
    line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    assert set(rec) == FRONTIER_RECORD_KEYS
    assert [leg["budget"] for leg in rec["sweep"]] == [1, 2]
    for leg in rec["sweep"]:
        assert FRONTIER_LEG_KEYS <= set(leg)
        assert leg["mean_iters_used"] <= leg["budget"]
    with open("f.json") as f:
        assert json.loads(f.read()) == rec


@pytest.mark.parametrize("flags, item", [
    (["--mixed_precision"], "A2"),
    (["--data_parallel", "2"], "A12"),
    (["--strict"], "A13"),
])
def test_eval_cli_refused_flags_name_their_item(env, flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        eval_cli.main(["--device", "cpu", "--model", env.weights,
                       "--dataset", "chairs"] + flags)


def test_eval_cli_refuses_orbax_and_missing_models(env, tmp_path):
    os.makedirs(tmp_path / "orbax_run" / "100")
    with pytest.raises(SystemExit, match="ROADMAP A10"):
        eval_cli.main(["--device", "cpu", "--small", "--model",
                       str(tmp_path / "orbax_run"), "--dataset", "chairs"])
    with pytest.raises(SystemExit, match="no such model file"):
        eval_cli.main(["--device", "cpu", "--small", "--model", "nope.pth",
                       "--dataset", "chairs"])
    with pytest.raises(SystemExit, match="--dataset or --submission"):
        eval_cli.main(["--device", "cpu", "--model", env.weights])


def test_eval_cli_scan_unroll_changes_nothing(env, capsys):
    base = _numbers(_run(env, capsys, "--dataset", "chairs"))
    out = _run(env, capsys, "--dataset", "chairs", "--scan_unroll", "4")
    assert "--scan_unroll 4 changes nothing" in out
    assert _numbers(out) == base


def test_eval_cli_v2_fails_on_missing_edges_as_jax(env, tmp_path):
    """v2 takes its edge frames from the data, which no validator
    passes: the model's ValueError, in both packages."""
    from dexiraft_tpu.config import raft_v2 as j_raft_v2
    from dexiraft_tpu.models.raft import RAFT as JRAFT
    from dexiraft_tpu_torch.config import raft_v2
    from dexiraft_tpu_torch.models.raft import create_model
    path = str(tmp_path / "v2.pth")
    torch.save(create_model(raft_v2(small=True), seed=0,
                            device="cpu").state_dict(), path)
    with pytest.raises(ValueError, match="edges1/edges2"):
        eval_cli.main(["--device", "cpu", "--small", "--variant", "v2",
                       "--model", path, "--dataset", "chairs"] + ITERS)
    img = jnp.zeros((1, 64, 96, 3), jnp.float32)
    j_cfg = j_raft_v2(small=True, corr_impl="local")
    variables = JRAFT(j_cfg).init(jax.random.PRNGKey(0), img, img, iters=1,
                                  train=False, edges1=img, edges2=img)
    step = j_make_eval_step(j_cfg, iters=2)
    with pytest.raises(ValueError, match="edges1/edges2"):
        j_val.validate_chairs(lambda a, b, flow_init=None: step(
            variables, jnp.asarray(a), jnp.asarray(b)))


def test_eval_cli_without_a_card_exits_naming_cuda(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "dexiraft_tpu_torch", "eval", "--model",
         env.weights, "--dataset", "chairs"],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and "'cuda'" in proc.stderr
    assert "Traceback" not in proc.stderr


def test_dispatcher_lists_eval_and_viz():
    proc = subprocess.run([sys.executable, "-m", "dexiraft_tpu_torch"],
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "{serve,router,train,eval,viz,dexined,pack_records}" in proc.stderr


def test_viz_cli_matches_flow_to_image_and_jax(tmp_path, capsys):
    """Each PNG decodes to flow_to_image of its .flo, and to what the
    JAX package's viz_cli writes through imageio."""
    from dexiraft_tpu.viz_cli import main as j_viz_main
    from dexiraft_tpu_torch.data.flow_io import write_flo
    rng = np.random.default_rng(8)
    for rel in ("a/frame0001.flo", "a/frame0002.flo", "b/frame0001.flo"):
        os.makedirs(tmp_path / "in" / os.path.dirname(rel), exist_ok=True)
        write_flo(tmp_path / "in" / rel,
                  rng.normal(0, 4, (21, 34, 2)).astype(np.float32))
    for rad_max in (None, "10"):
        extra = [] if rad_max is None else ["--rad_max", rad_max]
        viz_cli.main(["--input", str(tmp_path / "in"), "--output",
                      str(tmp_path / "t")] + extra)
        j_viz_main(["--input", str(tmp_path / "in"), "--output",
                    str(tmp_path / "j")] + extra)
        pngs = _tree(tmp_path / "t")
        assert pngs == _tree(tmp_path / "j") and len(pngs) == 3
        for rel in pngs:
            got = read_png(tmp_path / "t" / rel)
            flow = read_flo(tmp_path / "in" / rel.replace(".png", ".flo"))
            want = flow_to_image(flow, rad_max=None if rad_max is None
                                 else float(rad_max))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(read_png(tmp_path / "j" / rel),
                                          want)
    assert "frame0001.flo ->" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no .flo files"):
        viz_cli.main(["--input", str(tmp_path / "t")])


class _FakeSteps:
    """In-memory stand-in for the JAX package's orbax step listing."""

    def __init__(self):
        self.steps = set()

    def all_steps(self, directory):
        return sorted(self.steps)

    def delete_step(self, directory, step):
        self.steps.discard(step)


@pytest.mark.parametrize("keep, keep_best", [(0, False), (1, False),
                                             (2, False), (1, True),
                                             (2, True)])
def test_retention_makes_jax_decisions(tmp_path, monkeypatch, keep,
                                       keep_best):
    """Saves at steps 1..8 with a scored validation after each, GC before
    each save protecting the last one (the trainer's order): the port's
    deletions, survivors and best step equal JAX's."""
    from dexiraft_tpu.resilience import retention as j_ret
    fake = _FakeSteps()
    monkeypatch.setattr(j_ret, "ckpt", fake)
    monkeypatch.setattr(j_ret, "delete_position", lambda d, s: None)
    j_pol = j_ret.RetentionPolicy(keep, keep_best, str(tmp_path / "j"))
    t_dir = str(tmp_path / "t")
    t_pol = RetentionPolicy(keep, keep_best, t_dir)
    scores = [5.0, 3.0, 4.0, 2.5, 6.0, 7.0, 2.6, 8.0]
    last = None
    for step, score in enumerate(scores, start=1):
        j_del = j_pol.apply(str(tmp_path / "j"), protect=(last,))
        t_del = t_pol.apply(t_dir, protect=(last,))
        assert t_del == j_del
        fake.steps.add(step)
        os.makedirs(os.path.join(t_dir, str(step)))
        open(os.path.join(t_dir, str(step), ckpt.STATE_FILE), "w").close()
        j_pol.note_score(step, score)
        t_pol.note_score(step, score)
        last = step
        assert ckpt.all_steps(t_dir) == sorted(fake.steps)
        assert t_pol.best_step() == j_pol.best_step()
    assert t_pol.scores == j_pol.scores
    # the scores outlive the process
    assert RetentionPolicy(keep, keep_best, t_dir).scores == t_pol.scores
    if keep_best:
        assert 4 in ckpt.all_steps(t_dir)  # the best (2.5) survives
    with pytest.raises(ValueError, match="keep must be >= 0"):
        RetentionPolicy(-1)
