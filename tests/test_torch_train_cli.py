"""The port's trainer end to end on the CPU: ``train_cli`` on a synthetic
FlyingChairs tree, checkpoints, ``--resume``, ``--restore_ckpt``,
in-training validation with ``--keep_best``, the device prefetch and
every refused flag (``--records_dir`` and ``--chaos`` run in
tests/test_torch_resilience.py).

The tree is written with the port's own codecs (binary PPM frames and .flo
flows, as tests/test_data.py's chairs tree), v1 small at 64x96, 2
iterations, so each CLI run takes seconds.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dexiraft_tpu_torch import train_cli
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.data.flow_io import read_flo, read_image, write_flo, \
    write_ppm
from dexiraft_tpu_torch.train import checkpoint as ckpt
from dexiraft_tpu_torch.train.state import create_state
from dexiraft_tpu_torch.train.step import make_train_step
from test_torch_train_ops import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--stage", "chairs", "--variant", "v1", "--small", "--iters", "2",
        "--image_size", "64", "96", "--batch_size", "2", "--num_workers", "1",
        "--sum_freq", "1", "--device", "cpu"]


def write_chairs_tree(root, n=6, h=96, w=128, seed=0, n_val=0):
    """A FlyingChairs_release tree under ``root`` with ``n`` training
    pairs, then ``n_val`` validation pairs."""
    data = os.path.join(root, "FlyingChairs_release", "data")
    os.makedirs(data, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n + n_val):
        for k in (1, 2):
            write_ppm(os.path.join(data, f"{i:05d}_img{k}.ppm"),
                      rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        write_flo(os.path.join(data, f"{i:05d}_flow.flo"),
                  rng.normal(size=(h, w, 2)).astype(np.float32))
    with open(os.path.join(root, "FlyingChairs_release",
                           "chairs_split.txt"), "w") as f:
        f.write("\n".join(["1"] * n + ["2"] * n_val))
    return data


@pytest.fixture()
def chairs_env(tmp_path, monkeypatch):
    write_chairs_tree(str(tmp_path))
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _losses(log_dir, name):
    with open(os.path.join(log_dir, name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def test_codecs_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    write_ppm(tmp_path / "a.ppm", img)
    np.testing.assert_array_equal(read_image(tmp_path / "a.ppm"), img)
    flow = rng.normal(size=(5, 7, 2)).astype(np.float32)
    write_flo(tmp_path / "a.flo", flow)
    np.testing.assert_array_equal(read_flo(tmp_path / "a.flo"), flow)


def test_cli_trains_saves_and_resumes_exactly(chairs_env):
    """An uninterrupted 4-step run, then --resume from a copy of its
    middle checkpoint: the resumed run starts at the saved step and logs
    the same losses (the same schedule, data position and generator)."""
    import shutil
    train_cli.main(BASE + ["--name", "full", "--num_steps", "4",
                           "--val_freq", "2", "--log_dir", "runs_a"])
    assert ckpt.all_steps("checkpoints/full") == [2, 4]
    full = _losses("runs_a", "full")
    assert sorted(full) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in full.values())
    shutil.copytree("checkpoints/full/2", "checkpoints/resumed/2")
    train_cli.main(BASE + ["--name", "resumed", "--num_steps", "4",
                           "--val_freq", "2", "--log_dir", "runs_b",
                           "--resume"])
    resumed = _losses("runs_b", "resumed")
    assert sorted(resumed) == [3, 4]
    for s in (3, 4):
        assert resumed[s] == pytest.approx(full[s], rel=1e-6)
    payload = ckpt.load_payload("checkpoints/resumed")
    # 6 pairs at batch 2: 3 batches an epoch, so step 4 ends at (1, 1)
    assert payload["step"] == 4 and tuple(payload["extra"]["stream"]) == (1, 1)
    assert payload["configs"]["train"]["num_steps"] == 4


def test_cli_restore_ckpt_from_checkpoint_and_state_dict(chairs_env, capsys):
    train_cli.main(BASE + ["--name", "a", "--num_steps", "1",
                           "--val_freq", "1"])
    sd = ckpt.read_model_weights("checkpoints/a")
    torch.save(sd, "weights.pth")
    # one reader for every CLI: the step directory and its state.pt too
    for path in ("checkpoints/a/1", "checkpoints/a/1/state.pt"):
        assert ckpt.read_model_weights(path).keys() == sd.keys()
    for src in ("checkpoints/a", "weights.pth"):
        train_cli.main(BASE + ["--name", "b", "--num_steps", "1",
                               "--restore_ckpt", src, "--no_guard"])
        assert "Partial restore from" in capsys.readouterr().out
    os.makedirs("orbax_run/100", exist_ok=True)
    with pytest.raises(SystemExit, match="ROADMAP A10"):
        train_cli.main(BASE + ["--name", "c", "--restore_ckpt", "orbax_run"])


@pytest.mark.parametrize("flags, field, value", [
    (["--mixed_precision"], "mixed_precision", True),
    (["--precision", "bf16"], "mixed_precision", True),
    (["--remat"], "remat", True),
    (["--remat_lookup"], "remat_lookup", True),
])
def test_precision_and_remat_flags_reach_the_model(flags, field, value):
    """The JAX CLI's precision and remat flags resolve into the model the
    trainer builds (train_model_config: --precision bf16 turns on mixed
    precision, as JAX's make_train_step does)."""
    from dexiraft_tpu_torch.train.state import train_model_config
    args = train_cli.build_parser().parse_args(BASE + flags)
    train_cli.refuse_unported(args)
    cfg, tc = train_cli.resolve_configs(args)
    assert getattr(train_model_config(cfg, tc), field) == value
    if "--precision" in flags:
        assert tc.precision == "bf16" and not cfg.mixed_precision


def test_cli_trains_in_bf16_under_remat(chairs_env):
    """One real step with --precision bf16 --remat: the checkpoint's
    weights and moments are fp32 and the logged loss is finite."""
    train_cli.main(BASE + ["--name", "bf16", "--num_steps", "1",
                           "--precision", "bf16", "--remat"])
    payload = ckpt.load_payload("checkpoints/bf16")
    assert payload["configs"]["train"]["precision"] == "bf16"
    assert payload["configs"]["raft"]["remat"] is True
    assert {v.dtype for v in payload["model"].values()
            if v.is_floating_point()} == {torch.float32}


@pytest.mark.parametrize("flags, item", [
    (["--fsdp", "1", "--resume"], "A12"),
    (["--elastic"], "A12"),
    (["--join", "host1"], "A12"),
    (["--fsdp", "auto", "--resume"], "A12"),
])
def test_refused_flags_name_their_item(flags, item, tmp_path, monkeypatch):
    """--elastic and --join are refused; --fsdp runs (on one process an
    fsdp axis of 1 or 'auto' is the one-device step), and what it refuses
    is a --resume of a checkpoint saved in another storage layout, here
    a step saved sharded 2-way (A12.1, resharded resume)."""
    monkeypatch.chdir(tmp_path)
    if "--resume" in flags:
        step = tmp_path / "checkpoints" / "refused" / "2"
        step.mkdir(parents=True)
        torch.save({"step": 2, "fsdp": {"n_fsdp": 2, "dims": {}}},
                   step / ckpt.STATE_FILE)
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        train_cli.main(BASE + ["--name", "refused"] + flags)


def test_cli_strict_run_equals_the_default_run(chairs_env, capsys,
                                               monkeypatch):
    """--strict (on the CPU: the recompile half) trains the same losses
    as the default run and reports no drift; a step that searches again
    after the first fails a strict run and only warns, once, in a default
    one."""
    common = BASE + ["--num_steps", "3", "--val_freq", "2"]
    train_cli.main(common + ["--name", "plain", "--log_dir", "runs"])
    train_cli.main(common + ["--name", "strict", "--log_dir", "runs",
                             "--strict"])
    assert "[guards]" not in capsys.readouterr().err
    plain, strict = _losses("runs", "plain"), _losses("runs", "strict")
    assert sorted(strict) == [1, 2, 3]
    for s in plain:
        assert strict[s] == pytest.approx(plain[s], rel=1e-6)

    import dexiraft_tpu_torch.train.step as step_mod
    from dexiraft_tpu_torch.analysis import guards

    real = step_mod.make_train_step

    def searching_step(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            guards.note_compile("train_step")
            return step(state, batch)

        return run

    monkeypatch.setattr(step_mod, "make_train_step", searching_step)
    with pytest.raises(guards.RecompileBudgetExceeded, match="train"):
        train_cli.main(common + ["--name", "drift", "--strict"])
    train_cli.main(common + ["--name", "drift_warn"])
    assert capsys.readouterr().err.count("[guards] train[drift_warn]") == 1


@pytest.mark.parametrize("flags", [
    ["--chaos", "sigterm@3"],
    ["--records_dir", "packs"],
    ["--stall_timeout", "30", "--straggler_factor", "5"],
])
def test_records_dir_and_chaos_are_ported(flags):
    """No longer refused: the flags parse and pass the refusal gate (the
    runs themselves are in tests/test_torch_resilience.py and, for the
    hang watchdog, tests/test_torch_coord.py)."""
    args = train_cli.build_parser().parse_args(BASE + flags)
    train_cli.refuse_unported(args)


def test_preset_resolution_and_dropped_validation(chairs_env, capsys):
    """A preset's validation sets are kept, and ``--validation`` with no
    names drops them (this tree has no validation pairs)."""
    args = train_cli.build_parser().parse_args(
        ["--stage", "things", "--preset", "standard", "--lr", "1e-5"])
    cfg, tc = train_cli.resolve_configs(args)
    assert (tc.name, tc.batch_size, tc.image_size, tc.freeze_bn, tc.lr) == (
        "raft-things", 6, (400, 720), True, 1e-5)
    assert cfg.corr_impl == "allpairs" and tc.validation == ("sintel",)
    args = train_cli.build_parser().parse_args(
        BASE + ["--preset", "standard", "--validation"])
    assert train_cli.resolve_configs(args)[1].validation == ()
    train_cli.main(BASE + ["--preset", "standard", "--name", "p",
                           "--num_steps", "2", "--val_freq", "1",
                           "--validation", "--corr_impl", "flash",
                           "--fused_update"])
    out = capsys.readouterr().out
    assert "ROADMAP A7" not in out and "Validation" not in out
    assert "Done: 2 steps" in out
    with pytest.raises(SystemExit, match="requires --corr_impl"):
        train_cli.main(BASE + ["--fused_update", "--corr_impl", "local"])


def _metric_rows(log_dir, name, key):
    with open(os.path.join(log_dir, name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r[key] for r in rows if key in r}


def test_cli_validates_at_checkpoints_and_keeps_best(tmp_path, monkeypatch,
                                                    capsys):
    """--validation chairs --keep_best --keep 1: the chairs EPE is logged
    at every checkpoint, retention.json holds the scores of the steps on
    disk, the best step survives GC beside the newest, and the training
    losses equal a run without validation (dropout on: validation draws
    no mask from the generator, and training resumes in train mode)."""
    write_chairs_tree(str(tmp_path), n=6, n_val=2)
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    common = BASE + ["--num_steps", "8", "--val_freq", "2",
                     "--dropout", "0.2", "--keep", "1"]
    train_cli.main(common + ["--name", "val", "--log_dir", "runs_v",
                             "--validation", "chairs", "--keep_best"])
    out = capsys.readouterr().out
    assert out.count("Validation Chairs EPE") == 4
    train_cli.main(common + ["--name", "plain", "--log_dir", "runs_p",
                             "--validation"])
    with_val, without = _losses("runs_v", "val"), _losses("runs_p", "plain")
    assert sorted(with_val) == list(range(1, 9))
    assert with_val == without
    epe = _metric_rows("runs_v", "val", "chairs")
    assert sorted(epe) == [2, 4, 6, 8]
    assert all(np.isfinite(v) for v in epe.values())
    steps = ckpt.all_steps("checkpoints/val")
    best = min(epe, key=epe.get)
    assert best in steps and 8 in steps and len(steps) <= 3
    with open("checkpoints/val/retention.json") as f:
        scores = {int(k): v for k, v in json.load(f).items()}
    assert sorted(scores) == steps
    for s in steps:
        assert scores[s] == pytest.approx(epe[s], rel=1e-6)
    # without --keep_best the window alone decides: 6 and 8 stay
    assert ckpt.all_steps("checkpoints/plain") == [6, 8]


def test_preset_validation_without_its_data_fails(chairs_env):
    """A validation set whose data is absent fails at the first
    checkpoint, as in the JAX trainer (the dataset cannot be listed)."""
    with pytest.raises(FileNotFoundError):
        train_cli.main(BASE + ["--name", "s", "--num_steps", "1",
                               "--val_freq", "1", "--validation", "sintel"])


def test_cli_without_a_card_exits_naming_cuda(chairs_env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "dexiraft_tpu_torch", "train", "--stage",
         "chairs", "--num_steps", "1"], cwd=str(chairs_env), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "'cuda'" in proc.stderr


def test_logger_writes_tensorboard_without_tensorflow(tmp_path):
    """The Logger's TensorBoard scalars are written through TensorBoard's
    own file API: TensorFlow is not imported (it costs every logging
    process ~15 s where it is installed), and the event file reads back
    every scalar (a subprocess: this one may hold TensorFlow already)."""
    code = (
        "import json, sys\n"
        "from dexiraft_tpu_torch.train.logger import Logger\n"
        "log = Logger(sum_freq=2, log_dir=sys.argv[1])\n"
        "for v in (1.0, 3.0, 5.0, 7.0):\n"
        "    log.push({'loss': v})\n"
        "log.write_dict({'chairs': 0.5}, step=4)\n"
        "log.close()\n"
        "tf_imported = 'tensorflow' in sys.modules\n"
        "from tensorboard.backend.event_processing.event_accumulator "
        "import EventAccumulator\n"
        "ev = EventAccumulator(sys.argv[1])\n"
        "ev.Reload()\n"
        "print(json.dumps([tf_imported] + [[[e.step, e.value] for e in "
        "ev.Scalars(k)] for k in ('loss', 'chairs')]))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    tf_imported, loss, chairs = json.loads(proc.stdout.splitlines()[-1])
    assert not tf_imported
    assert loss == [[2, 2.0], [4, 6.0]] and chairs == [[4, 0.5]]


def test_checkpoint_round_trip_and_async_flush(tmp_path):
    cfg = raft_v1(small=True, corr_impl="local", dropout=0.2)
    tc = TrainConfig(iters=2, batch_size=2, num_steps=20)
    rng = np.random.default_rng(2)
    batch = dict(image1=rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32),
                 image2=rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32),
                 flow=rng.normal(size=(2, 32, 48, 2)).astype(np.float32),
                 valid=np.ones((2, 32, 48), np.float32))
    step = make_train_step(cfg, tc)
    a = create_state(cfg, tc, device="cpu", seed=5)
    a, _ = step(a, batch)
    ckpt.save_checkpoint(str(tmp_path), a, block=False,
                         extra={"stream": (0, 1)})
    a, ma = step(a, batch)  # the flush holds the copy made before this
    info = ckpt.wait_pending(str(tmp_path))
    assert info["step"] == 1 and info["error"] is None
    assert ckpt.all_steps(str(tmp_path)) == [1]
    b = create_state(cfg, tc, device="cpu", seed=99)
    b, extra = ckpt.restore_checkpoint(str(tmp_path), b)
    assert b.step == 1 and tuple(extra["stream"]) == (0, 1)
    b, mb = step(b, batch)  # same dropout masks from the restored generator
    assert float(mb["loss"]) == float(ma["loss"])
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    ckpt.delete_step(str(tmp_path), 1)
    assert ckpt.latest_step(str(tmp_path)) is None
    # partial restore: keys of another shape stay fresh
    other = create_state(raft_v1(corr_impl="local"), tc, device="cpu")
    skipped = ckpt.restore_params_into(other.model, a.model.state_dict())
    assert skipped and "fnet.conv1.weight" in skipped


def test_prefetch_yields_the_host_batches_in_order():
    from dexiraft_tpu_torch.data.prefetch import DevicePrefetcher
    host = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    for depth in (0, 2):
        pf = DevicePrefetcher(iter(host), "cpu", depth=depth)
        got = [int(b["x"][0, 0]) for b in pf]
        assert got == list(range(5)) and pf.stats.batches == 5
        assert "5 batches" in pf.summary()
    with pytest.raises(ValueError):
        DevicePrefetcher(iter(host), "cpu", depth=-1)


def test_trainer_locks_are_ranked():
    from dexiraft_tpu_torch.serve.locks import LOCK_ORDER
    assert LOCK_ORDER.index("train.checkpoint.pending") < LOCK_ORDER.index(
        "data.loader.pool")
    # the collective flight recorder's ring is the leaf, as in JAX
    assert LOCK_ORDER[-3:] == ("train.checkpoint.pending", "data.loader.pool",
                               "resilience.trace.ring")
    assert LOCK_ORDER.index("resilience.watchdog.armed") < LOCK_ORDER.index(
        "train.checkpoint.pending")
