"""The port's recovery paths on the CPU: ``resilience.verify`` on the
port's checkpoint format, ``resilience.chaos``'s spec parser, and the
trainer end to end (``train_cli`` on a synthetic chairs tree, v1 small at
64x96, 2 iterations): ``--records_dir`` against the raw loader,
``--chaos sigterm@3`` then ``--resume`` against an uninterrupted run
(final weights bit-equal), a corrupt ``.flo`` skipped and counted, and a
``--chaos kill_mid_flush`` child whose ``--resume`` continues from the
previous committed step.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import pytest
import torch

from dexiraft_tpu_torch import train_cli
from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.data.synthetic import write_chairs_tree
from dexiraft_tpu_torch.resilience import chaos
from dexiraft_tpu_torch.resilience.verify import (CheckpointIntegrityError,
                                                  restore_verified,
                                                  uncommitted_flushes,
                                                  verify_state)
from dexiraft_tpu_torch.train import checkpoint as ckpt
from dexiraft_tpu_torch.train.state import create_state
from test_torch_train_ops import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--stage", "chairs", "--variant", "v1", "--small", "--iters", "2",
        "--image_size", "64", "96", "--batch_size", "2", "--num_workers", "1",
        "--sum_freq", "1", "--device", "cpu", "--num_steps", "6",
        "--val_freq", "2", "--validation"]
CFG = raft_v1(small=True, corr_impl="local")
TC = TrainConfig(iters=2, batch_size=2, num_steps=10)


def _state(seed=0):
    return create_state(CFG, TC, device="cpu", seed=seed)


def _weights(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


# ---- restore_verified on the port's format ----

def test_truncated_newest_falls_back_and_is_deleted(tmp_path, capsys):
    d = str(tmp_path / "ck")
    one, two = _state(1), _state(2)
    ckpt.save_checkpoint(d, one, step=1, extra={"stream": (0, 1)})
    ckpt.save_checkpoint(d, two, step=2, extra={"stream": (0, 2)})
    assert chaos.truncate_checkpoint(d, 2) == [
        os.path.join(d, "2", "state.pt")]
    state, step, extra = restore_verified(d, _state(9))
    assert step == 1 and extra["stream"] == (0, 1)
    for k, v in _weights(one).items():
        torch.testing.assert_close(state.model.state_dict()[k], v,
                                   rtol=0, atol=0)
    out = capsys.readouterr().out
    assert "failed verification" in out and "restored step 1" in out
    # the damaged step is gone, so training re-saves it
    assert ckpt.all_steps(d) == [1]
    ckpt.save_checkpoint(d, two, step=2)
    assert restore_verified(d, _state(9), verbose=False)[1] == 2


def test_nonfinite_and_mismatched_steps_are_rejected(tmp_path):
    good = _state(1)
    poisoned = _state(1)
    with torch.no_grad():
        # the largest tensor is always in the finiteness sample
        big = max(poisoned.model.parameters(), key=lambda p: p.numel())
        big.fill_(float("nan"))
    with pytest.raises(CheckpointIntegrityError, match="non-finite"):
        verify_state(poisoned, good)
    other = create_state(raft_v1(corr_impl="local"), TC, device="cpu")
    with pytest.raises(CheckpointIntegrityError, match="model keys|model\\."):
        verify_state(other, good)
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, good, step=1)
    ckpt.save_checkpoint(d, poisoned, step=2)
    template = _state(9)
    before = _weights(template)
    assert restore_verified(d, template, verbose=False)[1] == 1
    assert ckpt.all_steps(d) == [1]
    # a step of another model is refused before it touches the template
    d2 = str(tmp_path / "ck2")
    ckpt.save_checkpoint(d2, other, step=1)
    template = _state(9)
    with pytest.raises(CheckpointIntegrityError):
        restore_verified(d2, template, verbose=False)
    for k, v in _weights(template).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_all_bad_raises_and_deletes_nothing(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2):
        ckpt.save_checkpoint(d, _state(s), step=s)
        assert chaos.truncate_checkpoint(d, s)
    with pytest.raises(CheckpointIntegrityError, match="no restorable"):
        restore_verified(d, _state(9), verbose=False)
    assert ckpt.all_steps(d) == [1, 2]
    with pytest.raises(FileNotFoundError):
        restore_verified(str(tmp_path / "empty"), _state(9))


def test_debris_reported_always_cleaned_only_by_the_writer(tmp_path,
                                                           capsys):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, _state(1), step=3)
    debris = tmp_path / "ck" / "4.tmp-abc123"
    debris.mkdir()
    (debris / "state.pt").write_bytes(b"x" * 64)
    assert uncommitted_flushes(d) == ["4.tmp-abc123"]
    assert restore_verified(d, _state(9))[1] == 3
    assert uncommitted_flushes(d) == ["4.tmp-abc123"]
    assert "left in place" in capsys.readouterr().out
    assert restore_verified(d, _state(9), clean_debris=True)[1] == 3
    assert uncommitted_flushes(d) == []
    assert "removed 1 uncommitted flush" in capsys.readouterr().out
    assert ckpt.all_steps(d) == [3]


# ---- chaos specs ----

def test_parse_spec_arms_and_fires_once_and_refuses_unknown():
    arm = chaos.parse_spec("kill_mid_flush@3")
    try:
        arm(2)
        assert not ckpt._chaos_kill_next_flush
        arm(3)
        assert ckpt._chaos_kill_next_flush
        ckpt._chaos_kill_next_flush = False
        arm(4)  # armed once only
        assert not ckpt._chaos_kill_next_flush
    finally:
        ckpt._chaos_kill_next_flush = False  # never kill this pytest
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    try:
        fire = chaos.parse_spec("sigterm@2")
        fire(1)
        fire(2)
        fire(3)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert got == [signal.SIGTERM]
    with pytest.raises(ValueError, match="unknown chaos spec"):
        chaos.parse_spec("explode@3")


# ---- the trainer end to end ----

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A chairs tree (6 pairs at 96x128), its pack at the run's crop, and
    the uninterrupted raw run's losses and final weights."""
    root = tmp_path_factory.mktemp("torch_resilience")
    write_chairs_tree(str(root), n_train=6, n_val=0, hw=(96, 128))
    with pytest.MonkeyPatch.context() as m:
        m.setenv("DEXIRAFT_DATA_DIR", str(root))
        m.chdir(root)
        n = torch.get_num_threads()
        torch.set_num_threads(min(n, 2))
        try:
            from dexiraft_tpu_torch import pack_records

            assert pack_records.main(["--stage", "chairs", "--image_size",
                                      "64", "96", "--shards", "2", "--out",
                                      "records"]) == 0
            train_cli.main(BASE + ["--name", "ref", "--log_dir", "runs"])
        finally:
            torch.set_num_threads(n)
    return root


@pytest.fixture()
def in_tree(tree, monkeypatch):
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", str(tree))
    monkeypatch.chdir(tree)
    return tree


def _losses(name, log_dir="runs"):
    with open(os.path.join(log_dir, name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def _final(name, step=6):
    return ckpt.load_payload(os.path.join("checkpoints", name), step)


def _assert_same_weights(a, b):
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        torch.testing.assert_close(a["model"][k], b["model"][k], rtol=0,
                                   atol=0, msg=k)


def test_records_dir_losses_equal_the_raw_run(in_tree, capsys):
    train_cli.main(BASE + ["--name", "rec", "--log_dir", "runs",
                           "--records_dir", "records"])
    out = capsys.readouterr().out
    assert "Training with 6 packed samples (6 records in 2 shard(s)" in out
    ref, rec = _losses("ref"), _losses("rec")
    assert sorted(ref) == list(range(1, 7)) and rec == ref
    _assert_same_weights(_final("rec"), _final("ref"))
    extra = _final("rec")["extra"]
    assert extra["loader_kind"] == "records" and extra["seed"] == 1234
    assert len(extra["fingerprint"]) == 40
    assert _final("ref")["extra"]["loader_kind"] == "raw"
    # a resume of the raw run under the records loader is refused
    with pytest.raises(SystemExit, match="drop --records_dir|pass the"):
        train_cli.main(BASE + ["--name", "ref", "--log_dir", "runs_x",
                               "--records_dir", "records", "--resume"])
    with pytest.raises(SystemExit, match="stage 'chairs'"):
        train_cli.main([a if a != "chairs" else "things" for a in BASE]
                       + ["--name", "x", "--records_dir", "records"])


def test_sigterm_then_resume_is_bit_exact(in_tree, capsys):
    train_cli.main(BASE + ["--name", "cut", "--log_dir", "runs_cut",
                           "--chaos", "sigterm@3"])
    assert "Preempted at step 3" in capsys.readouterr().out
    cut = os.path.join("checkpoints", "cut")
    assert ckpt.all_steps(cut) == [2, 3]
    # the NEXT batch to consume: 3 batches an epoch, so (1, 0)
    assert tuple(ckpt.load_payload(cut)["extra"]["stream"]) == (1, 0)
    train_cli.main(BASE + ["--name", "cut", "--log_dir", "runs_cut2",
                           "--resume"])
    assert "Resumed full state at step 3" in capsys.readouterr().out
    assert ckpt.latest_step(cut) == 6
    _assert_same_weights(_final("cut"), _final("ref"))


def test_corrupt_flo_is_skipped_and_counted(in_tree, tmp_path, monkeypatch,
                                           capsys):
    bad = tmp_path / "bad"
    shutil.copytree(in_tree / "FlyingChairs_release",
                    bad / "FlyingChairs_release")
    for i in range(1, 6):
        (bad / "FlyingChairs_release" / "data"
         / f"{i:05d}_flow.flo").write_bytes(b"not a flow file")
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", str(bad))
    train_cli.main([a if a != "6" else "2" for a in BASE]
                   + ["--name", "corrupt", "--log_dir", "runs_bad"])
    out = capsys.readouterr().out
    assert "[pipeline:" in out and "skipped" in out and "[pipeline]" in out
    assert ckpt.latest_step(os.path.join("checkpoints", "corrupt")) == 2


def test_kill_mid_flush_child_resumes_from_the_previous_step(in_tree,
                                                             capsys):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "dexiraft_tpu_torch", "train"] + BASE
        + ["--name", "kill", "--log_dir", "runs_kill",
           "--chaos", "kill_mid_flush@3"],
        cwd=str(in_tree), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 7, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "[chaos] killing process mid-flush of step 4" in proc.stdout
    kill = os.path.join("checkpoints", "kill")
    assert ckpt.all_steps(kill) == [2]
    debris = uncommitted_flushes(kill)
    assert len(debris) == 1 and debris[0].startswith("4.tmp-")
    train_cli.main(BASE + ["--name", "kill", "--log_dir", "runs_kill2",
                           "--resume"])
    out = capsys.readouterr().out
    assert "removed 1 uncommitted flush" in out
    assert "Resumed full state at step 2" in out
    assert uncommitted_flushes(kill) == [] and ckpt.latest_step(kill) == 6
    ref, resumed = _losses("ref"), _losses("kill", "runs_kill2")
    assert sorted(resumed) == [3, 4, 5, 6]
    assert all(resumed[s] == ref[s] for s in resumed)
    _assert_same_weights(_final("kill"), _final("ref"))


def test_resume_and_rollback_restore_through_verification(in_tree, capsys):
    """A copy of the raw run with its newest step truncated: --resume falls
    back to step 4 and deletes 6; with every loss over the guard's
    threshold, the rollback restores step 4 through the same check, and
    the exhausted budget names it as the last good checkpoint."""
    rb = os.path.join("checkpoints", "rb")
    shutil.copytree(os.path.join("checkpoints", "ref"), rb)
    assert chaos.truncate_checkpoint(rb, 6)
    with pytest.raises(RuntimeError, match="last good checkpoint: .*step 4"):
        train_cli.main([a if a != "6" else "8" for a in BASE]
                       + ["--name", "rb", "--log_dir", "runs_rb", "--resume",
                          "--guard_threshold", "1e-9", "--guard_every", "1",
                          "--max_rollbacks", "1"])
    out = capsys.readouterr().out
    assert "step 6 failed verification" in out
    assert "Resumed full state at step 4" in out
    assert "(rollback 1/1); restored step 4" in out
    assert ckpt.all_steps(rb) == [2, 4]
