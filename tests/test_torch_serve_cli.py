"""``python -m dexiraft_tpu_torch serve``: the port's service CLI.

In child processes on the CPU (``--cpu``): a synthetic-init service starts,
answers, drains on SIGTERM and exits 0; a ``--model`` file written by the
JAX package's ``export_raft_state_dict`` serves the JAX model's flows
(rtol 5e-3); without ``--cpu`` on a machine without a card the process
exits non-zero naming ``cuda``. In process: the refused flags and inputs,
each with its ROADMAP item, and the DeviceThread the service's forwards
run on.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.interop.torch_convert import export_raft_state_dict
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu_torch import serve_cli
from dexiraft_tpu_torch.config import raft_v1
from dexiraft_tpu_torch.device import DeviceThread
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.serve.server import decode_response, encode_request
from test_torch_raft import ATOL, RTOL, _variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_S = 120.0   # a child's start on the CPU takes a few seconds


def _serve(*flags):
    """Start a child service; (process, url, lines read so far)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dexiraft_tpu_torch", "serve", "--cpu",
         "--port", "0", *flags], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(START_S, proc.kill)
    watchdog.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"listening on (http://\S+)", line)
            if m:
                return proc, m.group(1), lines
    finally:
        watchdog.cancel()
    proc.wait()
    raise AssertionError(f"no 'listening on' line: {''.join(lines)}")


def _post(url, im1, im2):
    req = urllib.request.Request(url + "/v1/flow",
                                 data=encode_request(im1, im2))
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, decode_response(r.read())


def _stop(proc, lines):
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    return proc.returncode, "".join(lines) + out


def _frames(h, w, seed):
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    im2 = np.clip(np.roll(im1, 2, axis=1) + rng.normal(0, 4, im1.shape),
                  0, 255).astype(np.float32)
    return im1, im2


def test_synthetic_service_serves_and_drains_on_sigterm():
    proc, url, lines = _serve("--synthetic_init", "--variant", "v1",
                              "--small", "--iters", "2", "--batch_size",
                              "2", "--warmup", "40x56")
    try:
        for seed in (0, 1):
            status, flow = _post(url, *_frames(40, 56, seed))
            assert status == 200 and flow.shape == (40, 56, 2)
            assert np.isfinite(flow).all()
    finally:
        rc, log = _stop(proc, lines)
    assert rc == 0, log
    assert "corr_impl auto -> local" in log and "device=cpu" in log
    assert "RANDOM weights" in log
    assert re.search(r"stopped after .* 2 served, 0 shed, 0 failed", log)


def test_worker_pool_shares_one_port_and_drains():
    """--workers 2: two stateless children on one SO_REUSEPORT port; a
    SIGTERM to the parent reaches both, and the pool exits 0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dexiraft_tpu_torch", "serve", "--cpu",
         "--synthetic_init", "--variant", "v1", "--small", "--iters", "1",
         "--port", str(port), "--workers", "2"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(START_S, proc.kill)
    watchdog.start()
    lines, up = [], 0
    try:
        for line in proc.stdout:
            lines.append(line)
            up += "listening on" in line
            if up == 2:
                break
    finally:
        watchdog.cancel()
    try:
        assert up == 2, "".join(lines)
        for seed in (0, 1):
            status, flow = _post(f"http://127.0.0.1:{port}",
                                 *_frames(40, 56, seed))
            assert status == 200 and flow.shape == (40, 56, 2)
    finally:
        rc, log = _stop(proc, lines)
    assert rc == 0, log
    assert "pool: 2 workers" in log and "sessions=off" in log
    assert log.count("stopped after") == 2


def test_model_file_serves_the_jax_flows(tmp_path):
    """A state dict exported from JAX variables (with a DataParallel
    ``module.`` prefix and a ``state_dict`` wrapper) loads with
    strict=True and serves the JAX forward's flow."""
    v = _variables(True, 5)
    template = RAFT(raft_v1(small=True, corr_impl="local")).state_dict()
    sd = export_raft_state_dict(v, template, small=True)
    path = tmp_path / "raft-small.pth"
    torch.save({"state_dict": {"module." + k: torch.from_numpy(
        np.array(a)) for k, a in sd.items()}}, path)
    im1, im2 = _frames(48, 64, 7)
    _, j_up = JRAFT(j_raft_v1(small=True, corr_impl="local")).apply(
        v, jnp.asarray(im1[None]), jnp.asarray(im2[None]), iters=2,
        train=False, test_mode=True)
    proc, url, lines = _serve("--model", str(path), "--variant", "v1",
                              "--small", "--iters", "2", "--batch_size",
                              "1", "--bucket_multiple", "8",
                              "--session_ttl_s", "0")
    try:
        status, flow = _post(url, im1, im2)
    finally:
        rc, log = _stop(proc, lines)
    assert rc == 0, log
    assert f"loaded {len(sd)} tensors" in log
    assert status == 200 and np.abs(np.asarray(j_up)).max() > 1e-2
    np.testing.assert_allclose(flow, np.asarray(j_up)[0], rtol=RTOL,
                               atol=ATOL)


def test_no_cpu_flag_without_a_card_exits_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "dexiraft_tpu_torch", "serve",
         "--synthetic_init", "--port", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "'cuda'" in proc.stderr and "listening" not in proc.stdout


@pytest.mark.parametrize("flags, message", [
    (["--mixed_precision"], "ROADMAP A2"),
    (["--data_parallel", "2"], "ROADMAP A12"),
    (["--strict"], "ROADMAP A13"),
    (["--fused_update", "--corr_impl", "local"], "requires --corr_impl"),
    (["--corr_impl", "allpairs"], "ROADMAP A9"),
    ([], "exactly one of --model or --synthetic_init"),
])
def test_refused_flags_exit_with_their_item(flags, message):
    init = [] if not flags else ["--synthetic_init"]
    with pytest.raises(SystemExit) as ei:
        serve_cli.main(["--cpu", "--small", *init, *flags])
    assert message in str(ei.value.code)


def test_orbax_directory_refused_naming_a10(tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP A10"):
        serve_cli.main(["--cpu", "--small", "--model", str(tmp_path)])
    with pytest.raises(SystemExit, match="no such model file"):
        serve_cli.main(["--cpu", "--small", "--model",
                        str(tmp_path / "missing.pth")])


def test_module_entry_point_usage():
    proc = subprocess.run([sys.executable, "-m", "dexiraft_tpu_torch"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and "serve" in proc.stderr


def test_device_thread_runs_calls_on_one_thread():
    worker = DeviceThread("test-device")
    seen = set()

    def where(x):
        seen.add(threading.get_ident())
        return x * 2

    wrapped = worker.wrap(where)
    threads = [threading.Thread(target=wrapped, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert wrapped(21) == 42
    assert len(seen) == 1 and threading.get_ident() not in seen
    # a call made from the worker itself runs inline (no self-deadlock)
    assert worker.call(lambda: worker.call(where, 1)) == 2

    def boom():
        raise ValueError("on the device thread")

    with pytest.raises(ValueError, match="on the device thread"):
        worker.call(boom)
    assert worker.call(where, 3) == 6  # the thread survives an error
