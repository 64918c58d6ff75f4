"""Checkpoints of the train state: async full-state saves, restore for
``--resume``, partial restore for ``--restore_ckpt``.

Counterpart of ``dexiraft_tpu/train/checkpoint.py`` in the port's own
format (orbax directories cannot be read without JAX and are refused). A
checkpoint directory holds one subdirectory per step, ``<dir>/<step>/``,
with ``state.pt``: the model's state dict (parameters and BatchNorm
stats), the optimizer's (Adam moments, step count and schedule), the
generator's state, the step, the configs and any ``extra`` the trainer
adds (the data stream's position). It is written by ``torch.save`` into
``<dir>/<step>.tmp-*`` and renamed into place, so a crash mid-flush leaves
the previous step the newest one.

``save_checkpoint(block=False)`` copies the state to host memory at once
(the only part the step loop waits for: the next step updates the tensors
in place) and writes it on one background thread. ``wait_pending`` is the
barrier, taken before anything that reads or changes the directory (the
next save, a restore, retention, exit); it reports how long the caller
blocked and how long the flush took. The pending flushes are registered
under ``OrderedLock("train.checkpoint.pending")``.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

from dexiraft_tpu_torch.serve.locks import OrderedLock

STATE_FILE = "state.pt"
_LOCK = OrderedLock("train.checkpoint.pending")
_PENDING: Dict[str, Tuple[int, Future, float]] = {}
_EXECUTOR: Optional[ThreadPoolExecutor] = None


def _executor() -> ThreadPoolExecutor:
    global _EXECUTOR
    with _LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt-flush")
            atexit.register(_EXECUTOR.shutdown, wait=True)
        return _EXECUTOR


def _to_host(obj: Any) -> Any:
    """A deep copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _config_dict(cfg: Any) -> Any:
    return dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else cfg


def _payload(state, extra: Optional[Dict[str, Any]] = None,
                  configs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The host copy of ``state`` that a checkpoint holds."""
    return _to_host({
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "configs": {k: _config_dict(v) for k, v in (configs or {}).items()},
        "extra": dict(extra or {}),
    })


def _flush(directory: str, step: int, payload: Dict[str, Any]) -> float:
    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{step}.tmp-", dir=directory)
    try:
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        final = os.path.join(directory, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return time.perf_counter() - t0


def save_checkpoint(directory: str, state, step: Optional[int] = None,
                    block: bool = True, extra: Optional[Dict[str, Any]] = None,
                    configs: Optional[Dict[str, Any]] = None) -> None:
    """Save ``state`` as ``<directory>/<step>`` (default: ``state.step``).
    A flush still pending for this directory is waited for first."""
    step = int(state.step if step is None else step)
    key = os.path.abspath(directory)
    wait_pending(directory)
    t0 = time.perf_counter()
    payload = _payload(state, extra, configs)
    fut = _executor().submit(_flush, key, step, payload)
    with _LOCK:
        _PENDING[key] = (step, fut, time.perf_counter() - t0)
    if block:
        info = wait_pending(directory)
        if info and info["error"]:
            raise RuntimeError(f"checkpoint flush of step {step} failed: "
                               f"{info['error']}")


def wait_pending(directory: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Wait for the pending flush of ``directory`` (every directory when
    None); returns {step, flush_s, blocked_s, error} for it, or None when
    nothing was pending."""
    with _LOCK:
        keys = (list(_PENDING) if directory is None
                else [os.path.abspath(directory)])
        items = [(k, _PENDING.pop(k)) for k in keys if k in _PENDING]
    info = None
    for _, (step, fut, snap_s) in items:
        t0 = time.perf_counter()
        error = None
        flush_s = 0.0
        try:
            flush_s = fut.result()
        except Exception as e:  # reported to the caller, not raised here
            error = f"{type(e).__name__}: {e}"
        info = {"step": step, "flush_s": flush_s,
                "blocked_s": snap_s + time.perf_counter() - t0,
                "error": error}
    return info


def all_steps(directory: str) -> "list[int]":
    """The committed steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d, STATE_FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def delete_step(directory: str, step: int) -> None:
    wait_pending(directory)
    shutil.rmtree(os.path.join(directory, str(step)), ignore_errors=True)


def _is_orbax_dir(path: str) -> bool:
    if not os.path.isdir(path):
        return False
    names = set(os.listdir(path))
    if any(n.startswith("_CHECKPOINT_METADATA") or n == "_METADATA"
           or n.endswith(".orbax-checkpoint-tmp") for n in names):
        return True
    return any(os.path.isdir(os.path.join(path, n)) and n.isdigit()
               and not os.path.isfile(os.path.join(path, n, STATE_FILE))
               for n in names)


def load_payload(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The saved payload of ``path``: a checkpoint directory (its newest
    step, or ``step``), one step directory, or a ``state.pt`` file."""
    if os.path.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        return load_payload(os.path.join(path, STATE_FILE))
    if step is None:
        step = latest_step(path)
    if step is None:
        if _is_orbax_dir(path):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package; the "
                "PyTorch port cannot read one without JAX (ROADMAP A10): "
                "export its weights with interop.torch_convert and pass "
                "the state-dict file")
        raise FileNotFoundError(f"no checkpoint under {path}")
    return load_payload(os.path.join(path, str(step), STATE_FILE))


def restore_checkpoint(path: str, state, step: Optional[int] = None):
    """Load the full saved state (model, optimizer, generator, step) into
    ``state`` in place, for ``--resume``; returns (state, the payload's
    ``extra``)."""
    payload = load_payload(path, step)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state, payload.get("extra", {})


def restore_params_into(model: torch.nn.Module,
                        restored: Dict[str, torch.Tensor],
                        verbose: bool = False) -> "list[str]":
    """``load_state_dict(strict=False)`` with shapes checked: every entry
    of ``restored`` whose key exists in ``model`` with the same shape is
    loaded, the rest of the model keeps its init. Returns the skipped keys
    (missing from either side, or of another shape)."""
    own = model.state_dict()
    take = {k: v for k, v in restored.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    skipped = sorted(set(own) - set(take)) + sorted(set(restored) - set(own))
    skipped += sorted(k for k in restored if k in own and k not in take)
    model.load_state_dict(take, strict=False)
    if verbose and skipped:
        print(f"[checkpoint] partial restore skipped {len(skipped)} keys "
              f"(first {min(8, len(skipped))}): {skipped[:8]}")
    return skipped


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of ``path``: a checkpoint of this module (its
    newest step) or a bare state-dict file (the bridge's
    ``export_raft_state_dict`` layout)."""
    if os.path.isfile(path):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        return obj["model"] if isinstance(obj, dict) and "model" in obj \
            and "optimizer" in obj else obj
    return load_payload(path)["model"]
