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

``read_model_weights`` reads the weights of a checkpoint or of a bare
state-dict file for every CLI's ``--model`` and ``--restore_ckpt``.

A state stored sharded over an fsdp axis (``parallel.fsdp``) is saved
per shard by :func:`save_sharded`, which every rank calls: the ranks of
data index 0 each write their slices of the sharded parameters and of
their Adam moments as ``shard-<f>-of-<n>.pt`` into ``<dir>/<step>.tmp-
fsdp``; after a barrier rank 0 adds ``state.pt`` (the replicated
parameters and moments, BatchNorm stats, the optimizer's step count, the
generator, step, configs, ``extra`` and the layout: the fsdp size and
each sharded key's dim) and renames the directory into place once, so a
crash leaves the previous step the newest one. :func:`load_state_payload`
reads a step back for a template of either layout, checking every shard
(a missing or truncated one fails the step, and the verified restore
falls back). A step saved in another layout than the template's (sharded
n-way, m-way or replicated, or on other dims) is assembled whole, the
model and both Adam moments, and restricted to the template's layout:
this rank's slices under its ``ShardPlan``, or the whole tensors for a
replicated template (JAX's restore grafts a leaf into the template's
sharding whatever mesh saved it). ``read_model_weights`` assembles a
sharded step's full weights on one process.

``save_checkpoint(block=False)`` copies the state to host memory at once
(the only part the step loop waits for: the next step updates the tensors
in place) and writes it on one background thread. ``wait_pending`` is the
barrier, taken before anything that reads or changes the directory (the
next save, a restore, retention, exit); it reports how long the caller
blocked and how long the flush took. The pending flushes are registered
under ``OrderedLock("train.checkpoint.pending")``.

``chaos_kill_next_flush`` arms the chaos seam (resilience/chaos.py,
``--chaos kill_mid_flush@N``): the next save writes ``state.pt`` into its
``<step>.tmp-*`` directory and the process ``os._exit``s before the commit
rename, leaving the debris a crash mid-flush leaves.
``resilience/verify.restore_verified`` is the restore that survives it and
a truncated or non-finite step.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from dexiraft_tpu_torch.serve.locks import OrderedLock

STATE_FILE = "state.pt"
#: a sharded step's shard files, and the directory its flush writes
SHARD_FILE = "shard-{index}-of-{n}.pt"
SHARDED_TMP = "{step}.tmp-fsdp"
_LOCK = OrderedLock("train.checkpoint.pending")
_PENDING: Dict[str, Tuple[int, Future, float]] = {}
_EXECUTOR: Optional[ThreadPoolExecutor] = None
# the chaos seam: when set, the next save parks its flush after writing
# state.pt into the tmp dir and the process exits before the commit
_chaos_kill_next_flush = False


def chaos_kill_next_flush() -> None:
    """Arm the mid-flush crash: the next ``save_checkpoint`` writes its
    ``state.pt`` into ``<step>.tmp-*`` and then ``os._exit``s (code 7)
    before the commit rename (chaos injector — see
    resilience.chaos.parse_spec, spec ``kill_mid_flush@N``). os._exit
    skips atexit, so the flush is abandoned exactly as a SIGKILL would
    abandon it."""
    global _chaos_kill_next_flush
    _chaos_kill_next_flush = True


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
    if state.shards is not None:
        raise ValueError("a sharded state is saved by every rank together "
                         "(save_sharded)")
    return _to_host({
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "configs": {k: _config_dict(v) for k, v in (configs or {}).items()},
        "extra": dict(extra or {}),
    })


def _flush(directory: str, step: int, payload: Dict[str, Any],
           parked: Optional[threading.Event] = None) -> float:
    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{step}.tmp-", dir=directory)
    try:
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if parked is not None:
            # chaos: written but never committed; the saving thread
            # exits the process while this flush waits here
            parked.set()
            threading.Event().wait()  # synclint: disable=JL032 chaos hook: the process exits while the flush parks
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
    parked = threading.Event() if _chaos_kill_next_flush else None
    fut = _executor().submit(_flush, key, step, payload, parked)
    with _LOCK:
        _PENDING[key] = (step, fut, time.perf_counter() - t0)
    if parked is not None:
        if not parked.wait(timeout=120):
            # the flush failed before reaching the commit: exit
            # DIFFERENTLY so the chaos run fails with the true cause
            cause = fut.exception() if fut.done() else "still writing"
            print(f"[chaos] kill_mid_flush of step {step}: the flush never "
                  f"reached its commit ({cause!r}); exiting 8, not 7",
                  flush=True)
            os._exit(8)
        print(f"[chaos] killing process mid-flush of step {step}",
              flush=True)
        os._exit(7)
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
            flush_s = fut.result()  # synclint: disable=JL032 this process's own flush thread, no peer
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


def state_file(path: str, step: Optional[int] = None) -> str:
    """The ``state.pt`` of ``path``: a checkpoint directory (its newest
    step, or ``step``), one step directory, or the file itself."""
    if os.path.isfile(path):
        return path
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        return os.path.join(path, STATE_FILE)
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
    return os.path.join(path, str(step), STATE_FILE)


def load_payload(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The saved payload of ``path`` (:func:`state_file`'s); of a sharded
    step, its replicated part (``state.pt``)."""
    return torch.load(state_file(path, step), map_location="cpu",
                      weights_only=True)


def _shards(path: str, layout: Dict[str, Any]) -> "list[Dict[str, Any]]":
    """Every shard file beside the sharded step's ``state.pt`` at
    ``path``, in fsdp order; a missing or unreadable one raises."""
    n = int(layout["n_fsdp"])
    out = []
    for f in range(n):
        shard = torch.load(os.path.join(os.path.dirname(path),
                                        SHARD_FILE.format(index=f, n=n)),
                           map_location="cpu", weights_only=True)
        if shard.get("index") != f or shard.get("n_fsdp") != n:
            raise ValueError(f"shard {f} of {n} holds index "
                             f"{shard.get('index')} of {shard.get('n_fsdp')}")
        missing = set(layout["dims"]) - set(shard["model"])
        if missing:
            raise ValueError(f"shard {f} of {n} lacks {sorted(missing)[:4]}")
        out.append(shard)
    return out


def layout_of(template) -> Optional[Dict[str, Any]]:
    """The storage layout of a TrainState as its checkpoints record it:
    None for a replicated state, else its plan's ``layout()``."""
    return None if template.shards is None else template.shards.layout()


def describe_layout(layout: Optional[Dict[str, Any]]) -> str:
    """A storage layout (``layout_of``'s) in words, for the logs."""
    if layout is None:
        return "replicated"
    return f"sharded {layout['n_fsdp']}-way over fsdp"


def load_state_payload(template, path: str, step: Optional[int] = None
                       ) -> Dict[str, Any]:
    """The payload of ``path`` (:func:`state_file`'s) in the storage form
    of ``template`` (a TrainState), after every shard of a sharded step
    was read: of a step saved in the template's layout, the replicated
    part with this rank's slices and moments added; of a step saved in
    another layout, the step assembled whole (:func:`_whole_state`) and
    restricted to the template's (``ShardPlan.restrict``). The payload's
    ``fsdp`` stays the layout the step was saved in."""
    file = state_file(path, step)
    payload = torch.load(file, map_location="cpu", weights_only=True)
    saved, own = payload.get("fsdp"), layout_of(template)
    if saved == own:
        if saved is None:
            return payload
        mine = _shards(file, saved)[template.shards.mesh.fsdp_index]
        optim = dict(payload["optimizer"])
        optim["state"] = {**optim["state"], **mine["optimizer_state"]}
        return dict(payload, model={**payload["model"], **mine["model"]},
                    optimizer=optim)
    from dexiraft_tpu_torch.parallel.fsdp import param_keys

    model, optim = _whole_state(file, payload, param_keys(template.model))
    if template.shards is not None:
        model, optim = template.shards.restrict(model, optim)
    return dict(payload, model=model, optimizer=optim)


def _whole_state(file: str, payload: Dict[str, Any],
                 keys: "list[Tuple[str, ...]]"
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(model, optimizer) state dicts of the step ``payload`` (read from
    ``file``) whole, as one process holds them: a sharded step's slices
    of each parameter and of its two Adam moments joined along the
    saved dim. ``keys``: every parameter's state-dict keys in
    ``model.parameters()`` order (the optimizer's indices); a parameter
    registered under two keys is one leaf, joined once."""
    layout = payload.get("fsdp")
    if layout is None:
        return payload["model"], payload["optimizer"]
    shards = _shards(file, layout)
    model = _whole_model(file, payload, shards)
    optim = dict(payload["optimizer"])
    state = dict(optim["state"])
    for i, leaf_keys in enumerate(keys):
        dim = layout["dims"].get(leaf_keys[0])
        parts = [s["optimizer_state"].get(i) for s in shards]
        if dim is None or parts[0] is None:
            continue  # replicated (moments in state.pt), or none yet
        state[i] = {k: (torch.cat([p[k] for p in parts], dim=dim)
                        if isinstance(v, torch.Tensor) and v.dim() else v)
                    for k, v in parts[0].items()}
    optim["state"] = state
    return model, optim


def save_sharded(directory: str, state, step: Optional[int] = None,
                 barrier: Callable[[str], None] = lambda tag: None,
                 extra: Optional[Dict[str, Any]] = None,
                 configs: Optional[Dict[str, Any]] = None) -> None:
    """Save the sharded ``state`` as ``<directory>/<step>`` (module
    docstring); every rank calls it, ``barrier(tag)`` joins them (the
    trainer's ``Coordinator.barrier``). Blocking: the commit waits for
    every shard."""
    plan = state.shards
    step = int(state.step if step is None else step)
    mesh = plan.mesh
    tmp = os.path.join(directory, SHARDED_TMP.format(step=step))
    model_sd, optim_sd = state.state_dicts()
    sharded = plan.sharded_keys()
    moments = {i for i, leaf in enumerate(plan.leaves)
               if leaf.dim is not None}
    if mesh.data_index == 0:
        os.makedirs(tmp, exist_ok=True)
        name = SHARD_FILE.format(index=mesh.fsdp_index, n=mesh.n_fsdp)
        part = os.path.join(tmp, name + ".part")
        torch.save(_to_host({
            "index": mesh.fsdp_index, "n_fsdp": mesh.n_fsdp,
            "model": {k: model_sd[k] for k in sharded},
            "optimizer_state": {i: st for i, st in optim_sd["state"].items()
                                if i in moments}}), part)
        os.replace(part, os.path.join(tmp, name))
    barrier(f"shards@{step}")
    if not mesh.world.is_writer:
        return
    optim = dict(optim_sd, state={i: st for i, st in optim_sd["state"].items()
                                  if i not in moments})
    torch.save(_to_host({
        "step": int(state.step),
        "model": {k: v for k, v in model_sd.items() if k not in sharded},
        "optimizer": optim,
        "generator": state.generator.get_state(),
        "configs": {k: _config_dict(v) for k, v in (configs or {}).items()},
        "extra": dict(extra or {}),
        "fsdp": plan.layout(),
        "keys": list(model_sd),
    }), os.path.join(tmp, STATE_FILE))
    if _chaos_kill_next_flush:
        print(f"[chaos] killing process mid-flush of step {step}",
              flush=True)
        os._exit(7)
    final = os.path.join(directory, str(step))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def restore_checkpoint(path: str, state, step: Optional[int] = None):
    """Load the full saved state (model, optimizer, generator, step) into
    ``state`` in place; returns (state, the payload's ``extra``). The
    trainer's ``--resume`` and rollback go through
    ``resilience.verify.restore_verified``, which checks a step before
    it is applied."""
    return apply_payload(state, load_state_payload(state, path, step))


def apply_payload(state, payload: Dict[str, Any]):
    """Load a saved payload (``load_state_payload``'s, in the state's
    storage form) into ``state`` in place; returns (state, the payload's
    ``extra``)."""
    state.load_state_dicts(payload["model"], payload["optimizer"])
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


def read_model_weights(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of ``path``, with the reference key names, for a
    strict load: a checkpoint directory of this module (its newest step),
    one step directory or ``state.pt``, or a bare state-dict file (the
    bridge's ``export_raft_state_dict`` layout; a ``state_dict`` wrapper
    and a ``module.`` prefix are taken off). The one reader of every
    CLI's ``--model`` / ``--restore_ckpt``.

    A sharded step's weights are assembled whole from its shards.

    Raises FileNotFoundError for a missing path and ValueError, naming
    ROADMAP A10, for a directory that holds no checkpoint of this module
    (an orbax checkpoint of the JAX package)."""
    if os.path.isdir(path):
        if (latest_step(path) is None
                and not os.path.isfile(os.path.join(path, STATE_FILE))):
            raise ValueError(
                f"{path} holds no checkpoint of the port's trainer (an "
                "orbax checkpoint?); the PyTorch port cannot read orbax "
                "without JAX (ROADMAP A10): export its weights with "
                "interop.torch_convert and pass the state-dict file")
        return _whole_model(state_file(path))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such model file {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj and "optimizer" in obj:
        return _whole_model(path, obj)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.removeprefix("module."): torch.as_tensor(v)
            for k, v in obj.items()}


def _whole_model(file: str, payload: Optional[Dict[str, Any]] = None,
                 shards: "Optional[list[Dict[str, Any]]]" = None
                 ) -> Dict[str, torch.Tensor]:
    """The model state dict of the checkpoint ``state.pt`` at ``file``,
    whole: a sharded step's slices (``shards``, read here when None)
    joined along their dims, in the state dict's key order."""
    if payload is None:
        payload = torch.load(file, map_location="cpu", weights_only=True)
    layout = payload.get("fsdp")
    if layout is None:
        return payload["model"]
    if shards is None:
        shards = _shards(file, layout)
    model = dict(payload["model"])
    for key, dim in layout["dims"].items():
        model[key] = torch.cat([s["model"][key] for s in shards], dim=dim)
    order = payload.get("keys")
    return model if order is None else {k: model[k] for k in order}
