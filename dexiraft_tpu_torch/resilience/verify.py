"""Restore-time checkpoint integrity: verify, and fall back, loudly.

Counterpart of ``dexiraft_tpu/resilience/verify.py`` for the port's
checkpoint format (train/checkpoint.py: ``<dir>/<step>/state.pt``). A
checkpoint can be bad in two distinct ways: a TRUNCATED/corrupt step
(preemption mid-write, disk trouble) fails to load, and a step that
loads cleanly but holds non-finite tensors (saved by a guard-less run,
or poisoned storage) would resume silently and waste a relaunch before
the divergence guard fires.

``restore_verified`` walks the saved steps newest-first: each candidate
must (a) load at all (a sharded step: every shard of it), (b) match the
template's model and optimizer
state dicts — the same keys, and each tensor the template's shape and
dtype (an Adam moment its parameter's) — and (c) pass a finiteness
sample over the float tensors. A candidate is checked before anything
is loaded into the template, so a bad step never touches the live
state. The first step that passes wins; everything skipped is reported
in one line each, so "resumed from step 40000 because 45000 was
truncated" is visible in the log instead of being silently wrong. A step
saved in another storage layout than the template's (fsdp size, sharded
dims, or replicated) is read whole and restricted to the template's
layout (``ckpt.load_state_payload``), and checked in that form; the
restore names both layouts in one line.

Once a good step restores, the skipped bad steps are DELETED: retraining
toward that step number re-saves it, and the run's newest checkpoint must
then be the good re-save, never the damaged original. When every
candidate fails, nothing is deleted (forensics beat tidiness on a total
loss) and CheckpointIntegrityError carries the skip list.

Async saves add a third way a directory can be dirty: a crash MID-FLUSH
(kill -9, chaos kill_mid_flush, node loss) abandons an uncommitted
``<step>.tmp-*`` directory. The commit rename never happened, so the
step is invisible to every restore path — the previous committed step is
still the newest restorable one, which is the whole point — but the
debris would accumulate. ``restore_verified`` always reports it, and
removes it when the caller declares itself the directory's writer
(``clean_debris=True`` — the recovering trainer; readers such as
serve/eval must never delete another process's possibly-live flush).
"""

from __future__ import annotations

import os
import os.path as osp
import re
import shutil
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

from dexiraft_tpu_torch.train import checkpoint as ckpt

# tensors sampled for the finiteness check: every Nth float tensor plus
# the largest one (the big encoder kernels are where storage corruption
# is most likely to land by mass)
_SAMPLE_EVERY = 7
_DEBRIS = re.compile(r"^\d+\.tmp-")


class CheckpointIntegrityError(RuntimeError):
    """No saved step under the directory passed verification."""


def uncommitted_flushes(directory: str) -> "list[str]":
    """Leftover ``<step>.tmp-*`` dirs from flushes that never committed
    (the process died mid-write). Sorted names, not paths."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(n for n in names if _DEBRIS.match(n)
                  and osp.isdir(osp.join(directory, n)))


def clean_uncommitted(directory: str, verbose: bool = True) -> "list[str]":
    """Remove crashed-flush debris (see module docstring). Only call
    when this process owns the directory's writes — the wait_pending
    barrier guarantees no in-flight flush of our own, and the
    single-writer checkpoint model means nobody else's."""
    debris = uncommitted_flushes(directory)
    for name in debris:
        shutil.rmtree(osp.join(directory, name), ignore_errors=True)
    if debris and verbose:
        print(f"[resilience] removed {len(debris)} uncommitted flush(es) "
              f"under {directory} (crash mid-save; the committed steps "
              f"are unaffected): {debris}", flush=True)
    return debris


def _state_dicts(state) -> Tuple[Mapping[str, Any], Mapping[str, Any]]:
    """(model, optimizer) state dicts of a TrainState (in its storage
    form: a sharded parameter's slice) or a saved payload."""
    if isinstance(state, Mapping):
        return state["model"], state["optimizer"]
    return state.state_dicts()


def _tensors(model_sd, optim_sd) -> Iterator[Tuple[str, torch.Tensor]]:
    for k, v in model_sd.items():
        yield f"model.{k}", v
    for i, st in optim_sd.get("state", {}).items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                yield f"optimizer.state.{i}.{k}", v


def verify_state(state, template, sample_every: int = _SAMPLE_EVERY) -> None:
    """Raise CheckpointIntegrityError unless ``state`` (a TrainState or a
    saved payload) matches ``template``'s (a TrainState) model and
    optimizer state dicts — keys, shapes, dtypes; each Adam moment shaped
    like its parameter — and passes a finiteness sample."""
    got_m, got_o = _state_dicts(state)
    want_m, want_o = _state_dicts(template)
    if set(got_m) != set(want_m):
        missing = sorted(set(want_m) - set(got_m))[:4]
        extra = sorted(set(got_m) - set(want_m))[:4]
        raise CheckpointIntegrityError(
            f"model keys differ: missing {missing}, unexpected {extra}")
    for k, ref in want_m.items():
        leaf = got_m[k]
        if (not isinstance(leaf, torch.Tensor)
                or tuple(leaf.shape) != tuple(ref.shape)
                or leaf.dtype != ref.dtype):
            raise CheckpointIntegrityError(
                f"model.{k}: {getattr(leaf, 'dtype', type(leaf))} "
                f"{tuple(getattr(leaf, 'shape', ()))} != expected "
                f"{ref.dtype} {tuple(ref.shape)}")

    # the optimizer: one group over the template's parameters, each
    # parameter's moments (when it has any) shaped and typed like it
    params = list(template.optimizer.param_groups[0]["params"])
    groups = got_o.get("param_groups")
    want_ids = [g["params"] for g in want_o["param_groups"]]
    if not groups or [g.get("params") for g in groups] != want_ids:
        raise CheckpointIntegrityError(
            "optimizer parameter groups differ from the template's")
    for i, st in got_o.get("state", {}).items():
        if not 0 <= int(i) < len(params):
            raise CheckpointIntegrityError(
                f"optimizer state for unknown parameter {i}")
        ref = params[int(i)]
        for k, v in st.items():
            if (isinstance(v, torch.Tensor) and v.dim() > 0
                    and (tuple(v.shape) != tuple(ref.shape)
                         or v.dtype != ref.dtype)):
                raise CheckpointIntegrityError(
                    f"optimizer.state.{i}.{k}: {v.dtype} {tuple(v.shape)} "
                    f"!= parameter {ref.dtype} {tuple(ref.shape)}")

    floats = [(k, v) for k, v in _tensors(got_m, got_o)
              if v.is_floating_point()]
    sample = floats[::max(1, sample_every)]
    if floats:
        largest = max(floats, key=lambda e: e[1].numel())
        if all(largest[0] != k for k, _ in sample):
            sample.append(largest)
    for k, v in sample:
        # |x|.sum() is finite iff every element is (inf and nan both
        # survive the reduction) — one scalar read per sampled tensor
        if not torch.isfinite(v.abs().sum()):
            raise CheckpointIntegrityError(
                f"{k} contains non-finite values")


def restore_verified(
    directory: str,
    template,
    step: Optional[int] = None,
    verbose: bool = True,
    clean_debris: bool = False,
    delete_bad: bool = True,
) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore the newest step (<= ``step`` if given) that passes
    verification into ``template`` (a TrainState, in place), falling back
    step by step. Returns (state, step, the step's ``extra``: the data
    stream's position, which the port keeps inside the checkpoint).

    clean_debris=True additionally sweeps uncommitted-flush tmp dirs —
    pass it ONLY from the directory's writer (the trainer recovering
    its own run): a reader must never delete what may be another
    process's in-flight flush. Readers still get the debris REPORTED,
    so a crashed run's leftovers are visible wherever they are seen.

    delete_bad=False leaves the steps that fail verification in place
    (a data-parallel run's non-writing ranks: rank 0 deletes them).

    Raises CheckpointIntegrityError when every candidate fails —
    crashing with the full skip list beats silently training from a
    fresh init under a name that has checkpoints.
    """
    # barrier FIRST: an in-flight async flush of our own must commit
    # before the debris sweep below — its live tmp dir is not debris
    ckpt.wait_pending(directory)
    if clean_debris:
        clean_uncommitted(directory, verbose=verbose)
    elif verbose:
        debris = uncommitted_flushes(directory)
        if debris:
            print(f"[resilience] {len(debris)} uncommitted flush(es) "
                  f"under {directory} (crash mid-save; left in place — "
                  f"only the writing trainer cleans them): {debris}",
                  flush=True)
    steps = sorted(ckpt.all_steps(directory), reverse=True)
    if step is not None:
        steps = [s for s in steps if s <= step]
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")

    skipped = []
    for s in steps:
        try:
            payload = ckpt.load_state_payload(template, directory, step=s)
            verify_state(payload, template)
        except Exception as e:  # torch.load raises many types on bad input
            skipped.append((s, e))
            if verbose:
                print(f"[resilience] checkpoint {directory} step {s} failed "
                      f"verification ({type(e).__name__}: {e}); trying the "
                      f"previous step", flush=True)
            continue
        saved, own = payload.get("fsdp"), ckpt.layout_of(template)
        state, extra = ckpt.apply_payload(template, payload)
        if saved != own and verbose:
            print(f"[resilience] step {s} was saved "
                  f"{ckpt.describe_layout(saved)}; restored into this "
                  f"run's layout ({ckpt.describe_layout(own)})", flush=True)
        for bad, _ in (skipped if delete_bad else ()):
            # remove what failed verification: a damaged step left behind
            # would stay the directory's newest until training re-saves
            # that step number (see module docstring)
            ckpt.delete_step(directory, bad)
        if skipped and verbose:
            print(f"[resilience] restored step {s} after skipping "
                  f"{len(skipped)} bad step(s)"
                  f"{' (now deleted)' if delete_bad else ''}: "
                  f"{[b for b, _ in skipped]}", flush=True)
        return state, s, extra
    raise CheckpointIntegrityError(
        f"no restorable checkpoint under {directory}: all of "
        f"{[b for b, _ in skipped]} failed verification "
        f"(last error: {skipped[-1][1]})")
