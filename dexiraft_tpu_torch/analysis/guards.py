"""Runtime guards of the port: implicit host syncs and the recompile budget.

Counterpart of ``dexiraft_tpu/analysis/guards.py``, with its public names.
The static half (sources that sync or lock wrongly) is
``analysis/synclint.py`` and ``analysis/threadlint.py``; this module
catches what only shows at run time:

- **steady-state recompiles.** Eager PyTorch compiles nothing, but the
  port pays once per new signature what a compile costs: cuDNN's search
  over its deterministic algorithms at the first call of each conv shape
  on a thread (``train.step.eval_arithmetic``, a few hundred ms), and the
  kernel libraries' build or load (``ops.cuda_build``). The sites call
  :func:`note_compile` (the eval, encode and refine steps and the train
  step on each new key: thread (on a card), input shapes and dtypes, TF32 flag,
  precision, remat policy, iteration count; ``cuda_build`` on each
  library build or load), and :func:`compile_count` is their
  process-wide total. A CUDA-graph capture would be one more feed.
- **implicit host syncs.** A ``float()``/``.item()``/``.cpu()`` on the
  wrong tensor stalls the host behind the device every step.
  ``torch.cuda.set_sync_debug_mode("error")`` makes PyTorch raise at such
  a call; the explicit spellings :func:`fetch` (``jax.device_get``'s
  counterpart) and :func:`put` (``jax.device_put``'s) open a sanctioned
  sync window and pass, as does any code under :func:`sync_window`.

``strict_mode()`` arms both and raises on a violation: ``--strict`` in the
train, eval and serve CLIs. ``RecompileWatch`` observes without raising:
it gives non-strict runs their one-line drift warning.

The sync half acts on CUDA only: on a CPU device ``strict_mode`` arms the
recompile half and sets no sync mode. Known blind spot, accepted: the sync
debug mode is process-global (``jax.transfer_guard`` is per thread), so
while any thread has a sync window open, every thread's implicit syncs
pass. Windows are as short as the copies they cover, and an implicit sync
on a steady-state path recurs, so the next one outside a window raises.
PyTorch's mode itself does not see every sync: on an H100 (torch 2.11)
``.item()``, ``float(t)``, ``.cpu()``, ``torch.tensor(x, device=...)``, a
blocking host->device copy, a stream's ``synchronize()``, ``nonzero`` and
boolean indexing raised, while ``torch.cuda.synchronize()``, an event's
``synchronize()`` and a ``non_blocking`` copy from pageable memory passed.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from dexiraft_tpu_torch.serve.locks import OrderedLock

#: strict_mode's ``transfer`` levels -> torch.cuda's sync debug modes
TRANSFER_LEVELS = {"allow": "default", "log": "warn", "disallow": "error"}

# the process-wide compile counter and sync-window bookkeeping
_lock = OrderedLock("analysis.guards.listener")
_count = 0
_by_kind: Dict[str, int] = {}
_syncs = 0            # sanctioned sync windows opened so far
_seen: set = set()    # keys note_new_key has counted
_armed: list = []     # open strict regions' (token, sync mode), newest last
_caller_mode: Optional[str] = None  # the mode before the first region
_windows = 0          # sync windows open now, on any thread
_applied: Optional[str] = None      # the mode last set here


class RecompileBudgetExceeded(RuntimeError):
    """Raised when a strict_mode region compiles past its pinned budget."""


def note_compile(kind: str) -> None:
    """Count one compile-like event (``kind``: "eval_step", "train_step",
    "encode", "refine", "kernel_build", ...)."""
    global _count
    with _lock:
        _count += 1
        _by_kind[kind] = _by_kind.get(kind, 0) + 1


def note_new_key(kind: str, key, per_thread: bool = True) -> bool:
    """Count a compile when ``(kind, key)`` is new to this process; True
    when it was. ``per_thread`` (a step on a CUDA device): the calling
    thread is part of the key, since cuDNN keeps its search results per
    thread and a known shape on a new thread is searched again."""
    global _count
    k = (kind, threading.get_ident() if per_thread else None, key)
    with _lock:
        if k in _seen:
            return False
        _seen.add(k)
        _count += 1
        _by_kind[kind] = _by_kind.get(kind, 0) + 1
    return True


def compile_count() -> int:
    """Compile-like events observed in this process so far (monotone)."""
    with _lock:
        return _count


def counts() -> dict:
    """{"compiles": n, "by_kind": {...}, "sync_windows": n}: the totals a
    run reports (chip_smoke.py's ``strict`` record)."""
    with _lock:
        return {"compiles": _count, "by_kind": dict(_by_kind),
                "sync_windows": _syncs}


# ---- the sync half ------------------------------------------------------

def _get_sync_mode() -> str:
    return {0: "default", 1: "warn", 2: "error"}[
        torch.cuda.get_sync_debug_mode()]


def _set_sync_mode(mode: str) -> None:
    torch.cuda.set_sync_debug_mode(mode)


def _apply_locked() -> None:
    """Set the sync mode the open regions and windows call for (called
    with ``_lock`` held): the caller's own mode outside every region,
    "default" while a window is open, else the innermost region's."""
    global _applied
    if not _armed:
        return
    want = "default" if _windows else _armed[-1][1]
    if want != _applied:
        _set_sync_mode(want)
        _applied = want


@contextlib.contextmanager
def sync_window() -> Iterator[None]:
    """A sanctioned host sync: implicit syncs pass while any window is
    open (the sync-side twin of :meth:`RecompileWatch.sanctioned`, and of
    ``jax.transfer_guard("allow")``). Windows on several threads merge:
    the strict mode comes back when the last one closes."""
    global _windows, _syncs
    with _lock:
        _windows += 1
        _syncs += 1
        _apply_locked()
    try:
        yield
    finally:
        with _lock:
            _windows -= 1
            _apply_locked()


def _to_host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def fetch(tree):
    """The explicit device->host copy: every tensor of ``tree`` (a tensor,
    or dicts, lists and tuples of them) as a numpy array (bf16 as
    float32); other leaves pass. ``jax.device_get``'s counterpart: it
    syncs, in a sanctioned window."""
    with sync_window():
        return _to_host(tree)


def put(array, device: Union[str, torch.device]) -> torch.Tensor:
    """The explicit host->device copy of a numpy array (or CPU tensor):
    staged through pinned memory and moved with ``non_blocking=True``, so
    the host does not wait for the device. ``jax.device_put``'s
    counterpart. On the CPU the array's memory is shared."""
    dev = torch.device(device)
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(array))
    if dev.type != "cuda":
        return t.to(dev)
    with sync_window():
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)


def _arms_syncs(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


# ---- the recompile half -------------------------------------------------

class RecompileWatch:
    """Observe-only recompile sentinel for non-strict runs.

    Usage::

        watch = RecompileWatch("train")
        ... warmup (searches and builds expected) ...
        watch.mark_warm()
        ... steady state ...
        watch.warn_if_drifted()   # one line on stderr, once, if any
                                  # post-warmup compile happened

    ``mark_warm()`` may be called repeatedly (e.g. once per new bucket
    the caller *expects* to compile); drift is measured from the last
    call.
    """

    def __init__(self, label: str = "run", budget: int = 0):
        self.label = label
        self.budget = budget
        self._warm_at: Optional[int] = None
        self._warned = False
        # open sanctioned() windows (possibly on other threads): the
        # counter is process-global, so a check() racing an expected
        # compile in progress would read it as drift before the
        # window's exit shifts the baseline
        self._slock = OrderedLock("analysis.guards.watch")
        self._sanctioned_depth = 0
        self._win_base = 0   # compile_count at the 0->1 depth transition

    def mark_warm(self) -> None:
        # read and write under the window lock: a count read before it
        # can go stale against a concurrent sanctioned() exit's shift.
        # watch -> listener (compile_count) is LOCK_ORDER's direction.
        with self._slock:
            self._warm_at = compile_count()

    @property
    def drift(self) -> int:
        """Compiles since mark_warm() (0 before it is called)."""
        if self._warm_at is None:
            return 0
        return compile_count() - self._warm_at

    def check(self, budget: Optional[int] = None) -> None:
        """Raise :class:`RecompileBudgetExceeded` when drift exceeds the
        budget (defaults to the watch's own); defers while a sanctioned
        window is open."""
        budget = self.budget if budget is None else budget
        with self._slock:
            if self._sanctioned_depth > 0:
                # an open window (engines share one watch across
                # threads) shifts the baseline past its compiles on exit
                return
            d = self.drift
        if d > budget:
            raise RecompileBudgetExceeded(
                f"[guards] {self.label}: {d} compile(s) (cuDNN searches, "
                f"kernel builds) in a strict region with budget {budget} "
                f"— a new shape, dtype or thread after warm-up; "
                f"guards.counts() names their kinds")

    @contextlib.contextmanager
    def sanctioned(self) -> Iterator[None]:
        """Absorb the compiles of a sanctioned window.

        The baseline shifts by exactly the window's compile count, so
        drift outside the window still counts. No-op before
        ``mark_warm()``. While any window is open, concurrent
        :meth:`check`/:meth:`warn_if_drifted` calls defer. Overlapping
        windows (on several threads) merge into one span: the baseline
        snapshots at the 0->1 depth transition and shifts once at 1->0.

        Known blind spot, accepted: the counter is process-global, so
        another thread's genuine drift landing inside an open window is
        absorbed with it; steady-state drift recurs, so the next check
        outside a window catches a real leak."""
        with self._slock:
            if self._sanctioned_depth == 0:
                self._win_base = compile_count()
            self._sanctioned_depth += 1
        try:
            yield
        finally:
            with self._slock:
                self._sanctioned_depth -= 1
                if self._sanctioned_depth == 0 and self._warm_at is not None:
                    now = compile_count()
                    # capped at the current count: a mark_warm() inside
                    # the window must not compound with the shift
                    self._warm_at = min(self._warm_at
                                        + (now - self._win_base), now)

    def warn_if_drifted(self, file=None) -> bool:
        """One-line, once-only warning when post-warmup compiles exist.
        Returns True if drift was (ever) reported."""
        report = False
        with self._slock:
            if self._sanctioned_depth > 0:
                return self._warned
            d = self.drift
            if d > 0 and not self._warned:
                # claim the once-only slot under the lock; print after
                self._warned = True
                report = True
        if report:
            print(f"[guards] {self.label}: {d} recompile(s) after warmup "
                  f"(cuDNN searches or kernel builds) — shape, dtype or "
                  f"thread drift is costing time; rerun with --strict to "
                  f"fail fast", file=file or sys.stderr)
        return self._warned


@contextlib.contextmanager
def strict_mode(compile_budget: int = 0, transfer: str = "disallow",
                label: str = "strict", device=None
                ) -> Iterator[RecompileWatch]:
    """Arm the sync debug mode and the recompile sentinel for a region.

    Inside the region, on a CUDA device:
      - an implicit host sync (``.item()``, ``float(t)``, ``.cpu()``, a
        blocking copy) raises at the offending call (``transfer``
        "disallow"; "log" warns; "allow" arms nothing); :func:`fetch`,
        :func:`put` and :func:`sync_window` pass;
      - compiles are counted; leaving the region (or calling ``check()``
        on the yielded watch) raises :class:`RecompileBudgetExceeded` if
        more than ``compile_budget`` happened.

    ``device``: the device the region runs on (None: CUDA if there is
    one). On a CPU device only the recompile half is armed. The caller's
    sync mode is restored on exit, an exception included.

    The yielded :class:`RecompileWatch` is marked warm at entry;
    ``watch.mark_warm()`` absorbs an expected compile (a planned new
    shape) without widening the budget for the unplanned ones.
    """
    global _caller_mode, _applied
    if transfer not in TRANSFER_LEVELS:
        raise ValueError(f"transfer must be one of {sorted(TRANSFER_LEVELS)}"
                         f", got {transfer!r}")
    watch = RecompileWatch(label, budget=compile_budget)
    watch.mark_warm()
    token = object() if _arms_syncs(device) else None
    if token is not None:
        with _lock:
            if not _armed:
                _caller_mode = _applied = _get_sync_mode()
            _armed.append((token, TRANSFER_LEVELS[transfer]))
            _apply_locked()
    try:
        yield watch
    finally:
        if token is not None:
            with _lock:
                _armed[:] = [a for a in _armed if a[0] is not token]
                if _armed:
                    _apply_locked()
                else:
                    _set_sync_mode(_caller_mode)
                    _caller_mode = _applied = None
    watch.check()
