"""Graceful-preemption signal handling for the training loop.

A copy of ``dexiraft_tpu/resilience/preemption.py``. A cloud
preemption (and any orchestrator teardown, torchrun's included) arrives
as SIGTERM with a grace window; an interactive operator sends SIGINT.
Either would kill the run wherever it stood, losing up to val_freq steps
of work and any data-stream position. The handler converts the FIRST
signal into a flag the train loop polls at step boundaries, where it
performs one final atomic emergency save (still guard-checked: a
poisoned state is never saved, preempted or not) and exits cleanly.

A SECOND signal raises KeyboardInterrupt immediately: if the emergency
save itself wedges (hung filesystem), the operator can still get out.

Installation is a context manager so nested/sequential uses restore the
previous handlers, and it degrades to an inert no-op off the main thread
(Python only allows signal handlers there) — library callers embedding
the trainer in a worker thread keep the old die-on-signal behavior
rather than getting a crash at install time.
"""

from __future__ import annotations

import signal
from typing import Optional, Tuple


class PreemptionHandler:
    """Latch SIGTERM/SIGINT into a poll-able flag (see module docstring)."""

    def __init__(self, signums: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signums = signums
        self.triggered = False
        self.signum: Optional[int] = None
        self._previous: dict = {}

    @property
    def signal_name(self) -> str:
        if self.signum is None:
            return "none"
        try:
            return signal.Signals(self.signum).name
        except ValueError:
            return str(self.signum)

    def _handle(self, signum, frame) -> None:
        if self.triggered:
            # second signal: the graceful path is stuck — bail hard
            raise KeyboardInterrupt(
                f"second {self.signal_name} during preemption handling")
        self.triggered = True
        self.signum = signum
        print(f"[preempt] received {self.signal_name}; finishing the "
              f"current step, then saving an emergency checkpoint "
              f"(signal again to abort immediately)", flush=True)

    def __enter__(self) -> "PreemptionHandler":
        for signum in self.signums:
            try:
                self._previous[signum] = signal.signal(signum, self._handle)
            except ValueError:
                # not the main thread: signals can't be installed; stay inert
                self._previous.pop(signum, None)
        return self

    def __exit__(self, *exc) -> None:
        for signum, prev in self._previous.items():
            try:
                signal.signal(signum, prev)
            except ValueError:
                pass
        self._previous.clear()
        return None
