"""Hang watchdog: a stalled run exits loudly instead of hanging forever.

A copy of ``dexiraft_tpu/resilience/watchdog.py``. The failure mode
consensus (resilience.coord) cannot cover: a peer dies or stops INSIDE a
collective (the train step's gradient all-reduce, a synced BatchNorm's
statistics), and every surviving rank blocks in it with nothing
scheduled to time out for the process group's half hour. The job looks
alive to the orchestrator while every card idles.

``HangWatchdog`` is a daemon monitor thread armed around each step (and
any other region that must make progress: checkpoint barriers, emergency
saves, validation). If an armed region exceeds ``timeout_s`` the
watchdog dumps the step index, the region name, the collective flight
recorder's tail and the LIVE stack traces of every thread
(faulthandler: the collective the process is stuck in is right there in
the dump), then ``os._exit``s with STALL_EXIT_CODE so the orchestrator
restarts the job instead of billing a hung one. Exit, not an exception:
the stalled thread cannot raise, it is blocked in C.

Straggler detection rides the same timer: the watchdog keeps an EWMA of
completed region durations, and an in-flight region exceeding
``straggler_factor`` x the EWMA gets a one-line warning (once per
region) long before the hard timeout: the early signature of a slow
rank, a throttled card, or a degrading disk.

The clock and the exit are injectable so tests drive the whole protocol
with a fake clock instead of real multi-second sleeps. The JAX
watchdog's elastic handoff (``on_stall``) comes with elastic membership
(ROADMAP A12).
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

from dexiraft_tpu_torch.serve.locks import OrderedLock

STALL_EXIT_CODE = 98


class HangWatchdog:
    """Arm/disarm around regions that must make progress; see module doc.

    timeout_s <= 0 constructs an inert watchdog (arm/disarm are no-ops,
    no thread) so callers can wire it unconditionally.
    """

    def __init__(self, timeout_s: float, straggler_factor: float = 10.0,
                 ewma_alpha: float = 0.1, label: str = "train",
                 poll_s: Optional[float] = None,
                 slow_region_factor: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 exit_fn: Callable[[int], None] = os._exit,
                 stream=None):
        self.timeout_s = float(timeout_s)
        self.straggler_factor = float(straggler_factor)
        # sanctioned slow regions (steady=False: checkpoint barrier,
        # validation, restore) are legitimately much longer than a
        # step; they get timeout_s x this factor before the stall
        # fires, so a step-sized --stall_timeout never kills a healthy
        # validation sweep
        self.slow_region_factor = float(slow_region_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.label = label
        self.poll_s = (poll_s if poll_s is not None
                       else max(0.05, min(1.0, self.timeout_s / 20)))
        self._clock = clock
        self._exit = exit_fn
        self._stream = stream
        self.ewma_s: Optional[float] = None
        self.fired = False
        self.straggler_warnings = 0
        self._lock = OrderedLock("resilience.watchdog.armed")
        self._armed: Optional[tuple] = None  # (step, region, t0, warned)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HangWatchdog":
        if self.enabled and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"watchdog[{self.label}]",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- arming ------------------------------------------------------------
    def arm(self, step: int, region: str = "step",
            steady: bool = True) -> None:
        """The region begins now; the monitor times it from this call.

        steady=False marks a sanctioned slow region (checkpoint
        barrier, validation, rollback restore): the hard stall timeout
        still applies, but the region neither feeds the step-time EWMA
        nor gets compared against it for straggler warnings — a
        legitimately slow validation window is not a slow rank."""
        if not self.enabled:
            return
        with self._lock:
            self._armed = (int(step), region, self._clock(), False,
                           bool(steady))

    def disarm(self, feed_ewma: bool = True) -> Optional[float]:
        """The region completed; returns its duration. The duration
        feeds the straggler EWMA only for steady regions (and
        feed_ewma=False opts a steady region out, e.g. a partial
        iteration)."""
        if not self.enabled:
            return None
        with self._lock:
            if self._armed is None:
                return None
            _, _, t0, _, steady = self._armed
            self._armed = None
        dt = self._clock() - t0
        if not (feed_ewma and steady):
            return dt
        with self._lock:
            # under the lock: the monitor thread reads ewma_s for the
            # straggler floor every poll, and an unlocked read-blend-
            # write here can resurrect a stale EWMA over a fresh one
            if self.ewma_s is None:
                self.ewma_s = dt
            else:
                a = self.ewma_alpha
                self.ewma_s = (1 - a) * self.ewma_s + a * dt
        return dt

    # -- monitor -----------------------------------------------------------
    def check_once(self) -> Optional[str]:
        """One monitor poll (the thread's body; tests call it directly).
        Returns "stall" / "straggler" / None for what it observed."""
        with self._lock:
            armed = self._armed
        if armed is None:
            return None
        step, region, t0, warned, steady = armed
        dt = self._clock() - t0
        limit = self.timeout_s * (1.0 if steady
                                  else self.slow_region_factor)
        if dt > limit:
            self._fire(step, region, dt, limit)
            return "stall"
        if not steady:
            return None  # sanctioned slow region: (scaled) stall bound only
        floor = self.straggler_factor * self.ewma_s if self.ewma_s else None
        if floor is not None and dt > floor and not warned:
            with self._lock:
                # re-check under the lock: disarm/arm may have raced
                if self._armed == armed:
                    self._armed = (step, region, t0, True, steady)
                    self.straggler_warnings += 1
                    print(f"[watchdog:{self.label}] straggler: {region} at "
                          f"step {step} running {dt:.1f}s "
                          f"(EWMA {self.ewma_s:.2f}s, warn at "
                          f"{self.straggler_factor:.0f}x); stall timeout "
                          f"at {self.timeout_s:.0f}s",
                          file=self._stream or sys.stderr, flush=True)
            return "straggler"
        return None

    def _fire(self, step: int, region: str, dt: float,
              limit: Optional[float] = None) -> None:
        out = self._stream or sys.stderr
        self.fired = True
        print(f"[watchdog:{self.label}] STALL: {region} at step {step} "
              f"has made no progress for {dt:.1f}s "
              f"(timeout {limit if limit is not None else self.timeout_s:.0f}s)"
              f" — dumping live stacks "
              f"and exiting {STALL_EXIT_CODE} instead of hanging the job"
              f" (a rank lost mid-collective?)",
              file=out, flush=True)
        # the collective flight-recorder tail FIRST: a stall inside a
        # consensus/barrier names the namespace+round it died in (the
        # faulthandler stacks below then show WHERE it is blocked)
        try:
            from dexiraft_tpu_torch.analysis import collective_trace

            print(collective_trace.recorder().render_tail(),
                  file=out, flush=True)
        except Exception:
            pass
        try:
            faulthandler.dump_traceback(file=out)
            out.flush()
        except Exception:
            pass
        self._exit(STALL_EXIT_CODE)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check_once()
