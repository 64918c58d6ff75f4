"""SLO-aware request scheduler: the queue between HTTP handlers and the
engine.

Counterpart of ``dexiraft_tpu/serve/scheduler.py``, its decision logic
copied unchanged (``poll_once``, ``_select``, ``_iter_budget``, the EWMA
of service time that leaves out ``engine.compile_s``, which in the port
is the first dispatch's cuDNN search). The description below is the JAX
module's; "compile" reads "cuDNN's search" here.

The InferenceEngine batches a stream it can SEE (eval hands it the whole
dataset); a service only sees requests as they arrive. The scheduler
turns arrivals into engine batches under a latency contract:

  * per-bucket FIFO queues — only same-bucket requests can share an
    executable, so the queue is keyed by the same quantized shape the
    engine compiles for (buckets.bucket_shape; no registry state is
    touched from handler threads).
  * dispatch a FULL batch the moment a bucket reaches batch_size — the
    throughput-optimal case, identical to eval's grouping.
  * dispatch a PARTIAL batch when the oldest queued request's latency
    budget says waiting any longer would miss it: each bucket keeps an
    EWMA of its measured service time (compile time excluded — a fresh
    bucket's first batch would otherwise poison the estimate by 100x),
    and the head request's dispatch deadline is
    ``t_submit + max(0, slo - est_service)``. Before the first
    measurement the estimate is slo/2 — early traffic errs toward
    dispatching small batches rather than missing its budget while the
    scheduler is still learning.
  * bounded queue — past ``max_queue`` waiting requests, submit raises
    QueueFull and the server answers 503. Under overload the service
    sheds load at admission instead of stretching everyone's latency
    (goodput stays flat instead of collapsing; serve_bench --closed_loop
    measures exactly this).
  * adaptive iteration budgets (``adaptive=True``, engine built with
    ServeConfig(adaptive=True)) — each dispatch carries an iteration
    budget derived from the head request's REMAINING latency budget and
    the queue's overload state: ``affordable = remaining_slo /
    per_iter_est`` (a per-bucket EWMA of measured seconds-per-iteration)
    capped by ``max_iters * (1 - queue_pressure)``, floored at
    ``min_iters``. Under overload the service degrades refinement depth
    smoothly (every admitted request still gets >= min_iters of real
    work) BEFORE admission control starts shedding — a second, softer
    valve ahead of the 503. Budgets are per-BATCH (the engine's
    while_loop runs one budget per dispatch); convergence still exits
    items early below the budget.
  * drain — ``drain()`` flips every queue to dispatch-immediately and
    blocks until empty: the SIGTERM path finishes every admitted request
    before the process exits, and new submits are refused.

Exactly ONE dispatcher thread calls into the engine (it is not
thread-safe and the device wants one in-order submission stream);
handler threads only enqueue and wait on their request's event. The
decision logic is separated from the thread (``poll_once``) so tests
drive it with a fake clock, deterministically.

Like the engine, the scheduler is unit-testable with a numpy stub
eval_fn.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from dexiraft_tpu_torch.serve.buckets import bucket_shape
from dexiraft_tpu_torch.serve.engine import InferenceEngine, Result
from dexiraft_tpu_torch.serve.locks import OrderedLock

# EWMA weight for new service-time samples: heavy enough to track a
# warming cache, light enough that one slow batch doesn't collapse the
# hold window
_EWMA = 0.3
_PCTL_WINDOW = 4096  # bounded sample windows, same rationale as ServeStats


class QueueFull(RuntimeError):
    """Admission refused: max_queue requests already waiting (503)."""


class SchedulerClosed(RuntimeError):
    """Submit after drain/close began: the service is shutting down."""


class SchedulerStats:
    """Counter block the /stats endpoint and serve_bench serialize.

    dispatch_full / dispatch_slo / dispatch_drain partition every batch
    by WHY it left the queue: bucket filled, latency budget said go, or
    shutdown flush. A high slo share at high load means batch_size or
    slo_ms is mis-tuned (batches never fill); a high full share at low
    concurrency means the SLO hold is queueing requests it should
    release.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.submitted = 0
        self.completed = 0
        self.failed = 0          # engine raised; error re-raised to callers
        self.rejected = 0        # QueueFull admissions
        self.dispatch_full = 0
        self.dispatch_slo = 0
        self.dispatch_drain = 0
        self.queue_peak = 0
        self.batch_fill = 0      # real (non-pad) requests dispatched
        self.wait_s: "collections.deque" = collections.deque(
            maxlen=_PCTL_WINDOW)
        self.latency_s: "collections.deque" = collections.deque(
            maxlen=_PCTL_WINDOW)
        # adaptive mode only: the iteration budget each dispatched batch
        # was granted (empty on fixed-iteration schedulers) — /stats
        # reports p50/p99 so an operator can SEE the degradation valve
        # working under load
        self.iter_budget: "collections.deque" = collections.deque(
            maxlen=_PCTL_WINDOW)

    @staticmethod
    def _pctl(samples, p: float) -> float:
        if not samples:
            return 0.0
        return float(np.percentile(samples, p))

    @classmethod
    def _pctl_ms(cls, samples, p: float) -> float:
        return cls._pctl(samples, p) * 1e3

    def record(self) -> dict:
        batches = (self.dispatch_full + self.dispatch_slo
                   + self.dispatch_drain)
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "rejected": self.rejected,
            "dispatch_full": self.dispatch_full,
            "dispatch_slo": self.dispatch_slo,
            "dispatch_drain": self.dispatch_drain,
            "queue_peak": self.queue_peak,
            "mean_batch_fill": (round(self.batch_fill / batches, 2)
                                if batches else 0.0),
            "wait_p50_ms": round(self._pctl_ms(self.wait_s, 50), 2),
            "wait_p99_ms": round(self._pctl_ms(self.wait_s, 99), 2),
            "latency_p50_ms": round(self._pctl_ms(self.latency_s, 50), 2),
            "latency_p99_ms": round(self._pctl_ms(self.latency_s, 99), 2),
        }


class _Request:
    __slots__ = ("item", "bucket", "t_submit", "event", "result", "error")

    def __init__(self, item: Dict[str, Any], bucket: Tuple[int, int],
                 t_submit: float):
        self.item = item
        self.bucket = bucket
        self.t_submit = t_submit
        self.event = threading.Event()
        self.result: Optional[Result] = None
        self.error: Optional[BaseException] = None


class Scheduler:
    """Request queue + SLO-aware dynamic batching over one engine."""

    def __init__(self, engine: InferenceEngine, *,
                 slo_ms: float = 200.0,
                 max_queue: int = 64,
                 adaptive: bool = False,
                 max_iters: int = 32,
                 min_iters: int = 4,
                 clock: Callable[[], float] = time.monotonic):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if adaptive:
            if not engine.config.adaptive:
                raise ValueError(
                    "Scheduler(adaptive=True) needs an adaptive engine — "
                    "build it with ServeConfig(adaptive=True) and "
                    "make_eval_step(adaptive=True)")
            if not 1 <= min_iters <= max_iters:
                raise ValueError(
                    f"need 1 <= min_iters <= max_iters, got "
                    f"min_iters={min_iters} max_iters={max_iters}")
        self.engine = engine
        self.slo_s = slo_ms / 1e3
        self.max_queue = max_queue
        # adaptive budget policy knobs: max_iters mirrors the step's
        # configured full iteration count (the budget is CLAMPED there
        # again inside the while_loop, so a mismatch degrades safely);
        # min_iters is the quality floor no overload can push below
        self.adaptive = adaptive
        self.max_iters = max_iters
        self.min_iters = min_iters
        self.clock = clock
        self.stats = SchedulerStats()
        # called in the DISPATCHER thread after each successful batch,
        # with (bucket, results) — the one place extra per-bucket device
        # work (e.g. the server's carry-splat warm compile) can run with
        # a guarantee that no other dispatch is concurrent
        self.post_dispatch: Optional[
            Callable[[Tuple[int, int], List[Result]], None]] = None
        # the condition's lock is a named, REENTRANT OrderedLock: the
        # quiesced /stats snapshot re-enters it (run_quiesced ->
        # stats_record), and naming it puts every queue-lock nesting
        # (cv -> sessions/video stats in the service's quiesced reset)
        # under the declared LOCK_ORDER
        self._cv = threading.Condition(
            OrderedLock("serve.scheduler.cv", reentrant=True))
        self._running = False        # dispatcher currently inside _run()
        self._quiesce_waiters = 0    # run_quiesced() callers pending
        self._queues: Dict[Tuple[int, int], "collections.deque[_Request]"] \
            = {}
        self._pending = 0
        self._dispatched = 0   # popped for a batch, result not yet set
        self._service_s: Dict[Tuple[int, int], float] = {}
        # adaptive mode: per-bucket EWMA of measured seconds PER
        # REFINEMENT ITERATION (batch service time / iterations the
        # while_loop actually ran) — the unit the SLO budget divides by
        self._iter_s: Dict[Tuple[int, int], float] = {}
        self._draining = False
        self._closed = False
        self._drained = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- submission side (any thread) ----------------------------------

    def submit_async(self, item: Dict[str, Any]) -> _Request:
        """Admit one request; returns a handle whose ``event`` fires when
        ``result`` (or ``error``) is set. Raises QueueFull / Scheduler-
        Closed instead of queueing what the service cannot honor."""
        cfg = self.engine.config
        h, w = np.shape(item["image1"])[:2]
        bucket = bucket_shape(h, w, cfg.stride, cfg.bucket_multiple)
        with self._cv:
            if self._closed or self._draining:
                raise SchedulerClosed("scheduler is draining/closed")
            if self._pending >= self.max_queue:
                self.stats.rejected += 1
                raise QueueFull(
                    f"{self._pending} requests already queued "
                    f"(max_queue={self.max_queue})")
            req = _Request(item, bucket, self.clock())
            self._queues.setdefault(bucket, collections.deque()).append(req)
            self._pending += 1
            self.stats.submitted += 1
            self.stats.queue_peak = max(self.stats.queue_peak, self._pending)
            self._cv.notify()
        return req

    def submit(self, item: Dict[str, Any],
               timeout: Optional[float] = None) -> Result:
        """Blocking submit: admit, wait, return the Result (or re-raise
        the batch's engine error in the caller's thread). On timeout the
        request is CANCELLED out of its queue — a caller that already
        answered 504 must not leave the engine computing flow for a dead
        request (under overload with client timeouts that zombie work
        would eat exactly the capacity admission control protects)."""
        req = self.submit_async(item)
        if not req.event.wait(timeout):
            with self._cv:
                q = self._queues.get(req.bucket)
                if q is not None and req in q:
                    q.remove(req)
                    self._pending -= 1
            # re-check under no lock: the dispatcher may have taken the
            # request between the failed wait and the cancellation
            if not req.event.is_set():
                raise TimeoutError(
                    f"request not served within {timeout}s (bucket "
                    f"{req.bucket}; queue depth {self.queue_depth()})")
        if req.error is not None:
            raise req.error
        return req.result

    def queue_depth(self) -> int:
        with self._cv:
            return self._pending

    def inflight(self) -> int:
        """Admitted-but-unanswered requests: queued PLUS mid-dispatch.
        The /healthz readiness payload reports this so a router's drain
        can wait for genuinely-zero outstanding work — queue_depth alone
        goes to 0 the moment the last batch is TAKEN, while its
        requests are still computing in the engine."""
        with self._cv:
            return self._pending + self._dispatched

    # ---- dispatch decision (dispatcher thread / tests) ------------------

    def _hold_s(self, bucket: Tuple[int, int]) -> float:
        est = self._service_s.get(bucket, self.slo_s * 0.5)
        return max(0.0, self.slo_s - est)

    def _select(self, now: float):
        """Under self._cv. Returns (bucket, 0.0) when a batch should go
        NOW, (None, wait_s) when the earliest deadline is wait_s away,
        (None, None) when every queue is empty."""
        bs = self.engine.config.batch_size
        best: Optional[Tuple[float, Tuple[int, int]]] = None
        for bucket, q in self._queues.items():
            if not q:
                continue
            if len(q) >= bs or self._draining or self._closed:
                return bucket, 0.0
            deadline = q[0].t_submit + self._hold_s(bucket)
            if best is None or deadline < best[0]:
                best = (deadline, bucket)
        if best is None:
            return None, None
        if now >= best[0]:
            return best[1], 0.0
        return None, best[0] - now

    def _take(self, bucket: Tuple[int, int]):
        """Under self._cv: pop up to batch_size requests off a bucket."""
        bs = self.engine.config.batch_size
        q = self._queues[bucket]
        group = [q.popleft() for _ in range(min(len(q), bs))]
        self._pending -= len(group)
        self._dispatched += len(group)
        return group, len(group) == bs

    def _iter_budget(self, bucket: Tuple[int, int], group: List["_Request"],
                     now: float) -> Optional[int]:
        """Under self._cv, after _take. SLO + overload state → this
        dispatch's iteration budget (None on fixed schedulers).

        Two pressures compound, both clamped to the [min_iters,
        max_iters] band:
          * affordable — the batch head's (oldest request's) remaining
            SLO divided by the bucket's learned seconds-per-iteration.
            Before the first measurement this is max_iters: early
            batches run at full depth so the estimate learns the true
            per-iteration cost, not a degraded one.
          * pressure — queued/max_queue scales the cap linearly down
            from max_iters toward the floor, so depth degrades SMOOTHLY
            as the queue fills instead of binary full-depth-then-503.
        """
        if not self.adaptive:
            return None
        full = self.max_iters
        remaining = max(0.0, self.slo_s - (now - group[0].t_submit))
        per_iter = self._iter_s.get(bucket)
        affordable = (full if per_iter is None or per_iter <= 0
                      else remaining / per_iter)
        pressure = min(1.0, self._pending / self.max_queue)
        budget = int(min(affordable, full * (1.0 - pressure)))
        return max(self.min_iters, min(full, budget))

    def poll_once(self) -> bool:
        """One dispatch decision + (if due) one engine batch. The unit
        tests' deterministic entry point; the dispatcher thread is this
        in a loop with cv waiting in between."""
        with self._cv:
            now = self.clock()
            bucket, _wait = self._select(now)
            if bucket is None:
                return False
            group, full = self._take(bucket)
            budget = self._iter_budget(bucket, group, now)
        self._run(bucket, group, full, budget)
        return True

    # ---- dispatch execution (dispatcher thread only) --------------------

    def _run(self, bucket: Tuple[int, int], group: List[_Request],
             full: bool, budget: Optional[int] = None) -> None:
        try:
            self._run_inner(bucket, group, full, budget)
        finally:
            with self._cv:
                self._dispatched -= len(group)
                self._cv.notify_all()   # inflight()==0 pollers re-check

    def _run_inner(self, bucket: Tuple[int, int], group: List[_Request],
                   full: bool, budget: Optional[int] = None) -> None:
        st = self.stats
        t0 = self.clock()
        # counter bumps take the cv: handler threads mutate the same
        # SchedulerStats under it (submit/reject paths) and /stats reads
        # it — a bare dispatcher-side += is the RouterStats undercount
        # bug (threadlint JL021). The ENGINE call below stays outside
        # the lock: blocking a whole batch's device time under the cv
        # would stall every submit (JL023).
        with self._cv:
            if full:
                st.dispatch_full += 1
            elif self._draining or self._closed:
                st.dispatch_drain += 1
            else:
                st.dispatch_slo += 1
            st.batch_fill += len(group)
            for r in group:
                st.wait_s.append(t0 - r.t_submit)
            if budget is not None:
                st.iter_budget.append(budget)
        compile0 = self.engine.compile_s
        try:
            results = self.engine.run_batch([r.item for r in group],
                                            iter_budget=budget)
        except Exception as e:
            with self._cv:
                st.failed += len(group)
            for r in group:
                r.error = e
                r.event.set()
            return
        # service estimate excludes this batch's compile share: the
        # first batch on a fresh bucket traces+compiles synchronously,
        # and folding that into the EWMA would pin the hold window at 0
        # for the rest of the process life
        dt = (self.clock() - t0
              - max(0.0, self.engine.compile_s - compile0))
        with self._cv:
            prev = self._service_s.get(bucket)
            self._service_s[bucket] = (dt if prev is None
                                       else (1 - _EWMA) * prev + _EWMA * dt)
            if budget is not None:
                # the while_loop ran max(iters_used) steps, not the full
                # budget — divide by what EXECUTED so early-converging
                # batches don't inflate the per-iteration estimate
                ran = max((r.iters_used for r in results
                           if r.iters_used is not None), default=budget)
                if ran and ran > 0:
                    per = dt / ran
                    prevp = self._iter_s.get(bucket)
                    self._iter_s[bucket] = (
                        per if prevp is None
                        else (1 - _EWMA) * prevp + _EWMA * per)
        if self.post_dispatch is not None:
            # BEFORE the events fire: a waiter acting on its result
            # (e.g. the server's carry splat) must find whatever this
            # hook compiles already compiled
            try:
                self.post_dispatch(bucket, results)
            except Exception as e:
                print(f"[scheduler] post_dispatch hook failed: "
                      f"{type(e).__name__}: {e}", flush=True)
        now = self.clock()
        with self._cv:
            for r in group:
                st.latency_s.append(now - r.t_submit)
            st.completed += len(group)
        for r, res in zip(group, results):
            r.result = res
            r.event.set()

    def _loop(self) -> None:
        while True:
            with self._cv:
                self._running = False
                self._cv.notify_all()   # wake run_quiesced waiters
                while self._quiesce_waiters:
                    # yield to pending quiesced sections: under
                    # saturation the dispatcher would otherwise re-take
                    # work while still holding the lock and starve them
                    self._cv.wait(timeout=0.05)
                while True:
                    now = self.clock()
                    bucket, wait = self._select(now)
                    if bucket is not None:
                        group, full = self._take(bucket)
                        budget = self._iter_budget(bucket, group, now)
                        self._running = True
                        break
                    if self._pending == 0:
                        if self._closed:
                            self._drained.set()
                            return
                        if self._draining:
                            self._drained.set()
                    self._cv.wait(timeout=wait)
            self._run(bucket, group, full, budget)

    def run_quiesced(self, fn: Callable[[], None]) -> None:
        """Run `fn` while the dispatcher provably is NOT inside the
        engine: holding the lock keeps it from taking new work, and the
        _running flag excludes a batch already in flight. The /stats
        reset path uses this so zeroing engine.compile_s can never race
        a dispatch's read-modify-write (a mid-batch reset would fold a
        whole compile span into the bucket's EWMA service estimate)."""
        with self._cv:
            self._quiesce_waiters += 1
            try:
                while self._running:
                    self._cv.wait(timeout=0.05)
                fn()
            finally:
                self._quiesce_waiters -= 1
                self._cv.notify_all()

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "Scheduler":
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = threading.Thread(
            target=self._loop, name="flow-scheduler", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, dispatch everything queued (partial batches
        go immediately), return True when the queue hit empty."""
        with self._cv:
            self._draining = True
            if self._pending == 0 and self._thread is None:
                self._drained.set()
            self._cv.notify()
        return self._drained.wait(timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Drain, then stop the dispatcher thread."""
        self.drain(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    @property
    def draining(self) -> bool:
        return self._draining or self._closed

    def stats_record(self) -> dict:
        """SchedulerStats counters + live queue state + the learned
        per-bucket service estimates (the SLO policy's working memory)."""
        with self._cv:
            depth = self._pending
            inflight = self._pending + self._dispatched
            ests = {f"{h}x{w}": round(s * 1e3, 2)
                    for (h, w), s in sorted(self._service_s.items())}
            # counters snapshot under the same lock their writers hold
            # (submit paths and the dispatcher's bumps): no torn
            # completed-vs-latency combinations in a scrape
            counters = self.stats.record()
            budget_p50 = SchedulerStats._pctl(self.stats.iter_budget, 50)
            budget_p99 = SchedulerStats._pctl(self.stats.iter_budget, 99)
            iter_ests = {f"{h}x{w}": round(s * 1e3, 3)
                         for (h, w), s in sorted(self._iter_s.items())}
        rec = {
            **counters,
            "queue_depth": depth,
            "inflight": inflight,
            "slo_ms": round(self.slo_s * 1e3, 2),
            "max_queue": self.max_queue,
            "service_est_ms": ests,
            "draining": self.draining,
        }
        if self.adaptive:
            # adaptive keys only on adaptive schedulers: fixed-path
            # /stats and bench schema pins stay byte-identical
            rec.update(
                adaptive=True,
                min_iters=self.min_iters,
                max_iters=self.max_iters,
                iter_budget_p50=round(budget_p50, 2),
                iter_budget_p99=round(budget_p99, 2),
                iter_est_ms=iter_ests,
            )
        return rec
