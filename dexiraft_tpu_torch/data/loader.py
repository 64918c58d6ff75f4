"""Batch loader: deterministic shuffle, per-host sharding, threaded prefetch.

A copy of ``dexiraft_tpu/data/loader.py`` (its lock is the port's
``serve.locks.OrderedLock``, ranked in the same order). Replaces torch's
DataLoader (core/datasets.py:233-234: bs, shuffle, 4 workers, drop_last):
  * the global batch is SPLIT ACROSS HOSTS — each process decodes only its
    ``process_index`` slice (multi-host data parallelism without any data
    duplication; one process here, ROADMAP A12);
  * shuffling and augmentation are driven by counter-based PRNG streams
    keyed on (seed, epoch, global index) — any sample of any epoch is
    reproducible in isolation, unlike the reference's per-worker seeding;
  * a thread pool decodes ahead of the training step (the chips, not the
    host, should be the bottleneck).

Fault tolerance (the resilience layer's data half): a decode failure —
corrupt PNG, truncated .flo, or a pool worker dying outright — degrades
throughput, never the run. Failed decodes get bounded retry with
backoff, then skip-and-count (the batch backfills from its surviving
samples, mirroring the inference engine's tail-pad); a broken process
pool is rebuilt in place. PipelineStats carries the counts to the
logger. Exact resume rides the same counter-based PRNG design:
``batches(start_epoch=, start_offset=)`` reproduces the stream from any
(epoch, global-batch offset) position.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import BrokenExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from dexiraft_tpu_torch.serve.locks import OrderedLock

Batch = Dict[str, np.ndarray]


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """THE deterministic global-shuffle contract of the data plane.

    The epoch-``epoch`` visit order over ``n`` samples is a pure function
    of ``(seed, epoch)``: stable across processes and platforms for a
    given numpy version, so a restarted process, a packer verifying host
    slices offline, and every host of a multi-host mesh all derive the
    SAME permutation with no communication. (NEP 19 reserves the right
    to change Generator streams between numpy feature releases — all
    hosts of one run, and a resumed run, must use the same numpy
    version, which any pinned pod image already guarantees.) Exact-resume (resilience.stream) and per-host input
    sharding (Loader.batches slicing host-disjoint windows of this
    order) both lean on this function and nothing else; it is pinned by
    tests/test_zzzdata_records.py including across a process restart.
    """
    order = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(order)
    return order


def world_compatible(batch_size: int, process_count: int) -> Optional[str]:
    """None when ``process_count`` hosts can slice a ``batch_size``
    global batch, else a one-line reason. The Loader constructor raises
    the same condition; this form lets elastic membership
    (resilience.membership) refuse a shrink target BEFORE tearing the
    old world down — the global-batch offsets in the stream sidecars
    are host-count-invariant precisely because every world slices the
    SAME global batch, so a world that cannot slice it evenly is not a
    resize, it is a different run."""
    if process_count < 1:
        return f"process_count must be positive, got {process_count}"
    if batch_size % process_count:
        return (f"global batch {batch_size} must divide over "
                f"{process_count} hosts")
    return None


def _stack(samples) -> Batch:
    keys = [k for k in samples[0] if k != "extra_info"]
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class PipelineStats:
    """Data-pipeline fault accounting (the loader analog of
    prefetch.PrefetchStats / profiling.ServeStats): every degradation
    the pipeline absorbed, countable, so a run that silently skipped
    half its data cannot masquerade as a healthy one."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.retries = 0          # decode re-submissions (incl. after a
                                  # pool rebuild)
        self.skipped_samples = 0  # samples abandoned after the retry
                                  # budget; their batch slot backfills
        self.dropped_batches = 0  # batches with NO surviving sample
        self.worker_restarts = 0  # decode-pool rebuilds (worker death)

    @property
    def faults(self) -> int:
        return (self.retries + self.skipped_samples + self.dropped_batches
                + self.worker_restarts)

    def as_dict(self) -> Dict[str, int]:
        return {"retries": self.retries,
                "skipped_samples": self.skipped_samples,
                "dropped_batches": self.dropped_batches,
                "worker_restarts": self.worker_restarts}

    def summary(self) -> str:
        if not self.faults:
            return "no pipeline faults"
        return (f"{self.retries} decode retries, {self.skipped_samples} "
                f"samples skipped, {self.dropped_batches} batches dropped, "
                f"{self.worker_restarts} worker-pool restarts")


# --- process-worker plumbing -------------------------------------------------
# Decoding is a pure function of (seed, epoch, index) — the counter-based
# PRNG keys make a sample reproducible in ANY worker, so thread and
# process pools yield bit-identical batches. The dataset is shipped to
# each worker ONCE via the pool initializer (under the default fork
# context it is inherited for free); per-task traffic is just two ints
# out and the decoded arrays back.
_WORKER_STATE: dict = {}


def _process_worker_init(dataset, seed: int) -> None:
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["seed"] = seed


def _process_decode(epoch: int, index: int) -> Batch:
    rng = np.random.default_rng((_WORKER_STATE["seed"], epoch, index))
    return _WORKER_STATE["dataset"].sample(int(index), rng)


class _FeederError:
    """Queue marker carrying a fatal feeder-thread exception to the
    consumer side of the batch stream."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _FailedFuture:
    """Future-shaped carrier for a submit()-time error, so the consumer's
    one result-with-retry path handles enqueue failures too."""

    def __init__(self, exc: BaseException):
        self._exc = exc

    def result(self):
        raise self._exc


class _PoolManager:
    """Owns the decode pool and rebuilds it when workers die.

    A ProcessPoolExecutor whose worker exits (OOM-kill, segfault,
    injected os._exit) becomes permanently broken: every pending and
    future submission raises BrokenProcessPool. Both the feeder thread
    (submitting ahead) and the consumer (resolving results) can observe
    the break, so rebuild() is generation-guarded behind a lock — the
    first observer rebuilds, later observers of the same broken
    generation just pick up the fresh pool.
    """

    # consecutive rebuilds WITHOUT a single successful decode in between
    # before giving up: a pool whose workers die at startup (bad spawn
    # entrypoint, broken install) would otherwise rebuild forever while
    # the consumer waits on batches that can never arrive
    MAX_CONSECUTIVE_REBUILDS = 8

    def __init__(self, loader: "Loader"):
        self.loader = loader
        self._lock = OrderedLock("data.loader.pool")
        self._generation = 0
        self._rebuilds_since_success = 0
        self._closed = False
        self._pool = self._build()

    def note_success(self) -> None:
        with self._lock:
            # unlocked, this reset can interleave with rebuild()'s
            # locked increment and resurrect a stale streak count —
            # the give-up ceiling then fires early (or never)
            self._rebuilds_since_success = 0

    def _build(self):
        ld = self.loader
        if ld.worker_mode == "process":
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            return ProcessPoolExecutor(
                max_workers=ld.num_workers,
                mp_context=mp.get_context(ld.mp_start_method),
                initializer=_process_worker_init,
                initargs=(ld.dataset, ld.seed))
        return ThreadPoolExecutor(max_workers=ld.num_workers)

    def _submit_raw(self, pool, epoch: int, index: int):
        if self.loader.worker_mode == "process":
            return pool.submit(_process_decode, epoch, int(index))
        return pool.submit(self.loader._decode, epoch, int(index))

    def rebuild(self, seen_generation: int) -> None:
        """Replace the pool unless another thread already did."""
        with self._lock:
            if self._closed:
                # shutdown() raced the feeder's last submissions: the
                # "broken" pool is the one we closed on purpose — do
                # not resurrect a pool nobody will shut down, and do
                # not count a phantom worker restart
                return
            if seen_generation != self._generation:
                return
            self._rebuilds_since_success += 1
            if self._rebuilds_since_success > self.MAX_CONSECUTIVE_REBUILDS:
                raise RuntimeError(
                    f"decode pool produced no result across "
                    f"{self._rebuilds_since_success - 1} consecutive "
                    f"rebuilds — the workers are dying at startup "
                    f"(worker_mode={self.loader.worker_mode!r}, "
                    f"mp_start_method={self.loader.mp_start_method!r}); "
                    f"this is not a recoverable data fault")
            old = self._pool
            self._pool = self._build()
            self._generation += 1
            self.loader.stats.worker_restarts += 1
        print(f"[loader] decode pool broken; rebuilt "
              f"({self.loader.stats.worker_restarts} restart(s) so far)",
              flush=True)
        try:
            old.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass

    def submit(self, epoch: int, index: int):
        """Submit a decode; the returned future is tagged with the pool
        generation that produced it, so a consumer observing its failure
        rebuilds THAT generation (idempotent under races)."""
        with self._lock:
            pool, generation = self._pool, self._generation
        try:
            fut = self._submit_raw(pool, epoch, index)
        except (BrokenExecutor, RuntimeError):
            # RuntimeError covers "cannot schedule new futures after
            # shutdown" races during a concurrent rebuild
            self.rebuild(generation)
            with self._lock:
                pool, generation = self._pool, self._generation
            try:
                fut = self._submit_raw(pool, epoch, index)
            except Exception as e2:
                fut = _FailedFuture(e2)
        except Exception as e:
            fut = _FailedFuture(e)
        fut.pool_generation = generation
        return fut

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            pool = self._pool
        pool.shutdown(wait=False, cancel_futures=True)


class Loader:
    """Iterable over batches of a FlowDataset(-like) object.

    len(dataset) defines an epoch; iteration is endless (the trainer's
    should_keep_training loop decides when to stop, train.py:163).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 1234,
        num_workers: int = 4,
        prefetch: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        worker_mode: str = "thread",
        mp_start_method: str = "fork",
        max_retries: int = 3,
        retry_backoff_s: float = 0.05,
    ):
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} must divide over {process_count} hosts")
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be thread|process, got {worker_mode!r}")
        # "process" sidesteps the GIL for the Python/numpy share of
        # decode+augment (the reference's DataLoader runs 4 worker
        # PROCESSES for the same reason, core/datasets.py:234). Prefer
        # constructing the Loader BEFORE heavy jax/TPU init when using
        # the default fork start method, or pass mp_start_method="spawn".
        self.worker_mode = worker_mode
        self.mp_start_method = mp_start_method
        # decode-fault budget: a sample gets max_retries re-submissions
        # (exponential backoff from retry_backoff_s) before it is
        # skipped and its batch slot backfilled
        self.max_retries = max(0, max_retries)
        self.retry_backoff_s = retry_backoff_s
        self.stats = PipelineStats()
        # (epoch, offset) of each YIELDED batch, in yield order — the
        # trainer pops one entry per batch it consumes, so its stream
        # position stays exact even when a batch with no surviving
        # samples is dropped without a yield (the position of a dropped
        # batch never enters the queue); alignment survives any
        # prefetch depth because both sides are strictly FIFO. maxlen
        # bounds the memory of consumers that never pop (benches,
        # plain `for b in loader:` users) — a popping consumer can lag
        # at most its prefetch depth, far under the bound
        self.positions: "collections.deque[Tuple[int, int]]" = (
            collections.deque(maxlen=64))

    def __len__(self) -> int:
        n = len(self.dataset) // self.global_batch
        if not self.drop_last and len(self.dataset) % self.global_batch:
            n += 1
        return n

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            return epoch_permutation(self.seed, epoch, len(self.dataset))
        return np.arange(len(self.dataset))

    def _decode(self, epoch: int, index: int) -> Batch:
        rng = np.random.default_rng((self.seed, epoch, index))
        return self.dataset.sample(int(index), rng)

    def _note_decode_ok(self) -> None:
        """Hook: a sample decoded successfully (RecordLoader counts
        record reads here; the base loader keeps no per-success stat)."""

    def _note_decode_error(self, exc: BaseException) -> None:
        """Hook: one decode attempt failed with ``exc`` — called BEFORE
        the retry/skip accounting, so subclasses can classify the fault
        (e.g. RecordLoader counting CRC failures) without changing the
        retry discipline."""

    def _resolve(self, pools: _PoolManager, epoch: int, index: int, fut):
        """One sample's result, with bounded retry: pool breakage
        rebuilds + resubmits, decode errors resubmit with backoff, and
        a sample still failing after the budget is skipped (None)."""
        attempt = 0
        while True:
            try:
                sample = fut.result()
                pools.note_success()
                self._note_decode_ok()
                return sample
            except BrokenExecutor:
                # the pool died under this future; rebuild the future's
                # OWN generation (idempotent under races: a concurrent
                # observer of the same break rebuilds once) and charge
                # one attempt — a sample that deterministically kills
                # its worker must exhaust the budget, not rebuild pools
                # forever
                pools.rebuild(getattr(fut, "pool_generation", 0))
            except Exception as e:
                self._note_decode_error(e)  # classify, then retry below
            attempt += 1
            if attempt > self.max_retries:
                self.stats.skipped_samples += 1
                print(f"[loader] sample (epoch {epoch}, index {index}) "
                      f"failed {attempt} attempt(s); skipping it "
                      f"({self.stats.skipped_samples} skipped so far)",
                      flush=True)
                return None
            self.stats.retries += 1
            time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
            fut = pools.submit(epoch, index)

    def batches(self, start_epoch: int = 0,
                start_offset: int = 0) -> Iterator[Batch]:
        """Endless batch stream; this host's slice of each global batch.

        start_epoch/start_offset position the stream at global batch
        `start_offset` of `start_epoch` — with the counter-based PRNG
        streams this reproduces the EXACT sample sequence an
        interrupted run would have consumed next (resilience.stream).
        """
        if len(self) > 0:  # normalize an offset past the epoch end
            start_epoch += start_offset // len(self)
            start_offset %= len(self)
        pools = _PoolManager(self)
        out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        self.positions.clear()  # one live stream per Loader

        # a trailing partial global batch cannot be split evenly across
        # hosts — some would yield one more batch than others and the
        # sharded step's collectives would deadlock; always drop it when
        # multi-host
        drop_last = self.drop_last or self.process_count > 1

        def submit_loop():
            epoch = start_epoch
            skip = start_offset * self.global_batch
            try:
                while not stop.is_set():
                    order = self._epoch_order(epoch)
                    usable = (len(order) // self.global_batch
                              * self.global_batch
                              if drop_last else len(order))
                    for b0 in range(skip, usable, self.global_batch):
                        lo = b0 + self.process_index * self.local_batch
                        ids = order[lo:lo + self.local_batch]
                        if len(ids) == 0:
                            continue
                        # tagged with the batch's (epoch, offset) so the
                        # consumer can publish the exact position of
                        # every yielded batch (dropped ones never are)
                        work = (epoch, b0 // self.global_batch,
                                [(int(i), pools.submit(epoch, i))
                                 for i in ids])
                        while not stop.is_set():  # never park forever on put
                            try:
                                out.put(work, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                    epoch += 1
                    skip = 0
            except BaseException as e:
                # a fatal feeder error (e.g. the pool-rebuild bound) must
                # surface in the CONSUMER, not die with this thread while
                # the trainer blocks on a batch that will never come
                while not stop.is_set():
                    try:
                        out.put(_FeederError(e), timeout=0.1)
                        return
                    except queue.Full:
                        continue

        feeder = threading.Thread(target=submit_loop, daemon=True)
        feeder.start()
        try:
            while True:
                work = out.get()
                if isinstance(work, _FeederError):
                    raise work.exc
                epoch_b, offset_b, pairs = work
                samples = [self._resolve(pools, epoch_b, i, f)
                           for i, f in pairs]
                good = [s for s in samples if s is not None]
                if not good:
                    # nothing in this batch survived; drop it rather
                    # than fabricate data (single-host only: a
                    # multi-host run would need a collective agreement
                    # to drop, see docs/resilience.md). No position is
                    # published: the trainer never consumed this offset,
                    # so resume will revisit (and re-drop) it
                    self.stats.dropped_batches += 1
                    print(f"[loader] batch with no surviving samples "
                          f"dropped ({self.stats.dropped_batches} so far)",
                          flush=True)
                    continue
                n_good = len(good)
                while len(good) < len(pairs):
                    # backfill skipped slots by replicating survivors —
                    # batch shape stays stable (one compiled step), and
                    # a duplicated good sample beats a crashed run
                    good.append(good[len(good) % n_good])
                self.positions.append((epoch_b, offset_b))
                yield _stack(good)
        finally:
            stop.set()
            pools.shutdown()

    def __iter__(self) -> Iterator[Batch]:
        return self.batches()
