"""Fault-injection harness: prove the recovery paths recover.

A copy of ``dexiraft_tpu/resilience/chaos.py`` over the port's
checkpoint format. Every resilience claim is tested by injecting the
real fault, not a mock of its symptom: corrupt samples RAISE from
decode, worker death actually `os._exit`s a pool process (breaking the
executor), SIGTERM is a real signal through the real handler, a kill
mid-flush exits the trainer while its checkpoint write is in flight,
and checkpoint truncation damages the real ``state.pt`` the trainer
wrote. Used by tests/test_torch_resilience.py and chip_smoke.py's
``records`` phase.

Module constraint: everything picklable from module scope (the dataset
wrappers are shipped to SPAWNED process-pool workers).
"""

from __future__ import annotations

import os
import os.path as osp
import signal
from typing import Callable, Dict, Iterable, Optional

import numpy as np


class ChaosError(RuntimeError):
    """The injected decode failure (distinct type, so tests can tell an
    injected fault from a genuine bug in the recovery path)."""


class SyntheticFlowDataset:
    """Tiny in-memory FlowDataset stand-in: deterministic samples from
    counter-based PRNG keyed on (seed, index) — no files, no augmentor,
    picklable, so loader-level chaos tests stay CPU-cheap."""

    def __init__(self, n: int = 16, size=(32, 48), seed: int = 0):
        self.n = n
        self.size = tuple(size)
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def sample(self, index: int,
               rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        h, w = self.size
        gen = np.random.default_rng((self.seed, int(index)))
        img1 = gen.uniform(0, 255, (h, w, 3)).astype(np.float32)
        img2 = gen.uniform(0, 255, (h, w, 3)).astype(np.float32)
        flow = gen.normal(size=(h, w, 2)).astype(np.float32)
        return {"image1": img1, "image2": img2, "flow": flow,
                "valid": np.ones((h, w), np.float32)}

    __getitem__ = sample


class CorruptSampleDataset:
    """Decode of the chosen indices raises — a corrupt PNG/flo in spirit.

    fail_times bounds failures PER WORKER (attempt counters live in the
    decoding process): None = the sample is permanently corrupt (the
    skip-and-count path); k = transient, succeeds on retry k+1 (the
    retry-with-backoff path — use thread workers, where one counter sees
    every attempt).
    """

    def __init__(self, base, bad_indices: Iterable[int],
                 fail_times: Optional[int] = None):
        self.base = base
        self.bad = set(int(i) for i in bad_indices)
        self.fail_times = fail_times
        self._attempts: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self.base)

    def sample(self, index: int, rng=None):
        index = int(index)
        if index in self.bad:
            n = self._attempts.get(index, 0)
            if self.fail_times is None or n < self.fail_times:
                self._attempts[index] = n + 1
                raise ChaosError(f"chaos: corrupt sample {index} "
                                 f"(attempt {n + 1})")
        return self.base.sample(index, rng)

    __getitem__ = sample


class WorkerDeathDataset:
    """Decoding the chosen indices hard-kills the decode process.

    PROCESS worker_mode only: in thread mode os._exit would take the
    whole trainer down (which is the point — this simulates a pool
    worker segfaulting/OOM-killed, not a decode exception). Each index
    kills at most once, coordinated through a sentinel file in
    `sentinel_dir` (worker processes share no memory and are REBUILT
    after the pool breaks, so in-process counters cannot carry the
    "already died" fact across the rebuild).
    """

    def __init__(self, base, die_indices: Iterable[int], sentinel_dir: str):
        self.base = base
        self.die = set(int(i) for i in die_indices)
        self.sentinel_dir = sentinel_dir

    def __len__(self) -> int:
        return len(self.base)

    def sample(self, index: int, rng=None):
        index = int(index)
        if index in self.die:
            try:
                # atomic claim: exactly one attempt per index dies
                fd = os.open(osp.join(self.sentinel_dir, f"die_{index}"),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                os._exit(3)
            except FileExistsError:
                pass  # this index already killed a worker once; decode
        return self.base.sample(index, rng)

    __getitem__ = sample


def parse_spec(spec: str) -> Callable[[int], None]:
    """Parse a --chaos spec into a per-step callback for the train loop.

    Grammar:
      "sigterm@N" — after step N completes, send the process a real
      SIGTERM (once). The signal flows through the installed
      PreemptionHandler exactly as an external `kill -TERM` would, which
      is what makes the emergency-save tests deterministic: the stop
      step is pinned without racing a timer against compile time.
      "kill_mid_flush@N" — after step N completes, arm the checkpoint
      module so the NEXT async save os._exit()s while its flush is in
      flight: a real crash before the commit rename, leaving an
      uncommitted ``<step>.tmp-*`` dir. The step's save never commits;
      the run's previous committed step must remain the
      verified-restorable latest (chip_smoke.py's records phase).
    """
    kind, _, arg = spec.partition("@")
    if kind == "sigterm":
        at = int(arg)
        fired = [False]

        def fire(step: int) -> None:
            if not fired[0] and step >= at:
                fired[0] = True
                os.kill(os.getpid(), signal.SIGTERM)

        return fire
    if kind == "kill_mid_flush":
        at = int(arg)
        armed = [False]

        def arm(step: int) -> None:
            if not armed[0] and step >= at:
                armed[0] = True
                # deferred import: only the trainer process firing the
                # spec needs the checkpoint module
                from dexiraft_tpu_torch.train import checkpoint as ckpt_io

                ckpt_io.chaos_kill_next_flush()

        return arm
    raise ValueError(f"unknown chaos spec {spec!r} "
                     f"(supported: sigterm@N, kill_mid_flush@N)")


def truncate_checkpoint(directory: str, step: int) -> "list[str]":
    """Damage a saved step the way a mid-write preemption does: the
    largest file under <directory>/<step>/ (the port's ``state.pt``) is
    truncated to half. Returns
    the damaged paths (empty = nothing large enough to damage)."""
    step_dir = osp.join(directory, str(int(step)))
    if not osp.isdir(step_dir):
        raise FileNotFoundError(f"no step dir {step_dir}")
    files = []
    for root, _, names in os.walk(step_dir):
        for name in names:
            p = osp.join(root, name)
            files.append((os.path.getsize(p), p))
    files.sort(reverse=True)
    damaged = []
    for size, path in files[:1]:
        if size < 2:
            continue
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        damaged.append(path)
    return damaged
