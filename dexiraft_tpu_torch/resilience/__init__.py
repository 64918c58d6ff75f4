"""Training resilience of the PyTorch port (counterpart of
``dexiraft_tpu.resilience``): checkpoint retention, the data stream's
position, the verified restore, the fault injectors, and the multi-rank
failure handling:

  * coord.Coordinator — rank-consensus primitives (any_flag / min_int /
    agree_step / barrier) over the ``torch.distributed`` store: a NaN or
    preemption notice on ANY rank becomes the SAME verdict (and the same
    rollback/emergency-save step) on ALL ranks; a single process is the
    identity.
  * watchdog.HangWatchdog — armed around each step and every other
    region that must make progress; a stall past the timeout dumps the
    step, the region and the live stacks and exits 98.
  * preemption.PreemptionHandler — SIGTERM/SIGINT become ONE graceful
    emergency checkpoint.
  * analysis.collective_trace (re-exported: CollectiveDivergence) — the
    collective flight recorder behind the Coordinator's lockstep check.

Elastic membership (``membership``) and ``verify.prune_steps_above`` are
ROADMAP A12. The fault injectors are imported by module name,
``resilience.chaos``, as in the JAX package.
"""

from dexiraft_tpu_torch.analysis.collective_trace import CollectiveDivergence
from dexiraft_tpu_torch.resilience.coord import Coordinator, CoordinatorTimeout
from dexiraft_tpu_torch.resilience.preemption import PreemptionHandler
from dexiraft_tpu_torch.resilience.retention import RetentionPolicy
from dexiraft_tpu_torch.resilience.stream import (
    LoaderKindMismatch,
    StreamPosition,
    position_extra,
    position_from_extra,
)
from dexiraft_tpu_torch.resilience.verify import (
    CheckpointIntegrityError,
    clean_uncommitted,
    restore_verified,
    uncommitted_flushes,
    verify_state,
)
from dexiraft_tpu_torch.resilience.watchdog import STALL_EXIT_CODE, HangWatchdog

__all__ = [
    "CheckpointIntegrityError",
    "CollectiveDivergence",
    "Coordinator",
    "CoordinatorTimeout",
    "HangWatchdog",
    "LoaderKindMismatch",
    "PreemptionHandler",
    "RetentionPolicy",
    "STALL_EXIT_CODE",
    "StreamPosition",
    "clean_uncommitted",
    "position_extra",
    "position_from_extra",
    "restore_verified",
    "uncommitted_flushes",
    "verify_state",
]
