"""Training resilience of the PyTorch port (counterpart of
``dexiraft_tpu.resilience``): checkpoint retention, the data stream's
position, the verified restore and the fault injectors.

The multi-host half (coord, membership, watchdog, preemption as a
module, ``prune_steps_above``) is ROADMAP A12. The fault injectors are
imported by module name, ``resilience.chaos``, as in the JAX package.
"""

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

__all__ = [
    "CheckpointIntegrityError",
    "LoaderKindMismatch",
    "RetentionPolicy",
    "StreamPosition",
    "clean_uncommitted",
    "position_extra",
    "position_from_extra",
    "restore_verified",
    "uncommitted_flushes",
    "verify_state",
]
