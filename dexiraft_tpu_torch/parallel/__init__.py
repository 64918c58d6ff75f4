"""Data-parallel training across processes.

The port of the data axis of ``dexiraft_tpu/parallel/``: torchrun's
environment joins the process group (``distributed.initialize``), and
``layout.make_train_mesh`` checks that it can split the global batch and
hands its :class:`World` to the train step, which synchronises over it.
fsdp storage sharding, halo spatial sharding, ring/context correlation
and elastic membership are ROADMAP A12.
"""

from dexiraft_tpu_torch.parallel.distributed import (
    World,
    coordination_store,
    initialize,
    teardown,
)
from dexiraft_tpu_torch.parallel.layout import (
    local_rows,
    make_train_mesh,
)

__all__ = [
    "World",
    "coordination_store",
    "initialize",
    "local_rows",
    "make_train_mesh",
    "teardown",
]
