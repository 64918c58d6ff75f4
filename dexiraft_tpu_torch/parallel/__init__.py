"""Multi-rank training across processes: the data axis and fsdp.

The port of the data and fsdp axes of ``dexiraft_tpu/parallel/``:
torchrun's environment joins the process group
(``distributed.initialize``), and ``layout.make_train_mesh`` checks that
it can split the global batch and hands the train step its mesh: the
process group's :class:`World` (data parallelism), or an
``layout.FsdpMesh`` whose fsdp axis stores the parameters and Adam
moments sharded between steps (``fsdp.shard_state``; JAX's fence mode).
Halo spatial sharding, ring/context correlation and elastic membership
are ROADMAP A12.
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
