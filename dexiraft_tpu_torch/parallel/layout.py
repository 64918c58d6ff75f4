"""The data axis of a data-parallel train step.

The port of the data axis of ``dexiraft_tpu/parallel/layout.py``
(``make_train_mesh``). JAX builds a device mesh and lets the SPMD
partitioner insert the gradient all-reduce; here every rank is one
process with its own replica of the model, and the process group the
replicas synchronise over stands for the mesh: ``make_train_step(cfg,
tc, mesh=world)`` (a ``parallel.World``) averages the gradients over it,
its BatchNorms normalise with the statistics of the global microbatch,
and its metrics are reduced over it (train/step.py).

The global batch is split the way JAX's sharded step splits it: the
step cuts the global batch into ``accum_steps`` microbatches of
consecutive rows, and each microbatch is sharded over the data axis, so
rank r holds the r-th block of rows of every microbatch
(:func:`local_rows`). The loader hands each rank exactly those rows
(``Loader(..., process_index=rank, process_count=world,
microbatches=accum_steps)``).

The fsdp, seq and serve meshes are ROADMAP A12.
"""

from __future__ import annotations

from typing import Optional

import torch

from dexiraft_tpu_torch.data.loader import rank_rows, world_compatible
from dexiraft_tpu_torch.parallel.distributed import World


def make_train_mesh(batch_size: int, world: World,
                    accum_steps: int = 1) -> Optional[World]:
    """The train CLI's mesh policy, data axis only.

    JAX takes the largest device count that divides the batch; here
    every rank has to take part, so a world that cannot slice the global
    batch evenly is refused with the loader's message, and so is one
    whose microbatches (``batch_size / accum_steps``) do not divide over
    the ranks. Returns None for a single process without a process
    group (the one-device step), else ``world`` (a 1-rank group runs the
    synced step with its collectives)."""
    reason = world_compatible(batch_size, world.size)
    if reason is not None:
        raise ValueError(reason)
    rank_rows(batch_size, accum_steps, 0, world.size)  # raises if uneven
    return world if world.grouped else None


def local_rows(batch: int, accum_steps: int, mesh: Optional[World]
               ) -> Optional[torch.Tensor]:
    """Indices of this rank's rows in the global batch of ``batch`` rows
    (None without a mesh): ``data.loader.rank_rows``, the rows the
    rank's loader reads."""
    if mesh is None:
        return None
    return torch.from_numpy(rank_rows(batch, accum_steps, mesh.rank,
                                      mesh.size))
