"""The data and fsdp axes of a multi-rank train step.

The port of ``dexiraft_tpu/parallel/layout.py``'s train meshes and its
fsdp leaf policy. JAX builds a device mesh and lets the SPMD partitioner
insert the collectives; here every rank is one process with its own
model, and the process group stands for the mesh:

  * **data** (``make_train_mesh(batch, world)``, a ``parallel.World``):
    ``make_train_step(cfg, tc, mesh=world)`` averages the gradients over
    the ranks, its BatchNorms normalise with the statistics of the
    global microbatch, and its metrics are reduced over them
    (train/step.py).
  * **(data, fsdp)** (``make_train_mesh(batch, world, fsdp=...)``, an
    :class:`FsdpMesh`): the ranks form a (data, fsdp) grid, fsdp
    innermost, as JAX's ``make_mesh_fsdp`` places it: rank r has data
    index r // n_fsdp and fsdp index r % n_fsdp. The ranks of one fsdp
    group read the same rows and hold, between steps, one slice each of
    every parameter the leaf policy shards and of its Adam moments
    (``parallel/fsdp.py``); the step gathers the parameters at entry and
    computes the replicated step (JAX's fence mode). The data axis is
    the data index over the data size: gradients, BatchNorm statistics,
    dropout masks, noise and metrics reduce over the data subgroup.

The global batch is split the way JAX's sharded step splits it: the
step cuts the global batch into ``accum_steps`` microbatches of
consecutive rows, and each microbatch is sharded over the data axis, so
data index d holds the d-th block of rows of every microbatch
(:func:`local_rows`). The loader hands each rank exactly those rows
(``Loader(..., process_index=d, process_count=n_data,
microbatches=accum_steps)``).

**Leaf policy** (:func:`leaf_shard_dim`, JAX's
``SpecLayout.param_leaf_spec``): a leaf is sharded along its largest dim
that the fsdp size divides, ties to the earliest; a leaf under
:data:`FSDP_MIN_LEAF_SIZE` elements, or with no dividing dim, stays
replicated. The decision is taken on the leaf's logical (JAX) shape,
HWIO for a conv kernel where the port stores OIHW, and the chosen dim
is mapped through the weight bridge's transpose
(:func:`param_shard_dim`), so both packages shard the same leaves along
the same logical dim.

The seq and serve meshes are ROADMAP A12.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from dexiraft_tpu_torch.data.loader import rank_rows, world_compatible
from dexiraft_tpu_torch.parallel.distributed import World, mesh_groups

#: Leaves smaller than this (elements) stay replicated on fsdp meshes:
#: biases, norm scales and scalars cost more to gather than they save
#: (JAX's ``SpecLayout.FSDP_MIN_LEAF_SIZE``).
FSDP_MIN_LEAF_SIZE = 4096

#: torch dim -> logical (JAX) dim of a conv kernel (OIHW of HWIO) and of
#: a transposed conv's kernel ((in, out, kH, kW) of flax's (kH, kW, in,
#: out)): the weight bridge's transposes (interop/jax_weights.py)
CONV_DIMS = (3, 2, 0, 1)
CONV_TRANSPOSE_DIMS = (2, 3, 0, 1)


def leaf_shard_dim(shape: Sequence[int], n_fsdp: int) -> Optional[int]:
    """The dim of a leaf of logical shape ``shape`` that an
    ``n_fsdp``-way fsdp axis shards (None: replicated): the largest dim
    that ``n_fsdp`` divides, ties to the earliest; none for a leaf under
    FSDP_MIN_LEAF_SIZE elements or an axis of 1."""
    shape = tuple(int(s) for s in shape)
    if n_fsdp <= 1 or int(np.prod(shape, dtype=np.int64)) < \
            FSDP_MIN_LEAF_SIZE:
        return None
    best = None
    for i, d in enumerate(shape):
        if d and d % n_fsdp == 0 and (best is None or d > shape[best]):
            best = i
    return best


def logical_dims(module: nn.Module, name: str, ndim: int
                 ) -> Tuple[int, ...]:
    """torch dim -> logical (JAX) dim of parameter ``name`` of
    ``module`` (the weight bridge's layout)."""
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return CONV_TRANSPOSE_DIMS
    if name == "weight" and isinstance(module, nn.Conv2d):
        return CONV_DIMS
    if ndim > 1:
        raise ValueError(f"no logical layout for the {ndim}-d parameter "
                         f"{name!r} of {type(module).__name__}")
    return tuple(range(ndim))


def param_shard_dim(module: nn.Module, name: str, shape: Sequence[int],
                    n_fsdp: int) -> "Tuple[Optional[int], Optional[int]]":
    """(torch dim, logical dim) that an ``n_fsdp``-way fsdp axis shards
    parameter ``name`` (of torch shape ``shape``) of ``module`` along,
    or (None, None): the leaf policy on the logical shape, mapped back
    to the torch dim."""
    dims = logical_dims(module, name, len(shape))
    logical = [0] * len(shape)
    for t, j in enumerate(dims):
        logical[j] = shape[t]
    dim = leaf_shard_dim(logical, n_fsdp)
    if dim is None:
        return None, None
    return dims.index(dim), dim


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """A data axis: this rank's index on it, its size, and the process
    group its reductions run over (BatchNorm, dropout, noise rows,
    gradients and metrics read these three)."""

    rank: int
    size: int
    group: Any = None


@dataclasses.dataclass(frozen=True)
class FsdpMesh:
    """A (data, fsdp) grid over every rank of ``world`` (module
    docstring), with its two subgroups (``distributed.mesh_groups``)."""

    world: World
    n_data: int
    n_fsdp: int
    data_group: Any = None
    fsdp_group: Any = None

    @property
    def data_index(self) -> int:
        return self.world.rank // self.n_fsdp

    @property
    def fsdp_index(self) -> int:
        return self.world.rank % self.n_fsdp

    @property
    def data(self) -> DataAxis:
        return DataAxis(self.data_index, self.n_data, self.data_group)


TrainMesh = Union[World, FsdpMesh]


def fsdp_mesh_shape(batch_size: int, world_size: int, fsdp, local_size: int
                    ) -> Tuple[int, int]:
    """(n_data, n_fsdp) of JAX's ``make_train_mesh(batch_size, devices,
    fsdp)`` over ``world_size`` ranks, ``local_size`` of them on each
    host; raises where that mesh would leave ranks idle (every rank must
    take part).

    data: the largest rank count that divides the batch. ``fsdp``: None
    or 1, no fsdp axis; ``'auto'``, the ranks data left over, walked
    down to a size that divides, or is a multiple of, ``local_size`` (an
    fsdp group within whole hosts); an int N, exactly N-way, carved
    first, data then taking the largest batch divisor of the ranks
    left."""
    n_data = max(n for n in range(1, world_size + 1) if batch_size % n == 0)
    if fsdp is None or fsdp == 1:
        n_fsdp = 1
    elif fsdp == "auto":
        n_fsdp = world_size // n_data
        local = max(1, local_size)
        while n_fsdp > 1 and not (local % n_fsdp == 0
                                  or n_fsdp % local == 0):
            n_fsdp -= 1
    else:
        n_fsdp = int(fsdp)
        if n_fsdp < 1 or n_fsdp > world_size:
            raise ValueError(f"fsdp={n_fsdp}: need between 1 and "
                             f"{world_size} rank(s)")
        n_data = max(n for n in range(1, world_size // n_fsdp + 1)
                     if batch_size % n == 0)
    if n_data * n_fsdp != world_size:
        raise ValueError(
            f"global batch {batch_size} with fsdp={fsdp} makes a "
            f"{n_data}x{n_fsdp} (data, fsdp) mesh, which leaves "
            f"{world_size - n_data * n_fsdp} of {world_size} ranks idle; "
            "every rank must take part: pick a batch size, world size and "
            "--fsdp whose data x fsdp uses every rank")
    return n_data, n_fsdp


def make_train_mesh(batch_size: int, world: World, accum_steps: int = 1,
                    fsdp=None) -> Optional[TrainMesh]:
    """The train CLI's mesh policy.

    ``fsdp`` None (or a mesh whose fsdp axis comes out 1): the data
    axis only. Every rank has to take part, so a world that cannot
    slice the global batch evenly is refused with the loader's message,
    and so is one whose microbatches (``batch_size / accum_steps``) do
    not divide over the ranks. Returns None for a single process
    without a process group (the one-device step), else ``world`` (a
    1-rank group runs the synced step with its collectives).

    ``fsdp`` ``'auto'`` or N: the (data, fsdp) mesh of
    :func:`fsdp_mesh_shape` as an :class:`FsdpMesh` with its subgroups
    built (every rank must call this), refused where it would leave
    ranks idle or its microbatches do not divide over the data axis."""
    if fsdp is not None and fsdp != 1:
        n_data, n_fsdp = fsdp_mesh_shape(
            batch_size, world.size, fsdp, world.local_size or world.size)
        if n_fsdp > 1:
            rank_rows(batch_size, accum_steps, 0, n_data)  # raises if uneven
            if not world.grouped:
                raise ValueError("an fsdp mesh needs a process group "
                                 "(launch the ranks with torchrun)")
            return FsdpMesh(world, n_data, n_fsdp,
                            *mesh_groups(world, n_data, n_fsdp))
    reason = world_compatible(batch_size, world.size)
    if reason is not None:
        raise ValueError(reason)
    rank_rows(batch_size, accum_steps, 0, world.size)  # raises if uneven
    return world if world.grouped else None


def data_axis(mesh: Optional[TrainMesh]) -> Optional[Union[World, DataAxis]]:
    """The data axis of ``mesh``: a data-parallel World itself (a 1-rank
    group included, which runs the synced step's collectives), an fsdp
    mesh's data subgroup, or None: no mesh, or an fsdp mesh whose data
    axis is one rank, whose ranks compute what one process computes."""
    if mesh is None or isinstance(mesh, World):
        return mesh
    return mesh.data if mesh.n_data > 1 else None


def local_rows(batch: int, accum_steps: int, axis
               ) -> Optional[torch.Tensor]:
    """Indices of this rank's rows in the global batch of ``batch`` rows
    (None without a data axis): ``data.loader.rank_rows``, the rows the
    rank's loader reads. ``axis``: a data axis (:func:`data_axis`, or a
    data-parallel World)."""
    if axis is None:
        return None
    return torch.from_numpy(rank_rows(batch, accum_steps, axis.rank,
                                      axis.size))
