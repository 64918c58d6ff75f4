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

  * **(data, fsdp, seq)** (``make_train_mesh(batch, world, fsdp=...,
    seq=N)``, an :class:`FsdpMesh` with ``n_seq`` N): seq innermost,
    as JAX's ``make_mesh_fsdp(n_data, n_fsdp, n_seq)`` places it. The
    ranks of one seq group read the same rows of the batch and each
    computes a contiguous block of their image rows (the halo step,
    parallel/halo.py); the state is stored as on the (data, fsdp) mesh.

The mesh-axis names (:data:`LAYOUT_AXES`), the canonical group specs
the placement audit declares (``analysis/shardaudit.py``), its
:data:`REPLICATED_OK` exemptions and :func:`virtual_mesh` (every rank of
a mesh in one process, no process group) are the port's copies of JAX's
``SpecLayout`` vocabulary.

**The serve mesh** (:func:`make_serve_mesh`, a :class:`ServeMesh`; JAX's
``make_serve_mesh``): data-parallel inference in one process. JAX runs
one SPMD program over a 1-D ``data`` mesh, the variables replicated and
each batch's rows sharded. Here the mesh is a tuple of devices, one
entry each: :func:`replicate` copies the model once onto every entry,
:func:`shard_batch` cuts a batch into one contiguous block of rows per
entry (in entry order) and puts each on its entry's device, and a mesh
step (``train.step.make_eval_step(mesh=)``) launches each block's
forward on its own device and returns :class:`RowShards`, the outputs
still on their devices in row order. The serve mesh has no fsdp or seq
axis, as in JAX.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from dexiraft_tpu_torch.data.loader import rank_rows, world_compatible
from dexiraft_tpu_torch.device import resolve_device
from dexiraft_tpu_torch.parallel.distributed import World, mesh_groups

#: The mesh-axis names, JAX's ``SpecLayout`` axes: specs and the
#: placement audit spell them from here (shardlint pins the set).
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQ_AXIS = "seq"
LAYOUT_AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS)

#: Groups the placement audit may see fully replicated over its size
#: threshold without flagging, each with its reason (JAX's
#: ``REPLICATED_OK``; the port's generator state stands for JAX's rng
#: key). The parameters and Adam moments are not here: on an fsdp mesh
#: they shard, and a layout that replicated them over the threshold
#: fails the audit.
REPLICATED_OK = {
    "batch_stats": "BatchNorm running stats are global (sync-BN)",
    "generator": "the train state's generator state (JAX's rng key)",
    "step": "scalar step counter",
    "metrics": "scalar loss/metric outputs",
}

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
class MeshAxis:
    """One axis of a mesh: this rank's index on it, its size, and the
    process group its reductions run over (on the data axis BatchNorm,
    dropout, noise rows, gradients and metrics read these three)."""

    rank: int
    size: int
    group: Any = None


@dataclasses.dataclass(frozen=True)
class FsdpMesh:
    """A (data, fsdp, seq) grid over every rank of ``world`` (module
    docstring), with its subgroups (``distributed.mesh_groups``). Seq
    innermost: rank r has seq index r % n_seq, fsdp index (r // n_seq)
    % n_fsdp and data index r // (n_fsdp * n_seq). ``n_seq`` 1 is the
    (data, fsdp) mesh."""

    world: World
    n_data: int
    n_fsdp: int
    data_group: Any = None
    fsdp_group: Any = None
    n_seq: int = 1
    seq_group: Any = None
    #: the ranks that share this rank's parameter shards (the data group
    #: when n_seq is 1): gradients, the loss and metrics of a step whose
    #: rows are sharded over seq reduce over it
    data_seq_group: Any = None

    @property
    def data_index(self) -> int:
        return self.world.rank // (self.n_fsdp * self.n_seq)

    @property
    def fsdp_index(self) -> int:
        return (self.world.rank // self.n_seq) % self.n_fsdp

    @property
    def seq_index(self) -> int:
        return self.world.rank % self.n_seq

    @property
    def data(self) -> MeshAxis:
        return MeshAxis(self.data_index, self.n_data, self.data_group)

    @property
    def fsdp(self) -> MeshAxis:
        return MeshAxis(self.fsdp_index, self.n_fsdp, self.fsdp_group)

    @property
    def seq(self) -> MeshAxis:
        return MeshAxis(self.seq_index, self.n_seq, self.seq_group)

    @property
    def data_seq(self) -> MeshAxis:
        """The data and seq axes as one, data major (the rank's index is
        data index * n_seq + seq index)."""
        return MeshAxis(self.data_index * self.n_seq + self.seq_index,
                        self.n_data * self.n_seq,
                        self.data_seq_group if self.n_seq > 1
                        else self.data_group)


def virtual_mesh(rank: int, n_data: int, n_fsdp: int, n_seq: int = 1
                 ) -> FsdpMesh:
    """Rank ``rank`` of a (data, fsdp, seq) mesh on the ``meta`` device
    with no process group (every group None): what that rank places,
    read in one process (the placement audit). Its collectives cannot
    run."""
    size = n_data * n_fsdp * n_seq
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a mesh of {size} ranks")
    world = World(rank, size, rank, torch.device("meta"), "gloo")
    return FsdpMesh(world, n_data, n_fsdp, n_seq=n_seq)


def group_spec(group: str, axes: "dict[str, int]") -> Tuple[str, ...]:
    """The canonical spec of a declared array group on a mesh of
    ``axes`` (JAX's ``SpecLayout``): batch, correlation fmaps and halo
    activations over (data, seq), seq where the mesh has it; the carry
    over data; the parameters and Adam moments over fsdp where the mesh
    has it, else replicated."""
    if group in ("batch", "corr_fmaps"):
        return ((DATA_AXIS, SEQ_AXIS) if SEQ_AXIS in axes
                else (DATA_AXIS,))
    if group == "halo_activations":
        return (DATA_AXIS, SEQ_AXIS)
    if group == "carry":
        return (DATA_AXIS,)
    if group in ("params", "opt_state"):
        return (FSDP_AXIS,) if FSDP_AXIS in axes else ()
    raise ValueError(f"no canonical spec for the group {group!r}")


def spec_str(spec: Sequence[Optional[str]]) -> str:
    """A spec (an axis name or None per dim) as JAX's ``spec_str`` writes
    a PartitionSpec: ``P()``, ``P('data', 'seq')``, ``P(None, None,
    None, 'fsdp')``."""
    return "P(" + ", ".join("None" if e is None else repr(e)
                            for e in spec) + ")"


def has_seq(mesh) -> bool:
    """``mesh`` shards image rows over a seq axis of more than one rank."""
    return isinstance(mesh, FsdpMesh) and mesh.n_seq > 1


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
                    fsdp=None, seq=None) -> Optional[TrainMesh]:
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
    ranks idle or its microbatches do not divide over the data axis.

    ``seq`` N > 1: a (data, fsdp, seq) :class:`FsdpMesh` whose seq axis
    of N ranks shards image rows (the halo train and eval steps,
    parallel/halo.py; JAX's ``make_mesh_fsdp(n_data, n_fsdp, n_seq)``):
    the (data, fsdp) shape is the one above over ``world.size / N``
    ranks, and the mesh is an :class:`FsdpMesh` even with an fsdp axis
    of one rank (the halo step takes the state in its storage layout,
    ``parallel.fsdp.shard_state``). ``seq`` None or 1: no seq axis."""
    n_seq = 1 if seq is None else int(seq)
    if n_seq < 1 or world.size % n_seq:
        raise ValueError(f"seq={seq}: the seq axis must divide the world's "
                         f"{world.size} rank(s)")
    if n_seq > 1:
        if not world.grouped:
            raise ValueError("a seq mesh needs a process group (launch the "
                             "ranks with torchrun)")
        n_data, n_fsdp = fsdp_mesh_shape(
            batch_size, world.size // n_seq, fsdp,
            max(1, (world.local_size or world.size) // n_seq))
        rank_rows(batch_size, accum_steps, 0, n_data)  # raises if uneven
        data_g, fsdp_g, seq_g, data_seq_g = mesh_groups(world, n_data,
                                                        n_fsdp, n_seq)
        return FsdpMesh(world, n_data, n_fsdp, data_g, fsdp_g, n_seq, seq_g,
                        data_seq_g)
    if fsdp is not None and fsdp != 1:
        n_data, n_fsdp = fsdp_mesh_shape(
            batch_size, world.size, fsdp, world.local_size or world.size)
        if n_fsdp > 1:
            rank_rows(batch_size, accum_steps, 0, n_data)  # raises if uneven
            if not world.grouped:
                raise ValueError("an fsdp mesh needs a process group "
                                 "(launch the ranks with torchrun)")
            data_g, fsdp_g, _, _ = mesh_groups(world, n_data, n_fsdp)
            return FsdpMesh(world, n_data, n_fsdp, data_g, fsdp_g)
    reason = world_compatible(batch_size, world.size)
    if reason is not None:
        raise ValueError(reason)
    rank_rows(batch_size, accum_steps, 0, world.size)  # raises if uneven
    return world if world.grouped else None


def data_axis(mesh: Optional[TrainMesh]) -> Optional[Union[World, MeshAxis]]:
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


# ---- the serve mesh ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A 1-D ``data`` mesh for inference (module docstring): entry i is
    ``devices[i]``; an entry may repeat another's device (the tests' CPU
    entries, two shards on one card)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axes(self) -> Dict[str, int]:
        return {DATA_AXIS: self.size}

    @property
    def is_cuda(self) -> bool:
        return any(d.type == "cuda" for d in self.devices)


def make_serve_mesh(n_chips: Optional[int] = None, *,
                    devices: Optional[Sequence[Union[str, torch.device]]]
                    = None) -> ServeMesh:
    """The serve mesh over the first ``n_chips`` devices (default all),
    as JAX's ``make_serve_mesh``: an ``n_chips`` outside 1..(devices
    present) raises ``ValueError`` with JAX's message.

    The devices are the cards of ``torch.cuda.device_count()`` (a
    process without one raises: ``device.resolve_device``), or the
    entries ``devices`` names, each resolved (a CUDA entry that is not
    there raises). Entries may repeat: ``("cpu",) * 8`` is the
    counterpart of the JAX suite's 8 forced host devices."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if n_chips is not None:
        if not 1 <= n_chips <= len(devs):
            raise ValueError(f"n_chips {n_chips} out of range "
                             f"1..{len(devs)}")
        devs = devs[:n_chips]
    if not devs:
        raise ValueError("a serve mesh needs at least one device")
    return ServeMesh(devs)


def cli_serve_mesh(n: int, dev: torch.device, prog: str
                   ) -> Optional[ServeMesh]:
    """The CLIs' ``--data_parallel N``: None for N 0; else the serve mesh
    of the first N cards, or of N CPU entries when ``dev`` is the CPU
    (the CLI's ``--cpu``/``--device cpu``), printed as ``[prog] ...``. A
    mesh the devices present cannot hold exits naming the flag."""
    if n <= 0:
        return None
    try:
        mesh = (make_serve_mesh(n, devices=(dev,) * n) if dev.type == "cpu"
                else make_serve_mesh(n))
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"{prog}: --data_parallel {n}: {e}")
    print(f"[{prog}] data-parallel over {mesh.size} entries: "
          f"{', '.join(str(d) for d in mesh.devices)}", flush=True)
    return mesh


def check_serve_mesh(mesh) -> ServeMesh:
    """``mesh`` itself when it is a :class:`ServeMesh`; a train mesh (a
    World, an fsdp or seq mesh) or anything else raises ``TypeError``."""
    if not isinstance(mesh, ServeMesh):
        raise TypeError(f"mesh={mesh!r} is no ServeMesh: inference shards "
                        "its batch over parallel.layout.make_serve_mesh's "
                        "1-D data mesh (no fsdp or seq axis)")
    return mesh


def replicate(model: nn.Module, mesh: ServeMesh) -> Tuple[nn.Module, ...]:
    """One eval-mode replica of ``model`` on each entry's device, made
    once (JAX's ``replicate``: the variables put fully replicated up
    front): every parameter and buffer equals the source's to the bit.
    The first entry on the source's own device takes the source itself,
    so that device holds no second copy of it; every other entry a deep
    copy, made on the source's device and then moved."""
    check_serve_mesh(mesh)
    home = next(model.parameters()).device
    reps = []
    for dev in mesh.devices:
        if dev == home and not any(r is model for r in reps):
            reps.append(model.eval())
        else:
            reps.append(copy.deepcopy(model).to(dev).eval())
    return tuple(reps)


def row_blocks(batch: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """[start, stop) of each of ``n`` contiguous, equal row blocks of a
    batch of ``batch`` rows; a batch that ``n`` does not divide raises."""
    if batch % n:
        raise ValueError(f"batch of {batch} rows is not divisible by the "
                         f"mesh's {n} entries: every entry needs a full "
                         "shard of each batch")
    k = batch // n
    return tuple((i * k, (i + 1) * k) for i in range(n))


class RowShards:
    """A batch tensor held as contiguous row blocks, one per serve-mesh
    entry, in row order (JAX's array sharded over ``data``):
    ``shards[i]`` lies on entry i's device and holds rows
    ``rows[i][0]:rows[i][1]`` of the whole."""

    __slots__ = ("shards", "rows")

    def __init__(self, shards: Sequence[torch.Tensor],
                 rows: Sequence[Tuple[int, int]]):
        if len(shards) != len(rows) or any(
                s.shape[0] != b - a for s, (a, b) in zip(shards, rows)):
            raise ValueError(f"{len(shards)} shards do not hold the row "
                             f"blocks {tuple(rows)}")
        self.shards = tuple(shards)
        self.rows = tuple(rows)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.rows[-1][1],) + tuple(self.shards[0].shape[1:])

    def __len__(self) -> int:
        return self.rows[-1][1]

    def fetch(self) -> np.ndarray:
        """The whole batch on the host, in row order (``guards.fetch`` of
        every shard: the explicit device->host copies)."""
        from dexiraft_tpu_torch.analysis import guards

        return np.concatenate(guards.fetch(list(self.shards)), axis=0)


def fetch_rows(x):
    """``x.fetch()`` for :class:`RowShards`, ``guards.fetch(x)``
    otherwise (a tensor, a tree of tensors, host arrays, None)."""
    from dexiraft_tpu_torch.analysis import guards

    return x.fetch() if isinstance(x, RowShards) else guards.fetch(x)


def shard_batch(batch, mesh: ServeMesh):
    """Each entry's block of rows of ``batch`` on its device, as
    :class:`RowShards` (JAX's ``shard_batch``): ``batch`` is a host
    array, a CPU tensor (pinned: the copies do not block the host) or a
    dict of them; None passes. A batch that the mesh size does not
    divide raises."""
    from dexiraft_tpu_torch.analysis import guards

    if batch is None or isinstance(batch, RowShards):
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    rows = row_blocks(int(batch.shape[0]), mesh.size)
    return RowShards([guards.put(batch[a:b], dev)
                      for (a, b), dev in zip(rows, mesh.devices)], rows)


def batch_putter(mesh: Optional[ServeMesh]):
    """batch -> its row blocks on the mesh's devices (:func:`shard_batch`);
    ``mesh`` None: the batch as it is (a one-device step moves it)."""
    if mesh is None:
        return lambda batch: batch
    check_serve_mesh(mesh)
    return lambda batch: shard_batch(batch, mesh)
