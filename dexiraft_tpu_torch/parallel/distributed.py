"""Process-group initialization for data-parallel training.

The port of ``dexiraft_tpu/parallel/distributed.py:initialize``. JAX
runs one process per host and sees every chip through it; PyTorch runs
one process per rank, each driving one device. ``torchrun`` (or any
launcher that sets its variables) starts the ranks:

  torchrun --nproc_per_node N -m dexiraft_tpu_torch train ...

:func:`initialize` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``). With none of them set it is a no-op: one process, no
process group. Otherwise:

  * each rank's device is explicit. ``device="cuda"`` is
    ``cuda:LOCAL_RANK``, and a rank whose card is missing raises, as
    ``device.resolve_device`` does. ``device="cuda:N"`` puts every local
    rank on card N (ranks sharing one card). ``device="cpu"`` runs the
    plain versions on the CPU.
  * the backend is ``nccl`` where every rank owns its own card, and
    ``gloo`` where local ranks share one (NCCL refuses two ranks on one
    device) or on the CPU. The choice is printed on one line.
  * the process group rendezvouses on a ``TCPStore`` (torchrun's agent
    store when there is one), which :func:`coordination_store` hands to
    the failure-consensus layer (resilience.coord). A failed
    rendezvous or ``init_process_group`` raises.

:func:`mesh_groups` builds the data and fsdp subgroups of an fsdp mesh
(parallel/layout.py). The elastic runtime (``elastic_initialize``/
``elastic_teardown``) is the second half of ROADMAP A12.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Mapping, Optional, Union

import torch

from dexiraft_tpu_torch.device import resolve_device

#: torchrun's variables; any one of them set means a multi-rank launch
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
#: the rendezvous's and the process group's own timeout (a stalled
#: collective is the hang watchdog's to catch, long before this)
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the run: its rank, the world size, its
    device and the process group's backend (None: a single process with
    no process group)."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: Optional[str] = None
    #: the ranks on this host (torchrun's LOCAL_WORLD_SIZE; 0: unknown,
    #: taken as ``size``)
    local_size: int = 0

    @property
    def grouped(self) -> bool:
        """A process group is live (also for a 1-rank group)."""
        return self.backend is not None

    @property
    def group(self):
        """The process group the data axis reduces over: the default
        group (None) of a data-parallel World."""
        return None


_STORE = None


def _env_int(env: Mapping[str, str], name: str) -> int:
    value = env.get(name)
    if value is None:
        raise ValueError(
            f"multi-rank init: some of {ENV_VARS} are set but {name} is "
            "not (launch with torchrun, or set all of them)")
    return int(value)


def rank_device(device: Union[str, torch.device], local_rank: int,
                local_world: int) -> "tuple[torch.device, bool]":
    """(this rank's device, whether local ranks share it).

    ``cuda`` without an index is ``cuda:local_rank`` (one card per rank;
    a missing card raises); ``cuda:N`` is card N for every local rank,
    shared when more than one rank runs on the host; ``cpu`` is the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            return resolve_device(f"cuda:{local_rank}"), False
        return resolve_device(dev), local_world > 1
    return resolve_device(dev), False


def initialize(device: Union[str, torch.device] = "cuda") -> World:
    """Join the process group torchrun's environment describes (module
    docstring); returns this process's :class:`World`. No-op (a
    single-process World, no process group) when none of
    :data:`ENV_VARS` is set."""
    import torch.distributed as dist

    from dexiraft_tpu_torch.analysis import collective_trace

    global _STORE
    env = os.environ
    if not any(name in env for name in ENV_VARS):
        return World(0, 1, 0, resolve_device(device))
    if dist.is_initialized():
        raise RuntimeError("parallel.distributed.initialize: a process "
                           "group is already live (teardown() first)")
    rank = _env_int(env, "RANK")
    size = _env_int(env, "WORLD_SIZE")
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", size))
    dev, shared = rank_device(device, local_rank, local_world)
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # torch's env:// rendezvous: a TCPStore on MASTER_ADDR:MASTER_PORT
    # (rank 0 hosts it, or torchrun's agent does)
    store, rank, size = next(dist.rendezvous(
        "env://", rank=rank, world_size=size, timeout=TIMEOUT))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size, timeout=TIMEOUT)
    _STORE = store
    collective_trace.install(host=rank)
    print(f"[dist] backend={backend} world={size} rank={rank} "
          f"device={dev}", flush=True)
    return World(rank, size, local_rank, dev, backend, local_world)


def mesh_groups(world: World, n_data: int, n_fsdp: int):
    """(data group, fsdp group) of ``world.rank`` on the (data, fsdp)
    grid whose rank r has data index r // n_fsdp and fsdp index
    r % n_fsdp (fsdp innermost, as JAX's ``make_mesh_fsdp`` places it):
    the data group joins the ranks that hold this rank's shards, the
    fsdp group the ranks that read this rank's rows. Every rank builds
    every group, in the same order (``dist.new_group`` is collective
    over the world), once per mesh."""
    import torch.distributed as dist

    if n_data * n_fsdp != world.size:
        raise ValueError(f"a {n_data}x{n_fsdp} (data, fsdp) grid needs "
                         f"{n_data * n_fsdp} ranks, the world has "
                         f"{world.size}")
    data_group = fsdp_group = None
    for f in range(n_fsdp):
        group = dist.new_group([d * n_fsdp + f for d in range(n_data)])
        if world.rank % n_fsdp == f:
            data_group = group
    for d in range(n_data):
        group = dist.new_group([d * n_fsdp + f for f in range(n_fsdp)])
        if world.rank // n_fsdp == d:
            fsdp_group = group
    return data_group, fsdp_group


def coordination_store():
    """The store the process group rendezvoused on (the consensus
    layer's channel); raises before :func:`initialize` joined one."""
    if _STORE is None:
        raise RuntimeError(
            "multi-rank consensus needs a process group: call "
            "parallel.distributed.initialize() (under torchrun) before "
            "the first Coordinator call")
    return _STORE


def teardown() -> None:
    """Leave the process group (no-op without one)."""
    import torch.distributed as dist

    global _STORE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None
