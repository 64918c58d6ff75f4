"""Placement audit of the port's multi-rank train state and batches.

The port's counterpart of ``dexiraft_tpu/analysis/shardaudit.py``. JAX
compiles its steps on a virtual 8-device CPU mesh and reads the
shardings the partitioner resolved. Here every rank is a process that
places its own tensors, so the audit reads what the port's code places,
for every rank of a virtual mesh in one process (``parallel.layout.
virtual_mesh``: no process group, no forward, a ``meta`` model):

  * the state: for each rank the ``ShardPlan`` that ``parallel.fsdp.
    shard_state`` builds, its storage (a slice of each sharded
    parameter, the parameter itself otherwise) and the Adam moments the
    optimizer over that storage creates (``AdamW.init_state``); the same
    after the step's exit fence (``ShardPlan.free_``);
  * the batch: each rank's rows as the steps cut them,
    ``parallel.layout.local_rows`` over the data axis and, on a seq mesh,
    ``parallel.halo.slab`` over the seq axis (read on index-coded
    tensors, so the audit sees which rows and image rows each rank
    holds); the metrics the train step returns, 0-d values every rank
    holds after their reduction.

From the ranks' pieces of each tensor it derives the spec: per dim the
mesh axes the pieces vary along, written in the flax logical order
(``parallel.layout.logical_dims``: HWIO for a conv kernel), so that the
strings compare with JAX's (``P(None, None, None, 'fsdp')``). Each group
is summarised in JAX's format: the sorted set of specs, the leaf count,
the whole bytes and the largest leaf's.

Legs (golden files beside this module):

  * ``train_fsdp`` (``layout_golden_fsdp.json``): v1 small, 48x64, batch
    8, 2 iterations, the fence step on JAX's (data 2, fsdp 2, seq 2)
    mesh. The file also holds ``plans``: each ``ShardPlan.layout()`` of
    full-width v1 and v5 at 2 and 4 ways with its parameters' section,
    the production leaf policy pinned.
  * ``train_halo`` (``layout_golden_halo.json``): the same model on the
    same mesh, through ``halo.check_halo_support``.
  * ``train`` and ``eval`` (``layout_golden.json``, JAX's file's name):
    the fence train step and the fence eval step on JAX's train mesh,
    ``{data: 4, seq: 2}``, in JAX's geometry; the eval step in its
    production configuration (v1 small, ``corr_impl="flash"``,
    ``fused_update=True``). The eval step reads each replica's whole
    parameters and its rows and image rows of image1, image2 and
    flow_init (``train.step._seq_slab``, the step's own cut, on
    index-coded inputs); its outputs are the forward of those slabs,
    one output row block per input row block, read by the same cut.
  * ``serve``, ``serve_encode``, ``serve_refine`` (``layout_golden.json``):
    the data-parallel eval step and the streaming encode and refine steps
    (``train.step.make_*_step(mesh=)``) on JAX's serve mesh, ``{data:
    8}``, here 8 entries of the CPU
    (``parallel.layout.make_serve_mesh(devices=("cpu",) * 8)``), in JAX's
    geometry and production configuration: v1 small with
    ``corr_impl="flash"``, ``fused_update=True``, 48x64, batch 8, 2
    iterations. The audit runs each step once on index-coded inputs put
    by ``parallel.layout.shard_batch`` and reads what each entry holds:
    the parameters of its replica that the step reads (recorded by a
    ``TorchFunctionMode``: JAX's compiled step drops the variables it
    does not use, so encode reads the encoders' 88 leaves and refine
    the update block's 18), the input rows of each shard the step reads
    (features2's ``ctx`` is not read by refine, as in JAX) and the rows
    of each output's shards (``RowShards.rows``). Groups carry JAX's
    positional names (``[0]['params']``, ``[1]``, ``['ctx']``, ...); the
    golden's header lists the port argument each stands for
    (:data:`SERVE_NAMES`).

All three files carry the declared groups of JAX's ``declared_groups``
at the production geometry (440x1024, batch 8), resolved on each
golden's JAX mesh (data 2, fsdp 2, seq 2 for the fsdp and halo files;
JAX's train mesh, data 4, seq 2, for ``layout_golden.json``): each
group's canonical spec
(``parallel.layout.group_spec``), total and per-rank megabytes, whether
it is replicated, and the flag of a replicated group over the threshold
(64 MB) that ``parallel.layout.REPLICATED_OK`` does not exempt.

Group names follow the port's train state: ``[0].params``,
``[0].opt_state`` (the two Adam moments of every parameter),
``[0].opt_count`` (the optimizer's step count, a Python int in its
parameter group, counted at 8 bytes, as is ``[0].step``),
``[0].generator`` (the generator's state: JAX's ``[0].rng`` key), and
``[1]['image1']`` ... for the batch, ``[1]['loss']`` ... for the train
step's metrics (its ``lr`` a Python float, counted at 8 bytes: JAX's is
an f32 array). JAX's ``[0].opt_state`` holds the moments and two int32
counts (optax's adam and schedule counts); the goldens' header lists
these correspondences.

  python -m dexiraft_tpu_torch.analysis.shardaudit [--write]

audits every leg against its golden and exits nonzero on any drift or
flagged group; ``--write`` regenerates the goldens instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
FSDP_GOLDEN = "layout_golden_fsdp.json"
HALO_GOLDEN = "layout_golden_halo.json"
SERVE_GOLDEN = "layout_golden.json"

#: JAX's audit geometry and its production reference geometry
AUDIT_IMAGE = (48, 64)
AUDIT_BATCH = 8
AUDIT_ITERS = 2
PROD_IMAGE = (440, 1024)
PROD_BATCH = 8
DEFAULT_THRESHOLD_MB = 64.0
#: the legs' meshes, and the mesh the declared groups resolve on (JAX's)
FSDP_MESH = {"data": 2, "fsdp": 2, "seq": 2}
HALO_MESH = {"data": 2, "fsdp": 2, "seq": 2}
#: the fence train and eval legs' mesh (JAX's train mesh)
TRAIN_MESH = {"data": 4, "seq": 2}
DECLARED_MESH = {"data": 2, "fsdp": 2, "seq": 2}
#: the serve legs' mesh, and the mesh the serve golden's declared groups
#: resolve on (JAX's serve mesh and its train mesh)
SERVE_MESH = {"data": 8}
SERVE_DECLARED_MESH = {"data": 4, "seq": 2}
#: the production plans pinned: (variant, fsdp size)
PLANS = (("v1", 2), ("v1", 4), ("v5", 2), ("v5", 4))
#: bytes of a Python int the state holds (the step, the optimizer count)
INT_BYTES = 8
#: what the goldens' groups are in JAX's report
RENAMED = {"[0].rng": "[0].generator"}
#: the train step's metrics: name -> bytes of the 0-d value every rank
#: returns (``lr`` is the update's Python float)
METRIC_BYTES = {"loss": 4, "epe": 4, "1px": 4, "3px": 4, "5px": 4,
                "lr": INT_BYTES, "state_finite": 1}
OPT_STATE_SCALARS = {
    "jax": "[0].opt_state holds the moments and two int32 counts "
           "(optax's adam and schedule counts)",
    "port": "[0].opt_state holds the moments; the one count is "
            "[0].opt_count (the optimizer's parameter group)",
    "jax_scalar_leaves": 2, "jax_scalar_bytes": 8,
}
#: the serve legs' groups: JAX's positional name -> what it is in the
#: port (the step's argument or output)
SERVE_NAMES = {
    "serve": {
        "in": {"[0]['params']": "each replica's parameters",
               "[1]": "image1", "[2]": "image2", "[5]": "flow_init"},
        "out": {"[0]": "flow_low", "[1]": "flow_up"}},
    "serve_encode": {
        "in": {"[0]['params']": "each replica's parameters",
               "[1]": "frame"},
        "out": {"['ctx']": "ctx", "['fmap']": "fmap"}},
    "serve_refine": {
        "in": {"[0]['params']": "each replica's parameters",
               "[1]['ctx']": "features1['ctx']",
               "[1]['fmap']": "features1['fmap']",
               "[2]['ctx']": "features2['ctx']",
               "[2]['fmap']": "features2['fmap']", "[3]": "flow_init"},
        "out": {"[0]": "flow_low", "[1]": "flow_up"}},
    "eval": {
        "in": {"[0]['params']": "the model's parameters",
               "[1]": "image1", "[2]": "image2", "[5]": "flow_init"},
        "out": {"[0]": "flow_low", "[1]": "flow_up"}},
}


# ---- specs from placements ---------------------------------------------


def _coords(mesh) -> Dict[str, int]:
    from dexiraft_tpu_torch.parallel.layout import (DATA_AXIS, FSDP_AXIS,
                                                    SEQ_AXIS)

    return {DATA_AXIS: mesh.data_index, FSDP_AXIS: mesh.fsdp_index,
            SEQ_AXIS: mesh.seq_index}


def _dim_axes(pieces: Sequence[Tuple[int, ...]],
              coords: Sequence[Dict[str, int]], full: int,
              axes: Sequence[str]):
    """The mesh axis one dim is split over, from every rank's piece (the
    indices it holds) and mesh coordinates: None when every rank holds
    the whole dim, else the first axis such that ranks equal on it hold
    the same piece and the pieces of its coordinates tile the dim.
    Raises when no axis explains the placement."""
    if all(p == tuple(range(full)) for p in pieces):
        return None
    for axis in axes:
        by: Dict[int, Tuple[int, ...]] = {}
        if all(by.setdefault(c[axis], p) == p
               for p, c in zip(pieces, coords)) and \
                sorted(i for p in by.values() for i in p) == \
                list(range(full)):
            return axis
    raise ValueError(f"pieces {pieces[:4]}... of a dim of {full} follow "
                     "no mesh axis")


def _spec(pieces_by_dim: Sequence[Sequence[Tuple[int, ...]]],
          coords: Sequence[Dict[str, int]], shape: Sequence[int],
          axes: Sequence[str], order: Optional[Sequence[int]] = None,
          trim: bool = False) -> Tuple[Any, ...]:
    """The spec of a tensor of torch ``shape`` from each dim's pieces,
    in logical order (``order``: torch dim -> logical dim): P() when no
    dim is split; ``trim`` drops trailing Nones (JAX's batch specs name
    the leading dims only, its parameter specs every dim)."""
    entries = [_dim_axes(p, coords, n, axes)
               for p, n in zip(pieces_by_dim, shape)]
    if order is not None:
        logical: List[Any] = [None] * len(entries)
        for t, j in enumerate(order):
            logical[j] = entries[t]
        entries = logical
    while entries and (trim or all(e is None for e in entries)) \
            and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _piece(leaf, f: int, n: int, dim: int) -> Tuple[int, ...]:
    """The indices along torch ``dim`` that fsdp rank ``f`` of ``n``
    stores of ``leaf`` (``Leaf.piece`` on an index vector)."""
    full = leaf.shape[dim]
    if leaf.dim != dim:
        return tuple(range(full))
    shape = [1] * len(leaf.shape)
    shape[dim] = full
    return tuple(leaf.piece(torch.arange(full).view(shape), f, n)
                 .reshape(-1).tolist())


class _Group:
    def __init__(self):
        self.specs, self.leaves, self.bytes, self.max = set(), 0, 0, 0

    def add(self, spec: Tuple[Any, ...], nbytes: int) -> None:
        from dexiraft_tpu_torch.parallel.layout import spec_str

        self.specs.add(spec_str(spec))
        self.leaves += 1
        self.bytes += nbytes
        self.max = max(self.max, nbytes)

    def summary(self) -> Dict[str, Any]:
        return {"specs": sorted(self.specs), "leaves": self.leaves,
                "bytes": self.bytes, "max_leaf_bytes": self.max}


def _nbytes(shape: Sequence[int], itemsize: int) -> int:
    n = itemsize
    for s in shape:
        n *= int(s)
    return n


# ---- the state ----------------------------------------------------------


def _meta_model(cfg):
    from dexiraft_tpu_torch.models.raft import RAFT

    with torch.device("meta"):
        return RAFT(cfg)


def _rank_state(cfg, tc, mesh):
    """(plan, optimizer) of one rank, as ``shard_state`` builds them on
    a meta model: the plan, AdamW over its storage, the moments made."""
    from dexiraft_tpu_torch.parallel.fsdp import ShardPlan
    from dexiraft_tpu_torch.train.optimizer import make_optimizer

    plan = ShardPlan(_meta_model(cfg), mesh)
    opt = make_optimizer(plan.storage, tc.lr, tc.num_steps, tc.wdecay,
                         tc.epsilon, tc.clip)
    opt.init_state()
    return plan, opt


def _leaf_order(plan):
    """Each leaf's torch dim -> logical dim (the weight bridge's)."""
    from dexiraft_tpu_torch.parallel.fsdp import _param_leaves
    from dexiraft_tpu_torch.parallel.layout import logical_dims

    return [logical_dims(module, attr, len(p.shape))
            for p, module, attr, _ in _param_leaves(plan.model)]


def _stored_dim(leaf, storage_shape: Sequence[int], n: int
                ) -> Optional[int]:
    """The dim a rank's stored tensor of ``leaf`` is cut on, read off its
    shape (None: whole); a cut that is not 1/n of the leaf raises."""
    cut = [d for d, (a, b) in enumerate(zip(leaf.shape, storage_shape))
           if a != b]
    if len(storage_shape) != len(leaf.shape) or len(cut) > 1 or (
            cut and storage_shape[cut[0]] * n != leaf.shape[cut[0]]):
        raise ValueError(f"{leaf.keys[0]}: stored {tuple(storage_shape)} "
                         f"is no 1/{n} slice of {leaf.shape}")
    if cut and cut[0] != leaf.dim:
        raise ValueError(f"{leaf.keys[0]}: stored cut on dim {cut[0]}, "
                         f"the plan says {leaf.dim}")
    return cut[0] if cut else None


def _state_groups(ranks, axes: Sequence[str]) -> Dict[str, Dict[str, Any]]:
    """The state's groups over every rank's (plan, optimizer, coords)."""
    plan0 = ranks[0][0]
    order = _leaf_order(plan0)
    coords = [c for _, _, c in ranks]
    params, moments = _Group(), _Group()
    for i, leaf in enumerate(plan0.leaves):
        nd = len(leaf.shape)
        stored, mom = [], []
        for plan, opt, _ in ranks:
            mine = plan.leaves[i]
            n = plan.mesh.n_fsdp
            st = opt.state[mine.storage]
            stored.append(_stored_dim(mine, mine.storage.shape, n))
            mom.append([_stored_dim(mine, st[k].shape, n)
                        for k in ("mu", "nu")])
        pieces = [[_piece(plan.leaves[i], plan.mesh.fsdp_index,
                          plan.mesh.n_fsdp, d) for plan, _, _ in ranks]
                  for d in range(nd)]
        spec = _spec(pieces, coords, leaf.shape, axes, order[i])
        nbytes = _nbytes(leaf.shape, leaf.param.element_size())
        params.add(spec, nbytes)
        if any(m != [s, s] for m, s in zip(mom, stored)):
            raise ValueError(f"{leaf.keys[0]}: moments cut {mom} against "
                             f"the parameter's {stored}")
        for _ in ("mu", "nu"):
            moments.add(spec, nbytes)
    scalar = ()
    out = {"[0].params": params.summary(),
           "[0].opt_state": moments.summary()}
    for name in ("[0].opt_count", "[0].step"):
        g = _Group()
        g.add(scalar, INT_BYTES)
        out[name] = g.summary()
    g = _Group()
    g.add(scalar, int(torch.Generator().get_state().numel()))
    out["[0].generator"] = g.summary()
    return dict(sorted(out.items()))


# ---- the batch ------------------------------------------------------------


def _batch_groups(mesh_of, n_ranks: int, axes: Sequence[str],
                  accum: int, seq: bool) -> Dict[str, Dict[str, Any]]:
    """The batch's groups: each rank's rows (``local_rows``) and, on a
    seq mesh, its image rows (``halo.slab`` of the rank's rows, as the
    fence and halo steps cut them), read on index-coded tensors."""
    from dexiraft_tpu_torch.parallel.halo import slab
    from dexiraft_tpu_torch.parallel.layout import data_axis, local_rows

    b, (h, w) = AUDIT_BATCH, AUDIT_IMAGE
    shapes = {"image1": (b, h, w, 3), "image2": (b, h, w, 3),
              "flow": (b, h, w, 2), "valid": (b, h, w)}
    coords, rows, image_rows = [], [], []
    for r in range(n_ranks):
        mesh = mesh_of(r)
        coords.append(_coords(mesh))
        mine = local_rows(b, accum, data_axis(mesh))
        rows.append(tuple(range(b)) if mine is None
                    else tuple(mine.tolist()))
        ids = torch.arange(h).view(1, h, 1)
        image_rows.append(tuple((slab(ids, mesh.seq, dim=1) if seq else ids)
                                .reshape(-1).tolist()))
    out = {}
    for key, shape in shapes.items():
        pieces = [rows, image_rows] + [[tuple(range(n))] * n_ranks
                                       for n in shape[2:]]
        g = _Group()
        g.add(_spec(pieces, coords, shape, axes, trim=True),
              _nbytes(shape, 4))
        out[f"[1][{key!r}]"] = g.summary()
    return out


# ---- the legs -------------------------------------------------------------


def _audit_configs():
    from dexiraft_tpu_torch.config import TrainConfig, raft_v1

    cfg = raft_v1(small=True)
    tc = TrainConfig(name="shardaudit", stage="chairs", num_steps=10,
                     batch_size=AUDIT_BATCH, image_size=AUDIT_IMAGE,
                     iters=AUDIT_ITERS)
    return cfg, tc


def _metric_groups() -> Dict[str, Dict[str, Any]]:
    out = {}
    for name, nbytes in METRIC_BYTES.items():
        g = _Group()
        g.add((), nbytes)
        out[f"[1][{name!r}]"] = g.summary()
    return out


def _mesh_dims(mesh_axes: Dict[str, int]) -> Tuple[int, int, int]:
    from dexiraft_tpu_torch.parallel.layout import (DATA_AXIS, FSDP_AXIS,
                                                    SEQ_AXIS)

    return (mesh_axes[DATA_AXIS], mesh_axes.get(FSDP_AXIS, 1),
            mesh_axes.get(SEQ_AXIS, 1))


def audit_leg(mesh_axes: Dict[str, int], halo: bool) -> Dict[str, Any]:
    """One train leg's section: {mesh, in, out} (module docstring)."""
    from dexiraft_tpu_torch.parallel.layout import LAYOUT_AXES, virtual_mesh

    cfg, tc = _audit_configs()
    dims = _mesh_dims(mesh_axes)
    n_ranks = dims[0] * dims[1] * dims[2]

    def mesh_of(r):
        return virtual_mesh(r, *dims)

    if halo:
        from dexiraft_tpu_torch.parallel.halo import check_halo_support

        check_halo_support(cfg, tc, mesh_of(0))
    elif dims[2] > 1:
        from dexiraft_tpu_torch.train.step import check_seq_fence

        check_seq_fence(cfg)
    ranks = []
    for r in range(n_ranks):
        mesh = mesh_of(r)
        plan, opt = _rank_state(cfg, tc, mesh)
        ranks.append((plan, opt, _coords(mesh)))
    state_in = _state_groups(ranks, LAYOUT_AXES)
    batch = _batch_groups(mesh_of, n_ranks, LAYOUT_AXES, tc.accum_steps,
                          seq=dims[2] > 1)
    for plan, _, _ in ranks:
        plan.free_()  # the step's exit fence: only the slices stay
        if any(leaf.param.numel() for leaf in plan.sharded):
            raise ValueError("a sharded parameter kept its full storage")
    state_out = _state_groups(ranks, LAYOUT_AXES)
    return {"mesh": dict(mesh_axes), "in": {**state_in, **batch},
            "out": {**state_out, **_metric_groups()}}


def audit_eval_leg(mesh_axes: Dict[str, int] = TRAIN_MESH
                   ) -> Dict[str, Any]:
    """The fence eval step's section on a seq mesh (module docstring):
    each rank's whole parameters (a meta model of the production
    config) and its rows and image rows of the inputs, cut by the step's
    own ``_seq_slab`` after ``local_rows``; the outputs the same cut of
    the outputs' rows."""
    from dexiraft_tpu_torch.config import raft_v1
    from dexiraft_tpu_torch.parallel.layout import (LAYOUT_AXES, data_axis,
                                                    local_rows, virtual_mesh)
    from dexiraft_tpu_torch.train.step import _seq_slab, check_seq_fence

    cfg = raft_v1(small=True, corr_impl="flash", fused_update=True)
    check_seq_fence(cfg)
    dims = _mesh_dims(mesh_axes)
    n_ranks = dims[0] * dims[1] * dims[2]
    b, (h, w) = AUDIT_BATCH, AUDIT_IMAGE
    shapes = {"[1]": (b, h, w, 3), "[2]": (b, h, w, 3),
              "[5]": (b, h // 8, w // 8, 2), "out[0]": (b, h // 8, w // 8, 2),
              "out[1]": (b, h, w, 2)}
    coords, pieces = [], {k: [] for k in shapes}
    for r in range(n_ranks):
        mesh = virtual_mesh(r, *dims)
        coords.append(_coords(mesh))
        mine = local_rows(b, 1, data_axis(mesh))
        for key, shape in shapes.items():
            rows = tuple(range(b)) if mine is None else tuple(mine.tolist())
            ids = torch.arange(shape[1]).view(1, shape[1], 1)
            pieces[key].append((rows, tuple(
                _seq_slab(ids, mesh.seq).reshape(-1).tolist())))
    groups = {}
    for key, shape in shapes.items():
        dims_pieces = ([[p[0] for p in pieces[key]],
                        [p[1] for p in pieces[key]]]
                       + [[tuple(range(n))] * n_ranks for n in shape[2:]])
        g = _Group()
        g.add(_spec(dims_pieces, coords, shape, LAYOUT_AXES, trim=True),
              _nbytes(shape, 4))
        groups[key] = g.summary()
    params = _Group()
    for p in _meta_model(cfg).parameters():
        params.add((), _nbytes(p.shape, p.element_size()))
    return {"mesh": dict(mesh_axes),
            "in": {"[0]['params']": params.summary(),
                   **{k: groups[k] for k in ("[1]", "[2]", "[5]")}},
            "out": {"[0]": groups["out[0]"], "[1]": groups["out[1]"]}}


def plan_section(plan) -> Dict[str, Any]:
    """One rank's ``ShardPlan``: its ``layout()`` and its parameters'
    group, read off its storage (the live audit on a card prints this
    for its real plan)."""
    from dexiraft_tpu_torch.parallel.layout import FSDP_AXIS

    order = _leaf_order(plan)
    g = _Group()
    for leaf, o in zip(plan.leaves, order):
        dim = _stored_dim(leaf, leaf.storage.shape, plan.mesh.n_fsdp)
        if dim is None:
            spec: Tuple[Any, ...] = ()
        else:
            entries: List[Any] = [None] * len(leaf.shape)
            entries[o[dim]] = FSDP_AXIS
            spec = tuple(entries)
        g.add(spec, _nbytes(leaf.shape, leaf.param.element_size()))
    return {"layout": plan.layout(), "params": g.summary()}


def audit_plans() -> Dict[str, Any]:
    """Rank 0's plan of full-width v1 and v5 at 2 and 4 ways."""
    from dexiraft_tpu_torch.config import VARIANTS
    from dexiraft_tpu_torch.parallel.fsdp import ShardPlan
    from dexiraft_tpu_torch.parallel.layout import virtual_mesh

    out = {}
    for variant, n in PLANS:
        plan = ShardPlan(_meta_model(VARIANTS[variant]()),
                         virtual_mesh(0, 1, n))
        out[f"{variant}@{n}"] = plan_section(plan)
    return out


def declared_entries(halo: bool) -> List[Tuple[str, int]]:
    """(group, total bytes at the production geometry), JAX's
    ``declared_groups`` figures: full-batch totals, so every axis of a
    group's spec divides its dim."""
    h, w = PROD_IMAGE
    b = PROD_BATCH
    hw8 = (h // 8) * (w // 8)
    fmap = b * hw8 * 256 * 4  # one (B, H/8, W/8, 256) fp32 fmap
    pyramid = sum(b * (hw8 >> (2 * i)) * 256 * 4 for i in range(4))
    entries = [("batch", b * h * w * 3 * 4 * 2),
               ("carry", b * hw8 * 2 * 4),
               ("corr_fmaps", fmap + pyramid),
               ("params", 5_300_000 * 4),
               ("opt_state", 2 * 5_300_000 * 4)]
    if halo:  # fmap1 + fmap2 + context of the row-sharded forward
        entries.append(("halo_activations", 3 * fmap))
    return entries


def declared_groups(halo: bool, axes: Dict[str, int] = DECLARED_MESH
                    ) -> Dict[str, Any]:
    """Each declared group's spec on a mesh of ``axes``, total and
    per-rank MB, replication and the over-threshold flag (module
    docstring)."""
    from dexiraft_tpu_torch.parallel.layout import (REPLICATED_OK,
                                                    group_spec, spec_str)

    out = {}
    for name, total in declared_entries(halo):
        spec = group_spec(name, axes)
        shards = 1
        for axis in spec:
            shards *= axes.get(axis, 1)
        per_rank = total // shards
        replicated = shards == 1
        out[name] = {
            "spec": spec_str(spec),
            "total_mb": round(total / 2**20, 2),
            "per_device_mb": round(per_rank / 2**20, 2),
            "replicated": replicated,
            "flagged": (replicated
                        and per_rank > DEFAULT_THRESHOLD_MB * 2**20
                        and name not in REPLICATED_OK),
        }
    return out


def _header(serve: bool = False) -> Dict[str, Any]:
    from dexiraft_tpu_torch.parallel.layout import LAYOUT_AXES

    head = {"version": 1, "axes": {a: a for a in LAYOUT_AXES},
            "audit_image": list(AUDIT_IMAGE), "audit_batch": AUDIT_BATCH,
            "renamed_from_jax": dict(RENAMED),
            "opt_state_scalars": dict(OPT_STATE_SCALARS)}
    if serve:  # JAX's group names, each standing for a port argument
        return {**head, "positional_names": SERVE_NAMES}
    return head


# ---- the serve legs -------------------------------------------------------


def _tensors(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _reading():
    """A ``TorchFunctionMode`` that records the id of every tensor an op
    takes as an argument (``.ids``): what a step reads."""
    from torch.overrides import TorchFunctionMode

    class Reads(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.ids = set()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.ids.update(id(t) for t in _tensors([args, kwargs], []))
            return func(*args, **kwargs)

    return Reads()


def _coded(shape: Sequence[int]) -> "np.ndarray":
    """A float32 batch whose every value is its row's index."""
    import numpy as np

    rows = np.arange(shape[0], dtype=np.float32)
    return np.broadcast_to(rows.reshape((-1,) + (1,) * (len(shape) - 1)),
                           shape).copy()


def _rows_group(pieces: List[Tuple[int, ...]], shape: Sequence[int],
                n: int) -> Dict[str, Any]:
    """The group of one batch tensor of ``shape`` whose entry i holds the
    rows ``pieces[i]`` (every other dim whole)."""
    from dexiraft_tpu_torch.parallel.layout import DATA_AXIS

    coords = [{DATA_AXIS: i} for i in range(n)]
    dims = [pieces] + [[tuple(range(d))] * n for d in shape[1:]]
    g = _Group()
    g.add(_spec(dims, coords, shape, (DATA_AXIS,), trim=True),
          _nbytes(shape, 4))
    return g.summary()


def _params_group(replicas, mesh, reads) -> Dict[str, Any]:
    """``[0]['params']``: the parameters of each replica that the step
    read, each whole on its entry (P() when every entry holds all of
    it); every entry must have read the same set."""
    from dexiraft_tpu_torch.parallel.layout import DATA_AXIS

    read = [[(name, p) for name, p in rep.named_parameters()
             if id(p) in reads] for rep in replicas]
    names = {tuple(name for name, _ in r) for r in read}
    if len(names) != 1:
        raise ValueError("the entries' replicas read different parameters")
    coords = [{DATA_AXIS: i} for i in range(mesh.size)]
    g = _Group()
    for j, (name, p0) in enumerate(read[0]):
        held = [r[j][1] for r in read]
        if any(p.device != d for p, d in zip(held, mesh.devices)):
            raise ValueError(f"{name}: a replica's copy is off its entry")
        pieces = [[tuple(range(n)) for n in p.shape] for p in held]
        g.add(_spec(list(zip(*pieces)) if p0.dim() else [], coords,
                    p0.shape, (DATA_AXIS,)),
              _nbytes(p0.shape, p0.element_size()))
    return g.summary()


def _shard_rows(x) -> List[Tuple[int, ...]]:
    """Each shard's rows of an index-coded RowShards, read off its
    values."""
    return [tuple(int(v) for v in s.reshape(s.shape[0], -1)[:, 0].tolist())
            for s in x.shards]


def _out_group(x, n: int) -> Dict[str, Any]:
    return _rows_group([tuple(range(a, b)) for a, b in x.rows], x.shape, n)


def audit_serve_leg(step_name: str) -> Dict[str, Any]:
    """One serve leg's section (module docstring): ``serve`` (the
    data-parallel eval step), ``serve_encode`` or ``serve_refine``."""
    from dexiraft_tpu_torch.config import raft_v1
    from dexiraft_tpu_torch.models.raft import create_model
    from dexiraft_tpu_torch.parallel.layout import (DATA_AXIS,
                                                    make_serve_mesh,
                                                    replicate, shard_batch)
    from dexiraft_tpu_torch.train.step import (make_encode_step,
                                               make_eval_step,
                                               make_refine_step)

    n = SERVE_MESH[DATA_AXIS]
    mesh = make_serve_mesh(devices=("cpu",) * n)
    cfg = raft_v1(small=True, corr_impl="flash", fused_update=True)
    replicas = replicate(create_model(cfg, seed=0, device="cpu"), mesh)
    b, (h, w) = AUDIT_BATCH, AUDIT_IMAGE
    image = (b, h, w, 3)
    flow = (b, h // 8, w // 8, 2)
    names = SERVE_NAMES[step_name]
    if step_name == "serve":
        inputs = {"image1": image, "image2": image, "flow_init": flow}
    elif step_name == "serve_encode":
        inputs = {"frame": image}
    else:  # index-coded features of the encode step's shapes
        encode = make_encode_step(replicas, mesh=mesh)
        feats = {f"features{k}": {
            key: shard_batch(_coded(v.shape), mesh)
            for key, v in encode(shard_batch(_coded(image), mesh)).items()}
            for k in (1, 2)}
        inputs = {"flow_init": flow}
    put = {k: shard_batch(_coded(shape), mesh) for k, shape in inputs.items()}
    args = dict(put)
    if step_name == "serve_refine":
        args.update({f"{f}[{k!r}]": v for f, d in feats.items()
                     for k, v in d.items()})
    held = {name: _shard_rows(x) for name, x in args.items()}
    if step_name == "serve":
        step = make_eval_step(replicas, AUDIT_ITERS, mesh=mesh)
    elif step_name == "serve_encode":
        step = make_encode_step(replicas, mesh=mesh)
    else:
        step = make_refine_step(replicas, AUDIT_ITERS, mesh=mesh)
    reads = _reading()
    with reads:  # the step's call only
        if step_name == "serve":
            outs = dict(zip(("flow_low", "flow_up"), step(
                put["image1"], put["image2"], put["flow_init"])))
        elif step_name == "serve_encode":
            outs = step(put["frame"])
        else:
            outs = dict(zip(("flow_low", "flow_up"), step(
                feats["features1"], feats["features2"], put["flow_init"])))
    groups_in = {"[0]['params']": _params_group(replicas, mesh, reads.ids)}
    for name, x in args.items():
        if not any(id(s) in reads.ids for s in x.shards):
            continue  # the step does not read it
        groups_in[_positional(names["in"], name)] = _rows_group(
            held[name], x.shape, n)
    groups_out = {_positional(names["out"], k): _out_group(v, n)
                  for k, v in outs.items()}
    return {"mesh": mesh.axes, "in": dict(sorted(groups_in.items())),
            "out": dict(sorted(groups_out.items()))}


def _positional(names: Dict[str, str], port_name: str) -> str:
    for jax_name, what in names.items():
        if what == port_name:
            return jax_name
    raise ValueError(f"no positional name for {port_name!r}")


SERVE_STEPS = ("serve", "serve_encode", "serve_refine")


def run_audit(leg: str) -> Dict[str, Any]:
    """The report of ``leg`` ("fsdp", "halo" or "serve": the file
    ``layout_golden.json``, whose steps are the serve legs and the fence
    ``train`` and ``eval`` legs)."""
    if leg == "serve":
        steps = {name: audit_serve_leg(name) for name in SERVE_STEPS}
        steps["train"] = audit_leg(TRAIN_MESH, False)
        steps["eval"] = audit_eval_leg()
        return {**_header(serve=True),
                "declared": declared_groups(False, SERVE_DECLARED_MESH),
                "steps": dict(sorted(steps.items()))}
    halo = leg == "halo"
    report = {**_header(),
              "declared": declared_groups(halo),
              "steps": {f"train_{leg}": audit_leg(
                  HALO_MESH if halo else FSDP_MESH, halo)}}
    if not halo:
        report["plans"] = audit_plans()
    return report


# ---- goldens --------------------------------------------------------------


def diff_golden(report: Dict[str, Any], golden: Dict[str, Any]
                ) -> List[str]:
    """Drift lines between a report and its golden: the header, every
    step group (specs, leaves, bytes), every declared group's fields and
    every plan."""
    drift: List[str] = []
    for key in ("version", "axes", "audit_image", "audit_batch",
                "renamed_from_jax", "opt_state_scalars",
                "positional_names"):
        if report.get(key) != golden.get(key):
            drift.append(f"{key}: golden {golden.get(key)!r} != current "
                         f"{report.get(key)!r}")
    steps, gsteps = report.get("steps", {}), golden.get("steps", {})
    for step in sorted(set(steps) | set(gsteps)):
        sec, gsec = steps.get(step), gsteps.get(step)
        if sec is None or gsec is None:
            drift.append(f"steps.{step}: "
                         + ("vanished" if sec is None else "not in golden"))
            continue
        if sec.get("mesh") != gsec.get("mesh"):
            drift.append(f"steps.{step}.mesh: golden {gsec.get('mesh')!r} "
                         f"!= current {sec.get('mesh')!r}")
        for io in ("in", "out"):
            drift.extend(_diff_groups(f"steps.{step}.{io}", sec.get(io, {}),
                                      gsec.get(io, {})))
    cur, gold = report.get("declared", {}), golden.get("declared", {})
    for name in sorted(set(cur) | set(gold)):
        if name not in cur:
            drift.append(f"declared.{name}: vanished from the layout")
        elif name not in gold:
            drift.append(f"declared.{name}: not in golden")
        elif cur[name] != gold[name]:
            drift.append(f"declared.{name}: golden {gold[name]} != "
                         f"current {cur[name]}")
    drift.extend(_diff_groups("plans", report.get("plans", {}),
                              golden.get("plans", {})))
    return drift


def _diff_groups(prefix: str, cur: Dict[str, Any], gold: Dict[str, Any]
                 ) -> List[str]:
    drift = []
    for group in sorted(set(cur) | set(gold)):
        c, g = cur.get(group), gold.get(group)
        if c is None:
            drift.append(f"{prefix}.{group}: vanished (golden {g})")
        elif g is None:
            drift.append(f"{prefix}.{group}: new group {c}: regenerate "
                         "the golden (--write) if intended")
        elif c != g:
            drift.append(f"{prefix}.{group}: golden {g} != current {c}")
    return drift


def flagged_groups(report: Dict[str, Any]) -> List[str]:
    """Declared groups over the threshold that resolve replicated."""
    return [f"declared.{name}: {g['total_mb']} MB resolves fully "
            f"replicated (spec {g['spec']}): shard it or pin it in "
            "parallel.layout.REPLICATED_OK"
            for name, g in report.get("declared", {}).items()
            if g.get("flagged")]


def load_golden(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_golden(report: Dict[str, Any], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser("shardaudit")
    p.add_argument("--write", action="store_true",
                   help="regenerate the goldens instead of diffing")
    p.add_argument("--golden_dir", default=_HERE,
                   help="where the goldens are (default: beside this "
                        "module)")
    args = p.parse_args(argv)
    bad = 0
    for leg, name in (("fsdp", FSDP_GOLDEN), ("halo", HALO_GOLDEN),
                      ("serve", SERVE_GOLDEN)):
        report = run_audit(leg)
        path = os.path.join(args.golden_dir, name)
        flagged = flagged_groups(report)
        for line in flagged:
            print(f"[{leg}] FLAGGED {line}")
        bad += len(flagged)
        if args.write:
            write_golden(report, path)
            print(f"[{leg}] wrote {path}")
            continue
        drift = diff_golden(report, load_golden(path))
        for line in drift:
            print(f"[{leg}] DRIFT {line}")
        bad += len(drift)
        print(f"[{leg}] {len(drift)} drift line(s), {len(flagged)} "
              f"flagged group(s) against {name}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
