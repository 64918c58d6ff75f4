"""fsdp storage sharding of the train state, in fence mode.

The port of the fsdp axis of ``dexiraft_tpu/parallel/layout.py``
(``state_sharding``, ``shard_state``, ``gather_state``) and of the fence
pattern of ``dexiraft_tpu/train/step.py``. On an fsdp mesh
(``parallel.layout.FsdpMesh``) the ranks of one fsdp group hold, between
steps, one slice each of every parameter the leaf policy shards
(``layout.param_shard_dim``) and of its two Adam moments; the model's
full-size storage of those parameters is freed, not just left
unreferenced. The train step gathers the parameters into the model at
entry (:meth:`ShardPlan.gather_`), runs the replicated step's forward and
backward on them, and updates only this rank's slices
(:meth:`ShardPlan.step_`): the clip norm is taken over the full gradient,
as the one-process step takes it, and AdamW is elementwise, so each
slice is exactly the replicated update restricted to it.

The gather is one ``all_gather_into_tensor`` of one flat buffer (every
rank's slices, concatenated in parameter order) over the fsdp subgroup
per step. On CUDA tensors over gloo (ranks sharing one card) the
backend runs it itself; a backend that cannot raises, and the step with
it.

:func:`shard_state` turns a replicated ``TrainState`` (every rank's
seeded ``create_state``, or a restored one) into its storage layout;
``state.shards`` is then the plan, and the optimizer is ``AdamW`` over
the plan's storage tensors (a slice for a sharded parameter, the model's
parameter for a replicated one), so its ``state_dict()`` keeps the
one-process optimizer's indices, with slice-shaped moments.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from dexiraft_tpu_torch.parallel.layout import FsdpMesh, param_shard_dim


@dataclasses.dataclass
class Leaf:
    """One parameter of the model: its state-dict keys (a parameter
    registered twice has two), the torch dim the fsdp axis shards (None:
    replicated), and its storage on this rank."""

    param: nn.Parameter
    keys: Tuple[str, ...]
    dim: Optional[int]
    shape: Tuple[int, ...]
    storage: torch.Tensor

    def piece(self, full: torch.Tensor, index: int, n: int) -> torch.Tensor:
        """Slice ``index`` of ``n`` of a full-size tensor of this leaf."""
        k = self.shape[self.dim] // n
        return full.narrow(self.dim, index * k, k)


def _param_leaves(model: nn.Module) -> List[Tuple[nn.Parameter, nn.Module,
                                                  str, Tuple[str, ...]]]:
    """(parameter, its module, its attribute, every state-dict key of
    it) for each parameter of ``model``, in ``model.parameters()``
    order."""
    owner: Dict[int, Tuple[nn.Module, str]] = {}
    keys: Dict[int, List[str]] = {}
    for prefix, module in model.named_modules(remove_duplicate=False):
        for attr, p in module.named_parameters(recurse=False):
            owner.setdefault(id(p), (module, attr))
            keys.setdefault(id(p), []).append(
                f"{prefix}.{attr}" if prefix else attr)
    return [(p, *owner[id(p)], tuple(keys[id(p)]))
            for p in model.parameters()]


def param_keys(model: nn.Module) -> List[Tuple[str, ...]]:
    """Every parameter's state-dict keys, in ``model.parameters()``
    order (the optimizer's state indices)."""
    return [keys for _, _, _, keys in _param_leaves(model)]


class ShardPlan:
    """Which parameters an fsdp mesh shards, and along which dim; this
    rank's slices; the gather and the sharded update (module
    docstring)."""

    def __init__(self, model: nn.Module, mesh: FsdpMesh):
        self.model, self.mesh = model, mesh
        n, f = mesh.n_fsdp, mesh.fsdp_index
        self.leaves: List[Leaf] = []
        for p, module, attr, keys in _param_leaves(model):
            shape = tuple(p.shape)
            dim, _ = param_shard_dim(module, attr, shape, n)
            leaf = Leaf(p, keys, dim, shape, p)
            if dim is not None:
                leaf.storage = nn.Parameter(
                    leaf.piece(p.detach(), f, n).clone(),
                    requires_grad=False)
            self.leaves.append(leaf)
        self.sharded = [leaf for leaf in self.leaves if leaf.dim is not None]
        self.gathered = False

    # ---- layout --------------------------------------------------------

    @property
    def storage(self) -> List[torch.Tensor]:
        """The optimizer's tensors, in ``model.parameters()`` order."""
        return [leaf.storage for leaf in self.leaves]

    def layout(self) -> Dict[str, object]:
        """What a checkpoint must match to restore onto this plan: the
        fsdp size and each sharded key's dim."""
        return {"n_fsdp": self.mesh.n_fsdp,
                "dims": {k: leaf.dim for leaf in self.sharded
                         for k in leaf.keys}}

    def sharded_keys(self) -> Dict[str, Leaf]:
        return {k: leaf for leaf in self.sharded for k in leaf.keys}

    # ---- the fences ----------------------------------------------------

    def free_(self) -> None:
        """Drop the full-size storage (and gradient) of every sharded
        parameter: between steps the rank holds only its slices."""
        for leaf in self.sharded:
            p = leaf.param
            p.data = p.data.new_empty(0)
            p.grad = None
        self.gathered = False

    def gather_(self) -> None:
        """All-gather every sharded parameter into the model, full size
        (the entry fence); a no-op when it already is."""
        if self.gathered or not self.sharded:
            self.gathered = True
            return
        n = self.mesh.n_fsdp
        flat = torch.cat([leaf.storage.detach().reshape(-1)
                          for leaf in self.sharded])
        every = all_gather_flat(flat, n, self.mesh.fsdp_group)
        offset = 0
        for leaf in self.sharded:
            piece = leaf.storage.shape
            size = leaf.storage.numel()
            parts = every[:, offset:offset + size].reshape((n,) + piece)
            leaf.param.data = torch.cat(parts.unbind(0), dim=leaf.dim)
            offset += size
        self.gathered = True

    @contextlib.contextmanager
    def gathered_params(self) -> Iterator[nn.Module]:
        """The model with its full parameters for the body (validation,
        an export), sharded again after; collective over the fsdp
        group."""
        self.gather_()
        try:
            yield self.model
        finally:
            self.free_()

    def step_(self, optimizer) -> None:
        """The sharded update, after the gradients of the full
        parameters are final: the clip norm over the full gradient, then
        AdamW over this rank's slices and the replicated parameters; the
        full parameters and gradients are freed."""
        norm, clip = None, optimizer.param_groups[0]["clip"]
        if clip and clip > 0:
            norm = optimizer.grad_norm([
                leaf.param.grad if leaf.param.grad is not None
                else torch.zeros_like(leaf.param) for leaf in self.leaves])
        f, n = self.mesh.fsdp_index, self.mesh.n_fsdp
        for leaf in self.sharded:
            g = leaf.param.grad
            leaf.storage.grad = (None if g is None
                                 else leaf.piece(g, f, n).contiguous())
        optimizer.step(grad_norm=norm)
        for leaf in self.sharded:
            leaf.storage.grad = None
        self.free_()

    # ---- state ---------------------------------------------------------

    def state_dicts(self, optimizer) -> Tuple[Dict[str, torch.Tensor],
                                              Dict[str, object]]:
        """(model, optimizer) state dicts in storage form: a sharded key
        holds this rank's slice."""
        slices = self.sharded_keys()
        model = {k: (slices[k].storage.detach() if k in slices else v)
                 for k, v in self.model.state_dict().items()}
        return model, optimizer.state_dict()

    def restrict(self, model_sd, optim_sd) -> Tuple[Dict[str, torch.Tensor],
                                                    Dict[str, object]]:
        """Whole (one-process) state dicts -> this rank's storage form
        under this plan: each sharded leaf's slice of the parameter and
        of its Adam moments, every other entry as it is."""
        f, n = self.mesh.fsdp_index, self.mesh.n_fsdp
        slices = self.sharded_keys()
        model = {k: (slices[k].piece(v, f, n).clone() if k in slices else v)
                 for k, v in model_sd.items()}
        state = {}
        for i, st in optim_sd["state"].items():
            leaf = self.leaves[int(i)]
            state[i] = st if leaf.dim is None else {
                k: (leaf.piece(v, f, n).clone()
                    if isinstance(v, torch.Tensor) and v.dim() else v)
                for k, v in st.items()}
        return model, dict(optim_sd, state=state)

    def load_state_dicts_(self, optimizer, model_sd, optim_sd) -> None:
        """Load storage-form state dicts (:meth:`state_dicts`'s) into the
        model, the slices and the optimizer."""
        slices = self.sharded_keys()
        own = self.model.state_dict()
        missing = set(own) - set(model_sd)
        if missing:
            raise KeyError(f"state dict lacks {sorted(missing)[:4]}")
        with torch.no_grad():
            for k, v in model_sd.items():
                if k in slices:
                    slices[k].storage.copy_(v)
                else:
                    own[k].copy_(v)
        optimizer.load_state_dict(optim_sd)

    def state_bytes(self, optimizer) -> Dict[str, int]:
        """This rank's bytes of parameters plus Adam moments between
        steps, the full state's, and the bytes still held by the model's
        sharded parameters (0 once freed)."""
        held = full = 0
        for leaf in self.leaves:
            st = optimizer.state.get(leaf.storage, {})
            tensors = [leaf.storage] + [st[k] for k in ("mu", "nu")
                                        if k in st]
            held += sum(t.numel() * t.element_size() for t in tensors)
            full += len(tensors) * leaf.param.element_size() * int(
                torch.Size(leaf.shape).numel())
        resident = sum(leaf.param.untyped_storage().nbytes()
                       for leaf in self.sharded)
        return {"held": held, "full": full, "resident_sharded": resident}


def all_gather_flat(flat: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, L): every rank of ``group``'s ``flat`` (L,), by rank."""
    import torch.distributed as dist

    out = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(n, -1)


def shard_state(state, mesh: FsdpMesh):
    """Put a replicated ``TrainState`` into its storage layout on
    ``mesh`` in place (every rank holds the same replicated state, as
    ``create_state`` or a replicated restore gives it): the plan keeps
    this rank's slices, the optimizer becomes AdamW over the plan's
    storage with its moments sliced alike and its step count kept, and
    the full-size sharded parameters are freed. Returns ``state``."""
    from dexiraft_tpu_torch.train.optimizer import AdamW

    if state.shards is not None:
        raise ValueError("the state is sharded already")
    plan = ShardPlan(state.model, mesh)
    old = state.optimizer
    group = old.param_groups[0]
    opt = AdamW(plan.storage, lr=group["max_lr"], num_steps=group["num_steps"],
                wdecay=group["weight_decay"], epsilon=group["eps"],
                clip=group["clip"], b1=group["b1"], b2=group["b2"])
    opt.load_state_dict(plan.restrict({}, old.state_dict())[1])
    plan.free_()
    state.optimizer, state.shards = opt, plan
    return state
