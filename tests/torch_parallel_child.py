"""One rank of the port's multi-rank step runs (tests/test_torch_parallel.py,
data-parallel; tests/test_torch_fsdp.py, fsdp storage sharding).

  RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
      python tests/torch_parallel_child.py SPEC.pt OUT_DIR

``SPEC.pt`` (torch.save) holds ``state_dict`` (the v1 weights), ``size``
(H, W), ``iters``, ``batches`` (global batches: dicts of NHWC numpy
arrays), ``scenarios`` (dicts with ``accum``, ``add_noise``,
``dropout``, ``lr``, ``num_steps``; optionally ``precision``, ``remat``,
``steps`` (how many of the batches) and ``save_at``) and optionally
``fsdp`` (the mesh's fsdp size). For each scenario the rank joins the
process group's train step on its rows of every global batch
(``parallel.local_rows`` of the mesh's data axis) and writes
``OUT_DIR/rank{r}.pt``: per scenario the per-step metrics and the final
state dict. On an fsdp mesh the state is sharded
(``parallel.fsdp.shard_state``), the state dict is the gathered one, and
the record adds the rank's state bytes between steps; with ``save_at``
the rank saves per-shard checkpoints (``train.checkpoint.save_sharded``)
under ``OUT_DIR/ckpt-<scenario>`` after that step and after the last,
records the gathered state dicts at both, then restores a fresh sharded
state from the ``save_at`` step (``resilience.verify.restore_verified``)
and records the steps after it again.

With ``resume`` in the spec (``dir``, ``step``, ``fsdp``) the rank joins
the mesh of that fsdp size (None: data-parallel), restores the step into
a fresh state of the mesh's layout (``resilience.verify.
restore_verified``: a step saved in another layout is resharded) and
writes one record: the restored storage (this rank's model entries and
Adam moments as it holds them), then the first scenario's steps on the
batches after the restored step (per-step metrics, the gathered state
dict).

With ``halo`` in the spec (tests/test_torch_halo.py) the rank joins a
(data 1, fsdp ``halo["fsdp"]``, seq 2) mesh instead and writes one
record: the halo eval step of the initial weights on ``eval_batch``, the
halo gradient function on the first batch (loss, metric sums, clip norm
and the gathered gradients), then ``halo["steps"]`` halo train steps
(per-step metrics, the gathered state dict); with ``halo["remat"]`` the
gradient again under ``remat="per_iter"``; with ``context`` also its
rows of ``context_parallel_corr`` and ``ring_corr_lookup``, with
``convs`` its rows of ``halo_conv`` beside the unsharded conv.

With ``fence_seq`` in the spec (tests/test_torch_fence_seq.py: ``fsdp``,
``batch``) the rank joins a (data, fsdp, seq 2) mesh for that global
batch and runs the spec's ``cases`` in order with the fence steps on it,
writing one record per case: a ``train`` case (``variant``, ``cfg``,
``tc``: the RAFTConfig and TrainConfig keywords, ``state_dict``,
``batches``: global batches) its per-step metrics and the gathered state
dict after the last step; an ``eval`` case (``variant``, ``cfg``,
``state_dict``, ``iters``, ``adaptive``, ``inputs``: the global batch's
arrays, ``iter_budget``) this rank's output slabs; a ``group_norm`` case
(``x``, NCHW, ``groups``, ``weight``, ``bias``) the seq-aware
``models.layers.GroupNorm`` of its rows of ``x``. Imports neither jax
nor the JAX package.
"""

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.parallel import initialize, local_rows, \
    make_train_mesh, teardown
from dexiraft_tpu_torch.parallel.fsdp import shard_state
from dexiraft_tpu_torch.parallel.layout import FsdpMesh, data_axis
from dexiraft_tpu_torch.resilience.verify import restore_verified
from dexiraft_tpu_torch.train import checkpoint as ckpt
from dexiraft_tpu_torch.train.state import create_state, train_model_config
from dexiraft_tpu_torch.train.step import make_train_step


def gathered(state) -> dict:
    """A copy of the model's whole state dict (its gathered parameters
    on an fsdp mesh)."""
    if state.shards is None:
        return {k: v.clone() for k, v in state.model.state_dict().items()}
    with state.shards.gathered_params() as model:
        return {k: v.clone() for k, v in model.state_dict().items()}


def configs(spec: dict, sc: dict):
    """(RAFTConfig, TrainConfig) of scenario ``sc``."""
    cfg = raft_v1(dropout=sc["dropout"])
    tc = TrainConfig(iters=spec["iters"], batch_size=4,
                     num_steps=sc["num_steps"], lr=sc["lr"],
                     accum_steps=sc["accum"], add_noise=sc["add_noise"],
                     precision=sc.get("precision", "fp32"),
                     remat=sc.get("remat", "none"))
    return cfg, tc


def fresh_state(spec: dict, cfg, tc, mesh):
    """The spec's weights in a fresh state, in ``mesh``'s storage
    layout."""
    model = RAFT(train_model_config(cfg, tc))
    model.load_state_dict(spec["state_dict"], strict=True)
    state = create_state(cfg, tc, device="cpu", model=model)
    return shard_state(state, mesh) if isinstance(mesh, FsdpMesh) else state


def local_batch(batch: dict, accum: int, mesh) -> dict:
    """This rank's rows of a global batch."""
    rows = local_rows(batch["image1"].shape[0], accum, data_axis(mesh))
    return {k: v if rows is None else v[rows.numpy()]
            for k, v in batch.items()}


def run(spec: dict, mesh, out_dir: str = None) -> list:
    out = []
    fsdp = isinstance(mesh, FsdpMesh)
    for i, sc in enumerate(spec["scenarios"]):
        cfg, tc = configs(spec, sc)

        def fresh():
            return fresh_state(spec, cfg, tc, mesh)

        state, step = fresh(), make_train_step(cfg, tc, mesh=mesh)
        batches = spec["batches"][:sc.get("steps", len(spec["batches"]))]

        def local(batch):
            return local_batch(batch, sc["accum"], mesh)

        save_at = sc.get("save_at")
        ckpt_dir = os.path.join(out_dir or ".", f"ckpt-{i}")
        metrics, rec = [], {}
        for n, batch in enumerate(batches, start=1):
            state, m = step(state, local(batch))
            metrics.append({k: float(v) for k, v in m.items()})
            if save_at is not None and n in (save_at, len(batches)):
                ckpt.save_sharded(ckpt_dir, state,
                                  barrier=lambda tag: dist.barrier())
                dist.barrier()  # rank 0's commit
                rec.setdefault("saved", {})[n] = gathered(state)
        if fsdp:
            rec["bytes"] = state.shards.state_bytes(state.optimizer)
            rec["layout"] = state.shards.layout()
        rec.update(metrics=metrics, state_dict=gathered(state))
        if save_at is not None:
            state, restored, _ = restore_verified(
                ckpt_dir, fresh(), step=save_at, delete_bad=False)
            resumed = []
            for batch in batches[restored:]:
                state, m = step(state, local(batch))
                resumed.append({k: float(v) for k, v in m.items()})
            rec.update(restored_step=restored, resumed_metrics=resumed)
        out.append(rec)
    return out


def _copy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _copy(v) for k, v in obj.items()}
    return obj


def resume(spec: dict, mesh) -> dict:
    """The ``resume`` record (module docstring)."""
    sc = spec["scenarios"][0]
    cfg, tc = configs(spec, sc)
    r = spec["resume"]
    state, restored, _ = restore_verified(
        r["dir"], fresh_state(spec, cfg, tc, mesh), step=r["step"],
        delete_bad=False)
    model_sd, optim_sd = state.state_dicts()
    rec = {"restored_step": restored,
           "storage": {"model": _copy(model_sd),
                       "optimizer": _copy(optim_sd["state"]),
                       "count": optim_sd["param_groups"][0]["count"]}}
    step = make_train_step(cfg, tc, mesh=mesh)
    metrics = []
    for batch in spec["batches"][restored:]:
        state, m = step(state, local_batch(batch, sc["accum"], mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    rec.update(metrics=metrics, state_dict=gathered(state))
    return rec


def gathered_grads(state, mesh) -> dict:
    """Every parameter's gradient, whole (a sharded leaf's slices
    gathered over the fsdp group), by state-dict key."""
    from dexiraft_tpu_torch.parallel.fsdp import all_gather_flat

    out = {}
    for leaf in state.shards.leaves:
        g = leaf.storage.grad
        if leaf.dim is not None:
            every = all_gather_flat(g.reshape(-1).contiguous(), mesh.n_fsdp,
                                    mesh.fsdp_group)
            g = torch.cat(every.view((mesh.n_fsdp,) + tuple(g.shape))
                          .unbind(0), dim=leaf.dim)
        out[leaf.keys[0]] = g.clone()
    return out


def run_context(ctx: dict, axis) -> dict:
    """This rank's rows of both context-parallel lookups."""
    from dexiraft_tpu_torch.parallel import context
    from dexiraft_tpu_torch.parallel.halo import slab

    f1, f2, coords = (slab(torch.from_numpy(ctx[k]), axis, dim=1)
                      for k in ("f1", "f2", "coords"))
    kw = dict(num_levels=ctx["levels"], radius=ctx["radius"])
    return {"context": context.context_parallel_corr(f1, f2, coords, axis,
                                                     **kw),
            "ring": context.ring_corr_lookup(f1, f2, coords, axis, **kw)}


def run_convs(x, cases: dict, axis) -> dict:
    """(kernel, stride) -> (this rank's halo_conv rows, the unsharded
    conv of the whole ``x``, computed here)."""
    import torch.nn.functional as F

    from dexiraft_tpu_torch.parallel.halo import halo_conv, slab

    x = torch.from_numpy(x)
    out = {}
    for (kh, stride), (w, b) in cases.items():
        w, b = torch.from_numpy(w), torch.from_numpy(b)
        out[(kh, stride)] = (halo_conv(slab(x, axis), w, b, axis, stride),
                             F.conv2d(x, w, b, stride, kh // 2))
    return out


def run_halo(spec: dict, world) -> dict:
    from dexiraft_tpu_torch.parallel import halo
    from dexiraft_tpu_torch.train.step import make_eval_step, \
        make_halo_grad_fn

    h = spec["halo"]
    cfg = raft_v1(small=h["small"])
    tc = TrainConfig(iters=spec["iters"], batch_size=4,
                     image_size=spec["size"], num_steps=h["num_steps"],
                     lr=h["lr"], freeze_bn=True)
    mesh = make_train_mesh(4, world, fsdp=h["fsdp"], seq=2)
    model = RAFT(cfg)
    model.load_state_dict(spec["state_dict"], strict=True)
    state = shard_state(create_state(cfg, tc, device="cpu", model=model),
                        mesh)
    rec = {"mesh": [mesh.data_index, mesh.fsdp_index, mesh.seq_index]}
    if "context" in spec:
        rec.update(run_context(spec["context"], mesh.seq))
    if "convs" in spec:
        rec["convs"] = run_convs(*spec["convs"], mesh.seq)
    ev = make_eval_step(state.model, iters=h["eval_iters"], device="cpu",
                        mesh=mesh, compute_sharding="halo",
                        shards=state.shards)
    eb = spec["eval_batch"]
    rec["eval"] = ev(eb["image1"], eb["image2"])
    loss, sums, norm = make_halo_grad_fn(cfg, tc, mesh)(state,
                                                        spec["batches"][0])
    rec["grad"] = {"loss": float(loss), "sums": sums.tolist(),
                   "norm": float(norm), "grads": gathered_grads(state, mesh)}
    if h.get("remat"):
        # the same gradient with every iteration recomputed in the backward
        tc_r = dataclasses.replace(tc, remat="per_iter")
        model = RAFT(train_model_config(cfg, tc_r))
        model.load_state_dict(spec["state_dict"], strict=True)
        state_r = shard_state(create_state(cfg, tc_r, device="cpu",
                                           model=model), mesh)
        calls, update_block = [], halo.update_block
        halo.update_block = lambda *a: calls.append(1) or update_block(*a)
        make_halo_grad_fn(cfg, tc_r, mesh)(state_r, spec["batches"][0])
        halo.update_block = update_block
        rec["grad_remat"] = gathered_grads(state_r, mesh)
        rec["remat_update_calls"] = len(calls)
    step = make_train_step(cfg, tc, mesh=mesh, compute_sharding="halo")
    metrics = []
    for batch in spec["batches"][:h["steps"]]:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    rec.update(metrics=metrics, state_dict=gathered(state),
               bytes=state.shards.state_bytes(state.optimizer))
    return rec


def run_fence_seq(spec: dict, world) -> dict:
    """The ``fence_seq`` records (module docstring)."""
    from dexiraft_tpu_torch.config import VARIANTS
    from dexiraft_tpu_torch.train.step import make_eval_step

    fs = spec["fence_seq"]
    mesh = make_train_mesh(fs["batch"], world, fsdp=fs["fsdp"], seq=2)
    rec = {"mesh": [mesh.data_index, mesh.fsdp_index, mesh.seq_index]}
    for case in spec["cases"]:
        if case["kind"] == "group_norm":
            from dexiraft_tpu_torch.models.layers import GroupNorm
            from dexiraft_tpu_torch.parallel.halo import slab

            x = torch.from_numpy(case["x"])
            gn = GroupNorm(case["groups"], x.shape[1])
            with torch.no_grad():
                gn.weight.copy_(torch.from_numpy(case["weight"]))
                gn.bias.copy_(torch.from_numpy(case["bias"]))
            gn.seq = mesh.seq
            with torch.no_grad():
                rec[case["name"]] = gn(slab(x, mesh.seq))
            continue
        cfg = VARIANTS[case["variant"]](**case["cfg"])
        if case["kind"] == "train":
            tc = TrainConfig(**case["tc"])
            model = RAFT(train_model_config(cfg, tc))
            model.load_state_dict(case["state_dict"], strict=True)
            state = shard_state(create_state(cfg, tc, device="cpu",
                                             model=model), mesh)
            step = make_train_step(cfg, tc, mesh=mesh)
            metrics = []
            for batch in case["batches"]:
                state, m = step(state, local_batch(batch, tc.accum_steps,
                                                   mesh))
                metrics.append({k: float(v) for k, v in m.items()})
            rec[case["name"]] = {"metrics": metrics,
                                 "state_dict": gathered(state)}
            continue
        model = RAFT(cfg)
        model.load_state_dict(case["state_dict"], strict=True)
        ev = make_eval_step(model, case["iters"], device="cpu", mesh=mesh,
                            adaptive=case["adaptive"])
        x = local_batch(case["inputs"], 1, mesh)
        budget = (case["iter_budget"],) if case["adaptive"] else ()
        rec[case["name"]] = [t.clone() for t in ev(
            x["image1"], x["image2"], x.get("flow_init"), *budget,
            edges1=x.get("edges1"), edges2=x.get("edges2"))]
    return rec


def main(spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    spec = torch.load(spec_path, weights_only=False)
    world = initialize("cpu")
    for key, fn in (("halo", run_halo), ("fence_seq", run_fence_seq)):
        if key in spec:
            torch.save(fn(spec, world), f"{out_dir}/rank{world.rank}.pt")
            teardown()
            return
    mesh = make_train_mesh(4, world, accum_steps=max(
        sc["accum"] for sc in spec["scenarios"]), fsdp=spec.get("fsdp"))
    results = (resume(spec, mesh) if "resume" in spec
               else run(spec, mesh, out_dir))
    torch.save(results, f"{out_dir}/rank{world.rank}.pt")
    teardown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
