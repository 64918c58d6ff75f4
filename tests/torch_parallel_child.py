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
and records the steps after it again. Imports neither jax nor the JAX
package.
"""

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


def run(spec: dict, mesh, out_dir: str = None) -> list:
    out = []
    fsdp = isinstance(mesh, FsdpMesh)
    for i, sc in enumerate(spec["scenarios"]):
        cfg = raft_v1(dropout=sc["dropout"])
        tc = TrainConfig(iters=spec["iters"], batch_size=4,
                         num_steps=sc["num_steps"], lr=sc["lr"],
                         accum_steps=sc["accum"], add_noise=sc["add_noise"],
                         precision=sc.get("precision", "fp32"),
                         remat=sc.get("remat", "none"))

        def fresh():
            model = RAFT(train_model_config(cfg, tc))
            model.load_state_dict(spec["state_dict"], strict=True)
            state = create_state(cfg, tc, device="cpu", model=model)
            return shard_state(state, mesh) if fsdp else state

        state, step = fresh(), make_train_step(cfg, tc, mesh=mesh)
        rows_of = data_axis(mesh)
        batches = spec["batches"][:sc.get("steps", len(spec["batches"]))]

        def local(batch):
            rows = local_rows(batch["image1"].shape[0], sc["accum"], rows_of)
            return {k: v if rows is None else v[rows.numpy()]
                    for k, v in batch.items()}

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


def main(spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    spec = torch.load(spec_path, weights_only=False)
    world = initialize("cpu")
    mesh = make_train_mesh(4, world, accum_steps=max(
        sc["accum"] for sc in spec["scenarios"]), fsdp=spec.get("fsdp"))
    results = run(spec, mesh, out_dir)
    torch.save(results, f"{out_dir}/rank{world.rank}.pt")
    teardown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
