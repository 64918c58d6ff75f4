"""One rank of tests/test_torch_parallel.py's data-parallel runs.

  RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
      python tests/torch_parallel_child.py SPEC.pt OUT_DIR

``SPEC.pt`` (torch.save) holds ``state_dict`` (the v1 weights), ``size``
(H, W), ``iters``, ``batches`` (global batches: dicts of NHWC numpy
arrays) and ``scenarios`` (dicts with ``accum``, ``add_noise``,
``dropout``, ``lr``, ``num_steps``). For each scenario the rank joins
the process group's train step on its rows of every global batch
(``parallel.local_rows``) and writes ``OUT_DIR/rank{r}.pt``: per scenario
the per-step metrics and the final state dict. Imports neither jax nor
the JAX package.
"""

import sys

import torch

from dexiraft_tpu_torch.config import TrainConfig, raft_v1
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.parallel import initialize, local_rows, \
    make_train_mesh, teardown
from dexiraft_tpu_torch.train.state import create_state
from dexiraft_tpu_torch.train.step import make_train_step


def run(spec: dict, mesh) -> list:
    out = []
    for sc in spec["scenarios"]:
        cfg = raft_v1(dropout=sc["dropout"])
        tc = TrainConfig(iters=spec["iters"], batch_size=4,
                         num_steps=sc["num_steps"], lr=sc["lr"],
                         accum_steps=sc["accum"], add_noise=sc["add_noise"])
        model = RAFT(cfg)
        model.load_state_dict(spec["state_dict"], strict=True)
        state = create_state(cfg, tc, device="cpu", model=model)
        step = make_train_step(cfg, tc, mesh=mesh)
        metrics = []
        for batch in spec["batches"]:
            n = batch["image1"].shape[0]
            rows = local_rows(n, sc["accum"], mesh)
            local = {k: v if rows is None else v[rows.numpy()]
                     for k, v in batch.items()}
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        out.append({"metrics": metrics,
                    "state_dict": {k: v.clone() for k, v in
                                   state.model.state_dict().items()}})
    return out


def main(spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    spec = torch.load(spec_path, weights_only=False)
    world = initialize("cpu")
    mesh = make_train_mesh(4, world, accum_steps=max(
        sc["accum"] for sc in spec["scenarios"]))
    results = run(spec, mesh)
    torch.save(results, f"{out_dir}/rank{world.rank}.pt")
    teardown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
