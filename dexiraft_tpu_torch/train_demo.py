"""Training demo with exact ground truth, on the port's train step.

Counterpart of the JAX package's ``scripts/train_demo.py``. No dataset is
needed: image2 is a smooth random texture, the flow a smooth random warp,
and image1[x] = image2[x + flow[x]] by bilinear sampling, so the flow
supervision is exact by construction. The mean EPE falling from the
flow-magnitude level shows the whole training path (model, sequence loss,
OneCycle AdamW, the kernels' forward and their plain backward) learning.

  python -m dexiraft_tpu_torch.train_demo --steps 200 --batch 4 \\
      --corr_impl flash --fused_update

prints one line every 25 steps and, at the end, one JSON object with the
per-step EPE trajectory and the training rate. ``run_demo`` is the same
run as a function (chip_smoke.py's ``train_demo`` phase).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np

# training-distribution generator parameters (the JAX demo's)
TEX_GRID, FLOW_GRID, MAX_DISP = 24, 6, 6.0


def smooth_noise(rng: np.random.Generator, shape, grid: int = 8,
                 lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Low-frequency noise: a coarse grid upsampled with cubic zoom."""
    from scipy import ndimage

    h, w = shape
    coarse = rng.uniform(lo, hi, (grid, grid))
    return ndimage.zoom(coarse, (h / grid, w / grid), order=3)[:h, :w]


def make_pair(rng: np.random.Generator, h: int, w: int,
              max_disp: float = MAX_DISP, tex_grid: int = TEX_GRID,
              flow_grid: int = FLOW_GRID):
    """(image1, image2, flow) with image1[x] = image2[x + flow[x]]."""
    from scipy import ndimage

    img2 = np.stack([smooth_noise(rng, (h, w), tex_grid, 0, 255)
                     for _ in range(3)], axis=-1)
    flow = np.stack([smooth_noise(rng, (h, w), flow_grid, -max_disp,
                                  max_disp) for _ in range(2)], axis=-1)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img1 = np.stack([ndimage.map_coordinates(
        img2[..., c], [yy + flow[..., 1], xx + flow[..., 0]], order=1,
        mode="nearest") for c in range(3)], axis=-1)
    return img1, img2, flow


def make_batch(rng: np.random.Generator, batch: int, h: int, w: int
               ) -> Dict[str, np.ndarray]:
    """A batch in the train step's NHWC host layout."""
    i1, i2, fl = zip(*[make_pair(rng, h, w) for _ in range(batch)])
    return {"image1": np.stack(i1).astype(np.float32),
            "image2": np.stack(i2).astype(np.float32),
            "flow": np.stack(fl).astype(np.float32),
            "valid": np.ones((batch, h, w), np.float32)}


def run_demo(steps: int = 200, batch: int = 4, size=(192, 256),
             corr_impl: str = "flash", fused_update: bool = True,
             device: str = "cuda", pool: int = 16, seed: int = 1234,
             lr: float = 4e-4, iters: int = 12, log=print) -> Dict:
    """Train RAFT-small v1 for ``steps`` steps on a pool of ``pool``
    exact-GT batches; returns {"epe": per-step training EPE, "loss": per
    step, "steps_per_s": the rate after the first step, "first_step_s"}."""
    import torch

    from dexiraft_tpu_torch.analysis import guards
    from dexiraft_tpu_torch.config import TrainConfig, raft_v1
    from dexiraft_tpu_torch.device import resolve_device
    from dexiraft_tpu_torch.train.state import create_state, param_count
    from dexiraft_tpu_torch.train.step import make_train_step

    dev = resolve_device(device)
    h, w = size
    cfg = raft_v1(small=True, corr_impl=corr_impl, fused_update=fused_update)
    tc = TrainConfig(name="demo", num_steps=steps, batch_size=batch,
                     image_size=(h, w), iters=iters, lr=lr, wdecay=1e-5,
                     seed=seed)
    state = create_state(cfg, tc, device=dev)
    step_fn = make_train_step(cfg, tc)
    rng = np.random.default_rng(seed)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in make_batch(rng, batch, h, w).items()}
               for _ in range(pool)]
    log(f"# train_demo: RAFT-small v1 ({corr_impl}"
        f"{' fused' if fused_update else ''}), {param_count(state.model)} "
        f"parameters, batch {batch}, {h}x{w}, iters {iters}, {steps} steps "
        f"on {dev}")
    losses: List = []
    epes: List = []
    t_first = time.perf_counter()
    t0: Optional[float] = None
    for i in range(steps):
        state, m = step_fn(state, batches[i % pool])
        losses.append(m["loss"])
        epes.append(m["epe"])
        if i == 0:
            guards.fetch(m["loss"])
            first_step_s = time.perf_counter() - t_first
            t0 = time.perf_counter()
        if (i + 1) % 25 == 0 or i == steps - 1:
            loss_i, epe_i = guards.fetch((m["loss"], m["epe"]))
            log(f"[{i + 1:5d}] loss {float(loss_i):7.3f}  epe "
                f"{float(epe_i):6.3f}")
    loss_v, epe_v = guards.fetch((torch.stack(losses), torch.stack(epes)))
    loss_v, epe_v = loss_v.tolist(), epe_v.tolist()
    rate = (steps - 1) / (time.perf_counter() - t0) if steps > 1 else 0.0
    return {"epe": epe_v, "loss": loss_v, "steps_per_s": rate,
            "first_step_s": first_step_s}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("dexiraft-torch-train-demo")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, nargs=2, default=(192, 256))
    ap.add_argument("--corr_impl", default="flash",
                    choices=["allpairs", "local", "flash", "pallas"])
    ap.add_argument("--fused_update", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_demo(args.steps, args.batch, tuple(args.size), args.corr_impl,
                   args.fused_update, args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
