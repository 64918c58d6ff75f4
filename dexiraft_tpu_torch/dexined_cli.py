"""DexiNed standalone train/test CLI (reference core/DexiNed/main.py).

  python -m dexiraft_tpu_torch dexined --train --data_root /data/BIPED/edges
  python -m dexiraft_tpu_torch dexined --test --checkpoint ckpts/dexined \
      --data_root /data/CLASSIC

Counterpart of ``dexiraft_tpu/dexined_cli.py`` with its flags, plus
``--device`` (``cuda`` unless ``cpu`` is asked for). Training: AdamW at a
constant learning rate, no gradient clipping (``optax.adamw(lr,
weight_decay=wd)``'s arithmetic: ``torch.optim.AdamW`` with every
parameter given a gradient, so a parameter the forward never reaches is
decayed as optax decays every leaf), the per-scale weighted bdcn_loss2
(weights [0.7, 0.7, 1.1, 1.1, 0.3, 0.3, 1.3], main.py:29,39), BatchNorm
in train mode, a per-epoch checkpoint in the port's format
(``train/checkpoint.py``) and the epoch-end divergence guard, which rolls
back to this run's last epoch checkpoint. Testing: the 7 maps through a
sigmoid, saved as the reference's fused/avg PNGs (utils/image.py:29-133)
and the inverted fused map at the source resolution, with per-image
timing (main.py:133-147), the channel-swap ensemble (``--test_pich``) and
ODS/OIS/AP against ``--gt_root``.

``--stall_timeout`` arms the hang watchdog (resilience/watchdog.py) over
every training step but the first (its cuDNN searches): a step that makes
no progress for that many seconds dumps the step and every thread's stack
and exits 98.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import time
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn as nn

from dexiraft_tpu_torch.dexined.data import (DATASET_INFO, BipedDataset,
                                             TestDataset)
from dexiraft_tpu_torch.dexined.losses import weighted_multiscale_loss
from dexiraft_tpu_torch.models.dexined import DexiNed, create_dexined
from dexiraft_tpu_torch.train.step import (EVAL_TF32, TRAIN_TF32, all_finite,
                                           eval_arithmetic)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dexiraft-dexined")
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--data_root", required=True)
    p.add_argument("--dataset", default="BIPED", choices=sorted(DATASET_INFO))
    p.add_argument("--checkpoint", default="checkpoints/dexined")
    p.add_argument("--output_dir", default="dexined_results")
    p.add_argument("--epochs", type=int, default=17)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--img_size", type=int, default=352)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="cap batches per epoch (default: full dataset)")
    p.add_argument("--no_guard", action="store_true",
                   help="disable the epoch-end divergence guard "
                        "(non-finite loss -> roll back to the last "
                        "epoch checkpoint instead of saving the "
                        "poisoned state)")
    p.add_argument("--max_rollbacks", type=int, default=3)
    p.add_argument("--gt_root", default=None,
                   help="ground-truth edge-map dir: --test additionally "
                        "reports ODS/OIS/AP (dexined.metrics)")
    p.add_argument("--matching", default="assignment",
                   choices=("assignment", "dilation"),
                   help="TP matching rule: 'assignment' is the exact "
                        "one-to-one correspondPixels protocol; 'dilation' "
                        "is the fast surrogate (scores trend higher)")
    p.add_argument("--upconv", default="subpixel",
                   choices=("transpose", "subpixel"),
                   help="the JAX package's upsampler implementations, one "
                        "linear map: both build the port's transposed conv")
    p.add_argument("--stall_timeout", type=float, default=0.0,
                   help="hang watchdog: a training step making no "
                        "progress for this many seconds dumps live "
                        "stacks and exits 98 (0 = disabled)")
    p.add_argument("--test_pich", action="store_true",
                   help="channel-swap ensemble test (reference testPich, "
                        "main.py:149-187): second forward on the BGR-swapped "
                        "image, merged where it is more edge-confident")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def save_edge_maps(fused_probs: np.ndarray, names, shapes, out_dir: str) -> None:
    """sigmoid output -> inverted uint8 edge PNG at original resolution."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for prob, name, shape in zip(fused_probs, names, shapes):
        img = (255.0 * (1.0 - prob[..., 0])).clip(0, 255).astype(np.uint8)
        img = cv2.resize(img, (int(shape[1]), int(shape[0])))
        cv2.imwrite(osp.join(out_dir, osp.splitext(name)[0] + ".png"), img)


def _normalize_invert(prob: np.ndarray) -> np.ndarray:
    """min-max normalize to [0,255] then invert (utils/image.py:9-26,90-91)."""
    lo, hi = float(prob.min()), float(prob.max())
    img = (prob - lo) * 255.0 / (hi - lo + 1e-12)
    return 255 - img.astype(np.uint8)


def save_test_outputs(probs: np.ndarray, probs2, names, shapes,
                      out_dir: str) -> None:
    """The reference's full test-mode save protocol (utils/image.py:29-133).

    probs: (7, B, H, W, 1) sigmoid outputs. Each of the 7 maps is min-max
    normalized, inverted, and resized to the source resolution; `fused/`
    gets scale 7 (the block_cat output), `avg/` the mean over all 7. With
    a channel-swap second pass (probs2, testPich) the directories are
    named `fusedCH`/`avgCH` and each map is merged with its swapped twin
    where the twin is more edge-confident (pixels where map>128 but
    twin<128 take the twin — utils/image.py:106-121).
    """
    import cv2

    fuse_name, av_name = ("fusedCH", "avgCH") if probs2 is not None \
        else ("fused", "avg")
    dir_f = osp.join(out_dir, fuse_name)
    dir_a = osp.join(out_dir, av_name)
    os.makedirs(dir_f, exist_ok=True)
    os.makedirs(dir_a, exist_ok=True)
    for b, (name, shape) in enumerate(zip(names, shapes)):
        size = (int(shape[1]), int(shape[0]))
        preds, fuse = [], None
        for s in range(probs.shape[0]):
            img = cv2.resize(_normalize_invert(probs[s, b, ..., 0]), size)
            if probs2 is not None:
                img2 = cv2.resize(
                    _normalize_invert(probs2[s, b, ..., 0]), size)
                img = np.where((img > 128) & (img2 < 128), img2, img)
            preds.append(img)
            if s == probs.shape[0] - 1:
                fuse = img.astype(np.uint8)
        average = np.mean(np.asarray(preds, np.float32), axis=0).astype(
            np.uint8)
        stem = osp.splitext(name)[0] + ".png"
        cv2.imwrite(osp.join(dir_f, stem), fuse)
        cv2.imwrite(osp.join(dir_a, stem), average)


def make_optimizer(model: nn.Module, lr: float, wd: float
                   ) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)``: b1 0.9, b2 0.999, eps 1e-8
    outside the square root, decoupled decay, a constant learning rate,
    no clipping."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=wd)


def to_nchw(x: np.ndarray, device) -> torch.Tensor:
    """A batched NHWC host array -> a float32 NCHW tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        device).permute(0, 3, 1, 2)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer
                    ) -> Callable[[torch.Tensor, torch.Tensor],
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """One step on an NCHW batch: the train-mode forward (BatchNorm on
    batch statistics, running stats updated), the multiscale loss, the
    backward and the AdamW update, in place. Returns the loss (of the
    parameters before the update) and the all-finite verdict on the state
    after it, both 0-d device tensors."""
    params = list(model.parameters())
    for p in params:
        # side_5 and the "cat" head's BatchNorm never reach the loss: a
        # zero gradient (not None) makes AdamW decay them, as optax does
        p.grad = torch.zeros_like(p)

    def step(images: torch.Tensor, labels: torch.Tensor):
        model.train()
        with eval_arithmetic(TRAIN_TF32):
            optimizer.zero_grad(set_to_none=False)
            loss = weighted_multiscale_loss(model(images), labels)
            loss.backward()
            optimizer.step()
        # the Adam moments with the parameters and BatchNorm stats (the
        # step counts are host scalars in torch's AdamW)
        state = list(model.state_dict().values()) + [
            st[k] for st in optimizer.state.values()
            for k in ("exp_avg", "exp_avg_sq")]
        return loss.detach(), all_finite(state)

    return step


def train(args) -> None:
    from dexiraft_tpu_torch.device import resolve_device
    from dexiraft_tpu_torch.resilience.watchdog import HangWatchdog
    from dexiraft_tpu_torch.train.guard import DivergenceGuard
    from dexiraft_tpu_torch.train.state import TrainState

    dev = resolve_device(args.device)
    info = DATASET_INFO[args.dataset]
    dataset = BipedDataset(args.data_root, img_size=args.img_size,
                           mean_bgr=info.mean_bgr,
                           train_list=info.train_list)
    print(f"Training DexiNed on {args.dataset}: {len(dataset)} pairs")

    model = create_dexined(args.seed).to(dev)
    optimizer = make_optimizer(model, args.lr, args.wd)
    step = make_train_step(model, optimizer)
    # the checkpoint format's generator: DexiNed training draws nothing
    state = TrainState(step=0, model=model, optimizer=optimizer,
                       generator=torch.Generator(device=dev).manual_seed(
                           args.seed))
    # finiteness-only: healthy BDCN multiscale losses run in the
    # thousands, so no magnitude threshold
    guard = DivergenceGuard(threshold=float("inf"),
                            max_rollbacks=args.max_rollbacks)
    # hang watchdog: a stalled step dumps live stacks and exits 98 (inert
    # at 0); stopped WITH the loop, also on the error path, so a still-
    # armed watchdog never replaces the real traceback with a stall report
    wd = HangWatchdog(args.stall_timeout,
                      label=f"dexined[{args.dataset}]").start()
    try:
        _train_epochs(args, dataset, dev, step, state, guard, wd)
    finally:
        wd.stop()


def _train_epochs(args, dataset, dev, step, state, guard, wd) -> None:
    from dexiraft_tpu_torch.train import checkpoint as ckpt_io

    n = len(dataset)
    steps_per_epoch = args.steps_per_epoch or max(n // args.batch_size, 1)
    # only checkpoints written by THIS run are valid rollback targets —
    # --checkpoint defaults to a constant dir, and splicing a previous
    # experiment's weights into this one would be silent corruption
    last_saved = None
    for epoch in range(args.epochs):
        # periodic reseed like the reference's per-epoch reshuffle
        # (main.py:403-410)
        order = np.random.default_rng((args.seed, epoch)).permutation(n)
        for b in range(steps_per_epoch):
            ids = order[(b * args.batch_size) % n:][:args.batch_size]
            if len(ids) < args.batch_size:
                ids = order[:args.batch_size]
            if epoch or b:
                # never armed over the first step (cuDNN's searches)
                wd.arm(epoch * steps_per_epoch + b + 1)
            samples = [dataset.sample(int(i), np.random.default_rng(
                (args.seed, epoch, int(i)))) for i in ids]
            images = to_nchw(np.stack([s["images"] for s in samples]), dev)
            labels = to_nchw(np.stack([s["labels"] for s in samples]), dev)
            loss, state_ok = step(images, labels)
            if b % 5 == 0:
                print(f"{time.ctime()} Epoch: {epoch} Sample {b}/"
                      f"{steps_per_epoch} Loss: {float(loss):.4f}",
                      flush=True)
            # disarmed AFTER the cadence sync above: the step returns at
            # launch, and float(loss) is where a wedged step blocks
            wd.disarm()

        state.step = (epoch + 1) * steps_per_epoch
        # epoch-end divergence guard: the last-batch loss catches poison
        # introduced BEFORE that batch's update; state_ok (the post-update
        # state) catches the final batch's own update poisoning the state
        # the save would persist
        loss_h, ok_h = float(loss), bool(state_ok)
        if not args.no_guard and guard.poisoned(loss_h, ok_h):
            rollback_msg = guard.consume_rollback(
                loss_h, ok_h, f"epoch {epoch}", last_saved,
                ckpt_dir=args.checkpoint)
            ckpt_io.restore_checkpoint(args.checkpoint, state,
                                       step=last_saved)
            print(f"[guard] poisoned epoch {epoch} (loss {loss_h:.4g}, "
                  f"state_finite={ok_h}); {rollback_msg}", flush=True)
            continue
        ckpt_io.save_checkpoint(args.checkpoint, state)
        last_saved = state.step
        print(f"Epoch {epoch}: checkpoint -> {args.checkpoint}", flush=True)


def make_test_forward(model: nn.Module) -> Callable[[torch.Tensor],
                                                    np.ndarray]:
    """NCHW batch -> the 7 maps' probabilities, (7, B, H, W, 1) host
    float32 (BatchNorm on its running stats)."""
    model.eval()

    def forward(images: torch.Tensor) -> np.ndarray:
        with torch.inference_mode(), eval_arithmetic(EVAL_TF32):
            probs = torch.stack([torch.sigmoid(p) for p in model(images)])
        return probs.permute(0, 1, 3, 4, 2).cpu().numpy()

    return forward


def test(args) -> None:
    from dexiraft_tpu_torch.device import resolve_device
    from dexiraft_tpu_torch.train import checkpoint as ckpt_io

    dev = resolve_device(args.device)
    info = DATASET_INFO[args.dataset]
    # registry eval resolutions: the reference's per-dataset test
    # protocol (datasets.py:9-149)
    dataset = TestDataset(args.data_root, img_height=info.img_height,
                          img_width=info.img_width, mean_bgr=info.mean_bgr,
                          test_list=info.test_list)
    model = DexiNed()
    # the newest step of a port checkpoint dir, or a state-dict file
    model.load_state_dict(ckpt_io.read_model_weights(args.checkpoint),
                          strict=True)
    forward = make_test_forward(model.to(dev))

    total, times = 0, []
    counts, gt_missing = [], []
    for i in range(len(dataset)):
        s = dataset.sample(i)
        t0 = time.perf_counter()
        images = to_nchw(s["images"][None], dev)
        probs = forward(images)
        probs2 = None
        if args.test_pich:
            # second forward on the channel-swapped image (main.py:172-174)
            probs2 = forward(images.flip(1))
        dt = time.perf_counter() - t0
        times.append(dt)
        fused = probs[-1]
        save_test_outputs(probs, probs2, [s["file_name"]],
                          [s["image_shape"]],
                          osp.join(args.output_dir, args.dataset))
        save_edge_maps(fused, [s["file_name"]], [s["image_shape"]],
                       osp.join(args.output_dir, args.dataset))
        if args.gt_root:
            import cv2

            from dexiraft_tpu_torch.dexined.metrics import edge_counts

            stem = osp.splitext(s["file_name"])[0]
            gt = cv2.imread(osp.join(args.gt_root, stem + ".png"),
                            cv2.IMREAD_GRAYSCALE)
            if gt is None:
                gt_missing.append(s["file_name"])
            else:
                # score at the GT's native resolution: upsample the
                # probability map rather than downscaling the GT, which
                # would interpolate away its 1-px edges
                pred_full = cv2.resize(fused[0, ..., 0],
                                       (gt.shape[1], gt.shape[0]))
                # streaming: only the (T, 4) counts are kept per image
                counts.append(edge_counts(pred_full, gt > 127,
                                          matching=args.matching))
        total += 1
        print(f"{s['file_name']}: {dt * 1e3:.1f} ms", flush=True)
    if times:
        print(f"Mean inference time over {total} images "
              f"(first excluded): {np.mean(times[1:] or times) * 1e3:.1f} ms")
    if args.gt_root:
        if gt_missing:
            print(f"[metrics] WARNING: no GT found for {len(gt_missing)}/"
                  f"{total} images (e.g. {gt_missing[0]!r}) under "
                  f"{args.gt_root}")
        if counts:
            from dexiraft_tpu_torch.dexined.metrics import evaluate_from_counts

            res = evaluate_from_counts(counts)
            print(f"ODS: {res['ODS']:.4f}  OIS: {res['OIS']:.4f}  "
                  f"AP: {res['AP']:.4f}  ({len(counts)} images)")
        else:
            print(f"[metrics] no GT matched under {args.gt_root}; "
                  "expected <gt_root>/<image stem>.png")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not (args.train or args.test):
        raise SystemExit("need --train or --test")
    if args.train:
        train(args)
    if args.test:
        test(args)


if __name__ == "__main__":
    main(sys.argv[1:])
