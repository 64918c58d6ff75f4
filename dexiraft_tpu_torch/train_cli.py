"""Training CLI of the PyTorch port, on one device.

  python -m dexiraft_tpu_torch train --stage chairs --name raft-chairs \\
      --variant v1
  python -m dexiraft_tpu_torch train --preset standard --stage things \\
      --restore_ckpt checkpoints/raft-chairs

Counterpart of ``dexiraft_tpu/train_cli.py``: the same flags, defaults and
preset resolution (``resolve_configs``), and its loop on one device:
fetch_dataset -> Loader -> prefetch to the device -> create_state -> train
step -> Logger -> DivergenceGuard -> a checkpoint every ``--val_freq``
steps and at the end. Every checkpoint carries the data stream's position,
so ``--resume`` continues the exact sample sequence from the latest step.
The device is ``cuda`` unless ``--device cpu`` is given.

Refused, each naming the ROADMAP item that ports it: ``--mixed_precision``
and ``--precision bf16`` (A2); ``--remat`` and ``--remat_lookup`` (A10);
``--fsdp``, ``--elastic``, ``--join``, a nonzero ``--stall_timeout`` and
``--chaos`` (A12); ``--strict`` (A13); ``--records_dir`` (A6); named
``--validation`` sets and ``--keep_best`` (A7). A preset's own validation
sets are dropped with one printed line naming A7. ``--restore_ckpt``
takes a checkpoint of this trainer or a state-dict file (the bridge's
layout); an orbax directory is refused (A10). PyTorch runs eagerly, so
``--compile_cache`` has nothing to cache and only says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp
import signal
import sys
from typing import Dict

import numpy as np

from dexiraft_tpu_torch import config as cfglib
from dexiraft_tpu_torch.config import VARIANTS, RAFTConfig, TrainConfig

# the in-training validation sets of the JAX trainer (their port is A7)
_VAL_SETS = ("chairs", "hd1k", "kitti", "sintel")


def fsdp_arg(value: str):
    """argparse type= for --fsdp: 'auto' or a positive integer."""
    if value == "auto":
        return value
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or an integer, got {value!r}")
    if n < 1:
        raise argparse.ArgumentTypeError(f"expected >= 1, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dexiraft-torch-train")
    p.add_argument("--name", default=None,
                   help="experiment name (default: preset's per-stage name, "
                        "else 'raft')")
    p.add_argument("--stage", required=True,
                   choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--preset", choices=["standard", "mixed", "none"],
                   default="none", help="stage hyperparameter preset")
    p.add_argument("--variant", default="v1", choices=sorted(VARIANTS))
    p.add_argument("--small", action="store_true")
    p.add_argument("--mixed_precision", action="store_true",
                   help="refused: ROADMAP A2")
    p.add_argument("--corr_impl", default="allpairs",
                   choices=["allpairs", "local", "pallas", "flash"])
    p.add_argument("--corr_dtype", default="fp32", choices=["fp32", "bf16"],
                   help="storage precision of the correlation pyramid "
                        "(int8 is inference-only)")
    p.add_argument("--fused_update", action="store_true",
                   help="each iteration's 4-level lookup and the motion "
                        "encoder's corr conv in one kernel launch (requires "
                        "--corr_impl flash or pallas)")
    p.add_argument("--remat", action="store_true", help="refused: ROADMAP A10")
    p.add_argument("--remat_lookup", action="store_true",
                   help="refused: ROADMAP A10")
    p.add_argument("--dexined_upconv", default="subpixel",
                   choices=["transpose", "subpixel"])
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=None)
    p.add_argument("--wdecay", type=float, default=None)
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                   help="bf16 is refused: ROADMAP A2")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: batch_size = accum * "
                        "microbatch")
    p.add_argument("--fsdp", default=None, type=fsdp_arg,
                   help="refused: ROADMAP A12")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="batches copied to the device ahead of the step "
                        "(0 disables)")
    p.add_argument("--compile_cache", action="store_true")
    p.add_argument("--compile_cache_dir", default=None)
    p.add_argument("--validation", nargs="*", default=None,
                   choices=sorted(_VAL_SETS),
                   help="named sets are refused (ROADMAP A7); an empty "
                        "list turns the preset's off")
    p.add_argument("--records_dir", default=None, help="refused: ROADMAP A6")
    p.add_argument("--edge_root", default=None,
                   help="parallel tree of precomputed edge-map PNGs for the "
                        "v2/v3 data-edge contract")
    p.add_argument("--edge_sum_fusion", action="store_true",
                   help="v1-lineage fusion: the model on the image pair AND "
                        "the edge pair, per-iteration flows summed; needs "
                        "--edge_root")
    p.add_argument("--restore_ckpt", default=None,
                   help="partial (strict=False-style) restore from a "
                        "checkpoint of this trainer or a state-dict file")
    p.add_argument("--resume", action="store_true",
                   help="restore the FULL state (optimizer, schedule, "
                        "generator, data position) from --output/<name> "
                        "and continue")
    p.add_argument("--output", default="checkpoints")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--val_freq", type=int, default=5000)
    p.add_argument("--sum_freq", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--worker_mode", choices=["thread", "process"],
                   default="thread")
    p.add_argument("--log_dir", default="runs")
    p.add_argument("--profile_steps", type=int, nargs=2, default=None,
                   metavar=("START", "STOP"),
                   help="torch.profiler trace of steps [START, STOP) into "
                        "<log_dir>/<name>/profile")
    p.add_argument("--no_guard", action="store_true",
                   help="disable the divergence guard")
    p.add_argument("--guard_every", type=int, default=100)
    p.add_argument("--guard_threshold", type=float, default=1e4)
    p.add_argument("--max_rollbacks", type=int, default=3)
    p.add_argument("--keep", type=int, default=0,
                   help="keep only the newest N checkpoints (0 = all); the "
                        "rollback target is never deleted")
    p.add_argument("--keep_best", action="store_true",
                   help="refused: needs validation (ROADMAP A7)")
    p.add_argument("--on_preempt", choices=["save", "abort"], default="save",
                   help="SIGTERM/SIGINT: 'save' finishes the step and writes "
                        "one checkpoint; 'abort' stops without saving")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="refused: ROADMAP A12")
    p.add_argument("--stall_timeout", type=float, default=0.0,
                   help="nonzero is refused: ROADMAP A12")
    p.add_argument("--straggler_factor", type=float, default=10.0)
    p.add_argument("--coord_every", type=int, default=10)
    p.add_argument("--coord_timeout_s", type=float, default=600.0)
    p.add_argument("--elastic", action="store_true",
                   help="refused: ROADMAP A12")
    p.add_argument("--min_hosts", type=int, default=1)
    p.add_argument("--join", default=None, metavar="NAME",
                   help="refused: ROADMAP A12")
    p.add_argument("--strict", action="store_true",
                   help="refused: ROADMAP A13")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def refuse_unported(args) -> None:
    """Exit naming the ROADMAP item of the first flag the port lacks."""
    refused = (
        (args.mixed_precision, "--mixed_precision", "A2"),
        (args.precision == "bf16", "--precision bf16", "A2"),
        (args.remat, "--remat", "A10"),
        (args.remat_lookup, "--remat_lookup", "A10"),
        (args.fsdp is not None, "--fsdp", "A12"),
        (args.elastic, "--elastic", "A12"),
        (args.join is not None, "--join", "A12"),
        (args.stall_timeout != 0.0, "--stall_timeout", "A12"),
        (args.chaos is not None, "--chaos", "A12"),
        (args.strict, "--strict", "A13"),
        (args.records_dir is not None, "--records_dir", "A6"),
        (bool(args.validation), "--validation with named sets", "A7"),
        (args.keep_best, "--keep_best", "A7"),
    )
    for bad, flag, item in refused:
        if bad:
            raise SystemExit(f"train: {flag} is not ported to PyTorch yet "
                             f"(ROADMAP {item}); use the JAX package "
                             "(python -m dexiraft_tpu train) for it")
    if args.coord_every < 1:
        raise SystemExit("train: --coord_every must be >= 1")
    if args.coord_timeout_s <= 0:
        raise SystemExit("train: --coord_timeout_s must be > 0")


def resolve_configs(args) -> "tuple[RAFTConfig, TrainConfig]":
    """The (RAFTConfig, TrainConfig) pair of the flags: the preset's stage
    config (or the defaults) with the given flags applied."""
    if args.fused_update and args.corr_impl not in ("pallas", "flash"):
        raise SystemExit("train: --fused_update requires --corr_impl "
                         "flash or pallas")
    cfg = VARIANTS[args.variant](
        small=args.small,
        dropout=args.dropout,
        corr_impl=args.corr_impl,
        corr_dtype=args.corr_dtype,
        fused_update=args.fused_update,
        dexined_upconv=args.dexined_upconv,
    )
    if args.preset != "none":
        stages = (cfglib.STANDARD_STAGES if args.preset == "standard"
                  else cfglib.MIXED_STAGES)
        base = next(tc for tc in stages if tc.stage == args.stage)
    else:
        base = TrainConfig(stage=args.stage)
    overrides: Dict = dict(
        stage=args.stage,
        clip=args.clip,
        iters=args.iters,
        add_noise=args.add_noise,
        precision=args.precision,
        accum_steps=args.accum_steps,
        prefetch_depth=args.prefetch_depth,
        edge_sum_fusion=args.edge_sum_fusion,
        # BatchNorm frozen for every post-chairs stage
        freeze_bn=args.stage != "chairs",
        val_freq=args.val_freq,
        sum_freq=args.sum_freq,
        seed=args.seed,
    )
    if args.name is not None:
        overrides["name"] = args.name
    if args.validation is not None:
        overrides["validation"] = tuple(args.validation)
    for field, value in [("lr", args.lr), ("num_steps", args.num_steps),
                         ("batch_size", args.batch_size),
                         ("wdecay", args.wdecay), ("gamma", args.gamma)]:
        if value is not None:
            overrides[field] = value
    if args.image_size is not None:
        overrides["image_size"] = tuple(args.image_size)
    return cfg, dataclasses.replace(base, **overrides)


class _Preemption:
    """SIGTERM/SIGINT set a flag the loop reads at step boundaries; a
    second signal aborts at once."""

    def __init__(self):
        self.signum = None
        self._previous = {}

    def _handle(self, signum, frame):
        if self.signum is not None:
            raise SystemExit(f"second {signal.Signals(signum).name} during "
                             "preemption handling")
        self.signum = signum
        print(f"[preempt] received {signal.Signals(signum).name}; finishing "
              "the current step", flush=True)

    def __enter__(self):
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:  # not the main thread: stay inert
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        return False


def _stream_position(epoch: int, offset: int, per_epoch: int):
    """The position after consuming the batch at (epoch, offset)."""
    absolute = epoch * per_epoch + offset + 1
    return absolute // per_epoch, absolute % per_epoch


def train(cfg: RAFTConfig, tc: TrainConfig, args) -> None:
    """The training loop (module docstring)."""
    import torch

    from dexiraft_tpu_torch.data.datasets import fetch_dataset
    from dexiraft_tpu_torch.data.loader import Loader
    from dexiraft_tpu_torch.data.prefetch import DevicePrefetcher
    from dexiraft_tpu_torch.device import resolve_device
    from dexiraft_tpu_torch.train import checkpoint as ckpt
    from dexiraft_tpu_torch.train.guard import DivergenceGuard
    from dexiraft_tpu_torch.train.logger import Logger
    from dexiraft_tpu_torch.train.state import create_state, param_count
    from dexiraft_tpu_torch.train.step import make_train_step

    dev = resolve_device(args.device)
    np.random.seed(tc.seed)
    ckpt_dir = osp.join(args.output, tc.name)
    if args.compile_cache or args.compile_cache_dir:
        print("[cache] nothing to cache: the PyTorch port runs eagerly")
    if tc.validation:
        print(f"[validation] the preset's sets {list(tc.validation)} are "
              "dropped: in-training validation is not ported yet "
              "(ROADMAP A7)")
        tc = dataclasses.replace(tc, validation=())

    state = create_state(cfg, tc, device=dev)
    print(f"Parameter Count: {param_count(state.model)}")
    stream = (0, 0)
    last_saved = None
    if args.resume and ckpt.latest_step(ckpt_dir) is not None:
        state, extra = ckpt.restore_checkpoint(ckpt_dir, state)
        last_saved = state.step
        stream = tuple(extra.get("stream", (0, 0)))
        print(f"Resumed full state at step {state.step} (data stream: "
              f"epoch {stream[0]}, batch {stream[1]})")
    elif args.restore_ckpt:
        try:
            restored = ckpt.read_state_dict(args.restore_ckpt)
        except (ValueError, FileNotFoundError) as e:
            raise SystemExit(f"train: --restore_ckpt: {e}")
        skipped = ckpt.restore_params_into(state.model, restored,
                                           verbose=True)
        print(f"Partial restore from {args.restore_ckpt} "
              f"({len(skipped)} keys fresh)")

    dataset = fetch_dataset(tc.stage, tc.image_size, edge_root=args.edge_root)
    print(f"Training with {len(dataset)} image pairs")
    loader = Loader(dataset, tc.batch_size, seed=tc.seed,
                    num_workers=args.num_workers,
                    worker_mode=args.worker_mode, mp_start_method="spawn")
    per_epoch = max(len(loader), 1)
    step_fn = make_train_step(cfg, tc)
    logger = Logger(tc.sum_freq, log_dir=osp.join(args.log_dir, tc.name),
                    model_iters=tc.iters, pipeline_stats=loader.stats)
    total_steps = state.step
    logger.rewind(total_steps)
    guard = DivergenceGuard(args.guard_threshold, args.max_rollbacks)
    configs = {"raft": cfg, "train": tc}

    def save(step: int, block: bool = False) -> None:
        nonlocal last_saved
        info = ckpt.wait_pending(ckpt_dir)
        _note_flush(info)
        if args.keep > 0:
            steps = ckpt.all_steps(ckpt_dir)
            for old in steps[:max(len(steps) - args.keep + 1, 0)]:
                if old != last_saved:
                    ckpt.delete_step(ckpt_dir, old)
        ckpt.save_checkpoint(ckpt_dir, state, step=step, block=False,
                             extra={"stream": stream}, configs=configs)
        if block:
            info = ckpt.wait_pending(ckpt_dir)
            _note_flush(info)
            if info and info["error"]:
                raise RuntimeError(f"checkpoint flush of step {step} failed: "
                                   f"{info['error']}")
        last_saved = step

    def _note_flush(info) -> None:
        if info:
            print(f"[ckpt] step {info['step']}: flush "
                  f"{info['flush_s'] * 1e3:.0f} ms, train blocked "
                  f"{info['blocked_s'] * 1e3:.0f} ms"
                  + (f" (FLUSH FAILED: {info['error']})" if info["error"]
                     else ""))

    prof_start, prof_stop = args.profile_steps or (-1, -1)
    prof = None
    metrics = None
    preempted = False
    batches = DevicePrefetcher(
        loader.batches(start_epoch=stream[0], start_offset=stream[1]), dev,
        depth=tc.prefetch_depth, pipeline_stats=loader.stats)
    try:
        with _Preemption() as preempt:
            for batch in batches:
                if prof is None and prof_start <= total_steps < prof_stop:
                    prof = torch.profiler.profile(activities=(
                        [torch.profiler.ProfilerActivity.CPU]
                        + ([torch.profiler.ProfilerActivity.CUDA]
                           if dev.type == "cuda" else [])))
                    prof.__enter__()
                state, metrics = step_fn(state, batch)
                total_steps += 1
                stream = _stream_position(*loader.positions.popleft(),
                                          per_epoch)
                logger.push(metrics)
                if prof is not None and total_steps >= prof_stop:
                    prof.__exit__(None, None, None)
                    path = osp.join(args.log_dir, tc.name, "profile",
                                    "trace.json")
                    os.makedirs(osp.dirname(path), exist_ok=True)
                    prof.export_chrome_trace(path)
                    prof, prof_start = None, -1
                    print(f"[profile] trace -> {path}")

                if not args.no_guard and (
                        total_steps % args.guard_every == 0
                        or total_steps % tc.val_freq == 0):
                    loss_v = float(metrics["loss"])
                    state_ok = bool(metrics["state_finite"])
                    if guard.poisoned(loss_v, state_ok):
                        msg = guard.consume_rollback(
                            loss_v, state_ok, f"step {total_steps}",
                            last_saved, ckpt_dir=ckpt_dir)
                        _note_flush(ckpt.wait_pending(ckpt_dir))
                        state, _ = ckpt.restore_checkpoint(ckpt_dir, state,
                                                           step=last_saved)
                        print(f"[guard] loss {loss_v:.4g} "
                              f"(state_finite={state_ok}) at step "
                              f"{total_steps}; {msg}")
                        total_steps = state.step
                        logger.rewind(total_steps)
                        metrics = None
                        continue

                if preempt.signum is not None:
                    preempted = True
                    if args.on_preempt == "save":
                        save(total_steps, block=True)
                        print(f"[preempt] checkpoint: {ckpt_dir} step "
                              f"{total_steps}; resume with --resume")
                    break
                if total_steps % tc.val_freq == 0:
                    save(total_steps)
                if total_steps >= tc.num_steps:
                    break
    finally:
        batches.close()
        if prof is not None:
            prof.__exit__(None, None, None)
    final_ok = not preempted
    if final_ok and not args.no_guard and metrics is not None:
        loss_v = float(metrics["loss"])
        state_ok = bool(metrics["state_finite"])
        if guard.poisoned(loss_v, state_ok):
            final_ok = False
            print(f"[guard] final state poisoned (loss {loss_v:.4g}, "
                  f"state_finite={state_ok}); skipping the final save — "
                  f"latest good checkpoint remains step {last_saved}")
    if final_ok and last_saved != total_steps:
        save(total_steps, block=True)
    else:
        _note_flush(ckpt.wait_pending(ckpt_dir))
    logger.close()
    print(f"[prefetch] {batches.summary()}")
    if loader.stats.faults:
        print(f"[pipeline] {loader.stats.summary()}")
    if preempted:
        print(f"Preempted at step {total_steps} -> {ckpt_dir}")
    else:
        print(f"Done: {total_steps} steps -> {ckpt_dir}")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    cfg, tc = resolve_configs(args)
    train(cfg, tc, args)


if __name__ == "__main__":
    main(sys.argv[1:])
