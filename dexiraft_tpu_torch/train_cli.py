"""Training CLI of the PyTorch port, on one device or data-parallel.

  python -m dexiraft_tpu_torch train --stage chairs --name raft-chairs \\
      --variant v1
  python -m dexiraft_tpu_torch train --preset standard --stage things \\
      --restore_ckpt checkpoints/raft-chairs
  torchrun --nproc_per_node 2 -m dexiraft_tpu_torch train --stage chairs

Counterpart of ``dexiraft_tpu/train_cli.py``: the same flags, defaults and
preset resolution (``resolve_configs``), and its loop:
fetch_dataset -> Loader -> prefetch to the device -> create_state -> train
step -> Logger -> DivergenceGuard -> every ``--val_freq`` steps a
checkpoint, retention's GC (``--keep``, ``--keep_best``) and the
validation sets (the preset's, or ``--validation``), then a checkpoint at
the end. Every checkpoint carries the data stream's position, the
loader's kind and the records pack's fingerprint, so ``--resume``
continues the exact sample sequence from the latest step that passes
``resilience.verify.restore_verified`` (a truncated or non-finite newest
step falls back to the previous one and is deleted; the debris of a
crash mid-flush is swept), and refuses to resume under the other data
plane or another pack (``LoaderKindMismatch``). The guard's rollback
restores through the same check. The device is ``cuda`` unless
``--device cpu`` is given.

``--records_dir`` trains from a packed-record directory (``python -m
dexiraft_tpu_torch pack_records``) through ``data.records.RecordLoader``:
the same batches as the raw loader, decoded once at pack time. Its
provenance is checked as in the JAX trainer: the pack's stage must be
the run's, a sintel pack must hold the default mixture, a different
crop recipe is warned about, and ``--edge_root`` is refused.
``--chaos SPEC`` (``sigterm@N``, ``kill_mid_flush@N``;
resilience/chaos.py) fires a real fault after step N.

Validation runs each set's validator (eval/validate.py) through the eval
step over the live model at the reference iteration counts
(``_VAL_ITERS``), after the checkpoint flush barrier, and logs the
metrics at that step; the first EPE-like scalar of the first set ranks
the checkpoint for ``--keep_best`` (resilience/retention.py, scores in
``<output>/<name>/retention.json``). The eval step puts the model in
eval mode and the train step puts it back in train mode; validation
draws nothing from the train state's generator.

``--mixed_precision`` (or ``--precision bf16``, which implies it) trains
the model in bf16 over fp32 parameters; ``--remat`` and ``--remat_lookup``
recompute each iteration (or only its lookup) in the backward, as the JAX
CLI's flags do.

Under torchrun (``parallel.distributed.initialize``, before anything
touches a card) each rank trains on its rows of the global batch
``--batch_size`` through the data-parallel step (``make_train_step(...,
mesh=)``), which computes what one process computes at that batch. Every
failure verdict is collective, over ``resilience.coord.Coordinator``:
the guard's rollback (and its agreed target step), the resume step
(``agree_step`` over the verified restore), and preemption, polled
every ``--coord_every`` steps (one rank's SIGTERM stops every rank at
the same step, with one emergency checkpoint). Rank 0 writes the
checkpoints, ``retention.json`` and the logs, and runs validation; the
other ranks wait at a coordinator barrier. ``--coord_timeout_s`` bounds
every consensus round but the wait for rank 0's validation, which only
the watchdog's validation window bounds (nothing with the watchdog off),
as JAX's ranks validate with no consensus deadline.

``--fsdp N|auto`` (under torchrun) stores the parameters and Adam
moments sharded over an fsdp axis between steps (``parallel.fsdp``,
JAX's fence mode): the ranks form a (data, fsdp) grid
(``parallel.make_train_mesh``; a world that would leave ranks idle is
refused), each rank reads the rows of its data index, the step gathers
the parameters at entry and computes the replicated step. Checkpoints
are written per shard by every rank together
(``train.checkpoint.save_sharded``), and a ``--resume`` onto another
layout is refused (A12.1, resharded resume); rank 0's validation runs
on the gathered model. ``--stall_timeout``
arms the hang watchdog (``resilience.watchdog``): a step, barrier or
save that makes no progress for that long (10x for checkpoint and
validation windows) dumps the step, the region and every thread's stack
and exits 98; ``--straggler_factor`` x the step-time EWMA warns first.
``--strict`` arms ``analysis.guards.strict_mode`` after the first step
(its cuDNN searches and kernel builds are the warm-up): from then on an
implicit host sync raises (on a card; a multi-rank run, whose gloo
collectives pass through the host, and a CPU run arm only the recompile
half) and a compile past the warm-up fails the run at the guard cadence
and at the end. Checkpoint saves, restores and validation run in
sanctioned windows, for compiles and syncs. Without ``--strict`` the same
watch only warns, once. Refused, each naming the ROADMAP item that
ports it: ``--elastic`` and ``--join`` (A12).
``--restore_ckpt`` takes a checkpoint of this trainer or a state-dict file
(the bridge's layout); an orbax directory is refused (A10). PyTorch runs
eagerly, so ``--compile_cache`` has nothing to cache and only says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import sys
from typing import Dict

import numpy as np

from dexiraft_tpu_torch import config as cfglib
from dexiraft_tpu_torch.config import VARIANTS, RAFTConfig, TrainConfig

# reference in-training validation iteration counts (evaluate.py:81-210)
_VAL_ITERS = {"chairs": 24, "sintel": 32, "kitti": 24, "hd1k": 24}


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
                   help="bf16 encoders, DexiNed and update block over fp32 "
                        "parameters (the correlation stays fp32)")
    p.add_argument("--corr_impl", default="allpairs",
                   choices=["allpairs", "local", "pallas", "flash"])
    p.add_argument("--corr_dtype", default="fp32", choices=["fp32", "bf16"],
                   help="storage precision of the correlation pyramid "
                        "(int8 is inference-only)")
    p.add_argument("--fused_update", action="store_true",
                   help="each iteration's 4-level lookup and the motion "
                        "encoder's corr conv in one kernel launch (requires "
                        "--corr_impl flash or pallas)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each refinement iteration in the "
                        "backward instead of storing its activations")
    p.add_argument("--remat_lookup", action="store_true",
                   help="recompute only the correlation lookup in the "
                        "backward (unfused paths)")
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
                   help="bf16 trains in mixed precision (implies "
                        "--mixed_precision); loss and optimizer stay fp32")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: batch_size = accum * "
                        "microbatch")
    p.add_argument("--fsdp", default=None, type=fsdp_arg,
                   help="under torchrun: store parameters and Adam moments "
                        "sharded over an fsdp axis of this many ranks "
                        "('auto': the ranks the data axis leaves), gathered "
                        "for each step; checkpoints are written per shard")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="batches copied to the device ahead of the step "
                        "(0 disables)")
    p.add_argument("--compile_cache", action="store_true")
    p.add_argument("--compile_cache_dir", default=None)
    p.add_argument("--validation", nargs="*", default=None,
                   choices=sorted(_VAL_ITERS),
                   help="sets validated at every checkpoint (default: the "
                        "preset's; an empty list turns them off)")
    p.add_argument("--records_dir", default=None,
                   help="train from a packed-record directory (python -m "
                        "dexiraft_tpu_torch pack_records) instead of "
                        "decoding the raw files; the same batch stream")
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
                   help="retention also keeps the checkpoint with the best "
                        "validation EPE (the first set's) even once it ages "
                        "out of the --keep window")
    p.add_argument("--on_preempt", choices=["save", "abort"], default="save",
                   help="SIGTERM/SIGINT: 'save' finishes the step and writes "
                        "one checkpoint; 'abort' stops without saving")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="fault injection after step N: sigterm@N (a real "
                        "SIGTERM) or kill_mid_flush@N (the next checkpoint "
                        "write exits the process before its commit)")
    p.add_argument("--stall_timeout", type=float, default=0.0,
                   help="hang watchdog: a step making no progress for this "
                        "many seconds dumps live stacks and exits 98 "
                        "(0 = disabled)")
    p.add_argument("--straggler_factor", type=float, default=10.0,
                   help="warn when a step runs this many times the "
                        "step-time EWMA")
    p.add_argument("--coord_every", type=int, default=10,
                   help="multi-rank: poll the collective preemption verdict "
                        "every N steps")
    p.add_argument("--coord_timeout_s", type=float, default=600.0,
                   help="multi-rank: seconds a consensus round waits for "
                        "a silent peer (not the wait for rank 0's "
                        "validation)")
    p.add_argument("--elastic", action="store_true",
                   help="refused: ROADMAP A12")
    p.add_argument("--min_hosts", type=int, default=1)
    p.add_argument("--join", default=None, metavar="NAME",
                   help="refused: ROADMAP A12")
    p.add_argument("--strict", action="store_true",
                   help="arm analysis.guards.strict_mode after the first "
                        "step: an implicit host sync raises (on one card; "
                        "with several ranks, or on the CPU, only the "
                        "recompile half is armed) and a compile past the "
                        "warm-up fails the run")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; under torchrun cuda:LOCAL_RANK), "
                        "'cuda:N' (every rank on card N) or 'cpu'")
    return p


def refuse_unported(args) -> None:
    """Exit naming the ROADMAP item of the first flag the port lacks."""
    refused = (
        (args.elastic, "--elastic", "A12"),
        (args.join is not None, "--join", "A12"),
    )
    for bad, flag, item in refused:
        if bad:
            raise SystemExit(f"train: {flag} is not ported to PyTorch yet "
                             f"(ROADMAP {item}); use the JAX package "
                             "(python -m dexiraft_tpu train) for it")
    if args.coord_every < 1:
        raise SystemExit("train: --coord_every must be >= 1 (it is a step "
                         "modulus; the preemption broadcast keeps the ranks "
                         "exiting together)")
    if args.coord_timeout_s <= 0:
        raise SystemExit("train: --coord_timeout_s must be > 0 (a consensus "
                         "round with no timeout hangs on the first dead "
                         "peer)")


def resolve_configs(args) -> "tuple[RAFTConfig, TrainConfig]":
    """The (RAFTConfig, TrainConfig) pair of the flags: the preset's stage
    config (or the defaults) with the given flags applied."""
    if args.fused_update and args.corr_impl not in ("pallas", "flash"):
        raise SystemExit("train: --fused_update requires --corr_impl "
                         "flash or pallas")
    cfg = VARIANTS[args.variant](
        small=args.small,
        mixed_precision=args.mixed_precision,
        dropout=args.dropout,
        corr_impl=args.corr_impl,
        corr_dtype=args.corr_dtype,
        fused_update=args.fused_update,
        remat=args.remat,
        remat_lookup=args.remat_lookup,
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


def _make_validators(model_fn, dev):
    """run(name) -> that set's metric dict, from its validator over the
    CURRENT model (``model_fn()``) at ``_VAL_ITERS[name]`` iterations.
    The eval step is built per call: building it puts the model in eval
    mode, and the next train step puts it back in train mode."""
    from dexiraft_tpu_torch.eval.validate import VALIDATORS
    from dexiraft_tpu_torch.train.step import make_eval_step

    def run(name: str) -> Dict[str, float]:
        step = make_eval_step(model_fn(), iters=_VAL_ITERS[name], device=dev)
        return VALIDATORS[name](step)

    return run


def _open_records(args, tc: TrainConfig):
    """The packed dataset of ``--records_dir``, with the JAX trainer's
    provenance checks; exits naming the mismatch."""
    from dexiraft_tpu_torch.data.datasets import DEFAULT_TRAIN_DS
    from dexiraft_tpu_torch.data.records import open_records

    if args.edge_root:
        raise SystemExit("train: --records_dir cannot be combined with "
                         "--edge_root: edge-paired stages are not packable "
                         "(pack_records) — use the raw loader")
    records = open_records(args.records_dir)
    man = records.manifest
    if man.stage is not None and man.stage != tc.stage:
        raise SystemExit(f"train: --records_dir {args.records_dir} was "
                         f"packed from stage {man.stage!r} but this run "
                         f"trains stage {tc.stage!r} — pack the right stage "
                         f"or drop --records_dir")
    # the raw path always trains sintel with the default mixture
    # selector; a pack of a reduced mixture is a DIFFERENT epoch
    if (tc.stage == "sintel" and man.train_ds is not None
            and man.train_ds != DEFAULT_TRAIN_DS):
        raise SystemExit(f"train: --records_dir {args.records_dir} was "
                         f"packed with train_ds={man.train_ds!r} but the "
                         f"sintel stage trains the {DEFAULT_TRAIN_DS!r} "
                         f"mixture — repack with the default selector or "
                         f"use the raw loader")
    if (man.image_size is not None
            and tuple(man.image_size) != tuple(tc.image_size)):
        print(f"[records] WARNING: pack was made at image_size "
              f"{tuple(man.image_size)}, run requests "
              f"{tuple(tc.image_size)}; the pack-time crop recipe wins "
              f"(repack to change it)")
    return records


def train(cfg: RAFTConfig, tc: TrainConfig, args, world=None) -> None:
    """The training loop (module docstring). ``world``: this process's
    ``parallel.World`` (``initialize()``'s; None: a single process on
    ``--device``)."""
    import contextlib

    import torch

    from dexiraft_tpu_torch.analysis import guards
    from dexiraft_tpu_torch.data.datasets import fetch_dataset
    from dexiraft_tpu_torch.data.loader import Loader
    from dexiraft_tpu_torch.data.prefetch import DevicePrefetcher
    from dexiraft_tpu_torch.device import resolve_device
    from dexiraft_tpu_torch.ops import corr_kernels
    from dexiraft_tpu_torch.parallel import World, make_train_mesh
    from dexiraft_tpu_torch.parallel.fsdp import shard_state
    from dexiraft_tpu_torch.parallel.layout import FsdpMesh
    from dexiraft_tpu_torch.resilience.coord import Coordinator
    from dexiraft_tpu_torch.resilience.preemption import PreemptionHandler
    from dexiraft_tpu_torch.resilience.retention import RetentionPolicy
    from dexiraft_tpu_torch.resilience.stream import (LoaderKindMismatch,
                                                      StreamPosition,
                                                      position_extra,
                                                      position_from_extra)
    from dexiraft_tpu_torch.resilience.verify import restore_verified
    from dexiraft_tpu_torch.resilience.watchdog import HangWatchdog
    from dexiraft_tpu_torch.train import checkpoint as ckpt
    from dexiraft_tpu_torch.train.guard import DivergenceGuard
    from dexiraft_tpu_torch.train.logger import Logger
    from dexiraft_tpu_torch.train.state import (create_state, param_count,
                                                state_bytes)
    from dexiraft_tpu_torch.train.step import make_train_step

    if world is None:
        world = World(0, 1, 0, resolve_device(args.device))
    dev = world.device
    # rank 0 writes the checkpoints, retention.json and the logs, and
    # validates; every rank restores and trains
    writer = world.rank == 0
    try:
        mesh = make_train_mesh(tc.batch_size, world, tc.accum_steps,
                               fsdp=args.fsdp)
    except ValueError as e:
        raise SystemExit(f"train: {e}")
    # the data axis this rank reads its rows on: its data index over the
    # data size (under fsdp the ranks of one fsdp group read the same rows)
    fsdp = isinstance(mesh, FsdpMesh)
    data_index, data_size = ((mesh.data_index, mesh.n_data) if fsdp
                             else (world.rank, world.size))
    if world.size > 1 or args.fsdp is not None:
        print(f"[mesh] world={world.size} data={data_size} "
              f"fsdp={mesh.n_fsdp if fsdp else 1}", flush=True)
    np.random.seed(tc.seed)
    ckpt_dir = osp.join(args.output, tc.name)
    if args.compile_cache or args.compile_cache_dir:
        print("[cache] nothing to cache: the PyTorch port runs eagerly")
    # every rank builds the same seeded state (and generator)
    state = create_state(cfg, tc, device=dev)
    print(f"Parameter Count: {param_count(state.model)}")
    # which data plane feeds this run, stamped into every checkpoint (kind
    # and pack fingerprint) so --resume refuses a raw<->records swap AND a
    # records-to-different-pack swap (LoaderKindMismatch); the pack is
    # opened BEFORE the resume path so its provenance gates both
    loader_kind = "records" if args.records_dir else "raw"
    records = _open_records(args, tc) if args.records_dir else None
    fingerprint = records.manifest.fingerprint if records is not None \
        else None
    # position of the NEXT global batch to consume
    stream = StreamPosition()
    last_saved = None
    # rank consensus (resilience.coord): identity on one process, one
    # store round per decision across ranks, so every failure verdict
    # below (divergence, preemption, resume step) is the SAME on every
    # rank and no rank rolls back or exits alone into a hung collective
    coord = Coordinator(size=world.size, index=world.rank,
                        timeout_s=args.coord_timeout_s)
    # hang watchdog: started BEFORE the first consensus round, so a peer
    # dying during the startup restore is bounded like any other hang
    # (inert at --stall_timeout 0)
    wd = HangWatchdog(args.stall_timeout,
                      straggler_factor=args.straggler_factor,
                      label=f"train[{tc.name}]").start()
    wd.arm(0, "coord-warmup", steady=False)
    try:
        coord.warmup()
    finally:
        wd.disarm()
    # the resume decision is collective: a rank that skipped agree_step
    # would strand its peers mid-round, and a run where only some ranks
    # see checkpoints refuses rather than splicing a stale directory in
    have_ckpt = args.resume and ckpt.latest_step(ckpt_dir) is not None
    all_have = args.resume and not coord.any_flag(not have_ckpt)
    have_any = args.resume and coord.any_flag(have_ckpt)
    if have_any and not all_have:
        raise SystemExit(
            f"[resume] checkpoints under {ckpt_dir} are visible to "
            f"{'this rank' if have_ckpt else 'a peer rank'} but not to "
            "every rank; give every rank the same checkpoint directory, "
            "or drop --resume and use a fresh --name/--output")
    extras: Dict[int, dict] = {}

    def restore(bound):
        """The verified restore at or below ``bound``; the writer alone
        sweeps a crashed flush's debris and deletes what fails."""
        st, step, extra = restore_verified(ckpt_dir, state, step=bound,
                                           clean_debris=writer,
                                           delete_bad=writer)
        extras[step] = extra
        return st, step

    if args.restore_ckpt and not all_have:
        # the weights go in whole, before the state is sharded
        try:
            restored = ckpt.read_model_weights(args.restore_ckpt)
        except (ValueError, FileNotFoundError) as e:
            raise SystemExit(f"train: --restore_ckpt: {e}")
        skipped = ckpt.restore_params_into(state.model, restored,
                                           verbose=True)
        print(f"Partial restore from {args.restore_ckpt} "
              f"({len(skipped)} keys fresh)")
    if fsdp:
        # between steps this rank holds only its slices (parallel.fsdp);
        # a resume restores into that layout
        shard_state(state, mesh)
    if all_have:
        # verified restore: a truncated/non-finite newest step falls back
        # to the previous one; agree_step pins every rank to the SAME step
        wd.arm(0, "resume-restore", steady=False)
        try:
            state, last_saved = coord.agree_step(restore, None)
        except ckpt.LayoutMismatch as e:
            raise SystemExit(f"[resume] {e}")
        finally:
            wd.disarm()
        try:
            pos = position_from_extra(extras[last_saved], last_saved,
                                      seed=tc.seed, loader_kind=loader_kind,
                                      fingerprint=fingerprint)
        except LoaderKindMismatch as e:
            raise SystemExit(f"[resume] {e}")
        stream = pos or stream
        print(f"Resumed full state at step {state.step} (data stream: "
              f"epoch {stream.epoch}, batch {stream.offset})")

    # each rank reads its rows of every global batch: its data index's
    # block of each microbatch (parallel.layout)
    loader_kwargs = dict(seed=tc.seed, num_workers=args.num_workers,
                         worker_mode=args.worker_mode, mp_start_method="spawn",
                         process_index=data_index, process_count=data_size,
                         microbatches=tc.accum_steps)
    if records is not None:
        from dexiraft_tpu_torch.data.records import RecordLoader

        man = records.manifest
        print(f"Training with {len(records)} packed samples "
              f"({man.num_records} records in {len(man.shards)} shard(s), "
              f"fingerprint {man.fingerprint[:12]})")
        loader = RecordLoader(records, tc.batch_size, **loader_kwargs)
    else:
        dataset = fetch_dataset(tc.stage, tc.image_size,
                                edge_root=args.edge_root)
        print(f"Training with {len(dataset)} image pairs")
        loader = Loader(dataset, tc.batch_size, **loader_kwargs)
    per_epoch = max(len(loader), 1)
    step_fn = make_train_step(cfg, tc, mesh=mesh)
    logger = Logger(tc.sum_freq,
                    log_dir=osp.join(args.log_dir, tc.name) if writer
                    else None,
                    tensorboard=writer, model_iters=tc.iters,
                    pipeline_stats=loader.stats)
    total_steps = state.step
    logger.rewind(total_steps)
    guard = DivergenceGuard(args.guard_threshold, args.max_rollbacks)
    configs = {"raft": cfg, "train": tc}
    # bound to ckpt_dir: --keep_best scores persist in
    # <ckpt_dir>/retention.json, so a resumed run still knows the best step
    retention = RetentionPolicy(args.keep, args.keep_best,
                                directory=ckpt_dir if writer else None)
    validate = _make_validators(lambda: state.model, dev)

    def save(step: int, block: bool = False) -> None:
        """Rank 0 hands the checkpoint to its flush (``block``: and waits
        for the commit); then every rank meets at a barrier, so no rank
        runs ahead of a save (or past an emergency save's commit)."""
        nonlocal last_saved
        with sanctioned():
            _save(step, block)
        coord.barrier(f"save@{step}")
        last_saved = step

    def _save(step: int, block: bool) -> None:
        extra = position_extra(stream, seed=tc.seed, loader_kind=loader_kind,
                               fingerprint=fingerprint)
        if writer:
            info = ckpt.wait_pending(ckpt_dir)
            _note_flush(info)
            # GC before the new flush is handed off; the rollback target
            # stays
            retention.apply(ckpt_dir, protect=(last_saved,))
        if fsdp:
            # every rank writes its shard; rank 0 commits after a barrier
            ckpt.save_sharded(ckpt_dir, state, step=step,
                              barrier=coord.barrier, extra=extra,
                              configs=configs)
            return
        if writer:
            ckpt.save_checkpoint(ckpt_dir, state, step=step, block=False,
                                 extra=extra, configs=configs)
            if block:
                info = ckpt.wait_pending(ckpt_dir)
                _note_flush(info)
                if info and info["error"]:
                    raise RuntimeError(f"checkpoint flush of step {step} "
                                       f"failed: {info['error']}")

    @contextlib.contextmanager
    def sanctioned():
        """Host I/O (checkpoints, restores, validation): its compiles and
        host syncs are expected, not steady-state drift."""
        with (watch.sanctioned() if watch is not None
              else contextlib.nullcontext()), guards.sync_window():
            yield

    def verdict():
        """(loss, state_finite) of the last step, one explicit fetch."""
        loss, ok = guards.fetch((metrics["loss"], metrics["state_finite"]))
        return float(loss), bool(ok)

    def _note_flush(info) -> None:
        if info:
            print(f"[ckpt] step {info['step']}: flush "
                  f"{info['flush_s'] * 1e3:.0f} ms, train blocked "
                  f"{info['blocked_s'] * 1e3:.0f} ms"
                  + (f" (FLUSH FAILED: {info['error']})" if info["error"]
                     else ""))

    # fault injection (resilience/chaos.py): a real signal or crash fired
    # after a pinned step, through the real recovery paths
    chaos_step = None
    if args.chaos:
        from dexiraft_tpu_torch.resilience import chaos as chaos_lib

        chaos_step = chaos_lib.parse_spec(args.chaos)

    prof_start, prof_stop = args.profile_steps or (-1, -1)
    prof = None
    # the recompile watch, from the end of the first step; under --strict
    # the strict region (analysis.guards.strict_mode) holds it and arms
    # the sync half (one process on a card)
    watch = None
    region = contextlib.ExitStack()
    metrics = None
    preempted = False
    first_iteration = True
    batches = DevicePrefetcher(
        loader.batches(start_epoch=stream.epoch, start_offset=stream.offset),
        dev,
        depth=tc.prefetch_depth, pipeline_stats=loader.stats)
    preempt = PreemptionHandler()
    try:
        with region, preempt:
            # not armed over the first iteration: its cuDNN searches and
            # kernel builds would trip a step-sized timeout
            for batch in batches:
                if prof is None and prof_start <= total_steps < prof_stop:
                    prof = torch.profiler.profile(activities=(
                        [torch.profiler.ProfilerActivity.CPU]
                        + ([torch.profiler.ProfilerActivity.CUDA]
                           if dev.type == "cuda" else [])))
                    prof.__enter__()
                state, metrics = step_fn(state, batch)
                total_steps += 1
                if watch is None:
                    # the first step searched and built: the steady-state
                    # contract holds from here
                    label = f"train[{tc.name}]"
                    if args.strict:
                        watch = region.enter_context(guards.strict_mode(
                            label=label, device=dev,
                            transfer="allow" if world.size > 1
                            else "disallow"))
                    else:
                        watch = guards.RecompileWatch(label)
                        watch.mark_warm()
                # advanced on consumption, never rewound by a rollback
                stream = StreamPosition(*loader.positions.popleft()).advance(
                    1, per_epoch)
                logger.push(metrics)
                if chaos_step is not None:
                    chaos_step(total_steps)
                if prof is not None and total_steps >= prof_stop:
                    prof.__exit__(None, None, None)
                    path = osp.join(args.log_dir, tc.name, "profile",
                                    f"trace_rank{world.rank}.json"
                                    if world.size > 1 else "trace.json")
                    os.makedirs(osp.dirname(path), exist_ok=True)
                    prof.export_chrome_trace(path)
                    prof, prof_start = None, -1
                    print(f"[profile] trace -> {path}")

                if not args.no_guard and (
                        total_steps % args.guard_every == 0
                        or total_steps % tc.val_freq == 0):
                    # state_finite is the step's post-update verdict over
                    # every rank (the loss certifies only the pre-update
                    # parameters)
                    loss_v, state_ok = verdict()
                    poisoned_here = guard.poisoned(loss_v, state_ok)
                    # a poisoned verdict on ANY rank rolls back ALL ranks
                    if coord.any_flag(poisoned_here):
                        # the agreed target: the newest step every rank
                        # has saved (-1: nothing saved yet, which aborts)
                        agreed = coord.min_int(
                            last_saved if last_saved is not None else -1)
                        target = None if agreed < 0 else agreed
                        msg = guard.consume_rollback(
                            loss_v, state_ok, f"step {total_steps}"
                            + ("" if poisoned_here
                               else " (verdict from a peer rank)"),
                            target, ckpt_dir=ckpt_dir)
                        wd.disarm(feed_ewma=False)
                        wd.arm(total_steps, "rollback-restore", steady=False)
                        if writer:
                            _note_flush(ckpt.wait_pending(ckpt_dir))
                        # the target's flush has committed before any
                        # rank reads it
                        coord.barrier(f"rollback@{total_steps}")
                        # verified: a damaged target falls back further,
                        # and the ranks re-agree until they hold one step
                        with sanctioned():
                            state, last_saved = coord.agree_step(restore,
                                                                 target)
                        print(f"[guard] loss {loss_v:.4g} "
                              f"(state_finite={state_ok}, poisoned_here="
                              f"{poisoned_here}) at step {total_steps}; "
                              f"{msg}; restored step {last_saved}")
                        total_steps = state.step
                        logger.rewind(total_steps)
                        metrics = None
                        wd.disarm(feed_ewma=False)
                        wd.arm(total_steps + 1, "step+data")
                        continue

                # the recompile sentinel, on the guard's cadence: strict
                # raises, the default warns once
                if total_steps % args.guard_every == 0:
                    if args.strict:
                        watch.check()
                    else:
                        watch.warn_if_drifted()

                # preemption is a COLLECTIVE verdict: one rank's SIGTERM
                # stops every rank at the same step. One process: the
                # local flag every step; ranks: one store round every
                # --coord_every steps
                if coord.size == 1:
                    stop_now = preempt.triggered
                else:
                    stop_now = (total_steps % args.coord_every == 0
                                and coord.any_flag(preempt.triggered))
                if stop_now:
                    preempted = True
                    wd.disarm(feed_ewma=False)
                    wd.arm(total_steps, "emergency-save", steady=False)
                    if args.on_preempt == "save":
                        poisoned = False
                        if not args.no_guard and metrics is not None:
                            poisoned = guard.poisoned(*verdict())
                        # one rank's poison vetoes the save everywhere
                        if coord.any_flag(poisoned):
                            print(f"[preempt] state at step {total_steps} "
                                  f"is poisoned; NOT saving — latest good "
                                  f"checkpoint remains step {last_saved}")
                        else:
                            save(total_steps, block=True)
                            print(f"[preempt] emergency checkpoint: "
                                  f"{ckpt_dir} step {total_steps} (data "
                                  f"stream epoch {stream.epoch}, batch "
                                  f"{stream.offset}); resume with --resume")
                    else:
                        print(f"[preempt] --on_preempt abort: stopping "
                              f"without saving (latest checkpoint: step "
                              f"{last_saved})")
                    break
                in_val_window = total_steps % tc.val_freq == 0
                if in_val_window:
                    # the step part of this iteration is done: the
                    # (sanctioned, slow) checkpoint+validation window
                    wd.disarm(feed_ewma=not first_iteration)
                    wd.arm(total_steps, "checkpoint+validation",
                           steady=False)
                    save(total_steps)
                    if fsdp and tc.validation:
                        # rank 0 validates the whole model: every rank
                        # gathers, as JAX's gather_state does
                        state.shards.gather_()
                    if writer and tc.validation:
                        # barrier before validation: --keep_best must not
                        # rank a step whose flush then fails
                        _note_flush(ckpt.wait_pending(ckpt_dir))
                    for vname in (tc.validation if writer else ()):
                        with sanctioned():
                            results = validate(vname)
                        logger.write_dict(results, step=total_steps)
                        # the first EPE-like scalar of the first set ranks
                        # this checkpoint for --keep_best (lower = better)
                        if vname == tc.validation[0] and results:
                            epe_keys = [k for k in results
                                        if "epe" in k or k == vname]
                            if epe_keys:
                                retention.note_score(total_steps,
                                                     results[epe_keys[0]])
                    if tc.validation:
                        # the other ranks wait out rank 0's validation
                        # (a full Sintel pass outlasts --coord_timeout_s):
                        # no consensus deadline; the window armed above
                        # bounds it at 10x --stall_timeout
                        coord.barrier(f"validation@{total_steps}",
                                      bounded=False)
                        if fsdp:
                            state.shards.free_()
                if total_steps >= tc.num_steps:
                    break
                # close this iteration's window (a validation window and
                # the first, partial one stay out of the step-time EWMA)
                # and open the next, which also covers the batch fetch
                if not first_iteration or in_val_window:
                    wd.disarm(feed_ewma=not in_val_window)
                wd.arm(total_steps + 1, "step+data")
                first_iteration = False
    finally:
        batches.close()
        if prof is not None:
            prof.__exit__(None, None, None)
        # the monitor must not outlive the loop: what follows is host I/O
        wd.stop()
    final_ok = not preempted
    if final_ok and not args.no_guard and metrics is not None:
        loss_v, state_ok = verdict()
        if guard.poisoned(loss_v, state_ok):
            final_ok = False
            print(f"[guard] final state poisoned (loss {loss_v:.4g}, "
                  f"state_finite={state_ok}); skipping the final save — "
                  f"latest good checkpoint remains step {last_saved}")
    if final_ok and last_saved != total_steps:
        save(total_steps, block=True)
    elif writer:
        _note_flush(ckpt.wait_pending(ckpt_dir))
    # the end-of-run verdict: strict fails the run on a compile the
    # sanctioned windows did not absorb; the default warns once
    if watch is not None:
        if args.strict:
            watch.check()
        else:
            watch.warn_if_drifted()
    if wd.enabled and wd.straggler_warnings:
        print(f"[watchdog] {wd.straggler_warnings} straggler warning(s) "
              f"this run (EWMA step {wd.ewma_s:.2f}s)")
    logger.close()
    held = state_bytes(state)
    print(f"[state] parameters + Adam moments held {held['held']} of "
          f"{held['full']} bytes ({held['held'] / held['full']:.4f}); "
          f"sharded parameters' resident bytes {held['resident_sharded']}")
    print(f"[prefetch] {batches.summary()}")
    # this process's kernel launches (the train step's forward on B1 at
    # --corr_impl flash --fused_update; all zero on the CPU)
    print(f"[kernels] launches {json.dumps(dict(corr_kernels.LAUNCHES))}")
    if loader.stats.faults:
        print(f"[pipeline] {loader.stats.summary()}")
    if preempted:
        print(f"Preempted at step {total_steps} ({preempt.signal_name}) "
              f"-> {ckpt_dir}")
    else:
        print(f"Done: {total_steps} steps -> {ckpt_dir}")


def main(argv=None) -> None:
    from dexiraft_tpu_torch.parallel import distributed

    args = build_parser().parse_args(argv)
    refuse_unported(args)
    cfg, tc = resolve_configs(args)
    # joins torchrun's process group before anything touches a card (a
    # single process without torchrun's environment)
    world = distributed.initialize(args.device)
    train(cfg, tc, args, world)
    distributed.teardown()


if __name__ == "__main__":
    main(sys.argv[1:])
