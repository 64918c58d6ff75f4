"""Evaluation / submission CLI of the PyTorch port (reference:
evaluate.py:212-243).

  python -m dexiraft_tpu_torch eval --model weights.pth \\
      --dataset sintel --variant v5
  python -m dexiraft_tpu_torch eval --model checkpoints/raft-things \\
      --submission sintel --warm_start --output sintel_submission

Counterpart of ``dexiraft_tpu/eval_cli.py``: the same flags and defaults,
the same validators and submission writers (dexiraft_tpu_torch.eval),
the engine path (``--batch_size`` > 1 or ``--serve``) and the
``--adaptive_iters`` frontier record. ``--model`` is a state-dict file
(the bridge's ``export_raft_state_dict`` layout) or a checkpoint
directory of the port's trainer, loaded with strict=True. The device is
``cuda`` unless ``--device cpu`` is given; without a card the CLI exits
naming it. ``--corr_impl auto`` is the fused B1 kernel on the card.

``--mixed_precision`` runs the model in bf16 over its fp32 weights, as
the JAX CLI's flag does. ``--strict`` runs every evaluation and submission
in one ``analysis.guards.strict_mode`` region: on a card an implicit host
sync raises (on the CPU only the recompile half is armed), and a compile
on a geometry already seen fails the run (``_strict_wrap``, or the
engine's check on a searched bucket). On a mesh both halves stay armed:
every put and fetch there is ``guards.put``/``guards.fetch``.

``--data_parallel N`` (> 0) evaluates data-parallel over a serve mesh
of N entries (``parallel.layout.make_serve_mesh``: the first N cards,
or N entries of the CPU with ``--device cpu``): the model is replicated
once onto every entry and each engine batch's rows are cut into one
block per entry. It implies the engine path; ``--batch_size`` must
divide by N, a warm-start submission carries its flows through the host,
and the ``--adaptive_iters`` sweep stays per image on one device. Refused, naming its ROADMAP item: an orbax ``--model`` directory
(A10). PyTorch runs eagerly, so
``--scan_unroll`` changes nothing and only says so. v2/v3 take their edge
frames from the data, which the validators never pass: they fail with the
model's ValueError, as in the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from dexiraft_tpu_torch.config import VARIANTS
from dexiraft_tpu_torch.train_cli import _VAL_ITERS

# ---- adaptive frontier record schema (the JAX package's) ---------------
FRONTIER_RECORD_KEYS = {
    "record", "dataset", "iters", "converge_tol", "fixed", "sweep",
}
# every sweep leg carries the dataset's metric keys plus these
FRONTIER_LEG_KEYS = {
    "budget", "wall_s", "mean_iters_used", "p99_iters_used",
    "mean_final_delta",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dexiraft-torch-eval")
    p.add_argument("--model", required=True,
                   help="a state-dict file or a checkpoint directory of "
                        "the port's trainer")
    p.add_argument("--dataset",
                   choices=["chairs", "sintel", "kitti", "hd1k", "edgesum"],
                   help="'edgesum' = the v1-lineage summed-fusion "
                        "validation (alt/evaluate_1.py): chairs val pairs "
                        "+ their edge images from --edge_root, per-iter "
                        "flows of both passes summed before EPE")
    p.add_argument("--edge_root", default=None,
                   help="parallel tree of edge-map PNGs (for "
                        "--dataset edgesum)")
    p.add_argument("--submission", choices=["sintel", "kitti"])
    p.add_argument("--warm_start", action="store_true")
    p.add_argument("--variant", default="v1", choices=sorted(VARIANTS))
    p.add_argument("--small", action="store_true")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 encoders, DexiNed and update block (the "
                        "correlation stays fp32)")
    p.add_argument("--corr_impl", default="auto",
                   choices=["auto", "allpairs", "local", "pallas", "flash"],
                   help="'auto' (default) = the fused flash kernel (B1) on "
                        "the card, the plain local lookup on the CPU")
    p.add_argument("--corr_dtype", default="fp32",
                   choices=["fp32", "bf16", "int8"],
                   help="storage precision of the correlation pyramid")
    p.add_argument("--fused_update", action="store_true",
                   help="each iteration's 4-level lookup and the motion "
                        "encoder's corr conv in one kernel launch (requires "
                        "--corr_impl flash or pallas; same checkpoints)")
    p.add_argument("--scan_unroll", type=int, default=1,
                   help="accepted for the JAX CLI's sake; the PyTorch port "
                        "runs eagerly, so it changes nothing")
    p.add_argument("--dexined_upconv", default="subpixel",
                   choices=["transpose", "subpixel"],
                   help="embedded-DexiNed upsampler implementation "
                        "(numerically identical)")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--adaptive", action="store_true",
                   help="convergence-gated adaptive inference: each item "
                        "stops refining once its flow-delta norm drops "
                        "below converge_tol; --iters becomes the budget cap")
    p.add_argument("--converge_tol", type=float, default=None,
                   help="override RAFTConfig.converge_tol (0 disables the "
                        "gate: fixed-iteration parity)")
    p.add_argument("--adaptive_iters", default=None,
                   help="comma-separated iteration budgets (e.g. "
                        "4,8,16,32): runs the fixed baseline at --iters "
                        "plus the adaptive driver at each budget and "
                        "emits ONE EPE-vs-latency frontier JSON record")
    p.add_argument("--frontier_out", default=None,
                   help="also write the --adaptive_iters frontier "
                        "record to this path")
    p.add_argument("--output", default=None, help="submission output dir")
    # the engine knobs of serve_cli, with eval's metric-parity defaults
    from dexiraft_tpu_torch.serve.engine import add_engine_args

    add_engine_args(p, batch_size=1, bucket_multiple=None)
    p.add_argument("--serve", action="store_true",
                   help="route through the inference engine even at "
                        "batch_size 1 (async in-flight dispatch, bucket "
                        "accounting)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard each engine batch over N devices (a serve "
                        "mesh of the first N cards, or N CPU entries with "
                        "--device cpu); implies the engine path, and "
                        "--batch_size must divide by N (default 0: one "
                        "device)")
    p.add_argument("--strict", action="store_true",
                   help="run evaluation inside analysis.guards."
                        "strict_mode: an implicit host sync raises (on a "
                        "card; on the CPU only the recompile half is "
                        "armed) and a compile on an already-seen geometry "
                        "fails the run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (default) or 'cpu'")
    return p


def check_args(args) -> None:
    """Exit on flags that do not go together (JAX's checks)."""
    if args.data_parallel < 0:
        raise SystemExit(f"--data_parallel must be >= 0, got "
                         f"{args.data_parallel}")
    if args.data_parallel and args.batch_size % args.data_parallel:
        raise SystemExit(f"--batch_size {args.batch_size} must divide by "
                         f"--data_parallel {args.data_parallel}")


def make_mesh(args, model, dev):
    """(serve mesh, replicas) for --data_parallel N > 0: the mesh of N
    entries on ``dev``'s kind and the model's replicas, made once (every
    eval step of the run shares them); (None, model) otherwise."""
    from dexiraft_tpu_torch.parallel.layout import cli_serve_mesh, replicate

    mesh = cli_serve_mesh(args.data_parallel, dev, "eval")
    return (None, model) if mesh is None else (mesh, replicate(model, mesh))


def load_model(args, dev):
    """(cfg, model on ``dev`` in eval mode) from --model, strict=True."""
    from dexiraft_tpu_torch.config import resolve_corr_impl_args
    from dexiraft_tpu_torch.models.raft import RAFT
    from dexiraft_tpu_torch.train.checkpoint import read_model_weights

    impl, fused = resolve_corr_impl_args(args, dev.type, "eval")
    try:
        cfg = VARIANTS[args.variant](small=args.small,
                                     mixed_precision=args.mixed_precision,
                                     corr_impl=impl,
                                     corr_dtype=args.corr_dtype,
                                     fused_update=fused,
                                     dexined_upconv=args.dexined_upconv)
        if args.converge_tol is not None:
            # the gate threshold shapes no params, only the adaptive exit
            cfg = dataclasses.replace(cfg, converge_tol=args.converge_tol)
        model = RAFT(cfg)
        sd = read_model_weights(args.model)
    except (ValueError, FileNotFoundError) as e:
        raise SystemExit(f"eval: {e}")
    model.load_state_dict(sd, strict=True)
    print(f"[eval] loaded {len(sd)} tensors from {args.model}", flush=True)
    return cfg, model.to(dev).eval()


def _edgesum_dataset(edge_root: str):
    """Chairs validation pairs + their edge images from a parallel tree —
    the data side of the v1-lineage summed-fusion validation
    (alt/evaluate_1.py), with training's path mapping
    (data.datasets.wrap_with_edge_tree)."""
    from dexiraft_tpu_torch.data.datasets import (FlyingChairs,
                                                  wrap_with_edge_tree)

    return wrap_with_edge_tree(FlyingChairs(None, split="validation"),
                               edge_root)


def _dataset_arg(args):
    """The dataset object for --dataset, None for the validator's
    default."""
    if args.dataset != "edgesum":
        return None
    if not args.edge_root:
        raise SystemExit("--dataset edgesum needs --edge_root")
    return _edgesum_dataset(args.edge_root)


def _serving(args) -> bool:
    return args.serve or args.batch_size > 1 or args.data_parallel > 0


def _adaptive_pair_view(eval_fn, sink=None):
    """Adapt the adaptive 4-tuple eval fn to the (flow_low, flow_up)
    contract of the per-image loops. iters_used/final_delta land in
    ``sink`` (a list of per-call (iters_used, final_delta) host arrays)
    when one is given."""
    from dexiraft_tpu_torch.eval.validate import _fetch

    def fn(im1, im2, flow_init=None):
        flow_low, flow_up, iters_used, final_delta = eval_fn(
            im1, im2, flow_init)
        if sink is not None:
            sink.append((_fetch(iters_used), _fetch(final_delta)))
        return flow_low, flow_up

    return fn


def _sink_summary(sink) -> dict:
    import numpy as np

    used = np.concatenate([np.atleast_1d(iu) for iu, _ in sink])
    deltas = np.concatenate([np.atleast_1d(fd) for _, fd in sink])
    return {
        "mean_iters_used": round(float(used.mean()), 2),
        "p99_iters_used": round(float(np.percentile(used, 99)), 2),
        "mean_final_delta": round(float(deltas.mean()), 6),
    }


def _make_engine(args, eval_fn, dev, mode, warm_start=False, watch=None,
                 mesh=None):
    """The engine over ``eval_fn`` on ``dev`` (or over ``mesh``); a
    warm-start engine on one device keeps each row's carry there
    (ServeConfig.device_carry), on a mesh the carry goes through the
    host. ``watch``: the strict region's, which the engine's expected
    bucket searches re-baseline."""
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig

    device_carry = warm_start and mesh is None
    engine = InferenceEngine(
        eval_fn,
        ServeConfig.from_args(args, mode=mode, warm_start=warm_start,
                              device_carry=device_carry),
        mesh=mesh, device=None if mesh is not None else dev)
    if watch is not None:
        engine.watch = watch
    return engine


def _strict_wrap(eval_fn, watch):
    """Per-geometry compile absorption for the per-image eval loops: the
    first call on an input signature is an expected search (it
    re-baselines the watch); a repeat signature that compiled anyway is
    drift, and the watch raises."""
    import numpy as np

    seen = set()

    def wrapped(im1, im2, flow_init=None):
        sig = (np.shape(im1), np.shape(im2),
               None if flow_init is None else tuple(flow_init.shape))
        out = eval_fn(im1, im2, flow_init=flow_init)
        if sig in seen:
            watch.check()
        else:
            seen.add(sig)
            watch.mark_warm()
        return out

    return wrapped


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not args.dataset and not args.submission:
        raise SystemExit("need --dataset or --submission")
    from dexiraft_tpu_torch.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"eval: {e}")
    if args.scan_unroll != 1:
        print(f"[eval] --scan_unroll {args.scan_unroll} changes nothing: "
              "the PyTorch port runs eagerly", flush=True)
    check_args(args)
    cfg, model = load_model(args, dev)
    # the --adaptive_iters sweep runs per image, on one device
    mesh, replicas = ((None, model) if args.adaptive_iters
                      else make_mesh(args, model, dev))
    import contextlib

    from dexiraft_tpu_torch.analysis import guards

    region = contextlib.ExitStack()
    watch = None
    if args.strict:
        # one strict region over every eval and submission below: an
        # implicit host sync raises at the offending call, and the
        # region's exit check fails the run on any compile the
        # per-geometry absorption (_strict_wrap, the engine's mark_warm)
        # did not expect
        watch = region.enter_context(guards.strict_mode(label="eval",
                                                        device=dev))
    with region:
        if args.adaptive_iters:
            _adaptive_sweep(args, cfg, model, dev)
            return
        _run_eval(args, model, dev, watch, mesh, replicas)


def _run_eval(args, model, dev, watch=None, mesh=None, replicas=None
              ) -> None:
    from dexiraft_tpu_torch.train.step import make_eval_step

    if mesh is not None:  # every step runs over the mesh's replicas
        model = replicas
    if args.dataset:
        from dexiraft_tpu_torch.eval.validate import run_validation

        dataset = _dataset_arg(args)
        iters = args.iters or _VAL_ITERS.get(args.dataset, 24)
        eval_fn = make_eval_step(model, iters=iters, device=dev,
                                 adaptive=args.adaptive, mesh=mesh)
        engine = None
        sink: list = []
        if _serving(args):
            mode = "kitti" if args.dataset in ("kitti", "hd1k") else "sintel"
            engine = _make_engine(args, eval_fn, dev, mode, watch=watch,
                                  mesh=mesh)
        else:
            if args.adaptive:
                eval_fn = _adaptive_pair_view(eval_fn, sink)
            if watch is not None:
                eval_fn = _strict_wrap(eval_fn, watch)
        run_validation(args.dataset, eval_fn, dataset,
                       batch_size=args.batch_size, engine=engine)
        if engine is not None:
            print(f"engine: {engine.stats.summary()}")
            if engine.config.adaptive:
                print(f"adaptive: mean iters_used "
                      f"{engine.stats.iters_used_mean():.1f} / "
                      f"p99 {engine.stats.iters_used_pctl(99):.0f} "
                      f"(budget {iters})")
        elif sink:
            s = _sink_summary(sink)
            print(f"adaptive: mean iters_used {s['mean_iters_used']} / "
                  f"p99 {s['p99_iters_used']} (budget {iters}), "
                  f"mean final delta {s['mean_final_delta']}")

    if args.submission == "sintel":
        from dexiraft_tpu_torch.eval.submission import create_sintel_submission

        eval_fn = make_eval_step(model, iters=args.iters or 32, device=dev,
                                 adaptive=args.adaptive, mesh=mesh)
        engine = (_make_engine(args, eval_fn, dev, "sintel",
                               warm_start=args.warm_start, watch=watch,
                               mesh=mesh)
                  if _serving(args) else None)
        if engine is None and args.adaptive:
            eval_fn = _adaptive_pair_view(eval_fn)
        if engine is None and watch is not None:
            eval_fn = _strict_wrap(eval_fn, watch)
        create_sintel_submission(
            eval_fn,
            output_path=args.output or "sintel_submission",
            warm_start=args.warm_start,
            batch_size=args.batch_size,
            engine=engine)
    elif args.submission == "kitti":
        from dexiraft_tpu_torch.eval.submission import create_kitti_submission

        eval_fn = make_eval_step(model, iters=args.iters or 24, device=dev,
                                 adaptive=args.adaptive, mesh=mesh)
        engine = (_make_engine(args, eval_fn, dev, "kitti", watch=watch,
                               mesh=mesh)
                  if _serving(args) else None)
        if engine is None and args.adaptive:
            eval_fn = _adaptive_pair_view(eval_fn)
        if engine is None and watch is not None:
            eval_fn = _strict_wrap(eval_fn, watch)
        create_kitti_submission(
            eval_fn,
            output_path=args.output or "kitti_submission",
            batch_size=args.batch_size,
            engine=engine)


def _adaptive_sweep(args, cfg, model, dev) -> None:
    """The EPE-vs-latency frontier protocol: ONE fixed baseline at
    --iters plus the adaptive driver at each budget in --adaptive_iters,
    all over the same dataset in the same process. Emits one
    self-describing JSON record (stdout, and --frontier_out).

    Per-image loop on purpose (no engine/batching): the legs differ
    only in the refinement driver, so their wall-clocks are directly
    comparable and the per-item iters_used samples are exact. Each leg's
    wall time ends with its last flow on the host.
    """
    import json
    import time

    from dexiraft_tpu_torch.eval.validate import run_validation
    from dexiraft_tpu_torch.train.step import make_eval_step

    if not args.dataset:
        raise SystemExit("--adaptive_iters needs --dataset")
    budgets = [int(tok) for tok in args.adaptive_iters.split(",")
               if tok.strip()]
    if not budgets:
        raise SystemExit(f"--adaptive_iters parsed to no budgets: "
                         f"{args.adaptive_iters!r}")
    dataset = _dataset_arg(args)
    iters = args.iters or _VAL_ITERS.get(args.dataset, 24)

    fixed_fn = make_eval_step(model, iters=iters, device=dev)
    t0 = time.perf_counter()
    fixed_metrics = run_validation(args.dataset, fixed_fn, dataset)
    fixed_wall = time.perf_counter() - t0

    adaptive_fn = make_eval_step(model, iters=iters, device=dev,
                                 adaptive=True)
    record = {
        "record": "adaptive_frontier",
        "dataset": args.dataset,
        "iters": iters,
        "converge_tol": cfg.converge_tol,
        "fixed": {**fixed_metrics, "wall_s": round(fixed_wall, 2)},
        "sweep": [],
    }
    for budget in budgets:
        sink: list = []
        fn = _adaptive_pair_view(
            lambda im1, im2, flow_init=None, _b=budget:
            adaptive_fn(im1, im2, flow_init, _b), sink)
        t0 = time.perf_counter()
        metrics = run_validation(args.dataset, fn, dataset)
        wall = time.perf_counter() - t0
        leg = {**metrics, "budget": budget, "wall_s": round(wall, 2)}
        if sink:
            leg.update(_sink_summary(sink))
        # the frontier's decision metric: quality cost of THIS budget
        # relative to the fixed anchor, per dataset key
        for k, v in fixed_metrics.items():
            if isinstance(v, float) and k in metrics:
                leg[f"{k}_delta"] = round(metrics[k] - v, 4)
        if not FRONTIER_LEG_KEYS <= set(leg):
            raise RuntimeError(f"frontier leg lacks "
                               f"{sorted(FRONTIER_LEG_KEYS - set(leg))}")
        record["sweep"].append(leg)
    if set(record) != FRONTIER_RECORD_KEYS:
        raise RuntimeError(f"frontier record keys differ: "
                           f"{sorted(set(record) ^ FRONTIER_RECORD_KEYS)}")
    line = json.dumps(record)
    print(line)
    if args.frontier_out:
        with open(args.frontier_out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
