"""Persistent flow-service CLI: a model behind HTTP, on the card.

  python -m dexiraft_tpu_torch serve --model raft-things.pth \\
      --variant v5 --port 8000 --batch_size 4 --bucket_multiple 64

Counterpart of ``dexiraft_tpu/serve_cli.py``, with its flags and defaults
where they mean something in the port. One process is one worker: weights
-> the eval step on the card -> InferenceEngine -> SLO Scheduler -> HTTP
endpoint (serve/server.py). ``--workers N`` starts N single-worker
children that bind one port with SO_REUSEPORT; on one card each child
holds its own CUDA context and weights, and the children are stateless
(sessions off), since the kernel's accept balancing has no affinity.

Session carry stays on the card by default (``--host_carry`` moves it
through the host), and a single worker with sessions on also serves
chained video through ``POST /v1/flow/stream`` (serve/video.py).

The step runs on CUDA unless ``--cpu`` asks for the CPU: without a card
the process exits non-zero, naming ``cuda``. A kernel that fails to
build or launch fails its request with 500; nothing falls back to the
plain version.

``--model`` takes a torch state-dict file with the reference key names
(the layout ``dexiraft_tpu/interop/torch_convert.export_raft_state_dict``
writes and ``load_raft_pth`` reads; a ``module.`` prefix and a
``state_dict`` wrapper are stripped), or a checkpoint directory of the
port's trainer (its newest step's model), loaded with ``strict=True``.
``--mixed_precision`` serves the model in bf16 over its fp32 weights.
``--strict`` serves inside ``analysis.guards.strict_mode`` from the end of
the warm-up: on a card an implicit host sync raises (on the CPU only the
recompile half is armed), a compile on a searched bucket fails its
request (the pair and streaming engines share one RecompileWatch), and the
lock-order runtime raises on an inverted nesting. Refused, naming its
ROADMAP item: an orbax checkpoint directory (A10). The JAX CLI's XLA
flags (``--compile_cache_dir``, ``--no_compile_cache``,
``--scan_unroll``) have no counterpart here.

``--data_parallel N`` (> 0) serves data-parallel over a serve mesh of N
entries (``parallel.layout.make_serve_mesh``: the first N cards, or N
entries of the CPU with ``--cpu``): the model is replicated once onto
each entry, every pair batch's rows are cut into one block per entry
(``--batch_size`` must divide by N), the pair forwards still run on the
pair engine's DeviceThread, the session carry goes through the host, and
the streaming endpoint is off (its batch-1 chunks do not shard), as in
JAX.

SIGTERM drains: admitted requests finish and flush before exit; a second
signal aborts.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import subprocess
import sys

from dexiraft_tpu_torch.config import CORR_DTYPES, VARIANTS
from dexiraft_tpu_torch.serve.engine import ServeConfig, add_engine_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dexiraft-torch-serve")
    p.add_argument("--model", default=None,
                   help="torch state-dict file with the reference key "
                        "names (export_raft_state_dict's layout)")
    p.add_argument("--synthetic_init", action="store_true",
                   help="serve the seeded random init (create_model(cfg, "
                        "seed=0)) instead of weights: load and capacity "
                        "runs exercise the serving stack without a model")
    p.add_argument("--variant", default="v1", choices=sorted(VARIANTS))
    p.add_argument("--small", action="store_true")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 encoders, DexiNed and update block (the "
                        "correlation stays fp32)")
    p.add_argument("--corr_impl", default="auto",
                   choices=["auto", "allpairs", "local", "pallas", "flash"],
                   help="'auto' (default) = the production config: the "
                        "flash kernel with the fused update on the card "
                        "(B1), the plain lookup with --cpu")
    p.add_argument("--corr_dtype", default="fp32", choices=CORR_DTYPES,
                   help="correlation-pyramid storage precision")
    p.add_argument("--fused_update", action="store_true",
                   help="the lookup and the motion encoder's 1x1 corr conv "
                        "in one kernel per iteration (requires --corr_impl "
                        "flash or pallas)")
    p.add_argument("--dexined_upconv", default="subpixel",
                   choices=["transpose", "subpixel"])
    p.add_argument("--iters", type=int, default=24,
                   help="refinement iterations per request (the budget "
                        "cap with --adaptive)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive-iteration inference: each item stops "
                        "refining at convergence (converge_tol) and the "
                        "scheduler turns each batch head's remaining SLO "
                        "and the queue's pressure into an iteration budget")
    p.add_argument("--converge_tol", type=float, default=None,
                   help="override RAFTConfig.converge_tol (0 disables "
                        "the gate)")
    p.add_argument("--min_iters", type=int, default=4,
                   help="adaptive budget floor")
    p.add_argument("--mode", default="sintel", choices=["sintel", "kitti"],
                   help="pad placement for bucket padding")
    add_engine_args(p, batch_size=4, bucket_multiple=64)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard each pair batch over N devices (a serve "
                        "mesh of the first N cards, or N CPU entries with "
                        "--cpu); --batch_size must divide by N, the carry "
                        "goes through the host and the streaming endpoint "
                        "is off (default 0: one device)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slo_ms", type=float, default=200.0,
                   help="per-request latency budget: a partial batch "
                        "dispatches when the oldest queued request's "
                        "budget (minus the bucket's learned service time) "
                        "runs out")
    p.add_argument("--max_queue", type=int, default=64,
                   help="queued-request admission bound; past it the "
                        "service sheds load with 503")
    p.add_argument("--session_ttl_s", type=float, default=60.0,
                   help="session warm-start TTL; 0 disables sessions "
                        "(stateless mode, forced when --workers > 1)")
    p.add_argument("--host_carry", action="store_true",
                   help="move the session carry through the host (a D2H "
                        "per response, an H2D per warm request) instead "
                        "of keeping it on the card; implied by --workers "
                        "> 1")
    p.add_argument("--stream_sessions_mb", type=float, default=256.0,
                   help="device byte budget for the streaming tier's "
                        "feature carries (POST /v1/flow/stream); 0 "
                        "disables the streaming endpoint")
    p.add_argument("--stream_chunk_frames", type=int, default=64,
                   help="max frames per /v1/flow/stream chunk (400 past "
                        "it)")
    p.add_argument("--request_timeout_s", type=float, default=60.0,
                   help="per-request server-side wait bound (504 past it)")
    p.add_argument("--workers", type=int, default=1,
                   help="worker processes sharing one SO_REUSEPORT port")
    p.add_argument("--warmup", default=None,
                   help="comma-separated HxW geometries to run once before "
                        "accepting traffic (builds the kernels and lets "
                        "cuDNN search each bucket's convs), e.g. "
                        "440x1024,376x1248")
    p.add_argument("--strict", action="store_true",
                   help="serve inside analysis.guards.strict_mode after "
                        "the warm-up: an implicit host sync raises (on a "
                        "card; on the CPU only the recompile half is "
                        "armed) and a compile on a searched bucket fails "
                        "its request")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the "
                        "kernels); without it the service needs a card")
    p.add_argument("--reuse_port", action="store_true",
                   help=argparse.SUPPRESS)  # set by the --workers parent
    return p


def _check_args(args) -> None:
    """Flags that do not go together: one line saying why."""
    if args.data_parallel < 0:
        raise SystemExit(f"serve: --data_parallel must be >= 0, got "
                         f"{args.data_parallel}")
    if args.data_parallel and args.batch_size % args.data_parallel:
        raise SystemExit(f"serve: --batch_size {args.batch_size} must "
                         f"divide by --data_parallel {args.data_parallel}")


# ---- multi-worker pool --------------------------------------------------


def _run_pool(args, argv) -> None:
    """Spawn N single-worker children on one SO_REUSEPORT port; forward
    SIGTERM/SIGINT so every child drains; exit with the worst child rc."""
    if args.port == 0:
        raise SystemExit("serve: --workers > 1 needs an explicit --port "
                         "(ephemeral port 0 would scatter the workers)")
    # appended flags override the parent's own (the last occurrence wins)
    child_argv = list(argv) + ["--workers", "1", "--reuse_port",
                               "--session_ttl_s", "0"]
    children = []
    for i in range(args.workers):
        env = dict(os.environ, DEXIRAFT_SERVE_WORKER=str(i))
        # own session: every signal a child sees comes through _forward
        children.append(subprocess.Popen(
            [sys.executable, "-m", "dexiraft_tpu_torch", "serve"]
            + child_argv, env=env, start_new_session=True))
    print(f"[serve] pool: {args.workers} workers on "
          f"{args.host}:{args.port} (SO_REUSEPORT), one CUDA context and "
          f"one copy of the weights each, stateless sessions", flush=True)

    def _forward(signum, frame):
        for c in children:
            try:
                c.send_signal(signum)
            except OSError:
                pass

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _forward)
    rc = 0
    for c in children:
        try:
            rc = max(rc, abs(c.wait()))
        except KeyboardInterrupt:
            _forward(signal.SIGINT, None)
            rc = max(rc, abs(c.wait()))
    raise SystemExit(rc)


# ---- single worker ------------------------------------------------------


def _device(args):
    """The step's device: CUDA unless --cpu; no card is an error."""
    from dexiraft_tpu_torch.device import resolve_device

    try:
        return resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        raise SystemExit(f"serve: {e}")


def _load(args, dev):
    """(cfg, model) on ``dev``: the weights of --model (strict=True) or
    the seeded init of --synthetic_init."""
    from dexiraft_tpu_torch.config import resolve_corr_impl_args
    from dexiraft_tpu_torch.models.raft import RAFT, create_model

    impl, fused = resolve_corr_impl_args(args, dev.type, "serve")
    try:
        cfg = VARIANTS[args.variant](small=args.small,
                                     mixed_precision=args.mixed_precision,
                                     corr_impl=impl,
                                     corr_dtype=args.corr_dtype,
                                     fused_update=fused,
                                     dexined_upconv=args.dexined_upconv)
        if args.converge_tol is not None:
            cfg = dataclasses.replace(cfg, converge_tol=args.converge_tol)
    except ValueError as e:
        raise SystemExit(f"serve: {e}")
    try:
        if args.synthetic_init:
            model = create_model(cfg, seed=0, device=dev)
            print("[serve] synthetic init: serving RANDOM weights "
                  "(bench/chaos mode — flow quality is meaningless)",
                  flush=True)
            return cfg, model
        model = RAFT(cfg)
    except ValueError as e:  # a config the model refuses
        raise SystemExit(f"serve: {e}")
    from dexiraft_tpu_torch.train.checkpoint import read_model_weights

    try:
        sd = read_model_weights(args.model)
    except (ValueError, FileNotFoundError) as e:
        raise SystemExit(f"serve: {e}")
    model.load_state_dict(sd, strict=True)
    print(f"[serve] loaded {len(sd)} tensors from {args.model}", flush=True)
    return cfg, model.to(dev).eval()


def _on_device_thread(fns, dev, name):
    """On CUDA, ``fns`` run on one DeviceThread: cuDNN's search results
    live per thread, and the service calls them from threads it does not
    keep warm (device.DeviceThread)."""
    if dev.type != "cuda":
        return fns
    from dexiraft_tpu_torch.device import DeviceThread

    worker = DeviceThread(name)
    return [worker.wrap(fn) for fn in fns]


def _make_eval_fn(args, model, iters, dev, mesh=None):
    """The engine's eval_fn: the test-mode step on ``dev``, or over
    ``mesh`` on replicas of ``model`` made once here (on CUDA, run on the
    pair engine's DeviceThread); with --adaptive, the gated loop with a
    trailing iter_budget (None = the full ``iters``)."""
    from dexiraft_tpu_torch.train.step import make_eval_step

    step = make_eval_step(model, iters=iters, device=dev,
                          adaptive=args.adaptive, mesh=mesh)
    (step,) = _on_device_thread([step], dev, "serve-pairs")
    return step


def _make_carry_fn(dev, device: bool = True):
    """Session carry = the previous frame's low-res flow splatted forward
    to the next frame's grid (forward_interpolate) on ``dev``. device=True
    keeps the result a device tensor (the store holds it, the engine
    stacks it into the next warm batch); device=False returns host numpy
    (--host_carry)."""
    import torch

    from dexiraft_tpu_torch.analysis import guards
    from dexiraft_tpu_torch.eval.interpolate import forward_interpolate

    @torch.inference_mode()
    def carry(flow_low):
        if not isinstance(flow_low, torch.Tensor):
            flow_low = guards.put(flow_low, dev)
        out = forward_interpolate(flow_low.to(dev))
        return out if device else guards.fetch(out)

    return carry


def _warmup(engine, geometries, carry_fn=None, video=None) -> float:
    """Run each named bucket once before the listener opens: the first
    dispatch builds the kernels and lets cuDNN search the bucket's convs,
    which would otherwise land in a first request's latency. The carry
    splat and the streaming engine run here too, so a --strict service is
    compile-flat from the first request; the adaptive engine's second
    dispatch at another budget must ride the first one's searches (its
    check raises otherwise). Returns the pair engine's first-dispatch
    seconds (its ``compile_s``, cuDNN's search)."""
    import numpy as np

    for geom in geometries:
        h, w = (int(v) for v in geom.split("x"))
        item = {"image1": np.zeros((h, w, 3), np.float32),
                "image2": np.zeros((h, w, 3), np.float32)}
        (res,) = engine.run_batch([item])
        if carry_fn is not None:
            carry_fn(res.flow_low)
            engine.watch.mark_warm()  # expected, not drift
        if engine.config.adaptive:
            (res2,) = engine.run_batch([item], iter_budget=1)
            engine.watch.check()
            if res2.iters_used is None:
                raise RuntimeError(
                    "adaptive engine returned no iters_used during "
                    "warmup — eval_fn is not the adaptive 4-tuple "
                    "contract (make_eval_step(adaptive=True))")
    if video is not None:
        video.warmup(geometries)
    search_s = engine.compile_s
    engine.reset_stats()  # warmup is not traffic
    return search_s


def _make_video_engine(args, cfg, model, dev, sessions_on, watch=None,
                       mesh=None):
    """The streaming tier (serve/video.py), or None with a printed why
    (on a mesh: the chunk loop is batch-1 and serially dependent, and a
    frame's rows are the wrong axis to shard). ``watch``: the pair
    engine's, shared (the compile counter is process-wide, so a separate
    watch would read one engine's expected searches as the other's
    drift)."""
    why = None
    if args.stream_sessions_mb <= 0:
        why = "--stream_sessions_mb 0"
    elif not sessions_on:
        why = "sessions off (the carry needs a session store)"
    elif mesh is not None:
        why = "--data_parallel (batch-1 chunks do not shard)"
    elif cfg.variant in ("early", "separate") and not cfg.embed_dexined:
        why = (f"variant {cfg.variant!r} needs data-supplied edge "
               "frames the stream wire format does not carry")
    if why is not None:
        print(f"[serve] streaming endpoint disabled: {why}", flush=True)
        return None

    import torch

    from dexiraft_tpu_torch.analysis import guards
    from dexiraft_tpu_torch.eval.interpolate import forward_interpolate
    from dexiraft_tpu_torch.serve.sessions import DeviceSessionStore
    from dexiraft_tpu_torch.serve.video import VideoEngine
    from dexiraft_tpu_torch.train.step import (make_encode_step,
                                               make_refine_step)

    encode_step = make_encode_step(model, device=dev)
    refine_step = make_refine_step(model, iters=args.iters, device=dev,
                                   adaptive=args.adaptive)
    if args.adaptive:
        # chunks bypass the scheduler's SLO policy: the full budget
        refine_fn = (lambda f1, f2, fi:
                     refine_step(f1, f2, fi, args.iters))
    else:
        refine_fn = refine_step

    @torch.inference_mode()
    def splat(low):
        return forward_interpolate(low[0])[None]

    # one thread for every stream's device work (handler threads come and
    # go with their connections)
    encode_step, refine_fn, splat = _on_device_thread(
        [encode_step, refine_fn, splat], dev, "serve-streams")
    store = DeviceSessionStore(
        budget_bytes=int(args.stream_sessions_mb * 2**20),
        ttl_s=args.session_ttl_s, max_sessions=1024)
    return VideoEngine(
        encode_step, refine_fn, splat, sessions=store,
        put=lambda x: guards.put(x, dev),
        mode=args.mode, bucket_multiple=args.bucket_multiple,
        max_chunk_frames=args.stream_chunk_frames, adaptive=args.adaptive,
        strict=args.strict, watch=watch)


def _serve_one(args) -> None:
    import contextlib

    from dexiraft_tpu_torch.analysis import guards
    from dexiraft_tpu_torch.ops import corr_kernels
    from dexiraft_tpu_torch.parallel.layout import cli_serve_mesh
    from dexiraft_tpu_torch.serve import locks
    from dexiraft_tpu_torch.serve.engine import InferenceEngine
    from dexiraft_tpu_torch.serve.server import FlowService

    if args.strict:
        # the lock-order runtime raises at an inverted nesting or a
        # re-entry instead of counting it
        locks.set_strict(True)
    dev = _device(args)
    cfg, model = _load(args, dev)
    mesh = cli_serve_mesh(args.data_parallel, dev, "serve")
    # one resident copy of the weights: the pair step and the streaming
    # encode/refine steps all run this model (on a mesh: one replica per
    # entry, the source itself on its own device, and no streaming)
    eval_fn = _make_eval_fn(args, model, args.iters, dev, mesh)
    sessions_on = args.session_ttl_s > 0
    # the carry goes through the host on a mesh, as in JAX
    device_carry = sessions_on and not args.host_carry and mesh is None
    engine = InferenceEngine(
        eval_fn,
        ServeConfig.from_args(args, mode=args.mode, warm_start=sessions_on,
                              device_carry=device_carry),
        mesh=mesh, device=None if mesh is not None else dev)
    carry_fn = (_make_carry_fn(dev, device=device_carry)
                if sessions_on else None)
    video = _make_video_engine(args, cfg, model, dev, sessions_on,
                               watch=engine.watch, mesh=mesh)
    if args.warmup:
        search_s = _warmup(engine, args.warmup.split(","), carry_fn, video)
        print(f"[serve] warmup: {engine.registry.searches} signature(s) "
              f"searched in {search_s:.1f} s"
              f"{' (+streaming)' if video is not None else ''}", flush=True)
    # /stats' kernel_launches counts traffic: the warm-up's are not
    corr_kernels.reset_launches()
    region = contextlib.ExitStack()
    if args.strict:
        # the region's watch becomes the engines' (marked warm at entry,
        # after the warm-up); its exit check is the service's verdict
        watch = region.enter_context(guards.strict_mode(label="serve",
                                                        device=dev))
        engine.watch = watch
        if video is not None:
            video.watch = watch

    service = FlowService(
        engine,
        host=args.host, port=args.port,
        slo_ms=args.slo_ms, max_queue=args.max_queue,
        max_iters=args.iters, min_iters=args.min_iters,
        session_ttl_s=args.session_ttl_s,
        carry_fn=carry_fn,
        request_timeout_s=args.request_timeout_s,
        reuse_port=args.reuse_port,
        video=video)
    with region:
        _run_service(args, cfg, dev, engine, service, sessions_on)


def _run_service(args, cfg, dev, engine, service, sessions_on) -> None:
    """Start the service, wait for its stop, print the summary."""
    service.install_signal_handlers()
    service.start()
    worker = os.environ.get("DEXIRAFT_SERVE_WORKER")
    tag = f" (worker {worker})" if worker is not None else ""
    print(f"[serve] listening on {service.url}{tag} — device={dev} "
          f"batch_size={args.batch_size} slo_ms={args.slo_ms:g} "
          f"sessions={'on' if sessions_on else 'off'}"
          + (f" data_parallel={engine.mesh.size}"
             if engine.mesh is not None else "")
          + (f" adaptive=on (tol={cfg.converge_tol:g}, "
             f"iters {args.min_iters}..{args.iters})"
             if args.adaptive else ""), flush=True)

    try:
        while not service.stopped.wait(1.0):
            pass
    except KeyboardInterrupt:
        # second signal: best-effort fast drain, then leave
        service.drain_and_stop(timeout=5.0)
    sched = service.scheduler.stats
    print(f"[serve] stopped after {service.uptime_s():.1f}s — "
          f"{sched.completed} served, {sched.rejected} shed, "
          f"{sched.failed} failed; {engine.stats.summary()}", flush=True)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if bool(args.model) == bool(args.synthetic_init):
        raise SystemExit("serve: exactly one of --model or "
                         "--synthetic_init is required")
    _check_args(args)
    if args.workers < 1:
        raise SystemExit(f"serve: --workers must be >= 1, got "
                         f"{args.workers}")
    if args.workers > 1:
        if args.session_ttl_s > 0:
            print("[serve] WARNING: --workers > 1 has NO session "
                  "affinity (SO_REUSEPORT accept-balancing is blind); "
                  "sessions are forced OFF in the pool.", flush=True)
        _run_pool(args, argv)
    else:
        _serve_one(args)


if __name__ == "__main__":
    main(sys.argv[1:])
