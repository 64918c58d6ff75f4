"""Bucketed, batched, pipelined inference engine over the test-mode step.

Counterpart of ``dexiraft_tpu/serve/engine.py``:

  * shape buckets (serve.buckets): each frame pair is padded
    (replicate-edge, data.padder) to its bucket shape;
  * micro-batching: same-bucket pairs are grouped into batches of
    ``ServeConfig.batch_size``; a bucket's tail batch is filled up by
    repeating its last item, and the filler results are dropped;
  * in-flight dispatch: the eval step only enqueues device work, so up to
    ``ServeConfig.inflight`` dispatched batches are held before the host
    blocks on the oldest. On a CUDA device the engine pads each batch
    straight into pinned staging buffers (one per batch in flight and
    bucket), so the step's ``non_blocking`` upload is a real asynchronous
    copy and not one that waits behind the previous batch's forward; a
    CUDA event recorded after each dispatch is what its fetch waits on.
    ServeStats (profiling.py) keeps the accounts: ``dispatch_s`` the
    host's pad and enqueue, ``fetch_s`` the device time the window did not
    hide;
  * device carry (``ServeConfig.device_carry``): a per-item flow_init may
    be a device tensor (the session store's splatted carry); the batch's
    flow_init is stacked on the device from cached zero rows, and each
    Result's flow_low stays a device row. flow_up, the response, is
    fetched. The carry then moves no host<->device bytes
    (``carry_h2d_bytes`` / ``carry_d2h_bytes`` count the ones it does
    move on the host path).

The first dispatch of a (bucket, warm-start) signature is where cuDNN
times its algorithms for the batch's conv shapes (train/step.py
``eval_arithmetic``); its eval_fn time goes to ``compile_s``, the
attribute the scheduler subtracts from its service-time estimate, and
not to ``dispatch_s``.

eval_fn contract (train.step.make_eval_step): eval_fn(image1, image2,
flow_init) -> (flow_low, flow_up), batched NHWC in [0, 255] (numpy
arrays, or pinned CPU tensors on a CUDA engine), flow_init None or (B,
H/8, W/8, 2); outputs NHWC tensors or arrays. A flow_init row of zeros is
the same as no warm start, so one batch can mix warm and cold items. Like
the JAX engine, it passes no edge images, so v2/v3 (data-supplied edges)
are driven through the eval step directly.

Adaptive engines (``ServeConfig.adaptive``): the eval_fn takes a trailing
``iter_budget`` (None = the step's full iterations) and returns
(flow_low, flow_up, iters_used (B,), final_delta (B,))
(make_eval_step(adaptive=True)); each Result carries its row's two
values and the stats keep them as samples. A fixed engine refuses a
budget. The adaptive loop reads its done mask on the host every
iteration, so its eval_fn returns only when the batch is nearly done:
the in-flight window hides nothing there.

Recompile guard (analysis.guards): the engine holds ``watch``, a
RecompileWatch shared with the streaming engine where there is one. A
fresh (bucket, warm-start) signature's dispatch runs inside
``watch.sanctioned()`` and marks the watch warm after it (its cuDNN search
is expected); a dispatch on a searched signature that still compiled is
drift: ``ServeConfig(strict=True)`` raises RecompileBudgetExceeded, the
default warns once. Fetches go through ``guards.fetch`` and host carry
rows up through ``guards.put``, so a dispatch runs clean under
``guards.strict_mode``'s sync half.

Data-parallel serving (``mesh=``, a ``parallel.layout.ServeMesh``; the
JAX engine's mesh): the eval_fn is a mesh step
(``make_eval_step(mesh=)``). Each dispatch pads into one staging buffer
(pinned on a CUDA mesh), ``parallel.layout.batch_putter`` copies each
entry's block of rows to its device, and one CUDA event per entry is
recorded on its device's current stream; the fetch waits on each and
fetches the blocks in row order. ``batch_size`` must divide by the mesh
size, and the carry goes through the host (``device_carry`` is refused,
as JAX's serve CLI forces host carry on a mesh).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from dexiraft_tpu_torch.analysis import guards
from dexiraft_tpu_torch.data.padder import InputPadder
from dexiraft_tpu_torch.profiling import ServeStats
from dexiraft_tpu_torch.serve.buckets import BucketRegistry

EvalFn = Callable[..., Tuple[Any, Any]]

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 1
    mode: str = "sintel"         # pad placement (data.padder modes)
    stride: int = 8
    # bucket quantization granule; None -> stride (reference pad shapes)
    bucket_multiple: Optional[int] = None
    # dispatched-unfetched batches held before blocking on a fetch
    inflight: int = 2
    # always pass a flow_init (zeros for cold items)
    warm_start: bool = False
    # a compile (cuDNN search, kernel build) on an already-searched
    # signature raises RecompileBudgetExceeded instead of the default
    # one-line drift warning (analysis.guards)
    strict: bool = False
    # flow_init rows may be device tensors and Result.flow_low stays on
    # the device (module docstring)
    device_carry: bool = False
    # the eval_fn is adaptive: dispatches thread an iter_budget and
    # Results carry iters_used / final_delta
    adaptive: bool = False

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {self.inflight}")

    @classmethod
    def from_args(cls, args, *, mode: str = "sintel",
                  warm_start: bool = False,
                  device_carry: bool = False,
                  adaptive: Optional[bool] = None) -> "ServeConfig":
        """Build from an argparse namespace that went through
        :func:`add_engine_args`."""
        return cls(
            batch_size=args.batch_size,
            mode=mode,
            bucket_multiple=args.bucket_multiple,
            inflight=args.inflight,
            warm_start=warm_start,
            strict=getattr(args, "strict", False),
            device_carry=device_carry,
            adaptive=(getattr(args, "adaptive", False)
                      if adaptive is None else adaptive),
        )


def add_engine_args(p, *, batch_size: int = 1,
                    bucket_multiple: Optional[int] = None) -> None:
    """The engine knobs of a CLI (see ServeConfig.from_args), with the
    caller's defaults."""
    p.add_argument("--batch_size", type=int, default=batch_size,
                   help="frame pairs per forward: 1 = the reference "
                        "per-image loop; >1 batches same-bucket pairs "
                        f"(default: {batch_size})")
    p.add_argument("--inflight", type=int, default=2,
                   help="dispatched-unfetched batches the engine holds "
                        "before blocking on a fetch (default: 2)")
    p.add_argument("--bucket_multiple", type=int, default=bucket_multiple,
                   help="quantize pad shapes up to multiples of this "
                        "(bounds the conv shapes cuDNN searches across "
                        "mixed geometries); default: "
                        + (f"{bucket_multiple}" if bucket_multiple
                           else "stride 8, the exact reference pad "
                                "shapes"))


class Result(NamedTuple):
    """One frame pair's output: flow_up unpadded to the item's (H, W, 2);
    flow_low at the bucket's padded 1/8 resolution (the warm-start carry;
    a device row on a device-carry engine). iters_used / final_delta: the
    adaptive path's refinement updates applied and last 1/8-res
    flow-delta norm; None on fixed engines."""

    index: int
    item: Dict[str, Any]
    flow_low: Any
    flow_up: np.ndarray
    iters_used: Optional[int] = None
    final_delta: Optional[float] = None


class _Ticket(NamedTuple):
    flow_low: Any             # (B, bh/8, bw/8, 2), device or host
    flow_up: Any              # (B, bh, bw, 2)
    entries: List[Tuple[int, Dict[str, Any], InputPadder]]
    t_dispatch: float
    iters_used: Any = None    # adaptive: (B,)
    final_delta: Any = None   # adaptive: (B,)
    events: Any = ()          # CUDA events recorded after the dispatch
    staging: Any = None       # (key, pinned buffer) back to the pool


class InferenceEngine:
    """Bucketed, batched, pipelined driver of a test-mode forward step.

    ``device``: where the step runs. None (numpy stubs) or the CPU pass
    host arrays; a CUDA device gets pinned staging and per-dispatch
    events. ``mesh``: a serve mesh instead of ``device`` (module
    docstring); ``device`` then reads its first entry. Not thread-safe:
    one thread dispatches (the scheduler's)."""

    def __init__(self, eval_fn: EvalFn, config: ServeConfig = ServeConfig(),
                 *, mesh=None,
                 device: Optional[Union[str, torch.device]] = None):
        # (parallel.layout imports the data loader, which imports this
        # package's locks)
        from dexiraft_tpu_torch.parallel.layout import (batch_putter,
                                                        check_serve_mesh)

        self.mesh = None if mesh is None else check_serve_mesh(mesh)
        self.put = batch_putter(self.mesh)
        if mesh is not None:
            if device is not None:
                raise ValueError("pass mesh= or device=, not both: a mesh "
                                 "names its devices")
            if config.batch_size % mesh.size:
                raise ValueError(
                    f"batch_size {config.batch_size} not divisible by the "
                    f"mesh's {mesh.size} devices — every device needs a "
                    "full shard of each dispatched batch")
            if config.device_carry:
                raise ValueError("device_carry is off on a mesh: the carry "
                                 "goes through the host")
            device = mesh.devices[0]
        self.eval_fn = eval_fn
        self.config = config
        self.device = None if device is None else torch.device(device)
        self.registry = BucketRegistry(config.stride, config.bucket_multiple)
        self.stats = ServeStats()
        # seconds inside first-dispatch eval_fn calls (cuDNN's search)
        self.compile_s = 0.0
        self._inflight: "collections.deque[_Ticket]" = collections.deque()
        self._zero_rows: Dict[Tuple[int, ...], torch.Tensor] = {}
        # pinned staging buffers by batch shape, free ones only
        self._pinned: Dict[Tuple[int, ...], List[torch.Tensor]] = {}
        # recompile drift sentinel: a fresh signature is an expected
        # search; a search on a searched signature is drift
        self.watch = guards.RecompileWatch("serve")

    @property
    def _cuda(self) -> bool:
        if self.mesh is not None:
            return self.mesh.is_cuda
        return self.device is not None and self.device.type == "cuda"

    def _devices(self):
        return (self.mesh.devices if self.mesh is not None
                else (self.device,))

    # ---- input validation ----------------------------------------------

    def validate_item(self, item: Dict[str, Any]) -> None:
        """Single-item validation for the HTTP server: a malformed request
        is a 400 at the door, not a 500 for its whole batch."""
        self._validate_item(0, item)

    def _validate_item(self, index: int, item: Dict[str, Any]) -> None:
        """Reject malformed frames with a clear ValueError; the normalized
        arrays are written back into ``item``. A tensor flow_init (the
        device carry) passes untouched: converting it would be the host
        round trip the device carry exists to avoid."""
        shapes = {}
        for key in ("image1", "image2"):
            im = item.get(key)
            if im is None:
                raise ValueError(f"item {index}: missing {key!r}")
            im = item[key] = np.asarray(im)
            if im.ndim != 3 or im.shape[-1] != 3:
                raise ValueError(f"item {index}: {key!r} must be (H, W, 3), "
                                 f"got shape {im.shape}")
            if not (np.issubdtype(im.dtype, np.floating)
                    or np.issubdtype(im.dtype, np.integer)):
                raise ValueError(f"item {index}: {key!r} dtype {im.dtype} "
                                 "is not a real numeric type")
            shapes[key] = im.shape
        if shapes["image1"] != shapes["image2"]:
            raise ValueError(f"item {index}: image1 {shapes['image1']} and "
                             f"image2 {shapes['image2']} must agree")
        fi = item.get("flow_init")
        if fi is not None:
            if not isinstance(fi, torch.Tensor):
                fi = item["flow_init"] = np.asarray(fi, np.float32)
            if fi.ndim != 3 or fi.shape[-1] != 2:
                raise ValueError(f"item {index}: flow_init must be "
                                 f"(H/{self.config.stride}, W/"
                                 f"{self.config.stride}, 2), got "
                                 f"{tuple(fi.shape)}")

    # ---- dispatch side -------------------------------------------------

    def _staging(self, shape: Tuple[int, ...]):
        """(key, buffer) for a (2, B, H, W, 3) float32 batch of both
        frames: pinned CPU memory on a CUDA engine, reused once the
        ticket that held it is fetched; a fresh numpy array otherwise."""
        if not self._cuda:
            return None, np.empty(shape, np.float32)
        pool = self._pinned.setdefault(shape, [])
        buf = pool.pop() if pool else torch.empty(
            shape, dtype=torch.float32, pin_memory=True)
        return (shape, buf), buf

    def _dispatch(self, bucket: Tuple[int, int],
                  group: List[Tuple[int, Dict[str, Any]]], mode: str,
                  iter_budget: Optional[int] = None) -> None:
        cfg = self.config
        if iter_budget is not None and not cfg.adaptive:
            raise ValueError(
                "iter_budget passed to a fixed-iteration engine — build "
                "it with ServeConfig(adaptive=True) and an adaptive "
                "eval_fn (make_eval_step(adaptive=True))")
        t0 = time.perf_counter()
        bh, bw = bucket
        padders = [InputPadder(it["image1"].shape, mode=mode,
                               stride=cfg.stride, target=bucket)
                   for _, it in group]
        staging, buf = self._staging((2, cfg.batch_size, bh, bw, 3))
        frames = buf.numpy() if isinstance(buf, torch.Tensor) else buf
        for row, (p, (_, it)) in enumerate(zip(padders, group)):
            frames[0, row] = p.pad(np.asarray(it["image1"], np.float32))[0]
            frames[1, row] = p.pad(np.asarray(it["image2"], np.float32))[0]
        fill = cfg.batch_size - len(group)
        if fill:  # tail: repeat the last item up to the batch shape
            frames[:, len(group):] = frames[:, len(group) - 1:len(group)]
            self.stats.pad_frames += fill

        inits = [it.get("flow_init") for _, it in group]
        will_fi = cfg.warm_start or any(x is not None for x in inits)
        fresh = self.registry.mark_searched((bucket, will_fi))
        # the expected search of a fresh signature rides one sanctioned
        # window: the watch is shared with the streaming engine, whose
        # check on another thread must not read it as drift
        win = (self.watch.sanctioned() if fresh
               else contextlib.nullcontext())
        iters_used = final_delta = None
        try:
            with win:
                fi = self._assemble_fi(bucket, inits) if will_fi else None
                t1 = time.perf_counter()
                im1, im2, fi = (self.put(x) for x in (buf[0], buf[1], fi))
                if cfg.adaptive:
                    flow_low, flow_up, iters_used, final_delta = \
                        self.eval_fn(im1, im2, fi, iter_budget)
                else:
                    flow_low, flow_up = self.eval_fn(im1, im2, fi)
        except BaseException:
            self._release(staging)
            raise
        events = []
        if self._cuda:  # one per device: this batch's work on each
            for dev in self._devices():
                events.append(torch.cuda.Event())
                events[-1].record(torch.cuda.current_stream(dev))
        t2 = time.perf_counter()
        if fresh:
            # cuDNN's search runs inside this first call: compile_s only
            self.compile_s += t2 - t1
            self.stats.dispatch_s += t1 - t0
            self.watch.mark_warm()
        else:
            self.stats.dispatch_s += t2 - t0
            # a searched signature that still compiled is drift
            if cfg.strict:
                self.watch.check()
            else:
                self.watch.warn_if_drifted()
        self.stats.batches += 1
        self._inflight.append(_Ticket(
            flow_low, flow_up,
            [(idx, it, p) for (idx, it), p in zip(group, padders)],
            t_dispatch=t0, iters_used=iters_used, final_delta=final_delta,
            events=tuple(events), staging=staging))
        self.stats.peak_inflight = max(self.stats.peak_inflight,
                                       len(self._inflight))

    def _assemble_fi(self, bucket: Tuple[int, int], inits: List[Any]):
        """The group's (batch_size, h/8, w/8, 2) flow_init.

        Host path (device_carry off): host zeros with the warm rows copied
        in, uploaded with the frames; the warm rows count as carry H2D
        bytes. Device path: rows stacked on the device over a cached zero
        row per shape; a host row (a client's own seed) is uploaded and
        counted, a device row is used as it is."""
        cfg = self.config
        bh, bw = bucket
        shape = (bh // cfg.stride, bw // cfg.stride, 2)
        if not cfg.device_carry:
            if any(isinstance(init, torch.Tensor) for init in inits):
                raise ValueError(
                    "a tensor flow_init reached an engine without "
                    "ServeConfig(device_carry=True); enable device_carry "
                    "or hand host numpy")
            fi = np.zeros((cfg.batch_size,) + shape, np.float32)
            for row, init in enumerate(inits):
                if init is not None:
                    fi[row] = init
                    self.stats.carry_h2d_bytes += fi[row].nbytes
            return fi
        dev = self.device or torch.device("cpu")
        zero = self._zero_rows.get(shape)
        if zero is None:
            zero = self._zero_rows[shape] = torch.zeros(shape, device=dev)
        rows = []
        for init in inits:
            if init is None:
                rows.append(zero)
            elif isinstance(init, torch.Tensor):
                rows.append(init.to(dev))
            else:
                self.stats.carry_h2d_bytes += init.nbytes
                rows.append(guards.put(np.asarray(init, np.float32), dev))
        rows += [zero] * (cfg.batch_size - len(rows))
        return torch.stack(rows)

    def _release(self, staging) -> None:
        if staging is not None:
            shape, buf = staging
            self._pinned[shape].append(buf)

    # ---- fetch side ----------------------------------------------------

    def _fetch_one(self) -> Iterator[Result]:
        from dexiraft_tpu_torch.parallel.layout import fetch_rows

        ticket = self._inflight.popleft()
        t0 = time.perf_counter()
        try:
            # this batch's work only, not whatever was queued after it:
            # one event per mesh entry (one on a single device)
            with guards.sync_window():
                for event in ticket.events:
                    event.synchronize()  # synclint: disable=SL002 the fetch's one wait, per device of the batch
            if self.config.device_carry and isinstance(ticket.flow_low,
                                                       torch.Tensor):
                low = ticket.flow_low      # the carry stays on the device
            else:
                low = fetch_rows(ticket.flow_low)
                if self.config.warm_start:
                    self.stats.carry_d2h_bytes += low.nbytes
            # the blocks of a mesh's outputs come back in row order
            up, iu, fd = (fetch_rows(x) for x in (
                ticket.flow_up, ticket.iters_used, ticket.final_delta))
        finally:
            self._release(ticket.staging)
        now = time.perf_counter()
        self.stats.fetch_s += now - t0
        self.stats.fetches += 1
        self.stats.batch_latency_s.append(now - ticket.t_dispatch)
        for row, (idx, item, padder) in enumerate(ticket.entries):
            self.stats.frames += 1
            if iu is None:
                yield Result(idx, item, low[row], padder.unpad(up[row]))
            else:
                self.stats.iters_used.append(int(iu[row]))
                self.stats.final_delta.append(float(fd[row]))
                yield Result(idx, item, low[row], padder.unpad(up[row]),
                             iters_used=int(iu[row]),
                             final_delta=float(fd[row]))

    def _drain_to(self, n: int) -> Iterator[Result]:
        while len(self._inflight) > n:
            yield from self._fetch_one()

    # ---- public API ----------------------------------------------------

    def stream(self, items: Iterable[Dict[str, Any]],
               mode: Optional[str] = None,
               iter_budget: Optional[int] = None) -> Iterator[Result]:
        """Run every item through the engine; yields Results as their
        batches complete (bucket-grouped, not input order: each Result
        carries its original index). ``iter_budget`` (adaptive engines
        only) caps every batch's refinement iterations."""
        mode = mode or self.config.mode
        cfg = self.config
        pending: Dict[Tuple[int, int], List[Tuple[int, Dict[str, Any]]]] = {}
        for index, item in enumerate(items):
            self._validate_item(index, item)
            h, w = item["image1"].shape[:2]
            bucket = self.registry.bucket_for(h, w)
            pending.setdefault(bucket, []).append((index, item))
            if len(pending[bucket]) == cfg.batch_size:
                # fetch down to a free slot before dispatching: at most
                # `inflight` tickets are ever outstanding
                yield from self._drain_to(cfg.inflight - 1)
                self._dispatch(bucket, pending.pop(bucket), mode,
                               iter_budget)
        for bucket in sorted(pending):  # partial tails, deterministic order
            yield from self._drain_to(cfg.inflight - 1)
            self._dispatch(bucket, pending.pop(bucket), mode, iter_budget)
        yield from self._drain_to(0)

    def run_batch(self, items: List[Dict[str, Any]],
                  mode: Optional[str] = None,
                  iter_budget: Optional[int] = None) -> List[Result]:
        """One batch of same-bucket items, dispatched and fetched, Results
        in input order; ``iter_budget`` as in :meth:`stream`."""
        if not items:
            return []
        if len(items) > self.config.batch_size:
            raise ValueError(f"{len(items)} items > batch_size "
                             f"{self.config.batch_size}")
        for index, item in enumerate(items):
            self._validate_item(index, item)
        buckets = {self.registry.bucket_for(*it["image1"].shape[:2])
                   for it in items}
        if len(buckets) > 1:
            raise ValueError(f"run_batch items span buckets {buckets}")
        if self._inflight:
            raise RuntimeError(
                f"run_batch with {len(self._inflight)} ticket(s) still in "
                "flight from a previous stream(); consume that iterator "
                "first (or use a separate engine)")
        self._dispatch(buckets.pop(), list(enumerate(items)),
                       mode or self.config.mode, iter_budget)
        return sorted(self._fetch_one(), key=lambda r: r.index)

    def reset_stats(self) -> None:
        """Zero the accounting for a new measurement window; the searched
        signatures survive (a warm bucket's next dispatch is no search)."""
        self.stats.reset()
        self.registry.hits.clear()
        self.compile_s = 0.0

    def stats_record(self) -> dict:
        """The engine's /stats block; the adaptive keys appear only on
        adaptive engines."""
        rec = {
            "batch_size": self.config.batch_size,
            "inflight": self.config.inflight,
            "frames": self.stats.frames,
            "batches": self.stats.batches,
            "pad_frames": self.stats.pad_frames,
            "peak_inflight": self.stats.peak_inflight,
            "fetch_blocked_ms": round(self.stats.fetch_s * 1e3, 2),
            "dispatch_ms": round(self.stats.dispatch_s * 1e3, 2),
            "search_s": round(self.compile_s, 2),
            "device_carry": self.config.device_carry,
            "carry_h2d_bytes": self.stats.carry_h2d_bytes,
            "carry_d2h_bytes": self.stats.carry_d2h_bytes,
            "latency_p50_ms": round(self.stats.latency_ms(50), 2),
            "latency_p99_ms": round(self.stats.latency_ms(99), 2),
            **self.registry.stats(),
        }
        if self.config.adaptive:
            rec.update(
                adaptive=True,
                iters_used_mean=round(self.stats.iters_used_mean(), 2),
                iters_used_p50=round(self.stats.iters_used_pctl(50), 2),
                iters_used_p99=round(self.stats.iters_used_pctl(99), 2),
                final_delta_p50=round(self.stats.final_delta_pctl(50), 5),
                final_delta_p99=round(self.stats.final_delta_pctl(99), 5),
            )
        return rec
