"""Persistent flow service: the HTTP tier over engine + scheduler +
sessions.

Counterpart of ``dexiraft_tpu/serve/server.py``: the same endpoints, wire
format, status codes and drain. Where the port differs:

  * the session carry's splat (``carry_fn``, eval.interpolate's
    forward_interpolate on the flow's device) runs in the scheduler's
    ``post_dispatch`` hook, on the dispatcher thread, for every result
    of a request that named a session: device work stays on the one
    thread that dispatches pair batches, and the carry is stored before
    the response goes out;
  * ``/healthz`` also reports the device the step runs on (``device``),
    and /stats' service block the device memory the process holds
    (``device_memory_reserved_bytes``) and the corr kernels' launches in
    this process (``kernel_launches``, ops/corr_kernels.LAUNCHES: a
    replica's own count of the kernels its forwards ran; serve_cli zeroes
    it after the warm-up, and ``?reset=1`` leaves it);
  * ``/stats``: the engine block says ``search_s`` / ``searches`` /
    ``searched`` for the JAX ``compile_s`` / ``compiles`` / ``compiled``
    (the first dispatch of a signature runs cuDNN's search, not an XLA
    compile), and the ``locks`` block has no ``cycles`` (serve/locks.py).

The JAX module's description follows.

Pure stdlib (`http.server.ThreadingHTTPServer`) — the repo adds no
dependency to become a service. One process hosts:

  handler threads  -> Scheduler (SLO-aware same-bucket batching)
                      -> ONE dispatcher thread -> InferenceEngine
  SessionStore     -> per-stream flow_init warm-start across requests

Endpoints:

  POST /v1/flow     body = .npz with float arrays ``image1``/``image2``
                    (H, W, 3); optional ``X-Session-Id`` header opts the
                    request into warm-start carry. Response: .npz with
                    ``flow_up`` (H, W, 2) float32; ``X-Warm-Start`` and
                    ``X-Bucket`` headers describe what served it.
                    400 malformed, 503 queue-full/draining, 504 SLO-
                    timeout, 500 engine error.
  POST /v1/flow/stream
                    body = .npz with ``frames`` (T, H, W, 3) — one CHUNK
                    of a video stream through the split-encoder
                    streaming engine (serve/video.py): each frame is
                    encoded ONCE, the previous frame's features + flow
                    seed ride the device-resident session carry keyed by
                    ``X-Session-Id``. Response: .npz ``flows``
                    (N, H, W, 2) with N = T warm / T-1 cold
                    (X-Frames-In / X-Flows-Out headers spell it out).
                    404 when streaming is disabled on the replica.
  GET  /healthz     JSON READINESS; 200 while serving, 503 once
                    draining (load balancers stop routing before the
                    exit). The payload always carries {draining,
                    inflight, sessions}: a router can tell "dying"
                    (drain in progress, inflight counting down) from
                    "busy" and can poll inflight to 0 for a zero-drop
                    drain.
  GET  /livez       JSON LIVENESS; 200 as long as the process answers
                    — stays 200 through a drain. Restart on /livez,
                    route on /healthz.
  GET  /stats       JSON {service, engine, scheduler, sessions} —
                    ServeStats/SchedulerStats/SessionStore records.
                    ``?reset=1`` zeroes the counters after the scrape
                    (engine.reset_stats + SchedulerStats.reset): each
                    scrape window reports ITS traffic, not history.

Graceful shutdown (the preemption discipline, service-shaped):
the first SIGTERM/SIGINT stops admissions (503), lets the scheduler
drain every queued request, joins the handler threads so every response
is flushed, then exits; a second signal aborts immediately. In-flight
work is never dropped — the closed-loop bench and the service test pin
this.

The npz wire format is deliberate: frames are arrays, JSON-of-lists is
~10x the bytes and the decode dominates small-image latency; npz is the
one container numpy reads/writes with zero new deps
(``allow_pickle=False`` — no code execution surface).
"""

from __future__ import annotations

import io
import json
import signal
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from dexiraft_tpu_torch.ops import corr_kernels
from dexiraft_tpu_torch.serve import locks
from dexiraft_tpu_torch.serve.buckets import bucket_shape
from dexiraft_tpu_torch.serve.engine import InferenceEngine
from dexiraft_tpu_torch.serve.httputil import QuietDisconnectsMixin
from dexiraft_tpu_torch.serve.locks import OrderedLock
from dexiraft_tpu_torch.serve.scheduler import (QueueFull, Scheduler,
                                                SchedulerClosed)
from dexiraft_tpu_torch.serve.sessions import SessionStore
from dexiraft_tpu_torch.serve.video import StreamOverloaded

# ---- wire format (shared by server, bench client, tests) ----------------


def encode_request(image1, image2) -> bytes:
    """Client side: one frame pair -> the POST /v1/flow body."""
    buf = io.BytesIO()
    np.savez(buf, image1=np.asarray(image1), image2=np.asarray(image2))
    return buf.getvalue()


def decode_request(body: bytes) -> Dict[str, Any]:
    """Server side: POST body -> engine item dict. ValueError on any
    malformed payload (the handler's 400 path)."""
    try:
        z = np.load(io.BytesIO(body), allow_pickle=False)
        arrays = {k: z[k] for k in z.files}
    except Exception as e:
        raise ValueError(f"body is not a readable .npz archive: {e}")
    for key in ("image1", "image2"):
        if key not in arrays:
            raise ValueError(f"npz body missing required array {key!r} "
                             f"(got {sorted(arrays)})")
    return {"image1": arrays["image1"], "image2": arrays["image2"]}


def encode_response(flow_up: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, flow_up=np.asarray(flow_up, np.float32))
    return buf.getvalue()


def decode_response(body: bytes) -> np.ndarray:
    """Client side: response body -> (H, W, 2) float32 flow."""
    z = np.load(io.BytesIO(body), allow_pickle=False)
    return z["flow_up"]


# ---- streaming wire format (POST /v1/flow/stream) -----------------------


def encode_stream_request(frames) -> bytes:
    """Client side: one CHUNK of a video stream -> the POST
    /v1/flow/stream body. ``frames`` is (T, H, W, 3) [0, 255] — T
    same-geometry frames; the carry across chunks rides the
    ``X-Session-Id`` header, so a client streams arbitrary-length video
    as a sequence of bounded chunks."""
    buf = io.BytesIO()
    np.savez(buf, frames=np.asarray(frames, np.float32))
    return buf.getvalue()


def decode_stream_request(body: bytes) -> np.ndarray:
    """Server side: POST body -> (T, H, W, 3) frames array. ValueError
    on any malformed payload (the handler's 400 path); shape/dtype
    validation is VideoEngine.validate_frames' job."""
    try:
        z = np.load(io.BytesIO(body), allow_pickle=False)
        arrays = {k: z[k] for k in z.files}
    except Exception as e:
        raise ValueError(f"body is not a readable .npz archive: {e}")
    if "frames" not in arrays:
        raise ValueError(f"npz body missing required array 'frames' "
                         f"(got {sorted(arrays)})")
    return arrays["frames"]


def encode_stream_response(flows) -> bytes:
    """(N, H, W, 2) stacked flows (N may be T or T-1 — a cold chunk has
    no carry pair for its first frame; N=0 for a cold single-frame
    chunk that only primed the carry)."""
    buf = io.BytesIO()
    if len(flows):
        arr = np.stack([np.asarray(f, np.float32) for f in flows])
    else:
        arr = np.zeros((0,), np.float32)
    np.savez(buf, flows=arr)
    return buf.getvalue()


def decode_stream_response(body: bytes) -> np.ndarray:
    """Client side: response body -> (N, H, W, 2) float32 flows."""
    z = np.load(io.BytesIO(body), allow_pickle=False)
    return z["flows"]


# ---- HTTP plumbing ------------------------------------------------------


class _FlowHTTPServer(QuietDisconnectsMixin, ThreadingHTTPServer):
    """ThreadingHTTPServer that (a) carries the FlowService reference,
    (b) JOINS handler threads on close — the drain path's guarantee that
    every admitted response is flushed before exit — and (c) optionally
    binds with SO_REUSEPORT so ``--workers N`` processes share one port
    (the kernel load-balances accepts across workers)."""

    daemon_threads = False      # joined at server_close(), not abandoned
    block_on_close = True

    def __init__(self, addr, handler, service: "FlowService",
                 reuse_port: bool = False):
        self.service = service
        self._reuse_port = reuse_port
        super().__init__(addr, handler)

    def server_bind(self):
        if self._reuse_port:
            if not hasattr(socket, "SO_REUSEPORT"):
                raise OSError("SO_REUSEPORT unavailable on this platform "
                              "— multi-worker mode needs it")
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


class _Handler(BaseHTTPRequestHandler):
    server_version = "dexiraft-serve/1.0"
    # keep-alive: closed-loop clients reuse one connection per thread
    protocol_version = "HTTP/1.1"
    # an IDLE keep-alive connection must not pin its handler thread
    # forever: drain joins handler threads (block_on_close), so a
    # client that holds a connection open without sending would
    # otherwise stall shutdown until it went away
    timeout = 30.0

    # ---- helpers -------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet: /stats carries the signal
        pass

    def _send(self, status: int, body: bytes, content_type: str,
              headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload: dict,
                   headers: Optional[Dict[str, str]] = None) -> None:
        self._send(status, json.dumps(payload).encode(),
                   "application/json", headers)

    def _send_error_json(self, status: int, message: str,
                         retry: bool = False) -> None:
        self._send_json(status, {"error": message},
                        {"Retry-After": "1"} if retry else None)

    # ---- GET: health + stats -------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        svc = self.server.service
        url = urlparse(self.path)
        if url.path == "/livez":
            # liveness: 200 as long as the process answers — a DRAINING
            # replica is alive (finishing admitted work), only a dead
            # one fails this. Routers restart on /livez, route on
            # /healthz.
            self._send_json(200, {"status": "alive"})
        elif url.path == "/healthz":
            # readiness: 503 once draining (load balancers stop routing
            # before the exit), but the payload always reports the full
            # {draining, inflight, sessions} picture so a router can
            # tell "dying" (drain + inflight counting down) from "busy"
            # (ready with a deep queue) instead of a bare status flip.
            payload = svc.health_record()
            self._send_json(503 if payload["draining"] else 200, payload)
        elif url.path == "/stats":
            reset = parse_qs(url.query).get("reset", ["0"])[0] == "1"
            payload = (svc.snapshot_and_reset() if reset
                       else svc.stats_record())
            self._send_json(200, payload)
        else:
            self._send_error_json(404, f"no such endpoint {url.path!r}")

    # ---- POST: inference -----------------------------------------------

    def _read_body(self) -> Optional[bytes]:
        """Read the request body on EVERY path (including the ones that
        answer 4xx): an unread body on a keep-alive connection would be
        parsed as the next request line, desyncing every later request
        on that connection. None (and close_connection) on a body we
        cannot frame (chunked, bad Content-Length)."""
        te = self.headers.get("Transfer-Encoding", "")
        if te and te.lower() != "identity":
            self.close_connection = True
            return None
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length < 0:
                raise ValueError(length)
        except ValueError:
            self.close_connection = True
            return None
        return self.rfile.read(length) if length > 0 else b""

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        svc = self.server.service
        body = self._read_body()
        if body is None:
            self._send_error_json(
                400, "unsupported Transfer-Encoding or bad Content-Length")
            return
        path = urlparse(self.path).path
        if path == "/v1/flow/stream":
            self._post_stream(svc, body)
            return
        if path != "/v1/flow":
            self._send_error_json(404, f"no such endpoint {self.path!r}")
            return
        try:
            item = decode_request(body)
            # reject malformed input at the door (400) instead of
            # poisoning a whole scheduler batch deep in the engine (500)
            svc.engine.validate_item(item)
        except ValueError as e:
            self._send_error_json(400, str(e))
            return

        cfg = svc.engine.config
        h, w = item["image1"].shape[:2]
        bucket = bucket_shape(h, w, cfg.stride, cfg.bucket_multiple)
        session_id = self.headers.get("X-Session-Id")
        warm = False
        if session_id and svc.sessions is not None:
            # the dispatcher stores this request's carry (_post_dispatch)
            item["session_id"] = session_id
            init = svc.sessions.get(session_id, bucket)
            if init is not None:
                item["flow_init"] = init
                warm = True

        try:
            result = svc.scheduler.submit(item, timeout=svc.request_timeout_s)
        except QueueFull as e:
            self._send_error_json(503, f"overloaded: {e}", retry=True)
            return
        except SchedulerClosed:
            self._send_error_json(503, "draining: service is shutting down")
            return
        except TimeoutError as e:
            self._send_error_json(504, str(e))
            return
        except Exception as e:  # engine error, re-raised by submit()
            self._send_error_json(
                500, f"inference failed: {type(e).__name__}: {e}")
            return

        headers = {"X-Warm-Start": "1" if warm else "0",
                   "X-Bucket": f"{bucket[0]}x{bucket[1]}"}
        if result.iters_used is not None:
            # adaptive engines only: how many refinement iterations THIS
            # item actually ran before its convergence gate (or the
            # scheduler's SLO budget) stopped it, and the last pre-stop
            # flow-delta norm — per-request convergence evidence on the
            # wire, no extra body bytes
            headers["X-Iters-Used"] = str(result.iters_used)
            headers["X-Final-Delta"] = f"{result.final_delta:.6f}"
        self._send(200, encode_response(result.flow_up),
                   "application/x-npz", headers)

    def _post_stream(self, svc: "FlowService", body: bytes) -> None:
        """POST /v1/flow/stream: one chunk of a video stream through the
        split-encoder VideoEngine. The response's ``flows`` array may be
        one SHORTER than the chunk (cold start has no carry pair for the
        first frame) — X-Frames-In / X-Flows-Out spell it out."""
        if svc.video is None:
            self._send_error_json(
                404, "streaming is not enabled on this replica (start "
                     "serve with sessions on and --stream_sessions_mb "
                     "> 0; docs/serving.md \"Streaming\")")
            return
        if svc.draining:
            self._send_error_json(503, "draining: service is shutting "
                                       "down")
            return
        try:
            frames = decode_stream_request(body)
            frames = svc.video.validate_frames(frames)
        except ValueError as e:
            self._send_error_json(400, str(e))
            return
        session_id = self.headers.get("X-Session-Id")
        try:
            res = svc.video.process_chunk(session_id, frames)
        except Exception as e:
            if isinstance(e, StreamOverloaded):
                # bounded admission, scheduler.QueueFull discipline:
                # shed with a retry signal instead of pinning handler
                # threads behind one in-flight chunk
                self._send_error_json(503, str(e), retry=True)
                return
            self._send_error_json(
                500, f"streaming inference failed: "
                     f"{type(e).__name__}: {e}")
            return
        headers = {"X-Warm-Start": "1" if res.warm else "0",
                   "X-Bucket": f"{res.bucket[0]}x{res.bucket[1]}",
                   "X-Frames-In": str(res.frames_in),
                   "X-Flows-Out": str(len(res.flows))}
        if getattr(res, "iters_used", None) is not None:
            # adaptive streaming: mean refinement iterations across this
            # chunk's frame pairs (per-pair detail is in /stats)
            headers["X-Iters-Used"] = f"{res.iters_used:.1f}"
        self._send(200, encode_stream_response(res.flows),
                   "application/x-npz", headers)


# ---- the service object -------------------------------------------------


class FlowService:
    """Engine + scheduler + sessions behind one persistent HTTP endpoint.

    Lifecycle: ``start()`` launches the dispatcher and the HTTP thread;
    ``drain_and_stop()`` (or the installed SIGTERM handler) refuses new
    work, finishes everything admitted, flushes responses, and sets
    ``stopped``. ``port=0`` binds an ephemeral port (tests/bench);
    ``reuse_port=True`` lets N worker processes share one port.
    """

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        slo_ms: float = 200.0,
        max_queue: int = 64,
        adaptive: Optional[bool] = None,
        max_iters: int = 32,
        min_iters: int = 4,
        session_ttl_s: float = 60.0,
        max_sessions: int = 1024,
        carry_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        request_timeout_s: float = 60.0,
        reuse_port: bool = False,
        video=None,
        clock=None,
    ):
        if clock is None:
            import time

            clock = time.monotonic
        self.engine = engine
        # optional streaming tier (serve.video.VideoEngine): owns its
        # own device-carry session store and serialization; None keeps
        # /v1/flow/stream answering 404 with a how-to-enable message
        self.video = video
        self.clock = clock
        # adaptive defaults to the engine's mode: an adaptive engine
        # behind the service gets SLO-driven iteration budgets unless
        # the caller explicitly opts the scheduler out (adaptive=False
        # keeps budgets at the full iters; convergence exits still fire)
        if adaptive is None:
            adaptive = engine.config.adaptive
        self.scheduler = Scheduler(engine, slo_ms=slo_ms,
                                   max_queue=max_queue, adaptive=adaptive,
                                   max_iters=max_iters, min_iters=min_iters,
                                   clock=clock)
        # session_ttl_s <= 0 = stateless mode (multi-worker default:
        # kernel accept-balancing breaks per-worker affinity anyway)
        self.sessions = (SessionStore(session_ttl_s, max_sessions,
                                      clock=clock)
                         if session_ttl_s > 0 else None)
        self.carry_fn = carry_fn if carry_fn is not None else (lambda x: x)
        self.scheduler.post_dispatch = self._post_dispatch
        self.request_timeout_s = request_timeout_s
        self._httpd = _FlowHTTPServer((host, port), _Handler, service=self,
                                      reuse_port=reuse_port)
        self._http_thread: Optional[threading.Thread] = None
        self._t0 = clock()
        self._signal_latched = False
        # ranked ABOVE the scheduler cv in LOCK_ORDER: drain_and_stop
        # holds it across scheduler.drain()/close(), which take the cv
        self._stop_lock = OrderedLock("serve.server.stop")
        self.stopped = threading.Event()

    # ---- introspection -------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return host, port

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    @property
    def draining(self) -> bool:
        return self.scheduler.draining

    def uptime_s(self) -> float:
        return self.clock() - self._t0

    def health_record(self) -> dict:
        """The /healthz readiness payload: liveness is implied by
        answering at all; readiness is `not draining`; `inflight`
        (admitted-but-unanswered, queued AND mid-batch) is what a
        router's zero-drop drain polls down to 0; `sessions` says how
        much warm state dies with this replica."""
        return {
            "status": "draining" if self.draining else "ok",
            "draining": self.draining,
            # streaming chunks bypass the scheduler, so they count here
            # explicitly — a drain that polled scheduler inflight alone
            # would restart a replica over a live stream
            "inflight": self.scheduler.inflight()
            + (self.video.inflight() if self.video is not None else 0),
            "sessions": len(self.sessions) if self.sessions is not None
            else 0,
            "device": (None if self.engine.device is None
                       else str(self.engine.device)),
            "uptime_s": round(self.uptime_s(), 3),
            "queue_depth": self.scheduler.queue_depth(),
        }

    def stats_record(self) -> dict:
        # the engine's batches before the launches: a forward counts its
        # launches as it enqueues them and its batch after, so the pair
        # read in this order never shows a batch without its launches
        engine = self.engine.stats_record()
        return {
            "service": {
                "uptime_s": round(self.uptime_s(), 3),
                "draining": self.draining,
                "slo_ms": round(self.scheduler.slo_s * 1e3, 2),
                "sessions_enabled": self.sessions is not None,
                # the engine/scheduler blocks carry the adaptive detail
                # (iters_used percentiles, budget policy state); this
                # flag is the one-glance "is this replica adaptive"
                "adaptive": self.engine.config.adaptive,
                # the caching allocator's hold on the card (None off it):
                # each --workers child holds its own
                "device_memory_reserved_bytes": self._device_memory(),
                "kernel_launches": dict(corr_kernels.LAUNCHES),
            },
            "engine": engine,
            "scheduler": self.scheduler.stats_record(),
            "sessions": (self.sessions.stats_record()
                         if self.sessions is not None else None),
            "video": (self.video.stats_record()
                      if self.video is not None else None),
            # the lock-order runtime's verdict block (serve/locks.py):
            # order violations must read 0 on a healthy replica;
            # contention + max-held-ms surface the lock hot spots a
            # latency investigation needs
            "locks": locks.stats_record(),
        }

    def _device_memory(self):
        dev = self.engine.device
        if dev is None or dev.type != "cuda":
            return None
        return int(torch.cuda.memory_reserved(dev))

    def _post_dispatch(self, bucket, results) -> None:
        """Dispatcher-thread hook (scheduler.post_dispatch), run before
        the requests' events fire: frame j's carry seeds frame j+1 of the
        same stream, so each result of a request that named a session
        stores carry_fn(flow_low) (the splat; identity, the raw flow_low,
        when serve_cli wires none) under its id."""
        if self.sessions is None:
            return
        for r in results:
            session_id = r.item.get("session_id")
            if session_id:
                self.sessions.put(session_id, bucket,
                                  self.carry_fn(r.flow_low))

    def _zero_stats(self) -> None:
        # quiesced-context only (dispatcher provably outside the engine):
        # zeroing engine.compile_s mid-batch would race the dispatch's
        # accumulation and fold a compile span into the bucket's EWMA
        # service estimate
        self.engine.reset_stats()
        self.scheduler.stats.reset()
        if self.sessions is not None:
            self.sessions.reset_counters()
        if self.video is not None:
            self.video.reset_stats()

    def reset_stats(self) -> None:
        """One measurement-window handoff across every layer: engine
        counters+latency window, scheduler counters, session flow
        counters. Searched signatures, learned service-time estimates,
        and live session carries all survive — they are state, not
        statistics."""
        self.scheduler.run_quiesced(self._zero_stats)

    def snapshot_and_reset(self) -> dict:
        """The /stats?reset=1 path: capture the window's record and zero
        the counters as ONE quiesced operation. Snapshotting first and
        resetting after the response went out would lose every request
        completing in the gap — zeroed without ever being reported in
        either window."""
        record: dict = {}

        def _snapshot_reset():
            record.update(self.stats_record())
            self._zero_stats()

        self.scheduler.run_quiesced(_snapshot_reset)
        return record

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> "FlowService":
        self.scheduler.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="flow-http", daemon=True)
        self._http_thread.start()
        return self

    def drain_and_stop(self, timeout: Optional[float] = 30.0) -> bool:
        """Refuse new work, finish everything admitted, flush responses,
        stop. Returns True when the queue drained inside `timeout`.
        Idempotent — the signal path and an explicit caller can race;
        the loser of the race just waits for `stopped`."""
        if not self._stop_lock.acquire(blocking=False):
            self.stopped.wait(timeout)
            return not self.scheduler.queue_depth()
        try:
            drained = self.scheduler.drain(timeout)
            # handler threads blocked in submit() have their results;
            # closing the listener now joins them (block_on_close) so
            # every response hits the wire before we report stopped
            if self._http_thread is not None:
                self._httpd.shutdown()
            self._httpd.server_close()
            self.scheduler.close()
            self.stopped.set()
            return drained
        finally:
            self._stop_lock.release()

    # ---- signals (preemption discipline) -------------------------------

    def install_signal_handlers(self) -> bool:
        """First SIGTERM/SIGINT -> background graceful drain; second ->
        immediate KeyboardInterrupt (a wedged drain must not trap the
        operator). Returns False off the main thread (signals can only
        install there — library embedders keep their own handling)."""

        def _handle(signum, frame):
            if self._signal_latched:
                raise KeyboardInterrupt(
                    f"second signal {signum} during drain")
            self._signal_latched = True
            print(f"[serve] received signal {signum}; draining "
                  f"{self.scheduler.queue_depth()} queued request(s), "
                  f"refusing new work (signal again to abort)", flush=True)
            threading.Thread(target=self.drain_and_stop,
                             name="flow-drain", daemon=True).start()

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                signal.signal(s, _handle)
        except ValueError:
            return False
        return True
