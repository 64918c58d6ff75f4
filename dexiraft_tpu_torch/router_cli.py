"""Fleet router CLI: one router process fronting N FlowService replicas.

Two modes:

  # front an EXISTING pool (replicas started any way you like)
  python -m dexiraft_tpu_torch router --port 8000 \
      --replicas 127.0.0.1:8101,127.0.0.1:8102

  # SPAWN the pool too: N single-worker serve processes on
  # port_base..port_base+N-1, supervised (restart-on-death with
  # backoff), every flag after `--` forwarded to each replica
  python -m dexiraft_tpu_torch router --port 8000 --spawn 4 \
      --port_base 8101 -- --model raft-sintel.pt --variant v5 \
      --warmup 440x1024

A copy of ``dexiraft_tpu/router_cli.py`` whose replicas are the port's
``python -m dexiraft_tpu_torch serve`` processes.

This is the sanctioned multi-replica path (``serve --workers``'
SO_REUSEPORT pool has NO session affinity — the kernel balances
accepts blindly): each replica is a complete stateful service, and the
router keeps ``X-Session-Id`` streams pinned to the replica holding
their warm-start carry via a consistent-hash ring (serve/router.py).

Lifecycle discipline:
  * a replica that DIES is routed around within the breaker's failure
    threshold (in-flight requests fail over to a healthy replica) and,
    in spawn mode, restarted with jittered backoff — bounded by
    ``--max_restarts`` consecutive failures per replica so a
    crash-looping model cannot flap forever.
  * ``POST /admin/drain?replica=<rid>`` does a ZERO-DROP rolling
    restart: out of assignment, wait in-flight to 0 (the replica's
    /healthz readiness payload), SIGTERM (the replica's own drain
    discipline finishes the tail), respawn.
  * SIGTERM on the router: stop supervising (no respawns), drain every
    spawned replica, exit. A second signal aborts.

No model and no device in this process: the router must keep routing
while model processes load, crash, and restart.
"""

from __future__ import annotations

import argparse
import http.client
import json
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from dexiraft_tpu_torch.serve.locks import OrderedLock
from dexiraft_tpu_torch.serve.router import Router, RouterConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "dexiraft-router",
        description="health-checked, session-affine router over N "
                    "FlowService replicas (everything after `--` is "
                    "forwarded to spawned replicas)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="the router's own listen port (0 = ephemeral)")
    p.add_argument("--replicas", default=None,
                   help="comma-separated replica addresses "
                        "(host:port or http://host:port) to front")
    p.add_argument("--spawn", type=int, default=0,
                   help="spawn this many single-worker serve replicas "
                        "(flags after `--` are forwarded to each)")
    p.add_argument("--port_base", type=int, default=8101,
                   help="spawned replica i listens on port_base + i")
    p.add_argument("--fail_threshold", type=int, default=3,
                   help="consecutive probe/request failures that open a "
                        "replica's circuit breaker")
    p.add_argument("--cooldown_s", type=float, default=2.0,
                   help="open-breaker cooldown before the half-open "
                        "trial probe")
    p.add_argument("--probe_interval_s", type=float, default=0.5,
                   help="active /healthz probe cadence per replica")
    p.add_argument("--max_inflight", type=int, default=128,
                   help="router-level admission bound (503 + Retry-After "
                        "past it)")
    p.add_argument("--deadline_s", type=float, default=60.0,
                   help="per-request budget covering the proxy AND the "
                        "one failover retry")
    p.add_argument("--max_restarts", type=int, default=5,
                   help="consecutive supervised restarts per replica "
                        "before giving up on it")
    p.add_argument("--restart_backoff_s", type=float, default=1.0,
                   help="base (jittered, doubling) backoff between "
                        "supervised restarts")
    p.add_argument("--boot_timeout_s", type=float, default=600.0,
                   help="how long to wait for spawned replicas' first "
                        "healthy /healthz (model load + warmup)")
    return p


# ---- spawn-mode plumbing -------------------------------------------------


def spawn_replica(port: int, serve_args: List[str], *, host="127.0.0.1",
                  env: Optional[dict] = None) -> subprocess.Popen:
    """One single-worker serve process on an explicit port. Detached
    into its own session so ^C on the router's terminal reaches it
    exactly once, through our forwarding (the serve_cli pool's
    rationale)."""
    argv = [sys.executable, "-m", "dexiraft_tpu_torch", "serve",
            "--host", host, "--port", str(port), *serve_args]
    return subprocess.Popen(argv, env=env, start_new_session=True)


def wait_ready(host: str, port: int, timeout_s: float = 600.0,
               poll_s: float = 0.25) -> bool:
    """Poll /healthz until it answers 200 (model load + warmup can take
    a minute). False on timeout."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            conn = http.client.HTTPConnection(host, port, timeout=2.0)
            try:
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    return True
            finally:
                conn.close()
        except OSError:
            pass
        time.sleep(poll_s)
    return False


_RESTART_RESET_S = 120.0   # alive this long => the crash streak is over


class _Supervisor:
    """Owns the spawned replica processes: restart-on-death with
    jittered doubling backoff (bounded per crash STREAK — a replica
    that stays up resets its count), the drain hook's respawn, and the
    shutdown fan-out."""

    def __init__(self, args, serve_args: List[str]):
        self.args = args
        self.serve_args = serve_args
        self.procs: Dict[str, subprocess.Popen] = {}
        self.ports: Dict[str, int] = {}
        self.restarts: Dict[str, int] = {}
        self._last_restart: Dict[str, float] = {}
        self._gave_up: set = set()
        self._respawning: set = set()
        self._lock = OrderedLock("serve.router.supervisor")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def spawn_all(self) -> Dict[str, str]:
        urls = {}
        with self._lock:
            # startup runs before _watch exists, but the drain hook can
            # already be wired — keep every procs/ports mutation under
            # the one lock the other writers hold
            for i in range(self.args.spawn):
                rid = f"r{i}"
                port = self.args.port_base + i
                self.ports[rid] = port
                self.restarts[rid] = 0
                self.procs[rid] = spawn_replica(port, self.serve_args,
                                                host=self.args.host)
                urls[rid] = f"{self.args.host}:{port}"
        return urls

    def respawn(self, rid: str) -> None:
        """The drain hook: SIGTERM (replica drains itself — zero-drop),
        reap, spawn fresh. Called with the replica already out of
        assignment and at 0 in-flight. Idempotent under concurrent
        drains of the same rid: the loser of the latch race returns and
        lets the in-flight respawn finish."""
        with self._lock:
            if rid in self._respawning:
                # a second drain of the same replica while the first is
                # still reaping: both would reap the same old child and
                # then BOTH spawn onto the same port (one live orphan +
                # procs[rid] pointing at the bind-race loser)
                return
            # _respawning is ALSO the watcher-suppression latch: _watch
            # skips respawning rids in both its dead-sweep and its
            # backoff-spawn guard, so the watcher cannot double-spawn
            # onto the port while we reap below with no lock held. The
            # latch is self-clearing in the finally — a failed spawn
            # returns the rid to the watcher's care (crash-restart with
            # backoff) instead of stranding it.
            self._respawning.add(rid)
            proc = self.procs.get(rid)
        try:
            if proc is not None and proc.poll() is None:
                # reap OUTSIDE the lock: a drain-wait can take up to
                # 60s, and holding the supervisor lock across it would
                # stall the crash-restart sweep for every OTHER replica
                proc.terminate()
                try:
                    proc.wait(timeout=60.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            with self._lock:
                self.procs[rid] = spawn_replica(self.ports[rid],
                                                self.serve_args,
                                                host=self.args.host)
                self.restarts[rid] = 0  # deliberate restart, not a crash
                self._gave_up.discard(rid)   # a drain respawn revives
        finally:
            with self._lock:
                self._respawning.discard(rid)
        print(f"[router] replica {rid} drained and respawned on port "
              f"{self.ports[rid]}", flush=True)

    def _watch(self) -> None:
        import random

        rng = random.Random()
        while not self._stop.wait(1.0):
            now = time.monotonic()
            with self._lock:
                dead = [(rid, p, p.returncode)
                        for rid, p in self.procs.items()
                        if p.poll() is not None
                        and rid not in self._gave_up
                        and rid not in self._respawning]
                # a replica that stayed up past the reset window ended
                # its crash STREAK: its restart budget refills (the cap
                # bounds consecutive failures, not lifetime restarts)
                for rid, p in self.procs.items():
                    if (p.poll() is None and self.restarts[rid]
                            and now - self._last_restart.get(rid, now)
                            > _RESTART_RESET_S):
                        self.restarts[rid] = 0
            for rid, proc, rc in dead:
                n = self.restarts[rid]
                if n >= self.args.max_restarts:
                    # latch: one give-up line, not one per sweep; a
                    # drain-hook respawn un-latches it
                    with self._lock:
                        self._gave_up.add(rid)
                    print(f"[router] replica {rid} exited rc={rc}; "
                          f"{n} consecutive restarts already — giving up "
                          f"on it (breaker keeps it out of routing; "
                          f"/admin/drain?replica={rid} revives it)",
                          flush=True)
                    continue
                backoff = (self.args.restart_backoff_s * (2 ** n)
                           * (1 + rng.random()))
                print(f"[router] replica {rid} exited rc={rc}; "
                      f"restarting in {backoff:.1f}s "
                      f"(attempt {n + 1}/{self.args.max_restarts})",
                      flush=True)
                if self._stop.wait(backoff):
                    return
                with self._lock:
                    if self._stop.is_set():
                        return
                    if (self.procs[rid] is not proc
                            or proc.poll() is None
                            or rid in self._respawning):
                        # someone (the drain hook) already replaced it —
                        # or is mid-respawn right now — spawning again
                        # would double-bind the port and orphan the
                        # live child
                        continue
                    self.restarts[rid] += 1
                    self._last_restart[rid] = time.monotonic()
                    self.procs[rid] = spawn_replica(self.ports[rid],
                                                    self.serve_args,
                                                    host=self.args.host)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._watch,
                                        name="router-supervisor",
                                        daemon=True)
        self._thread.start()

    def shutdown(self, sig: int = signal.SIGTERM) -> None:
        """Stop respawning, drain every child (their own SIGTERM
        discipline finishes admitted work), reap."""
        self._stop.set()
        with self._lock:
            procs = dict(self.procs)
        for rid, p in procs.items():
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass
        for rid, p in procs.items():
            try:
                p.wait(timeout=60.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


# ---- main ---------------------------------------------------------------


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    # everything after `--` belongs to the spawned replicas
    serve_args: List[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, serve_args = argv[:split], argv[split + 1:]
    args = build_parser().parse_args(argv)

    if bool(args.replicas) == bool(args.spawn):
        raise SystemExit("router: exactly one of --replicas or --spawn N "
                         "is required")
    if serve_args and not args.spawn:
        raise SystemExit("router: serve args after `--` only make sense "
                         "with --spawn")

    supervisor = None
    restarts = {}
    if args.spawn:
        if args.spawn < 1:
            raise SystemExit(f"router: --spawn must be >= 1, got "
                             f"{args.spawn}")
        supervisor = _Supervisor(args, serve_args)
        urls = supervisor.spawn_all()
        print(f"[router] spawned {args.spawn} replica(s) on ports "
              f"{args.port_base}..{args.port_base + args.spawn - 1}; "
              f"waiting for first healthy probe", flush=True)
        ok = [rid for rid, url in urls.items()
              if wait_ready(args.host, supervisor.ports[rid],
                            args.boot_timeout_s)]
        if not ok:
            supervisor.shutdown()
            raise SystemExit("router: no spawned replica became healthy "
                             f"within {args.boot_timeout_s:g}s")
        if len(ok) < args.spawn:
            print(f"[router] WARNING: only {len(ok)}/{args.spawn} "
                  f"replicas healthy at boot; breakers cover the rest",
                  flush=True)
        restarts = {rid: (lambda r=rid: supervisor.respawn(r))
                    for rid in urls}
        supervisor.start()
    else:
        urls = {f"r{i}": addr.strip()
                for i, addr in enumerate(args.replicas.split(","))
                if addr.strip()}
        if not urls:
            raise SystemExit("router: --replicas parsed to an empty pool")

    router = Router(
        urls, host=args.host, port=args.port,
        config=RouterConfig(
            fail_threshold=args.fail_threshold,
            cooldown_s=args.cooldown_s,
            probe_interval_s=args.probe_interval_s,
            max_inflight=args.max_inflight,
            deadline_s=args.deadline_s),
        restarts=restarts)
    router.start()
    print(f"[router] listening on {router.url} — "
          f"{len(urls)} replica(s): "
          + ", ".join(f"{rid}={u}" for rid, u in sorted(urls.items())),
          flush=True)

    stop = threading.Event()
    latched = [False]

    def _handle(signum, frame):
        if latched[0]:
            raise KeyboardInterrupt(f"second signal {signum}")
        latched[0] = True
        print(f"[router] signal {signum}: draining fleet", flush=True)
        stop.set()

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _handle)
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    router.stop()
    if supervisor is not None:
        supervisor.shutdown()
    rec = router.stats.record()
    print(f"[router] stopped — {rec['requests']} requests, "
          f"{rec['proxied_ok']} ok, {rec['retries']} retries "
          f"({rec['failovers']} failovers), "
          f"{rec['shed_router'] + rec['shed_upstream']} shed, "
          f"{rec['upstream_errors']} upstream errors; "
          f"affinity {json.dumps(router.pool.affinity_record())}",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
