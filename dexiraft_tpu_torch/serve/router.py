"""Fleet router: health-checked, session-affine load balancing over N
FlowService replicas.

A copy of ``dexiraft_tpu/serve/router.py`` with the port's imports: the
lock ranks of ``serve/locks.py`` and the HTTP plumbing of
``serve/httputil.py``. The hash ring (blake2b points, 64 virtual nodes),
the breaker states, the ``RouterConfig`` defaults and the ``/stats``,
``/healthz`` and ``/admin/drain`` schemas are the JAX package's.

One FlowService process is one failure domain: ``serve --workers N``
scales accepts but gives no session affinity (the kernel balances
connections blindly) and no failure handling (a dead worker's accepted
connections just reset). This router is the layer above — a pure-stdlib
proxy process that keeps the fleet serving through replica death,
restart, and overload:

  * **active health checking** — a background thread probes every
    replica's ``/healthz`` on a cadence; ``fail_threshold`` consecutive
    failures open a per-replica circuit breaker
    (closed -> open -> half-open probe -> closed), and proxy-side
    connect-refused/timeouts mark failures passively so a crash is
    detected at the FIRST failed request, not the next probe tick.
  * **consistent-hash session affinity** — ``X-Session-Id`` maps to a
    replica through a hash ring (virtual nodes), so the RAFT warm-start
    carry (``flow_init`` sessions) keeps landing on the replica
    that holds it. Pool changes remap only the bounded key range the
    ring guarantees: adding replica N+1 moves ~1/(N+1) of the sessions,
    removing a replica moves ONLY its own. A session whose replica died
    restarts cold elsewhere — counted (``sticky_misses``), not an
    error.
  * **zero-drop lifecycle** — ``drain(rid)`` removes a replica from
    assignment, polls its ``/healthz`` readiness payload until
    ``inflight`` hits 0, then invokes the restart hook (router_cli
    wires the subprocess restart); nothing admitted is dropped. An
    upstream failure on an in-flight proxied request (connection
    refused/reset — the request provably did not complete; flow
    inference is idempotent, a pure function of the frames) retries
    ONCE on a different healthy replica after a jittered backoff, under
    a per-request deadline budget — so even an ABRUPT replica kill
    drops zero accepted requests.
  * **graceful overload** — a router-level admission bound (503 +
    Retry-After past ``max_inflight``), replica 503 sheds retried once
    elsewhere then surfaced, and ``/stats`` aggregation: per-replica
    breaker state + last health payload, affinity hit rate, retries,
    failovers, shed counts, and an ``autoscale`` block fed by the
    replica schedulers' EWMA service estimates + shed counters.

Endpoints (the router speaks the SAME wire protocol as one replica, so
clients cannot tell one FlowService from a fleet):

  POST /v1/flow       proxied to the session's (or next healthy)
                      replica; response gains ``X-Replica`` and
                      ``X-Router-Retries`` headers.
  GET  /healthz       200 while >=1 replica is routable, else 503.
  GET  /stats         router counters + per-replica health + autoscale
                      hints; ``?replicas=1`` also scrapes every live
                      replica's own /stats into the blob.
  POST /admin/drain?replica=<rid>   zero-drop drain (+restart, when a
                      restart hook is wired) in the background; 202.

This module imports no torch and touches no device — the router is
pure control plane and must survive model-side crashes, and be
unit-testable with fake clocks and fake probers.
"""

from __future__ import annotations

import bisect
import hashlib
import http.client
import json
import random
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from dexiraft_tpu_torch.serve import locks as _locks
from dexiraft_tpu_torch.serve.httputil import QuietDisconnectsMixin
from dexiraft_tpu_torch.serve.locks import OrderedLock

# breaker states
CLOSED = "closed"          # healthy: in the ring, taking traffic
OPEN = "open"              # failed: out of the ring, cooling down
HALF_OPEN = "half_open"    # cooldown elapsed: one probe decides


class NoHealthyReplica(RuntimeError):
    """Every replica is open/draining/unready — the router must shed."""


# ---- consistent hashing -------------------------------------------------


class HashRing:
    """Consistent-hash ring with virtual nodes.

    The property the fleet needs is BOUNDED REMAPPING: membership
    changes must not reshuffle every session's home (each reshuffled
    session restarts its warm-start carry cold). A mod-N table remaps
    ~100% of keys when N changes; the ring remaps ~1/(N+1) on add and
    exactly the departed member's keys on remove —
    tests/test_zzfleet_router.py pins both.
    """

    def __init__(self, members: Sequence[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: List[Tuple[int, str]] = []   # sorted (point, member)
        self._members: set = set()
        for m in members:
            self.add(m)

    @staticmethod
    def _point(key: str) -> int:
        # blake2b over md5: no deprecation noise, stable across runs
        # and processes (hash() is salted per-process — useless here)
        return int.from_bytes(
            hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for v in range(self.vnodes):
            bisect.insort(self._points,
                          (self._point(f"{member}#{v}"), member))

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        self._points = [(p, m) for p, m in self._points if m != member]

    @property
    def members(self) -> set:
        return set(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def lookup(self, key: str) -> Optional[str]:
        """The key's owner: first virtual node clockwise of its point."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, (self._point(key), ""))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def chain(self, key: str) -> List[str]:
        """Every member, in ring order starting at the key's owner —
        the deterministic failover order (the retry goes to chain[1]
        when chain[0] is the dead owner)."""
        if not self._points:
            return []
        i = bisect.bisect_right(self._points, (self._point(key), ""))
        seen: List[str] = []
        for j in range(len(self._points)):
            m = self._points[(i + j) % len(self._points)][1]
            if m not in seen:
                seen.append(m)
        return seen


# ---- replica pool: breaker + affinity + drain ---------------------------


class RouterConfig:
    """Router knobs (construction-time; no live mutation)."""

    def __init__(self, *,
                 fail_threshold: int = 3,
                 cooldown_s: float = 2.0,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 max_inflight: int = 128,
                 deadline_s: float = 60.0,
                 retry_backoff_s: float = 0.05,
                 upstream_timeout_s: float = 60.0,
                 vnodes: int = 64,
                 affinity_window: int = 4096):
        if fail_threshold < 1:
            raise ValueError(f"fail_threshold must be >= 1, got "
                             f"{fail_threshold}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{max_inflight}")
        self.fail_threshold = fail_threshold
        self.cooldown_s = cooldown_s
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.max_inflight = max_inflight
        self.deadline_s = deadline_s
        self.retry_backoff_s = retry_backoff_s
        self.upstream_timeout_s = upstream_timeout_s
        self.vnodes = vnodes
        self.affinity_window = affinity_window


class Replica:
    """One upstream FlowService: address + breaker state + last-seen
    health payload. All mutation happens under the pool's lock."""

    def __init__(self, rid: str, url: str,
                 restart: Optional[Callable[[], None]] = None):
        u = urlparse(url if "//" in url else f"http://{url}")
        if not u.hostname or not u.port:
            raise ValueError(f"replica {rid}: url {url!r} needs host:port")
        self.rid = rid
        self.host = u.hostname
        self.port = u.port
        self.restart = restart      # lifecycle hook (router_cli: respawn)
        self.state = CLOSED
        self.fails = 0              # consecutive failures
        self.opened_at = 0.0
        self.draining = False       # router-side: excluded from the ring
        self.ready = True           # replica-side: /healthz said 200
        self.health: dict = {}      # last /healthz payload (either status)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def routable(self) -> bool:
        return self.state == CLOSED and self.ready and not self.draining

    def record(self) -> dict:
        return {"url": self.url, "state": self.state,
                "ready": self.ready, "draining": self.draining,
                "consecutive_failures": self.fails,
                "health": self.health}


class ReplicaPool:
    """Breaker state machine + ring membership + affinity accounting.

    `clock` and `prober` are injectable so every policy path (breaker
    transitions, drain-waits-for-inflight, probe cadence) runs under a
    fake clock with no sockets. The default prober is a real HTTP GET
    of the replica's /healthz.
    """

    def __init__(self, replicas: Dict[str, str],
                 config: Optional[RouterConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 prober: Optional[Callable[[Replica], dict]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.config = config or RouterConfig()
        self.clock = clock
        self.sleep = sleep
        self.prober = prober or self._http_probe
        # reentrant: record() re-enters via affinity_record()
        self._lock = OrderedLock("serve.router.pool", reentrant=True)
        self.replicas: Dict[str, Replica] = {
            rid: Replica(rid, url) for rid, url in replicas.items()}
        self.ring = HashRing(sorted(self.replicas),
                             vnodes=self.config.vnodes)
        self._last_probe: Dict[str, float] = {rid: -1e18
                                              for rid in self.replicas}
        self._rr = 0                # stateless round-robin cursor
        # session -> rid that served it last (bounded LRU): the ground
        # truth for affinity hits vs sticky misses
        self._session_home: "OrderedDict[str, str]" = OrderedDict()
        self.affinity_hits = 0
        self.affinity_new = 0
        self.sticky_misses = 0      # home replica changed under the session
        self.breaker_opens = 0
        self.drains = 0

    # ---- probing --------------------------------------------------------

    def _http_probe(self, replica: Replica) -> dict:
        """GET /healthz. Returns the payload (200 OR 503-draining —
        both mean ALIVE); raises on anything connection-shaped."""
        conn = http.client.HTTPConnection(
            replica.host, replica.port,
            timeout=self.config.probe_timeout_s)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = resp.read()
            payload = json.loads(body) if body else {}
            payload["_status"] = resp.status
            return payload
        finally:
            conn.close()

    def probe_once(self) -> None:
        """One health-check sweep: probe every replica whose interval
        (or breaker cooldown) elapsed. The health thread calls this in
        a loop; fake-clock tests call it directly."""
        now = self.clock()
        cfg = self.config
        with self._lock:
            due = []
            for rid, r in self.replicas.items():
                if r.state == OPEN:
                    if now - r.opened_at < cfg.cooldown_s:
                        continue            # still cooling down
                    r.state = HALF_OPEN     # cooldown over: trial probe
                elif now - self._last_probe[rid] < cfg.probe_interval_s:
                    continue
                self._last_probe[rid] = now
                due.append(r)

        def _probe_one(r: Replica) -> None:
            try:
                payload = self.prober(r)
            except Exception:
                self.mark_failure(r.rid)
            else:
                self.mark_alive(r.rid, payload)

        if len(due) <= 1:
            for r in due:
                _probe_one(r)
            return
        # probe CONCURRENTLY: sequential probing lets one black-holing
        # replica (SYN dropped — each probe burns the full
        # probe_timeout_s) stretch the whole sweep, inflating every
        # other replica's detection/half-open latency with fleet size
        threads = [threading.Thread(target=_probe_one, args=(r,),
                                    name=f"probe-{r.rid}", daemon=True)
                   for r in due]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def mark_alive(self, rid: str, payload: dict) -> None:
        """The replica answered /healthz: close the breaker; ring
        membership follows READINESS (a draining replica is alive but
        must stop receiving new sessions)."""
        with self._lock:
            r = self.replicas[rid]
            r.fails = 0
            r.state = CLOSED
            r.health = {k: v for k, v in payload.items()
                        if not k.startswith("_")}
            r.ready = (payload.get("_status", 200) == 200
                       and not payload.get("draining", False))
            if r.routable():
                self.ring.add(rid)
            else:
                self.ring.remove(rid)

    def mark_failure(self, rid: str) -> None:
        """One failed probe OR one failed proxied request (passive
        marking): breaker math is shared, so a crash surfaces at the
        first failed request instead of waiting for the next probe."""
        with self._lock:
            r = self.replicas[rid]
            r.fails += 1
            if r.state == HALF_OPEN or (r.state == CLOSED
                                        and r.fails
                                        >= self.config.fail_threshold):
                if r.state != OPEN:
                    self.breaker_opens += 1
                r.state = OPEN
                r.opened_at = self.clock()
                self.ring.remove(rid)

    # ---- routing --------------------------------------------------------

    def route(self, session_id: Optional[str] = None) -> Replica:
        """Pick the replica for one request. Session requests go to
        their ring owner (affinity); stateless requests round-robin
        over routable replicas. Raises NoHealthyReplica."""
        with self._lock:
            routable = [r for r in self.replicas.values() if r.routable()]
            if not routable:
                raise NoHealthyReplica(
                    f"0 of {len(self.replicas)} replicas routable")
            if session_id is None:
                r = routable[self._rr % len(routable)]
                self._rr += 1
                return r
            owner = self.ring.lookup(session_id)
            if owner is None:          # ring empty but routable nonempty
                owner = routable[0].rid   # (draining edge) — any is fine
            self._note_affinity(session_id, owner)
            return self.replicas[owner]

    def _note_affinity(self, session_id: str, rid: str) -> None:
        # under self._lock
        home = self._session_home.get(session_id)
        if home is None:
            self.affinity_new += 1
        elif home == rid:
            self.affinity_hits += 1
            self._session_home.move_to_end(session_id)
        else:
            # the session's replica died/drained and the ring moved it:
            # its warm carry is gone, it restarts cold elsewhere
            self.sticky_misses += 1
        self._session_home[session_id] = rid
        self._session_home.move_to_end(session_id)
        while len(self._session_home) > self.config.affinity_window:
            self._session_home.popitem(last=False)

    def alternate(self, exclude: str,
                  session_id: Optional[str] = None) -> Optional[Replica]:
        """A DIFFERENT routable replica for the failover retry —
        ring-order next for session requests (deterministic), round-
        robin otherwise. None when no alternative exists."""
        with self._lock:
            if session_id is not None:
                for rid in self.ring.chain(session_id):
                    r = self.replicas[rid]
                    if rid != exclude and r.routable():
                        return r
            candidates = [r for r in self.replicas.values()
                          if r.rid != exclude and r.routable()]
            if not candidates:
                return None
            r = candidates[self._rr % len(candidates)]
            self._rr += 1
            return r

    # ---- lifecycle ------------------------------------------------------

    def drain(self, rid: str, *, timeout_s: float = 60.0,
              poll_s: float = 0.2, restart: bool = True) -> dict:
        """Zero-drop replica drain: (1) stop new assignment (out of the
        ring — its sessions remap now, under the ring's bounded-move
        guarantee), (2) poll the replica's /healthz readiness payload
        until ``inflight`` reaches 0, (3) run the restart hook. The
        health loop re-admits it once it probes ready again.

        Returns {rid, drained, waited_s, inflight_last, restarted};
        ``drained`` False means the timeout expired with work still in
        flight (the caller decides whether to restart anyway — we do
        NOT)."""
        with self._lock:
            r = self.replicas[rid]
            r.draining = True
            self.ring.remove(rid)
            self.drains += 1
        t0 = self.clock()
        inflight = None
        drained = False
        while self.clock() - t0 <= timeout_s:
            try:
                payload = self.prober(r)
                inflight = int(payload.get("inflight", 0))
            except Exception:
                # dead mid-drain: nothing in flight to wait for
                inflight = 0
            if inflight == 0:
                drained = True
                break
            self.sleep(poll_s)
        out = {"rid": rid, "drained": drained,
               "waited_s": round(self.clock() - t0, 3),
               "inflight_last": inflight,
               "restarted": bool(drained and restart
                                 and r.restart is not None)}
        if out["restarted"]:
            r.restart()
        with self._lock:
            r.draining = False
            # membership returns via mark_alive once it probes ready
        return out

    # ---- introspection --------------------------------------------------

    def healthy_count(self) -> int:
        with self._lock:
            return sum(r.routable() for r in self.replicas.values())

    def affinity_record(self) -> dict:
        with self._lock:
            tracked = self.affinity_hits + self.sticky_misses
            return {
                "hits": self.affinity_hits,
                "new": self.affinity_new,
                "sticky_misses": self.sticky_misses,
                # hit rate over requests whose session HAD a home —
                # first-contact requests can't hit by definition
                "hit_rate": (round(self.affinity_hits / tracked, 4)
                             if tracked else None),
            }

    def reset_counters(self) -> None:
        with self._lock:
            self.affinity_hits = self.affinity_new = 0
            self.sticky_misses = 0
            self.breaker_opens = 0
            self.drains = 0

    def record(self) -> dict:
        with self._lock:
            return {
                "replicas": {rid: r.record()
                             for rid, r in sorted(self.replicas.items())},
                "healthy": sum(r.routable()
                               for r in self.replicas.values()),
                "ring_members": sorted(self.ring.members),
                "breaker_opens": self.breaker_opens,
                "drains": self.drains,
                "affinity": self.affinity_record(),
            }


# ---- router stats -------------------------------------------------------

_PCTL_WINDOW = 4096


class RouterStats:
    """Proxy-side counters (the pool owns health/affinity ones).

    Handler threads mutate these concurrently, so every increment goes
    through ``bump()`` under one lock — bare ``+= 1`` is a load/store
    race that silently undercounts exactly the numbers the fleet bench
    and chaos phase report as results."""

    def __init__(self) -> None:
        self._lock = OrderedLock("serve.router.stats")
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.requests = 0
            self.proxied_ok = 0
            self.retries = 0           # failover attempts made
            self.failovers = 0         # retries that returned 200
            self.shed_router = 0       # router-level 503 (admission bound)
            self.shed_upstream = 0     # replica 503 surfaced to the client
            self.upstream_errors = 0   # 502s surfaced to the client
            self.no_healthy = 0        # 503: zero routable replicas
            self.latency_s: List[float] = []

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def note_latency(self, dt: float) -> None:
        with self._lock:
            self.latency_s.append(dt)
            if len(self.latency_s) > _PCTL_WINDOW:
                del self.latency_s[:len(self.latency_s) - _PCTL_WINDOW]

    def record(self) -> dict:
        with self._lock:   # one consistent snapshot, counters + window
            lat = list(self.latency_s)
            out = {
                "requests": self.requests,
                "proxied_ok": self.proxied_ok,
                "retries": self.retries,
                "failovers": self.failovers,
                "shed_router": self.shed_router,
                "shed_upstream": self.shed_upstream,
                "upstream_errors": self.upstream_errors,
                "no_healthy": self.no_healthy,
            }
        out["latency_p50_ms"] = (round(float(np.percentile(lat, 50)) * 1e3,
                                       2) if lat else 0.0)
        out["latency_p99_ms"] = (round(float(np.percentile(lat, 99)) * 1e3,
                                       2) if lat else 0.0)
        return out


# ---- the proxy ----------------------------------------------------------

# upstream failures that prove the request did NOT complete — safe to
# retry an idempotent request elsewhere. A read TIMEOUT is absent on
# purpose: the work may still finish, and re-running it would double
# load exactly when the fleet is slowest.
_RETRYABLE = (ConnectionRefusedError, ConnectionResetError,
              BrokenPipeError, http.client.BadStatusLine,
              http.client.RemoteDisconnected, ConnectionAbortedError)


class _UpstreamResult:
    __slots__ = ("status", "body", "headers")

    def __init__(self, status: int, body: bytes, headers: dict):
        self.status = status
        self.body = body
        self.headers = headers


class _RouterHTTPServer(QuietDisconnectsMixin, ThreadingHTTPServer):
    daemon_threads = False
    block_on_close = True

    def __init__(self, addr, handler, router: "Router"):
        self.router = router
        super().__init__(addr, handler)


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "dexiraft-router/1.0"
    protocol_version = "HTTP/1.1"
    timeout = 30.0

    def log_message(self, fmt, *args):
        pass

    def _send(self, status: int, body: bytes, content_type: str,
              headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
        self._send(status, json.dumps(payload).encode(),
                   "application/json", headers)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        router = self.server.router
        url = urlparse(self.path)
        if url.path == "/healthz":
            healthy = router.pool.healthy_count()
            self._send_json(200 if healthy else 503,
                            {"status": "ok" if healthy else "no_healthy",
                             "replicas": len(router.pool.replicas),
                             "healthy": healthy})
        elif url.path == "/livez":
            self._send_json(200, {"status": "alive"})
        elif url.path == "/stats":
            scrape = parse_qs(url.query).get("replicas", ["0"])[0] == "1"
            self._send_json(200, router.stats_record(
                scrape_replicas=scrape))
        else:
            self._send_json(404, {"error": f"no such endpoint {url.path!r}"})

    def _read_body(self) -> Optional[bytes]:
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
        router = self.server.router
        body = self._read_body()
        if body is None:
            self._send_json(400, {"error": "unsupported Transfer-Encoding "
                                           "or bad Content-Length"})
            return
        path = urlparse(self.path)
        if path.path == "/admin/drain":
            rid = parse_qs(path.query).get("replica", [None])[0]
            if rid is None or rid not in router.pool.replicas:
                self._send_json(400, {"error": f"unknown replica {rid!r} "
                                               f"(have "
                                               f"{sorted(router.pool.replicas)})"})
                return
            def _drain_and_report(rid=rid):
                out = router.pool.drain(rid)
                # the 202 already went out — the OUTCOME must land
                # somewhere visible, or a timed-out drain (replica NOT
                # restarted, returned to rotation still running the old
                # process) silently impersonates a completed one
                verdict = (("complete, replica restarted"
                            if out["restarted"] else
                            "complete (no restart hook wired)")
                           if out["drained"] else
                           "TIMED OUT with work in flight — NOT "
                           "restarted, returned to rotation")
                print(f"[router] drain {rid}: {verdict} "
                      f"(waited {out['waited_s']}s, last inflight "
                      f"{out['inflight_last']})", flush=True)

            threading.Thread(target=_drain_and_report,
                             name=f"drain-{rid}", daemon=True).start()
            self._send_json(202, {"status": "draining", "replica": rid})
            return
        if path.path != "/v1/flow":
            self._send_json(404, {"error": f"no such endpoint {self.path!r}"})
            return
        status, resp_body, headers = router.proxy_flow(
            body, self.headers.get("X-Session-Id"),
            self.headers.get("Content-Type", "application/x-npz"))
        self._send(status, resp_body,
                   headers.pop("Content-Type", "application/json"), headers)


class Router:
    """The fleet front: ReplicaPool policy + HTTP proxy + health loop.

    ``replicas`` maps replica id -> base url (``http://host:port`` or
    bare ``host:port``). ``restarts`` optionally maps replica id -> a
    zero-arg restart hook for the drain lifecycle (router_cli wires the
    subprocess respawn; tests wire stubs).
    """

    def __init__(self, replicas: Dict[str, str], *,
                 host: str = "127.0.0.1", port: int = 0,
                 config: Optional[RouterConfig] = None,
                 restarts: Optional[Dict[str, Callable[[], None]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 prober: Optional[Callable[[Replica], dict]] = None,
                 rng: Optional[random.Random] = None):
        self.config = config or RouterConfig()
        self.pool = ReplicaPool(replicas, self.config, clock=clock,
                                prober=prober)
        for rid, hook in (restarts or {}).items():
            self.pool.replicas[rid].restart = hook
        self.stats = RouterStats()
        # the autoscale window's since-last-scrape snapshot: /stats can
        # be scraped concurrently (operator curl + the bench + a second
        # router probe), and an unlocked read-swap would hand two
        # scrapes overlapping windows — double-counting shed into two
        # scale_up verdicts. Ranked above pool/stats: the whole
        # counters-read + prev-swap runs under it as one window
        self._autoscale_lock = OrderedLock("serve.router.autoscale")
        self._autoscale_prev = {"requests": 0, "shed": 0}
        self.clock = clock
        self._rng = rng or random.Random(0)
        self._inflight = 0
        # ranked before the stats lock: proxy_flow bumps counters while
        # holding the admission bound
        self._inflight_lock = OrderedLock("serve.router.inflight")
        self._httpd = _RouterHTTPServer((host, port), _RouterHandler,
                                        router=self)
        self._http_thread: Optional[threading.Thread] = None
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None

    # ---- addresses ------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return host, port

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    # ---- proxying -------------------------------------------------------

    def _upstream(self, replica: Replica, body: bytes, session_id,
                  content_type: str, timeout: float) -> _UpstreamResult:
        """One proxied request over a FRESH connection — deliberately
        not pooled: a reused keep-alive connection the replica idled
        out raises the same RemoteDisconnected a crash does, which
        would passively mark (and eventually breaker-open) a healthy
        replica. A fresh connect can only fail if the replica is
        actually unreachable, keeping the retry/breaker signal clean;
        the connect itself is loopback/intra-cell cheap next to a flow
        forward."""
        conn = http.client.HTTPConnection(replica.host, replica.port,
                                          timeout=timeout)
        try:
            headers = {"Content-Type": content_type}
            if session_id:
                headers["X-Session-Id"] = session_id
            conn.request("POST", "/v1/flow", body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            keep = {k: v for k, v in resp.getheaders()
                    if k in ("X-Warm-Start", "X-Bucket", "Content-Type",
                             "Retry-After")}
            return _UpstreamResult(resp.status, data, keep)
        finally:
            conn.close()

    def proxy_flow(self, body: bytes, session_id: Optional[str],
                   content_type: str) -> Tuple[int, bytes, dict]:
        """One client request end to end: admission -> route -> proxy
        -> (maybe) one failover retry. Returns (status, body, headers);
        never raises."""
        st = self.stats
        cfg = self.config
        with self._inflight_lock:
            st.bump("requests")
            if self._inflight >= cfg.max_inflight:
                st.bump("shed_router")
                return (503,
                        json.dumps({"error": "router overloaded: "
                                    f"{self._inflight} in flight"}).encode(),
                        {"Retry-After": "1"})
            self._inflight += 1
        t0 = self.clock()
        deadline = t0 + cfg.deadline_s
        try:
            return self._proxy_with_retry(body, session_id, content_type,
                                          deadline)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
            st.note_latency(self.clock() - t0)

    def _proxy_with_retry(self, body, session_id, content_type,
                          deadline) -> Tuple[int, bytes, dict]:
        st = self.stats
        cfg = self.config
        try:
            replica = self.pool.route(session_id)
        except NoHealthyReplica as e:
            st.bump("no_healthy")
            return (503, json.dumps({"error": str(e)}).encode(),
                    {"Retry-After": "1"})
        retried = False
        first_rid = replica.rid
        last_shed: Optional[_UpstreamResult] = None
        for attempt in (0, 1):
            budget = deadline - self.clock()
            if budget <= 0:
                st.bump("upstream_errors")
                return (504, json.dumps(
                    {"error": f"deadline ({cfg.deadline_s:g}s) exhausted"
                              f" after {attempt} attempt(s)"}).encode(), {})
            try:
                res = self._upstream(
                    replica, body, session_id, content_type,
                    timeout=min(budget, cfg.upstream_timeout_s))
            except _RETRYABLE:
                # the request provably never completed upstream — mark
                # the replica (passive breaker input) and fail over
                self.pool.mark_failure(replica.rid)
                res = None
            except OSError:
                # timeouts and the rest of the socket zoo: mark, but do
                # NOT retry (the work may still be running — re-running
                # doubles load exactly when the fleet is slowest)
                self.pool.mark_failure(replica.rid)
                st.bump("upstream_errors")
                return (502, json.dumps(
                    {"error": f"upstream {replica.rid} failed"}).encode(),
                    {})
            if res is not None and res.status != 503:
                if res.status == 200:
                    st.bump("proxied_ok")
                    if retried:
                        st.bump("failovers")
                res.headers["X-Replica"] = replica.rid
                res.headers["X-Router-Retries"] = str(int(retried))
                return res.status, res.body, res.headers
            if res is not None:
                # replica shed (or is draining): it is healthy, just
                # loaded — not a breaker failure. Try one other replica.
                last_shed = res
            if attempt == 1:
                break
            alt = self.pool.alternate(first_rid, session_id)
            if alt is None:
                break
            # jittered backoff, capped by the remaining budget
            pause = min(cfg.retry_backoff_s * (1 + self._rng.random()),
                        max(0.0, deadline - self.clock()))
            if pause > 0:
                time.sleep(pause)
            st.bump("retries")
            retried = True
            replica = alt
        if last_shed is not None:
            # every replica we could reach shed: the honest answer is
            # the fleet-wide 503 (+ Retry-After), never a 502
            st.bump("shed_upstream")
            last_shed.headers["X-Replica"] = replica.rid
            last_shed.headers.setdefault("Retry-After", "1")
            return last_shed.status, last_shed.body, last_shed.headers
        st.bump("upstream_errors")
        return (502, json.dumps(
            {"error": f"upstream failed "
                      f"({'both attempts' if retried else first_rid}); "
                      f"no healthy alternate"}).encode(), {})

    # ---- stats ----------------------------------------------------------

    def _autoscale_record(self) -> dict:
        """The autoscale hook: the signals a scaler needs, derived from
        what the fleet already measures — replica queue depths (off the
        schedulers' health payloads, backed by their EWMA service
        estimates) and the shed counters. The window is SINCE THE LAST
        SCRAPE (deltas against a kept snapshot): cumulative lifetime
        counters would latch one ancient shed into scale_up forever and
        make scale_down unreachable after the first request.
        Recommendation: UP when anything shed this window or every
        routable replica is carrying queued work; DOWN when >1 replica
        is routable and the window was idle; else steady."""
        with self._autoscale_lock:
            # read-and-swap is ONE atomic window: computing `cur`
            # outside the lock lets two concurrent scrapes swap
            # snapshots out of order (an older cur stored as prev
            # double-counts the newer scrape's window). The autoscale
            # lock ranks ABOVE pool/stats in LOCK_ORDER precisely so
            # these record() calls may nest under it
            pool_rec = self.pool.record()
            st = self.stats.record()
            cur = {"requests": st["requests"],
                   "shed": (st["shed_router"] + st["shed_upstream"]
                            + st["no_healthy"])}
            prev = self._autoscale_prev
            self._autoscale_prev = cur
        # counters only move forward except across reset_stats(); a
        # negative delta means a reset — the window restarts at cur
        d_req = (cur["requests"] - prev["requests"]
                 if cur["requests"] >= prev["requests"]
                 else cur["requests"])
        d_shed = (cur["shed"] - prev["shed"]
                  if cur["shed"] >= prev["shed"] else cur["shed"])
        healthy = pool_rec["healthy"]
        # queue depths from ROUTABLE replicas only: a breaker-open
        # corpse's last cached payload is a frozen snapshot, and its
        # stale depth would bias toward spurious scale_up
        depths = [r["health"].get("queue_depth", 0)
                  for r in pool_rec["replicas"].values()
                  if r["health"] and r["state"] == CLOSED
                  and r["ready"] and not r["draining"]]
        busy = bool(depths) and all(d > 0 for d in depths)
        if d_shed > 0 or (healthy and busy):
            rec = "scale_up"
        elif healthy > 1 and d_req == 0:
            rec = "scale_down"
        else:
            rec = "steady"
        return {"recommendation": rec, "healthy": healthy,
                "shed_window": d_shed, "queue_depths": depths}

    def stats_record(self, scrape_replicas: bool = False) -> dict:
        rec = {
            "router": self.stats.record(),
            "pool": self.pool.record(),
            "autoscale": self._autoscale_record(),
            # lock-order runtime verdicts + contention gauges for the
            # router's own thread fabric (handler threads, health loop,
            # drain threads) — the chaos failover phase pins the
            # violation counters at 0
            "locks": _locks.stats_record(),
        }
        if scrape_replicas:
            scraped = {}
            for rid, r in self.pool.replicas.items():
                try:
                    conn = http.client.HTTPConnection(
                        r.host, r.port, timeout=self.config.probe_timeout_s)
                    try:
                        conn.request("GET", "/stats")
                        scraped[rid] = json.loads(
                            conn.getresponse().read())
                    finally:
                        conn.close()
                except Exception as e:
                    scraped[rid] = {"error": f"{type(e).__name__}: {e}"}
            rec["replica_stats"] = scraped
        return rec

    def reset_stats(self) -> None:
        self.stats.reset()
        self.pool.reset_counters()
        with self._autoscale_lock:
            self._autoscale_prev = {"requests": 0, "shed": 0}

    # ---- lifecycle ------------------------------------------------------

    def _health_loop(self) -> None:
        while not self._health_stop.is_set():
            try:
                self.pool.probe_once()
            except Exception as e:   # a probe bug must not kill routing
                print(f"[router] health sweep failed: "
                      f"{type(e).__name__}: {e}", flush=True)
            self._health_stop.wait(self.config.probe_interval_s / 2)

    def start(self, *, health_thread: bool = True) -> "Router":
        if health_thread:
            # synchronous first sweep: the listener opens with breaker
            # state that reflects reality, not optimism
            self.pool.probe_once()
            self._health_thread = threading.Thread(
                target=self._health_loop, name="router-health", daemon=True)
            self._health_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="router-http",
            daemon=True)
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._health_stop.set()
        if self._http_thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
