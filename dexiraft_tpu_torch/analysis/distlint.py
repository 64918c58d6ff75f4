"""distlint — the collective-divergence rules (JL030-JL034) over the port.

The port's copy of ``dexiraft_tpu/analysis/distlint.py``: the same rules,
numbers and messages, with the port's collectives and host identities in
its pinned vocabulary. A multi-rank run hangs on every rank when one rank
takes a branch, returns early or swallows an exception around a
collective round (a Coordinator round, a ``torch.distributed`` call, the
fsdp gather, the halo exchange): every peer then waits in an exchange
this rank never joins. The defect is textual, so these rules read it off
the AST:

  JL030 divergent-collective-branch   a collective under a branch on
                            host identity (rank, fsdp/data/seq index,
                            the writer flag, hostname) whose arms do not
                            issue matching collective sequences.
  JL031 mid-protocol-bail   ``return``/``raise``/``continue`` between
                            collective rounds of a multi-round protocol
                            function on a local condition (one governed
                            by a collective verdict is sanctioned).
  JL032 unbounded-distributed-wait    ``.wait()``/``.join()``/
                            ``.result()`` with no timeout on the
                            distributed tier (``resilience/``,
                            ``parallel/``, ``train/checkpoint.py``,
                            ``analysis/collective_trace.py``; never
                            ``serve/``, whose bounded waits are its own).
  JL033 swallowed-collective-error    a collective inside a ``try`` whose
                            ``except`` swallows and continues.
  JL034 unreleased-armed-region   watchdog ``.arm(...)`` (or a
                            ``sanctioned()`` window) with no
                            ``finally``-path ``disarm``/``stop``.

The collective vocabulary is a pinned name set: JAX's (the Coordinator's
consensus primitives, the XLA collectives, orbax's barrier, the elastic
splice) plus the Coordinator's ``barrier``, ``torch.distributed``'s
collectives, process-group set-up and teardown, and the port's own
wrappers ``all_gather_flat`` (the fsdp gather), ``halo_exchange`` and
``ring_corr_lookup``. A rank-dependent choice that follows a collective
every rank issued (the halo exchange picks its neighbours' rows by
``axis.rank`` after one ``all_gather_flat``) is no divergence: JL030
compares only the collectives under the branch.

Pure stdlib. ``analysis/synclint.py`` loads it by file path, so its rules
share synclint's CLI, ``# synclint: disable=JL03X`` and
``analysis/baseline.json``.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Sequence, Set, Tuple

RULES = {
    "JL030": "divergent-collective-branch",
    "JL031": "mid-protocol-bail",
    "JL032": "unbounded-distributed-wait",
    "JL033": "swallowed-collective-error",
    "JL034": "unreleased-armed-region",
}

#: The repo's collective vocabulary, pinned (the shardlint LAYOUT_AXES
#: idiom): a call participates in JL030/031/033 iff its terminal name
#: is here. Coordinator primitives (resilience/coord.py), the lax
#: collectives shard_map bodies issue (parallel/halo.py), orbax's
#: process barrier, and the elastic backend splice points — each is a
#: blocking rendezvous every live host must join.
_COLLECTIVE_NAMES: Set[str] = {
    # Coordinator consensus primitives (+ the raw exchange they ride)
    "any_flag", "min_int", "agree_step", "_allgather", "barrier",
    # XLA collectives inside shard_map/pmap bodies
    "psum", "pmean", "pmax", "pmin", "all_gather", "ppermute",
    "all_to_all", "psum_scatter", "pshuffle",
    # orbax checkpoint barrier entry (and the test shim's name)
    "sync_global_processes", "kv_sync",
    # elastic backend splice: every surviving host re-initializes
    "elastic_initialize", "elastic_teardown",
    # torch.distributed: collectives, and the group's set-up and teardown
    "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
    "broadcast", "batch_isend_irecv", "init_process_group",
    "destroy_process_group",
    # the port's wrappers: the fsdp gather, the halo exchange, the ring
    "all_gather_flat", "halo_exchange", "ring_corr_lookup",
}

#: Host-identity markers for JL030: an ``if`` test mentioning one of
#: these branches on WHO the host is, not on replicated state.
#: (``size``/``epoch`` are deliberately absent — identical on every
#: host, branching on them is lockstep.)
_IDENTITY_ATTRS: Set[str] = {
    "process_index", "process_id", "index", "rank", "host_id",
    "is_coordinator", "is_leader", "is_primary", "hostname",
    # the port's: the writer rank, a rank's coordinates on the mesh
    "is_writer", "data_index", "fsdp_index", "seq_index",
}
_IDENTITY_NAMES: Set[str] = {"rank", "hostname", "is_coordinator",
                             "is_leader", "writer", "data_index",
                             "fsdp_index", "seq_index"}
_IDENTITY_CALLS: Set[str] = {"process_index", "process_id",
                             "gethostname", "get_rank"}

#: JL032's blocking-wait vocabulary: attrs whose ZERO-ARG form blocks
#: forever. Positional-arg forms (``join(sep)``, ``wait(5)``,
#: ``result(t)``) and a non-None ``timeout=`` keyword are bounded.
_WAIT_ATTRS: Set[str] = {"wait", "join", "result",
                         "wait_until_finished"}
_TIMEOUT_KWARGS: Set[str] = {"timeout", "timeout_s", "timeout_ms",
                             "timeout_secs"}

#: JL032 runs only on the distributed tier (normalized-path markers):
#: a dead PEER is what makes an unbounded wait unrecoverable, and only
#: these paths wait on peers.
_DIST_PATH_MARKERS: Tuple[str, ...] = (
    "dexiraft_tpu_torch/resilience/",
    "dexiraft_tpu_torch/parallel/",
    "dexiraft_tpu_torch/train/checkpoint.py",
    "dexiraft_tpu_torch/analysis/collective_trace.py",
)

#: JL034's armed-region vocabulary: acquire attr -> release attrs that
#: discharge it when called on the same receiver root inside a
#: ``finally`` (``stop`` counts — it disarms and retires the monitor).
_ARM_ATTR = "arm"
_RELEASE_ATTRS: Set[str] = {"disarm", "stop"}
_WINDOW_ATTR = "sanctioned"


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------


def _terminal_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_collective(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _terminal_name(node.func) in _COLLECTIVE_NAMES)


def _own_walk(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does NOT descend into nested function/class/lambda
    scopes — their protocol structure is judged on its own."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _collectives_in(node: ast.AST) -> List[ast.Call]:
    """Collective call sites under `node`, own scope only, in source
    order (line, col)."""
    calls = [n for n in _own_walk(node) if _is_collective(n)]
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    return calls


def _test_is_identity(test: ast.AST) -> Optional[str]:
    """The identity marker an ``if`` test branches on, or None."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call):
            name = _terminal_name(sub.func)
            if name in _IDENTITY_CALLS:
                return f"{name}()"
        elif isinstance(sub, ast.Attribute):
            if sub.attr in _IDENTITY_ATTRS:
                return f".{sub.attr}"
        elif isinstance(sub, ast.Name):
            if sub.id in _IDENTITY_NAMES:
                return sub.id
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost name of a dotted receiver (``wd`` for ``wd``,
    ``self`` for ``self.watch``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _receiver_key(func: ast.Attribute) -> Optional[str]:
    """Receiver identity for arm/release matching: ``self.watch`` and
    ``wd`` keep their full dotted spelling so distinct carriers on the
    same object do not alias."""
    parts: List[str] = []
    node: ast.AST = func.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# --------------------------------------------------------------------------
# JL030 — collective under a host-identity branch
# --------------------------------------------------------------------------


def _branch_sequence(stmts: Sequence[ast.stmt]) -> List[str]:
    calls: List[ast.Call] = []
    for s in stmts:
        if _is_collective(s):
            calls.append(s)  # pragma: no cover - stmts are not Calls
        calls.extend(c for c in _own_walk(s) if _is_collective(c))
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    return [_terminal_name(c.func) or "?" for c in calls]


def _rule_jl030(linter) -> None:
    for node in ast.walk(linter.mod.tree):
        if not isinstance(node, ast.If):
            continue
        marker = _test_is_identity(node.test)
        if marker is None:
            continue
        body_seq = _branch_sequence(node.body)
        else_seq = _branch_sequence(node.orelse)
        if not body_seq and not else_seq:
            continue
        if body_seq == else_seq:
            continue  # matching-branches exemption: same protocol
        first = (_collectives_in_stmts(node.body)
                 or _collectives_in_stmts(node.orelse))[0]
        name = _terminal_name(first.func)
        linter.flag(
            "JL030", first,
            f"collective '{name}' under a host-identity branch "
            f"(test mentions '{marker}') whose arms issue different "
            f"collective sequences ({body_seq or '[]'} vs "
            f"{else_seq or '[]'}) — hosts on the other arm never join "
            f"this exchange and every peer hangs in it; hoist the "
            f"collective out of the branch or mirror the sequence in "
            f"both arms")


def _collectives_in_stmts(stmts: Sequence[ast.stmt]) -> List[ast.Call]:
    calls: List[ast.Call] = []
    for s in stmts:
        calls.extend(c for c in _own_walk(s) if _is_collective(c))
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    return calls


# --------------------------------------------------------------------------
# JL031 — early bail between collective rounds
# --------------------------------------------------------------------------


class _BailScan:
    """Walk one protocol function's statements tracking governing ifs,
    enclosing loops, and except-handler context."""

    def __init__(self, fn, verdict_names: Set[str]):
        self.fn = fn
        self.verdict_names = verdict_names
        #: (node, kind, in_collective_loop, governed, in_handler)
        self.bails: List[Tuple[ast.stmt, str, bool, bool, bool]] = []
        self._walk(fn.body, ifs=(), loop_coll=False, handler=False)

    def _test_collective(self, test: ast.AST) -> bool:
        for sub in ast.walk(test):
            if _is_collective(sub):
                return True
            if isinstance(sub, ast.Name) and sub.id in self.verdict_names:
                return True
        return False

    def _walk(self, stmts: Sequence[ast.stmt], ifs: tuple,
              loop_coll: bool, handler: bool) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Return):
                self.bails.append((stmt, "return", loop_coll,
                                   any(ifs), handler))
            elif isinstance(stmt, ast.Raise):
                bare = stmt.exc is None  # re-raise: not a new bail
                if not bare:
                    self.bails.append((stmt, "raise", loop_coll,
                                       any(ifs), handler))
            elif isinstance(stmt, ast.Continue):
                self.bails.append((stmt, "continue", loop_coll,
                                   any(ifs), handler))
            if isinstance(stmt, ast.If):
                governed = self._test_collective(stmt.test)
                self._walk(stmt.body, ifs + (governed,), loop_coll,
                           handler)
                self._walk(stmt.orelse, ifs + (governed,), loop_coll,
                           handler)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                has_coll = bool(_collectives_in(stmt))
                self._walk(stmt.body, ifs, loop_coll or has_coll,
                           handler)
                # a loop's else runs after normal exhaustion — past the
                # rounds, not between them
                self._walk(stmt.orelse, ifs, loop_coll, handler)
                continue
            if isinstance(stmt, ast.Try):
                self._walk(stmt.body, ifs, loop_coll, handler)
                for h in stmt.handlers:
                    self._walk(h.body, ifs, loop_coll, True)
                self._walk(stmt.orelse, ifs, loop_coll, handler)
                self._walk(stmt.finalbody, ifs, loop_coll, handler)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._walk(stmt.body, ifs, loop_coll, handler)
                continue


def _rule_jl031(linter) -> None:
    for fn in ast.walk(linter.mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = _collectives_in(fn)
        loops_with_coll = any(
            isinstance(n, (ast.For, ast.AsyncFor, ast.While))
            and _collectives_in(n)
            for n in _own_walk(fn))
        if len(calls) < 2 and not loops_with_coll:
            continue  # not a multi-round protocol function
        # names carrying a collective verdict: `stop = any_flag(...)`
        verdicts: Set[str] = set()
        for n in _own_walk(fn):
            if isinstance(n, ast.Assign) and any(
                    _is_collective(s) for s in ast.walk(n.value)):
                verdicts.update(t.id for t in n.targets
                                if isinstance(t, ast.Name))
        first_l = min(c.lineno for c in calls) if calls else 0
        last_l = max(c.lineno for c in calls) if calls else 0
        for node, kind, in_loop, governed, handler in \
                _BailScan(fn, verdicts).bails:
            if governed or handler:
                continue
            between = first_l < node.lineno < last_l
            if not (in_loop or between):
                continue
            where = ("inside a collective-bearing loop" if in_loop
                     else "between collective rounds")
            linter.flag(
                "JL031", node,
                f"early {kind} {where} of protocol function "
                f"'{fn.name}' on a host-local condition — this host "
                f"skips the next round and every peer hangs in it "
                f"until timeout; make the verdict collective first "
                f"(gate the bail on any_flag/min_int agreement) or "
                f"move the bail outside the protocol")


# --------------------------------------------------------------------------
# JL032 — unbounded wait on a distributed path
# --------------------------------------------------------------------------


def _on_dist_path(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(m in p for m in _DIST_PATH_MARKERS)


def _rule_jl032(linter) -> None:
    for node in ast.walk(linter.mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _WAIT_ATTRS):
            continue
        if node.args:
            continue  # positional timeout (join(t), wait(t), result(t))
        bounded = False
        for kw in node.keywords:
            if kw.arg in _TIMEOUT_KWARGS:
                bounded = not (isinstance(kw.value, ast.Constant)
                               and kw.value.value is None)
        if bounded:
            continue
        linter.flag(
            "JL032", node,
            f"unbounded .{node.func.attr}() on a distributed path — "
            f"a dead peer turns this into a forever-hang that no "
            f"timeout attributes (the zombie-flush class); pass a "
            f"timeout (and handle its expiry), or bound it from the "
            f"caller")


# --------------------------------------------------------------------------
# JL033 — collective inside an exception-swallowing try
# --------------------------------------------------------------------------


def _rule_jl033(linter) -> None:
    for node in ast.walk(linter.mod.tree):
        if not isinstance(node, ast.Try):
            continue
        colls = _collectives_in_stmts(node.body)
        if not colls:
            continue
        name = _terminal_name(colls[0].func)
        for h in node.handlers:
            swallows = not any(
                isinstance(x, ast.Raise)
                for s in h.body for x in ast.walk(s))
            if not swallows:
                continue
            linter.flag(
                "JL033", h,
                f"except handler swallows a failed collective "
                f"('{name}' is inside this try) and continues — this "
                f"host's round counter falls behind its peers and "
                f"every later exchange pairs mismatched rounds; "
                f"re-raise (or escalate to a reconfiguration verdict) "
                f"so the divergence is loud")


# --------------------------------------------------------------------------
# JL034 — armed region without a finally-path release
# --------------------------------------------------------------------------


def _finally_released_roots(fn) -> Set[str]:
    """Receiver keys released (disarm/stop) inside any finally block of
    the function — function-scoped, like threadlint JL022: the
    ``arm(); try: ... finally: stop()`` idiom keeps the arm OUTSIDE
    the try."""
    out: Set[str] = set()
    for n in _own_walk(fn):
        if not isinstance(n, ast.Try):
            continue
        for s in n.finalbody:
            for c in ast.walk(s):
                if (isinstance(c, ast.Call)
                        and isinstance(c.func, ast.Attribute)
                        and c.func.attr in _RELEASE_ATTRS):
                    key = _receiver_key(c.func)
                    if key is not None:
                        out.add(key)
    return out


def _with_context_names(fn) -> Set[str]:
    """Names entered as `with` contexts in the function (the
    ``win = watch.sanctioned() if fresh else nullcontext(); with win:``
    idiom)."""
    out: Set[str] = set()
    for n in _own_walk(fn):
        if isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                if isinstance(item.context_expr, ast.Name):
                    out.add(item.context_expr.id)
    return out


def _rule_jl034(linter) -> None:
    for fn in ast.walk(linter.mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        released = None  # computed lazily: most functions never arm
        with_names = None
        with_exprs = None
        for n in _own_walk(fn):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)):
                continue
            if n.func.attr == _ARM_ATTR:
                if released is None:
                    released = _finally_released_roots(fn)
                key = _receiver_key(n.func)
                if key is not None and key in released:
                    continue
                linter.flag(
                    "JL034", n,
                    f".arm() in '{fn.name}' with no finally-path "
                    f"disarm/stop on the same receiver in the "
                    f"function — an exception mid-region leaks the "
                    f"armed contract and the next slow-but-healthy "
                    f"phase is executed as a stall; release in a "
                    f"finally (arm(); try: ... finally: "
                    f"disarm()/stop())")
            elif n.func.attr == _WINDOW_ATTR:
                if with_names is None:
                    with_names = _with_context_names(fn)
                    with_exprs = {
                        id(item.context_expr)
                        for w in _own_walk(fn)
                        if isinstance(w, (ast.With, ast.AsyncWith))
                        for item in w.items}
                if id(n) in with_exprs:
                    continue  # `with watch.sanctioned():` — scoped
                if _assigned_to_with_name(fn, n, with_names):
                    continue
                linter.flag(
                    "JL034", n,
                    f"sanctioned() window opened in '{fn.name}' "
                    f"outside a `with` — an exception inside the "
                    f"window leaks the shifted compile baseline; use "
                    f"`with watch.sanctioned():` (assigning it to a "
                    f"name later entered by `with` also counts)")


def _assigned_to_with_name(fn, call: ast.Call,
                           with_names: Set[str]) -> bool:
    for n in _own_walk(fn):
        if not isinstance(n, ast.Assign):
            continue
        if any(s is call for s in ast.walk(n.value)):
            return any(isinstance(t, ast.Name) and t.id in with_names
                       for t in n.targets)
    return False


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def run_rules(linter) -> None:
    """Entry point synclint's _Linter calls; duck-typed on (mod, flag)."""
    _rule_jl030(linter)
    _rule_jl031(linter)
    if _on_dist_path(linter.mod.path):
        _rule_jl032(linter)
    _rule_jl033(linter)
    _rule_jl034(linter)
