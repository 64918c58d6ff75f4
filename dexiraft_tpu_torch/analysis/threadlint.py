"""threadlint — the lock-discipline rules (JL020-JL024) over the port.

A copy of ``dexiraft_tpu/analysis/threadlint.py`` (pure ``ast``; the port
may not import the JAX package), with the rule ids kept, since the rules
are the same. The serving tier, the router and the trainer are a thread
fabric (handler threads, one dispatcher, the DeviceThreads, health,
supervisor, flush and watchdog threads), and its races are textual: an
unlocked ``+=`` on a counter other code updates under a lock, a manual
``acquire()`` with no ``finally``, a sleep under a lock, a nesting of
two locks the order does not declare. The runtime half (inverted
nestings, held spans) is ``serve/locks.py``'s :class:`OrderedLock`.

Rule catalog:

  JL020 unlocked-shared-write   plain write to a shared ``self.X`` that
                            the class protects under a lock elsewhere,
                            outside any ``with self._lock`` block.
  JL021 unlocked-rmw        read-modify-write (``self.x += n``,
                            ``self.d[k] = ...``, ``self.q.append``/
                            ``pop``/``update``/...) on a lock-protected
                            attr without the lock held.
  JL022 manual-lock-acquire ``.acquire()`` on a lock attr with no
                            try-finally ``.release()`` in the function.
  JL023 blocking-under-lock a blocking call (sleep, subprocess,
                            urlopen, ``Thread.join``, ``Event.wait``,
                            future ``.result``, ``getresponse``,
                            ``torch.cuda.synchronize``, an event's or
                            stream's ``.synchronize()``, and the JAX
                            package's ``jax.device_get``/
                            ``block_until_ready``) while a lock is held.
                            ``cv.wait`` on the held condition is exempt.
  JL024 undeclared-lock-order   nested lock acquisition whose
                            (outer, inner) pair is not declared: both
                            locks must carry names from ``LOCK_ORDER``
                            (``serve/locks.py``), outer first.

Scope: JL020/21 run only inside classes that own a lock, and only on
attrs the class mutates under that lock somewhere; ``__init__`` never
counts. A helper whose every intra-class call site sits inside a
``with``-lock block is treated as lock-held (a fixpoint). One level of
``name = self.attr`` aliasing is resolved. Cross-object state is out of
static reach; the OrderedLock runtime covers it.

``synclint.py`` loads this module by file path, so its gate, its
baseline and ``# synclint: disable=JL02X`` suppression cover these rules.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULES = {
    "JL020": "unlocked-shared-write",
    "JL021": "unlocked-rmw",
    "JL022": "manual-lock-acquire",
    "JL023": "blocking-under-lock",
    "JL024": "undeclared-lock-order",
}

#: Mirror of the port's declared lock order (serve/locks.py LOCK_ORDER).
#: This module imports nothing of the package (synclint loads it by file
#: path), so the names are pinned here and tests/test_torch_lint.py
#: asserts they equal the live registry's.
LOCK_ORDER: Tuple[str, ...] = (
    "serve.video.chunk",
    "serve.server.stop",
    "serve.scheduler.cv",
    "serve.router.supervisor",
    "serve.router.autoscale",
    "serve.router.pool",
    "serve.router.inflight",
    "serve.router.stats",
    "serve.video.inflight",
    "serve.video.stats",
    "serve.sessions.store",
    "serve.sessions.device",
    "analysis.guards.watch",
    "analysis.guards.listener",
    "resilience.watchdog.armed",
    "train.checkpoint.pending",
    "data.loader.pool",
    "resilience.trace.ring",
)
_RANK = {name: i for i, name in enumerate(LOCK_ORDER)}

# dotted names (post alias-resolution) that construct a lock
_LOCK_CTORS = {
    "threading.Lock", "threading.RLock", "Lock", "RLock",
    "OrderedLock", "locks.OrderedLock",
    "dexiraft_tpu.analysis.locks.OrderedLock",
    "dexiraft_tpu_torch.serve.locks.OrderedLock",
}
_CV_CTORS = {"threading.Condition", "Condition"}
_THREAD_CTORS = {"threading.Thread", "Thread"}
# container/dict/deque methods that mutate their receiver in place
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "move_to_end",
}
# calls that block the calling thread (JL023)
_BLOCKING_DOTTED = {
    "time.sleep", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "urllib.request.urlopen", "socket.create_connection",
    "jax.device_get", "jax.block_until_ready", "torch.cuda.synchronize",
}
_BLOCKING_ATTRS = {
    "sleep", "wait", "result", "getresponse", "urlopen",
    "block_until_ready", "recv", "accept", "connect", "join",
    "synchronize",
}


# --------------------------------------------------------------------------
# lock-carrier discovery
# --------------------------------------------------------------------------


def _lock_decl(linter, value: ast.AST) -> Optional[Tuple[bool, Optional[str]]]:
    """(is_lock, declared_name) when `value` constructs a lock:
    threading.Lock/RLock (name None), OrderedLock("name", ...), or a
    Condition over either. None when it is not a lock construction."""
    if not isinstance(value, ast.Call):
        return None
    callee = linter.mod.dotted(value.func)
    if callee in _LOCK_CTORS:
        name = None
        if (callee.split(".")[-1] == "OrderedLock" and value.args
                and isinstance(value.args[0], ast.Constant)
                and isinstance(value.args[0].value, str)):
            name = value.args[0].value
        return True, name
    if callee in _CV_CTORS:
        if value.args:
            inner = _lock_decl(linter, value.args[0])
            if inner is not None:
                return inner
        return True, None   # Condition() over its default RLock
    return None


def _class_locks(linter, cls: ast.ClassDef) -> Dict[str, Optional[str]]:
    """self-attr name -> declared OrderedLock name (None when the attr
    holds an anonymous threading lock)."""
    out: Dict[str, Optional[str]] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        decl = _lock_decl(linter, node.value)
        if decl is None:
            continue
        for t in node.targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                out[t.attr] = decl[1]
    return out


def _module_locks(linter) -> Dict[str, Optional[str]]:
    """Module-global lock name -> declared OrderedLock name."""
    out: Dict[str, Optional[str]] = {}
    for node in linter.mod.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        decl = _lock_decl(linter, node.value)
        if decl is None:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = decl[1]
    return out


def _thread_attrs(linter, cls: ast.ClassDef) -> Set[str]:
    """self attrs assigned a threading.Thread (JL023's join targets)."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and linter.mod.dotted(node.value.func) in _THREAD_CTORS):
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    out.add(t.attr)
    return out


# --------------------------------------------------------------------------
# per-function scan
# --------------------------------------------------------------------------

# carrier key: ("self", attr) for self.<attr>, ("mod", name) for a
# module-global lock


def _carrier(node: ast.AST, self_locks: Dict[str, Optional[str]],
             module_locks: Dict[str, Optional[str]],
             aliases: Dict[str, str]):
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)):
        if node.value.id == "self" and node.attr in self_locks:
            return ("self", node.attr)
    if isinstance(node, ast.Name):
        if node.id in module_locks:
            return ("mod", node.id)
        attr = aliases.get(node.id)
        if attr is not None and attr in self_locks:
            return ("self", attr)
    return None


def _self_root(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """First attribute after `self` for a self.X[..].Y target/receiver,
    resolving one level of ``name = self.attr`` aliasing."""
    chain: List[str] = []
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        if isinstance(node, ast.Attribute):
            chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        if node.id == "self":
            return chain[-1] if chain else None
        return aliases.get(node.id)
    return None


class _Mutation:
    __slots__ = ("root", "rmw", "locked", "node", "op", "method")

    def __init__(self, root, rmw, locked, node, op, method):
        self.root = root
        self.rmw = rmw
        self.locked = locked
        self.node = node
        self.op = op
        self.method = method


class _FnScan:
    """One pass over a function body tracking the held-lock stack."""

    def __init__(self, linter, fn, self_locks, module_locks, thread_attrs,
                 method_names: Set[str]):
        self.linter = linter
        self.fn = fn
        self.self_locks = self_locks
        self.module_locks = module_locks
        self.thread_attrs = thread_attrs
        self.method_names = method_names
        self.aliases: Dict[str, str] = {}
        self.thread_vars: Set[str] = set()
        self.mutations: List[_Mutation] = []
        self.calls: List[Tuple[str, bool]] = []      # (callee, locked)
        self.blocking: List[Tuple[ast.Call, bool, str]] = []
        self.acquires: Dict[tuple, List[ast.Call]] = {}
        self.released_in_finally: Set[tuple] = set()
        self.pairs: List[Tuple[tuple, tuple, ast.AST]] = []
        self._walk(fn.body, held=())

    # ---- statement walk -------------------------------------------------

    def _walk(self, stmts: Sequence[ast.stmt], held: tuple) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue   # fresh scope
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    key = _carrier(item.context_expr, self.self_locks,
                                   self.module_locks, self.aliases)
                    if key is not None:
                        for outer in inner:
                            self.pairs.append((outer, key,
                                               item.context_expr))
                        inner = inner + (key,)
                    else:
                        self._scan_expr(item.context_expr, held)
                self._walk(stmt.body, inner)
                continue
            if isinstance(stmt, ast.Try):
                for key in self._finally_releases(stmt):
                    self.released_in_finally.add(key)
            self._scan_stmt_exprs(stmt, held)
            if isinstance(stmt, (ast.Assign, ast.AugAssign)):
                self._note_assignment(stmt, held)
            for blk in self._stmt_blocks(stmt):
                self._walk(blk, held)

    @staticmethod
    def _stmt_blocks(stmt: ast.stmt) -> List[List[ast.stmt]]:
        blocks = []
        for attr in ("body", "orelse", "finalbody"):
            blk = getattr(stmt, attr, None)
            if isinstance(blk, list) and blk and isinstance(blk[0], ast.stmt):
                blocks.append(blk)
        for h in getattr(stmt, "handlers", []) or []:
            blocks.append(h.body)
        return blocks

    def _finally_releases(self, stmt: ast.Try) -> List[tuple]:
        out = []
        for s in stmt.finalbody:
            for node in ast.walk(s):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "release"):
                    key = _carrier(node.func.value, self.self_locks,
                                   self.module_locks, self.aliases)
                    if key is not None:
                        out.append(key)
        return out

    # ---- expression scan ------------------------------------------------

    def _scan_stmt_exprs(self, stmt: ast.stmt, held: tuple) -> None:
        """Scan the statement's own expressions (not nested stmt lists)
        for calls: blocking-under-lock, intra-class calls, manual
        acquires, and in-place mutator calls."""
        for field, value in ast.iter_fields(stmt):
            values = value if isinstance(value, list) else [value]
            for v in values:
                if isinstance(v, ast.expr):
                    self._scan_expr(v, held)

    def _scan_expr(self, expr: ast.AST, held: tuple) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # intra-class call (the lock-held-helper fixpoint input)
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"
                    and f.attr in self.method_names):
                self.calls.append((f.attr, bool(held)))
            # manual acquire on a lock carrier
            if isinstance(f, ast.Attribute) and f.attr == "acquire":
                key = _carrier(f.value, self.self_locks,
                               self.module_locks, self.aliases)
                if key is not None:
                    self.acquires.setdefault(key, []).append(node)
            # in-place mutator on a self-rooted container
            if (isinstance(f, ast.Attribute) and f.attr in _MUTATORS):
                root = _self_root(f.value, self.aliases)
                if root is not None and root not in self.self_locks:
                    self.mutations.append(_Mutation(
                        root, True, bool(held), node,
                        f".{f.attr}()", self.fn.name))
            # blocking call while a lock is held
            if held:
                self._note_blocking(node, held)
            elif self._is_blocking(node, held):
                # recorded unbound: flagged later iff the whole method
                # proves lock-held via the call-graph fixpoint
                self.blocking.append((node, False, self._blocking_label(node)))

    def _is_blocking(self, node: ast.Call, held: tuple) -> bool:
        f = node.func
        dotted = self.linter.mod.dotted(f)
        if dotted in _BLOCKING_DOTTED:
            return True
        if isinstance(f, ast.Attribute) and f.attr in _BLOCKING_ATTRS:
            if f.attr == "join" and not self._threadish(f.value):
                return False   # str.join / os.path.join
            if f.attr == "wait":
                key = _carrier(f.value, self.self_locks,
                               self.module_locks, self.aliases)
                if key is not None and (key in held or not held):
                    # cv.wait on the held condition RELEASES while
                    # waiting — the one sanctioned blocking wait
                    return False
            return True
        return False

    def _blocking_label(self, node: ast.Call) -> str:
        dotted = self.linter.mod.dotted(node.func)
        if dotted in _BLOCKING_DOTTED:
            return dotted
        return f".{node.func.attr}()"

    def _note_blocking(self, node: ast.Call, held: tuple) -> None:
        if self._is_blocking(node, held):
            self.blocking.append((node, True, self._blocking_label(node)))

    def _threadish(self, recv: ast.AST) -> bool:
        root = _self_root(recv, self.aliases)
        if root is not None and root in self.thread_attrs:
            return True
        return isinstance(recv, ast.Name) and recv.id in self.thread_vars

    # ---- assignments ----------------------------------------------------

    def _note_assignment(self, stmt, held: tuple) -> None:
        locked = bool(held)
        if isinstance(stmt, ast.AugAssign):
            root = _self_root(stmt.target, self.aliases)
            if root is not None and root not in self.self_locks:
                op = type(stmt.op).__name__
                self.mutations.append(_Mutation(
                    root, True, locked, stmt, f"aug-assign ({op})",
                    self.fn.name))
            return
        # plain Assign: aliases, thread vars, then target mutations
        if isinstance(stmt.value, ast.Call):
            callee = self.linter.mod.dotted(stmt.value.func)
            if callee in _THREAD_CTORS:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.thread_vars.add(t.id)
        for t in stmt.targets:
            if (isinstance(t, ast.Name)
                    and isinstance(stmt.value, ast.Attribute)
                    and isinstance(stmt.value.value, ast.Name)
                    and stmt.value.value.id == "self"):
                self.aliases[t.id] = stmt.value.attr
        for t in stmt.targets:
            targets = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    continue
                root = _self_root(tgt, self.aliases)
                if root is None or root in self.self_locks:
                    continue
                rmw = isinstance(tgt, ast.Subscript)
                self.mutations.append(_Mutation(
                    root, rmw, locked, stmt,
                    "subscript-store" if rmw else "attribute write",
                    self.fn.name))


# --------------------------------------------------------------------------
# class-level analysis
# --------------------------------------------------------------------------


def _lockheld_fixpoint(scans: Dict[str, _FnScan]
                       ) -> Tuple[Set[str], Set[str]]:
    """(always_locked, sometimes_locked) method sets, by intra-class
    call-site analysis (the ``_sweep`` idiom, as a fixpoint).

    always_locked: EVERY call site is lock-held (directly or via
    another always-locked method) — the method's mutations are
    sanctioned. sometimes_locked: >= 1 call site is lock-held — the
    method's mutations still ESTABLISH the protection contract (the
    class does lock this state), so a method that is also reachable
    unlocked gets flagged rather than silently untracked. A method
    with no intra-class call sites is neither (it is API)."""
    sites: Dict[str, List[Tuple[str, bool]]] = {}
    for caller, scan in scans.items():
        for callee, locked in scan.calls:
            sites.setdefault(callee, []).append((caller, locked))
    always: Set[str] = set()
    sometimes: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name in scans:
            if name == "__init__":
                continue
            callers = sites.get(name)
            if not callers:
                continue
            if name not in always and all(
                    locked or c in always for c, locked in callers):
                always.add(name)
                changed = True
            if name not in sometimes and any(
                    locked or c in sometimes for c, locked in callers):
                sometimes.add(name)
                changed = True
    return always, sometimes | always


def _check_class(linter, cls: ast.ClassDef,
                 module_locks: Dict[str, Optional[str]]) -> None:
    self_locks = _class_locks(linter, cls)
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    if not self_locks:
        # no lock, no contract: single-threaded classes (and ones whose
        # callers own the locking) stay out of JL020/21's reach
        return
    thread_attrs = _thread_attrs(linter, cls)
    scans = {name: _FnScan(linter, fn, self_locks, module_locks,
                           thread_attrs, set(methods))
             for name, fn in methods.items()}
    lockheld, sometimes_locked = _lockheld_fixpoint(scans)

    # tracked attrs: mutated under a lock somewhere in the class —
    # that locked site IS the class's declared protection contract
    # (sometimes_locked is deliberately the wider set: a helper with a
    # single locked call site still declares the contract, and its
    # OTHER, unlocked reachability is then the finding)
    tracked: Dict[str, str] = {}
    for name, scan in scans.items():
        if name == "__init__":
            continue
        for m in scan.mutations:
            if ((m.locked or name in sometimes_locked)
                    and m.root not in tracked):
                tracked[m.root] = name
    for name, scan in scans.items():
        if name == "__init__":
            continue
        for m in scan.mutations:
            if m.locked or name in lockheld or m.root not in tracked:
                continue
            lock_names = ", ".join(f"self.{a}" for a in sorted(self_locks))
            if m.rmw:
                linter.flag(
                    "JL021", m.node,
                    f"read-modify-write of shared 'self.{m.root}' "
                    f"({m.op}) in {cls.name}.{name} without the lock — "
                    f"the class protects this attr under a lock in "
                    f"{cls.name}.{tracked[m.root]}; concurrent updates "
                    f"lose increments (the RouterStats undercount bug "
                    f"class). Hold {lock_names} here")
            else:
                linter.flag(
                    "JL020", m.node,
                    f"write to shared 'self.{m.root}' in "
                    f"{cls.name}.{name} without the lock — the class "
                    f"protects this attr under a lock in "
                    f"{cls.name}.{tracked[m.root]}, so this write races "
                    f"every locked reader. Hold {lock_names} here")
        _flag_fn_common(linter, cls.name, scan,
                        whole_fn_locked=scan.fn.name in lockheld,
                        self_locks=self_locks, module_locks=module_locks)


def _flag_fn_common(linter, owner: str, scan: _FnScan, *,
                    whole_fn_locked: bool,
                    self_locks: Dict[str, Optional[str]],
                    module_locks: Dict[str, Optional[str]]) -> None:
    """JL022/JL023/JL024 for one scanned function."""
    # JL022: manual acquire with no try-finally release in the function
    for key, nodes in scan.acquires.items():
        if key in scan.released_in_finally:
            continue
        label = key[1] if key[0] == "mod" else f"self.{key[1]}"
        for node in nodes:
            linter.flag(
                "JL022", node,
                f"manual {label}.acquire() in {owner}.{scan.fn.name} "
                f"with no try-finally release in the function — an "
                f"exception between acquire and release wedges every "
                f"other thread on this lock; use `with {label}:` (or "
                f"release in a finally)")
    # JL023: blocking calls under a held lock (or in a provably
    # lock-held helper)
    for node, held, label in scan.blocking:
        if not held and not whole_fn_locked:
            continue
        linter.flag(
            "JL023", node,
            f"blocking call {label} in {owner}.{scan.fn.name} while a "
            f"lock is held — every thread queueing on that lock stalls "
            f"behind this wait; move the blocking work outside the "
            f"locked region (snapshot under the lock, block after)")
    # JL024: nested acquisition pairs vs the declared order
    for outer, inner, node in scan.pairs:
        o_name = (module_locks if outer[0] == "mod"
                  else self_locks).get(outer[1])
        i_name = (module_locks if inner[0] == "mod"
                  else self_locks).get(inner[1])
        o_lbl = outer[1] if outer[0] == "mod" else f"self.{outer[1]}"
        i_lbl = inner[1] if inner[0] == "mod" else f"self.{inner[1]}"
        if o_name is None or i_name is None:
            anon = o_lbl if o_name is None else i_lbl
            linter.flag(
                "JL024", node,
                f"nested lock acquisition {o_lbl} -> {i_lbl} in "
                f"{owner}.{scan.fn.name}, but {anon} is an anonymous "
                f"lock — nested locks must be OrderedLocks named in "
                f"the central LOCK_ORDER registry (serve/locks.py) "
                f"so the pair's order is declared and runtime-checked")
            continue
        if o_name not in _RANK or i_name not in _RANK:
            missing = o_name if o_name not in _RANK else i_name
            linter.flag(
                "JL024", node,
                f"nested lock acquisition '{o_name}' -> '{i_name}' in "
                f"{owner}.{scan.fn.name}, but '{missing}' is not in "
                f"the LOCK_ORDER registry (serve/locks.py) — "
                f"declare it so the pair participates in the total "
                f"order")
            continue
        if _RANK[o_name] >= _RANK[i_name]:
            linter.flag(
                "JL024", node,
                f"nested lock acquisition '{o_name}' (rank "
                f"{_RANK[o_name]}) -> '{i_name}' (rank "
                f"{_RANK[i_name]}) in {owner}.{scan.fn.name} inverts "
                f"the declared LOCK_ORDER — another path nesting these "
                f"in registry order would ABBA-deadlock against this "
                f"one")


def _check_module_functions(linter,
                            module_locks: Dict[str, Optional[str]]) -> None:
    """JL022/23/24 for module-level functions using module-global locks
    (the train/checkpoint.py shape). JL020/21 stay class-scoped: module
    globals have no single owning lock contract to infer."""
    if not module_locks:
        return
    for node in linter.mod.tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scan = _FnScan(linter, node, {}, module_locks, set(), set())
        _flag_fn_common(linter, "<module>", scan, whole_fn_locked=False,
                        self_locks={}, module_locks=module_locks)


def run_rules(linter) -> None:
    """Entry point synclint._Linter calls; duck-typed on (mod, flag)."""
    module_locks = _module_locks(linter)
    for node in ast.walk(linter.mod.tree):
        if isinstance(node, ast.ClassDef):
            _check_class(linter, node, module_locks)
    _check_module_functions(linter, module_locks)
