"""synclint — AST lint of the port for the host-sync and build footguns.

The static half of ``analysis/guards.py``: a ``float()`` on a step's
output stalls the host behind the device every step, a timed span that
never waits for the device measures the launch queue, and a kernel built
at import makes every import pay a compile (and fail without ``nvcc``).
These are textual, so this module finds them in the source of
``dexiraft_tpu_torch/``. Pure stdlib (``ast``): it imports neither torch
nor the package, and the rules of its siblings run with it, loaded by
file path: the sharding contract of ``shardlint.py`` (JL010-JL013), the
lock discipline of ``threadlint.py`` (JL020-JL024) and the collective
divergence of ``distlint.py`` (JL030-JL034).

Rule catalog (each the counterpart of a rule of the JAX package's
``analysis/jaxlint.py``, or the port's own):

  SL001 implicit-fetch  (JL007) ``float()``/``int()``/``bool()`` on, or
                        ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``
                        of, a step's or model's result outside
                        ``guards.fetch``: an implicit device->host sync.
                        Results are the names bound from a call of a
                        ``make_*step`` product, of a parameter or name
                        called ``fn``/``*_fn``/``step``/``*_step``, of
                        ``self.*_fn``, or of a ``model``.
  SL002 loop-sync       (JL008) an unconditional per-iteration host sync
                        (``guards.fetch``, ``torch.cuda.synchronize``,
                        ``.synchronize()``, ``.item()``, ``.cpu()``,
                        ``.tolist()``) inside a ``for``/``while`` of
                        ``train/``, ``eval/``, ``serve/`` or the train,
                        eval and serve CLIs: syncs belong on a cadence
                        (``if step % N == 0``).
  SL003 untimed-span    (JL004) a ``perf_counter()`` span that launches
                        device work (a step or ``fn`` call, an engine's
                        ``stream``/``run_batch``) and reads the timer
                        with no ``torch.cuda.synchronize()``, event or
                        stream wait, or fetch inside the span.
  SL004 kernel-at-import  (the port's lazy-build rule) ``import triton``
                        or a ``cuda_build`` build/load call at module
                        top level: kernels are built inside the function
                        that launches them, never when a module is
                        imported.

The JAX rules with no meaning here: JL001 and JL003 (tracer syncs and
branches: PyTorch runs eagerly, nothing is traced), JL002 (PRNG key
reuse: the port draws from stateful ``torch.Generator``s), JL005 (f64 on
a TPU), JL006 (jit donation) and JL009 (jit in a loop).

Suppression: ``# synclint: disable=SL00X`` (or ``JL0XX``) on the line,
or a reviewed entry in ``analysis/baseline.json``, which matches on
(rule, path, stripped source line) and carries a ``reason``; an entry
that matches nothing is stale and fails the lint.

  python dexiraft_tpu_torch/analysis/synclint.py [--root DIR]

lints the package against its baseline and exits non-zero on a finding
or a stale entry.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib.util
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "SL000": "syntax-error",
    "SL001": "implicit-fetch",
    "SL002": "loop-sync",
    "SL003": "untimed-span",
    "SL004": "kernel-at-import",
}

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load_rule_module(filename: str, modname: str):
    """A sibling rule module, loaded by file path (no package import)."""
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(_HERE, filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_shardlint = _load_rule_module("shardlint.py", "_port_shardlint")
_threadlint = _load_rule_module("threadlint.py", "_port_threadlint")
_distlint = _load_rule_module("distlint.py", "_port_distlint")
for _rules in (_shardlint, _threadlint, _distlint):
    RULES.update(_rules.RULES)

# the explicit host syncs
_SYNC_FUNCS = {"torch.cuda.synchronize",
               "dexiraft_tpu_torch.analysis.guards.fetch", "guards.fetch"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# SL001: conversions and methods that fetch a device value implicitly
_CONVERSIONS = {"float", "int", "bool"}
_FETCH_METHODS = {"item", "tolist", "cpu", "numpy"}
# attribute reads and methods that describe a tensor without reading it
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad", "numel", "dim", "size", "nbytes",
                 "element_size", "data_ptr", "is_floating_point"}
_TIMER_FUNCS = {"time.perf_counter", "time.monotonic", "time.time"}
_ENGINE_METHODS = {"stream", "run_batch"}
_MAKE_STEP_RE = re.compile(r"^make_\w*step$")
_CALLABLE_RE = re.compile(r"^(fn|\w+_fn|step|\w+_step)$")
_MODEL_NAMES = {"model", "RAFT", "create_model"}
_BUILD_CALLS = {"load_library", "build_library", "build_libraries"}
# paths whose loops SL002 holds to a cadence
_LOOP_SCOPE = ("dexiraft_tpu_torch/train/", "dexiraft_tpu_torch/eval/",
               "dexiraft_tpu_torch/serve/")
_LOOP_FILES = ("dexiraft_tpu_torch/train_cli.py",
               "dexiraft_tpu_torch/eval_cli.py",
               "dexiraft_tpu_torch/serve_cli.py")
_DISABLE_RE = re.compile(r"#\s*synclint:\s*disable=([A-Z0-9,\s]+)")

DEFAULT_SUBDIRS = ("dexiraft_tpu_torch",)
BASELINE_PATH = os.path.join(_HERE, "baseline.json")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str  # stripped source line: the baseline's match key

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{RULES[self.rule]}] {self.message}")


class _Module:
    """One module's tree, import aliases and source lines."""

    def __init__(self, tree: ast.Module, src: str, path: str):
        self.tree = tree
        self.path = path
        self.lines = src.splitlines()
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    root = a.name.split(".")[0]
                    self.aliases[a.asname or root] = (
                        a.name if a.asname else root)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")
        # names bound anywhere from a make_*step or model constructor call
        self.step_names: Set[str] = set()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                callee = (self.dotted(node.value.func) or "").split(".")[-1]
                if _MAKE_STEP_RE.match(callee) or callee in _MODEL_NAMES:
                    for t in node.targets:
                        self.step_names.update(_target_names(t))

    def dotted(self, node: ast.AST) -> Optional[str]:
        """A Name/Attribute chain as a dotted path, through the aliases."""
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.dotted(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def suppressed(self, line: int, rule: str) -> bool:
        m = _DISABLE_RE.search(self.snippet(line))
        return bool(m) and rule in m.group(1)


class _Linter:
    def __init__(self, mod: _Module, rules: Optional[Set[str]] = None):
        self.mod = mod
        self.rules = rules or set(RULES)
        self.findings: List[Finding] = []

    def flag(self, rule: str, node: ast.AST, message: str) -> None:
        if rule not in self.rules:
            return
        line = getattr(node, "lineno", 0)
        if self.mod.suppressed(line, rule):
            return
        self.findings.append(Finding(
            rule=rule, path=self.mod.path, line=line,
            col=getattr(node, "col_offset", 0), message=message,
            snippet=self.mod.snippet(line)))

    def run(self) -> List[Finding]:
        tree = self.mod.tree
        self._rule_sl001(tree)
        rel = self.mod.path.replace(os.sep, "/")
        if rel.startswith(_LOOP_SCOPE) or rel in _LOOP_FILES:
            for node in ast.walk(tree):
                if isinstance(node, (ast.For, ast.While)):
                    self._sl002_body(node.body)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._sl003_block(node.body, _device_names(self.mod, node))
        self._rule_sl004(tree.body)
        _shardlint.run_rules(self)  # JL010-JL013
        _threadlint.run_rules(self)  # JL020-JL024
        _distlint.run_rules(self)  # JL030-JL034
        seen = set()
        unique = []
        for f in self.findings:
            k = (f.rule, f.line, f.col, f.message)
            if k not in seen:
                seen.add(k)
                unique.append(f)
        return unique

    # ---- SL001 -----------------------------------------------------------

    def _rule_sl001(self, tree: ast.AST) -> None:
        scopes = [tree] + [n for n in ast.walk(tree)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
        for scope in scopes:
            callables = _device_names(self.mod, scope)
            values: Set[str] = set()
            for stmt in _own_statements(scope):
                if (isinstance(stmt, ast.Assign)
                        and isinstance(stmt.value, ast.Call)
                        and _is_device_call(self.mod, stmt.value, callables)):
                    for t in stmt.targets:
                        values.update(_target_names(t))
            for stmt in _own_statements(scope):
                for node in _walk_own(stmt):
                    if isinstance(node, ast.Call):
                        self._sl001_call(node, callables, values)

    def _sl001_call(self, node: ast.Call, callables: Set[str],
                    values: Set[str]) -> None:
        callee = self.mod.dotted(node.func)
        if callee in _CONVERSIONS and node.args:
            arg = node.args[0]
            what = f"{callee}()"
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _FETCH_METHODS and not node.args):
            arg = node.func.value
            what = f".{node.func.attr}()"
        else:
            return
        if (isinstance(arg, ast.Call)
                and _is_device_call(self.mod, arg, callables)):
            self.flag("SL001", node,
                      f"{what} directly on a step's or model's result: an "
                      f"implicit device->host sync; fetch it with "
                      f"guards.fetch(...) so the sync is explicit and "
                      f"passes strict_mode")
            return
        root = _value_root(arg)
        if root in values:
            self.flag("SL001", node,
                      f"{what} on '{root}' (a step's or model's result): "
                      f"an implicit device->host sync; use "
                      f"guards.fetch(...)")

    # ---- SL002 -----------------------------------------------------------

    def _sl002_body(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.If, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # a cadence-gated sync is the sanctioned shape
            if isinstance(stmt, (ast.For, ast.While)):
                continue  # the nested loop is visited on its own
            for node in _walk_own(stmt, skip=(ast.If, ast.IfExp,
                                              ast.Lambda)):
                if isinstance(node, ast.Call) and self._is_sync(node):
                    label = (self.mod.dotted(node.func)
                             or f".{node.func.attr}()")
                    self.flag("SL002", node,
                              f"unconditional per-iteration host sync "
                              f"({label}) in a train/eval/serve loop: "
                              f"gate it on a cadence (`if step % N == "
                              f"0`)")

    def _is_sync(self, node: ast.Call) -> bool:
        if self.mod.dotted(node.func) in _SYNC_FUNCS:
            return True
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS and not node.args
                and not _static_receiver(node.func.value))

    # ---- SL003 -----------------------------------------------------------

    def _sl003_block(self, stmts: Sequence[ast.stmt],
                     callables: Set[str]) -> None:
        opens: Dict[str, Tuple[int, ast.stmt]] = {}
        for i, stmt in enumerate(stmts):
            closed = set()
            for node in ast.walk(stmt):
                if (isinstance(node, ast.BinOp)
                        and isinstance(node.op, ast.Sub)
                        and isinstance(node.right, ast.Name)
                        and node.right.id in opens
                        and isinstance(node.left, ast.Call)
                        and self.mod.dotted(node.left.func) in _TIMER_FUNCS):
                    closed.add(node.right.id)
            for name in closed:
                start, open_stmt = opens.pop(name)
                span = list(stmts[start + 1:i])
                if (span and self._launches(span, callables)
                        and not self._span_syncs(span + [stmt])):
                    self.flag("SL003", open_stmt,
                              f"timed span ('{name}', read line "
                              f"{stmt.lineno}) launches device work but "
                              f"never waits for it: add "
                              f"torch.cuda.synchronize(), an event wait or "
                              f"a fetch inside the span")
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)
                    and self.mod.dotted(stmt.value.func) in _TIMER_FUNCS):
                opens[stmt.targets[0].id] = (i, stmt)
            for blk in _sub_blocks(stmt):
                self._sl003_block(blk, callables)

    def _launches(self, stmts: Iterable[ast.stmt],
                  callables: Set[str]) -> bool:
        for stmt in stmts:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                if _is_device_call(self.mod, node, callables):
                    return True
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in _ENGINE_METHODS
                        and "engine" in (_value_root(f.value) or "")):
                    return True
        return False

    def _span_syncs(self, stmts: Iterable[ast.stmt]) -> bool:
        for stmt in stmts:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) and (
                        self._is_sync(node)
                        or self.mod.dotted(node.func) in _CONVERSIONS
                        or (isinstance(node.func, ast.Attribute)
                            and node.func.attr == "elapsed_time")):
                    return True
        return False

    # ---- SL004 -----------------------------------------------------------

    def _rule_sl004(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    if a.name.split(".")[0] == "triton":
                        self.flag("SL004", stmt,
                                  "import triton at module top level: "
                                  "import it inside the function that "
                                  "launches the kernel")
            elif (isinstance(stmt, ast.ImportFrom) and stmt.module
                  and stmt.module.split(".")[0] == "triton"):
                self.flag("SL004", stmt,
                          "from triton import ... at module top level: "
                          "import it inside the function that launches "
                          "the kernel")
            else:
                for node in _walk_own(stmt):
                    if isinstance(node, ast.Call):
                        callee = self.mod.dotted(node.func) or ""
                        if (callee.split(".")[-1] in _BUILD_CALLS
                                or callee == "torch.utils.cpp_extension.load"):
                            self.flag("SL004", node,
                                      f"{callee}() at module top level: "
                                      f"build kernels at first use, never "
                                      f"at import")
            for blk in _sub_blocks(stmt, classes=True):
                self._rule_sl004(blk)


# ---- AST utilities --------------------------------------------------------

def _device_names(mod: _Module, scope: ast.AST) -> Set[str]:
    """Names that dispatch device work when called in ``scope``: names
    bound from a ``make_*step``/model constructor call anywhere in the
    module, and the scope's parameters named like a step or a model."""
    out = set(mod.step_names)
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = scope.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if _CALLABLE_RE.match(p.arg) or p.arg == "model":
                out.add(p.arg)
    return out


def _is_device_call(mod: _Module, call: ast.Call, callables: Set[str]) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in callables
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id == "self"):
        return bool(_CALLABLE_RE.match(f.attr)) or f.attr == "model"
    return False


def _static_receiver(node: ast.AST) -> bool:
    """True for x.shape[...]-style reads (no device value is read)."""
    while isinstance(node, (ast.Subscript, ast.Attribute, ast.Call)):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return True
        node = node.func if isinstance(node, ast.Call) else node.value
    return False


def _value_root(node: ast.AST) -> Optional[str]:
    """The name a subscript/attribute/method chain reads, None for a
    static read (``x.shape``) or anything else."""
    if _static_receiver(node):
        return None
    while isinstance(node, (ast.Subscript, ast.Attribute, ast.Starred,
                            ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _target_names(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in node.elts:
            out.extend(_target_names(e))
        return out
    if isinstance(node, ast.Starred):
        return _target_names(node.value)
    return []


def _walk_own(node: ast.AST, skip: tuple = ()) -> Iterable[ast.AST]:
    """ast.walk that does not enter nested functions, lambdas, classes or
    the ``skip`` node types."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef) + skip):
                continue
            stack.append(child)


def _sub_blocks(stmt: ast.stmt, classes: bool = False) -> List[List[ast.stmt]]:
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    if isinstance(stmt, ast.ClassDef) and not classes:
        return []
    blocks = []
    for attr in ("body", "orelse", "finalbody"):
        blk = getattr(stmt, attr, None)
        if isinstance(blk, list) and blk and isinstance(blk[0], ast.stmt):
            blocks.append(blk)
    for h in getattr(stmt, "handlers", []) or []:
        blocks.append(h.body)
    return blocks


def _own_statements(scope: ast.AST) -> List[ast.stmt]:
    """The statements of ``scope``, nested function bodies excluded."""
    out: List[ast.stmt] = []

    def collect(stmts: Sequence[ast.stmt]) -> None:
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            out.append(s)
            for blk in _sub_blocks(s):
                collect(blk)

    collect(scope.body)
    return out


# ---- public API -----------------------------------------------------------

def lint_source(src: str, path: str = "<string>",
                rules: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one module's source; ``path`` is repo-relative with forward
    slashes (SL002 scopes on it)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(rule="SL000", path=path, line=e.lineno or 0,
                        col=e.offset or 0, message=f"syntax error: {e.msg}",
                        snippet="")]
    return _Linter(_Module(tree, src, path), rules).run()


@dataclasses.dataclass
class Baseline:
    """``analysis/baseline.json``'s ``allow`` list: reviewed findings
    matched on (rule, path, stripped line), each with its ``reason``."""

    allow: List[dict] = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, path: str = BASELINE_PATH) -> "Baseline":
        with open(path, encoding="utf-8") as f:
            return cls(allow=list(json.load(f).get("allow", [])))

    def split(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """(kept, allowed, stale entries)."""
        keys = {(e.get("rule"), e.get("path"), e.get("snippet")): e
                for e in self.allow}
        used = set()
        kept, allowed = [], []
        for f in findings:
            if f.key() in keys:
                allowed.append(f)
                used.add(f.key())
            else:
                kept.append(f)
        return kept, allowed, [e for k, e in keys.items() if k not in used]


def iter_py_files(root: str, subdirs: Sequence[str] = DEFAULT_SUBDIRS
                  ) -> Iterable[Tuple[str, str]]:
    """(abspath, repo-relative posix path) of every .py under the subdirs,
    sorted."""
    for sub in subdirs:
        for dirpath, dirnames, filenames in os.walk(os.path.join(root, sub)):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    ab = os.path.join(dirpath, name)
                    yield ab, os.path.relpath(ab, root).replace(os.sep, "/")


def lint_tree(root: str, subdirs: Sequence[str] = DEFAULT_SUBDIRS,
              baseline: Optional[Baseline] = None,
              rules: Optional[Set[str]] = None):
    """(kept, allowed, stale entries, files linted) over the tree."""
    findings: List[Finding] = []
    n_files = 0
    for ab, rel in iter_py_files(root, subdirs):
        n_files += 1
        with open(ab, encoding="utf-8") as f:
            findings.extend(lint_source(f.read(), rel, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if baseline is None:
        return findings, [], [], n_files
    kept, allowed, stale = baseline.split(findings)
    return kept, allowed, stale, n_files


def main(argv=None) -> int:
    p = argparse.ArgumentParser("synclint")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)),
                   help="the repository root (default: this checkout)")
    p.add_argument("--baseline", default=BASELINE_PATH)
    args = p.parse_args(argv)
    kept, allowed, stale, n = lint_tree(args.root,
                                        baseline=Baseline.load(args.baseline))
    for f in kept:
        print(f)
    for e in stale:
        print(f"stale baseline entry (matches nothing): {json.dumps(e)}")
    print(f"synclint: {n} files, {len(kept)} finding(s), {len(allowed)} "
          f"baselined, {len(stale)} stale")
    return 1 if kept or stale else 0


if __name__ == "__main__":
    sys.exit(main())
