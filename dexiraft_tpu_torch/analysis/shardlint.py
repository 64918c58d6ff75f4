"""shardlint — the sharding-contract rules (JL010-JL013) over the port.

The port's counterpart of ``dexiraft_tpu/analysis/shardlint.py``, with
JAX's rule numbers and their PyTorch meaning. In JAX the canonical
layout (``parallel/layout.py``) owns every mesh and PartitionSpec; in
the port a mesh is a process group and its subgroups, and the layout
(``parallel/layout.py``, with ``parallel/distributed.py`` building the
groups) owns them the same way. What breaks that contract is textual:

  JL010 adhoc-process-group    a process group built (``new_group``,
                               ``init_process_group``, a ``DeviceMesh``)
                               outside ``parallel/distributed.py`` and
                               ``parallel/layout.py``: a group the mesh
                               does not know runs collectives the
                               placement audit cannot account for.
  JL011 adhoc-mesh-axis        an ``FsdpMesh``/``MeshAxis`` built outside
                               ``parallel/layout.py``, or a mesh-axis
                               name spelled as a string literal
                               ('data', 'fsdp', 'seq') passed to a mesh
                               or collective API: axis names come from
                               the layout's constants.
  JL012 raw-rank-literal       a rank literal compared to
                               ``get_rank()`` or ``.rank`` (``== 0``)
                               outside ``parallel/`` and
                               ``resilience/coord.py``: which rank
                               writes is the layout's decision
                               (``World.is_writer``), not each site's.
  JL013 ungrouped-mesh-collective  inside a function with a ``mesh``
                               parameter (a step factory), a
                               ``torch.distributed`` collective with
                               no ``group=``, outside
                               the ``if mesh is None`` branch: it runs
                               over every rank of the world, not the
                               mesh axis's subgroup.

:data:`LAYOUT_AXES` mirrors ``parallel.layout.LAYOUT_AXES`` (this module
imports nothing of the package; a test holds the two equal). Pure
stdlib; ``analysis/synclint.py`` loads it by file path, so its rules
share synclint's CLI, ``# synclint: disable=JL01X`` and
``analysis/baseline.json``.
"""

from __future__ import annotations

import ast
from typing import List, Tuple

RULES = {
    "JL010": "adhoc-process-group",
    "JL011": "adhoc-mesh-axis",
    "JL012": "raw-rank-literal",
    "JL013": "ungrouped-mesh-collective",
}

#: The modules that own the mesh: the layout, and the process-group
#: plumbing it calls.
LAYOUT_PATH = "dexiraft_tpu_torch/parallel/layout.py"
GROUP_PATHS = (LAYOUT_PATH, "dexiraft_tpu_torch/parallel/distributed.py")
#: where rank literals belong (JL012)
RANK_PATHS = ("dexiraft_tpu_torch/parallel/",
              "dexiraft_tpu_torch/resilience/coord.py")

#: Mirror of parallel.layout.LAYOUT_AXES.
LAYOUT_AXES = frozenset({"data", "fsdp", "seq"})

_GROUP_CTORS = {"new_group", "new_subgroups", "init_process_group",
                "DeviceMesh", "init_device_mesh"}
_MESH_CTORS = {"FsdpMesh", "MeshAxis"}
#: mesh and collective APIs whose string arguments name axes (JL011)
_AXIS_APIS = _MESH_CTORS | _GROUP_CTORS | {
    "make_train_mesh", "virtual_mesh", "mesh_groups", "all_reduce",
    "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
    "broadcast", "barrier", "all_gather_flat", "halo_exchange",
    "ring_corr_lookup", "context_parallel_corr"}
_AXIS_KEYWORDS = {"axis", "axis_name", "axis_names", "mesh_axes",
                  "mesh_dim_names"}
#: torch.distributed's collectives (JL013)
_DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "reduce_scatter", "broadcast", "barrier",
    "reduce", "gather", "scatter", "all_to_all", "all_to_all_single",
    "all_gather_object", "broadcast_object_list", "send", "recv",
    "isend", "irecv", "monitored_barrier"}


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _terminal(linter, func: ast.AST) -> str:
    return (linter.mod.dotted(func) or "").split(".")[-1]


def _rule_jl010(linter) -> None:
    if _norm(linter.mod.path) in GROUP_PATHS:
        return
    for node in ast.walk(linter.mod.tree):
        if isinstance(node, ast.Call) and \
                _terminal(linter, node.func) in _GROUP_CTORS:
            linter.flag(
                "JL010", node,
                f"{_terminal(linter, node.func)}(...) outside "
                f"{' and '.join(GROUP_PATHS)}: process groups are the "
                "mesh's (parallel.make_train_mesh / "
                "distributed.mesh_groups), built once by every rank")


def _rule_jl011(linter) -> None:
    if _norm(linter.mod.path) == LAYOUT_PATH:
        return
    for node in ast.walk(linter.mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _terminal(linter, node.func)
        if name in _MESH_CTORS:
            linter.flag(
                "JL011", node,
                f"{name}(...) built outside {LAYOUT_PATH}: meshes and "
                "their axes come from the layout (make_train_mesh, "
                "virtual_mesh, a mesh's .data/.fsdp/.seq)")
        is_axis_api = name in _AXIS_APIS
        for arg in node.args:
            if is_axis_api:
                _flag_axis_strings(linter, arg)
        for kw in node.keywords:
            if is_axis_api or kw.arg in _AXIS_KEYWORDS:
                _flag_axis_strings(linter, kw.value)


def _flag_axis_strings(linter, node: ast.AST) -> None:
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and sub.value in LAYOUT_AXES):
            linter.flag(
                "JL011", sub,
                f"mesh-axis name {sub.value!r} spelled as a string "
                "literal: use the layout's constants (parallel.layout."
                "DATA_AXIS / FSDP_AXIS / SEQ_AXIS)")


def _is_rank_read(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        return node.attr == "rank"
    if isinstance(node, ast.Call):
        f = node.func
        return (isinstance(f, ast.Attribute) and f.attr == "get_rank") or (
            isinstance(f, ast.Name) and f.id == "get_rank")
    return False


def _rule_jl012(linter) -> None:
    path = _norm(linter.mod.path)
    if any(path.startswith(p) for p in RANK_PATHS):
        return
    for node in ast.walk(linter.mod.tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        literal = any(isinstance(s, ast.Constant) and type(s.value) is int
                      for s in sides)
        if literal and any(_is_rank_read(s) for s in sides):
            linter.flag(
                "JL012", node,
                "a rank compared to an integer literal outside "
                "parallel/ and resilience/coord.py: name the rank's "
                "role where the mesh is defined (World.is_writer) and "
                "test that")


def _mesh_none_spans(fn: ast.AST) -> List[Tuple[int, int]]:
    """Line spans of the ``if mesh is None:`` bodies inside ``fn``."""
    spans = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        t = node.test
        if (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
                and t.left.id == "mesh" and len(t.ops) == 1
                and isinstance(t.ops[0], ast.Is)
                and isinstance(t.comparators[0], ast.Constant)
                and t.comparators[0].value is None):
            spans.append((node.body[0].lineno,
                          max(getattr(s, "end_lineno", s.lineno)
                              for s in node.body)))
    return spans


def _rule_jl013(linter) -> None:
    for fn in ast.walk(linter.mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = fn.args
        if "mesh" not in {p.arg for p in a.posonlyargs + a.args
                          + a.kwonlyargs}:
            continue
        exempt = _mesh_none_spans(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = linter.mod.dotted(node.func) or ""
            head, _, name = dotted.rpartition(".")
            if head != "torch.distributed" or name not in _DIST_COLLECTIVES:
                continue
            if any(k.arg == "group" for k in node.keywords):
                continue
            if any(s <= node.lineno <= e for s, e in exempt):
                continue  # the one-process branch
            linter.flag(
                "JL013", node,
                f"torch.distributed.{name}(...) with no group= in "
                f"'{fn.name}', which takes a mesh: it runs over every "
                "rank of the world, not the mesh axis's subgroup; pass the "
                "axis's group (mesh.data.group, mesh.fsdp.group, ...)")


def run_rules(linter) -> None:
    """Entry point synclint's _Linter calls; duck-typed on (mod, flag)."""
    _rule_jl010(linter)
    _rule_jl011(linter)
    _rule_jl012(linter)
    _rule_jl013(linter)
