"""Shared lint model: findings, MPI call-name tables, AST helpers.

The port's copy of ``ompi_tpu/check/lint/model.py``; the tables are the
reference's (the port keeps its API names).

Everything a rule module needs that is not analysis machinery lives
here so the rule packages (:mod:`rules.requests`,
:mod:`rules.collective`, :mod:`rules.conventions`), the engines
(:mod:`cfg`, :mod:`dataflow`, :mod:`callgraph`) and the runner can
all import it without cycles.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    #: matched an entry in the findings baseline (``--baseline``):
    #: known debt, reported but not a gate failure
    baselined: bool = False

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "suppressed": self.suppressed,
                "baselined": self.baselined}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Finding":
        return cls(d["rule"], d["path"], d["line"], d["message"],
                   bool(d.get("suppressed")), bool(d.get("baselined")))


@dataclass
class ModuleContext:
    """One module as the rules see it: AST + parent map + the
    project-wide call graph (:class:`ompi_tpu_torch.check.lint.callgraph.
    Project`) for interprocedural lookups, plus a ``stats`` bag the
    runner folds into ``check_lint_*`` pvars."""

    tree: ast.AST
    parents: Dict[ast.AST, ast.AST]
    path: str
    project: Any = None          # callgraph.Project (None in unit tests)
    stats: Dict[str, int] = field(default_factory=dict)
    _cfgs: Dict[ast.AST, Any] = field(default_factory=dict)

    def bump(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    def cfg_of(self, func: ast.AST):
        """Build (and memoize) the CFG for one function so the three
        dataflow rules and the divergence rule share a single build."""
        got = self._cfgs.get(func)
        if got is None:
            from ompi_tpu_torch.check.lint import cfg as cfg_mod
            got = cfg_mod.build_cfg(func)
            self._cfgs[func] = got
        return got

    def functions(self):
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


# -- call-name tables ----------------------------------------------------

REQUEST_PRODUCERS = frozenset((
    "isend", "irecv", "Isend", "Irecv", "Issend", "Isendrecv",
    "Isendrecv_replace", "Send_init", "Recv_init",
    "Ibarrier", "Ibcast", "Iallreduce", "Ireduce", "Igather",
    "Iscatter", "Iallgather", "Ialltoall", "Igatherv", "Iscatterv",
    "Iallgatherv", "Ialltoallv", "Iscan", "Iexscan",
    "Ireduce_scatter", "Ireduce_scatter_block",
    "Barrier_init", "Bcast_init", "Allreduce_init", "Reduce_init",
    "Gather_init", "Scatter_init", "Allgather_init", "Alltoall_init",
    "Reduce_scatter_block_init", "Allreduce_multi_init",
    "Pallreduce_init", "Reduce_scatter_multi_init",
    "Allgather_multi_init", "Preduce_scatter_init",
    "psend_init", "precv_init", "Psend_init", "Precv_init",
))

PART_INIT = frozenset(("psend_init", "precv_init",
                       "Psend_init", "Precv_init"))
PREADY_NAMES = frozenset(("pready", "Pready", "pready_range",
                          "Pready_range", "pready_list", "Pready_list"))
START_NAMES = frozenset(("start", "Start", "start_all", "Start_all",
                         "startall", "Startall"))

COLLECTIVES = frozenset((
    "Barrier", "barrier", "Bcast", "bcast", "Reduce", "reduce",
    "Allreduce", "allreduce", "Gather", "gather", "Gatherv",
    "Scatter", "scatter", "Scatterv", "Allgather", "allgather",
    "Allgatherv", "Alltoall", "alltoall", "Alltoallv",
    "Reduce_scatter", "Reduce_scatter_block", "Scan", "Exscan",
    "Allreduce_multi", "Reduce_scatter_multi", "Allgather_multi",
)) | REQUEST_PRODUCERS.difference((
    "isend", "irecv", "Isend", "Irecv", "Issend", "Isendrecv",
    "Isendrecv_replace", "Send_init", "Recv_init",
    "psend_init", "precv_init", "Psend_init", "Precv_init",
))

NONBLOCKING_SENDS = frozenset(("isend", "Isend", "Issend",
                               "Send_init", "psend_init",
                               "Psend_init"))

#: instance methods that complete (or explicitly abandon) a request
REQUEST_CONSUMERS = frozenset(("wait", "Wait", "test", "Test",
                               "free", "Free", "cancel", "Cancel"))

#: container mutators that fold a handle into a collection the
#: dataflow then tracks one alias level deep (``reqs.append(r)``)
CONTAINER_ADDERS = frozenset(("append", "add", "insert", "extend",
                              "appendleft", "push"))

HANDLE_PRODUCERS = frozenset(("dup", "Dup", "split", "Split",
                              "split_type", "Split_type",
                              "create_group", "Create_group",
                              "merge", "Merge",
                              "win_create", "Win_create",
                              "win_allocate", "Win_allocate"))
HANDLE_PRODUCER_FNS = frozenset(("File_open", "win_create",
                                 "win_allocate"))
FREE_NAMES = frozenset(("free", "Free", "close", "Close",
                        "disconnect", "Disconnect", "shutdown"))

#: module globals carrying the one-branch disabled guard convention
GUARD_GLOBALS = frozenset(("FLIGHT", "RECORDER", "SANITIZER",
                           "TRAFFIC", "INGEST", "OBSERVER", "SKEW"))

#: path components marking the MPI-convention public API surface for
#: bare-public-raise (coll/, osc/, shmem/, part/, ingest/, elastic/,
#: io/)
PUBLIC_API_DIRS = frozenset(("coll", "osc", "shmem", "part",
                             "ingest", "elastic", "io"))


# -- shared walking helpers ----------------------------------------------

def build_parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    return {child: node for node in ast.walk(tree)
            for child in ast.iter_child_nodes(node)}


def _unparse(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — best-effort source rendering
        return ""


def _enclosing_scope(node: ast.AST, parents) -> ast.AST:
    """Nearest enclosing function (or the module)."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Module)):
            return cur
        cur = parents.get(cur)
    return node


def _enclosing_stmt(node: ast.AST, parents) -> Optional[ast.stmt]:
    cur: Optional[ast.AST] = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = parents.get(cur)
    return cur


def _method_call_name(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _call_name(call: ast.Call) -> Optional[str]:
    """Bare or attribute callee name (``f`` for both ``f()`` and
    ``obj.f()``) — the key the call graph resolves by."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def own_walk(node: ast.AST):
    """Depth-first pre-order walk that does NOT descend into nested
    function/class bodies — the scope's own code only. (The nested
    def/class node itself is yielded; its body is analyzed as its own
    scope.)"""
    stack = list(reversed(list(ast.iter_child_nodes(node))))
    while stack:
        cur = stack.pop()
        yield cur
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(cur))))


def _loads_after(scope: ast.AST, name: str, line: int) -> List[ast.Name]:
    return [n for n in ast.walk(scope)
            if isinstance(n, ast.Name) and n.id == name
            and isinstance(n.ctx, ast.Load)
            and getattr(n, "lineno", 0) > line]
