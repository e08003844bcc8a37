"""Project-wide call graph with per-function effect summaries.

The interprocedural half of the lint engine, one level deep by
design: every function in the linted tree gets a syntactic summary —
which parameters it consumes (waits/tests/frees or lets escape),
whether it returns a request handle, and the sequence of collectives
it issues directly — and call sites resolve against those summaries
by callee name. Resolution is deliberately narrow: only ``self.f(…)``
/ ``cls.f(…)`` and bare-name calls resolve (an arbitrary receiver is
opaque), and ambiguous names merge conservatively (a parameter
counts as consumed if *any* candidate consumes it; a collective
effect is only trusted when all candidates agree), so the
interprocedural verdicts can refine findings but never manufacture
one out of a bad resolution.

Summaries are plain dicts round-trippable through JSON — the unit
the incremental cache persists per file, and whose digest keys the
"did my callees change" half of the cache invalidation.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ompi_tpu_torch.check.lint.model import (
    COLLECTIVES, FREE_NAMES, REQUEST_CONSUMERS, REQUEST_PRODUCERS,
    _call_name, _method_call_name, _unparse, build_parents, own_walk,
)

__all__ = ["FuncSummary", "Project", "summarize_module",
           "module_call_names"]


@dataclass
class FuncSummary:
    name: str
    qual: str
    path: str
    line: int
    params: List[str] = field(default_factory=list)
    is_method: bool = False
    #: parameter names the function waits/tests/frees or escapes
    consumes: List[str] = field(default_factory=list)
    #: (collective op, receiver source) issued directly, lexical order
    collectives: List[Tuple[str, str]] = field(default_factory=list)
    returns_request: bool = False

    def to_dict(self) -> dict:
        return {"name": self.name, "qual": self.qual,
                "path": self.path, "line": self.line,
                "params": self.params, "is_method": self.is_method,
                "consumes": self.consumes,
                "collectives": [list(c) for c in self.collectives],
                "returns_request": self.returns_request}

    @classmethod
    def from_dict(cls, d: dict) -> "FuncSummary":
        return cls(d["name"], d["qual"], d["path"], d["line"],
                   list(d.get("params", ())),
                   bool(d.get("is_method")),
                   list(d.get("consumes", ())),
                   [tuple(c) for c in d.get("collectives", ())],
                   bool(d.get("returns_request")))

    def effective_params(self) -> List[str]:
        return self.params[1:] if self.is_method else self.params


def _param_consumed(func: ast.AST, parents, name: str) -> bool:
    from ompi_tpu_torch.check.lint.dataflow import HandleTracker

    tracker = HandleTracker(func, name,
                            REQUEST_CONSUMERS | FREE_NAMES,
                            project=None, parents=parents)
    for node in own_walk(func):
        if isinstance(node, ast.Name) and node.id == name \
                and isinstance(node.ctx, ast.Load):
            if tracker._use_consumes(node):
                return True
    return False


def _returns_request(func: ast.AST) -> bool:
    bound: Set[str] = set()
    for node in own_walk(func):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call) \
                and _method_call_name(node.value) in REQUEST_PRODUCERS:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bound.add(t.id)
    for node in own_walk(func):
        if isinstance(node, ast.Return) and node.value is not None:
            v = node.value
            if isinstance(v, ast.Call) \
                    and _method_call_name(v) in REQUEST_PRODUCERS:
                return True
            if isinstance(v, ast.Name) and v.id in bound:
                return True
    return False


def summarize_function(func: ast.AST, path: str,
                       qual: str, parents=None) -> FuncSummary:
    if parents is None:
        parents = build_parents(func)
    params = [a.arg for a in func.args.posonlyargs + func.args.args]
    is_method = bool(params) and params[0] in ("self", "cls")
    consumes = [p for p in params
                if _param_consumed(func, parents, p)]
    collectives: List[Tuple[str, str]] = []
    for node in own_walk(func):
        if isinstance(node, ast.Call):
            op = _method_call_name(node)
            if op in COLLECTIVES:
                collectives.append(
                    (op, _unparse(node.func.value)))  # type: ignore
    return FuncSummary(func.name, qual, path, func.lineno,
                       params, is_method, consumes, collectives,
                       _returns_request(func))


def summarize_module(tree: ast.AST, path: str) -> List[FuncSummary]:
    out: List[FuncSummary] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                out.append(summarize_function(child, path, qual))
                visit(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def module_call_names(tree: ast.AST) -> List[str]:
    """Every callee name referenced by the module — the dependency
    edge set the incremental cache digests."""
    names = {_call_name(n) for n in ast.walk(tree)
             if isinstance(n, ast.Call)}
    names.discard(None)
    return sorted(names)  # type: ignore[arg-type]


class Project:
    """The resolved project: function summaries indexed by bare name."""

    def __init__(self, summaries) -> None:
        self.by_name: Dict[str, List[FuncSummary]] = {}
        for s in summaries:
            self.by_name.setdefault(s.name, []).append(s)

    @classmethod
    def from_summaries(cls, summaries) -> "Project":
        return cls(summaries)

    def lookup(self, name: str,
               prefer_path: Optional[str] = None) -> List[FuncSummary]:
        cands = self.by_name.get(name, [])
        if prefer_path is not None:
            local = [c for c in cands if c.path == prefer_path]
            if local:
                return local
        return cands

    def call_consumes_param(self, callee: str, pos: Optional[int],
                            kw: Optional[str],
                            prefer_path: Optional[str] = None
                            ) -> Optional[bool]:
        """None = unknown callee; True/False = some/no candidate
        consumes the argument at that position/keyword."""
        cands = self.lookup(callee, prefer_path)
        if not cands:
            return None
        for c in cands:
            eff = c.effective_params()
            if kw is not None:
                pname = kw if kw in eff else None
            elif pos is not None and pos < len(eff):
                pname = eff[pos]
            else:
                pname = None
            if pname is None:
                return True     # *args / unmappable: assume consumed
            if pname in c.consumes:
                return True
        return False

    def collective_effect(self, callee: str,
                          prefer_path: Optional[str] = None
                          ) -> List[Tuple[str, str]]:
        """The collective sequence a call to ``callee`` contributes to
        a path — only when every candidate agrees (an ambiguous name
        must not manufacture a divergence)."""
        cands = self.lookup(callee, prefer_path)
        if not cands:
            return []
        seqs = {tuple(c.collectives) for c in cands}
        if len(seqs) != 1:
            return []
        return list(seqs.pop())

    def returns_request(self, callee: str,
                        prefer_path: Optional[str] = None) -> bool:
        cands = self.lookup(callee, prefer_path)
        return bool(cands) and all(c.returns_request for c in cands)
