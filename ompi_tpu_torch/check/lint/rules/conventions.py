"""Repo-convention rules (lexical by design — the property each
guards is visible in one AST): ``bare-public-raise``,
``unregistered-pvar``, ``unguarded-observability``. The port's copy of
``ompi_tpu/check/lint/rules/conventions.py``: a pvar is registered when
the port's ``core/pvar.py`` knows it (``WELL_KNOWN`` or one of its
``WELL_KNOWN_PREFIXES`` families)."""

from __future__ import annotations

import ast
from typing import List

from ompi_tpu_torch.check.lint.model import (
    GUARD_GLOBALS, PUBLIC_API_DIRS, Finding, ModuleContext, _unparse,
)


def rule_bare_public_raise(ctx: ModuleContext) -> List[Finding]:
    parts = ctx.path.replace("\\", "/").split("/")
    if not PUBLIC_API_DIRS.intersection(parts):
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        name = None
        if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
            name = exc.func.id
        elif isinstance(exc, ast.Name):
            name = exc.id
        if name not in ("ValueError", "TypeError"):
            continue
        out.append(Finding(
            "bare-public-raise", ctx.path, node.lineno,
            f"raise {name} on an MPI API path — raise "
            "errors.MPIError(ERR_*) so the comm errhandler sees it"))
    return out


def rule_unregistered_pvar(ctx: ModuleContext) -> List[Finding]:
    from ompi_tpu_torch.core import pvar

    out: List[Finding] = []
    for call in ast.walk(ctx.tree):
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr in ("record", "record_hwm", "timer")
                and "pvar" in _unparse(call.func.value)):
            continue
        if not (call.args and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            continue  # dynamic name families are exempt
        name = call.args[0].value
        reg = name + "_ns" if call.func.attr == "timer" else name
        if not pvar.is_well_known(reg):
            out.append(Finding(
                "unregistered-pvar", ctx.path, call.lineno,
                f"pvar '{reg}' is not in pvar.WELL_KNOWN — it will "
                "not export at 0 before first use"))
    return out


def rule_unguarded_observability(ctx: ModuleContext) -> List[Finding]:
    parents = ctx.parents
    out: List[Finding] = []
    for call in ast.walk(ctx.tree):
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)):
            continue
        base = call.func.value
        guard = None
        if isinstance(base, ast.Attribute) and base.attr in GUARD_GLOBALS:
            guard = base.attr
        elif isinstance(base, ast.Name) and base.id in GUARD_GLOBALS:
            guard = base.id
        if guard is None:
            continue
        cur = parents.get(call)
        protected = False
        while cur is not None and not protected:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if isinstance(cur, (ast.If, ast.While, ast.Assert)) \
                    and guard in _unparse(cur.test):
                protected = True
            if isinstance(cur, ast.IfExp) and guard in _unparse(cur.test):
                protected = True
            cur = parents.get(cur)
        if not protected:
            out.append(Finding(
                "unguarded-observability", ctx.path, call.lineno,
                f"direct call through {guard} with no enclosing None "
                "check — bind the guard once and branch on it (the "
                "one-branch disabled-guard convention)"))
    return out
