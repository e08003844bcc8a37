"""Request/handle lifecycle rules, path-aware over the CFG engine.

The three handle rules (``unwaited-request``,
``buffer-reuse-before-wait``, ``handle-leak``) share one shape:
enumerate creation sites, build a :class:`~ompi_tpu_torch.check.lint.
dataflow.HandleTracker` for the bound name, and ask
:func:`~ompi_tpu_torch.check.lint.dataflow.find_leaks` whether some CFG
path reaches the scope exit without consuming the handle — so a
request waited on only one arm of a branch is a finding, while one
appended to a list that is later ``wait_all``-ed (or handed to a
helper the call graph proves waits it) is not. ``pready-outside-
start`` stays a lexical check: the property it guards (an active
partitioned region between init and Pready) is an ordering over one
scope the linear scan already captures faithfully.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from ompi_tpu_torch.check.lint.dataflow import HandleTracker, find_leaks
from ompi_tpu_torch.check.lint.model import (
    FREE_NAMES, HANDLE_PRODUCER_FNS, HANDLE_PRODUCERS,
    NONBLOCKING_SENDS, PART_INIT, PREADY_NAMES, REQUEST_CONSUMERS,
    REQUEST_PRODUCERS, START_NAMES, Finding, ModuleContext,
    _enclosing_scope, _enclosing_stmt, _loads_after,
    _method_call_name, _unparse, own_walk,
)


def _scopes(ctx: ModuleContext) -> Iterator[ast.AST]:
    """Every analyzable scope: the module body plus each function."""
    yield ctx.tree
    yield from ctx.functions()


def _decisions_str(decisions) -> str:
    if not decisions:
        return "the straight-line path"
    return " -> ".join(f"line {ln}:{lab}" for ln, lab in decisions)


def _producer_creations(ctx, scope):
    """Yield (stmt, name, op) creation sites in one scope: direct
    request-producer calls, and (one level interprocedural) calls to
    project functions that provably return a request. ``name`` is
    None for a dropped result, "_" for the discard binding."""
    for stmt in own_walk(scope):
        if isinstance(stmt, ast.Expr) \
                and isinstance(stmt.value, ast.Call):
            op = _creation_op(ctx, stmt.value)
            if op is not None:
                yield stmt, None, op
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                and isinstance(stmt.value, ast.Call):
            op = _creation_op(ctx, stmt.value)
            if op is None:
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if len(targets) != 1 or not isinstance(targets[0], ast.Name):
                continue    # attribute/subscript/tuple target: escapes
            yield stmt, targets[0].id, op


def _creation_op(ctx, call: ast.Call) -> Optional[str]:
    op = _method_call_name(call)
    if op in REQUEST_PRODUCERS:
        return op
    if ctx.project is not None:
        # helper that provably returns a request: self.f() / bare f()
        fn = call.func
        if isinstance(fn, ast.Attribute):
            if not (isinstance(fn.value, ast.Name)
                    and fn.value.id in ("self", "cls")):
                return None
            callee = fn.attr
        elif isinstance(fn, ast.Name):
            callee = fn.id
        else:
            return None
        if callee not in REQUEST_PRODUCERS \
                and ctx.project.returns_request(
                    callee, prefer_path=ctx.path):
            return callee
    return None


def rule_unwaited_request(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    for scope in _scopes(ctx):
        for stmt, name, op in _producer_creations(ctx, scope):
            if name is None:
                out.append(Finding(
                    "unwaited-request", ctx.path, stmt.lineno,
                    f"result of {op}() dropped — the request is never "
                    "waited, tested, or freed"))
                continue
            if name == "_":
                out.append(Finding(
                    "unwaited-request", ctx.path, stmt.lineno,
                    f"result of {op}() bound to '_' — the request is "
                    "never waited, tested, or freed"))
                continue
            tracker = HandleTracker(scope, name, REQUEST_CONSUMERS,
                                    ctx.project, ctx.parents, ctx.path)
            report, _ = find_leaks(ctx.cfg_of(scope), stmt, tracker)
            ctx.bump("cfg_paths", report.paths_walked)
            if report.leak_decisions is None:
                continue
            if report.consumed_somewhere:
                out.append(Finding(
                    "unwaited-request", ctx.path, stmt.lineno,
                    f"request from {op}() bound to '{name}' is waited "
                    "on only some paths — unconsumed on the path "
                    f"[{_decisions_str(report.leak_decisions)}]"))
            elif not _loads_after(scope, name, stmt.lineno):
                out.append(Finding(
                    "unwaited-request", ctx.path, stmt.lineno,
                    f"request from {op}() bound to '{name}' which is "
                    "never used again — never waited, tested, or "
                    "freed"))
            else:
                out.append(Finding(
                    "unwaited-request", ctx.path, stmt.lineno,
                    f"request from {op}() bound to '{name}' is used "
                    "but never waited, tested, or freed on any path"))
    return out


def rule_buffer_reuse_before_wait(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []

    class _NeverConsumes:
        def stmt_consumes(self, stmt):  # dropped request: no wait
            return False

        def expr_consumes(self, expr):
            return False

    for scope in _scopes(ctx):
        sends: List[Tuple[ast.stmt, Optional[str], str, str, int]] = []
        for node in own_walk(scope):
            if not (isinstance(node, ast.Call)
                    and _method_call_name(node) in NONBLOCKING_SENDS
                    and node.args
                    and isinstance(node.args[0], ast.Name)):
                continue
            stmt = _enclosing_stmt(node, ctx.parents)
            if stmt is None:
                continue
            req = None
            if isinstance(stmt, ast.Assign) and stmt.value is node \
                    and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                req = stmt.targets[0].id
            sends.append((stmt, req, node.args[0].id,
                          node.func.attr, node.lineno))  # type: ignore

        for stmt, req, buf, op, line in sends:
            tracker = (HandleTracker(scope, req, REQUEST_CONSUMERS,
                                     ctx.project, ctx.parents, ctx.path)
                       if req is not None else _NeverConsumes())

            def stores_buf(s: ast.stmt, buf=buf) -> bool:
                if isinstance(s, ast.Assign):
                    tgts = s.targets
                elif isinstance(s, (ast.AugAssign, ast.AnnAssign)):
                    tgts = [s.target]
                else:
                    return False
                for t in tgts:
                    if isinstance(t, ast.Name) and t.id == buf:
                        return True
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == buf:
                        return True
                return False

            report, violations = find_leaks(
                ctx.cfg_of(scope), stmt, tracker, violates=stores_buf)
            ctx.bump("cfg_paths", report.paths_walked)
            for vstmt, decisions in violations:
                out.append(Finding(
                    "buffer-reuse-before-wait", ctx.path, vstmt.lineno,
                    f"'{buf}' written before the {op}() of line "
                    f"{line} is waited — the transfer may read the "
                    "new bytes"))
    return out


def rule_handle_leak(ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    for scope in ctx.functions():    # module-level handles live on
        for stmt in own_walk(scope):
            if not (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            call = stmt.value
            produced = _method_call_name(call)
            if produced in HANDLE_PRODUCERS:
                what = produced
            elif isinstance(call.func, ast.Name) \
                    and call.func.id in HANDLE_PRODUCER_FNS:
                what = call.func.id
            else:
                continue
            name = stmt.targets[0].id
            # refine_calls=False: passing a comm/window/file handle to
            # any call is "passed on" (ownership transfer) — unlike a
            # request, whose receiving helper must provably wait it
            tracker = HandleTracker(scope, name, FREE_NAMES,
                                    ctx.project, ctx.parents, ctx.path,
                                    refine_calls=False)
            report, _ = find_leaks(ctx.cfg_of(scope), stmt, tracker)
            ctx.bump("cfg_paths", report.paths_walked)
            if report.leak_decisions is None:
                continue
            if report.consumed_somewhere:
                out.append(Finding(
                    "handle-leak", ctx.path, stmt.lineno,
                    f"handle from {what}() bound to '{name}' is freed "
                    "on only some paths — leaks on the path "
                    f"[{_decisions_str(report.leak_decisions)}]"))
            else:
                out.append(Finding(
                    "handle-leak", ctx.path, stmt.lineno,
                    f"handle from {what}() bound to '{name}' is never "
                    "freed, closed, returned, stored, or passed on"))
    return out


def rule_pready_outside_start(ctx: ModuleContext) -> List[Finding]:
    tree, parents, path = ctx.tree, ctx.parents, ctx.path
    out: List[Finding] = []
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        if _method_call_name(call) not in PREADY_NAMES:
            continue
        recv = call.func.value  # type: ignore[union-attr]
        if not isinstance(recv, ast.Name):
            continue
        req = recv.id
        scope = _enclosing_scope(call, parents)
        init_line = None
        for other in ast.walk(scope):
            if isinstance(other, ast.Assign) \
                    and isinstance(other.value, ast.Call) \
                    and _method_call_name(other.value) in PART_INIT \
                    and any(isinstance(t, ast.Name) and t.id == req
                            for t in other.targets) \
                    and other.lineno < call.lineno:
                init_line = other.lineno
        if init_line is None:
            continue  # request came from elsewhere: cannot see
        started = False
        for other in ast.walk(scope):
            if not (isinstance(other, ast.Call)
                    and init_line <= getattr(other, "lineno", 0)
                    <= call.lineno):
                continue
            nm = _method_call_name(other)
            if nm in START_NAMES and isinstance(
                    other.func.value, ast.Name) \
                    and other.func.value.id == req:
                started = True
            elif isinstance(other.func, ast.Name) \
                    and other.func.id in START_NAMES \
                    and req in _unparse(other):
                started = True  # start_all([req, ...])
        if not started:
            out.append(Finding(
                "pready-outside-start", path, call.lineno,
                f"Pready on '{req}' with no Start/start_all between "
                f"the psend_init (line {init_line}) and here — no "
                "active partitioned region"))
    return out
