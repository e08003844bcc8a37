"""Flow-sensitive handle lifecycle analysis over the lint CFGs.

Three pieces, all conservative in the same direction (a use the
analysis cannot prove harmless counts as handled, so findings stay
close to real defects):

- :func:`classify_use` / :class:`HandleTracker` — what one statement
  does to a tracked request/comm handle: *consume* it (``wait``/
  ``test``/``free``/``cancel`` or the rule's free-name set), *escape*
  it (returned, yielded, stored into a structure, passed to a call
  the call graph cannot prove ignores it), *alias* it one level into
  a local container (``reqs.append(r)`` — consuming the container
  consumes the request), *rebind* the name, or nothing.
- :func:`find_leaks` — path-sensitive reachability from a creation
  site: is there an entry-respecting CFG path to the function exit on
  which the handle is never consumed? Returns the offending decision
  trail so the finding can name the branch that leaks.
- :func:`rank_taint` — which local names are (transitively, one
  assignment chain) derived from ``<comm>.rank`` / ``Get_rank()``,
  and from which comm — the trigger predicate for the
  ``collective-order-divergence`` deadlock rule.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ompi_tpu_torch.check.lint.cfg import CFG
from ompi_tpu_torch.check.lint.model import (
    CONTAINER_ADDERS, FREE_NAMES, PREADY_NAMES, REQUEST_CONSUMERS,
    START_NAMES, _unparse, build_parents,
)

__all__ = ["HandleTracker", "LeakReport", "find_leaks",
           "rank_taint", "rank_sources"]

#: bound on paths explored per creation site; hitting it without a
#: leak counts as clean (we only report what we can demonstrate)
LEAK_PATH_LIMIT = 128


@dataclass
class LeakReport:
    #: a demonstrated path to exit with no consume (branch decisions)
    leak_decisions: Optional[Tuple[Tuple[int, str], ...]]
    #: the handle is consumed on at least one other path
    consumed_somewhere: bool
    #: paths explored (feeds the check_lint_cfg_paths pvar)
    paths_walked: int = 0


class HandleTracker:
    """Per-function classifier: what does each statement do to the
    handle bound to ``name``? ``consumers`` is the method-name set
    that completes the handle (requests: wait/test/free/cancel;
    comm/window handles: the free/close set)."""

    def __init__(self, func: ast.AST, name: str, consumers: frozenset,
                 project=None, parents=None,
                 path: Optional[str] = None,
                 refine_calls: bool = True) -> None:
        self.func = func
        self.name = name
        self.consumers = consumers
        self.project = project
        self.path = path
        #: when False, passing the handle to ANY call ends its tracked
        #: lifetime (ownership transfer) — the handle-leak semantics;
        #: requests keep the interprocedural refinement (a helper must
        #: provably wait/free the request for the pass to count)
        self.refine_calls = refine_calls
        self.parents = parents if parents is not None \
            else build_parents(func)
        self._container_loads: Dict[str, bool] = {}

    # -- helpers ---------------------------------------------------------

    def _container_used_after(self, container: str, line: int) -> bool:
        """Any later Load of the container in this function — the one
        alias level: wait_all(reqs), for r in reqs, return reqs …"""
        key = f"{container}@{line}"
        got = self._container_loads.get(key)
        if got is None:
            got = any(isinstance(n, ast.Name) and n.id == container
                      and isinstance(n.ctx, ast.Load)
                      and getattr(n, "lineno", 0) > line
                      for n in ast.walk(self.func))
            self._container_loads[key] = got
        return got

    def _call_consumes_arg(self, call: ast.Call,
                           pos: Optional[int],
                           kw: Optional[str]) -> bool:
        """Does passing the handle to this call consume it? Unknown
        callees conservatively do; a project-resolved callee that
        provably ignores the parameter does not (the interprocedural
        one-level refinement)."""
        if self.project is None or not self.refine_calls:
            return True
        # only trust resolution for self-methods and bare names —
        # arbitrary receivers (lst.append, obj.push) are opaque
        fn = call.func
        if isinstance(fn, ast.Attribute):
            if not (isinstance(fn.value, ast.Name)
                    and fn.value.id in ("self", "cls")):
                return True
            callee = fn.attr
        elif isinstance(fn, ast.Name):
            callee = fn.id
        else:
            return True
        verdict = self.project.call_consumes_param(
            callee, pos, kw, prefer_path=self.path)
        return True if verdict is None else verdict

    # -- the statement-effect classifier ---------------------------------

    def stmt_consumes(self, stmt: ast.stmt) -> bool:
        """True when executing ``stmt`` ends the handle's tracked
        lifetime: a consuming method call, an escape, a rebind, or an
        alias into a container that is itself used later."""
        name = self.name
        # rebinding the name ends the old handle's liveness here
        # (leaking-by-rebind is the unwaited rule's creation-site
        # concern for the NEW handle, not this one's)
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return True
        return self.expr_consumes(stmt)

    def expr_consumes(self, expr: ast.AST) -> bool:
        """Any Load of the handle in ``expr`` that consumes/escapes
        it — also used on branch-test expressions, which live on the
        CFG block's ``test`` slot rather than in its stmt list."""
        for node in ast.walk(expr):
            if not (isinstance(node, ast.Name)
                    and node.id == self.name
                    and isinstance(node.ctx, ast.Load)):
                continue
            if self._use_consumes(node):
                return True
        return False

    def _use_consumes(self, node: ast.Name) -> bool:
        parent = self.parents.get(node)
        # r.meth(...) — consuming, neutral, or container-ish
        if isinstance(parent, ast.Attribute) and parent.value is node:
            gp = self.parents.get(parent)
            if isinstance(gp, ast.Call) and gp.func is parent:
                if parent.attr in self.consumers:
                    return True
                return False    # start()/pready()/plain method: neutral
            return False        # plain attribute read: neutral
        if isinstance(parent, ast.Call):
            # r passed as an argument
            if node in parent.args:
                pos = parent.args.index(node)
                if isinstance(parent.func, ast.Attribute) \
                        and parent.func.attr in CONTAINER_ADDERS \
                        and isinstance(parent.func.value, ast.Name):
                    # reqs.append(r): one alias level — consumed iff
                    # the container is itself used afterwards
                    return self._container_used_after(
                        parent.func.value.id,
                        getattr(parent, "lineno", 0))
                return self._call_consumes_arg(parent, pos, None)
            for k in parent.keywords:
                if k.value is node:
                    return self._call_consumes_arg(parent, None, k.arg)
            return True         # starred/nested: conservative escape
        if isinstance(parent, (ast.Compare, ast.BoolOp, ast.UnaryOp)):
            return False        # `if r is not None:` — neutral read
        if isinstance(parent, (ast.If, ast.While)):
            return False        # bare truthiness test
        # returned / yielded / stored / packed into a literal /
        # anything else: the handle escapes — conservative consume
        return True


def _absent_on_edge(test: Optional[ast.AST], name: Optional[str],
                    label: str) -> bool:
    """None-narrowing: taking this edge proves the tracked name holds
    no handle (``x is None`` true-edge, ``x is not None`` false-edge,
    bare/`not` truthiness) — producers like ``split(UNDEFINED)``
    return None, and a None cannot leak."""
    if test is None or name is None:
        return False
    if isinstance(test, ast.Name) and test.id == name:
        return label == "false"
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and isinstance(test.operand, ast.Name) \
            and test.operand.id == name:
        return label == "true"
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Name) \
            and test.left.id == name \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.Is):
            return label == "true"
        if isinstance(test.ops[0], ast.IsNot):
            return label == "false"
    return False


def _locate(cfg: CFG, stmt: ast.stmt) -> Optional[Tuple[int, int]]:
    for bid, block in cfg.blocks.items():
        for i, s in enumerate(block.stmts):
            if s is stmt:
                return bid, i
    return None


def find_leaks(cfg: CFG, creation: ast.stmt,
               tracker: HandleTracker,
               violates=None) -> Tuple[LeakReport, List]:
    """Walk every path from ``creation`` to the function exit.

    Returns a :class:`LeakReport` (a demonstrated consume-free path,
    if any) plus the list of ``(stmt, decisions)`` where the optional
    ``violates(stmt)`` predicate fired before the handle was consumed
    on that path — the buffer-reuse-before-wait engine.
    """
    loc = _locate(cfg, creation)
    violations: List[Tuple[ast.stmt, Tuple]] = []
    seen_violation_ids: Set[int] = set()
    if loc is None:
        return LeakReport(None, True, 0), violations
    start_bid, start_idx = loc
    state = {"walked": 0, "leak": None, "consumed": False}

    def scan(block, idx, decisions) -> Optional[bool]:
        """Run stmts of one block from idx; True = consumed here,
        False = fell through, None = path budget exhausted."""
        for stmt in block.stmts[idx:]:
            if stmt is creation and not (block.bid == start_bid
                                         and idx == start_idx + 1):
                # looped back around to the creation site: the name
                # is rebound to a fresh handle — old lifetime ends
                return True
            if tracker.stmt_consumes(stmt):
                state["consumed"] = True
                return True
            if violates is not None and violates(stmt) \
                    and id(stmt) not in seen_violation_ids:
                seen_violation_ids.add(id(stmt))
                violations.append((stmt, tuple(decisions)))
        # the branch test is evaluated when leaving the block — a
        # consuming use there (wait_all(reqs) in a condition, the
        # handle passed to a predicate) ends the lifetime too
        if block.test is not None \
                and tracker.expr_consumes(block.test):
            state["consumed"] = True
            return True
        return False

    def dfs(bid, idx, decisions, used) -> None:
        if state["walked"] >= LEAK_PATH_LIMIT:
            return
        block = cfg.blocks[bid]
        done = scan(block, idx, decisions)
        if done:
            state["walked"] += 1
            return
        if bid == cfg.exit or not block.succ:
            state["walked"] += 1
            if bid == cfg.exit and state["leak"] is None:
                state["leak"] = tuple(decisions)
            return
        name = getattr(tracker, "name", None)
        for e in block.succ:
            key = (bid, e.dst, e.label)
            if key in used:
                continue
            if _absent_on_edge(block.test, name, e.label):
                # the handle is provably None down this edge: the
                # path is clean by construction, not "consumed"
                state["walked"] += 1
                continue
            if e.label == "except" and bid == start_bid \
                    and start_idx == len(block.stmts) - 1:
                # the creation is this block's LAST stmt, so an
                # exception here fired at-or-before the creation —
                # the name was never bound, nothing can leak
                state["walked"] += 1
                continue
            labelled = e.label in ("true", "false", "loop", "exit",
                                   "except", "case")
            if labelled:
                decisions.append((block.test_line, e.label))
            used.add(key)
            dfs(e.dst, 0, decisions, used)
            used.discard(key)
            if labelled:
                decisions.pop()

    dfs(start_bid, start_idx + 1, [], set())
    return LeakReport(state["leak"], state["consumed"],
                      state["walked"]), violations


# -- rank taint (for the deadlock rule) ----------------------------------

def rank_sources(expr: ast.AST,
                 taint: Dict[str, Set[str]]) -> Set[str]:
    """Comm sources whose rank the expression depends on:
    ``comm.rank`` / ``comm.Get_rank()`` directly, or any name the
    taint map already traces back to one."""
    out: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr == "rank":
            src = _unparse(n.value)
            if src:
                out.add(src)
        elif isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("Get_rank", "get_rank"):
            src = _unparse(n.func.value)
            if src:
                out.add(src)
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id in taint:
            out |= taint[n.id]
    return out


def rank_taint(func: ast.AST,
               before_line: Optional[int] = None) -> Dict[str, Set[str]]:
    """name -> comm sources its value's rank-dependence flows from.
    Two fixpoint sweeps in lexical order cover the assignment chains
    that matter (``rank = comm.rank; me = rank``). ``before_line``
    restricts to assignments lexically before that line — the cheap
    reaching-definitions cut that keeps a cache-fill assignment
    *inside* a branch from tainting the branch's own test."""
    taint: Dict[str, Set[str]] = {}
    assigns: List[Tuple[ast.expr, ast.expr]] = []
    for node in ast.walk(func):
        if before_line is not None \
                and getattr(node, "lineno", 0) >= before_line:
            continue
        if isinstance(node, ast.Assign):
            for t in node.targets:
                assigns.append((t, node.value))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            assigns.append((node.target, node.value))
        elif isinstance(node, ast.NamedExpr):
            assigns.append((node.target, node.value))
    for _ in range(2):
        for target, value in assigns:
            pairs: List[Tuple[ast.expr, ast.expr]]
            if isinstance(target, ast.Tuple) \
                    and isinstance(value, ast.Tuple) \
                    and len(target.elts) == len(value.elts):
                pairs = list(zip(target.elts, value.elts))
            else:
                pairs = [(target, value)]
            for t, v in pairs:
                if not isinstance(t, ast.Name):
                    continue
                srcs = rank_sources(v, taint)
                if srcs:
                    taint.setdefault(t.id, set()).update(srcs)
    return taint
