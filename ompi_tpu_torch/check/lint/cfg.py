"""Per-function control-flow graphs over the lint ASTs.

One :class:`CFG` per ``def``: basic blocks of statements joined by
labelled edges (``true``/``false`` off a branch block, ``loop``/
``exit`` off a loop header, ``except`` into a handler, ``back`` for
the loop back edge). The model is deliberately simple and
conservative for the dataflow rules layered on top:

- loops execute their body zero times or once per enumerated path
  (the back edge is never followed twice), so every lexical ordering
  of statements is covered without unrolling;
- an ``except`` handler is entered from the block where the ``try``
  body *starts* — the worst case for handle-lifecycle analysis is
  that the exception fired before anything in the body ran;
- a ``finally`` body runs on both the normal and the handler path;
- ``return``/``raise`` edge straight to the exit block,
  ``break``/``continue`` to the loop exit/header;
- ``with`` bodies are linear (the item expressions stay visible as
  part of the ``With`` statement in the block);
- nested ``def``/``class`` bodies are opaque single statements —
  nested functions get their own CFG.

:func:`paths` enumerates acyclic-ish paths (each edge at most once
per path) up to a cap, yielding the statement sequence and the
branch decisions taken — the raw material for the
``collective-order-divergence`` deadlock rule and for naming the
leaking path in the dataflow findings.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["Block", "Edge", "CFG", "Path", "build_cfg", "paths"]

#: per-function cap on enumerated paths; beyond it the enumeration
#: stops and the CFG is marked truncated (rules stay sound on the
#: prefix they saw, they just cannot prove absence past the cap)
PATH_LIMIT = 64


@dataclass
class Edge:
    dst: int
    label: str = ""          # "", true, false, loop, exit, back, except


@dataclass
class Block:
    bid: int
    stmts: List[ast.stmt] = field(default_factory=list)
    #: branch condition when this block ends in a conditional split
    test: Optional[ast.expr] = None
    test_line: int = 0
    succ: List[Edge] = field(default_factory=list)


@dataclass
class Path:
    """One walk entry→exit: the blocks visited and the decisions
    (test line, edge label) taken at every labelled split."""

    blocks: Tuple[int, ...]
    decisions: Tuple[Tuple[int, str], ...]

    def describe(self) -> str:
        if not self.decisions:
            return "the straight-line path"
        return " -> ".join(f"line {ln}:{lab}"
                           for ln, lab in self.decisions)


@dataclass
class CFG:
    func: ast.AST
    blocks: Dict[int, Block]
    entry: int
    exit: int
    truncated: bool = False

    def stmt_seq(self, path: Path) -> Iterator[ast.stmt]:
        for bid in path.blocks:
            yield from self.blocks[bid].stmts


class _Builder:
    def __init__(self, func: ast.AST) -> None:
        self.func = func
        self.blocks: Dict[int, Block] = {}
        self._n = 0

    def _block(self) -> Block:
        b = Block(self._n)
        self.blocks[self._n] = b
        self._n += 1
        return b

    def _edge(self, src: Block, dst: Block, label: str = "") -> None:
        src.succ.append(Edge(dst.bid, label))

    def build(self) -> CFG:
        entry = self._block()
        self.exit_block = self._block()
        end = self._seq(self.func.body, entry, [])
        if end is not None:
            self._edge(end, self.exit_block)
        return CFG(self.func, self.blocks, entry.bid,
                   self.exit_block.bid)

    # loops: stack of (header_block, after_block) for break/continue
    def _seq(self, body: List[ast.stmt], cur: Optional[Block],
             loops) -> Optional[Block]:
        for stmt in body:
            if cur is None:
                return None     # statically unreachable tail
            cur = self._stmt(stmt, cur, loops)
        return cur

    def _stmt(self, stmt: ast.stmt, cur: Block,
              loops) -> Optional[Block]:
        if isinstance(stmt, ast.If):
            cur.test, cur.test_line = stmt.test, stmt.lineno
            join = self._block()
            then_b = self._block()
            self._edge(cur, then_b, "true")
            then_end = self._seq(stmt.body, then_b, loops)
            if then_end is not None:
                self._edge(then_end, join)
            if stmt.orelse:
                else_b = self._block()
                self._edge(cur, else_b, "false")
                else_end = self._seq(stmt.orelse, else_b, loops)
                if else_end is not None:
                    self._edge(else_end, join)
            else:
                self._edge(cur, join, "false")
            return join

        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head = self._block()
            self._edge(cur, head)
            head.test = (stmt.test if isinstance(stmt, ast.While)
                         else stmt.iter)
            head.test_line = stmt.lineno
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                # the target binding happens at the loop head
                head.stmts.append(stmt)
            body_b = self._block()
            after = self._block()
            self._edge(head, body_b, "loop")
            body_end = self._seq(stmt.body, body_b,
                                 loops + [(head, after)])
            if body_end is not None:
                self._edge(body_end, head, "back")
            if stmt.orelse:
                else_b = self._block()
                self._edge(head, else_b, "exit")
                else_end = self._seq(stmt.orelse, else_b, loops)
                if else_end is not None:
                    self._edge(else_end, after)
            else:
                self._edge(head, after, "exit")
            return after

        if isinstance(stmt, ast.Try):
            body_b = self._block()
            self._edge(cur, body_b)
            body_end = self._seq(stmt.body, body_b, loops)
            if body_end is not None and stmt.orelse:
                body_end = self._seq(stmt.orelse, body_end, loops)
            fin = self._block() if stmt.finalbody else None
            join = self._block()
            normal_to = fin if fin is not None else join
            if body_end is not None:
                self._edge(body_end, normal_to)
            for handler in stmt.handlers:
                h_b = self._block()
                # worst case: the exception fired before ANY body
                # statement ran, so the handler hangs off the start
                self._edge(body_b, h_b, "except")
                h_end = self._seq(handler.body, h_b, loops)
                if h_end is not None:
                    self._edge(h_end, normal_to)
            if fin is not None:
                fin_end = self._seq(stmt.finalbody, fin, loops)
                if fin_end is not None:
                    self._edge(fin_end, join)
            return join

        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            cur.stmts.append(stmt)
            return self._seq(stmt.body, cur, loops)

        if isinstance(stmt, (ast.Return, ast.Raise)):
            cur.stmts.append(stmt)
            self._edge(cur, self.exit_block,
                       "return" if isinstance(stmt, ast.Return)
                       else "raise")
            return None

        if isinstance(stmt, ast.Break):
            if loops:
                self._edge(cur, loops[-1][1], "break")
            else:
                self._edge(cur, self.exit_block, "break")
            return None

        if isinstance(stmt, ast.Continue):
            if loops:
                self._edge(cur, loops[-1][0], "continue")
            else:
                self._edge(cur, self.exit_block, "continue")
            return None

        if isinstance(stmt, ast.Match):
            cur.test, cur.test_line = stmt.subject, stmt.lineno
            join = self._block()
            exhaustive = False
            for case in stmt.cases:
                c_b = self._block()
                self._edge(cur, c_b, "case")
                c_end = self._seq(case.body, c_b, loops)
                if c_end is not None:
                    self._edge(c_end, join)
                if isinstance(case.pattern, ast.MatchAs) \
                        and case.pattern.pattern is None \
                        and case.guard is None:
                    exhaustive = True
            if not exhaustive:
                self._edge(cur, join, "false")
            return join

        # plain statement (incl. nested def/class kept opaque)
        cur.stmts.append(stmt)
        return cur


def build_cfg(func: ast.AST) -> CFG:
    """CFG for one ``FunctionDef``/``AsyncFunctionDef`` (or any node
    with a ``body`` list)."""
    return _Builder(func).build()


def paths(cfg: CFG, limit: int = PATH_LIMIT) -> List[Path]:
    """Enumerate entry→exit paths, following each edge at most once
    per path (loops run zero times or once). Stops at ``limit`` and
    sets ``cfg.truncated`` so callers can report reduced coverage."""
    out: List[Path] = []

    def dfs(bid: int, blocks: List[int],
            decisions: List[Tuple[int, str]], used) -> None:
        if len(out) >= limit:
            cfg.truncated = True
            return
        blocks.append(bid)
        if bid == cfg.exit:
            out.append(Path(tuple(blocks), tuple(decisions)))
            blocks.pop()
            return
        block = cfg.blocks[bid]
        succ = block.succ
        if not succ:        # dangling block (e.g. unreachable join)
            blocks.pop()
            return
        for e in succ:
            key = (bid, e.dst, e.label)
            if key in used:
                continue
            labelled = e.label in ("true", "false", "loop", "exit",
                                   "except", "case")
            if labelled:
                decisions.append((block.test_line, e.label))
            used.add(key)
            dfs(e.dst, blocks, decisions, used)
            used.discard(key)
            if labelled:
                decisions.pop()
        blocks.pop()

    dfs(cfg.entry, [], [], set())
    return out
