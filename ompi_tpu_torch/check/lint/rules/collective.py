"""The static deadlock detector: ``collective-order-divergence``.

Supersedes the lexical ``rank-divergent-collective``. Instead of
flagging any collective lexically inside a rank-tested branch, the
rule symbolically walks the scope's CFG paths and compares the
*sequence* of collectives issued on each: a finding requires two
concrete paths whose divergence point is a branch whose condition is
rank-dependent (``comm.rank`` / ``Get_rank()`` directly, or a local
the taint pass traces back to one) AND whose collective sequences on
that comm differ between the divergence and the paths' first
re-convergence — so differences introduced by a *later, unrelated*
branch are never attributed to the rank test, and a branch that
issues the same sequence on both arms (the "rank 0 packs, everyone
bcasts" shape) is a true negative the lexical rule could never
prove.

Interprocedural one level: a call to a project function whose
summary carries a collective effect contributes that sequence to the
arm, so a rank-guarded helper that bcasts is caught at the caller.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ompi_tpu_torch.check.lint import cfg as cfg_mod
from ompi_tpu_torch.check.lint.dataflow import rank_sources, rank_taint
from ompi_tpu_torch.check.lint.model import (
    COLLECTIVES, Finding, ModuleContext, _call_name,
    _method_call_name, _unparse, own_walk,
)

#: (op, comm-or-helper source, line)
_Coll = Tuple[str, str, int]


def _has_rank_read(scope: ast.AST) -> bool:
    for n in own_walk(scope):
        if isinstance(n, ast.Attribute) and n.attr == "rank":
            return True
        if isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("Get_rank", "get_rank"):
            return True
    return False


def _block_collectives(ctx: ModuleContext,
                       graph) -> Dict[int, List[_Coll]]:
    out: Dict[int, List[_Coll]] = {}
    for bid, block in graph.blocks.items():
        seq: List[_Coll] = []
        for stmt in block.stmts:
            for node in own_walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                op = _method_call_name(node)
                if op in COLLECTIVES:
                    seq.append((op,
                                _unparse(node.func.value),  # type: ignore
                                node.lineno))
                    continue
                if ctx.project is None:
                    continue
                callee = _call_name(node)
                if callee is None or callee in COLLECTIVES:
                    continue
                for eop, _esrc in ctx.project.collective_effect(
                        callee, prefer_path=ctx.path):
                    # helper effect: attributed to the helper so both
                    # arms calling the same helper stay symmetric
                    seq.append((eop, f"{callee}()", node.lineno))
        if seq:
            out[bid] = seq
    return out


def _filtered(seq: List[_Coll],
              comms: Set[str]) -> List[Tuple[str, str]]:
    """The comparable projection: collectives on one of the rank-
    tested comms, plus helper effects (whose comm is unknown — they
    must match positionally across arms)."""
    return [(op, src) for op, src, _ in seq
            if src in comms or src.endswith("()")]


def _render(seq: List[_Coll], comms: Set[str]) -> str:
    kept = [f"{op}@{ln}" for op, src, ln in seq
            if src in comms or src.endswith("()")]
    return "[" + ", ".join(kept) + "]"


def _divergent_segments(pa, pb) -> Optional[Tuple[int, list, list]]:
    """Where two paths split and what each runs until they first
    re-converge: (branch block id, A's arm blocks, B's arm blocks)."""
    a, b = pa.blocks, pb.blocks
    p = 0
    while p < len(a) and p < len(b) and a[p] == b[p]:
        p += 1
    if p == 0 or p >= len(a) or p >= len(b):
        return None         # identical or one a prefix (can't happen)
    b_rest = set(b[p:])
    join_a = next((i for i in range(p, len(a)) if a[i] in b_rest),
                  len(a))
    join_block = a[join_a] if join_a < len(a) else None
    join_b = b.index(join_block, p) if join_block is not None \
        else len(b)
    return a[p - 1], list(a[p:join_a]), list(b[p:join_b])


def rule_collective_order_divergence(
        ctx: ModuleContext) -> List[Finding]:
    out: List[Finding] = []
    scopes = [ctx.tree] + list(ctx.functions())
    for scope in scopes:
        if not _has_rank_read(scope):
            continue
        # taint is recomputed per branch-test line: an assignment can
        # only taint a test it lexically precedes, so the cache-fill
        # idiom (``if x is None: x = f(comm.rank)``) does not make
        # its own guard "rank-dependent"
        taints: Dict[int, Dict[str, Set[str]]] = {}
        graph = ctx.cfg_of(scope)
        by_block = _block_collectives(ctx, graph)
        if not by_block:
            continue
        paths = cfg_mod.paths(graph)
        ctx.bump("cfg_paths", len(paths))
        if len(paths) < 2:
            continue
        reported: Set[int] = set()
        for i in range(len(paths)):
            for j in range(i + 1, len(paths)):
                split = _divergent_segments(paths[i], paths[j])
                if split is None:
                    continue
                bid, arm_a, arm_b = split
                branch = graph.blocks[bid]
                if branch.test is None or branch.test_line in reported:
                    continue
                taint = taints.get(branch.test_line)
                if taint is None:
                    taint = taints[branch.test_line] = rank_taint(
                        scope, before_line=branch.test_line)
                comms = rank_sources(branch.test, taint)
                if not comms:
                    continue
                seq_a = [c for blk in arm_a
                         for c in by_block.get(blk, ())]
                seq_b = [c for blk in arm_b
                         for c in by_block.get(blk, ())]
                if _filtered(seq_a, comms) == _filtered(seq_b, comms):
                    continue
                reported.add(branch.test_line)
                src = sorted(comms)[0]
                out.append(Finding(
                    "collective-order-divergence", ctx.path,
                    branch.test_line,
                    "collective order diverges under the rank-"
                    f"dependent branch at line {branch.test_line} "
                    f"(tests {src}.rank): the path "
                    f"[{paths[i].describe()}] runs "
                    f"{_render(seq_a, comms)} but the path "
                    f"[{paths[j].describe()}] runs "
                    f"{_render(seq_b, comms)} — ranks can disagree "
                    "on collective order (deadlock risk)"))
    return out
