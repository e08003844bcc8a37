"""RMA epoch-lifecycle rules.

One lexical rule, same conservatism bar as ``pready-outside-start``:
it only reasons about windows it can SEE being created (a plain name
assigned from ``win_create``/``win_allocate``/``win_create_device``/
``win_create_cuda`` in the same scope), so a finding is an epoch
opener with provably no closer — a hang or an ERR_RMA_SYNC at
runtime, not a style nit. The port's copy of
``ompi_tpu/check/lint/rules/osc.py``: ``win_create_cuda`` (a
``CudaWindow``) takes the place of the reference's
``win_create_pallas``.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from ompi_tpu_torch.check.lint.model import (
    Finding, ModuleContext, _enclosing_scope, _method_call_name,
)

#: window-producing callees (method or bare function form)
WIN_PRODUCERS = frozenset((
    "win_create", "Win_create", "win_allocate", "Win_allocate",
    "win_create_device", "win_create_cuda",
))

#: epoch opener -> method names that close it on the same window
EPOCH_CLOSERS: Dict[str, frozenset] = {
    "Lock": frozenset(("Unlock", "Unlock_all")),
    "Lock_all": frozenset(("Unlock_all",)),
    "Start": frozenset(("Complete",)),
    "Post": frozenset(("Wait", "Test")),
}


def _producer_name(call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return ""


def rule_osc_unclosed_epoch(ctx: ModuleContext) -> List[Finding]:
    """An epoch opener (Lock/Lock_all/Start/Post) on a window created
    in this scope, with no matching closer (Unlock/Unlock_all/
    Complete/Wait) on the same window later in the scope. The access
    epoch never ends: peers block in Wait/Unlock handshakes and the
    window cannot Free."""
    tree, parents, path = ctx.tree, ctx.parents, ctx.path
    out: List[Finding] = []
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        opener = _method_call_name(call)
        if opener not in EPOCH_CLOSERS:
            continue
        recv = call.func.value  # type: ignore[union-attr]
        if not isinstance(recv, ast.Name):
            continue  # self._win.Lock(...) etc: cannot see the object
        win = recv.id
        scope = _enclosing_scope(call, parents)
        created = any(
            isinstance(other, ast.Assign)
            and isinstance(other.value, ast.Call)
            and _producer_name(other.value) in WIN_PRODUCERS
            and any(isinstance(t, ast.Name) and t.id == win
                    for t in other.targets)
            and other.lineno <= call.lineno
            for other in ast.walk(scope))
        if not created:
            continue  # window from elsewhere: out of scope, stay quiet
        closers = EPOCH_CLOSERS[opener]
        closed = any(
            isinstance(other, ast.Call)
            and _method_call_name(other) in closers
            and isinstance(other.func.value, ast.Name)
            and other.func.value.id == win
            and getattr(other, "lineno", 0) >= call.lineno
            for other in ast.walk(scope))
        if not closed:
            want = "/".join(sorted(closers))
            out.append(Finding(
                "osc-unclosed-epoch", path, call.lineno,
                f"{opener} on window '{win}' with no {want} later in "
                "the scope — the epoch never closes (peers hang in "
                "the sync handshake and Free cannot complete)"))
    return out
