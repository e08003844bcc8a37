"""hook framework — init / finalize interception points.

The port's copy of ``ompi_tpu.core.hook`` (reference: ompi/mca/hook/:
components get callbacks at well-defined points of MPI_Init and
MPI_Finalize; the shipped ``comm_method`` component prints the selected
transport matrix at init, ``mpirun --mca ompi_display_comm mpi``). A
registry of (at_init, at_finalize) callables that ``runtime/state`` runs
at the end of Init and at the start of Finalize, plus the built-in
comm_method hook under the ``hook_comm_method`` cvar.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Tuple

from ompi_tpu_torch.core import cvar, output

_out = output.stream("hook")

_hooks: List[Tuple[Optional[Callable], Optional[Callable]]] = []

_comm_method_var = cvar.register(
    "hook_comm_method", 0, int,
    help="Print the transport matrix (which BTL reaches each peer) "
         "at MPI_Init, like the reference's hook/comm_method "
         "(ompi_display_comm). 0=off, 1=rank 0 prints the full "
         "world matrix.", level=5)


def register(at_init: Optional[Callable] = None,
             at_finalize: Optional[Callable] = None) -> None:
    """Register interception callbacks: ``at_init(world_comm)`` runs at
    the end of MPI_Init, ``at_finalize()`` at the start of Finalize."""
    _hooks.append((at_init, at_finalize))


def run_init(world) -> None:
    if _comm_method_var.get():
        _comm_method(world)
    for init_fn, _ in _hooks:
        if init_fn is not None:
            try:
                init_fn(world)
            except Exception as exc:  # noqa: BLE001 — a hook never
                _out.verbose(1, "init hook failed: %s", exc)  # kills Init


def run_finalize() -> None:
    for _, fini_fn in _hooks:
        if fini_fn is not None:
            try:
                fini_fn()
            except Exception as exc:  # noqa: BLE001
                _out.verbose(1, "finalize hook failed: %s", exc)


def _comm_method(world) -> None:
    """The comm_method transport matrix: every rank reports which btl its
    bml endpoint selects per peer; rank 0 prints the table (reference:
    hook/comm_method's 2-D method table)."""
    from ompi_tpu_torch import pml

    p = pml.current()
    row = []
    for peer in range(world.size):
        if peer == world.rank:
            row.append("self")
            continue
        try:
            row.append(p.bml.endpoint(world.group.ranks[peer]).NAME)
        except Exception:  # noqa: BLE001 — an unreachable peer
            row.append("?")
    rows = world.allgather(row)
    if world.rank == 0:
        width = max(4, max(len(x) for r in rows for x in r))
        hdr = "      " + " ".join(f"{i:>{width}}" for i in range(world.size))
        lines = ["transport matrix (hook/comm_method analog):", hdr]
        for i, r in enumerate(rows):
            lines.append(f"{i:>5} " + " ".join(f"{x:>{width}}" for x in r))
        print("\n".join(lines), file=sys.stderr, flush=True)
