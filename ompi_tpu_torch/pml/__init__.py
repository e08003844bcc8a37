"""PML — point-to-point messaging layer.

The port's counterpart of ``ompi_tpu.pml`` (reference: ompi/mca/pml/,
pml.h:157-515; exactly one PML per job, ompi/instance/instance.c:535):
:mod:`.ob1` over the btls, selected by ``runtime/state`` at MPI_Init and
finalized at MPI_Finalize; :mod:`.request`;
:mod:`.accel_p2p`, device-tensor point-to-point through pipelined pinned
staging; ob1's tool attachments, :mod:`.peruse` (queue-event callbacks)
and :mod:`.custommatch` (the indexed matching engine); and the
interposition layers that wrap the selected PML (:func:`set_current`):
:mod:`.vprotocol` (pml/v message logging) and :mod:`.monitoring` (the
monitoring plane).
"""

from __future__ import annotations

from typing import Optional

_pml = None


def select():
    """Select and enable the PML (mca_pml_base_select)."""
    global _pml
    if _pml is None:
        from ompi_tpu_torch.pml.ob1 import Ob1

        p = Ob1()
        p.enable()
        _pml = p
    return _pml


def current():
    return select() if _pml is None else _pml


def instance() -> Optional[object]:
    """The selected PML, or None before selection (no side effects)."""
    return _pml


def set_current(pml) -> None:
    """Install an interposition PML (reference: pml/monitoring, pml/v)."""
    global _pml
    _pml = pml


def finalize() -> None:
    global _pml
    if _pml is not None:
        _pml.disable()
        _pml = None
