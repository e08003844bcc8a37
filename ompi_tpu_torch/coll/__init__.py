"""Collectives framework — per-communicator priority-stacked tables.

Reference: ompi/mca/coll/ — coll.h:532-649 (the per-comm function table),
coll_base_comm_select.c:236-330 (all enabled components stacked in
ascending priority, each overriding the slots it implements; disqualify on
priority<0). The port has three components so far: ``basic`` (priority
10, every comm: ``allgather_obj``, ``bcast_obj`` and ``barrier`` over
the runtime store), ``device`` (priority 50, the coll/xla counterpart:
its fixed device slot table, blocking, nonblocking and persistent, on
every comm the device plane serves and on every one-rank comm) and
``cuda`` (priority 60, opt-in: the hand-written ring kernels,
the counterpart of coll/pallas, falling through to ``device`` for what
they do not take). The host collectives come in later slices, so a slot
no component provides raises ``MPIError(ERR_NOT_SUPPORTED)``.
"""

from __future__ import annotations

from typing import Dict

from ompi_tpu_torch import errors
from ompi_tpu_torch.coll.basic import CollBasic
from ompi_tpu_torch.coll.cuda import CollCuda
from ompi_tpu_torch.coll.device import CollDevice
from ompi_tpu_torch.core import output

_out = output.stream("coll_base")

#: the components comm_select ranks: each has NAME, query(comm) -> priority
#: (< 0 disqualifies) and slots(comm) -> {slot name: function}
COMPONENTS = (CollBasic, CollDevice, CollCuda)


class CollTable:
    """The stacked per-communicator table (comm.coll)."""

    def __init__(self) -> None:
        self.fns: Dict[str, callable] = {}
        self.providers: Dict[str, str] = {}

    def __getattr__(self, name):
        if name.startswith("_"):  # copy/pickle probes stay AttributeErrors
            raise AttributeError(name)
        try:
            return self.fns[name]
        except KeyError:
            raise errors.MPIError(
                errors.ERR_NOT_SUPPORTED,
                f"no coll component provides '{name}' on this "
                "communicator (device collectives on more than one rank "
                "need --mca device_plane on; host collectives come with "
                "the pml slice)") from None


def comm_select(comm) -> None:
    """Stack all qualifying components in ascending priority
    (higher priority installs last, overriding lower)."""
    table = CollTable()
    ranked = []
    for comp in (cls() for cls in COMPONENTS):
        pri = comp.query(comm)
        if pri >= 0:
            ranked.append((pri, comp))
    ranked.sort(key=lambda t: t[0])  # ascending: high pri wins
    for _, comp in ranked:
        for slot, fn in comp.slots(comm).items():
            table.fns[slot] = fn
            table.providers[slot] = comp.NAME
    comm.coll = table
    _out.verbose(5, "comm %s coll table: %s", getattr(comm, "name", "?"),
                 table.providers)
