"""Collectives framework — per-communicator priority-stacked tables.

Reference: ompi/mca/coll/ — coll.h:532-649 (the per-comm function table),
coll_base_comm_select.c:236-330 (all enabled components stacked in
ascending priority, each overriding the slots it implements; disqualify on
priority<0), and ``ompi_tpu.coll``. The port's components:

- ``basic`` (10, every comm): the linear host algorithms, the object
  collectives and the barrier over the pml;
- ``libnbc`` (20): the host ``I*`` and ``*_init`` forms as progressed
  schedules;
- ``tuned`` (30, comms of two ranks or more): the decision rules over
  the base algorithm library (``coll/base_algos.py``);
- ``accelerator`` (40, every comm): device tensors staged through the
  host slots, for the comms the device plane does not serve and for
  what coll/device hands it;
- ``device`` (50): the coll/xla counterpart, its fixed device slot
  table, on every comm the device plane serves and on every one-rank
  comm;
- ``cuda`` (60, opt-in): the hand-written ring kernels, the
  counterpart of coll/pallas, falling through to ``device``;
- ``hier`` (70, opt-in): the two-level schedules over a comm's low and
  up splits, falling through to ``cuda`` or ``device``;
- ``han`` (``coll_han_priority``, 35; under ``coll_han_split``, on comms
  of four ranks or more spanning nodes): the two-level host
  collectives;
- ``adapt`` (opt-in, ``coll_adapt_priority``): segmented ibcast /
  ireduce;
- ``sync`` (90, with ``coll_sync_barrier_before``): no slot of its own;
  its ``post_stack`` wraps the stacked host slots;
- ``inter`` (45, intercommunicators only): the group-vs-group
  collectives. Only a component with ``INTER_OK`` stacks on an
  intercommunicator (the gate is here, ompi_tpu/coll/__init__.py:115-120):
  the intra algorithms assume one group.

On a topology comm (``comm.topo``, attached by :mod:`ompi_tpu_torch.topo`,
which re-runs :func:`comm_select`) coll/basic adds the host neighbourhood
slots, coll/libnbc their ``ineighbor_*`` forms, coll/accelerator the
staging ``neighbor_*_dev`` slots and coll/device its own
(:mod:`ompi_tpu_torch.coll.device_neighbor`), which win where the device
plane is up.

The components register with the registry's ``coll`` framework
(``core/registry.py``), whose cvar of the same name includes or
excludes them (``--mca coll ^hier``); :func:`comm_select` ranks the
opened ones per communicator, as ``ompi_tpu/coll/__init__.py:110-145``
does.

Collective traffic runs in the communicator's collective context with a
per-comm tag sequence (:meth:`CollTable.next_tag`), so user p2p never
interferes. A slot no component provides raises
``MPIError(ERR_NOT_SUPPORTED)``.
"""

from __future__ import annotations

from typing import Dict

from ompi_tpu_torch import errors
from ompi_tpu_torch.coll.accelerator import CollAccelerator
from ompi_tpu_torch.coll.adapt import CollAdapt
from ompi_tpu_torch.coll.basic import CollBasic
from ompi_tpu_torch.coll.cuda import CollCuda
from ompi_tpu_torch.coll.device import CollDevice
from ompi_tpu_torch.coll.han import CollHan
from ompi_tpu_torch.coll.hier import CollHier
from ompi_tpu_torch.coll.inter import CollInter
from ompi_tpu_torch.coll.libnbc import CollLibnbc
from ompi_tpu_torch.coll.sync import CollSync
from ompi_tpu_torch.coll.tuned import CollTuned
from ompi_tpu_torch.core import output, registry

_out = output.stream("coll_base")

framework = registry.framework("coll")

#: the components comm_select ranks: each has NAME, query(comm) -> priority
#: (< 0 disqualifies) and slots(comm) -> {slot name: function}; one may
#: have post_stack(comm, table), run once every component has stacked
for _cls in (CollBasic, CollLibnbc, CollTuned, CollHan, CollAccelerator,
             CollDevice, CollCuda, CollHier, CollAdapt, CollSync,
             CollInter):
    framework.register(_cls)
del _cls

#: the blocking and object host slots (coll.h's function-pointer members,
#: ompi_tpu/coll/__init__.py:32-64), the ones coll/sync wraps beside the
#: ``i*`` forms
SLOTS = (
    "barrier", "bcast", "reduce", "allreduce", "gather", "gatherv",
    "scatter", "scatterv", "allgather", "allgatherv", "alltoall",
    "alltoallv", "reduce_scatter", "reduce_scatter_block", "scan",
    "exscan", "reduce_local",
    "bcast_obj", "gather_obj", "scatter_obj", "allgather_obj",
    "alltoall_obj", "allreduce_obj",
)


class CollTable:
    """The stacked per-communicator table (comm.coll)."""

    def __init__(self) -> None:
        self.fns: Dict[str, callable] = {}
        self.providers: Dict[str, str] = {}
        self.seq = 0

    def next_tag(self) -> int:
        """The pml tag of the comm's next collective (every member calls
        a comm's collectives in the same order)."""
        self.seq += 1
        return self.seq & 0x3FFFFFFF

    def __getattr__(self, name):
        if name.startswith("_"):  # copy/pickle probes stay AttributeErrors
            raise AttributeError(name)
        try:
            return self.fns[name]
        except KeyError:
            raise errors.MPIError(
                errors.ERR_NOT_SUPPORTED,
                f"no coll component provides '{name}' on this "
                "communicator (the neighbourhood slots exist on topology "
                "comms only: Create_cart, Create_graph, "
                "Create_dist_graph[_adjacent])") from None


def comm_select(comm) -> None:
    """Stack all qualifying components in ascending priority (higher
    priority installs last, overriding lower), then run their
    ``post_stack`` hooks over the finished table (coll/sync's
    interposition, ompi_tpu/coll/__init__.py:137-143)."""
    table = CollTable()
    ranked = []
    is_inter = getattr(comm, "is_inter", False)
    for comp in framework.open_components():
        if is_inter and not getattr(comp, "INTER_OK", False):
            continue  # intra algorithms never stack on an intercomm
        pri = comp.query(comm)
        if pri >= 0:
            ranked.append((pri, comp))
    ranked.sort(key=lambda t: t[0])  # ascending: high pri wins
    for _, comp in ranked:
        for slot, fn in comp.slots(comm).items():
            table.fns[slot] = fn
            table.providers[slot] = comp.NAME
    for _, comp in ranked:
        hook = getattr(comp, "post_stack", None)
        if hook is not None:
            hook(comm, table)
    comm.coll = table
    _out.verbose(5, "comm %s coll table: %s", getattr(comm, "name", "?"),
                 table.providers)
