"""pml/monitoring — the interposition PML feeding the monitoring plane
(the port of :mod:`ompi_tpu.pml.monitoring`).

Reference: ompi/mca/pml/monitoring + common/monitoring: a PML that wraps
the selected one and counts messages and bytes per destination. The
matrices live in :mod:`ompi_tpu_torch.monitoring.matrix`; this layer is
the send-path interposition plus the historical module API
(:func:`install`, :func:`installed`, :func:`uninstall`, :func:`matrix`,
:func:`dump`).

Peer translation goes through the comm's group (``matrix.world_rank``);
a peer outside it raises ``MPIError(ERR_RANK)`` at the call. Window
service messages (tag :data:`_OSC_SERVICE_TAG`) are counted by the
window's own funnel with their payload bytes, not here; sends at or below
:data:`_PART_TAG_CEIL` are partitioned chunks (ctx ``part``).

``--mca pml_monitoring 1`` (deprecated) maps to ``monitoring_level 1``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from ompi_tpu_torch.core import cvar, output
from ompi_tpu_torch.monitoring import matrix as _matrix

_out = output.stream("pml_monitoring")

#: ``ompi_tpu_torch.osc._SERVICE_TAG``, not imported: osc imports the pml
_OSC_SERVICE_TAG = -64

#: ``ompi_tpu_torch.part.host._PART_BASE``, not imported: part imports
#: the pml; every partitioned-chunk isend rides a tag at or below it
_PART_TAG_CEIL = -(1 << 24)

_enable_var = cvar.register(
    "pml_monitoring", False, bool,
    help="DEPRECATED compat alias for --mca monitoring_level 1 "
         "(reference: pml/monitoring). The monitoring plane replaces "
         "this cvar; it keeps working via the compat mapping.",
    level=7)


class MonitoringPml:
    """Wraps the selected PML; counts every send, by its sender, into the
    plane's TRAFFIC matrix. Every other attribute is the inner PML's."""

    def __init__(self, inner) -> None:
        self._inner = inner

    @staticmethod
    def _count(comm, dst: int, nbytes: int, collective: bool,
               ns: int = 0, tag: int = 0) -> None:
        tm = _matrix.TRAFFIC
        if tm is None:
            return
        if tag <= _PART_TAG_CEIL:
            ctx = "part"
        else:
            ctx = "coll" if collective else "p2p"
        tm.count(ctx, _matrix.world_rank(comm, dst), nbytes, ns=ns)

    @staticmethod
    def _nbytes(buf, count, dtype) -> int:
        if dtype is not None and count:
            return count * dtype.size
        nb = getattr(buf, "nbytes", None)
        return nb if nb is not None else 0

    # -- the intercepted send-side entries --------------------------------
    def isend(self, comm, buf, count, dtype, dst, tag, **kw):
        self._count(comm, dst, self._nbytes(buf, count, dtype),
                    kw.get("collective", False), tag=tag)
        return self._inner.isend(comm, buf, count, dtype, dst, tag, **kw)

    def send(self, comm, buf, count, dtype, dst, tag, **kw):
        t0 = time.monotonic_ns()
        out = self._inner.send(comm, buf, count, dtype, dst, tag, **kw)
        self._count(comm, dst, self._nbytes(buf, count, dtype),
                    kw.get("collective", False),
                    ns=time.monotonic_ns() - t0, tag=tag)
        return out

    def isend_obj(self, comm, obj, dst, tag, **kw):
        if tag != _OSC_SERVICE_TAG:
            self._count(comm, dst, 0, kw.get("collective", False))
        return self._inner.isend_obj(comm, obj, dst, tag, **kw)

    def send_obj(self, comm, obj, dst, tag, **kw):
        if tag != _OSC_SERVICE_TAG:
            self._count(comm, dst, 0, kw.get("collective", False))
        return self._inner.send_obj(comm, obj, dst, tag, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def install() -> MonitoringPml:
    """Wrap the selected PML (idempotent); enables the matrices at level
    1 when the plane is not up yet."""
    from ompi_tpu_torch import pml

    if _matrix.TRAFFIC is None:
        from ompi_tpu_torch.runtime import rte

        _matrix.enable(rank=rte.rank, level=1, nranks=max(rte.size, 1))
    cur = pml.current()
    if isinstance(cur, MonitoringPml):
        return cur
    mon = MonitoringPml(cur)
    pml.set_current(mon)
    return mon


def installed() -> Optional[MonitoringPml]:
    """The monitoring layer anywhere in the interposition stack."""
    from ompi_tpu_torch import pml

    cur = pml.instance()
    while cur is not None:
        if isinstance(cur, MonitoringPml):
            return cur
        cur = getattr(cur, "_inner", None)
    return None


def uninstall() -> None:
    from ompi_tpu_torch import pml

    cur = pml.instance()
    if isinstance(cur, MonitoringPml):
        pml.set_current(cur._inner)


def matrix(collective: bool = False) -> Dict[int, Tuple[int, int]]:
    """Send-side ``{peer world rank: (msgs, bytes)}`` of the p2p (or
    coll) context."""
    tm = _matrix.TRAFFIC
    if tm is None:
        return {}
    return dict(sorted(
        tm.peer_totals("coll" if collective else "p2p").items()))


def dump() -> None:
    """common/monitoring-style matrix dump to the output stream."""
    tm = _matrix.TRAFFIC
    if tm is None:
        _out.verbose(0, "monitoring not installed")
        return
    for label in ("p2p", "coll"):
        for peer, (msgs, nbytes) in sorted(
                tm.peer_totals(label).items()):
            _out.verbose(0, "rank %d -> %d [%s]: %d msgs, %d bytes",
                         tm.rank, peer, label, msgs, nbytes)
