"""The traffic-matrix guard (``ompi_tpu/monitoring/matrix.py:47``).

The reference keeps one ``TrafficMatrix`` per rank here while
``monitoring_level >= 1``; every instrumented site reads :data:`TRAFFIC`
and pays one branch when it is None. The port's matrices come with
ROADMAP item 10; until then the guard stays None, and its call sites
(coll/hier's per-level accounting, the expert load) are in place.
"""

from __future__ import annotations

#: this rank's traffic matrices (None: the plane is off). A live one has
#: ``coll(kind, comm, nbytes, dtype=, per_peer=)``, ``hier(kind, ici,
#: dcn, wire)`` and ``expert_tokens(counts)``.
TRAFFIC = None
