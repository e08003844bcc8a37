"""The monitoring plane's guards — the part of :mod:`ompi_tpu.monitoring`
that the port's callers reach so far.

The reference's plane keeps per-rank traffic matrices in
``matrix.TRAFFIC`` once ``monitoring_level`` turns it on; it is off by
default, and every feed is then one branch. The port has no matrices
yet (ROADMAP item 10): :data:`matrix.TRAFFIC` stays None, and
:func:`expert_load`, the feed that ``ops/moe.py`` and
``DeviceCommunicator.record_expert_load`` call, is the reference's guard
(``ompi_tpu/monitoring/__init__.py:157-165``), reading the one
``TRAFFIC`` there is. :mod:`~ompi_tpu_torch.monitoring.algo` holds the
per-level byte models coll/hier records.
"""

from __future__ import annotations


def expert_load(counts) -> None:
    """Record per-expert token counts on the plane
    (``monitoring_expert_tokens``); one branch when off."""
    from ompi_tpu_torch.monitoring import matrix as _matrix

    tm = _matrix.TRAFFIC
    if tm is not None:
        tm.expert_tokens(counts)
