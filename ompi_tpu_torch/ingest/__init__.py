"""ompi_tpu_torch.ingest — the streaming ingest plane.

The port's copy of ``ompi_tpu.ingest``: a host pytree (restored
checkpoint state, a joining rank's parameters) goes up to the card as a
pipeline instead of one serial copy:

- **chunked multi-stream upload** through double-buffered pinned staging
  rings (cvars ``ingest_streams`` / ``ingest_chunk_bytes`` /
  ``ingest_depth``) over the accelerator's H2D stream pool;
- **compile / upload overlap**: ``overlap_compile`` runs the first-use
  build of the kernel libraries beside the upload;
- **partial availability**: the MPI-4 ``Parrived`` model (shared with
  :mod:`ompi_tpu_torch.part` through
  :class:`~ompi_tpu_torch.part.partial.PartialAvailability`): an
  :class:`~ompi_tpu_torch.ingest.plan.IngestPlan` cuts the pytree into
  units, the request exposes each one's completion, and
  :meth:`~ompi_tpu_torch.ingest.engine.IngestRequest.gate` starts the
  first step on the leaves it touches while the tail uploads.

Enable with ``--mca ingest_enable 1`` (or ``OMPI_TPU_INGEST=1``); the
live engine is the guard global ``ompi_tpu_torch.ingest.engine.INGEST``.
A standalone :class:`~ompi_tpu_torch.ingest.engine.IngestEngine` works
without the plane.
"""

from __future__ import annotations

from ompi_tpu_torch.ingest.engine import (  # noqa: F401 — re-exports
    IngestEngine, IngestRequest, default_put, disable, enable, requested,
    upload_for_restore)
from ompi_tpu_torch.ingest.plan import IngestPlan, Unit  # noqa: F401


def start(rank: int = 0) -> "IngestEngine":
    """Plane bring-up (runtime/state.init_instance)."""
    return enable(rank=rank)


def stop() -> None:
    """Plane teardown (runtime/state._release)."""
    disable()
