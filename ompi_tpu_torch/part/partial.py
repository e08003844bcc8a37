"""Partial availability: the MPI-4 ``Parrived`` probe family.

The port's copy of ``ompi_tpu.part.partial`` (part/partial.py:35-71):

- ``Parrived(i)``: nonblocking, has piece ``i`` completed?
- ``Parrived_range(lo, hi)`` / ``Parrived_list(idxs)``: the grouped
  probes, mirroring ``Pready_range`` / ``Pready_list`` on the send side
  (MPI 4.0 §4.2.4).
- Probing a request that was never started is erroneous and raises
  ``MPIError(ERR_REQUEST)`` (MPI 4.0 §4.2).

A concrete request implements ``_partial_started()`` (ever started?),
``_partial_probe(idx)`` (one nonblocking poll; the index check lives
there) and the class attribute ``_PARRIVED_PVAR``, the counter a
successful probe records. The reference shares the mixin with its
streaming ingest plane, which the port does not have.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import pvar


class PartialAvailability:
    """Mixin: the ``Parrived`` probes over the request's hooks."""

    #: counter recorded on each successful probe (None: record nothing)
    _PARRIVED_PVAR: Optional[str] = None

    def _partial_started(self) -> bool:
        raise NotImplementedError

    def _partial_probe(self, idx: int) -> bool:
        raise NotImplementedError

    def Parrived(self, idx: int) -> bool:
        if not self._partial_started():
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"Parrived({idx}): request never started — nothing is in "
                "flight to probe (MPI 4.0 §4.2)")
        # no completed-request fast path: an out-of-range index is
        # erroneous even after everything arrived
        ok = self._partial_probe(idx)
        if ok and self._PARRIVED_PVAR is not None:
            pvar.record(self._PARRIVED_PVAR)
        return ok

    def Parrived_range(self, lo: int, hi: int) -> bool:
        """True when every piece in [lo, hi] (inclusive, as
        ``Pready_range``) has completed."""
        return all(self.Parrived(i) for i in range(lo, hi + 1))

    def Parrived_list(self, idxs: Iterable[int]) -> bool:
        return all(self.Parrived(i) for i in idxs)
