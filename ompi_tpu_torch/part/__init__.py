"""ompi_tpu_torch.part — MPI-4 partitioned communication.

The port's copy of ``ompi_tpu.part`` (reference: ompi/mca/part,
part.h:124-185, and part/persist): partitioned operations are persistent
requests whose payload is split into partitions the application hands
over one by one.

- :mod:`.host`: partitioned point-to-point (``Comm.Psend_init`` /
  ``Precv_init``, ``Pready`` / ``Pready_range`` / ``Pready_list`` /
  ``Parrived``) over ob1, one message per partition; attaches the
  Communicator methods at import.
- The device collectives ``Comm.Pallreduce_init`` and
  ``Comm.Preduce_scatter_init`` (coll/device's
  ``PartitionedAllreduceRequest`` / ``PartitionedReduceScatterRequest``):
  one partition per pytree leaf, a bucket's collective launched the
  moment its last leaf is ready (bound in :mod:`ompi_tpu_torch.mpi`).
- :mod:`.overlap`: :class:`GradientSync` and :class:`ZeroGradientSync`,
  the backward-hook pattern over those, and :class:`LayerPrefetcher`,
  stage 3's run-ahead scheduler.
- :mod:`.partial`: :class:`PartialAvailability`, the ``Parrived``
  family with MPI 4.0 §4.2's erroneous-call policy.

``ompi_tpu_torch.pml.part`` stays as a shim over :mod:`.host`.
"""

from ompi_tpu_torch.part import host  # noqa: F401  (attaches at import)
from ompi_tpu_torch.part.host import (  # noqa: F401
    MAX_PARTITIONS, MAX_TAG, PartitionedRecvRequest, PartitionedSendRequest,
)
from ompi_tpu_torch.part.overlap import (  # noqa: F401
    GradientSync, LayerPrefetcher, ZeroGradientSync,
)
from ompi_tpu_torch.part.partial import PartialAvailability  # noqa: F401
