"""Compat shim: partitioned point-to-point lives in
:mod:`ompi_tpu_torch.part` (``part.host``), as in the reference
(``ompi_tpu.pml.part``). Importing it attaches ``Comm.Psend_init`` /
``Precv_init``."""

from ompi_tpu_torch.part.host import (  # noqa: F401
    MAX_PARTITIONS, MAX_TAG, PartitionedRecvRequest,
    PartitionedSendRequest, _Precv_init, _Psend_init, attach,
)
