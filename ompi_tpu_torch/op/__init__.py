"""Reduction operations (MPI_Op).

Reference: ompi/mca/op/ (op.h:56-75) and the JAX package's
``ompi_tpu.op``. This slice carries the four ops the device kernels
implement; their elementwise combine is
:func:`ompi_tpu_torch.coll.cuda_kernels.combine` (plain) and the CUDA
kernels' ``Combine`` (csrc/ring_kernels.cu).
"""

from __future__ import annotations


class Op:
    """An MPI reduction operator, known by its MPI name."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __repr__(self) -> str:
        return f"Op({self.name})"


SUM = Op("MPI_SUM")
PROD = Op("MPI_PROD")
MIN = Op("MPI_MIN")
MAX = Op("MPI_MAX")

BUILTIN = {op.name: op for op in (SUM, PROD, MIN, MAX)}

