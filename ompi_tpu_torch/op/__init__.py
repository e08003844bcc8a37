"""Reduction operations (MPI_Op).

Reference: ompi/mca/op/ (op.h:56-75) and the JAX package's
``ompi_tpu.op``. Every builtin op is named here, so a call can take it
and a component can refuse it by name; the device kernels implement
SUM/PROD/MIN/MAX (their elementwise combine is
:func:`ompi_tpu_torch.coll.cuda_kernels.combine`, plain, and the CUDA
kernels' ``Combine``, ``coll/csrc/combine.cuh``), and the one-sided
window's apply kernels REPLACE too.
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
LAND = Op("MPI_LAND")
LOR = Op("MPI_LOR")
LXOR = Op("MPI_LXOR")
BAND = Op("MPI_BAND")
BOR = Op("MPI_BOR")
BXOR = Op("MPI_BXOR")
MINLOC = Op("MPI_MINLOC")
MAXLOC = Op("MPI_MAXLOC")
REPLACE = Op("MPI_REPLACE")
NO_OP = Op("MPI_NO_OP")

BUILTIN = {op.name: op for op in (
    SUM, PROD, MIN, MAX, LAND, LOR, LXOR, BAND, BOR, BXOR,
    MINLOC, MAXLOC, REPLACE, NO_OP)}
