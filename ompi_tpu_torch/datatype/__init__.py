"""Datatypes — the predefined MPI types and a contiguous convertor.

The port's reduction of ``ompi_tpu.datatype`` (reference:
opal/datatype/ and ompi/datatype/) to what the point-to-point slice
moves: predefined types over numpy buffers. Derived datatypes raise
``MPIError(ERR_NOT_SUPPORTED)`` naming ROADMAP queue 1 item 4.
"""

from ompi_tpu_torch.datatype.datatype import (  # noqa: F401
    BFLOAT16, BOOL, BYTE, CHAR, COMPLEX64, COMPLEX128, DOUBLE, FLOAT,
    FLOAT16, INT, INT8, INT16, INT32, INT64, LONG, PACKED, PREDEFINED,
    UINT8, UINT16, UINT32, UINT64, Datatype, contiguous, create_struct,
    darray, from_numpy_dtype, hindexed, hvector, indexed, indexed_block,
    resized, subarray, vector,
)
from ompi_tpu_torch.datatype.convertor import Convertor, dtype_of  # noqa: F401
