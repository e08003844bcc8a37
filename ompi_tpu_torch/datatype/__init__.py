"""Datatype engine — MPI derived datatypes and the pack / unpack
convertor.

The port's copy of ``ompi_tpu.datatype`` (reference: opal/datatype/, the
convertor that walks a compiled description with partial-completion
state, and ompi/datatype/, the MPI face). The compiled form is a flat
span table of (offset, length) byte ranges in numpy arrays: the host
convertor (``convertor.py``) packs by vectorized gather / scatter over a
byte view, windowed for big counts, with the heterogeneous byte swap and
external32; the device convertor (``device.py``) compiles the same table
to an element-index vector and packs a ``torch.Tensor`` on its own card.
"""

from ompi_tpu_torch.datatype.datatype import (  # noqa: F401
    BFLOAT16, BOOL, BYTE, CHAR, COMPLEX64, COMPLEX128, DISTRIBUTE_BLOCK,
    DISTRIBUTE_CYCLIC, DISTRIBUTE_DFLT_DARG, DISTRIBUTE_NONE, DOUBLE,
    DOUBLE_INT, FLOAT, FLOAT16, FLOAT_INT, INT, INT8, INT16, INT32, INT64,
    LONG, LONG_INT, PACKED, PAIR_TYPES, PREDEFINED, SHORT_INT, TWOINT,
    UINT8, UINT16, UINT32, UINT64, Datatype, contiguous, create_struct,
    darray, from_numpy_dtype, hindexed, hvector, indexed, indexed_block,
    resized, subarray, vector,
)
from ompi_tpu_torch.datatype.convertor import Convertor, dtype_of  # noqa: F401
