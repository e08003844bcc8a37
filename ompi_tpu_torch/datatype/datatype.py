"""Predefined MPI datatypes.

The port's reduction of ``ompi_tpu.datatype.datatype`` (reference:
ompi/datatype/ompi_datatype_internal.h, the predefined types) to the
contiguous, predefined types: ``BYTE``, the numeric types and
``from_numpy_dtype``. A predefined type is one contiguous span of
``size`` bytes. Derived types (vector, indexed, struct, subarray, ...)
and their span tables come with the datatype engine in ROADMAP queue 1
item 4; their constructors raise ``MPIError(ERR_NOT_SUPPORTED)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ompi_tpu_torch import errors

#: where derived datatypes are waiting
DERIVED_ITEM = ("derived datatypes come with the datatype engine "
                "(ROADMAP queue 1 item 4)")


class Datatype:
    """A predefined MPI datatype: ``size`` contiguous bytes per element,
    whose numpy element type is ``base`` (None for BFLOAT16, which numpy
    lacks)."""

    __slots__ = ("size", "extent", "lb", "base", "name")

    def __init__(self, size: int, base: Optional[np.dtype],
                 name: str) -> None:
        self.size = int(size)
        self.extent = int(size)
        self.lb = 0
        self.base = base
        self.name = name

    def Get_size(self) -> int:
        """MPI_Type_size."""
        return self.size

    def Get_extent(self):
        """MPI_Type_get_extent -> (lb, extent)."""
        return self.lb, self.extent

    @property
    def is_contiguous(self) -> bool:
        return True

    def commit(self) -> "Datatype":
        return self

    def __repr__(self) -> str:
        return f"Datatype({self.name}, size={self.size})"


def _predef(np_dtype, name: str) -> Datatype:
    dt = np.dtype(np_dtype)
    return Datatype(dt.itemsize, dt, name)


BYTE = _predef(np.uint8, "MPI_BYTE")
PACKED = _predef(np.uint8, "MPI_PACKED")
CHAR = _predef(np.int8, "MPI_CHAR")
INT8 = _predef(np.int8, "MPI_INT8_T")
UINT8 = _predef(np.uint8, "MPI_UINT8_T")
INT16 = _predef(np.int16, "MPI_INT16_T")
UINT16 = _predef(np.uint16, "MPI_UINT16_T")
INT32 = _predef(np.int32, "MPI_INT32_T")
UINT32 = _predef(np.uint32, "MPI_UINT32_T")
INT64 = _predef(np.int64, "MPI_INT64_T")
UINT64 = _predef(np.uint64, "MPI_UINT64_T")
INT = INT32
LONG = INT64
FLOAT = _predef(np.float32, "MPI_FLOAT")
DOUBLE = _predef(np.float64, "MPI_DOUBLE")
FLOAT16 = _predef(np.float16, "MPI_FLOAT16")
BFLOAT16 = Datatype(2, None, "MPI_BFLOAT16")
BOOL = _predef(np.bool_, "MPI_C_BOOL")
COMPLEX64 = _predef(np.complex64, "MPI_C_FLOAT_COMPLEX")
COMPLEX128 = _predef(np.complex128, "MPI_C_DOUBLE_COMPLEX")

PREDEFINED = {
    d.name: d for d in (
        BYTE, PACKED, CHAR, INT8, UINT8, INT16, UINT16, INT32, UINT32,
        INT64, UINT64, FLOAT, DOUBLE, FLOAT16, BFLOAT16, BOOL, COMPLEX64,
        COMPLEX128)
}

_NP_CACHE: Dict[str, Datatype] = {}


def from_numpy_dtype(dt) -> Datatype:
    """Map a numpy dtype to a (cached) predefined Datatype; an element
    type no predefined name covers gets a contiguous type of its own
    size, as the reference's ``MPI_NP_*`` types."""
    dt = np.dtype(dt)
    key = dt.str if dt.names is None else str(dt)
    got = _NP_CACHE.get(key)
    if got is None:
        if dt.name == "bfloat16":
            got = BFLOAT16
        else:
            got = next((d for d in PREDEFINED.values() if d.base == dt),
                       None) or _predef(dt, f"MPI_NP_{key}")
        _NP_CACHE[key] = got
    return got


def derived(*args, **kwargs):
    """Every derived-datatype constructor of the reference (contiguous,
    vector, hvector, indexed, hindexed, indexed_block, create_struct,
    subarray, resized, darray): not in this slice."""
    raise errors.MPIError(errors.ERR_NOT_SUPPORTED, DERIVED_ITEM)


contiguous = vector = hvector = indexed = hindexed = indexed_block = \
    create_struct = subarray = resized = darray = derived
