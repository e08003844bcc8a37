"""Reduction operations (MPI_Op) — host functions and user-defined ops.

Reference: ompi/mca/op/ (op.h:56-75), MPI_Reduce_local
(ompi/mpi/c/reduce_local.c) and the JAX package's ``ompi_tpu.op``. Every
op carries its elementwise numpy function (``np_fn``), which the host
collectives (coll/basic, base_algos, libnbc, coll/accelerator's staging)
fold with; MINLOC and MAXLOC combine ``(val, loc)`` records of the pair
datatypes (``datatype.FLOAT_INT`` and the rest). The device kernels read
only ``.name``: they implement SUM/PROD/MIN/MAX (their elementwise
combine is :func:`ompi_tpu_torch.coll.cuda_kernels.combine`, plain, and
the CUDA kernels' ``Combine``, ``coll/csrc/combine.cuh``), and the
one-sided window's apply kernels REPLACE too.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class Op:
    """An MPI reduction operator: ``np_fn(a, b)`` elementwise over numpy
    arrays, ``commute`` as MPI_Op_create's flag."""

    def __init__(self, name: str, np_fn: Callable,
                 commute: bool = True) -> None:
        self.name = name
        self.np_fn = np_fn
        self.commute = commute

    def __call__(self, a, b):
        return self.np_fn(a, b)

    def __repr__(self) -> str:
        return f"Op({self.name})"


def _minloc(a, b):
    """MINLOC over (val, loc) records: the lower loc wins ties."""
    take_b = (b["val"] < a["val"]) | ((b["val"] == a["val"])
                                      & (b["loc"] < a["loc"]))
    return np.where(take_b, b, a)


def _maxloc(a, b):
    take_b = (b["val"] > a["val"]) | ((b["val"] == a["val"])
                                      & (b["loc"] < a["loc"]))
    return np.where(take_b, b, a)


SUM = Op("MPI_SUM", np.add)
PROD = Op("MPI_PROD", np.multiply)
MIN = Op("MPI_MIN", np.minimum)
MAX = Op("MPI_MAX", np.maximum)
LAND = Op("MPI_LAND", np.logical_and)
LOR = Op("MPI_LOR", np.logical_or)
LXOR = Op("MPI_LXOR", np.logical_xor)
BAND = Op("MPI_BAND", np.bitwise_and)
BOR = Op("MPI_BOR", np.bitwise_or)
BXOR = Op("MPI_BXOR", np.bitwise_xor)
MINLOC = Op("MPI_MINLOC", _minloc)
MAXLOC = Op("MPI_MAXLOC", _maxloc)
REPLACE = Op("MPI_REPLACE", lambda a, b: b, commute=False)
NO_OP = Op("MPI_NO_OP", lambda a, b: a, commute=False)

BUILTIN = {op.name: op for op in (
    SUM, PROD, MIN, MAX, LAND, LOR, LXOR, BAND, BOR, BXOR,
    MINLOC, MAXLOC, REPLACE, NO_OP)}


def create(fn: Callable, commute: bool = True, name: str = "user") -> Op:
    """MPI_Op_create: ``fn(invec, inoutvec)`` returns the elementwise
    result."""
    return Op(name, fn, commute=commute)


def reduce_local(inbuf: np.ndarray, inoutbuf: np.ndarray, op: Op) -> None:
    """MPI_Reduce_local: ``inoutbuf = op(inbuf, inoutbuf)`` in place;
    ``inbuf`` is the left operand (it matters to a non-commutative op)."""
    if isinstance(op.np_fn, np.ufunc):
        op.np_fn(inbuf, inoutbuf, out=inoutbuf, casting="same_kind")
    else:
        np.copyto(inoutbuf, op.np_fn(inbuf, inoutbuf), casting="same_kind")


def apply_bytes(a: bytes, b, np_dtype, op: Op) -> None:
    """Reduce packed byte buffers in place, ``b = op(a, b)``; ``b`` is
    writable (a bytearray or a writable memoryview)."""
    ia = np.frombuffer(a, dtype=np_dtype)
    ib = np.frombuffer(b, dtype=np_dtype)
    ib[:] = op.np_fn(ia, ib)
