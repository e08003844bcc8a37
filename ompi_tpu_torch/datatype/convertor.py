"""Convertor — pack/unpack with a byte position, for contiguous types.

The port's reduction of ``ompi_tpu.datatype.convertor`` (reference:
opal/datatype/opal_convertor.{h,c}, opal_convertor_pack/unpack with
position state for pipelined fragments) to what ob1 uses
(ob1.py:36-41, :251-258): ``packed_size``, a bounded ``pack`` from the
current position and an ``unpack`` at the fragment's offset. Every
predefined type is one contiguous span, so packing is a byte slice of
the buffer.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ompi_tpu_torch.datatype.datatype import Datatype, from_numpy_dtype

Buffer = Union[np.ndarray, bytearray, memoryview, bytes]


def _writable_byte_view(buf: Buffer) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return buf.view(np.uint8).reshape(-1)
    mv = memoryview(buf)
    if mv.readonly:
        raise ValueError("buffer not writable")
    return np.frombuffer(mv, dtype=np.uint8)


class Convertor:
    """Pack/unpack iterator over (buffer, datatype, count), tracking a
    byte position like the reference convertor's stack."""

    def __init__(self, buf: Buffer, dtype: Datatype, count: int) -> None:
        self.dtype = dtype
        self.count = count
        self.packed_size = dtype.size * count
        self.position = 0
        self._buf = buf

    def _flat(self, writable: bool) -> np.ndarray:
        if writable:
            return _writable_byte_view(self._buf)
        if isinstance(self._buf, np.ndarray):
            return self._buf.view(np.uint8).reshape(-1)
        return np.frombuffer(memoryview(self._buf), dtype=np.uint8)

    @property
    def done(self) -> bool:
        return self.position >= self.packed_size

    def set_position(self, pos: int) -> None:
        """Reposition (pipelined restart)."""
        self.position = pos

    def pack(self, max_bytes: Optional[int] = None) -> bytes:
        """Pack up to max_bytes from the current position; advances it."""
        start = self.position
        end = self.packed_size if max_bytes is None else \
            min(self.packed_size, start + max_bytes)
        if end <= start:
            return b""
        out = self._flat(writable=False)[start:end].tobytes()
        self.position = end
        return out

    def unpack(self, data: bytes) -> int:
        """Unpack bytes at the current position; returns bytes consumed
        (at most what is left of ``packed_size``)."""
        if not data:
            return 0
        start = self.position
        end = min(self.packed_size, start + len(data))
        n = end - start
        self._flat(writable=True)[start:end] = np.frombuffer(
            data, dtype=np.uint8, count=n)
        self.position = end
        return n


def pack(buf: Buffer, dtype: Datatype, count: int) -> bytes:
    """One-shot MPI_Pack."""
    return Convertor(buf, dtype, count).pack()


def unpack(data: bytes, buf: Buffer, dtype: Datatype, count: int) -> int:
    """One-shot MPI_Unpack."""
    return Convertor(buf, dtype, count).unpack(data)


def dtype_of(obj) -> Datatype:
    """The Datatype of a numpy array's (or buffer's) element type."""
    return from_numpy_dtype(np.asarray(obj).dtype)
