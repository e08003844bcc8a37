"""Convertor — pack / unpack with partial-completion state.

The port's copy of ``ompi_tpu.datatype.convertor`` (reference:
opal/datatype/opal_convertor.{h,c} — prepare_for_send / recv,
opal_convertor_pack / unpack with position state for pipelined
fragments, the optional checksum of opal_convertor.h:113-130 — and
opal_copy_functions_heterogeneous.c for the byte swap of a peer of
another order). Movement is numpy slicing over a byte view, vectorized
through the span table. A count whose span table would pass
``_SPAN_WINDOW_LIMIT`` spans is walked in windows generated per pack /
unpack range, so a count past 2**31 builds no table of that length and
positions stay Python ints.

A device tensor packs through ``datatype.device`` on its own card; this
module moves host buffers only.
"""

from __future__ import annotations

import zlib
from typing import Optional, Union

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.datatype.datatype import (Datatype, from_numpy_dtype,
                                               wire_pattern)

Buffer = Union[np.ndarray, bytearray, memoryview, bytes]

#: above this many total spans the convertor switches from a materialized
#: span table to windowed per-range generation (big counts)
_SPAN_WINDOW_LIMIT = 1 << 22
#: below this many spans a Python loop beats building an index vector
_SPAN_LOOP_MAX = 64


def _pattern_perm(pattern) -> np.ndarray:
    """Byte permutation applying a wire pattern's byteswap to one packed
    element: each (unit, nbytes) segment reverses the bytes of every
    unit (unit 1 is raw padding, the identity)."""
    parts = []
    pos = 0
    for unit, nbytes in pattern:
        if unit <= 1:
            parts.append(np.arange(pos, pos + nbytes, dtype=np.int64))
        else:
            k = nbytes // unit
            parts.append((pos + np.arange(k * unit, dtype=np.int64)
                          .reshape(k, unit)[:, ::-1]).reshape(-1))
        pos += nbytes
    return np.concatenate(parts) if parts else np.empty(0, np.int64)


def _writable_byte_view(buf: Buffer) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return buf.view(np.uint8).reshape(-1)
    mv = memoryview(buf)
    if mv.readonly:
        raise ValueError("buffer not writable")
    return np.frombuffer(mv, dtype=np.uint8)


class Convertor:
    """Pack / unpack iterator over (buffer, datatype, count), tracking a
    byte position like the reference convertor's stack. ``checksum=True``
    keeps a running CRC32 of the wire bytes (CONVERTOR_WITH_CHECKSUM)."""

    def __init__(self, buf: Buffer, dtype: Datatype, count: int,
                 checksum: bool = False) -> None:
        self.dtype = dtype
        self.count = count
        self.packed_size = dtype.size * count
        self.position = 0
        self.checksum = 0 if checksum else None
        self._buf = buf
        # heterogeneous wire conversion: see set_hetero
        self.wire_swap = False
        self.wire_round = False
        self._swap_unit = 0
        self._swap_dtype = None  # a uniform base swaps with byteswap;
        self._swap_perm = None   # a mixed layout by its pattern's perm
        if dtype.lb < 0:
            # bytes before the buffer's start do not exist in an array
            raise ValueError(
                f"datatype {dtype.name} has negative lb={dtype.lb}; "
                "pass a buffer view that starts at lb or resize the type")
        self._windowed = False
        self._spans = None  # None: one contiguous range, or windowed
        if dtype.is_contiguous:
            pass
        elif count * len(dtype.spans) > _SPAN_WINDOW_LIMIT:
            self._windowed = True
        else:
            self._spans = dtype.spans_for_count(count)
            self._cum = np.concatenate([[0], np.cumsum(self._spans[:, 1])])

    def _flat(self, writable: bool) -> np.ndarray:
        if writable:
            return _writable_byte_view(self._buf)
        if isinstance(self._buf, np.ndarray):
            return self._buf.view(np.uint8).reshape(-1)
        return np.frombuffer(memoryview(self._buf), dtype=np.uint8)

    @property
    def done(self) -> bool:
        return self.position >= self.packed_size

    @property
    def is_contig_layout(self) -> bool:
        """True iff the packed bytes are the buffer's own byte layout
        (the zero-copy precondition; a windowed convertor also holds no
        table and is not contiguous)."""
        return self._spans is None and not self._windowed

    def set_position(self, pos: int) -> None:
        """Reposition (pipelined restart). A restart from 0 resets the
        running checksum; moving a checksumming convertor elsewhere
        mid-stream would corrupt it and raises."""
        if self.checksum is not None:
            if pos == 0:
                self.checksum = 0
            elif pos != self.position:
                raise ValueError("cannot reposition a checksumming "
                                 "convertor mid-stream (restart from 0)")
        self.position = pos

    # -- heterogeneous wire conversion ---------------------------------------
    def set_hetero(self, swap: bool) -> None:
        """A peer of another byte order (the arch descriptor rides the
        modex). The packed wire is element-dense, so the conversion is a
        byte reversal per typemap entry. ``swap=False`` still rounds
        pack windows to whole elements (a swapping peer must never see a
        split element); ``swap=True`` also reverses bytes. A uniform base
        swaps with one vectorized byteswap; a mixed layout (pair types,
        structs of different fields) through its wire pattern's
        permutation, with windows rounded to whole pattern periods."""
        base = self.dtype.base
        if base is not None and base.names is None:
            self._swap_unit = int(base.itemsize)
            self._swap_dtype = base
            self.wire_round = True
            self.wire_swap = swap and self._swap_unit > 1
            return
        pat = wire_pattern(self.dtype)
        if pat is None:
            raise ValueError(
                f"datatype {self.dtype.name!r} has no typemap wire "
                "pattern (raw span table); cross-architecture transfer "
                "of unknown layouts is unsupported")
        self._swap_dtype = None
        self._swap_unit = int(sum(nb for _, nb in pat)) or 1
        self._swap_perm = _pattern_perm(pat)
        self.wire_round = True
        self.wire_swap = swap and any(u > 1 for u, _ in pat)

    def _swap_bytes(self, data: bytes) -> bytes:
        # per component: a complex value swaps each float half
        if self._swap_dtype is not None:
            return np.frombuffer(data, dtype=self._swap_dtype) \
                .byteswap().tobytes()
        arr = np.frombuffer(data, np.uint8).reshape(-1, self._swap_unit)
        return arr[:, self._swap_perm].tobytes()

    # -- pack ----------------------------------------------------------------
    def pack(self, max_bytes: Optional[int] = None) -> bytes:
        """Pack up to max_bytes from the current position; advances it."""
        start = self.position
        end = self.packed_size if max_bytes is None else \
            min(self.packed_size, start + max_bytes)
        if self.wire_round and end < self.packed_size:
            # whole elements per window: the swapping side reverses per
            # element and must never see one split across frames
            end = start + (end - start) // self._swap_unit * self._swap_unit
            if end <= start:
                raise ValueError(
                    f"pack window {max_bytes} smaller than the "
                    f"{self._swap_unit}-byte element of a heterogeneous "
                    "transfer")
        if end <= start:
            return b""
        src = self._flat(writable=False)
        if self._windowed:
            out = self._gather_win(src, start, end)
        elif self._spans is None:
            out = src[start:end].tobytes()
        elif start == 0 and end == self.packed_size:
            out = src[self._gather_index()].tobytes()
        else:
            out = _gather_range(src, self._spans, self._cum, start,
                                end).tobytes()
        self.position = end
        if self.wire_swap:
            out = self._swap_bytes(out)  # the wire is the advertised order
        if self.checksum is not None:  # checksums cover wire bytes
            self.checksum = zlib.crc32(out, self.checksum)
        return out

    def _gather_index(self) -> np.ndarray:
        """Flat byte-index vector of the whole layout: one fancy index
        instead of a per-span loop."""
        idx = getattr(self, "_idx", None)
        if idx is None:
            lens = self._spans[:, 1]
            idx = (np.repeat(self._spans[:, 0], lens)
                   + np.arange(int(self._cum[-1]), dtype=np.int64)
                   - np.repeat(self._cum[:-1], lens))
            self._idx = idx
        return idx

    # -- big-count windowed movement -----------------------------------------
    def _window_spans(self, e0: int, e1: int):
        """Span table and packed-byte cumsum of elements [e0, e1),
        generated on demand: O(window) memory, not O(count)."""
        espans = self.dtype.spans
        base = np.arange(e0, e1, dtype=np.int64) * self.dtype.extent
        offs = (espans[:, 0][None, :] + base[:, None]).reshape(-1)
        lens = np.tile(espans[:, 1], e1 - e0)
        return (np.stack([offs, lens], axis=1),
                np.concatenate(([0], np.cumsum(lens))))

    def _win_iter(self, start: int, end: int):
        """(window spans, window cum, local start, local end, out
        position) chunks covering packed bytes [start, end)."""
        esize = self.dtype.size
        w = max(1, _SPAN_WINDOW_LIMIT // max(1, len(self.dtype.spans)))
        last = (end - 1) // esize + 1  # never past what the range touches
        e = start // esize
        pos = 0
        while pos < end - start:
            we = min(self.count, e + w, last)
            spans, cum = self._window_spans(e, we)
            wb0 = e * esize
            s = max(start, wb0) - wb0
            t = min(end, we * esize) - wb0
            yield spans, cum, s, t, pos
            pos += t - s
            e = we

    def _gather_win(self, src: np.ndarray, start: int, end: int) -> bytes:
        out = np.empty(end - start, np.uint8)
        for spans, cum, s, t, pos in self._win_iter(start, end):
            out[pos:pos + (t - s)] = _gather_range(src, spans, cum, s, t)
        return out.tobytes()

    # -- unpack --------------------------------------------------------------
    def unpack(self, data: bytes) -> int:
        """Unpack bytes at the current position; returns the bytes
        consumed (at most what is left of ``packed_size``)."""
        if not data:
            return 0
        dst = self._flat(writable=True)
        start = self.position
        end = min(self.packed_size, start + len(data))
        n = end - start
        if self.wire_swap:
            if n % self._swap_unit:
                raise ValueError(
                    f"heterogeneous frame of {n} bytes splits a "
                    f"{self._swap_unit}-byte element (the peer did not "
                    "round its windows)")
            src = np.frombuffer(self._swap_bytes(data[:n]), dtype=np.uint8)
        else:
            src = np.frombuffer(data, dtype=np.uint8, count=n)
        if self._windowed:
            for spans, cum, s, t, pos in self._win_iter(start, end):
                _scatter_range(dst, src[pos:pos + (t - s)], spans, cum, s, t)
        elif self._spans is None:
            dst[start:end] = src
        elif start == 0 and end == self.packed_size:
            dst[self._gather_index()] = src
        else:
            _scatter_range(dst, src, self._spans, self._cum, start, end)
        self.position = end
        if self.checksum is not None:
            self.checksum = zlib.crc32(data[:n], self.checksum)
        return n


def _range_index(spans: np.ndarray, cum: np.ndarray, start: int,
                 end: int) -> np.ndarray:
    """Flat byte-index vector of packed range [start, end), built for the
    touched spans only (O(range), not O(layout))."""
    i0 = int(np.searchsorted(cum, start, side="right")) - 1
    i1 = int(np.searchsorted(cum, end, side="left"))
    offs = spans[i0:i1, 0].copy()
    lens = spans[i0:i1, 1].copy()
    head = start - int(cum[i0])
    if head > 0:
        offs[0] += head
        lens[0] -= head
    tail = int(cum[i1]) - end
    if tail > 0:
        lens[-1] -= tail
    starts = np.concatenate(([0], np.cumsum(lens[:-1])))
    return (np.repeat(offs, lens) + np.arange(int(lens.sum()), dtype=np.int64)
            - np.repeat(starts, lens))


def _gather_range(src: np.ndarray, spans: np.ndarray, cum: np.ndarray,
                  start: int, end: int) -> np.ndarray:
    """Packed bytes [start, end) (cum coordinates) out of src."""
    i0 = int(np.searchsorted(cum, start, side="right")) - 1
    i1 = int(np.searchsorted(cum, end, side="left"))
    if i1 - i0 > _SPAN_LOOP_MAX:
        return src[_range_index(spans, cum, start, end)]
    parts = []
    for i in range(i0, i1):
        off, ln = int(spans[i, 0]), int(spans[i, 1])
        s0 = max(0, start - int(cum[i]))
        s1 = min(ln, end - int(cum[i]))
        parts.append(src[off + s0:off + s1])
    return np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)


def _scatter_range(dst: np.ndarray, src: np.ndarray, spans: np.ndarray,
                   cum: np.ndarray, start: int, end: int) -> None:
    """Place packed bytes [start, end) (cum coordinates) into dst."""
    i0 = int(np.searchsorted(cum, start, side="right")) - 1
    i1 = int(np.searchsorted(cum, end, side="left"))
    if i1 - i0 > _SPAN_LOOP_MAX:
        dst[_range_index(spans, cum, start, end)] = src[:end - start]
        return
    pos = 0
    for i in range(i0, i1):
        off, ln = int(spans[i, 0]), int(spans[i, 1])
        s0 = max(0, start - int(cum[i]))
        s1 = min(ln, end - int(cum[i]))
        dst[off + s0:off + s1] = src[pos:pos + s1 - s0]
        pos += s1 - s0


# -- external32 (MPI_Pack_external) --------------------------------------------

def _check_datarep(datarep: str) -> None:
    if datarep != "external32":
        raise errors.MPIError(errors.ERR_ARG, f"unknown datarep {datarep!r}")


def pack_external(datarep: str, buf: Buffer, dtype: Datatype,
                  count: int) -> bytes:
    """MPI_Pack_external: the canonical big-endian 'external32' wire
    form. external32's fixed sizes are numpy's native sizes, so only the
    byte order changes; the element type is the buffer's."""
    _check_datarep(datarep)
    return _swap_wire(pack(buf, dtype, count), _elem_dtype(buf, dtype))


def unpack_external(datarep: str, data: bytes, buf: Buffer,
                    dtype: Datatype, count: int) -> int:
    """MPI_Unpack_external (the inverse of pack_external)."""
    _check_datarep(datarep)
    return unpack(_swap_wire(bytes(data), _elem_dtype(buf, dtype)), buf,
                  dtype, count)


def _elem_dtype(buf, dtype: Datatype) -> np.dtype:
    """The element representation to swap by: a typed buffer's own dtype
    (an already big-endian buffer needs no swap); a raw byte buffer
    falls back to the datatype's base in native order. Raw bytes under a
    baseless datatype raise: a guess would skip the canonical swap."""
    elem = np.asarray(buf).dtype
    if not (elem.names is not None or elem.kind in ("V", "S")
            or elem.itemsize == 1):
        return elem
    if dtype.base is not None:
        return np.dtype(dtype.base)
    raise errors.MPIError(
        errors.ERR_NOT_SUPPORTED,
        "external32 needs a uniform element type: this datatype carries "
        "no base type and the buffer is raw bytes")


def _swap_wire(wire: bytes, elem: np.dtype) -> bytes:
    """Element representation <-> big-endian canonical swap of a packed
    stream (a no-op when the representation is big-endian already)."""
    if elem.names is not None:
        # a struct's packed stream drops inter-field padding, so it
        # cannot be re-viewed as the structured dtype
        raise errors.MPIError(errors.ERR_NOT_SUPPORTED,
                              "external32 over structured element types")
    if elem.itemsize <= 1 or elem.byteorder == "|" \
            or elem.newbyteorder(">") == elem:
        return wire
    if len(wire) % elem.itemsize:
        raise errors.MPIError(
            errors.ERR_TYPE, "packed size is not a multiple of the element "
            "size")
    return np.frombuffer(wire, dtype=elem).byteswap().tobytes()


def pack(buf: Buffer, dtype: Datatype, count: int) -> bytes:
    """One-shot MPI_Pack."""
    return Convertor(buf, dtype, count).pack()


def unpack(data: bytes, buf: Buffer, dtype: Datatype, count: int) -> int:
    """One-shot MPI_Unpack."""
    return Convertor(buf, dtype, count).unpack(data)


def dtype_of(obj) -> Datatype:
    """The Datatype of a numpy array's (or buffer's) element type."""
    return from_numpy_dtype(np.asarray(obj).dtype)
