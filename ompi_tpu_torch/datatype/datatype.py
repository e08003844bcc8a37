"""Datatype objects and constructors.

The port's copy of ``ompi_tpu.datatype.datatype`` (reference:
ompi/datatype/ompi_datatype_create*.c for each constructor;
opal_datatype_optimize.c for the span-merging "optimized description";
lb / ub / extent per MPI-3.1 §4.1).

The compiled form of a datatype is an (N, 2) int64 numpy span table of
half-open (offset, length) byte ranges. Construction, tiling and merging
are vectorized numpy operations, never per-element Python loops, so a
big count costs nothing at construction (the convertor windows it).
``extent`` is the stride between consecutive elements; ``lb`` may be
negative or positive.

The predefined types are the ones the point-to-point and collective
slices export: the numeric types, ``BYTE`` / ``PACKED``, and the MINLOC /
MAXLOC pair types (``FLOAT_INT``, ``DOUBLE_INT``, ``LONG_INT``,
``TWOINT``, ``SHORT_INT``: structured numpy dtypes of a ``val`` and an
int32 ``loc`` field, packed). ``BFLOAT16``'s ``base`` is None (numpy has
no bfloat16), so its 2-byte wire pattern is stated by hand.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.attr import AttrHost
from ompi_tpu_torch.core import cvar, mpool

#: tiled span tables per (derived dtype, count), the rcache analog
_span_cache = mpool.Rcache()

_max_spans_var = cvar.register(
    "datatype_max_descriptor_spans", 1 << 26, int,
    help="Maximum spans a materialized derived-type descriptor may "
         "hold (each span is 16 bytes; the default caps descriptor "
         "memory at ~1 GB). Constructions above the cap raise at "
         "type-creation time: put the repetition in the transfer "
         "count instead, which the convertor streams with O(window) "
         "memory.", level=6)


def _as_span_array(spans) -> np.ndarray:
    arr = np.asarray(spans, dtype=np.int64)
    if arr.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    return arr.reshape(-1, 2)


def _merge(arr: np.ndarray) -> np.ndarray:
    """Merge adjacent spans, vectorized (opal_datatype_optimize.c)."""
    if len(arr) == 0:
        return arr
    arr = arr[arr[:, 1] > 0]
    if len(arr) <= 1:
        return arr
    adjacent = arr[1:, 0] == arr[:-1, 0] + arr[:-1, 1]
    idx = np.nonzero(np.concatenate([[True], ~adjacent]))[0]
    return np.stack([arr[idx, 0], np.add.reduceat(arr[:, 1], idx)], axis=1)


def _tile(spans: np.ndarray, n: int, stride: int) -> np.ndarray:
    """n copies of a span table at a byte stride, merged. Vectorized."""
    if n == 1:
        return _merge(spans)
    spans = _merge(spans)
    if len(spans) == 1 and stride == spans[0, 1]:
        # contiguous tiling collapses to one span
        return np.array([[spans[0, 0], stride * n]], dtype=np.int64)
    cap = _max_spans_var.get()
    if n * len(spans) > cap:
        raise ValueError(
            f"type descriptor would need {n * len(spans):,} spans "
            f"(> {cap:,}; cvar datatype_max_descriptor_spans); move "
            "the repetition to the transfer count — Send(buf, count, "
            "small_dtype) streams any count with O(1) descriptor memory")
    reps = np.arange(n, dtype=np.int64) * stride
    offs = (spans[None, :, 0] + reps[:, None]).reshape(-1)
    lens = np.broadcast_to(spans[None, :, 1], (n, len(spans))).reshape(-1)
    return _merge(np.stack([offs, lens], axis=1))


def _pattern_of_np(dt: np.dtype):
    """Wire pattern of one packed element of a numpy dtype: (unit_bytes,
    nbytes) segments in offset order, the typemap the heterogeneous
    convertor swaps by (opal_copy_functions_heterogeneous.c). Unit 1 is
    raw bytes (padding, never swapped); complex swaps per component."""
    dt = np.dtype(dt)
    if dt.names is None:
        if dt.subdtype is not None:
            # a subarray field ('<f4', (3,)) is n copies of its scalar:
            # swapped per element, not raw
            base, shape = dt.subdtype
            return _merge_pattern(_pattern_of_np(base) * int(np.prod(shape)))
        if dt.kind == "V":  # opaque raw bytes
            return [(1, dt.itemsize)]
        unit = dt.itemsize // 2 if dt.kind == "c" else dt.itemsize
        return [(max(unit, 1), dt.itemsize)]
    segs = []
    pos = 0
    for name in sorted(dt.names, key=lambda k: dt.fields[k][1]):
        fld, off = dt.fields[name][0], dt.fields[name][1]
        if off > pos:
            segs.append((1, off - pos))  # padding: raw
        segs.extend(_pattern_of_np(fld))
        pos = off + fld.itemsize
    if pos < dt.itemsize:
        segs.append((1, dt.itemsize - pos))
    return _merge_pattern(segs)


def _merge_pattern(segs):
    out = []
    for unit, nbytes in segs:
        if nbytes <= 0:
            continue
        if out and out[-1][0] == unit:
            out[-1] = (unit, out[-1][1] + nbytes)
        else:
            out.append((unit, nbytes))
    return out


def wire_pattern(d: "Datatype"):
    """One period of the (unit, nbytes) swap pattern of ``d``'s packed
    stream (the stream repeats it, so the convertor tiles it by reshape,
    never by materializing O(count) patterns). None when unknown: a raw
    span table with no type information, which the heterogeneous path
    rejects rather than corrupts."""
    if d.pattern is not None:
        return d.pattern
    if d.base is not None:
        return _pattern_of_np(d.base) if d.size else []
    return None


def _elems_of_np(dt):
    """One packed element of a numpy dtype as (nbytes, nelems) segments
    for MPI_Get_elements: a complex scalar is one basic element and
    padding is zero elements."""
    dt = np.dtype(dt)
    if dt.names is None:
        if dt.subdtype is not None:
            base, shape = dt.subdtype
            return _elems_of_np(base) * int(np.prod(shape))
        if dt.kind == "V":
            return [(dt.itemsize, 0)]
        return [(dt.itemsize, 1)]
    segs = []
    pos = 0
    for name in sorted(dt.names, key=lambda k: dt.fields[k][1]):
        fld, off = dt.fields[name][0], dt.fields[name][1]
        if off > pos:
            segs.append((off - pos, 0))
        segs.extend(_elems_of_np(fld))
        pos = off + fld.itemsize
    if pos < dt.itemsize:
        segs.append((dt.itemsize - pos, 0))
    return segs


def element_pattern(d: "Datatype"):
    """One period of (nbytes, nelems) segments of ``d``'s packed stream,
    the basic-element decomposition MPI_Get_elements counts by
    (get_elements.c walks the typemap the same way). None when no
    decomposition is known (the caller reports MPI_UNDEFINED)."""
    if d.base is not None:
        return _elems_of_np(d.base) if d.size else []
    if d.combiner == "named":  # a predefined type numpy lacks (BFLOAT16)
        pat = d.pattern
        return None if pat is None else [(nb, nb // u) for u, nb in pat]
    if d.combiner == "struct":
        ints, _, types = d.cargs
        out = []
        for bl, t in zip(ints[1:], types):
            if bl <= 0 or t.size == 0:
                continue
            p = element_pattern(t)
            if p is None:
                return None
            period = sum(nb for nb, _ in p)
            out.extend(p * ((bl * t.size) // period))
        return out
    if d.combiner in ("contiguous", "vector", "hvector", "indexed",
                      "hindexed", "indexed_block", "subarray", "resized",
                      "dup", "darray"):
        # the packed stream repeats the old type's element
        types = d.cargs[2]
        return element_pattern(types[0]) if types else None
    return None


class Datatype(AttrHost):
    """An MPI datatype: a byte layout over an (N, 2) span table.
    Attribute caching (Set / Get / Delete_attr) comes from AttrHost."""

    # __weakref__: the span cache's death hook (mpool.buffer_key)
    __slots__ = ("spans", "size", "extent", "lb", "name", "base",
                 "committed", "pattern", "attrs", "combiner", "cargs",
                 "__weakref__")
    _attr_kind = "type"

    def __init__(self, spans, extent: int, lb: int = 0,
                 base: Optional[np.dtype] = None, name: str = "derived",
                 pattern=None) -> None:
        self.spans = _merge(_as_span_array(spans))
        self.size = int(self.spans[:, 1].sum()) if len(self.spans) else 0
        self.extent = int(extent)
        self.lb = int(lb)
        self.base = base
        self.name = name
        self.pattern = pattern  # the wire pattern of a mixed layout;
        # uniform-base types derive theirs on demand (wire_pattern)
        self.committed = False
        self.attrs = {}
        # constructor provenance (MPI_Type_get_envelope / _contents):
        # predefined until a constructor stamps itself through _prov
        self.combiner = "named"
        self.cargs = ((), (), ())

    def Get_size(self) -> int:
        """MPI_Type_size: significant (non-gap) bytes per element."""
        return self.size

    def Get_extent(self) -> Tuple[int, int]:
        """MPI_Type_get_extent -> (lb, extent)."""
        return self.lb, self.extent

    def Get_true_extent(self) -> Tuple[int, int]:
        """MPI_Type_get_true_extent -> (true_lb, true_extent): the bytes
        the type touches, ignoring lb / ub markers and resizing."""
        if len(self.spans) == 0:
            return 0, 0
        lo = int(self.spans[:, 0].min())
        hi = int((self.spans[:, 0] + self.spans[:, 1]).max())
        return lo, hi - lo

    @property
    def ub(self) -> int:
        return self.lb + self.extent

    @property
    def is_contiguous(self) -> bool:
        return (len(self.spans) == 1 and self.spans[0, 0] == 0
                and self.spans[0, 1] == self.extent and self.lb == 0)

    @property
    def has_gaps(self) -> bool:
        return not self.is_contiguous

    def merged_spans(self):
        return [tuple(map(int, s)) for s in self.spans]

    def commit(self) -> "Datatype":
        """MPI_Type_commit (the span table is already optimized)."""
        self.committed = True
        return self

    def Get_envelope(self):
        """MPI_Type_get_envelope: (num_integers, num_addresses,
        num_datatypes, combiner)."""
        ints, addrs, types = self.cargs
        return len(ints), len(addrs), len(types), self.combiner

    def Get_contents(self):
        """MPI_Type_get_contents: (integers, addresses, datatypes) as
        passed to the constructor (MPI-3.1 §4.1.13); erroneous on a
        predefined type."""
        if self.combiner == "named":
            raise errors.MPIError(
                errors.ERR_TYPE,
                f"{self.name}: get_contents on a predefined type")
        ints, addrs, types = self.cargs
        return list(ints), list(addrs), list(types)

    def free(self) -> None:
        """MPI_Type_free: handles are garbage-collected; the visible
        effect is the attribute delete callbacks."""
        if self.attrs:
            from ompi_tpu_torch import attr

            attr.delete_attrs(self)

    def dup(self) -> "Datatype":
        """MPI_Type_dup: the same layout, attributes copied through
        their keyvals' copy callbacks."""
        d = Datatype(self.spans, self.extent, self.lb, self.base,
                     self.name + "_dup", pattern=self.pattern)
        _prov(d, "dup", (), (), (self,))
        if self.attrs:
            from ompi_tpu_torch import attr

            attr.copy_attrs(self, d)
        return d

    def spans_for_count(self, count: int) -> np.ndarray:
        """(N, 2) span table of ``count`` consecutive elements, cached
        per (datatype, count) in the registration cache with LRU
        eviction."""
        key = mpool.buffer_key(self, _span_cache)
        if key is None:
            return _tile(self.spans, count, self.extent)
        per_count = _span_cache.lookup(key)
        if per_count is not None and count in per_count:
            return per_count[count]
        table = _tile(self.spans, count, self.extent)
        per_count = dict(per_count or {})
        per_count[count] = table
        _span_cache.insert(key, per_count,
                           sum(t.nbytes for t in per_count.values()))
        return table

    def __repr__(self) -> str:
        return (f"Datatype({self.name}, size={self.size}, "
                f"extent={self.extent}, lb={self.lb}, "
                f"spans={len(self.spans)})")


# -- predefined types ----------------------------------------------------------

def _predef(np_dtype, name: str) -> Datatype:
    dt = np.dtype(np_dtype)
    return Datatype([(0, dt.itemsize)], dt.itemsize, base=dt,
                    name=name).commit()


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
#: numpy has no bfloat16: no base, and a 2-byte swap unit stated by hand
BFLOAT16 = Datatype([(0, 2)], 2, name="MPI_BFLOAT16",
                    pattern=[(2, 2)]).commit()
BOOL = _predef(np.bool_, "MPI_C_BOOL")
COMPLEX64 = _predef(np.complex64, "MPI_C_FLOAT_COMPLEX")
COMPLEX128 = _predef(np.complex128, "MPI_C_DOUBLE_COMPLEX")

# the MINLOC / MAXLOC pair types (MPI-3.1 5.9.4) as numpy struct dtypes
FLOAT_INT = _predef([("val", np.float32), ("loc", np.int32)],
                    "MPI_FLOAT_INT")
DOUBLE_INT = _predef([("val", np.float64), ("loc", np.int32)],
                     "MPI_DOUBLE_INT")
LONG_INT = _predef([("val", np.int64), ("loc", np.int32)], "MPI_LONG_INT")
TWOINT = _predef([("val", np.int32), ("loc", np.int32)], "MPI_2INT")
SHORT_INT = _predef([("val", np.int16), ("loc", np.int32)],
                    "MPI_SHORT_INT")
#: the pair types, which only MINLOC and MAXLOC combine
PAIR_TYPES = (FLOAT_INT, DOUBLE_INT, LONG_INT, TWOINT, SHORT_INT)

PREDEFINED = {
    d.name: d for d in (
        BYTE, PACKED, CHAR, INT8, UINT8, INT16, UINT16, INT32, UINT32,
        INT64, UINT64, FLOAT, DOUBLE, FLOAT16, BFLOAT16, BOOL, COMPLEX64,
        COMPLEX128, *PAIR_TYPES)
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


# -- constructors (MPI_Type_*) -------------------------------------------------

def _prov(d: Datatype, combiner: str, ints, addrs, types) -> Datatype:
    """Stamp constructor provenance (the MPI-3.1 §4.1.13 envelope /
    contents record): the argument lists as the caller passed them."""
    d.combiner = combiner
    d.cargs = (tuple(ints), tuple(addrs), tuple(types))
    return d


def contiguous(count: int, old: Datatype) -> Datatype:
    """MPI_Type_contiguous (ompi_datatype_create_contiguous.c)."""
    spans = _tile(old.spans, count, old.extent)
    base = old.base if old.is_contiguous else None
    # the packed stream stays periodic in old's element: one period
    pat = wire_pattern(old) if base is None else None
    return _prov(Datatype(spans, count * old.extent, lb=old.lb, base=base,
                          name="contiguous", pattern=pat),
                 "contiguous", (count,), (), (old,))


def vector(count: int, blocklength: int, stride: int,
           old: Datatype) -> Datatype:
    """MPI_Type_vector: stride in elements of old."""
    return _prov(hvector(count, blocklength, stride * old.extent, old),
                 "vector", (count, blocklength, stride), (), (old,))


def hvector(count: int, blocklength: int, stride_bytes: int,
            old: Datatype) -> Datatype:
    """MPI_Type_create_hvector: stride in bytes. lb / ub derive from
    old's markers (MPI-3.1 §4.1.7), so a resized inner type tiles at its
    resized extent."""
    block = _tile(old.spans, blocklength, old.extent)
    spans = _tile(block, count, stride_bytes)
    placements_lo = min(0, (count - 1) * stride_bytes)
    placements_hi = max(0, (count - 1) * stride_bytes) \
        + (blocklength - 1) * old.extent
    lb = placements_lo + old.lb
    ub = placements_hi + old.ub
    # a vector of a uniform element keeps it as its typemap base; mixed
    # elements carry one period of their wire pattern
    pat = None
    if old.base is None or old.base.names is not None:
        pat = wire_pattern(old)
    return _prov(Datatype(spans, ub - lb, lb=lb, base=old.base,
                          name="vector", pattern=pat),
                 "hvector", (count, blocklength), (stride_bytes,), (old,))


def indexed(blocklengths: Sequence[int], displs: Sequence[int],
            old: Datatype) -> Datatype:
    """MPI_Type_indexed: displacements in elements of old."""
    bl = list(blocklengths)
    displs = list(displs)
    return _prov(hindexed(bl, [d * old.extent for d in displs], old),
                 "indexed", (len(bl), *bl, *displs), (), (old,))


def hindexed(blocklengths: Sequence[int], displs_bytes: Sequence[int],
             old: Datatype) -> Datatype:
    """MPI_Type_create_hindexed: displacements in bytes; pack order is
    the type map (declaration) order, as create_struct with one type."""
    bl = list(blocklengths)
    displs_bytes = list(displs_bytes)
    d = create_struct(bl, displs_bytes, [old] * len(bl))
    d.name = "indexed"
    return _prov(d, "hindexed", (len(bl), *bl), tuple(displs_bytes), (old,))


def indexed_block(blocklength: int, displs: Sequence[int],
                  old: Datatype) -> Datatype:
    """MPI_Type_create_indexed_block."""
    displs = list(displs)
    return _prov(indexed([blocklength] * len(displs), displs, old),
                 "indexed_block", (len(displs), blocklength, *displs), (),
                 (old,))


def create_struct(blocklengths: Sequence[int], displs_bytes: Sequence[int],
                  types: Sequence[Datatype]) -> Datatype:
    """MPI_Type_create_struct."""
    # materialize once: a caller may pass one-shot iterables
    blocklengths = list(blocklengths)
    displs_bytes = list(displs_bytes)
    types = list(types)
    parts = []
    lb = ub = None
    for bl, disp, t in zip(blocklengths, displs_bytes, types):
        if bl <= 0:
            continue
        block = _tile(t.spans, bl, t.extent).copy()
        block[:, 0] += disp
        parts.append(block)
        this_lb = disp + t.lb
        this_ub = disp + (bl - 1) * t.extent + t.ub
        lb = this_lb if lb is None else min(lb, this_lb)
        ub = this_ub if ub is None else max(ub, this_ub)
    ints = (len(blocklengths), *blocklengths)
    if not parts:  # a zero-count struct is still a derived type
        return _prov(Datatype([], 0, name="struct"), "struct", ints,
                     tuple(displs_bytes), tuple(types))
    bases = {t.base for t in types if t.size}
    base = bases.pop() if len(bases) == 1 else None  # uniform only
    pat = None
    if base is None:
        # mixed: the wire pattern in pack (declaration) order, so the
        # heterogeneous convertor swaps per typemap entry; a pathological
        # pattern (huge blocklengths of mixed fields) degrades to None,
        # which the heterogeneous path refuses
        pat = []
        for bl, t in zip(blocklengths, types):
            if bl <= 0 or t.size == 0:
                continue
            p = wire_pattern(t)
            if p is None:
                pat = None
                break
            reps = (bl * t.size) // sum(nb for _, nb in p)
            if len(pat) + reps * len(p) > (1 << 16):
                pat = None
                break
            pat.extend(p * reps)
        pat = _merge_pattern(pat) if pat is not None else None
    return _prov(Datatype(np.concatenate(parts), ub - lb, lb=lb, base=base,
                          name="struct", pattern=pat),
                 "struct", ints, tuple(displs_bytes), tuple(types))


def subarray(sizes: Sequence[int], subsizes: Sequence[int],
             starts: Sequence[int], old: Datatype,
             order: str = "C") -> Datatype:
    """MPI_Type_create_subarray: an ndim tile of a larger array."""
    ndim = len(sizes)
    orig = (list(sizes), list(subsizes), list(starts))
    if order != "C":
        sizes, subsizes, starts = (list(reversed(x)) for x in orig)
    strides = [1] * ndim
    for i in range(ndim - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    idx = np.indices(subsizes).reshape(ndim, -1)
    flat = np.zeros(idx.shape[1], dtype=np.int64)
    for d in range(ndim):
        flat += (idx[d] + starts[d]) * strides[d]
    flat.sort()
    if not old.is_contiguous:
        raise NotImplementedError("subarray over non-contiguous base types")
    offs = flat * old.extent
    spans = np.stack([offs, np.full(len(offs), old.extent, np.int64)],
                     axis=1)
    total = int(np.prod(sizes, dtype=np.int64)) if ndim else 1
    return _prov(Datatype(spans, total * old.extent, name="subarray"),
                 "subarray", (ndim, *orig[0], *orig[1], *orig[2], order),
                 (), (old,))


def resized(old: Datatype, lb: int, extent: int) -> Datatype:
    """MPI_Type_create_resized."""
    return _prov(Datatype(old.spans, extent, lb=lb, base=old.base,
                          name=old.name + "_resized", pattern=old.pattern),
                 "resized", (), (lb, extent), (old,))


# -- darray (MPI_Type_create_darray, ompi/mpi/c/type_create_darray.c) ----------

DISTRIBUTE_NONE = "none"
DISTRIBUTE_BLOCK = "block"
DISTRIBUTE_CYCLIC = "cyclic"
DISTRIBUTE_DFLT_DARG = -1


def _darray_dim_indices(gsize: int, distrib: str, darg: int, psize: int,
                        coord: int) -> np.ndarray:
    """Global indices along one dimension owned by process ``coord`` of
    ``psize`` (the HPF block / cyclic rules)."""
    if distrib == DISTRIBUTE_NONE:
        if psize != 1:
            raise ValueError("DISTRIBUTE_NONE requires psize 1")
        return np.arange(gsize, dtype=np.int64)
    if distrib == DISTRIBUTE_BLOCK:
        bsize = (-(-gsize // psize) if darg == DISTRIBUTE_DFLT_DARG
                 else int(darg))
        if bsize * psize < gsize:
            raise ValueError(
                f"block darg {bsize} x {psize} procs < gsize {gsize}")
        lo = coord * bsize
        return np.arange(lo, min(lo + bsize, gsize), dtype=np.int64)
    if distrib == DISTRIBUTE_CYCLIC:
        k = 1 if darg == DISTRIBUTE_DFLT_DARG else int(darg)
        starts = np.arange(coord * k, gsize, k * psize, dtype=np.int64)
        out = (starts[:, None]
               + np.arange(k, dtype=np.int64)[None, :]).reshape(-1)
        return out[out < gsize]
    raise ValueError(f"unknown distribution {distrib!r}")


def darray(size: int, rank: int, gsizes: Sequence[int],
           distribs: Sequence[str], dargs: Sequence[int],
           psizes: Sequence[int], old: Datatype,
           order: str = "C") -> Datatype:
    """MPI_Type_create_darray: the HPF block / cyclic decomposition of an
    ndim global array over a row-major process grid; ``order`` is the
    array's storage order. The extent spans the whole global array."""
    gsizes, distribs, dargs, psizes = (list(gsizes), list(distribs),
                                       list(dargs), list(psizes))
    ndim = len(gsizes)
    if int(np.prod(psizes)) != size:
        raise ValueError(f"psizes {psizes} != size {size}")
    if not old.is_contiguous:
        raise NotImplementedError("darray over non-contiguous base types")
    coords = []
    stride = size
    rem = rank
    for p in psizes:
        stride //= p
        coords.append(rem // stride)
        rem %= stride
    gs, ds, da, ps = list(gsizes), list(distribs), list(dargs), list(psizes)
    if order != "C":  # F storage: reverse the dims, keep coords aligned
        gs, ds, da, ps, coords = (list(reversed(x))
                                  for x in (gs, ds, da, ps, coords))
    owned = [_darray_dim_indices(gs[d], ds[d], da[d], ps[d], coords[d])
             for d in range(ndim)]
    strides = [1] * ndim
    for i in range(ndim - 2, -1, -1):
        strides[i] = strides[i + 1] * gs[i + 1]
    if any(len(o) == 0 for o in owned):
        flat = np.empty(0, dtype=np.int64)
    else:
        grids = np.meshgrid(*owned, indexing="ij")
        flat = sum(g.astype(np.int64) * strides[d]
                   for d, g in enumerate(grids)).reshape(-1)
        flat.sort()
    offs = flat * old.extent
    spans = np.stack([offs, np.full(len(offs), old.extent, np.int64)],
                     axis=1)
    total = int(np.prod(gs)) if ndim else 0
    return _prov(Datatype(spans, total * old.extent, name="darray"),
                 "darray", (size, rank, ndim, *gsizes, *distribs, *dargs,
                            *psizes, order), (), (old,))
