"""The port's datatype engine against the JAX package's, in one process.

Every constructor of ``datatype/datatype.py`` is built in both packages
from the same arguments, and its span table, size, extent, true extent,
envelope, contents, wire and element patterns must be equal, with the
host convertor's pack / unpack / external32 bytes of a seeded buffer
equal byte for byte. Then the convertor's state: partial packs at odd
window sizes, ``set_position`` restarts, checksums, the windowed
big-count walk (forced at a small size) and the heterogeneous swap;
``Status.get_elements`` / ``set_elements``; the darray and
introspection cases; the span cache and the "type" keyvals; one
hypothesis property over random vector / indexed / struct / subarray
parameters; and the device convertor (``datatype/device.py``) on CPU
tensors against the reference's on jax CPU arrays, compared as uint
views. Covers ``tests/test_datatype.py``, ``test_bigcount.py``'s
single-process cases, ``test_type_introspect.py`` (except the msgq tree
and the file I/O halves), ``test_hetero.py``'s single-process cases,
``test_mpool.py::test_span_cache_reuses_tables`` and
``test_attr.py::test_type_keyval_dup_and_free``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from ompi_tpu import errors as R_errors
from ompi_tpu.datatype import convertor as R_cv
from ompi_tpu.datatype import datatype as R_D
from ompi_tpu.datatype import device as R_dev
from ompi_tpu.pml import request as R_rq
from ompi_tpu_torch import errors as P_errors
from ompi_tpu_torch.datatype import convertor as P_cv
from ompi_tpu_torch.datatype import datatype as P_D
from ompi_tpu_torch.datatype import device as P_dev
from ompi_tpu_torch.pml import request as P_rq

PKGS = ((R_D, R_cv), (P_D, P_cv))

#: (name, a function of a datatype module, count): every constructor and
#: the nestings the reference's tests use
CASES = [
    ("contiguous", lambda D: D.contiguous(5, D.INT32), 3),
    ("vector", lambda D: D.vector(3, 2, 4, D.FLOAT), 2),
    ("vector_column", lambda D: D.vector(4, 1, 4, D.FLOAT), 1),
    ("vector_neg_stride", lambda D: D.hvector(3, 1, -8, D.INT32), 1),
    ("hvector", lambda D: D.hvector(3, 2, 16, D.FLOAT), 2),
    ("indexed", lambda D: D.indexed([2, 3], [0, 5], D.INT32), 2),
    ("indexed_desc", lambda D: D.indexed([1, 2], [6, 1], D.DOUBLE), 1),
    ("hindexed", lambda D: D.hindexed([1, 1], [4, 32], D.INT32), 1),
    ("indexed_block", lambda D: D.indexed_block(2, [0, 3], D.FLOAT), 3),
    ("struct_padded", lambda D: D.create_struct([1, 1], [0, 8],
                                                [D.INT32, D.DOUBLE]), 2),
    ("struct_pair", lambda D: D.create_struct([1, 2], [0, 8],
                                              [D.DOUBLE, D.INT32]), 2),
    ("struct_int8_float", lambda D: D.create_struct(
        [1, 1], [0, 4], [D.INT8, D.FLOAT]), 3),
    ("struct_empty", lambda D: D.create_struct([], [], []), 1),
    ("subarray_2d", lambda D: D.subarray([6, 6], [2, 3], [1, 2], D.FLOAT),
     1),
    ("subarray_3d_f", lambda D: D.subarray([4, 3, 5], [2, 2, 3],
                                           [1, 0, 2], D.INT16, order="F"),
     1),
    ("resized", lambda D: D.resized(D.vector(2, 1, 2, D.INT32), 0, 16), 2),
    ("resized_neg_lb", lambda D: D.resized(D.vector(3, 2, 4, D.FLOAT),
                                           -8, 64), 1),
    ("vector_of_resized", lambda D: D.vector(
        2, 2, 3, D.resized(D.INT32, 0, 8)), 2),
    ("vector_of_struct", lambda D: D.vector(
        2, 1, 2, D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32])), 2),
    ("contiguous_of_struct", lambda D: D.contiguous(
        5, D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32])), 1),
    ("dup", lambda D: D.vector(3, 2, 4, D.FLOAT).dup(), 1),
    ("darray_block_cyclic", lambda D: D.darray(
        4, 1, [8, 6], [D.DISTRIBUTE_BLOCK, D.DISTRIBUTE_CYCLIC],
        [D.DISTRIBUTE_DFLT_DARG, 2], [2, 2], D.INT32), 1),
    ("darray_f", lambda D: D.darray(
        2, 0, [4, 4], [D.DISTRIBUTE_BLOCK, D.DISTRIBUTE_NONE],
        [D.DISTRIBUTE_DFLT_DARG] * 2, [2, 1], D.FLOAT, order="F"), 1),
    ("minloc_pair", lambda D: D.DOUBLE_INT, 3),
    ("vector_of_pair", lambda D: D.vector(2, 1, 3, D.FLOAT_INT), 2),
    ("complex", lambda D: D.vector(2, 1, 2, D.COMPLEX128), 2),
    ("numpy_padded", lambda D: D.from_numpy_dtype(
        np.dtype([("a", "i1"), ("b", "f8")], align=True)), 2),
    ("numpy_subarray_field", lambda D: D.from_numpy_dtype(
        np.dtype([("v", "<f4", (3,)), ("i", "<i4")])), 2),
]
IDS = [c[0] for c in CASES]


def _contents(d):
    """Get_contents with datatypes named recursively (the two packages'
    objects differ; their structure must not)."""
    if d.combiner == "named":
        return d.name
    ints, addrs, types = d.Get_contents()
    return [d.combiner, list(ints), list(addrs),
            [_contents(t) for t in types]]


def _describe(D, d):
    return dict(spans=d.spans.tolist(), size=d.size, extent=d.extent,
                lb=d.lb, true=d.Get_true_extent(),
                envelope=d.Get_envelope(), contents=_contents(d),
                contiguous=d.is_contiguous, wire=D.wire_pattern(d),
                elems=D.element_pattern(d))


def _seeded(nbytes: int, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8)


def _buf_bytes(d, count: int) -> int:
    lo, ext = d.Get_true_extent()
    return max(0, lo + ext + (count - 1) * d.extent) + 16


@pytest.mark.parametrize("name,build,count", CASES, ids=IDS)
def test_constructor_tables_and_bytes_match(name, build, count):
    """Span table, sizes, extents, envelope / contents, patterns, and
    the pack / unpack bytes of a seeded buffer, equal in both."""
    ref, port = build(R_D), build(P_D)
    assert _describe(P_D, port) == _describe(R_D, ref)
    if port.lb < 0:  # the convertor refuses bytes before the buffer
        for cv, d in ((R_cv, ref), (P_cv, port)):
            with pytest.raises(ValueError, match="negative lb"):
                cv.Convertor(np.zeros(8, np.uint8), d, count)
        return
    src = _seeded(_buf_bytes(port, count))
    wire = R_cv.pack(src, ref, count)
    assert P_cv.pack(src, port, count) == wire
    assert len(wire) == port.size * count
    outs = []
    for cv, d in ((R_cv, ref), (P_cv, port)):
        out = np.full_like(src, 0xA5)
        assert cv.unpack(wire, out, d, count) == len(wire)
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])


#: the external32 cases: (name, the type's function, count, buffer dtype)
EXT32 = [
    ("int32", lambda D: D.INT32, 16, np.int32),
    ("vector_double", lambda D: D.vector(4, 2, 4, D.DOUBLE), 1, np.float64),
    ("indexed_int16", lambda D: D.indexed([2, 1], [0, 5], D.INT16), 3,
     np.int16),
    ("complex64", lambda D: D.COMPLEX64, 5, np.complex64),
    ("big_endian_buffer", lambda D: D.INT32, 8, ">i4"),
    ("raw_bytes_uniform", lambda D: D.vector(3, 1, 2, D.FLOAT), 2, np.uint8),
]


@pytest.mark.parametrize("name,build,count,npdt", EXT32,
                         ids=[c[0] for c in EXT32])
def test_external32_bytes_match(name, build, count, npdt):
    ref, port = build(R_D), build(P_D)
    nbytes = _buf_bytes(port, count)
    k = np.dtype(npdt).itemsize
    src = _seeded(nbytes + (-nbytes) % k).view(npdt)
    wire = R_cv.pack_external("external32", src, ref, count)
    assert P_cv.pack_external("external32", src, port, count) == wire
    outs = []
    for cv, d in ((R_cv, ref), (P_cv, port)):
        out = np.zeros_like(src)
        cv.unpack_external("external32", wire, out, d, count)
        outs.append(out.view(np.uint8))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_external32_refusals():
    """An unknown datarep, a structured element type and raw bytes under
    a baseless type raise MPIError in both."""
    pair = [D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32])
            for D in (R_D, P_D)]
    for (D, cv), errs, st in zip(PKGS, (R_errors, P_errors), pair):
        src = np.arange(16, dtype=np.int32)
        with pytest.raises(errs.MPIError):
            cv.pack_external("native", src, D.INT32, 16)
        with pytest.raises(errs.MPIError):
            cv.pack_external("external32", np.zeros(2, D.DOUBLE_INT.base),
                             D.DOUBLE_INT, 2)
        with pytest.raises(errs.MPIError):
            cv.pack_external("external32", np.zeros(32, np.uint8), st, 1)


@pytest.mark.parametrize("window", [1, 7, 33, 777, None])
@pytest.mark.parametrize("name,build,count", [
    c for c in CASES if c[0] in ("vector", "indexed_desc", "struct_pair",
                                 "subarray_3d_f", "vector_of_struct")],
    ids=["vector", "indexed_desc", "struct_pair", "subarray_3d_f",
         "vector_of_struct"])
def test_partial_pack_and_unpack_match(name, build, count, window):
    """Fragment-at-a-time pack and unpack (the RNDV pipeline) at odd
    windows, with a running checksum: the same fragments, checksums and
    unpacked bytes."""
    src = _seeded(_buf_bytes(build(P_D), count) + 64)
    results = []
    for D, cv in PKGS:
        d = build(D)
        conv = cv.Convertor(src, d, count, checksum=True)
        frags = []
        while not conv.done:
            frags.append(conv.pack(max_bytes=window))
        out = np.zeros_like(src)
        uc = cv.Convertor(out, d, count, checksum=True)
        for f in frags:
            uc.unpack(f)
        results.append((frags, conv.checksum, uc.checksum, out.tobytes()))
    assert results[0] == results[1]
    assert b"".join(results[0][0]) == R_cv.pack(src, build(R_D), count)


def test_set_position_restarts():
    """A restart from 0 repeats the stream (and resets the checksum); a
    checksumming convertor refuses a mid-stream move."""
    buf = np.arange(100, dtype=np.float64)
    for D, cv in PKGS:
        t = D.vector(25, 1, 2, D.DOUBLE)
        conv = cv.Convertor(buf, t, 1, checksum=True)
        a = conv.pack(max_bytes=64)
        crc = conv.checksum
        conv.set_position(0)
        assert conv.checksum == 0
        assert conv.pack(max_bytes=64) == a and conv.checksum == crc
        with pytest.raises(ValueError, match="mid-stream"):
            conv.set_position(8)
        plain = cv.Convertor(buf, t, 1)
        plain.set_position(40)
        assert plain.pack() == cv.pack(buf, t, 1)[40:]


@pytest.fixture
def small_windows(monkeypatch):
    """Windowed big-count walks at a test size: both packages' window
    limit forced to 8 spans."""
    monkeypatch.setattr(R_cv, "_SPAN_WINDOW_LIMIT", 8)
    monkeypatch.setattr(P_cv, "_SPAN_WINDOW_LIMIT", 8)


@pytest.mark.parametrize("count,window,restart", [
    (37, 777, None), (37, 333, None), (31, None, 1 / 3), (23, 501, None)])
def test_windowed_big_count_walk_matches(small_windows, count, window,
                                         restart):
    """Windowed pack (fragments straddling window and element bounds),
    unpack, a mid-stream reposition and the checksum, against the
    reference's windowed walk and its materialized pack."""
    buf = np.arange(40_000, dtype=np.float64)
    got = []
    for D, cv in PKGS:
        vec = D.vector(4, 2, 5, D.DOUBLE)
        conv = cv.Convertor(buf, vec, count, checksum=restart is None)
        assert conv._windowed and not conv.is_contig_layout
        if restart is not None:
            conv.set_position(int(conv.packed_size * restart) + 1)
        frags = []
        while not conv.done:
            frags.append(conv.pack(max_bytes=window))
        out = np.zeros_like(buf)
        uc = cv.Convertor(out, vec, count)
        uc.set_position(conv.packed_size - sum(map(len, frags)))
        for f in frags:
            uc.unpack(f)
        got.append((frags, conv.checksum, out.tobytes()))
    assert got[0] == got[1]
    whole = b"".join(got[0][0])
    assert whole == R_cv.pack(buf, R_D.vector(4, 2, 5, R_D.DOUBLE),
                              count)[-len(whole):]


def test_huge_counts_construct_instantly():
    """A count past 2**33 windows (no table of that length); a
    contiguous big type is one span; positions stay exact ints."""
    for D, cv in PKGS:
        vec = D.vector(2, 3, 5, D.FLOAT)
        conv = cv.Convertor(np.empty(0, np.uint8), vec, 3_000_000_000)
        assert conv._windowed and conv.packed_size == 3_000_000_000 * 24
        conv.set_position(conv.packed_size - 4)
        assert not conv.done and conv.position == conv.packed_size - 4
        big = D.contiguous(3_000_000_000, D.FLOAT)
        assert big.size == 12_000_000_000 and big.is_contiguous
        assert not cv.Convertor(np.empty(0, np.uint8), big, 1)._windowed
        assert big.spans_for_count(1).tolist() == [[0, 12_000_000_000]]
        assert D.vector(1000, 1, 1000, D.DOUBLE).spans_for_count(1).dtype \
            == np.int64
        with pytest.raises(ValueError, match="transfer count"):
            D.vector(1_000_000_000, 2, 5, D.DOUBLE)


HETERO = ["vector", "struct_pair", "minloc_pair", "complex",
          "numpy_subarray_field", "vector_of_struct", "numpy_padded"]


@pytest.mark.parametrize("name", HETERO)
@pytest.mark.parametrize("window", [None, 40])
def test_heterogeneous_swap_matches(name, window):
    """set_hetero(swap=True): the swapped wire (per component for
    complex, through the typemap permutation for mixed layouts), the
    windows rounded to whole elements, and the unswapped unpack, equal
    in both."""
    _, build, count = CASES[IDS.index(name)]
    src = _seeded(_buf_bytes(build(P_D), count))
    got = []
    for D, cv in PKGS:
        d = build(D)
        conv = cv.Convertor(src, d, count)
        conv.set_hetero(swap=True)
        frags = []
        while not conv.done:
            frags.append(conv.pack(max_bytes=window))
        out = np.zeros_like(src)
        uc = cv.Convertor(out, d, count)
        uc.set_hetero(swap=True)
        for f in frags:
            uc.unpack(f)
        got.append((frags, out.tobytes()))
    assert got[0] == got[1]
    plain = np.zeros_like(src)
    P_cv.unpack(P_cv.pack(src, build(P_D), count), plain, build(P_D), count)
    assert got[1][1] == plain.tobytes()  # swapped twice = the original


def test_wire_patterns_and_permutation():
    """tests/test_hetero.py's single-process cases on both packages."""
    for D, cv in PKGS:
        pair = D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32])
        assert D.wire_pattern(pair) == [(8, 8), (4, 4)]
        assert D.wire_pattern(D.vector(2, 1, 2, pair)) == [(8, 8), (4, 4)]
        assert D.wire_pattern(D.vector(3, 2, 4, D.FLOAT)) == [(4, 4)]
        sub = np.dtype([("v", "<f4", (3,)), ("i", "<i4")])
        assert D._pattern_of_np(sub) == [(4, 16)]
        nested = np.dtype([("s", np.dtype([("d", "<f8"), ("i", "<i4")]),
                            (2,))])
        assert D._pattern_of_np(nested) == [(8, 8), (4, 4), (8, 8), (4, 4)]
        assert D._pattern_of_np(np.dtype("V12")) == [(1, 12)]
        assert D.wire_pattern(D.from_numpy_dtype(
            np.dtype(("<f4", (3,))))) == [(4, 12)]
        perm = cv._pattern_perm([(8, 8), (4, 4)])
        assert bytes(np.arange(12, dtype=np.uint8)[perm]) == bytes(
            [7, 6, 5, 4, 3, 2, 1, 0, 11, 10, 9, 8])
    # a raw span table has no pattern: the heterogeneous path refuses it
    for D, cv in PKGS:
        raw = D.Datatype([(0, 4), (8, 4)], 12)
        with pytest.raises(ValueError, match="wire"):
            cv.Convertor(np.zeros(12, np.uint8), raw, 1).set_hetero(True)


def test_bfloat16_swaps_in_the_port():
    """BFLOAT16 (no numpy base in the port) swaps its two bytes and
    counts one element per 2 bytes; the reference's ml_dtypes base is a
    void dtype, whose pattern is raw (the difference ROADMAP queue 3
    states)."""
    assert P_D.wire_pattern(P_D.BFLOAT16) == [(2, 2)]
    assert R_D.wire_pattern(R_D.BFLOAT16) == [(1, 2)]
    v = P_D.vector(2, 1, 2, P_D.BFLOAT16)
    conv = P_cv.Convertor(np.arange(6, dtype=np.uint8), v, 1)
    conv.set_hetero(swap=True)
    assert conv.pack() == bytes([1, 0, 5, 4])
    st = P_rq.Status()
    st.count = 6
    assert st.get_elements(P_D.BFLOAT16) == 3


def _status(rq, count):
    st = rq.Status()
    st.count = count
    return st


@pytest.mark.parametrize("name,build,nbytes", [
    ("pair", lambda D: D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32]),
     [36, 32, 34, 7, 0]),
    ("contiguous", lambda D: D.contiguous(10, D.DOUBLE), [80, 44]),
    ("vector", lambda D: D.vector(3, 2, 4, D.DOUBLE), [56, 100]),
    ("contiguous_of_pair", lambda D: D.contiguous(5, D.create_struct(
        [1, 1], [0, 8], [D.DOUBLE, D.INT32])), [60, 32]),
    ("padded", lambda D: D.from_numpy_dtype(np.dtype(
        [("a", "i1"), ("b", "f8")], align=True)), [16, 24, 3]),
    ("complex", lambda D: D.COMPLEX128, [32, 8]),
    ("raw", lambda D: D.Datatype([(0, 4), (8, 4)], 12), [24]),
    ("none", lambda D: None, [7]),
])
def test_get_elements_matches(name, build, nbytes):
    """MPI_Get_elements over the element pattern (partial receives,
    padding, complex scalars, MPI_UNDEFINED) and get_count, equal."""
    for n in nbytes:
        got = [(_status(rq, n).get_elements(build(D)),
                _status(rq, n).get_count(build(D)))
               for D, rq in ((R_D, R_rq), (P_D, P_rq))]
        assert got[0] == got[1], (n, got)


@pytest.mark.parametrize("elements", [12, 6, 5, 1, 0])
def test_set_elements_matches(elements):
    """MPI_Status_set_elements round-trips through get_elements, and
    get_count floors to whole vectors, in both."""
    got = []
    for D, rq in ((R_D, R_rq), (P_D, P_rq)):
        v = D.vector(4, 1, 2, D.DOUBLE)
        pair = D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32])
        out = []
        for t in (v, pair, D.DOUBLE):
            st = rq.Status()
            st.set_elements(t, elements)
            out.append((st.count, st.get_elements(t), st.get_count(t)))
        got.append(out)
    assert got[0] == got[1]


def test_darray_decompositions_match():
    """tests/test_type_introspect.py's darray cases: BLOCK x BLOCK
    equals the manual subarrays, CYCLIC(2) x BLOCK partitions a ragged
    array, F order reverses the strides; the refusals raise the same
    classes."""
    for D in (R_D, P_D):
        gs = [8, 6]
        for rank in range(4):
            i, j = rank // 2, rank % 2
            da = D.darray(4, rank, gs, [D.DISTRIBUTE_BLOCK] * 2,
                          [D.DISTRIBUTE_DFLT_DARG] * 2, [2, 2], D.INT32)
            sa = D.subarray(gs, [4, 3], [4 * i, 3 * j], D.INT32)
            assert da.merged_spans() == sa.merged_spans()
            assert da.extent == sa.extent == 8 * 6 * 4
        seen = np.zeros(35, dtype=np.int32)
        for rank in range(4):
            da = D.darray(4, rank, [7, 5],
                          [D.DISTRIBUTE_CYCLIC, D.DISTRIBUTE_BLOCK],
                          [2, D.DISTRIBUTE_DFLT_DARG], [2, 2], D.INT32)
            for off, ln in da.merged_spans():
                seen[off // 4:(off + ln) // 4] += 1
        assert (seen == 1).all()
        with pytest.raises(NotImplementedError):
            D.darray(1, 0, [2], [D.DISTRIBUTE_BLOCK],
                     [D.DISTRIBUTE_DFLT_DARG], [1], D.vector(2, 1, 2, D.FLOAT))
        with pytest.raises(NotImplementedError):
            D.subarray([4], [2], [0], D.vector(2, 1, 2, D.FLOAT))
        for args in (
                (4, 0, [8], [D.DISTRIBUTE_BLOCK], [D.DISTRIBUTE_DFLT_DARG],
                 [2], D.FLOAT),
                (2, 0, [8, 8], [D.DISTRIBUTE_NONE, D.DISTRIBUTE_BLOCK],
                 [D.DISTRIBUTE_DFLT_DARG] * 2, [2, 1], D.FLOAT),
                (4, 0, [8, 8], [D.DISTRIBUTE_BLOCK] * 2,
                 [1, D.DISTRIBUTE_DFLT_DARG], [4, 1], D.FLOAT)):
            with pytest.raises(ValueError):
                D.darray(*args)


def test_introspection_edges_match():
    """One-shot iterables recorded, the zero-count struct's record, the
    predefined types' empty envelope and refused contents, and
    Get_true_extent ignoring the resized markers."""
    got = []
    for D, errs in ((R_D, R_errors), (P_D, P_errors)):
        ix = D.indexed([2, 1], iter([0, 4]), D.DOUBLE)
        hx = D.hindexed(iter([2, 1]), iter([0, 32]), D.DOUBLE)
        st = D.create_struct(iter([1]), iter([0]), iter([D.FLOAT]))
        empty = D.create_struct([], [], [])
        with pytest.raises(errs.MPIError):
            D.FLOAT.Get_contents()
        v = D.vector(3, 2, 4, D.FLOAT)
        rz = D.resized(v, -8, 64)
        got.append([_contents(ix), _contents(hx), _contents(st),
                    empty.Get_envelope(), _contents(empty),
                    D.FLOAT.Get_envelope(), v.Get_size(), v.Get_extent(),
                    v.Get_true_extent(), rz.Get_extent(),
                    rz.Get_true_extent(), rz.ub, v.has_gaps])
    assert got[0] == got[1]
    assert got[1][3] == (1, 0, 0, "struct")


def test_span_cache_reuses_tables():
    """The registration cache hands back the same tiled table per
    (datatype, count) and drops a dead type's entries."""
    import gc

    from ompi_tpu_torch.core import mpool

    vec = P_D.vector(4, 2, 5, P_D.FLOAT)
    t1 = vec.spans_for_count(3)
    assert vec.spans_for_count(3) is t1
    assert vec.spans_for_count(4) is not t1
    np.testing.assert_array_equal(
        t1, R_D.vector(4, 2, 5, R_D.FLOAT).spans_for_count(3))
    key = mpool.buffer_key(vec, P_D._span_cache)
    assert key == mpool.buffer_key(vec, P_D._span_cache)
    assert P_D._span_cache.lookup(key) is not None
    del vec, t1
    gc.collect()
    assert P_D._span_cache.lookup(key) is None
    assert mpool.buffer_key(object(), P_D._span_cache) is None


def test_type_keyval_dup_and_free_match():
    """tests/test_attr.py::test_type_keyval_dup_and_free on both: dup
    copies through the copy callback, free deletes, a NULL copy drops,
    dup_fn copies by reference; a comm keyval on a type raises."""
    from ompi_tpu import mpi as R_mpi
    from ompi_tpu_torch import mpi as P_mpi

    logs = []
    for D, mpi, errs in ((R_D, R_mpi, R_errors), (P_D, P_mpi, P_errors)):
        log = []
        kv = mpi.Type_create_keyval(
            lambda obj, k, extra, val: log.append(("copy", val)) or val * 2,
            lambda obj, k, val, extra: log.append(("del", val)))
        t = D.vector(3, 2, 4, D.FLOAT).commit()
        t.Set_attr(kv, 5)
        d = t.dup()
        log.append((d.Get_attr(kv), t.Get_attr(kv)))
        d.free()
        t.free()
        kv2 = mpi.Type_create_keyval()
        t2 = D.vector(2, 1, 2, D.FLOAT)
        t2.Set_attr(kv2, "x")
        log.append(t2.dup().Get_attr(kv2))
        kv3 = mpi.Type_create_keyval(copy_fn=mpi.dup_fn)
        ref = ["ref"]
        t2.Set_attr(kv3, ref)
        log.append(t2.dup().Get_attr(kv3) is ref)
        assert mpi.Type_free_keyval(kv3) == mpi.KEYVAL_INVALID
        ckv = mpi.Comm_create_keyval()
        with pytest.raises(errs.MPIError):
            t2.Set_attr(ckv, 1)
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][:4] == [("copy", 5), (10, 5), ("del", 10), ("del", 5)]


# -- one property over random layouts ------------------------------------------

_layout = st.one_of(
    st.tuples(st.just("vector"), st.integers(1, 6), st.integers(1, 4),
              st.integers(-6, 8)),
    st.tuples(st.just("indexed"),
              st.lists(st.tuples(st.integers(0, 3), st.integers(0, 20)),
                       min_size=1, max_size=5)),
    st.tuples(st.just("struct"),
              st.lists(st.tuples(st.integers(0, 3), st.integers(0, 6),
                                 st.sampled_from(["INT8", "INT16", "FLOAT",
                                                  "DOUBLE"])),
                       min_size=1, max_size=4)),
    st.tuples(st.just("subarray"),
              st.lists(st.integers(1, 5), min_size=1, max_size=3),
              st.integers(0, 10 ** 6), st.sampled_from(["C", "F"])),
)


def _build(D, spec):
    kind = spec[0]
    if kind == "vector":
        _, count, bl, stride = spec
        return D.vector(count, bl, stride, D.INT32)
    if kind == "indexed":
        return D.indexed([b for b, _ in spec[1]], [x for _, x in spec[1]],
                         D.INT16)
    if kind == "struct":
        return D.create_struct([b for b, _, _ in spec[1]],
                               [8 * x for _, x, _ in spec[1]],
                               [getattr(D, t) for _, _, t in spec[1]])
    _, sizes, seed, order = spec
    rng = np.random.default_rng(seed)
    subs = [int(rng.integers(1, s + 1)) for s in sizes]
    starts = [int(rng.integers(0, s - b + 1)) for s, b in zip(sizes, subs)]
    return D.subarray(sizes, subs, starts, D.FLOAT, order=order)


@settings(max_examples=60, deadline=None)
@given(spec=_layout, count=st.integers(1, 3), window=st.integers(1, 50))
def test_random_layouts_match(spec, count, window):
    """Span tables, patterns and pack bytes (whole and in windows) of
    random vector / indexed / struct / subarray layouts, equal."""
    ref, port = _build(R_D, spec), _build(P_D, spec)
    assert _describe(P_D, port) == _describe(R_D, ref)
    if port.lb < 0:
        return
    src = _seeded(_buf_bytes(port, count), seed=count)
    wire = R_cv.pack(src, ref, count)
    assert P_cv.pack(src, port, count) == wire
    conv = P_cv.Convertor(src, port, count)
    frags = []
    while not conv.done:
        frags.append(conv.pack(max_bytes=window))
    assert b"".join(frags) == wire


# -- the device convertor -------------------------------------------------------

#: (torch dtype, jax dtype) of the device cases; the 8-byte ones (jax
#: without x64 has none) are held against the host convertor alone
DEV_DTYPES = [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
    (torch.int32, jnp.int32), (torch.uint16, jnp.uint16),
    (torch.bool, jnp.bool_), (torch.float16, jnp.float16),
    (torch.uint8, jnp.uint8), (torch.float64, None), (torch.int64, None),
]
DEV_CASES = [c for c in CASES if c[0] in (
    "contiguous", "vector", "vector_column", "hvector", "indexed",
    "indexed_desc", "indexed_block", "subarray_2d", "resized",
    "vector_of_resized", "darray_block_cyclic")]
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _dev_type(D, build, k):
    """The case's type over k-byte elements: its FLOAT / INT32 / DOUBLE /
    INT16 base swapped for the predefined type of the tensor's size."""
    base = {1: D.UINT8, 2: D.INT16, 4: D.FLOAT, 8: D.DOUBLE}[k]
    sub = type("Sub", (), {n: getattr(D, n) for n in dir(D)
                           if not n.startswith("__")})
    for name in ("INT32", "FLOAT", "DOUBLE", "INT16"):
        setattr(sub, name, base)
    return build(sub)


def _tensor(bits: np.ndarray, tdt) -> torch.Tensor:
    k = bits.itemsize
    return torch.from_numpy(bits.view(f"i{k}").copy()).view(tdt)


def _bits(t: torch.Tensor) -> np.ndarray:
    k = t.element_size()
    return t.view(_SIGNED[k]).numpy().view(_UINT[k])


def _jax(bits: np.ndarray, jdt):
    if jdt == jnp.bool_:
        return jnp.asarray(bits.astype(bool))
    return jnp.asarray(bits).view(jdt)


@pytest.mark.parametrize("tdt,jdt", DEV_DTYPES,
                         ids=[str(t[0])[6:] for t in DEV_DTYPES])
@pytest.mark.parametrize("name,build,count", DEV_CASES,
                         ids=[c[0] for c in DEV_CASES])
def test_device_pack_unpack_match(name, build, count, tdt, jdt):
    """datatype.device's pack of a CPU tensor equals the host
    convertor's bytes and the reference's pack of a jax CPU array; the
    in-place unpack into a template equals the reference's new array
    (the gaps keep the template's values), all as uint views; the index
    vector is cached per key."""
    k = torch.tensor([], dtype=tdt).element_size()
    port = _dev_type(P_D, build, k)
    n = (_buf_bytes(port, count) + k - 1) // k
    bits = _seeded(n * k, seed=n).view(_UINT[k])
    tpl_bits = _seeded(n * k, seed=n + 1).view(_UINT[k])
    if tdt == torch.bool:
        bits, tpl_bits = bits & 1, tpl_bits & 1
    elif tdt.is_floating_point:
        # no NaN (XLA's CPU gather quiets bfloat16 NaN payloads, which
        # the parity tests set aside): clear the exponent's top bit
        keep = _UINT[k](~(1 << (8 * k - 2)) & ((1 << 8 * k) - 1))
        bits, tpl_bits = bits & keep, tpl_bits & keep
    src = _tensor(bits, tdt)
    got = P_dev.pack(src, port, count)
    assert got.dtype == tdt and got.numel() == P_dev.packed_elems(
        port, count, k)
    assert _bits(got).tobytes() == P_cv.pack(bits, port, count)
    tpl = _tensor(tpl_bits, tdt)
    assert P_dev.unpack(got, port, count, tpl) is tpl
    host = tpl_bits.copy()
    P_cv.unpack(P_cv.pack(bits, port, count), host, port, count)
    np.testing.assert_array_equal(_bits(tpl), host)
    idx = P_dev._indices(port, count, k, src.device)[0]
    assert P_dev._indices(port, count, k, src.device)[0] is idx
    if jdt is None:
        return
    ref = _dev_type(R_D, build, k)
    packed = R_dev.pack(_jax(bits, jdt), ref, count)
    np.testing.assert_array_equal(
        np.asarray(packed).view(_UINT[k]) if jdt != jnp.bool_
        else np.asarray(packed).astype(np.uint8), _bits(got))
    out = np.asarray(R_dev.unpack(packed, ref, count, _jax(tpl_bits, jdt)))
    np.testing.assert_array_equal(
        out.view(_UINT[k]) if jdt != jnp.bool_ else out.astype(np.uint8),
        _bits(tpl))


def test_device_refusals_and_forms():
    """A misaligned (mixed struct) type has no device route and a type
    that passes the tensor's end raises, naming the type and count, in
    both (the port's class is MPIError ERR_TYPE); the (tensor, count)
    form takes the leading count; a non-contiguous template unpacks in
    place."""
    s = [D.create_struct([1, 1], [0, 4], [D.INT8, D.FLOAT])
         for D in (R_D, P_D)]
    x = torch.arange(24, dtype=torch.float32)
    assert not P_dev.supports(s[1], x)
    assert not R_dev.supports(s[0], jnp.arange(24, dtype=jnp.float32))
    with pytest.raises(P_errors.MPIError, match="device route") as e:
        P_dev.pack(x, s[1], 1)
    assert e.value.error_class == P_errors.ERR_TYPE
    with pytest.raises(TypeError):
        R_dev.pack(jnp.arange(24, dtype=jnp.float32), s[0], 1)
    vec = P_D.vector(3, 2, 4, P_D.FLOAT)
    with pytest.raises(P_errors.MPIError, match="vector x 3"):
        P_dev.pack(x, vec, 3)
    with pytest.raises(ValueError, match="vector x 3"):
        R_dev.pack(jnp.arange(24, dtype=jnp.float32),
                   R_D.vector(3, 2, 4, R_D.FLOAT), 3)
    np.testing.assert_array_equal(P_dev.pack(x, None, 5).numpy(),
                                  np.arange(5, dtype=np.float32))
    tpl = torch.zeros(4, 6)
    view = tpl.t()  # non-contiguous (6, 4)
    P_dev.unpack(torch.ones(6), vec, 1, view)
    want = np.zeros(24, np.float32)
    want[[0, 1, 4, 5, 8, 9]] = 1
    np.testing.assert_array_equal(view.reshape(-1).numpy(), want)
