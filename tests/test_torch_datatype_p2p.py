"""The port's derived datatypes, heterogeneous peers and device tuple forms
on ranks, against the JAX package's.

One rank body, run on 2 and on 3 ranks by both packages: the reference
through ``tests.harness.run_ranks`` (isolated, with its own prelude),
the port through its launcher with the same settings mapped by
``compat.mca_from_reference`` plus ``device_plane_platform cpu``, both
under ``device_plane on``. Rank 1 sets ``OMPI_TPU_ARCH=big`` before it
imports the package (as ``tests/test_hetero.py`` does), so it advertises
the other byte order and swaps its wire, and its peers convert. Both
packages make the same numpy inputs and write every result as ``.npy``
and every count as JSON; the test compares the results bitwise through a
uint8 view and the counts exactly. The body covers:

- ``tests/test_hetero.py``'s rank cases: eager both ways, a RNDV
  message and a strided column (with single copy off across the orders),
  the host collectives across the orders, a mixed struct and the MINLOC
  pair type, a struct with a subarray field, complex128, and the forced
  rank's own traffic (a self send: the sender swaps to its advertisement
  though the peer's order is its own);
- ``tests/test_bigcount.py::test_windowed_rndv_single_copy_correct`` and
  the vector cases of ``tests/test_p2p.py`` (a strided column into a
  contiguous receive), ``tests/test_smsc.py`` (a non-contiguous single
  copy, and on 3 ranks an offer declined by a disqualified receiver),
  ``tests/test_datatype.py``'s ``Pack`` / ``Unpack`` of a vector, and a
  derived-type host ``Bcast``; on 3 ranks these run between the two
  native ranks 0 and 2, where single copy is on;
- ``tests/test_device_path.py:134-240``'s tuple forms on device arrays
  (CPU tensors in the port, jax CPU arrays in the reference): Send /
  Recv of a vector with a flat receive of its packed form, Isend / Irecv
  of a subarray, an Allreduce of a vector; and Sendrecv, Bcast, Ibcast
  and Iallreduce ones, a bfloat16 tensor from the forced rank, and
  'linear' Allreduces of random floats, bitwise.
"""

import json
import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch import compat
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

REF_MCA = {"device_plane": "on"}

#: both packages' prelude: rank 1 advertises big-endian, set before the
#: package (whose cvars resolve at registration) is imported
_PRELUDE = """
import os
if int(os.environ["OMPI_TPU_RANK"]) == 1:
    os.environ["OMPI_TPU_ARCH"] = "big"
import json
import numpy as np
from {pkg} import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size
"""

_HEAD = """
from {pkg} import errors
from {pkg}.core import pvar
from {pkg}.datatype import datatype as D
OUT, WHO, PORT = {out!r}, {who!r}, {port!r}
res = {{}}
if PORT:
    import torch

    def dev(a):
        return torch.from_numpy(np.array(a, copy=True))

    def host(x):
        return x.numpy()

    def dev_bf16(bits):
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)

    def host_bits(x):
        return x.view(torch.int16).numpy()
else:
    import jax.numpy as jnp

    def dev(a):
        return jnp.asarray(a)

    def host(x):
        return np.asarray(x)

    def dev_bf16(bits):
        return jnp.asarray(bits).view(jnp.bfloat16)

    def host_bits(x):
        return np.asarray(x).view(np.int16)


def save(name, arr):
    np.save(f"{{OUT}}/{{WHO}}_{{name}}_r{{rank}}.npy", np.asarray(arr))


def pv(name):
    return pvar.read(name)


def rng(tag):
    return np.random.default_rng(1000 * size + 17 * rank + tag)


last = size - 1
"""

_TAIL = """
with open(f"{OUT}/{WHO}_res_r{rank}.json", "w") as fh:
    json.dump(res, fh, sort_keys=True, default=str)
mpi.Finalize()
"""

#: the rank body both packages run
_BODY = """
# -- tests/test_hetero.py: rank 1 advertises big-endian --
vals = np.array([1.5, -2.25, 3e18, 7e-12], np.float64)
ints = np.arange(10, dtype=np.int32) * 1000
if rank == 0:
    comm.Send(vals, dest=1, tag=1)
    got = np.zeros(10, np.int32)
    st = comm.Recv(got, source=1, tag=2)
    save("eager_ints", got)
    res["eager_ints_count"] = st.count
elif rank == 1:
    got = np.zeros(4, np.float64)
    comm.Recv(got, source=0, tag=1)
    save("eager_vals", got)
    comm.Send(ints, dest=0, tag=2)

n = 200_000
copies0 = pv("smsc_single_copies")
if rank == 0:
    comm.Send(np.arange(n, dtype=np.float64), dest=1, tag=3)
    mat = np.arange(16, dtype=np.float32).reshape(4, 4)
    col = D.vector(4, 1, 4, D.FLOAT).commit()
    comm.Send((mat, 1, col), dest=1, tag=4)
elif rank == 1:
    big = np.zeros(n, np.float64)
    comm.Recv(big, source=0, tag=3)
    save("rndv_big", big)
    colbuf = np.zeros(4, np.float32)
    st = comm.Recv(colbuf, source=0, tag=4)
    save("column", colbuf)
    res["column_elements"] = [st.get_count(D.FLOAT),
                              st.get_elements(D.vector(4, 1, 4, D.FLOAT))]
    # single copy disqualifies itself across the orders
    res["cross_single_copies"] = pv("smsc_single_copies") - copies0

out = np.zeros(8, np.float64)
comm.Allreduce(np.full(8, float(rank + 1)), out)
save("allreduce_cross", out)
buf = np.arange(6, dtype=np.int64) if rank == 0 else np.zeros(6, np.int64)
comm.Bcast(buf, root=0)
save("bcast_cross", buf)
r = rng(5).standard_normal(33).astype(np.float32)
out = np.zeros_like(r)
comm.Allreduce(r, out, op=mpi.MAX)
save("allreduce_max_f32", out)

pair = D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32]).commit()
send = np.zeros(2, dtype=np.dtype([("d", np.float64), ("i", np.int32)]))
send["d"] = [1.25, -3e7]
send["i"] = [42, -7]
minloc = np.zeros(3, D.DOUBLE_INT.base)
minloc["val"] = [0.5, -1.5, 9e9]
minloc["loc"] = [10, 20, 30]
sub_dt = np.dtype([("v", "<f4", (3,)), ("i", "<i4")])
sub_send = np.zeros(2, sub_dt)
sub_send["v"] = [[1.5, -2.25, 3e7], [0.5, 4.0, -8.25]]
sub_send["i"] = [42, -7]
z = np.array([1 + 2j, -3.5 + 0.25j], np.complex128)
if rank == 0:
    comm.Send((send, 2, pair), dest=1, tag=5)
    comm.Send((minloc, 3, D.DOUBLE_INT), dest=1, tag=6)
    comm.Send((sub_send, 2, D.from_numpy_dtype(sub_dt)), dest=1, tag=7)
    comm.Send(z, dest=1, tag=8)
    back = np.zeros_like(send)
    comm.Recv((back, 2, pair), source=1, tag=9)
    save("struct_back", back)
elif rank == 1:
    got = np.zeros_like(send)
    st = comm.Recv((got, 2, pair), source=0, tag=5)
    save("struct", got)
    res["struct_elements"] = st.get_elements(pair)
    got2 = np.zeros_like(minloc)
    comm.Recv((got2, 3, D.DOUBLE_INT), source=0, tag=6)
    save("minloc", got2)
    got3 = np.zeros_like(sub_send)
    comm.Recv((got3, 2, D.from_numpy_dtype(sub_dt)), source=0, tag=7)
    save("subarray_field", got3)
    gz = np.zeros(2, np.complex128)
    comm.Recv(gz, source=0, tag=8)
    save("complex", gz)
    comm.Send((got, 2, pair), dest=0, tag=9)
    # the forced rank's own traffic: it swaps to its advertisement and
    # converts from it, though the peer's order is its own
    me = np.zeros(2, np.complex128)
    rq_self = comm.Irecv(me, source=1, tag=10)
    comm.Send(z, dest=1, tag=10)
    rq_self.wait()
    save("complex_self", me)

# -- derived types between native ranks (0 and the last rank; on 2
# ranks the last is the forced rank 1 and every case converts) --
import {pkg}.datatype.convertor as cv
limit, cv._SPAN_WINDOW_LIMIT = cv._SPAN_WINDOW_LIMIT, 64
vec8 = D.vector(8, 4, 7, D.DOUBLE)
count = 500
n_elems = count * 7 * 8
copies0 = pv("smsc_single_copies")
if rank == 0:
    buf = np.arange(n_elems, dtype=np.float64)
    conv = cv.Convertor(buf, vec8, count)
    res["windowed"] = [conv._windowed, conv.is_contig_layout]
    comm.Send((buf, count, vec8), last, tag=11)
elif rank == last:
    out = np.full(n_elems, -1.0, np.float64)
    comm.Recv((out, count, vec8), 0, tag=11)
    save("windowed_rndv", out)
    res["windowed_copies"] = pv("smsc_single_copies") - copies0
cv._SPAN_WINDOW_LIMIT = limit

rows, cols = 512, 64
vec = D.vector(rows, cols // 2, cols, D.DOUBLE)
src = np.arange(rows * cols, dtype=np.float64).reshape(rows, cols)
copies0 = pv("smsc_single_copies")
if rank == 0:
    comm.Send((src, 1, vec), dest=last, tag=12)
elif rank == last:
    dst = np.zeros((rows, cols), dtype=np.float64)
    comm.Recv((dst, 1, vec), source=0, tag=12)
    save("noncontig_sc", dst)
    res["noncontig_copies"] = pv("smsc_single_copies") - copies0

vec = D.vector(3, 2, 4, D.INT32)
m = np.arange(12, dtype=np.int32) * 3 if rank == 0 \\
    else np.full(12, -1, np.int32)
comm.Bcast((m, 1, vec), root=0)
save("bcast_vec", m)
a = np.arange(6, dtype=np.int32) + rank
b = np.linspace(0, 1, 4, dtype=np.float64)
size_ab = comm.Pack_size(6, D.INT32) + comm.Pack_size(4, D.DOUBLE)
pk = bytearray(size_ab)
pos = comm.Pack(b, pk, comm.Pack(a, pk, 0))
a2, b2 = np.zeros_like(a), np.zeros_like(b)
comm.Unpack(pk, comm.Unpack(pk, 0, a2), b2)
save("pack_a", a2)
save("pack_b", b2)
srcv = np.arange(12, dtype=np.int32) * (rank + 1)
outv = bytearray(comm.Pack_size(1, vec))
end = comm.Pack((srcv, 1, vec), outv, 0)
save("pack_vec", np.frombuffer(bytes(outv[:end]), np.uint8))
res["pack_sizes"] = [size_ab, pos, end]
save("pack_external", np.frombuffer(mpi.Pack_external(
    "external32", srcv, vec, 1), np.uint8))

# -- tests/test_device_path.py's tuple forms on device arrays --
vec = D.vector(3, 2, 4, D.FLOAT)
if rank == 0:
    x = dev(np.arange(12, dtype=np.float32))
    comm.Send((x, 1, vec), dest=1, tag=20)
    comm.Send((x, 1, vec), dest=1, tag=21)
    sub = D.subarray([4, 4], [2, 2], [1, 1], D.FLOAT)
    comm.Isend((dev(np.arange(16, dtype=np.float32).reshape(4, 4)), 1,
                sub), dest=1, tag=22).wait()
    bf = comm.Recv(dev_bf16(np.zeros(8, np.uint16)), source=1, tag=23)
    save("dev_bf16", host_bits(bf))
elif rank == 1:
    st = mpi.Status()
    tpl = dev(np.full(12, -1.0, np.float32))
    out = comm.Recv((tpl, 1, vec), source=0, tag=20, status=st)
    save("dev_recv_vec", host(out))
    res["dev_recv_count"] = st.count
    flat = comm.Recv(dev(np.zeros(6, np.float32)), source=0, tag=21)
    save("dev_recv_flat", host(flat))
    sub = D.subarray([4, 4], [2, 2], [1, 1], D.FLOAT)
    r = comm.Irecv((dev(np.zeros((4, 4), np.float32)), 1, sub), source=0,
                   tag=22)
    mpi.wait_all([r], timeout=60)
    save("dev_irecv_sub", host(r.array))
    bits = np.arange(8, dtype=np.uint16) * 4099
    comm.Send(dev_bf16(bits), dest=0, tag=23)
    comm.Send(dev(np.arange(5, dtype=np.float32) + 0.5), dest=0, tag=24)
if rank == 0:
    # the forced rank's device send, read raw off the wire by host
    # receives: the chunks are typed, so they travel big-endian
    hdr = np.zeros(1, np.int64)
    comm.Recv(hdr, source=1, tag=24)
    wire = np.zeros(20, np.uint8)
    comm.Recv(wire, source=1, tag=24)
    save("dev_wire_from_big", wire)
    res["dev_wire_elements"] = int(hdr[0])

# a ring of Sendrecv tuple forms (the reference returns no array from
# Sendrecv: its Irecv / Isend pair gives the same receive)
right, left = (rank + 1) % size, (rank - 1) % size
x = dev(np.arange(12, dtype=np.float32) + 100 * rank)
tpl = dev(np.full(12, -1.0, np.float32))
if PORT:
    st = comm.Sendrecv((x, 1, vec), right, (tpl, 1, vec), left, 30, 30)
    got = tpl
else:
    r = comm.Irecv((tpl, 1, vec), left, 30)
    s = comm.Isend((x, 1, vec), right, 30)
    st = r.wait()
    s.wait()
    got = r.array
save("dev_sendrecv", host(got))
res["dev_sendrecv_count"] = st.count

vec2 = D.vector(2, 1, 3, D.FLOAT)
x = dev(np.arange(6, dtype=np.float32) + rank)
save("dev_allreduce_vec", host(comm.Allreduce((x, 1, vec2))))
vec3 = D.vector(64, 3, 5, D.FLOAT)
xr = rng(7).standard_normal(320).astype(np.float32)
save("dev_allreduce_linear", host(comm.Allreduce(
    (dev(xr), 1, vec3), deterministic="linear")))
save("dev_allreduce_count", host(comm.Allreduce(
    (dev(xr), 7), deterministic="linear")))
xb = dev(np.arange(12, dtype=np.float32) * 7) if rank == last \\
    else dev(np.full(12, -2.0, np.float32))
save("dev_bcast_vec", host(comm.Bcast((xb, 1, vec), root=last)))
xb = dev(np.arange(12, dtype=np.float32) * 3) if rank == 0 \\
    else dev(np.full(12, -3.0, np.float32))
req = comm.Ibcast((xb, 1, vec), root=0)
req.wait()
save("dev_ibcast_vec", host(req.array))
req = comm.Iallreduce((dev(xr), 1, vec3), deterministic="linear")
req.wait()
save("dev_iallreduce_vec", host(req.array))
res["staged"] = pv("coll_accelerator_staged")

# -- tests/test_smsc.py: an offer declined by a disqualified receiver
# (process-permanent, so last) --
if size == 3:
    from {pkg} import smsc
    if rank == 2:
        smsc.disqualify("test: receiver-side denial")
    comm.Barrier()
    vec = D.vector(1024, 16, 32, D.DOUBLE)
    src = np.arange(1024 * 32, dtype=np.float64).reshape(1024, 32)
    copies0, frags0 = pv("smsc_single_copies"), pv("rndv_frag")
    if rank == 0:
        comm.Send(np.arange(1 << 19, dtype=np.float64), dest=2, tag=40)
        comm.Send((src, 1, vec), dest=2, tag=41)
        res["declined_streamed"] = pv("rndv_frag") - frags0 > 1
    elif rank == 2:
        buf = np.zeros(1 << 19, np.float64)
        comm.Recv(buf, source=0, tag=40)
        save("declined", buf)
        dst = np.zeros((1024, 32), np.float64)
        comm.Recv((dst, 1, vec), source=0, tag=41)
        save("declined_vec", dst)
        res["declined_copies"] = pv("smsc_single_copies") - copies0
"""

#: the port's own refusals, checked inside its jobs
_PORT_CHECKS = """
def error_class(fn):
    try:
        fn()
    except errors.MPIError as e:
        return e.error_class
    raise AssertionError("no MPIError raised")

t = dev(np.zeros(12, np.float32))
# a tuple form on an entry outside the device tuple list
assert error_class(lambda: comm.Ssend((t, 1, vec2), dest=rank)) \\
    == errors.ERR_NOT_SUPPORTED
assert error_class(lambda: comm.Reduce((t, 1, vec2), None)) \\
    == errors.ERR_NOT_SUPPORTED
# a struct of mixed fields has no device route; a type past the end
mixed = D.create_struct([1, 1], [0, 4], [D.INT8, D.FLOAT])
assert error_class(lambda: comm.Send((t, 1, mixed), dest=mpi.PROC_NULL)) \\
    == errors.ERR_TYPE
assert error_class(lambda: comm.Allreduce((t, 4, vec2))) == errors.ERR_TYPE
# a non-contiguous numpy buffer names the derived-datatype route
assert error_class(lambda: comm.Send(np.zeros((4, 4))[:, 0], dest=rank)) \\
    == errors.ERR_BUFFER

# the chip smoke's example at a test size, in this job (its Finalize is
# this job's): the device mode, then the heterogeneous host mode (rank 1
# is big-endian already)
from ompi_tpu_torch.examples import datatype_exchange
fin = mpi.Finalize
mpi.Finalize = lambda: None
try:
    datatype_exchange.main(["--size", "24", "--out", f"{OUT}/example"])
    datatype_exchange.main(["--hetero", "--count", "100",
                            "--out", f"{OUT}/example_hetero"])
finally:
    mpi.Finalize = fin
"""


def _job(tmp, n):
    """Run the body in both packages on n ranks; returns the results
    directory."""
    head = dict(out=str(tmp))
    run_ranks(_PRELUDE.format(pkg="ompi_tpu")
              + _HEAD.format(pkg="ompi_tpu", who="ref", port=False, **head)
              + _BODY.replace("{pkg}", "ompi_tpu") + _TAIL, n, mca=REF_MCA,
              timeout=240, prelude=False, isolate=True)
    src = (_PRELUDE.format(pkg="ompi_tpu_torch")
           + _HEAD.format(pkg="ompi_tpu_torch", who="port", port=True,
                          **head)
           + _BODY.replace("{pkg}", "ompi_tpu_torch") + _PORT_CHECKS + _TAIL)
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        rc = port_launcher.launch(
            [sys.executable, path], n, timeout=240,
            mca=dict(compat.mca_from_reference(REF_MCA),
                     device_plane_platform="cpu"))
    finally:
        os.unlink(path)
    assert rc == 0, f"port job on {n} ranks exited {rc}"
    return tmp


def _compare(d, n):
    """Every .npy bitwise through a uint8 view, every result equal."""
    names = sorted(f for f in os.listdir(d) if f.startswith("ref_"))
    assert names
    for f in names:
        got = os.path.join(d, "port_" + f[4:])
        assert os.path.exists(got), f"the port wrote no {f[4:]}"
        if f.endswith(".npy"):
            ref, port = np.load(os.path.join(d, f)), np.load(got)
            assert ref.dtype == port.dtype and ref.shape == port.shape, f
            np.testing.assert_array_equal(
                ref.reshape(-1).view(np.uint8),
                port.reshape(-1).view(np.uint8), err_msg=f)
        else:
            with open(os.path.join(d, f)) as a, open(got) as b:
                ref, port = json.load(a), json.load(b)
            assert ref == port, (f, ref, port)
    return {r: json.load(open(os.path.join(d, f"port_res_r{r}.json")))
            for r in range(n)}


@pytest.fixture(scope="module", params=[2, 3], ids=["n2", "n3"])
def job(request, tmp_path_factory):
    n = request.param
    d = _job(tmp_path_factory.mktemp(f"dtp2p{n}"), n)
    return n, _compare(d, n), d


def _load(d, name, rank):
    return np.load(os.path.join(d, f"port_{name}_r{rank}.npy"))


def test_heterogeneous_peers(job):
    """Rank 1 advertises big-endian: eager, RNDV, a strided column, the
    host collectives, mixed structs, the MINLOC pair, a subarray field
    and complex128 arrive converted, equal to the reference and to the
    values sent; single copy stays off across the orders."""
    n, res, d = job
    np.testing.assert_array_equal(_load(d, "eager_ints", 0),
                                  np.arange(10, dtype=np.int32) * 1000)
    np.testing.assert_array_equal(_load(d, "rndv_big", 1),
                                  np.arange(200_000, dtype=np.float64))
    np.testing.assert_array_equal(_load(d, "column", 1), [0, 4, 8, 12])
    assert res[1]["cross_single_copies"] == 0
    assert res[1]["column_elements"] == [4, 4]
    assert (_load(d, "allreduce_cross", n - 1)
            == n * (n + 1) / 2).all()
    got = _load(d, "struct", 1)
    assert got["d"].tolist() == [1.25, -3e7] and got["i"].tolist() == [42, -7]
    assert res[1]["struct_elements"] == 4
    assert _load(d, "minloc", 1)["loc"].tolist() == [10, 20, 30]
    assert _load(d, "complex_self", 1).tolist() == [1 + 2j, -3.5 + 0.25j]
    np.testing.assert_array_equal(_load(d, "struct_back", 0),
                                  _load(d, "struct", 1))


def test_derived_types_between_ranks(job):
    """The windowed big-count RNDV, a non-contiguous single copy, a
    derived-type host Bcast and Pack / Unpack / Pack_external: equal to
    the reference; single copy ran between the native ranks of the
    3-rank job and stayed off on 2 (the last rank is the forced one)."""
    n, res, d = job
    assert res[0]["windowed"] == [True, False]
    last = n - 1
    sc = res[last]["noncontig_copies"], res[last]["windowed_copies"]
    assert sc == ((1, 1) if n == 3 else (0, 0))
    dst = _load(d, "noncontig_sc", last)
    src = np.arange(512 * 64, dtype=np.float64).reshape(512, 64)
    np.testing.assert_array_equal(dst[:, :32], src[:, :32])
    assert (dst[:, 32:] == 0).all()
    want = np.full(12, -1, np.int32)
    want[[0, 1, 4, 5, 8, 9]] = np.array([0, 1, 4, 5, 8, 9]) * 3
    for r in range(n):
        np.testing.assert_array_equal(
            _load(d, "bcast_vec", r),
            want if r else np.arange(12, dtype=np.int32) * 3)
    assert res[0]["pack_sizes"] == [56, 56, 24]
    if n == 3:
        assert res[0]["declined_streamed"] and res[2]["declined_copies"] == 0


def test_datatype_exchange_example(job):
    """The chip smoke's example (``examples/datatype_exchange.py``) at a
    24 x 24 tile: halo columns by tuple-form Send / Recv, the 'linear'
    and 'ring' Allreduce and the Bcast of a column, checked bitwise by
    every rank; then the heterogeneous host mode, rank 1 big-endian."""
    n, _, d = job
    for sub in ("example", "example_hetero"):
        for r in range(n):
            with open(os.path.join(d, sub, f"rank{r}.json")) as f:
                doc = json.load(f)
            assert doc["cases"] and all(c["ok"] for c in doc["cases"]), doc
            assert doc["coll_accelerator_staged"] == 0
            if sub == "example_hetero":
                assert doc["arch"] == ("big" if r == 1 else "little")
            else:
                assert set(doc["p50_ms"]) == {
                    "halo Send/Recv", "Allreduce linear", "Allreduce ring",
                    "Bcast"}


def test_device_tuple_forms(job):
    """(tensor, count, datatype) on Send / Recv / Isend / Irecv /
    Sendrecv / Allreduce / Bcast / Ibcast / Iallreduce over CPU tensors:
    packed on the device, the packed form moved, scattered back in place
    with the gaps kept, equal to the reference's; nothing staged."""
    n, res, d = job
    want = np.full(12, -1.0, np.float32)
    want[[0, 1, 4, 5, 8, 9]] = [0, 1, 4, 5, 8, 9]
    np.testing.assert_array_equal(_load(d, "dev_recv_vec", 1), want)
    assert res[1]["dev_recv_count"] == 24
    np.testing.assert_array_equal(_load(d, "dev_recv_flat", 1),
                                  [0, 1, 4, 5, 8, 9])
    np.testing.assert_array_equal(
        _load(d, "dev_bf16", 0),
        (np.arange(8, dtype=np.uint16) * 4099).view(np.int16))
    assert res[0]["dev_wire_elements"] == 5
    assert _load(d, "dev_wire_from_big", 0).tobytes() == (
        np.arange(5, dtype=np.float32) + 0.5).astype(">f4").tobytes()
    x = np.arange(6, dtype=np.float32)
    for r in range(n):
        exp = x + r
        exp[[0, 3]] = [sum(i + q for q in range(n)) for i in (0, 3)]
        np.testing.assert_array_equal(_load(d, "dev_allreduce_vec", r), exp)
        assert res[r]["staged"] == 0
