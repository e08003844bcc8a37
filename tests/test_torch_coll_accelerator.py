"""coll/accelerator, the port's staging of tensors through the host
collectives, against the JAX package's.

Two jobs, each run by both packages (the reference through
``tests.harness.run_ranks``, the port through its launcher with the
settings mapped by ``compat.mca_from_reference`` plus
``device_plane_platform cpu``), making the same seeded numpy inputs and
writing every result as ``.npy``; the test compares them bitwise through
a uint8 view:

- 4 ranks, no device plane: the staged cases of
  ``tests/test_accel_coll.py`` (Allreduce, Bcast, Allgather, Alltoall,
  Reduce_scatter_block, Scatter, Gather, Reduce of device buffers), which
  coll/accelerator serves in both packages (cpu-backed jax arrays in the
  reference, CPU tensors in the port), and every other staged slot: the
  v-collectives, Scan / Exscan, the ``I*`` forms and Ibarrier, the
  ``*_init`` forms started three times, Allreduce_multi and the zero/
  pair Reduce_scatter_multi / Allgather_multi;
- 3 ranks under ``device_plane on``: what coll/device (coll/xla in the
  reference) hands to the staging, decided from the op and the dtype:
  REPLACE, NO_OP and a non-commutative ``op.create`` through every
  reducing slot and their nonblocking, persistent and fused forms
  (bfloat16 REPLACE among them, moved as bits), against the reference's
  same calls on jax arrays; float64, int64 and complex64 tensors through
  every slot, against the reference's host collectives on the same numpy
  values (jax holds no 64-bit dtype).

The port's jobs read ``coll_accelerator_staged`` against the staged calls
they made, and check that MINLOC / MAXLOC on a tensor raise ERR_OP.
"""

import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch import compat
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

_REF_HEAD = """
import jax.numpy as jnp
from ompi_tpu import errors, op as O
OUT, WHO = {out!r}, "ref"

def T(a, dtype=None):
    x = jnp.asarray(a)
    return x if dtype is None else x.astype(dtype)

def N(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x
"""

_PORT_HEAD = """
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi, op as O
from ompi_tpu_torch.core import pvar
comm = mpi.Init()
rank, size = comm.rank, comm.size
OUT, WHO = {out!r}, "port"
staged0 = pvar.read("coll_accelerator_staged")

def T(a, dtype=None):
    x = compat.tensor_from_numpy(np.asarray(a))
    return x if dtype is None else x.to(getattr(torch, dtype))

def N(x):
    return compat.tensor_to_numpy(x)
"""

_COMMON = """
def save(name, x):
    if x is not None:
        np.save(f"{OUT}/{WHO}_{name}_r{rank}.npy", np.asarray(N(x)))

def rng(tag):
    return np.random.default_rng(1000 * size + 17 * rank + tag)

def wait(req):
    req.wait()
    return req.array
"""

#: 4 ranks, no device plane: coll/accelerator serves every device slot
_BODY4 = """
# -- tests/test_accel_coll.py's staged cases --
x = T(np.arange(8, dtype=np.float32) + rank)
save("allreduce", comm.Allreduce(x))
save("bcast", comm.Bcast(T(np.full(4, float(rank), np.float32)), root=2))
save("allgather", comm.Allgather(T(np.array([rank, rank * 10], np.int32))))
save("alltoall", comm.Alltoall(T(np.arange(size, dtype=np.int32)
                                 + rank * 100)))
save("rsb", comm.Reduce_scatter_block(T(np.ones(size * 2, np.float32)
                                        * (rank + 1))))
if rank == 0:
    mine = comm.Scatter(T(np.arange(size * 3, dtype=np.float32)), root=0)
else:
    mine = comm.Scatter(None, None, root=0, device=True)
save("scatter", mine)
save("gather", comm.Gather(mine, root=1))
save("reduce", comm.Reduce(T(np.full(2, rank + 1.0, np.float32)), root=0))
# -- every other staged slot, seeded float32 --
a = rng(1).standard_normal(12).astype(np.float32)
xa = T(a)
counts = [1, 3, 0, 2][:size] + [2] * max(0, size - 4)
mine = T(rng(2).standard_normal((counts[rank], 2)).astype(np.float32))
save("allgatherv", comm.Allgatherv(mine, None, counts))
save("gatherv", comm.Gatherv(mine, None, counts, root=2))
sv = T(np.arange(sum(counts) * 2, dtype=np.float32).reshape(-1, 2)) \\
    if rank == 0 else None
save("scatterv", comm.Scatterv(sv, T(np.zeros((counts[rank], 2),
                                             np.float32)),
                               counts, root=0, device=rank != 0))
sc = [(rank + q) % 3 for q in range(size)]
rc = [(p + rank) % 3 for p in range(size)]
save("alltoallv", comm.Alltoallv(T(rng(3).standard_normal(
    (sum(sc), 3)).astype(np.float32)), None, sc, rc))
save("reduce_scatter", comm.Reduce_scatter(
    T(rng(4).standard_normal((sum(counts), 2)).astype(np.float32)), None,
    counts))
save("scan", comm.Scan(xa))
save("exscan", comm.Exscan(xa))
save("reduce_max", comm.Reduce(xa, op=O.MAX, root=3))
comm.Barrier(device=True)
# the nonblocking forms
save("iallreduce", wait(comm.Iallreduce(xa)))
save("ibcast", wait(comm.Ibcast(xa, root=1)))
save("ireduce", wait(comm.Ireduce(xa, root=2)))
save("iallgather", wait(comm.Iallgather(xa)))
save("igather", wait(comm.Igather(xa, root=0)))
save("ialltoall", wait(comm.Ialltoall(xa)))
save("irsb", wait(comm.Ireduce_scatter_block(xa)))
save("iscan", wait(comm.Iscan(xa)))
save("iexscan", wait(comm.Iexscan(xa)))
if rank == 3:
    save("iscatter", wait(comm.Iscatter(xa, root=3)))
else:
    save("iscatter", wait(comm.Iscatter(None, None, root=3, device=True)))
save("iallgatherv", wait(comm.Iallgatherv(mine, None, counts)))
save("igatherv", wait(comm.Igatherv(mine, None, counts, root=1)))
save("ialltoallv", wait(comm.Ialltoallv(T(rng(5).standard_normal(
    (sum(sc), 3)).astype(np.float32)), None, sc, rc)))
save("ireduce_scatter", wait(comm.Ireduce_scatter(
    T(rng(6).standard_normal((sum(counts), 2)).astype(np.float32)), None,
    counts)))
comm.Ibarrier(device=True).wait()
# the persistent forms, three starts each
for name, req in (("ar", comm.Allreduce_init(xa)),
                  ("bc", comm.Bcast_init(xa, root=3)),
                  ("ag", comm.Allgather_init(xa)),
                  ("a2a", comm.Alltoall_init(xa)),
                  ("rsb", comm.Reduce_scatter_block_init(xa))):
    for it in range(3):
        req.start()
        save(f"init_{name}_{it}", wait(req))
# the fused and zero/ slots
out = comm.Allreduce_multi({"w": xa, "b": [T(a[:5] * 3)]})
save("multi_w", out["w"])
save("multi_b", out["b"][0])
st = comm.Reduce_scatter_multi([xa, T(a[:7] * 2)])
for b, s in enumerate(st.shards):
    save(f"rs_multi_{b}", s)
full = comm.Allgather_multi(st)
save("ag_multi_0", full[0])
save("ag_multi_1", full[1])
"""

_PORT_TAIL4 = """
assert comm.coll.providers["allreduce_dev"] == "accelerator"
# every call above staged once; the zero/ pair once each, Allreduce_multi
# once a leaf, a persistent request once a start
want = 8 + 9 + 15 + 15 + 2 + 2
assert pvar.read("coll_accelerator_staged") - staged0 == want, \\
    pvar.read("coll_accelerator_staged") - staged0
for op in (O.MINLOC, O.MAXLOC):
    try:
        comm.Allreduce(xa, op=op)
    except errors.MPIError as e:
        assert e.error_class == errors.ERR_OP and "SHORT_INT" in str(e)
    else:
        raise AssertionError("MINLOC on a tensor was not refused")
open(f"{OUT}/port_ok_r{rank}.ok", "w").close()
mpi.Finalize()
"""

#: 3 ranks under device_plane on: what coll/device hands to the staging
_BODY3 = """
UOP = O.create(lambda a, b: a * 0.5 + b, commute=False)
for oname, op in (("replace", O.REPLACE), ("noop", O.NO_OP),
                  ("user", UOP)):
    a = rng(10).standard_normal(6).astype(np.float32)
    x = T(a)
    save(f"{oname}_allreduce", comm.Allreduce(x, op=op))
    save(f"{oname}_reduce", comm.Reduce(x, op=op, root=1))
    save(f"{oname}_rsb", comm.Reduce_scatter_block(x, op=op))
    save(f"{oname}_reduce_scatter", comm.Reduce_scatter(x, None, [1, 2, 3],
                                                        op=op))
    save(f"{oname}_scan", comm.Scan(x, op=op))
    save(f"{oname}_exscan", comm.Exscan(x, op=op))
    save(f"{oname}_iallreduce", wait(comm.Iallreduce(x, op=op)))
    req = comm.Allreduce_init(x, None, op)
    for it in range(3):
        req.start()
        save(f"{oname}_init_{it}", wait(req))
    out = comm.Allreduce_multi([x, T(a[:4] * 2)], op=op)
    save(f"{oname}_multi_0", out[0])
    save(f"{oname}_multi_1", out[1])
save("bf16_replace", comm.Allreduce(T(rng(11).standard_normal(5).astype(
    np.float32), "bfloat16"), op=O.REPLACE))
"""

#: the 64-bit and complex dtypes: the reference's host collectives on
#: numpy, the port's tensor calls (coll/device stages them)
_REF_WIDE = """
def host(fn, like):
    out = np.zeros_like(like)
    fn(out)
    return out
d = rng(20).standard_normal(6)
i = rng(21).integers(-2**40, 2**40, 6)
c = (rng(22).standard_normal(6) + 1j * rng(23).standard_normal(6)).astype(
    np.complex64)
save("f64_allreduce", host(lambda o: comm.Allreduce(d, o), d))
save("i64_allreduce_max", host(lambda o: comm.Allreduce(i, o, op=O.MAX), i))
save("c64_allreduce", host(lambda o: comm.Allreduce(c, o), c))
b = i.copy() if rank == 2 else np.zeros_like(i)
comm.Bcast(b, root=2)
save("i64_bcast", b)
save("f64_allgather", host(lambda o: comm.Allgather(d, o),
                           np.zeros(6 * size)))
save("i64_alltoall", host(lambda o: comm.Alltoall(i, o), i))
g = np.zeros(6 * size)
comm.Gather(d, g if rank == 0 else None, root=0)
if rank == 0:
    save("f64_gather", g)
sv = np.arange(6 * size, dtype=np.float64) if rank == 1 else None
save("f64_scatter", host(lambda o: comm.Scatter(sv, o, root=1),
                         np.zeros(6)))
r = np.zeros(6)
comm.Reduce(d, r, root=2)
if rank == 2:
    save("f64_reduce", r)
save("f64_rsb", host(lambda o: comm.Reduce_scatter_block(d, o),
                     np.zeros(2)))
save("f64_scan", host(lambda o: comm.Scan(d, o), d))
save("f64_allgatherv", host(lambda o: comm.Allgatherv(d[:rank + 1], o,
                                                      [1, 2, 3]),
                            np.zeros(6)))
save("i64_alltoallv", host(lambda o: comm.Alltoallv(i[:size], o,
                                                    [1] * size, [1] * size),
                           np.zeros(size, np.int64)))
save("f64_iallreduce", host(lambda o: comm.Iallreduce(d, o).wait(), d))
for it in range(3):
    save(f"f64_init_{it}", host(lambda o: comm.Allreduce(d * (it + 1), o),
                                d))
"""

_PORT_WIDE = """
s = pvar.session()
d = rng(20).standard_normal(6)
i = rng(21).integers(-2**40, 2**40, 6)
c = (rng(22).standard_normal(6) + 1j * rng(23).standard_normal(6)).astype(
    np.complex64)
save("f64_allreduce", comm.Allreduce(T(d)))
save("i64_allreduce_max", comm.Allreduce(T(i), op=O.MAX))
save("c64_allreduce", comm.Allreduce(T(c)))
save("i64_bcast", comm.Bcast(T(i if rank == 2 else np.zeros_like(i)),
                             root=2))
save("f64_allgather", comm.Allgather(T(d)))
save("i64_alltoall", comm.Alltoall(T(i)))
save("f64_gather", comm.Gather(T(d), root=0))
save("f64_scatter", comm.Scatter(
    T(np.arange(6 * size, dtype=np.float64)) if rank == 1 else None, None,
    root=1, device=True))
save("f64_reduce", comm.Reduce(T(d), root=2))
save("f64_rsb", comm.Reduce_scatter_block(T(d)))
save("f64_scan", comm.Scan(T(d)))
save("f64_allgatherv", comm.Allgatherv(T(d[:rank + 1]), None, [1, 2, 3]))
save("i64_alltoallv", comm.Alltoallv(T(i[:size]), None, [1] * size,
                                     [1] * size))
save("f64_iallreduce", wait(comm.Iallreduce(T(d))))
src = T(d)
req = comm.Allreduce_init(src)
for it in range(3):
    src.copy_(T(d * (it + 1)))
    req.start()
    save(f"f64_init_{it}", wait(req))
assert s.read("coll_accelerator_staged") == 17, \\
    s.read("coll_accelerator_staged")
assert s.read("coll_device_launches") == 0
"""

_PORT_TAIL3 = """
assert comm.coll.providers["allreduce_dev"] == "device"
# _BODY3: 3 ops x (7 calls, 3 starts, 2 leaves) + the bfloat16 REPLACE,
# then the wide dtypes' 17
assert pvar.read("coll_accelerator_staged") - staged0 == 3 * 12 + 1 + 17
for op in (O.MINLOC, O.MAXLOC):
    for call in (lambda: comm.Allreduce(T(np.ones(3, np.float32)), op=op),
                 lambda: comm.Reduce(T(np.ones(3)), op=op, root=0)):
        try:
            call()
        except errors.MPIError as e:
            assert e.error_class == errors.ERR_OP and "pair" in str(e)
        else:
            raise AssertionError("MINLOC on a tensor was not refused")
open(f"{OUT}/port_ok_r{rank}.ok", "w").close()
mpi.Finalize()
"""


def _job(tmp, n, ref_mca, ref_body, port_body):
    head = dict(out=str(tmp))
    run_ranks(_REF_HEAD.format(**head) + _COMMON + ref_body, n,
              mca=ref_mca, timeout=300, isolate=True)
    src = _PORT_HEAD.format(**head) + _COMMON + port_body
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        rc = port_launcher.launch(
            [sys.executable, path], n,
            mca=dict(compat.mca_from_reference(ref_mca),
                     device_plane_platform="cpu"), timeout=300)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job on {n} ranks exited {rc}"
    return n, tmp


@pytest.fixture(scope="module")
def staged4(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("accel4"), 4, {}, _BODY4,
                _BODY4 + _PORT_TAIL4)


@pytest.fixture(scope="module")
def handed3(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("accel3"), 3,
                {"device_plane": "on"}, _BODY3 + _REF_WIDE,
                _BODY3 + _PORT_WIDE + _PORT_TAIL3)


def _check(job, prefixes):
    """Every ref_<prefix>*.npy equals the port's bitwise (uint8 views of
    the flattened results: a host Allgather's recvbuf is flat where the
    tensor form returns (n, ...)); returns how many were compared."""
    n, d = job
    seen = 0
    for f in sorted(os.listdir(d)):
        if not (f.startswith("ref_") and f.endswith(".npy")
                and f[4:].startswith(prefixes)):
            continue
        got = d / ("port_" + f[4:])
        assert got.exists(), f"the port wrote no {f[4:]}"
        ref, port = np.load(d / f), np.load(got)
        assert ref.dtype == port.dtype and ref.size == port.size, \
            (f, ref.dtype, port.dtype, ref.shape, port.shape)
        np.testing.assert_array_equal(ref.reshape(-1).view(np.uint8),
                                      port.reshape(-1).view(np.uint8),
                                      err_msg=f)
        seen += 1
    for r in range(n):
        assert (d / f"port_ok_r{r}.ok").exists()
    return seen


def test_accel_coll_staged_cases(staged4):
    """``tests/test_accel_coll.py``'s staged cases on 4 ranks: Allreduce,
    Bcast from root 2, Allgather, Alltoall, Reduce_scatter_block, the
    root's Scatter and the non-roots' ``device=True`` form, Gather to
    root 1 and Reduce to root 0, bitwise the reference's."""
    assert _check(staged4, ("allreduce_r", "bcast", "allgather_r",
                            "alltoall_r", "rsb", "scatter_r", "gather_r",
                            "reduce_r")) == 6 * 4 + 2


def test_staged_v_collectives_and_prefixes(staged4):
    """Allgatherv, Gatherv, Scatterv, Alltoallv (zero counts among them),
    Reduce_scatter, Scan, Exscan and a MAX Reduce staged: bitwise."""
    _check(staged4, ("allgatherv", "gatherv", "scatterv", "alltoallv",
                     "reduce_scatter", "scan", "exscan", "reduce_max"))


def test_staged_nonblocking(staged4):
    """Every staged ``I*`` form (15) and Ibarrier: each request's result
    bitwise the reference's."""
    assert _check(staged4, (
        "iallreduce", "ibcast", "ireduce", "iallgather", "igather",
        "ialltoall", "irsb", "iscan", "iexscan", "iscatter",
        "iallgatherv", "igatherv", "ialltoallv", "ireduce_scatter")) \
        == 14 * 4 - 3 - 3 - 3


def test_staged_persistent(staged4):
    """Allreduce_init, Bcast_init, Allgather_init, Alltoall_init and
    Reduce_scatter_block_init started three times each: bitwise."""
    assert _check(staged4, ("init_",)) == 5 * 3 * 4


def test_staged_fused_and_zero(staged4):
    """Allreduce_multi leaf by leaf, Reduce_scatter_multi (the ZeroPlan's
    padded bucket, one host allreduce each) and Allgather_multi back:
    bitwise, and every staged call counted in coll_accelerator_staged."""
    _check(staged4, ("multi_", "rs_multi_", "ag_multi_"))


@pytest.mark.parametrize("op", ["replace", "noop", "user"])
def test_untraceable_ops_fall_through(handed3, op):
    """REPLACE, NO_OP and a non-commutative ``op.create`` under
    ``device_plane on``: coll/device hands Allreduce, Reduce,
    Reduce_scatter(_block), Scan, Exscan, Iallreduce, Allreduce_init and
    Allreduce_multi to coll/accelerator, as coll/xla hands them to the
    reference's staging: bitwise."""
    assert _check(handed3, (f"{op}_",)) == 12 * 3 - 2


def test_bfloat16_replace_moves_bits(handed3):
    """A bfloat16 REPLACE Allreduce stages the tensor's bits: equal to the
    reference's."""
    assert _check(handed3, ("bf16_replace",)) == 3


@pytest.mark.parametrize("dtype", ["f64", "i64", "c64"])
def test_wide_dtypes_fall_through(handed3, dtype):
    """float64, int64 and complex64 tensors through coll/device's slots
    (Allreduce, Bcast, Allgather(v), Alltoall(v), Gather, Scatter, Reduce,
    Reduce_scatter_block, Scan, Iallreduce, Allreduce_init) stage through
    the host: bitwise the reference's host collectives on the same
    values; coll_accelerator_staged counts each call and no kernel
    launches (checked in the port's job)."""
    assert _check(handed3, (f"{dtype}_",))
