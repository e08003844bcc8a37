"""The port's host collectives (coll/basic's linear algorithms, the base
algorithm library, coll/tuned, coll/libnbc, coll/sync and coll/adapt)
against the JAX package's.

One rank body, run on 3 and on 4 ranks by both packages: the reference
through ``tests.harness.run_ranks`` (isolated: the body steps the
``coll_tuned_*`` cvars), the port through its launcher with the same
settings mapped by ``compat.mca_from_reference`` plus
``device_plane_platform cpu``. Both make the same seeded numpy inputs and
write every result as ``.npy`` and every count as JSON; the test compares
the results bitwise through a uint8 view and the counts exactly. The
body covers:

- every case of ``tests/test_coll.py`` (Barrier, Bcast, Allreduce SUM /
  MIN / MAX, the rank-order Reduce, Gather / Scatter, Allgather,
  Alltoall(v), Reduce_scatter_block, Scan / Exscan, collectives on split
  and created communicators, IN_PLACE Allreduce);
- ``tests/test_coll_algos.py``: each forced algorithm of Allreduce,
  Bcast, Allgather, Alltoall and Barrier, stepped by ``cvar.set`` inside
  the job, with seeded float inputs (bitwise, since every algorithm's
  fold order is fixed), coll/tuned's default decisions on both sides of
  the ring switchpoint, the ring Reduce_scatter_block and the
  recursive-halving Reduce_scatter;
- ``tests/test_nbc.py`` and ``tests/test_nbc_extended.py``: every host
  ``I*`` form and Ibarrier, several in flight at once, the ``*_init``
  forms restarted, and coll/adapt's segmented ibcast / ireduce on a dup
  taken with ``coll_adapt_priority`` 25; the schedule-error cases of
  ``test_nbc.py`` run in process against the port's ``NbcRequest``;
- ``tests/test_han_sync.py::test_sync_injects_barriers`` on a dup taken
  with ``coll_sync_barrier_before`` 2.

The port's own additions, compared with the reference too: MINLOC /
MAXLOC over every pair type, a non-commutative ``op.create`` (Allreduce,
Reduce, Scan), ``Reduce_local``, IN_PLACE on Reduce, Scan, Exscan,
Allgather(v) and the ``I*`` forms (the reference's result of the same
call without IN_PLACE where it has no IN_PLACE form), Gatherv / Scatterv
/ Allgatherv, and every ``*_init`` form started three times on refilled
buffers.
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

_HEAD = """
import json
from {pkg} import errors, op as O
from {pkg}.core import cvar, pvar
from {pkg}.pml import request as rq
OUT, WHO = {out!r}, {who!r}
res = {{}}

def save(name, arr):
    np.save(f"{{OUT}}/{{WHO}}_{{name}}_r{{rank}}.npy", np.asarray(arr))

def rng(tag):
    return np.random.default_rng(1000 * size + 17 * rank + tag)
"""

_TAIL = """
with open(f"{OUT}/{WHO}_res_r{rank}.json", "w") as fh:
    json.dump(res, fh, sort_keys=True)
"""

#: the rank body both packages run (``{pkg}`` names the package)
_BODY = """
# -- tests/test_coll.py --
for _ in range(5):
    comm.Barrier()
buf = np.arange(100, dtype=np.float64) if rank == 0 else np.zeros(100)
comm.Bcast(buf, root=0)
save("bcast", buf)
res["bcast_obj"] = comm.bcast({"cfg": 1} if rank == 0 else None, root=0)
data = np.arange(1000, dtype=np.float64) * (rank + 1)
out = np.zeros_like(data)
comm.Allreduce(data, out)
save("allreduce_sum", out)
data = np.array([rank, -rank, rank * 2], dtype=np.int64)
for name, op in (("min", O.MIN), ("max", O.MAX)):
    out = np.zeros(3, dtype=np.int64)
    comm.Allreduce(data, out, op=op)
    save(f"allreduce_{name}", out)
data = (np.arange(64, dtype=np.float32) + 1) * 0.1 * (rank + 1)
for it in range(3):
    out = np.zeros_like(data)
    comm.Reduce(data, out, root=0)
    save(f"reduce_rank_order_{it}", out)
sb = np.full(4, rank, dtype=np.int32)
rb = np.zeros(4 * size, dtype=np.int32) if rank == 0 else None
comm.Gather(sb, rb, root=0)
if rank == 0:
    save("gather", rb)
sendm = np.repeat(np.arange(size, dtype=np.int32) * 10, 2) \\
    if rank == 0 else None
out = np.zeros(2, dtype=np.int32)
comm.Scatter(sendm, out, root=0)
save("scatter", out)
rb = np.zeros(size, dtype=np.int64)
comm.Allgather(np.array([rank * 7], dtype=np.int64), rb)
save("allgather", rb)
res["allgather_obj"] = comm.allgather(["r", rank])
sb = np.array([rank * 10 + d for d in range(size)], dtype=np.int32)
rb = np.zeros(size, dtype=np.int32)
comm.Alltoall(sb, rb)
save("alltoall", rb)
scounts = [d + 1 for d in range(size)]
sb = np.concatenate([np.full(d + 1, rank * 100 + d, dtype=np.int32)
                     for d in range(size)])
rb = np.zeros((rank + 1) * size, dtype=np.int32)
comm.Alltoallv(sb, rb, scounts, [rank + 1] * size)
save("alltoallv", rb)
rb = np.zeros(2)
comm.Reduce_scatter_block(np.arange(2 * size, dtype=np.float64) + rank, rb)
save("reduce_scatter_block", rb)
sb = np.array([rank + 1], dtype=np.int64)
rb = np.zeros(1, dtype=np.int64)
comm.Scan(sb, rb)
save("scan", rb)
eb = np.zeros(1, dtype=np.int64)
comm.Exscan(sb, eb)
if rank > 0:
    save("exscan", eb)
sub = comm.split(color=rank % 2, key=rank)
out = np.zeros(1, dtype=np.int32)
sub.Allreduce(np.array([sub.rank], dtype=np.int32), out)
save("split_allreduce", out)
comm.Barrier()
dup = comm.dup()
dup.Barrier()
even = comm.create(comm.group.incl(list(range(0, size, 2))))
if rank % 2 == 0:
    even.Barrier()
buf = np.full(8, rank + 1, dtype=np.float32)
comm.Allreduce(mpi.IN_PLACE, buf)
save("in_place_allreduce", buf)

# -- tests/test_coll_algos.py: each forced algorithm, seeded floats --
for algo in ("recursivedoubling", "ring", "rabenseifner", "basic", ""):
    cvar.set("coll_tuned_allreduce_algorithm", algo)
    for n in (1, 5, 1000, 4096):
        x = rng(n).standard_normal(n).astype(np.float32)
        out = np.zeros_like(x)
        comm.Allreduce(x, out)
        save(f"allreduce_{algo or 'default'}_{n}", out)
        buf = x.astype(np.float64)
        comm.Allreduce(mpi.IN_PLACE, buf)
        save(f"allreduce_in_place_{algo or 'default'}_{n}", buf)
    x = rng(7).integers(-2**31, 2**31 - 1, 513, dtype=np.int64)
    x = x.astype(np.int32)
    out = np.zeros_like(x)
    comm.Allreduce(x, out, op=O.MAX)
    save(f"allreduce_{algo or 'default'}_i32_max", out)
cvar.set("coll_tuned_allreduce_algorithm", "")
# the default decision past the ring switchpoint
cvar.set("coll_tuned_allreduce_ring_min", 4096)
x = rng(8).standard_normal(3000).astype(np.float32)
out = np.zeros_like(x)
comm.Allreduce(x, out)
save("allreduce_default_past_ring_min", out)
cvar.set("coll_tuned_allreduce_ring_min", 2 << 20)
for algo in ("binomial", "pipeline", "linear", ""):
    cvar.set("coll_tuned_bcast_algorithm", algo)
    cvar.set("coll_tuned_bcast_segsize", 4096)
    for n in (3, 1000, 100_000):
        buf = (np.arange(n, dtype=np.float32) * 2 if rank == 1
               else np.zeros(n, dtype=np.float32))
        comm.Bcast(buf, root=1)
        save(f"bcast_{algo or 'default'}_{n}", buf)
cvar.set("coll_tuned_bcast_algorithm", "")
cvar.set("coll_tuned_bcast_segsize", 1 << 20)
for algo in ("ring", "bruck", "recursivedoubling", "basic", ""):
    cvar.set("coll_tuned_allgather_algorithm", algo)
    for cnt in (1, 7, 512, 5000):
        rb = np.zeros(cnt * size, dtype=np.int64)
        comm.Allgather(np.full(cnt, rank + 1, dtype=np.int64), rb)
        save(f"allgather_{algo or 'default'}_{cnt}", rb)
cvar.set("coll_tuned_allgather_algorithm", "")
for algo in ("pairwise", "bruck", "basic", ""):
    cvar.set("coll_tuned_alltoall_algorithm", algo)
    for cnt in (1, 9):
        sb = np.arange(size * cnt, dtype=np.int32) + rank * 1000
        rb = np.zeros(size * cnt, dtype=np.int32)
        comm.Alltoall(sb, rb)
        save(f"alltoall_{algo or 'default'}_{cnt}", rb)
cvar.set("coll_tuned_alltoall_algorithm", "")
for algo in ("recursivedoubling", "bruck", "linear", ""):
    cvar.set("coll_tuned_barrier_algorithm", algo)
    for _ in range(10):
        comm.Barrier()
cvar.set("coll_tuned_barrier_algorithm", "")
x = rng(9).standard_normal(3 * size).astype(np.float32)
rb = np.zeros(3, dtype=np.float32)
comm.Reduce_scatter_block(x, rb)
save("reduce_scatter_block_ring", rb)
counts = [r + 1 for r in range(size)]
x = rng(10).standard_normal(sum(counts)).astype(np.float32)
rb = np.zeros(rank + 1, dtype=np.float32)
comm.Reduce_scatter(x, rb, counts)
save("reduce_scatter_uneven", rb)
x = rng(11).standard_normal(2 * size).astype(np.float32)
rb = np.zeros(2, dtype=np.float32)
comm.Reduce_scatter(x, rb, [2] * size)
save("reduce_scatter_even", rb)
for root in (0, size - 1):
    x = rng(12).standard_normal(33).astype(np.float32)
    out = np.zeros_like(x)
    comm.Reduce(x, out, root=root)
    if rank == root:
        save(f"reduce_binomial_{root}", out)
    buf = x.copy()
    comm.Reduce(mpi.IN_PLACE if rank == root else x, buf, root=root)
    if rank == root:
        save(f"reduce_in_place_{root}", buf)
x = rng(13).standard_normal(17).astype(np.float32)
out = np.zeros_like(x)
comm.Scan(x, out)
save("scan_f32", out)
out = np.zeros_like(x)
comm.Exscan(x, out)
if rank > 0:
    save("exscan_f32", out)

# -- v-collectives with seeded counts --
counts = [int(c) for c in np.random.default_rng(5).integers(0, 6, size)]
displs = [int(sum(counts[:i])) for i in range(size)]
mine = rng(14).standard_normal(counts[rank]).astype(np.float32)
rb = np.zeros(sum(counts), dtype=np.float32)
comm.Allgatherv(mine, rb, counts)
save("allgatherv", rb)
rb = np.zeros(sum(counts), dtype=np.float32) if rank == 1 else None
comm.Gatherv(mine, rb, counts, root=1)
if rank == 1:
    save("gatherv", rb)
sv = (np.arange(sum(counts), dtype=np.float32) + 0.5) if rank == 0 else None
rv = np.zeros(counts[rank], dtype=np.float32)
comm.Scatterv(sv, rv, counts, root=0)
save("scatterv", rv)

# -- MINLOC / MAXLOC over every pair type --
for vname, vt in (("float_int", np.float32), ("double_int", np.float64),
                  ("long_int", np.int64), ("2int", np.int32),
                  ("short_int", np.int16)):
    dt = np.dtype([("val", vt), ("loc", np.int32)])
    a = np.zeros(6, dt)
    a["val"] = (rng(15).integers(0, 4, 6)).astype(vt)
    a["loc"] = rank
    for oname, op in (("minloc", O.MINLOC), ("maxloc", O.MAXLOC)):
        out = np.zeros(6, dt)
        comm.Allreduce(a, out, op=op)
        save(f"allreduce_{oname}_{vname}", out.view(np.uint8))
        out = np.zeros(6, dt)
        comm.Reduce(a, out, op=op, root=size - 1)
        if rank == size - 1:
            save(f"reduce_{oname}_{vname}", out.view(np.uint8))

# -- a non-commutative op.create --
nc = O.create(lambda a, b: a * 2 + b, commute=False)
x = (rng(16).integers(-3, 4, 9)).astype(np.float64)
for algo in ("", "rabenseifner", "basic"):
    cvar.set("coll_tuned_allreduce_algorithm", algo)
    out = np.zeros_like(x)
    comm.Allreduce(x, out, op=nc)
    save(f"allreduce_noncommute_{algo or 'default'}", out)
cvar.set("coll_tuned_allreduce_algorithm", "")
out = np.zeros_like(x)
comm.Reduce(x, out, op=nc, root=1)
if rank == 1:
    save("reduce_noncommute", out)
out = np.zeros_like(x)
comm.Scan(x, out, op=nc)
save("scan_noncommute", out)

# -- Reduce_local --
a = rng(17).standard_normal(5).astype(np.float32)
b = rng(18).standard_normal(5).astype(np.float32)
for oname, op in (("sum", O.SUM), ("noncommute", nc)):
    io = b.copy()
    if WHO == "ref":
        O.reduce_local(a, io, op)
    else:
        mpi.Reduce_local(a, io, op)
    save(f"reduce_local_{oname}", io)

# -- IN_PLACE where the reference has no IN_PLACE form: the port's
# IN_PLACE call against the reference's plain call --
x = rng(19).standard_normal(6).astype(np.float32)
out = x.copy()
if WHO == "ref":
    comm.Scan(x, out)
else:
    comm.Scan(mpi.IN_PLACE, out)
save("scan_in_place", out)
out = x.copy()
if WHO == "ref":
    comm.Exscan(x, out)
else:
    comm.Exscan(mpi.IN_PLACE, out)
if rank > 0:
    save("exscan_in_place", out)
rb = np.zeros(3 * size, dtype=np.float32)
rb[3 * rank:3 * rank + 3] = x[:3]
if WHO == "ref":
    comm.Allgather(x[:3].copy(), rb)
else:
    comm.Allgather(mpi.IN_PLACE, rb)
save("allgather_in_place", rb)
rb = np.zeros(sum(counts), dtype=np.float32)
rb[displs[rank]:displs[rank] + counts[rank]] = mine
if WHO == "ref":
    comm.Allgatherv(mine, rb, counts)
else:
    comm.Allgatherv(mpi.IN_PLACE, rb, counts)
save("allgatherv_in_place", rb)

# -- tests/test_nbc.py --
req = comm.Ibarrier()
acc = float(np.arange(1000).sum())
req.wait()
data = np.full(64, rank + 1, dtype=np.float64)
out = np.zeros_like(data)
r1 = comm.Iallreduce(data, out)
buf = (np.arange(32, dtype=np.int32) if rank == 0
       else np.zeros(32, dtype=np.int32))
r2 = comm.Ibcast(buf, root=0)
mpi.wait_all([r1, r2])
save("iallreduce", out)
save("ibcast", buf)
sb = np.full(2, rank, dtype=np.int64)
rb = np.zeros(2 * size, dtype=np.int64) if rank == 0 else None
comm.Igather(sb, rb, root=0).wait()
if rank == 0:
    save("igather", rb)
sv = np.arange(2 * size, dtype=np.int64) * 3 if rank == size - 1 else None
rv = np.zeros(2, dtype=np.int64)
comm.Iscatter(sv, rv, root=size - 1).wait()
save("iscatter", rv)
a2a_r = np.zeros(size, dtype=np.int32)
comm.Ialltoall(np.arange(size, dtype=np.int32) + rank * 10, a2a_r).wait()
save("ialltoall", a2a_r)
rb = np.zeros(3 * size, dtype=np.float32)
comm.Iallgather(rng(20).standard_normal(3).astype(np.float32), rb).wait()
save("iallgather", rb)
reqs, outs = [], []
for k in range(4):
    x = rng(21 + k).standard_normal(16)
    outs.append(np.zeros_like(x))
    reqs.append(comm.Iallreduce(x, outs[-1]))
mpi.wait_all(reqs)
for k, o in enumerate(outs):
    save(f"iallreduce_outstanding_{k}", o)
buf = rng(25).standard_normal(7).astype(np.float32)
comm.Iallreduce(mpi.IN_PLACE, buf).wait()
save("iallreduce_in_place", buf)
x = rng(26).standard_normal(11).astype(np.float32)
out = np.zeros_like(x) if rank == 2 % size else None
comm.Ireduce(x, out, root=2 % size).wait()
if rank == 2 % size:
    save("ireduce", out)

# -- tests/test_nbc_extended.py --
vc = [r + 1 for r in range(size)]
total = sum(vc)
mine = np.full(rank + 1, rank, dtype=np.float64)
out = np.zeros(total)
comm.Iallgatherv(mine, out, vc).wait()
save("iallgatherv", out)
rbuf = np.zeros((rank + 1) * size)
sbuf = np.concatenate([np.full(c, rank, dtype=np.float64) for c in vc])
comm.Ialltoallv(sbuf, rbuf, vc, [rank + 1] * size).wait()
save("ialltoallv", rbuf)
gout = np.zeros(total) if rank == 1 else None
comm.Igatherv(mine, gout, vc, root=1).wait()
if rank == 1:
    save("igatherv", gout)
sv = np.concatenate([np.full(r + 1, 7.0 + r) for r in range(size)]) \\
    if rank == 0 else None
rv = np.zeros(rank + 1)
comm.Iscatterv(sv, rv, vc, root=0).wait()
save("iscatterv", rv)
data = rng(27).standard_normal(4).astype(np.float32)
out = np.zeros(4, dtype=np.float32)
comm.Iscan(data, out).wait()
save("iscan", out)
oute = np.zeros(4, dtype=np.float32)
comm.Iexscan(data, oute).wait()
if rank > 0:
    save("iexscan", oute)
buf = data.copy()
comm.Iscan(mpi.IN_PLACE, buf).wait()
save("iscan_in_place", buf)
buf = data.copy()
comm.Iexscan(mpi.IN_PLACE, buf).wait()
if rank > 0:
    save("iexscan_in_place", buf)
sb = rng(28).standard_normal(4 * size).astype(np.float32)
rb = np.zeros(4, dtype=np.float32)
comm.Ireduce_scatter_block(sb, rb).wait()
save("ireduce_scatter_block", rb)
sbv = rng(29).standard_normal(total).astype(np.float32)
rbv = np.zeros(rank + 1, dtype=np.float32)
comm.Ireduce_scatter(sbv, rbv, vc).wait()
save("ireduce_scatter", rbv)

# -- every *_init form, started three times on refilled buffers --
send = np.zeros(4)
out = np.zeros(4)
reqs = {"allreduce": comm.Allreduce_init(send, out)}
bbuf = np.zeros(8, dtype=np.int64)
reqs["bcast"] = comm.Bcast_init(bbuf, root=0)
rsend = np.zeros(5, dtype=np.float32)
rout = np.zeros(5, dtype=np.float32)
reqs["reduce"] = comm.Reduce_init(rsend, rout, root=size - 1)
gsend = np.zeros(2, dtype=np.int32)
gout = np.zeros(2 * size, dtype=np.int32)
reqs["gather"] = comm.Gather_init(gsend, gout, root=1)
ssend = np.zeros(3 * size, dtype=np.float32)
sout = np.zeros(3, dtype=np.float32)
reqs["scatter"] = comm.Scatter_init(ssend, sout, root=0)
agsend = np.zeros(2)
agout = np.zeros(2 * size)
reqs["allgather"] = comm.Allgather_init(agsend, agout)
a2send = np.zeros(size, dtype=np.int32)
a2out = np.zeros(size, dtype=np.int32)
reqs["alltoall"] = comm.Alltoall_init(a2send, a2out)
rsbsend = np.zeros(2 * size, dtype=np.float32)
rsbout = np.zeros(2, dtype=np.float32)
reqs["reduce_scatter_block"] = comm.Reduce_scatter_block_init(rsbsend,
                                                             rsbout)
reqs["barrier"] = comm.Barrier_init()
for it in range(3):
    g = rng(40 + it)
    send[:] = g.standard_normal(4)
    if rank == 0:
        bbuf[:] = np.arange(8) * (it + 1)
    rsend[:] = g.standard_normal(5)
    gsend[:] = rank * 10 + it
    ssend[:] = np.arange(3 * size) + it
    agsend[:] = g.standard_normal(2)
    a2send[:] = np.arange(size) + 100 * rank + it
    rsbsend[:] = g.standard_normal(2 * size)
    mpi.start_all(list(reqs.values()))
    mpi.wait_all(list(reqs.values()))
    for name, arr in (("allreduce", out), ("bcast", bbuf),
                      ("allgather", agout), ("alltoall", a2out),
                      ("scatter", sout), ("reduce_scatter_block", rsbout)):
        save(f"init_{name}_{it}", arr)
    if rank == size - 1:
        save(f"init_reduce_{it}", rout)
    if rank == 1:
        save(f"init_gather_{it}", gout)

# -- coll/adapt: segmented ibcast / ireduce on a dup selected with it --
cvar.set("coll_adapt_priority", 25)
cvar.set("coll_adapt_max_inflight", 3)
cvar.set("coll_adapt_segment_bytes", 4096)
ad = comm.dup()
cvar.set("coll_adapt_priority", -1)
res["adapt_provider"] = ad.coll.providers["ibcast"]
n = 10_000
buf = (np.arange(n, dtype=np.float64) if rank == 1
       else np.zeros(n, dtype=np.float64))
ad.Ibcast(buf, root=1).wait()
save("adapt_ibcast", buf)
x = rng(30).standard_normal(n)
out = np.zeros(n) if rank == 0 else None
ad.Ireduce(x, out, root=0).wait()
if rank == 0:
    save("adapt_ireduce", out)
big = (np.arange(8000, dtype=np.float64) if rank == 1
       else np.zeros(8000, dtype=np.float64))
ad.Ibcast((big, 4000), root=1).wait()
save("adapt_ibcast_count", big)
ba = bytearray(b"ADAPT-DELEGATION" if rank == 0 else 16)
ad.Ibcast((ba, 16), root=0).wait()
res["adapt_bytearray"] = bytes(ba).decode()
cvar.set("coll_adapt_segment_bytes", 1 << 16)
cvar.set("coll_adapt_max_inflight", 32)

# -- tests/test_han_sync.py::test_sync_injects_barriers --
cvar.set("coll_sync_barrier_before", 2)
sc = comm.dup()
before = pvar.read("sync_injected_barriers")
data = np.ones(4, dtype=np.float32)
out = np.zeros_like(data)
for _ in range(6):
    sc.Allreduce(data, out)
res["sync_injected"] = pvar.read("sync_injected_barriers") - before
res["sync_provider"] = sc.coll.providers["allreduce"].startswith("sync(")
cvar.set("coll_sync_barrier_before", 0)
save("sync_allreduce", out)
"""

_PORT_PRELUDE = """
import numpy as np
from ompi_tpu_torch import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size
"""

_PORT_EPILOGUE = """
mpi.Finalize()
"""


def _job(tmp, n):
    """Run the body in both packages on n ranks; returns the results
    directory."""
    head = dict(out=str(tmp))
    run_ranks(_HEAD.format(pkg="ompi_tpu", who="ref", **head)
              + _BODY + _TAIL, n, timeout=300, isolate=True)
    src = (_PORT_PRELUDE + _HEAD.format(pkg="ompi_tpu_torch", who="port",
                                        **head) + _BODY + _TAIL
           + _PORT_EPILOGUE)
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        rc = port_launcher.launch(
            [sys.executable, path], n,
            mca=dict(compat.mca_from_reference({}),
                     device_plane_platform="cpu"), timeout=300)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job on {n} ranks exited {rc}"
    return tmp


_jobs = {}


@pytest.fixture(params=[3, 4], scope="module")
def job(request, tmp_path_factory):
    """Both packages' jobs, once per n: (n, results directory)."""
    n = request.param
    if n not in _jobs:
        _jobs[n] = (n, _job(tmp_path_factory.mktemp(f"host{n}"), n))
    return _jobs[n]


def _check(job, prefixes):
    """Every ref_<prefix>*.npy of the job equals the port's bitwise
    (uint8 views); returns how many were compared."""
    n, d = job
    seen = 0
    for f in sorted(os.listdir(d)):
        if not (f.startswith("ref_") and f.endswith(".npy")):
            continue
        name = f[4:]
        if not name.startswith(prefixes):
            continue
        got = d / ("port_" + name)
        assert got.exists(), f"the port wrote no {name}"
        ref, port = np.load(d / f), np.load(got)
        assert ref.dtype == port.dtype and ref.shape == port.shape, \
            (name, ref.dtype, port.dtype, ref.shape, port.shape)
        np.testing.assert_array_equal(ref.reshape(-1).view(np.uint8),
                                      port.reshape(-1).view(np.uint8),
                                      err_msg=name)
        seen += 1
    assert seen, prefixes
    return seen


def _res(job):
    n, d = job
    out = []
    for r in range(n):
        ref = json.loads((d / f"ref_res_r{r}.json").read_text())
        port = json.loads((d / f"port_res_r{r}.json").read_text())
        assert ref == port, (r, ref, port)
        out.append(port)
    return out


def test_coll_cases(job):
    """``tests/test_coll.py``: Bcast, Allreduce SUM / MIN / MAX, the
    rank-order Reduce (equal across repeats), Gather / Scatter,
    Allgather, Alltoall(v), Reduce_scatter_block, Scan / Exscan, a split
    comm's Allreduce and IN_PLACE Allreduce, bitwise; the object bcast
    and allgather equal."""
    _check(job, ("bcast_r", "allreduce_sum", "allreduce_min",
                 "allreduce_max", "reduce_rank_order", "gather_r",
                 "scatter_r", "allgather_r", "alltoall_r", "alltoallv",
                 "reduce_scatter_block_r", "scan_r", "exscan_r",
                 "split_allreduce", "in_place_allreduce"))
    n, d = job
    for r in range(n):
        rounds = [np.load(d / f"port_reduce_rank_order_{i}_r0.npy")
                  for i in range(3)]
        assert all(np.array_equal(rounds[0], x) for x in rounds)
    res = _res(job)
    assert res[0]["bcast_obj"] == {"cfg": 1}
    assert res[1]["allgather_obj"] == [["r", r] for r in range(n)]


@pytest.mark.parametrize("algo", ["recursivedoubling", "ring",
                                  "rabenseifner", "basic", "default"])
def test_allreduce_algorithms(job, algo):
    """Each forced Allreduce algorithm (and the default decision) at 1, 5,
    1000 and 4096 seeded float32 elements, in place over float64, and
    int32 MAX: bitwise the reference's (each keeps its fold order and
    non-power-of-two folding)."""
    _check(job, (f"allreduce_{algo}_", f"allreduce_in_place_{algo}_"))


def test_allreduce_default_past_the_ring_switchpoint(job):
    """coll_tuned_allreduce_ring_min lowered to 4 KiB: the default
    decision takes the ring, bitwise the reference's."""
    _check(job, ("allreduce_default_past_ring_min",))


@pytest.mark.parametrize("coll", ["bcast", "allgather", "alltoall"])
def test_forced_algorithms(job, coll):
    """Bcast (binomial, pipeline at a 4 KiB segment, linear), Allgather
    (ring, Bruck, recursive doubling, gather + bcast) and Alltoall
    (pairwise, Bruck, all at once) forced through cvar.set, and the
    default decisions: bitwise. The barriers run between them."""
    names = {"bcast": ("binomial", "pipeline", "linear", "default"),
             "allgather": ("ring", "bruck", "recursivedoubling", "basic",
                           "default"),
             "alltoall": ("pairwise", "bruck", "basic", "default")}[coll]
    assert _check(job, tuple(f"{coll}_{a}_" for a in names)) \
        >= len(names) * job[0]


def test_reduce_scatter_and_rooted_algorithms(job):
    """The ring Reduce_scatter_block, Reduce_scatter with uneven counts
    (coll/basic's reduce + scatterv) and even counts (recursive halving
    on a power of two), the binomial Reduce to roots 0 and n-1 (and in
    place), float32 Scan / Exscan: bitwise."""
    _check(job, ("reduce_scatter_block_ring", "reduce_scatter_uneven",
                 "reduce_scatter_even", "reduce_binomial",
                 "reduce_in_place", "scan_f32", "exscan_f32"))


def test_v_collectives(job):
    """Allgatherv, Gatherv and Scatterv with seeded counts (zero counts
    among them): bitwise."""
    _check(job, ("allgatherv_r", "gatherv", "scatterv"))


def test_minloc_maxloc_every_pair_type(job):
    """MINLOC / MAXLOC Allreduce and Reduce over FLOAT_INT, DOUBLE_INT,
    LONG_INT, TWOINT and SHORT_INT records: bitwise (ties go to the lower
    loc)."""
    assert _check(job, ("allreduce_minloc", "allreduce_maxloc",
                        "reduce_minloc", "reduce_maxloc")) >= 10 * job[0]


def test_noncommutative_user_op(job):
    """A non-commutative ``op.create`` through Allreduce (the default
    decision, Rabenseifner and coll/basic's fold), Reduce (the linear
    fold) and Scan: bitwise, operand order included."""
    _check(job, ("allreduce_noncommute", "reduce_noncommute",
                 "scan_noncommute"))


def test_reduce_local_and_in_place(job):
    """``Reduce_local`` (SUM and the non-commutative op: inbuf is the left
    operand) against the reference's ``op.reduce_local``; IN_PLACE Scan,
    Exscan, Allgather and Allgatherv against the reference's plain
    calls."""
    _check(job, ("reduce_local", "scan_in_place", "exscan_in_place",
                 "allgather_in_place", "allgatherv_in_place"))


def test_nonblocking(job):
    """``tests/test_nbc.py`` and ``test_nbc_extended.py``: Ibarrier,
    Iallreduce beside Ibcast, Igather, Iscatter, Ialltoall, Iallgather,
    four Iallreduces in flight, IN_PLACE Iallreduce / Iscan / Iexscan,
    Ireduce, the i-vector forms, Iscan / Iexscan and
    Ireduce_scatter(_block): bitwise."""
    _check(job, ("iallreduce", "ibcast", "igather", "iscatter",
                 "ialltoall", "iallgather", "ireduce", "iscan",
                 "iexscan"))


def test_persistent_forms_restart(job):
    """Every ``*_init`` form (Allreduce, Bcast, Reduce, Gather, Scatter,
    Allgather, Alltoall, Reduce_scatter_block, Barrier) started three
    times through start_all on refilled buffers: each cycle bitwise the
    reference's."""
    assert _check(job, ("init_",)) >= 3 * 6 * job[0]


def test_adapt_segmented(job):
    """coll/adapt on a dup taken with ``coll_adapt_priority`` 25: it
    serves ibcast; the segmented Ibcast (whole, and of a count below the
    buffer's size) and Ireduce equal the reference's; a bytearray goes to
    libnbc and still lands in the caller's memory."""
    _check(job, ("adapt_",))
    res = _res(job)
    assert all(r["adapt_provider"] == "adapt" for r in res)
    assert all(r["adapt_bytearray"] == "ADAPT-DELEGATION" for r in res)


def test_sync_injects_barriers(job):
    """coll/sync on a dup taken with ``coll_sync_barrier_before`` 2 wraps
    the host slots and injects a barrier every second call: the same
    count as the reference's."""
    _check(job, ("sync_allreduce",))
    res = _res(job)
    assert all(r["sync_provider"] and r["sync_injected"] == 3 for r in res)


# -- tests/test_nbc.py's schedule-error cases, in process ------------------

def test_nbc_schedule_error_surfaces_at_own_wait():
    """An error raised inside a progressed schedule completes THAT request
    with it, raised at its own wait, not in whatever call was spinning
    the progress engine."""
    from ompi_tpu_torch import errors
    from ompi_tpu_torch.coll.libnbc import NbcRequest
    from ompi_tpu_torch.core import progress
    from ompi_tpu_torch.pml import request as rq

    gate = rq.Request()

    def bad_sched():
        yield [gate]
        raise errors.MPIError(errors.ERR_OTHER, "disk on fire")

    req = NbcRequest(bad_sched())
    assert not req.completed
    gate.complete()
    progress.progress()
    assert req.completed and req.status.error == errors.ERR_OTHER
    with pytest.raises(errors.MPIError, match="disk on fire"):
        req.wait()


def test_nbc_schedule_reentrant_progress_safe():
    """A schedule body that spins the progress engine does not resume its
    own executing generator."""
    from ompi_tpu_torch.coll.libnbc import NbcRequest
    from ompi_tpu_torch.core import progress
    from ompi_tpu_torch.pml import request as rq

    gate = rq.Request()
    seen = []

    def sched():
        yield [gate]
        progress.progress()
        seen.append("resumed-once")
        yield []

    req = NbcRequest(sched())
    gate.complete()
    progress.progress()
    assert req.completed and req.status.error == 0
    assert seen == ["resumed-once"]


def test_nbc_prologue_error_raises_at_call_site():
    """An argument error in a schedule's prologue raises at the call."""
    from ompi_tpu_torch.coll.libnbc import NbcRequest

    def bad_prologue():
        raise ValueError("bad recvbuf shape")
        yield []  # pragma: no cover

    with pytest.raises(ValueError, match="bad recvbuf shape"):
        NbcRequest(bad_prologue())


def test_persistent_start_while_active_raises():
    """A persistent collective started again before its cycle completed
    raises ERR_REQUEST."""
    from ompi_tpu_torch import errors
    from ompi_tpu_torch.coll.libnbc import PersistentCollRequest
    from ompi_tpu_torch.pml import request as rq

    gate = rq.Request()

    def sched():
        yield [gate]

    req = PersistentCollRequest(sched)
    req.start()
    with pytest.raises(errors.MPIError) as e:
        req.start()
    assert e.value.error_class == errors.ERR_REQUEST
    gate.complete()
    req.wait()
    assert req.completed


def test_minloc_records_in_process():
    """MINLOC / MAXLOC fold (val, loc) records as the reference's op does
    (ties to the lower loc), and each pair type maps from its numpy
    dtype."""
    from ompi_tpu import op as ref_op
    from ompi_tpu_torch import datatype, op as O

    for dt in datatype.PAIR_TYPES:
        assert datatype.from_numpy_dtype(dt.base) is dt
        a = np.zeros(5, dt.base)
        b = np.zeros(5, dt.base)
        a["val"] = [1, 2, 3, 2, 0]
        b["val"] = [1, 1, 3, 5, 0]
        a["loc"] = [4, 0, 2, 1, 9]
        b["loc"] = [3, 1, 5, 0, 2]
        for mine, ref in ((O.MINLOC, ref_op.MINLOC),
                          (O.MAXLOC, ref_op.MAXLOC)):
            np.testing.assert_array_equal(
                mine(a, b).view(np.uint8), ref.np_fn(a, b).view(np.uint8))
