"""The port's host point-to-point (ob1 over btl/self, sm and tcp, smsc/cma
single copy) against the JAX package's.

Every case of ``tests/test_p2p.py`` (bind-to-core aside; its derived
datatype cases run in ``tests/test_torch_datatype_p2p.py``),
``tests/test_rndv_pipeline.py`` and ``tests/test_smsc.py`` runs in one
rank body that both packages execute: the reference through
``tests.harness.run_ranks`` (isolated, so no pooled process carries its
pvars or a disqualified cma into another test), the port through its
launcher with the same settings mapped by ``compat.mca_from_reference``
plus ``device_plane_platform cpu``. Both make the same numpy inputs and
write every received payload as ``.npy`` and every Status as (source,
tag, count, error); the test compares payloads bitwise through a uint8
view and statuses exactly, wildcard receives as the set of (source, tag,
payload). Jobs: 2 ranks under the default transport (self + sm + cma),
2 ranks with ``smsc off`` (the streaming protocol at depth 1 and at the
default depth), 2 ranks with ``btl self,tcp`` (every case of
``test_tcp_only_transport``, and the pipelined stream over tcp), 3 ranks
(ANY_SOURCE / ANY_TAG) and 4 ranks (the ring of BASELINE config #1 and
the object collectives); and ``examples/ring.py`` / ``hello.py`` of both
packages under their launchers, stdout against stdout. One in-process
test holds ob1's unexpected queue to arrival order per receive pattern.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch import compat
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEAD = """
import json, threading, time
from {pkg} import errors
from {pkg}.core import cvar, pvar
from {pkg}.pml import request as rq
OUT, WHO = {out!r}, {who!r}
res = {{}}

def save(name, arr):
    np.save(f"{{OUT}}/{{WHO}}_{{name}}_r{{rank}}.npy", np.asarray(arr))

def stat(name, st):
    res[name] = [st.source, st.tag, st.count, st.error]

def pv(name):
    return pvar.read(name)
"""

_TAIL = """
with open(f"{OUT}/{WHO}_res_r{rank}.json", "w") as fh:
    json.dump(res, fh, sort_keys=True, default=str)
"""

#: the 2-rank cases under the default transport (self + sm + cma)
_BODY2 = """
peer = 1 - rank
# test_p2p: object round trip
if rank == 0:
    comm.send({"k": [1, 2, 3]}, dest=1, tag=7)
    res["obj"] = comm.recv(source=1, tag=8)
else:
    res["obj"] = comm.recv(source=0, tag=7)
    comm.send("reply", dest=0, tag=8)
# test_p2p: rendezvous past the eager limit (RNDV + single copy)
n = 300_000
if rank == 0:
    comm.Send(np.arange(n, dtype=np.float32), dest=1, tag=1)
else:
    buf = np.zeros(n, dtype=np.float32)
    stat("rndv_large", comm.Recv(buf, source=0, tag=1))
    save("rndv_large", buf)
# non-overtaking between one pair
if rank == 0:
    for i in range(50):
        comm.send(i, dest=1, tag=5)
else:
    res["order"] = [comm.recv(source=0, tag=5) for _ in range(50)]
# Isend / Irecv / Waitall
sends = [comm.Isend(np.full(8, rank * 10 + i, dtype=np.int64), dest=peer,
                    tag=i) for i in range(10)]
bufs = [np.zeros(8, dtype=np.int64) for _ in range(10)]
recvs = [comm.Irecv(bufs[i], source=peer, tag=i) for i in range(10)]
for i, st in enumerate(mpi.wait_all(recvs)):
    stat(f"waitall_{i}", st)
mpi.wait_all(sends)
save("waitall", np.stack(bufs))
# Ssend completes only once matched
if rank == 0:
    t0 = time.time()
    comm.Ssend(np.ones(4, dtype=np.int32), dest=1, tag=3)
    res["ssend_waited"] = time.time() - t0 > 0.2
else:
    time.sleep(0.3)
    buf = np.zeros(4, dtype=np.int32)
    stat("ssend", comm.Recv(buf, source=0, tag=3))
# Probe, then ERR_TRUNCATE for a 4-int message into 2 ints
if rank == 0:
    comm.Send(np.arange(10, dtype=np.float64), dest=1, tag=11)
    comm.Send(np.arange(4, dtype=np.int32), dest=1, tag=12)
else:
    stat("probe", comm.Probe(source=0, tag=11))
    buf = np.zeros(10, dtype=np.float64)
    comm.Recv(buf, source=0, tag=11)
    save("probe", buf)
    try:
        comm.Recv(np.zeros(2, dtype=np.int32), source=0, tag=12)
        res["truncate"] = None
    except errors.MPIError as e:
        res["truncate"] = e.error_class
# Sendrecv
rbuf = np.zeros(16, dtype=np.int32)
stat("sendrecv", comm.Sendrecv(np.full(16, rank, dtype=np.int32), dest=peer,
                               recvbuf=rbuf, source=peer, sendtag=0,
                               recvtag=0))
save("sendrecv", rbuf)
# persistent requests
sbuf = np.zeros(4, dtype=np.int32)
rbuf = np.zeros(4, dtype=np.int32)
sreq = comm.Send_init(sbuf, dest=peer, tag=2)
rreq = comm.Recv_init(rbuf, source=peer, tag=2)
seen = []
for it in range(5):
    sbuf[:] = rank * 100 + it
    mpi.start_all([rreq, sreq])
    rreq.wait(); sreq.wait()
    seen.append(rbuf.copy())
save("persistent", np.stack(seen))
# Mprobe / Mrecv
if rank == 0:
    comm.Send(np.arange(6, dtype=np.int32), dest=1, tag=44)
else:
    msg, st = comm.Mprobe(source=0, tag=44)
    stat("mprobe", st)
    buf = np.zeros(6, dtype=np.int32)
    stat("mrecv", comm.Mrecv(msg, buf))
    save("mrecv", buf)
# generalized requests, waited beside native ones
seen = {}
req = mpi.Grequest_start(query_fn=lambda st: setattr(st, "tag", 77),
                         free_fn=lambda: seen.__setitem__("freed", True))
first_test = req.test()
threading.Timer(0.05, req.complete).start()
st = req.wait(timeout=10)
req.free()
req2 = mpi.Grequest_start(cancel_fn=lambda d: seen.__setitem__("cancel", d))
req2.cancel()
grq = [first_test, st.tag, seen.get("freed"), seen.get("cancel"),
       req2.completed, req2.status.cancelled]
req2.complete()
grq.append(req2.test())
r3 = mpi.Grequest_start()
sreq = comm.Isend(np.ones(4, np.float32), dest=peer, tag=3)
rreq = comm.Irecv(np.zeros(4, np.float32), source=peer, tag=3)
threading.Timer(0.05, r3.complete).start()
rq.wait_all([sreq, rreq, r3], timeout=30)
res["grequest"] = grq
# Isendrecv / Isendrecv_replace
rb = np.zeros(8)
req = comm.Isendrecv(np.full(8, float(rank + 1), np.float64), peer, rb,
                     source=peer, sendtag=3, recvtag=3)
stat("isendrecv", req.wait(timeout=60))
save("isendrecv", rb)
buf = np.full(4, 100 + rank, np.int32)
mpi.wait_all([comm.Isendrecv_replace(buf, peer, source=peer, sendtag=4,
                                     recvtag=4)])
save("isendrecv_replace", buf)
buf = np.full(4, 200 + rank, np.int32)
stat("sendrecv_replace", comm.Sendrecv_replace(buf, peer, source=peer,
                                               sendtag=6, recvtag=6))
save("sendrecv_replace", buf)
# Bsend against an attached buffer's capacity
nb = 1 << 20  # above the eager limit: the bsend stays in flight
cap = nb + mpi.BSEND_OVERHEAD
if rank == 0:
    mpi.Buffer_attach(cap)
    try:
        mpi.Buffer_attach(64)
        res["double_attach"] = None
    except errors.MPIError as e:
        res["double_attach"] = e.error_class
    comm.Bsend(np.zeros(nb, np.uint8), dest=1, tag=1)
    try:
        comm.Bsend(np.zeros(4, np.uint8), dest=1, tag=2)
        res["over_capacity"] = None
    except errors.MPIError as e:
        res["over_capacity"] = e.error_class
    comm.Send(np.zeros(1, np.uint8), dest=1, tag=5)
    res["detached"] = mpi.Buffer_detach()
    comm.Bsend(np.arange(4, dtype=np.uint8), dest=1, tag=3)
else:
    comm.Recv(np.zeros(1, np.uint8), source=0, tag=5)
    big = np.ones(nb, np.uint8)
    stat("bsend_big", comm.Recv(big, source=0, tag=1))
    small = np.zeros(4, np.uint8)
    comm.Recv(small, source=0, tag=3)
    save("bsend_small", small)
    res["bsend_big_sum"] = int(big.sum())
comm.Barrier()
# test_rndv_pipeline: several large messages between one pair at once
k = 512 * 1024
if rank == 0:
    for r in [comm.Isend(np.full(k, i, np.int32), dest=1, tag=i)
              for i in range(4)]:
        r.wait()
else:
    bufs = [np.zeros(k, np.int32) for _ in range(4)]
    for i, r in enumerate([comm.Irecv(bufs[i], source=0, tag=i)
                           for i in range(4)]):
        stat(f"streams_{i}", r.wait())
    save("streams", np.stack(bufs))
# test_smsc: a contiguous 8 MB message is pulled with one copy
sc0, cp0 = pv("rndv_sc"), pv("smsc_single_copies")
m = 1 << 20
if rank == 0:
    comm.Send(np.arange(m, dtype=np.float64), dest=1, tag=1)
    res["sc_offered"] = pv("rndv_sc") - sc0 >= 1
else:
    buf = np.zeros(m, dtype=np.float64)
    comm.Recv(buf, source=0, tag=1)
    save("smsc_contig", buf)
    res["sc_copies"] = pv("smsc_single_copies") - cp0 >= 1
# large messages both ways, receives posted first
m = 200_000
bufs = [np.zeros(m, dtype=np.int64) for _ in range(4)]
reqs = [comm.Irecv(b, source=peer, tag=20 + i) for i, b in enumerate(bufs)]
for i in range(4):
    comm.Send(np.full(m, rank * 100 + i, dtype=np.int64), dest=peer,
              tag=20 + i)
for r in reqs:
    r.wait()
save("both_ways", np.stack(bufs))
# Pack / Unpack / Pack_size of predefined types
packed = bytearray(comm.Pack_size(5, np.dtype(np.float32)) + 8)
pos = comm.Pack(np.arange(5, dtype=np.float32) + rank, packed, 0)
pos = comm.Pack(np.array([rank, 7], np.int32), packed, pos)
out_f = np.zeros(5, np.float32)
out_i = np.zeros(2, np.int32)
back = comm.Unpack(packed, 0, out_f)
back = comm.Unpack(packed, back, out_i)
res["pack"] = [pos, back]
save("pack", np.frombuffer(bytes(packed), np.uint8))
# test_smsc: an offer the receiver declines at run time streams instead
from {pkg} import smsc
if rank == 1:
    smsc.disqualify("test: receiver-side denial")
comm.Barrier()
sc0, fr0, cp0 = pv("rndv_sc"), pv("rndv_frag"), pv("smsc_single_copies")
m = 1 << 19
if rank == 0:
    comm.Send(np.arange(m, dtype=np.float64), dest=1, tag=1)
    res["declined_offered"] = pv("rndv_sc") - sc0 >= 1
    res["declined_streamed"] = pv("rndv_frag") - fr0 > 1
else:
    buf = np.zeros(m, dtype=np.float64)
    comm.Recv(buf, source=0, tag=1)
    save("declined", buf)
    res["declined_copies"] = pv("smsc_single_copies") - cp0
"""

#: 2 ranks with smsc off: the streaming protocol (test_rndv_pipeline,
#: test_smsc's fallback)
_BODY2_STREAM = """
for name, depth, window, nbytes in (("depth1", 1, 1, 2 << 20),
                                    ("default", 4, 1 << 20, 8 << 20)):
    cvar.set("pml_ob1_send_pipeline_depth", depth)
    cvar.set("pml_ob1_send_window_bytes", window)
    fr0 = pv("rndv_frag")
    if rank == 0:
        comm.Send(np.arange(nbytes, dtype=np.uint8) % 251, dest=1, tag=5)
        res[name + "_fragmented"] = pv("rndv_frag") - fr0 > 1
    else:
        buf = np.zeros(nbytes, np.uint8)
        stat(name, comm.Recv(buf, source=0, tag=5))
        save(name, buf)
m = 1 << 19
sc0, rv0, cp0 = pv("rndv_sc"), pv("rndv"), pv("smsc_single_copies")
if rank == 0:
    comm.Send(np.arange(m, dtype=np.float64), dest=1, tag=3)
    res["off_counts"] = [pv("rndv_sc") - sc0, pv("rndv") - rv0 >= 1]
else:
    buf = np.zeros(m, dtype=np.float64)
    comm.Recv(buf, source=0, tag=3)
    save("off", buf)
    res["off_copies"] = pv("smsc_single_copies") - cp0
"""

#: 2 ranks over self + tcp (test_tcp_only_transport, the tcp pipeline)
_BODY2_TCP = """
peer = 1 - rank
data = np.arange(100_000, dtype=np.float32)
out = np.zeros_like(data)
stat("tcp_sendrecv", comm.Sendrecv(data, dest=peer, recvbuf=out,
                                   source=peer))
save("tcp_sendrecv", out)
fr0 = pv("rndv_frag")
nbytes = 4 << 20
if rank == 0:
    comm.Send(np.arange(nbytes, dtype=np.uint8) % 251, dest=1, tag=5)
    res["tcp_fragmented"] = pv("rndv_frag") - fr0 > 1
else:
    buf = np.zeros(nbytes, np.uint8)
    stat("tcp_stream", comm.Recv(buf, source=0, tag=5))
    save("tcp_stream", buf)
"""

#: 3 ranks: ANY_SOURCE / ANY_TAG, objects and buffers
_BODY3 = """
if rank == 0:
    got = []
    for _ in range(size - 1):
        st = mpi.Status()
        obj = comm.recv(source=mpi.ANY_SOURCE, tag=mpi.ANY_TAG, status=st)
        got.append([st.source, st.tag, obj])
    res["any_obj"] = sorted(got)
    comm.Barrier()  # the buffers follow every object
    got = []
    for _ in range(size - 1):
        buf = np.zeros(5, np.int32)
        st = comm.Recv(buf, source=mpi.ANY_SOURCE, tag=mpi.ANY_TAG)
        got.append([st.source, st.tag, st.count, buf.tolist()])
    res["any_buf"] = sorted(got)
else:
    comm.send(rank * 100 + rank, dest=0, tag=rank)
    comm.Barrier()
    comm.Send(np.full(5, 10 * rank, np.int32), dest=0, tag=30 + rank)
"""

#: 4 ranks: the ring of BASELINE config #1, and the object collectives
_BODY4 = """
nxt, prv = (rank + 1) % size, (rank - 1 + size) % size
msg = np.array([10], dtype=np.int32)
trace = []
if rank == 0:
    comm.Send(msg, dest=nxt, tag=201)
while True:
    comm.Recv(msg, source=prv, tag=201)
    if rank == 0:
        msg[0] -= 1
    trace.append(int(msg[0]))
    comm.Send(msg, dest=nxt, tag=201)
    if msg[0] == 0:
        break
if rank == 0:
    comm.Recv(msg, source=prv, tag=201)
res["ring"] = trace + [int(msg[0])]
res["bcast"] = comm.bcast({"root": rank} if rank == 2 else None, root=2)
res["gather"] = comm.gather(rank * rank, root=1)
res["scatter"] = comm.scatter([f"s{i}" for i in range(size)]
                              if rank == 3 else None, root=3)
res["allgather"] = comm.allgather((rank, "x" * rank))
res["alltoall"] = comm.alltoall([rank * 10 + d for d in range(size)])
res["allreduce"] = int(comm.allreduce(rank + 1, op=mpi.SUM))
res["allreduce_fn"] = comm.allreduce([rank], op=lambda a, b: a + b)
red = comm.reduce(rank + 1, op=mpi.MAX, root=0)
res["reduce"] = None if red is None else int(red)
comm.barrier()
comm.Barrier()
sends = [comm.Isend(np.full(3, rank, np.int16), dest=d, tag=9)
         for d in range(size) if d != rank]
bufs = {s: np.zeros(3, np.int16) for s in range(size) if s != rank}
recvs = [comm.Irecv(bufs[s], source=s, tag=9) for s in sorted(bufs)]
mpi.wait_all(recvs + sends)
save("all_pairs", np.stack([bufs[s] for s in sorted(bufs)]))
"""

#: the port's own refusals, checked inside its jobs
_PORT_CHECKS = """
import torch
from ompi_tpu_torch import datatype
def error_class(fn):
    try:
        fn()
    except errors.MPIError as e:
        return e.error_class, str(e)
    raise AssertionError("no MPIError raised")
# a tuple form on an entry outside the device tuple list still raises
cls, msg = error_class(lambda: comm.Ssend(
    (torch.ones(4), 1, datatype.vector(2, 1, 2, datatype.FLOAT)), dest=0))
assert cls == errors.ERR_NOT_SUPPORTED and "Iallreduce" in msg, msg
# a host-buffer Allreduce, once refused, fills its recvbuf through
# coll/tuned (its result is compared with the reference's: _LIFTED)
assert comm.Allreduce(np.ones(4, np.float32), np.zeros(4, np.float32)) \
    is None
cls, msg = error_class(lambda: comm.Gather((torch.ones(4), 2), None))
assert cls == errors.ERR_NOT_SUPPORTED, msg
assert isinstance(comm.Isend(np.ones(2), dest=mpi.PROC_NULL),
                  rq.Request)
st = comm.Recv(np.zeros(2), source=mpi.PROC_NULL)
assert st.source == mpi.PROC_NULL
from ompi_tpu_torch import pml as _pml
assert _pml.instance() is not None
"""

#: a call of the host collectives both packages run in every job, compared
#: bitwise like every other result
_LIFTED = """
lifted = np.zeros(4, np.float32)
comm.Allreduce(np.arange(4, dtype=np.float32) * (rank + 1), lifted)
save("host_allreduce", lifted)
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


def _job(tmp, body, n, ref_mca=None):
    """Run ``body`` in both packages on n ranks; returns the results
    directory."""
    ref_mca = dict(ref_mca or {})
    head = dict(out=str(tmp))
    run_ranks(_HEAD.format(pkg="ompi_tpu", who="ref", **head)
              + body.replace("{pkg}", "ompi_tpu") + _LIFTED + _TAIL, n,
              mca=ref_mca,
              timeout=240, isolate=True)
    port_mca = dict(compat.mca_from_reference(ref_mca),
                    device_plane_platform="cpu")
    src = (_PORT_PRELUDE + _HEAD.format(pkg="ompi_tpu_torch", who="port",
                                        **head)
           + body.replace("{pkg}", "ompi_tpu_torch") + _LIFTED
           + _PORT_CHECKS + _TAIL + _PORT_EPILOGUE)
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        rc = port_launcher.launch([sys.executable, path], n, mca=port_mca,
                                  timeout=240)
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


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = _job(tmp_path_factory.mktemp("p2p2"), _BODY2, 2)
    return _compare(d, 2)


def test_two_ranks_default_transport(two):
    """Eager, RNDV with cma single copy, non-overtaking, Waitall, Ssend,
    Probe and ERR_TRUNCATE, Sendrecv(_replace), Isendrecv, persistent,
    Mprobe / Mrecv, generalized requests, Bsend's capacity, concurrent
    streams, Pack / Unpack and a declined single-copy offer: bitwise and
    status-equal to the reference."""
    r0, r1 = two[0], two[1]
    assert r1["obj"] == {"k": [1, 2, 3]} and r0["obj"] == "reply"
    assert r1["order"] == list(range(50))
    assert r0["ssend_waited"] is True
    assert r1["truncate"] == 15  # ERR_TRUNCATE
    assert r1["probe"] == [0, 11, 80, 0]
    assert r0["grequest"] == [False, 77, True, False, False, True, True]
    assert r0["double_attach"] == r0["over_capacity"] == 1  # ERR_BUFFER
    assert r0["detached"] == (1 << 20) + 64
    assert r0["sc_offered"] and r1["sc_copies"]
    assert r0["declined_offered"] and r0["declined_streamed"]
    assert r1["declined_copies"] == 0


@pytest.fixture(scope="module")
def streaming(tmp_path_factory):
    d = _job(tmp_path_factory.mktemp("p2pstream"), _BODY2_STREAM, 2,
             {"smsc": "off"})
    return _compare(d, 2)


def test_two_ranks_streaming_protocol(streaming):
    """With cma off: FRAG / FRAG_ACK streaming at depth 1 (stop and
    wait) and at the default depth, and the rendezvous fallback."""
    r0, r1 = streaming[0], streaming[1]
    assert r0["depth1_fragmented"] and r0["default_fragmented"]
    assert r0["off_counts"] == [0, True] and r1["off_copies"] == 0


@pytest.fixture(scope="module")
def tcp(tmp_path_factory):
    d = _job(tmp_path_factory.mktemp("p2ptcp"), _BODY2_TCP, 2,
             {"btl": "self,tcp", "pml_ob1_send_pipeline_depth": "3",
              "pml_ob1_send_window_bytes": "1"})
    return _compare(d, 2)


def test_two_ranks_tcp(tcp):
    """``btl self,tcp``: the tcp-only Sendrecv and a pipelined 4 MiB
    stream."""
    assert tcp[0]["tcp_fragmented"]


def test_three_ranks_wildcards(tmp_path):
    """ANY_SOURCE / ANY_TAG receives of objects and buffers: the same
    set of (source, tag, payload) as the reference."""
    res = _compare(_job(tmp_path, _BODY3, 3), 3)
    assert res[0]["any_obj"] == [[1, 1, 101], [2, 2, 202]]
    assert [r[:2] for r in res[0]["any_buf"]] == [[1, 31], [2, 32]]


def test_four_ranks_ring_and_objects(tmp_path):
    """The ring's countdown on every rank and the object collectives
    (bcast, gather, scatter, allgather, alltoall, allreduce, reduce,
    barrier) equal to the reference's."""
    res = _compare(_job(tmp_path, _BODY4, 4), 4)
    assert res[0]["ring"] == list(range(9, -1, -1)) + [0]
    assert res[1]["gather"] == [0, 1, 4, 9]
    assert res[2]["allreduce"] == 10 and res[0]["reduce"] == 4


def _example(pkg: str, name: str) -> list:
    if pkg == "ompi_tpu":
        cmd = [sys.executable, "-m", "ompi_tpu.runtime.launcher", "-n", "4",
               os.path.join(ROOT, "examples", name)]
    else:
        cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
               "-n", "4", "--mca", "device_plane_platform", "cpu",
               os.path.join(ROOT, "ompi_tpu_torch", "examples", name)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    # block-buffered, each rank writes its few lines at exit in one
    # piece: unbuffered ranks sharing the pipe can split a line
    env.pop("PYTHONUNBUFFERED", None)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


@pytest.mark.parametrize("name", ["ring.py", "hello.py"])
def test_examples_print_what_the_reference_prints(name):
    """``examples/ring.py`` and ``hello.py`` on 4 ranks: the same lines
    (processor names aside; ranks interleave, so as multisets) and rank
    0's lines in the same order."""
    import re

    def norm(lines):
        return [re.sub(r" \(.*\)$", "", ln) for ln in lines]

    ref, port = norm(_example("ompi_tpu", name)), \
        norm(_example("ompi_tpu_torch", name))
    assert sorted(ref) == sorted(port), (ref, port)
    zero = [ln for ln in ref if "0" in ln.split()[:2] or "Process 0" in ln]
    assert zero == [ln for ln in port
                    if "0" in ln.split()[:2] or "Process 0" in ln]
    if name == "ring.py":
        assert len(ref) == 2 + 10 + 4


_ARRIVALS = [(2, -3), (1, 7), (2, 5), (1, 5), (1, 5), (0, 9), (3, 9), (2, -3)]


@pytest.mark.parametrize("want_src,want_tag", [
    (1, 5), ("any", 5), (1, "any"), ("any", "any"), (2, -3), ("any", -3),
    (3, 9), (4, 4)])
def test_unexpected_queue_yields_matches_in_arrival_order(want_src,
                                                          want_tag):
    """ob1's unexpected queue (a plain deque per context) gives a receive
    pattern its matching arrivals oldest first and leaves the others in
    order; ANY_TAG never matches an internal (negative) tag."""
    from ompi_tpu_torch.pml import ob1, request as rq

    want_src = rq.ANY_SOURCE if want_src == "any" else want_src
    want_tag = rq.ANY_TAG if want_tag == "any" else want_tag
    ob = ob1.Ob1()
    ctx = 6
    ob.unexpected[ctx] = ob1.deque(
        ob1._Unexpected((ob1.HDR_MATCH, ctx, src, tag, i, 0, 0, i), i, src)
        for i, (src, tag) in enumerate(_ARRIVALS))

    def matches(src, tag):
        return ((want_src == rq.ANY_SOURCE or want_src == src)
                and (tag == want_tag
                     or (want_tag == rq.ANY_TAG and tag >= 0)))

    want = [i for i, st in enumerate(_ARRIVALS) if matches(*st)]
    got = []
    while True:
        peek = ob._find_unexpected(ctx, want_src, want_tag, take=False)
        took = ob._find_unexpected(ctx, want_src, want_tag, take=True)
        assert peek is took
        if took is None:
            break
        got.append(took.payload)
    assert got == want
    assert [u.payload for u in ob.unexpected[ctx]] == [
        i for i in range(len(_ARRIVALS)) if i not in want]
