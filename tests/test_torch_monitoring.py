"""The port's monitoring plane (traffic matrices, link attribution, merge,
report, the pml interposition) against the JAX package's, the
counterparts of ``tests/test_monitoring.py``'s plane cases.

In this process: the byte models, the link map, ``world_rank``, the tag
constants, the level-0 guard (and an AST scan that every ``TRAFFIC`` site
of the port is one load and one branch), ``dims_create`` / ``CartTopo``,
and the merge / report / CLI on the same snapshots. Launcher jobs, one per
package and rank count, run the same programs:

- 2 ranks at ``monitoring_level 2`` (with ``pml_monitoring`` and a
  Finalize-time dump): the context pvars and the two-rank traffic plane;
- 3 and 4 ranks under the device plane with coll/cuda (coll/pallas in the
  reference), at level 1 (with ``pml_monitoring``, and the p2p matrix
  case) and level 2: each rank snapshots its matrices around a segment of
  coll/device slot calls (Allreduce float32 and bfloat16, Allgather,
  Alltoall, Alltoallv with max_count, Reduce_scatter_block, Bcast,
  Barrier, Scan) and one of coll/cuda's ('ring', 'bidir' and 'linear'
  Allreduce, Allgather, Reduce_scatter_block), each collective called
  once before the segment so no first-use round falls inside it.

The segments' cells (bytes and messages per peer and context), collective
records, link loads and the merged report's text equal the reference's.
"""

import ast
import json
import os
import sys
import tempfile
import textwrap

import pytest

from ompi_tpu_torch import compat, errors
from ompi_tpu_torch.monitoring import algo as P_algo
from ompi_tpu_torch.monitoring import links as P_links
from ompi_tpu_torch.monitoring import matrix as P_matrix
from ompi_tpu_torch.monitoring import merge as P_merge
from ompi_tpu_torch.monitoring import report as P_report
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: rank count -> the reference job's mca (the port's through compat)
JOBS = {
    2: {"monitoring_level": "2", "pml_monitoring": "1"},
    3: {"device_plane": "on", "coll_pallas": "on", "pml_monitoring": "1"},
    4: {"device_plane": "on", "coll_pallas": "on", "monitoring_level": "2"},
}

#: the 2-rank program (test_monitoring_context_pvars,
#: test_traffic_plane_two_ranks)
_PROG2 = '''
doc = {}
mon = pml_mon.installed()
doc["installed"] = mon is not None
tm = matrix.TRAFFIC
doc["level"] = tm.level
s = pvar.session()
nxt = (rank + 1) % size
prv = (rank - 1) % size
data = np.ones(128, dtype=np.float64)  # 1024 bytes
if rank % 2 == 0:
    comm.Send(data, dest=nxt, tag=5)
    comm.Recv(data, source=prv, tag=5)
else:
    comm.Recv(data, source=prv, tag=5)
    comm.Send(data, dest=nxt, tag=5)
doc["ctx1"] = [s.read("monitoring_p2p_msgs"), s.read("monitoring_p2p_bytes"),
               s.read("monitoring_coll_msgs")]
out = np.zeros(4)
comm.Allreduce(np.ones(4), out)
doc["ctx2"] = [s.read("monitoring_p2p_msgs"), s.read("monitoring_coll_msgs"),
               s.read("monitoring_msgs")]
s = pvar.session()
peer = 1 - rank
data = np.ones(256, dtype=np.float64)  # 2048 bytes
if rank == 0:
    comm.Send(data, dest=peer, tag=9)
    comm.Recv(data, source=peer, tag=9)
else:
    comm.Recv(data, source=peer, tag=9)
    comm.Send(data, dest=peer, tag=9)
doc["p2p_bytes"] = s.read("monitoring_p2p_bytes")
sreq = comm.Psend_init(data, 4, peer, tag=3)
rreq = comm.Precv_init(np.empty_like(data), 4, peer, tag=3)
sreq.start(); rreq.start()
for i in range(4):
    sreq.Pready(i)
rq.wait_all([sreq, rreq])
doc["part"] = [s.read("monitoring_part_bytes"),
               s.read("monitoring_p2p_bytes")]
snap = merge.snapshot_doc(tm)
docs = comm.allgather(snap)
merged = merge.merge(docs)
doc["skew"] = merged["transpose_skew"]
doc["tx"] = merged["tx_bytes"]
doc["links"] = merged["links"]
doc["tables"] = {c: {dst: cell[:2] for dst, cell in t.items()}
                 for c, t in snap["tables"].items() if c != "coll"}
doc["link_bytes"] = snap["link_bytes"]
doc["report"] = report.render(
    merge.merge([dict(d, tables={c: t for c, t in d["tables"].items()
                                 if c != "coll"}) for d in docs]))
path = monitoring.finalize_dump()
doc["dump"] = [os.path.exists(path), json.load(open(path))["schema"],
               json.load(open(path))["rank"]]
with open(f"{out_dir}/doc_r{rank}.json", "w") as fh:
    json.dump(doc, fh)
'''

#: the 3- and 4-rank program (test_pml_monitoring_traffic_matrix on 3,
#: and the device collectives' records on both)
_PROG34 = '''
doc = {}


def seg(a, b):
    """b - a: the cells (msgs, bytes), records and link loads added."""
    out = {"tables": {}, "coll_records": [], "link_bytes": {}}
    for ctx, t in b["tables"].items():
        ta = a["tables"].get(ctx, {})
        for dst, cell in t.items():
            c0 = ta.get(dst, [0, 0.0, 0])
            d = [cell[0] - c0[0], cell[1] - c0[1]]
            if d != [0, 0.0]:
                out["tables"].setdefault(ctx, {})[dst] = d + [0]
    ra = {(r["op"], r["bucket"], r["dtype"], tuple(r["mesh"])): r
          for r in a["coll_records"]}
    for r in b["coll_records"]:
        r0 = ra.get((r["op"], r["bucket"], r["dtype"], tuple(r["mesh"])))
        n_ = r["launches"] - (r0["launches"] if r0 else 0)
        if n_:
            out["coll_records"].append(dict(
                r, launches=n_, bytes=r["bytes"] - (r0["bytes"] if r0
                                                    else 0.0)))
    for k, v in b["link_bytes"].items():
        d = v - a["link_bytes"].get(k, 0.0)
        if d:
            out["link_bytes"][k] = d
    return dict(b, **out)


tm = matrix.TRAFFIC
if size == 3:  # test_pml_monitoring_traffic_matrix
    nxt = (rank + 1) % size
    data = np.ones(256, dtype=np.float64)  # 2048 bytes
    for _ in range(3):
        if rank % 2 == 0:
            comm.Send(data, dest=nxt, tag=1)
            comm.Recv(data, source=(rank - 1) % size, tag=1)
        else:
            comm.Recv(data, source=(rank - 1) % size, tag=1)
            comm.Send(data, dest=nxt, tag=1)
    m = pml_mon.matrix()
    doc["p2p"] = [m[nxt][0], m[nxt][1]]
    out = np.zeros(4)
    comm.Allreduce(np.ones(4), out)
    coll = pml_mon.matrix(collective=True)
    doc["coll_msgs"] = sum(c[0] for c in coll.values())
    doc["p2p_after"] = pml_mon.matrix()[nxt][0]
    pml_mon.dump()
doc["installed"] = pml_mon.installed() is not None
rng = np.random.default_rng(7)
x = rng.standard_normal(6 * size).astype(np.float32) + rank
xb = rng.standard_normal(4 * size).astype(np.float32)
y = rng.standard_normal((5, 3)).astype(np.float32) + rank
z = rng.standard_normal((size * 2, 3)).astype(np.float32) + rank
scounts = [(rank + p) % 3 for p in range(size)]
rcounts = [(p + rank) % 3 for p in range(size)]
v = rng.standard_normal((sum(scounts), 4)).astype(np.float32)


def device_segment():
    FLAT.allreduce_dev(comm, mk(x))
    FLAT.allreduce_dev(comm, mk(xb, "bfloat16"))
    FLAT.allgather_dev(comm, mk(y))
    FLAT.alltoall_dev(comm, mk(z))
    FLAT.alltoallv_dev(comm, mk(v), scounts, rcounts, max_count=2)
    FLAT.reduce_scatter_block_dev(comm, mk(z[:size * 2]))
    FLAT.bcast_dev(comm, mk(y), root=1)
    FLAT.barrier_dev(comm)
    FLAT.scan_dev(comm, mk(x))


def cuda_segment():
    for algo in ("", "bidir", "linear"):
        cvar.set(PFX + "_allreduce_algorithm", algo)
        comm.coll.allreduce_dev(comm, mk(x))
    cvar.set(PFX + "_allreduce_algorithm", "")
    comm.coll.allgather_dev(comm, mk(y))
    comm.coll.reduce_scatter_block_dev(comm, mk(z))


device_segment()
cuda_segment()
a = merge.snapshot_doc(tm)
device_segment()
b = merge.snapshot_doc(tm)
cuda_segment()
c = merge.snapshot_doc(tm)
doc["device"] = seg(a, b)
doc["cuda"] = seg(b, c)
docs = comm.allgather([doc["device"], doc["cuda"]])
doc["report_device"] = report.render(merge.merge([d[0] for d in docs]))
doc["report_cuda"] = report.render(merge.merge([d[1] for d in docs]))
with open(f"{out_dir}/doc_r{rank}.json", "w") as fh:
    json.dump(doc, fh)
'''

_REF_PRELUDE = '''
import json, os
import jax.numpy as jnp
import ompi_tpu.monitoring as monitoring
from ompi_tpu.coll import xla as FLAT
from ompi_tpu.core import cvar, pvar
from ompi_tpu.monitoring import matrix, merge, report
from ompi_tpu.pml import monitoring as pml_mon
from ompi_tpu.pml import request as rq
out_dir = {out_dir!r}
PFX = "coll_pallas"


def mk(a, dt="float32"):
    return jnp.asarray(a).astype(dt)
'''

_PORT_PRELUDE = '''
import json, os
import numpy as np
import torch
import ompi_tpu_torch.monitoring as monitoring
from ompi_tpu_torch import mpi
from ompi_tpu_torch.coll import device as FLAT
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.monitoring import matrix, merge, report
from ompi_tpu_torch.pml import monitoring as pml_mon
from ompi_tpu_torch.pml import request as rq
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
PFX = "coll_cuda"


def mk(a, dt="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dt))
'''


def _mca(n, out):
    return dict(JOBS[n], monitoring_dump=os.path.join(out, "mon_{rank}.json"))


def _port_job(n: int, out: str) -> None:
    prog = _PROG2 if n == 2 else _PROG34
    src = textwrap.dedent(_PORT_PRELUDE).format(out_dir=out) + prog \
        + "\nmpi.Finalize()\n"
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    mca = dict(compat.mca_from_reference(_mca(n, out)),
               device_plane_platform="cpu")
    try:
        rc = port_launcher.launch([sys.executable, path], n, mca=mca,
                                  timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job on {n} ranks exited {rc}"


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{n: (reference dir, port dir)}, every job run once."""
    out = {}
    for n in JOBS:
        ref = tmp_path_factory.mktemp(f"mon_ref{n}")
        port = tmp_path_factory.mktemp(f"mon_port{n}")
        prog = _PROG2 if n == 2 else _PROG34
        run_ranks(textwrap.dedent(_REF_PRELUDE).format(out_dir=str(ref))
                  + prog, n, mca=_mca(n, str(ref)), timeout=300,
                  isolate=True)
        _port_job(n, str(port))
        out[n] = (ref, port)
    return out


def _doc(d, r):
    return json.loads((d / f"doc_r{r}.json").read_text())


# ---------------------------------------------------------------------------
# in process


def test_algo_per_peer_models():
    """The reference test's cases, then every op of the models over
    ranks, sizes and roots against the reference's own."""
    from ompi_tpu.monitoring import algo as R_algo

    n, B = 4, 4096.0
    assert P_algo.per_peer("reduce_scatter", 1, n, B) == {2: (n - 1) / n * B}
    assert P_algo.per_peer("allgather", 3, n, B) == {0: (n - 1) / n * B}
    assert P_algo.per_peer("allreduce", 0, n, B) == {1: 2 * (n - 1) / n * B}
    a2a = P_algo.per_peer("alltoall", 1, n, B)
    assert a2a == {0: B / n, 2: B / n, 3: B / n}
    assert P_algo.per_peer("bcast", 0, n, B, root=1) == {}
    assert P_algo.per_peer("bcast", 1, n, B, root=1) == {2: B}
    assert P_algo.per_peer("reduce", 2, n, B, root=2) == {}
    assert P_algo.per_peer("alltoallv", 0, 3, 0.0, counts=[5, 0, 2],
                           row_bytes=8.0) == {2: 16.0}
    ops = ("allgather", "allgatherv", "allgather_multi", "reduce_scatter",
           "reduce_scatter_block", "reduce_scatter_multi", "allreduce",
           "allreduce_multi", "barrier", "bcast", "reduce", "scan",
           "exscan", "gather", "gatherv", "scatter", "scatterv",
           "alltoall", "alltoallv", "unknown")
    for n in (1, 2, 3, 4, 5):
        counts = [(3 * r + 1) % 4 for r in range(n)]
        for op in ops:
            for rank in range(n):
                for root in range(n):
                    for cnt in (None, counts):
                        kw = dict(root=root, counts=cnt, row_bytes=12.0)
                        assert P_algo.per_peer(op, rank, n, 1000, **kw) \
                            == R_algo.per_peer(op, rank, n, 1000, **kw)
                for algo in ("ring", "bidir", "linear"):
                    assert P_algo.pallas_per_peer(op, algo, rank, n, 4096) \
                        == R_algo.pallas_per_peer(op, algo, rank, n, 4096)
    edges = [(0, 1, 5), (1, 0, 3), (0, 0, 9), (2, 1, 4), (0, 2, 1)]
    for rank in range(3):
        assert P_algo.rma_per_peer(rank, edges, 4) \
            == R_algo.rma_per_peer(rank, edges, 4)


def test_linkmap_torus_wraparound():
    """2x2 torus: opposite corners route over two links; ring of 4:
    0 -> 3 takes the wraparound link; every route of a few shapes is
    the reference's."""
    from ompi_tpu.monitoring import links as R_links

    lm = P_links.LinkMap((2, 2))
    assert lm.route(0, 3) == [(0, 0, 2), (1, 2, 3)]
    ring = P_links.LinkMap((4,))
    assert ring.route(0, 3) == [(0, 0, 3)]
    assert P_links.link_name((0, 0, 3)) == "d0:r0-r3"
    loads = {}
    lm.charge(loads, 0, 3, 100.0)
    lm.charge(loads, 0, 1, 50.0)
    assert loads[(0, 0, 2)] == 100.0 and loads[(1, 2, 3)] == 100.0
    assert loads[(1, 0, 1)] == 50.0
    (hot, hb), = P_links.LinkMap.hottest(loads, top=1)
    assert hb == 100.0 and hot in ((0, 0, 2), (1, 2, 3))
    assert P_links.LinkMap.imbalance(loads) > 1.0
    assert P_links.LinkMap.for_world(2).route(0, 1) == [(0, 0, 1)]
    for dims in ((2, 2), (4,), (3, 2), (4, 4), (5,), (2, 3, 2), (6,)):
        a, b = P_links.LinkMap(dims), R_links.LinkMap(dims)
        for s in range(a.n):
            assert a.neighbors(s) == b.neighbors(s)
            for d in range(a.n):
                assert a.route(s, d) == b.route(s, d), (dims, s, d)
    for n in range(1, 13):
        assert P_links.LinkMap.for_world(n).dims \
            == R_links.LinkMap.for_world(n).dims


def test_topo_dims_create_and_cart_match_reference():
    """dims_create and CartTopo (coordinates, ranks, shifts, neighbours,
    routes, open and periodic dims) are the reference's."""
    from ompi_tpu import topo as R_topo
    from ompi_tpu_torch import topo as P_topo

    for nn in range(1, 40):
        for nd in (1, 2, 3):
            assert P_topo.dims_create(nn, nd) == R_topo.dims_create(nn, nd)
    assert P_topo.dims_create(12, 3, [0, 3, 0]) \
        == R_topo.dims_create(12, 3, [0, 3, 0])
    # the reference's ValueError is the port's MPIError (ERR_DIMS)
    with pytest.raises(errors.MPIError) as ei:
        P_topo.dims_create(10, 2, [3, 0])
    assert ei.value.error_class == errors.ERR_DIMS
    for dims, periods in (((3, 4), (True, False)), ((2, 2, 2), (False,) * 3),
                          ((5,), (True,)), ((4, 3), (True, True))):
        a = P_topo.CartTopo(dims, periods)
        b = R_topo.CartTopo(dims, periods)
        assert a.size == b.size and a.ndims == b.ndims
        for r in range(a.size):
            assert a.coords(r) == b.coords(r)
            assert a.neighbors(r) == b.neighbors(r)
            for dim in range(a.ndims):
                for disp in (1, 2, -1):
                    assert a.shift(r, dim, disp) == b.shift(r, dim, disp)
            for d in range(a.size):
                assert a.route(r, d) == b.route(r, d)
        assert a.rank_of([9] * a.ndims) == b.rank_of([9] * b.ndims)


def test_world_rank_invalid_peer():
    from ompi_tpu_torch.pml.request import ANY_SOURCE, PROC_NULL

    class G:
        ranks = [4, 7]

    class C:
        group = G()
        is_inter = False

    assert P_matrix.world_rank(C(), 1) == 7
    assert P_matrix.world_rank(C(), PROC_NULL) == PROC_NULL
    assert P_matrix.world_rank(C(), ANY_SOURCE) == ANY_SOURCE
    with pytest.raises(errors.MPIError) as ei:
        P_matrix.world_rank(C(), 5)
    assert ei.value.error_class == errors.ERR_RANK


def test_service_tag_constants_agree():
    """The shim's copies of the osc and part tags track the port's own
    (and the reference's)."""
    from ompi_tpu import osc as R_osc
    from ompi_tpu.part import host as R_part
    from ompi_tpu_torch import osc as P_osc
    from ompi_tpu_torch.part import host as P_part
    from ompi_tpu_torch.pml import monitoring as P_pml_mon

    assert P_pml_mon._OSC_SERVICE_TAG == P_osc._SERVICE_TAG \
        == R_osc._SERVICE_TAG
    assert P_pml_mon._PART_TAG_CEIL == P_part._PART_BASE == R_part._PART_BASE


def test_level_zero_plane_is_off():
    """A default session: no matrix, level 0, expert_load a no-op."""
    import ompi_tpu_torch.monitoring as monitoring

    assert P_matrix.TRAFFIC is None
    assert monitoring.level() == 0 and not monitoring.requested()
    monitoring.expert_load([3, 5])
    assert P_matrix.TRAFFIC is None


def _traffic_reads(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        for i, stmt in enumerate(body):
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Attribute) \
                    and stmt.value.attr == "TRAFFIC":
                yield stmt, node.body[i + 1:i + 2]


def test_traffic_sites_are_one_branch():
    """Every instrumented site of the port (the examples are users, not
    sites) reads ``TRAFFIC`` once into a local and branches on it being
    None before anything else: level 0 costs one attribute load and one
    branch."""
    sites = 0
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ompi_tpu_torch")):
        if os.path.basename(dirpath) == "examples":
            continue
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            for stmt, nxt in _traffic_reads(path):
                sites += 1
                var = stmt.targets[0].id
                assert nxt and isinstance(nxt[0], ast.If), (path, stmt.lineno)
                test = nxt[0].test
                first = test.values[0] if isinstance(test, ast.BoolOp) \
                    else test
                assert isinstance(first, ast.Compare) \
                    and isinstance(first.left, ast.Name) \
                    and first.left.id == var, (path, stmt.lineno)
                # ``is not None``: the work inside; ``is None``: returns
                assert isinstance(first.ops[0], ast.IsNot) or (
                    isinstance(first.ops[0], ast.Is)
                    and isinstance(nxt[0].body[-1], ast.Return)), \
                    (path, stmt.lineno)
    assert sites >= 29, sites


def test_merge_transpose_and_report(tmp_path):
    """Symmetric 2-rank traffic merges with zero transpose skew; the
    port's docs, merge and report are the reference's; the CLI
    round-trips."""
    from ompi_tpu.monitoring import matrix as R_matrix
    from ompi_tpu.monitoring import merge as R_merge
    from ompi_tpu.monitoring import report as R_report

    out = {}
    for tag, M, G, R in (("port", P_matrix, P_merge, P_report),
                         ("ref", R_matrix, R_merge, R_report)):
        docs = []
        try:
            for r in range(2):
                M.enable(rank=r, level=2, nranks=2)
                tm = M.TRAFFIC
                tm.count("p2p", 1 - r, 2048, msgs=2)
                tm.expert_tokens([10, 0, 6])
                tm.hier("allreduce", 100.0, 25.0, 12.5)
                docs.append(G.snapshot_doc(tm))
                M.disable()
        finally:
            M.disable()
        merged = G.merge(docs)
        out[tag] = (docs, merged, R.render(merged))
    docs, merged, text = out["port"]
    assert docs == out["ref"][0] and merged == out["ref"][1]
    assert text == out["ref"][2]
    assert merged["nranks"] == 2
    assert merged["transpose_skew"]["p2p"] == 0.0
    assert merged["tx_bytes"] == [2048.0, 2048.0]
    assert merged["rx_bytes"] == [2048.0, 2048.0]
    assert merged["links"] == [{"name": "d0:r0-r1", "bytes": 4096.0}]
    assert merged["expert_tokens"] == {0: 20, 2: 12}
    assert "d0:r0-r1" in text and "tx_total" in text
    paths = []
    for i, d in enumerate(docs):
        p = tmp_path / f"m{i}.json"
        p.write_text(json.dumps(d))
        paths.append(str(p))
    from ompi_tpu_torch.monitoring.__main__ import main

    dest = tmp_path / "merged.json"
    assert main(["report", *paths, "--json", str(dest)]) == 0
    assert json.loads(dest.read_text())["nranks"] == 2
    assert main(["report", str(tmp_path / "missing.json")]) == 1
    bad = tmp_path / "bad.json"
    bad.write_text("garbage")
    assert main(["report", str(bad)]) == 1


def test_collect_times_out_naming_the_rank():
    """The port's kvstore collect waits until its timeout, then raises
    ERR_INTERN naming the rank that never published."""
    from ompi_tpu_torch.runtime import kvstore

    store = kvstore.Store().start()
    try:
        client = kvstore.Client(store.addr)
        tm = P_matrix.TrafficMatrix(rank=0, level=1, nranks=2)
        tm.count("p2p", 1, 64)
        P_merge.publish(client, "job", 0, P_merge.snapshot_doc(tm))
        with pytest.raises(errors.MPIError) as ei:
            P_merge.collect(client, "job", 2, timeout=0.2)
        assert ei.value.error_class == errors.ERR_INTERN
        assert "rank 1" in str(ei.value)
        tm1 = P_matrix.TrafficMatrix(rank=1, level=1, nranks=2)
        tm1.count("p2p", 0, 64)
        P_merge.publish(client, "job", 1, P_merge.snapshot_doc(tm1))
        merged = P_merge.merge(P_merge.collect(client, "job", 2))
        assert merged["transpose_skew"]["p2p"] == 0.0
        client.close()
    finally:
        store.stop()


# ---------------------------------------------------------------------------
# launcher jobs


def test_pml_monitoring_traffic_matrix(jobs):
    """3 ranks under the deprecated pml_monitoring: the shim is
    installed, the p2p matrix counts 3 messages of 2048 bytes to the
    ring successor, collective traffic counts separately."""
    ref, port = jobs[3]
    for r in range(3):
        dp, dr = _doc(port, r), _doc(ref, r)
        assert dp["installed"]
        assert dp["p2p"] == [3, 3 * 2048] == dr["p2p"]
        assert dp["coll_msgs"] > 0
        assert dp["p2p_after"] == 3


def test_monitoring_context_pvars(jobs):
    """The per-context split reaches the pvars as in the reference."""
    ref, port = jobs[2]
    for r in range(2):
        dp, dr = _doc(port, r), _doc(ref, r)
        assert dp["installed"] and dp["level"] == 2
        assert dp["ctx1"] == [1, 1024, 0] == dr["ctx1"]
        p2p, coll, total = dp["ctx2"]
        assert p2p == 1 and coll > 0 and total == p2p + coll
        assert dp["ctx2"] == dr["ctx2"]


def test_traffic_plane_two_ranks(jobs):
    """Level 2: send-side totals equal the bytes per context (p2p and
    partitioned), the merged matrix transposes cleanly, the link is
    named, the Finalize-style dump round-trips; the p2p and part cells,
    link loads and report equal the reference's."""
    ref, port = jobs[2]
    for r in range(2):
        dp, dr = _doc(port, r), _doc(ref, r)
        assert dp["p2p_bytes"] == 2048
        assert dp["part"] == [2048, 2048]
        assert dp["skew"]["p2p"] == 0.0 and dp["skew"]["part"] == 0.0
        assert any(link["name"] == "d0:r0-r1" for link in dp["links"])
        assert dp["dump"] == [True, P_merge.SCHEMA, r]
        for key in ("tables", "link_bytes", "report", "skew"):
            assert dp[key] == dr[key], key


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("segment", ["device", "cuda"])
def test_collective_records_match_reference(jobs, n, segment):
    """coll/device's slots (coll/xla's) and coll/cuda's (coll/pallas's)
    record the reference's per-peer bytes: every cell, collective record
    (op, size bucket, dtype, mesh, launches, bytes) and, at level 2, link
    load of the segment, and the merged report's text."""
    ref, port = jobs[n]
    for r in range(n):
        dp, dr = _doc(port, r), _doc(ref, r)
        a, b = dp[segment], dr[segment]
        assert a["coll_records"] and a["tables"]["coll"]
        assert a["tables"] == b["tables"]
        assert a["coll_records"] == b["coll_records"]
        assert a["link_bytes"] == b["link_bytes"]
        if n == 4:
            assert a["link_bytes"]
        assert dp[f"report_{segment}"] == dr[f"report_{segment}"]
