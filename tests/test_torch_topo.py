"""The port's topology framework (``topo/``, ``topo/reorder.py``, the
neighbourhood slots of coll/basic, coll/libnbc, coll/accelerator and
``coll/device_neighbor.py``) against the JAX package's.

In this process: ``tests/test_topo.py``'s local cases (``dims_create``,
the cart arithmetic, the mesh correspondence, the placement unit cases)
and the parity of ``reorder.place`` / ``cart_weights`` and of the device
slots' edge pairing on seeded inputs, the one-shared-card identity
placement (a stub plane) and the inconsistent dist graph's ERR_TOPOLOGY.

Launcher jobs, one per package and rank count, run the same programs
(:data:`_PROG2`, :data:`_PROG3`, :data:`_PROG4`: the reference's cases on
numpy buffers, each rank writing what it got); the reference's run as
pooled bodies. The port's 4-rank job runs under the device plane on the
CPU platform and adds :data:`_DEVICE4`, ``tests/test_device_path.py``'s
neighbourhood cases on CPU tensors; its 3-rank job runs with no plane
and adds the staging case (:data:`_STAGED3`), on a periodic and an open
ring of 3 (the reference's 2 x 2 cart needs 4 ranks, whose job has the
plane up). A device result must equal, bitwise, the host result of the
same exchange in the reference's job.
"""

import json
import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch import errors
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

_HEAD = '''
import json, os
import numpy as np
from {pkg}.pml.request import PROC_NULL
from {pkg}.topo import dims_create
doc = {{}}


def err(call):
    try:
        call()
        return None
    except Exception as e:  # noqa: BLE001 — the class is the result
        return [type(e).__name__, getattr(e, "error_class", None)]
'''

_TAIL = '''
with open(os.path.join({out!r}, f"r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''

#: 2 ranks: the degenerate size-2 alltoall, a zero-degree dist graph,
#: Topo_test / Is_inter / Request_get_status, the oversize maps
_PROG2 = _HEAD + '''
cart = comm.Create_cart([2], periods=[True])
send = np.array([10.0 * rank + 1, 10.0 * rank + 2], np.float32)
recv = np.zeros(2, np.float32)
cart.Neighbor_alltoall(send, recv)
doc["size2"] = recv.tolist()
if rank == 0:
    g = comm.Create_dist_graph_adjacent(sources=[1], destinations=[])
    recv = np.empty(3, np.float32)
    g.Neighbor_alltoall(np.empty(0, np.float32), recv)
    doc["zero_degree"] = recv.tolist()
else:
    g = comm.Create_dist_graph_adjacent(sources=[], destinations=[0])
    g.Neighbor_alltoall(np.full(3, 7.0, np.float32), np.empty(0, np.float32))
    doc["zero_degree"] = []
kinds = [comm.Topo_test(), comm.Is_inter(),
         comm.Create_cart([size]).Topo_test(),
         comm.Create_dist_graph_adjacent([], []).Topo_test(),
         comm.Create_graph([1, 2], [1, 0]).Topo_test()]
doc["kinds"] = kinds
peer = 1 - rank
rb = np.zeros(4)
req = comm.Irecv(rb, source=peer, tag=2)
comm.Send(np.full(4, 5.0), dest=peer, tag=2)
req.wait()
doc["get_status"] = [[bool(f), st.source] for f, st in
                     (mpi.Request_get_status(req) for _ in range(2))]
doc["get_status"].append(rb.tolist())
doc["oversize"] = [err(lambda: comm.Cart_map([size + 1])),
                   err(lambda: comm.Graph_map([0] * (size + 1), [])),
                   err(lambda: comm.Create_cart([size + 1])),
                   err(lambda: comm.Cart_sub([True]))]
doc["maps"] = [comm.Cart_map([1]), comm.Graph_map([0], [])]
'''

#: 3 ranks: the open boundary, reorder with no coordinates (no device
#: plane in either 3-rank job), the directed ring, the star graph, the
#: receive-only alltoallv
_PROG3 = _HEAD + '''
cart = comm.Create_cart([size], periods=[False])
send = np.full(1, float(rank), np.float32)
recv = np.full((2, 1), -1.0, np.float32)
cart.Neighbor_allgather(send, recv)
doc["open"] = recv.tolist()
doc["reorder_off"] = comm.Create_cart([size], periods=[True],
                                      reorder=True).rank
left, right = (rank - 1) % size, (rank + 1) % size
g = comm.Create_dist_graph_adjacent(sources=[left], destinations=[right])
ins, outs = g.Dist_graph_neighbors()
recv = np.empty(3, np.float32)
g.Neighbor_alltoall(np.full(3, float(rank), np.float32), recv)
doc["ring"] = [list(ins), list(outs), recv.tolist()]
others = [r for r in range(size) if r != 0]
index, edges = [], []
for r in range(size):
    edges.extend(others if r == 0 else [0])
    index.append(len(edges))
g = comm.Create_graph(index, edges)
nbrs = g.Graph_neighbors()
recv = np.zeros((len(nbrs), 1), np.float32)
g.Neighbor_allgather(np.full(1, float(rank), np.float32), recv)
doc["star"] = [nbrs, recv[:, 0].tolist(), g.Graph_neighbors(0)]
sources = {{0: [1, 2], 1: [], 2: []}}[rank]
dests = {{0: [], 1: [0], 2: [0]}}[rank]
g = comm.Create_dist_graph_adjacent(sources, dests)
if rank == 0:
    rb = np.full(4, -1, np.int32)
    g.Neighbor_alltoallv(np.zeros(0, np.int32), rb, [], [3, 1])
    doc["recv_only"] = rb.tolist()
else:
    g.Neighbor_alltoallv(np.full({{1: 3, 2: 1}}[rank], 11 * rank, np.int32),
                         np.zeros(0, np.int32), [{{1: 3, 2: 1}}[rank]], [])
    doc["recv_only"] = []
comm.Barrier()
'''

#: 4 ranks: the halo Sendrecv, Cart_sub, the ring allgather,
#: Dist_graph_create, the v forms, the I forms, and the
#: host side of tests/test_device_path.py's four device cases
_PROG4 = _HEAD + '''
cart = comm.Create_cart([size], periods=[True])
src, dst = cart.Cart_shift(0, 1)
left = np.empty(4, np.float32)
cart.Sendrecv(np.full(4, float(rank), np.float32), dest=dst, recvbuf=left,
              source=src)
doc["halo"] = [src, dst, left.tolist(), cart.Cart_get()]
dims = dims_create(size, 2)
cart = comm.Create_cart(dims, periods=[False, False])
coords = cart.Cart_coords()
row, col = cart.Cart_sub([False, True]), cart.Cart_sub([True, False])
out = np.empty(1, np.float32)
row.Allreduce(np.array([float(rank)], np.float32), out)
doc["sub"] = [dims, coords, row.size, row.rank, col.size, col.rank,
              list(row.topo.dims), list(col.topo.periods), out.tolist(),
              cart.Cart_rank([coords[0], 0]), cart.Cart_shift(1, 1)]
cart = comm.Create_cart([size], periods=[True])
recv = np.zeros((2, 2), np.float32)
cart.Neighbor_allgather(np.full(2, float(rank), np.float32), recv)
doc["ring_allgather"] = recv.tolist()
if rank == 0:
    s, d, t = list(range(size)), [1] * size, [(x + 1) % size
                                             for x in range(size)]
else:
    s, d, t = [], [], []
dg = comm.Create_dist_graph(s, d, t)
ins, outs = dg.Dist_graph_neighbors()
recv = np.zeros(2, np.float64)
dg.Neighbor_allgather(np.full(2, float(rank)), recv)
doc["general"] = [list(ins), list(outs), recv.tolist()]
cart = comm.Create_cart([size], periods=[True])
ins = cart.topo.in_neighbors(cart.rank)
mine = np.full(rank + 1, 10 * rank, np.int32)
rcounts = [ins[i] + 1 for i in range(2)]
vout = np.full(rcounts[0] + 2 + rcounts[1], -1, np.int32)
cart.Neighbor_allgatherv(mine, vout, rcounts, [0, rcounts[0] + 2])
sb = np.concatenate([np.full(j + 1, 100 * rank + j, np.int32)
                     for j in range(2)])
rc2 = [(cart.topo.out_neighbors(s).index(rank)
        if cart.topo.out_neighbors(s).count(rank) == 1 else i ^ 1) + 1
       for i, s in enumerate(ins)]
rb = np.full(sum(rc2), -1, np.int32)
cart.Neighbor_alltoallv(sb, rb, [1, 2], rc2)
doc["v"] = [vout.tolist(), rb.tolist()]
out = np.zeros((2, 4))
r1 = cart.Ineighbor_allgather(np.full(4, float(rank), np.float64), out)
isb = np.stack([np.full(3, 10 * rank + j, np.float32) for j in range(2)])
irb = np.zeros((2, 3), np.float32)
r2 = cart.Ineighbor_alltoall(isb, irb)
comm.send(("x", rank), dest=(rank + 1) % size, tag=77)
got = comm.recv(source=(rank - 1) % size, tag=77)
ivout = np.zeros(sum(s + 1 for s in ins), np.int32)
r3 = cart.Ineighbor_allgatherv(np.full(rank + 1, rank, np.int32), ivout,
                               [s + 1 for s in ins])
ivrb = np.full(sum(rc2), -1, np.int32)
r4 = cart.Ineighbor_alltoallv(sb, ivrb, [1, 2], rc2)
mpi.wait_all([r1, r2, r3, r4])
doc["i"] = [out.tolist(), irb.tolist(), list(got), ivout.tolist(),
            ivrb.tolist()]
# tests/test_device_path.py's payloads on the host path
c22 = comm.Create_cart([2, 2], periods=[True, True])
n22 = c22.topo.in_neighbors(c22.rank)
h = np.zeros((len(n22), 3), np.float32)
c22.Neighbor_allgather(np.arange(3, dtype=np.float32) + 10 * c22.rank, h)
a2a = np.zeros((len(n22), 2), np.float32)
c22.Neighbor_alltoall(np.arange(len(n22) * 2, dtype=np.float32).reshape(
    len(n22), 2) + 100 * c22.rank, a2a)
c4 = comm.Create_cart([4], periods=[False])
op = np.zeros((2, 2), np.float32)
c4.Neighbor_allgather(np.full(2, float(c4.rank + 1), np.float32), op)
gouts = {{0: [1, 2], 1: [2], 2: [3], 3: [0]}}[rank]
gins = {{0: [3], 1: [0], 2: [1, 0], 3: [2]}}[rank]
g = comm.Create_dist_graph_adjacent(gins, gouts)
gag = np.zeros((len(gins), 2), np.float32)
g.Neighbor_allgather(np.full(2, float(g.rank), np.float32), gag)
ga2a = np.zeros((len(gins), 2), np.float32)
g.Neighbor_alltoall(np.arange(len(gouts) * 2, dtype=np.float32).reshape(
    len(gouts), 2) + 100 * g.rank, ga2a)
doc["device_host"] = {{"allgather_2x2": h.tolist(), "alltoall_2x2": a2a.tolist(),
                      "open": op.tolist(), "graph_allgather": gag.tolist(),
                      "graph_alltoall": ga2a.tolist()}}
'''

#: the port's 4-rank job under the device plane: tests/test_device_path.py
#: :21-113 on CPU tensors, the ERR_COUNT refusal, and the dist graph
#: reordered on the CPU plane's line of coordinates
_DEVICE4 = '''
import torch
from ompi_tpu_torch.core import pvar
s0 = pvar.read("coll_device_launches")
dev = {}
c22 = comm.Create_cart([2, 2], periods=[True, True])
n22 = c22.topo.in_neighbors(c22.rank)
x = torch.arange(3, dtype=torch.float32) + 10 * c22.rank
dev["allgather_2x2"] = c22.Neighbor_allgather(x)
sb = torch.arange(len(n22) * 2, dtype=torch.float32).reshape(len(n22), 2) \\
    + 100 * c22.rank
dev["alltoall_2x2"] = c22.Neighbor_alltoall(sb)
c4 = comm.Create_cart([4], periods=[False])
dev["open"] = c4.Neighbor_allgather(
    torch.full((2,), float(c4.rank + 1), dtype=torch.float32))
gouts = {0: [1, 2], 1: [2], 2: [3], 3: [0]}[rank]
gins = {0: [3], 1: [0], 2: [1, 0], 3: [2]}[rank]
g = comm.Create_dist_graph_adjacent(gins, gouts)
dev["graph_allgather"] = g.Neighbor_allgather(
    torch.full((2,), float(g.rank), dtype=torch.float32))
dev["graph_alltoall"] = g.Neighbor_alltoall(
    torch.arange(len(gouts) * 2, dtype=torch.float32).reshape(len(gouts), 2)
    + 100 * g.rank)
# a byte copy: int64 and bool blocks move bitwise too
i64 = c22.Neighbor_allgather(torch.full((5,), (1 << 40) + c22.rank,
                                        dtype=torch.int64))
bools = c22.Neighbor_alltoall(torch.tensor(
    [[True, False]] * len(n22)) ^ (c22.rank % 2 == 1))
doc["device"] = {k: v.tolist() for k, v in dev.items()}
doc["device_types"] = [isinstance(v, torch.Tensor) and v.device.type
                       for v in dev.values()]
doc["device_bytes"] = [n22, i64.tolist(), bools.tolist()]
doc["device_pvars"] = [pvar.read("coll_accelerator_staged"),
                       pvar.read("coll_device_launches") - s0,
                       c22.coll.providers["neighbor_allgather_dev"],
                       c22.coll.providers["neighbor_alltoall_dev"]]
doc["err_count"] = err(lambda: c22.Neighbor_alltoall(torch.zeros(3, 2)))
outs = {0: [2], 2: [1], 1: [3], 3: []}
ins = {2: [0], 1: [2], 3: [1], 0: []}
dg = comm.Create_dist_graph_adjacent(ins[rank], outs[rank], reorder=True)
srcs, dsts = dg.Dist_graph_neighbors()
doc["reorder_plane"] = [dg.rank, list(srcs), list(dsts)]
'''

#: the port's 3-rank job, no device plane: tensors on topology comms stage
#: through coll/accelerator (test_neighbor_device_staging_fallback)
_STAGED3 = '''
import torch
from ompi_tpu_torch.core import pvar
staged = []
for periods in ([True], [False]):
    c = comm.Create_cart([size], periods=periods)
    x = torch.arange(3, dtype=torch.float32) + 10 * c.rank
    out = c.Neighbor_allgather(x)
    a2a = c.Neighbor_alltoall(torch.arange(4, dtype=torch.float32).reshape(
        2, 2) + 100 * c.rank)
    h = np.full((2, 2), 0, np.float32)
    c.Neighbor_alltoall((np.arange(4, dtype=np.float32).reshape(2, 2)
                         + 100 * c.rank), h)
    staged.append([c.topo.in_neighbors(c.rank), out.tolist(), a2a.tolist(),
                   h.tolist(), c.coll.providers["neighbor_allgather_dev"]])
doc["staged"] = [staged, pvar.read("coll_accelerator_staged")]
'''

_PORT_PRELUDE = '''
import numpy as np
from ompi_tpu_torch import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size
'''

_PORT_EPILOGUE = '''
mpi.Finalize()
'''

_PROGS = {2: _PROG2, 3: _PROG3, 4: _PROG4}
#: what the port's job of each rank count adds, and its mca
_PORT_EXTRA = {3: (_STAGED3, None),
               4: (_DEVICE4, {"device_plane": "on",
                              "device_plane_platform": "cpu"})}
_jobs = {}


def _port_job(src: str, n: int, mca=None, timeout=240) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n, mca=mca,
                                    timeout=timeout)
    finally:
        os.unlink(path)


@pytest.fixture(scope="module")
def docs(request, tmp_path_factory):
    """[(port doc, reference doc)] per rank for the rank count."""
    n = request.param
    if n not in _jobs:
        ref = tmp_path_factory.mktemp(f"topo_ref{n}")
        port = tmp_path_factory.mktemp(f"topo_port{n}")
        run_ranks(_PROGS[n].format(pkg="ompi_tpu", out=str(ref)) +
                  _TAIL.format(out=str(ref)), n, timeout=240)
        extra, mca = _PORT_EXTRA.get(n, ("", None))
        src = (_PORT_PRELUDE + _PROGS[n].format(pkg="ompi_tpu_torch")
               + extra + _TAIL.format(out=str(port)) + _PORT_EPILOGUE)
        assert _port_job(src, n, mca) == 0, "port job failed"
        _jobs[n] = [(json.loads((port / f"r{r}.json").read_text()),
                     json.loads((ref / f"r{r}.json").read_text()))
                    for r in range(n)]
    return _jobs[n]


def _same(pairs, key):
    for p, r in pairs:
        assert p[key] == r[key], (key, p[key], r[key])
    return [r[key] for _, r in pairs]


# ---------------------------------------------------------------------------
# in process


def test_dims_create():
    """tests/test_topo.py::test_dims_create (the refusal: MPIError
    ERR_DIMS where the reference raises ValueError)."""
    from ompi_tpu import topo as R
    from ompi_tpu_torch import topo as P

    for args in ((12, 2), (8, 3), (6, 2, [3, 0]), (24, 3, [0, 2, 0])):
        assert P.dims_create(*args) == R.dims_create(*args)
    assert sorted(P.dims_create(12, 2), reverse=True) == [4, 3]
    with pytest.raises(ValueError):
        R.dims_create(7, 2, [2, 0])
    with pytest.raises(errors.MPIError) as ei:
        P.dims_create(7, 2, [2, 0])
    assert ei.value.error_class == errors.ERR_DIMS


def test_cart_coords_rank_shift_local():
    """tests/test_topo.py::test_cart_coords_rank_shift_local."""
    from ompi_tpu import topo as R
    from ompi_tpu_torch import topo as P
    from ompi_tpu_torch.pml.request import PROC_NULL

    t, u = P.CartTopo((2, 3), (False, True)), R.CartTopo((2, 3),
                                                         (False, True))
    assert t.coords(5) == u.coords(5) == [1, 2]
    assert t.rank_of([0, 3]) == t.rank_of([0, 0]) == u.rank_of([0, 3])
    assert t.rank_of([2, 0]) == PROC_NULL == u.rank_of([2, 0])
    for d in (0, 1):
        for disp in (1, 2, -1):
            assert t.shift(0, d, disp) == u.shift(0, d, disp)
    assert t.shift(0, 0, 1) == (PROC_NULL, 3)
    with pytest.raises(errors.MPIError):
        t.rank_of([0])


def test_cart_matches_device_mesh_groups():
    """tests/test_topo.py::test_cart_matches_device_mesh_groups: the
    port's Mesh (ranks under named axes) maps to the reference's cart
    dims, and Cart_sub's groups are the mesh's axis groups."""
    from ompi_tpu_torch.parallel.mesh import Mesh
    from ompi_tpu_torch.topo import CartTopo, cart_of_mesh

    mesh = Mesh(np.arange(6).reshape(2, 3), ("a", "b"), None)
    dims, names = cart_of_mesh(mesh)
    assert (dims, names) == ([2, 3], ["a", "b"])
    assert cart_of_mesh(mesh, ["b", "a"]) == ([3, 2], ["b", "a"])
    topo = CartTopo(dims, [False] * 2)
    by_row = {}
    for r in range(mesh.size):
        by_row.setdefault(topo.coords(r)[0], []).append(r)
    assert [sorted(v) for _, v in sorted(by_row.items())] \
        == mesh.devices.tolist()
    import jax

    if len(jax.devices()) >= 6:
        from ompi_tpu.parallel import make_mesh
        from ompi_tpu.topo import cart_of_mesh as R_cart_of_mesh

        assert R_cart_of_mesh(make_mesh(("a", "b"), (2, 3))) \
            == (dims, names)


def test_place_path_graph_on_line():
    """tests/test_topo.py::test_place_path_graph_on_line, both packages."""
    from ompi_tpu.topo import reorder as R
    from ompi_tpu_torch.topo import reorder as P

    n = 6
    w = np.zeros((n, n))
    for v in range(n - 1):
        w[v, v + 1] = 1.0
    coords = [(i,) for i in range(n)]
    perm = P.place(w, coords)
    assert perm == R.place(w, coords)
    assert sorted(perm) == list(range(n))
    assert all(abs(perm[v] - perm[v + 1]) == 1 for v in range(n - 1))


def test_cart_weights_stencil():
    """tests/test_topo.py::test_cart_weights_stencil, and the same
    stencils as the reference's for several grids."""
    from ompi_tpu.topo import reorder as R
    from ompi_tpu_torch.topo import reorder as P

    w = P.cart_weights([2, 3], [False, True])
    assert w[0, 1] == w[0, 2] == w[0, 3] == 1 and w[0, 4] == 0
    assert np.all(w.diagonal() == 0)
    for dims, per in (([2, 3], [False, True]), ([4], [True]), ([2, 2, 2],
                      [True, False, True]), ([5, 1], [False, True])):
        assert np.array_equal(P.cart_weights(dims, per),
                              R.cart_weights(dims, per))


def test_place_matches_reference_on_seeded_graphs():
    """reorder.place (greedy + pairwise refine) against the reference's
    on seeded weight matrices and coordinates: lines, 2-D grids with
    ties, one-hot cards."""
    from ompi_tpu.topo import reorder as R
    from ompi_tpu_torch.topo import reorder as P

    rng = np.random.default_rng(23)
    for trial in range(12):
        n = int(rng.integers(2, 9))
        w = rng.integers(0, 3, (n, n)).astype(float)
        np.fill_diagonal(w, 0)
        kind = trial % 3
        if kind == 0:
            coords = [(int(c),) for c in rng.permutation(n)]
        elif kind == 1:
            coords = [(i // 2, i % 2) for i in range(n)]
        else:
            k = int(rng.integers(1, 4))
            coords = [tuple(int(i == c % k) for i in range(k))
                      for c in range(n)]
        assert P.place(w, coords) == R.place(w, coords), (trial, w, coords)


def test_reorder_identity_on_one_shared_card(monkeypatch):
    """Every rank on one CUDA card: one coordinate, so Create_cart's
    placement is the identity (a stub plane); two cards are equidistant
    one-hot coordinates, and the CPU plane is a line by world rank."""
    import torch

    from ompi_tpu_torch.runtime import device_plane, rte
    from ompi_tpu_torch.topo import reorder as P

    class Stub:
        def __init__(self, n):
            self.group = type("G", (), {"ranks": tuple(range(n))})()

    devs = {}
    monkeypatch.setattr(device_plane, "active", lambda: True)
    monkeypatch.setattr(device_plane, "device_for_world_rank", devs.get)
    monkeypatch.setattr(rte, "world_offset", 0)
    for r in range(4):
        devs[r] = torch.device("cuda", 0)
    assert P.rank_coords(Stub(4)) == [(1,)] * 4
    w = P.cart_weights([2, 2], [True, True])
    assert P.permute_for(Stub(4), w) is None
    for r in range(4):
        devs[r] = torch.device("cuda", r // 2)
    assert P.rank_coords(Stub(4)) == [(1, 0), (1, 0), (0, 1), (0, 1)]
    assert P.permute_for(Stub(4), w) is not None
    for r in range(4):
        devs[r] = torch.device("cpu")
    assert P.rank_coords(Stub(4)) == [(0,), (1,), (2,), (3,)]


def _random_graph(rng, n):
    """Per-rank in / out lists of a random directed multigraph."""
    outs = [[] for _ in range(n)]
    ins = [[] for _ in range(n)]
    for _ in range(int(rng.integers(0, 3 * n))):
        s, d = (int(v) for v in rng.integers(0, n, 2))
        outs[s].append(d)
        ins[d].append(s)
    for lst in outs + ins:  # posted order is the caller's, not sorted
        rng.shuffle(lst)
    return ins, outs


def test_edge_pairing_matches_reference():
    """The device slots' edges (_edges_allgather, _edges_alltoall: a
    cart's conjugate slots, a graph's first-in first-out multi-edges)
    against the reference's on seeded graphs with multi-edges and on
    carts."""
    from ompi_tpu import topo as R_topo
    from ompi_tpu.coll import xla_neighbor as R
    from ompi_tpu_torch import topo as P_topo
    from ompi_tpu_torch.coll import device_neighbor as P

    rng = np.random.default_rng(4)
    for _ in range(20):
        n = int(rng.integers(1, 7))
        ins, outs = _random_graph(rng, n)
        pa, ra = P._GlobalAdj(ins, outs), R._GlobalAdj(ins, outs)
        assert P._edges_allgather(pa, n) == R._edges_allgather(ra, n)
        assert P._edges_alltoall(pa, n) == R._edges_alltoall(ra, n)
        edges = P._edges_alltoall(pa, n)[0]
        assert P._color(edges) == R._color(edges)
    for dims, per in (([2, 2], [True, True]), ([4], [False]),
                      ([2, 3], [True, False]), ([2], [True])):
        pt, rt = P_topo.CartTopo(dims, per), R_topo.CartTopo(dims, per)
        n = pt.size
        assert P._edges_alltoall(pt, n) == R._edges_alltoall(rt, n)
        assert P._edges_allgather(pt, n) == R._edges_allgather(rt, n)
    # 2 x 2 periodic: 16 edges, 4 greedy colour rounds
    edges, _ = P._edges_allgather(P_topo.CartTopo([2, 2], [True, True]), 4)
    assert len(edges) == 16 and len(P._color(edges)) == 4


def test_dist_graph_inconsistent_is_err_topology():
    """A rank that lists a source more often than the source lists it
    back: ERR_TOPOLOGY from both packages' pairing."""
    from ompi_tpu import errors as R_errors
    from ompi_tpu.coll import xla_neighbor as R
    from ompi_tpu_torch.coll import device_neighbor as P

    ins, outs = [[1, 1], []], [[], [0]]
    with pytest.raises(errors.MPIError) as ei:
        P._edges_alltoall(P._GlobalAdj(ins, outs), 2)
    assert ei.value.error_class == errors.ERR_TOPOLOGY
    with pytest.raises(R_errors.MPIError):
        R._edges_alltoall(R._GlobalAdj(ins, outs), 2)


# ---------------------------------------------------------------------------
# launcher jobs: tests/test_topo.py's rank cases


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_cart_halo_exchange(docs):
    vals = _same(docs, "halo")
    for r, (src, dst, left, _) in enumerate(vals):
        assert (src, dst) == ((r - 1) % 4, (r + 1) % 4)
        assert left == [float((r - 1) % 4)] * 4


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_cart_sub_rows_cols(docs):
    for r, v in enumerate(_same(docs, "sub")):
        dims, coords = v[0], v[1]
        assert v[2:6] == [dims[1], coords[1], dims[0], coords[0]]


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_neighbor_allgather_cart(docs):
    for r, recv in enumerate(_same(docs, "ring_allgather")):
        assert recv == [[float((r - 1) % 4)] * 2, [float((r + 1) % 4)] * 2]


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_neighbor_allgather_open_boundary(docs):
    got = _same(docs, "open")
    assert got[0] == [[-1.0], [1.0]] and got[2] == [[1.0], [-1.0]]


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_neighbor_alltoall_cart_size2_degenerate(docs):
    assert _same(docs, "size2") == [[12.0, 11.0], [2.0, 1.0]]


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_dist_graph_neighbor_alltoall(docs):
    for r, (ins, outs, recv) in enumerate(_same(docs, "ring")):
        assert ins == [(r - 1) % 3] and outs == [(r + 1) % 3]
        assert recv == [float((r - 1) % 3)] * 3


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_dist_graph_zero_degree(docs):
    assert _same(docs, "zero_degree")[0] == [7.0] * 3


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_graph_create_neighbors(docs):
    got = _same(docs, "star")
    assert got[0][:2] == [[1, 2], [1.0, 2.0]] and got[1][:2] == [[0], [0.0]]


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_reorder_identity_off_plane(docs):
    """With no device plane reorder is the identity (the reference's
    case on a 2 x 2 cart; here a ring of 3, the rank count whose jobs
    run with no plane)."""
    assert _same(docs, "reorder_off") == [0, 1, 2]


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_dist_graph_reorder_places_heavy_edges_on_neighbors(docs):
    """The scrambled path 0-2-1-3 reordered on the CPU plane (each rank a
    position on a line, the reference's virtual devices): the ranks and
    adopted adjacencies of the reference's placement on those
    coordinates."""
    from ompi_tpu.topo import reorder as R

    outs = {0: [2], 2: [1], 1: [3], 3: []}
    ins = {2: [0], 1: [2], 3: [1], 0: []}
    w = np.zeros((4, 4))
    for r in range(4):
        for s in ins[r]:
            w[s, r] += 1
        for d in outs[r]:
            w[r, d] += 1
    perm = R.place(w, [(i,) for i in range(4)])
    for r, (p, _) in enumerate(docs):
        new, srcs, dsts = p["reorder_plane"]
        assert new == perm.index(r)
        assert srcs == ins[new] and dsts == outs[new]
    pos = {p["reorder_plane"][0]: r for r, (p, _) in enumerate(docs)}
    for a, b in ((0, 2), (2, 1), (1, 3)):
        assert abs(pos[a] - pos[b]) == 1


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_dist_graph_create_general(docs):
    for r, (ins, outs, recv) in enumerate(_same(docs, "general")):
        assert outs == [(r + 1) % 4] and ins == [(r - 1) % 4]
        assert recv == [float((r - 1) % 4)] * 2


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_neighbor_v_variants_ragged(docs):
    got = _same(docs, "v")
    vout, rb = got[0]
    assert vout == [30] * 4 + [-1, -1] + [10] * 2
    assert rb == [301, 301, 100]


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_neighbor_alltoallv_receive_only_rank(docs):
    assert _same(docs, "recv_only")[0] == [11, 11, 11, 22]


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_ineighbor_nonblocking_overlap(docs):
    got = _same(docs, "i")
    for r, (out, irb, sent, ivout, ivrb) in enumerate(got):
        a, b = (r - 1) % 4, (r + 1) % 4
        assert out == [[float(a)] * 4, [float(b)] * 4]
        assert sent == ["x", a]
        assert ivout == [a] * (a + 1) + [b] * (b + 1)
        assert irb == [[10.0 * a + 1] * 3, [10.0 * b + 0] * 3]
    assert [g[4] for g in got] == [d[0]["v"][1] for d in docs]


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_topo_test_is_inter_request_get_status(docs):
    got = _same(docs, "kinds")
    assert got[0] == ["undefined", False, "cart", "dist_graph", "graph"]
    for r, v in enumerate(_same(docs, "get_status")):
        assert v[:2] == [[True, 1 - r]] * 2 and v[2] == [5.0] * 4


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_cart_graph_map_oversize_rejected(docs):
    """The size contract of Cart_map / Graph_map / Create_cart and
    Cart_sub on a comm with no cart: the reference's ValueError is the
    port's MPIError (ERR_DIMS, ERR_TOPOLOGY)."""
    for p, r in docs:
        assert [e[0] for e in r["oversize"]] == ["ValueError"] * 4
        assert p["oversize"] == [
            ["MPIError", errors.ERR_DIMS], ["MPIError", errors.ERR_TOPOLOGY],
            ["MPIError", errors.ERR_DIMS], ["MPIError", errors.ERR_TOPOLOGY]]
        assert p["maps"] == r["maps"]
    assert docs[0][0]["maps"] == [0, 0] and docs[1][0]["maps"] == [
        -32766, -32766]


# ---------------------------------------------------------------------------
# tests/test_device_path.py:21-131 on CPU tensors


@pytest.mark.parametrize("docs", [4], indirect=True)
@pytest.mark.parametrize("case", ["allgather_2x2", "alltoall_2x2", "open",
                                  "graph_allgather"])
def test_neighbor_device_matches_host(docs, case):
    """test_cart_neighbor_allgather_device_no_staging,
    test_cart_neighbor_alltoall_device_degenerate_dim,
    test_cart_neighbor_open_boundary_null_rows (PROC_NULL rows zero) and
    the allgather of test_dist_graph_neighbor_device_ragged: the port's
    device result on CPU tensors is bitwise the reference's host result
    of the same exchange."""
    for p, r in docs:
        assert p["device"][case] == r["device_host"][case]
        assert all(t == "cpu" for t in p["device_types"])


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_dist_graph_neighbor_device_ragged(docs):
    """test_dist_graph_neighbor_device_ragged: ragged degrees (rank 0
    sends 2 rows, rank 2 receives 2); no staging, coll/device serves,
    a mismatched dim 0 is ERR_COUNT, any dtype moves bitwise."""
    for rank, (p, r) in enumerate(docs):
        assert p["device"]["graph_alltoall"] == r["device_host"][
            "graph_alltoall"]
        staged, launches, prov_ag, prov_a2a = p["device_pvars"]
        assert staged == 0 and launches == 7
        assert prov_ag == prov_a2a == "device"
        assert p["err_count"] == ["MPIError", errors.ERR_COUNT]
        n22, i64, bools = p["device_bytes"]
        assert i64 == [[(1 << 40) + s] * 5 for s in n22]
        assert bools == [[s % 2 == 0, s % 2 == 1] for s in n22]


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_neighbor_device_staging_fallback(docs):
    """test_neighbor_device_staging_fallback: with no device plane a
    tensor on a topology comm stages through coll/accelerator (counted,
    PROC_NULL rows zero) and equals the host path."""
    for r, (p, _) in enumerate(docs):
        staged, count = p["staged"]
        assert count == 4
        for ins, out, a2a, host, prov in staged:
            assert prov == "accelerator" and a2a == host
            for k, s in enumerate(ins):
                want = [0.0] * 3 if s < 0 else [float(10 * s + i)
                                                for i in range(3)]
                assert out[k] == want
