"""Process topologies — cartesian, graph and distributed graph.

Reference: ompi/mca/topo/ (topo_base_cart_create.c, the construction and
its optional reorder; topo_base_cart_sub.c; the graph and dist-graph
bookkeeping) and the neighbourhood collective slots they unlock
(ompi/mca/coll/coll.h:600-618); the JAX package's ``ompi_tpu/topo``.

- :func:`dims_create` (MPI_Dims_create) and :class:`CartTopo`, the grid
  arithmetic (coordinates, ranks, shifts, neighbours and the
  dimension-ordered minimal-hop route that the monitoring plane's level-2
  link attribution walks, :mod:`ompi_tpu_torch.monitoring.links`);
  :class:`GraphTopo` and :class:`DistGraphTopo`.
- The constructors and queries, attached to ``Communicator``:
  Create_cart (``reorder``: :mod:`ompi_tpu_torch.topo.reorder` places the
  stencil on the devices' distances), Cart_sub, Cart_coords / _rank /
  _shift / _get, Cart_map, Create_graph, Graph_map, Graph_neighbors,
  Create_dist_graph (the general form) and Create_dist_graph_adjacent,
  Dist_graph_neighbors. A topology comm re-runs coll's ``comm_select``
  (:func:`_attach`), so components install their neighbourhood slots.
- The eight neighbourhood entries, Neighbor_allgather / _alltoall /
  _allgatherv / _alltoallv and their ``I*`` forms. A numpy ``sendbuf``
  takes the host slots (coll/basic's linear round, coll/libnbc's
  schedule), filling ``recvbuf``; a tensor ``sendbuf`` with no ``recvbuf``
  takes the device slot (coll/device's one exchange, or coll/accelerator's
  staging where the device plane is down) and returns a new
  ``(n_in, *shape)`` tensor, row k from in-neighbour k (PROC_NULL rows
  zero); every rank calls, with blocks of one shape and dtype.
- :func:`cart_of_mesh`: the (dims, axis names) of a
  :class:`ompi_tpu_torch.parallel.Mesh`, whose Cart_sub groups are the
  mesh's axis sub-communicators.

Neighbour order follows the MPI standard: a cart's lists are (-1, +1) per
dimension in dimension order; a graph's its stored adjacency. PROC_NULL
neighbours (open boundaries) contribute nothing, and the host path
leaves their receive rows as they were.

Where the port differs: every check that raises ``ValueError`` in the
reference raises ``errors.MPIError`` (ERR_DIMS for a cart's dims,
ERR_TOPOLOGY for a graph or a call on the wrong kind of comm), and a
tensor given to a ``v`` form raises ``MPIError(ERR_NOT_SUPPORTED)`` (the
reference: NotImplementedError).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.comm import Communicator, UNDEFINED
from ompi_tpu_torch.pml.request import PROC_NULL


def dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> List[int]:
    """MPI_Dims_create: a balanced factorisation of ``nnodes`` over
    ``ndims`` (reference: ompi/mpi/c/dims_create.c). Nonzero entries of
    ``dims`` are fixed constraints."""
    out = list(dims) if dims is not None else [0] * ndims
    fixed = math.prod(d for d in out if d > 0) or 1
    if nnodes % fixed:
        raise errors.MPIError(
            errors.ERR_DIMS,
            f"Dims_create: {nnodes} not divisible by fixed dims {out}")
    rem = nnodes // fixed
    free = [i for i, d in enumerate(out) if d == 0]
    # greedy balance: each prime factor, largest first, goes to the
    # currently smallest free dim
    factors: List[int] = []
    n, p = rem, 2
    while p * p <= n:
        while n % p == 0:
            factors.append(p)
            n //= p
        p += 1
    if n > 1:
        factors.append(n)
    sizes = {i: 1 for i in free}
    for f in sorted(factors, reverse=True):
        if not free:
            break
        tgt = min(free, key=lambda i: sizes[i])
        sizes[tgt] *= f
    for i in free:
        out[i] = sizes[i]
    # MPI orders the free dims non-increasing
    vals = sorted((out[i] for i in free), reverse=True)
    for i, v in zip(free, vals):
        out[i] = v
    return out


class CartTopo:
    """A cartesian grid (row-major ranks, per-dim periodicity)."""

    kind = "cart"

    def __init__(self, dims: Sequence[int], periods: Sequence[bool]):
        self.dims = tuple(int(d) for d in dims)
        self.periods = tuple(bool(p) for p in periods)
        if len(self.dims) != len(self.periods):
            raise errors.MPIError(errors.ERR_DIMS,
                                  "dims/periods length mismatch")
        self.size = math.prod(self.dims) if self.dims else 1

    @property
    def ndims(self) -> int:
        return len(self.dims)

    def coords(self, rank: int) -> List[int]:
        """MPI_Cart_coords (row-major)."""
        c = []
        for d in reversed(self.dims):
            c.append(rank % d)
            rank //= d
        return list(reversed(c))

    def rank_of(self, coords: Sequence[int]) -> int:
        """MPI_Cart_rank: periodic dims wrap; out of range on an open dim
        is PROC_NULL."""
        if len(coords) != self.ndims:
            raise errors.MPIError(
                errors.ERR_DIMS,
                f"Cart_rank: {len(coords)} coords for {self.ndims} dims")
        r = 0
        for c, d, per in zip(coords, self.dims, self.periods):
            if not 0 <= c < d:
                if not per:
                    return PROC_NULL
                c %= d
            r = r * d + c
        return r

    def shift(self, rank: int, direction: int,
              disp: int = 1) -> Tuple[int, int]:
        """MPI_Cart_shift -> (source, dest)."""
        c = self.coords(rank)
        src = list(c)
        dst = list(c)
        src[direction] -= disp
        dst[direction] += disp
        return self.rank_of(src), self.rank_of(dst)

    def neighbors(self, rank: int) -> List[int]:
        """The MPI-standard cartesian neighbour order: per dim, (-1, +1)."""
        out = []
        for d in range(self.ndims):
            src, dst = self.shift(rank, d, 1)
            out.extend((src, dst))
        return out

    in_neighbors = neighbors
    out_neighbors = neighbors

    def route(self, src: int, dst: int) -> List[Tuple[int, int, int, int]]:
        """The minimal-hop dimension-ordered route src -> dst: the hops
        ``[(from_rank, to_rank, dim, step)]``, each dimension walked in
        turn by +/-1 steps, the wraparound direction taken on a periodic
        dim when it is strictly shorter (a tie goes the positive way)."""
        hops: List[Tuple[int, int, int, int]] = []
        cur = list(self.coords(src))
        tgt = self.coords(dst)
        here = src
        for d, size in enumerate(self.dims):
            delta = tgt[d] - cur[d]
            if self.periods[d] and size > 1:
                # the shortest signed distance on the ring; a tie -> +1
                delta = (delta + size // 2 - (size % 2 == 0)) \
                    % size - size // 2 + (size % 2 == 0)
            step = 1 if delta > 0 else -1
            for _ in range(abs(delta)):
                cur[d] += step
                nxt = self.rank_of(cur)
                hops.append((here, nxt, d, step))
                here = nxt
        return hops


class GraphTopo:
    """MPI_Graph_create's topology (the index / edges arrays)."""

    kind = "graph"

    def __init__(self, index: Sequence[int], edges: Sequence[int]):
        self.index = tuple(index)
        self.edges = tuple(edges)
        self.size = len(self.index)

    def neighbors(self, rank: int) -> List[int]:
        lo = self.index[rank - 1] if rank > 0 else 0
        return list(self.edges[lo:self.index[rank]])

    in_neighbors = neighbors
    out_neighbors = neighbors


class DistGraphTopo:
    """MPI_Dist_graph_create_adjacent's topology: this rank's directed
    in and out lists only."""

    kind = "dist_graph"

    def __init__(self, sources: Sequence[int],
                 destinations: Sequence[int]):
        self.sources = tuple(sources)
        self.destinations = tuple(destinations)

    def in_neighbors(self, rank: int) -> List[int]:
        return list(self.sources)

    def out_neighbors(self, rank: int) -> List[int]:
        return list(self.destinations)


# ---------------------------------------------------------------------------
# construction (attached to Communicator below)

def _attach(comm: Communicator, topo) -> Communicator:
    """Attach ``topo`` and re-stack the comm's coll table: components
    install their neighbourhood slots only on a topology comm (the
    reference re-selects at the end of topo_base_cart_create.c)."""
    from ompi_tpu_torch.coll import comm_select

    comm.topo = topo
    comm_select(comm)
    return comm


def _cart_size(dims, what: str, comm) -> int:
    n = math.prod(dims) if dims else 1
    if n > comm.size:
        raise errors.MPIError(
            errors.ERR_DIMS,
            f"{what}: cart size {n} exceeds comm size {comm.size}")
    return n


def _graph_size(index, what: str, comm) -> int:
    if len(index) > comm.size:
        raise errors.MPIError(
            errors.ERR_TOPOLOGY,
            f"{what}: graph size {len(index)} exceeds comm size "
            f"{comm.size}")
    return len(index)


def _Create_cart(self, dims: Sequence[int],
                 periods: Optional[Sequence[bool]] = None,
                 reorder: bool = False) -> Optional[Communicator]:
    """MPI_Cart_create. With ``reorder`` the stencil is placed on the
    ranks' device distances (:mod:`ompi_tpu_torch.topo.reorder`, the
    treematch analog); with no device plane the placement is the
    identity, as in the reference where no topology is known. Ranks
    beyond the grid get None."""
    dims = list(dims)
    periods = [False] * len(dims) if periods is None else list(periods)
    n = _cart_size(dims, "Create_cart", self)
    key = self.rank
    if reorder and n > 1 and self.rank < n:
        from ompi_tpu_torch.topo import reorder as reorder_mod

        perm = reorder_mod.permute_for(
            self, reorder_mod.cart_weights(dims, periods))
        if perm is not None:
            # perm[cart position] = the old rank that plays it
            key = perm.index(self.rank)
    sub = self.split(0 if self.rank < n else UNDEFINED, key=key)
    if sub is None:
        return None
    return _attach(sub, CartTopo(dims, periods))


def _Cart_sub(self, remain_dims: Sequence[bool]) -> Communicator:
    """MPI_Cart_sub: the sub-grids that keep ``remain_dims`` (colour: the
    dropped dims' coordinates; key: this rank, so the kept dims stay
    row-major), as a mesh's axis sub-communicator keeps its axes."""
    topo = self.topo
    if topo is None or topo.kind != "cart":
        raise errors.MPIError(errors.ERR_TOPOLOGY,
                              "Cart_sub on a non-cartesian communicator")
    remain = [bool(r) for r in remain_dims]
    color = 0
    for c, d, keep in zip(topo.coords(self.rank), topo.dims, remain):
        if not keep:
            color = color * d + c
    sub = self.split(color, key=self.rank)
    kept_dims = [d for d, keep in zip(topo.dims, remain) if keep]
    kept_per = [p for p, keep in zip(topo.periods, remain) if keep]
    return _attach(sub, CartTopo(kept_dims, kept_per))


def _Cart_coords(self, rank: Optional[int] = None) -> List[int]:
    return self.topo.coords(self.rank if rank is None else rank)


def _Cart_rank(self, coords: Sequence[int]) -> int:
    return self.topo.rank_of(coords)


def _Cart_shift(self, direction: int, disp: int = 1) -> Tuple[int, int]:
    return self.topo.shift(self.rank, direction, disp)


def _Cart_get(self):
    t = self.topo
    return list(t.dims), list(t.periods), t.coords(self.rank)


def _Create_graph(self, index: Sequence[int], edges: Sequence[int],
                  reorder: bool = False) -> Optional[Communicator]:
    """MPI_Graph_create (every rank passes the whole index / edges, as
    the standard defines). Ranks beyond the graph get None."""
    n = _graph_size(index, "Create_graph", self)
    sub = self.split(0 if self.rank < n else UNDEFINED, key=self.rank)
    if sub is None:
        return None
    return _attach(sub, GraphTopo(index, edges))


def _Create_dist_graph(self, sources: Sequence[int], degrees: Sequence[int],
                       destinations: Sequence[int],
                       reorder: bool = False) -> Communicator:
    """MPI_Dist_graph_create, the general form: any rank may contribute
    any edges (``sources[i]`` owns the next ``degrees[i]`` entries of
    ``destinations``); the contributions are gathered and redistributed
    into per-vertex adjacency, then placed as the adjacent form
    (topo_base_dist_graph_create.c)."""
    contrib = self.allgather(
        (list(sources), list(degrees), list(destinations)))
    outs = {r: [] for r in range(self.size)}
    ins = {r: [] for r in range(self.size)}
    for srcs, degs, dsts in contrib:
        i = 0
        for s, d in zip(srcs, degs):
            for dst in dsts[i:i + d]:
                outs[s].append(dst)
                ins[dst].append(s)
            i += d
    key = self.rank
    if reorder and self.size > 1:
        from ompi_tpu_torch.topo import reorder as reorder_mod

        w = np.zeros((self.size, self.size))
        for s in range(self.size):
            for d in outs[s]:
                w[s, d] += 1.0
        perm = reorder_mod.permute_for(self, w)
        if perm is not None:
            key = perm.index(self.rank)
    sub = self.split(0, key=key)
    return _attach(sub, DistGraphTopo(ins[key], outs[key]))


def _Create_dist_graph_adjacent(
        self, sources: Sequence[int], destinations: Sequence[int],
        reorder: bool = False) -> Communicator:
    """MPI_Dist_graph_create_adjacent: every rank gives its own in and
    out lists. With ``reorder`` the gathered graph is placed on the
    device distances, and a process moved to rank v takes the adjacency
    given for v (the lists name virtual ranks: MPI's reorder)."""
    key = self.rank
    if reorder and self.size > 1:
        from ompi_tpu_torch.topo import reorder as reorder_mod

        alladj = self.allgather((list(sources), list(destinations)))
        w = np.zeros((self.size, self.size))
        for r, (srcs, dsts) in enumerate(alladj):
            for s in srcs:
                w[s, r] += 1.0
            for d in dsts:
                w[r, d] += 1.0
        perm = reorder_mod.permute_for(self, w)
        if perm is not None:
            key = perm.index(self.rank)
            sources, destinations = alladj[key]
    sub = self.split(0, key=key)
    return _attach(sub, DistGraphTopo(sources, destinations))


def _Cart_map(self, dims: Sequence[int],
              periods: Optional[Sequence[bool]] = None) -> int:
    """MPI_Cart_map (topo_base_cart_map.c): the rank this process would
    have in the cart; the map is the identity, so ranks beyond the grid
    get UNDEFINED."""
    n = _cart_size(dims, "Cart_map", self)
    return self.rank if self.rank < n else UNDEFINED


def _Graph_map(self, index: Sequence[int], edges: Sequence[int]) -> int:
    """MPI_Graph_map (topo_base_graph_map.c)."""
    n = _graph_size(index, "Graph_map", self)
    return self.rank if self.rank < n else UNDEFINED


def _Graph_neighbors(self, rank: Optional[int] = None) -> List[int]:
    return self.topo.neighbors(self.rank if rank is None else rank)


def _Dist_graph_neighbors(self):
    t = self.topo
    return t.in_neighbors(self.rank), t.out_neighbors(self.rank)


# ---------------------------------------------------------------------------
# the neighbourhood collectives (dispatched into the coll table)

def _nbr_allgather_args(self, sendbuf, recvbuf, what):
    from ompi_tpu_torch.mpi import _parse_buf, _require_recvbuf

    _require_recvbuf(recvbuf, what)
    sarr, count, dt = _parse_buf(sendbuf)
    rarr, _, rdt = _parse_buf(recvbuf)
    # a receive-only rank's sendbuf is empty: the per-edge count comes
    # from the receive side, not count-0 (truncating) receives
    n_in = len(self.topo.in_neighbors(self.rank))
    if count == 0 and n_in:
        count = np.asarray(rarr).size // n_in
        dt = rdt
    return sarr, rarr, count, dt


def _nbr_alltoall_args(self, sendbuf, recvbuf, what):
    from ompi_tpu_torch.mpi import _parse_buf, _require_recvbuf

    _require_recvbuf(recvbuf, what)
    sarr, _, dt = _parse_buf(sendbuf)
    rarr = _parse_buf(recvbuf)[0]
    # the per-edge count from whichever side has edges
    n_out = len(self.topo.out_neighbors(self.rank))
    n_in = len(self.topo.in_neighbors(self.rank))
    if n_out:
        count = np.asarray(sarr).size // n_out
    elif n_in:
        count = np.asarray(rarr).size // n_in
    else:
        count = 0
    return sarr, rarr, count, dt


def _Neighbor_allgather(self, sendbuf, recvbuf=None):
    """A tensor: the device slot's new ``(n_in, *shape)`` tensor (copied
    into ``recvbuf`` too, where one is given)."""
    from ompi_tpu_torch.mpi import _deliver, _is_dev

    if _is_dev(sendbuf):
        return _deliver(self.coll.neighbor_allgather_dev(self, sendbuf),
                        recvbuf)
    sarr, rarr, count, dt = _nbr_allgather_args(
        self, sendbuf, recvbuf, "Neighbor_allgather")
    self.coll.neighbor_allgather(self, sarr, rarr, count, dt)


def _Ineighbor_allgather(self, sendbuf, recvbuf=None):
    """MPI_Ineighbor_allgather: ``recvbuf`` fills at completion."""
    sarr, rarr, count, dt = _nbr_allgather_args(
        self, sendbuf, recvbuf, "Ineighbor_allgather")
    return self.coll.ineighbor_allgather(self, sarr, rarr, count, dt)


def _Neighbor_alltoall(self, sendbuf, recvbuf=None):
    """A tensor of shape ``(n_out, *blk)``: the device slot's new
    ``(n_in, *blk)`` tensor."""
    from ompi_tpu_torch.mpi import _deliver, _is_dev

    if _is_dev(sendbuf):
        return _deliver(self.coll.neighbor_alltoall_dev(self, sendbuf),
                        recvbuf)
    sarr, rarr, count, dt = _nbr_alltoall_args(
        self, sendbuf, recvbuf, "Neighbor_alltoall")
    self.coll.neighbor_alltoall(self, sarr, rarr, count, dt)


def _Ineighbor_alltoall(self, sendbuf, recvbuf=None):
    """MPI_Ineighbor_alltoall."""
    sarr, rarr, count, dt = _nbr_alltoall_args(
        self, sendbuf, recvbuf, "Ineighbor_alltoall")
    return self.coll.ineighbor_alltoall(self, sarr, rarr, count, dt)


def _norm_cd(counts, displs):
    """(counts, displs) as ints, displs packed by default."""
    from ompi_tpu_torch.coll.basic import packed_displs

    counts = [int(c) for c in counts]
    return counts, (packed_displs(counts) if displs is None
                    else [int(d) for d in displs])


def _nbr_v_common(sendbuf, recvbuf, what):
    from ompi_tpu_torch.mpi import _is_dev, _parse_buf, _require_recvbuf

    if _is_dev(sendbuf):
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"{what} has no device route: pass numpy buffers (the uniform "
            "neighbourhood forms have one)")
    _require_recvbuf(recvbuf, what)
    sarr, count, dt = _parse_buf(sendbuf)
    rarr, _, rdt = _parse_buf(recvbuf)
    return sarr, rarr, count, dt or rdt


def _Neighbor_allgatherv(self, sendbuf, recvbuf, rcounts, rdispls=None):
    """MPI_Neighbor_allgatherv: ragged per-in-neighbour blocks (element
    counts and displacements; packed by default). Host buffers."""
    sarr, rarr, count, dt = _nbr_v_common(sendbuf, recvbuf,
                                          "Neighbor_allgatherv")
    rcounts, rdispls = _norm_cd(rcounts, rdispls)
    self.coll.neighbor_allgatherv(self, sarr, rarr, count, dt, rcounts,
                                  rdispls)


def _Ineighbor_allgatherv(self, sendbuf, recvbuf, rcounts, rdispls=None):
    """MPI_Ineighbor_allgatherv."""
    sarr, rarr, count, dt = _nbr_v_common(sendbuf, recvbuf,
                                          "Ineighbor_allgatherv")
    rcounts, rdispls = _norm_cd(rcounts, rdispls)
    return self.coll.ineighbor_allgatherv(self, sarr, rarr, count, dt,
                                          rcounts, rdispls)


def _Neighbor_alltoallv(self, sendbuf, recvbuf, scounts, rcounts,
                        sdispls=None, rdispls=None):
    """MPI_Neighbor_alltoallv: ragged per-edge segments (element units;
    packed by default). Host buffers."""
    sarr, rarr, _, dt = _nbr_v_common(sendbuf, recvbuf,
                                      "Neighbor_alltoallv")
    scounts, sdispls = _norm_cd(scounts, sdispls)
    rcounts, rdispls = _norm_cd(rcounts, rdispls)
    self.coll.neighbor_alltoallv(self, sarr, rarr, dt, scounts, sdispls,
                                 rcounts, rdispls)


def _Ineighbor_alltoallv(self, sendbuf, recvbuf, scounts, rcounts,
                         sdispls=None, rdispls=None):
    """MPI_Ineighbor_alltoallv."""
    sarr, rarr, _, dt = _nbr_v_common(sendbuf, recvbuf,
                                      "Ineighbor_alltoallv")
    scounts, sdispls = _norm_cd(scounts, sdispls)
    rcounts, rdispls = _norm_cd(rcounts, rdispls)
    return self.coll.ineighbor_alltoallv(self, sarr, rarr, dt, scounts,
                                         sdispls, rcounts, rdispls)


_API = {
    "Create_cart": _Create_cart,
    "Cart_sub": _Cart_sub,
    "Cart_coords": _Cart_coords,
    "Cart_rank": _Cart_rank,
    "Cart_shift": _Cart_shift,
    "Cart_get": _Cart_get,
    "Create_graph": _Create_graph,
    "Create_dist_graph": _Create_dist_graph,
    "Create_dist_graph_adjacent": _Create_dist_graph_adjacent,
    "Graph_neighbors": _Graph_neighbors,
    "Dist_graph_neighbors": _Dist_graph_neighbors,
    "Cart_map": _Cart_map,
    "Graph_map": _Graph_map,
    "Neighbor_allgather": _Neighbor_allgather,
    "Neighbor_alltoall": _Neighbor_alltoall,
    "Neighbor_allgatherv": _Neighbor_allgatherv,
    "Neighbor_alltoallv": _Neighbor_alltoallv,
    "Ineighbor_allgather": _Ineighbor_allgather,
    "Ineighbor_alltoall": _Ineighbor_alltoall,
    "Ineighbor_allgatherv": _Ineighbor_allgatherv,
    "Ineighbor_alltoallv": _Ineighbor_alltoallv,
}

for _name, _fn in _API.items():
    setattr(Communicator, _name, _fn)


def cart_of_mesh(mesh, axis_order: Optional[Sequence[str]] = None):
    """The (dims, axis names) of a device mesh: its host-plane cart has
    one dim per mesh axis, in the same order, with no periodicity."""
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    names = list(axis_order or mesh.axis_names)
    return [shape[n] for n in names], names
