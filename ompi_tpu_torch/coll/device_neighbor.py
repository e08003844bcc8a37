"""coll/device's neighbourhood collectives — the halo exchange on the card.

The port's counterpart of ``ompi_tpu.coll.xla_neighbor`` (reference: the
coll framework's neighbourhood slots, ompi/mca/coll/coll.h:600-618). A
topology comm's tensor ``Neighbor_allgather`` / ``Neighbor_alltoall``
runs on the device plane: halo data never stages through the host.
coll/device installs these slots on topology comms only; coll/cuda has
none, so they fall through to coll/device as its other unsupported cases
do.

The contract is the reference's: every rank calls, with blocks of one
shape and dtype; row k of the result comes from in-neighbour k; a
PROC_NULL row is zeros; a ragged in-degree gives each rank its own row
count; ``neighbor_alltoall_dev`` raises ERR_COUNT when dim 0 of
``sendbuf`` is not the out-degree. The edges are paired as the reference
pairs them (:func:`_edges_allgather`; :func:`_edges_alltoall`, with a
cart's conjugate slots and a graph's first-in, first-out multi-edges; an
inconsistent dist graph raises ERR_TOPOLOGY on every rank). A dist graph
knows only its own lists, so :func:`_global_topo` allgathers every rank's
once and caches them on the comm.

Where the port differs, and why: the reference lowers the edges to
greedily edge-coloured ``lax.ppermute`` rounds (:func:`_color`), because
XLA's CollectivePermute must be a partial matching. ``Arena.exchange``
(:mod:`ompi_tpu_torch.coll.cuda`) has no such limit: it takes any set of
readers and sources in one host step. So the whole neighbourhood is one
exchange of the comm's ``perm`` arena: every rank stages its ``sendbuf``
once (allgather) or its out rows (alltoall), and lands each in-edge's
block into its result row with K2 (``ring_ag_hop``), one launch per
non-PROC_NULL in-edge. The bytes are the reference's; a dtype of any
kind moves bitwise (a byte copy). The arena's size class is the staged
bytes (the block, or the maximum out-degree times the row), which every
rank computes alike.

Each call counts one ``coll_device_launches`` (coll/xla's
``coll_xla_device``) and meters, where the monitoring plane is on, the
reference's per-peer bytes (:175-184, :238-249).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.coll import cuda as _cuda
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.monitoring import matrix as _mon
from ompi_tpu_torch.pml.request import PROC_NULL


class _GlobalAdj:
    """Every rank's (in, out) lists of a dist graph, from one cached
    allgather (its adjacency cannot change after creation)."""

    def __init__(self, ins, outs):
        self._ins, self._outs = ins, outs

    def in_neighbors(self, r):
        return self._ins[r]

    def out_neighbors(self, r):
        return self._outs[r]


def _global_topo(comm):
    topo = comm.topo
    if topo.kind != "dist_graph":
        return topo  # a cart or graph answers for any rank
    adj = comm.__dict__.get("_coll_device_nbr_adj")
    if adj is None:
        gathered = comm.allgather((list(topo.in_neighbors(comm.rank)),
                                   list(topo.out_neighbors(comm.rank))))
        adj = comm._coll_device_nbr_adj = _GlobalAdj(
            [g[0] for g in gathered], [g[1] for g in gathered])
    return adj


def _edges_allgather(topo, n: int):
    """Directed edges (src, dst, dst_slot): dst receives src's whole
    ``sendbuf`` into row dst_slot (src's place in dst's in-list;
    PROC_NULL slots stay holes); and the largest in-degree."""
    edges = []
    max_in = 0
    for d in range(n):
        nbrs = topo.in_neighbors(d)
        max_in = max(max_in, len(nbrs))
        for slot, s in enumerate(nbrs):
            if s != PROC_NULL:
                edges.append((s, d, slot))
    return edges, max_in


def _edges_alltoall(topo, n: int):
    """Directed edges (src, dst, src_slot, dst_slot): src sends its row
    src_slot into dst's row dst_slot; the largest in- and out-degrees.

    A cart pairs conjugate slots (in-slot j with the peer's out-slot
    j ^ 1: the (d, -1) in-edge is the peer's (d, +1) out-edge, which a
    periodic dim of size 2 needs, as coll/basic's conjugate tags); a
    graph or dist graph pairs multi-edges occurrence by occurrence (the
    standard's posted-order matching)."""
    is_cart = getattr(topo, "kind", None) == "cart"
    out_slots: Dict[Tuple[int, int], List[int]] = {}
    max_out = 0
    for s in range(n):
        outs = topo.out_neighbors(s)
        max_out = max(max_out, len(outs))
        for j, d in enumerate(outs):
            if d != PROC_NULL:
                out_slots.setdefault((s, d), []).append(j)
    edges = []
    max_in = 0
    for d in range(n):
        ins = topo.in_neighbors(d)
        max_in = max(max_in, len(ins))
        for slot, s in enumerate(ins):
            if s == PROC_NULL:
                continue
            if is_cart:
                edges.append((s, d, slot ^ 1, slot))
                continue
            q = out_slots.get((s, d))
            if not q:
                raise errors.MPIError(
                    errors.ERR_TOPOLOGY,
                    f"inconsistent topology: rank {d} lists {s} as an "
                    f"in-neighbor more times than {s} lists {d} outbound")
            edges.append((s, d, q.pop(0), slot))
    return edges, max_in, max_out


def _color(edges) -> List[list]:
    """The reference's greedy partition of directed edges into partial
    matchings (unique sources and destinations a round): one
    ``lax.ppermute`` each there. Here only a schedule to compare the one
    exchange with (``examples/neighbor_halo.py``)."""
    remaining = list(edges)
    rounds = []
    while remaining:
        used_s, used_d, rnd, rest = set(), set(), [], []
        for e in remaining:
            if e[0] in used_s or e[1] in used_d:
                rest.append(e)
            else:
                used_s.add(e[0])
                used_d.add(e[1])
                rnd.append(e)
        rounds.append(rnd)
        remaining = rest
    return rounds


def _exchange(comm, blocks, arena_bytes: int, rowbytes: int, edges,
              out) -> None:
    """One ``Arena.exchange`` of the comm's ``perm`` arena of
    ``arena_bytes`` (the same on every rank): this rank stages
    ``blocks`` (a 1-D uint8 tensor) and, for each edge (src, dst,
    src_off, dst_row) into it, K2-copies ``rowbytes`` at ``src_off`` of
    src's region into row ``dst_row`` of ``out``. Readers and sources
    come from the same global edge list on every rank."""
    r = comm.rank
    mine = [e for e in edges if e[1] == r]
    readers = sorted({e[1] for e in edges if e[0] == r})
    sources = sorted({e[0] for e in mine})
    flat = out.view(out.shape[0], -1).view(torch.uint8) \
        if out.numel() else None

    def stage(region):
        region[:blocks.numel()].copy_(blocks)

    def land(regions):
        for s, _, off, row in mine:
            K.ring_ag_hop(regions[s][off:off + rowbytes], flat[row])
    ep = _cuda._arena(comm, "perm", arena_bytes)
    ep.exchange(stage, readers, land, sources)


def _meter(tm, kind: str, comm, topo, sendbuf, row_bytes: float) -> None:
    per: Dict[int, float] = {}
    for p in topo.out_neighbors(comm.rank):
        if p != PROC_NULL:
            per[p] = per.get(p, 0.0) + row_bytes
    from ompi_tpu_torch.coll.device import _dtype_name

    tm.coll(kind, comm, sendbuf.nbytes, per_peer=per,
            dtype=_dtype_name(sendbuf.dtype))


def neighbor_allgather_dev(comm, sendbuf):
    """MPI_Neighbor_allgather on the device plane: a new
    ``(n_in, *sendbuf.shape)`` tensor, row k in-neighbour k's
    ``sendbuf`` (zeros for a PROC_NULL row)."""
    from ompi_tpu_torch.coll.device import _check_buf

    _check_buf("neighbor_allgather", comm, sendbuf, any_dtype=True)
    pvar.record("coll_device_launches")
    topo = _global_topo(comm)
    tm = _mon.TRAFFIC
    if tm is not None:
        # graph edges, not an algorithm's model: the whole sendbuf to
        # every out-neighbour
        _meter(tm, "neighbor_allgather", comm, topo, sendbuf,
               sendbuf.nbytes)
    n_in = len(topo.in_neighbors(comm.rank))
    out = torch.zeros((n_in,) + tuple(sendbuf.shape), dtype=sendbuf.dtype,
                      device=sendbuf.device)
    nbytes = sendbuf.nbytes
    if nbytes:
        edges, _ = _edges_allgather(topo, comm.size)
        _exchange(comm, sendbuf.contiguous().view(-1).view(torch.uint8),
                  nbytes, nbytes, [(s, d, 0, slot) for s, d, slot in edges],
                  out)
    return out


def neighbor_alltoall_dev(comm, sendbuf):
    """MPI_Neighbor_alltoall on the device plane: ``sendbuf`` rows are
    per-out-neighbour blocks (row j to out-neighbour j); a new
    ``(n_in, *blk)`` tensor, row k from in-neighbour k (PROC_NULL rows
    send nowhere and stay zero)."""
    from ompi_tpu_torch.coll.device import _check_buf

    _check_buf("neighbor_alltoall", comm, sendbuf, any_dtype=True)
    topo = _global_topo(comm)
    my_out = len(topo.out_neighbors(comm.rank))
    my_in = len(topo.in_neighbors(comm.rank))
    if sendbuf.dim() < 1 or sendbuf.shape[0] != my_out:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"neighbor_alltoall: sendbuf dim 0 of shape "
            f"{tuple(sendbuf.shape)} != out-degree {my_out}")
    pvar.record("coll_device_launches")
    blk = tuple(sendbuf.shape[1:])
    rowbytes = sendbuf.element_size()
    for d in blk:
        rowbytes *= d
    tm = _mon.TRAFFIC
    if tm is not None:
        # one sendbuf row per out-neighbour (PROC_NULL rows go nowhere)
        _meter(tm, "neighbor_alltoall", comm, topo, sendbuf,
               sendbuf.nbytes / my_out if my_out else 0.0)
    edges, _, max_out = _edges_alltoall(topo, comm.size)
    out = torch.zeros((my_in,) + blk, dtype=sendbuf.dtype,
                      device=sendbuf.device)
    if rowbytes and max_out:
        _exchange(comm, sendbuf.contiguous().view(-1).view(torch.uint8)
                  if my_out else sendbuf.new_empty(0, dtype=torch.uint8),
                  max_out * rowbytes, rowbytes,
                  [(s, d, j * rowbytes, slot) for s, d, j, slot in edges],
                  out)
    return out


def slots(comm) -> dict:
    """The neighbourhood device slots, on topology comms only (the
    reference installs them at topo-comm creation, coll.h:600-618)."""
    if getattr(comm, "topo", None) is None:
        return {}
    return {"neighbor_allgather_dev": neighbor_allgather_dev,
            "neighbor_alltoall_dev": neighbor_alltoall_dev}
