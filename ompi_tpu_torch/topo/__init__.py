"""Process topologies — the cartesian part of :mod:`ompi_tpu.topo`.

Reference: ompi/mca/topo/ (topo_base_cart_create.c) and the JAX
package's ``ompi_tpu/topo/__init__.py:32-155``. This slice carries
:func:`dims_create` (MPI_Dims_create) and :class:`CartTopo`, the grid
arithmetic (coordinates, ranks, shifts, neighbours and the
dimension-ordered minimal-hop route) that the monitoring plane's level-2
link attribution walks (:mod:`ompi_tpu_torch.monitoring.links`). The
communicator constructors (Cart_create, Graph_create, Dist_graph_create,
Cart_sub), the graph topologies and the neighbourhood collectives come
with the rest of the topo framework (ROADMAP queue 1 item 4f).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from ompi_tpu_torch.pml.request import PROC_NULL


def dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> List[int]:
    """MPI_Dims_create: a balanced factorisation of ``nnodes`` over
    ``ndims`` (reference: ompi/mpi/c/dims_create.c). Nonzero entries of
    ``dims`` are fixed constraints."""
    out = list(dims) if dims is not None else [0] * ndims
    fixed = math.prod(d for d in out if d > 0) or 1
    if nnodes % fixed:
        raise ValueError(
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
            raise ValueError("dims/periods length mismatch")
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
            raise ValueError(
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
