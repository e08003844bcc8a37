"""Topology-aware rank reordering — the treematch analog.

The port's copy of ``ompi_tpu.topo.reorder`` (reference:
ompi/mca/topo/treematch/ maps a communication graph onto the hardware
topology tree when MPI_Cart_create / MPI_Dist_graph_create get
``reorder=1``). Reordering places the graph's vertices on the ranks'
device coordinates so heavy edges land on near devices: a greedy
affinity placement (Cuthill-McKee order onto the sorted slots) polished
by pairwise swaps, deterministic, ties broken on the lowest index. Every
rank computes the same placement from the same inputs, so no round
beyond the graph itself is needed. :func:`place`, :func:`_refine`,
:func:`cart_weights` and :func:`permute_for` are the reference's.

The coordinates (:func:`rank_coords`) state the card's real distances:

- on the CPU plane each rank has its own position on a line (its index
  in its world), as the reference's CPU plane gives each rank one virtual
  device whose id orders the line;
- on CUDA, ranks that share a card share a coordinate, and cards under
  one NVSwitch are equidistant: a card's coordinate is its one-hot
  vector, so two cards are 2 apart and a card 0 from itself.

A placement where every distance is zero cannot lower the cost, so
:func:`permute_for` keeps the identity there (every rank on one shared
card); with no device plane there are no coordinates and reorder stays a
hint (identity), as in the reference.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


def rank_coords(comm) -> Optional[List[Tuple[int, ...]]]:
    """The device coordinates of each comm rank, or None with no device
    plane (or a member whose device this world does not know)."""
    from ompi_tpu_torch.runtime import device_plane, rte

    if not device_plane.active():
        return None
    devs = []
    for w in comm.group.ranks:
        d = device_plane.device_for_world_rank(w)
        if d is None:
            return None
        devs.append((w, d))
    if all(d.type != "cuda" for _, d in devs):
        return [(w - rte.world_offset,) for w, _ in devs]
    cards = 1 + max(d.index or 0 for _, d in devs)
    return [tuple(int(i == (d.index or 0)) for i in range(cards))
            for _, d in devs]


def _dist(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
    return int(sum(abs(x - y) for x, y in zip(a, b)))


def place(weights: np.ndarray,
          coords: Sequence[Tuple[int, ...]]) -> List[int]:
    """Greedy affinity placement: ``perm[vertex]`` = the slot (index into
    ``coords``; slot i is the process holding comm rank i). Minimises the
    sum over edges of weight x manhattan distance, treematch's objective
    on a mesh metric. Deterministic: ties break on the lowest index."""
    n = len(coords)
    w = np.asarray(weights, dtype=np.float64)
    assert w.shape == (n, n)
    w = w + w.T  # symmetric: the cost counts both directions
    # slots sorted along the mesh; vertices in a weighted Cuthill-McKee
    # BFS order from a peripheral (lightest) vertex, so graph
    # neighbourhoods become slot neighbourhoods
    slot_order = sorted(range(n), key=lambda s: coords[s])
    deg = w.sum(axis=1)
    visited: List[int] = []
    remaining = set(range(n))
    while remaining:
        start = min(remaining, key=lambda v: (deg[v], v))
        remaining.discard(start)
        queue = [start]
        while queue:
            v = queue.pop(0)
            visited.append(v)
            nbrs = sorted((u for u in remaining if w[v, u] > 0),
                          key=lambda u: (-w[v, u], u))
            for u in nbrs:
                remaining.discard(u)
                queue.append(u)
    perm = [0] * n
    for v, s in zip(visited, slot_order):
        perm[v] = s
    return _refine(perm, w, coords)


def _refine(perm: List[int], w: np.ndarray,
            coords: Sequence[Tuple[int, ...]]) -> List[int]:
    """Pairwise-swap local search: swap two vertices' slots while the
    total weighted distance drops."""
    n = len(perm)

    def vertex_cost(v: int, p: List[int]) -> float:
        cv = coords[p[v]]
        return sum(w[v, u] * _dist(cv, coords[p[u]])
                   for u in range(n) if u != v)

    improved = True
    while improved:
        improved = False
        for a in range(n):
            for b in range(a + 1, n):
                before = vertex_cost(a, perm) + vertex_cost(b, perm) \
                    - 2 * w[a, b] * _dist(coords[perm[a]],
                                          coords[perm[b]])
                perm[a], perm[b] = perm[b], perm[a]
                after = vertex_cost(a, perm) + vertex_cost(b, perm) \
                    - 2 * w[a, b] * _dist(coords[perm[a]],
                                          coords[perm[b]])
                if after < before - 1e-12:
                    improved = True
                else:
                    perm[a], perm[b] = perm[b], perm[a]
    return perm


def cart_weights(dims: Sequence[int],
                 periods: Sequence[bool]) -> np.ndarray:
    """The unit-weight stencil adjacency of a cartesian grid (every
    neighbour pair exchanges alike in a halo)."""
    n = math.prod(dims) if dims else 1
    w = np.zeros((n, n))

    def coords_of(r):
        out = []
        for d in reversed(dims):
            out.append(r % d)
            r //= d
        return list(reversed(out))

    def rank_of(c):
        r = 0
        for x, d in zip(c, dims):
            r = r * d + x
        return r

    for r in range(n):
        c = coords_of(r)
        for dim, (d, per) in enumerate(zip(dims, periods)):
            for step in (-1, 1):
                c2 = list(c)
                c2[dim] += step
                if per:
                    c2[dim] %= d
                elif not 0 <= c2[dim] < d:
                    continue
                w[r, rank_of(c2)] = 1.0
    return w


def permute_for(comm, weights: np.ndarray) -> Optional[List[int]]:
    """``perm[vertex]`` = the comm rank that should play that vertex, or
    None for the identity: no coordinates, or all of them equal."""
    coords = rank_coords(comm)
    if coords is None or len(coords) < weights.shape[0]:
        return None
    coords = coords[:weights.shape[0]]
    if len(set(coords)) == 1:
        return None
    return place(weights, coords)
