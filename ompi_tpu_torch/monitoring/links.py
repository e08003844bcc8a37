"""ICI link attribution — matrix cells onto torus links (the port of
:mod:`ompi_tpu.monitoring.links`; plain Python, the port's own copy).

Level 2 of the monitoring plane: every (src, dst) byte cell is walked
along its dimension-ordered minimal-hop route on the job's torus
(the port's ``topo.CartTopo.route``), and each traversed hop charges its bytes
to the undirected physical link it rides. The mesh shape comes from
``parallel.mesh.mesh_shape_for`` — the same near-square factorization
the device plane builds its meshes with — so host-side attribution
names the links of the mesh the device collectives run over. On one card
the "links" are the model's, not NVLink's: the names are the reference's,
so merged reports compare across the two packages.

Link identity is ``(dim, lo_rank, hi_rank)`` (undirected: both
directions of a bidirectional ICI link aggregate onto one counter,
which is how hotspots present — a saturated link hurts both ways).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Link = Tuple[int, int, int]  # (dim, lo_rank, hi_rank)


def link_name(link: Link) -> str:
    d, a, b = link
    return f"d{d}:r{a}-r{b}"


class LinkMap:
    """Routing + per-link aggregation over one torus shape."""

    def __init__(self, dims: Sequence[int],
                 periods: Optional[Sequence[bool]] = None):
        from ompi_tpu_torch.topo import CartTopo

        dims = [int(d) for d in dims if int(d) > 1] or [1]
        if periods is None:
            periods = [True] * len(dims)  # ICI axes are rings
        self.topo = CartTopo(dims, periods)
        self.dims = self.topo.dims
        self.n = self.topo.size
        self._routes: Dict[Tuple[int, int], List[Link]] = {}

    @classmethod
    def for_world(cls, n: int) -> "LinkMap":
        """The LinkMap of an n-rank job: same near-square 2D torus
        factorization the device plane uses (1D ring below 4)."""
        from ompi_tpu_torch.parallel.mesh import mesh_shape_for

        return cls(mesh_shape_for(n, 2 if n >= 4 else 1))

    def route(self, src: int, dst: int) -> List[Link]:
        """The undirected links the src->dst route traverses
        (memoized — the route table is static for the job)."""
        key = (src, dst)
        got = self._routes.get(key)
        if got is None:
            got = [(d, min(a, b), max(a, b))
                   for a, b, d, _step in self.topo.route(src, dst)]
            self._routes[key] = got
        return got

    def neighbors(self, rank: int) -> List[int]:
        """Distinct ICI neighbors of `rank` (the watchdog names these
        next to the hottest link in a hang dump)."""
        out: List[int] = []
        for p in self.topo.neighbors(rank):
            if p >= 0 and p != rank and p not in out:
                out.append(p)
        return out

    def charge(self, loads: Dict[Link, float], src: int, dst: int,
               nbytes: float) -> None:
        """Charge `nbytes` of src->dst traffic onto every link of its
        route."""
        if src == dst or not 0 <= dst < self.n or not 0 <= src < self.n:
            return
        for link in self.route(src, dst):
            loads[link] = loads.get(link, 0.0) + nbytes

    @staticmethod
    def imbalance(loads: Dict[Link, float]) -> float:
        """max/mean link load — 1.0 is perfectly balanced; the gauge
        the plane exports as monitoring_link_imbalance_permille."""
        if not loads:
            return 0.0
        vals = list(loads.values())
        mean = sum(vals) / len(vals)
        return max(vals) / mean if mean > 0 else 0.0

    @staticmethod
    def hottest(loads: Dict[Link, float],
                top: int = 1) -> List[Tuple[Link, float]]:
        return sorted(loads.items(), key=lambda kv: (-kv[1], kv[0]))[:top]


def sum_links(parts: Iterable[Dict[Link, float]]) -> Dict[Link, float]:
    """Merge per-rank link loads (send-side charging means each rank
    contributes its own outbound routes; summing gives the job view)."""
    out: Dict[Link, float] = {}
    for p in parts:
        for link, v in p.items():
            out[link] = out.get(link, 0.0) + v
    return out
