"""osc/device_epoch — what the fence epochs share, reduced.

The port's counterpart of ``ompi_tpu.osc.device_epoch`` reduced to what
:mod:`ompi_tpu_torch.osc.cuda` uses: the :class:`GetHandle` of a
fence-epoch Get and the port's own copy of the edge colouring
(``ompi_tpu.coll.xla_neighbor._color``, xla_neighbor.py:127-144). The
``DeviceEpochWindow`` itself comes in a later slice (ROADMAP queue 1,
item 7).
"""

from __future__ import annotations

from typing import List


class GetHandle:
    """Result handle for an epoch Get: ``.array`` is a fresh device tensor
    after the closing Fence (never a view of an arena slot, which the next
    round reuses)."""

    __slots__ = ("array",)

    def __init__(self) -> None:
        self.array = None


def _color(edges) -> List[list]:
    """Greedy partition of directed edges ``(src, dst, ...)`` into partial
    matchings (unique src and unique dst per round), first fit in edge
    order — each round is one valid permutation. The order decides the
    order of same-location accumulates, so it is the reference's exactly:
    its passes (each pass takes, in order, every remaining edge whose src
    and dst the pass has not used yet) give every edge the smallest round
    that neither its src nor its dst uses among earlier edges, which is
    what this computes in one pass, with a per-endpoint floor below which
    every round is taken (the 2048 updates of one owner take 2048 rounds:
    the reference's passes cost quadratic time there)."""
    used: dict = {}  # ("s", src) / ("d", dst) -> rounds it takes
    floor: dict = {}  # the same keys -> every round below is taken
    rounds: List[list] = []
    for e in edges:
        ks, kd = ("s", e[0]), ("d", e[1])
        us, ud = used.setdefault(ks, set()), used.setdefault(kd, set())
        c = max(floor.get(ks, 0), floor.get(kd, 0))
        while c in us or c in ud:
            c += 1
        us.add(c)
        ud.add(c)
        for k, u in ((ks, us), (kd, ud)):
            f = floor.get(k, 0)
            while f in u:
                f += 1
            floor[k] = f
        if c == len(rounds):
            rounds.append([])
        rounds[c].append(e)
    return rounds
