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
    order of same-location accumulates, so it is the reference's exactly."""
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
