"""Statistics over a run's samples and unions of time intervals."""

from __future__ import annotations

from typing import Iterable, List, Tuple


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                   float]]:
    """Union of [t0, t1) intervals as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def covered(intervals: Iterable[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi)."""
    return sum(max(0.0, min(t1, hi) - max(t0, lo))
               for t0, t1 in merge(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for t0, t1 in merge(intervals):
        if t1 <= lo or t0 >= hi:
            continue
        if t0 > cur:
            out.append((cur, min(t0, hi)))
        cur = max(cur, t1)
    if cur < hi:
        out.append((cur, hi))
    return out
