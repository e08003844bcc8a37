"""The program's host spans as unions of intervals, for the span
readers: the spans of one name and subsystem in a rank's record, and
the length of a union, or of the overlap of two unions, inside a step."""

from __future__ import annotations

import bisect
from typing import Iterable, List, Tuple

from benchmark.lib import stats


def named(rec: dict, name: str, subsys: str) -> List[Tuple[float, float]]:
    """The [t0, t1) of a rank's spans called ``name`` in ``subsys``."""
    return [(s[2], s[3]) for s in rec["spans"]
            if s[0] == name and s[1] == subsys]


class Union:
    """The union of intervals as sorted disjoint intervals."""

    def __init__(self, intervals: Iterable[Tuple[float, float]]) -> None:
        self.iv = stats.merge(intervals)
        self._ends = [t1 for _, t1 in self.iv]

    def __bool__(self) -> bool:
        return bool(self.iv)

    def within(self, lo: float, hi: float) -> float:
        """Length of the union inside [lo, hi)."""
        total = 0.0
        i = bisect.bisect_right(self._ends, lo)
        while i < len(self.iv) and self.iv[i][0] < hi:
            t0, t1 = self.iv[i]
            total += min(t1, hi) - max(t0, lo)
            i += 1
        return total

    def __and__(self, other: "Union") -> "Union":
        """The intervals both unions cover."""
        out, i, j = [], 0, 0
        a, b = self.iv, other.iv
        while i < len(a) and j < len(b):
            t0, t1 = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
            if t0 < t1:
                out.append((t0, t1))
            if a[i][1] < b[j][1]:
                i += 1
            else:
                j += 1
        return Union(out)
