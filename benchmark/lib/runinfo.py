"""What a run collected, as the metric readers see it.

``Run`` holds the cell's files, the harness's own clock readings and
every rank's record (``rank<r>.json`` of the driver). Readers of the
device metrics take a card's profiled window and its device operations,
all on the host's monotonic clock (:mod:`benchmark.lib.devtrace`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark.lib import stats


class Run:
    def __init__(self, files: dict, ranks: List[dict], launch_mono: float,
                 chips: int, trace: bool) -> None:
        self.cell = files["cell"]
        self.config = files["config"]
        self.traffic = files["traffic"]
        self.ranks = sorted(ranks, key=lambda x: x["rank"])
        self.launch_mono = launch_mono
        self.chips = chips
        self.trace = trace

    @property
    def lead(self) -> dict:
        return self.ranks[0]

    def cards(self) -> Dict[int, List[dict]]:
        out: Dict[int, List[dict]] = {}
        for rec in self.ranks:
            out.setdefault(rec["card"], []).append(rec)
        return out

    def card_window(self, recs) -> Optional[Tuple[float, float]]:
        """[first start, last stop] of the card's ranks' profiled spans,
        ns; None without a device trace."""
        spans = [r["prof_span"] for r in recs
                 if r.get("prof_span") and r.get("dev_trace")
                 and r["prof_span"][1] is not None]
        if len(spans) != len(recs):
            return None
        return min(s[0] for s in spans), max(s[1] for s in spans)

    def card_ops(self, recs) -> List[list]:
        return [op for r in recs for op in r["dev_trace"]["ops"]]

    def prof_steps(self) -> Optional[int]:
        p = self.lead.get("prof_steps")
        return None if not p else p[1] - p[0]

    def phase_step_s(self) -> Dict[str, float]:
        """Rank 0's seconds a step in each phase of a traced run, named by
        the instruments on (``none`` first); the first step of a later
        phase, which holds the profiler's start or stop, left out."""
        lead = self.lead
        k0 = lead.get("plain_steps") or 0
        k1 = lead["after"]["step"] if lead.get("after") else lead["steps"]
        parts = lead.get("trace_parts", [])
        out = {}
        for name, a, b in (("none", 0, k0),
                           ("+".join(parts), k0 + 1, k1),
                           ("+".join(p for p in parts if p != "profiler")
                            or "none", k1 + 1, lead["steps"])):
            xs = lead["step_s"][a:b]
            if xs:
                out[name if name not in out else name + " (after)"] = \
                    sum(xs) / len(xs)
        return out

    def counted(self, rec) -> dict:
        """The steps and counters a host layer's metric reads: a traced
        run's last phase (recorder alone), else the whole window."""
        return rec.get("after") or rec

    def busy(self) -> Optional[Tuple[float, float]]:
        """Mean over cards of (seconds some device operation ran, length
        of the profiled window)."""
        busy, win = [], []
        for recs in self.cards().values():
            w = self.card_window(recs)
            if w is None:
                return None
            busy.append(stats.covered(((o[1], o[2]) for o in
                                       self.card_ops(recs)), *w) / 1e9)
            win.append((w[1] - w[0]) / 1e9)
        return sum(busy) / len(busy), sum(win) / len(win)

    def step_spans(self, rec) -> List[Tuple[float, float]]:
        """The driver's step spans; of a traced run, its last phase's
        (the recorder alone)."""
        t0 = (rec.get("after") or {}).get("t0_ns", 0)
        return [(s[2], s[3]) for s in rec["spans"]
                if s[0] == "step" and s[1] == "bench" and s[2] >= t0]

    def coll_spans(self, rec) -> List[Tuple[float, float]]:
        """Host spans of the port's collective layer: its ``launch``
        spans and the MPI API's entry-to-exit spans."""
        return [(s[2], s[3]) for s in rec["spans"]
                if s[0] == "launch" or s[1] == "api"]
