"""Skew decomposition engine — wall time into wait vs transfer.

Given the clock-synced records of all ranks for a ``(cid, seq)``,
each rank's wall time inside the collective splits exactly:

- ``arrival_skew`` (aka exposed wait): ``latest_arrival - my_arrival``
  — time I spent waiting for stragglers, the part no algorithm or
  wire tuning can recover;
- ``transfer``: ``my_exit - latest_arrival`` — the collective
  actually moving data once everyone showed up (clamped at 0: a rank
  can observe its exit before the recorded last arrival by up to the
  clock error).

Each group's straggler (the last-arriving rank) has its lateness
attributed to compute vs comm by the gap since its previous
collective exit: a straggler whose time OUTSIDE collectives covers
at least half its lateness was doing compute (or injected delay —
the smoke lane's case); one that left its previous collective late
was dragged by communication upstream. The half bar (not 1.0×)
keeps the call stable when the outside gap and the lateness are the
same quantity measured on two clocks — the sleep-injected-straggler
shape, where scheduler jitter would otherwise flip it per step.

The per-step critical path chains the last-arriving rank of each
collective in seq order — the bounding rank sequence a pipeline
bubble analysis would walk. The persistent-straggler
verdict names any rank last into ≥ ``skew_straggler_pct`` of the
window's collectives, the monitoring hot-expert verdict shape.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.core import cvar, pvar

_pct_var = cvar.register(
    "skew_straggler_pct", 50.0, float,
    help="Persistent-straggler bar: a rank arriving last into at "
         "least this percentage of the window's collectives gets a "
         "named verdict (skew report, Finalize log line, "
         "skew_stragglers pvar).", level=7)

_window_var = cvar.register(
    "skew_window", 0, int,
    help="Collectives considered by the persistent-straggler verdict "
         "(most recent N groups; 0 = the whole merged window).",
    level=7)


def straggler_pct() -> float:
    return float(_pct_var.get())


def window() -> int:
    return int(_window_var.get())


def groups_of(per_rank: Dict[int, List[Dict[str, Any]]]
              ) -> List[Dict[str, Any]]:
    """Group shared-timebase records by ``(cid, seq)`` and decompose.

    ``per_rank`` maps rank -> record dicts (``seq/op/cid/nbytes/
    t0/t1`` in ns, already rebased into one timebase). Groups seen by
    fewer than two ranks carry no cross-rank information (ring drops,
    rank-local collectives) and are skipped. Returns seq-ordered
    group dicts."""
    by_key: Dict[Tuple[int, int], Dict[int, Dict[str, Any]]] = {}
    for rank, recs in per_rank.items():
        for rec in recs:
            by_key.setdefault(
                (int(rec["cid"]), int(rec["seq"])), {})[int(rank)] = rec
    # previous-exit lookup per rank (seq order) for cause attribution
    prev_exit: Dict[Tuple[int, int, int], int] = {}
    for rank, recs in per_rank.items():
        by_cid: Dict[int, List[Dict[str, Any]]] = {}
        for rec in recs:
            by_cid.setdefault(int(rec["cid"]), []).append(rec)
        for cid, rs in by_cid.items():
            rs.sort(key=lambda r: int(r["seq"]))
            for prev, cur in zip(rs, rs[1:]):
                prev_exit[(int(rank), cid, int(cur["seq"]))] = \
                    int(prev["t1"])
    groups: List[Dict[str, Any]] = []
    for (cid, seq), members in sorted(by_key.items(),
                                      key=lambda kv: (kv[0][1],
                                                      kv[0][0])):
        if len(members) < 2:
            continue
        last_rank = max(members, key=lambda r: int(members[r]["t0"]))
        last_arr = int(members[last_rank]["t0"])
        first_arr = min(int(m["t0"]) for m in members.values())
        ranks: Dict[int, Dict[str, int]] = {}
        for r, m in sorted(members.items()):
            t0, t1 = int(m["t0"]), int(m["t1"])
            ranks[r] = {
                "wall_ns": t1 - t0,
                "wait_ns": last_arr - t0,
                "transfer_ns": max(0, t1 - last_arr),
            }
        lateness = last_arr - first_arr
        gap = prev_exit.get((last_rank, cid, seq))
        if gap is None:
            cause = "unknown"
        else:
            cause = ("compute" if last_arr - gap >= lateness / 2
                     else "comm")
        groups.append({
            "cid": cid, "seq": seq,
            "op": members[last_rank].get("op", "?"),
            "nbytes": int(members[last_rank].get("nbytes", 0)),
            "last_rank": last_rank,
            "last_arrival_ns": last_arr,
            "arrival_skew_ns": lateness,
            "cause": cause,
            "ranks": ranks,
        })
    return groups


def critical_path(groups: List[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """The step's bounding rank sequence: the last-arriving rank of
    each collective, chained in seq order."""
    return [{"seq": g["seq"], "cid": g["cid"], "op": g["op"],
             "rank": g["last_rank"],
             "arrival_skew_ns": g["arrival_skew_ns"],
             "cause": g["cause"]}
            for g in sorted(groups, key=lambda g: (g["seq"],
                                                   g["cid"]))]


def verdict(groups: List[Dict[str, Any]],
            pct: Optional[float] = None,
            win: Optional[int] = None) -> List[Dict[str, Any]]:
    """Persistent stragglers over the (most recent) window: ranks
    last into >= pct% of the window's collectives, worst first. Each
    entry carries the rank's last-share, its dominant lateness cause
    (weighted by arrival skew, so a handful of big compute stalls
    outvotes many sub-ms barrier hops), and its summed arrival skew
    — everything the named verdict line renders."""
    pct = straggler_pct() if pct is None else float(pct)
    win = window() if win is None else int(win)
    ordered = sorted(groups, key=lambda g: (g["seq"], g["cid"]))
    if win > 0:
        ordered = ordered[-win:]
    if not ordered:
        return []
    last_counts: Dict[int, int] = {}
    causes: Dict[int, Dict[str, int]] = {}
    skew_sum: Dict[int, int] = {}
    for g in ordered:
        r = g["last_rank"]
        last_counts[r] = last_counts.get(r, 0) + 1
        c = causes.setdefault(r, {})
        # skew-weighted (+1 so zero-skew ties still count the cause)
        c[g["cause"]] = (c.get(g["cause"], 0) + 1
                         + g["arrival_skew_ns"])
        skew_sum[r] = skew_sum.get(r, 0) + g["arrival_skew_ns"]
    n = len(ordered)
    out = []
    for r, cnt in sorted(last_counts.items(),
                         key=lambda kv: -kv[1]):
        share = 100.0 * cnt / n
        if share < pct:
            continue
        cause = max(causes[r], key=causes[r].get)
        out.append({"rank": r, "last": cnt, "of": n,
                    "share_pct": round(share, 1),
                    "cause": cause,
                    "arrival_skew_ns": skew_sum[r]})
    return out


def exposed_wait(groups: List[Dict[str, Any]]) -> Dict[int, int]:
    """Per-rank summed exposed wait (ns) — the straggler tax each
    rank paid, the report's headline ranking."""
    out: Dict[int, int] = {}
    for g in groups:
        for r, cell in g["ranks"].items():
            out[int(r)] = out.get(int(r), 0) + int(cell["wait_ns"])
    return out


def per_op(groups: List[Dict[str, Any]]
           ) -> List[Dict[str, Any]]:
    """Per-op skew table: group count, mean/max arrival skew, summed
    exposed wait across all ranks."""
    accum: Dict[str, List[int]] = {}
    for g in groups:
        row = accum.setdefault(g["op"], [0, 0, 0, 0])
        row[0] += 1
        row[1] += g["arrival_skew_ns"]
        row[2] = max(row[2], g["arrival_skew_ns"])
        row[3] += sum(int(c["wait_ns"]) for c in g["ranks"].values())
    return [{"op": op, "n": row[0],
             "mean_skew_ns": row[1] // max(1, row[0]),
             "max_skew_ns": row[2], "wait_ns": row[3]}
            for op, row in sorted(accum.items())]


def analyze(per_rank: Dict[int, List[Dict[str, Any]]],
            clock_err_ns: int = 0,
            pct: Optional[float] = None,
            win: Optional[int] = None) -> Dict[str, Any]:
    """Full analysis doc over shared-timebase per-rank records: the
    decomposed groups, per-rank exposed-wait ranking, per-op table,
    critical path, persistent-straggler verdicts, and the timestamp
    error bar every one of those figures inherits."""
    groups = groups_of(per_rank)
    return {
        "schema": "ompi_tpu.skew/1+analysis",
        "nranks": len(per_rank),
        "collectives": len(groups),
        "clock_err_ns": int(clock_err_ns),
        "groups": groups,
        "exposed_wait_ns": {str(r): v for r, v in
                            sorted(exposed_wait(groups).items())},
        "per_op": per_op(groups),
        "critical_path": critical_path(groups),
        "stragglers": verdict(groups, pct=pct, win=win),
    }


def record_pvars(analysis: Dict[str, Any], rank: int) -> None:
    """Fold one rank's view of an analysis into the pvar plane:
    summed exposed wait for THIS rank, per-op wait (dynamic
    ``skew_op_wait_ns_<op>`` family — OpenMetrics folds it into a
    labelled family), the worst arrival skew seen (hwm), and the
    persistent-straggler count."""
    mine = int(analysis.get("exposed_wait_ns", {}).get(str(rank), 0))
    if mine:
        pvar.record("skew_exposed_wait_ns", mine)
    for row in analysis.get("per_op", ()):
        if row.get("wait_ns"):
            pvar.record("skew_op_wait_ns_%s" % row["op"],
                        int(row["wait_ns"]))
    worst = max((g["arrival_skew_ns"]
                 for g in analysis.get("groups", ())), default=0)
    pvar.record_hwm("skew_arrival_skew_ns", worst)
    n = len(analysis.get("stragglers", ()))
    if n:
        pvar.record("skew_stragglers", n)
