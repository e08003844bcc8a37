"""Crossover + regression analysis over PerfDB stats.

Three consumers of the same aggregated table:

- :func:`crossovers` — measured cuda-vs-device and hier-vs-flat
  comparisons per ``(op, dtype, mesh, log2-size)``: which provider/
  algorithm actually won, by how much (p50 ratio), only where BOTH
  arms were observed (no extrapolation).
- :func:`candidate_tables` — ready-to-ingest switchpoint suggestions
  in the exact JSON entry shapes ``coll/cuda._switchpoint`` and
  ``coll/hier._switchpoint`` parse (``{op, dtype, mesh, log2,
  algorithm}``; largest log2 <= the payload's bucket wins). These are
  SUGGESTIONS — the observatory reports, it never self-applies; a
  human (or a later explore/exploit PR) points the ``coll_*_
  switchpoints`` cvars at them.
- :func:`regressions` — current run vs the stored baseline DB, named
  verdicts ("allreduce float32 2^24 on 2x2 [hier/hier]: p50 1.8x
  slower than PerfDB baseline") for keys whose p50 degraded past
  ``tune_regress_threshold``.

Quantiles come from the log2 latency histograms (bin midpoints, the
OpenMetrics exposition's ``_bin_mid`` convention) — approximate by
design, stable under the associative merge.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Key = Tuple[str, str, int, Tuple[int, ...], str, str]


def _bin_mid(b: int) -> float:
    """Representative value for log2 bin b (midpoint of
    [2^(b-1), 2^b); b=0 holds exact zeros)."""
    if b <= 0:
        return 0.0
    if b == 1:
        return 1.0
    return 3.0 * 2.0 ** (b - 2)


def quantile(hist: Dict[int, int], q: float) -> float:
    """Approximate q-quantile of a log2 histogram."""
    total = sum(hist.values())
    if total <= 0:
        return 0.0
    want = q * total
    cum = 0
    for b in sorted(hist):
        cum += hist[b]
        if cum >= want:
            return _bin_mid(b)
    return _bin_mid(max(hist))


def summarize(rec: list) -> Dict[str, float]:
    """count/mean/p50/p99 (+ min/max) for one stats record."""
    count = int(rec[0])
    return {
        "count": count,
        "mean_ns": rec[1] / count if count else 0.0,
        "min_ns": int(rec[2]),
        "max_ns": int(rec[3]),
        "p50_ns": quantile(rec[4], 0.50),
        "p99_ns": quantile(rec[4], 0.99),
    }


def _size_of(mesh) -> int:
    size = 1
    for d in mesh:
        size *= int(d)
    return size


def _arms(stats: Dict[Key, list]):
    """Group stats by (op, dtype, mesh-device-product, log2); each
    group holds the (provider, algorithm, mesh, summary) arms that
    served that shape. Product-of-mesh matching is what lets the flat
    1-D arm (mesh ``(n,)``) line up against the hier 2-D arm (mesh
    ``(n_dcn, n_ici)``) on the same communicator size."""
    groups: Dict[Tuple[str, str, int, int], list] = {}
    for (op, dt, lg, mesh, prov, algo), rec in stats.items():
        size = _size_of(mesh)
        groups.setdefault((op, dt, size, lg), []).append(
            (prov, algo, mesh, summarize(rec)))
    return groups


#: the two measured comparisons (the reference's pallas-vs-xla is the
#: port's cuda-vs-device: coll/cuda's kernels against coll/device's
#: schedules, which serve when coll/cuda falls through)
_PAIRS = (("cuda-vs-device", "cuda", "device"),
          ("hier-vs-flat", "hier", "device"))


def crossovers(stats: Dict[Key, list]) -> List[Dict[str, object]]:
    """Per-key measured winners where both arms of a pair ran."""
    rows: List[Dict[str, object]] = []
    for (op, dt, size, lg), arms in sorted(_arms(stats).items()):
        by_prov: Dict[str, Tuple[str, Tuple[int, ...], dict]] = {}
        for prov, algo, mesh, summ in arms:
            best = by_prov.get(prov)
            if best is None or summ["p50_ns"] < best[2]["p50_ns"]:
                by_prov[prov] = (algo, mesh, summ)
        for pair, a, b in _PAIRS:
            if a not in by_prov or b not in by_prov:
                continue
            (algo_a, mesh_a, sa) = by_prov[a]
            (algo_b, mesh_b, sb) = by_prov[b]
            a_wins = sa["p50_ns"] <= sb["p50_ns"]
            win, lose = ((a, algo_a, mesh_a, sa),
                         (b, algo_b, mesh_b, sb))
            if not a_wins:
                win, lose = lose, win
            slow = max(lose[3]["p50_ns"], 1e-9)
            fast = max(win[3]["p50_ns"], 1e-9)
            rows.append({
                "pair": pair, "op": op, "dtype": dt,
                "size": size, "log2": lg,
                "winner": win[0], "winner_algorithm": win[1],
                "winner_mesh": list(win[2]),
                "winner_p50_ns": win[3]["p50_ns"],
                "loser": lose[0], "loser_algorithm": lose[1],
                "loser_p50_ns": lose[3]["p50_ns"],
                "speedup": slow / fast,
            })
    return rows


def candidate_tables(
        stats: Dict[Key, list]) -> Dict[str, List[Dict[str, object]]]:
    """Suggested switchpoint tables from the measured winners, in the
    exact entry shapes the ``_switchpoint`` readers consume."""
    cuda: List[Dict[str, object]] = []
    hier: List[Dict[str, object]] = []
    for row in crossovers(stats):
        if row["pair"] == "cuda-vs-device":
            # the coll/cuda reader keys on the flat mesh shape (size,);
            # algorithm 'xla' means "fall through" to coll/device (the
            # reader's name for it, coll/cuda.py _select)
            mesh = (row["winner_mesh"] if row["winner"] == "cuda"
                    else [row["size"]])
            algo = (row["winner_algorithm"]
                    if row["winner"] == "cuda" else "xla")
            cuda.append({"op": row["op"], "dtype": row["dtype"],
                           "mesh": list(mesh), "log2": row["log2"],
                           "algorithm": algo})
        else:  # hier-vs-flat: reader keys on (n_dcn, n_ici)
            if row["winner"] == "hier":
                hmesh, algo = row["winner_mesh"], "hier"
            else:
                # the hier arm lost; its 2-D mesh is on the loser side
                hmesh = next(
                    (list(m) for (op, dt, lg, m, prov, _a) in stats
                     if prov == "hier" and op == row["op"]
                     and dt == row["dtype"] and lg == row["log2"]
                     and _size_of(m) == row["size"]),
                    None)
                algo = "flat"
            if hmesh is not None:
                hier.append({"op": row["op"], "dtype": row["dtype"],
                             "mesh": list(hmesh), "log2": row["log2"],
                             "algorithm": algo})
    return {"cuda": cuda, "hier": hier}


def regressions(stats: Dict[Key, list], baseline: Dict[Key, list],
                threshold: float = 1.5,
                min_count: int = 1) -> List[Dict[str, object]]:
    """Current-run keys whose p50 degraded past ``threshold`` x the
    baseline DB's p50, worst first, each with a named verdict."""
    out: List[Dict[str, object]] = []
    for key, rec in stats.items():
        base = baseline.get(key)
        if base is None or rec[0] < min_count or base[0] < min_count:
            continue
        cur = quantile(rec[4], 0.50)
        ref = quantile(base[4], 0.50)
        if ref <= 0:
            continue
        ratio = cur / ref
        if ratio < threshold:
            continue
        op, dt, lg, mesh, prov, algo = key
        out.append({
            "op": op, "dtype": dt, "log2": lg, "mesh": list(mesh),
            "provider": prov, "algorithm": algo,
            "p50_ns": cur, "baseline_p50_ns": ref, "ratio": ratio,
            "verdict": (
                "%s %s 2^%d on %s [%s/%s]: p50 %.1fx slower than "
                "PerfDB baseline (%.0f ns vs %.0f ns)" % (
                    op, dt, lg, "x".join(str(d) for d in mesh),
                    prov, algo, ratio, cur, ref)),
        })
    out.sort(key=lambda r: -r["ratio"])
    return out


def render(stats: Dict[Key, list],
           baseline: Optional[Dict[Key, list]] = None,
           threshold: float = 1.5, top: int = 20) -> str:
    """Human-readable observatory report."""
    lines = ["== tune: collective performance observatory =="]
    total = sum(rec[0] for rec in stats.values())
    lines.append("keys=%d samples=%d" % (len(stats), total))

    lines.append("")
    lines.append("-- observed (top %d keys by samples) --" % top)
    ranked = sorted(stats.items(), key=lambda kv: -kv[1][0])[:top]
    for (op, dt, lg, mesh, prov, algo), rec in ranked:
        s = summarize(rec)
        lines.append(
            "  %-18s %-9s 2^%-2d %-7s %s/%s: n=%d mean=%.0fns "
            "p50=%.0fns p99=%.0fns" % (
                op, dt, lg, "x".join(str(d) for d in mesh),
                prov, algo, s["count"], s["mean_ns"], s["p50_ns"],
                s["p99_ns"]))

    rows = crossovers(stats)
    lines.append("")
    lines.append("-- measured crossovers (%d) --" % len(rows))
    for row in rows:
        lines.append(
            "  [%s] %s %s 2^%d on %d devices: %s(%s) wins %.2fx "
            "over %s (p50 %.0fns vs %.0fns)" % (
                row["pair"], row["op"], row["dtype"], row["log2"],
                row["size"], row["winner"],
                row["winner_algorithm"], row["speedup"],
                row["loser"], row["winner_p50_ns"],
                row["loser_p50_ns"]))
    if not rows:
        lines.append("  (none — need both arms of a pair observed "
                     "on the same op/dtype/size/bucket)")

    tables = candidate_tables(stats)
    lines.append("")
    lines.append("-- candidate switchpoint tables (suggestions; "
                 "point coll_*_switchpoints at the emitted JSON) --")
    lines.append("  cuda entries: %d   hier entries: %d" % (
        len(tables["cuda"]), len(tables["hier"])))

    if baseline is not None:
        regs = regressions(stats, baseline, threshold)
        lines.append("")
        lines.append("-- regression verdicts vs PerfDB baseline "
                     "(threshold %.2fx): %d --" % (threshold,
                                                   len(regs)))
        for r in regs:
            lines.append("  REGRESSION: " + r["verdict"])
        if not regs:
            lines.append("  (none — every shared key within "
                         "%.2fx of baseline p50)" % threshold)
    return "\n".join(lines) + "\n"
