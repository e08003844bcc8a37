"""Human-readable skew reports — rankings, tables, critical path.

Renders the analysis doc ``decompose.analyze`` produces: the
per-rank exposed-wait ranking (who paid the straggler tax), the
per-op skew table, the step's critical path (last-arriving rank per
collective with its compute-vs-comm cause), and the persistent-
straggler verdicts — each figure qualified by the merged clock error
bar, because a wait smaller than the error bar is noise.
"""

from __future__ import annotations

from typing import Any, Dict, List


def _ms(ns: int) -> str:
    return "%.3f ms" % (ns / 1e6)


def verdict_line(v: Dict[str, Any]) -> str:
    """The named persistent-straggler line (Finalize log + report +
    smoke-lane grep target)."""
    return ("PERSISTENT STRAGGLER: rank %d last into %d%% of %d "
            "collectives (%s, +%s skew)"
            % (v["rank"], round(v["share_pct"]), v["of"],
               v["cause"], _ms(v["arrival_skew_ns"])))


def render(analysis: Dict[str, Any], top: int = 8,
           path_rows: int = 16) -> str:
    lines: List[str] = []
    err = int(analysis.get("clock_err_ns", 0))
    lines.append(
        "skew report: %d collectives across %d ranks "
        "(timestamp error bar ±%.1f us)"
        % (analysis.get("collectives", 0),
           analysis.get("nranks", 0), err / 1e3))

    waits = sorted(analysis.get("exposed_wait_ns", {}).items(),
                   key=lambda kv: -int(kv[1]))
    if waits:
        lines.append("")
        lines.append("exposed wait by rank (time spent waiting for "
                     "stragglers):")
        for r, w in waits[:top]:
            lines.append("  rank %-4s %12s" % (r, _ms(int(w))))

    ops = analysis.get("per_op", ())
    if ops:
        lines.append("")
        lines.append("per-op arrival skew:")
        lines.append("  %-24s %5s %14s %14s %14s"
                     % ("op", "n", "mean skew", "max skew",
                        "total wait"))
        for row in ops:
            lines.append("  %-24s %5d %14s %14s %14s"
                         % (row["op"], row["n"],
                            _ms(row["mean_skew_ns"]),
                            _ms(row["max_skew_ns"]),
                            _ms(row["wait_ns"])))

    path = analysis.get("critical_path", ())
    if path:
        lines.append("")
        lines.append("critical path (last-arriving rank per "
                     "collective, seq order):")
        shown = list(path)[-path_rows:]
        if len(shown) < len(path):
            lines.append("  ... %d earlier collectives elided"
                         % (len(path) - len(shown)))
        for hop in shown:
            lines.append(
                "  seq %-5d %-24s rank %-4d +%s (%s)"
                % (hop["seq"], hop["op"], hop["rank"],
                   _ms(hop["arrival_skew_ns"]), hop["cause"]))

    lines.append("")
    stragglers = analysis.get("stragglers", ())
    if stragglers:
        for v in stragglers:
            lines.append(verdict_line(v))
    else:
        lines.append("no persistent straggler (no rank was last "
                     "often enough to name)")
    return "\n".join(lines)
