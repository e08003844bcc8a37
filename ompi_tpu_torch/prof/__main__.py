"""CLI: merged wall-clock attribution report.

    python -m ompi_tpu_torch.prof report r0_trace.json r1_trace.json
    python -m ompi_tpu_torch.prof report -o attribution.json --top 15 *.json

The port's copy of ``ompi_tpu.prof.__main__``. Inputs are ordinary
per-rank trace files (``trace.export.write`` output) — the prof
plane's phase and xfer spans ride the same recorder, so clock sync and
cross-rank merge are
exactly ``python -m ompi_tpu_torch.trace merge`` (store-synced clocks,
pid-per-rank). The report answers "where did the wall go":

- **phase ledger** first, sorted by worst-rank seconds descending —
  a staging-bound run prints ``staging`` on top;
- **transfer summary** per direction (bytes, spans, average and peak
  achieved bandwidth) from the xfer spans;
- **top-N span consumers** by total time across the remaining
  subsystems.

Error convention matches the trace CLI: missing/corrupt input is one
line on stderr and exit 1, never a traceback.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ompi_tpu_torch.trace import merge as _merge

#: the reference's schema: a report reads the same from either package
SCHEMA = "ompi_tpu.prof.attribution/1"


def attribution(doc: Dict[str, Any], top: int = 10) -> Dict[str, Any]:
    """Merged trace doc -> attribution dict (the JSON export shape)."""
    spans = [ev for ev in doc.get("traceEvents", [])
             if ev.get("ph") == "X"]
    ranks = sorted({ev.get("pid", 0) for ev in spans})
    t0 = min((ev["ts"] for ev in spans), default=0.0)
    t1 = max((ev["ts"] + ev.get("dur", 0.0) for ev in spans),
             default=0.0)

    # phase ledger: per-(rank, phase) wall; job-level attribution is
    # the worst rank (the wall waits for the slowest) plus the mean
    per_rank: Dict[str, Dict[int, float]] = {}
    for ev in spans:
        if ev.get("cat") != "prof":
            continue
        cell = per_rank.setdefault(ev["name"], {})
        pid = ev.get("pid", 0)
        cell[pid] = cell.get(pid, 0.0) + ev.get("dur", 0.0) / 1e6
    phases = [{
        "phase": name,
        "max_s": round(max(cell.values()), 6),
        "mean_s": round(sum(cell.values()) / len(cell), 6),
        "per_rank_s": {str(r): round(s, 6)
                       for r, s in sorted(cell.items())},
    } for name, cell in per_rank.items()]
    phases.sort(key=lambda p: -p["max_s"])

    # concurrent-phase overlap: per rank, sweep the prof spans for
    # wall covered by >= 2 DISTINCT open phase names. With the ingest
    # plane staging and compile genuinely run together, so the phase
    # ledger legitimately sums past wall_s — this quantifies by how
    # much instead of leaving the report looking inconsistent
    ov_rank: Dict[int, float] = {}
    by_pid: Dict[int, List[Any]] = {}
    for ev in spans:
        if ev.get("cat") == "prof":
            by_pid.setdefault(ev.get("pid", 0), []).append(ev)
    for pid, evs in by_pid.items():
        edges = []
        for ev in evs:
            edges.append((ev["ts"], 1, ev["name"]))
            edges.append((ev["ts"] + ev.get("dur", 0.0), -1,
                          ev["name"]))
        edges.sort(key=lambda e: (e[0], e[1]))
        open_names: Dict[str, int] = {}
        total = prev = 0.0
        for ts, delta, name in edges:
            if ts > prev and sum(
                    1 for c in open_names.values() if c > 0) >= 2:
                total += ts - prev
            prev = ts
            open_names[name] = open_names.get(name, 0) + delta
        ov_rank[pid] = total / 1e6
    phase_overlap = {
        "max_s": round(max(ov_rank.values(), default=0.0), 6),
        "mean_s": round(sum(ov_rank.values()) / len(ov_rank), 6)
        if ov_rank else 0.0,
        "per_rank_s": {str(r): round(s, 6)
                       for r, s in sorted(ov_rank.items())},
    }

    transfers: Dict[str, Dict[str, Any]] = {}
    for ev in spans:
        if ev.get("cat") != "xfer" or ev["name"] not in ("h2d", "d2h"):
            continue
        cell = transfers.setdefault(ev["name"], {
            "bytes": 0, "spans": 0, "seconds": 0.0, "peak_gbps": 0.0})
        nb = int(ev.get("args", {}).get("bytes", 0))
        dur_s = ev.get("dur", 0.0) / 1e6
        cell["bytes"] += nb
        cell["spans"] += 1
        cell["seconds"] += dur_s
        if dur_s > 0 and nb:
            cell["peak_gbps"] = max(cell["peak_gbps"],
                                    nb / dur_s / 1e9)
    for cell in transfers.values():
        cell["seconds"] = round(cell["seconds"], 6)
        cell["avg_gbps"] = round(
            cell["bytes"] / cell["seconds"] / 1e9, 3) \
            if cell["seconds"] > 0 else None
        cell["peak_gbps"] = round(cell["peak_gbps"], 3)

    by_op: Dict[Any, List[float]] = {}
    for ev in spans:
        if ev.get("cat") == "prof":
            continue
        cell = by_op.setdefault((ev.get("cat", "?"), ev["name"]),
                                [0, 0.0])
        cell[0] += 1
        cell[1] += ev.get("dur", 0.0) / 1e6
    consumers = [{"subsys": c, "name": n, "spans": int(cnt),
                  "seconds": round(s, 6)}
                 for (c, n), (cnt, s) in by_op.items()]
    consumers.sort(key=lambda c: -c["seconds"])

    return {
        "schema": SCHEMA,
        "ranks": [int(r) for r in ranks],
        "wall_s": round(max(t1 - t0, 0.0) / 1e6, 6),
        "phases": phases,
        "phase_overlap": phase_overlap,
        "transfers": transfers,
        "top": consumers[:top],
    }


def _render(rep: Dict[str, Any]) -> str:
    lines = [f"wall-clock attribution: {len(rep['ranks'])} rank(s) "
             f"{rep['ranks']}, wall {rep['wall_s']:.3f}s"]
    if rep["phases"]:
        lines.append("phase ledger (worst-rank / mean seconds):")
        for p in rep["phases"]:
            lines.append(f"  {p['phase']:12s} {p['max_s']:10.3f} "
                         f"{p['mean_s']:10.3f}")
        ov = rep.get("phase_overlap") or {}
        lines.append(
            f"phase overlap: {ov.get('max_s', 0.0):.3f}s worst-rank "
            f"/ {ov.get('mean_s', 0.0):.3f}s mean under concurrent "
            "phases — overlapped phases (staging || compile) "
            "legitimately sum past wall")
    else:
        lines.append("phase ledger: no prof spans (run with "
                     "--mca prof_enable 1 and trace_enable 1)")
    for d, c in sorted(rep["transfers"].items()):
        bw = (f"avg {c['avg_gbps']} GB/s, peak {c['peak_gbps']} GB/s"
              if c["avg_gbps"] is not None else "async (0ns spans)")
        lines.append(f"transfers {d}: {c['bytes']} bytes in "
                     f"{c['spans']} span(s), {c['seconds']:.3f}s, {bw}")
    if rep["top"]:
        lines.append(f"top {len(rep['top'])} span consumers:")
        for c in rep["top"]:
            lines.append(f"  {c['subsys']:10s} {c['name']:24s} "
                         f"{c['spans']:8d} spans {c['seconds']:10.3f}s")
    return "\n".join(lines)


def _cmd_report(args) -> int:
    try:
        doc = _merge.merge(args.inputs)
    except OSError as exc:
        print(f"prof report: {exc}", file=sys.stderr)
        return 1
    except (json.JSONDecodeError, KeyError, TypeError,
            ValueError) as exc:
        print("prof report: corrupt trace input: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    rep = attribution(doc, top=args.top)
    print(_render(rep))
    if args.out:
        try:
            with open(args.out, "w") as fh:
                json.dump(rep, fh, indent=2)
        except OSError as exc:
            print(f"prof report: {exc}", file=sys.stderr)
            return 1
        print(f"wrote {args.out}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.prof",
        description="merged wall-clock attribution from per-rank "
                    "trace files (phase ledger + transfers + top-N)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("report", help="merge per-rank traces and "
                                      "print/export attribution")
    r.add_argument("-o", "--out", default=None,
                   help="also write the report as JSON here")
    r.add_argument("--top", type=int, default=10,
                   help="top-N span consumers to list (default 10)")
    r.add_argument("inputs", nargs="+",
                   help="per-rank trace files (trace.export output)")
    r.set_defaults(fn=_cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
