"""CLI: merge per-rank traces / summarize a trace file.

    python -m ompi_tpu_torch.trace merge -o merged.json r0.json r1.json
    python -m ompi_tpu_torch.trace report trace.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ompi_tpu_torch.trace import export, merge


def _cmd_merge(args) -> int:
    try:
        doc = merge.merge_files(args.out, args.inputs)
    except OSError as exc:
        # missing/unreadable per-rank file (or unwritable output):
        # one line, nonzero exit — never a traceback
        print(f"trace merge: {exc}", file=sys.stderr)
        return 1
    except (json.JSONDecodeError, KeyError, TypeError,
            ValueError) as exc:
        print("trace merge: corrupt trace input: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    md = doc["metadata"]
    print(f"merged {md['merged_from']} trace(s), ranks {md['ranks']}, "
          f"{len(doc['traceEvents'])} events -> {args.out}")
    return 0


def _cmd_report(args) -> int:
    with open(args.input) as fh:
        doc = json.load(fh)
    by_subsys = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cell = by_subsys.setdefault(ev.get("cat", "?"), [0, 0.0])
        cell[0] += 1
        cell[1] += ev.get("dur", 0.0)
    print(f"{args.input}: {sum(c[0] for c in by_subsys.values())} "
          "spans")
    for subsys, (n, dur) in sorted(by_subsys.items()):
        print(f"  {subsys:10s} {n:8d} spans  {dur / 1e3:10.3f} ms")
    hist = doc.get("metadata", {}).get("hist", {})
    for op in sorted(export.histograms(hist)):
        pc = export.percentiles(op, (0.5, 0.99), hist)
        print(f"  hist {op}: p50={pc[0] / 1e3:.1f}us "
              f"p99={pc[1] / 1e3:.1f}us")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.trace",
        description="merge/summarize ompi_tpu_torch trace files")
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge", help="merge per-rank trace files "
                                     "into one timeline")
    m.add_argument("-o", "--out", required=True)
    m.add_argument("inputs", nargs="+")
    m.set_defaults(fn=_cmd_merge)
    r = sub.add_parser("report", help="span counts + histogram "
                                      "percentiles of one trace file")
    r.add_argument("input")
    r.set_defaults(fn=_cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
