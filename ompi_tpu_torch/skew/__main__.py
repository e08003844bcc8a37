"""CLI: merge per-rank skew-ring dumps into the straggler report.

    python -m ompi_tpu_torch.skew report skew_r0.json skew_r1.json
    python -m ompi_tpu_torch.skew report --json analysis.json --pct 60 \
        skew_r*.json

Inputs are the Finalize-time dumps ``--mca skew_dump
'/tmp/skew_r{rank}.json'`` writes (schema ``ompi_tpu.skew/1``).
Missing or corrupt input: one line on stderr, exit 1 — same contract
as the monitoring/trace merge CLIs.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ompi_tpu_torch.skew import decompose, merge, report


def _cmd_report(args) -> int:
    docs = []
    try:
        for path in args.inputs:
            with open(path) as fh:
                docs.append(json.load(fh))
        merged = merge.merge(docs)
        analysis = decompose.analyze(
            merged["records"], clock_err_ns=merged["clock_err_ns"],
            pct=args.pct, win=args.window)
    except OSError as exc:
        print(f"skew report: {exc}", file=sys.stderr)
        return 1
    except (json.JSONDecodeError, KeyError, TypeError,
            ValueError) as exc:
        print("skew report: corrupt skew ring input: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(report.render(analysis, top=args.top))
    if args.json:
        try:
            with open(args.json, "w") as fh:
                json.dump(analysis, fh, indent=1)
        except OSError as exc:
            print(f"skew report: {exc}", file=sys.stderr)
            return 1
        print(f"skew analysis written: {args.json}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.skew",
        description="merge/report the port's cross-rank skew rings")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser(
        "report", help="exposed-wait ranking, per-op skew table, "
                       "critical path, and persistent-straggler "
                       "verdicts from per-rank skew_dump files")
    r.add_argument("inputs", nargs="+",
                   help="per-rank skew_dump JSON files")
    r.add_argument("--json", default="",
                   help="also write the analysis JSON artifact")
    r.add_argument("--top", type=int, default=8,
                   help="exposed-wait rows to print (default 8)")
    r.add_argument("--pct", type=float, default=None,
                   help="persistent-straggler share bar in percent "
                        "(default: the skew_straggler_pct cvar)")
    r.add_argument("--window", type=int, default=None,
                   help="most recent N collectives for the verdict "
                        "(default: the skew_window cvar; 0 = all)")
    r.set_defaults(fn=_cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
