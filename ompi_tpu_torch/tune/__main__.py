"""CLI: render the collective performance observatory report.

    python -m ompi_tpu_torch.tune report tune_r0.json tune_r1.json
    python -m ompi_tpu_torch.tune report --db tune_perfdb_cpu_n2.json \
        --tables cand --json merged.json tune_r*.json

Inputs are per-rank Finalize dumps (``--mca tune_dump
'/tmp/tune_r{rank}.json'``) and/or a persistent PerfDB file — all
the same schema ``ompi_tpu.tune.perfdb/1`` — merged associatively.
``--db`` names the BASELINE to diff against for regression verdicts;
``--tables PREFIX`` writes the candidate switchpoint suggestions
(``PREFIX_cuda.json`` / ``PREFIX_hier.json``) in the exact shapes
the ``coll_*_switchpoints`` readers consume. Missing or corrupt
input: one line on stderr, exit 1 — the monitoring CLI contract.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ompi_tpu_torch.tune import perfdb, report


def _cmd_report(args) -> int:
    docs = []
    try:
        for path in args.inputs:
            with open(path) as fh:
                docs.append(json.load(fh))
        merged = perfdb.merge(docs)
        stats = perfdb.stats_of(merged["entries"])
        baseline = None
        if args.db:
            with open(args.db) as fh:
                bdoc = json.load(fh)
            if bdoc.get("schema") != perfdb.SCHEMA:
                raise ValueError(
                    f"baseline {args.db}: schema "
                    f"{bdoc.get('schema')!r}, want {perfdb.SCHEMA!r}")
            baseline = perfdb.stats_of(bdoc.get("entries", []))
    except OSError as exc:
        print(f"tune report: {exc}", file=sys.stderr)
        return 1
    except (json.JSONDecodeError, KeyError, TypeError,
            ValueError) as exc:
        print("tune report: corrupt perfdb input: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(report.render(stats, baseline=baseline,
                        threshold=args.threshold, top=args.top))
    try:
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(merged, fh, indent=1)
            print(f"merged perfdb written: {args.json}")
        if args.tables:
            tables = report.candidate_tables(stats)
            for kind in ("cuda", "hier"):
                path = f"{args.tables}_{kind}.json"
                with open(path, "w") as fh:
                    json.dump(tables[kind], fh, indent=1)
                print(f"candidate {kind} switchpoints (suggestions, "
                      f"{len(tables[kind])} entries): {path}")
    except OSError as exc:
        print(f"tune report: {exc}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.tune",
        description="collective performance observatory reports")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser(
        "report", help="measured crossovers, candidate switchpoint "
                       "tables, and regression verdicts from perfdb "
                       "dumps")
    r.add_argument("inputs", nargs="+",
                   help="per-rank tune_dump / perfdb JSON files")
    r.add_argument("--db", default="",
                   help="baseline PerfDB to diff for regression "
                        "verdicts")
    r.add_argument("--json", default="",
                   help="also write the merged perfdb JSON artifact")
    r.add_argument("--tables", default="",
                   help="write candidate switchpoint tables as "
                        "PREFIX_cuda.json / PREFIX_hier.json")
    r.add_argument("--threshold", type=float, default=1.5,
                   help="regression verdict bar (default 1.5x p50)")
    r.add_argument("--top", type=int, default=20,
                   help="observed keys to print (default 20)")
    r.set_defaults(fn=_cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
