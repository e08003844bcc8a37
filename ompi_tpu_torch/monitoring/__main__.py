"""CLI: merge per-rank matrix dumps into heatmap + hotspot reports (the
port of ``python -m ompi_tpu.monitoring``).

    python -m ompi_tpu_torch.monitoring report mon_r0.json mon_r1.json
    python -m ompi_tpu_torch.monitoring report --json merged.json \
        --top 10 mon_r*.json

Inputs are the Finalize-time dumps ``--mca monitoring_dump
'/tmp/mon_r{rank}.json'`` writes (schema
``ompi_tpu.monitoring.matrix/1``). Missing or corrupt input: one
line on stderr, exit 1 — same contract as the trace merge CLI.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ompi_tpu_torch.monitoring import merge, report


def _cmd_report(args) -> int:
    docs = []
    try:
        for path in args.inputs:
            with open(path) as fh:
                docs.append(json.load(fh))
        merged = merge.merge(docs)
    except OSError as exc:
        print(f"monitoring report: {exc}", file=sys.stderr)
        return 1
    except (json.JSONDecodeError, KeyError, TypeError,
            ValueError) as exc:
        print("monitoring report: corrupt matrix input: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(report.render(merged, top=args.top))
    if args.json:
        try:
            with open(args.json, "w") as fh:
                json.dump(merged, fh, indent=1)
        except OSError as exc:
            print(f"monitoring report: {exc}", file=sys.stderr)
            return 1
        print(f"merged matrix written: {args.json}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.monitoring",
        description="merge/report ompi_tpu_torch traffic matrices")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser(
        "report", help="rank-by-rank + per-link heatmaps with top-N "
                       "hotspot ranking from per-rank matrix dumps")
    r.add_argument("inputs", nargs="+",
                   help="per-rank monitoring_dump JSON files")
    r.add_argument("--json", default="",
                   help="also write the merged matrix JSON artifact")
    r.add_argument("--top", type=int, default=5,
                   help="hotspot rows to print (default 5)")
    r.set_defaults(fn=_cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
