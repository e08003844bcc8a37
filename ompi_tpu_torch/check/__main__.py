"""CLI for the correctness plane.

    python -m ompi_tpu_torch.check lint <paths...>   static collective lint
    python -m ompi_tpu_torch.check rules             rule catalog
    python -m ompi_tpu_torch.check run prog.py ...   run under the sanitizer

The port's copy of ``ompi_tpu/check/__main__.py``. ``lint`` exits 1
when any unsuppressed finding remains (the gate's contract:
``python -m ompi_tpu_torch.check lint ompi_tpu_torch`` must exit 0;
``scripts/torch_lint_gate.sh``). Missing/unreadable input is one line
on stderr and exit 1, never a traceback — the prof CLI's error
convention.
"""

from __future__ import annotations

import argparse
import os
import sys


def _cmd_lint(ns: argparse.Namespace) -> int:
    from ompi_tpu_torch.check import lint
    from ompi_tpu_torch.check.lint import sarif

    for p in ns.paths:
        if not os.path.exists(p):
            print(f"check lint: no such path: {p}", file=sys.stderr)
            return 1
    stats: dict = {}
    findings = lint.lint_paths(ns.paths, cache=ns.cache, stats=stats,
                               exclude=ns.exclude or ())
    if ns.baseline:
        if not os.path.exists(ns.baseline):
            print(f"check lint: no such baseline: {ns.baseline}",
                  file=sys.stderr)
            return 1
        try:
            keys = lint.load_baseline(ns.baseline)
        except (OSError, ValueError, KeyError) as exc:
            print(f"check lint: bad baseline {ns.baseline}: {exc}",
                  file=sys.stderr)
            return 1
        lint.apply_baseline(findings, keys)
    if ns.write_baseline:
        n = lint.write_baseline(findings, ns.write_baseline)
        print(f"check lint: baseline of {n} finding(s) written to "
              f"{ns.write_baseline}", file=sys.stderr)
    if ns.sarif:
        sarif.write_sarif(findings, ns.sarif)
    bad = lint.unsuppressed(findings)
    shown = findings if ns.show_suppressed else bad
    for f in shown:
        tag = " (suppressed)" if f.suppressed else \
            " (baselined)" if f.baselined else ""
        print(f"{f}{tag}")
    nsup = sum(1 for f in findings if f.suppressed)
    nbase = sum(1 for f in findings if f.baselined)
    print(f"check lint: {len(bad)} finding(s), {nsup} suppressed, "
          f"{nbase} baselined; {stats.get('cached', 0)}/"
          f"{stats.get('files', 0)} file(s) from cache",
          file=sys.stderr)
    parse_errors = [f for f in bad if f.rule == "parse-error"]
    if parse_errors and len(parse_errors) == len(bad):
        # the exit-code edge: a run whose only findings are parse
        # errors must fail loudly — an unparseable file is unchecked
        # code, and no suppression or baseline can absorb it
        print(f"check lint: {len(parse_errors)} file(s) failed to "
              "parse — parse failures cannot be suppressed or "
              "baselined; fix the file or --exclude it explicitly",
              file=sys.stderr)
        return 1
    return 1 if bad else 0


def _cmd_rules(ns: argparse.Namespace) -> int:
    from ompi_tpu_torch.check.lint import CATALOG

    width = max(len(r) for r in CATALOG)
    for rule, desc in sorted(CATALOG.items()):
        print(f"{rule:<{width}}  {desc}")
    print(f"\nsuppress with: # check: disable={next(iter(CATALOG))}"
          "  (or disable=all)")
    return 0


def _cmd_run(ns: argparse.Namespace) -> int:
    import runpy

    if not os.path.exists(ns.script):
        print(f"check run: no such file: {ns.script}", file=sys.stderr)
        return 1
    os.environ["OMPI_TPU_CHECK"] = str(ns.level)
    sys.argv = [ns.script] + ns.args
    runpy.run_path(ns.script, run_name="__main__")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.check",
        description="ompi_tpu_torch correctness plane: static collective "
                    "lint + runtime MPI sanitizer")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("lint", help="static MPI lint over files/dirs")
    lp.add_argument("paths", nargs="+")
    lp.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed/baselined findings")
    lp.add_argument("--cache", metavar="FILE",
                    help="incremental per-file cache (JSON), keyed "
                         "by content hash + callee-summary digest")
    lp.add_argument("--sarif", metavar="FILE",
                    help="write findings as SARIF 2.1.0 for GitHub "
                         "code scanning")
    lp.add_argument("--baseline", metavar="FILE",
                    help="findings baseline: matching findings "
                         "report but do not fail the gate")
    lp.add_argument("--write-baseline", metavar="FILE",
                    help="write current unsuppressed findings as "
                         "the accepted baseline")
    lp.add_argument("--exclude", action="append", metavar="GLOB",
                    help="skip files matching this glob/substring "
                         "(repeatable; e.g. generated code)")
    lp.set_defaults(fn=_cmd_lint)

    rp = sub.add_parser("rules", help="print the rule catalog")
    rp.set_defaults(fn=_cmd_rules)

    xp = sub.add_parser(
        "run", help="run a program under the runtime sanitizer "
                    "(sets OMPI_TPU_CHECK)")
    xp.add_argument("--level", type=int, default=2, choices=[1, 2])
    xp.add_argument("script")
    xp.add_argument("args", nargs=argparse.REMAINDER)
    xp.set_defaults(fn=_cmd_run)

    ns = ap.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())
