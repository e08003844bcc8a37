"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics;
``benchmark/workloads/<cell>.json`` holds a cell, which names its
configuration (``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``) and its driver
(``benchmark/drivers/<driver>.py``); ``benchmark/metrics/<metric>.py``
reads one metric. Nothing here needs editing when a later change adds
any of them.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def path(kind: str, name: str, ext: str = ".json",
         bench_dir: str = BENCH_DIR) -> str:
    """``benchmark/<kind>/<name><ext>``; refuses a name outside the
    allowed characters (so no name leads out of its folder)."""
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r}: not a benchmark name")
    return os.path.join(bench_dir, kind, name + ext)


def cell(name: str, bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """The cell's file with its configuration and traffic files."""
    c = _load(path("workloads", name, bench_dir=bench_dir))
    return {"cell": c,
            "config": _load(path("configs", c["config"],
                                 bench_dir=bench_dir)),
            "traffic": _load(path("traffic", c["traffic"],
                                  bench_dir=bench_dir))}


def driver_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return path("drivers", name, ".py", bench_dir)


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(run)`` function of ``benchmark/metrics/<name>.py``."""
    p = path("metrics", name, ".py", bench_dir)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's metrics of one kind: end-to-end without trace,
    per-layer with it; a metric with ``workloads`` only in those."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
