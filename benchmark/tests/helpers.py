"""Shared by the benchmark's tests: a copy of the benchmark with a tiny
configuration, and a run of the harness on the port's CPU platform."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

#: GPT-2's structure at widths a CPU test holds; with buckets of 20000
#: bytes (the harness passes the configuration's size to the program)
#: the plan has several
TINY = {"name": "tiny", "n_embd": 48, "n_layer": 2, "n_positions": 64,
        "vocab_size": 503}


def tiny_copy(dest: str) -> str:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dest``,
    with the configuration ``tiny`` and the cells ``tiny.zero2-ring`` and
    ``tiny.zero2-linear``, added to every metric's list of cells. Returns
    the copy's root."""
    root = os.path.join(dest, "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # the tiny cells report every metric a listed cell reports
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny.zero2-ring", "tiny.zero2-linear"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "gpt2-small.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    cfg["deployment"]["bucket_bytes"] = 20000
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    for tr in ("ring", "linear"):
        with open(os.path.join(b, "workloads",
                               f"gpt2-small.zero2-{tr}.json")) as f:
            cell = json.load(f)
        cell.update(name=f"tiny.zero2-{tr}", config="tiny")
        with open(os.path.join(b, "workloads", f"tiny.zero2-{tr}.json"),
                  "w") as f:
            json.dump(cell, f)
    return root


def run_cpu(root: str, cell: str, seed: int, *extra: str,
            seconds: float = 1.0, trace: int = 0, tmp: str = ""):
    """``benchmark/run.py`` of the copy at ``root`` on the CPU platform;
    returns (exit code, the result line or None, standard error)."""
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=tmp or root)
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "benchmark", "run.py"),
         "--workload", cell, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(trace), "--platform", "cpu", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines \
        else None
    return proc.returncode, result, proc.stderr
