"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout. The cell's file (``benchmark/workloads/
<CELL>.json``) names its configuration, traffic, driver, chips, MCA
settings and launcher options; the configuration gives the ranks, the
ranks a card holds and the bucket size (passed to the program as
``--mca coll_device_bucket_bytes``). The harness starts one job of the port's launcher with
the cell's driver on every rank, waits for it, lets the metric readers
of the cell (``benchmark/metrics/<metric>.py``, as ``BENCHMARK.json``
lists them: end-to-end metrics without trace, per-layer metrics with
it) read what the ranks recorded, and prints one JSON line as the last
line of standard output. The numbers that decide ``correct`` are
printed beside their limits as the last lines of standard error and
under ``checks``, the result's last key.

Where a run writes: the run's folder under ``TMPDIR`` (the ranks'
records, the profiler's trace, the port's shared-memory files through
``OMPI_TPU_SHM_DIR``), removed at the end; the kernels' build and the
caches under the checkout's ``build/``.

Without a CUDA card, or with fewer than the cell asks for, the run
exits with code 2 and prints no result. ``--platform cpu`` (for the
benchmark's own tests) runs the ranks on the port's CPU platform
instead; ``--control`` runs the configuration's lower precision and
``--fault NAME`` plants a fault of ``benchmark/tests/faults.py`` (the
checks of ``correct``); ``--trace-parts`` names the instruments a traced
run turns on (``spans``, ``api``, ``profiler``; all by default), to
measure what each costs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import cells, runinfo, stats  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ompi_tpu")
#: seconds a job may take beyond its window (set-up, a first build,
#: the reference)
JOB_SLACK_S = 1100
GiB = float(1 << 30)


def fail(msg: str, code: int = 1) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def card_info(chips: int) -> None:
    """The cards' names and power limits, and with more than one card
    how they reach each other, on standard error."""
    for cmd in (["nvidia-smi", "--query-gpu=index,name,power.limit",
                 "--format=csv,noheader"],
                ["nvidia-smi", "topo", "-m"] if chips > 1 else None):
        if cmd is None:
            continue
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=60).stdout
        except (OSError, subprocess.SubprocessError) as exc:
            out = f"({cmd[0]} failed: {exc})"
        print(f"benchmark: {' '.join(cmd[1:])}:\n{out.rstrip()}",
              file=sys.stderr, flush=True)


def visible_cards(chips: int):
    """The first ``chips`` of the cards this process may use, or None."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    env = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    ids = [x for x in env.split(",") if x] if env else \
        [str(i) for i in range(torch.cuda.device_count())]
    return ids[:chips] if len(ids) >= chips else None


def job_env(run_dir: str, cards, cpu: bool) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMPI_TPU_SHM_DIR"] = os.path.join(run_dir, "shm")
    cache = os.path.join(ROOT, "build", "cache")
    env["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    env["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    env["OMP_NUM_THREADS"] = "1"
    env["USE_FLAX"] = "0"
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    if not cpu:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
    return env


def run_job(cmd, env, timeout_s: float) -> int:
    """The launcher's job, its output on standard error; on a timeout its
    whole process group is ended."""
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=sys.stderr,
                            stderr=sys.stderr, start_new_session=True)
    try:
        return proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        return 124


def breakdown(run: runinfo.Run) -> dict:
    """The device operations that took most time (summed over ranks) and
    the idle time of the cards by what their ranks' hosts were doing."""
    per_op: dict = {}
    idle: dict = {}
    for recs in run.cards().values():
        w = run.card_window(recs)
        if w is None:
            return {}
        ops = run.card_ops(recs)
        for name, t0, t1 in ops:
            per_op[name] = per_op.get(name, 0.0) + (t1 - t0) / 1e9
        for g0, g1 in stats.gaps(((o[1], o[2]) for o in ops), *w):
            what = _doing(recs, (g0 + g1) / 2)
            idle[what] = idle.get(what, 0.0) + (g1 - g0) / 1e9
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def _doing(recs, t: float) -> str:
    """What the card's ranks' hosts were doing at t: inside a collective
    launch (or an MPI call), inside the optimizer's own code, or between
    steps (the gradient hand-over and the loop)."""
    labels = []
    for rec in recs:
        inner = None
        for name, subsys, t0, t1, op in rec["spans"]:
            if t0 <= t < t1 and (name == "launch" or subsys == "api"):
                inner = f"launch.{op}" if name == "launch" and op \
                    else f"{subsys}.{name}"
                break
        if inner is None and any(s[0] == "step" and s[2] <= t < s[3]
                                 for s in rec["spans"]):
            inner = "optimizer_self"
        labels.append(inner or "between_steps")
    for pref in ("launch.", "api.", "optimizer_self"):
        for lb in labels:
            if lb.startswith(pref):
                return lb
    return labels[0] if labels else "between_steps"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                    help=argparse.SUPPRESS)
    ap.add_argument("--control", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--fault", default="", help=argparse.SUPPRESS)
    ap.add_argument("--trace-parts", default="", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    cpu = ns.platform == "cpu"

    try:
        bench = cells.benchmark(ROOT)
        files = cells.cell(ns.workload)
    except (OSError, ValueError, KeyError) as exc:
        return fail(f"cannot load cell {ns.workload!r}: {exc}")
    c = files["cell"]
    chips = int(c["chips"])
    dep = files["config"]["deployment"]
    if chips * int(dep["ranks_per_card"]) != int(dep["ranks"]):
        return fail(f"cell {ns.workload}: {chips} card(s) of "
                    f"{dep['ranks_per_card']} rank(s) do not hold the "
                    f"configuration's {dep['ranks']} ranks")
    cards = None
    if not cpu:
        cards = visible_cards(chips)
        if cards is None:
            return fail(f"cell {ns.workload} needs {chips} CUDA card(s); "
                        "this machine does not offer them", 2)
        card_info(chips)
    driver = cells.driver_path(c["driver"])
    if not os.path.exists(driver):
        return fail(f"no driver {driver}")

    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    run_dir = tempfile.mkdtemp(prefix="ompi_bench_", dir=base)
    try:
        return _run(ns, bench, files, chips, cards, cpu, driver, run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _run(ns, bench, files, chips, cards, cpu, driver, run_dir) -> int:
    c = files["cell"]
    out_dir = os.path.join(run_dir, "out")
    os.makedirs(out_dir)
    os.makedirs(os.path.join(run_dir, "shm"))
    flags = os.path.join(run_dir, "flags")
    with open(flags, "wb") as f:
        f.write(b"\0" * 64)
    spec = {"config": files["config"], "traffic": files["traffic"],
            "cell": c, "seed": ns.seed, "seconds": ns.seconds,
            "trace": bool(ns.trace), "out": out_dir, "flags": flags,
            "control": ns.control, "fault": ns.fault,
            "trace_parts": [x for x in ns.trace_parts.split(",") if x]}
    spec_path = os.path.join(run_dir, "spec.json")
    with open(spec_path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    dep = files["config"]["deployment"]
    ranks = int(dep["ranks"])
    mca = [x for k, v in c["mca"].items() for x in ("--mca", k, str(v))]
    mca += ["--mca", "coll_device_bucket_bytes", str(int(dep["bucket_bytes"]))]
    if cpu:
        mca += ["--mca", "device_plane_platform", "cpu"]
    timeout_s = ns.seconds + JOB_SLACK_S
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
           "-n", str(ranks), *c.get("launcher", []),
           "--timeout", str(timeout_s), *mca, driver,
           spec_path]
    launch_mono = time.monotonic()
    rc = run_job(cmd, job_env(run_dir, cards, cpu), timeout_s + 60)
    if rc != 0:
        return fail(f"the job exited with {rc}", rc if rc > 0 else 1)
    recs = []
    for r in range(ranks):
        p = os.path.join(out_dir, f"rank{r}.json")
        if not os.path.exists(p):
            return fail(f"rank {r} wrote no record")
        with open(p, encoding="utf-8") as f:
            recs.append(json.load(f))
    left = os.listdir(os.path.join(run_dir, "shm"))
    if left:
        print(f"benchmark: shared-memory files left: {left}",
              file=sys.stderr)
    run = runinfo.Run(files, recs, launch_mono, chips, bool(ns.trace))

    seen = sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
    for rec in recs:
        seen += [f"{m} (rank {rec['rank']})"
                 for m in rec["forbidden_modules"]]
    if seen:
        return fail(f"modules of JAX or of the JAX package loaded: {seen}")

    metrics = {}
    for m in cells.metrics_for(bench, ns.workload, bool(ns.trace)):
        v = cells.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    mem = [r["mem_used_bytes"] for r in recs if r["mem_used_bytes"]]
    device = {"platform": "cpu" if cpu else "gpu",
              "kind": run.lead.get("card_name", "cpu"),
              "count": chips,
              "memory_peak_bytes": max(mem) if mem else 0}
    result = {"correct": None, "attempted": run.lead["steps"], "failed": 0,
              "metrics": metrics, "device": device}
    if ns.trace:
        b = run.busy()
        if b is not None:
            device["busy_s"], device["window_s"] = b
            result["breakdown"] = breakdown(run)

    limits = c["checks"]
    checks = {}
    for name, limit in limits.items():
        worst = max(r["checks"][name] for r in recs)
        checks[name] = {"value": worst, "limit": limit}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    result["correct"] = ok
    result["failed"] = 0 if ok else run.lead["steps"]
    result["checks"] = checks
    align = [r["dev_trace"].get("align_err_ns") for r in recs
             if r.get("dev_trace")]
    print(f"benchmark: {ns.workload} seed {ns.seed}: {run.lead['steps']} "
          f"steps in {run.lead['window_s']:.3f} s, reference "
          f"{max(r['reference_s'] for r in recs):.2f} s, "
          f"{run.lead['sampled']} elements sampled"
          + (f", trace alignment within {max(align) / 1e3:.1f} us"
             if align else ""), file=sys.stderr)
    lead = run.lead
    print(f"benchmark: the loop's garbage collection took "
          f"{lead['gc_s'] / lead['steps'] * 1e3:.4f} ms a step, "
          f"{lead['gc_s'] / lead['window_s'] * 100:.3f}% of the window "
          "(rank 0)", file=sys.stderr)
    if lead.get("plain_steps"):
        print("benchmark: ms a step by instruments on (rank 0): "
              + "; ".join(f"{k} {v * 1e3:.3f}" for k, v in
                          run.phase_step_s().items()), file=sys.stderr)
    if run.lead.get("reserved_bytes"):
        print("benchmark: torch's reserved GiB a rank (window start, end, "
              "peak): " + "; ".join(
                  " ".join(f"{x / GiB:.3f}" for x in r["reserved_bytes"])
                  for r in recs), file=sys.stderr)
    for name, v in checks.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
