"""The observability planes on the device collectives: trace, telemetry
and prof around coll/cuda's Allreduce and coll/device's fused
Allreduce_multi, bitwise the same with the planes on and off, and what
they cost.

Part A (the default; every rank): the job starts with the three planes
on (``trace_enable``, ``telemetry_enable``, ``prof_enable``). In the
ledger's ``staging`` phase each rank uploads and reads back a staging
buffer through its accelerator (the ``xfer`` lane) and builds its
inputs; in ``train`` it times, in turns, a device ``Allreduce`` (SUM,
float32) at each size of ``--sizes`` under ``'linear'`` (K3) and
``'ring'`` (K1 + K2) and one ``Allreduce_multi`` step of
``fused_gradients.py``'s gradients (coll/device, K3 a bucket), with the
planes live and then switched off (``recorder.disable()``,
``flight.disable()``, ``ledger.disable()``, enabled again for the next
live turn). Checks: every result bitwise equal on and off, the 'linear'
Allreduces bitwise the rank-order fold and the 'ring' ones the ring's
fold; in the live turns the ``launch`` spans of ``coll_cuda`` and
``coll_device`` equal the deltas of ``coll_cuda_launches`` and
``coll_device_launches``; the K1-K3 launches equal what the schedules
imply. Then a guard's cost with the planes off, the sampler's page
scraped over its HTTP endpoint (``--mca telemetry_port -1``), the clocks
synced and each rank's spans written as a Chrome trace
(``trace_r<rank>.json``) for ``python -m ompi_tpu_torch.trace merge``
and ``python -m ompi_tpu_torch.prof report`` (:func:`check_traces`).

Part B (``--stall R``): the watchdog on a device collective. After one
warm-up Allreduce, rank R sleeps ``--stall-s`` seconds (past
``telemetry_hang_timeout``) before the next 'linear' Allreduce, which
the others have entered; their watchdog dumps the hang naming rank R
(``ompi_tpu_hang_rank<r>_seq<s>.json`` in ``telemetry_dump_dir``) and
raises the ``telemetry_hang`` MPI_T event, then rank R arrives and the
Allreduce completes, bitwise.

Run::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on --mca trace_enable 1 --mca telemetry_enable 1 \\
        --mca prof_enable 1 --mca telemetry_port -1 \\
        ompi_tpu_torch/examples/observability.py --out DIR
    python -m ompi_tpu_torch.runtime.launcher -n 2 --mca device_plane on \\
        --mca coll_cuda on --mca trace_enable 1 --mca telemetry_enable 1 \\
        --mca telemetry_hang_timeout 2 --mca telemetry_dump_dir DIR \\
        ompi_tpu_torch/examples/observability.py --stall 1 --out DIR

Add ``--mca device_plane_platform cpu`` and ``--tiny`` on a machine
without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request

import torch

from ompi_tpu_torch import accelerator, mpi, telemetry
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import events, pvar
from ompi_tpu_torch.examples import kernel_counts as KC
from ompi_tpu_torch.examples.device_collectives import (bits_equal,
                                                        expected_allreduce)
from ompi_tpu_torch.examples.fused_gradients import grads_for
from ompi_tpu_torch.prof import ledger
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.telemetry import flight, openmetrics
from ompi_tpu_torch.trace import export, recorder
from ompi_tpu_torch.zero import layout as zl

MODES = ("linear", "ring")
#: calls a guard is timed over (and the empty calls it is held against)
GUARD_CALLS = 200_000
#: the launch pvar of each subsystem whose ``launch`` spans are counted
LAUNCH_PVARS = {"coll_cuda": "coll_cuda_launches",
                "coll_device": "coll_device_launches"}


def _size(text: str) -> int:
    text = text.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(text[-1:], 1)
    return int(text.rstrip("kmg")) * mult


def inputs(rank: int, nbytes: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed * 1000003 + rank * 7919 + nbytes)
    return torch.randn(nbytes // 4, generator=g).to(dev)


def set_planes(live: bool, rank: int, keep: list) -> None:
    """Switch the three planes on or off; the spans of a recorder that
    goes off are kept for the trace file. The recorder and the flight
    recorder each interpose on the API (``profile.attach_tool``), the
    recorder first: they detach in the reverse order, as PMPI layers
    must."""
    if live:
        recorder.enable(rank=rank)
        flight.enable(rank=rank)
        ledger.enable(rank=rank)
        return
    flight.disable()
    rec = recorder.disable()
    if rec is not None:
        keep.extend(rec.spans())
    ledger.disable()


def guard_ns() -> dict:
    """ns a disabled site pays for its guard (one attribute load and one
    branch), each held against an empty call, on this rank's host."""
    def nop():
        return None

    def trace_site():
        rec = recorder.RECORDER
        if rec is not None:
            return rec

    def flight_site():
        fl = flight.FLIGHT
        if fl is not None:
            return fl

    def prof_site():
        p = ledger.PROFILER
        if p is not None:
            return p

    out = {}
    for name, site in (("trace", trace_site), ("flight", flight_site),
                       ("prof", prof_site)):
        t0 = time.perf_counter_ns()
        for _ in range(GUARD_CALLS):
            site()
        base = time.perf_counter_ns()
        for _ in range(GUARD_CALLS):
            nop()
        out[name] = ((base - t0) - (time.perf_counter_ns() - base)) \
            / GUARD_CALLS
    return out


def check_traces(out: str, n: int) -> dict:
    """Merge the ranks' trace files with ``python -m ompi_tpu_torch.trace
    merge`` and report them with ``python -m ompi_tpu_torch.prof report``;
    returns what the two say (raises AssertionError where the merged
    timeline lacks a rank, a subsystem or per-tid monotone timestamps,
    or the report attributes no wall to a phase)."""
    paths = [os.path.join(out, f"trace_r{r}.json") for r in range(n)]
    merged = os.path.join(out, "merged.json")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    m = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.trace",
                        "merge", "-o", merged, *paths], env=env,
                       capture_output=True, text=True, timeout=120)
    assert m.returncode == 0, m.stderr
    with open(merged) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    pids = sorted({e["pid"] for e in spans})
    cats = sorted({e["cat"] for e in spans})
    assert pids == list(range(n)), pids
    assert "api" in cats and ("coll_cuda" in cats
                              or "coll_device" in cats), cats
    last: dict = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "M" or "ts" not in e:
            continue
        key = (e["pid"], e.get("tid"))
        assert e["ts"] >= last.get(key, float("-inf")), key
        last[key] = e["ts"]
    rep_json = os.path.join(out, "attribution.json")
    p = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.prof",
                        "report", "-o", rep_json, *paths], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    with open(rep_json) as f:
        rep = json.load(f)
    phases = {ph["phase"]: ph["max_s"] for ph in rep["phases"]}
    assert "staging" in phases and "train" in phases, phases
    return {"pids": pids, "cats": cats, "events": len(doc["traceEvents"]),
            "merge": m.stdout.strip(), "phases": phases,
            "wall_s": rep["wall_s"], "transfers": rep["transfers"],
            "report": p.stdout}


def part_a(comm, ns, dev, cases, report) -> dict:
    n, r = comm.size, comm.rank
    cuda = dev.type == "cuda"
    sizes = [_size(s) for s in ns.sizes.split(",") if s]
    counts = KC.Counts(dev)
    keep: list = []

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[observability n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    sampler, watchdog = telemetry.get_sampler(), telemetry.get_watchdog()
    case("the planes up at init", recorder.RECORDER is not None
         and flight.FLIGHT is not None and ledger.PROFILER is not None
         and sampler is not None and watchdog is not None)

    # -- staging: the xfer lane and the inputs
    acc = accelerator.for_device(dev)
    with ledger.phase("staging"):
        host = acc.host_buffer(ns.staging_bytes, dev)
        host.copy_(torch.arange(ns.staging_bytes, dtype=torch.int64)
                   .to(torch.uint8))
        acc.begin_staging(dev)
        buf = torch.empty(ns.staging_bytes, dtype=torch.uint8, device=dev)
        acc.to_device(host, buf).wait()
        back = acc.host_buffer(ns.staging_bytes, dev)
        got = acc.copy_async(buf, back).wait()
        xs = {nb: [inputs(p, nb, ns.seed, dev) for p in range(n)]
              for nb in sizes}
        grads = grads_for(r, dev)
        sync()
    case("staging round trip", bool((torch.from_numpy(got.copy())
                                     == host.cpu()).all()))
    want = {}
    for nb in sizes:
        for mode in MODES:
            want[nb, mode] = expected_allreduce(
                [x.cpu() for x in xs[nb]], "MPI_SUM", mode, n).to(dev)
    plan = zl._FusePlan(zl._fuse_metas(zl.tree_leaves(grads)),
                        int(device_plane_bucket()))
    ops = [(f"allreduce_{nb}_{mode}",
            lambda nb=nb, mode=mode: comm.Allreduce(
                xs[nb][r], deterministic=mode))
           for nb in sizes for mode in MODES]
    ops.append(("allreduce_multi",
                lambda: comm.Allreduce_multi(grads, deterministic="linear")))

    first: dict = {}
    times = {name: {"on": [], "off": []} for name, _ in ops}
    same = {name: True for name, _ in ops}
    spans_n = dict.fromkeys(LAUNCH_PVARS, 0)
    pvar_n = dict.fromkeys(LAUNCH_PVARS, 0)
    counts.reset()
    with ledger.phase("train"):
        for name, fn in ops:  # warm-up (planes on): maps every arena
            first[name] = fn()
        sync()
        for turn in range(ns.reps):
            for live in ((True, False) if turn % 2 == 0
                         else (False, True)):
                set_planes(live, r, keep)
                t_start = recorder.now()
                before = {k: pvar.read(v) for k, v in LAUNCH_PVARS.items()}
                for name, fn in ops:
                    sync()
                    t0 = time.perf_counter()
                    out = fn()
                    sync()
                    times[name]["on" if live else "off"].append(
                        (time.perf_counter() - t0) * 1e3)
                    a = zl.tree_leaves(out)
                    b = zl.tree_leaves(first[name])
                    same[name] = same[name] and len(a) == len(b) and all(
                        bits_equal(p, q) for p, q in zip(a, b))
                if live:
                    for k, v in LAUNCH_PVARS.items():
                        pvar_n[k] += pvar.read(v) - before[k]
                    for sp in recorder.RECORDER.spans():
                        if sp.name == "launch" and sp.subsys in spans_n \
                                and sp.t0 >= t_start:
                            spans_n[sp.subsys] += 1
        set_planes(True, r, keep)
    launched = counts.read()
    calls = 1 + 2 * ns.reps
    derived = KC.merged(*(
        [KC.add({}, K3=1) if mode == "linear" else KC.ring_allreduce(n)
         for _nb in sizes for mode in MODES]
        + [KC.add({}, K3=len(plan.buckets))]))
    derived = {k: v * calls for k, v in derived.items()}
    for name in same:
        case(f"{name}: bitwise equal on and off", same[name])
    for nb in sizes:
        for mode in MODES:
            name = f"allreduce_{nb}_{mode}"
            case(f"{name}: the {mode} fold, bitwise",
                 bits_equal(first[name], want[nb, mode]))
    case("launch spans == launch pvars in the live turns",
         spans_n == pvar_n and spans_n["coll_cuda"] > 0
         and spans_n["coll_device"] > 0, spans=spans_n, pvars=pvar_n)

    # -- a disabled site's guard, the scraped page, the trace file
    set_planes(False, r, keep)
    report["guard_ns"] = guard_ns()
    set_planes(True, r, keep)
    page = ""
    if sampler is not None:
        sampler.sample()
        if sampler.http_addr is not None:
            host_, port = sampler.http_addr[:2]
            with urllib.request.urlopen(
                    f"http://{host_}:{port}/metrics", timeout=10) as resp:
                page = resp.read().decode()
    parsed = openmetrics.parse(page) if page else {}
    case("the sampler's page scraped and parsed",
         "telemetry_flight_ops" in parsed
         and "coll_cuda_launches" in parsed, families=len(parsed))
    recorder.sync_clock()
    rec = recorder.RECORDER
    os.makedirs(ns.out, exist_ok=True)
    export.write(os.path.join(ns.out, f"trace_r{r}.json"), rec,
                 spans=keep + rec.spans())
    if r == 0:
        with open(os.path.join(ns.out, "metrics_r0.txt"), "w") as f:
            f.write(page)

    def quartiles(v):
        v = sorted(v)
        return [v[len(v) // 4], v[len(v) // 2], v[3 * len(v) // 4]]

    report["sizes"] = sizes
    report["times_ms"] = times
    report["quartiles_ms"] = {k: {m: quartiles(t) for m, t in d.items()}
                              for k, d in times.items()}
    report["launch_spans"] = spans_n
    report["page_lines"] = len(page.splitlines())
    report["page_families"] = len(parsed)
    report["page_head"] = [ln for ln in page.splitlines()
                           if ln.startswith(("ompi_tpu_coll_cuda_launches",
                                             "ompi_tpu_telemetry_flight_ops",
                                             "ompi_tpu_prof_xfer_h2d_bytes",
                                             "ompi_tpu_trace_dropped"))]
    report["xfer_bytes"] = ns.staging_bytes
    return launched, derived


def part_b(comm, ns, dev, cases, report) -> dict:
    """The watchdog: rank ``--stall`` arrives late at a device Allreduce."""
    n, r = comm.size, comm.rank
    counts = KC.Counts(dev)
    fired = []
    h = events.handle_alloc("telemetry_hang", callback=lambda e:
                            fired.append(dict(e.data)))
    xs = [inputs(p, ns.stall_bytes, ns.seed, dev) for p in range(n)]
    want = expected_allreduce([x.cpu() for x in xs], "MPI_SUM", "linear",
                              n).to(dev)
    counts.reset()
    comm.Allreduce(xs[r], deterministic="linear")  # warm-up: the arena
    comm.Barrier()
    if r == ns.stall:
        time.sleep(ns.stall_s)
    t0 = time.perf_counter()
    out = comm.Allreduce(xs[r], deterministic="linear")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    waited = time.perf_counter() - t0
    comm.Barrier()
    h.free()
    wd = telemetry.get_watchdog()
    dumps = sorted(wd._dumped.values()) if wd is not None else []
    named = []
    for path in dumps:
        with open(path) as f:
            named.append(json.load(f)["verdict"]["stragglers"])
    cases.append({"name": "the stalled Allreduce, bitwise the linear fold",
                  "ok": bits_equal(out, want)})
    if r != ns.stall:
        cases.append({"name": "the hang dump names the stalled rank",
                      "ok": bool(named) and all(s == [ns.stall]
                                                for s in named),
                      "named": named})
        cases.append({"name": "telemetry_hang fired",
                      "ok": bool(fired) and all(
                          list(e["stragglers"]) == [ns.stall]
                          for e in fired)})
    report.update({"stall_rank": ns.stall, "stall_s": ns.stall_s,
                   "waited_s": waited, "dumps": dumps, "named": named,
                   "events": len(fired), "hangs": pvar.read(
                       "telemetry_hangs")})
    return counts.read(), KC.merged(KC.add({}, K3=2))


def device_plane_bucket() -> int:
    from ompi_tpu_torch.coll import device

    return device.bucket_var.get()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="1m,64m",
                    help="Allreduce payloads a rank (float32)")
    ap.add_argument("--reps", type=int, default=41,
                    help="turns; each gives one sample on and one off")
    ap.add_argument("--staging-bytes", type=int, default=64 << 20)
    ap.add_argument("--stall", type=int, default=-1,
                    help="part B: the rank that arrives late")
    ap.add_argument("--stall-s", type=float, default=3.5)
    ap.add_argument("--stall-bytes", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if ns.tiny:
        ns.sizes, ns.reps, ns.staging_bytes = "4k,64k", 2, 1 << 16
        ns.stall_bytes = 1 << 12
    comm = mpi.Init()
    dev = device_plane.device()
    cases, report = [], {}
    if ns.stall >= 0:
        launched, derived = part_b(comm, ns, dev, cases, report)
    else:
        launched, derived = part_a(comm, ns, dev, cases, report)
    cases.append({"name": "K1-K3 launches == derived from the schedules",
                  "ok": launched == {k: derived.get(k, 0)
                                     for k in launched},
                  "got": launched, "want": derived})
    n, r = comm.size, comm.rank
    staged = pvar.read("coll_accelerator_staged")
    if r == 0:
        print(f"[observability n={n}] {json.dumps(report)}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "launches": launched,
                       "expected_launches": derived,
                       "required": [k for k, v in derived.items() if v],
                       "report": report, "cases": cases,
                       "coll_accelerator_staged": staged}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
