"""The port's trace plane (``trace/``: the recorder, the Chrome export,
the merge and its CLI) against the JAX package's: the counterparts of
``tests/test_trace.py``'s 14 cases, and the scan of every guard site of
the three observability planes (``RECORDER``, ``FLIGHT``, ``PROFILER``).

In this process: the ring and its drop accounting (one thread and four),
the disabled guard on coll/device's one-rank path, the log2 histograms,
the export, merge and CLI on the same recorded spans (the two packages'
documents equal), and the events plane's drop accounting, each case on
both packages. Launcher jobs, one per package on 2 ranks, run the same
program under ``trace_enable``: the recorder up at init with the rank,
the p2p segment's spans (the same subsystems and names, in the same
order), the clocks synced through the store, the merged timeline. The
port's job also runs the Pready -> flush attribution case (the reference
runs it in this process on jax arrays, the port on CPU tensors under the
device plane) and holds coll/device's ``launch`` spans to its
``coll_device_launches``. One more port job runs
``ompi_tpu_torch/examples/observability.py --tiny`` (4 ranks, the CPU
platform), the card's phase 17: results bitwise equal with the planes on
and off, launch spans equal to the launch pvars, the traces merged by the
CLI into four pids and attributed to phases by ``python -m
ompi_tpu_torch.prof report``.

:func:`planes_off` (used here and by the telemetry and prof files) puts
both packages' guards back to None around each case, the flight
recorder's API tool detached before the recorder's (PMPI layers come off
in the reverse order they went on).
"""

import ast
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

from ompi_tpu.core import events as R_events
from ompi_tpu.core import pvar as R_pvar
from ompi_tpu.trace import __main__ as R_cli
from ompi_tpu.trace import export as R_export
from ompi_tpu.trace import merge as R_merge
from ompi_tpu.trace import recorder as R_rec
from ompi_tpu_torch.core import events as P_events
from ompi_tpu_torch.core import pvar as P_pvar
from ompi_tpu_torch.runtime import launcher as port_launcher
from ompi_tpu_torch.trace import __main__ as P_cli
from ompi_tpu_torch.trace import export as P_export
from ompi_tpu_torch.trace import merge as P_merge
from ompi_tpu_torch.trace import recorder as P_rec
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: side -> (recorder, export, merge, CLI, pvar, events)
SIDES = {"ref": (R_rec, R_export, R_merge, R_cli, R_pvar, R_events),
         "port": (P_rec, P_export, P_merge, P_cli, P_pvar, P_events)}


def planes_down() -> None:
    """Both packages' flight recorder, span recorder and profiler off
    (in that order: the flight recorder's API tool sits over the
    recorder's)."""
    from ompi_tpu.prof import ledger as R_led
    from ompi_tpu.telemetry import flight as R_fl
    from ompi_tpu_torch.prof import ledger as P_led
    from ompi_tpu_torch.telemetry import flight as P_fl

    for fl, rec, led in ((R_fl, R_rec, R_led), (P_fl, P_rec, P_led)):
        fl.disable()
        rec.disable()
        led.disable()


@pytest.fixture
def planes_off():
    """Every guard of both packages None before and after the case."""
    planes_down()
    yield
    planes_down()


pytestmark = pytest.mark.usefixtures("planes_off")


# ---------------------------------------------------------------------------
# launcher jobs

#: the 2-rank program of both packages (``{pkg}``; the port's job adds
#: :data:`_PORT_EXTRA`)
_PROG = '''
import json, os
import numpy as np
from {pkg}.trace import export, merge, recorder
out_dir = {out!r}
doc = {{}}
rec = recorder.RECORDER
doc["live"] = rec is not None and rec.rank == rank
rec.clear()
data = np.ones(64, np.float32)
if rank == 0:
    comm.Send(data, dest=1, tag=3)
else:
    comm.Recv(data, source=0, tag=3)
doc["p2p"] = [[sp.subsys, sp.name] for sp in rec.spans()]
comm.Barrier()
export.write(os.path.join(out_dir, f"trace_r{{rank}}.json"), rec)
comm.Barrier()
paths = [os.path.join(out_dir, f"trace_r{{r}}.json") for r in range(size)]
m = merge.merge(paths)
spans = [e for e in m["traceEvents"] if e.get("ph") == "X"]
doc["pids"] = sorted({{e["pid"] for e in spans}})
doc["bases"] = len({{json.load(open(p))["metadata"]["clock_base_ns"]
                    for p in paths}})
doc["cats"] = sorted({{e["cat"] for e in spans}})
'''

#: the port job's cases under the device plane: Pready -> flush and the
#: launch funnel
_PORT_EXTRA = '''
import torch
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.trace import export as texport
dev = device_plane.device()
bufs = [torch.ones(64, dtype=torch.float32, device=dev),
        torch.ones(64, dtype=torch.float32, device=dev),
        torch.ones(64, dtype=torch.int32, device=dev),
        torch.ones(64, dtype=torch.int32, device=dev)]
preq = comm.Pallreduce_init(bufs)
rec.clear()
s = pvar.session()
preq.start()
for i in (1, 0, 2, 3):
    preq.Pready(i)
preq.wait()
flushes = [sp for sp in rec.spans() if sp.name == "part_bucket_flush"]
doc["flushes"] = sorted([sp.args["trigger_partition"], sp.args["overlap"],
                         sp.args["nbytes"], sp.subsys] for sp in flushes)
doc["preadys"] = [sp.args["partition"] for sp in rec.spans()
                  if sp.name == "pready"]
doc["flush_hist"] = sum(texport.histograms(s.snapshot()).get(
    "part_bucket_flush", {{}}).values())
doc["launch_spans"] = sum(1 for sp in rec.spans() if sp.name == "launch"
                          and sp.subsys == "coll_device")
doc["result"] = [t.tolist()[:2] for t in preq.array]
preq.free()
# every launch of coll/device's slots is one launch span
rec.clear()
s = pvar.session()
x = torch.arange(16, dtype=torch.float32, device=dev) + rank
comm.Allreduce(x, deterministic="linear")
comm.Bcast(x, root=0)
comm.Allgather(x)
comm.Alltoall(x)
comm.Reduce(x, root=0)
comm.Scan(x)
comm.Allreduce_multi({{"a": x, "b": x.to(torch.int32)}})
comm.Barrier(device=True)
doc["funnel"] = [s.read("coll_device_launches"),
                 sum(1 for sp in rec.spans() if sp.name == "launch"
                     and sp.subsys == "coll_device")]
'''

_WRITE = '''
with open(os.path.join(out_dir, f"doc_r{rank}.json"), "w") as fh:
    json.dump(doc, fh)
'''

_PORT_PRELUDE = '''
from ompi_tpu_torch import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size
'''


def port_job(src: str, n: int, mca: dict, timeout: float = 240) -> None:
    """Run ``src`` (a whole program) on n ranks of the port's launcher.
    The launcher enables this process's ledger when the job profiles:
    it is put back."""
    from ompi_tpu_torch.prof import ledger

    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    was = ledger.PROFILER
    try:
        rc = port_launcher.launch([sys.executable, path], n, mca=mca,
                                  timeout=timeout)
    finally:
        os.unlink(path)
        if was is None:
            ledger.disable()
    assert rc == 0, f"port job on {n} ranks exited {rc}"


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """(reference dir, port dir) of the 2-rank job pair."""
    ref = tmp_path_factory.mktemp("trace_ref")
    port = tmp_path_factory.mktemp("trace_port")
    run_ranks(_PROG.format(pkg="ompi_tpu", out=str(ref)) + _WRITE, 2,
              mca={"trace_enable": "1"}, timeout=120, isolate=True)
    port_job(textwrap.dedent(_PORT_PRELUDE)
             + _PROG.format(pkg="ompi_tpu_torch", out=str(port))
             + _PORT_EXTRA.format() + _WRITE + "\nmpi.Finalize()\n", 2,
             {"trace_enable": "1", "device_plane": "on",
              "device_plane_platform": "cpu"})
    return ref, port


def _doc(d, r):
    return json.loads((d / f"doc_r{r}.json").read_text())


# ---------------------------------------------------------------------------
# ring buffer and drop accounting


def test_ring_buffer_bounds_and_trace_dropped():
    got = {}
    for side, (rec_mod, _e, _m, _c, pvar, _ev) in SIDES.items():
        rec = rec_mod.Recorder(capacity=8, rank=0)
        s = pvar.session()
        for i in range(20):
            t = rec_mod.now()
            rec.record(f"s{i}", "test", t, t + 10)
        got[side] = ([sp.name for sp in rec.spans()],
                     s.read("trace_dropped"))
    assert got["port"] == got["ref"] \
        == ([f"s{i}" for i in range(12, 20)], 12)


def test_ring_thread_safety_exact_accounting():
    got = {}
    for side, (rec_mod, _e, _m, _c, pvar, _ev) in SIDES.items():
        rec = rec_mod.Recorder(capacity=16, rank=0)
        s = pvar.session()
        n_threads, per = 4, 100
        start = threading.Barrier(n_threads)

        def emitter(k, rec=rec, rec_mod=rec_mod, start=start):
            start.wait()
            for i in range(per):
                t = rec_mod.now()
                rec.record(f"t{k}_{i}", "test", t, t)

        ts = [threading.Thread(target=emitter, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        got[side] = (len(rec.spans()), s.read("trace_dropped"))
    assert got["port"] == got["ref"] == (16, 4 * 100 - 16)


def test_disabled_guard_constructs_nothing(monkeypatch):
    """Tracing off builds no span on coll/device's path: a one-rank comm
    (no device plane) through the baseline, fused and partitioned slots,
    and the reference's coll/xla path beside it."""
    import jax.numpy as jnp

    from ompi_tpu.coll import xla as cx
    from ompi_tpu_torch.coll import device as D

    assert P_rec.RECORDER is None and R_rec.RECORDER is None

    def boom(*a, **k):
        raise AssertionError("Span constructed while tracing disabled")

    monkeypatch.setattr(P_rec, "Span", boom)
    monkeypatch.setattr(R_rec, "Span", boom)
    comm = types.SimpleNamespace(size=1, rank=0, cid=0)
    s = P_pvar.session()
    x = torch.ones(16)
    assert torch.equal(D.allreduce_dev(comm, x), x)
    D.allgather_dev(comm, x)
    D.allreduce_multi_dev(comm, {"a": x})
    D.barrier_dev(comm)
    assert s.read("coll_device_launches") == 4  # the path really ran
    ctx = cx._Ctx.local()
    rs = R_pvar.session()
    launcher = cx._allreduce_prep(types.SimpleNamespace(_coll_xla_ctx=ctx),
                                  jnp.ones(16, jnp.float32))
    launcher()
    launcher()
    assert rs.read("coll_xla_launches") >= 2


# ---------------------------------------------------------------------------
# log2 histograms


def test_histogram_binning():
    got = {}
    for side, (rec_mod, export, _m, _c, pvar, _ev) in SIDES.items():
        s = pvar.session()
        rec_mod.hist("t_binop", 1000, 5000)
        a = s.read("trace_hist_t_binop_sz10_lat13")
        rec_mod.hist("t_binop", 0, 0)
        b = s.read("trace_hist_t_binop_sz0_lat0")
        got[side] = (a, b, export.histograms(s.snapshot())["t_binop"])
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (1, 1)
    assert got["port"][2] == {(10, 13): 1, (0, 0): 1}


def test_histogram_percentiles():
    got = {}
    for side, (rec_mod, export, _m, _c, pvar, _ev) in SIDES.items():
        s = pvar.session()
        for _ in range(10):
            rec_mod.hist("t_pctop", 64, 100)
        rec_mod.hist("t_pctop", 64, 100000)
        got[side] = (export.percentiles("t_pctop", (0.5, 0.99),
                                        s.snapshot()),
                     export.percentiles("t_no_such_op"))
    assert got["port"] == got["ref"] == ([96.0, 3.0 * 2 ** 15], None)


# ---------------------------------------------------------------------------
# Pready -> flush attribution


def _reference_pready_case():
    """The reference's case in this process (coll/xla on one jax
    device): its flushes, Pready markers, histogram and launch spans."""
    import jax

    from ompi_tpu import op as op_mod
    from ompi_tpu.coll import xla as cx

    ctx = cx._Ctx.local()
    import jax.numpy as jnp

    bufs = [jnp.ones(64, jnp.float32), jnp.ones(64, jnp.float32),
            jnp.ones(64, jnp.int32), jnp.ones(64, jnp.int32)]
    leaves, treedef = jax.tree.flatten(bufs)
    preq = cx.PartitionedAllreduceRequest(ctx, leaves, treedef,
                                          op_mod.SUM, None)
    rec = R_rec.enable(capacity=1024, api_spans=False)
    s = R_pvar.session()
    try:
        preq.start()
        for i in (1, 0, 2, 3):
            preq.Pready(i)
        preq.wait()
    finally:
        R_rec.disable()
    flushes = [sp for sp in rec.spans() if sp.name == "part_bucket_flush"]
    return {
        "flushes": sorted([sp.args["trigger_partition"], sp.args["overlap"],
                           sp.args["nbytes"], sp.subsys] for sp in flushes),
        "preadys": [sp.args["partition"] for sp in rec.spans()
                    if sp.name == "pready"],
        "flush_hist": sum(R_export.histograms(s.snapshot()).get(
            "part_bucket_flush", {}).values()),
        "launch_spans": sum(1 for sp in rec.spans()
                            if sp.name == "launch"
                            and sp.subsys == "coll_xla"),
    }


def test_pready_flush_span_attribution(jobs):
    """Flush spans carry the Pready that released each bucket and
    whether later partitions were pending; the latency lands in the
    ``part_bucket_flush`` histogram; one launch span a flush. The port's
    on two ranks of CPU tensors, the reference's on one jax device."""
    _, port = jobs
    ref = _reference_pready_case()
    assert ref["flushes"] == [[0, True, 512, "part"],
                              [3, False, 512, "part"]]
    for r in range(2):
        d = _doc(port, r)
        for key in ("flushes", "preadys", "flush_hist", "launch_spans"):
            assert d[key] == ref[key], (r, key, d[key], ref[key])
        assert d["result"] == [[2.0, 2.0], [2.0, 2.0], [2, 2], [2, 2]]


# ---------------------------------------------------------------------------
# Chrome export and merge


def _fake_recorder(rec_mod, rank, t_base=1_000_000):
    rec = rec_mod.Recorder(capacity=64, rank=rank)
    rec.record("alpha", "api", t_base, t_base + 5_000)
    rec.record("beta", "pml", t_base + 1_000, t_base + 2_000)
    rec.record("gamma", "api", t_base + 6_000, t_base + 9_000)
    return rec


def test_export_chrome_shape():
    docs = {}
    for side, (rec_mod, export, *_rest) in SIDES.items():
        docs[side] = export.to_chrome(_fake_recorder(rec_mod, 0))
    doc = docs["port"]
    assert doc["traceEvents"] == docs["ref"]["traceEvents"]
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(spans) == 3
    assert {e["name"] for e in metas} == {"process_name", "thread_name"}
    by_tid = {}
    for e in spans:
        by_tid.setdefault(e["tid"], []).append(e["ts"])
    for ts in by_tid.values():
        assert ts == sorted(ts)
    assert next(e for e in spans if e["name"] == "alpha")["dur"] == 5.0
    assert doc["metadata"]["rank"] == 0


def test_export_requires_a_recorder():
    for _side, (_r, export, *_rest) in SIDES.items():
        with pytest.raises(RuntimeError):
            export.to_chrome()


def test_merge_two_ranks_distinct_pids(tmp_path):
    out = {}
    for side, (rec_mod, export, merge, *_rest) in SIDES.items():
        p0, p1 = str(tmp_path / f"{side}0.json"), str(tmp_path /
                                                      f"{side}1.json")
        export.write(p0, _fake_recorder(rec_mod, 0))
        export.write(p1, _fake_recorder(rec_mod, 1, t_base=1_500_000))
        out[side] = merge.merge([p0, p1])
    doc = out["port"]

    def shape(d):  # the rebase shifts ts by each recorder's clock sample
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in d["traceEvents"]]
    assert shape(doc) == shape(out["ref"])
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["pid"] for e in spans} == {0, 1}
    assert doc["metadata"]["ranks"] == [0, 1]
    ph = [e["ph"] for e in doc["traceEvents"]]
    assert ph == sorted(ph, key=lambda p: 0 if p == "M" else 1)
    ts = [e["ts"] for e in spans]
    assert ts == sorted(ts)


def test_merge_pid_collision_bumps(tmp_path):
    for side, (rec_mod, export, merge, *_rest) in SIDES.items():
        p0, p1 = str(tmp_path / f"{side}a.json"), str(tmp_path /
                                                      f"{side}b.json")
        export.write(p0, _fake_recorder(rec_mod, 0))
        export.write(p1, _fake_recorder(rec_mod, 0))
        assert merge.merge([p0, p1])["metadata"]["ranks"] == [0, 1], side


def test_merge_cli(tmp_path, capsys):
    texts = {}
    for side, (rec_mod, export, _m, cli, *_rest) in SIDES.items():
        p0, p1 = str(tmp_path / f"{side}r0.json"), str(tmp_path /
                                                       f"{side}r1.json")
        rec_mod.hist("t_cliop", 64, 100)
        export.write(p0, _fake_recorder(rec_mod, 0))
        export.write(p1, _fake_recorder(rec_mod, 1))
        out = str(tmp_path / f"{side}merged.json")
        assert cli.main(["merge", "-o", out, p0, p1]) == 0
        assert {e["pid"] for e in json.load(open(out))["traceEvents"]} \
            == {0, 1}
        capsys.readouterr()
        assert cli.main(["report", p0]) == 0
        texts[side] = capsys.readouterr().out.replace(side + "r0", "")
    assert "api" in texts["port"] and "hist t_cliop" in texts["port"]
    # the span table is the reference's (the histograms differ: each
    # package's process-wide pvars)
    assert texts["port"].split("  hist")[0] \
        == texts["ref"].split("  hist")[0]


def test_merge_cli_bad_inputs(tmp_path, capsys):
    """A missing or corrupt input is one line on stderr and exit 1, as
    the reference's CLI."""
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for _side, (_r, _e, _m, cli, *_rest) in SIDES.items():
        out = str(tmp_path / "m.json")
        assert cli.main(["merge", "-o", out,
                         str(tmp_path / "missing.json")]) == 1
        assert cli.main(["merge", "-o", out, str(bad)]) == 1
        err = capsys.readouterr().err
        assert err.count("trace merge:") == 2 and "corrupt" in err


# ---------------------------------------------------------------------------
# the events plane's drop accounting, which the recorder builds on


@pytest.mark.parametrize("side", ["ref", "port"])
def test_event_drops_concurrent_emitters_exact(side):
    events = SIDES[side][5]
    events.register_type("t_trace_drops", "test type", ("i",))
    fired = []
    h = events.handle_alloc("t_trace_drops", buffer_size=4)
    h.set_dropped_handler(lambda n: fired.append(n))
    try:
        n_threads, per = 4, 50
        start = threading.Barrier(n_threads)

        def emitter():
            start.wait()
            for i in range(per):
                events.emit("t_trace_drops", i=i)

        ts = [threading.Thread(target=emitter) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert h.dropped == n_threads * per - 4, h.dropped
        assert len(fired) == 1, fired
        assert h.read() is not None
        events.emit("t_trace_drops", i=-1)
        assert h.dropped == n_threads * per - 4
        events.emit("t_trace_drops", i=-2)
        assert h.dropped == n_threads * per - 3
        assert len(fired) == 2, fired
    finally:
        h.free()


@pytest.mark.parametrize("side", ["ref", "port"])
def test_event_dropped_handler_single_thread_transitions(side):
    events = SIDES[side][5]
    events.register_type("t_trace_drops2", "test type", ("i",))
    fired = []
    h = events.handle_alloc("t_trace_drops2", buffer_size=2)
    h.set_dropped_handler(lambda n: fired.append(n))
    try:
        for i in range(6):
            events.emit("t_trace_drops2", i=i)
        assert h.dropped == 4
        assert fired == [1], fired
    finally:
        h.free()


def test_trace_span_event_fields_match_reference():
    """A span's ``trace_span`` MPI_T event carries the reference's
    registered fields, and only while a tool listens. (The reference's
    own emit passes the field ``name`` beside the event's name and
    raises TypeError once a tool listens; the port's ``emit`` takes the
    event's name positionally, so the field rides the payload.)"""
    ref_fields = R_events.get_info(R_events.index_of("trace_span"))["fields"]
    rec = P_rec.Recorder(capacity=4, rank=0)
    assert not P_events.active("trace_span")
    rec.record("quiet", "test", 0, 1)
    seen = []
    h = P_events.handle_alloc("trace_span",
                              callback=lambda e: seen.append(e.data))
    try:
        rec.record("heard", "test", 10, 25)
    finally:
        h.free()
    assert seen == [{"name": "heard", "subsys": "test", "t0_ns": 10,
                     "dur_ns": 15}]
    assert tuple(seen[0]) == tuple(ref_fields)


# ---------------------------------------------------------------------------
# end to end: init-time enable, clock sync, the merged timeline


def test_trace_enabled_two_ranks_end_to_end(jobs):
    """``trace_enable`` raises the recorder at init with the rank; the
    p2p segment's spans are the reference's, subsystem and name, in
    order; the clocks sync to rank 0's; the merged timeline has both
    pids and the api and pml lanes."""
    ref, port = jobs
    for r in range(2):
        a, b = _doc(ref, r), _doc(port, r)
        assert b["live"] and a["live"]
        assert b["p2p"] == a["p2p"], (r, b["p2p"], a["p2p"])
        assert b["pids"] == a["pids"] == [0, 1]
        assert b["bases"] == a["bases"] == 1
        assert {"api", "pml"} <= set(b["cats"]), b["cats"]
    assert _doc(port, 0)["p2p"][-1] == ["api", "Send"]


def test_launch_spans_equal_coll_device_launches(jobs):
    """coll/device's one launch funnel: every slot's launch is one
    ``launch`` span in ``coll_device``, the count its pvar's."""
    _, port = jobs
    for r in range(2):
        launches, spans = _doc(port, r)["funnel"]
        assert launches == spans and launches >= 8, (r, launches, spans)


def test_observability_example_tiny(tmp_path):
    """The card's phase 17 on the CPU platform: the example's checks hold
    on every rank (bitwise on / off, launch spans == launch pvars, K1-K3
    as derived, the page scraped), the traces merge into four pids and
    the prof report attributes staging and train."""
    from ompi_tpu_torch.examples.observability import check_traces

    out = str(tmp_path / "obs")
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
         "4", "--timeout", "200", "--mca", "device_plane", "on", "--mca",
         "coll_cuda", "on", "--mca", "device_plane_platform", "cpu",
         "--mca", "trace_enable", "1", "--mca", "telemetry_enable", "1",
         "--mca", "prof_enable", "1", "--mca", "telemetry_port", "-1",
         os.path.join("ompi_tpu_torch", "examples", "observability.py"),
         "--tiny", "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    docs = [json.load(open(os.path.join(out, f"rank{i}.json")))
            for i in range(4)]
    for d in docs:
        assert all(c["ok"] for c in d["cases"]), d["cases"]
        assert d["launches"] == d["expected_launches"]
    tr = check_traces(out, 4)
    assert tr["pids"] == [0, 1, 2, 3]
    assert {"api", "coll_cuda", "coll_device", "prof", "xfer"} \
        <= set(tr["cats"])
    assert set(tr["phases"]) >= {"staging", "train"}
    assert tr["transfers"]["h2d"]["bytes"] == 4 * (1 << 16)


# ---------------------------------------------------------------------------
# the guard scan


_GUARDS = ("RECORDER", "FLIGHT", "PROFILER", "OBSERVER", "SKEW",
           "SANITIZER")
#: the modules that define the guards
_DEFINERS = {"trace/recorder.py", "telemetry/flight.py", "prof/ledger.py",
             "tune/observe.py", "skew/record.py", "check/sanitizer.py"}


def _compares_name(test, name: str) -> bool:
    """``test`` (or its first operand) is ``name is [not] None``."""
    first = test.values[0] if isinstance(test, ast.BoolOp) else test
    return isinstance(first, ast.Compare) \
        and isinstance(first.left, ast.Name) and first.left.id == name \
        and isinstance(first.ops[0], (ast.Is, ast.IsNot))


def _branches_on(stmt, name: str) -> bool:
    """The statement right after ``name = <guard>``: an ``if`` on it, or
    an assignment whose value is a conditional expression on it."""
    if isinstance(stmt, ast.If):
        return _compares_name(stmt.test, name)
    if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
            and isinstance(stmt.value, ast.IfExp):
        return _compares_name(stmt.value.test, name)
    return False


def guard_sites(path):
    """(kind, lineno, ok) for every load of a guard attribute
    (``<module>.RECORDER`` and the like) in a file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Attribute) and node.attr in _GUARDS
                and isinstance(node.ctx, ast.Load)):
            continue
        up = parents[node]
        if isinstance(up, ast.Compare) and up.left is node \
                and isinstance(up.ops[0], (ast.Is, ast.IsNot)):
            owner = parents[up]
            if isinstance(owner, ast.BoolOp):
                owner = parents[owner]
            yield "test", node.lineno, isinstance(owner, (ast.If,
                                                          ast.IfExp))
            continue
        stmt = up
        while not isinstance(stmt, ast.stmt):
            stmt = parents[stmt]
        body = next((getattr(parents[stmt], f) for f in
                     ("body", "orelse", "finalbody")
                     if stmt in getattr(parents[stmt], f, [])), [])
        nxt = body[body.index(stmt) + 1:body.index(stmt) + 2]
        ok = isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name) and nxt \
            and _branches_on(nxt[0], stmt.targets[0].id)
        yield "load", node.lineno, bool(ok)


def test_guard_sites_are_one_branch():
    """Every RECORDER / FLIGHT / PROFILER / OBSERVER / SKEW / SANITIZER
    site of the port (the examples are users, not sites) is one attribute
    load and one branch: the load is the operand of an ``is [not] None``
    test, or it is assigned to a local and the next statement branches on
    that local. The main path's modules read the guards: the tune plane's
    OBSERVER in coll/cuda's, coll/device's and coll/hier's launch
    funnels, the skew plane's SKEW at the flight recorder's exit, the
    trace export's skew lane and the watchdog's live view, and the check
    plane's SANITIZER in the watchdog's dump and ``check.get_sanitizer``
    (the sanitizer's own API hook reads its module global, a name)."""
    per_file = {}
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ompi_tpu_torch")):
        if os.path.basename(dirpath) == "examples":
            continue
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, os.path.join(ROOT,
                                                     "ompi_tpu_torch"))
            for kind, line, ok in guard_sites(path):
                assert ok, (rel, line, kind)
                per_file[rel] = per_file.get(rel, 0) + 1
    for mod in ("coll/device.py", "coll/cuda.py", "accelerator/cuda.py",
                "accelerator/__init__.py", "pml/ob1.py", "btl/base.py",
                "part/host.py", "osc/cuda.py", "zero/zero3.py",
                "serve/loop.py", "ingest/engine.py", "elastic/context.py",
                "coll/cuda_kernels.py", "coll/hier.py", "zero/optimizer.py"):
        assert per_file.get(mod, 0) >= 1, (mod, per_file)
    assert sum(per_file.values()) >= 60, per_file
    observer, skew, sanitizer = {}, {}, {}
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ompi_tpu_torch")):
        if os.path.basename(dirpath) == "examples":
            continue
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, os.path.join(ROOT,
                                                         "ompi_tpu_torch"))
                with open(path, encoding="utf-8") as f:
                    text = f.read()
                for table, attr in ((observer, ".OBSERVER"),
                                    (skew, ".SKEW"),
                                    (sanitizer, ".SANITIZER")):
                    if attr in text:
                        table[rel] = text.count(attr)
    for mod in ("coll/cuda.py", "coll/device.py", "coll/hier.py"):
        assert observer.get(mod, 0) >= 1, (mod, observer)
    for mod in ("telemetry/flight.py", "trace/export.py",
                "telemetry/watchdog.py"):
        assert skew.get(mod, 0) >= 1, (mod, skew)
    for mod in ("telemetry/watchdog.py", "check/__init__.py"):
        assert sanitizer.get(mod, 0) >= 1, (mod, sanitizer)


def test_guard_scan_catches_a_second_load(tmp_path):
    """The scan refuses a site that reads a guard twice on its disabled
    path or builds something before it branches."""
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent('''
        from x import recorder as _trace
        def f():
            rec = _trace.RECORDER
            t0 = _trace.now()
            if rec is not None:
                pass
        def g():
            return _trace.RECORDER.spans()
    '''))
    assert [ok for _k, _l, ok in guard_sites(str(bad))] == [False, False]
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent('''
        from x import recorder as _trace
        def f():
            rec = _trace.RECORDER
            if rec is None:
                return
        def g():
            fl = _trace.FLIGHT
            tok = fl.enter() if fl is not None else None
        def h():
            if _trace.PROFILER is not None and True:
                pass
    '''))
    assert [ok for _k, _l, ok in guard_sites(str(good))] == [True] * 3
