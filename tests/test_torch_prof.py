"""The port's attribution profiler (``prof/``: the phase ledger, the
transfer accounting, the compile counterparts and the report CLI)
against the JAX package's: the counterparts of ``tests/test_prof.py``'s
14 cases.

In this process: the ledger's nesting, reentrancy, pvars and spans and
its cross-thread ``current_phase``, the disabled guard over the
accelerator's copy sites and coll/device's one-rank path, the transfer
accounting of the accelerator's copies (the null component's, CPU
tensors) beside the reference's chunked upload, the sampler's rolling
bandwidth gauge, the kernel library load counted as a compile, the
compile cache's stated mapping (``prof/__init__.py``: the port has no
XLA cache, so ``wire_compile_cache`` returns None and the cache counters
stay 0), the watchdog dump's phase, the well-known pvars, and the
attribution CLI on the same traces (the two reports equal). Launcher
jobs, one per package on 2 ranks, run the same program under
``prof_enable`` and ``trace_enable``: an upload in ``staging``, a
``train`` phase, the report over both ranks' traces; the port's job
also runs coll/device Allreduces under the device plane, the first
planning its arena (``prof_compile_misses``), the second reusing it
(``prof_compile_hits``), as the reference's ``_Ctx`` compiles then hits.
"""

import ctypes.util
import json
import textwrap
import threading
import time
import types

import numpy as np
import pytest
import torch

from ompi_tpu.core import pvar as R_pvar
from ompi_tpu.prof import __main__ as R_cli
from ompi_tpu.prof import ledger as R_led
from ompi_tpu.trace import export as R_export
from ompi_tpu.trace import recorder as R_rec
from ompi_tpu_torch.core import pvar as P_pvar
from ompi_tpu_torch.prof import __main__ as P_cli
from ompi_tpu_torch.prof import ledger as P_led
from ompi_tpu_torch.trace import export as P_export
from ompi_tpu_torch.trace import recorder as P_rec
from tests.harness import run_ranks
from tests.test_torch_ingest import (  # noqa: F401 — autouse
    port_accelerator_state)
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse
from tests.test_torch_trace import planes_off, port_job  # noqa: F401

pytestmark = pytest.mark.usefixtures("planes_off")

#: side -> (ledger, recorder, export, CLI, pvar)
SIDES = {"ref": (R_led, R_rec, R_export, R_cli, R_pvar),
         "port": (P_led, P_rec, P_export, P_cli, P_pvar)}


# ---------------------------------------------------------------------------
# launcher jobs

_PROG = '''
import json, os, time
import numpy as np
from {pkg}.prof import ledger
from {pkg}.prof import __main__ as prof_cli
from {pkg}.trace import export, recorder
out_dir = {out!r}
doc = {{}}
doc["live"] = ledger.PROFILER is not None and ledger.PROFILER.rank == rank
with ledger.phase("staging"):
    upload()
    time.sleep(0.15)
with ledger.phase("train"):
    time.sleep(0.02)
comm.Barrier()
export.write(os.path.join(out_dir, f"trace_r{{rank}}.json"),
             recorder.RECORDER)
comm.Barrier()
if rank == 0:
    paths = [os.path.join(out_dir, f"trace_r{{r}}.json")
             for r in range(size)]
    out = os.path.join(out_dir, "attr.json")
    doc["rc"] = prof_cli.main(["report", "-o", out] + paths)
    rep = json.load(open(out))
    doc["ranks"] = rep["ranks"]
    doc["phases"] = [p["phase"] for p in rep["phases"]]
    doc["staging_s"] = rep["phases"][0]["max_s"]
    doc["h2d_bytes"] = rep["transfers"]["h2d"]["bytes"]
comm.Barrier()
'''

_REF_UPLOAD = '''
from ompi_tpu.accelerator import tpu as tpu_mod
_acc = tpu_mod.TpuAccelerator()


def upload():
    _acc.to_device(np.ones(1 << 18, np.float32))
'''

_PORT_UPLOAD = '''
import torch
from ompi_tpu_torch import accelerator, mpi
from ompi_tpu_torch.core import pvar
comm = mpi.Init()
rank, size = comm.rank, comm.size
_acc = accelerator.current()


def upload():
    _acc.to_device(torch.ones(1 << 20, dtype=torch.uint8),
                   torch.empty(1 << 20, dtype=torch.uint8))
'''

#: the port job's compile counterparts: an arena planned, then reused
_PORT_COMPILE = '''
x = torch.ones(16)
s = pvar.session()
comm.Allreduce(x, deterministic="linear")
doc["compile"] = [s.read("prof_compile_misses") >= 1,
                  s.read("prof_compile_ns") > 0]
s = pvar.session()
comm.Allreduce(x, deterministic="linear")
doc["recompile"] = [s.read("prof_compile_hits") >= 1,
                    s.read("prof_compile_misses")]
'''

_WRITE = '''
with open(os.path.join(out_dir, f"doc_r{rank}.json"), "w") as fh:
    json.dump(doc, fh)
'''

_MCA = {"prof_enable": "1", "trace_enable": "1"}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    ref = tmp_path_factory.mktemp("prof_ref")
    port = tmp_path_factory.mktemp("prof_port")
    run_ranks(textwrap.dedent(_REF_UPLOAD)
              + _PROG.format(pkg="ompi_tpu", out=str(ref)) + _WRITE, 2,
              mca=_MCA, timeout=120, isolate=True)
    port_job(textwrap.dedent(_PORT_UPLOAD)
             + _PROG.format(pkg="ompi_tpu_torch", out=str(port))
             + _PORT_COMPILE + _WRITE + "\nmpi.Finalize()\n", 2,
             dict(_MCA, device_plane="on", device_plane_platform="cpu"))
    return ref, port


def _doc(d, r):
    return json.loads((d / f"doc_r{r}.json").read_text())


# ---------------------------------------------------------------------------
# the phase ledger


def test_phase_nesting_reentrancy_pvars_and_spans():
    got = {}
    for side, (led, rec_mod, _e, _c, pvar) in SIDES.items():
        led.enable(rank=0)
        rec_mod.enable(rank=0, api_spans=False)
        s = pvar.session()
        seen = [led.current_phase()]
        with led.phase("staging"):
            seen.append(led.current_phase())
            with led.phase("compile"):
                seen.append(led.current_phase())
                time.sleep(0.002)
            seen.append(led.current_phase())
        seen.append(led.current_phase())
        with led.phase("staging"):
            pass
        ph = led.phase_seconds()
        spans = [(sp.name, sp.subsys) for sp in rec_mod.RECORDER.spans()]
        got[side] = (seen, ph["staging"] >= ph["compile"] > 0,
                     led.PROFILER.phase_counts(),
                     s.read("prof_phase_staging_ns") > 0,
                     s.read("prof_phase_compile_ns") > 0, spans)
        rec_mod.disable()
        led.disable()
    assert got["port"] == got["ref"]
    assert got["port"][0] == [None, "staging", "compile", "staging", None]
    assert got["port"][2] == {"staging": 2, "compile": 1}
    assert got["port"][5] == [("compile", "prof"), ("staging", "prof"),
                              ("staging", "prof")]


def test_current_phase_cross_thread():
    for side, (led, *_rest) in SIDES.items():
        led.enable()
        seen = []
        with led.phase("train"):
            t = threading.Thread(
                target=lambda: seen.append(led.current_phase()))
            t.start()
            t.join()

        def worker(led=led):
            with led.phase("io"):
                seen.append(led.current_phase())

        with led.phase("train"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert seen == ["train", "io"], side
        led.disable()


def test_disabled_guard_constructs_nothing(monkeypatch):
    """The profiler off touches no ledger machinery on any site: the
    shared no-op phase, the accelerator's copies (to_device, copy_async,
    put_chunk) and coll/device's one-rank path."""
    from ompi_tpu_torch import accelerator
    from ompi_tpu_torch.coll import device as D

    assert P_led.PROFILER is None

    def boom(*a, **k):
        raise AssertionError("prof machinery touched while disabled")

    monkeypatch.setattr(P_led, "now", boom)
    monkeypatch.setattr(P_led, "_PhaseOpen", boom)
    monkeypatch.setattr(P_led.Profiler, "xfer", boom)
    monkeypatch.setattr(P_led.Profiler, "xfer_chunk", boom)
    assert P_led.phase("staging") is P_led._NOP
    with P_led.phase("staging"):
        pass
    acc = accelerator.for_device("cpu")
    host = torch.arange(4096, dtype=torch.int64).to(torch.uint8)
    dev = torch.empty(4096, dtype=torch.uint8)
    acc.to_device(host, dev).wait()
    back = acc.copy_async(dev, acc.host_buffer(4096, "cpu")).wait()
    assert bytes(back) == bytes(host.numpy())
    acc.put_chunk(host.numpy()[:1024], dev[:1024]).wait()
    s = P_pvar.session()
    comm = types.SimpleNamespace(size=1, rank=0, cid=0)
    D.allreduce_dev(comm, torch.ones(16))
    D.allreduce_dev(comm, torch.ones(16))
    assert s.read("coll_device_launches") == 2  # the path really ran


# ---------------------------------------------------------------------------
# transfer accounting


def test_transfer_accounting_chunked_h2d_and_d2h():
    """Byte accounting is exact and chunk spans never count bytes: the
    port's upload (one ``to_device`` of 9 MiB, its two ``put_chunk``
    halves as chunk spans) and readback (one ``copy_async``) account as
    the reference's chunked upload and readback; the histograms reach
    the OpenMetrics page as histogram families."""
    from ompi_tpu.accelerator import tpu as tpu_mod
    from ompi_tpu.telemetry import openmetrics as R_om
    from ompi_tpu_torch import accelerator
    from ompi_tpu_torch.telemetry import openmetrics as P_om

    nbytes = 9 << 20
    got = {}
    # the reference's, as its test drives it
    R_led.enable(rank=0)
    racc = tpu_mod.TpuAccelerator()
    racc.to_host(racc.to_device(np.ones(4, np.float32)))  # warm backend
    R_rec.enable(rank=0, api_spans=False)
    s = R_pvar.session()
    host = np.ones(nbytes // 4, np.float32)
    racc.to_host(racc.to_device(host))
    got["ref"] = _xfer_summary(R_rec.RECORDER.spans(), s)
    got["ref_page"] = R_om.render(R_pvar.snapshot(), {"rank": "0"})
    # the port's, on CPU tensors through the null component
    P_led.enable(rank=0)
    P_rec.enable(rank=0, api_spans=False)
    acc = accelerator.for_device("cpu")
    s = P_pvar.session()
    src = torch.ones(nbytes, dtype=torch.uint8)
    dst = torch.empty(nbytes, dtype=torch.uint8)
    acc.to_device(src, dst).wait()
    half = nbytes // 2
    for lo in (0, half):
        acc.put_chunk(src.numpy()[lo:lo + half], dst[lo:lo + half]).wait()
    acc.copy_async(dst, acc.host_buffer(nbytes, "cpu")).wait()
    got["port"] = _xfer_summary(P_rec.RECORDER.spans(), s)
    got["port_page"] = P_om.render(P_pvar.snapshot(), {"rank": "0"})
    assert P_led.PROFILER.rolling_bw_bps("h2d") > 0
    assert P_pvar.read("prof_xfer_h2d_bw_mbps") > 0
    for side in ("ref", "port"):
        assert got[side]["h2d_bytes"] == got[side]["d2h_bytes"] == nbytes
        assert got[side]["h2d_spans"] == got[side]["d2h_spans"] == 1
        assert got[side]["chunks"] == 2
        assert got[side]["chunk_bytes"] == nbytes
        assert got[side]["ns"], side
        for d in ("h2d", "d2h"):
            fam = "ompi_tpu_trace_hist_xfer_" + d
            assert f"# TYPE {fam} histogram" in got[side + "_page"]


def _xfer_summary(spans, s) -> dict:
    h2d = [sp for sp in spans if sp.subsys == "xfer" and sp.name == "h2d"]
    d2h = [sp for sp in spans if sp.subsys == "xfer" and sp.name == "d2h"]
    chunks = [sp for sp in spans if sp.name == "h2d_chunk"]
    return {"h2d_bytes": s.read("prof_xfer_h2d_bytes"),
            "d2h_bytes": s.read("prof_xfer_d2h_bytes"),
            "ns": s.read("prof_xfer_h2d_ns") > 0
            and s.read("prof_xfer_d2h_ns") > 0,
            "h2d_spans": len(h2d), "d2h_spans": len(d2h),
            "chunks": len(chunks),
            "chunk_bytes": sum(sp.args["bytes"] for sp in chunks)}


def test_sampler_publishes_rolling_bandwidth_gauge():
    from ompi_tpu.telemetry.sampler import Sampler as R_Sampler
    from ompi_tpu_torch.telemetry import openmetrics as P_om
    from ompi_tpu_torch.telemetry.sampler import Sampler as P_Sampler

    vals = {}
    for side, sampler in (("ref", R_Sampler), ("port", P_Sampler)):
        led = SIDES[side][0]
        p = led.enable()
        p.xfer("h2d", 1 << 20, 0, 1_000_000)  # 1 MiB in 1 ms
        smp = sampler(rank=0, jobid="jp", size=1, interval=3600, port=0,
                      path="", rollup=False)
        text = smp.sample()
        parsed = P_om.parse(text)
        metric = P_om.PREFIX + "prof_xfer_h2d_rolling_bps"
        assert f"# TYPE {metric} gauge" in text, side
        assert "prof_xfer_d2h_rolling_bps" not in parsed, side
        vals[side] = parsed["prof_xfer_h2d_rolling_bps"][
            '{job="jp",rank="0"}']
        led.disable()
    assert vals["port"] == vals["ref"] == int((1 << 20) * 1e9 / 1_000_000)


# ---------------------------------------------------------------------------
# compile observability


def test_kernel_library_load_counts_as_a_compile(monkeypatch):
    """A kernel library's first load (its nvcc build on the card) is the
    port's compile: with the ledger on it counts ``prof_compile_misses``
    and ``prof_compile_ns`` and, with the recorder on, leaves a
    ``compile`` span naming the source; off, it counts nothing."""
    from ompi_tpu_torch.coll import cuda_kernels as K

    libc = ctypes.util.find_library("c")
    monkeypatch.setattr(K, "build", lambda src=None, verbose=False: libc)
    s = P_pvar.session()
    K.load(K.GEMM_SRC)
    assert s.read("prof_compile_misses") == 0
    P_led.enable()
    rec = P_rec.enable(api_spans=False)
    K.load(K.GEMM_SRC)
    assert s.read("prof_compile_misses") == 1
    assert s.read("prof_compile_ns") > 0
    spans = [sp for sp in rec.spans() if sp.name == "compile"]
    assert [(sp.subsys, sp.args) for sp in spans] == [
        ("coll_cuda", {"cache": "miss", "key": "gemm_kernels.cu"})]


def test_ctx_compile_pvars_miss_then_hit(jobs):
    """coll/device's arena planned on a comm's first call of a size class
    is a compile miss; the next call's reuse a hit (the reference's
    ``_Ctx`` compiles, then hits)."""
    _, port = jobs
    for r in range(2):
        d = _doc(port, r)
        assert d["compile"] == [True, True], d
        assert d["recompile"] == [True, 0], d


def test_compile_cache_wiring_and_accounting(tmp_path):
    """The stated mapping: the reference's compile-cache cvars exist in
    the port with its defaults, so its ``--mca`` settings parse; setting
    the directory wires nothing (no XLA cache) and creates nothing, and
    the cache counters stay 0."""
    from ompi_tpu import prof as R_prof
    from ompi_tpu_torch import prof as P_prof

    for name in ("compile_cache_dir", "compile_cache_min_secs"):
        rv = getattr(R_prof, "_cache_dir_var" if name.endswith("dir")
                     else "_cache_min_var")
        pv = getattr(P_prof, "_cache_dir_var" if name.endswith("dir")
                     else "_cache_min_var")
        assert (pv.name, pv.default, pv.typ) == (rv.name, rv.default,
                                                 rv.typ)
    d = str(tmp_path / "xla_cache")
    P_prof._cache_dir_var.set(d)
    try:
        s = P_pvar.session()
        assert P_prof.wire_compile_cache() is None
        assert P_prof.wire_compile_cache() is None  # idempotent
        assert not (tmp_path / "xla_cache").exists()
        assert s.read("prof_compile_cache_hits") == 0
        assert s.read("prof_compile_cache_misses") == 0
    finally:
        P_prof._cache_dir_var.set("")


def test_wire_compile_cache_unset_is_none():
    from ompi_tpu import prof as R_prof
    from ompi_tpu_torch import prof as P_prof

    for prof in (R_prof, P_prof):
        assert str(prof._cache_dir_var.get() or "") == ""
        assert prof.wire_compile_cache() is None


# ---------------------------------------------------------------------------
# the watchdog's phase


def test_watchdog_dump_carries_current_phase(tmp_path):
    """A rank stuck in staging reports phase=staging in its hang dump."""
    from ompi_tpu.telemetry import flight as R_fl
    from ompi_tpu.telemetry.watchdog import Watchdog as R_Wd
    from ompi_tpu_torch.telemetry import flight as P_fl
    from ompi_tpu_torch.telemetry.watchdog import Watchdog as P_Wd

    for side, fl_mod, wd_cls in (("ref", R_fl, R_Wd), ("port", P_fl, P_Wd)):
        led = SIDES[side][0]
        led.enable()
        fl = fl_mod.FlightRecorder()
        fl.exit(fl.enter("warmup"))
        fl.enter("allreduce_dev", comm_cid=1, nbytes=64)
        wd = wd_cls(rank=0, jobid="jp", world=range(2), client=None,
                    flight_rec=fl, dead_fn=lambda: {}, period=3600,
                    timeout=0.0, action="dump",
                    dump_dir=str(tmp_path / side))
        with led.phase("staging"):
            v = wd.sweep()
        assert v is not None and v["stragglers"] == [1], side
        assert json.load(open(wd._dumped[(2, "hang")]))["phase"] \
            == "staging", side
        led.disable()


# ---------------------------------------------------------------------------
# the pvar plane


def test_prof_pvars_are_well_known():
    """The reference's prof pvars are the port's well-known ones, and so
    is every phase and histogram family."""
    names = [n for n in R_pvar.WELL_KNOWN if n.startswith("prof_")]
    assert len(names) >= 13
    for name in names:
        assert P_pvar.is_well_known(name), name
    for name in ("prof_phase_recovery_ns", "prof_phase_spawn_ns",
                 "prof_xfer_h2d_bw_mbps", "trace_hist_xfer_h2d_sz21_lat10",
                 "trace_dropped", "telemetry_flight_ops",
                 "telemetry_inflight"):
        assert P_pvar.is_well_known(name), name


# ---------------------------------------------------------------------------
# the attribution CLI


def _prof_recorder(rec_mod, rank, t_base=1_000_000):
    """A rank trace with prof + xfer + ordinary spans; staging is the
    worst-rank phase on rank 1 (40 ms vs 30 ms)."""
    rec = rec_mod.Recorder(capacity=64, rank=rank)
    stag = 40_000_000 if rank else 30_000_000
    rec.record("staging", "prof", t_base, t_base + stag)
    rec.record("h2d", "xfer", t_base + 1_000, t_base + 2_001_000,
               {"bytes": 1 << 20, "site": "to_device", "chunks": 1})
    rec.record("train", "prof", t_base + stag, t_base + stag + 10_000_000)
    rec.record("launch", "coll_device", t_base + stag + 500,
               t_base + stag + 600)
    return rec


def test_attribution_cli_roundtrip(tmp_path, capsys):
    reps = {}
    for side, (_l, rec_mod, export, cli, _p) in SIDES.items():
        p0, p1 = str(tmp_path / f"{side}0.json"), str(tmp_path /
                                                      f"{side}1.json")
        export.write(p0, _prof_recorder(rec_mod, 0))
        export.write(p1, _prof_recorder(rec_mod, 1))
        out = str(tmp_path / f"{side}attr.json")
        assert cli.main(["report", "-o", out, "--top", "5", p0, p1]) == 0
        text = capsys.readouterr().out
        assert "phase ledger" in text and "transfers h2d" in text, side
        reps[side] = json.load(open(out))
    rep = reps["port"]
    assert rep["schema"] == P_cli.SCHEMA == R_cli.SCHEMA
    for key in ("ranks", "phases", "phase_overlap", "transfers"):
        assert rep[key] == reps["ref"][key], key
    assert rep["phases"][0]["phase"] == "staging"
    assert rep["phases"][0]["max_s"] == pytest.approx(0.04)
    assert rep["phases"][0]["per_rank_s"] == {"0": 0.03, "1": 0.04}
    assert rep["transfers"]["h2d"]["bytes"] == 2 << 20
    assert rep["top"] and all(c["subsys"] != "prof" for c in rep["top"])


def test_attribution_cli_missing_input(tmp_path, capsys):
    for side, (*_a, cli, _p) in SIDES.items():
        assert cli.main(["report", str(tmp_path / "nope.json")]) == 1
        err = capsys.readouterr().err
        assert err.startswith("prof report:") and err.count("\n") == 1


def test_attribution_cli_corrupt_input(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for side, (*_a, cli, _p) in SIDES.items():
        assert cli.main(["report", str(bad)]) == 1
        assert "corrupt" in capsys.readouterr().err, side


# ---------------------------------------------------------------------------
# end to end


def test_prof_enabled_two_ranks_end_to_end(jobs):
    """``prof_enable`` raises the ledger at init with the rank; the
    phase and transfer spans ride the recorder; the CLI merges both
    ranks and attributes the wall to staging first, as the
    reference's."""
    ref, port = jobs
    a, b = _doc(ref, 0), _doc(port, 0)
    for key in ("rc", "ranks", "h2d_bytes"):
        assert b[key] == a[key], (key, b[key], a[key])
    assert b["phases"][0] == a["phases"][0] == "staging"
    assert "train" in b["phases"] and b["staging_s"] >= 0.15
    assert b["h2d_bytes"] == 2 * (1 << 20) and b["ranks"] == [0, 1]
    for r in range(2):
        assert _doc(port, r)["live"] and _doc(ref, r)["live"]


def test_launcher_ledger_attributes_spawn_and_wait(tmp_path):
    """The port's launcher profiles itself when the job does (reference
    ``launcher.py:46-59``): ``spawn`` and ``wait`` phases in its own
    ledger, put back after the case."""
    import sys

    from ompi_tpu_torch.runtime import launcher

    prog = tmp_path / "noop.py"
    prog.write_text("pass\n")
    s = P_pvar.session()
    assert launcher.launch([sys.executable, str(prog)], 1,
                           mca={"prof_enable": "1"}, timeout=60) == 0
    assert P_led.PROFILER is not None
    assert set(P_led.phase_seconds()) == {"spawn", "wait"}
    assert s.read("prof_phase_spawn_ns") > 0
    assert s.read("prof_phase_wait_ns") > 0
