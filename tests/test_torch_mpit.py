"""The port's MPI_T tools plane (``core/events.py``, ``mpit.py``), its
registry (``core/registry.py``, ``util/show_help.py``) and hooks
(``core/hook.py``) against the JAX package's: the counterparts of
``tests/test_mpit.py``'s 9 cases, ``tests/test_core.py``'s two registry
cases and ``tests/test_hook.py``'s 2.

In this process: cvar and pvar handles, categories, event enumeration
and sources (and the port's event types against the reference's, names
through ``compat``), the new emitters' payloads, the registry and its
refusal to serve the CPU on the ``cuda`` platform, show_help. Launcher
jobs, one per package on 2 ranks, run the same program (:data:`_PROG`):
the sm wireup events and the hooks around Init / Finalize, matched and
unexpected events with their order and timestamps, a buffered handle's
drops, libnbc's completion events and the host window's epoch events;
the port's job also drives the device windows' emitters under the
device plane on the CPU platform.

The ``tools/info`` half of ``test_event_coll_and_info_dump`` is
``tests/test_torch_tools.py``'s ``test_info_lists_event_types``.

The in-process cases call the reference too, whose registries are
process-wide: :func:`reference_state` (autouse here, and imported by the
other port test files that call the reference in process) puts both
packages' back as each case found them, so a reference test that runs
later in the same process (an xdist worker's next file) sees no port
case's cvar, pvar, event handle, hook, framework or release hook.
"""

import copy
import importlib
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import weakref

import pytest

from ompi_tpu_torch import compat, errors
from ompi_tpu_torch import mpit as P_mpit
from ompi_tpu_torch.core import cvar as P_cvar
from ompi_tpu_torch.core import events as P_events
from ompi_tpu_torch.core import pvar as P_pvar
from ompi_tpu_torch.core import registry as P_registry
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's event types whose emitters wait for their slices (none
#: since the trace and telemetry planes, ROADMAP item 10a)
WAITING: dict = {}

#: the 2-rank program; ``{pkg}`` is the package, ``{port}`` True in the
#: port's job (which also drives the device windows' emitters)
_PROG = '''
import json, os, time
import numpy as np
from {pkg}.core import events, hook
from {pkg} import mpi, mpit, osc
PORT = {port}
doc = {{}}
wired = []
h_btl = events.handle_alloc("btl_endpoint_connected",
                            callback=lambda e: wired.append(
                                (e.data["btl"], e.data["peer"])))
fired = {{"init": None, "fini": 0}}
hook.register(at_init=lambda w: fired.__setitem__("init", [w.rank, w.size]),
              at_finalize=lambda: fired.__setitem__("fini", 1))
comm = mpi.Init()
rank, size = comm.rank, comm.size
doc["hook_init"] = fired["init"]
comm.Barrier()
h_btl.free()
doc["wired"] = sorted(wired)


def p2p(e):
    return e.read("ctx") % 2 == 0


def go():
    """Rank 0 sends only once rank 1's handles listen: rank 1's token
    (a send, which matches nothing on rank 1)."""
    if rank == 1:
        comm.Send(np.zeros(1, np.int32), dest=0, tag=99)
    else:
        comm.Recv(np.zeros(1, np.int32), source=1, tag=99)


# -- test_event_callbacks_ordered_with_timestamps
got = []
h_match = mpit.event_handle_alloc("pml_message_matched",
                                  callback=lambda e: got.append(e.copy()))
h_unex = mpit.event_handle_alloc("pml_unexpected_queued",
                                 callback=lambda e: got.append(e.copy()))
go()
if rank == 0:
    comm.Send(np.arange(4, dtype=np.float32), dest=1, tag=5)
    comm.Send(np.arange(4, dtype=np.float32), dest=1, tag=6)
else:
    deadline = time.time() + 30
    while comm.Iprobe(source=0, tag=6) is None and time.time() < deadline:
        time.sleep(0.005)
    buf = np.zeros(4, np.float32)
    comm.Recv(buf, source=0, tag=5)
    comm.Recv(buf, source=0, tag=6)
ev = [e for e in got if p2p(e) and e.read("tag") in (5, 6)]
doc["ordered"] = {{
    "events": [[e.type_name, e.read("tag"), e.read("size"),
                e.data.get("from_unexpected", e.data.get("depth"))]
               for e in ev],
    "seq_sorted": [e.seq for e in got] == sorted(e.seq for e in got),
    "ts_sorted": [e.timestamp for e in got]
    == sorted(e.timestamp for e in got),
    "ts_positive": all(e.timestamp > 0 for e in got)}}
comm.Barrier()
h_match.free()
h_unex.free()
n = len(got)
if rank == 0:
    comm.Send(np.zeros(1, np.float32), dest=1, tag=9)
else:
    comm.Recv(np.zeros(1, np.float32), source=0, tag=9)
doc["freed_silent"] = len(got) == n

# -- test_event_buffered_read_and_forced_drops
drops = []
h = mpit.event_handle_alloc("pml_message_matched", buffer_size=2)
h.set_dropped_handler(lambda k: drops.append(k))
go()
if rank == 0:
    for i in range(5):
        comm.Send(np.zeros(2, np.float32), dest=1, tag=20 + i)
else:
    buf = np.zeros(2, np.float32)
    for i in range(5):
        comm.Recv(buf, source=0, tag=20 + i)
doc["dropped"] = h.dropped
doc["drops"] = list(drops)
a, b, c = h.read(), h.read(), h.read()
doc["drained"] = [None if x is None else x.read("tag") for x in (a, b, c)]
doc["drained_in_order"] = b is None or a.seq < b.seq
h.free()
comm.Barrier()

# -- test_event_coll_and_info_dump (the libnbc half)
coll = []
h = mpit.event_handle_alloc("coll_schedule_complete",
                            callback=lambda e: coll.append(e.copy()))
r = comm.Ibarrier()
r.wait(timeout=60)
doc["coll"] = [[e.read("kind"), e.read("rounds"),
                e.read("comm_cid") == comm.cid] for e in coll]
h.free()

# -- test_osc_and_io_event_emitters (the osc half): every epoch kind
seen = []
h = events.handle_alloc("osc_epoch_transition",
                        callback=lambda e: seen.append(
                            [e.data["kind"], e.data["phase"],
                             e.data["peer"]]))
win = osc.win_create(comm, np.zeros(8))
win.Fence()
if rank == 0:
    win.Put(np.ones(4), target=1, disp=0)
win.Fence()
if rank == 0:
    win.Lock(1)
    win.Put(np.ones(2), target=1, disp=0)
    win.Unlock(1)
comm.Barrier()
if rank == 0:
    win.Start([1])
    win.Put(np.ones(2), target=1, disp=0)
    win.Complete()
else:
    win.Post([0])
    win.Wait()
win.Free()
h.free()
doc["epochs"] = seen

# -- test_osc_and_io_event_emitters (the io half): the collective write
# and read each emit their completion
from {pkg} import io as io_mod
hio = []
h = events.handle_alloc("io_collective_complete",
                        callback=lambda e: hio.append(
                            [e.data["kind"], e.data["nbytes"],
                             os.path.basename(e.data["file"])]))
path = os.path.join({out!r}, "ev.mpiio")
f = io_mod.File_open(comm, path, io_mod.MODE_CREATE | io_mod.MODE_RDWR)
f.Write_at_all(0, np.arange(8, dtype=np.int32))
back = np.zeros(8, np.int32)
f.Read_at_all(0, back)
f.Close()
h.free()
doc["io"] = hio
doc["io_back"] = back.tolist()

if PORT:  # the device windows' emitters (device plane, CPU platform)
    import torch
    from ompi_tpu_torch import errors, op as op_mod
    from ompi_tpu_torch.core import cvar
    fb, ft, cep = [], [], []
    h1 = events.handle_alloc("osc_device_fallback", callback=lambda e:
                             fb.append([e.data["op"], e.data["reason"]]))
    h2 = events.handle_alloc("osc_cuda_fallthrough", callback=lambda e:
                             ft.append([e.data["what"], e.data["reason"]]))
    dw = osc.win_create_device(comm, torch.zeros(16, dtype=torch.int32))
    dw.Fence()
    try:
        dw.Accumulate(torch.ones(4, dtype=torch.int32), 1 - rank, 0,
                      op_mod.BAND)
    except errors.MPIError as e:
        assert e.error_class == errors.ERR_OP, e
    else:
        raise AssertionError("a BAND accumulate was fused")
    dw.Fence()
    dw.Free()
    cvar.set("osc_cuda", "on")
    h3 = events.handle_alloc("osc_epoch_transition", callback=lambda e:
                             cep.append([e.data["kind"], e.data["phase"]]))
    cw = osc.win_create(comm, torch.zeros(16, dtype=torch.int32))
    doc["cuda_window"] = type(cw).__name__
    cw.Fence()
    cw.Accumulate(torch.full((4,), 6, dtype=torch.int32), 1 - rank, 0,
                  op_mod.BAND)
    cw.Fence()
    cw.Free()
    h3.free()
    hw = osc.win_create(comm, torch.zeros(16, dtype=torch.int16))
    doc["int16_window"] = type(hw).__name__
    hw.Free()
    h1.free()
    h2.free()
    doc["device_fallback"] = fb
    doc["cuda_fallthrough"] = ft
    doc["cuda_epochs"] = cep
mpi.Finalize()
doc["hook_fini"] = fired["fini"]
with open(os.path.join({out!r}, f"doc_r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''

#: the port job's mca beyond the reference's (none)
_PORT_MCA = {"device_plane": "on", "device_plane_platform": "cpu"}


def _port_run(src: str, n: int, mca: dict, timeout: float = 240) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n, mca=mca,
                                    timeout=timeout)
    finally:
        os.unlink(path)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """(reference dir, port dir): the 2-rank program once per package."""
    ref = tmp_path_factory.mktemp("mpit_ref")
    port = tmp_path_factory.mktemp("mpit_port")
    run_ranks(_PROG.format(pkg="ompi_tpu", port=False, out=str(ref)), 2,
              prelude=False, timeout=240)
    rc = _port_run(_PROG.format(pkg="ompi_tpu_torch", port=True,
                                out=str(port)), 2, _PORT_MCA)
    assert rc == 0, f"port job exited {rc}"
    return ref, port


def _docs(jobs):
    ref, port = jobs
    return [(json.loads((port / f"doc_r{r}.json").read_text()),
             json.loads((ref / f"doc_r{r}.json").read_text()))
            for r in range(2)]


# ---------------------------------------------------------------------------
# the reference's process-wide state around each in-process case

#: each package's module-level containers a case may change that are
#: data, put back exactly: pvar counters, hooks, PERUSE subscribers, the
#: user error space and the warn-once sets
_DATA = {
    "ompi_tpu": (
        ("core.pvar", ("_counters", "_watermarks", "_timers")),
        ("core.hook", ("_hooks",)), ("pml.peruse", ("_subs", "active")),
        ("errors", ("_user_strings", "_user_codes", "_last_used")),
        ("osc.pallas", ("_warned",)), ("osc.device_epoch", ("_warned",)),
        ("tune.observe", ("_warned_tables",))),
    "ompi_tpu_torch": (
        ("core.pvar", ("_counters", "_watermarks")),
        ("core.hook", ("_hooks",)), ("pml.peruse", ("_subs", "active")),
        ("errors", ("_user_strings", "_user_codes", "_last_used")),
        ("osc.device_epoch", ("_warned",))),
}


def _module_held(pkg: str) -> set:
    """ids of what the loaded modules of ``pkg`` hold, as globals or one
    level inside a global dict or object: a cvar, event type, framework
    or component registered at import, which a case may have imported and
    must keep."""
    held = set()
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == pkg or name.startswith(pkg + ".")):
            continue
        for v in list(vars(mod).values()):
            held.add(id(v))
            if isinstance(v, dict):
                held.update(id(x) for x in list(v.values()))
            elif not isinstance(v, (type, type(sys))) \
                    and hasattr(v, "__dict__"):
                held.update(id(x) for x in list(vars(v).values()))
    return held


def _mods(pkg: str):
    return [importlib.import_module(f"{pkg}.{m}") for m in
            ("mpit", "core.cvar", "core.events", "core.memhooks",
             "core.registry")]


def _snapshot(pkg: str) -> dict:
    mpit, cvar, events, memhooks, registry = _mods(pkg)
    data = {}
    for mod, names in _DATA[pkg]:
        m = sys.modules.get(f"{pkg}.{mod}")
        if m is not None:
            data[m.__name__] = {n: copy.deepcopy(getattr(m, n))
                                for n in names}
    return {
        "data": data,
        "cvars": {n: (v, v._value, v._source)
                  for n, v in cvar._registry._vars.items()},
        "types": {n: (t, list(t.handles)) for n, t in events._types.items()},
        "frameworks": {n: (fw, dict(fw._components))
                       for n, fw in registry._frameworks.items()},
        "memhooks": list(memhooks._hooks),
    }


def _restore(pkg: str, snap: dict) -> None:
    mpit, cvar, events, memhooks, registry = _mods(pkg)
    held = _module_held(pkg)
    for mod, saved in snap["data"].items():
        for n, v in saved.items():
            setattr(sys.modules[mod], n, v)
    for n, fw in list(registry._frameworks.items()):
        old = snap["frameworks"].get(n)
        if old is None:
            if id(fw) not in held:
                del registry._frameworks[n]
            continue
        for c, cls in list(fw._components.items()):
            if c not in old[1] and id(cls) not in held:
                del fw._components[c]
    # cvars: a case's own registrations go, import-time ones (and a kept
    # framework's include / exclude list) stay; every earlier var gets
    # its value and source back
    reg = cvar._registry._vars
    for n, var in list(reg.items()):
        old = snap["cvars"].get(n)
        if old is None:
            if id(var) not in held and n not in registry._frameworks:
                del reg[n]
        else:
            reg[n] = old[0]
            old[0]._value, old[0]._source = old[1], old[2]
    mpit._cvar_order[:] = [n for n in mpit._cvar_order if n in reg]
    mpit._cvar_seen.intersection_update(reg)
    for n, t in list(events._types.items()):
        old = snap["types"].get(n)
        if old is None:
            if id(t) not in held:
                del events._types[n]
                events._order.remove(t)
        else:
            t.handles[:] = old[1]
    # a case's strong release hooks go; weak ones (caches) die on their own
    memhooks._hooks[:] = [h for h in memhooks._hooks
                          if h in snap["memhooks"]
                          or isinstance(h, weakref.WeakMethod)]


@pytest.fixture(autouse=True)
def reference_state():
    """Put both packages' process-wide registries back as the case found
    them (cvars and their values, the MPI_T cvar order, pvars, event
    handles, hooks, frameworks, release hooks, the user error space)."""
    snaps = {pkg: _snapshot(pkg) for pkg in _DATA}
    yield
    for pkg, snap in snaps.items():
        _restore(pkg, snap)


@pytest.fixture
def reference_only_state():
    """The reference's registries alone put back (for files whose port
    cases keep state from case to case: ``pytestmark =
    pytest.mark.usefixtures("reference_only_state")``)."""
    snap = _snapshot("ompi_tpu")
    yield
    _restore("ompi_tpu", snap)


# ---------------------------------------------------------------------------
# in process


def test_cvar_enumeration_and_handles():
    from ompi_tpu import mpit as R_mpit
    from ompi_tpu.core import cvar as R_cvar

    infos = []
    for mpit, cvar in ((P_mpit, P_cvar), (R_mpit, R_cvar)):
        cvar.register("mpit_test_var", 7, int, help="test var", level=5)
        mpit.init_thread()
        assert mpit.cvar_get_num() >= 1
        idx = mpit.cvar_index("mpit_test_var")
        info = mpit.cvar_get_info(idx)
        assert info["type"] == "int" and info["verbosity"] == 5
        h = mpit.CvarHandle(idx)
        assert h.read() == 7
        h.write(9)
        assert cvar.get("mpit_test_var") == 9 == h.read()
        infos.append(info)
        mpit.finalize()
    assert infos[0] == infos[1]
    # indices stay stable as modules register more cvars
    before = P_mpit.cvar_index("mpit_test_var")
    P_cvar.register("aaa_mpit_late_var", 1, int)
    assert P_mpit.cvar_index("mpit_test_var") == before
    assert P_mpit.cvar_index("aaa_mpit_late_var") == P_mpit.cvar_get_num() - 1


def test_reference_cvar_case_passes_after_the_port_case():
    """The guard: with the port's parity case first in one process, the
    reference's own ``test_cvar_enumeration_and_handles`` still passes
    (its ``assert 9 == 7`` failed when the port's case left
    ``mpit_test_var`` at 9 in the reference's registry), and the
    reference's registry holds no ``mpit_test_var`` after either."""
    from ompi_tpu.core import cvar as R_cvar
    from tests import test_mpit

    snaps = {pkg: _snapshot(pkg) for pkg in _DATA}
    test_cvar_enumeration_and_handles()
    for pkg, snap in snaps.items():
        _restore(pkg, snap)
    assert R_cvar.lookup("mpit_test_var") is None
    test_mpit.test_cvar_enumeration_and_handles()
    _restore("ompi_tpu", snaps["ompi_tpu"])
    assert R_cvar.lookup("mpit_test_var") is None


def test_pvar_sessions_and_handles():
    from ompi_tpu import mpit as R_mpit
    from ompi_tpu.core import pvar as R_pvar

    reads = []
    for mpit, pvar in ((P_mpit, P_pvar), (R_mpit, R_pvar)):
        pvar.record("mpit_test_counter", 10)
        s = mpit.pvar_session_create()
        h = s.handle_alloc("mpit_test_counter")
        got = [h.read() == pvar.read("mpit_test_counter")]  # absolute
        h.start()
        pvar.record("mpit_test_counter", 5)
        got.append(h.read())  # the delta since start
        h.stop()
        pvar.record("mpit_test_counter", 5)
        got.append(h.read())  # frozen at stop
        h.reset()
        got.append(h.read())
        assert "mpit_test_counter" in mpit.pvar_names()
        assert mpit.pvar_get_num() >= 1
        s.free()
        with pytest.raises(RuntimeError):
            s.handle_alloc("x")
        reads.append(got)
    assert reads[0] == reads[1] == [True, 5, 5, 0]


def test_categories_cover_frameworks():
    """One category per registered framework, each listing its cvars by
    prefix: the port's frameworks (btl, coll, accelerator) are the
    reference's of those names, with the same include / exclude cvar."""
    import ompi_tpu_torch.accelerator  # noqa: F401 — registers its framework
    import ompi_tpu_torch.btl  # noqa: F401
    import ompi_tpu_torch.coll  # noqa: F401
    from ompi_tpu import mpit as R_mpit
    from ompi_tpu.tools.info import _import_component_universe

    _import_component_universe()
    cats = dict(P_mpit.categories())
    assert {"btl", "coll", "accelerator"} <= set(cats), sorted(cats)
    assert any(v.startswith("btl_") for v in cats["btl"])
    assert "btl" in cats["btl"] and "coll" in cats["coll"]
    assert P_mpit.category_get_num() == len(cats)
    ref = dict(R_mpit.categories())
    assert set(cats) <= set(ref), set(cats) - set(ref)


@pytest.mark.parametrize("example,n", [("connectivity", 3),
                                       ("library_caching", 3),
                                       ("parallel_io", 4)])
def test_examples_run(example, n):
    """The port's host examples run, as the reference's do (hello and
    ring run in tests/test_torch_p2p.py, the shmem ones in
    tests/test_torch_shmem.py)."""
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
         str(n), "--timeout", "90", "--mca", "device_plane_platform", "cpu",
         os.path.join("ompi_tpu_torch", "examples", f"{example}.py"),
         *([] if example == "parallel_io" else ["-v"])],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
    want = {"connectivity": f"Connectivity test on {n} processes PASSED.",
            "library_caching": f"caching example OK on {n} ranks",
            "parallel_io": f"parallel IO example OK: 8x8 darray + {n} "
                           "ordered records"}[example]
    assert want in r.stdout, r.stdout


def test_event_enumeration_and_sources():
    assert P_mpit.event_get_num() >= 5
    names = [P_mpit.event_get_info(i)["name"]
             for i in range(P_mpit.event_get_num())]
    assert "pml_message_matched" in names
    assert "pml_unexpected_queued" in names
    assert P_mpit.event_index("pml_message_matched") == \
        names.index("pml_message_matched")
    info = P_mpit.event_get_info(P_mpit.event_index("btl_endpoint_connected"))
    assert "peer" in info["fields"] and info["source"] == 0
    for name in WAITING:  # registered with their modules' slices
        assert name not in names, name
    assert P_mpit.source_get_num() == 1
    src = P_mpit.source_get_info(0)
    assert src["ordering"] == "ordered"
    assert src["ticks_per_second"] == 1_000_000_000
    t0 = P_mpit.source_get_timestamp()
    t1 = P_mpit.source_get_timestamp()
    assert t1 >= t0


def test_event_types_match_reference():
    """Every event type the reference registers has the port's
    counterpart (its name through ``compat.event_name``) with the same
    fields and description, less any whose emitters wait
    (:data:`WAITING`)."""
    import ompi_tpu.osc.device_epoch  # noqa: F401 — register their types
    import ompi_tpu.osc.pallas  # noqa: F401
    import ompi_tpu.telemetry.watchdog  # noqa: F401
    import ompi_tpu.trace.recorder  # noqa: F401
    import ompi_tpu.tune.observe  # noqa: F401
    import ompi_tpu_torch.osc.cuda  # noqa: F401
    import ompi_tpu_torch.osc.device_epoch  # noqa: F401
    import ompi_tpu_torch.telemetry.watchdog  # noqa: F401
    import ompi_tpu_torch.trace.recorder  # noqa: F401
    import ompi_tpu_torch.tune.observe  # noqa: F401
    from ompi_tpu.core import events as R_events

    ref = {}
    for i in range(R_events.get_num()):
        info = R_events.get_info(i)
        ref[info["name"]] = info
    assert WAITING.keys() <= ref.keys()
    port = {}
    for i in range(P_events.get_num()):
        info = P_events.get_info(i)
        port[info["name"]] = info
    want = {compat.event_name(n) for n in ref} - set(WAITING)
    assert set(port) == want, (set(port) ^ want)
    for name, info in ref.items():
        if name in WAITING:
            continue
        p = port[compat.event_name(name)]
        assert p["fields"] == info["fields"], name
        assert p["desc"] == info["desc"].replace("osc/pallas", "osc/cuda")


def _ft_sweep(detector_mod):
    """One sweep of a detector whose observer saw world rank 3 die (the
    detector's shell, no thread and no store connection)."""
    det = detector_mod.Detector.__new__(detector_mod.Detector)
    det.dead = {3: "killed by signal 9"}
    det.revoked_cids = set()
    det._applied_dead = set()
    det._applied_revokes = set()
    det._apply_faults = lambda dead: 0
    det._sweep()


def test_new_emitters_carry_reference_fields():
    """``osc_device_fallback``, ``osc_cuda_fallthrough``,
    ``tune_table_error`` and the failure detector's
    ``ft_process_failure``: the same call of each package's emitter gives
    the same event payload (the port's fallthrough named through
    ``compat``); with no handle nothing is delivered."""
    from ompi_tpu.core import events as R_events
    from ompi_tpu.ft import detector as R_det
    from ompi_tpu_torch.ft import detector as P_det
    from ompi_tpu.osc import device_epoch as R_de
    from ompi_tpu.osc import pallas as R_pallas
    from ompi_tpu.tune import observe as R_obs
    from ompi_tpu_torch.osc import cuda as P_cuda
    from ompi_tpu_torch.osc import device_epoch as P_de
    from ompi_tpu_torch.tune import observe as P_obs

    exc = ValueError("bad json")
    calls = [
        ("osc_device_fallback",
         lambda m: m._fallback("accumulate", "op 'MPI_BAND' is not fusable "
                               "into the fence program"), R_de, P_de),
        ("osc_pallas_fallthrough",
         lambda m: m._fallthrough_note("accumulate",
                                       "op 'MPI_BAND' is not elementwise"),
         R_pallas, P_cuda),
        ("tune_table_error",
         lambda m: m.table_error("coll_switchpoints", "/no/such.json", exc),
         R_obs, P_obs),
        ("ft_process_failure", _ft_sweep, R_det, P_det),
    ]
    for name, call, R_mod, P_mod in calls:
        out = {}
        for tag, ev, mod, nm in (("ref", R_events, R_mod, name),
                                 ("port", P_events, P_mod,
                                  compat.event_name(name))):
            assert not ev.active(nm)
            call(mod)  # no handle: nothing to deliver
            got = []
            h = ev.handle_alloc(nm, callback=lambda e, g=got: g.append(e))
            try:
                call(mod)
            finally:
                h.free()
            assert len(got) == 1, (tag, name, got)
            assert got[0].type_name == nm
            out[tag] = got[0].data
        assert out["port"] == out["ref"], name


def test_registry_priority_selection():
    fw = P_registry.framework("t_fw1")

    @fw.register
    class Low(P_registry.Component):
        NAME = "low"
        PRIORITY = 10

    @fw.register
    class High(P_registry.Component):
        NAME = "high"
        PRIORITY = 90

    @fw.register
    class Broken(P_registry.Component):
        NAME = "broken"
        PRIORITY = 100

        def open(self):
            return False

    @fw.register
    class Raises(P_registry.Component):
        NAME = "raises"
        PRIORITY = 95

        def open(self):
            raise OSError("no device")

    opened = fw.open_components()
    assert [c.NAME for c in opened] == ["high", "low"]
    assert fw.select_one().NAME == "high"
    # a raising open is skipped and kept with its cause
    assert isinstance(fw.failures["raises"], OSError)
    assert "broken" not in fw.failures
    fw.close_components()
    assert "t_fw1" in P_registry.all_frameworks()


def test_registry_exclude_list(capsys):
    fw = P_registry.framework("t_fw2")

    @fw.register
    class A(P_registry.Component):
        NAME = "a"
        PRIORITY = 10

    @fw.register
    class B(P_registry.Component):
        NAME = "b"
        PRIORITY = 20

    P_cvar.set("t_fw2", "^b")
    assert [c.NAME for c in fw.open_components()] == ["a"]
    fw.close_components()
    P_cvar.set("t_fw2", "b")
    assert [c.NAME for c in fw.open_components()] == ["b"]
    fw.close_components()
    P_cvar.set("t_fw2", "a,^b")
    with pytest.raises(ValueError):
        fw.open_components()
    # nothing selectable: the no-component help, printed once per topic
    from ompi_tpu_torch.util import show_help

    show_help.reset_for_testing()
    P_cvar.set("t_fw2", "zzz")
    for _ in range(2):
        with pytest.raises(RuntimeError):
            fw.select_one()
        fw.close_components()
    err = capsys.readouterr().err
    assert err.count("No usable component found for framework 't_fw2'") \
        == 1, err
    P_cvar.set("t_fw2", "")


def test_bml_refuses_a_btl_that_fails_to_open():
    """A btl whose open() raises fails the Bml with ERR_INTERN and its
    cause (its peers may count on it), where the registry alone would
    skip it."""
    from ompi_tpu_torch.btl import base as btl_base

    class Broken(btl_base.Btl):
        NAME = "t_broken"

        def open(self):
            raise OSError("no shared memory")

    fw = btl_base.framework
    fw.register(Broken)
    try:
        P_cvar.set("btl", "t_broken")
        with pytest.raises(errors.MPIError) as ei:
            btl_base.Bml()
        assert ei.value.error_class == errors.ERR_INTERN
        assert "t_broken" in str(ei.value) and "no shared memory" in str(
            ei.value)
        assert isinstance(ei.value.__cause__, OSError)
    finally:
        P_cvar.set("btl", "")
        fw._components.pop("t_broken", None)
        fw.close_components()


def test_show_help_once(capsys):
    from ompi_tpu_torch.util import show_help

    show_help.reset_for_testing()
    show_help.show("launcher", "rank-died", rank=3, cause="signal 9")
    show_help.show("launcher", "rank-died", rank=3, cause="signal 9")
    err = capsys.readouterr().err
    assert err.count("terminating the") == 1
    assert "rank:   3" in err
    assert "(no help text registered)" in show_help.render("x", "y")


def test_accelerator_registry_refuses_the_cpu_on_cuda(monkeypatch):
    """On the ``cuda`` platform the accelerator framework never serves the
    null component in the cuda component's place: with the device plane
    requested and no GPU it raises ERR_INTERN naming the cause; a cuda
    component whose open raises does the same. ``--mca accelerator
    ^cuda`` is a requested choice and selects null."""
    import torch

    from ompi_tpu_torch import accelerator

    def current():
        accelerator.reset_for_testing()
        return accelerator.current()

    try:
        assert current().NAME == ("cuda" if torch.cuda.is_available()
                                  else "null")
        if not torch.cuda.is_available():
            P_cvar.set("device_plane", "on")
            with pytest.raises(errors.MPIError) as ei:
                current()
            assert ei.value.error_class == errors.ERR_INTERN
            assert "is_available() is false" in str(ei.value)
            P_cvar.set("accelerator", "^cuda")
            assert current().NAME == "null"
            P_cvar.set("accelerator", "")
            P_cvar.set("device_plane_platform", "cpu")
            assert current().NAME == "null"
            P_cvar.set("device_plane_platform", "cuda")
            P_cvar.set("device_plane", "off")

        def broken_init():
            raise RuntimeError("CUDA driver initialization failed")

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "init", broken_init)
        with pytest.raises(errors.MPIError) as ei:
            current()
        assert ei.value.error_class == errors.ERR_INTERN
        assert "CUDA driver initialization failed" in str(ei.value)
        assert isinstance(ei.value.__cause__, RuntimeError)
    finally:
        monkeypatch.undo()
        for name, val in (("device_plane", "off"), ("accelerator", ""),
                          ("device_plane_platform", "cuda")):
            P_cvar.set(name, val)
        accelerator.reset_for_testing()


def test_compat_maps_framework_lists_and_events():
    got = compat.mca_from_reference({"coll": "^pallas,^xla,^hier",
                                     "accelerator": "tpu,null",
                                     "btl": "self,sm"})
    assert got == {"coll": "^cuda,^device,^hier", "accelerator": "cuda,null",
                   "btl": "self,sm"}
    assert compat.event_name("osc_pallas_fallthrough") \
        == "osc_cuda_fallthrough"
    assert compat.event_name("pml_message_matched") == "pml_message_matched"


def test_comm_method_matrix_prints():
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write("from ompi_tpu_torch import mpi\n"
                 "mpi.Init()\nmpi.Finalize()\n")
        path = fh.name
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
             "2", "--mca", "hook_comm_method", "1", "--mca",
             "device_plane_platform", "cpu", path],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "transport matrix" in proc.stderr, proc.stderr
        lines = proc.stderr.splitlines()
        i = next(k for k, ln in enumerate(lines) if "transport matrix" in ln)
        assert lines[i + 2].split() == ["0", "self", "sm"], lines
        assert lines[i + 3].split() == ["1", "sm", "self"], lines
    finally:
        os.unlink(path)


# ---------------------------------------------------------------------------
# launcher jobs


def test_hooks_run_at_init_and_finalize(jobs):
    for r, (dp, dr) in enumerate(_docs(jobs)):
        assert dp["hook_init"] == [r, 2] == dr["hook_init"]
        assert dp["hook_fini"] == 1 == dr["hook_fini"]


def test_event_callbacks_ordered_with_timestamps(jobs):
    """Both paths of the matching engine: rank 1's two messages queue as
    unexpected, then match from the queue; the instances arrive in
    sequence and timestamp order; a freed handle gets nothing more. The
    point-to-point events equal the reference's."""
    for r, (dp, dr) in enumerate(_docs(jobs)):
        o = dp["ordered"]
        assert o["seq_sorted"] and o["ts_sorted"] and o["ts_positive"]
        assert dp["freed_silent"]
        assert o["events"] == dr["ordered"]["events"]
        if r == 1:
            kinds = [e[0] for e in o["events"]]
            assert kinds == ["pml_unexpected_queued"] * 2 \
                + ["pml_message_matched"] * 2, o["events"]
            assert all(e[3] is True for e in o["events"][2:])
            assert [e[1] for e in o["events"]] == [5, 6, 5, 6]


def test_event_buffered_read_and_forced_drops(jobs):
    """Five matches into a two-slot buffer: three drops, the dropped
    handler told once, the two oldest drained in order, as in the
    reference."""
    dp, dr = _docs(jobs)[1]
    assert dp["dropped"] == 3 == dr["dropped"]
    assert dp["drops"] == [1] == dr["drops"]
    assert dp["drained"] == [20, 21, None] == dr["drained"]
    assert dp["drained_in_order"]


def test_event_coll_and_info_dump(jobs):
    """libnbc's Ibarrier emits its completion with its kind, rounds and
    comm (the tools/info half is
    ``tests/test_torch_tools.py::test_info_lists_event_types``)."""
    for dp, dr in _docs(jobs):
        assert dp["coll"] == dr["coll"]
        assert dp["coll"] and all(k == "barrier" and n >= 1 and same
                                  for k, n, same in dp["coll"])


def test_osc_and_io_event_emitters(jobs):
    """The sm wireup emits one event per peer (the handle allocated
    before Init); the host window emits enter / exit at every fence,
    lock and PSCW epoch, as the reference's does; a collective write and
    read each emit ``io_collective_complete`` with its kind, bytes and
    file."""
    for r, (dp, dr) in enumerate(_docs(jobs)):
        assert dp["io"] == dr["io"] == [["write", 32, "ev.mpiio"],
                                        ["read", 32, "ev.mpiio"]], dp["io"]
        assert dp["io_back"] == dr["io_back"] == list(range(8))
        assert dp["wired"] == [["sm", 1 - r]] == dr["wired"]
        assert dp["epochs"] == dr["epochs"], (dp["epochs"], dr["epochs"])
        assert dp["epochs"].count(["fence", "enter", -1]) == 2
    assert _docs(jobs)[0][0]["epochs"][4:] == [
        ["lock", "enter", 1], ["lock", "exit", 1],
        ["pscw_access", "enter", -1], ["pscw_access", "exit", -1]]
    assert _docs(jobs)[1][0]["epochs"][4:] == [
        ["pscw_exposure", "enter", -1], ["pscw_exposure", "exit", -1]]


def test_device_window_emitters(jobs):
    """The port's device windows on the CPU platform: a DeviceEpochWindow
    BAND accumulate emits ``osc_device_fallback`` once with the
    reference's (op, reason); a CudaWindow's host-assisted BAND and an
    int16 window's creation emit ``osc_cuda_fallthrough``; the
    CudaWindow's fences emit enter / exit pairs."""
    for dp, _ in _docs(jobs):
        assert dp["device_fallback"] == [
            ["accumulate",
             "op 'MPI_BAND' is not fusable into the fence program"]]
        assert dp["cuda_window"] == "CudaWindow"
        assert dp["int16_window"] == "Window"
        what = [w for w, _ in dp["cuda_fallthrough"]]
        assert what == ["accumulate", "win_create"], dp["cuda_fallthrough"]
        assert dp["cuda_fallthrough"][0][1] == "op 'MPI_BAND' is not " \
            "elementwise"
        assert "int16" in dp["cuda_fallthrough"][1][1]
        assert dp["cuda_epochs"] == [["fence", "enter"], ["fence", "exit"]] * 2
