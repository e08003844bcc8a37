"""The port's instance plane (``runtime/state.py``: the reference-counted
instance, MPI-4 sessions, ``Comm_create_from_group``; ``MPI_Abort`` over
``runtime/kvstore.py``, ``rte.py`` and the launcher; ``ext/``) against the
JAX package's: the counterparts of ``tests/test_sessions.py``'s cases,
``tests/test_ext.py``'s ``test_registry_and_query`` and
``test_ftmpi_extension_binds_ft`` and ``tests/test_ft.py``'s
``test_mpi_abort_kills_job``.

In this process: the extension registry, ``Request_get_status``,
``Wtime``, ``Wtick``, ``Get_version`` and ``Get_library_version``. One
launcher job per package and rank count, each the same program
(:data:`_PROG3`, :data:`_PROG4`): on 3 ranks a session-only comm (no
world model), then Init over the same instance, Finalize first and the
session after; on 4 ranks the groups' set algebra, then Init with the
session finalized first, then a session after the teardown. Each records
the psets and their sizes, the collectives' values and the instance's
reference count at every step. The port's 4-rank job first runs
``ompi_tpu_torch/examples/sessions.py --device --tiny`` (its device
checks on CPU tensors, under the device plane on the CPU platform). The
Abort jobs are the port's alone. ``test_session_host_pset_multihost``
runs the reference's case on two fake hosts of the port's multi-host
launcher (``--host`` with the ``local`` agent).
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import pytest

from ompi_tpu_torch import compat, errors
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_ingest import (  # noqa: F401 — autouse
    port_accelerator_state)
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEAD = '''
import json, os
import numpy as np
from {pkg} import mpi
from {pkg}.runtime import state
doc = {{"users": []}}


def users(tag):
    doc["users"].append([tag, state._instance_users, state.is_initialized()])
'''

_TAIL = '''
with open(os.path.join({out!r}, f"doc_r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''

#: 3 ranks: tests/test_sessions.py's test_session_only_no_world_model, then
#: its test_init_is_session_consumer (Finalize first, the session last)
_PROG3 = _HEAD + '''
s = mpi.Session_init({{"thread_level": "single"}})
users("session")
names = [s.get_nth_pset(i) for i in range(s.num_psets())]
g = mpi.Group_from_session_pset(s, "mpi://WORLD")
rank = g.rank
comm = s.comm_from_group(g, "test.sessions.world")
out = np.zeros(4, np.float32)
comm.Allreduce(np.full(4, comm.rank + 1, np.float32), out)
gs = s.group_from_pset("mpi://SELF")
cself = s.comm_from_group(gs, "test.sessions.self")
doc["only"] = [names, s.pset_info("mpi://WORLD")["mpi_size"], g.size,
               out.tolist(), cself.size, state.is_initialized(),
               s.pset_info("ompi_tpu://HOST")["mpi_size"]]
s.finalize()
users("session finalized")

s = mpi.Session_init()
users("session 2")
comm = mpi.Init()
users("init")
out = np.zeros(1, np.int64)
comm.Allreduce(np.array([2], np.int64), out)
g = s.group_from_pset("mpi://WORLD")
c2 = s.comm_from_group(g, "test.sessions.after_init")
mpi.Finalize()
users("finalize")
out2 = np.zeros(1, np.int64)
c2.Allreduce(np.array([3], np.int64), out2)
s.finalize()
users("session 2 finalized")
doc["consumer"] = [int(out[0]), int(out2[0]), state.is_finalized()]
''' + _TAIL

#: 4 ranks: test_session_groups_and_set_algebra, then Init with the session
#: finalized first, then a session after the teardown
_PROG4 = _HEAD + '''
s = mpi.Session_init()
g = s.group_from_pset("mpi://WORLD")
rank = g.rank
sub = g.incl(list(range(0, g.size, 2)))
even = None
if sub.rank != mpi.UNDEFINED:
    c = s.comm_from_group(sub, "test.sessions.even")
    out = np.zeros(1, np.int64)
    c.Allreduce(np.array([1], np.int64), out)
    even = [int(out[0]), sub.size, c.size]
odd = g.difference(sub)
oc = mpi.Comm_create_from_group(odd, "test.sessions.odd")
doc["algebra"] = [even, list(sub.ranks), list(odd.ranks),
                  None if oc is None else oc.size,
                  list(g.union(sub).ranks), list(sub.intersection(odd).ranks)]
users("session")
comm = mpi.Init()
users("init")
s.finalize()
users("session finalized")
out = np.zeros(1, np.int64)
comm.Allreduce(np.array([comm.rank], np.int64), out)
mpi.Finalize()
users("finalize")
s3 = mpi.Session_init()
users("session 3")
c3 = s3.comm_from_group(s3.group_from_pset("mpi://WORLD"), "test.after")
out3 = np.zeros(1, np.int64)
c3.Allreduce(np.array([5], np.int64), out3)
s3.finalize()
users("session 3 finalized")
try:
    mpi.Init()
    again = None
except RuntimeError as e:
    again = "after finalize" in str(e)
doc["order"] = [int(out[0]), int(out3[0]), again]
''' + _TAIL

#: the port's 4-rank job runs the sessions example's device checks first
_EXAMPLE = '''
from ompi_tpu_torch.examples import sessions as _ex
assert _ex.main(["--device", "--tiny", "--out", {ex_out!r}]) == 0
'''

#: the port's 4-rank job's mca: the device plane on the CPU platform, and
#: coll/cuda and osc/cuda for the example
_PORT4_MCA = {"device_plane": "on", "device_plane_platform": "cpu",
              "coll_cuda": "on", "osc_cuda": "on"}


def _port_job(src: str, n: int, mca=None, env=None, timeout=240) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        if env is None:
            return port_launcher.launch([sys.executable, path], n, mca=mca,
                                        timeout=timeout)
        cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
               "-n", str(n), "--timeout", str(timeout), path]
        return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              timeout=timeout + 30).returncode
    finally:
        os.unlink(path)


_jobs = {}


@pytest.fixture(scope="module")
def docs(request, tmp_path_factory):
    """(n, [(port doc, reference doc)] per rank)."""
    n = request.param
    if n not in _jobs:
        prog = {3: _PROG3, 4: _PROG4}[n]
        ref = tmp_path_factory.mktemp(f"sess_ref{n}")
        port = tmp_path_factory.mktemp(f"sess_port{n}")
        run_ranks(prog.format(pkg="ompi_tpu", out=str(ref)), n,
                  prelude=False, timeout=240)
        src = prog.format(pkg="ompi_tpu_torch", out=str(port))
        mca = None
        if n == 4:
            src = _EXAMPLE.format(ex_out=str(port / "example")) + src
            mca = _PORT4_MCA
        assert _port_job(src, n, mca) == 0, "port job failed"
        _jobs[n] = (port, [
            (json.loads((port / f"doc_r{r}.json").read_text()),
             json.loads((ref / f"doc_r{r}.json").read_text()))
            for r in range(n)])
    return n, _jobs[n][1]


# ---------------------------------------------------------------------------
# in process


def test_registry_and_query():
    """tests/test_ext.py's case: the registry's names (the reference's
    through ``compat.ext_name``), the cuda query a bool, the short-float
    datatypes real 2-byte types, an unknown name an AttributeError."""
    from ompi_tpu import ext as R_ext
    from ompi_tpu_torch import ext

    names = ext.available()
    assert "MPIX_Query_cuda_support" in names and "MPIX_BFLOAT16" in names
    for name in R_ext.available():
        assert compat.ext_name(name) in names, name
    assert isinstance(ext.MPIX_Query_cuda_support(), bool)
    assert ext.MPIX_FLOAT16.size == R_ext.MPIX_FLOAT16.size == 2
    assert ext.MPIX_BFLOAT16.size == R_ext.MPIX_BFLOAT16.size == 2
    with pytest.raises(AttributeError):
        ext.MPIX_No_such_extension


def test_ftmpi_extension_binds_ft():
    """tests/test_ext.py's case: the ULFM extension's names are the ft
    plane's functions, in both packages."""
    from ompi_tpu import ext as R_ext, ft as R_ft
    from ompi_tpu_torch import ext, ft

    for name, fn in (("revoke", "revoke"), ("shrink", "shrink"),
                     ("agree", "agree"), ("iagree", "iagree"),
                     ("get_failed", "get_failed"),
                     ("ack_failed", "ack_failed")):
        assert getattr(ext, f"MPIX_Comm_{name}") is getattr(ft, fn)
        assert getattr(R_ext, f"MPIX_Comm_{name}") is getattr(R_ft, fn)
    assert set(ext.FTMPI_NAMES) <= set(ext.available())


def test_request_get_status_wtime_version():
    """Request_get_status on a generalized request before and after its
    completion, Wtime / Wtick, Get_version, Get_library_version: the
    reference's answers."""
    from ompi_tpu import mpi as R_mpi
    from ompi_tpu_torch import mpi as P_mpi

    rows = []
    for mpi in (P_mpi, R_mpi):
        req = mpi.Grequest_start(
            query_fn=lambda st: st.Set_elements(None, 12))
        flag0, st0 = mpi.Request_get_status(req)
        req.complete()
        flag1, st1 = mpi.Request_get_status(req)
        t0 = mpi.Wtime()
        time.sleep(0.01)
        dt = mpi.Wtime() - t0
        rows.append([flag0, flag1, st1.count, st1.error, mpi.Wtick(),
                     0.009 < dt < 1.0, mpi.Get_version(),
                     isinstance(mpi.Get_library_version(), str)])
    assert rows[0] == rows[1]
    assert rows[0][:2] == [False, True] and rows[0][2] == 12


def test_session_init_raises_without_the_card():
    """With the device plane on the cuda platform and no GPU,
    Session_init raises ERR_INTERN as Init does: no fallback to the
    CPU."""
    code = textwrap.dedent('''
        import torch
        from ompi_tpu_torch import errors, mpi
        assert not torch.cuda.is_available()
        got = []
        for call in (mpi.Session_init, mpi.Init):
            try:
                call()
                got.append(None)
            except errors.MPIError as e:
                got.append(e.error_class)
        print(got)
    ''')
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal needs none")
    env = dict(os.environ, PYTHONPATH=ROOT, OMPI_TPU_DEVICE_PLANE="on")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str([errors.ERR_INTERN] * 2)


# ---------------------------------------------------------------------------
# launcher jobs


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_session_only_no_world_model(docs):
    n, pairs = docs
    for p, r in pairs:
        assert p["only"] == r["only"]
        assert p["only"][0] == ["mpi://WORLD", "mpi://SELF",
                                "ompi_tpu://HOST"]
        assert p["only"][1:6] == [3, 3, [6.0] * 4, 1, False]


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_init_is_session_consumer(docs):
    n, pairs = docs
    for p, r in pairs:
        assert p["consumer"] == r["consumer"] == [6, 9, True]


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_session_groups_and_set_algebra(docs):
    n, pairs = docs
    for p, r in pairs:
        assert p["algebra"] == r["algebra"]
    assert pairs[0][0]["algebra"][0] == [2, 2, 2]


@pytest.mark.parametrize("docs", [3, 4], indirect=True)
def test_instance_count_in_both_finalize_orders(docs):
    """The instance's reference count and Is_initialized at every step:
    Init and each session acquire, Finalize and each session's finalize
    release, the last release tears the instance down (then a new session
    brings it back and a second Init still raises), in both orders."""
    n, pairs = docs
    for p, r in pairs:
        assert p["users"] == r["users"]
        if n == 4:
            assert p["order"] == r["order"] == [6, 20, True]
    want = {3: [["session", 1, False], ["session finalized", 0, False],
                ["session 2", 1, False], ["init", 2, True],
                ["finalize", 1, False], ["session 2 finalized", 0, False]],
            4: [["session", 1, False], ["init", 2, True],
                ["session finalized", 1, True], ["finalize", 0, False],
                ["session 3", 1, False], ["session 3 finalized", 0, False]]}
    assert pairs[0][0]["users"] == want[n]


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_sessions_example_device_checks(docs):
    """The example's device checks on CPU tensors (grant, query, the
    Allreduces, both recoveries, the fence replay, the fuzz schedule, the
    finalize and a second session), each rank's report."""
    n, _pairs = docs
    port, _ = _jobs[4]
    for r in range(4):
        doc = json.loads((port / "example" / f"rank{r}.json").read_text())
        assert all(c["ok"] for c in doc["cases"]), doc["cases"]
        assert len(doc["cases"]) == 20
        assert doc["report"]["grant"] == "system,mpi"
        assert doc["report"]["comm_recoveries"] == 1
        assert doc["report"]["window_recoveries"] == 2
        assert doc["coll_accelerator_staged"] == 0


@pytest.mark.parametrize("how", ["init", "session_device"])
def test_mpi_abort_kills_job(how, tmp_path):
    """tests/test_ft.py's case: one rank aborts (after Init, or after a
    session comm's device Allreduce on CPU tensors), the job comes down
    with the given code, and the launcher sweeps the job's shared-memory
    files (the shm dir is this test's own)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMPI_TPU_SHM_DIR=str(tmp_path))
    if how == "init":
        body = ("from ompi_tpu_torch import mpi\n"
                "comm = mpi.Init()\n"
                "if comm.rank == 1:\n"
                "    mpi.Abort(comm, errorcode=7)\n"
                "import time\n"
                "time.sleep(30)\n")
        t0 = time.monotonic()
        rc = _port_job(body, 3, env=env, timeout=25)
    else:
        cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
               "-n", "3", "--timeout", "25", "--mca", "device_plane", "on",
               "--mca", "device_plane_platform", "cpu", "--mca", "coll_cuda",
               "on", os.path.join(ROOT, "ompi_tpu_torch", "examples",
                                  "sessions.py"), "--abort", "2:7"]
        t0 = time.monotonic()
        rc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                            timeout=60).returncode
    assert rc == 7
    assert time.monotonic() - t0 < 25
    assert os.listdir(tmp_path) == []


def test_abort_code_zero_still_fails_and_store_propagates():
    """rte.abort with code 0 exits 1; the store answers a blocked get and
    later calls with the abort, and the client exits with its code."""
    import threading

    from ompi_tpu_torch.runtime import kvstore

    store = kvstore.Store().start()
    try:
        a, b = kvstore.Client(store.addr), kvstore.Client(store.addr)
        got = []

        def blocked():
            try:
                b.get("never", wait=True)
            except SystemExit as e:
                got.append(e.code)
        t = threading.Thread(target=blocked)
        t.start()
        time.sleep(0.2)
        assert a.aborted() is None
        a.abort(3, "test", 0)
        t.join(timeout=10)
        assert not t.is_alive() and got == [1]
        with pytest.raises(SystemExit) as ei:
            a.fence("f", 2, 0)
        assert ei.value.code == 1
        a.close()
        b.close()
    finally:
        store.stop()
    code = ("from ompi_tpu_torch.runtime import rte\n"
            "rte.init()\n"
            "rte.abort('zero', 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, timeout=60)
    assert proc.returncode == 1


_HOST_PSET = textwrap.dedent('''
    import numpy as np
    from ompi_tpu_torch import mpi
    from ompi_tpu_torch.runtime import rte
    rte.init()
    rank = rte.rank
    s = mpi.Session_init()
    hg = s.group_from_pset("ompi_tpu://HOST")
    assert hg.size == 2, hg.ranks
    assert rank in hg.ranks
    assert sorted(hg.ranks) == ([0, 1] if rank < 2 else [2, 3]), hg.ranks
    c = s.comm_from_group(hg, "test.sessions.host")
    out = np.zeros(1, np.int64)
    c.Allreduce(np.array([1], np.int64), out)
    assert out[0] == 2
    s.finalize()
''')


def test_session_host_pset_multihost(tmp_path):
    """``ompi_tpu://HOST`` resolves to this node's ranks (the PMIx host
    pset analog), across two fake hosts of the port's multi-host launch
    (tests/test_sessions.py's case)."""
    prog = tmp_path / "host_pset.py"
    prog.write_text(_HOST_PSET)
    rc = port_launcher.launch_hosts(
        [str(prog)], [port_launcher.HostSpec("fakeA", 2, "127.0.0.2"),
                      port_launcher.HostSpec("fakeB", 2, "127.0.0.3")],
        mca={"device_plane_platform": "cpu"}, timeout=120, agent="local")
    assert rc == 0, rc
