"""The port's error-handler and info planes (``errors.py``, ``info.py``,
the comm / request / window errhandlers of ``mpi.py``, ``pml/request.py``
and ``osc/``) against the JAX package's: the counterparts of
``tests/test_errhandler_info.py``'s cases, ``tests/test_attr.py``'s
``test_add_error_class_code_string_and_lastusedcode``, the errhandler on
CPU-tensor collectives through coll/device, and the memkind grant under
the null and the cuda components.

In this process: the Info object, MPI_INFO_ENV, the memkind negotiation
(the null components of both packages, then the port's cuda component
against the reference's tpu one, the kinds named through
``compat.memkinds``; with no card the grant raises, as
``MPIX_Query_cuda_support`` does), the user error space. One 2-rank
launcher job per package runs the same program (:data:`_PROG`) for the
rest; the port's job also runs the errhandler on CPU tensors (the
collectives and a DeviceEpochWindow) under ``--mca device_plane on --mca
device_plane_platform cpu``.
``test_file_errhandler_and_info`` runs with the rest of the MPI-IO plane
in ``tests/test_torch_io.py``.
"""

import json
import os
import sys
import tempfile

import pytest

from ompi_tpu_torch import compat, errors
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

#: the 2-rank program; ``{pkg}`` is the package, ``{port}`` True in the
#: port's job (which also runs the CPU-tensor collectives)
_PROG = '''
import json, os
import numpy as np
from {pkg} import errors, mpi, osc
from {pkg}.info import MEMORY_ALLOC_KINDS, env_info
PORT = {port}
comm = mpi.Init()
rank, size = comm.rank, comm.size
doc = {{}}

# -- test_errhandler_truncate_recovery
if rank == 0:
    comm.Send(np.arange(100, dtype=np.float32), dest=1, tag=7)
    comm.Send(np.arange(5, dtype=np.float32), dest=1, tag=8)
else:
    seen = []

    def on_error(obj, exc):
        assert obj is comm
        seen.append(exc.error_class)
    comm.Set_errhandler(mpi.Comm_create_errhandler(on_error))
    out = comm.Recv(np.zeros(10, np.float32), source=0, tag=7)
    ok = np.zeros(5, np.float32)
    comm.Recv(ok, source=0, tag=8)
    comm.Set_errhandler(errors.ERRORS_RETURN)
    doc["truncate"] = [out is None, seen, ok.tolist(),
                       comm.Get_errhandler() == errors.ERRORS_RETURN]
comm.Set_errhandler(errors.ERRORS_ARE_FATAL)
comm.Barrier()

# -- test_errhandler_inherited_on_dup_split
calls = []
eh = mpi.Comm_create_errhandler(lambda o, e: calls.append(e.error_class))
comm.Set_errhandler(eh)
d = comm.dup()
s = comm.split(0, key=rank)
inherit = [d.Get_errhandler() is eh, s.Get_errhandler() is eh]
g = comm.create_group(comm.Get_group()) if PORT else None
if PORT:
    inherit.append(g.Get_errhandler() is eh)
else:
    inherit.append(True)  # the reference's create_group takes a str tag


def reraise(o, e):
    raise e
d.Set_errhandler(mpi.Comm_create_errhandler(reraise))
try:
    d.Send(np.zeros(1, np.float32), dest=999)
    raised = None
except errors.MPIError as e:
    raised = e.error_class
s.Send(np.zeros(1, np.float32), dest=999)
doc["inherit"] = [inherit, raised, calls]
comm.Set_errhandler(errors.ERRORS_ARE_FATAL)

# -- test_win_errhandler_and_memkind_info
win = osc.win_create(comm, np.zeros(8, np.float32), 4,
                     info={{MEMORY_ALLOC_KINDS: "system,bogus:kind,mpi"}})
granted = win.Get_info().get(MEMORY_ALLOC_KINDS).split(",")
win.Fence()
try:
    win.Put(np.ones(2, np.float32), target=99)
    default = None
except errors.RankError as e:
    default = e.error_class
handled = []
win.Set_errhandler(mpi.Win_create_errhandler(
    lambda o, e: handled.append(e.error_class)))
win.Put(np.ones(2, np.float32), target=99)
win.Fence()
doc["win"] = [[k for k in granted if k in ("system", "mpi", "bogus:kind")],
              default, handled, win.Get_errhandler() is not None]
win.Free()

# -- test_session_info_memkinds
sess = mpi.Session_init(info={{MEMORY_ALLOC_KINDS: "system,mpi,made:up"}})
g = sess.get_info().get(MEMORY_ALLOC_KINDS).split(",")
doc["session"] = ["system" in g, "mpi" in g, "made:up" in g]
sess.finalize()

# -- test_errhandler_nonblocking_at_wait
if rank == 0:
    comm.Send(np.arange(40, dtype=np.float32), dest=1, tag=3)
else:
    seen = []
    comm.Set_errhandler(mpi.Comm_create_errhandler(
        lambda o, e: seen.append(e.error_class)))
    r = comm.Irecv(np.zeros(4, np.float32), source=0, tag=3)
    st = r.wait(timeout=60)
    flag, st2 = mpi.Request_get_status(r)
    doc["nonblocking"] = [seen, st.error, flag, st2.error]
    comm.Set_errhandler(errors.ERRORS_ARE_FATAL)
comm.Barrier()

# -- test_win_rma_ops_all_route_errhandler
win = osc.win_create(comm, np.zeros(4, np.int64), 8)
handled = []
win.Set_errhandler(mpi.Win_create_errhandler(
    lambda o, e: handled.append(e.error_class)))
win.Fence()
res = np.zeros(1, np.int64)
win.Accumulate(np.ones(1, np.int64), target=50)
win.Fetch_and_op(np.ones(1, np.int64), res, target=50)
win.Compare_and_swap(np.ones(1, np.int64), np.zeros(1, np.int64), res,
                     target=50)
win.Get_accumulate(np.ones(1, np.int64), res, target=50)
r = win.Rget(np.zeros(1, np.int64), target=50)
r.wait()
win.Fence()
win.Free()
doc["rma"] = [handled, res.tolist()]

# -- test_info_inherited_and_env_in_launched_job
comm.Set_info({{"k": "v"}})
env = env_info()
doc["info"] = [comm.dup().Get_info().get("k"),
               comm.split(0, key=rank).Get_info().get("k"),
               env.get("maxprocs"), bool(env.get("host")),
               sorted(env.keys())]

if PORT:  # the errhandler on CPU tensors through coll/device
    import torch
    cls = []
    comm.Set_errhandler(mpi.Comm_create_errhandler(
        lambda o, e: cls.append(e.error_class)))
    xs = [torch.arange(6, dtype=torch.int32) * (q + 1) for q in range(size)]
    outs = [comm.Bcast(xs[rank].clone(), root=99),
            comm.Reduce(xs[rank], root=-1)]
    got = comm.Allreduce(xs[rank])
    f = [torch.linspace(-1, 1, 6) * (q + 0.5) for q in range(size)]
    lin = comm.Allreduce(f[rank], deterministic="linear")
    comm.Set_errhandler(errors.ERRORS_ARE_FATAL)
    try:
        comm.Bcast(xs[rank].clone(), root=99)
        fatal = None
    except errors.MPIError as e:
        fatal = e.error_class
    want = f[0]
    for x in f[1:]:
        want = want + x
    doc["device"] = [cls, [o is None for o in outs], got.tolist(),
                     bool(torch.equal(lin, want)), fatal]
    # the device-epoch window's errhandler: a target outside the comm
    dw = osc.win_create_device(comm, torch.zeros(8))
    dseen = []
    dw.Set_errhandler(mpi.Win_create_errhandler(
        lambda w, e: dseen.append(e.error_class)))
    dw.Fence()
    dw.Put(torch.ones(2), 99)
    h = dw.Get(2, 99)
    dw.Put(torch.full((2,), float(rank + 1)), (rank + 1) % size, disp=0)
    dw.Fence()
    doc["device_epoch"] = [dseen, h.array.numel(), dw.array[:3].tolist()]
    dw.Free()
mpi.Finalize()
with open(os.path.join({out!r}, f"doc_r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''

#: the port job's mca beyond the reference's
_PORT_MCA = {"device_plane": "on", "device_plane_platform": "cpu"}


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    """[(port doc, reference doc)] per rank of the 2-rank program."""
    ref = tmp_path_factory.mktemp("eh_ref")
    port = tmp_path_factory.mktemp("eh_port")
    run_ranks(_PROG.format(pkg="ompi_tpu", port=False, out=str(ref)), 2,
              prelude=False, timeout=240)
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(_PROG.format(pkg="ompi_tpu_torch", port=True,
                              out=str(port)))
        path = fh.name
    try:
        rc = port_launcher.launch([sys.executable, path], 2, mca=_PORT_MCA,
                                  timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job exited {rc}"
    return [(json.loads((port / f"doc_r{r}.json").read_text()),
             json.loads((ref / f"doc_r{r}.json").read_text()))
            for r in range(2)]


# ---------------------------------------------------------------------------
# in process


def test_info_object_semantics():
    """The same operations on both packages' Info give the same results."""
    from ompi_tpu import info as R_info
    from ompi_tpu_torch import info as P_info

    got = []
    for mod in (P_info, R_info):
        inf = mod.Info()
        inf.set("a", "1")
        inf.set("b", "2")
        inf["c"] = 3
        row = [inf.get("a"), inf["c"], inf.get("zz"), inf.get("zz", "d"),
               inf.get_nkeys(), [inf.get_nthkey(i) for i in range(3)]]
        d = inf.dup()
        d.set("a", "9")
        row.append(inf.get("a"))
        inf.delete("b")
        row += ["b" in inf, inf.get_nkeys()]
        with pytest.raises(KeyError):
            inf.delete("b")
        with pytest.raises(ValueError):
            inf.set("k" * 300, "v")
        row.append(mod.Info({"x": "1"}) == mod.Info([("x", "1")]))
        got.append(row)
    assert got[0] == got[1] == [
        "1", "3", None, "d", 3, ["a", "b", "c"], "1", False, 2, True]


def test_info_env():
    from ompi_tpu.info import env_info as R_env
    from ompi_tpu_torch.info import env_info as P_env

    p, r = P_env(), R_env()
    assert p.keys() == r.keys()
    for key in ("command", "maxprocs", "host", "arch", "wdir",
                "thread_level"):
        assert p.get(key) == r.get(key), key


def _grants(mod, requests):
    return [mod.memkind_grant(q) for q in requests]


#: requests whose grants the two packages must agree on
REQUESTS = ("system,foo:bar,mpi:alloc_mem", "system,nonsense",
            "mpi,system,mpi,mpi:win_allocate",
            "system,mpi,cuda,cuda:device,cuda:managed,bogus",
            "cuda:device,system", "", "cuda:device")
#: the port's device kinds in a request, as the reference names them
_TO_REF = {"cuda": "tpu", "cuda:device": "tpu:hbm",
           "cuda:managed": "tpu:managed"}


def _as_reference(request: str) -> str:
    return ",".join(_TO_REF.get(k, k) for k in request.split(","))


def test_memkind_negotiation(monkeypatch):
    """Under both packages' null components: the same supported kinds,
    the same grants, and apply_memkinds' rewrite."""
    import ompi_tpu.accelerator as R_acc
    from ompi_tpu import info as R_info
    from ompi_tpu.accelerator.null import NullAccelerator
    import ompi_tpu_torch.accelerator as P_acc
    from ompi_tpu_torch import info as P_info

    monkeypatch.setattr(R_acc, "_current", NullAccelerator())
    monkeypatch.setattr(P_acc, "_current", P_acc.Accelerator())
    assert P_info.supported_memkinds() == R_info.supported_memkinds() == [
        "system", "mpi", "mpi:alloc_mem", "mpi:win_allocate"]
    assert _grants(P_info, REQUESTS) == _grants(R_info, REQUESTS)
    granted = P_info.memkind_grant("system,foo:bar,mpi:alloc_mem")
    assert granted == "system,mpi:alloc_mem"
    for mod in (P_info, R_info):
        inf = mod.Info({mod.MEMORY_ALLOC_KINDS: "system,nonsense"})
        assert mod.apply_memkinds(inf).get(mod.MEMORY_ALLOC_KINDS) \
            == "system"


def test_memkind_grant_under_cuda_and_no_fallback(monkeypatch):
    """The port's cuda component against the reference's tpu one: the
    same grants with the device kinds named through ``compat.memkinds``.
    With the device plane on the cuda platform and no card, the grant and
    ``MPIX_Query_cuda_support`` raise ERR_INTERN (the reference's grant
    falls back to the base kinds); a device runtime that fails inside the
    query raises too."""
    import torch

    import ompi_tpu.accelerator as R_acc
    from ompi_tpu import info as R_info
    import ompi_tpu_torch.accelerator as P_acc
    from ompi_tpu_torch import ext, info as P_info
    from ompi_tpu_torch.accelerator.cuda import CudaAccelerator
    from ompi_tpu_torch.core import cvar
    from ompi_tpu_torch.runtime import device_plane  # noqa: F401 — its cvars

    monkeypatch.setattr(R_acc, "_current", None)
    assert R_acc.current().NAME == "tpu"  # CPU devices on this host
    monkeypatch.setattr(P_acc, "_current", CudaAccelerator())
    assert P_info.supported_memkinds()[-2:] == ["cuda", "cuda:device"]
    ref = [compat.memkinds(g) for g in _grants(
        R_info, [_as_reference(q) for q in REQUESTS])]
    assert _grants(P_info, REQUESTS) == ref
    assert P_info.memkind_grant(REQUESTS[3]) == "system,mpi,cuda,cuda:device"

    class Broken(CudaAccelerator):
        def num_devices(self):
            raise RuntimeError("CUDA driver initialization failed")
    monkeypatch.setattr(P_acc, "_current", Broken())
    with pytest.raises(RuntimeError):
        ext.MPIX_Query_cuda_support()
    if torch.cuda.is_available():
        return
    monkeypatch.setattr(P_acc, "_current", None)
    try:
        cvar.set("device_plane", "on")
        for call in (lambda: P_info.memkind_grant("system,cuda"),
                     ext.MPIX_Query_cuda_support):
            with pytest.raises(errors.MPIError) as ei:
                call()
            assert ei.value.error_class == errors.ERR_INTERN
    finally:
        cvar.set("device_plane", "off")
        P_acc.reset_for_testing()


def test_add_error_class_code_string_and_lastusedcode():
    """tests/test_attr.py's case on both packages: the dynamic error space
    above LASTCODE, LASTUSEDCODE live with it, the same refusals."""
    from ompi_tpu import attr as R_attr, errors as R_errors, mpi as R_mpi
    from ompi_tpu_torch import attr as P_attr, mpi as P_mpi

    class PObj(P_attr.AttrHost):
        def __init__(self):
            self.attrs = {}

    class RObj:
        def __init__(self):
            self.attrs = {}

    def lastused(attr, o):
        if attr is P_attr:
            return o.Get_attr(attr.LASTUSEDCODE)
        return attr.get_attr(o, "comm", attr.LASTUSEDCODE)

    rows = []
    for attr, errs, mpi, o in ((P_attr, errors, P_mpi, PObj()),
                               (R_attr, R_errors, R_mpi, RObj())):
        before = lastused(attr, o)
        cls = mpi.Add_error_class()
        code = mpi.Add_error_code(cls)
        mpi.Add_error_string(code, "my library exploded")
        c2 = mpi.Add_error_code(errs.ERR_TYPE)
        row = [cls > errs.ERR_LASTCODE, code - cls, mpi.Error_class(code)
               - cls, mpi.Error_class(cls) - cls, mpi.Error_string(code),
               mpi.Error_string(errs.ERR_TRUNCATE), mpi.Error_string(10 ** 6),
               lastused(attr, o) - before,
               mpi.Error_class(c2) == errs.ERR_TYPE]
        for call in (lambda: mpi.Add_error_string(errs.ERR_TYPE, "nope"),
                     lambda: mpi.Add_error_code(10 ** 6),
                     lambda: mpi.Add_error_code(code),
                     lambda: mpi.Add_error_string(10 ** 6, "never")):
            with pytest.raises(errs.MPIError) as ei:
                call()
            row.append(ei.value.error_class)
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[0][:9] == [True, 1, 0, 0, "my library exploded",
                           "MPI_ERR_TRUNCATE", "MPI error 1000000", 3, True]
    assert errors.ERR_LASTCODE == R_errors.ERR_LASTCODE


def test_error_class_table_matches_reference():
    """Every class number, the subclasses make_mpi_error raises and the
    errhandler modes are the reference's."""
    from ompi_tpu import errors as R_errors

    names = sorted(k for k in vars(R_errors) if k.startswith("ERR_")
                   or k.startswith("ERRORS_") or k == "SUCCESS")
    assert names == sorted(k for k in vars(errors) if k.startswith("ERR_")
                           or k.startswith("ERRORS_") or k == "SUCCESS")
    for k in names:
        assert getattr(errors, k) == getattr(R_errors, k), k
    for cls in sorted(R_errors._CLASS_MAP):
        p, r = errors.make_mpi_error(cls), R_errors.make_mpi_error(cls)
        assert type(p).__name__ == type(r).__name__
        assert p.error_class == r.error_class == cls
        assert str(p) == str(r)
    seen = []
    eh = errors.create_errhandler(lambda o, e: seen.append(e))
    holder = type("H", (), {"errhandler": eh})()
    assert errors.dispatch(holder, errors.RankError()) is True
    holder.errhandler = errors.ERRORS_RETURN
    with pytest.raises(errors.RankError):
        errors.dispatch(holder, errors.RankError())
    assert len(seen) == 1
    with pytest.raises(TypeError):
        errors.create_errhandler(5)


# ---------------------------------------------------------------------------
# launcher jobs


def test_errhandler_truncate_recovery(docs):
    p, r = docs[1]
    assert p["truncate"] == r["truncate"] == [
        True, [errors.ERR_TRUNCATE], [0.0, 1.0, 2.0, 3.0, 4.0], True]


def test_errhandler_inherited_on_dup_split(docs):
    for p, r in docs:
        assert p["inherit"] == r["inherit"] == [
            [True, True, True], errors.ERR_RANK, [errors.ERR_RANK]]


def test_win_errhandler_and_memkind_info(docs):
    for p, r in docs:
        assert p["win"] == r["win"] == [["system", "mpi"], errors.ERR_RANK,
                                        [errors.ERR_RANK], True]


def test_session_info_memkinds(docs):
    for p, r in docs:
        assert p["session"] == r["session"] == [True, True, False]


def test_errhandler_nonblocking_at_wait(docs):
    p, r = docs[1]
    assert p["nonblocking"] == r["nonblocking"] == [
        [errors.ERR_TRUNCATE], errors.ERR_TRUNCATE, True,
        errors.ERR_TRUNCATE]


def test_win_rma_ops_all_route_errhandler(docs):
    for p, r in docs:
        assert p["rma"] == r["rma"] == [[errors.ERR_RANK] * 5, [0]]


def test_info_inherited_and_env_in_launched_job(docs):
    for p, r in docs:
        assert p["info"] == r["info"]
        assert p["info"][:4] == ["v", "v", "2", True]


def test_errhandler_on_cpu_tensor_collectives(docs):
    """coll/device on CPU tensors: a root outside the comm is ERR_ROOT on
    every rank before any hop, so a callback recovers Bcast and Reduce
    (None) and the next Allreduces are exact (int32) and bitwise the
    rank-order fold ('linear'); back on ERRORS_ARE_FATAL the same call
    raises."""
    for p, _r in docs:
        cls, nones, got, linear_ok, fatal = p["device"]
        assert cls == [errors.ERR_ROOT, errors.ERR_ROOT]
        assert nones == [True, True]
        assert got == [v * 3 for v in range(6)]  # (1 + 2) x arange
        assert linear_ok and fatal == errors.ERR_ROOT


def test_errhandler_on_the_device_epoch_window(docs):
    """A DeviceEpochWindow's callback recovers a Put and a Get to a rank
    outside the comm (the Get's handle holds an empty tensor after the
    fence), and the epoch's valid Put lands."""
    for r, (p, _r) in enumerate(docs):
        seen, got_n, win = p["device_epoch"]
        assert seen == [errors.ERR_RANK, errors.ERR_RANK]
        assert got_n == 0
        left = (r - 1) % 2
        assert win == [float(left + 1)] * 2 + [0.0]
