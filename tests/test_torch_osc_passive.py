"""The port's device window on the active-message plane
(``ompi_tpu_torch.osc.cuda.CudaWindow``: PSCW, passive target, the
synchronous gets and the atomics, applied through K7-K9) against the JAX
package's ``PallasWindow``.

One job per package and comm size n in {2, 3, 4}: the reference through
``tests.harness.run_ranks`` with ``device_plane on`` and ``osc_pallas
on`` (its kernels in interpret mode), the port through
``ompi_tpu_torch.runtime.launcher`` with the same settings mapped by
``compat.mca_from_reference`` plus ``device_plane_platform cpu`` (CPU
tensors: the kernels' wrappers take their plain versions). Both run, for
float32, bfloat16 and int32, the cases of ``tests/test_osc_pallas.py``
that ride the AM plane:

- PSCW (rank 0 exposes, the others Put, Put_strided, Accumulate and Get
  through Start / Complete), on 2, 3 and 4 ranks;
- lock atomicity (every rank adds one into rank 0's counter under a
  shared lock: integer values, so any arrival order gives the same bits);
- Get_accumulate, Fetch_and_op and Compare_and_swap under a self lock,
  and a NO_OP Get_accumulate that leaves the window untouched;
- the host-assisted BAND accumulate (int32; the port refuses it with
  ERR_NOT_SUPPORTED on bfloat16 and ERR_OP on float32, at the call);
- the creation fallthrough of an int16 window to the host window;
- the erroneous-call matrix (ERR_RMA_SYNC, ERR_ARG), its error classes
  compared;
- the lock-epoch strided halo: a fence-epoch ``Put_strided`` column,
  then one under Lock / Unlock. It is compared with the reference's
  ``PallasWindow`` and with a numpy replay, never with the reference's
  host window (ROADMAP queue 3: that half fails there under load).

Windows and results are compared bitwise, and the per-case deltas of the
``osc_cuda_{put,get,acc,am_ops,fallthrough}`` pvars must equal the
reference's ``osc_pallas_*``. The port job also runs the passive-target
example (``ompi_tpu_torch/examples/osc_passive.py``) at ``--tiny``, which
checks itself against a numpy replay.
"""

import json
import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch import compat
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_coll_cuda_kernels import assert_bits_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MCA = {"device_plane": "on", "osc_pallas": "on"}
PORT_MCA = dict(compat.mca_from_reference(REF_MCA),
                device_plane_platform="cpu")
DTYPES = ("float32", "bfloat16", "int32")
PVARS = ("put", "get", "acc", "am_ops", "fallthrough")
CASES = ("pscw", "lock", "rmw", "band", "halo")

#: shared verbatim by both rank programs; each prologue binds osc, OP,
#: LOCK_SHARED, win_for(base) (a device window over the numpy array),
#: dev(a), array(win) (the device window as numpy, bfloat16 as
#: ml_dtypes), counts() (the PVARS read from a fresh session) and errors
_SHARED = """
import ml_dtypes
DTYPES = {dtypes!r}
PVARS = {pvars!r}
N = 32

def cast(a, dtype):
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)

def base_for(dtype, rank):
    a = np.random.default_rng(40 + rank).standard_normal(N) * 8
    return cast(np.round(a).astype(np.float32), dtype)

def case_pscw(win, dtype):
    others = [r for r in range(size) if r != 0]
    res = {{}}
    if rank == 0:
        win.Post(others)
        win.Wait()
    else:
        win.Start([0])
        win.Put(dev(cast(np.full(2, 1.5 + rank), dtype)), 0, disp=2 * rank)
        win.Put_strided(dev(cast(np.full(2, -2.5 * rank), dtype)), 0,
                        disp=2 * rank + 9, stride=3)
        win.Accumulate(dev(cast(np.full(1, rank), dtype)), 0, disp=31,
                       op=OP.SUM)
        res["get"] = np_like(3, dtype)  # locations nobody writes here
        win.Get(res["get"], 0, disp=20)
        win.Complete()
    comm.barrier()
    return res

def np_like(m, dtype):
    return np.zeros(m, ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)

def case_lock(win, dtype):
    win.Lock(0, LOCK_SHARED)
    win.Accumulate(dev(cast(np.ones(1), dtype)), 0, disp=0)
    win.Unlock(0)
    comm.barrier()
    return {{}}

def case_rmw(win, dtype):
    val = cast(np.full(2, 2.0), dtype)
    old = np_like(2, dtype)
    win.Lock(rank)  # a self passive epoch covers the RMW ops
    win.Get_accumulate(dev(val), old, rank, disp=4)
    prev = np_like(1, dtype)
    win.Fetch_and_op(dev(cast(np.ones(1), dtype)), prev, rank, disp=4)
    got = np_like(1, dtype)
    win.Compare_and_swap(dev(cast(np.full(1, 9.0), dtype)), dev(prev), got,
                         rank, disp=4)
    miss = np_like(1, dtype)
    win.Compare_and_swap(dev(cast(np.full(1, 5.0), dtype)), dev(prev), miss,
                         rank, disp=4)
    win.Unlock(rank)
    comm.barrier()
    snap = array(win).copy()
    res = np_like(2, dtype)
    win.Lock(rank)
    win.Get_accumulate(dev(val), res, rank, disp=4, op=OP.NO_OP)
    win.Unlock(rank)
    assert np.array_equal(array(win).view(np.uint8), snap.view(np.uint8))
    return {{"old": old, "prev": prev, "got": got, "miss": miss, "res": res}}

def case_band(win, dtype):
    if dtype != "int32":
        return {{}}
    win.Fence()
    win.Accumulate(dev(np.full(4, 6, np.int32)), (rank + 1) % size, disp=2,
                   op=OP.BAND)
    win.Fence()
    return {{}}

def halo_cols(dtype):
    col = np.random.default_rng(90 + rank).standard_normal(4).astype(
        np.float32)
    return cast(col, dtype), cast(col * 2, dtype)

def case_halo(win, dtype):
    col, col2 = halo_cols(dtype)
    t = (rank + 1) % size
    win.Fence()
    win.Put_strided(dev(col), t, disp=7, stride=8)
    win.Fence()
    win.Lock(t)
    win.Put_strided(dev(col2), t, 0, 8)
    win.Unlock(t)
    comm.barrier()
    return {{}}

def error_classes(win, dtype):
    # the erroneous-call matrix: each call's error class (0: none)
    def cls(fn):
        try:
            fn()
        except errors.MPIError as e:
            return e.error_class
        return 0
    one = dev(cast(np.ones(1), dtype))
    out = [cls(lambda: win.Put(one, 0)),
           cls(lambda: win.Unlock((rank + 1) % size)),
           cls(win.Complete),
           cls(lambda: win.Get(np_like(1, dtype), 0))]
    win.Fence()
    out += [cls(lambda: win.Accumulate(np.ones(2, np.float64), 0)),
            cls(lambda: win.Rput(one, 0)),
            cls(lambda: win.Rget(np_like(1, dtype), 0))]
    win.Fence()
    return np.array(out)

def run(save, dtype):
    for case in {cases!r}:
        s = counts()
        win = win_for(base_for(dtype, rank))
        res = globals()["case_" + case](win, dtype)
        save(f"{{dtype}}_{{case}}_win", array(win))
        for k, v in res.items():
            save(f"{{dtype}}_{{case}}_{{k}}", v)
        save(f"{{dtype}}_{{case}}_pvars", np.array(
            [s.read(prefix + k) for k in PVARS]))
        win.Free()
    win = win_for(base_for(dtype, rank))
    save(f"{{dtype}}_errors", error_classes(win, dtype))
    win.Free()
"""

_REF_BODY = """
import jax.numpy as jnp
from ompi_tpu import errors, op as OP, osc
from ompi_tpu.core import pvar
from ompi_tpu.osc import LOCK_SHARED
from ompi_tpu.osc.pallas import PallasWindow
{shared}
prefix = "osc_pallas_"

def counts():
    return pvar.session()

def win_for(base):
    w = osc.win_create(comm, jnp.asarray(base),
                       disp_unit=base.dtype.itemsize)
    assert isinstance(w, PallasWindow), type(w)
    return w

def dev(a):
    return jnp.asarray(a)

def array(win):
    return np.asarray(win.array)

def save(name, a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    np.save(f"{{out_dir}}/ref_{{name}}_r{{rank}}.npy", a)

for dtype in DTYPES:
    run(save, dtype)
s = pvar.session()
w16 = osc.win_create(comm, jnp.zeros(8, jnp.int16), disp_unit=2)
assert not isinstance(w16, PallasWindow)
w16.Fence()
w16.Put(np.full(2, 3, np.int16), (rank + 1) % size, disp=0)
w16.Fence()
save("int16_win", w16.base)
save("int16_fallthrough", np.array([s.read("osc_pallas_fallthrough")]))
w16.Free()
"""

_PORT_PROG = """
import numpy as np
import torch
import ompi_tpu_torch.mpi as M
from ompi_tpu_torch import compat, errors, mpi, op as OP, osc
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.examples import osc_passive
from ompi_tpu_torch.osc import LOCK_SHARED
from ompi_tpu_torch.osc.cuda import CudaWindow
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
{shared}
prefix = "osc_cuda_"

def counts():
    return pvar.session()

def win_for(base):
    w = osc.win_create(comm, compat.tensor_from_numpy(base),
                       disp_unit=base.dtype.itemsize)
    assert isinstance(w, CudaWindow), type(w)
    return w

def dev(a):
    return compat.tensor_from_numpy(np.asarray(a))

def array(win):
    a = compat.tensor_to_numpy(win.array)
    return a.view(ml_dtypes.bfloat16) if win.array.dtype == torch.bfloat16 \\
        else a

def save(name, a):
    a = compat.tensor_to_numpy(a) if isinstance(a, torch.Tensor) \\
        else np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    np.save(f"{{out_dir}}/port_{{name}}_r{{rank}}.npy", a)

for dtype in DTYPES:
    run(save, dtype)
s = pvar.session()
w16 = osc.win_create(comm, torch.zeros(8, dtype=torch.int16), disp_unit=2)
assert type(w16) is osc.Window, type(w16)
w16.Fence()
w16.Put(np.full(2, 3, np.int16), (rank + 1) % size, disp=0)
w16.Fence()
save("int16_win", w16.base)
save("int16_fallthrough", np.array([s.read("osc_cuda_fallthrough")]))
w16.Free()

# what the port refuses at the call that the reference's target would fail
# on (or fold without a numpy type): BAND on float32 and bfloat16
for dtype, want in (("float32", errors.ERR_OP),
                    ("bfloat16", errors.ERR_NOT_SUPPORTED)):
    win = win_for(base_for(dtype, rank))
    win.Fence()
    s = pvar.session()
    try:
        win.Accumulate(dev(cast(np.ones(1), dtype)), 0, op=OP.BAND)
    except errors.MPIError as e:
        assert e.error_class == want, (dtype, e.error_class, str(e))
    else:
        raise AssertionError(f"BAND on {{dtype}} was not refused")
    assert s.read("osc_cuda_am_ops") == 0
    win.Fence()
    win.Free()

# the passive-target example at --tiny, in this job (its Finalize is ours)
fin = M.Finalize
M.Finalize = lambda: None
try:
    osc_passive.main(["--tiny", "--out", f"{{out_dir}}/port_example"])
finally:
    M.Finalize = fin
mpi.Finalize()
"""


def _port_job(src: str, n: int) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n,
                                    mca=PORT_MCA, timeout=240)
    finally:
        os.unlink(path)


_jobs = {}


@pytest.fixture(params=[2, 3, 4], scope="module")
def results(request, tmp_path_factory):
    """Run both packages' jobs once per n; returns (n, out_dir)."""
    n = request.param
    if n not in _jobs:
        out = tmp_path_factory.mktemp(f"osc_passive_n{n}")
        shared = _SHARED.format(dtypes=DTYPES, pvars=PVARS, cases=CASES)
        run_ranks(f"out_dir = {str(out)!r}\n"
                  + _REF_BODY.format(shared=shared), n, mca=REF_MCA,
                  timeout=300, isolate=True)
        rc = _port_job(_PORT_PROG.format(shared=shared, out_dir=str(out)),
                       n)
        assert rc == 0, f"port job exited {rc}"
        _jobs[n] = out
    return n, _jobs[n]


def _pair(out, name, r):
    return (np.load(out / f"ref_{name}_r{r}.npy"),
            np.load(out / f"port_{name}_r{r}.npy"))


def _check_case(out, n, dtype, case):
    for r in range(n):
        ref, got = _pair(out, f"{dtype}_{case}_win", r)
        assert_bits_equal(ref, got, f"{dtype} {case} window rank {r}")
        for p in sorted(out.glob(f"ref_{dtype}_{case}_*_r{r}.npy")):
            name = p.name[len("ref_"):-len(f"_r{r}.npy")]
            if name.endswith(("_win", "_pvars")):
                continue
            ref, got = _pair(out, name, r)
            assert ref.shape == got.shape, name
            assert_bits_equal(ref, got, f"{name} rank {r}")
        ref, got = _pair(out, f"{dtype}_{case}_pvars", r)
        assert got.tolist() == ref.tolist(), (case, dict(zip(
            PVARS, zip(ref.tolist(), got.tolist()))))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pscw_bitwise_equal_to_reference(results, dtype):
    """Post / Start / Complete / Wait: rank 0 exposes, the others Put,
    Put_strided, Accumulate and Get through the AM plane with K7-K9 at
    the target; every rank's window equals PallasWindow's bitwise."""
    n, out = results
    _check_case(out, n, dtype, "pscw")


@pytest.mark.parametrize("dtype", DTYPES)
def test_lock_accumulate_atomicity(results, dtype):
    """Every rank adds one into rank 0's counter under a shared lock:
    the total, and the window's bits, equal the reference's."""
    import ml_dtypes

    n, out = results
    _check_case(out, n, dtype, "lock")
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    base = np.round(np.random.default_rng(40).standard_normal(32) * 8)
    want = np.array([base[0] + n], np.float32).astype(dt)
    got = np.load(out / f"port_{dtype}_lock_win_r0.npy")[:1]
    assert_bits_equal(want, got, "the counter")


@pytest.mark.parametrize("dtype", DTYPES)
def test_get_accumulate_fetch_op_cas(results, dtype):
    """Get_accumulate returns the old slice, Fetch_and_op the old
    element, Compare_and_swap swaps on a hit and not on a miss, and a
    NO_OP Get_accumulate leaves the window untouched (asserted in both
    jobs): results and windows bitwise equal to PallasWindow's."""
    n, out = results
    _check_case(out, n, dtype, "rmw")


def test_band_accumulate_host_assisted(results):
    """BAND (not a kernel fold) on an int32 window: a K9 read, numpy's
    fold and a K7 replace at the target, counted in osc_cuda_fallthrough
    as the reference counts osc_pallas_fallthrough; the windows bitwise
    equal (float32 and bfloat16 refusals asserted in the port job)."""
    n, out = results
    _check_case(out, n, "int32", "band")
    for r in range(n):
        ref, got = _pair(out, "int32_band_pvars", r)
        assert got[PVARS.index("fallthrough")] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_lock_epoch_strided_halo(results, dtype):
    """A fence-epoch Put_strided column, then one under Lock / Unlock:
    the window equals PallasWindow's and a numpy replay of both puts
    (never the reference's host window, whose lock half flakes)."""
    n, out = results
    _check_case(out, n, dtype, "halo")
    import ml_dtypes

    def cast(a):
        return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                        else dtype)

    for r in range(n):
        p = (r - 1) % n
        base = np.random.default_rng(40 + r).standard_normal(32) * 8
        w = cast(np.round(base).astype(np.float32))
        col = np.random.default_rng(90 + p).standard_normal(4).astype(
            np.float32)
        w[7::8] = cast(col)
        w[0::8] = cast(col * 2)
        got = np.load(out / f"port_{dtype}_halo_win_r{r}.npy")
        assert_bits_equal(w, got, f"{dtype} halo replay rank {r}")


def test_creation_fallthrough_int16(results):
    """An int16 tensor is outside the kernels' matrix: win_create counts
    the fallthrough and serves the host window, which still works, as
    the reference's does."""
    n, out = results
    for r in range(n):
        ref, got = _pair(out, "int16_win", r)
        assert_bits_equal(ref, got, f"int16 window rank {r}")
        ref, got = _pair(out, "int16_fallthrough", r)
        assert got.tolist() == ref.tolist() == [1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_error_matrix_equal_to_reference(results, dtype):
    """Put outside any epoch, Unlock without Lock, Complete without
    Start, a sync Get outside any epoch (ERR_RMA_SYNC), an operand of
    another dtype (ERR_ARG), Rput / Rget under a fence (ERR_RMA_SYNC):
    the port raises the reference's class for each."""
    n, out = results
    for r in range(n):
        ref, got = _pair(out, f"{dtype}_errors", r)
        assert got.tolist() == ref.tolist()
        assert 0 not in ref.tolist()


def test_passive_example_tiny(results):
    """ompi_tpu_torch/examples/osc_passive.py at --tiny: its PSCW halo
    equals the same puts in fence epochs, its passive-target embedding
    rows and its atomics equal a numpy replay (on the CPU the wrappers
    count no launches; the example asserts its derived K7-K9 counts on
    the card)."""
    n, out = results
    for r in range(n):
        doc = json.loads((out / "port_example" / f"rank{r}.json")
                         .read_text())
        assert len(doc["cases"]) == 10 and all(
            c["ok"] for c in doc["cases"]), doc["cases"]
        assert doc["launches"] == {k: 0 for k in doc["launches"]}
        assert all(v > 0 for v in doc["expected_launches"].values()
                   if v is not None) and doc["expected_launches"][
                       "rma_apply_strided"] == 2 * 3


@pytest.mark.gpu
def test_passive_example_on_card():
    """On a CUDA card: the passive-target example at --tiny on 2 ranks,
    every target-side apply and read launched as K7-K9 (the example
    asserts its launch counts)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rc = port_launcher.launch(
        [sys.executable, os.path.join(ROOT, "ompi_tpu_torch", "examples",
                                      "osc_passive.py"), "--tiny"], 2,
        mca={"device_plane": "on", "osc_cuda": "on"}, timeout=240)
    assert rc == 0
