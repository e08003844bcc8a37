"""The port's compiled-fence device window (``ompi_tpu_torch.osc.
DeviceEpochWindow``, ``osc.win_create_device``) against the JAX package's.

One job per package and comm size n in {2, 3, 4}: the reference through
``tests.harness.run_ranks`` under ``device_plane on`` (its fence epochs
lowered to ``lax.ppermute`` rounds), the port through
``ompi_tpu_torch.runtime.launcher`` under ``device_plane on`` and
``device_plane_platform cpu`` (the rounds moved in exchanges over
shared-memory arenas, K7-K10 taking their plain versions on CPU tensors).
Both run, on the same numpy-seeded data:

- the three cases of ``tests/test_osc_device_epoch.py`` (a ring of puts
  with a get of the same location, puts of two sizes and empty epochs,
  fused accumulates of several kinds from every origin, the ``op.Op``
  form, the ERR_OP refusal) on 3 and 4 ranks, and
  ``tests/test_osc_pallas.py``'s ``test_device_epoch_fallback_counted``
  on 2, 3 and 4;
- one schedule per window dtype (float32, bfloat16, int32): puts,
  accumulates of every fusable kind, every origin's accumulates of two
  sizes onto the same slots of rank 0, gets, and a second epoch of MAX
  and SUM onto one row;
- same-row SUM accumulates from every origin, three a target, in float32
  and bfloat16, with magnitudes spread so the sum's bits show its order,
  and a smaller PROD that the size-grouped rounds apply first;
- payloads of float64 and int32 cast into a float32 window (Put and
  Accumulate).

The windows, the Get handles and the pvars the reference's tests read
(``osc_device_epoch_op``, ``osc_device_fallbacks``,
``coll_accelerator_staged`` and the host window's ``osc_put`` /
``osc_get`` / ``osc_acc``, as session deltas) are compared bitwise. The
port job also checks the port's stated differences (a numpy base, a base
the kernels do not take, shapes that differ across ranks, ops outside the
window or the comm) and, on 4 ranks, runs ``examples/device_epoch.py
--tiny`` (its lookups and rows against a numpy replay, each epoch against
a CudaWindow, the IPC hand-off).
"""

import json
import os
import sys
import tempfile
import textwrap

import ml_dtypes
import numpy as np
import pytest

from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_coll_cuda_kernels import assert_bits_equal

REF_MCA = {"device_plane": "on"}
PORT_MCA = {"device_plane": "on", "device_plane_platform": "cpu"}
NS = (2, 3, 4)
#: case -> the rank counts it runs on
CASES = {
    "put_get_no_staging": (3, 4),
    "multiple_puts_and_sizes": (3, 4),
    "accumulate_fused": (3, 4),
    "fallback_counted": (2, 3, 4),
    "dtypes": (2, 3, 4),
    "same_row": (3, 4),
    "cast": (2, 3, 4),
}
ORDER_SEED = 800  # case_same_row's generators: ORDER_SEED + rank

#: shared verbatim by both packages' rank programs; each prologue binds
#: osc, OP, errors, pvar, dev(a) (numpy -> the package's device array),
#: to_np(x) (-> numpy, bfloat16 as ml_dtypes) and out_dir, pkg
_SHARED = """
import ml_dtypes

def cast(a, dtype):
    return np.asarray(a).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)

def payload(dtype, rng, m):
    if dtype == "int32":
        return rng.integers(-50, 50, m).astype(np.int32)
    return cast((rng.standard_normal(m) * 4).astype(np.float32), dtype)

def pvars(s):
    return np.array([s.read(k) for k in (
        "osc_device_epoch_op", "osc_device_fallbacks",
        "coll_accelerator_staged", "osc_put", "osc_get", "osc_acc")])

def case_put_get_no_staging():
    s = pvar.session()
    win = osc.win_create_device(comm, dev(np.zeros(16, np.float32)))
    win.Fence()
    # ring of puts: rank r writes [r, r+0.5] into (r+1)%size at disp 2r
    nxt = (rank + 1) % size
    win.Put(dev(np.array([rank, rank + 0.5], np.float32)), target=nxt,
            disp=2 * rank)
    # and fetches back the location it just put (puts run before gets)
    prev = (rank - 1 + size) % size
    h = win.Get(2, target=nxt, disp=2 * rank)
    win.Fence()
    got = to_np(win.array)
    assert got[2 * prev] == prev and got[2 * prev + 1] == prev + 0.5, got
    np.testing.assert_array_equal(
        to_np(h.array), np.array([rank, rank + 0.5], np.float32))
    p = pvars(s)
    assert p[2] == 0 and p[3] == 0 and p[4] == 0 and p[0] == 2, p
    win.Free()
    return {"win": got, "h": to_np(h.array), "pvars": p}

def case_multiple_puts_and_sizes():
    s = pvar.session()
    win = osc.win_create_device(comm, dev(np.zeros(32, np.float32)))
    win.Fence()
    if rank == 0:
        # two different-size puts to two targets in ONE epoch
        win.Put(dev(np.full(4, 7.0, np.float32)), target=1, disp=0)
        win.Put(dev(np.full(8, 9.0, np.float32)), target=2, disp=8)
    if rank == 3:
        win.Put(dev(np.full(4, 3.0, np.float32)), target=1, disp=4)
    win.Fence()
    a = to_np(win.array)
    if rank == 1:
        assert (a[:4] == 7.0).all(), a
        assert size < 4 or (a[4:8] == 3.0).all(), a
    if rank == 2:
        assert (a[8:16] == 9.0).all(), a
    assert pvars(s)[2] == 0
    # empty epoch is legal
    win.Fence()
    win.Fence()
    out = {"win": to_np(win.array), "pvars": pvars(s)}
    win.Free()
    return out

def case_accumulate_fused():
    s = pvar.session()
    win = osc.win_create_device(comm, dev(np.zeros(16, np.float32)))
    win.Fence()
    # EVERY rank accumulates into rank 0's window slot 0..4 (combines)
    win.Accumulate(dev(np.full(4, float(rank + 1), np.float32)),
                   target=0, disp=0, op="sum")
    if rank == 1:
        win.Put(dev(np.full(2, 5.0, np.float32)), target=2, disp=4)
        win.Accumulate(dev(np.full(2, 9.0, np.float32)), target=size - 1,
                       disp=8, op="replace")
    h = win.Get(4, target=(rank + 1) % size, disp=0) if rank == 2 \\
        else None
    win.Fence()
    a = to_np(win.array)
    if rank == 0:
        exp = sum(r + 1 for r in range(size))
        assert (a[:4] == exp).all(), a
    if rank == 2:
        assert (a[4:6] == 5.0).all(), a
    if rank == size - 1:
        assert (a[8:10] == 9.0).all(), a
    first = a
    # second epoch: MAX accumulate over prior content
    win.Fence()
    win.Accumulate(dev(np.full(4, float(10 * rank), np.float32)),
                   target=0, disp=0, op="max")
    win.Fence()
    if rank == 0:
        exp = max(sum(r + 1 for r in range(size)), 10 * (size - 1))
        assert (to_np(win.array)[:4] == exp).all(), win.array
    p = pvars(s)
    assert p[2] == 0 and p[5] == 0, p
    # the host-window Op convention works too (surfaces match)
    win.Fence()
    win.Accumulate(dev(np.full(4, 1.0, np.float32)), target=0, disp=12,
                   op=OP.SUM)
    win.Fence()
    if rank == 0:
        assert (to_np(win.array)[12:16] == size).all(), win.array
    # non-fusable ops are rejected toward the AM path
    try:
        win.Accumulate(dev(np.ones(1, np.float32)), target=0, op="bxor")
        raise SystemExit("bxor accepted")
    except errors.MPIError as e:
        assert e.error_class == errors.ERR_OP
    out = {"first": first, "win": to_np(win.array), "pvars": pvars(s),
           "h": to_np(h.array) if h is not None else np.zeros(4, np.float32)}
    win.Free()
    return out

def case_fallback_counted():
    s = pvar.session()
    win = osc.win_create_device(comm, dev(np.zeros(8, np.float32)))
    win.Fence()
    try:
        win.Accumulate(dev(np.ones(2, np.float32)), 0, op=OP.BAND)
        raise AssertionError("non-fusable acc did not raise")
    except errors.MPIError as e:
        assert e.error_class == errors.ERR_OP
    assert s.read("osc_device_fallbacks") == 1
    classes = []
    for verb, args in (("Lock", (0,)), ("Unlock", (0,)),
                       ("Flush", (0,)), ("Post", ([0],)),
                       ("Start", ([0],))):
        try:
            getattr(win, verb)(*args)
            raise AssertionError(f"{verb} on device-epoch window")
        except errors.MPIError as e:
            assert e.error_class == errors.ERR_RMA_SYNC
            classes.append(e.error_class)
    assert s.read("osc_device_fallbacks") == 6
    win.Fence()
    win.Free()
    return {"pvars": pvars(s), "classes": np.array(classes)}

def case_dtypes():
    res = {}
    for dtype in ("float32", "bfloat16", "int32"):
        rng = np.random.default_rng(700 + rank)
        base = payload(dtype, np.random.default_rng(600 + rank), 48)
        win = osc.win_create_device(comm, dev(base))
        nxt, prv = (rank + 1) % size, (rank - 1) % size
        win.Fence()
        win.Put(dev(payload(dtype, rng, 4)), nxt, disp=0)
        for k, o in enumerate(("sum", "min", "max", "prod", "replace")):
            win.Accumulate(dev(payload(dtype, rng, 2)), nxt, disp=4 + 2 * k,
                           op=o)
        # every origin onto the same slots of rank 0, two sizes and the
        # op.Op form
        win.Accumulate(dev(payload(dtype, rng, 3)), 0, disp=20, op="sum")
        win.Accumulate(dev(payload(dtype, rng, 5)), 0, disp=20, op=OP.SUM)
        win.Accumulate(dev(payload(dtype, rng, 3)), 0, disp=21, op=OP.PROD)
        h1 = win.Get(6, prv, disp=0)
        h2 = win.Get(5, 0, disp=20)
        win.Fence()
        # a second epoch: MAX, then SUM from another origin, onto one row
        win.Accumulate(dev(payload(dtype, rng, 4)), prv, disp=40, op="max")
        win.Accumulate(dev(payload(dtype, rng, 4)), (rank + 2) % size,
                       disp=40, op="sum")
        h3 = win.Get(8, nxt, disp=40)
        win.Fence()
        res[dtype + "_win"] = to_np(win.array)
        for k, h in (("h1", h1), ("h2", h2), ("h3", h3)):
            res[f"{dtype}_{k}"] = to_np(h.array)
        win.Free()
    return res

def case_same_row():
    res = {}
    for dtype in ("float32", "bfloat16"):
        win = osc.win_create_device(comm, dev(cast(np.ones(16), dtype)))
        rng = np.random.default_rng(ORDER_SEED + rank)
        win.Fence()
        for rep in range(3):
            for t in range(size):
                v = (rng.standard_normal(4)
                     * 2.0 ** rng.integers(-10, 11, 4)).astype(np.float32)
                win.Accumulate(dev(cast(v, dtype)), t, disp=4, op="sum")
        if rank == 1:  # a smaller payload: its round group runs first
            win.Accumulate(dev(cast(np.full(2, 3.0), dtype)), 0, disp=5,
                           op="prod")
        win.Fence()
        res[dtype] = to_np(win.array)
        win.Free()
    return res

def case_cast():
    win = osc.win_create_device(comm, dev(np.zeros(16, np.float32)))
    rng = np.random.default_rng(900 + rank)
    f64 = rng.standard_normal(4) * 1e3 + 1e-9  # rounds to float32
    i32 = rng.integers(1 << 24, 1 << 30, 4).astype(np.int32)  # past 2**24
    nxt = (rank + 1) % size
    win.Fence()
    win.Put(dev(f64), nxt, disp=0)
    win.Put(dev(i32), nxt, disp=4)
    win.Accumulate(dev(f64), nxt, disp=8, op="sum")
    win.Accumulate(dev(i32), nxt, disp=8, op="sum")
    h = win.Get(12, nxt, disp=0)
    win.Fence()
    out = {"win": to_np(win.array), "h": to_np(h.array)}
    win.Free()
    return out

def save(name, a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    np.save(f"{out_dir}/{pkg}_{name}_r{rank}.npy", a)

def run(cases):
    for case in cases:
        for k, v in globals()["case_" + case]().items():
            save(f"{case}_{k}", v)
"""

_REF_BODY = """
import jax.numpy as jnp
from ompi_tpu import errors, op as OP, osc
from ompi_tpu.core import pvar
pkg, out_dir, ORDER_SEED = "ref", {out_dir!r}, {order_seed}

def dev(a):
    return jnp.asarray(a)

def to_np(x):
    return np.asarray(x)
{shared}
run({cases!r})
"""

_PORT_PROG = """
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi, op as OP, osc
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.runtime import device_plane
comm = mpi.Init()
rank, size = comm.rank, comm.size
pkg, out_dir, ORDER_SEED = "port", {out_dir!r}, {order_seed}

def dev(a):
    return compat.tensor_from_numpy(np.asarray(a), device_plane.device())

def to_np(x):
    # a copy: win.array is a live view of the window (the reference's is
    # an immutable array)
    a = compat.tensor_to_numpy(x).copy()
    return a.view(ml_dtypes.bfloat16) if x.dtype == torch.bfloat16 else a
{shared}
run({cases!r})

def refused(call, cls):
    try:
        call()
    except errors.MPIError as e:
        return e.error_class == cls
    return False

# the port's stated differences, each on every rank
flags = []
flags.append(refused(lambda: osc.win_create_device(
    comm, np.zeros(4, np.float32)), errors.ERR_BUFFER))
flags.append(refused(lambda: osc.win_create_device(
    comm, dev(np.zeros(4, np.float64))), errors.ERR_ARG))
flags.append(refused(lambda: osc.win_create_device(
    comm, dev(np.zeros(4 + (rank == 0), np.float32))), errors.ERR_ARG))
base = dev(np.arange(8, dtype=np.float32))
win = osc.win_create_device(comm, base)
flags.append(win.array.data_ptr() != base.data_ptr())
win.Fence()
one = dev(np.ones(2, np.float32))
flags.append(refused(lambda: win.Put(one, 0, disp=7), errors.ERR_ARG))
flags.append(refused(lambda: win.Put(one, 0, disp=-1), errors.ERR_ARG))
flags.append(refused(lambda: win.Get(9, 0), errors.ERR_ARG))
flags.append(refused(lambda: win.Accumulate(one, size, disp=0),
                     errors.ERR_RANK))
win.Put(one, (rank + 1) % size, disp=6)
win.Put(dev(np.zeros(0, np.float32)), 0, disp=8)  # moves nothing
h0 = win.Get(0, 0, disp=8)
flags.append(h0.array is None)  # fills at the closing fence
win.Fence()
flags.append(h0.array is not None and h0.array.numel() == 0)
want = np.arange(8, dtype=np.float32)
want[6:] = 1
flags.append(bool((to_np(win.array) == want).all()))
flags.append(bool((to_np(base) == np.arange(8)).all()))  # untouched
win.Free()
np.save(f"{{out_dir}}/port_flags_r{{rank}}.npy", np.array(flags))
if size == 4:  # the example at --tiny; its Finalize is this job's
    # count launches as the card would: the fence's K7 / K8 / K9 calls by
    # their plans' tables, K10 by its copy tables (the plain versions on
    # CPU tensors count nothing)
    from ompi_tpu_torch.osc import cuda_kernels as O
    _apply, _read, _land = O.Target.apply, O.Target.read, \
        O.rma_permute_recv_batch

    def apply(self, bases, rows):
        for what, _r in O.plan_apply(self.size, rows):
            k = O.rma_apply if what == "k7" else O.rma_apply_strided_batch
            k.launches += 1
        _apply(self, bases, rows)

    def read(self, rows, out):
        O.rma_read_batch.launches += len(O.plan_read(self.size, rows))
        _read(self, rows, out)

    def land(pairs):
        land.launches += len(O.copy_tables(pairs))
        _land(pairs)

    land.launches = 0
    land.__name__ = "rma_permute_recv_batch"
    O.Target.apply, O.Target.read = apply, read
    O.rma_permute_recv_batch = land
    O.KERNELS = O.KERNELS + (land,)
    from ompi_tpu_torch.examples import device_epoch
    device_epoch.main(["--tiny", "--out", f"{{out_dir}}/example"])
else:
    mpi.Finalize()
"""


def _cases(n: int):
    return [c for c, ns in CASES.items() if n in ns]


_jobs = {}


def _results(n: int, tmp_path_factory):
    """Run both packages' jobs once per n; returns the output dir."""
    if n not in _jobs:
        out = tmp_path_factory.mktemp(f"osc_device_epoch_n{n}")
        kw = dict(shared=_SHARED, cases=_cases(n), out_dir=str(out),
                  order_seed=ORDER_SEED)
        run_ranks(_REF_BODY.format(**kw), n, mca=REF_MCA, timeout=300)
        with tempfile.NamedTemporaryFile("w", suffix=".py",
                                         delete=False) as fh:
            fh.write(textwrap.dedent(_PORT_PROG.format(**kw)))
            path = fh.name
        try:
            rc = port_launcher.launch([sys.executable, path], n,
                                      mca=PORT_MCA, timeout=300)
        finally:
            os.unlink(path)
        assert rc == 0, f"port job exited {rc}"
        _jobs[n] = out
    return _jobs[n]


PAIRS = [(n, c) for n in NS for c in _cases(n)]


@pytest.mark.parametrize("n,case", PAIRS, ids=[f"{c}-n{n}" for n, c in PAIRS])
def test_device_epoch_equal_to_reference(n, case, tmp_path_factory):
    """Each case's windows, Get handles and pvars on every rank bitwise
    equal to the reference's."""
    out = _results(n, tmp_path_factory)
    names = sorted(p.name[len("ref_"):] for p in out.glob(f"ref_{case}_*"))
    assert names and len(names) % n == 0, names
    for name in names:
        ref = np.load(out / f"ref_{name}")
        got = np.load(out / f"port_{name}")
        assert ref.dtype == got.dtype and ref.shape == got.shape, \
            (name, ref.dtype, got.dtype, ref.shape, got.shape)
        assert_bits_equal(ref, got, name)


def _fold_in_call_order(n: int, dtype: str) -> np.ndarray:
    """Rank 0's window after case_same_row if every origin's ops applied
    in rank order and call order (not the reference's rounds)."""
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    win = np.ones(16, dt)
    for q in range(n):
        rng = np.random.default_rng(ORDER_SEED + q)
        for _rep in range(3):
            for t in range(n):
                v = (rng.standard_normal(4)
                     * 2.0 ** rng.integers(-10, 11, 4)).astype(np.float32)
                if t == 0:
                    win[4:8] = win[4:8] + v.astype(dt)
        if q == 1:
            win[5:7] = win[5:7] * np.full(2, 3.0).astype(dt)
    return win


@pytest.mark.parametrize("n", (3, 4))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_same_row_order_is_visible(n, dtype, tmp_path_factory):
    """case_same_row's values show the order: applied in rank and call
    order instead of the reference's rounds, rank 0's row has other bits
    (so the bitwise parity above would catch a change of order)."""
    out = _results(n, tmp_path_factory)
    ref = np.load(out / f"ref_same_row_{dtype}_r0.npy")
    naive = _fold_in_call_order(n, dtype)
    naive = naive.view(np.uint16) if dtype == "bfloat16" else naive
    assert ref.tobytes() != naive.tobytes(), (ref, naive)


@pytest.mark.parametrize("n", NS)
def test_port_stated_differences(n, tmp_path_factory):
    """The port's refusals (a numpy base ERR_BUFFER; a float64 base and
    shapes that differ across ranks ERR_ARG on every rank; a Put past the
    window's end or before its start, an oversized Get ERR_ARG; a target
    outside the comm ERR_RANK), the cloned base left untouched, and empty
    ops (a zero-element Get fills at the closing fence)."""
    out = _results(n, tmp_path_factory)
    for r in range(n):
        flags = np.load(out / f"port_flags_r{r}.npy")
        assert flags.all() and flags.size == 12, (r, flags)


def test_example_device_epoch_tiny(tmp_path_factory):
    """examples/device_epoch.py --tiny in the 4-rank port job: every
    rank's checks (lookups and rows against the numpy replay, each epoch
    against a CudaWindow, the block exchange, the IPC hand-off, the
    pvars) held, and the K7-K10 launches it derives from the schedules
    equal the ones its fences planned."""
    out = _results(4, tmp_path_factory) / "example"
    for r in range(4):
        with open(out / f"rank{r}.json") as f:
            doc = json.load(f)
        assert doc["cases"] and all(c["ok"] for c in doc["cases"]), doc
        assert doc["pvars"]["osc_device_epoch_op"] > 0
        # the launches the rank derived from every rank's schedule are the
        # ones its fences planned (counted as on the card), for both windows
        want = doc["part_expected"]
        assert set(want) == {"embedding", "block"}, want
        assert doc["part_launches"] == want, (r, doc["part_launches"], want)
        assert doc["part_cuda_window"] == want, (r, doc["part_cuda_window"])
        assert sum(want["embedding"].values()) > 0
