"""The port's host window (``ompi_tpu_torch.osc.Window``, its
active-message service) against the JAX package's.

One job per package and comm size n in {3, 4}: the reference through
``tests.harness.run_ranks`` (an isolated job), the port through
``ompi_tpu_torch.runtime.launcher``, both without the device plane (the
host window serves every buffer). Both run, on the same numpy-seeded
data:

- every case of ``tests/test_osc.py``, each on n ranks (fence Put / Get,
  the exclusive-lock counter, Rput after a Get, Rget, Fetch_and_op and
  Compare_and_swap, PSCW, ``win_allocate`` under Lock_all, a device
  buffer staged through the host mirror (a jax array there, a CPU tensor
  here), ``device_array`` on a host window, ``win_allocate_shared``, the
  dynamic window, ``Get_group`` and ``Sync``);
- the window case of ``tests/test_attr.py`` (the predefined WIN_*
  attributes and a keyval's delete callback at Free);
- one schedule per dtype (float32, bfloat16, int32) through every epoch:
  a fence with puts, strided puts and accumulates of every kind (the
  ordered same-origin pair, BAND on int32), a fence of Get / Get_strided,
  PSCW, an exclusive lock with a strided put and Get_accumulate (NO_OP
  among them), a Lock_all with Fetch_and_op and Compare_and_swap, and a
  shared lock with Rput / Rget; once over numpy windows and once over
  tensor windows in the staging mode. numpy holds no bfloat16: the
  port's bfloat16 tensors move as their bits and their folds raise
  ERR_NOT_SUPPORTED (asserted in the port job), and the reference's host
  window takes bfloat16 as uint16 bits only (an ml_dtypes array's
  ``dtype.str`` is a void type that its views cannot cast), so its
  bfloat16 windows and operands are those bits and the bfloat16
  schedule folds nothing in either package.

The windows and every result are compared bitwise.
"""

import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_coll_cuda_kernels import assert_bits_equal

DTYPES = ("float32", "bfloat16", "int32")
MODES = ("numpy", "staged")
#: the cases of tests/test_osc.py (and test_attr.py's window case)
CASES = ("fence_put_get", "lock_counter", "rput_after_get",
         "rget_and_flush", "fetch_and_op_cas", "pscw", "allocate_lock_all",
         "device_buffer", "device_array_error", "allocate_shared",
         "dynamic", "group_sync", "attrs")

#: shared verbatim by both rank programs; each prologue binds osc, OP,
#: LOCK_*, mpi, dev(a) (numpy -> the package's device operand), to_np(x)
#: (a device operand -> numpy, bfloat16 as its ml_dtypes type) and
#: dev_zeros(shape, dtype)
_SHARED = """
import ml_dtypes
N = 32

def cast(a, dtype):
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)

def payload(dtype, rng, m):
    if dtype == "int32":
        return rng.integers(-50, 50, m).astype(np.int32)
    return cast((rng.standard_normal(m) * 4).astype(np.float32), dtype)

def np_zeros(m, dtype):
    return np.zeros(m, ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)

def bits16(a):
    # the reference's host window takes bfloat16 as its bits only (an
    # ml_dtypes array's dtype.str is a void type its views cannot cast)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

def dtype_schedule(win, dev, zeros, dtype, folds):
    # every epoch over one N-element window (disp_unit = item size); the
    # locations each origin writes in an epoch are its own
    rng = np.random.default_rng(500 + rank)
    nxt, prv = (rank + 1) % size, (rank - 1) % size
    res = {}
    win.Fence()
    win.Put(dev(payload(dtype, rng, 4)), nxt, disp=0)
    win.Put_strided(dev(payload(dtype, rng, 3)), prv, disp=5, stride=6)
    win.Accumulate(dev(payload(dtype, rng, 2)), nxt, disp=28, op=OP.REPLACE)
    if folds:
        for k, o in enumerate((OP.SUM, OP.MIN, OP.MAX, OP.PROD)):
            win.Accumulate(dev(payload(dtype, rng, 2)), nxt, disp=20 + 2 * k,
                           op=o)
        # the same-origin ordered pair onto one location
        win.Accumulate(dev(payload(dtype, rng, 2)), nxt, disp=12, op=OP.SUM)
        win.Accumulate(dev(payload(dtype, rng, 2)), nxt, disp=12,
                       op=OP.PROD)
        if dtype == "int32":
            win.Accumulate(dev(payload(dtype, rng, 2)), nxt, disp=18,
                           op=OP.BAND)
    win.Fence()
    res["get"] = zeros(6)
    win.Get(res["get"], nxt, disp=2)
    res["gets"] = zeros(4)
    win.Get_strided(res["gets"], prv, disp=1, stride=7)
    win.Fence()
    # PSCW: expose the window to the previous rank, access the next
    win.Post([prv])
    win.Start([nxt])
    win.Put(dev(payload(dtype, rng, 3)), nxt, disp=14)
    res["pscw_get"] = zeros(3)
    win.Get(res["pscw_get"], nxt, disp=26)
    win.Complete()
    win.Wait()
    # passive target: an exclusive lock on the next rank
    win.Lock(nxt, LOCK_EXCLUSIVE)
    win.Put_strided(dev(payload(dtype, rng, 2)), nxt, disp=17, stride=3)
    res["ga"] = zeros(2)
    win.Get_accumulate(dev(payload(dtype, rng, 2)), res["ga"], nxt, disp=8,
                       op=OP.SUM if folds else OP.REPLACE)
    res["noop"] = zeros(2)
    win.Get_accumulate(dev(payload(dtype, rng, 2)), res["noop"], nxt,
                       disp=8, op=OP.NO_OP)
    win.Unlock(nxt)
    # Lock_all: an atomic to the previous rank, a compare-and-swap on the
    # next (read first, so the first swap succeeds and the second fails)
    win.Lock_all()
    res["fo"] = zeros(1)
    win.Fetch_and_op(dev(payload(dtype, rng, 1)), res["fo"], prv, disp=30,
                     op=OP.SUM if folds else OP.REPLACE)
    res["cur"] = zeros(1)
    win.Get(res["cur"], nxt, disp=31)
    win.Flush(nxt)
    new = payload(dtype, rng, 1)
    res["cas_hit"] = zeros(1)
    win.Compare_and_swap(dev(new), dev(to_np(res["cur"])), res["cas_hit"],
                         nxt, disp=31)
    res["cas_miss"] = zeros(1)
    win.Compare_and_swap(dev(payload(dtype, rng, 1)),
                         dev(to_np(res["cur"])), res["cas_miss"], nxt,
                         disp=31)
    win.Flush_all()
    win.Unlock_all()
    # request-based RMA under a shared lock
    win.Lock(prv, LOCK_SHARED)
    win.Rput(dev(payload(dtype, rng, 2)), prv, disp=10).wait()
    res["rget"] = zeros(2)
    win.Rget(res["rget"], prv, disp=10).wait()
    win.Unlock(prv)
    win.Fence()
    return res

def case_fence_put_get():
    buf = np.full(8, rank, dtype=np.int32)
    win = osc.win_create(comm, buf, disp_unit=4)
    win.Fence()
    nxt = (rank + 1) % size
    win.Put(np.array([100 + rank], dtype=np.int32), nxt, disp=0)
    win.Fence()
    got = np.zeros(1, dtype=np.int32)
    win.Get(got, nxt, disp=1)
    win.Fence()
    win.Free()
    return {"buf": buf, "got": got}

def case_lock_counter():
    buf = np.zeros(1, dtype=np.int64)
    win = osc.win_create(comm, buf, disp_unit=8)
    win.Lock(0, LOCK_EXCLUSIVE)
    win.Accumulate(np.array([1], dtype=np.int64), 0, op=OP.SUM)
    win.Unlock(0)
    win.Fence()
    win.Free()
    return {"buf": buf}

def case_rput_after_get():
    buf = np.zeros(4, dtype=np.int32)
    win = osc.win_create(comm, buf, disp_unit=4)
    win.Fence()
    nxt = (rank + 1) % size
    got = np.zeros(1, dtype=np.int32)
    win.Get(got, nxt, disp=0)          # completes via get_reply
    win.Rput(np.array([7 + rank], dtype=np.int32), nxt, disp=2).wait()
    val = np.zeros(1, dtype=np.int32)
    win.Get(val, nxt, disp=2)
    win.Fence()
    win.Free()
    return {"got": got, "val": val, "buf": buf}

def case_rget_and_flush():
    buf = np.arange(4, dtype=np.float64) + 10 * rank
    win = osc.win_create(comm, buf, disp_unit=8)
    win.Fence()
    out = np.zeros(4, dtype=np.float64)
    win.Rget(out, (rank + 1) % size).wait()
    win.Fence()
    win.Free()
    return {"out": out}

def case_fetch_and_op_cas():
    buf = np.zeros(2, dtype=np.int64)
    win = osc.win_create(comm, buf, disp_unit=8)
    win.Fence()
    old = np.zeros(1, dtype=np.int64)
    win.Fetch_and_op(np.array([1], dtype=np.int64), old, 0, disp=0)
    win.Fence()
    res = np.zeros(1, dtype=np.int64)
    win.Compare_and_swap(np.array([rank + 1], dtype=np.int64),
                         np.array([0], dtype=np.int64), res, 0, disp=1)
    win.Fence()
    olds = comm.allgather(int(old[0]))
    wins = comm.allgather(int(res[0]) == 0)
    slot = comm.bcast(int(buf[1]), 0)
    win.Free()
    # the fetched values are a permutation, one CAS wins, and it is the
    # winner's value that rank 0 holds
    return {"counter": buf[:1], "olds": np.sort(olds),
            "cas": np.array([sum(wins), slot == wins.index(True) + 1])}

def case_pscw():
    buf = np.zeros(size, dtype=np.int32)
    win = osc.win_create(comm, buf, disp_unit=4)
    if rank == 0:
        win.Post(list(range(1, size)))
        win.Wait()
    else:
        win.Start([0])
        win.Put(np.array([11 * rank], dtype=np.int32), 0, disp=rank - 1)
        win.Complete()
    win.Free()
    return {"buf": buf}

def case_allocate_lock_all():
    win = osc.win_allocate(comm, (4,), np.int32)
    win.Fence()
    win.Lock_all()
    win.Put(np.array([rank], dtype=np.int32), (rank + 1) % size, disp=0)
    win.Flush((rank + 1) % size)
    win.Unlock_all()
    win.Fence()
    out = win.base.copy()
    win.Free()
    return {"base": out}

def case_device_buffer():
    base = dev(np.zeros(8, np.float32) + 100 * rank)
    win = osc.win_create(comm, base, disp_unit=4)
    win.Fence()
    if rank != 0:  # device-origin Put: rank r writes r into slot r of 0
        win.Put(dev(np.full(1, float(rank), np.float32)), target=0,
                disp=rank)
    win.Fence()
    d0 = win.device_array()
    assert win.device_array() is d0  # no traffic: the cached array
    got = win.Get(dev(np.zeros(8, np.float32)), target=1)
    win.Fence()
    win.Fence()
    win.Accumulate(dev(np.ones(8, np.float32)), target=rank)
    win.Fence()
    mine = to_np(win.device_array())
    win.Free()
    return {"d0": to_np(d0), "got": to_np(got), "mine": mine,
            "base": to_np(base)}

def case_device_array_error():
    win = osc.win_create(comm, np.zeros(4), disp_unit=8)
    try:
        win.device_array()
        cls = -1
    except Exception as e:
        cls = e.error_class
        assert "host window" in str(e)
    win.Free()
    return {"cls": np.array([cls])}

def case_allocate_shared():
    win = osc.win_allocate_shared(comm, nbytes=64, disp_unit=1)
    mine, du = win.Shared_query(comm.rank)
    assert du == 1 and mine.size == 64
    mine[:] = comm.rank
    win.Fence()
    peer = (comm.rank + 1) % comm.size
    view, _ = win.Shared_query(peer)
    first = view[:8].copy()
    view[8] = 200 + comm.rank  # a direct store into the peer's region
    win.Fence()
    win.Put(np.full(4, 99, np.uint8), target=peer, disp=16)
    win.Fence()
    out = mine.copy()
    win.Free()
    return {"first": first, "mine": out}

def case_dynamic():
    win = osc.win_create_dynamic(comm)
    a = np.zeros(8, np.float64)
    b = np.zeros(4, np.int32)
    da = win.Attach(a)
    db = win.Attach(b)
    addrs = comm.allgather((da, db))  # targets ship their addresses
    win.Fence()
    peer = (comm.rank + 1) % comm.size
    pa, pb = addrs[peer]
    win.Put(np.full(8, float(comm.rank), np.float64), target=peer, disp=pa)
    win.Put(np.full(4, comm.rank + 10, np.int32), target=peer, disp=pb)
    win.Fence()
    got = np.zeros(8, np.float64)
    win.Get(got, target=peer, disp=pa)
    win.Fence()
    win.Detach(b)
    win.Fence()
    win.Free()
    return {"a": a, "b": b, "got": got, "addrs": np.array([da, db])}

def case_group_sync():
    win = osc.win_create(comm, np.zeros(4))
    n = win.Get_group().size
    win.Fence()
    win.Sync()
    win.Fence()
    win.Free()
    return {"group": np.array([n])}

def case_attrs():
    buf = np.arange(8, dtype=np.float64)
    win = osc.win_create(comm, buf, disp_unit=8)
    got = [win.Get_attr(mpi.WIN_SIZE), win.Get_attr(mpi.WIN_DISP_UNIT),
           int(win.Get_attr(mpi.WIN_BASE) is win.base)]
    model = win.Get_attr(mpi.WIN_MODEL)
    log = []
    kv = mpi.Win_create_keyval(delete_fn=lambda o, k, v, e: log.append(v))
    win.Set_attr(kv, "cached")
    assert win.Get_attr(kv) == "cached"
    win.Free()  # delete callbacks fire here
    assert log == ["cached"], log
    return {"attrs": np.array(got), "model": np.array([model]),
            "log": np.array(log)}
"""

_RUN = """
def save(name, a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    np.save(f"{out_dir}/{pkg}_{name}_r{rank}.npy", a)

for case in CASES:
    for k, v in globals()["case_" + case]().items():
        save(f"{case}_{k}", v)
for mode in MODES:
    for dtype in DTYPES:
        folds = dtype != "bfloat16"  # bits only, in both packages
        base = payload(dtype, np.random.default_rng(300 + rank), N)
        if mode == "numpy":
            win = osc.win_create(comm, bits16(base).copy(),
                                 disp_unit=base.dtype.itemsize)
            res = dtype_schedule(win, bits16,
                                 lambda m: bits16(np_zeros(m, dtype)),
                                 dtype, folds)
            final = win.base
        else:
            win = osc.win_create(comm, dev(base),
                                 disp_unit=base.dtype.itemsize)
            refusal_check(win, dtype)
            res = dtype_schedule(win, dev, lambda m: dev_zeros(m, dtype),
                                 dtype, folds)
            final = to_np(win.device_array())
        save(f"{mode}_{dtype}_win", final)
        for k, v in res.items():
            save(f"{mode}_{dtype}_{k}", to_np(v))
        win.Free()
"""

_REF_BODY = """
import jax.numpy as jnp
from ompi_tpu import op as OP, osc
from ompi_tpu.osc import LOCK_EXCLUSIVE, LOCK_SHARED
pkg = "ref"
{shared}

def dev(a):
    return jnp.asarray(bits16(a))

def to_np(x):
    return np.asarray(x)

def dev_zeros(m, dtype):
    return bits16(np_zeros(m, dtype))  # result buffers stay numpy here

def refusal_check(win, dtype):
    pass
{run}
"""

_PORT_PROG = """
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi, op as OP, osc
from ompi_tpu_torch.osc import LOCK_EXCLUSIVE, LOCK_SHARED
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
CASES, DTYPES, MODES = {cases!r}, {dtypes!r}, {modes!r}
pkg = "port"
{shared}

def dev(a):
    return compat.tensor_from_numpy(np.asarray(a))

def to_np(x):
    if isinstance(x, torch.Tensor):
        a = compat.tensor_to_numpy(x)
        return a.view(ml_dtypes.bfloat16) if x.dtype == torch.bfloat16 else a
    return np.asarray(x)

def dev_zeros(m, dtype):
    return dev(np_zeros(m, dtype))  # a tensor template, filled in place

def refusal_check(win, dtype):
    # a bfloat16 tensor moves as its bits: its folds are refused at the
    # call, before anything is sent
    if dtype != "bfloat16":
        return
    win.Fence()
    one = dev(np_zeros(1, dtype))
    for call in (lambda: win.Accumulate(one, 0, op=OP.SUM),
                 lambda: win.Get_accumulate(one, one.clone(), 0, op=OP.MAX),
                 lambda: win.Fetch_and_op(one, one.clone(), 0, op=OP.PROD)):
        try:
            call()
        except errors.MPIError as e:
            assert e.error_class == errors.ERR_NOT_SUPPORTED, e
        else:
            raise AssertionError("a bfloat16 fold was not refused")
    # what waits for a later item: Set_errhandler / Set_info (4f)
    for call, item in ((lambda: win.Set_errhandler(None), "item 4f"),
                       (lambda: win.Set_info({{}}), "item 4f")):
        try:
            call()
        except errors.MPIError as e:
            assert e.error_class == errors.ERR_NOT_SUPPORTED
            assert item in str(e), e
        else:
            raise AssertionError(f"not refused: {{item}}")
    # the compiled device-epoch window is ported: its creation runs (a
    # collective over a dup of the comm) and, this job having no device
    # plane, refuses the tensor with ERR_ARG on every rank
    # (tests/test_torch_osc_device_epoch.py creates working ones)
    try:
        osc.win_create_device(comm, dev(np_zeros(4, dtype)))
    except errors.MPIError as e:
        assert e.error_class == errors.ERR_ARG, e
        assert "device-plane device" in str(e), e
    else:
        raise AssertionError("win_create_device without a device plane")
{run}
mpi.Finalize()
"""


def _port_job(src: str, n: int) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n, timeout=180)
    finally:
        os.unlink(path)


_jobs = {}


@pytest.fixture(params=[3, 4], scope="module")
def results(request, tmp_path_factory):
    """Run both packages' jobs once per n; returns (n, out_dir)."""
    n = request.param
    if n not in _jobs:
        out = tmp_path_factory.mktemp(f"osc_am_n{n}")
        run = _RUN
        run_ranks(f"out_dir = {str(out)!r}\n"
                  f"CASES, DTYPES, MODES = {CASES!r}, {DTYPES!r}, "
                  f"{MODES!r}\n"
                  + _REF_BODY.format(shared=_SHARED, run=run), n,
                  timeout=300, isolate=True)
        rc = _port_job(_PORT_PROG.format(
            shared=_SHARED, run=run, out_dir=str(out), cases=CASES,
            dtypes=DTYPES, modes=MODES), n)
        assert rc == 0, f"port job exited {rc}"
        _jobs[n] = out
    return n, _jobs[n]


def _compare(out, prefix: str, n: int) -> int:
    """Every result the reference saved under ``prefix`` equal, bitwise,
    to the port's; returns how many were compared."""
    names = sorted(p.name[len("ref_"):] for p in out.glob(f"ref_{prefix}_*"))
    assert names, prefix
    for name in names:
        ref = np.load(out / f"ref_{name}")
        got = np.load(out / f"port_{name}")
        if ref.dtype.kind == "U":
            assert ref.tolist() == got.tolist(), name
            continue
        assert ref.shape == got.shape, (name, ref.shape, got.shape)
        assert_bits_equal(ref, got, name)
    assert len(names) % n == 0, names
    return len(names)


@pytest.mark.parametrize("case", CASES)
def test_osc_case_equal_to_reference(results, case):
    """Each case of tests/test_osc.py (and test_attr.py's window case):
    every rank's saved windows and results equal the reference's."""
    n, out = results
    _compare(out, case, n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_epoch_bitwise_equal_to_reference(results, dtype, mode):
    """The dtype schedule through fence, PSCW, an exclusive lock,
    Lock_all and a shared lock: the final windows and every Get,
    Get_strided, Get_accumulate (NO_OP too), Fetch_and_op,
    Compare_and_swap (a hit and a miss) and Rget result bitwise equal to
    the reference's, over numpy windows and staged tensor windows."""
    n, out = results
    assert _compare(out, f"{mode}_{dtype}", n) == n * 11
