"""The port's fence-epoch one-sided windows (ompi_tpu_torch.osc) against
the JAX package's.

One job per package and comm size n in {3, 4}: the reference runs through
``tests.harness.run_ranks`` with ``device_plane on`` and ``osc_pallas on``
(a ``PallasWindow``, its kernels in interpret mode); the port through
``ompi_tpu_torch.runtime.launcher`` with the same settings mapped by
``compat.mca_from_reference`` plus ``device_plane_platform cpu`` (a
``CudaWindow`` whose kernels take their plain versions on CPU tensors,
over shared-memory arenas and the same round handshake as the card). Both
run the same numpy-seeded schedules for float32, bfloat16 and int32:
rotating-target Puts; Accumulates of every elementwise kind plus a
same-origin ordered pair onto one location; starts past the end and below
zero; contiguous and strided Get_epoch (clamp and fill edges); SUM
accumulates that overlap across origins and repeat from one origin, then
a fence that mixes puts and gets (in the port once with one exchange per
fence phase and once with one exchange per round). The results are
compared bitwise (NaN payloads aside), and the
``osc_cuda_{put,acc,get,rounds,bytes}`` counts must equal the reference's
``osc_pallas_*``.

The strided halo (``Put_strided``) is held against the reference's host
``Window`` (ROADMAP queue 3: the reference's device-window halo test is
flaky on 3 ranks), and K8 itself against the Pallas kernel in
``test_torch_osc_kernels.py``. Both port examples run at ``--tiny`` inside
the port job: the halo example against a host-window replay of the
reference example's schedule, the embedding example against the
reference example itself. The erroneous-call matrix of
``tests/test_osc_pallas.py`` is checked in the port job unchanged, and
then the verbs that ride the active-message plane are served on the same
window, their results asserted (their parity with the reference is
``tests/test_torch_osc_passive.py``'s).
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
PVARS = ("put", "acc", "get", "rounds", "bytes")
NGETS = 4

#: shared verbatim by both rank programs: numpy data and the schedules
_SHARED = """
import ml_dtypes
DTYPES = {dtypes!r}
PVARS = {pvars!r}
N = 48

def cast(a, dtype):
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)

def payload(dtype, rng, m):
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, m,
                            dtype=np.int64).astype(np.int32)
    a = (rng.standard_normal(m) * 4).astype(np.float32)
    a[m // 2] = -0.0
    return cast(a, dtype)

def base_for(dtype, rank):
    a = payload(dtype, np.random.default_rng(40 + rank), N)
    if dtype != "int32":
        a[[5, 21]] = np.nan
        a[[2, 9]] = 0.0
        a[[3, 10]] = -0.0
    return a

def schedule(win, dev, dtype, rank, size, ops):
    # ops: SUM, MIN, MAX, PROD, REPLACE of the package under test
    rng = np.random.default_rng(70 + rank)
    nxt, nx2 = (rank + 1) % size, (rank + 2) % size
    win.Fence()
    for k in range(3):  # rotating-target puts
        win.Put(dev(payload(dtype, rng, 4)), (rank + 1 + k) % size,
                disp=5 * k)
    win.Fence()
    for k, o in enumerate(ops):  # every elementwise kind
        win.Accumulate(dev(payload(dtype, rng, 3)), nxt, disp=4 * k, op=o)
    # the same-origin ordered pair onto one location
    win.Accumulate(dev(payload(dtype, rng, 3)), nxt, disp=30, op=ops[0])
    win.Accumulate(dev(payload(dtype, rng, 3)), nxt, disp=30, op=ops[3])
    # a start past the end and one below zero: both land at N - 4
    win.Put(dev(payload(dtype, rng, 4)), nx2, disp=N - 2)
    win.Accumulate(dev(payload(dtype, rng, 4)), nx2, disp=-3, op=ops[0])
    win.Fence()
    hs = [win.Get_epoch(6, nxt, disp=3),
          win.Get_epoch(3, nxt, disp=1, stride=9),
          win.Get_epoch(4, nx2, disp=-3),
          win.Get_epoch(4, nx2, disp=N - 4, stride=2)]  # two past the end
    win.Fence()
    return hs

def overlap(win, dev, dtype, rank, size, ops):
    # SUM accumulates onto the same elements from every origin, repeated
    # from each, in two size groups; then one fence mixing puts and gets
    rng = np.random.default_rng(110 + rank)
    win.Fence()
    for k in range(3):
        win.Accumulate(dev(payload(dtype, rng, 6)), 0, disp=4, op=ops[0])
    win.Accumulate(dev(payload(dtype, rng, 6)), (rank + 1) % size, disp=6,
                   op=ops[0])
    win.Accumulate(dev(payload(dtype, rng, 3)), 0, disp=5, op=ops[0])
    win.Fence()
    win.Put(dev(payload(dtype, rng, 4)), (rank + 1) % size, disp=20)
    win.Accumulate(dev(payload(dtype, rng, 4)), (rank + 2) % size, disp=21,
                   op=ops[0])
    hs = [win.Get_epoch(8, (rank + 1) % size, disp=18),
          win.Get_epoch(4, (rank + 2) % size, disp=19, stride=2),
          win.Get_epoch(6, 0, disp=4)]
    win.Fence()
    return hs

def halo(win, dev, dtype, rank, size):
    # a 4 x 12 grid: one Put_strided halo column each way
    rng = np.random.default_rng(90 + rank)
    win.Fence()
    win.Put_strided(dev(payload(dtype, rng, 4)), (rank + 1) % size,
                    disp=0, stride=12)
    win.Put_strided(dev(payload(dtype, rng, 4)), (rank - 1) % size,
                    disp=11, stride=12)
    win.Fence()
"""

_REF_BODY = """
import runpy
import jax.numpy as jnp
import ompi_tpu.mpi as M
from ompi_tpu import op as op_mod, osc
from ompi_tpu.core import pvar
{shared}
OPS = [op_mod.SUM, op_mod.MIN, op_mod.MAX, op_mod.PROD, op_mod.REPLACE]

def save(name, a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    np.save(f"{{out_dir}}/ref_{{name}}_r{{rank}}.npy", a)

for dtype in DTYPES:
    s = pvar.session()
    base = base_for(dtype, rank)
    win = osc.win_create(comm, jnp.asarray(base),
                         disp_unit=base.dtype.itemsize)
    assert type(win).__name__ == "PallasWindow", type(win)
    hs = schedule(win, jnp.asarray, dtype, rank, size, OPS)
    save(f"{{dtype}}_win", win.array)
    for i, h in enumerate(hs):
        save(f"{{dtype}}_get{{i}}", h.array)
    save(f"{{dtype}}_pvars", np.array([s.read(f"osc_pallas_{{k}}")
                                      for k in PVARS]))
    win.Free()
for dtype in DTYPES:  # overlapping accumulates, a mixed fence
    s = pvar.session()
    base = base_for(dtype, rank)
    win = osc.win_create(comm, jnp.asarray(base),
                         disp_unit=base.dtype.itemsize)
    hs = overlap(win, jnp.asarray, dtype, rank, size, OPS)
    save(f"{{dtype}}_ovl_win", win.array)
    for i, h in enumerate(hs):
        save(f"{{dtype}}_ovl_get{{i}}", h.array)
    save(f"{{dtype}}_ovl_rounds", np.array([s.read("osc_pallas_rounds")]))
    win.Free()
for dtype in ("float32", "int32"):  # the halo, on the host window
    base = base_for(dtype, rank)
    wh = osc.Window(comm, base.copy(), disp_unit=base.dtype.itemsize)
    halo(wh, lambda a: a, dtype, rank, size)
    save(f"{{dtype}}_halo", wh.base)
    wh.Free()

# a strided put that lands in part on the next rank's 4-element window
win = osc.win_create(comm, jnp.zeros(4, jnp.float32), disp_unit=4)
win.Fence()
win.Put_strided(jnp.full((5,), 2.0, jnp.float32), (rank + 1) % size, disp=1,
                stride=2)
win.Fence()
save("fits", win.array)
win.Free()

# examples/halo_exchange.py's schedule, replayed on the host window
H, W = 6, 8
tile = np.random.default_rng(11 + rank).standard_normal((H, W)).astype(
    np.float32)
shadow = osc.Window(comm, tile.copy(), disp_unit=4)
grid = tile.copy()
for _ in range(3):
    shadow.Fence()
    shadow.Put_strided(np.ascontiguousarray(grid[:, W - 2]),
                       (rank + 1) % size, disp=0, stride=W)
    shadow.Put_strided(np.ascontiguousarray(grid[:, 1]), (rank - 1) % size,
                       disp=W - 1, stride=W)
    shadow.Fence()
    g = shadow.base.reshape(H, W)
    grid = g.copy()
    grid[:, 1:W - 1] = (g[:, :W - 2] + g[:, 1:W - 1] + g[:, 2:]) / np.float32(
        3.0)
    shadow.Fence()
    shadow.Put(grid.reshape(-1), rank, disp=0)
    shadow.Fence()
save("halo_example", shadow.base)
shadow.Free()

# examples/embedding_table.py itself (it checks itself against its host
# shadow window); its Finalize is the pool's, so it is held off
fin = M.Finalize
M.Finalize = lambda: None
try:
    g = runpy.run_path({emb!r})
finally:
    M.Finalize = fin
save("emb_rows", g["dev_rows"])
save("emb_window", g["got"])
save("emb_pvars", np.array([g["summary"]["osc_pallas_" + k]
                            for k in ("get", "acc", "rounds", "bytes")]))
"""

_PORT_PROG = """
import numpy as np
import torch
import ompi_tpu_torch.mpi as M
from ompi_tpu_torch import compat, errors, mpi, op as op_mod, osc
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.examples import embedding_table, halo_exchange
from ompi_tpu_torch.osc import cuda as osc_cuda
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
{shared}
OPS = [op_mod.SUM, op_mod.MIN, op_mod.MAX, op_mod.PROD, op_mod.REPLACE]

def save(name, t):
    a = compat.tensor_to_numpy(t) if isinstance(t, torch.Tensor) else t
    np.save(f"{{out_dir}}/port_{{name}}_r{{rank}}.npy", np.asarray(a))

def expect(cls, fn):
    try:
        fn()
    except errors.MPIError as e:
        assert e.error_class == cls, (cls, e.error_class, str(e))
        return str(e)
    raise AssertionError(f"no MPIError {{cls}} raised")

for dtype in DTYPES:
    s = pvar.session()
    base = base_for(dtype, rank)
    win = osc.win_create(comm, compat.tensor_from_numpy(base),
                         disp_unit=base.dtype.itemsize)
    assert type(win).__name__ == "CudaWindow", type(win)
    hs = schedule(win, compat.tensor_from_numpy, dtype, rank, size, OPS)
    save(f"{{dtype}}_win", win.array)
    for i, h in enumerate(hs):
        save(f"{{dtype}}_get{{i}}", h.array)
    save(f"{{dtype}}_pvars", np.array([s.read(f"osc_cuda_{{k}}")
                                      for k in PVARS]))
    assert s.read("osc_cuda_fallthrough") == 0
    assert torch.equal(compat.tensor_from_numpy(base).view(torch.uint8),
                       compat.tensor_from_numpy(base_for(dtype, rank)).view(
                           torch.uint8))
    win.Free()
# the overlap schedule with one exchange per fence phase, then with a
# budget that gives every round its own exchange (regions reused)
exchange_bytes = osc_cuda.EXCHANGE_BYTES
for dtype in DTYPES:
    for tag, budget in (("ovl", exchange_bytes), ("ovl1", 1)):
        osc_cuda.EXCHANGE_BYTES = budget
        s = pvar.session()
        base = base_for(dtype, rank)
        win = osc.win_create(comm, compat.tensor_from_numpy(base),
                             disp_unit=base.dtype.itemsize)
        hs = overlap(win, compat.tensor_from_numpy, dtype, rank, size, OPS)
        save(f"{{dtype}}_{{tag}}_win", win.array)
        for i, h in enumerate(hs):
            save(f"{{dtype}}_{{tag}}_get{{i}}", h.array)
        save(f"{{dtype}}_{{tag}}_counts", np.array(
            [s.read("osc_cuda_rounds"), s.read("osc_cuda_exchanges")]))
        win.Free()
osc_cuda.EXCHANGE_BYTES = exchange_bytes
for dtype in ("float32", "int32"):
    base = base_for(dtype, rank)
    win = osc.win_create(comm, compat.tensor_from_numpy(base),
                         disp_unit=base.dtype.itemsize)
    halo(win, compat.tensor_from_numpy, dtype, rank, size)
    save(f"{{dtype}}_halo", win.array)
    win.Free()

# both examples at --tiny, in this job (their Finalize is this job's)
fin = M.Finalize
M.Finalize = lambda: None
try:
    halo_exchange.main(["--tiny", "--out", f"{{out_dir}}/port_halo"])
    embedding_table.main(["--tiny", "--out", f"{{out_dir}}/port_emb"])
finally:
    M.Finalize = fin

# the reference's erroneous-call matrix (tests/test_osc_pallas.py)
win = osc.win_create(comm, torch.zeros(4), disp_unit=4)
for attempt in range(2):  # uncached: raises every call
    expect(errors.ERR_RMA_SYNC, lambda: win.Put(torch.ones(1), 0))
    expect(errors.ERR_RMA_SYNC, lambda: win.Unlock((rank + 1) % size))
    expect(errors.ERR_RMA_SYNC, win.Complete)
expect(errors.ERR_RMA_SYNC, lambda: win.Get_epoch(1, 0))
win.Fence()
for attempt in range(2):
    expect(errors.ERR_ARG,
           lambda: win.Accumulate(np.ones(2, np.float64), 0, disp=0))
for meth, args in (("Rput", (torch.ones(1), 0)),
                   ("Rget", (np.ones(1, np.float32), 0))):
    expect(errors.ERR_RMA_SYNC, lambda: getattr(win, meth)(*args))
expect(errors.ERR_RANK, lambda: win.Put(torch.ones(1), size))
# a contiguous RMA larger than the target's 4-element window raises ERR_ARG
# at the origin and queues nothing; a strided put still drops what falls
# outside, and the fence that closes the epoch completes
nxt = (rank + 1) % size
for attempt in range(2):
    expect(errors.ERR_ARG, lambda: win.Put(torch.ones(5), nxt))
    expect(errors.ERR_ARG,
           lambda: win.Put_strided(torch.ones(5), nxt, disp=0, stride=1))
    expect(errors.ERR_ARG, lambda: win.Accumulate(torch.ones(5), nxt))
    expect(errors.ERR_ARG, lambda: win.Get_epoch(5, nxt))
win.Put_strided(torch.full((5,), 2.0), nxt, disp=1, stride=2)
win.Fence()
save("fits", win.array)
# what rides the host window's AM service: served on this window, each
# result asserted (the window holds 0, 2, 0, 2 after the strided put). A
# passive-target op lands whenever its target makes progress, a peer's
# fence barrier included: barriers keep each check before the next
# epoch's ops
comm.Barrier()
s = pvar.session()
prv = (rank - 1) % size
one = np.ones(1, np.float32)
got = np.zeros(1, np.float32)
win.Lock(nxt)
win.Put(torch.full((1,), 10.0 + rank), nxt, disp=2)
win.Flush(nxt)
win.Get(got, nxt, disp=2)
assert got[0] == 10.0 + rank, got
win.Unlock(nxt)
win.Fence()
assert win.array.tolist() == [0.0, 2.0, 10.0 + prv, 2.0], win.array
comm.Barrier()
win.Lock_all()
old = np.zeros(1, np.float32)
win.Fetch_and_op(one, old, 0, disp=0)  # every rank adds 1 to rank 0's [0]
strided = torch.zeros(2)
win.Get_strided(strided, nxt, disp=1, stride=2)
assert strided.tolist() == [2.0, 2.0], strided
win.Flush_all()
win.Unlock_all()
win.Fence()
if rank == 0:
    assert win.array[0].item() == size, win.array
ga = np.zeros(1, np.float32)
res = np.zeros(1, np.float32)
win.Post([prv])
win.Start([nxt])
win.Get_accumulate(np.full(1, 5.0, np.float32), ga, nxt, disp=1)
assert ga[0] == 2.0, ga
win.Compare_and_swap(np.full(1, 7.0, np.float32), np.full(1, 7.0, np.float32),
                     res, nxt, disp=1)
assert res[0] == 7.0, res  # 2 + 5: equal, so 7 is swapped in (no change)
win.Complete()
win.Wait()
assert win.array[1].item() == 7.0, win.array
assert s.read("osc_cuda_fallthrough") == 0
assert s.read("osc_cuda_am_ops") == 6, s.read("osc_cuda_am_ops")
win.Put(torch.ones(1), (rank + 1) % size)
expect(errors.ERR_RMA_SYNC, win.Free)  # a descriptor is still queued
win.Fence()
win.Free()
# a non-elementwise op is host-assisted (counted), every other window
# the kernels do not take falls to the host window (counted)
base = np.arange(4, dtype=np.int32) + 10 * rank
wi = osc.win_create(comm, torch.from_numpy(base.copy()), disp_unit=4)
wi.Fence()
wi.Accumulate(torch.full((2,), 6, dtype=torch.int32), nxt, disp=1,
              op=op_mod.BAND)
wi.Fence()
want = base.copy()
want[1:3] &= 6
assert wi.array.tolist() == want.tolist(), (wi.array, want)
wi.Free()
w16 = osc.win_create(comm, torch.zeros(8, dtype=torch.int16), disp_unit=2)
assert type(w16).__name__ == "Window", type(w16)
w16.Free()
wn = osc.win_create(comm, np.zeros(8, np.float32), disp_unit=4)
assert type(wn).__name__ == "Window", type(wn)
wn.Free()
assert s.read("osc_cuda_fallthrough") == 3
cvar.set("osc_cuda", "off")
wt = osc.win_create(comm, torch.zeros(4), disp_unit=4)
assert type(wt).__name__ == "Window" and s.read("osc_cuda_fallthrough") == 3
wt.Fence()
wt.Put(torch.full((2,), 3.0), nxt, disp=1)
wt.Fence()
assert wt.device_array().tolist() == [0.0, 3.0, 3.0, 0.0], wt.device_array()
wt.Free()
cvar.set("osc_cuda", "on")
open(f"{{out_dir}}/port_errors_r{{rank}}.ok", "w").close()
mpi.Finalize()
"""


def _port_job(src: str, n: int, mca) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n, mca=mca,
                                    timeout=180)
    finally:
        os.unlink(path)


_jobs = {}


@pytest.fixture(params=[3, 4], scope="module")
def results(request, tmp_path_factory):
    """Run both packages' jobs once per n; returns (n, out_dir)."""
    n = request.param
    if n not in _jobs:
        out = tmp_path_factory.mktemp(f"osc_n{n}")
        shared = _SHARED.format(dtypes=DTYPES, pvars=PVARS)
        emb = os.path.join(ROOT, "examples", "embedding_table.py")
        run_ranks(f"out_dir = {str(out)!r}\n"
                  + _REF_BODY.format(shared=shared, emb=emb), n,
                  mca=REF_MCA, timeout=300)
        rc = _port_job(_PORT_PROG.format(shared=shared, out_dir=str(out)),
                       n, PORT_MCA)
        assert rc == 0, f"port job exited {rc}"
        _jobs[n] = out
    return n, _jobs[n]


def _pair(out, name, r):
    return (np.load(out / f"ref_{name}_r{r}.npy"),
            np.load(out / f"port_{name}_r{r}.npy"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fence_windows_bitwise_equal_to_reference(results, dtype):
    """Puts, every accumulate kind, the ordered pair and the clamped
    starts leave every rank's window bitwise equal to PallasWindow's."""
    n, out = results
    for r in range(n):
        ref, got = _pair(out, f"{dtype}_win", r)
        assert_bits_equal(ref, got, f"{dtype} window rank {r}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_get_epoch_handles_bitwise_equal_to_reference(results, dtype):
    """Contiguous, strided, wrapped-and-clamped and filled gets."""
    n, out = results
    for r in range(n):
        for i in range(NGETS):
            ref, got = _pair(out, f"{dtype}_get{i}", r)
            assert ref.shape == got.shape
            assert_bits_equal(ref, got, f"{dtype} get {i} rank {r}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_counts_equal_reference(results, dtype):
    """osc_cuda_{put,acc,get,rounds,bytes} == osc_pallas_* (the same
    descriptors, grouped and coloured into the same rounds)."""
    n, out = results
    for r in range(n):
        ref, got = _pair(out, f"{dtype}_pvars", r)
        assert got.tolist() == ref.tolist(), dict(zip(PVARS, zip(ref, got)))


@pytest.mark.parametrize("tag", ["ovl", "ovl1"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_overlapping_accumulates_bitwise_equal_to_reference(results, dtype,
                                                            tag):
    """SUM accumulates onto one location from every origin and repeated
    from each (bfloat16 rounds after every add, so only the reference's
    round order gives its bits), then a fence mixing puts and gets: the
    windows and handles bitwise equal to PallasWindow's, with one exchange
    per fence phase ("ovl") and with one per round ("ovl1")."""
    n, out = results
    for r in range(n):
        ref = np.load(out / f"ref_{dtype}_ovl_win_r{r}.npy")
        got = np.load(out / f"port_{dtype}_{tag}_win_r{r}.npy")
        assert_bits_equal(ref, got, f"{dtype} {tag} window rank {r}")
        for i in range(3):
            ref = np.load(out / f"ref_{dtype}_ovl_get{i}_r{r}.npy")
            got = np.load(out / f"port_{dtype}_{tag}_get{i}_r{r}.npy")
            assert ref.shape == got.shape
            assert_bits_equal(ref, got, f"{dtype} {tag} get {i} rank {r}")
        rounds = int(np.load(out / f"ref_{dtype}_ovl_rounds_r{r}.npy")[0])
        got_rounds, exchanges = np.load(
            out / f"port_{dtype}_{tag}_counts_r{r}.npy").tolist()
        assert got_rounds == rounds
        # three fence phases: the accumulates, the puts, the gets
        assert exchanges == (3 if tag == "ovl" else rounds)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_strided_halo_equal_to_host_window(results, dtype):
    n, out = results
    for r in range(n):
        ref, got = _pair(out, f"{dtype}_halo", r)
        assert_bits_equal(ref, got, f"{dtype} halo rank {r}")


def test_halo_example_equal_to_host_window_replay(results):
    """examples' halo_exchange at --tiny (3 steps of halo columns and a
    whole-tile self Put) == the JAX package's example schedule on its
    host window, and its counts are the reference example's."""
    n, out = results
    for r in range(n):
        ref = np.load(out / f"ref_halo_example_r{r}.npy")
        got = np.load(out / "port_halo" / f"rank{r}_window.npy")
        assert_bits_equal(ref, got.reshape(-1), f"halo example rank {r}")
        doc = json.loads((out / "port_halo" / f"rank{r}.json").read_text())
        assert all(c["ok"] for c in doc["cases"]), doc["cases"]
        # the reference example prints 9 puts in 9 rounds, 720 bytes
        assert doc["pvars"] == {"osc_cuda_put": 9, "osc_cuda_fence": 12,
                                "osc_cuda_rounds": 9, "osc_cuda_bytes": 720}


def test_embedding_example_equal_to_reference(results):
    """examples' embedding_table at --tiny == the JAX package's example:
    the looked-up rows, the updated shard and the counts."""
    n, out = results
    for r in range(n):
        ref_rows = np.load(out / f"ref_emb_rows_r{r}.npy")
        got_rows = np.load(out / "port_emb" / f"rank{r}_rows.npy")
        assert_bits_equal(ref_rows, got_rows, f"lookups rank {r}")
        ref_win = np.load(out / f"ref_emb_window_r{r}.npy")
        got_win = np.load(out / "port_emb" / f"rank{r}_window.npy")
        assert_bits_equal(ref_win, got_win.reshape(-1), f"shard rank {r}")
        doc = json.loads((out / "port_emb" / f"rank{r}.json").read_text())
        assert all(c["ok"] for c in doc["cases"]), doc["cases"]
        ref = np.load(out / f"ref_emb_pvars_r{r}.npy").tolist()
        assert [doc["pvars"]["osc_cuda_" + k] for k in
                ("get", "acc", "rounds", "bytes")] == ref


def test_error_matrix(results):
    """ERR_RMA_SYNC (op outside an epoch, Get_epoch outside a fence,
    Unlock without Lock, Complete without Start, Rput/Rget outside a
    Lock, Free with queued descriptors), ERR_ARG (operand dtype), ERR_RANK
    (target); then the AM verbs served (Lock, Flush, Get, Lock_all,
    Fetch_and_op, Get_strided, Flush_all, Post / Start, Get_accumulate,
    Compare_and_swap, Complete / Wait, osc_cuda_am_ops 6), a BAND
    Accumulate host-assisted and an int16 window and a host buffer served
    by the host window, each counted in osc_cuda_fallthrough, and with
    osc_cuda off a CPU tensor staged by the host window without a count —
    asserted inside the port job, on every rank."""
    n, out = results
    for r in range(n):
        assert (out / f"port_errors_r{r}.ok").exists()


def test_oversized_rma_raises_at_origin(results):
    """A Put, Put_strided of stride 1, Accumulate or Get_epoch of more
    elements than the target's window raises ERR_ARG at the call on every
    rank (nothing reaches the target, which would fail mid-exchange), and
    the next fence completes with the strided put that fits in part: the
    window bitwise equal to PallasWindow's after that put and fence alone
    (the refusals are asserted inside the port job)."""
    n, out = results
    for r in range(n):
        ref, got = _pair(out, "fits", r)
        assert_bits_equal(ref, got, f"window after the refusals rank {r}")


def test_mca_maps_osc_pallas():
    got = compat.mca_from_reference({"osc_pallas": "on",
                                     "osc_pallas_interpret": "on"})
    assert got == {"osc_cuda": "on"}
