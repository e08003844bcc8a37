"""The port's coll/hier (two-level collectives over a comm's low and up
splits), coll/device's two-level mode (``coll_device_hier``) and coll/han
against the JAX package's coll/hier, coll/xla's ``coll_xla_hier`` and
coll/han.

One job per package and rank count: 4 ranks under ``coll_hier_split 2x2``
and 6 ranks under ``2x3`` plus a duplicate of the world made under ``3x2``
(every grid of three slices or three ICI ranks). Both packages run the same
case program (:data:`_CASES`) on the same seeded numpy inputs — values
spanning seven decades, whose float sums round differently in another
order — and write every result: 'linear' Allreduce, Reduce_scatter_block
and the fused multi form for float32, bfloat16 and int32 x SUM / PROD /
MIN / MAX, the default split-level Allreduce and Reduce_scatter_block, and
Allgather, Bcast and Alltoall. Each package also checks, in its job, every
two-level result bitwise against its own flat slot (coll/xla; the port's
coll/device), the default within 1e-5.

Across the packages: 'linear' and the data movement bitwise; the default
split-level results (psum against the port's rings) within ``RTOL`` of
the operands' magnitudes. The port's job also holds the counterparts of
``tests/test_coll_hier.py``'s pvar, fallthrough, persistent, bad-split,
switchpoint, coll/han and off-by-default tests, ``tests/test_coll_xla.py``'s
two ``coll_xla_hier`` tests against ``coll_device_hier``, the providers of
the eight slots, and a collective on a user's 2-rank split (which has no
2 x 2 grid: ERR_ARG, as in the reference, while the grid's own 2-rank
levels run). The switchpoint-table fault (``tests/test_tune.py``) runs in
this process for coll/cuda and coll/hier.
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

#: default split-level results, relative to the operands' magnitudes
RTOL = {"float32": 1e-6, "bfloat16": 3e-3}
#: rank count -> (the world's split, the duplicate's split or None)
JOBS = {4: ("2x2", None), 6: ("2x3", "3x2")}
#: (dtype, ops) of the 'linear' matrix
MATRIX = (("float32", ("SUM", "PROD", "MIN", "MAX")),
          ("bfloat16", ("SUM", "PROD", "MIN", "MAX")),
          ("int32", ("SUM", "PROD", "MIN", "MAX")))


def _mca(split):
    return {"device_plane": "on", "coll_hier": "on", "coll_hier_split": split}


#: run in both packages: ``run_grid(comm, tag)`` saves each result as
#: ``{tag}_{case}_r{rank}.npy`` and returns the in-job checks against the
#: package's flat slots (``FLAT``)
_CASES = '''
def run_grid(comm, tag, MATRIX):
    n, r = comm.size, comm.rank
    oks = {}

    def save(name, y):
        np.save(f"{out_dir}/{tag}_{name}_r{r}.npy", npy(y))

    def same(a, b):
        a, b = npy(a), npy(b)
        return a.shape == b.shape and a.dtype == b.dtype and \\
            a.tobytes() == b.tobytes()

    rng = np.random.default_rng(13)
    h = (rng.standard_normal(6 * n)
         * (10.0 ** rng.integers(-3, 4, 6 * n))).astype(np.float32)
    hi = rng.integers(-1000, 1000, 6 * n).astype(np.int32)
    hp = rng.integers(-3, 4, 6 * n).astype(np.int32)
    for dt, ops in MATRIX:
        for opname in ops:
            src = hi if dt == "int32" else h
            if dt == "int32" and opname == "PROD":
                src = hp
            x = mk(np.roll(src, r * 5).reshape(n, 6), dt)
            op = getattr(OP, opname)
            p = comm.coll.allreduce_dev(comm, x, op, deterministic="linear")
            oks[f"ar_{dt}_{opname}"] = same(
                p, FLAT.allreduce_dev(comm, x, op, deterministic="linear"))
            save(f"ar_linear_{dt}_{opname}", p)
            p = comm.coll.reduce_scatter_block_dev(comm, x, op,
                                                   deterministic="linear")
            oks[f"rsb_{dt}_{opname}"] = same(
                p, FLAT.reduce_scatter_block_dev(comm, x, op,
                                                 deterministic="linear"))
            save(f"rsb_linear_{dt}_{opname}", p)
            bufs = {"w": mk(np.roll(src, r * 3).reshape(n, 6), dt),
                    "b": mk(np.roll(src, r)[:7], dt),
                    "i": mk((np.arange(5) + r).astype(np.int32), "int32")}
            p = comm.coll.allreduce_multi_dev(comm, bufs, op,
                                              deterministic="linear")
            q = FLAT.allreduce_multi_dev(comm, bufs, op,
                                         deterministic="linear")
            oks[f"multi_{dt}_{opname}"] = all(same(p[k], q[k]) for k in bufs)
            for k in bufs:
                save(f"multi_linear_{dt}_{opname}_{k}", p[k])
    x = mk(np.roll(h, r * 5).reshape(n, 6), "float32")
    p = comm.coll.allreduce_dev(comm, x)
    oks["ar_default_close"] = bool(np.allclose(
        npy(p), npy(FLAT.allreduce_dev(comm, x)), rtol=1e-5, atol=1e-5))
    save("ar_default", p)
    p = comm.coll.reduce_scatter_block_dev(comm, x)
    oks["rsb_default_close"] = bool(np.allclose(
        npy(p), npy(FLAT.reduce_scatter_block_dev(comm, x)), rtol=1e-5,
        atol=1e-5))
    save("rsb_default", p)
    y = mk(rng.standard_normal((5, 3)).astype(np.float32) + r, "float32")
    p = comm.coll.allgather_dev(comm, y)
    oks["allgather"] = same(p, FLAT.allgather_dev(comm, y))
    save("allgather", p)
    b = mk(np.full(7, float(r), np.float32), "float32")
    p = comm.coll.bcast_dev(comm, b, 1)
    oks["bcast"] = same(p, FLAT.bcast_dev(comm, b, 1)) \
        and bool(npy(p)[0] == 1.0)
    save("bcast", p)
    z = mk(rng.standard_normal((n * 2, 3)).astype(np.float32) + r,
           "float32")
    p = comm.coll.alltoall_dev(comm, z)
    oks["alltoall"] = same(p, FLAT.alltoall_dev(comm, z))
    save("alltoall", p)
    return oks


def run_job(comm, MATRIX, second):
    oks = {"g0": run_grid(comm, "g0", MATRIX)}
    if second:
        cvar.set("coll_hier_split", second)
        try:
            c2 = comm.dup()
            oks["g1"] = run_grid(c2, "g1", MATRIX)
            c2.free()
        finally:
            cvar.set("coll_hier_split", JOB_SPLIT)
    with open(f"{out_dir}/oks_r{comm.rank}.json", "w") as fh:
        json.dump(oks, fh)
'''

_REF_PROG = '''
import json
import jax.numpy as jnp
from ompi_tpu import op as OP
from ompi_tpu.coll import xla as FLAT
from ompi_tpu.core import cvar
out_dir = {out_dir!r}
JOB_SPLIT = {split!r}

def mk(x, dt):
    return jnp.asarray(x).astype(dt)

def npy(y):
    a = np.asarray(y)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
{cases}
run_job(comm, {matrix!r}, {second!r})
'''

_PORT_PROG = '''
import json
import numpy as np
import torch
from ompi_tpu_torch import comm as comm_mod, compat, errors, mpi, op as OP
from ompi_tpu_torch.coll import device as FLAT
from ompi_tpu_torch.datatype import dtype_of
from ompi_tpu_torch.coll import han
from ompi_tpu_torch.core import cvar, pvar
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
JOB_SPLIT = {split!r}

def mk(x, dt):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dt))

def npy(y):
    return compat.tensor_to_numpy(y)

def bits(a, b):
    return npy(a).tobytes() == npy(b).tobytes()

def err(fn):
    try:
        fn()
    except errors.MPIError as e:
        return [e.error_class, str(e)]
    return None
{cases}
doc = {{}}
doc["providers"] = {{s: comm.coll.providers[s] for s in (
    "allreduce_dev", "bcast_dev", "allgather_dev", "alltoall_dev",
    "reduce_scatter_block_dev", "allreduce_multi_dev", "allreduce_init_dev",
    "allreduce_multi_init_dev")}}
run_job(comm, {matrix!r}, {second!r})
plan = comm._coll_hier_plan
doc["grid"] = [plan.n_dcn, plan.n_ici, plan.low.size, plan.up.size]

# the DCN bound and its attribution (test_dcn_bytes_bounded_and_attributed)
x = torch.arange(4096, dtype=torch.float32) + rank
s = pvar.session()
comm.coll.allreduce_dev(comm, x)
doc["dcn"] = [s.read("hier_dcn_bytes"), s.read("hier_ici_bytes"),
              s.read("hier_launches"), 4096 * 4 // plan.n_ici]

# 'ring' and coll_hier_force flat fall through (test_ring_det_...)
x = torch.arange(64, dtype=torch.float32) * (rank + 1)
s = pvar.session()
p = comm.coll.allreduce_dev(comm, x, deterministic="ring")
doc["ring"] = [bits(p, FLAT.allreduce_dev(comm, x, deterministic="ring")),
               s.read("hier_fallthrough"), s.read("hier_launches")]
cvar.set("coll_hier_force", "flat")
s = pvar.session()
comm.coll.allreduce_dev(comm, x)
doc["force_flat"] = [s.read("hier_fallthrough"), s.read("hier_launches")]
cvar.set("coll_hier_force", "")

# the fused multi form (test_fused_multi_linear_bit_identical)
rng = np.random.default_rng(rank)
bufs = {{"w": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal((7,)).astype(np.float32)),
        "i": torch.arange(5, dtype=torch.int32) + rank}}
s = pvar.session()
p = comm.coll.allreduce_multi_dev(comm, bufs, deterministic="linear")
q = FLAT.allreduce_multi_dev(comm, bufs, deterministic="linear")
doc["fused"] = [all(bits(p[k], q[k]) for k in bufs),
                s.read("hier_fused_launches")]

# persistent restarts (test_persistent_restart_cycles)
rng = np.random.default_rng(rank + 3)
lst = [torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
       torch.from_numpy(rng.standard_normal((6,)).astype(np.float32))]
req = comm.coll.allreduce_multi_init_dev(comm, lst, deterministic="linear")
ref = FLAT._PERSISTENT["allreduce_multi_init_dev"](
    comm, lst, deterministic="linear")
s = pvar.session()
ok = True
for cycle in range(3):
    req.start(); ref.start(); req.wait(); ref.wait()
    ok = ok and all(bits(a, b) for a, b in zip(req.array, ref.array))
doc["persistent"] = [ok, s.read("hier_launches")]
req.free(); ref.free()
x = torch.full((8,), float(rank + 1))
r1 = comm.coll.allreduce_init_dev(comm, x)
vals = []
for cycle in range(2):
    r1.start(); r1.wait()
    vals.append(float(r1.array[0]))
r1.free()
doc["persistent_single"] = vals

# a malformed split raises at every call, uncached (test_bad_split_...)
bad = "3x2" if size == 4 else "4x2"
cvar.set("coll_hier_split", bad)
c3 = comm.dup()
doc["bad_split"] = [c3.coll.providers["allreduce_dev"],
                    err(lambda: c3.coll.allreduce_dev(c3, torch.ones(16))),
                    err(lambda: c3.coll.allreduce_dev(c3, torch.ones(16))),
                    "_coll_hier_plan" in c3.__dict__, bad]
cvar.set("coll_hier_split", JOB_SPLIT)
c3.free()

# a user's 2-rank split has no grid: ERR_ARG; the grid's levels run
sub = comm.split(rank // 2, rank)
doc["user_split"] = err(lambda: sub.coll.allreduce_dev(sub, torch.ones(4)))
sub.free()

# the switchpoint table (test_switchpoint_table_flat_entries)
path = f"{{out_dir}}/hier_sw_{{rank}}.json"
with open(path, "w") as f:
    json.dump([{{"op": "allreduce", "dtype": "float32",
                 "mesh": [plan.n_dcn, plan.n_ici], "log2": 12,
                 "algorithm": "flat"}}], f)
cvar.set("coll_hier_switchpoints", path)
s = pvar.session()
comm.coll.allreduce_dev(comm, torch.arange(64, dtype=torch.float32))
small = s.read("hier_launches")
s = pvar.session()
comm.coll.allreduce_dev(comm, torch.arange(2048, dtype=torch.float32))
doc["switchpoints"] = [small, s.read("hier_fallthrough"),
                       s.read("hier_launches")]
cvar.set("coll_hier_switchpoints", "")

# coll/han: providers under modulo:2, levels freed with the comm
cvar.set("coll_han_split", "modulo:2")
hc = comm.dup()
cvar.set("coll_han_split", "auto")
doc["han_providers"] = {{s: hc.coll.providers[s] for s in (
    "barrier", "bcast", "reduce", "allreduce", "allgather")}}
cvar.set("coll_han_split", "modulo:2")
hv = np.arange(6, dtype=np.float32) * (rank + 1)
hout = np.empty_like(hv)
hc.coll.allreduce(hc, hv, hout, 6, dtype_of(hout), OP.SUM)
lv = han._levels(hc)
low = lv.low
hc.free()
cvar.set("coll_han_split", "auto")
doc["han"] = [hout.tolist(), lv.low is None and lv.up is None,
              low.cid not in comm_mod._comms]

# off by default (test_off_by_default)
cvar.set("coll_hier", "off")
c4 = comm.dup()
cvar.set("coll_hier", "on")
doc["off_provider"] = c4.coll.providers["allreduce_dev"]
c4.free()

# coll/device's two-level mode (tests/test_coll_xla.py's coll_xla_hier),
# on comms where coll/hier does not stack
cvar.set("coll_device_hier", "2")
cvar.set("coll_hier", "off")
c5 = comm.dup()
x = torch.arange(8, dtype=torch.float32) + rank
r_ = c5.Allreduce(x)
g = FLAT.grid_of(c5)
b = c5.Bcast(torch.full((5,), float(rank)), root=3)
blk = 2
a = torch.arange(size * blk, dtype=torch.int32) + 100 * rank
a2a = c5.Alltoall(a)
d = c5.Allreduce(x, deterministic="linear")
want = torch.arange(8, dtype=torch.float32)
for rr in range(1, size):
    want = want + (torch.arange(8, dtype=torch.float32) + rr)
doc["xla_hier"] = {{
    "grid": None if g is None else [g.n_dcn, g.n_ici],
    "allreduce": r_.tolist(), "bcast": b.tolist(), "alltoall": a2a.tolist(),
    "linear_bits": bits(d, want)}}
c5.free()
sub3 = comm.split(rank // 3, rank) if size % 3 == 0 else None
if sub3 is not None:
    r3 = sub3.Allreduce(torch.ones(4))
    doc["xla_hier_3"] = [FLAT.grid_of(sub3) is None, r3.tolist()]
    sub3.free()
cvar.set("coll_device_hier", "auto")
cvar.set("coll_hier", "on")
with open(f"{{out_dir}}/doc_r{{rank}}.json", "w") as fh:
    json.dump(doc, fh)
mpi.Finalize()
'''


def _port_job(n: int, out: str) -> None:
    split, second = JOBS[n]
    src = textwrap.dedent(_PORT_PROG).format(
        out_dir=out, split=split, cases=_CASES, matrix=MATRIX,
        second=second)
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    mca = dict(compat.mca_from_reference(_mca(split)),
               device_plane_platform="cpu")
    try:
        rc = port_launcher.launch([sys.executable, path], n, mca=mca,
                                  timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job on {n} ranks exited {rc}"


def _ref_job(n: int, out: str) -> None:
    split, second = JOBS[n]
    run_ranks(_REF_PROG.format(out_dir=out, split=split, cases=_CASES,
                               matrix=MATRIX, second=second),
              n, mca=_mca(split), timeout=300, isolate=True)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{n: (reference dir, port dir)}, every job run once."""
    out = {}
    for n in JOBS:
        ref = tmp_path_factory.mktemp(f"hier_ref{n}")
        port = tmp_path_factory.mktemp(f"hier_port{n}")
        _ref_job(n, str(ref))
        _port_job(n, str(port))
        out[n] = (ref, port)
    return out


def _doc(d, r):
    return json.loads((d / f"doc_r{r}.json").read_text())


def _grids():
    out = []
    for n, (split, second) in JOBS.items():
        out.append((n, "g0", split))
        if second:
            out.append((n, "g1", second))
    return out


def _names():
    names = []
    for dt, ops in MATRIX:
        for op in ops:
            names += [f"ar_linear_{dt}_{op}", f"rsb_linear_{dt}_{op}"] + [
                f"multi_linear_{dt}_{op}_{k}" for k in ("w", "b", "i")]
    return names + ["allgather", "bcast", "alltoall"]


@pytest.mark.parametrize("n,tag,split", _grids())
def test_linear_bit_identical_to_flat(jobs, n, tag, split):
    """'linear' Allreduce, Reduce_scatter_block and the fused multi form
    (float32, bfloat16, int32 x SUM / PROD / MIN / MAX) and the data
    movers (Allgather, Bcast, Alltoall) equal the package's flat slots
    bitwise in both jobs, and the port's equal the reference's bitwise,
    on every grid; the default split-level results are within 1e-5 of the
    flat ones in both packages (different add order is the point)."""
    ref, port = jobs[n]
    for r in range(n):
        for d in (ref, port):
            oks = json.loads((d / f"oks_r{r}.json").read_text())[tag]
            assert all(oks.values()), (d, r, {k: v for k, v in oks.items()
                                              if not v})
        for name in _names():
            a = np.load(ref / f"{tag}_{name}_r{r}.npy")
            b = np.load(port / f"{tag}_{name}_r{r}.npy")
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(b, a, err_msg=f"{split} {name}")


@pytest.mark.parametrize("n,tag,split", _grids())
def test_default_split_level_matches_reference(jobs, n, tag, split):
    """The default split-level Allreduce and Reduce_scatter_block within
    RTOL of the reference's, per element, relative to the sum of the
    operands' magnitudes (the 3-slice grids fold three DCN operands)."""
    ref, port = jobs[n]
    rng = np.random.default_rng(13)
    h = (rng.standard_normal(6 * n)
         * (10.0 ** rng.integers(-3, 4, 6 * n))).astype(np.float32)
    mag = np.abs(h).sum()
    for r in range(n):
        for name in ("ar_default", "rsb_default"):
            a = np.load(ref / f"{tag}_{name}_r{r}.npy").astype(np.float64)
            b = np.load(port / f"{tag}_{name}_r{r}.npy").astype(np.float64)
            assert np.abs(a - b).max() <= RTOL["float32"] * mag, name


@pytest.mark.parametrize("n", sorted(JOBS))
def test_providers_and_grid(jobs, n):
    """coll/hier serves the eight slots; the plan's levels are the grid's
    (low: n_ici ranks, up: n_dcn)."""
    d, i = (int(v) for v in JOBS[n][0].split("x"))
    for r in range(n):
        doc = _doc(jobs[n][1], r)
        assert set(doc["providers"].values()) == {"hier"}, doc["providers"]
        assert doc["grid"] == [d, i, i, d]


@pytest.mark.parametrize("n", sorted(JOBS))
def test_dcn_bytes_bounded_and_attributed(jobs, n):
    """A split-level allreduce puts at most payload / ici_size bytes on
    the DCN level, and the per-level pvars attribute it."""
    for r in range(n):
        dcn, ici, launches, bound = _doc(jobs[n][1], r)["dcn"]
        assert 0 < dcn <= bound and ici > 0 and launches == 1


@pytest.mark.parametrize("n", sorted(JOBS))
def test_ring_det_and_force_flat_fall_through(jobs, n):
    """'ring' pins the flat ring (bitwise the flat slot's) and
    coll_hier_force=flat is the A/B switch: both delegate, counted."""
    for r in range(n):
        doc = _doc(jobs[n][1], r)
        assert doc["ring"] == [True, 1, 0]
        assert doc["force_flat"] == [1, 0]


@pytest.mark.parametrize("n", sorted(JOBS))
def test_fused_multi_linear_bit_identical(jobs, n):
    for r in range(n):
        ok, fused = _doc(jobs[n][1], r)["fused"]
        assert ok and fused >= 1


@pytest.mark.parametrize("n", sorted(JOBS))
def test_persistent_restart_cycles(jobs, n):
    """Three starts of the persistent multi form, bitwise the flat
    persistent form each time, one hier launch each; the single-buffer
    form restarts the same way."""
    for r in range(n):
        doc = _doc(jobs[n][1], r)
        assert doc["persistent"] == [True, 3]
        assert doc["persistent_single"] == [float(sum(range(1, n + 1)))] * 2


@pytest.mark.parametrize("n", sorted(JOBS))
def test_bad_split_raises_at_first_collective(jobs, n):
    """An indivisible split raises ERR_ARG naming the counts at every
    call (uncached), never inside comm_select's query."""
    from ompi_tpu_torch import errors

    for r in range(n):
        prov, e1, e2, cached, bad = _doc(jobs[n][1], r)["bad_split"]
        assert prov == "hier" and not cached
        for e in (e1, e2):
            assert e[0] == errors.ERR_ARG and bad in e[1] and str(n) in e[1]


@pytest.mark.parametrize("n", sorted(JOBS))
def test_user_split_subcomm(jobs, n):
    """A user's 2-rank split under the job's grid spec raises ERR_ARG at
    its collective (the reference does the same), while the grid's own
    2-rank levels run: coll/hier calls their slots directly."""
    from ompi_tpu_torch import errors

    for r in range(n):
        e = _doc(jobs[n][1], r)["user_split"]
        assert e[0] == errors.ERR_ARG and "the communicator has 2" in e[1]


@pytest.mark.parametrize("n", sorted(JOBS))
def test_switchpoint_table_flat_entries(jobs, n):
    """A 'flat' entry above its log2 falls through; below it stays
    two-level."""
    for r in range(n):
        assert _doc(jobs[n][1], r)["switchpoints"] == [1, 1, 0]


@pytest.mark.parametrize("n", sorted(JOBS))
def test_han_levels_freed_with_comm(jobs, n):
    """coll/han serves its five slots under modulo:2; its allreduce sums;
    freeing the comm frees its low and up levels."""
    want = (np.arange(6, dtype=np.float32) * sum(range(1, n + 1))).tolist()
    for r in range(n):
        doc = _doc(jobs[n][1], r)
        assert set(doc["han_providers"].values()) == {"han"}
        hout, released, gone = doc["han"]
        assert hout == want and released and gone


@pytest.mark.parametrize("n", sorted(JOBS))
def test_off_by_default(jobs, n):
    for r in range(n):
        assert _doc(jobs[n][1], r)["off_provider"] == "device"


@pytest.mark.parametrize("n", sorted(JOBS))
def test_hierarchical_collectives_on_sliced_comm(jobs, n):
    """coll_device_hier=2 (coll_xla_hier's counterpart): a 2-slice grid,
    Allreduce / Bcast / Alltoall exact, 'linear' flat and bitwise."""
    for r in range(n):
        h = _doc(jobs[n][1], r)["xla_hier"]
        assert h["grid"] == [2, n // 2]
        exp = n * np.arange(8, dtype=np.float32) + sum(range(n))
        np.testing.assert_allclose(h["allreduce"], exp, rtol=1e-6)
        assert h["bcast"] == [3.0] * 5
        out = np.asarray(h["alltoall"])
        for src in range(n):
            np.testing.assert_array_equal(
                out[src * 2:(src + 1) * 2],
                np.arange(r * 2, (r + 1) * 2) + 100 * src)
        assert h["linear_bits"]


def test_hier_off_and_indivisible_stay_flat(jobs):
    """3 ranks do not split into 2 slices: coll_device_hier=2 stays
    flat."""
    for r in range(6):
        flat, out = _doc(jobs[6][1], r)["xla_hier_3"]
        assert flat and out == [3.0] * 4


# ---------------------------------------------------------------------------
# the switchpoint-table fault (tests/test_tune.py:185-205), this process


@pytest.mark.parametrize("component", ["cuda", "hier"])
def test_switchpoint_table_errors_are_counted(tmp_path, component):
    """An unreadable table returns the built-in choice and counts
    tune_table_errors once per load attempt (coll/cuda raised ERR_ARG
    before)."""
    from ompi_tpu_torch.coll import cuda as ccuda
    from ompi_tpu_torch.coll import hier as chier
    from ompi_tpu_torch.core import cvar, pvar

    mod, var, mesh = {"cuda": (ccuda, "coll_cuda_switchpoints", (2,)),
                      "hier": (chier, "coll_hier_switchpoints",
                               (2, 2))}[component]
    bad = tmp_path / "bad_table.json"
    bad.write_text("{not json")
    s = pvar.session()
    try:
        cvar.set(var, str(bad))
        for attempt in (1, 2):
            mod._sw_cache.clear()
            assert mod._switchpoint("allreduce", 1 << 20, "float32",
                                    mesh) == ""
            assert s.read("tune_table_errors") == attempt
        cvar.set(var, str(tmp_path / "missing.json"))
        mod._sw_cache.clear()
        assert mod._switchpoint("allreduce", 1 << 20, "float32", mesh) == ""
        assert s.read("tune_table_errors") == 3
    finally:
        cvar.set(var, "")
        mod._sw_cache.clear()


def test_mca_maps_coll_xla_hier():
    """The reference's coll_xla_hier is coll_device_hier in the port; the
    coll_hier_* and coll_han_* settings keep their names."""
    got = compat.mca_from_reference({"coll_xla_hier": "2", "coll_hier": "on",
                                      "coll_hier_split": "2x2",
                                      "coll_han_split": "modulo:2"})
    assert got == {"coll_device_hier": "2", "coll_hier": "on",
                   "coll_hier_split": "2x2", "coll_han_split": "modulo:2"}
