"""The port's MPI-IO plane (``io/__init__.py``, ``io/fileview.py``,
``io/fcoll.py``) against the JAX package's: the counterparts of
``tests/test_io.py``'s 13 cases, ``tests/test_fcoll.py``'s 4,
``tests/test_type_introspect.py``'s ``test_darray_fileview_collective_io``
and ``test_type_and_file_query_methods``, and
``tests/test_errhandler_info.py::test_file_errhandler_and_info``.

In this process: the one-rank cases, each run through both packages on
the same seeded numpy data (:func:`_both`), the written files compared
byte for byte and the read buffers bitwise; the port's runs also hand CPU
tensors to the write forms, and a read into a tensor is
``MPIError(ERR_BUFFER)`` where the reference's read into a jax.Array
raises ValueError.

Launcher jobs, one per package and rank count (2, 3 and 4), run the same
programs (:data:`_PROG2`, :data:`_PROG3`, :data:`_PROG4`: the reference's
multi-rank cases, each writing its file under the job's directory and
each rank recording what it read); the reference's run as pooled bodies.
In the port's jobs every write form takes a CPU tensor (:data:`_W`). The
files of the two jobs must be equal byte for byte (the shared pointer's
records, whose order MPI leaves open, as a set) and every rank's reads
bitwise.
"""

import json
import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

#: what a write form is handed: numpy in the reference's jobs, a CPU
#: tensor over the same bytes in the port's
_W = {"ompi_tpu": "def W(a):\n    return a\n",
      "ompi_tpu_torch": "import torch\n\n\ndef W(a):\n"
                        "    return torch.from_numpy(np.ascontiguousarray(a))\n"}

_HEAD = '''
import json, os, time
import numpy as np
from {pkg} import errors, mpi
from {pkg} import io as io_mod
from {pkg}.datatype import datatype as D
from {pkg}.io import fcoll
OUT = {out!r}
doc = {{}}


def raw(name):
    return os.path.join(OUT, name)


def err(call):
    try:
        call()
        return None
    except Exception as e:  # noqa: BLE001 — the class is the result
        return [type(e).__name__, getattr(e, "error_class", None), str(e)]
'''

_TAIL = '''
comm.Barrier()
with open(os.path.join(OUT, f"r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''

#: 2 ranks: the shared pointer, the split collectives, the nonblocking
#: individual-pointer forms, atomicity, the file errhandler and info, the
#: aggregator's short-write retry
_PROG2 = _HEAD + '''
# -- test_shared_pointer_2rank
f = io_mod.File_open(comm, raw("shared"), io_mod.MODE_CREATE | io_mod.MODE_RDWR)
f.Write_shared(W(np.full(8, rank + 1, dtype=np.int32)))
comm.Barrier()
out = np.zeros(16, dtype=np.int32)
f.Read_at(0, out)
doc["shared"] = sorted([out[:8].tolist(), out[8:].tolist()])
f.Close()

# -- test_split_collective_begin_end
f = mpi.File_open(comm, raw("split"), mpi.MODE_CREATE | mpi.MODE_RDWR)
data = np.full(32, rank + 1, np.float64)
f.Write_at_all_begin(rank * data.nbytes, W(data))
doc["split_second_begin"] = err(lambda: f.Write_at_all_begin(0, W(data)))[:2]
busy = sum(range(1000))
doc["split_end"] = f.Write_at_all_end()
comm.Barrier()
back = np.zeros(32, np.float64)
f.Read_at_all_begin(((rank + 1) % size) * back.nbytes, back)
doc["split_read_end"] = f.Read_at_all_end()
doc["split_back"] = back.tolist()
doc["split_end_no_begin"] = err(f.Read_at_all_end)[:2]
comm.Barrier()
f.Close()

# -- test_iwrite_all_individual_pointer
f = mpi.File_open(comm, raw("iall"), mpi.MODE_CREATE | mpi.MODE_RDWR)
ftype = D.vector(4, 8, 8 * size, D.INT32)
f.Set_view(disp=rank * 8 * 4, etype=D.INT32, filetype=ftype)
data = np.arange(32, dtype=np.int32) + 100 * rank
r = f.Iwrite_all(W(data))
r.wait(timeout=60)
doc["iall_pos"] = f.Get_position()
comm.Barrier()
f.Seek(0)
back = np.zeros(32, np.int32)
rr = f.Iread_all(back)
rr.wait(timeout=60)
doc["iall_back"] = back.tolist()
comm.Barrier()
f.Close()

# -- test_file_atomicity
f = io_mod.File_open(comm, raw("atomic"), io_mod.MODE_CREATE | io_mod.MODE_RDWR)
doc["atomic_flags"] = [f.Get_atomicity()]
f.Set_atomicity(True)
doc["atomic_flags"].append(f.Get_atomicity())
fsyncs = []
real_fsync = os.fsync
os.fsync = lambda fd: (fsyncs.append(fd), real_fsync(fd))[1]
try:
    if rank == 0:
        f.Write_at(0, W(np.arange(8, dtype=np.int32)))
finally:
    os.fsync = real_fsync
doc["atomic_fsynced"] = bool(fsyncs) if rank == 0 else None
comm.Barrier()
got = np.zeros(8, np.int32)
if rank == 1:
    f.Read_at(0, got)
doc["atomic_got"] = got.tolist()
f.Set_atomicity(False)
f.Close()

# -- test_file_errhandler_and_info
from {pkg}.info import MEMORY_ALLOC_KINDS
f = mpi.File_open(comm, raw("eh"), mpi.MODE_CREATE | mpi.MODE_RDWR,
                  info={{MEMORY_ALLOC_KINDS: "system,junk"}})
doc["eh_info"] = f.Get_info().get(MEMORY_ALLOC_KINDS)
doc["eh_default"] = f.Get_errhandler() == errors.ERRORS_RETURN
if rank == 0:
    f.Write_at(0, W(np.arange(4, dtype=np.int32)))
comm.Barrier()
handled = []
f.Set_errhandler(mpi.File_create_errhandler(lambda o, e: handled.append(e)))
fd, f.fd = f.fd, None
buf = np.full(4, 7, np.int32)
doc["eh_recovered_n"] = f.Read_at(0, buf)
doc["eh_recovered_buf"] = buf.tolist()
doc["eh_handled"] = [e.error_class for e in handled]
f.fd = fd
f.Read_at(0, buf)
doc["eh_buf"] = buf.tolist()
comm.Barrier()
f.Close()

# -- test_aggregator_short_write_retries_2rank
f = io_mod.File_open(comm, raw("agg"), io_mod.MODE_CREATE | io_mod.MODE_RDWR)
if rank == 0:
    real = f._pwritev
    state = {{"first": True}}

    def flaky(extents, data):
        if state["first"] and len(data) > 1:
            state["first"] = False
            (off, ln), = extents
            real([(off, ln // 2)], data[:ln // 2])
            return ln // 2
        return real(extents, data)

    f._pwritev = flaky
blk = 512
data = bytes(np.full(blk, rank + 1, dtype=np.uint8))
doc["agg_n"] = fcoll.two_phase_write(f, [(rank * blk, blk)], data)
f.Close()
'''

#: 3 ranks: the nonblocking collectives with overlap, the ordered
#: shared-pointer collectives and their split forms, SEEK_END in visible
#: space and the bad shared seek
_PROG3 = _HEAD + '''
# -- test_iwrite_iread_at_all_nonblocking
f = mpi.File_open(comm, raw("inb"), mpi.MODE_CREATE | mpi.MODE_RDWR)
data = np.arange(64, dtype=np.int32) + 1000 * rank
wr = f.Iwrite_at_all(rank * data.nbytes, W(data))
token = comm.sendrecv(("overlap", rank), dest=(rank + 1) % size)
doc["inb_token"] = list(token)
wr.wait(timeout=60)
doc["inb_n"] = wr.result["n"]
comm.Barrier()
back = np.zeros(64, np.int32)
rd = f.Iread_at_all(((rank + 1) % size) * back.nbytes, back)
rd.wait(timeout=60)
doc["inb_back"] = back.tolist()
comm.Barrier()
f.Close()

# -- test_write_ordered_rank_order
f = io_mod.File_open(comm, raw("ordered"), io_mod.MODE_CREATE | io_mod.MODE_RDWR)
if rank == 0:
    time.sleep(0.2)  # rank order must not depend on arrival
f.Write_ordered(W(np.full(4 + 3 * rank, rank + 1, dtype=np.int32)))
f.Write_ordered(W(np.full(2, 10 + rank, dtype=np.int32)))
doc["ordered_shared"] = f.Get_position_shared()
comm.Barrier()
f.Close()

# -- test_read_ordered_and_split_forms
f = io_mod.File_open(comm, raw("ordered_r"), io_mod.MODE_CREATE | io_mod.MODE_RDWR)
sizes = [2 + r for r in range(size)]
f.Write_ordered_begin(W(np.full(sizes[rank], rank + 1, dtype=np.int32)))
acc = float(np.arange(500).sum())
doc["ordr_n"] = f.Write_ordered_end()
doc["ordr_shared"] = f.Get_position_shared()
f.Seek_shared(0)
got = np.zeros(sizes[rank], dtype=np.int32)
f.Read_ordered_begin(got)
e = err(lambda: f.Read_ordered_begin(got))
doc["ordr_double"] = [e[1], "split collective" in e[2]]
f.Read_ordered_end()
doc["ordr_got"] = got.tolist()
f.Close()

# -- test_seek_end_visible_space_and_bad_shared_seek
f = io_mod.File_open(comm, raw("seekend"), io_mod.MODE_CREATE | io_mod.MODE_RDWR)
if rank == 0:
    f.Write_at(0, W(np.arange(26, dtype=np.int32)))
comm.Barrier()
f.Set_view(disp=8, etype=D.INT32, filetype=D.vector(6, 1, 2, D.INT32))
f.Seek(0, io_mod.SEEK_END)
doc["seekend_pos"] = f.Get_position()
e = err(lambda: f.Seek_shared(-999, io_mod.SEEK_SET))
doc["seekend_bad"] = [e[1], "seek before start" in e[2]]
comm.Barrier()
f.Close()
'''

#: 4 ranks: the block-cyclic collective write and the darray fileview
_PROG4 = _HEAD + '''
# -- test_collective_write_at_all_4rank
f = io_mod.File_open(comm, raw("coll"), io_mod.MODE_CREATE | io_mod.MODE_RDWR)
n, block = 256, 16
ft = D.vector(n // block, block, block * size, D.INT32)
f.Set_view(disp=rank * block * 4, etype=D.INT32, filetype=ft)
f.Write_at_all(0, W(np.full(n, rank + 1, dtype=np.int32)))
f.Set_view(0)
total = np.zeros(n * size, dtype=np.int32)
f.Read_at_all(0, total)
doc["coll_total"] = total.tolist()
f.Close()

# -- test_darray_fileview_collective_io
gs = [8, 8]
i, j = rank // 2, rank % 2
local = np.arange(16, dtype=np.int32).reshape(4, 4) + 100 * (rank + 1)
ft = D.darray(size, rank, gs, [D.DISTRIBUTE_BLOCK, D.DISTRIBUTE_BLOCK],
              [D.DISTRIBUTE_DFLT_DARG] * 2, [2, 2], D.INT32)
f = io_mod.File_open(comm, raw("darray"), io_mod.MODE_CREATE | io_mod.MODE_RDWR)
f.Set_view(0, etype=D.INT32, filetype=ft)
f.Write_at_all(0, W(local.reshape(-1)))
f.Set_view(0)
whole = np.zeros(64, dtype=np.int32)
f.Read_at_all(0, whole)
doc["darray_whole"] = whole.tolist()
f.Set_view(0, etype=D.INT32, filetype=D.subarray(gs, [4, 4], [4 * i, 4 * j],
                                                  D.INT32))
back = np.zeros(16, dtype=np.int32)
f.Read_at_all(0, back)
doc["darray_back"] = back.tolist()
f.Close()
'''

_PROGS = {2: _PROG2, 3: _PROG3, 4: _PROG4}
_FILES = {2: ("split", "iall", "atomic", "eh", "agg"),
          3: ("inb", "ordered", "ordered_r", "seekend"),
          4: ("coll", "darray")}
_PORT_PRELUDE = '''
import numpy as np
from ompi_tpu_torch import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size
'''
_jobs = {}


def _port_job(src: str, n: int, timeout=240) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n,
                                    mca={"device_plane_platform": "cpu"},
                                    timeout=timeout)
    finally:
        os.unlink(path)


@pytest.fixture(scope="module")
def jobs(request, tmp_path_factory):
    """(port dir, reference dir, [(port doc, reference doc)] per rank)."""
    n = request.param
    if n not in _jobs:
        ref = tmp_path_factory.mktemp(f"io_ref{n}")
        port = tmp_path_factory.mktemp(f"io_port{n}")
        run_ranks(_W["ompi_tpu"] + _PROGS[n].format(pkg="ompi_tpu",
                                                    out=str(ref))
                  + _TAIL.format(), n, timeout=240)
        src = (_PORT_PRELUDE + _W["ompi_tpu_torch"]
               + _PROGS[n].format(pkg="ompi_tpu_torch", out=str(port))
               + _TAIL.format() + "mpi.Finalize()\n")
        assert _port_job(src, n) == 0, "port job failed"
        _jobs[n] = (port, ref, [
            (json.loads((port / f"r{r}.json").read_text()),
             json.loads((ref / f"r{r}.json").read_text()))
            for r in range(n)])
    return _jobs[n]


def _same(pairs, key):
    for p, r in pairs:
        assert p[key] == r[key], (key, p[key], r[key])
    return [r[key] for _, r in pairs]


def _same_file(jobs, name) -> bytes:
    port, ref, _ = jobs
    a, b = (port / name).read_bytes(), (ref / name).read_bytes()
    assert a == b, (name, len(a), len(b))
    return b


def _ints(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.int32)


# ---------------------------------------------------------------------------
# in process: one rank, both packages


def _pkgs():
    from ompi_tpu import io as R_io, mpi as R_mpi
    from ompi_tpu.datatype import datatype as R_D
    from ompi_tpu.io import fcoll as R_fcoll
    from ompi_tpu_torch import io as P_io, mpi as P_mpi
    from ompi_tpu_torch.datatype import datatype as P_D
    from ompi_tpu_torch.io import fcoll as P_fcoll

    return {"ref": (R_mpi, R_io, R_D, R_fcoll, lambda a: a),
            "port": (P_mpi, P_io, P_D, P_fcoll, _tensor)}


def _tensor(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _both(case, tmp_path):
    """Run ``case(mpi, io, D, fcoll, W, path)`` through each package on
    its own file; returns {side: (result, file bytes)}."""
    out = {}
    for side, (mpi, io_mod, D, fcoll, W) in _pkgs().items():
        path = str(tmp_path / f"{side}.mpiio")
        res = case(mpi, io_mod, D, fcoll, W, path)
        with open(path, "rb") as fh:
            out[side] = (res, fh.read())
        os.unlink(path)
    assert out["port"][1] == out["ref"][1], "files differ"
    return out


def _open(mpi, io_mod, path):
    return io_mod.File_open(mpi.Init(), path,
                            io_mod.MODE_CREATE | io_mod.MODE_RDWR)


def test_singleton_write_read_at(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.integers(-2**31, 2**31 - 1, 64, dtype=np.int32)

    def case(mpi, io_mod, D, fcoll, W, path):
        f = _open(mpi, io_mod, path)
        n = f.Write_at(0, W(data))
        out = np.zeros(64, dtype=np.int32)
        f.Read_at(0, out)
        f.Set_view(0, etype=None)
        f.Close()
        return n, out

    got = _both(case, tmp_path)
    assert got["port"][0][0] == got["ref"][0][0] == 256
    assert np.array_equal(got["port"][0][1], data)
    assert np.array_equal(got["ref"][0][1], data)


def test_file_view_strided(tmp_path):
    def case(mpi, io_mod, D, fcoll, W, path):
        f = _open(mpi, io_mod, path)
        ft = D.vector(8, 1, 2, D.INT32)
        for lane in range(2):
            f.Set_view(disp=lane * 4, etype=D.INT32, filetype=ft)
            f.Write_at(0, W(np.full(8, lane + 1, dtype=np.int32)))
        raw = np.zeros(16, dtype=np.int32)
        f.Set_view(0)
        f.Read_at(0, raw)
        f.Close()
        return raw

    got = _both(case, tmp_path)
    for side in ("port", "ref"):
        raw = got[side][0]
        assert (raw[::2] == 1).all() and (raw[1::2] == 2).all(), raw


def test_individual_pointer_and_seek(tmp_path):
    data = np.random.default_rng(2).standard_normal(10)

    def case(mpi, io_mod, D, fcoll, W, path):
        f = _open(mpi, io_mod, path)
        f.Write(W(data))
        pos = f.Get_position()
        f.Seek(0, io_mod.SEEK_SET)
        out = np.zeros(10, dtype=np.float64)
        f.Read(out)
        f.Close()
        return pos, out

    got = _both(case, tmp_path)
    for side in ("port", "ref"):
        assert got[side][0][0] == 80
        assert got[side][0][1].tobytes() == data.tobytes()


def test_iwrite_iread_at(tmp_path):
    data = np.random.default_rng(3).integers(0, 2**62, 1024, dtype=np.int64)

    def case(mpi, io_mod, D, fcoll, W, path):
        f = _open(mpi, io_mod, path)
        n = f.Iwrite_at(0, W(data)).wait()
        out = np.zeros_like(data)
        f.Iread_at(0, out).wait()
        f.Close()
        return n, out

    got = _both(case, tmp_path)
    for side in ("port", "ref"):
        assert got[side][0][0] == data.nbytes
        assert np.array_equal(got[side][0][1], data)


def test_type_and_file_query_methods(tmp_path):
    """MPI_Type_size / get_extent / get_true_extent and
    MPI_File_get_byte_offset / get_type_extent, both packages."""
    def case(mpi, io_mod, D, fcoll, W, path):
        v = D.vector(3, 2, 4, D.FLOAT)
        rz = D.resized(v, -8, 64)
        f = _open(mpi, io_mod, path)
        ft = D.vector(4, 1, 2, D.INT32)
        f.Set_view(disp=8, etype=D.INT32, filetype=ft)
        q = [v.Get_size(), v.Get_extent(), v.Get_true_extent(),
             rz.Get_extent(), rz.Get_true_extent(), f.Get_byte_offset(0),
             f.Get_byte_offset(1), f.Get_type_extent(ft) == ft.extent]
        f.Close()
        return q

    got = _both(case, tmp_path)
    assert got["port"][0] == got["ref"][0] == [
        24, (0, 40), (0, 40), (-8, 64), (0, 40), 8, 16, True]


def test_write_forms_take_tensors_reads_refuse_them(tmp_path):
    """Every write form of the port takes a CPU tensor (bfloat16 as its
    bytes under MPI_BFLOAT16) and lands the reference's bytes for the same
    numpy data; a read into a tensor is MPIError(ERR_BUFFER), where the
    reference's read into a jax.Array raises ValueError."""
    import jax.numpy as jnp
    import torch

    from ompi_tpu_torch import errors

    bits = np.random.default_rng(4).integers(0, 2**16, 6, dtype=np.uint16)

    def case(mpi, io_mod, D, fcoll, W, path):
        f = _open(mpi, io_mod, path)
        a = np.arange(6, dtype=np.float32)
        f.Write_at(0, W(a))
        f.Iwrite_at(24, W(a + 6)).wait()
        f.Seek(48)
        f.Write(W(a + 12))
        f.Write_all(W(a + 18))
        f.Iwrite_all(W(a + 24)).wait()
        f.Write_shared(W(a[:2]))
        f.Write_ordered(W(a[:2] + 1))
        f.Write_at_all(144, W(a + 30))
        f.Iwrite_at_all(168, W(a + 36)).wait()
        f.Write_at_all_begin(192, W(a + 42))
        f.Write_at_all_end()
        if isinstance(W(a), np.ndarray):
            bf = jnp.asarray(bits.view(jnp.bfloat16))
        else:
            bf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        f.Write_at(216, bf)
        refused = []
        for read in (f.Read_at, f.Iread_at, f.Read_at_all):
            target = jnp.zeros(4, jnp.float32) if isinstance(
                W(a), np.ndarray) else torch.zeros(4)
            try:
                req = read(0, target)
                if hasattr(req, "wait"):
                    req.wait()
            except Exception as e:  # noqa: BLE001 — the class is the result
                refused.append([type(e).__name__,
                                getattr(e, "error_class", None)])
        f.Close()
        return refused

    got = _both(case, tmp_path)
    assert got["ref"][0] == [["ValueError", None]] * 3
    assert got["port"][0] == [["MPIError", errors.ERR_BUFFER]] * 3
    assert np.frombuffer(got["port"][1][216:228], np.uint16).tolist() \
        == bits.tolist()


@pytest.mark.parametrize("case", ["retry_lands", "exhaustion",
                                  "extent_mismatch"])
def test_fcoll_one_rank(tmp_path, case):
    """``tests/test_fcoll.py``'s three one-rank cases: a short first
    write retries and lands every byte (``fcoll_write_retries`` 1); a
    persistently short write raises ERR_FILE naming "63/64"; extents
    that do not cover the data are ERR_ARG."""
    from ompi_tpu import errors as R_errors
    from ompi_tpu.core import pvar as R_pvar
    from ompi_tpu_torch import errors as P_errors
    from ompi_tpu_torch.core import pvar as P_pvar

    mods = {"ref": (R_errors, R_pvar), "port": (P_errors, P_pvar)}
    data = bytes(np.random.default_rng(5).integers(0, 256, 256,
                                                   dtype=np.uint8))

    def run(mpi, io_mod, D, fcoll, W, path):
        errors, pvar = mods["ref" if mpi.__name__.startswith("ompi_tpu.")
                            else "port"]
        f = _open(mpi, io_mod, path)
        real = f._pwritev
        if case == "retry_lands":
            calls = {"n": 0}

            def flaky(extents, data):
                calls["n"] += 1
                if calls["n"] == 1:
                    (off, ln), = extents
                    real([(off, ln // 2)], data[:ln // 2])
                    return ln // 2
                return real(extents, data)

            f._pwritev = flaky
            sess = pvar.session()
            n = fcoll.two_phase_write(f, [(0, len(data))], data)
            res = [n, calls["n"], sess.read("fcoll_write_retries")]
        else:
            if case == "exhaustion":
                f._pwritev = lambda extents, data: max(
                    0, extents[0][1] - 1)
                call = (lambda: fcoll.two_phase_write(f, [(0, 64)],
                                                      bytes(64)))
            else:
                call = (lambda: fcoll.two_phase_write(f, [(0, 10)],
                                                      bytes(64)))
            with pytest.raises(errors.MPIError) as ei:
                call()
            res = [ei.value.error_class, "63/64" in str(ei.value)]
        f._pwritev = real
        f.Close()
        return res

    got = _both(run, tmp_path)
    assert got["port"][0] == got["ref"][0], got
    want = {"retry_lands": [256, 2, 1],
            "exhaustion": [R_errors.ERR_FILE, True],
            "extent_mismatch": [R_errors.ERR_ARG, False]}[case]
    assert got["ref"][0] == want
    if case == "retry_lands":
        assert got["ref"][1] == data


# ---------------------------------------------------------------------------
# launcher jobs


@pytest.mark.parametrize("jobs", [2], indirect=True)
def test_shared_pointer_2rank(jobs):
    pairs = jobs[2]
    got = _same(pairs, "shared")
    assert got[0] == [[1] * 8, [2] * 8]
    port, ref, _ = jobs
    recs = [sorted(_ints((d / "shared").read_bytes()).reshape(2, 8).tolist())
            for d in (port, ref)]
    assert recs[0] == recs[1] == [[1] * 8, [2] * 8]


@pytest.mark.parametrize("jobs", [2], indirect=True)
def test_split_collective_begin_end(jobs):
    from ompi_tpu import errors as R

    pairs = jobs[2]
    assert _same(pairs, "split_second_begin")[0] == ["MPIError",
                                                      R.ERR_OTHER]
    assert _same(pairs, "split_end_no_begin")[0] == ["MPIError",
                                                      R.ERR_OTHER]
    assert _same(pairs, "split_end") == [256, 256]
    assert _same(pairs, "split_read_end") == [256, 256]
    back = _same(pairs, "split_back")
    for r, b in enumerate(back):
        assert b == [float((r + 1) % 2 + 1)] * 32
    raw = np.frombuffer(_same_file(jobs, "split"), np.float64)
    assert raw.tolist() == [1.0] * 32 + [2.0] * 32


@pytest.mark.parametrize("jobs", [2], indirect=True)
def test_iwrite_all_individual_pointer(jobs):
    pairs = jobs[2]
    assert _same(pairs, "iall_pos") == [32, 32]
    for r, b in enumerate(_same(pairs, "iall_back")):
        assert b == (np.arange(32) + 100 * r).tolist()
    _same_file(jobs, "iall")


@pytest.mark.parametrize("jobs", [2], indirect=True)
def test_file_atomicity(jobs):
    pairs = jobs[2]
    assert _same(pairs, "atomic_flags") == [[False, True]] * 2
    assert _same(pairs, "atomic_fsynced") == [True, None]
    assert _same(pairs, "atomic_got")[1] == list(range(8))
    _same_file(jobs, "atomic")


@pytest.mark.parametrize("jobs", [2], indirect=True)
def test_file_errhandler_and_info(jobs):
    from ompi_tpu import errors as R

    pairs = jobs[2]
    assert _same(pairs, "eh_info") == ["system"] * 2
    assert _same(pairs, "eh_default") == [True] * 2
    assert _same(pairs, "eh_handled") == [[R.ERR_FILE]] * 2
    assert _same(pairs, "eh_recovered_n") == [16] * 2
    assert _same(pairs, "eh_recovered_buf") == [[0] * 4] * 2
    assert _same(pairs, "eh_buf")[0] == list(range(4))
    _same_file(jobs, "eh")


@pytest.mark.parametrize("jobs", [2], indirect=True)
def test_aggregator_short_write_retries_2rank(jobs):
    assert _same(jobs[2], "agg_n") == [512, 512]
    got = np.frombuffer(_same_file(jobs, "agg"), np.uint8)
    assert got.tolist() == [1] * 512 + [2] * 512


@pytest.mark.parametrize("jobs", [3], indirect=True)
def test_iwrite_iread_at_all_nonblocking(jobs):
    pairs = jobs[2]
    assert _same(pairs, "inb_n") == [256] * 3
    for r, t in enumerate(_same(pairs, "inb_token")):
        assert t == ["overlap", (r - 1) % 3]
    for r, b in enumerate(_same(pairs, "inb_back")):
        assert b == (np.arange(64) + 1000 * ((r + 1) % 3)).tolist()
    _same_file(jobs, "inb")


@pytest.mark.parametrize("jobs", [3], indirect=True)
def test_write_ordered_rank_order(jobs):
    sizes = [4 + 3 * r for r in range(3)]
    assert _same(jobs[2], "ordered_shared") == [4 * (sum(sizes) + 6)] * 3
    out = _ints(_same_file(jobs, "ordered")).tolist()
    want = sum(([r + 1] * sizes[r] for r in range(3)), []) \
        + sum(([10 + r] * 2 for r in range(3)), [])
    assert out == want


@pytest.mark.parametrize("jobs", [3], indirect=True)
def test_read_ordered_and_split_forms(jobs):
    from ompi_tpu import errors as R

    pairs = jobs[2]
    assert _same(pairs, "ordr_n") == [4 * (2 + r) for r in range(3)]
    assert _same(pairs, "ordr_shared") == [4 * 9] * 3
    assert _same(pairs, "ordr_double") == [[R.ERR_OTHER, True]] * 3
    for r, g in enumerate(_same(pairs, "ordr_got")):
        assert g == [r + 1] * (2 + r)
    _same_file(jobs, "ordered_r")


@pytest.mark.parametrize("jobs", [3], indirect=True)
def test_seek_end_visible_space_and_bad_shared_seek(jobs):
    from ompi_tpu import errors as R

    pairs = jobs[2]
    assert _same(pairs, "seekend_pos") == [13] * 3
    assert _same(pairs, "seekend_bad") == [[R.ERR_ARG, True]] * 3
    assert _ints(_same_file(jobs, "seekend")).tolist() == list(range(26))


@pytest.mark.parametrize("jobs", [4], indirect=True)
def test_collective_write_at_all_4rank(jobs):
    for total in _same(jobs[2], "coll_total"):
        pattern = np.asarray(total).reshape(-1, 4, 16)
        for r in range(4):
            assert (pattern[:, r, :] == r + 1).all()
    _same_file(jobs, "coll")


@pytest.mark.parametrize("jobs", [4], indirect=True)
def test_darray_fileview_collective_io(jobs):
    pairs = jobs[2]
    for r, whole in enumerate(_same(pairs, "darray_whole")):
        world = np.asarray(whole).reshape(8, 8)
        for q in range(4):
            qi, qj = q // 2, q % 2
            exp = np.arange(16).reshape(4, 4) + 100 * (q + 1)
            assert (world[4 * qi:4 * qi + 4, 4 * qj:4 * qj + 4] == exp).all()
    for r, back in enumerate(_same(pairs, "darray_back")):
        assert back == (np.arange(16) + 100 * (r + 1)).tolist()
    _same_file(jobs, "darray")
