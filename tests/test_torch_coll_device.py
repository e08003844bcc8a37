"""coll/device, the port's coll/xla counterpart, against the JAX package's
coll/xla.

One job pair on 3 ranks (so the ring's zero pad and an odd ring count
show), and a second on 4 ranks for the order-sensitive cases (on 3 ranks
a ring run the other way round folds the same two operands first): the
reference runs through ``tests.harness.run_ranks`` with
``--mca device_plane on`` (coll/xla serves every device slot), the port
through its launcher with the same settings mapped by
``compat.mca_from_reference`` plus ``device_plane_platform cpu`` (coll/device
serves; no ``coll_cuda``). Both make the same inputs from a seed with
numpy, call Allreduce / Reduce_scatter_block / Allgather / Bcast /
Alltoall through the MPI API, and write every result as a ``.npy`` file.

- ``'linear'`` and ``'ring'``, Bcast, Alltoall and Allgather: bitwise
  (NaN payloads aside), for the kernels' dtypes and ops (K1-K3 over the
  arenas) and for the ten traceable ops on the dtypes where jnp defines
  them (the pull schedule, then the fold).
- ``''``: SUM and PROD within ``DEFAULT_RTOL[dtype]`` of the sum (product)
  of the operands' magnitudes per element (the fold order is the
  schedule's: psum against the ring or the rank-order fold, two or three
  roundings apart); every other op is order-independent and exact.

Plus the erroneous calls on every rank of both packages, and the
singleton (a one-rank world, no device plane) in a subprocess of each.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch import compat
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

N = 3
REF_MCA = {"device_plane": "on"}
PORT_MCA = dict(compat.mca_from_reference(REF_MCA),
                device_plane_platform="cpu")
#: '' tolerance per dtype, relative to the operands' magnitudes
DEFAULT_RTOL = {"float32": 1e-5, "float16": 2e-3, "bfloat16": 2e-2}

#: (case name, kind, dtype, op, deterministic or Bcast root)
CASES = [
    # the kernels' dtypes and ops: K3 ('linear') and K1 + K2 (the ring)
    ("ar_f32_sum_linear", "ar", "float32", "SUM", "linear"),
    ("ar_f32_sum_ring", "ar", "float32", "SUM", "ring"),
    ("ar_f32_sum_default", "ar", "float32", "SUM", ""),
    ("ar_bf16_max_ring", "ar", "bfloat16", "MAX", "ring"),
    ("ar_bf16_prod_default", "ar", "bfloat16", "PROD", ""),
    ("ar_i32_prod_linear", "ar", "int32", "PROD", "linear"),
    ("ar_i32_min_default", "ar", "int32", "MIN", ""),
    # the traceable ops outside the kernels: gather, then the fold
    ("ar_f16_sum_linear", "ar", "float16", "SUM", "linear"),
    ("ar_f16_sum_ring", "ar", "float16", "SUM", "ring"),
    ("ar_f16_sum_default", "ar", "float16", "SUM", ""),
    ("ar_u8_sum_ring", "ar", "uint8", "SUM", "ring"),
    ("ar_u8_sum_default", "ar", "uint8", "SUM", ""),
    ("ar_f16_prod_ring", "ar", "float16", "PROD", "ring"),
    ("ar_u8_prod_linear", "ar", "uint8", "PROD", "linear"),
    ("ar_f16_min_linear", "ar", "float16", "MIN", "linear"),
    ("ar_u8_min_ring", "ar", "uint8", "MIN", "ring"),
    ("ar_f16_max_ring", "ar", "float16", "MAX", "ring"),
    ("ar_bool_max_linear", "ar", "bool", "MAX", "linear"),
    ("ar_f32_land_ring", "ar", "float32", "LAND", "ring"),
    ("ar_bool_land_linear", "ar", "bool", "LAND", "linear"),
    ("ar_i32_land_default", "ar", "int32", "LAND", ""),
    ("ar_f16_lor_linear", "ar", "float16", "LOR", "linear"),
    ("ar_u8_lor_ring", "ar", "uint8", "LOR", "ring"),
    ("ar_bool_lor_default", "ar", "bool", "LOR", ""),
    ("ar_bf16_lxor_ring", "ar", "bfloat16", "LXOR", "ring"),
    ("ar_i32_lxor_linear", "ar", "int32", "LXOR", "linear"),
    ("ar_bool_lxor_default", "ar", "bool", "LXOR", ""),
    ("ar_i32_band_ring", "ar", "int32", "BAND", "ring"),
    ("ar_u8_band_linear", "ar", "uint8", "BAND", "linear"),
    ("ar_bool_band_default", "ar", "bool", "BAND", ""),
    ("ar_u8_bor_ring", "ar", "uint8", "BOR", "ring"),
    ("ar_bool_bor_linear", "ar", "bool", "BOR", "linear"),
    ("ar_i32_bor_default", "ar", "int32", "BOR", ""),
    ("ar_i32_bxor_ring", "ar", "int32", "BXOR", "ring"),
    ("ar_bool_bxor_linear", "ar", "bool", "BXOR", "linear"),
    ("ar_u8_bxor_default", "ar", "uint8", "BXOR", ""),
    # Reduce_scatter_block: kernels, then an all-to-all of the own chunk
    # and the fold (a 'ring' logical op needs bool in the reference: its
    # ring_reduce_scatter does not cast)
    ("rs_f32_sum_linear", "rs", "float32", "SUM", "linear"),
    ("rs_f32_sum_ring", "rs", "float32", "SUM", "ring"),
    ("rs_f32_sum_default", "rs", "float32", "SUM", ""),
    ("rs_f16_sum_ring", "rs", "float16", "SUM", "ring"),
    ("rs_f16_sum_default", "rs", "float16", "SUM", ""),
    ("rs_u8_max_linear", "rs", "uint8", "MAX", "linear"),
    ("rs_f16_min_default", "rs", "float16", "MIN", ""),
    ("rs_bool_land_ring", "rs", "bool", "LAND", "ring"),
    ("rs_i32_lor_linear", "rs", "int32", "LOR", "linear"),
    ("rs_bf16_land_default", "rs", "bfloat16", "LAND", ""),
    ("rs_i32_bxor_ring", "rs", "int32", "BXOR", "ring"),
    ("rs_bool_lxor_ring", "rs", "bool", "LXOR", "ring"),
    # the copies
    ("ag_f32", "ag", "float32", None, None),
    ("ag_f16", "ag", "float16", None, None),
    ("ag_bf16", "ag", "bfloat16", None, None),
    ("ag_bool", "ag", "bool", None, None),
    ("ag_u8", "ag", "uint8", None, None),
    ("bc_f32_root0", "bc", "float32", None, 0),
    ("bc_f32_rootlast", "bc", "float32", None, "last"),
    ("bc_bf16_root1", "bc", "bfloat16", None, 1),
    ("bc_bool_rootlast", "bc", "bool", None, "last"),
    ("a2a_i32", "a2a", "int32", None, None),
    ("a2a_bf16", "a2a", "bfloat16", None, None),
    ("a2a_f16", "a2a", "float16", None, None),
]

#: the 4-rank job's cases: the folds whose order shows, and the copies
CASES4 = [c for c in CASES
          if c[1] in ("bc", "a2a") or (c[4] in ("linear", "ring")
                                       and c[2] in ("float16", "float32")
                                       and c[3] in ("SUM", "PROD"))]

#: input maker shared verbatim by both rank programs and the test: float
#: dtypes come as float32 (bfloat16 is cast on each side, float16 here)
_INPUTS = """
def make_input(kind, dtype, rank, size, traps=True):
    rng = np.random.default_rng(1000 * size + rank)
    shape = {"ar": (257,), "rs": (3 * size, 5), "ag": (7, 3),
             "bc": (33,), "a2a": (2 * size, 3)}[kind]
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, shape,
                            dtype=np.int64).astype(np.int32)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)
    if dtype == "bool":
        return rng.random(shape) < 0.6
    h = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-2, 3, shape)).astype(np.float32)
    flat = h.reshape(-1)
    flat[11] = 0.0  # a zero for the logical ops
    if traps:
        flat[9] = -0.0 if rank % 2 else 0.0
        if rank == 1:
            flat[5] = np.nan
    return h.astype(np.float16) if dtype == "float16" else h
"""

_REF_BODY = """
import json
import jax.numpy as jnp
from ompi_tpu import errors, op as O
{inputs}
for name, kind, dtype, op, arg in {cases!r}:
    x = jnp.asarray(make_input(kind, dtype, rank, size,
                               traps=arg != "")).astype(dtype)
    if kind == "ar":
        out = comm.Allreduce(x, op=getattr(O, op), deterministic=arg)
    elif kind == "rs":
        out = comm.Reduce_scatter_block(x, op=getattr(O, op),
                                        deterministic=arg)
    elif kind == "ag":
        out = comm.Allgather(x)
    elif kind == "bc":
        out = comm.Bcast(x, root=size - 1 if arg == "last" else arg)
    else:
        out = comm.Alltoall(x)
    out = np.asarray(out)
    if dtype == "bfloat16":
        out = out.view(np.uint16)
    np.save(f"{out_dir}/ref_{{name}}_r{{rank}}.npy", out)

classes = {{}}
for what, fn in (
        ("alltoall_indivisible", lambda: comm.Alltoall(
            jnp.arange(size + 1, dtype=jnp.int32))),
        ("rsb_indivisible", lambda: comm.Reduce_scatter_block(
            jnp.ones((size + 1, 2), jnp.float32)))):
    try:
        fn()
    except errors.MPIError as e:
        classes[what] = e.error_class
with open(f"{out_dir}/ref_errors_r{{rank}}.json", "w") as fh:
    json.dump(classes, fh)
# the calls the port's coll/device stages or hands to the host collectives:
# a float64 Allreduce (a host buffer here: jax holds no float64) and a
# host-buffer Alltoall
x64 = make_input("ar", "float32", rank, size, traps=False).astype(np.float64)
out = np.empty_like(x64)
comm.Allreduce(x64, out)
np.save(f"{out_dir}/ref_lifted_f64_r{{rank}}.npy", out)
a2a = np.arange(2 * size, dtype=np.int32) + 10 * rank
out = np.empty_like(a2a)
comm.Alltoall(a2a, out)
np.save(f"{out_dir}/ref_lifted_a2a_r{{rank}}.npy", out)
"""

_PORT_PROG = """
import json
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi, op as O
from ompi_tpu_torch.core import pvar
comm = mpi.Init()
rank, size = comm.rank, comm.size
for slot in ("allreduce_dev", "reduce_scatter_block_dev", "allgather_dev",
             "bcast_dev", "alltoall_dev"):
    assert comm.coll.providers[slot] == "device", comm.coll.providers
{inputs}
s = pvar.session()
for name, kind, dtype, op, arg in {cases!r}:
    x = compat.tensor_from_numpy(make_input(kind, dtype, rank, size,
                                            traps=arg != ""))
    x = x.to(getattr(torch, dtype))
    if kind == "ar":
        out = comm.Allreduce(x, op=getattr(O, op), deterministic=arg)
    elif kind == "rs":
        out = comm.Reduce_scatter_block(x, op=getattr(O, op),
                                        deterministic=arg)
    elif kind == "ag":
        out = comm.Allgather(x)
    elif kind == "bc":
        out = comm.Bcast(x, root=size - 1 if arg == "last" else arg)
        # a non-root's buffer receives the root's too
        assert torch.equal(x.view(torch.uint8), out.view(torch.uint8)), name
    else:
        out = comm.Alltoall(x)
    np.save(f"{out_dir}/port_{{name}}_r{{rank}}.npy",
            compat.tensor_to_numpy(out))
assert s.read("coll_device_launches") == len({cases!r})

def error_class(fn):
    try:
        fn()
    except errors.MPIError as e:
        return e.error_class, str(e)
    raise AssertionError("no MPIError raised")

classes = {{}}
for what, fn in (
        ("alltoall_indivisible", lambda: comm.Alltoall(
            torch.arange(size + 1, dtype=torch.int32))),
        ("rsb_indivisible", lambda: comm.Reduce_scatter_block(
            torch.ones(size + 1, 2)))):
    classes[what] = error_class(fn)[0]
with open(f"{out_dir}/port_errors_r{{rank}}.json", "w") as fh:
    json.dump(classes, fh)
# float64 goes to coll/accelerator's staging; a host buffer to coll/tuned
s = pvar.session()
x64 = make_input("ar", "float32", rank, size, traps=False).astype(np.float64)
got = comm.Allreduce(torch.from_numpy(x64))
assert got.dtype == torch.float64 and s.read("coll_accelerator_staged") == 1
np.save(f"{out_dir}/port_lifted_f64_r{{rank}}.npy", got.numpy())
a2a = np.arange(2 * size, dtype=np.int32) + 10 * rank
got = np.empty_like(a2a)
assert comm.Alltoall(a2a, got) is None
np.save(f"{out_dir}/port_lifted_a2a_r{{rank}}.npy", got)
# the port's stated refusals, on every rank
cls, msg = error_class(lambda: comm.Allreduce(torch.ones(4), op=O.MINLOC))
assert cls == errors.ERR_OP and "FLOAT_INT" in msg, msg
assert error_class(lambda: comm.Bcast(torch.ones(4), root=size))[0] \\
    == errors.ERR_ROOT
assert error_class(lambda: comm.Allreduce(
    torch.ones(4), deterministic="tree"))[0] == errors.ERR_ARG
assert error_class(lambda: comm.Allreduce(torch.ones(4), op=O.BXOR))[0] \\
    == errors.ERR_OP
# a recvbuf receives the result too
recv = torch.empty(2 * size, dtype=torch.int32)
out = comm.Alltoall(torch.arange(2 * size, dtype=torch.int32) + 10 * rank,
                    recv)
assert torch.equal(out, recv)
assert torch.equal(out, (torch.arange(2 * rank, 2 * rank + 2).repeat(size)
                    + 10 * torch.arange(size).repeat_interleave(2)).int())
open(f"{out_dir}/port_ok_r{{rank}}.ok", "w").close()
mpi.Finalize()
"""


def _port_job(src: str, n: int, mca) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n, mca=mca,
                                    timeout=120)
    finally:
        os.unlink(path)


def _jobs(d, n, cases):
    run_ranks(_REF_BODY.format(inputs=_INPUTS, cases=cases, out_dir=d), n,
              mca=REF_MCA, timeout=240)
    rc = _port_job(_PORT_PROG.format(inputs=_INPUTS, cases=cases,
                                     out_dir=d), n, PORT_MCA)
    assert rc == 0, f"port job exited {rc}"
    return d


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """Run both packages' 3-rank jobs once; returns the results
    directory."""
    return _jobs(tmp_path_factory.mktemp("coll_device"), N, CASES)


def _inputs(kind, dtype):
    ns = {"np": np}
    exec(_INPUTS, ns)
    xs = [ns["make_input"](kind, dtype, r, N, traps=False) for r in range(N)]
    if dtype == "bfloat16":  # the magnitudes, in float32, of the cast
        import ml_dtypes

        xs = [x.astype(ml_dtypes.bfloat16).astype(np.float32) for x in xs]
    return xs


def _as_float(a, dtype):
    if dtype == "bfloat16":
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64)


def assert_bits_equal(ref, got, what, dtype=""):
    """Bitwise through an unsigned view of each element; where both are
    NaN any payload is accepted (bfloat16 comes as its uint16 bits)."""
    assert ref.dtype == got.dtype and ref.shape == got.shape, \
        (what, ref.dtype, got.dtype, ref.shape, got.shape)
    if dtype == "bfloat16":
        ref, got = _as_float(ref, dtype), _as_float(got, dtype)
    if ref.dtype.kind == "f":
        rn, gn = np.isnan(ref), np.isnan(got)
        np.testing.assert_array_equal(rn, gn, err_msg=f"{what}: NaN places")
        ref, got = ref[~rn], got[~gn]
        u = np.dtype(f"u{ref.dtype.itemsize}")
        ref, got = ref.view(u), got.view(u)
    np.testing.assert_array_equal(ref, got, err_msg=what)


def _cases(pred):
    got = [c for c in CASES if pred(*c[1:])]
    assert got
    return got


def _check_bitwise(out, cases, n=N):
    for name, kind, dtype, *_ in cases:
        for r in range(n):
            ref = np.load(out / f"ref_{name}_r{r}.npy")
            got = np.load(out / f"port_{name}_r{r}.npy")
            assert_bits_equal(ref, got, f"{name} rank {r}", dtype)


@pytest.mark.parametrize("kind", ["ar", "rs"])
def test_deterministic_modes_bitwise(out, kind):
    """'linear' and 'ring': the kernels' dtypes and ops and the fold of
    every other traceable op, bitwise equal to coll/xla's."""
    _check_bitwise(out, _cases(lambda k, dt, op, det: k == kind
                               and det in ("linear", "ring")))


@pytest.mark.parametrize("kind", ["ar", "rs"])
def test_default_mode_within_tolerance(out, kind):
    """'': SUM / PROD within DEFAULT_RTOL of the operands' magnitudes
    (integers exact), every other op exact."""
    for name, k, dtype, op, det in _cases(
            lambda k, dt, op, det: k == kind and det == ""):
        xs = _inputs(kind, dtype)
        for r in range(N):
            ref = np.load(out / f"ref_{name}_r{r}.npy")
            got = np.load(out / f"port_{name}_r{r}.npy")
            assert ref.dtype == got.dtype and ref.shape == got.shape, name
            if op not in ("SUM", "PROD") or dtype not in DEFAULT_RTOL:
                assert_bits_equal(ref, got, f"{name} rank {r}", dtype)
                continue
            mags = [np.abs(x.astype(np.float64)) for x in xs]
            mag = sum(mags) if op == "SUM" else np.prod(mags, axis=0)
            if kind == "rs":
                rows = mag.shape[0] // N
                mag = mag[r * rows:(r + 1) * rows]
            err = np.abs(_as_float(got, dtype) - _as_float(ref, dtype))
            assert (err <= DEFAULT_RTOL[dtype] * mag.reshape(err.shape)
                    + 1e-30).all(), f"{name} rank {r}: {err.max()}"


@pytest.mark.parametrize("kind", ["ag", "bc", "a2a"])
def test_copies_bitwise(out, kind):
    """Allgather, Bcast from roots 0, 1 and n-1, Alltoall: bitwise."""
    _check_bitwise(out, _cases(lambda k, *_: k == kind))


def test_four_ranks_bitwise(tmp_path):
    """On 4 ranks the ring order is told apart from its reverse: the
    float16 / float32 SUM and PROD folds under 'linear' and 'ring', Bcast
    and Alltoall, bitwise."""
    _check_bitwise(_jobs(tmp_path, 4, CASES4), CASES4, 4)


def test_erroneous_calls_on_every_rank(out):
    """An indivisible Alltoall / Reduce_scatter_block raises ERR_COUNT on
    every rank of both packages; the port's refusals (MINLOC on a tensor:
    ERR_OP naming the pair types; a root outside the comm, an unknown
    mode, BXOR on floats) raise their classes on every rank. What this
    test once checked as refused is served now, bitwise equal to the
    reference's host collective: a float64 Allreduce (staged through
    coll/accelerator, counted in coll_accelerator_staged) and a
    host-buffer Alltoall (coll/tuned)."""
    for r in range(N):
        ref = json.loads((out / f"ref_errors_r{r}.json").read_text())
        got = json.loads((out / f"port_errors_r{r}.json").read_text())
        assert ref == got == {"alltoall_indivisible": 2,
                              "rsb_indivisible": 2}
        assert (out / f"port_ok_r{r}.ok").exists()
        for what in ("f64", "a2a"):
            assert_bits_equal(np.load(out / f"ref_lifted_{what}_r{r}.npy"),
                              np.load(out / f"port_lifted_{what}_r{r}.npy"),
                              f"{what} r{r}")


_SINGLETON_REF = """
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax.numpy as jnp
from ompi_tpu import mpi, op as O
comm = mpi.Init()
for c in (comm, mpi.COMM_SELF):
    for slot in ("allreduce_dev", "reduce_scatter_block_dev",
                 "allgather_dev", "bcast_dev", "alltoall_dev"):
        assert c.coll.providers[slot] == "xla", c.coll.providers
x = jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3) - 5.5)
outs = {{}}
for tag, c in (("world", comm), ("self", mpi.COMM_SELF)):
    outs[tag + "_ar"] = c.Allreduce(x, op=O.PROD, deterministic="ring")
    outs[tag + "_rs"] = c.Reduce_scatter_block(x.astype(jnp.float16),
                                               op=O.LAND)
    outs[tag + "_ag"] = c.Allgather(x.astype(jnp.bfloat16))
    outs[tag + "_bc"] = c.Bcast(x.astype(jnp.int32))
    outs[tag + "_a2a"] = c.Alltoall((x + 6).astype(jnp.uint8))
for k, v in outs.items():
    v = np.asarray(v)
    np.save(os.path.join({out!r}, f"ref_{{k}}.npy"),
            v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
mpi.Finalize()
print("OK")
"""

_SINGLETON_PORT = """
import os
import numpy as np
import torch
from ompi_tpu_torch import compat, mpi, op as O
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.runtime import device_plane
comm = mpi.Init()
assert comm.size == 1 and not device_plane.active()
for c in (comm, mpi.COMM_SELF):
    for slot in ("allreduce_dev", "reduce_scatter_block_dev",
                 "allgather_dev", "bcast_dev", "alltoall_dev"):
        assert c.coll.providers[slot] == "device", c.coll.providers
x = torch.arange(12, dtype=torch.float32).reshape(4, 3) - 5.5
outs = {{}}
for tag, c in (("world", comm), ("self", mpi.COMM_SELF)):
    outs[tag + "_ar"] = c.Allreduce(x, op=O.PROD, deterministic="ring")
    outs[tag + "_rs"] = c.Reduce_scatter_block(x.half(), op=O.LAND)
    outs[tag + "_ag"] = c.Allgather(x.bfloat16())
    outs[tag + "_bc"] = c.Bcast(x.int())
    outs[tag + "_a2a"] = c.Alltoall((x + 6).to(torch.uint8))
    # a new tensor: the caller's buffer is not the result
    assert outs[tag + "_ar"].data_ptr() != x.data_ptr()
assert pvar.read("coll_device_launches") == 10
assert pvar.read("device_plane_arenas") == 0
for k, v in outs.items():
    np.save(os.path.join({out!r}, f"port_{{k}}.npy"),
            compat.tensor_to_numpy(v))
mpi.Finalize()
print("OK")
"""


def test_singleton_size1_serves_every_slot(tmp_path):
    """A one-rank world and COMM_SELF outside any launcher, with no
    device plane: every slot served by coll/device on the tensor's own
    device, as the reference's coll/xla serves it."""
    env = dict(os.environ)
    for key in [k for k in env if k.startswith("OMPI_TPU_")]:
        del env[key]
    for src in (_SINGLETON_REF, _SINGLETON_PORT):
        r = subprocess.run([sys.executable, "-c", src.format(out=str(
            tmp_path))], capture_output=True, text=True, timeout=120,
            env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    for tag in ("world", "self"):
        for kind in ("ar", "rs", "ag", "bc", "a2a"):
            ref = np.load(tmp_path / f"ref_{tag}_{kind}.npy")
            got = np.load(tmp_path / f"port_{tag}_{kind}.npy")
            assert_bits_equal(ref, got, f"{tag} {kind}",
                              "bfloat16" if kind == "ag" else "")
    assert np.load(tmp_path / "port_world_ag.npy").shape == (1, 4, 3)
