"""The port's slice end to end against the JAX package.

One job per package and comm size n: the reference runs through
``tests.harness.run_ranks`` with ``device_plane on`` and ``coll_pallas
on``; the port through ``ompi_tpu_torch.runtime.launcher`` with the same
settings mapped by ``compat.mca_from_reference`` plus
``device_plane_platform cpu``. Both ranks make the same inputs from a seed
with numpy, call Allreduce / Reduce_scatter_block / Allgather through the
MPI API, and write every result as a ``.npy`` file; the test compares
them. Under ``linear`` and ``ring`` the results are bitwise equal (NaN
payloads aside); the default mode is held to the tolerance of
coll/pallas's own default-mode test (rtol 1e-5 float32, 2e-2 bfloat16,
exact int32).
"""

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

REF_MCA = {"device_plane": "on", "coll_pallas": "on"}
PORT_MCA = dict(compat.mca_from_reference(REF_MCA),
                device_plane_platform="cpu")

#: (case name, kind, dtype, op, deterministic)
CASES = [
    ("ar_f32_sum_linear", "ar", "float32", "SUM", "linear"),
    ("ar_f32_sum_ring", "ar", "float32", "SUM", "ring"),
    ("ar_f32_sum_default", "ar", "float32", "SUM", None),
    ("ar_bf16_sum_linear", "ar", "bfloat16", "SUM", "linear"),
    ("ar_bf16_sum_ring", "ar", "bfloat16", "SUM", "ring"),
    ("ar_bf16_sum_default", "ar", "bfloat16", "SUM", None),
    ("ar_i32_sum_linear", "ar", "int32", "SUM", "linear"),
    ("ar_i32_sum_ring", "ar", "int32", "SUM", "ring"),
    ("ar_i32_sum_default", "ar", "int32", "SUM", None),
    ("ar_f32_min_ring", "ar", "float32", "MIN", "ring"),
    ("ar_f32_max_linear", "ar", "float32", "MAX", "linear"),
    ("ar_bf16_max_ring", "ar", "bfloat16", "MAX", "ring"),
    ("ar_i32_prod_ring", "ar", "int32", "PROD", "ring"),
    ("rs_f32_sum_linear", "rs", "float32", "SUM", "linear"),
    ("rs_f32_sum_ring", "rs", "float32", "SUM", "ring"),
    ("rs_f32_sum_default", "rs", "float32", "SUM", None),
    ("rs_i32_min_ring", "rs", "int32", "MIN", "ring"),
    ("ag_f32", "ag", "float32", None, None),
    ("ag_bf16", "ag", "bfloat16", None, None),
    # outside the kernels: coll/pallas falls through to coll/xla, coll/cuda
    # to coll/device
    ("ar_f16_sum_linear", "ar", "float16", "SUM", "linear"),
    ("ar_f16_sum_ring", "ar", "float16", "SUM", "ring"),
    ("rs_f16_max_ring", "rs", "float16", "MAX", "ring"),
    ("ag_f16", "ag", "float16", None, None),
]

#: input maker shared verbatim by both rank programs
_INPUTS = """
def make_input(kind, dtype, rank, size):
    rng = np.random.default_rng(1000 * size + rank)
    shape = {"ar": (257,), "rs": (3 * size, 5), "ag": (7, 3)}[kind]
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, shape,
                            dtype=np.int64).astype(np.int32)
    h = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)
    flat = h.reshape(-1)
    flat[9] = -0.0 if rank % 2 else 0.0
    if rank == 1:
        flat[5] = np.nan
    return h
"""

_REF_BODY = """
import jax.numpy as jnp
OPS = {{"SUM": mpi.SUM, "PROD": mpi.PROD, "MIN": mpi.MIN, "MAX": mpi.MAX}}
{inputs}
for name, kind, dtype, op, det in {cases!r}:
    x = jnp.asarray(make_input(kind, dtype, rank, size)).astype(dtype)
    if kind == "ar":
        out = comm.Allreduce(x, op=OPS[op], deterministic=det)
    elif kind == "rs":
        out = comm.Reduce_scatter_block(x, op=OPS[op], deterministic=det)
    else:
        out = comm.Allgather(x)
    out = np.asarray(out)
    if dtype == "bfloat16":
        out = out.view(np.uint16)
    np.save(f"{out_dir}/ref_{{name}}_r{{rank}}.npy", out)
# the port stages a float64 tensor through the host collectives: the
# reference's host Allreduce of the same values (jax holds no float64)
out = np.empty(8)
comm.Allreduce(np.arange(8, dtype=np.float64) * 0.3 * (rank + 1), out)
np.save(f"{out_dir}/ref_lifted_f64_r{{rank}}.npy", out)
out = np.empty(4, np.float32)
comm.Allreduce(np.ones(4, np.float32) * (rank + 1), out)
np.save(f"{out_dir}/ref_lifted_host_r{{rank}}.npy", out)
"""

_PORT_PROG = """
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi
from ompi_tpu_torch.core import pvar
comm = mpi.Init()
rank, size = comm.rank, comm.size
assert comm.coll.providers["allreduce_dev"] == "cuda", comm.coll.providers
OPS = {{"SUM": mpi.SUM, "PROD": mpi.PROD, "MIN": mpi.MIN, "MAX": mpi.MAX}}
{inputs}
for name, kind, dtype, op, det in {cases!r}:
    x = compat.tensor_from_numpy(make_input(kind, dtype, rank, size))
    x = x.to(getattr(torch, dtype))
    if kind == "ar":
        out = comm.Allreduce(x, op=OPS[op], deterministic=det)
    elif kind == "rs":
        out = comm.Reduce_scatter_block(x, op=OPS[op], deterministic=det)
    else:
        out = comm.Allgather(x)
    np.save(f"{out_dir}/port_{{name}}_r{{rank}}.npy",
            compat.tensor_to_numpy(out))

def expect_error(cls, fn):
    try:
        fn()
    except errors.MPIError as e:
        assert e.error_class == cls, e
        return str(e)
    raise AssertionError("no MPIError raised")

# a dtype outside the kernels and a forced 'xla' return coll/device's
# result and count the fallthrough
from ompi_tpu_torch.coll import device
from ompi_tpu_torch.core import cvar
s = pvar.session()
x = torch.arange(8, dtype=torch.float16) * (rank + 1)
assert torch.equal(comm.Allreduce(x, deterministic="ring"),
                   device.allreduce_dev(comm, x, deterministic="ring"))
assert s.read("coll_cuda_fallthrough") == 1
cvar.set("coll_cuda_allreduce_algorithm", "xla")
x = torch.arange(8, dtype=torch.float32) + rank
got = comm.Allreduce(x, deterministic="linear")
cvar.set("coll_cuda_allreduce_algorithm", "")
assert torch.equal(got, device.allreduce_dev(comm, x,
                                             deterministic="linear"))
assert s.read("coll_cuda_fallthrough") == 2
assert s.read("coll_cuda_launches") == 0

s = pvar.session()
got = comm.Allreduce(torch.arange(8, dtype=torch.float64) * 0.3 * (rank + 1))
np.save(f"{out_dir}/port_lifted_f64_r{{rank}}.npy", got.numpy())
assert s.read("coll_cuda_fallthrough") == 1
assert s.read("coll_accelerator_staged") == 1
assert s.read("coll_cuda_launches") == 0
expect_error(errors.ERR_COUNT, lambda: comm.Reduce_scatter_block(
    torch.ones(3 * size + 1, 2)))
out = np.empty(4, np.float32)
assert comm.Allreduce(np.ones(4, np.float32) * (rank + 1), out) is None
np.save(f"{out_dir}/port_lifted_host_r{{rank}}.npy", out)
open(f"{out_dir}/port_errors_r{{rank}}.ok", "w").close()
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


_jobs = {}


@pytest.fixture(params=[2, 3, 4], scope="module")
def results(request, tmp_path_factory):
    """Run both packages' jobs once per n; returns (n, out_dir)."""
    n = request.param
    if n not in _jobs:
        out = tmp_path_factory.mktemp(f"slice_n{n}")
        run_ranks(_REF_BODY.format(inputs=_INPUTS, cases=CASES,
                                   out_dir=out), n, mca=REF_MCA,
                  timeout=240)
        rc = _port_job(_PORT_PROG.format(inputs=_INPUTS, cases=CASES,
                                         out_dir=out), n, PORT_MCA)
        assert rc == 0, f"port job exited {rc}"
        _jobs[n] = out
    return n, _jobs[n]


def _pair(out, name, r):
    return (np.load(out / f"ref_{name}_r{r}.npy"),
            np.load(out / f"port_{name}_r{r}.npy"))


def _check(results, kinds, dets):
    n, out = results
    seen = 0
    for name, kind, dtype, op, det in CASES:
        if kind not in kinds or det not in dets:
            continue
        for r in range(n):
            ref, got = _pair(out, name, r)
            assert ref.shape == got.shape, (name, ref.shape, got.shape)
            if det is None and kind != "ag" and dtype != "int32":
                f = (lambda a: (a.astype(np.uint32) << 16).view(np.float32)) \
                    if dtype == "bfloat16" else (lambda a: a)
                np.testing.assert_allclose(
                    f(got), f(ref), rtol=2e-2 if dtype == "bfloat16"
                    else 1e-5, atol=1e-5, err_msg=name)
            else:
                assert_bits_equal(ref, got, f"{name} rank {r}")
            seen += 1
    assert seen


def test_allreduce_deterministic_bitwise(results):
    _check(results, {"ar"}, {"linear", "ring"})


def test_allreduce_default_within_tolerance(results):
    _check(results, {"ar"}, {None})


def test_reduce_scatter_block(results):
    _check(results, {"rs"}, {"linear", "ring", None})


def test_allgather_exact(results):
    _check(results, {"ag"}, {None})


def test_error_paths(results):
    """float16 and a forced 'xla' fall through to coll/device (its result,
    counted in coll_cuda_fallthrough); indivisible Reduce_scatter_block ->
    ERR_COUNT (asserted inside the port job, on every rank). Once refused
    and served now: float64 falls through coll/cuda and coll/device to
    coll/accelerator's staging (coll_accelerator_staged), and a host
    buffer runs coll/tuned; both equal the reference's host Allreduce
    bitwise."""
    n, out = results
    for r in range(n):
        assert (out / f"port_errors_r{r}.ok").exists()
        for what in ("f64", "host"):
            ref = np.load(out / f"ref_lifted_{what}_r{r}.npy")
            got = np.load(out / f"port_lifted_{what}_r{r}.npy")
            assert ref.dtype == got.dtype and np.array_equal(
                ref.view(np.uint8), got.view(np.uint8)), (what, r)


def test_coll_cuda_off_leaves_device_serving(tmp_path):
    """Without coll_cuda the coll/xla counterpart (no opt-in) serves every
    device slot it has; the fused slots stay coll/cuda's alone."""
    rc = _port_job(f"""
    import torch
    from ompi_tpu_torch import mpi
    comm = mpi.Init()
    for slot in ("allreduce_dev", "reduce_scatter_block_dev",
                 "allgather_dev", "bcast_dev", "alltoall_dev",
                 "reduce_scatter_multi_dev"):
        assert comm.coll.providers[slot] == "device", comm.coll.providers
    assert "fused_rs_update_dev" not in comm.coll.providers
    x = torch.arange(4, dtype=torch.float32) * (comm.rank + 1)
    for det in ("linear", "ring", None):
        out = comm.Allreduce(x, deterministic=det)
        assert torch.equal(out, torch.arange(4.0) * 3), (det, out)
    open("{tmp_path}/r%d.ok" % comm.rank, "w").close()
    mpi.Finalize()
    """, 2, {"device_plane": "on", "device_plane_platform": "cpu"})
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["r0.ok", "r1.ok"]


@pytest.mark.parametrize("mode", ["linear", "ring"])
def test_one_determinism_cvar_drives_both_components(tmp_path, mode):
    """``coll_device_deterministic`` alone (as coll_xla_deterministic
    alone drives coll/xla and coll/pallas) sets the mode coll/cuda runs,
    the mode it hands coll/device on a fallthrough, and the mode of the
    zero/ slots: a forced 'xla' Allreduce equals coll/cuda's own, a
    float16 Allreduce folds in the cvar's order, and ZeroOptimizer's
    fused step equals its unfused step. Three ranks, so the ring's order
    and the rank order give different bits (checked)."""
    rc = _port_job(f"""
    import numpy as np
    import torch
    from ompi_tpu_torch import mpi
    from ompi_tpu_torch.coll import device
    from ompi_tpu_torch.core import cvar, pvar
    from ompi_tpu_torch.zero import ZeroOptimizer, layout as zl
    comm = mpi.Init()
    rank, mode = comm.rank, {mode!r}
    other = "ring" if mode == "linear" else "linear"

    def inp(seed, dtype, n=257):
        rng = np.random.default_rng(seed)
        h = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3, n)
        return torch.from_numpy(h.astype(np.float32)).to(dtype)

    s = pvar.session()
    x = inp(10 + rank, torch.float32)
    ref = comm.Allreduce(x)
    assert s.read("coll_cuda_fallthrough") == 0
    assert torch.equal(ref, comm.Allreduce(x, deterministic=mode))
    assert not torch.equal(ref, comm.Allreduce(x, deterministic=other))
    cvar.set("coll_cuda_allreduce_algorithm", "xla")
    try:
        got = comm.Allreduce(x)
    finally:
        cvar.set("coll_cuda_allreduce_algorithm", "")
    assert s.read("coll_cuda_fallthrough") == 1
    assert torch.equal(got, ref), mode

    h = inp(20 + rank, torch.float16)
    got = comm.Allreduce(h)
    assert s.read("coll_cuda_fallthrough") == 2
    assert torch.equal(got, device.allreduce_dev(comm, h, deterministic=mode))
    assert not torch.equal(got, device.allreduce_dev(comm, h,
                                                     deterministic=other))

    params = {{"w": inp(1, torch.float32, 35).view(5, 7),
               "b": inp(2, torch.float32, 13)}}
    def run(fused, det=None):
        opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9,
                            deterministic=det, fused=fused)
        s = pvar.session()
        for step in range(2):
            out = opt.step({{"w": inp(100 + 10 * rank + step, torch.float32,
                                     35).view(5, 7),
                             "b": inp(200 + 10 * rank + step, torch.float32,
                                      13)}})
        assert (s.read("coll_cuda_fused_launches") > 0) == fused
        return zl.tree_leaves(out)
    unfused, fused = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(unfused, fused)), mode
    assert not all(torch.equal(a, b)
                   for a, b in zip(unfused, run(False, other)))
    open("{tmp_path}/r%d.ok" % rank, "w").close()
    mpi.Finalize()
    """, 3, {"device_plane": "on", "device_plane_platform": "cpu",
             "coll_cuda": "on", "coll_device_deterministic": mode})
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["r0.ok", "r1.ok", "r2.ok"]


def test_cuda_platform_without_gpu_fails_init_on_every_rank(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: Init succeeds here")
    rc = _port_job(f"""
    from ompi_tpu_torch import errors, mpi
    from ompi_tpu_torch.runtime import rte
    try:
        mpi.Init()
    except errors.MPIError as e:
        assert e.error_class == errors.ERR_INTERN, e
        assert "is_available() is false" in str(e), e
        open("{tmp_path}/r%d.raised" % rte.rank, "w").close()
    else:
        raise AssertionError("Init on platform cuda without a GPU passed")
    """, 3, {"device_plane": "on", "coll_cuda": "on"})
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == [f"r{r}.raised" for r in range(3)]
