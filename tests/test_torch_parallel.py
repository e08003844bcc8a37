"""The port's parallel/ (mesh of ranks, axis collectives and their
gradients, ring schedules over permute_dev) against the JAX package's
``ompi_tpu.parallel``.

One case table (:data:`_TABLE`, source text) runs in both packages on
the same seeded numpy inputs: the reference in this process, each case a
``shard_map`` over a 4- or 3-device sub-mesh of the 8 virtual CPU
devices, and the port in one launcher job per rank count (``--mca
device_plane on --mca device_plane_platform cpu``), each case through
``DeviceCommunicator.run`` and ``assemble``. The 4-rank job carries every
case (the counterparts of ``tests/test_parallel.py``'s cases, the 2 x 2
sub-communicators among them, the dtype matrix and the backwards); the
3-rank job the ones whose ring order or zero pad shows on an odd ring.

Tolerances: bitwise for data movement, 'linear', 'ring', the prefix
ops and integer dtypes, on float32, bfloat16 and int32; '' float
reductions (the reference's psum against the port's ring) within
``DEFAULT_RTOL`` of the operands' magnitudes. Every backward (jax.vjp of
the reference inside ``shard_map(check_vma=False)``, against
``Tensor.backward`` through the port's autograd Functions) is bitwise:
the inputs and cotangents are small integers, exact in any order.
"""

import json
import math
import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ompi_tpu.parallel import (  # noqa: E402
    DeviceCommunicator as RefDeviceCommunicator, collectives as RC,
    make_mesh as ref_make_mesh, mesh_shape_for as ref_mesh_shape_for,
    ring as RR,
)
from ompi_tpu import op as ROP  # noqa: E402
from ompi_tpu.util import jaxcompat  # noqa: E402
from ompi_tpu_torch import compat  # noqa: E402
from ompi_tpu_torch.parallel import (  # noqa: E402
    DeviceCommunicator, mesh as port_mesh, mesh_shape_for,
)
from ompi_tpu_torch.runtime import launcher as port_launcher  # noqa: E402

PORT_MCA = dict(compat.mca_from_reference({"device_plane": "on"}),
                device_plane_platform="cpu")
#: '' float reductions, relative to the sum of the operands' magnitudes
DEFAULT_RTOL = {"float32": 1e-6, "bfloat16": 3e-3}

#: The case table, evaluated in both packages. ``table(C, ring, O, P,
#: N, zeros)`` returns dicts: ``name``, ``fn`` (the per-rank body),
#: ``mesh`` ("x": a 1-D mesh of N ranks, "2d": ("dp", "tp") of 2 x 2),
#: ``ins`` / ``out`` specs, ``x`` (a numpy input: float32 or int32),
#: ``dtype`` (the cast each side applies), ``check`` ("bits" or "tol"),
#: ``ct`` (a cotangent for the backward, or None) and ``n3`` (also run
#: on 3 ranks).
_TABLE = '''
def table(C, ring, O, P, N, zeros):
    rng = np.random.default_rng(1234 + N)
    out = []

    def case(name, fn, x, dtype="float32", ins=None, out_=None,
             check="bits", ct=None, n3=False, mesh="x"):
        out.append(dict(name=name, fn=fn, x=x, dtype=dtype,
                        ins=P("x") if ins is None else ins,
                        out=P("x") if out_ is None else out_, check=check,
                        ct=ct, n3=n3, mesh=mesh))

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    # tests/test_parallel.py's cases
    case("allreduce_sum", lambda a: C.allreduce(a, "x"),
         np.arange(N * 3, dtype=np.float32).reshape(N, 3), check="tol")
    for name in ("MAX", "MIN", "PROD"):
        case(f"allreduce_{name.lower()}",
             lambda a, op=getattr(O, name): C.allreduce(a, "x", op),
             rng.uniform(0.5, 1.5, (N, 4)).astype(np.float32),
             check="tol" if name == "PROD" else "bits")
    case("allreduce_band", lambda a: C.allreduce(a, "x", O.BAND),
         np.arange(N * 2, dtype=np.int32).reshape(N, 2) + 7,
         dtype="int32")
    case("allreduce_linear_bit_identical",
         lambda a: C.allreduce(a, "x", deterministic="linear"),
         normal(N, 257, scale=1e3), n3=True)
    case("allreduce_ring_deterministic",
         lambda a: C.allreduce(a, "x", deterministic="ring"),
         normal(N, 100), n3=True)
    case("allreduce_ring_run_to_run",
         lambda a: C.allreduce(a, "x", deterministic="ring")
         - C.allreduce(a, "x", deterministic="ring"), normal(N, 100))
    case("ring_allreduce_nondivisible",
         lambda a: ring.ring_allreduce(a[0], "x")[None],
         normal(N, 1, 13), n3=True)
    case("reduce_scatter",
         lambda a: C.reduce_scatter(a[0, 0], "x")[None, None],
         np.arange(N * N * 2, dtype=np.float32).reshape(N, 1, N * 2),
         check="tol")
    case("reduce_scatter_ring",
         lambda a: C.reduce_scatter(a[0, 0], "x",
                                    deterministic="ring")[None, None],
         np.arange(N * N, dtype=np.float32).reshape(N, 1, N), n3=True)
    case("reduce_scatter_linear_bit_identical",
         lambda a: C.reduce_scatter(a[0, 0], "x",
                                    deterministic="linear")[None, None],
         normal(N, 1, N * 3, scale=1e3), n3=True)
    case("allgather", lambda a: C.allgather(a, "x"),
         np.arange(N * 2, dtype=np.float32).reshape(N, 2), out_=P())
    case("ring_allgather",
         lambda a: ring.ring_allgather(a[0, 0], "x")[None, None],
         np.arange(N * 3, dtype=np.float32).reshape(N, 1, 3), n3=True)
    case("alltoall", lambda a: C.alltoall(a[0, 0], "x", 0, 0)[None, None],
         np.arange(N * N, dtype=np.int32).reshape(N, 1, N), dtype="int32",
         n3=True)
    case("bcast", lambda a: C.bcast(a, "x", root=N - 1),
         np.arange(N * 4, dtype=np.float32).reshape(N, 4), n3=True)
    case("scatter", lambda a: C.scatter(a[0, 0], "x",
                                        root=min(2, N - 1))[None, None],
         np.arange(N * N, dtype=np.float32).reshape(N, 1, N), n3=True)
    case("scan", lambda a: C.scan(a, "x"),
         np.arange(N * 2, dtype=np.float32).reshape(N, 2) + 1, n3=True)
    case("exscan", lambda a: C.exscan(a, "x"),
         np.arange(N * 2, dtype=np.float32).reshape(N, 2) + 1, n3=True)
    case("exscan_identity", lambda a: C.exscan(a, "x", O.PROD, 1.0),
         np.arange(N * 2, dtype=np.float32).reshape(N, 2) + 1)
    case("shift", lambda a: C.shift(a, "x", 1),
         np.arange(N, dtype=np.int32).reshape(N, 1), dtype="int32",
         n3=True)
    case("shift_back_2", lambda a: C.shift(a, "x", -2),
         normal(N, 5), n3=True)

    def scan_body(a):
        def body(s, src, blk, carry):
            return carry + blk * (s + 1)
        return ring.ring_scan(body, zeros((N,)), a[0], "x")[None]
    case("ring_scan_visits_all_blocks_in_ring_order", scan_body,
         np.eye(N, dtype=np.float32)[:, None, :], n3=True)
    case("barrier_and_rank",
         lambda a: C.barrier("x") + C.axis_index("x") + a[0] * 0,
         np.zeros((N, 1), np.int32), dtype="int32")
    # ppermute with a partial permutation: no source -> zeros
    case("ppermute_partial",
         lambda a: C.ppermute(a, "x", [(0, 1), (1, 2), (N - 1, 0)]),
         normal(N, 6), n3=True)
    case("ppermute_tuple",
         lambda a: C.ppermute((a, a * 2), "x",
                              [(i, (i + 1) % N) for i in range(N)])[1],
         normal(N, 3))
    # the dtype matrix: bitwise for 'linear', 'ring', the copies and
    # integers; '' within DEFAULT_RTOL for floats
    for dt in ("float32", "bfloat16", "int32"):
        if dt == "int32":
            x = rng.integers(-1000, 1000, (N, 2 * N, 3)).astype(np.int32)
        else:
            x = normal(N, 2 * N, 3, scale=10.0)
        tol = "bits" if dt == "int32" else "tol"
        for det in ("linear", "ring", None):
            tag = det or "default"
            case(f"allreduce_{dt}_{tag}",
                 lambda a, det=det: C.allreduce(a[0], "x",
                                                deterministic=det)[None],
                 x, dt, check="bits" if det else tol,
                 n3=det is not None)
            case(f"reduce_scatter_{dt}_{tag}",
                 lambda a, det=det: C.reduce_scatter(
                     a[0], "x", deterministic=det)[None],
                 x, dt, check="bits" if det else tol,
                 n3=det is not None)
        case(f"allreduce_{dt}_max_ring",
             lambda a: C.allreduce(a[0], "x", O.MAX, "ring")[None], x, dt)
        case(f"allgather_{dt}_dim1",
             lambda a: C.allgather(a[0], "x", gather_dim=1)[None], x, dt)
        case(f"allgather_{dt}_untiled",
             lambda a: C.allgather(a[0], "x", tiled=False,
                                   gather_dim=1)[None], x, dt)
        case(f"alltoall_{dt}_split0_concat1",
             lambda a: C.alltoall(a[0], "x", 0, 1)[None], x, dt, n3=True)
        case(f"bcast_{dt}", lambda a: C.bcast(a, "x", root=1), x, dt)
        case(f"gather_{dt}", lambda a: C.gather(a[0], "x", dim=1)[None],
             x, dt)
        case(f"shift_{dt}", lambda a: C.shift(a, "x", 1), x, dt)
        case(f"scan_{dt}", lambda a: C.scan(a, "x"), x, dt, n3=True)
    # Ulysses' exchanges: q/k/v stacked, heads split at dim 3 and the
    # sequence gathered at dim 2; the inverse splits dim 1, gathers dim 2
    for dt in ("float32", "bfloat16"):
        case(f"alltoall_ulysses_qkv_{dt}",
             lambda a: C.alltoall(a[0], "x", 3, 2)[None],
             normal(N, 3, 2, 2, 2 * N, 3), dt, n3=True)
        case(f"alltoall_heads_to_seq_{dt}",
             lambda a: C.alltoall(a[0], "x", 1, 2)[None],
             normal(N, 2, 2 * N, 2, 3), dt, n3=True)
    case("reduce_scatter_untiled",
         lambda a: C.reduce_scatter(a[0], "x", tiled=False,
                                    scatter_dim=1)[None],
         np.arange(N * 2 * N, dtype=np.float32).reshape(N, 2, N),
         check="tol")
    case("reduce_scatter_max_dim1",
         lambda a: C.reduce_scatter(a[0], "x", O.MAX, scatter_dim=1)[None],
         normal(N, 2, 2 * N))
    # the 2 x 2 mesh: sub-communicators and a tuple of axes' rank order
    if N == 4:
        case("subcomm_dp", lambda a: C.allreduce(a, "dp"),
             np.arange(4, dtype=np.float32).reshape(2, 2), mesh="2d",
             ins=P("dp", "tp"), out_=P("dp", "tp"))
        case("subcomm_tp", lambda a: C.allreduce(a, "tp"),
             np.arange(4, dtype=np.float32).reshape(2, 2), mesh="2d",
             ins=P("dp", "tp"), out_=P("dp", "tp"))
        case("subcomm_world", lambda a: C.allreduce(a, ("dp", "tp")),
             np.arange(4, dtype=np.float32).reshape(2, 2), mesh="2d",
             ins=P("dp", "tp"), out_=P("dp", "tp"))
        case("tuple_axes_rank_order",
             lambda a: C.axis_index(("tp", "dp")) + a * 0,
             np.zeros((2, 2), np.int32), "int32", mesh="2d",
             ins=P("dp", "tp"), out_=P("dp", "tp"))
        case("tuple_axes_allgather_order",
             lambda a: C.allgather(a, ("tp", "dp")),
             np.arange(4, dtype=np.float32).reshape(2, 2) + 10, mesh="2d",
             ins=P("dp", "tp"), out_=P())
        case("tuple_axes_linear_fold",
             lambda a: C.allreduce(a, ("tp", "dp"), deterministic="linear"),
             normal(2, 2, scale=1e3), mesh="2d", ins=P("dp", "tp"),
             out_=P("dp", "tp"))
        case("spec_both_axes_on_dim0", lambda a: C.allreduce(a, "tp"),
             np.arange(8, dtype=np.float32).reshape(4, 2), mesh="2d",
             ins=P(("dp", "tp")), out_=P(("dp", "tp")))

    # backwards: small-integer inputs and cotangents (exact in any order)
    def ints(*shape):
        return rng.integers(-8, 9, shape).astype(np.float32)
    case("grad_region_enter", lambda a: C.region_enter(a, "x") * 3.0,
         ints(N, 3), ct=ints(N, 3))
    case("grad_region_exit", lambda a: C.region_exit(a * 2.0, "x"),
         ints(N, 3), ct=ints(N, 3))
    case("grad_allreduce_sum", lambda a: C.allreduce(a * a, "x"),
         ints(N, 3), ct=ints(N, 3))
    case("grad_allreduce_sum_linear",
         lambda a: C.allreduce(a, "x", deterministic="linear"),
         ints(N, 3), ct=ints(N, 3))
    case("grad_allgather", lambda a: C.allgather(a, "x"),
         ints(N, 3), ct=ints(N * N, 3))
    case("grad_allgather_untiled",
         lambda a: C.allgather(a[0], "x", tiled=False, gather_dim=1)[None],
         ints(N, 2, 3), ct=ints(N, 2, N, 3))
    case("grad_reduce_scatter_sum",
         lambda a: C.reduce_scatter(a[0], "x")[None],
         ints(N, 2 * N), ct=ints(N, 2))
    case("grad_alltoall", lambda a: C.alltoall(a[0], "x", 0, 1)[None],
         ints(N, N, 2), ct=ints(N, 1, 2 * N))
    case("grad_ppermute",
         lambda a: C.ppermute(a, "x", [(0, 1), (1, 2), (N - 1, 0)]),
         ints(N, 3), ct=ints(N, 3))
    case("grad_shift", lambda a: C.shift(a * a, "x", 1),
         ints(N, 3), ct=ints(N, 3))
    return out
'''

_PORT_PROG = """
import json
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi, op as O
from ompi_tpu_torch.parallel import (DeviceCommunicator, P, collectives as C,
                                     make_mesh, ring)
from ompi_tpu_torch.parallel.device_comm import assemble, local_block
world = mpi.Init()
N = world.size
meshes = {{"x": make_mesh(("x",), (N,))}}
if N == 4:
    meshes["2d"] = make_mesh(("dp", "tp"), (2, 2))
out_dir = {out_dir!r}
{table}

def tensor(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))

def zeros(shape):
    return torch.zeros(shape)

for c in table(C, ring, O, P, N, zeros):
    if N == 3 and not c["n3"]:
        continue
    mesh = meshes[c["mesh"]]
    dc = DeviceCommunicator(mesh, mesh.axis_names[0])
    x = tensor(c["x"], c["dtype"])
    if c["ct"] is None:
        got = dc.assemble(dc.run(c["fn"], c["ins"])(x), c["out"])
    else:
        xl = local_block(mesh, x, c["ins"]).requires_grad_()
        with mesh:
            y = c["fn"](xl)
        y.backward(local_block(mesh, tensor(c["ct"], "float32"), c["out"]))
        got = assemble(mesh, y.detach(), c["out"])
        grad = assemble(mesh, xl.grad, c["ins"])
        if world.rank == 0:
            np.save(f"{{out_dir}}/{{c['name']}}.grad.npy", grad)
    if world.rank == 0:
        np.save(f"{{out_dir}}/{{c['name']}}.npy", got)

# the argument errors, on every rank: MPIError(ERR_ARG) with the text
def err(fn):
    try:
        with meshes["x"]:
            fn()
    except errors.MPIError as e:
        return [e.error_class, str(e)]
    return None

x = torch.ones(N + 1, 2)
errs = {{
    "bad_mode": err(lambda: C.allreduce(x, "x", deterministic="tree")),
    "rs_indivisible": err(lambda: C.reduce_scatter(x, "x")),
    "ring_rs_indivisible": err(lambda: ring.ring_reduce_scatter(x, "x")),
    "ring_rs_dim1": err(lambda: C.reduce_scatter(
        torch.ones(N, N), "x", scatter_dim=1, deterministic="ring")),
    "a2a_indivisible": err(lambda: C.alltoall(x, "x")),
    "bad_perm": err(lambda: C.ppermute(x, "x", [(0, 1), (1, 1)])),
    "bad_axis": err(lambda: C.allreduce(x, "y")),
    "mesh_too_big": err(lambda: make_mesh(("a",), (N + 1,))),
}}
with open(f"{{out_dir}}/errors_r{{world.rank}}.json", "w") as fh:
    json.dump(errs, fh)
mpi.Finalize()
"""


def _port_job(n: int, out_dir: str) -> None:
    src = textwrap.dedent(_PORT_PROG).format(out_dir=out_dir,
                                             table=_TABLE)
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    try:
        rc = port_launcher.launch([sys.executable, path], n, mca=PORT_MCA,
                                  timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job on {n} ranks exited {rc}"


def _table(n: int):
    ns = {"np": np}
    exec(_TABLE, ns)
    return ns["table"](RC, RR, ROP, JP, n, lambda s: jnp.zeros(s,
                                                               jnp.float32))


def _names(n: int):
    return [c["name"] for c in _table(n) if n == 4 or c["n3"]]


@pytest.fixture(scope="module")
def port4(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel4")
    _port_job(4, str(d))
    return d


@pytest.fixture(scope="module")
def port3(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel3")
    _port_job(3, str(d))
    return d


_MESHES = {}


def _ref_mesh(n: int, kind: str):
    key = (n, kind)
    if key not in _MESHES:
        if len(jax.devices()) < n:
            pytest.skip(f"needs {n} devices")
        if kind == "x":
            _MESHES[key] = ref_make_mesh(("x",), (n,), jax.devices()[:n])
        else:
            _MESHES[key] = ref_make_mesh(("dp", "tp"), (2, 2),
                                         jax.devices()[:4])
    return _MESHES[key]


def _jnp(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _reference(c, n):
    mesh = _ref_mesh(n, c["mesh"])
    f = jaxcompat.shard_map(c["fn"], mesh=mesh, in_specs=(c["ins"],),
                            out_specs=c["out"], check_vma=False)
    x = _jnp(c["x"], c["dtype"])
    if c["ct"] is None:
        return _np(jax.jit(f)(x)), None
    y, vjp = jax.vjp(f, x)
    return _np(y), _np(vjp(jnp.asarray(c["ct"]))[0])


def _as_float(a, dtype):
    if dtype == "bfloat16":
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64)


def _check(c, ref, got, what):
    assert ref.shape == got.shape and ref.dtype == got.dtype, \
        (what, ref.shape, got.shape, ref.dtype, got.dtype)
    if c["check"] == "bits":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    x = _as_float(_np(_jnp(c["x"], c["dtype"])), c["dtype"])
    mag = np.abs(x).sum() if x.size else 0.0
    rtol = DEFAULT_RTOL[c["dtype"]] if c["dtype"] in DEFAULT_RTOL else 0
    err = np.abs(_as_float(got, c["dtype"]) - _as_float(ref, c["dtype"]))
    assert (err <= rtol * mag).all(), f"{what}: max err {err.max()}"


def _run_case(name, n, out):
    c = next(c for c in _table(n) if c["name"] == name)
    ref, ref_grad = _reference(c, n)
    got = np.load(out / f"{name}.npy")
    _check(c, ref, got, f"{name} n={n}")
    if c["ct"] is not None:
        grad = np.load(out / f"{name}.grad.npy")
        assert grad.dtype == ref_grad.dtype and grad.shape == ref_grad.shape
        np.testing.assert_array_equal(grad, ref_grad,
                                      err_msg=f"{name} backward n={n}")


@pytest.mark.parametrize("name", _names(4))
def test_four_ranks(port4, name):
    """Every case on 4 ranks against the reference on a 4-device mesh."""
    _run_case(name, 4, port4)


@pytest.mark.parametrize("name", _names(3))
def test_three_ranks(port3, name):
    """The ring-order, zero-pad and odd-ring cases on 3 ranks."""
    _run_case(name, 3, port3)


def test_argument_errors_on_every_rank(port4):
    """The reference's ValueErrors and asserts are MPIError(ERR_ARG) in
    the port, with the reference's text where it has one, on every rank."""
    from ompi_tpu_torch import errors

    for r in range(4):
        got = json.loads((port4 / f"errors_r{r}.json").read_text())
        for what, e in got.items():
            assert e is not None and e[0] == errors.ERR_ARG, (r, what, e)
        assert "expected None, 'ring' or 'linear'" in got["bad_mode"][1]
        assert "not divisible by 4" in got["ring_rs_indivisible"][1]
        assert "ring reduce_scatter: dim 0 only" in got["ring_rs_dim1"][1]
        assert "needs 5 devices, have 4" in got["mesh_too_big"][1]


@pytest.mark.parametrize("naxes", [1, 2, 3])
def test_mesh_shape_for(naxes):
    """The same factors as the reference for 1-16 ranks."""
    for n in range(1, 17):
        assert mesh_shape_for(n, naxes) == ref_mesh_shape_for(n, naxes), n


@pytest.mark.parametrize("shape,names,axis", [
    ((4, 2), ("dp", "tp"), "tp"), ((4, 2), ("dp", "tp"), "dp"),
    ((4, 2), ("dp", "tp"), ("dp", "tp")), ((4, 2), ("dp", "tp"),
                                           ("tp", "dp")),
    ((2, 2, 2), ("a", "b", "c"), ("a", "c")), ((2, 2, 2), ("a", "b", "c"),
                                               "b")])
def test_replica_groups(shape, names, axis):
    """The same rank groups as the reference's replica_groups (no ranks
    needed: a mesh with no communicator)."""
    if len(jax.devices()) < math.prod(shape):
        pytest.skip("needs 8 devices")
    ref = RefDeviceCommunicator(ref_make_mesh(names, shape), axis)
    m = port_mesh.Mesh(np.arange(math.prod(shape)).reshape(shape), names,
                       None)
    port = DeviceCommunicator(m, axis)
    assert port.replica_groups() == [[int(i) for i in g]
                                     for g in ref.replica_groups()]
    assert port.size == ref.size
