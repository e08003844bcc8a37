"""The port's parallel/hierarchical (the two-level compositions, the
rank-order forms, the compressed DCN transport and ``wire_quantize``)
against the JAX package's ``ompi_tpu.parallel.hierarchical``.

One case table (:data:`_TABLE`, source text) runs in both packages on the
same seeded numpy inputs: the reference in this process, each case a
``shard_map`` over a 2 x 2 and a 3 x 2 ``("dcn", "ici")`` sub-mesh of the
8 virtual CPU devices (``hier_mesh(n_slices=...)``); the port in one
4-rank and one 6-rank launcher job (``--mca device_plane on --mca
device_plane_platform cpu``), each case through ``DeviceCommunicator.run``
on ``hier_mesh(comm, n_slices)`` and ``assemble``. The table holds the
counterparts of ``tests/test_hierarchical.py``'s composition tests and
the rank-order forms for float32, bfloat16 and int32 x SUM / PROD / MIN /
MAX on values whose float sums round differently in another order.

Tolerances: bitwise for data movement, the rank-order forms, 'linear' and
the 2-slice bf16 wire transport (a fold of two operands is order-free);
split-level float reductions (the reference's psum against the port's
rings) within ``RTOL`` of the operands' magnitudes; the other wire
transports within the wire's epsilon of the magnitudes (compiled, the
reference's fp8 scale is ``amax * (1 / finfo.max)``: XLA rewrites the
division by a constant, which its eager and numpy paths and the port do
not). ``wire_quantize``
is held bitwise against the reference's ml_dtypes path in this process
(NaN payloads aside: torch and ml_dtypes spell a NaN differently).
"""

import json
import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ompi_tpu import op as ROP  # noqa: E402
from ompi_tpu.parallel import collectives as RC  # noqa: E402
from ompi_tpu.parallel import hierarchical as RH  # noqa: E402
from ompi_tpu.util import jaxcompat  # noqa: E402

# the reference probes its fp8 casts once, eagerly; a first probe inside a
# trace would find them missing
jaxcompat.wire_dtype("bf16")
from ompi_tpu_torch import compat  # noqa: E402
from ompi_tpu_torch.parallel import hierarchical as H  # noqa: E402
from ompi_tpu_torch.runtime import launcher as port_launcher  # noqa: E402

PORT_MCA = dict(compat.mca_from_reference({"device_plane": "on"}),
                device_plane_platform="cpu")
#: split-level float reductions, relative to the operands' magnitudes
RTOL = {"float32": 1e-6, "bfloat16": 3e-3}
#: (n_dcn, n_ici) grids
GRIDS = {4: (2, 2), 6: (3, 2)}
EPS = {"bf16": 2.0 ** -7, "fp8_e4m3": 2.0 ** -3, "fp8_e5m2": 2.0 ** -2}

#: The case table. ``table(H, C, O, P, D, I)`` returns dicts: name, fn (a
#: rank's body on its block), x (numpy, n blocks along dim 0), dtype,
#: out ("rep": replicated, "var": one block a rank), check ("bits",
#: "tol" or "wire:<name>").
_TABLE = '''
def table(H, C, O, P, D, I):
    N = D * I
    rng = np.random.default_rng(100 + N)
    out = []

    def case(name, fn, x, dtype="float32", out_="var", check="bits"):
        out.append(dict(name=name, fn=fn, x=x, dtype=dtype, out=out_,
                        check=check))

    def contribs(rows_per, cols=6, seed=0):
        r = np.random.default_rng(seed + N)
        return r.standard_normal((N * rows_per, cols)).astype(np.float32)

    def spread(*shape):
        # magnitudes over seven decades: sums round by order
        return (rng.standard_normal(shape)
                * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)

    # tests/test_hierarchical.py's compositions
    case("allreduce_matches_flat", lambda a: H.allreduce(a),
         contribs(I * 2), out_="rep", check="tol")
    case("allreduce_indivisible_falls_back_flat",
         lambda a: H.allreduce(a),
         np.arange(N * 3, dtype=np.float32).reshape(N, 3), out_="rep")
    case("reduce_scatter_allgather_roundtrip",
         lambda a: H.allgather(H.reduce_scatter(a)), contribs(N * 2),
         check="tol")
    case("reduce_scatter_shard_content", lambda a: H.reduce_scatter(a),
         contribs(N * 2), check="tol")
    root = N - 1
    case("bcast_from_nonzero_root",
         lambda a: H.bcast(a, root_dcn=root // I, root_ici=root % I),
         np.arange(N * 2 * 3, dtype=np.float32).reshape(N * 2, 3),
         out_="rep")
    case("alltoall_matches_flat_oracle", lambda a: H.alltoall(a),
         contribs(N * 2, seed=3))
    case("deterministic_linear_bit_identical",
         lambda a: H.allreduce(a, deterministic="linear"),
         (contribs(2, seed=7) * 1e3).astype(np.float32), out_="rep")
    # the rank-order forms, the dtype x op matrix
    for dt in ("float32", "bfloat16", "int32"):
        x = (rng.integers(-1000, 1000, (N * 2, 5)).astype(np.int32)
             if dt == "int32" else spread(N * 2, 5))
        for op in ("SUM", "PROD", "MIN", "MAX"):
            xo = x
            if op == "PROD" and dt == "int32":
                xo = rng.integers(-3, 4, (N * 2, 5)).astype(np.int32)
            case(f"allreduce_rankorder_{dt}_{op.lower()}",
                 lambda a, op=getattr(O, op): H.allreduce_rankorder(
                     a, op=op), xo, dt, out_="rep")
            case(f"reduce_scatter_block_rankorder_{dt}_{op.lower()}",
                 lambda a, op=getattr(O, op):
                 H.reduce_scatter_block_rankorder(a, op=op),
                 np.tile(xo, (N, 1)), dt)
        case(f"gather_rankorder_{dt}", lambda a: H.gather_rankorder(a),
             x, dt, out_="rep")
        case(f"reduce_scatter_rankmajor_{dt}",
             lambda a: H.reduce_scatter_rankmajor(a),
             np.tile(x, (N, 1)), dt,
             check="bits" if dt == "int32" else "tol")
    case("allreduce_rankorder_land",
         lambda a: H.allreduce_rankorder(a, op=O.LAND),
         rng.integers(0, 2, (N, 4)).astype(np.int32), "int32", out_="rep")
    # the compressed DCN transport and its rank-major scatter
    pos = ((rng.random((N * 2, 8)) + 0.1)
           * 10.0 ** rng.integers(-2, 3, (N * 2, 8))).astype(np.float32)
    for wire in ("bf16", "fp8_e4m3", "fp8_e5m2"):
        # bits where the fold is of two operands and no scale is agreed:
        # compiled, the reference's fp8 scale is amax x (1 / finfo.max)
        chk = "bits" if D == 2 and wire == "bf16" else f"wire:{wire}"
        case(f"dcn_wire_allreduce_{wire}",
             lambda a, w=wire: H.dcn_wire_allreduce(a, w), pos,
             check=chk)
        case(f"reduce_scatter_rankmajor_wire_{wire}",
             lambda a, w=wire: H.reduce_scatter_rankmajor(a, wire=w),
             np.tile(pos, (N, 1)), check=f"wire:{wire}")
    return out
'''

_PORT_PROG = """
import json
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi, op as O
from ompi_tpu_torch.parallel import DeviceCommunicator, P, collectives as C
from ompi_tpu_torch.parallel import hierarchical as H
world = mpi.Init()
N = world.size
D, I = {grid}
out_dir = {out_dir!r}
{table}

mesh = H.hier_mesh(world, n_slices=D)
dc = DeviceCommunicator(mesh, ("dcn", "ici"))
spec = P(("dcn", "ici"))

def tensor(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))

for c in table(H, C, O, P, D, I):
    got = dc.assemble(dc.run(c["fn"], spec)(tensor(c["x"], c["dtype"])),
                      P() if c["out"] == "rep" else spec)
    if world.rank == 0:
        np.save(f"{{out_dir}}/{{c['name']}}.npy", got)

def err(fn):
    try:
        fn()
    except errors.MPIError as e:
        return [e.error_class, str(e)]
    return None

doc = {{
    "axis_names": list(mesh.axis_names),
    "shape": [int(s) for s in mesh.devices.shape],
    "coords": list(mesh.coords),
    "ragged": err(lambda: H.hier_mesh(world, n_slices=N - 1)),
    "a2a_indivisible": err(lambda: dc.run(lambda a: H.alltoall(a), spec)(
        torch.zeros(N * 3, 2))),
    "auto_groups": H.slice_split(H.node_names(world)),
    "by_node": [int(s) for s in H.hier_mesh(world).devices.shape],
}}
with open(f"{{out_dir}}/doc_r{{world.rank}}.json", "w") as fh:
    json.dump(doc, fh)
mpi.Finalize()
"""


def _port_job(n: int, out_dir: str) -> None:
    src = textwrap.dedent(_PORT_PROG).format(out_dir=out_dir, table=_TABLE,
                                             grid=GRIDS[n])
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
    return ns["table"](RH, RC, ROP, JP, *GRIDS[n])


@pytest.fixture(scope="module")
def port4(tmp_path_factory):
    d = tmp_path_factory.mktemp("hier4")
    _port_job(4, str(d))
    return d


@pytest.fixture(scope="module")
def port6(tmp_path_factory):
    d = tmp_path_factory.mktemp("hier6")
    _port_job(6, str(d))
    return d


_MESHES = {}


def _ref_mesh(n: int):
    if n not in _MESHES:
        if len(jax.devices()) < n:
            pytest.skip(f"needs {n} devices")
        _MESHES[n] = RH.hier_mesh(jax.devices()[:n], n_slices=GRIDS[n][0])
    return _MESHES[n]


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _as_float(a, dtype):
    if dtype == "bfloat16":
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64)


def _reference(c, n):
    spec = JP(("dcn", "ici"))
    f = jaxcompat.shard_map(c["fn"], mesh=_ref_mesh(n), in_specs=(spec,),
                            out_specs=JP() if c["out"] == "rep" else spec,
                            check_vma=False)
    return _np(jax.jit(f)(jnp.asarray(c["x"]).astype(c["dtype"])))


def _check(c, ref, got, what):
    assert ref.shape == got.shape and ref.dtype == got.dtype, \
        (what, ref.shape, got.shape, ref.dtype, got.dtype)
    if c["check"] == "bits":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    x = _as_float(_np(jnp.asarray(c["x"]).astype(c["dtype"])), c["dtype"])
    mag = np.abs(x).sum()
    if c["check"] == "tol":
        rtol = RTOL[c["dtype"]]
    else:  # a wire's rounding of the DCN operands
        rtol = EPS[c["check"].split(":", 1)[1]]
    err = np.abs(_as_float(got, c["dtype"]) - _as_float(ref, c["dtype"]))
    assert (err <= rtol * mag).all(), f"{what}: max err {err.max()}"


def _run_case(name, n, out):
    c = next(c for c in _table(n) if c["name"] == name)
    _check(c, _reference(c, n), np.load(out / f"{name}.npy"),
           f"{name} n={n}")


@pytest.mark.parametrize("name", [c["name"] for c in _table(4)])
def test_grid_2x2(port4, name):
    """Every case on a 2 x 2 grid against the reference's 2 x 2 mesh."""
    _run_case(name, 4, port4)


@pytest.mark.parametrize("name", [c["name"] for c in _table(6)])
def test_grid_3x2(port6, name):
    """Every case on a 3 x 2 grid (three slices: a DCN fold of three
    operands shows its order, and a (j, s) transposition slip shows)."""
    _run_case(name, 6, port6)


@pytest.mark.parametrize("n", [4, 6])
def test_hier_mesh_shape(n, port4, port6):
    """hier_mesh(n_slices) is the reference's (dcn, ici) grid, rank-major;
    'auto' on one machine groups every rank on one node: one row, and
    slice_split stays flat (0)."""
    out = port4 if n == 4 else port6
    ref = _ref_mesh(n)
    for r in range(n):
        doc = json.loads((out / f"doc_r{r}.json").read_text())
        assert doc["axis_names"] == list(ref.axis_names)
        assert doc["shape"] == list(ref.devices.shape)
        assert doc["coords"] == list(np.unravel_index(r, ref.devices.shape))
        assert doc["auto_groups"] == 0
        assert doc["by_node"] == [1, n]


@pytest.mark.parametrize("n", [4, 6])
def test_hier_mesh_rejects_ragged(n, port4, port6):
    """n ranks do not split into n - 1 slices: ERR_ARG naming the counts,
    as the reference's (tests/test_hierarchical.py)."""
    from ompi_tpu import errors as rerrors
    from ompi_tpu_torch import errors

    out = port4 if n == 4 else port6
    text = f"{n} devices do not split into {n - 1} equal slices"
    with pytest.raises(rerrors.MPIError) as exc:
        RH.hier_mesh(jax.devices()[:n], n_slices=n - 1)
    assert text in str(exc.value)
    for r in range(n):
        got = json.loads((out / f"doc_r{r}.json").read_text())["ragged"]
        assert got[0] == errors.ERR_ARG and text in got[1], got


def test_alltoall_rejects_indivisible(port4):
    """dim 0 not divisible by the world: the reference's ValueError is
    MPIError(ERR_ARG) in the port, with its text."""
    from ompi_tpu_torch import errors

    with pytest.raises(ValueError, match="not divisible"):
        jax.jit(jaxcompat.shard_map(
            lambda a: RH.alltoall(a), mesh=_ref_mesh(4),
            in_specs=JP(("dcn", "ici")), out_specs=JP(("dcn", "ici")),
            check_vma=False))(np.zeros((4 * 3, 2), np.float32))
    for r in range(4):
        got = json.loads((port4 / f"doc_r{r}.json").read_text())
        assert got["a2a_indivisible"][0] == errors.ERR_ARG
        assert "not divisible by world 4" in got["a2a_indivisible"][1]


# ---------------------------------------------------------------------------
# the slice grouping and the wire formats, in this process


@pytest.mark.parametrize("labels,want", [
    (["a", "a", "b", "b"], 2), (["a", "a", "a", "a"], 0),
    (["a", "b", "a", "b"], 0), (["a", "a", "a", "b"], 0),
    (["a", "b", "c"], 3), ([None, None], 0)])
def test_slice_split_groups_contiguous_runs(labels, want):
    """The reference's rule on slice_index, applied to node labels."""
    class Dev:
        def __init__(self, s):
            self.slice_index = s
    assert H.slice_split(labels) == want
    assert RH.slice_split([Dev(s) for s in labels]) == want


@pytest.mark.parametrize("spec,n", [("2x2", 4), ("3x2", 6), ("2", 4),
                                    ("off", 4), ("1", 4)])
def test_parse_split_matches_reference(spec, n):
    assert H.parse_split(spec, n) == RH.parse_split(spec, n)


@pytest.mark.parametrize("spec", ["3x2", "x", "3"])
def test_parse_split_errors_match(spec):
    from ompi_tpu import errors as rerrors
    from ompi_tpu_torch import errors

    with pytest.raises(rerrors.MPIError) as ref:
        RH.parse_split(spec, 4)
    with pytest.raises(errors.MPIError) as got:
        H.parse_split(spec, 4)
    assert got.value.error_class == errors.ERR_ARG
    assert str(got.value).split(": ", 1)[-1] in str(ref.value)


def _sweep(wire):
    fm = H.wire_finfo_max(wire)
    sub = {"bf16": 2.0 ** -133, "fp8_e4m3": 2.0 ** -9,
           "fp8_e5m2": 2.0 ** -16}[wire]
    rng = np.random.default_rng(5)
    with np.errstate(over="ignore"):
        return {
            "spread": (rng.standard_normal(2000)
                       * 10.0 ** rng.integers(-8, 8, 2000)
                       ).astype(np.float32),
            "fmax": np.array([fm, -fm, fm * 1.01, fm * 0.99, fm / 2, 1.0,
                              -1.0], np.float32),
            "subnormals": np.array([sub, sub / 2, sub * 1.5, sub * 3, -sub,
                                    sub * 0.49, fm], np.float32),
            "zero": np.array([0.0, -0.0, 1.0, 0.0], np.float32),
            "all_zero": np.zeros(9, np.float32),
            "nan": np.array([np.nan, 1.0, 500.0, -600.0, 3e-5],
                            np.float32),
        }


def _bits_nan_aware(got, ref):
    """Equal bits, NaN positions aside (where both must be NaN); uint16
    arrays are bfloat16 bits."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape

    def values(a):
        if a.dtype == np.uint16:
            return (a.astype(np.uint32) << 16).view(np.float32)
        return a.astype(np.float32)
    nan = np.isnan(values(got))
    np.testing.assert_array_equal(nan, np.isnan(values(ref)))
    iv = np.uint32 if got.dtype.itemsize == 4 else np.uint16
    np.testing.assert_array_equal(got.view(iv)[~nan], ref.view(iv)[~nan])


@pytest.mark.parametrize("kind", ["spread", "fmax", "subnormals", "zero",
                                  "all_zero", "nan"])
@pytest.mark.parametrize("wire", ["bf16", "fp8_e4m3", "fp8_e5m2"])
def test_wire_quantize_bitwise(wire, kind):
    """wire_quantize on float32 numpy, float32 and bfloat16 tensors,
    bitwise the reference's on numpy and jnp arrays, around +-fmax, the
    wire's subnormals, zero, an all-zero array (scale 1) and NaN; and no
    finite input gives a NaN (x / scale never overflows the cast)."""
    import torch

    x = _sweep(wire)[kind]
    _bits_nan_aware(H.wire_quantize(x, wire), RH.wire_quantize(x, wire))
    got = H.wire_quantize(torch.from_numpy(x), wire).numpy()
    _bits_nan_aware(got, np.asarray(RH.wire_quantize(jnp.asarray(x), wire)))
    got = H.wire_quantize(torch.from_numpy(x).to(torch.bfloat16), wire)
    ref = RH.wire_quantize(jnp.asarray(x).astype(jnp.bfloat16), wire)
    _bits_nan_aware(got.view(torch.int16).numpy().view(np.uint16),
                    np.asarray(ref).view(np.uint16))
    if np.isfinite(x).all():
        assert not np.isnan(H.wire_quantize(x, wire)).any()


def test_wire_helpers_match_reference():
    """dtype, item size and finfo.max of each wire; wire_degrade is the
    identity (torch always has fp8)."""
    for w in H.WIRE_DTYPES:
        assert H.wire_itemsize(w) == jaxcompat.wire_itemsize(w)
        assert H.wire_finfo_max(w) == jaxcompat.wire_finfo_max(w)
        assert H.wire_degrade(w) == w == jaxcompat.wire_degrade(w)
        assert str(H.wire_dtype(w)).split(".")[-1].startswith(
            {"bf16": "bfloat16", "fp8_e4m3": "float8_e4m3fn",
             "fp8_e5m2": "float8_e5m2"}[w])
    assert H.wire_dtype("fp16") is None and H.wire_itemsize("fp16") == 0
    assert tuple(sorted(H.WIRE_DTYPES)) == tuple(sorted(RH.WIRE_DTYPES))
