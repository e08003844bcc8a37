"""coll/hier's compressed DCN wire formats and zero/layout.ErrorFeedback,
against the JAX package (``tests/test_coll_hier_dcn.py``'s contract).

Two job pairs. On 4 ranks under ``coll_hier on``, ``coll_hier_split 2x2``
(the reference through ``tests.harness.run_ranks``, the port through its
launcher with ``device_plane_platform cpu``), both packages run the same
program (:data:`_CASES`): Allreduce with the wire off / bf16 / fp8_e4m3 /
fp8_e5m2 / off, Reduce_scatter_block under bf16, the per-op overrides,
'linear' and int32 under fp8, the fused multi form with a mixed-dtype
tree, an unknown wire, and ZeroOptimizer stage 2 'linear' with
``error_feedback`` on device tensors; each records its in-job checks (the
reference test's) and writes its results. On 2 ranks (host numpy leaves,
no device plane) both run ZeroOptimizer and Zero3Optimizer with and
without ``error_feedback``.

Across the packages: 'off' and the exact launches bitwise; the compressed
launches within the wire's epsilon of the operands' magnitudes (the port
divides by finfo.max where the reference's compiled scale multiplies by
its reciprocal); every error-feedback trajectory bitwise (the quantiser
runs eagerly in both, and 'linear' folds in rank order). The
ErrorFeedback unit cases run in this process against the reference's.
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

MCA = {"device_plane": "on", "coll_hier": "on", "coll_hier_split": "2x2"}
EPS = {"bf16": 2.0 ** -7, "fp8_e4m3": 2.0 ** -3, "fp8_e5m2": 2.0 ** -2}
WIRES = ("bf16", "fp8_e4m3", "fp8_e5m2")

#: run in both packages on 4 ranks; saves ``{name}_r{rank}.npy`` and
#: ``oks_r{rank}.json``
_CASES = '''
oks = {}

def save(name, y):
    np.save(f"{out_dir}/{name}_r{rank}.npy", npy(y))

def bits(a, b):
    return npy(a).tobytes() == npy(b).tobytes()

def with_wire(wire, fn):
    cvar.set("coll_hier_dcn_dtype", wire)
    try:
        s = pvar.session()
        out = fn()
        return out, s.read("hier_dcn_bytes"), s.read("hier_dcn_wire_bytes")
    finally:
        cvar.set("coll_hier_dcn_dtype", "off")

# off is bitwise the uncompressed plane across the toggles; byte bounds
rng = np.random.default_rng(29)
h = ((rng.random(2048).astype(np.float32) + 0.1)
     * (10.0 ** rng.integers(-2, 3, 2048))).astype(np.float32)
x = mk(np.roll(h, rank * 7), "float32")
a1, nom, w_off = with_wire("off", lambda: comm.coll.allreduce_dev(comm, x))
oks["off_wire_eq_nominal"] = nom > 0 and w_off == nom
save("ar_off", a1)
for wire, bound, rtol in (("bf16", 0.5, 0.02), ("fp8_e4m3", 0.25, 0.35),
                          ("fp8_e5m2", 0.25, 0.35)):
    out, nom_c, w = with_wire(wire, lambda: comm.coll.allreduce_dev(comm, x))
    oks[f"{wire}_bound"] = 0 < w <= nom_c * bound
    oks[f"{wire}_close"] = bool(np.allclose(npy(out), npy(a1), rtol=rtol,
                                            atol=0.1))
    save(f"ar_{wire}", out)
a3, _, _ = with_wire("off", lambda: comm.coll.allreduce_dev(comm, x))
oks["off_after_toggle_bitwise"] = bits(a1, a3)

# reduce_scatter_block under bf16
xr = mk((np.arange(size * 64, dtype=np.float32) * 0.25 + 1.0
         + rank).reshape(size, 64), "float32")
exact = comm.coll.reduce_scatter_block_dev(comm, xr)
out, nom, w = with_wire("bf16",
                        lambda: comm.coll.reduce_scatter_block_dev(comm, xr))
oks["rsb_bound"] = 0 < w <= nom * 0.5
oks["rsb_close"] = bool(np.allclose(npy(out), npy(exact), rtol=0.02,
                                    atol=1e-3))
save("rsb_exact", exact)
save("rsb_bf16", out)

# per-op overrides both ways
xo = mk((np.arange(size * 32, dtype=np.float32).reshape(size, 32) + rank),
        "float32")
def ratio(fn):
    s = pvar.session()
    fn()
    return s.read("hier_dcn_wire_bytes"), s.read("hier_dcn_bytes")

cvar.set("coll_hier_dcn_dtype_allreduce", "bf16")
w, nom = ratio(lambda: comm.coll.allreduce_dev(comm, xo))
oks["override_compresses"] = w < nom
w, nom = ratio(lambda: comm.coll.reduce_scatter_block_dev(comm, xo))
oks["override_other_exact"] = w == nom
cvar.set("coll_hier_dcn_dtype_allreduce", "off")
cvar.set("coll_hier_dcn_dtype", "bf16")
w, nom = ratio(lambda: comm.coll.allreduce_dev(comm, xo))
oks["override_off_wins"] = w == nom
w, nom = ratio(lambda: comm.coll.reduce_scatter_block_dev(comm, xo))
oks["global_still_applies"] = w < nom
cvar.set("coll_hier_dcn_dtype", "off")
cvar.set("coll_hier_dcn_dtype_allreduce", "")

# 'linear' and int32 run exact under fp8
h2 = (rng.standard_normal(1024)
      * (10.0 ** rng.integers(-3, 4, 1024))).astype(np.float32)
xl = mk(np.roll(h2, rank * 3), "float32")
xi = mk(np.arange(777, dtype=np.int32) + rank, "int32")
cvar.set("coll_hier_dcn_dtype", "fp8_e4m3")
s = pvar.session()
p = comm.coll.allreduce_dev(comm, xl, deterministic="linear")
oks["linear_exact"] = bits(p, FLAT.allreduce_dev(
    comm, xl, deterministic="linear")) and \\
    s.read("hier_dcn_wire_bytes") == s.read("hier_dcn_bytes")
save("linear_fp8", p)
s = pvar.session()
p = comm.coll.allreduce_dev(comm, xi)
oks["int_exact"] = bits(p, FLAT.allreduce_dev(comm, xi)) and \\
    s.read("hier_dcn_wire_bytes") == s.read("hier_dcn_bytes")
save("int_fp8", p)
cvar.set("coll_hier_dcn_dtype", "off")

# an unknown wire raises ERR_ARG at every call, nothing counted
cvar.set("coll_hier_dcn_dtype", "fp16")
s = pvar.session()
errs = []
for attempt in range(2):
    try:
        comm.coll.allreduce_dev(comm, mk(np.ones(64, np.float32), "float32"))
    except errors.MPIError as e:
        errs.append(e.error_class == errors.ERR_ARG and "fp16" in str(e)
                    and "bf16" in str(e))
    else:
        errs.append(False)
oks["unknown_wire_raises"] = all(errs) and len(errs) == 2 and \\
    s.read("hier_launches") == 0 and s.read("hier_dcn_wire_bytes") == 0
cvar.set("coll_hier_dcn_dtype", "off")

# the fused multi form compresses per bucket
rng2 = np.random.default_rng(rank)
bufs = {"w": mk(rng2.random((64, 8)).astype(np.float32) + 0.5, "float32"),
        "b": mk(rng2.random((33,)).astype(np.float32) + 0.5, "float32"),
        "i": mk(np.arange(50, dtype=np.int32) + rank, "int32")}
ref = FLAT.allreduce_multi_dev(comm, bufs)
out, nom, w = with_wire("bf16",
                        lambda: comm.coll.allreduce_multi_dev(comm, bufs))
oks["multi_mixed"] = 0 < w < nom and bits(out["i"], ref["i"]) and all(
    bool(np.allclose(npy(out[k]), npy(ref[k]), rtol=0.02, atol=1e-3))
    for k in ("w", "b"))
for k in bufs:
    save(f"multi_bf16_{k}", out[k])

# ZeroOptimizer stage 2 'linear' with error feedback on device tensors
rng3 = np.random.default_rng(5)
p0 = {"w": rng3.standard_normal((6, 5)).astype(np.float32),
      "b": rng3.standard_normal(9).astype(np.float32)}
for wire in ("bf16", "fp8_e4m3"):
    opt = ZeroOptimizer(comm, {k: mk(v, "float32") for k, v in p0.items()},
                        lr=0.1, deterministic="linear", error_feedback=wire)
    s = pvar.session()
    for step in range(3):
        g = np.random.default_rng(100 + 10 * rank + step)
        out = opt.step({k: mk(g.standard_normal(v.shape).astype(np.float32),
                              "float32") for k, v in p0.items()})
    oks[f"zero_ef_{wire}_steps"] = s.read("zero_ef_steps") == 3
    for k in p0:
        save(f"zero_ef_{wire}_{k}", out[k])
with open(f"{out_dir}/oks_r{rank}.json", "w") as fh:
    json.dump({k: bool(v) for k, v in oks.items()}, fh)
'''

_REF_PROG = '''
import json
import jax.numpy as jnp
from ompi_tpu import errors
from ompi_tpu.coll import xla as FLAT
from ompi_tpu.core import cvar, pvar
from ompi_tpu.zero.optimizer import ZeroOptimizer
out_dir = {out_dir!r}

def mk(x, dt):
    return jnp.asarray(x).astype(dt)

def npy(y):
    return np.asarray(y)
{cases}
'''

_PORT_PROG = '''
import json
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi
from ompi_tpu_torch.coll import device as FLAT
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.zero.optimizer import ZeroOptimizer
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}

def mk(x, dt):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dt))

def npy(y):
    return compat.tensor_to_numpy(y)
{cases}
# toggling maps no new arena once each wire ran (the reference counts
# compile-cache misses: the port compiles nothing)
from ompi_tpu_torch.core import pvar as _pv
plan = comm._coll_hier_plan
xt = torch.arange(512, dtype=torch.float32) + rank

def arenas():
    return sum(len(c.__dict__.get("_coll_cuda_arenas", {{}}))
               for c in (comm, plan.low, plan.up))

comm.coll.allreduce_dev(comm, xt)
cvar.set("coll_hier_dcn_dtype", "bf16")
comm.coll.allreduce_dev(comm, xt)
before = (arenas(), _pv.read("device_plane_arena_bytes"))
s = pvar.session()
for wire in ("off", "bf16", "off", "bf16"):
    cvar.set("coll_hier_dcn_dtype", wire)
    comm.coll.allreduce_dev(comm, xt)
cvar.set("coll_hier_dcn_dtype", "off")
with open(f"{{out_dir}}/toggle_r{{rank}}.json", "w") as fh:
    json.dump([before == (arenas(), _pv.read("device_plane_arena_bytes")),
               s.read("hier_launches")], fh)
mpi.Finalize()
'''

#: 2 ranks, host numpy leaves, both packages: the optimizers with and
#: without error feedback; saves ``{name}_r{rank}.npy``, ``z_r{rank}.json``
_ZERO = '''
doc = {}
# fused + error_feedback is refused (ERR_ARG)
try:
    ZeroOptimizer(comm, {"w": np.ones(8, np.float32)}, fused=True,
                  error_feedback="bf16")
except errors.MPIError as e:
    doc["fused_ef"] = e.error_class == errors.ERR_ARG
else:
    doc["fused_ef"] = False
# SGD with fp8 EF gradients tracks the exact run; the pvars count
tgt = np.array([3.0, -2.0, 0.5, 8.0, -0.25, 4.0], np.float32)
params = {"w": np.zeros(6, np.float32)}
exact = ZeroOptimizer(comm, params, lr=0.2)
efopt = ZeroOptimizer(comm, params, lr=0.2, error_feedback="fp8_e4m3")
s = pvar.session()
for _ in range(30):
    pe = exact.step({"w": exact.params()["w"] - tgt})
    pq = efopt.step({"w": efopt.params()["w"] - tgt})
doc["steps"] = s.read("zero_ef_steps")
doc["ef_bytes"] = s.read("zero_ef_bytes")
doc["close"] = bool(np.allclose(pq["w"], pe["w"], rtol=0.05, atol=0.05))
np.save(f"{out_dir}/z1_exact_r{rank}.npy", np.asarray(pe["w"]))
np.save(f"{out_dir}/z1_ef_r{rank}.npy", np.asarray(pq["w"]))
# stage 3: one residual per layer
params = {"embed": np.ones((4, 6), np.float32),
          "layers": [{"w": np.ones((6, 6), np.float32)},
                     {"w": np.ones((6, 6), np.float32)}]}
exact = Zero3Optimizer(comm, params, lr=0.1)
efopt = Zero3Optimizer(comm, params, lr=0.1, error_feedback="bf16")
grads = {"embed": np.full((4, 6), 0.5, np.float32) * (rank + 1),
         "layers": [{"w": np.full((6, 6), 0.25, np.float32)},
                    {"w": np.full((6, 6), -0.125, np.float32) + rank}]}
s = pvar.session()
for _ in range(2):
    exact.step(grads)
    efopt.step(grads)
doc["z3_steps"] = s.read("zero_ef_steps")
doc["z3_layers"] = exact.plan.n_layers
a, b = leaves(exact.gathered_params()), leaves(efopt.gathered_params())
doc["z3_close"] = all(bool(np.allclose(np.asarray(y), np.asarray(x),
                                       rtol=0.01, atol=1e-3))
                      for x, y in zip(a, b))
for i, y in enumerate(b):
    np.save(f"{out_dir}/z3_ef_{i}_r{rank}.npy", np.asarray(y))
exact.free(); efopt.free()
with open(f"{out_dir}/z_r{rank}.json", "w") as fh:
    json.dump(doc, fh)
'''

_REF_ZERO = '''
import json
import jax
from ompi_tpu import errors
from ompi_tpu.core import pvar
from ompi_tpu.zero.optimizer import ZeroOptimizer
from ompi_tpu.zero.zero3 import Zero3Optimizer
out_dir = {out_dir!r}
leaves = jax.tree.leaves
{body}
'''

_PORT_ZERO = '''
import json
import numpy as np
from ompi_tpu_torch import errors, mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.zero import layout as zl
from ompi_tpu_torch.zero.optimizer import ZeroOptimizer
from ompi_tpu_torch.zero.zero3 import Zero3Optimizer
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
leaves = zl.tree_leaves
{body}
mpi.Finalize()
'''


def _launch_port(src: str, n: int, mca) -> None:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        rc = port_launcher.launch([sys.executable, path], n, mca=mca,
                                  timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job on {n} ranks exited {rc}"


@pytest.fixture(scope="module")
def wires(tmp_path_factory):
    ref = tmp_path_factory.mktemp("dcn_ref")
    port = tmp_path_factory.mktemp("dcn_port")
    run_ranks(_REF_PROG.format(out_dir=str(ref), cases=_CASES), 4,
              mca=MCA, timeout=300, isolate=True)
    _launch_port(_PORT_PROG.format(out_dir=str(port), cases=_CASES), 4,
                 dict(compat.mca_from_reference(MCA),
                      device_plane_platform="cpu"))
    return ref, port


@pytest.fixture(scope="module")
def zero2(tmp_path_factory):
    ref = tmp_path_factory.mktemp("ef_ref")
    port = tmp_path_factory.mktemp("ef_port")
    run_ranks(_REF_ZERO.format(out_dir=str(ref), body=_ZERO), 2, mca={},
              timeout=300, isolate=True)
    _launch_port(_PORT_ZERO.format(out_dir=str(port), body=_ZERO), 2,
                 {"device_plane_platform": "cpu"})
    return ref, port


def _oks(d, r):
    return json.loads((d / f"oks_r{r}.json").read_text())


def _load(d, name, r):
    return np.load(d / f"{name}_r{r}.npy")


def _within_wire(got, ref, mag, wire):
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    assert (err <= EPS[wire] * mag).all(), (wire, err.max())


def _check_oks(wires, *keys):
    ref, port = wires
    for r in range(4):
        for d in (ref, port):
            oks = _oks(d, r)
            assert all(oks[k] for k in keys), (d, r, oks)


def test_off_by_default_bitwise_across_toggles(wires):
    """'off' == the uncompressed plane bitwise, and stays so after the
    compressed launches; bf16 <= 1/2 and fp8 <= 1/4 of the nominal DCN
    bytes; the compressed results within the wire's precision; the port's
    equal the reference's ('off' bitwise, the wires within the wire's
    epsilon of the operands' magnitudes)."""
    _check_oks(wires, "off_wire_eq_nominal", "off_after_toggle_bitwise",
               *[f"{w}_{k}" for w in WIRES for k in ("bound", "close")])
    ref, port = wires
    rng = np.random.default_rng(29)
    h = ((rng.random(2048).astype(np.float32) + 0.1)
         * (10.0 ** rng.integers(-2, 3, 2048))).astype(np.float32)
    mag = 4 * np.abs(h).max()
    for r in range(4):
        np.testing.assert_array_equal(_load(port, "ar_off", r),
                                      _load(ref, "ar_off", r))
        for w in WIRES:
            _within_wire(_load(port, f"ar_{w}", r), _load(ref, f"ar_{w}", r),
                         mag, w)


def test_toggle_maps_no_new_arena(wires):
    """The reference counts zero recompiles across four toggled launches
    (its wire lives in the program cache key); the port compiles nothing:
    after one warm launch of each wire, toggling maps no new arena and
    hier_launches counts 4."""
    for r in range(4):
        same, launches = json.loads(
            (wires[1] / f"toggle_r{r}.json").read_text())
        assert same and launches == 4


def test_reduce_scatter_block_compressed(wires):
    _check_oks(wires, "rsb_bound", "rsb_close")
    ref, port = wires
    for r in range(4):
        np.testing.assert_array_equal(_load(port, "rsb_exact", r),
                                      _load(ref, "rsb_exact", r))
        _within_wire(_load(port, "rsb_bf16", r), _load(ref, "rsb_bf16", r),
                     4 * (63 * 0.25 + 1.0 + 3), "bf16")


def test_per_op_override(wires):
    _check_oks(wires, "override_compresses", "override_other_exact",
               "override_off_wins", "global_still_applies")


def test_linear_and_int_forced_exact(wires):
    _check_oks(wires, "linear_exact", "int_exact")
    ref, port = wires
    for r in range(4):
        for name in ("linear_fp8", "int_fp8"):
            np.testing.assert_array_equal(_load(port, name, r),
                                          _load(ref, name, r))


def test_unknown_wire_raises_every_call(wires):
    _check_oks(wires, "unknown_wire_raises")


def test_fused_multi_mixed_dtypes(wires):
    """Float buckets ride the wire while the int sibling stays exact;
    the port's equal the reference's (int bitwise, floats within bf16)."""
    _check_oks(wires, "multi_mixed")
    ref, port = wires
    for r in range(4):
        np.testing.assert_array_equal(_load(port, "multi_bf16_i", r),
                                      _load(ref, "multi_bf16_i", r))
        for k in ("w", "b"):
            _within_wire(_load(port, f"multi_bf16_{k}", r),
                         _load(ref, f"multi_bf16_{k}", r), 4 * 1.5, "bf16")


@pytest.mark.parametrize("wire", ["bf16", "fp8_e4m3"])
def test_zero_optimizer_ef_device_matches_reference(wires, wire):
    """ZeroOptimizer stage 2 'linear' with error_feedback on device
    tensors, 3 steps: the port's parameters equal the reference's
    bitwise."""
    _check_oks(wires, f"zero_ef_{wire}_steps")
    ref, port = wires
    for r in range(4):
        for k in ("w", "b"):
            np.testing.assert_array_equal(
                _load(port, f"zero_ef_{wire}_{k}", r),
                _load(ref, f"zero_ef_{wire}_{k}", r))


# ---------------------------------------------------------------------------
# error feedback — in this process


def test_ef_unknown_wire_raises():
    from ompi_tpu_torch import errors
    from ompi_tpu_torch.zero import layout as zl

    with pytest.raises(errors.MPIError) as ei:
        zl.ErrorFeedback("fp16")
    assert ei.value.error_class == errors.ERR_ARG


def test_ef_bounded_drift_vs_carry_free():
    """An accumulated EF-quantised gradient sum stays within one
    quantisation step of the exact sum where the carry-free quantiser
    drifts linearly; every step's output is the reference's, bitwise."""
    from ompi_tpu.zero import layout as rzl
    from ompi_tpu_torch.parallel import hierarchical as H
    from ompi_tpu_torch.zero import layout as zl

    g = np.array([1000.0, 0.1], np.float32)
    steps = 40
    ef, ref = zl.ErrorFeedback("fp8_e4m3"), rzl.ErrorFeedback("fp8_e4m3")
    acc = np.zeros(2, np.float32)
    for _ in range(steps):
        q = ef.apply([g], 2)[0]
        np.testing.assert_array_equal(q, ref.apply([g], 2)[0])
        acc = acc + q
    err_ef = np.abs(acc - steps * g)
    err_no = steps * np.abs(H.wire_quantize(g, "fp8_e4m3") - g)
    assert err_ef[1] < 0.01, err_ef
    assert err_no[1] > 0.1 and err_no[1] > 10 * max(err_ef[1], 1e-9)


def test_ef_layout_rebind_resets_residual():
    from ompi_tpu_torch.zero import layout as zl

    ef = zl.ErrorFeedback("bf16")
    ef.apply([np.ones(8, np.float32)], 2)
    assert ef.residuals and ef.residuals[0] is not None
    ef.apply([np.ones(8, np.float32), np.ones(3, np.float32)], 2)
    assert len(ef.residuals) == len(ef.plan.buckets)


def test_ef_skips_int_and_wide_enough_buckets():
    import torch

    from ompi_tpu_torch.zero import layout as zl

    ef = zl.ErrorFeedback("bf16")
    ints = np.arange(6, dtype=np.int32)
    halfs = np.ones(4, np.float16)
    out = ef.apply([ints, halfs], 2)
    np.testing.assert_array_equal(out[0], ints)
    np.testing.assert_array_equal(out[1], halfs)
    assert all(r is None for r in ef.residuals)
    t = [torch.ones(4, dtype=torch.bfloat16), torch.arange(3)]
    out = ef.apply(t, 2)
    assert torch.equal(out[0], t[0]) and torch.equal(out[1], t[1])


@pytest.mark.parametrize("wire", ["bf16", "fp8_e4m3", "fp8_e5m2"])
def test_ef_tensor_leaves_match_reference(wire):
    """ErrorFeedback on tensor leaves (two buckets, a float32 and a
    bfloat16 one), step after step, residuals included: the float32
    bucket bitwise the reference's ErrorFeedback on jax arrays; the
    bfloat16 bucket passes through under bf16 (no narrower) and, under
    fp8, bitwise the reference's quantiser with the residual carried.
    (The reference's ErrorFeedback passes a bfloat16 bucket through under
    fp8 too: ml_dtypes' bfloat16 has numpy kind 'V', not 'f'. The port
    quantises it, as the reference's docstring states; ROADMAP queue 3.)"""
    import jax.numpy as jnp
    import torch

    from ompi_tpu.parallel import hierarchical as RH
    from ompi_tpu.zero import layout as rzl
    from ompi_tpu_torch.zero import layout as zl

    rng = np.random.default_rng(3)
    ef, ref = zl.ErrorFeedback(wire), rzl.ErrorFeedback(wire)
    carry = None
    for step in range(3):
        a = (rng.standard_normal(37) * 10.0 ** rng.integers(-3, 3, 37)
             ).astype(np.float32)
        b = rng.standard_normal(11).astype(np.float32)
        got = ef.apply([torch.from_numpy(a),
                        torch.from_numpy(b).to(torch.bfloat16)], 2)
        jb = jnp.asarray(b).astype(jnp.bfloat16)
        want = ref.apply([jnp.asarray(a), jb], 2)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        if wire != "bf16":
            flat = jb if carry is None else jb + carry
            q = RH.wire_quantize(flat, wire)
            carry = flat - q
            want_b = q
        else:
            want_b = jb
        np.testing.assert_array_equal(compat.tensor_to_numpy(got[1]),
                                      np.asarray(want_b).view(np.uint16))


# ---------------------------------------------------------------------------
# the optimizers' wiring, 2 ranks, host numpy leaves


def test_zero_optimizer_ef_fused_mutually_exclusive(zero2):
    for d in zero2:
        for r in range(2):
            assert json.loads((d / f"z_r{r}.json").read_text())["fused_ef"]


def test_zero_optimizer_ef_loss_parity_and_pvars(zero2):
    """30 SGD steps with fp8 EF gradients track the exact run, every step
    records zero_ef_steps, and the port's trajectory equals the
    reference's bitwise."""
    ref, port = zero2
    for r in range(2):
        for d in (ref, port):
            doc = json.loads((d / f"z_r{r}.json").read_text())
            assert doc["steps"] == 30 and doc["ef_bytes"] > 0 \
                and doc["close"], doc
        for name in ("z1_exact", "z1_ef"):
            np.testing.assert_array_equal(_load(port, name, r),
                                          _load(ref, name, r))


def test_zero3_ef_smoke(zero2):
    """Stage 3 quantises each layer's gradients with its own residual
    (zero_ef_steps counts layers), stays close to exact, and equals the
    reference's bitwise."""
    ref, port = zero2
    for r in range(2):
        for d in (ref, port):
            doc = json.loads((d / f"z_r{r}.json").read_text())
            assert doc["z3_steps"] == 2 * doc["z3_layers"] and \
                doc["z3_close"], doc
        for i in range(3):
            np.testing.assert_array_equal(_load(port, f"z3_ef_{i}", r),
                                          _load(ref, f"z3_ef_{i}", r))


# ---------------------------------------------------------------------------
# the card path's examples at their CPU sizes


_EXAMPLES = {
    "hier_collectives": (["--tiny"], True),
    "hier_dcn_compress": (["--tiny"], True),
    "zero_training": (["--tiny", "--layers", "2", "--error-feedback",
                       "bf16,fp8_e4m3"], False),
}


@pytest.mark.parametrize("name", sorted(_EXAMPLES))
def test_examples_tiny(tmp_path, name):
    """The three examples ``chip_smoke.py`` phase 10 runs, at their CPU
    sizes on 4 ranks: every rank's checks hold, and each part's K1-K3
    calls (the plain versions' on the CPU) equal what the ranks derive
    from their schedules."""
    args, hier = _EXAMPLES[name]
    mca = {"device_plane": "on", "coll_cuda": "on",
           "device_plane_platform": "cpu"}
    if hier:
        mca.update(coll_hier="on", coll_hier_split="2x2",
                   coll_hier_inner="ring")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = os.path.join(root, "ompi_tpu_torch", "examples", f"{name}.py")
    rc = port_launcher.launch([sys.executable, prog, *args, "--out",
                               str(tmp_path)], 4, mca=mca, timeout=240)
    assert rc == 0
    for r in range(4):
        doc = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert doc["cases"] and all(c["ok"] for c in doc["cases"])
        assert all(v > 0 for k, v in doc["launches"].items()
                   if k in doc.get("required", doc["launches"]))
