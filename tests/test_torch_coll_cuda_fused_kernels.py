"""The port's fused kernels and schedules (K5 reduce_scatter_update, K5b
linear_reduce_scatter_update, K6 allgather_matmul) against the JAX
package's Pallas kernels.

Same inputs, made from a seed with numpy, go through
``pallas_kernels.ring_reduce_scatter_update`` /
``linear_reduce_scatter_update`` / ``allgather_matmul`` in interpret mode
under ``shard_map`` over an n-device virtual CPU mesh, and through the
port's schedules with n ranks stepped in lockstep in one process (the
kernels' plain versions, since the tensors lie on the CPU).

Tolerances, with their reasons:

- K5 and K5b against the reference: int32 bitwise; float32 within one
  rounding (rtol 1e-6, atol 1e-6 on values of order 1), because the
  reference's fused epilogue may contract a multiply-add
  (pallas_kernels.py:120-130); bfloat16 within 2e-2 (the bfloat16 bound
  of test_torch_mpi_device.py: XLA may keep float32 between the update's
  ops).
- K5 and K5b against the port's own unfused steps (the K1 ring, or the
  K3 'linear' reduce-scatter, then the eager update): bitwise for every
  dtype.
- K6: |got - ref| <= tol * (|x| @ |w|) elementwise, tol 1e-5 for
  float32 and 2e-2 for bfloat16 (sums in another order; bfloat16 rounds
  once at the end on both sides); int32 exact (mod 2**32 in any order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ompi_tpu.coll import pallas_kernels as JK
from ompi_tpu.util import jaxcompat
from ompi_tpu_torch import compat
from ompi_tpu_torch.coll import cuda_kernels as K
from tests.test_torch_coll_cuda_kernels import assert_bits_equal

CHUNK = 37  # shard elements per rank: odd, not a multiple of the vector
#: (momentum, inv) variants of the fused update
VARIANTS = [(False, False), (False, True), (True, False), (True, True)]
#: constants per dtype: int32 truncates 0.1/0.9 to 0, so it gets integers
CONSTS = {"float32": (0.1, 0.9), "bfloat16": (0.1, 0.9), "int32": (3.0, 2.0)}
M, D, F = 5, 7, 6  # K6: (M, D) blocks @ (D, F)
PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("int32", "int32"), ("float32", "bfloat16"),
         ("bfloat16", "float32"), ("int32", "bfloat16"),
         ("int32", "float32"), ("bfloat16", "int32")]


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("mpi",))


def _smap(body, n, in_specs):
    return jax.jit(jaxcompat.shard_map(body, mesh=_mesh(n),
                                       in_specs=in_specs,
                                       out_specs=P("mpi"), check_vma=False))


def _rand(rng, shape, dtype, full_range=True):
    if dtype == "int32":
        lo, hi = (-2**31, 2**31 - 1) if full_range else (-100, 100)
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# K5


_k5_cache = {}
#: the fused step per fold order: (JAX function, port schedule, the
#: port's unfused reduce-scatter algorithm)
FUSED = {"ring": (JK.ring_reduce_scatter_update, K.reduce_scatter_update,
                  "ring"),
         "linear": (JK.linear_reduce_scatter_update,
                    K.linear_reduce_scatter_update, "linear")}


def _k5_inputs(n, dtype):
    rng = np.random.default_rng(11 + n)
    x, p, v = (jnp.asarray(_rand(rng, shape, dtype)).astype(dtype)
               for shape in ((n, n * CHUNK), (n, CHUNK), (n, CHUNK)))
    return x, p, v


def _k5_reference(n, dtype, order="ring"):
    """Reference (p', v') per variant, rank by rank (one compile per n,
    dtype and fold order)."""
    if (n, dtype, order) in _k5_cache:
        return _k5_cache[(n, dtype, order)]
    lr, mu = CONSTS[dtype]
    x, p, v = _k5_inputs(n, dtype)
    jfn = FUSED[order][0]

    def body(x, p, v):
        x, p, v = x[0], p[0], v[0]
        outs = []
        for mom, inv in VARIANTS:
            pn, vn = jfn(x, "mpi", jnp.add, p, v if mom else None, lr=lr,
                         mu=mu, inv=1.0 / n if inv else None)
            outs += [pn[None], (vn if mom else p)[None]]
        return tuple(outs)

    res = [np.asarray(o) for o in _smap(body, n, P("mpi"))(x, p, v)]
    _k5_cache[(n, dtype, order)] = (x, p, v, res)
    return _k5_cache[(n, dtype, order)]


def _k5_port(n, x, p, v, dtype, mom, inv, fused, order="ring"):
    """(p', v') per rank: the fused schedule of the fold order, or its
    unfused reduce-scatter (K1 ring or K3 'linear') followed by the eager
    update."""
    tdt = getattr(torch, dtype)
    lr, mu = CONSTS[dtype]
    xs, ps, vs = ([compat.tensor_from_numpy(np.asarray(a)[r])
                   for r in range(n)] for a in (x, p, v))
    c = {"lr": K.shard_const(lr, tdt), "mu": K.shard_const(mu, tdt),
         "inv": K.shard_const(1.0 / n, tdt) if inv else None}
    rings = K.Ring.local(n, 4 * n * CHUNK, 4 * CHUNK + 64)
    outs = []
    _, schedule, algo = FUSED[order]
    if fused:
        pouts = [torch.empty_like(ps[r]) for r in range(n)]
        vouts = [torch.empty_like(vs[r]) if mom else None for r in range(n)]
        K.run_lockstep(rings, [schedule(
            rings[r], xs[r], ps[r], vs[r] if mom else None, c["lr"],
            c["mu"] if mom else None, c["inv"], pouts[r], vouts[r])
            for r in range(n)])
        return [(pouts[r], vouts[r] if mom else ps[r]) for r in range(n)]
    gs = [torch.empty_like(ps[r]) for r in range(n)]
    K.run_lockstep(rings, [K.reduce_scatter(rings[r], xs[r], "MPI_SUM",
                                            algo, 1, gs[r])
                           for r in range(n)])
    for r in range(n):
        pn, vn = K.shard_update_plain(gs[r], ps[r], vs[r] if mom else None,
                                      c["lr"], c["mu"], c["inv"])
        outs.append((pn, vn if mom else ps[r]))
    return outs


def _as_float(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def _check_fused_against_pallas(n, dtype, variant, order):
    mom, inv = variant
    x, p, v, ref = _k5_reference(n, dtype, order)
    i = VARIANTS.index(variant)
    fused = _k5_port(n, x, p, v, dtype, mom, inv, True, order)
    unfused = _k5_port(n, x, p, v, dtype, mom, inv, False, order)
    for r in range(n):
        for j, what in ((0, "p'"), (1, "v'")):
            got = compat.tensor_to_numpy(fused[r][j])
            # the port's fused step IS its unfused step, bit for bit
            assert_bits_equal(compat.tensor_to_numpy(unfused[r][j]), got,
                              f"fused vs unfused {what} rank {r}")
            want = ref[2 * i + j][r]
            if dtype == "int32":
                np.testing.assert_array_equal(got, want)
            else:
                tol = 2e-2 if dtype == "bfloat16" else 1e-6
                np.testing.assert_allclose(
                    _as_float(got), _as_float(want.view(np.uint16)
                                              if dtype == "bfloat16"
                                              else want),
                    rtol=tol, atol=tol, err_msg=f"{what} rank {r}")


@pytest.mark.parametrize("variant", VARIANTS,
                         ids=lambda v: f"mom{int(v[0])}-inv{int(v[1])}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_reduce_scatter_update_against_pallas(n, dtype, variant):
    _check_fused_against_pallas(n, dtype, variant, "ring")


@pytest.mark.parametrize("variant", VARIANTS,
                         ids=lambda v: f"mom{int(v[0])}-inv{int(v[1])}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_linear_reduce_scatter_update_against_pallas(n, dtype, variant):
    """K5b's schedule (its plain version on the CPU) against the
    reference's linear_reduce_scatter_update in interpret mode, and
    bitwise against the port's unfused 'linear' step."""
    _check_fused_against_pallas(n, dtype, variant, "linear")


def test_linear_reduce_scatter_update_passes_two_linear_steps():
    """K5b's schedule stages, passes one ALL step, folds, and passes
    another, like the 'linear' reduce-scatter; it never touches a ring
    direction's hop counter."""
    n = 3
    rings = K.Ring.local(n, 4 * n * CHUNK, 4 * CHUNK + 64)
    xs = [torch.arange(n * CHUNK, dtype=torch.float32) + r for r in range(n)]
    outs = [torch.empty(CHUNK) for _ in range(n)]
    lr = K.shard_const(1.0, torch.float32)
    K.run_lockstep(rings, [K.linear_reduce_scatter_update(
        rings[r], xs[r], torch.zeros(CHUNK), None, lr, None, None, outs[r],
        None) for r in range(n)])
    assert [e.linear for e in rings] == [2] * n
    assert [e.hops for e in rings] == [{1: 0, -1: 0}] * n
    for r in range(n):
        assert torch.equal(outs[r], -sum(xs)[r * CHUNK:(r + 1) * CHUNK])


def test_reduce_scatter_update_advances_hops_like_the_ring():
    """The fused hop writes no slot but counts as a hop: afterwards every
    rank's hop counter equals the plain ring's, so the next collective
    on the arena reads the right slot."""
    n = 3
    rings = K.Ring.local(n, 4 * n * CHUNK, 4 * CHUNK + 64)
    xs = [torch.arange(n * CHUNK, dtype=torch.float32) + r for r in range(n)]
    ps = [torch.zeros(CHUNK) for _ in range(n)]
    outs = [torch.empty(CHUNK) for _ in range(n)]
    lr = K.shard_const(1.0, torch.float32)
    K.run_lockstep(rings, [K.reduce_scatter_update(
        rings[r], xs[r], ps[r], None, lr, None, None, outs[r], None)
        for r in range(n)])
    assert [e.hops[1] for e in rings] == [n] * n
    # a ring allreduce right after gives the plain sum
    ar = [torch.empty(n * CHUNK) for _ in range(n)]
    K.run_lockstep(rings, [K.allreduce(rings[r], xs[r], "MPI_SUM", "ring",
                                       ar[r]) for r in range(n)])
    for r in range(n):
        assert torch.equal(ar[r], sum(xs))
        # p' = 0 - 1 * (own chunk's sum)
        assert torch.equal(outs[r], -sum(xs)[r * CHUNK:(r + 1) * CHUNK])


def test_rs_update_hop_checks_operands():
    a = torch.zeros(8)
    lr = K.shard_const(0.1, torch.float32)
    with pytest.raises(ValueError, match="go together"):
        K.ring_rs_update_hop(a, a, a, a, torch.zeros(8), None, lr, lr, None)
    with pytest.raises(ValueError, match="0-d tensors"):
        K.ring_rs_update_hop(a, a, a, None, torch.zeros(8), None,
                             K.shard_const(0.1, torch.bfloat16), None, None)
    with pytest.raises(ValueError, match="also an input"):
        K.ring_rs_update_hop(a, a, a, None, a, None, lr, None, None)


def test_linear_fold_update_checks_operands_and_counts_nothing_on_cpu():
    a, b = torch.ones(8), torch.full((8,), 2.0)
    lr = K.shard_const(0.5, torch.float32)
    with pytest.raises(ValueError, match="go together"):
        K.linear_fold_update([a, b], a, a, torch.zeros(8), None, lr, lr,
                             None)
    with pytest.raises(ValueError, match="elements"):
        K.linear_fold_update([a, torch.ones(9)], a, None, torch.zeros(8),
                             None, lr, None, None)
    with pytest.raises(ValueError, match="also an input"):
        K.linear_fold_update([a, b], a, None, b, None, lr, None, None)
    K.reset_launches()
    p, v, po, vo = torch.zeros(8), torch.ones(8), torch.empty(8), \
        torch.empty(8)
    mu = K.shard_const(0.5, torch.float32)
    K.linear_fold_update([a, b, b], p, v, po, vo, lr, mu, None)
    # g = 1 + 2 + 2 = 5; v' = 0.5 * 1 + 5; p' = 0 - 0.5 * 5.5
    assert torch.equal(vo, torch.full((8,), 5.5))
    assert torch.equal(po, torch.full((8,), -2.75))
    assert K.linear_fold_update.launches == 0


def test_shard_const_casts_like_jnp():
    """1/3 rounds to bfloat16 and 0.9 truncates to 0 for int32, as
    jnp.asarray(value, dtype) does."""
    for value in (1 / 3, 0.9, 0.1, 1 / 4):
        for dt in ("float32", "bfloat16", "int32"):
            ref = np.asarray(jnp.asarray(value, dt))
            got = compat.tensor_to_numpy(K.shard_const(value,
                                                       getattr(torch, dt)))
            assert_bits_equal(ref, got, f"{value} {dt}")


# ---------------------------------------------------------------------------
# K6

_k6_cache = {}


def _k6_inputs(n, xdt, wdt):
    rng = np.random.default_rng(100 * n + PAIRS.index((xdt, wdt)))
    full = xdt == wdt == "int32"
    x = jnp.asarray(_rand(rng, (n, M, D), xdt, full)).astype(xdt)
    w = jnp.asarray(_rand(rng, (D, F), wdt, full)).astype(wdt)
    return x, w


def _k6_reference(n):
    if n in _k6_cache:
        return _k6_cache[n]
    ins = [_k6_inputs(n, a, b) for a, b in PAIRS]

    def body(*args):
        outs = []
        for i in range(len(PAIRS)):
            x, w = args[2 * i][0], args[2 * i + 1]
            outs.append(JK.allgather_matmul(x, w, "mpi")[None])
        return tuple(outs)

    flat = [a for xw in ins for a in xw]
    specs = tuple(s for _ in PAIRS for s in (P("mpi"), P()))
    res = [np.asarray(o) for o in _smap(body, n, specs)(*flat)]
    _k6_cache[n] = (ins, res)
    return _k6_cache[n]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}@{p[1]}")
@pytest.mark.parametrize("n", [2, 3, 4])
def test_allgather_matmul_against_pallas(n, pair):
    ins, res = _k6_reference(n)
    i = PAIRS.index(pair)
    x, w = ins[i]
    ref = res[i]
    dt = torch.promote_types(getattr(torch, pair[0]), getattr(torch, pair[1]))
    assert str(dt).split(".")[-1] == str(jnp.result_type(*pair))
    xs = [compat.tensor_from_numpy(np.asarray(x)[r]).to(dt) for r in range(n)]
    wt = compat.tensor_from_numpy(np.asarray(w)).to(dt)
    rings = K.Ring.local(n, 256, 4 * M * D + 64)
    outs = [torch.empty(n * M, F, dtype=dt) for _ in range(n)]
    K.run_lockstep(rings, [K.allgather_matmul(rings[r], xs[r], wt, outs[r])
                           for r in range(n)])
    for r in range(n):
        got = compat.tensor_to_numpy(outs[r])
        want = ref[r]
        if dt == torch.int32:
            np.testing.assert_array_equal(got, want)
            continue
        xf = np.concatenate([compat.tensor_to_numpy(t.float()) for t in xs])
        mag = np.abs(xf).astype(np.float64) @ np.abs(
            compat.tensor_to_numpy(wt.float())).astype(np.float64)
        tol = 2e-2 if dt == torch.bfloat16 else 1e-5
        g = _as_float(got)
        want = _as_float(want.view(np.uint16) if dt == torch.bfloat16
                         else want)
        assert (np.abs(g - want) <= tol * mag + 1e-30).all(), (pair, r)


def test_matmul_i32_plain_is_exact_mod_2_32():
    rng = np.random.default_rng(5)
    x = rng.integers(-2**31, 2**31 - 1, (9, 300), dtype=np.int64)
    w = rng.integers(-2**31, 2**31 - 1, (300, 4), dtype=np.int64)
    exact = np.zeros((9, 4), dtype=object)
    for i in range(9):
        for j in range(4):
            exact[i, j] = sum(int(a) * int(b) for a, b in zip(x[i], w[:, j]))
    want = np.array([[((v + 2**31) % 2**32) - 2**31 for v in row]
                     for row in exact], dtype=np.int64).astype(np.int32)
    out = torch.empty(9, 4, dtype=torch.int32)
    K.block_matmul(torch.from_numpy(x.astype(np.int32)),
                   torch.from_numpy(w.astype(np.int32)), out)
    np.testing.assert_array_equal(out.numpy(), want)


def test_block_matmul_checks_and_promotes():
    x = torch.ones(2, 3, dtype=torch.int32)
    w = torch.full((3, 2), 0.5, dtype=torch.bfloat16)
    out = torch.empty(2, 2, dtype=torch.bfloat16)
    K.reset_launches()
    K.block_matmul(x, w, out)  # int32 x bfloat16 -> bfloat16
    assert torch.equal(out, torch.full((2, 2), 1.5, dtype=torch.bfloat16))
    assert K.block_matmul.launches == 0  # plain version on the CPU
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        K.block_matmul(x, w, torch.empty(2, 2))
    with pytest.raises(ValueError, match="shapes"):
        K.block_matmul(x, w.t().contiguous(), out)
    with pytest.raises(ValueError, match="one of float32"):
        K.block_matmul(x.to(torch.int16), x.t().to(torch.int16).contiguous(),
                       torch.empty(2, 2, dtype=torch.int16))


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16)


#: (x, w, out) maker and the K6 kernel the shape rule must name
VARIANT_CASES = {
    "main-path-bf16": (lambda: (_bf16(2048, 768), _bf16(768, 3072),
                                _bf16(2048, 3072)), "wgmma"),
    "float32": (lambda: (torch.empty(2048, 768), torch.empty(768, 3072),
                         torch.empty(2048, 3072)), "simt"),
    "int32": (lambda: (torch.empty(64, 64, dtype=torch.int32),
                       torch.empty(64, 64, dtype=torch.int32),
                       torch.empty(64, 64, dtype=torch.int32)), "simt"),
    "bf16-d70": (lambda: (_bf16(130, 70), _bf16(70, 200), _bf16(130, 200)),
                 "simt"),
    "bf16-offset-2-bytes": (lambda: (_bf16(130 * 72 + 1)[1:].view(130, 72),
                                     _bf16(72, 200), _bf16(130, 200)),
                            "simt"),
    "m0": (lambda: (_bf16(0, 64), _bf16(64, 128), _bf16(0, 128)), "simt"),
    "bf16-edge-1x64x8": (lambda: (_bf16(1, 64), _bf16(64, 8), _bf16(1, 8)),
                         "wgmma"),
}


@pytest.mark.parametrize("case", list(VARIANT_CASES))
def test_block_matmul_variant_rule(case):
    make, want = VARIANT_CASES[case]
    x, w, out = make()
    assert K.block_matmul_variant(x, w, out) == want


@pytest.mark.parametrize("pair", [p for p in PAIRS if p[0] != p[1]],
                         ids=lambda p: f"{p[0]}@{p[1]}")
def test_block_matmul_mixed_dtypes_on_cpu(pair):
    """CPU tensors take the plain product (promoted first) and count no
    launch of either kernel."""
    rng = np.random.default_rng(9)
    xdt, wdt = (getattr(torch, t) for t in pair)
    xn = rng.integers(-3, 4, (M, D)).astype(np.float32)
    wn = rng.integers(-3, 4, (D, F)).astype(np.float32)
    x, w = torch.from_numpy(xn).to(xdt), torch.from_numpy(wn).to(wdt)
    dt = torch.promote_types(xdt, wdt)
    out = torch.empty(M, F, dtype=dt)
    K.reset_launches()
    K.block_matmul(x, w, out)
    # |sums| <= 63: every product and sum is exact even in bfloat16
    np.testing.assert_array_equal(out.float().numpy(), xn @ wn)
    assert K.block_matmul.launches == 0
    assert K.block_matmul.variants == {"wgmma": 0, "simt": 0}


@pytest.mark.parametrize("shape", [(192, 3072, 256), (256, 3072, 256),
                                   (2048, 768, 3072), (130, 1001, 70),
                                   (130, 70, 200), (1, 64, 8), (5, 0, 7)])
def test_simt_splits(shape):
    """The SIMT kernel splits K only where its tiles leave SMs idle, in
    slices that are multiples of 16 and cover K exactly."""
    m, d, f = shape
    splits, kchunk = K.simt_splits(m, d, f, 132)
    tiles = -(-m // 128) * -(-f // 128)
    if splits == 1:
        assert kchunk >= d and (tiles >= 132 or d < 128)
    else:
        assert kchunk % 16 == 0 and kchunk >= 64
        assert kchunk * (splits - 1) < d <= kchunk * splits
        assert tiles * splits <= 132
    if shape == (192, 3072, 256):  # the zero-3 product: 32 slices of 96
        assert (splits, kchunk) == (32, 96)
    if shape == (2048, 768, 3072):  # 384 tiles fill the card
        assert splits == 1


@pytest.mark.gpu
def test_fused_kernels_against_plain_on_card():
    """On a CUDA card: K5 and K5b bitwise against their plain versions
    for every dtype with and without momentum and scaling (aligned and
    not), and K6's two kernels against its plain version (chip_smoke.py
    does the same at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for numel, off in ((4099, 0), (1027, 1)):
            def mk():
                if dtype == torch.int32:
                    t = torch.randint(-100, 100, (numel + off,), generator=g,
                                      device=dev, dtype=dtype)
                else:
                    t = torch.randn(numel + off, generator=g,
                                    device=dev).to(dtype)
                return t[off:]
            a, b, p, v = mk(), mk(), mk(), mk()
            for mom, inv in VARIANTS:
                c = [K.shard_const(x, dtype) for x in (3.0, 2.0, 0.25)]
                outs = [torch.empty_like(p) for _ in range(4)]
                args = dict(lr=c[0], mu=c[1] if mom else None,
                            inv=c[2] if inv else None)
                K.ring_rs_update_hop(a, b, p, v if mom else None, outs[0],
                                     outs[1] if mom else None, **args)
                K.ring_rs_update_hop_plain(a, b, p, v if mom else None,
                                           outs[2], outs[3] if mom else None,
                                           **args)
                torch.cuda.synchronize()
                assert_bits_equal(compat.tensor_to_numpy(outs[2]),
                                  compat.tensor_to_numpy(outs[0]))
                if mom:
                    assert_bits_equal(compat.tensor_to_numpy(outs[3]),
                                      compat.tensor_to_numpy(outs[1]))
                srcs = [a, b, v]
                K.linear_fold_update(srcs, p, None, outs[0], None, **{
                    **args, "mu": None})
                K.linear_fold_update_plain(srcs, p, None, outs[2], None, **{
                    **args, "mu": None})
                torch.cuda.synchronize()
                assert_bits_equal(compat.tensor_to_numpy(outs[2]),
                                  compat.tensor_to_numpy(outs[0]))
    for dt, tol, d in ((torch.float32, 1e-5, 70), (torch.bfloat16, 2e-2, 72),
                       (torch.bfloat16, 2e-2, 70)):
        x = torch.randn(130, d, generator=g, device=dev).to(dt)
        w = torch.randn(d, 200, generator=g, device=dev).to(dt)
        o1 = torch.empty(130, 200, device=dev, dtype=dt)
        o2 = torch.empty_like(o1)
        K.block_matmul(x, w, o1)
        K.block_matmul_plain(x, w, o2)
        mag = x.float().abs() @ w.float().abs()
        assert bool(((o1.float() - o2.float()).abs() <= tol * mag).all())
    xi = torch.randint(-2**31, 2**31 - 1, (130, 70), generator=g,
                       device=dev, dtype=torch.int32)
    wi = torch.randint(-2**31, 2**31 - 1, (70, 200), generator=g,
                       device=dev, dtype=torch.int32)
    i1 = torch.empty(130, 200, device=dev, dtype=torch.int32)
    i2 = torch.empty_like(i1)
    K.block_matmul(xi, wi, i1)
    K.block_matmul_plain(xi, wi, i2)
    assert torch.equal(i1, i2)
