"""The PyTorch port's ring kernels and schedules (ompi_tpu_torch.coll.
cuda_kernels) against the JAX package's Pallas kernels.

Same inputs, made from a seed with numpy, go through the JAX functions
(``pallas_kernels.*`` in interpret mode under ``shard_map`` over an
n-device virtual CPU mesh) and through the port's schedules with n ranks
stepped hop by hop in one process (the kernels' plain versions, since the
tensors lie on the CPU). Tolerance: none — float32, bfloat16 and int32
results are bitwise equal, except that where both sides are NaN the NaN
payload is not compared (jnp itself returns different payloads for
add and max of two NaNs).
"""

import os
import stat

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

JNP_OPS = {"MPI_SUM": jnp.add, "MPI_PROD": jnp.multiply,
           "MPI_MIN": jnp.minimum, "MPI_MAX": jnp.maximum}
DTYPES_T = (torch.float32, torch.bfloat16, torch.int32)
M = 257  # not a multiple of 2, 3 or 4: the allreduce pad path runs

#: the functions both sides run, in output order
FUNCS = ("ring_rs", "ring_ag", "linear_ar", "linear_rs", "ring_ar",
         "bidir_ar", "bidir_rs", "bidir_ag")


def _inputs(n, dtype):
    rng = np.random.default_rng(7 + n)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, (n, M),
                            dtype=np.int64).astype(np.int32)
    h = (rng.standard_normal((n, M))
         * 10.0 ** rng.integers(-3, 4, (n, M))).astype(np.float32)
    h[:, 5] = np.nan  # NaN against NaN
    h[0, 7] = np.nan  # NaN against numbers
    h[:, 9] = 0.0  # +0 against -0 in both orders
    h[1, 9] = -0.0
    h[:, 11] = -0.0
    return h


def _jax_run(n, x, op):
    mesh = Mesh(np.array(jax.devices()[:n]), ("mpi",))
    fn = JNP_OPS[op]
    km = (M // n) * n

    def body(a):
        a = a[0]
        rs = a[:km]
        outs = (JK.ring_reduce_scatter(rs, "mpi", fn),
                JK.ring_allgather(a, "mpi"),
                JK.linear_allreduce(a, "mpi", fn),
                JK.linear_reduce_scatter(rs, "mpi", fn),
                JK.ring_allreduce(a, "mpi", fn),
                JK.ring_allreduce(a, "mpi", fn, bidir=True),
                JK.bidir_reduce_scatter(rs, "mpi", fn),
                JK.bidir_allgather(a, "mpi"))
        return tuple(o[None] for o in outs)

    f = jax.jit(jaxcompat.shard_map(body, mesh=mesh, in_specs=P("mpi"),
                                    out_specs=P("mpi"), check_vma=False))
    return [np.asarray(o) for o in f(x)]


def _port_run(n, xs, op):
    k = K.padded_chunk(M, n)
    km = (M // n) * n
    res = {}

    def go(name, make, out_numel):
        rings = K.Ring.local(n, 4 * n * k + 64, 4 * M + 256)
        outs = [torch.empty(out_numel, dtype=xs[0].dtype) for _ in range(n)]
        K.run_lockstep(rings, [make(rings[r], xs[r], outs[r])
                               for r in range(n)])
        res[name] = outs

    go("ring_rs", lambda e, x, o: K.reduce_scatter(e, x[:km], op, "ring",
                                                   1, o), km // n)
    go("ring_ag", lambda e, x, o: K.allgather(e, x, "ring", o), n * M)
    go("linear_ar", lambda e, x, o: K.allreduce(e, x, op, "linear", o),
       n * k)
    go("linear_rs", lambda e, x, o: K.reduce_scatter(
        e, x[:km], op, "linear", 1, o), km // n)
    go("ring_ar", lambda e, x, o: K.allreduce(e, x, op, "ring", o), n * k)
    go("bidir_ar", lambda e, x, o: K.allreduce(e, x, op, "bidir", o), n * k)
    go("bidir_rs", lambda e, x, o: K.reduce_scatter(
        e, x[:km], op, "bidir", 1, o), km // n)
    go("bidir_ag", lambda e, x, o: K.allgather(e, x, "bidir", o), n * M)
    return res


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_bits_equal(ref, got, what=""):
    """Bitwise, NaN-payload-blind (both NaN at the same places)."""
    ref, got = _bits(ref).reshape(-1), _bits(got).reshape(-1)
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype)
    if ref.dtype == np.uint16:
        rf = (ref.astype(np.uint32) << 16).view(np.float32)
        gf = (got.astype(np.uint32) << 16).view(np.float32)
    elif ref.dtype in (np.float32, np.float16):
        rf, gf = ref, got
        u = np.uint32 if ref.dtype == np.float32 else np.uint16
        ref, got = ref.view(u), got.view(u)
    else:
        np.testing.assert_array_equal(ref, got, err_msg=what)
        return
    rn, gn = np.isnan(rf), np.isnan(gf)
    np.testing.assert_array_equal(rn, gn, err_msg=f"{what}: NaN places")
    np.testing.assert_array_equal(ref[~rn], got[~gn], err_msg=what)


@pytest.mark.parametrize("op", list(JNP_OPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_schedules_bitwise_equal_to_pallas_kernels(n, dtype, op):
    """K1-K4: reduce-scatter, allgather, linear and ring allreduce, and
    the bidirectional forms, rank by rank."""
    h = _inputs(n, dtype)
    jx = jnp.asarray(h).astype(dtype)
    ref = _jax_run(n, jx, op)
    xs = [compat.tensor_from_numpy(np.asarray(jx)[r]) for r in range(n)]
    got = _port_run(n, xs, op)
    for i, name in enumerate(FUNCS):
        for r in range(n):
            t = got[name][r]
            if name.endswith("_ar"):
                t = t[:M]  # the pad is sliced off by the caller
            assert_bits_equal(ref[i][r], compat.tensor_to_numpy(t),
                              f"{name} rank {r}")


def _jax_pull(n, x, root):
    from ompi_tpu.parallel import collectives as C

    mesh = Mesh(np.array(jax.devices()[:n]), ("mpi",))

    def body(a):
        a = a[0]
        outs = (C.bcast(a, "mpi", root), C.alltoall(a, "mpi"),
                jax.lax.all_gather(a, "mpi"))
        return tuple(o[None] for o in outs)

    f = jax.jit(jaxcompat.shard_map(body, mesh=mesh, in_specs=P("mpi"),
                                    out_specs=P("mpi"), check_vma=False))
    return [np.asarray(o) for o in f(x)]


@pytest.mark.parametrize("dtype", ["float16", "bool", "int32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_pull_schedules_bitwise_equal_to_lax(n, dtype):
    """coll/device's pull schedules in lockstep (stage, then K2 copies
    from the staged inputs), twice over the same rings so the second call
    restages what the first read: bcast from rank n-1 (coll/xla's
    all_gather + index), alltoall and gather, against lax on the virtual
    mesh, rank by rank."""
    rng = np.random.default_rng(40 + n)
    h = rng.standard_normal((n, 2 * n * 3)).astype(np.float32)
    jx = jnp.asarray(h > 0 if dtype == "bool" else h * 100).astype(dtype)
    ref = _jax_pull(n, jx, n - 1)
    xs = [compat.tensor_from_numpy(np.asarray(jx)[r]) for r in range(n)]
    m = xs[0].numel()
    rings = K.Ring.local(n, 4 * m + 64, 0)
    for _ in range(2):
        outs = {name: [torch.empty(size, dtype=xs[0].dtype)
                       for _ in range(n)]
                for name, size in (("bcast", m), ("alltoall", m),
                                   ("gather", n * m))}
        K.run_lockstep(rings, [K.bcast(rings[r], xs[r], n - 1,
                                       outs["bcast"][r]) for r in range(n)])
        K.run_lockstep(rings, [K.alltoall(rings[r], xs[r],
                                          outs["alltoall"][r])
                               for r in range(n)])
        K.run_lockstep(rings, [K.gather(rings[r], xs[r], outs["gather"][r])
                               for r in range(n)])
        for i, name in enumerate(("bcast", "alltoall", "gather")):
            for r in range(n):
                assert_bits_equal(
                    ref[i][r].reshape(-1),
                    compat.tensor_to_numpy(outs[name][r]),
                    f"{name} rank {r}")
    assert [ring.linear for ring in rings] == [12] * n


@pytest.mark.parametrize("n", [2, 3, 4])
def test_rooted_and_ragged_pulls_in_lockstep(n):
    """coll/device's rooted and ragged pull schedules in lockstep, twice
    over the same rings: gather_to_root (the root alone copies),
    scatter_from_root (the root alone stages), and ragged pulls at
    per-peer offsets in the Allgatherv and Alltoallv layouts (empty
    blocks included), against numpy."""
    rng = np.random.default_rng(60 + n)
    counts = [int(c) for c in rng.integers(0, 4, n)]
    counts[-1] = 0
    mat = rng.integers(0, 4, (n, n))  # mat[p][q]: elements p sends q
    xs = [torch.from_numpy(rng.integers(-99, 99, 40).astype(np.int32))
          for _ in range(n)]
    rings = K.Ring.local(n, 4 * 40 + 64, 0)
    root = n - 1
    for _ in range(2):
        gat = [torch.full((n * 5,), -1, dtype=torch.int32) if r == root
               else None for r in range(n)]
        K.run_lockstep(rings, [K.gather_to_root(rings[r], xs[r][:5], root,
                                                gat[r]) for r in range(n)])
        assert torch.equal(gat[root], torch.cat([x[:5] for x in xs]))
        sca = [torch.empty(4, dtype=torch.int32) for _ in range(n)]
        K.run_lockstep(rings, [K.scatter_from_root(
            rings[r], xs[r][:4 * n] if r == root else None, root, sca[r])
            for r in range(n)])
        for r in range(n):
            assert torch.equal(sca[r], xs[root][4 * r:4 * r + 4])
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        agv = [torch.empty(sum(counts), dtype=torch.int32)
               for _ in range(n)]
        K.run_lockstep(rings, [K.ragged(
            rings[r], torch.int32, [(xs[r][:counts[r]], 0)],
            [(p, 0, counts[p], int(offs[p])) for p in range(n)], agv[r])
            for r in range(n)])
        want = torch.cat([xs[p][:counts[p]] for p in range(n)])
        assert all(torch.equal(a, want) for a in agv)
        a2v = [torch.empty(int(mat[:, r].sum()), dtype=torch.int32)
               for r in range(n)]
        soff = [np.concatenate([[0], np.cumsum(row)[:-1]]) for row in mat]
        roff = [np.concatenate([[0], np.cumsum(mat[:, r])[:-1]])
                for r in range(n)]
        K.run_lockstep(rings, [K.ragged(
            rings[r], torch.int32, [(xs[r][:int(mat[r].sum())], 0)],
            [(p, int(soff[p][r]), int(mat[p][r]), int(roff[r][p]))
             for p in range(n)], a2v[r]) for r in range(n)])
        for r in range(n):
            want = torch.cat([xs[p][int(soff[p][r]):int(soff[p][r])
                                    + int(mat[p][r])] for p in range(n)])
            assert torch.equal(a2v[r], want), r
    assert [ring.linear for ring in rings] == [16] * n


def _binomial_oracle(xs, fn, root):
    """The reference's tree written out over numpy (coll/xla.py
    ``_reduce_binomial``): in round mask the vrank v with v % 2mask ==
    mask sends to v - mask, which folds fn(its partial, the sent one)."""
    n = len(xs)
    acc = [jnp.asarray(x) for x in xs]
    mask = 1
    while mask < n:
        sent = {(v - mask + root) % n: acc[(v + root) % n]
                for v in range(n) if v % (2 * mask) == mask}
        for d, got in sent.items():
            acc[d] = fn(acc[d], got)
        mask <<= 1
    return np.asarray(acc[root])


@pytest.mark.parametrize("op", list(JNP_OPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_binomial_reduce_in_lockstep(n, dtype, op):
    """binomial_reduce with K1 as the combine, every root, in lockstep:
    the reference's rounds and operand order, bitwise (NaN and -0
    included); ceil(log2 n) + 1 steps on every rank, None off the root."""
    x = jnp.asarray(_inputs(n, dtype)[:n]).astype(dtype)
    xs = [compat.tensor_from_numpy(np.asarray(x)[r]) for r in range(n)]
    rounds = K.binomial_rounds(n, 0)
    assert len(rounds) == (n - 1).bit_length()
    assert sorted(s for pairs in rounds for s, _ in pairs) == \
        list(range(1, n))  # every non-root sends once
    rings = K.Ring.local(n, 4 * M + 64, 0)
    for root in range(n):
        outs = [torch.empty(M, dtype=xs[0].dtype) if r == root else None
                for r in range(n)]
        K.run_lockstep(rings, [K.binomial_reduce(
            rings[r], xs[r], lambda c, g, d: K.ring_rs_hop(c, g, d, op),
            root, outs[r]) for r in range(n)])
        want = _binomial_oracle([np.asarray(x)[r] for r in range(n)],
                                JNP_OPS[op], root)
        assert_bits_equal(want, compat.tensor_to_numpy(outs[root]),
                          f"root {root}")
    assert [ring.linear for ring in rings] == \
        [n * (len(rounds) + 1)] * n


@pytest.mark.parametrize("n", [2, 3, 4])
def test_prefix_in_lockstep(n):
    """prefix over the staged inputs, every row count 0..n: K3 over the
    leading rows in rank order (one row: K2's copy; none: nothing
    written), bitwise against jnp's fold for float32 / bfloat16 / int32 x
    SUM / PROD / MIN / MAX."""
    rings = K.Ring.local(n, 4 * M + 64, 0)
    for dtype in ("float32", "bfloat16", "int32"):
        x = np.asarray(jnp.asarray(_inputs(n, dtype)[:n]).astype(dtype))
        xs = [compat.tensor_from_numpy(x[r]) for r in range(n)]
        for op, fn in JNP_OPS.items():
            for rows in range(n + 1):
                outs = [torch.zeros(M, dtype=xs[0].dtype) for _ in range(n)]
                K.run_lockstep(rings, [K.prefix(rings[r], xs[r], op, rows,
                                                outs[r]) for r in range(n)])
                if rows == 0:
                    assert not any(o.any() for o in outs)
                    continue
                acc = jnp.asarray(x[0])
                for p in range(1, rows):
                    acc = fn(acc, jnp.asarray(x[p]))
                for r in range(n):
                    assert_bits_equal(np.asarray(acc),
                                      compat.tensor_to_numpy(outs[r]),
                                      f"{dtype} {op} rows {rows}")


def test_ring_ag_hop_copies_any_dtype():
    """K2 copies bytes: float16 and bool through the plain version on the
    CPU (no launch); an operand of another byte count or dtype is
    refused."""
    K.reset_launches()
    for src in (torch.arange(9, dtype=torch.float16) - 4.5,
                torch.arange(9) % 3 == 0):
        dst, dst2 = torch.empty_like(src), torch.empty_like(src)
        K.ring_ag_hop(src, dst, dst2=dst2)
        assert torch.equal(dst, src) and torch.equal(dst2, src)
    assert K.ring_ag_hop.launches == 0
    with pytest.raises(ValueError, match="bytes"):
        K.ring_ag_hop(torch.zeros(8, dtype=torch.bool),
                      torch.zeros(9, dtype=torch.bool))
    with pytest.raises(ValueError, match="mixed dtypes"):
        K.ring_ag_hop(torch.zeros(8, dtype=torch.float16),
                      torch.zeros(8, dtype=torch.bfloat16))


@pytest.mark.parametrize("op", list(JNP_OPS))
def test_combine_special_values_match_jnp(op):
    """NaN propagation and the order of -0 and +0, in both operand
    orders, as jnp.minimum / jnp.maximum / add / multiply give them."""
    v = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf], np.float32)
    a = np.repeat(v, len(v))
    b = np.tile(v, len(v))
    for dt in ("float32", "bfloat16"):
        ja = jnp.asarray(a).astype(dt)
        jb = jnp.asarray(b).astype(dt)
        ref = np.asarray(JNP_OPS[op](ja, jb))
        got = K.combine(op, compat.tensor_from_numpy(np.asarray(ja)),
                        compat.tensor_from_numpy(np.asarray(jb)))
        assert_bits_equal(ref, compat.tensor_to_numpy(got), f"{op} {dt}")


def test_ring_order_oracle():
    """Chunk c of a clockwise ring is folded by ranks c+1, ..., c+n."""
    assert K.ring_order(4, 0, 1) == [1, 2, 3, 0]
    assert K.ring_order(3, 1, -1) == [0, 2, 1]


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers compute the plain version and count
    no launch (the count is of kernel launches only)."""
    K.reset_launches()
    a = torch.arange(10, dtype=torch.float32)
    dst, dst2 = torch.empty(10), torch.empty(10)
    K.ring_rs_hop(a, a, dst, "MPI_SUM", dst2=dst2)
    K.ring_ag_hop(a, dst)
    K.linear_fold([a, a, a], dst2, "MPI_PROD")
    assert torch.equal(dst, a) and torch.equal(dst2, a ** 3)
    assert [k.launches for k in K.KERNELS] == [0] * len(K.KERNELS)


def test_wrappers_check_operands():
    a = torch.zeros(8)
    with pytest.raises(ValueError, match="elements"):
        K.ring_rs_hop(a, torch.zeros(9), torch.zeros(8), "MPI_SUM")
    with pytest.raises(ValueError, match="mixed dtypes"):
        K.ring_rs_hop(a, torch.zeros(8, dtype=torch.float64),
                      torch.zeros(8), "MPI_SUM")
    with pytest.raises(ValueError, match="unsupported dtype"):
        K.linear_fold([torch.zeros(8, dtype=torch.float64)] * 2,
                      torch.zeros(8, dtype=torch.float64), "MPI_SUM")
    with pytest.raises(ValueError, match="non-contiguous"):
        K.ring_ag_hop(torch.zeros(8, 2)[:, 0], torch.zeros(8))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails surfaces as KernelError with its output —
    never a silent fallback to the plain versions."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc: no CUDA here' >&2\n"
                    "exit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(K, "build_dir", lambda: str(tmp_path / "b"))
    monkeypatch.setattr(K, "_nvcc", lambda: str(fake))
    with pytest.raises(K.KernelError, match="no CUDA here"):
        K.build()
    monkeypatch.setattr(K, "_nvcc", lambda: str(tmp_path / "missing"))
    with pytest.raises(K.KernelError, match="cannot run"):
        K.build()
    assert not os.listdir(tmp_path / "b") or \
        not any(p.endswith(".so") for p in os.listdir(tmp_path / "b"))


@pytest.mark.gpu
def test_kernels_bitwise_equal_to_plain_on_card():
    """On a CUDA card: each kernel against its plain version, every
    dtype x op, aligned and unaligned ragged shapes (chip_smoke.py runs
    the same at the main path's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    for dtype in DTYPES_T:
        for numel, off in ((4099, 0), (1027, 1)):
            if dtype == torch.int32:
                srcs = [torch.randint(-100, 100, (numel + off,), generator=g,
                                      device=dev, dtype=dtype)[off:]
                        for _ in range(3)]
            else:
                srcs = [torch.randn(numel + off, generator=g,
                                    device=dev).to(dtype)[off:]
                        for _ in range(3)]
            for op in K.OP_CODES:
                d, p = torch.empty_like(srcs[0]), torch.empty_like(srcs[0])
                K.ring_rs_hop(srcs[0], srcs[1], d, op)
                K.ring_rs_hop_plain(srcs[0], srcs[1], p, op)
                assert_bits_equal(compat.tensor_to_numpy(p),
                                  compat.tensor_to_numpy(d), op)
                K.linear_fold(srcs, d, op)
                K.linear_fold_plain(srcs, p, op)
                assert_bits_equal(compat.tensor_to_numpy(p),
                                  compat.tensor_to_numpy(d), op)
            K.ring_ag_hop(srcs[2], d)
            assert torch.equal(d, srcs[2])
    for dtype in (torch.float16, torch.bool):  # K2 copies any dtype
        src = torch.randn(1027, generator=g, device=dev)[1:]
        src = src > 0 if dtype == torch.bool else src.to(dtype)
        dst = torch.empty_like(src)
        K.ring_ag_hop(src, dst)
        assert torch.equal(dst.view(torch.uint8), src.view(torch.uint8))

