"""The port's one-sided kernels (ompi_tpu_torch.osc.cuda_kernels, K7-K10)
against the JAX package's Pallas kernels.

Same inputs, made from a seed with numpy, go through
``ompi_tpu.osc.pallas_kernels.apply`` / ``read`` in interpret mode and
through the port's wrappers, which take their plain versions for CPU
tensors. Tolerance: none — float32, bfloat16 and int32 windows are
bitwise equal, except that where both sides are NaN the NaN payload is
not compared (ROADMAP queue 3). The edges are the reference's own: a
start in [-size, 0) counts from the end and is then clamped into
[0, size-k] (K7, contiguous K9); strided applies drop what falls outside
the window (K8); strided reads count [-size, 0) from the end and fill
NaN / INT_MIN outside [-size, size) (K9). K10's plain version runs a
coloured round over in-process arena slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.osc import pallas_kernels as JK
from ompi_tpu_torch import compat
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.osc import cuda_kernels as O
from tests.test_torch_coll_cuda_kernels import assert_bits_equal

SIZE, KE = 64, 5  # window elements, payload elements
KINDS = ("put", "replace", "sum", "min", "max", "prod")
DTYPES = ("float32", "bfloat16", "int32")
#: (stride, displacements): d = 0, d + k = size, clamped and
#: out-of-range starts, negative starts in and below [-size, 0)
APPLY_CASES = [(1, (0, SIZE - KE, SIZE - 2, 100, -3, -SIZE, -70)),
               (2, (0, 3, SIZE - 4, SIZE - 1, -5, -70, 100)),
               (8, (0, 7, 30, 63, -9, -70))]
READ_CASES = [(1, (0, SIZE - KE, SIZE - 2, 100, -3, -SIZE, -70)),
              (2, (0, 3, SIZE - 4, -5, -SIZE - 1, -70)),
              (8, (0, 30, 63, -9, -70)),
              (0, (0, 11, -3, -70)),
              (-3, (10, 2, -60, 80))]


def _arrays(dtype, seed):
    """(window, payload) as numpy arrays in the jax dtype, carrying NaN
    and both zeros in float types and wrapping values in int32."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        w = rng.integers(-2**31, 2**31 - 1, SIZE, dtype=np.int64)
        p = rng.integers(-2**31, 2**31 - 1, KE, dtype=np.int64)
        return w.astype(np.int32), p.astype(np.int32)
    w = (rng.standard_normal(SIZE) * 10.0).astype(np.float32)
    p = (rng.standard_normal(KE) * 10.0).astype(np.float32)
    w[[1, 9, 60]] = np.nan
    w[[2, 3, 61]] = 0.0
    w[[4, 62]] = -0.0
    p[1] = np.nan
    p[2] = -0.0
    p[3] = 0.0
    return (np.asarray(jnp.asarray(w).astype(dtype)),
            np.asarray(jnp.asarray(p).astype(dtype)))


@pytest.mark.parametrize("stride,disps", APPLY_CASES,
                         ids=[f"s{s}" for s, _ in APPLY_CASES])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_bitwise_equal_to_pallas(dtype, kind, stride, disps):
    """K7 (stride 1) and K8 (strided) in place == the reference's new
    window, at every edge displacement."""
    w, p = _arrays(dtype, 3)
    for d in disps:
        ref = JK.apply(jnp.asarray(w), jnp.asarray(p), d, kind, stride,
                       interpret=True)
        got = compat.tensor_from_numpy(w)
        O.apply(got, compat.tensor_from_numpy(p), d, kind, stride)
        assert_bits_equal(np.asarray(ref), compat.tensor_to_numpy(got),
                          f"{dtype} {kind} disp {d} stride {stride}")


@pytest.mark.parametrize("stride,disps", READ_CASES,
                         ids=[f"s{s}" for s, _ in READ_CASES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_read_bitwise_equal_to_pallas(dtype, stride, disps):
    """K9: the clamped contiguous slice and the strided gather with its
    fill values, bitwise (the fill's NaN is the canonical quiet NaN)."""
    w, _ = _arrays(dtype, 4)
    for d in disps:
        ref = np.asarray(JK.read(jnp.asarray(w), d, KE, stride,
                                 interpret=True))
        out = torch.empty(KE, dtype=getattr(torch, dtype))
        got = O.rma_read(compat.tensor_from_numpy(w), d, stride, out)
        assert got is out
        assert_bits_equal(ref, compat.tensor_to_numpy(got),
                          f"{dtype} disp {d} stride {stride}")
        if stride != 1:  # the fill itself, NaN payload included
            idx = d + stride * np.arange(KE)
            fill = (idx < -SIZE) | (idx >= SIZE)
            u = {"float32": np.uint32, "bfloat16": np.uint16,
                 "int32": np.int32}[dtype]
            assert (compat.tensor_to_numpy(got).view(u)[fill]
                    == ref.view(u)[fill]).all(), (dtype, d, stride)


def test_out_of_range_edges_pinned():
    """The reference's edge semantics, spelt out on a float32 window of
    10: K7 puts of 4 at 8 and at -2 both land at 6..9; a strided apply
    at 7 with stride 2 writes 7 and 9 only; a strided read past the end
    fills NaN; int32 fills INT_MIN."""
    w = torch.arange(10, dtype=torch.float32)
    for d in (8, -2):
        x = w.clone()
        O.rma_apply(x, torch.full((4,), 100.0), d, "put")
        assert x.tolist() == [0, 1, 2, 3, 4, 5, 100, 100, 100, 100]
    x = w.clone()
    O.rma_apply_strided(x, torch.full((4,), 100.0), 7, 2, "sum")
    assert x.tolist() == [0, 1, 2, 3, 4, 5, 6, 107, 8, 109]
    got = O.rma_read(w, 7, 2, torch.empty(4))
    assert got[:2].tolist() == [7, 9] and torch.isnan(got[2:]).all()
    got = O.rma_read(torch.arange(10, dtype=torch.int32), -13, 2,
                     torch.empty(4, dtype=torch.int32))
    assert got.tolist() == [-2**31, -2**31, 1, 3]


@pytest.mark.parametrize("n", [3, 4])
def test_permute_recv_round_over_local_slots(n):
    """K10's plain version in one coloured round over in-process arena
    slots: every rank with a target stages its payload in its own slot,
    every rank with a source pulls that rank's slot, and a rank with no
    source (-1) lands zeros — including a self edge."""
    rings = K.Ring.local(n, 0, 256)
    # one partial matching: 0 -> 2, 1 -> 1 (self), n-1 -> 0; n-1 gets none
    edges = [(0, 2), (1, 1), (n - 1, 0)]
    tgt = {s: d for s, d in edges}
    src = {d: s for s, d in edges}
    rng = np.random.default_rng(5)
    pay = {s: torch.from_numpy(rng.standard_normal(7).astype(np.float32))
           for s in tgt}
    for r in range(n):  # stage
        if r in tgt:
            rings[r].slot(r, 1, 0).view(torch.float32)[:7].copy_(pay[r])
    for r in range(n):  # land
        out = torch.full((7,), 9.0)
        peer = (rings[r].slot(src[r], 1, 0).view(torch.float32)[:7]
                if r in src else None)
        got = O.rma_permute_recv(peer, out)
        want = pay[src[r]] if r in src else torch.zeros(7)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), r


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors compute the plain versions and count no launch."""
    O.reset_launches()
    w = torch.zeros(8, dtype=torch.int32)
    O.apply(w, torch.ones(2, dtype=torch.int32), 1, "sum")
    O.apply(w, torch.full((2,), 5, dtype=torch.int32), 0, "max", stride=3)
    O.rma_read(w, 0, 1, torch.empty(4, dtype=torch.int32))
    O.rma_permute_recv(None, torch.empty(3, dtype=torch.int32))
    assert w.tolist() == [5, 1, 1, 5, 0, 0, 0, 0]
    assert [k.launches for k in O.KERNELS] == [0] * len(O.KERNELS)


def test_wrappers_check_operands():
    w = torch.zeros(8)
    with pytest.raises(ValueError, match="mixed dtypes"):
        O.rma_apply(w, torch.zeros(2, dtype=torch.float64), 0, "sum")
    with pytest.raises(ValueError, match="unsupported kind"):
        O.rma_apply(w, torch.zeros(2), 0, "band")
    with pytest.raises(ValueError, match="into a window"):
        O.rma_apply(w, torch.zeros(9), 0, "put")
    with pytest.raises(ValueError, match="1-D and contiguous"):
        O.rma_apply_strided(w, torch.zeros(4, 2)[:, 0], 0, 2, "put")
    with pytest.raises(ValueError, match="from a window"):
        O.rma_read(w, 0, 1, torch.empty(9))
    with pytest.raises(ValueError, match="unsupported dtype"):
        O.rma_read(torch.zeros(8, dtype=torch.int16), 0, 2,
                   torch.empty(2, dtype=torch.int16))
    with pytest.raises(ValueError, match="does not match"):
        O.rma_permute_recv(torch.zeros(3), torch.empty(4))


def test_zero_length_and_nonpositive_strides_touch_nothing():
    w = torch.arange(6, dtype=torch.float32)
    O.rma_apply(w, torch.empty(0), 3, "put")
    O.rma_apply_strided(w, torch.ones(3), 1, 0, "put")
    O.rma_apply_strided(w, torch.ones(3), 4, -1, "put")
    assert w.tolist() == list(range(6))


@pytest.mark.gpu
def test_kernels_bitwise_equal_to_plain_on_card():
    """On a CUDA card: K7-K10 against their plain versions for every
    dtype and kind at the edge displacements (chip_smoke.py runs the same
    at the main paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    for dtype in DTYPES:
        w0, p0 = (compat.tensor_from_numpy(a).to(dev)
                  for a in _arrays(dtype, 6))
        for stride, disps in APPLY_CASES:
            for kind in KINDS:
                for d in disps:
                    got, want = w0.clone(), w0.clone()
                    O.apply(got, p0, d, kind, stride)
                    if stride == 1:
                        O.rma_apply_plain(want, p0, d, kind)
                    else:
                        O.rma_apply_strided_plain(want, p0, d, stride, kind)
                    assert_bits_equal(compat.tensor_to_numpy(want),
                                      compat.tensor_to_numpy(got), kind)
        for stride, disps in READ_CASES:
            for d in disps:
                got = O.rma_read(w0, d, stride, torch.empty_like(p0))
                want = torch.empty_like(p0)
                O.rma_read_plain(w0, d, stride, want)
                assert_bits_equal(compat.tensor_to_numpy(want),
                                  compat.tensor_to_numpy(got), "read")
        for src in (p0, None):
            got = O.rma_permute_recv(src, torch.empty_like(p0))
            want = torch.empty_like(p0)
            O.rma_permute_recv_plain(src, want)
            assert_bits_equal(compat.tensor_to_numpy(want),
                              compat.tensor_to_numpy(got), "permute")
