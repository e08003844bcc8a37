"""The port's ops/ (attention, ring attention, Ulysses, MoE) against the
JAX package's ``ompi_tpu.ops``.

The distributed ops run in one 4-rank launcher job of the port (``--mca
device_plane on --mca device_plane_platform cpu``) and in this process
for the reference (``shard_map`` over a 4-device sub-mesh of the 8
virtual CPU devices), on the same seeded numpy inputs: the counterparts
of ``tests/test_ops.py`` (ring attention and Ulysses, causal and not;
Ulysses == ring; MoE against the reference and the per-token oracle) at
the reference's float32 sizes and tolerances (2e-5 attention, 1e-4
MoE), and a bfloat16 pass within ``BF16_TOL``. The single-device
functions (``mha``, ``online_softmax_block``, ``finalize_online_softmax``,
``top1_routing``, ``mha_auto``) run against the jnp functions in this
process.
"""

import json
import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ompi_tpu.ops import attention as ratt  # noqa: E402
from ompi_tpu.ops import moe as rmoe  # noqa: E402
from ompi_tpu.ops.ring_attention import (  # noqa: E402
    ring_attention as ref_ring_attention,
)
from ompi_tpu.ops.ulysses import (  # noqa: E402
    ulysses_attention as ref_ulysses_attention,
)
from ompi_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from ompi_tpu.util import jaxcompat  # noqa: E402
from ompi_tpu_torch import compat  # noqa: E402
from ompi_tpu_torch.ops import attention as att  # noqa: E402
from ompi_tpu_torch.ops import moe  # noqa: E402
from ompi_tpu_torch.runtime import launcher as port_launcher  # noqa: E402

N = 4
PORT_MCA = dict(compat.mca_from_reference({"device_plane": "on"}),
                device_plane_platform="cpu")
#: bfloat16 outputs against the reference's: within two bfloat16
#: roundings of the largest output (the products are exact in float32 on
#: both sides; the float32 sums' order differs)
BF16_TOL = 2.0 ** -7

#: the inputs, shared verbatim by the port job and this process
_INPUTS = """
def attn_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]

#: (name, op, causal, seed, (B, T, H, D), dtype)
ATTN_CASES = [
    ("ring_noncausal", "ring", False, 0, (2, 16, 2, 8), "float32"),
    ("ring_causal", "ring", True, 0, (2, 16, 2, 8), "float32"),
    ("ulysses_noncausal", "ulysses", False, 3, (2, 16, 4, 8), "float32"),
    ("ulysses_causal", "ulysses", True, 3, (2, 16, 4, 8), "float32"),
    ("agree_ulysses", "ulysses", True, 4, (1, 8, 8, 4), "float32"),
    ("agree_ring", "ring", True, 4, (1, 8, 8, 4), "float32"),
    ("ring_bf16", "ring", True, 5, (2, 32, 4, 16), "bfloat16"),
    ("ulysses_bf16", "ulysses", True, 5, (2, 32, 4, 16), "bfloat16"),
]

#: the backwards: (name, op, causal, seed, (B, T, H, D)), float32, each
#: against jax.vjp of the reference op on the same cotangent
GRAD_CASES = [
    ("ring_noncausal_grad", "ring", False, 0, (2, 16, 2, 8)),
    ("ring_causal_grad", "ring", True, 0, (2, 16, 2, 8)),
    ("ulysses_causal_grad", "ulysses", True, 3, (2, 16, 4, 8)),
]

def cotangent(seed, shape):
    return np.random.default_rng(seed + 100).standard_normal(shape).astype(
        np.float32)

def moe_inputs(n):
    rng = np.random.default_rng(2)
    t_local, d, f, e_local = 16, 8, 16, 1
    e_total = e_local * n
    x = rng.standard_normal((n * t_local, d)).astype(np.float32)
    wg = rng.standard_normal((d, e_total)).astype(np.float32)
    w1 = rng.standard_normal((e_total, d, f)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((e_total, f, d)).astype(np.float32) * 0.1
    return x, wg, w1, w2
"""

_PORT_PROG = """
import json
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.ops import moe
from ompi_tpu_torch.ops.ring_attention import ring_attention
from ompi_tpu_torch.ops.ulysses import ulysses_attention
from ompi_tpu_torch.parallel import DeviceCommunicator, P, make_mesh
world = mpi.Init()
n, r = world.size, world.rank
mesh = make_mesh(("sp",), (n,))
dc = DeviceCommunicator(mesh, "sp")
out_dir = {out_dir!r}
{inputs}
OPS = {{"ring": ring_attention, "ulysses": ulysses_attention}}
for name, op, causal, seed, shape, dtype in ATTN_CASES:
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in attn_inputs(seed, shape))
    f = dc.run(lambda a, b, c: OPS[op](a, b, c, "sp", causal=causal),
               P(None, "sp"))
    got = dc.assemble(f(q, k, v), P(None, "sp"))
    if r == 0:
        np.save(f"{{out_dir}}/{{name}}.npy", got)

def attn_grads(a, b, c, g, op=None, causal=None):
    a, b, c = (t.requires_grad_() for t in (a, b, c))
    out = OPS[op](a, b, c, "sp", causal=causal)
    return torch.autograd.grad(out, (a, b, c), g)
for name, op, causal, seed, shape in GRAD_CASES:
    q, k, v = (torch.from_numpy(a) for a in attn_inputs(seed, shape))
    ct = torch.from_numpy(cotangent(seed, shape))
    f = dc.run(lambda a, b, c, g: attn_grads(a, b, c, g, op, causal),
               P(None, "sp"))
    got = dc.assemble(f(q, k, v, ct), P(None, "sp"))
    if r == 0:
        for which, a in zip("qkv", got):
            np.save(f"{{out_dir}}/{{name}}_{{which}}.npy", a)

x, wg, w1_all, w2_all = moe_inputs(n)
twg, w1, w2 = compat.moe_params_from_reference(wg, w1_all, w2_all, r, n)
t_local = x.shape[0] // n
xl = torch.from_numpy(x[r * t_local:(r + 1) * t_local])
# the backward: every input's gradient for a seeded cotangent (wg's is
# this rank's partial, as jax.vjp inside shard_map gives it)
ins = [t.clone().requires_grad_() for t in (xl, twg, w1, w2)]
cty = torch.from_numpy(cotangent(2, x.shape)[r * t_local:(r + 1) * t_local])
with mesh:
    gx, gwg, gw1, gw2 = torch.autograd.grad(
        moe.moe_ffn(*ins, "sp"), ins, cty)
    got = dc.assemble((gx, gwg[None], gw1, gw2), P("sp"))
if r == 0:
    for which, a in zip(("x", "wg", "w1", "w2"), got):
        np.save(f"{{out_dir}}/moe_grad_{{which}}.npy", a)
s = pvar.session()
with mesh:
    y = moe.moe_ffn(xl, twg, w1, w2, "sp")
cap = max(int(1.25 * t_local / w1_all.shape[0]), 1)
route = moe.top1_routing(xl @ twg, cap)
from ompi_tpu_torch.parallel.device_comm import assemble
got = assemble(mesh, y, P("sp"))
# moe_ffn and top1_routing each recorded the drop count once
drops = s.read("serve_dropped_tokens")
with mesh:
    try:
        ulysses_attention(*(torch.zeros(1, 4, 2, 4) for _ in range(3)),
                          "sp")
        uly_err = None
    except errors.MPIError as e:
        uly_err = [e.error_class, str(e)]
with open(f"{{out_dir}}/moe_r{{r}}.json", "w") as fh:
    json.dump({{"drops": drops, "dropped": int(route.dropped),
               "uly_err": uly_err}}, fh)
if r == 0:
    np.save(f"{{out_dir}}/moe.npy", got)
mpi.Finalize()
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("ops")
    src = textwrap.dedent(_PORT_PROG).format(out_dir=str(d), inputs=_INPUTS)
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    try:
        rc = port_launcher.launch([sys.executable, path], N, mca=PORT_MCA,
                                  timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job exited {rc}"
    return d


def _ns():
    ns = {"np": np}
    exec(_INPUTS, ns)
    return ns


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} devices")
    return ref_make_mesh(("sp",), (N,), jax.devices()[:N])


def _ref_attention(mesh, op, causal, q, k, v):
    fn = ref_ring_attention if op == "ring" else ref_ulysses_attention
    f = jax.jit(jaxcompat.shard_map(
        lambda a, b, c: fn(a, b, c, "sp", causal=causal), mesh=mesh,
        in_specs=(JP(None, "sp"),) * 3, out_specs=JP(None, "sp"),
        check_vma=False))
    return np.asarray(f(q, k, v))


def _case(name):
    return next(c for c in _ns()["ATTN_CASES"] if c[0] == name)


def _bf16(a):
    return (a.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("name", ["ring_noncausal", "ring_causal",
                                  "ulysses_noncausal", "ulysses_causal"])
def test_context_parallel_matches_reference_and_mha(port, mesh, name):
    """Ring attention and Ulysses, causal and not, float32: against the
    reference's schedule and against the single-device mha, atol 2e-5
    (tests/test_ops.py's)."""
    _, op, causal, seed, shape, _ = _case(name)
    q, k, v = _ns()["attn_inputs"](seed, shape)
    got = np.load(port / f"{name}.npy")
    ref = _ref_attention(mesh, op, causal, q, k, v)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    oracle = np.asarray(ratt.mha(jnp.array(q), jnp.array(k), jnp.array(v),
                                 causal=causal))
    np.testing.assert_allclose(got, oracle, atol=2e-5)


def test_ulysses_ring_agree(port):
    """Both context-parallel schedules compute the same attention."""
    np.testing.assert_allclose(np.load(port / "agree_ulysses.npy"),
                               np.load(port / "agree_ring.npy"), atol=2e-5)


@pytest.mark.parametrize("name", ["ring_bf16", "ulysses_bf16"])
def test_bfloat16_within_bound(port, mesh, name):
    """bfloat16 q, k, v: the port's output within BF16_TOL * max|ref| of
    the reference's (bfloat16 comes back as its uint16 bits)."""
    _, op, causal, seed, shape, _ = _case(name)
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16)
               for a in _ns()["attn_inputs"](seed, shape))
    ref = _ref_attention(mesh, op, causal, q, k, v).astype(np.float32)
    got = _bf16(np.load(port / f"{name}.npy"))
    assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()


def _moe_oracle(x, wg, w1_all, w2_all, cap):
    """tests/test_ops.py's per-shard numpy oracle (top-1, capacity)."""
    t, d = x.shape
    e = wg.shape[1]
    logits = x @ wg
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g = g / g.sum(-1, keepdims=True)
    pick = g.argmax(-1)
    counts = np.zeros(e, np.int64)
    out = np.zeros_like(x)
    for i in range(t):
        ex = pick[i]
        if counts[ex] < cap:
            counts[ex] += 1
            h = np.maximum(x[i] @ w1_all[ex], 0.0)
            out[i] = g[i, ex] * (h @ w2_all[ex])
    return out


def test_moe_ffn_matches_reference_and_oracle(port, mesh):
    """moe_ffn over 4 ranks (1 expert a rank, the reference's weights
    through compat.moe_params_from_reference): within 1e-4 of the
    reference's and of the oracle, per shard."""
    x, wg, w1, w2 = _ns()["moe_inputs"](N)
    t_local = x.shape[0] // N
    cap = max(int(1.25 * t_local / w1.shape[0]), 1)
    f = jax.jit(jaxcompat.shard_map(
        lambda xx, ww1, ww2: rmoe.moe_ffn(xx, jnp.array(wg), ww1, ww2,
                                          "sp"),
        mesh=mesh, in_specs=(JP("sp"), JP("sp"), JP("sp")),
        out_specs=JP("sp"), check_vma=False))
    ref = np.asarray(f(x, w1, w2))
    got = np.load(port / "moe.npy")
    np.testing.assert_allclose(got, ref, atol=1e-4)
    for s in range(N):
        sl = slice(s * t_local, (s + 1) * t_local)
        np.testing.assert_allclose(
            got[sl], _moe_oracle(x[sl], wg, w1, w2, cap), atol=1e-4)


def test_moe_stats_and_ulysses_refusal(port):
    """Each rank metered its drops (moe_ffn and top1_routing record them
    on every eager call), and Ulysses with 2 heads over 4 ranks raised
    MPIError(ERR_ARG) with the reference's text on every rank."""
    from ompi_tpu_torch import errors

    for r in range(N):
        doc = json.loads((port / f"moe_r{r}.json").read_text())
        assert doc["drops"] == 2 * doc["dropped"], doc
        assert doc["uly_err"][0] == errors.ERR_ARG
        assert doc["uly_err"][1].startswith(
            "ulysses: 2 heads not divisible by axis size 4")


def _pair(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (8, 0), (3, 5)])
def test_mha_against_jnp(causal, offsets):
    """mha float32 against the jnp function, with query / key offsets."""
    q, k, v = _pair(10, (2, 8, 3, 16))
    ref = np.asarray(ratt.mha(jnp.array(q), jnp.array(k), jnp.array(v),
                              causal=causal, q_offset=offsets[0],
                              k_offset=offsets[1]))
    got = att.mha(_t(q), _t(k), _t(v), causal=causal, q_offset=offsets[0],
                  k_offset=offsets[1]).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_mha_bfloat16_against_jnp():
    """bfloat16 operands with float32 products: within BF16_TOL of the
    jnp result's scale."""
    q, k, v = _pair(11, (2, 16, 2, 32))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(ratt.mha(jq, jk, jv)).astype(np.float32)
    got = att.mha(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() \
        <= BF16_TOL * np.abs(ref).max()


@pytest.mark.parametrize("masked", [False, True])
def test_online_softmax_block_against_jnp(masked):
    """One accumulation step from running carries (a fully-masked row
    included when masked), and the finalize: within 2e-6."""
    q, k, v = _pair(12, (1, 6, 2, 4))
    rng = np.random.default_rng(13)
    o = rng.standard_normal((1, 6, 2, 4)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (1, 2, 6)).astype(np.float32)
    m = rng.standard_normal((1, 2, 6)).astype(np.float32)
    m[0, 0, 1] = -np.inf
    l[0, 0, 1] = 0.0
    mask = None
    if masked:
        mask = np.tril(np.ones((6, 6), bool))
        mask[1] = mask[2] = False  # row 1 also has no running max
    ref = ratt.online_softmax_block(
        jnp.array(q), jnp.array(k), jnp.array(v), jnp.array(o),
        jnp.array(l), jnp.array(m),
        mask=None if mask is None else jnp.array(mask))
    got = att.online_softmax_block(
        _t(q), _t(k), _t(v), _t(o), _t(l), _t(m),
        mask=None if mask is None else torch.from_numpy(mask))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    np.testing.assert_allclose(
        att.finalize_online_softmax(got[0], got[1]).numpy(),
        np.asarray(ratt.finalize_online_softmax(ref[0], ref[1])),
        atol=2e-6)


def test_online_softmax_blocks_match_full():
    """Blockwise accumulation == full softmax on one device (the
    reference test's shapes)."""
    rng = np.random.default_rng(1)
    B, T, H, D = 1, 16, 2, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(
        np.float32)) for _ in range(3))
    o = torch.zeros_like(q)
    l = torch.zeros((B, H, T))
    m = torch.full((B, H, T), -torch.inf)
    for blk in range(4):
        kb, vb = k[:, blk * 4:(blk + 1) * 4], v[:, blk * 4:(blk + 1) * 4]
        o, l, m = att.online_softmax_block(q, kb, vb, o, l, m)
    out = att.finalize_online_softmax(o, l)
    ref = att.mha(q, k, v, causal=False)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_auto_on_cpu_is_mha(causal):
    """On CPU tensors mha_auto is mha, bitwise (even at shapes the card's
    fast path would take)."""
    q, k, v = (_t(a) for a in _pair(14, (1, 128, 1, 128)))
    a = att.mha_auto(q, k, v, causal=causal)
    b = att.mha(q, k, v, causal=causal)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_top1_routing_against_jnp(cap):
    """dispatch, counts and dropped exactly; combine within 1e-6."""
    rng = np.random.default_rng(15)
    logits = rng.standard_normal((40, 5)).astype(np.float32)
    logits[7] = logits[3]  # a tie of whole rows
    logits[9, 1] = logits[9, 2] = logits[9].max() + 1.0  # first max wins
    ref = rmoe.top1_routing(jnp.array(logits), cap)
    got = moe.top1_routing(torch.from_numpy(logits), cap)
    np.testing.assert_array_equal(got.dispatch.numpy(),
                                  np.asarray(ref.dispatch))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert int(got.dropped) == int(ref.dropped)
    assert got.counts.dtype == torch.int32 and got.dropped.dtype == \
        torch.int32
    np.testing.assert_allclose(got.combine.numpy(), np.asarray(ref.combine),
                               atol=1e-6)


def _ref_vjp(mesh, fn, ins, ct, in_spec, out_specs):
    """jax.vjp of ``fn`` inside shard_map: every input's cotangent for
    ``ct`` (a replicated input's is each device's partial)."""
    def body(*args):
        _, vjp = jax.vjp(fn, *args[:-1])
        return vjp(args[-1])
    f = jax.jit(jaxcompat.shard_map(
        body, mesh=mesh, in_specs=in_spec, out_specs=out_specs,
        check_vma=False))
    return [np.asarray(a) for a in f(*ins, ct)]


#: the backwards against jax.vjp: float32, the summation orders differ
GRAD_ATOL = 2e-5


@pytest.mark.parametrize("name", ["ring_noncausal_grad", "ring_causal_grad",
                                  "ulysses_causal_grad"])
def test_context_parallel_backward_matches_vjp(port, mesh, name):
    """Ring attention (causal and not) and Ulysses: the gradients of q,
    k and v through the port's autograd (the permute and Alltoall
    backwards, the masked blocks' where) against jax.vjp of the
    reference op on the same cotangent, within GRAD_ATOL, and finite."""
    c = next(c for c in _ns()["GRAD_CASES"] if c[0] == name)
    _, op, causal, seed, shape = c
    ns = _ns()
    q, k, v = ns["attn_inputs"](seed, shape)
    ct = ns["cotangent"](seed, shape)
    fn = ref_ring_attention if op == "ring" else ref_ulysses_attention
    ref = _ref_vjp(mesh, lambda a, b, cc: fn(a, b, cc, "sp", causal=causal),
                   (q, k, v), ct, (JP(None, "sp"),) * 4,
                   (JP(None, "sp"),) * 3)
    for which, r in zip("qkv", ref):
        got = np.load(port / f"{name}_{which}.npy")
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, r, atol=GRAD_ATOL)


def test_moe_ffn_backward_matches_vjp(port, mesh):
    """moe_ffn's gradients for x, the router wg (each rank's partial:
    the gate's path through combine), w1 and w2 against jax.vjp of the
    reference's, within 1e-4."""
    x, wg, w1, w2 = _ns()["moe_inputs"](N)
    ct = _ns()["cotangent"](2, x.shape)

    def fn(xx, g, a, b):
        return rmoe.moe_ffn(xx, g, a, b, "sp")

    def body(xx, g, a, b, c):
        _, vjp = jax.vjp(fn, xx, g, a, b)
        gx, gg, ga, gb = vjp(c)
        return gx, gg[None], ga, gb
    f = jax.jit(jaxcompat.shard_map(
        body, mesh=mesh,
        in_specs=(JP("sp"), JP(), JP("sp"), JP("sp"), JP("sp")),
        out_specs=(JP("sp"),) * 4, check_vma=False))
    ref = [np.asarray(a) for a in f(x, wg, w1, w2, ct)]
    for which, r in zip(("x", "wg", "w1", "w2"), ref):
        got = np.load(port / f"moe_grad_{which}.npy")
        assert got.shape == r.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, r, atol=1e-4)
