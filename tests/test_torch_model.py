"""The port's models/transformer.py against the JAX package's
``ompi_tpu.models.transformer``: a sharded training step equals the
unsharded one (``tests/test_model.py``'s rule), and the port's step equals
the reference's on the same mesh.

The sharded cases (:data:`_INPUTS`'s ``CASES``, shared verbatim by both
sides) run in one 4-rank launcher job of the port (``--mca device_plane
on --mca device_plane_platform cpu``) and in this process for the
reference (``shard_map`` over a 4-device sub-mesh of the 8 virtual CPU
devices), on the same seeded numpy parameters: the reference's
``init_params``, carried to each rank's shards by
``compat.model_params_from_reference``. The reference's 8-device (2, 2,
2) mesh stands as (1, 2, 2) and (2, 2, 1) on 4 ranks. Rank 0 of the job
also runs the port's one-rank step (``Axes()``) of every dense case.

Tolerances: float32 loss within ``LOSS_ATOL`` and params within
``PARAM_ATOL`` + ``PARAM_RTOL`` * |ref| (``tests/test_model.py``'s 1e-4,
5e-4 and 1e-4), both against the reference's step on the same mesh and
against the one-rank step; the MoE cases' six losses within
``LOSS_ATOL`` of the reference's and falling. ``sgd_update`` and the
numpy ``init_params`` draw are bitwise. The bfloat16 tp x sp gradients
against the one-rank step within ``GRAD_RTOL`` of each leaf's max |g|
(``examples/transformer_training.py``'s bound on the card).
"""

import functools
import os
import pickle
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ompi_tpu.models import transformer as rt  # noqa: E402
from ompi_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from ompi_tpu.util import jaxcompat  # noqa: E402
from ompi_tpu_torch import compat  # noqa: E402
from ompi_tpu_torch.examples import transformer_training as tt  # noqa: E402
from ompi_tpu_torch.models import transformer as tfm  # noqa: E402
from ompi_tpu_torch.runtime import launcher as port_launcher  # noqa: E402

N = 4
PORT_MCA = dict(compat.mca_from_reference({"device_plane": "on"}),
                device_plane_platform="cpu")
LOSS_ATOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 5e-4, 1e-4

#: shared verbatim by the port job and this process
_INPUTS = """
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=8, d_ff=64,
            max_seq=64, dtype="float32", param_dtype="float32")
MOE = dict(BASE, n_heads=4, moe_every=2)

def data(seed, b, t):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, (b, t)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    return tokens, labels

#: (name, config, param seed, mesh axes, mesh shape, Axes kwargs, data
#: spec, (B, T), lr, steps, what rank 0 also runs one-rank: "step" /
#: "grads" / None)
CASES = [
    ("dp", BASE, 0, ("dp",), (4,), {"dp": "dp"}, ("dp", None), (8, 16),
     1e-2, 1, "step"),
    ("tp", BASE, 0, ("tp",), (4,), {"tp": "tp"}, (), (8, 16), 1e-2, 1,
     "step"),
    ("sp", BASE, 0, ("sp",), (4,), {"sp": "sp"}, (None, "sp"), (8, 16),
     1e-2, 1, "step"),
    ("dp_tp_sp_1x2x2", BASE, 0, ("dp", "tp", "sp"), (1, 2, 2),
     {"dp": "dp", "tp": "tp", "sp": "sp"}, ("dp", "sp"), (4, 16), 1e-2, 1,
     "step"),
    ("dp_tp_sp_2x2x1", BASE, 0, ("dp", "tp", "sp"), (2, 2, 1),
     {"dp": "dp", "tp": "tp", "sp": "sp"}, ("dp", "sp"), (4, 16), 1e-2, 1,
     "step"),
    ("ulysses", dict(BASE, sp_schedule="ulysses"), 0, ("sp",), (4,),
     {"sp": "sp"}, (None, "sp"), (8, 16), 1e-2, 1, "step"),
    ("moe_ep", dict(MOE, n_experts=8), 1, ("ep",), (4,), {"ep": "ep"},
     ("ep",), (8, 16), 1e-1, 6, None),
    ("moe_ep_tp", dict(MOE, n_experts=4), 2, ("ep", "tp"), (2, 2),
     {"ep": "ep", "tp": "tp"}, ("ep",), (8, 16), 1e-1, 6, None),
    ("bf16_tp_sp", dict(BASE, dtype="bfloat16", param_dtype="bfloat16"),
     3, ("tp", "sp"), (2, 2), {"tp": "tp", "sp": "sp"}, (None, "sp"),
     (4, 16), 1e-2, 1, "grads"),
]
"""

_PORT_PROG = """
import pickle
import numpy as np
import torch
from ompi_tpu_torch import compat, mpi
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel import P, make_mesh
from ompi_tpu_torch.parallel.device_comm import assemble, local_block
world = mpi.Init()
r = world.rank
d = {out_dir!r}
{inputs}

def port_cfg(kw):
    kw = dict(kw)
    kw["dtype"] = compat.torch_dtype(kw["dtype"])
    kw["param_dtype"] = compat.torch_dtype(kw["param_dtype"])
    return tfm.Config(**kw)

def leaves_np(tree):
    return [compat.tensor_to_numpy(x) for x in tfm.tree_leaves(tree)]

for (name, kw, seed, axes, shape, axkw, dspec, (b, t), lr, steps,
     single) in CASES:
    with open(f"{{d}}/{{name}}.pkl", "rb") as fh:
        ref_params = pickle.load(fh)
    cfg = port_cfg(kw)
    ax = tfm.Axes(**axkw)
    mesh = make_mesh(axes, shape)
    specs = tfm.param_specs(cfg, ax)
    tokens, labels = data(seed, b, t)
    out = {{}}
    with mesh:
        params = compat.model_params_from_reference(ref_params, cfg, ax,
                                                    mesh)
        tk = local_block(mesh, tokens, P(*dspec))
        lb = local_block(mesh, labels, P(*dspec))
        if single == "grads":
            fn = tfm.make_grad_fn(cfg, ax, specs)
            loss, _, grads = fn(params, tk, lb)
            out["loss"] = np.array([float(loss)])
            got = [assemble(mesh, g, s) for g, s in
                   zip(tfm.tree_leaves(grads), tfm.tree_leaves(specs))]
        else:
            step = tfm.make_train_step(cfg, ax, specs, lr=lr)
            losses = []
            for _ in range(steps):
                params, loss = step(params, tk, lb)
                losses.append(float(loss))
            out["loss"] = np.array(losses)
            got = [assemble(mesh, p, s) for p, s in
                   zip(tfm.tree_leaves(params), tfm.tree_leaves(specs))]
    for i, a in enumerate(got):
        out[f"leaf{{i}}"] = a
    if r == 0 and single:
        one = tfm.Axes()
        full = compat.model_params_from_reference(ref_params, cfg, one,
                                                  None)
        ospecs = tfm.param_specs(cfg, one)
        tt, lt = torch.from_numpy(tokens), torch.from_numpy(labels)
        if single == "grads":
            loss, _, res = tfm.make_grad_fn(cfg, one, ospecs)(full, tt, lt)
        else:
            res, loss = tfm.make_train_step(cfg, one, ospecs, lr=lr)(
                full, tt, lt)
        out["single_loss"] = np.array([float(loss)])
        for i, a in enumerate(leaves_np(res)):
            out[f"single{{i}}"] = a
    if r == 0:
        np.savez(f"{{d}}/{{name}}.npz", **out)
mpi.Finalize()
"""


def _ns():
    ns = {"np": np}
    exec(_INPUTS, ns)
    return ns


def _case(name):
    return next(c for c in _ns()["CASES"] if c[0] == name)


def _ref_cfg(kw):
    kw = dict(kw)
    kw["dtype"] = jnp.dtype(kw["dtype"])
    kw["param_dtype"] = np.dtype(getattr(ml_dtypes, kw["param_dtype"])
                                 if kw["param_dtype"] == "bfloat16"
                                 else kw["param_dtype"])
    return rt.Config(**kw)


def _ref_params(name):
    _, kw, seed, *_ = _case(name)
    return rt.init_params(np.random.default_rng(seed), _ref_cfg(kw))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    for case in _ns()["CASES"]:
        with open(d / f"{case[0]}.pkl", "wb") as fh:
            pickle.dump(_ref_params(case[0]), fh)
    src = textwrap.dedent(_PORT_PROG).format(out_dir=str(d), inputs=_INPUTS)
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    try:
        rc = port_launcher.launch([sys.executable, path], N, mca=PORT_MCA,
                                  timeout=300)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job exited {rc}"
    return d


def _load(port, name):
    z = np.load(port / f"{name}.npz")
    n = len([k for k in z.files if k.startswith("leaf")])
    single = [z[f"single{i}"] for i in range(n)] \
        if "single0" in z.files else None
    return z, [z[f"leaf{i}"] for i in range(n)], single


def _ref_run(name, steps=None):
    """The reference's sharded step(s) of a case: (losses, leaves)."""
    (_, kw, seed, axes, shape, axkw, dspec, (b, t), lr, n_steps,
     _) = _case(name)
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} devices")
    cfg, ax = _ref_cfg(kw), rt.Axes(**axkw)
    mesh = ref_make_mesh(axes, shape, jax.devices()[:N])
    specs = rt.param_specs(cfg, ax)
    step = jax.jit(jaxcompat.shard_map(
        rt.make_train_step(cfg, ax, specs, lr=lr), mesh=mesh,
        in_specs=(specs, JP(*dspec), JP(*dspec)), out_specs=(specs, JP()),
        check_vma=False))
    p = _ref_params(name)
    tokens, labels = _ns()["data"](seed, b, t)
    losses = []
    for _ in range(steps or n_steps):
        p, loss = step(p, tokens, labels)
        losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree.leaves(p)]


def _ref_single(name):
    """The reference's one-device step of a case: (loss, leaves)."""
    (_, kw, seed, _, _, _, _, (b, t), lr, _, _) = _case(name)
    # Axes() ignores the sp schedule: the cases that differ only there
    # share one step
    kw = tuple(sorted((k, v) for k, v in kw.items() if k != "sp_schedule"))
    return _ref_single_cached(kw, seed, b, t, lr)


@functools.lru_cache(maxsize=None)
def _ref_single_cached(kw, seed, b, t, lr):
    cfg, ax = _ref_cfg(dict(kw)), rt.Axes()
    step = jax.jit(rt.make_train_step(cfg, ax, rt.param_specs(cfg, ax),
                                      lr=lr))
    tokens, labels = _ns()["data"](seed, b, t)
    p, loss = step(rt.init_params(np.random.default_rng(seed), cfg),
                   tokens, labels)
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(p)]


def _close(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=PARAM_RTOL)


def _check_against_single(port, name):
    z, got, single = _load(port, name)
    ref_losses, ref_leaves = _ref_run(name)
    one_loss, one_leaves = _ref_single(name)
    # the port against the reference on the same mesh
    np.testing.assert_allclose(z["loss"][0], ref_losses[0], atol=LOSS_ATOL)
    _close(got, ref_leaves)
    # each side against its one-rank step
    np.testing.assert_allclose(z["loss"][0], z["single_loss"][0],
                               atol=LOSS_ATOL)
    _close(got, single)
    np.testing.assert_allclose(ref_losses[0], one_loss, atol=LOSS_ATOL)
    _close(ref_leaves, one_leaves)
    # and the two one-rank steps
    np.testing.assert_allclose(z["single_loss"][0], one_loss,
                               atol=LOSS_ATOL)
    _close(single, one_leaves)


def _bf16(bits):
    """float32 values of bfloat16 bits (uint16)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _data(seed, b, t):
    return _ns()["data"](seed, b, t)


def test_single_device_step_decreases_loss():
    """Four one-rank steps (``Axes()``) in this process: each loss within
    LOSS_ATOL of the reference's, the params within its tolerance, the
    loss falling."""
    _, kw, seed, *_ = _case("dp")
    rcfg, cfg = _ref_cfg(kw), compat.model_config_from_reference(
        _ref_cfg(kw))
    params = _ref_params("dp")
    tokens, labels = _data(7, 4, 16)
    rstep = jax.jit(rt.make_train_step(rcfg, rt.Axes(),
                                       rt.param_specs(rcfg, rt.Axes())))
    step = tfm.make_train_step(cfg, tfm.Axes(),
                               tfm.param_specs(cfg, tfm.Axes()))
    p = compat.model_params_from_reference(params, cfg, tfm.Axes(), None)
    tk, lb = torch.from_numpy(tokens), torch.from_numpy(labels)
    rp, losses, ref_losses = params, [], []
    for _ in range(4):
        p, loss = step(p, tk, lb)
        rp, rloss = rstep(rp, tokens, labels)
        losses.append(float(loss))
        ref_losses.append(float(rloss))
    np.testing.assert_allclose(losses, ref_losses, atol=LOSS_ATOL)
    _close([x.numpy() for x in tfm.tree_leaves(p)],
           [np.asarray(x) for x in jax.tree.leaves(rp)])
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]


@pytest.mark.parametrize("strategy", ["dp", "tp", "sp"])
def test_1d_sharding_matches_single(port, strategy):
    """dp, tp and sp alone on 4 ranks: the port's step equals the
    reference's on the same mesh and the one-rank step."""
    _check_against_single(port, strategy)


@pytest.mark.parametrize("shape", ["1x2x2", "2x2x1"])
def test_3d_dp_tp_sp_matches_single(port, shape):
    """("dp", "tp", "sp") at (1, 2, 2) and (2, 2, 1): the reference's
    8-device (2, 2, 2) on 4 ranks."""
    _check_against_single(port, f"dp_tp_sp_{shape}")


def test_sp_ulysses_schedule_matches_single(port):
    """The Ulysses schedule trains as the unsharded step does."""
    _check_against_single(port, "ulysses")


@pytest.mark.parametrize("name", ["moe_ep", "moe_ep_tp"])
def test_moe_training_matches_reference(port, name):
    """MoE with ep 4 (8 experts) and with ep 2 x tp 2 (4 experts): six
    steps at lr 0.1, each loss within LOSS_ATOL of the reference's on
    the same mesh, the last below the first, and the params after the
    sixth within the reference's tolerance."""
    z, got, _ = _load(port, name)
    ref_losses, ref_leaves = _ref_run(name)
    assert len(z["loss"]) == 6
    np.testing.assert_allclose(z["loss"], ref_losses, atol=LOSS_ATOL)
    assert np.isfinite(z["loss"][0]) and z["loss"][-1] < z["loss"][0]
    _close(got, ref_leaves)


def test_bf16_tp_sp_grads_within_bound(port):
    """bfloat16 activations and storage on a 2 x 2 tp x sp mesh (the
    card path's layout): each leaf's synced gradient within GRAD_RTOL of
    its max |g| from the one-rank step's, and the loss within
    LOSS_RTOL of it and of the reference's sharded loss."""
    z, got, single = _load(port, "bf16_tp_sp")
    for i, (a, b) in enumerate(zip(got, single)):
        a, b = _bf16(a), _bf16(b)
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tt.GRAD_RTOL, (i, err)
    assert abs(z["loss"][0] - z["single_loss"][0]) \
        <= tt.LOSS_RTOL * abs(z["single_loss"][0])
    ref_losses, _ = _ref_run("bf16_tp_sp")
    assert abs(z["loss"][0] - ref_losses[0]) \
        <= tt.LOSS_RTOL * abs(ref_losses[0])


def test_bf16_param_storage_dtype_stable():
    """param_dtype bfloat16: two steps keep every leaf bfloat16, the
    numpy draw is the reference's bit for bit, and the losses are within
    LOSS_RTOL of the reference's."""
    rcfg = rt.Config(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                     max_seq=32, param_dtype=ml_dtypes.bfloat16)
    cfg = compat.model_config_from_reference(rcfg)
    assert cfg.param_dtype == torch.bfloat16 and cfg.dtype == torch.bfloat16
    params = tfm.init_params(np.random.default_rng(0), cfg)
    ref = rt.init_params(np.random.default_rng(0), rcfg)
    for a, b in zip(tfm.tree_leaves(params), jax.tree.leaves(ref)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(compat.tensor_to_numpy(a),
                                      np.asarray(b).view(np.uint16))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, (2, 16)).astype(np.int32)
    labs = np.roll(toks, -1, 1).astype(np.int32)
    step = tfm.make_train_step(cfg, tfm.Axes(),
                               tfm.param_specs(cfg, tfm.Axes()))
    rstep = jax.jit(rt.make_train_step(rcfg, rt.Axes(),
                                       rt.param_specs(rcfg, rt.Axes())))
    tk, lb = torch.from_numpy(toks), torch.from_numpy(labs)
    p, rp = params, ref
    for _ in range(2):
        p, loss = step(p, tk, lb)
        rp, rloss = rstep(rp, toks, labs)
        assert all(x.dtype == torch.bfloat16 for x in tfm.tree_leaves(p))
        assert abs(float(loss) - float(rloss)) \
            <= tt.LOSS_RTOL * abs(float(rloss))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_update_bitwise(dtype):
    """sgd_update against the reference's on the same numpy inputs,
    bitwise, on values over six decades (the float32 scale, the update in
    float32, one rounding to the storage dtype)."""
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    view = np.uint32 if dtype == "float32" else np.uint16
    rng = np.random.default_rng(5)
    shape = (257, 333)
    p = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-3, 3, shape)).astype(dt)
    g = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-3, 3, shape)).astype(dt)
    scale = jnp.float32(0.1) / jnp.float32(61.0)
    ref = np.asarray(rt.sgd_update({"a": jnp.asarray(p)},
                                   {"a": jnp.asarray(g)}, scale)["a"])
    pt = compat.tensor_from_numpy(p)
    got = tfm.sgd_update({"a": pt}, {"a": compat.tensor_from_numpy(g)},
                         tfm.sgd_scale(0.1, torch.tensor(61.0)))["a"]
    assert got is pt and got.dtype == compat.torch_dtype(dtype)
    np.testing.assert_array_equal(compat.tensor_to_numpy(got).view(view),
                                  ref.view(view))


@pytest.mark.parametrize("name", ["moe_ep", "bf16_tp_sp"])
def test_init_params_matches_reference(name):
    """The numpy draw (MoE and dense layers, float32 and bfloat16
    storage) equals the reference's leaf for leaf, bitwise; the device
    draw has its shapes, dtypes and leaf order."""
    _, kw, seed, *_ = _case(name)
    rcfg = _ref_cfg(kw)
    cfg = compat.model_config_from_reference(rcfg)
    got = tfm.init_params(np.random.default_rng(seed), cfg)
    ref = jax.tree.leaves(_ref_params(name))
    dev = tfm.tree_leaves(tfm.init_params_device(cfg, seed, "cpu"))
    assert len(tfm.tree_leaves(got)) == len(ref) == len(dev)
    for a, b, c in zip(tfm.tree_leaves(got), ref, dev):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            b = b.view(np.uint16)
        np.testing.assert_array_equal(compat.tensor_to_numpy(a), b)
        assert c.shape == a.shape and c.dtype == a.dtype
