"""The port's models/pipeline.py against the JAX package's
``ompi_tpu.models``: the GPipe pipeline over ``permute_dev`` equals the
plain layer loop and the dense train step (``tests/test_pipeline.py``'s
rule), and the host stage hand-off over the partitioned plane delivers
each microbatch as it is readied (``tests/test_part.py:169``).

The pipeline cases (:data:`_INPUTS`'s ``CASES``) run in one 4-rank
launcher job of the port (``--mca device_plane on --mca
device_plane_platform cpu``): pp 2 as a sub-mesh of the first two ranks,
and pp x tp 2 x 2. The reference's numpy parameters reach the ranks'
stage shards through ``compat.model_params_from_reference(...,
stacked=True)``; the oracles are the reference's dense step and
``forward_local`` in this process. The hand-off runs in a 2-rank job.

Tolerances (``tests/test_pipeline.py``'s, float32): logits within 1e-5;
the loss within rtol 1e-5 of the dense step's; updated params within
rtol 2e-4, atol 2e-5; the MoE router's update bitwise equal on the two tp
ranks of a stage.
"""

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

from ompi_tpu.models import pipeline as rpl  # noqa: E402
from ompi_tpu.models import transformer as rt  # noqa: E402
from ompi_tpu_torch import compat  # noqa: E402
from ompi_tpu_torch.models import pipeline as pl  # noqa: E402
from ompi_tpu_torch.models import transformer as tfm  # noqa: E402
from ompi_tpu_torch.runtime import launcher as port_launcher  # noqa: E402

N = 4
PORT_MCA = dict(compat.mca_from_reference({"device_plane": "on"}),
                device_plane_platform="cpu")

_INPUTS = """
BASE = dict(vocab=64, d_model=32, n_layers=4, n_heads=2, d_ff=64,
            max_seq=16)

def data(seed, mask_last):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, (4, 8)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    if mask_last:
        labels[:, -1] = -1
    return tokens, labels

#: (name, config, param seed, mesh axes, mesh shape, Axes kwargs, what
#: runs: "forward" or "train", labels' last column masked)
CASES = [
    ("forward", BASE, 1, ("pp",), (2,), {"pp": "pp"}, "forward", False),
    ("train", BASE, 2, ("pp",), (2,), {"pp": "pp"}, "train", True),
    # capacity >= all tokens: the expert capacity is per MoE call, so
    # microbatching would otherwise change the dropping
    ("moe_tp", dict(BASE, n_heads=4, moe_every=1, n_experts=2,
                    capacity_factor=4.0), 5, ("pp", "tp"), (2, 2),
     {"pp": "pp", "tp": "tp"}, "train", False),
    ("tp", dict(BASE, n_heads=4), 3, ("pp", "tp"), (2, 2),
     {"pp": "pp", "tp": "tp"}, "train", False),
]
"""

_PORT_PROG = """
import pickle
import numpy as np
import torch
from ompi_tpu_torch import compat, mpi
from ompi_tpu_torch.models import pipeline as pl, transformer as tfm
from ompi_tpu_torch.parallel import make_mesh
from ompi_tpu_torch.parallel.device_comm import assemble, local_block
world = mpi.Init()
r = world.rank
d = {out_dir!r}
{inputs}
for name, kw, seed, axes, shape, axkw, what, mask_last in CASES:
    with open(f"{{d}}/{{name}}.pkl", "rb") as fh:
        ref_params = pickle.load(fh)
    cfg = tfm.Config(**kw, dtype=torch.float32)
    ax = tfm.Axes(**axkw)
    mesh = make_mesh(axes, shape)
    if mesh.comm is None:  # outside the pp 2 sub-mesh
        continue
    specs = pl.stacked_param_specs(cfg, ax)
    tokens, labels = data(seed, mask_last)
    tk, lb = torch.from_numpy(tokens), torch.from_numpy(labels)
    out = {{}}
    with mesh:
        params = compat.model_params_from_reference(
            pl.stack_layers(ref_params), cfg, ax, mesh, stacked=True)
        if what == "forward":
            out["logits"] = pl.pipeline_forward(params, tk, cfg, ax,
                                                n_micro=2).numpy()
        else:
            step = pl.make_pp_train_step(cfg, ax, specs, n_micro=2, lr=0.1)
            params, loss = step(params, tk, lb)
            out["loss"] = np.array(float(loss))
            for k in ("wq", "w1", "w2", "wg"):
                if k in params["layers"]:
                    out[k] = assemble(mesh, params["layers"][k],
                                      specs["layers"][k])
            out["embed"] = assemble(mesh, params["embed"], specs["embed"])
            if "wg" in params["layers"]:
                out["wg_local"] = params["layers"]["wg"].numpy()
    np.savez(f"{{d}}/{{name}}_r{{r}}.npz", **out)

# the device draw of a rank's shards equals the shards of the full draw
# (the stacked pipeline layout and the flat one) on the pp x tp mesh
cfg = tfm.Config(**CASES[-1][1], dtype=torch.float32)
ax = tfm.Axes(pp="pp", tp="tp")
mesh = make_mesh(("pp", "tp"), (2, 2))
ok = []
for stacked in (True, False):
    full = tfm.init_params_device(cfg, 7, "cpu")
    specs = tfm.param_specs(cfg, ax)
    if stacked:
        full = pl.stack_layers(full)
        specs = pl.stacked_param_specs(cfg, ax)
    mine = tfm.init_params_device(cfg, 7, "cpu", ax, mesh, stacked)
    exp = tfm.tree_map(lambda a, s: local_block(mesh, a, s), full, specs)
    ok.append(all(a.shape == b.shape and torch.equal(a, b) for a, b in
                  zip(tfm.tree_leaves(mine), tfm.tree_leaves(exp))))
np.save(f"{{d}}/draw_r{{r}}.npy", np.array(ok))
mpi.Finalize()
"""

_HANDOFF_PROG = """
import numpy as np
from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import progress
from ompi_tpu_torch.models.pipeline import (stage_handoff_recv,
                                            stage_handoff_send)
comm = mpi.Init()
rank = comm.rank
n_micro, mb = 4, 32
acts = np.arange(n_micro * mb, dtype=np.float32).reshape(n_micro, mb)
for tick in range(2):  # persistent across pipeline ticks
    if rank == 0:
        if tick == 0:
            sreq = stage_handoff_send(comm, acts, n_micro, dest=1)
        else:
            sreq.start()
        for i in range(n_micro):   # "stage compute" finishes i
            sreq.Pready(i)
        sreq.wait()
    else:
        buf = np.zeros((n_micro, mb), np.float32)
        if tick == 0:
            rreq = stage_handoff_recv(comm, buf, n_micro, source=0)
            bound = buf
        else:
            bound[:] = 0
            rreq.start()
        done = set()
        while len(done) < n_micro:
            progress.progress()
            for i in range(n_micro):
                if i not in done and rreq.Parrived(i):
                    np.testing.assert_array_equal(bound[i], acts[i])
                    done.add(i)
        rreq.wait()
        assert done == set(range(n_micro))
bad = np.zeros((3, 4), np.float32)
for call in (lambda: stage_handoff_send(comm, bad, n_micro, 1 - rank),
             lambda: stage_handoff_recv(comm, bad, n_micro, 1 - rank)):
    try:
        call()
        raise SystemExit("expected ValueError")
    except ValueError as e:
        assert "must be n_micro=4" in str(e), e
mpi.Finalize()
"""


def _ns():
    ns = {"np": np}
    exec(_INPUTS, ns)
    return ns


def _case(name):
    return next(c for c in _ns()["CASES"] if c[0] == name)


def _ref_cfg(kw):
    return rt.Config(**kw, dtype=jnp.float32)


def _ref_params(name):
    _, kw, seed, *_ = _case(name)
    return rt.init_params(np.random.default_rng(seed), _ref_cfg(kw))


def _run(src, n):
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n,
                                    mca=PORT_MCA, timeout=240)
    finally:
        os.unlink(path)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    for case in _ns()["CASES"]:
        with open(d / f"{case[0]}.pkl", "wb") as fh:
            pickle.dump(_ref_params(case[0]), fh)
    rc = _run(textwrap.dedent(_PORT_PROG).format(out_dir=str(d),
                                                 inputs=_INPUTS), N)
    assert rc == 0, f"port job exited {rc}"
    return d


def _dense(name):
    """The reference's dense (one-device) step: (params, loss)."""
    _, kw, seed, *_, mask_last = _case(name)
    cfg = _ref_cfg(kw)
    tokens, labels = _ns()["data"](seed, mask_last)
    step = jax.jit(rt.make_train_step(cfg, rt.Axes(),
                                      rt.param_specs(cfg, rt.Axes()),
                                      lr=0.1))
    return step(_ref_params(name), tokens, labels)


def test_stack_layers_roundtrip():
    """stack_layers stacks numpy leaves as the reference does and
    tensor leaves alike; the stacked specs put pp first."""
    cfg = tfm.Config(vocab=64, d_model=32, n_layers=4, n_heads=2, d_ff=64,
                     max_seq=16, dtype=torch.float32)
    params = tfm.init_params(np.random.default_rng(0), cfg)
    stacked = pl.stack_layers(params)
    assert stacked["layers"]["wq"].shape == (4, 32, 32)
    torch.testing.assert_close(stacked["layers"]["w1"][2],
                               params["layers"][2]["w1"], rtol=0, atol=0)
    ref = rpl.stack_layers(_ref_params("train"))
    np_stacked = pl.stack_layers(_ref_params("train"))
    for a, b in zip(jax.tree.leaves(ref),
                    tfm.tree_leaves(np_stacked)):
        np.testing.assert_array_equal(a, b)
    specs = pl.stacked_param_specs(cfg, tfm.Axes(pp="pp", tp="tp"))
    assert tuple(specs["layers"]["wq"]) == ("pp", None, "tp")
    assert tuple(specs["layers"]["ln1"]["g"]) == ("pp",)
    assert tuple(specs["embed"]) == ()


def test_pipeline_forward_matches_layer_loop(port):
    """pp 2, n_micro 2: the last stage's logits equal the plain layer
    loop's (the reference's forward_local) within 1e-5."""
    _, kw, seed, *_ = _case("forward")
    tokens, _ = _ns()["data"](seed, False)
    ref = np.asarray(rt.forward_local(_ref_params("forward"), tokens,
                                      _ref_cfg(kw), rt.Axes()))
    last = np.load(port / "forward_r1.npz")["logits"]
    np.testing.assert_allclose(last, ref, rtol=1e-5, atol=1e-5)


def test_pp_train_step_runs_and_matches_dense(port):
    """pp 2 train step: the loss and the updated wq, w1, w2 and embed
    match the dense step's on every rank of the mesh."""
    dparams, dloss = _dense("train")
    dstacked = rpl.stack_layers(dparams)
    for r in range(2):
        z = np.load(port / f"train_r{r}.npz")
        np.testing.assert_allclose(z["loss"], float(dloss), rtol=1e-5)
        for k in ("wq", "w1", "w2"):
            np.testing.assert_allclose(z[k], np.asarray(
                dstacked["layers"][k]), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(z["embed"], np.asarray(dparams["embed"]),
                                   rtol=2e-4, atol=2e-5)


def test_pp_moe_with_tp_grad_sync(port):
    """All-MoE pipeline under pp x tp: the router wg's gradient takes the
    tp sum (grad_extra_axes), so the updated wg is the same on both tp
    ranks of a stage and matches the dense step's."""
    dparams, dloss = _dense("moe_tp")
    dstacked = rpl.stack_layers(dparams)
    docs = [np.load(port / f"moe_tp_r{r}.npz") for r in range(N)]
    for z in docs:
        np.testing.assert_allclose(z["loss"], float(dloss), rtol=1e-5)
        np.testing.assert_allclose(z["wg"],
                                   np.asarray(dstacked["layers"]["wg"]),
                                   rtol=2e-4, atol=2e-5)
    # ranks (stage, tp): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1)
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(docs[a]["wg_local"],
                                      docs[b]["wg_local"])


def test_pp_with_tp(port):
    """pp composes with tp on one mesh (pp 2 x tp 2): the loss equals the
    dense step's on every rank."""
    _, dloss = _dense("tp")
    for r in range(N):
        z = np.load(port / f"tp_r{r}.npz")
        np.testing.assert_allclose(z["loss"], float(dloss), rtol=1e-5)


def test_device_draw_keeps_this_ranks_shards(port):
    """init_params_device with ax and mesh (stacked for the pipeline, and
    flat) gives each rank of the pp x tp mesh exactly its shards of the
    full seeded draw."""
    for r in range(N):
        assert np.load(port / f"draw_r{r}.npy").tolist() == [True, True]


def test_pipeline_stage_handoff():
    """stage_handoff_send / recv over Psend_init / Precv_init on 2 ranks:
    one partition per microbatch, the consumer taking microbatch i as it
    arrives (Parrived), persistent across two ticks; a leading dim other
    than n_micro is refused with ValueError on either side."""
    assert _run(textwrap.dedent(_HANDOFF_PROG), 2) == 0
