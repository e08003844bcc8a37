"""The port's ZeRO stage 3 (zero/zero3: Zero3Plan, Zero3Optimizer, the
persistent Allgather_multi_init with rebind) and the host bucket cycle
against the JAX package.

One job per package and comm size n (2, 3 and 4): the reference through
``tests.harness.run_ranks`` under ``device_plane on`` with
``coll_xla_bucket_bytes`` 2048, the port through
``ompi_tpu_torch.runtime.launcher`` with the same settings mapped by
``compat.mca_from_reference`` plus ``device_plane_platform cpu``. Every
job runs stage 3 against stage 1 in 'linear' and stage 3 against stage 2
in 'ring' over the same parameters and seeded gradients; the 2-rank job
also runs the other cases of ``tests/test_zero3.py`` (bar the elastic
refusal, which waits for ``elastic/``) and ``tests/test_zero.py``'s host
bucket cycle. The fused product dups the comm with ``coll_pallas``
(the port: ``coll_cuda``) on, over CPU tensors, as
``tests/test_torch_zero.py`` maps it.

Tolerances: stage 3 'linear' bitwise equal to the reference's stage 3
and to the port's stage 1, momentum included; stage 3 'ring' bitwise
equal to the reference's stage 3 'ring', and within the bound of
:func:`ring_bound` of the port's stage 2 'ring' (the layers' buckets
chunk the ring differently); counters and error classes as the
reference's own assertions; the products within 1e-6 relative.
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

REF_MCA = {"device_plane": "on", "coll_xla_bucket_bytes": "2048"}
PORT_MCA = dict(compat.mca_from_reference(REF_MCA),
                device_plane_platform="cpu")
STEPS, LR, MU = 3, 0.05, 0.9

#: shared verbatim by both rank programs: numpy trees from a seed
_INPUTS = """
def make_params():
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": np.arange(256, dtype=np.float32).reshape(16, 16) / 7,
            "layers": [{"w": np.ones((12, 12), np.float32) * (i + 1),
                        "b": f(12)} for i in range(3)]}

def const_grads(rank, step):
    return {"embed": np.full((16, 16), (rank + 1) * 0.25 / (step + 1),
                             np.float32),
            "layers": [{"w": np.full((12, 12), (rank + 1) * 0.25 / (step + 1),
                                     np.float32),
                        "b": np.full(12, (rank + 1) * 0.25 / (step + 1),
                                     np.float32)} for _ in range(3)]}

def rand_grads(rank, step):
    rng = np.random.default_rng(100 + 10 * rank + step)
    f = lambda *s: (rng.standard_normal(s)
                    * 10.0 ** rng.integers(-2, 2, s)).astype(np.float32)
    return {"embed": f(16, 16),
            "layers": [{"w": f(12, 12), "b": f(12)} for _ in range(3)]}

def record(out, name, value):
    out[name] = value
"""

_REF_BODY = """
import json
import jax, jax.numpy as jnp
from ompi_tpu import errors
from ompi_tpu.core import cvar, pvar
from ompi_tpu.part import GradientSync
from ompi_tpu.zero import Zero3Optimizer, ZeroOptimizer, layout as zl
from ompi_tpu.zero.zero3 import Zero3Plan
{inputs}
out = {{}}
def J(tree):
    return jax.tree.map(jnp.asarray, tree)

def save(name, a):
    np.save(f"{out_dir}/ref_{{name}}_r{{rank}}.npy", np.asarray(a))

def eclass(fn):
    try:
        fn()
    except errors.MPIError as e:
        return int(e.error_class)
    return None

params = J(make_params())
for mode, grads in (("linear", const_grads), ("ring", rand_grads)):
    o3 = Zero3Optimizer(comm, params, lr={lr}, momentum={mu},
                        deterministic=mode)
    for step in range({steps}):
        o3.start_pass()
        for g in range(o3.plan.n_layers):
            with o3.layer(g):
                pass
        o3.step(J(grads(rank, step)))
    for i, leaf in enumerate(jax.tree.leaves(o3.gathered_params())):
        save(f"s3_{{mode}}_p{{i}}", leaf)
    for i, leaf in enumerate(jax.tree.leaves(o3.gathered_momentum())):
        save(f"s3_{{mode}}_m{{i}}", leaf)
    o3.free()

if size == 2:
    o = Zero3Optimizer(comm, params, lr=0.05, momentum=0.9,
                       deterministic="linear")
    L = o.plan.n_layers
    s = pvar.session()
    for step in range(3):
        o.start_pass()
        for g in range(L):
            with o.layer(g):
                pass
        o.start_pass(reverse=True)
        for g in reversed(range(L)):
            with o.layer(g):
                pass
        o.step(J(const_grads(rank, step)))
    record(out, "prefetch", {{
        "layers": L, "hits": s.read("zero_prefetch_hits"),
        "misses": s.read("zero_prefetch_misses"),
        "releases": s.read("zero3_releases"),
        "shard_bytes": o.shard_bytes, "replicated": o.replicated_bytes,
        "layer_bytes": list(o.plan.layer_bytes),
        "pad": sum(p.pad_bytes for p in o.plan.plans),
        "names": [o.plan.name_of(g) for g in range(L)]}})
    o.free()

    o = Zero3Optimizer(comm, params, lr=0.05, deterministic="linear")
    s = pvar.session()
    o.start_pass()
    ws = o.fetch(3)
    record(out, "window_miss", s.read("zero_prefetch_misses"))
    save("window_b", ws[0])
    save("window_w", ws[1])
    o.release(3)
    o.free()

    template = [jnp.zeros((40,), jnp.float32),
                jnp.zeros((6, 5), jnp.float32),
                jnp.zeros((17,), jnp.float32)]
    sync = GradientSync(comm, template, deterministic="linear")
    pstate = zl.ShardedState.from_full(
        comm, [jnp.ones((40,), jnp.float32),
               jnp.full((6, 5), 2.0, jnp.float32),
               jnp.full((17,), 3.0, jnp.float32)])
    req = comm.Allgather_multi_init(pstate)
    for cycle in range(3):
        sync.start()
        for i in reversed(range(sync.n_leaves)):
            sync.push(i, jnp.full(template[i].shape,
                                  float(rank + cycle) + 0.5, jnp.float32))
        summed = sync.finish()
        gstate = zl.ShardedState.from_full(comm, summed, plan=pstate.plan)
        pstate = pstate.map(
            lambda p, g: p - np.asarray(0.1, p.dtype) * g, gstate)
        req.rebind(pstate)
        req.start()
        req.wait()
        for i, leaf in enumerate(req.array):
            save(f"compose_c{{cycle}}_{{i}}", leaf)
        req.discard()
    req.free()
    record(out, "compose_freed", eclass(req.start))
    sync.free()

    st = zl.ShardedState.from_full(comm, [jnp.ones((30,), jnp.float32)])
    req = comm.Allgather_multi_init(st)
    req.start(); req.wait()
    save("rebind_0", req.array[0])
    req.rebind(st.map(lambda s: s * np.asarray(2.0, s.dtype)))
    req.start(); req.wait()
    save("rebind_1", req.array[0])
    other = zl.ShardedState.from_full(
        comm, [jnp.ones((12,), jnp.float32), jnp.ones((300,), jnp.float32)])
    errs = [eclass(lambda: req.rebind(other))]
    req.free()
    errs.append(eclass(lambda: req.rebind(st)))
    record(out, "rebind_errors", errs)

    cvar.set("coll_xla_bucket_bytes", 64)
    fparams = {{"frozen_emb": jnp.arange(16, dtype=jnp.float32).reshape(4, 4),
               "w1": jnp.ones((4, 4), jnp.float32),
               "w2": jnp.ones((4, 4), jnp.float32)}}
    opt = ZeroOptimizer(comm, fparams, lr=0.1, momentum=0.9,
                        deterministic="linear",
                        frozen={{"frozen_emb": True, "w1": False,
                                "w2": False}})
    s = pvar.session()
    g = jax.tree.map(lambda p: jnp.ones(p.shape, p.dtype), fparams)
    opt.step(g)
    p2 = opt.step(g)
    for i, leaf in enumerate(jax.tree.leaves(p2)):
        save(f"frozen_{{i}}", leaf)
    record(out, "frozen", [s.read("zero_ag_skipped"),
                           s.read("zero_rs_launches")])
    cvar.set("coll_xla_bucket_bytes", 2048)

    mparams = {{"a": jnp.arange(16, dtype=jnp.float32).reshape(4, 4),
               "b": jnp.ones((4, 4), jnp.float32)}}
    opt = ZeroOptimizer(comm, mparams, lr=0.1, momentum=0.9,
                        deterministic="linear",
                        frozen={{"a": True, "b": False}})
    mout = opt.step(jax.tree.map(lambda p: jnp.ones(p.shape, p.dtype),
                                 mparams))
    save("mixed_a", mout["a"])
    save("mixed_b", mout["b"])
    record(out, "mixed_errors", [
        eclass(lambda: ZeroOptimizer(comm, mparams, frozen={{"a": True}})),
        eclass(lambda: ZeroOptimizer(comm, mparams, fused=True,
                                     frozen={{"a": True, "b": False}}))])

    hparams = {{"embed": np.arange(32, dtype=np.float32).reshape(8, 4),
               "layers": [{{"w": np.ones((4, 4), np.float32)}}
                          for _ in range(2)]}}
    o3 = Zero3Optimizer(comm, hparams, lr=0.1, momentum=0.9,
                        deterministic="linear")
    o1 = ZeroOptimizer(comm, hparams, lr=0.1, momentum=0.9, stage=1,
                       deterministic="linear")
    s = pvar.session()
    for step in range(3):
        o3.start_pass()
        for g in range(o3.plan.n_layers):
            with o3.layer(g):
                pass
        hg = jax.tree.map(lambda p: np.full(p.shape, float(rank + 1),
                                            p.dtype), hparams)
        o3.step(hg)
        ref = o1.step(hg)
    record(out, "host_misses", s.read("zero_prefetch_misses"))
    for i, leaf in enumerate(jax.tree.leaves(o3.gathered_params())):
        save(f"host3_{{i}}", leaf)
    for i, leaf in enumerate(jax.tree.leaves(ref)):
        save(f"host1_{{i}}", leaf)

    so = Zero3Optimizer(mpi.COMM_SELF, {{"w": np.ones((4, 4), np.float32)}},
                        lr=0.5, deterministic="linear")
    for step in range(2):
        so.start_pass()
        with so.layer(0):
            pass
        so.step({{"w": np.ones((4, 4), np.float32)}})
    save("self_w", so.gathered_params()["w"])
    so.free()

    hb = [np.arange(50, dtype=np.float32) * (rank + 1),
          np.ones((7, 3), np.float64) * (rank + 0.5)]
    hst = comm.Reduce_scatter_multi(hb)
    for b, sh in enumerate(hst.shards):
        save(f"hcycle_s{{b}}", sh)
    for i, leaf in enumerate(comm.Allgather_multi(hst)):
        save(f"hcycle_f{{i}}", leaf)

    cvar.set("coll_pallas", "on")
    fc = comm.dup()
    wparams = {{"wide": jnp.arange(64, dtype=jnp.float32).reshape(8, 8) / 9}}
    rhs = jnp.ones((8, 3), jnp.float32) * 0.5
    for tag, c in (("fused", fc), ("plain", comm)):
        o = Zero3Optimizer(c, wparams, lr=0.1)
        s = pvar.session()
        o.start_pass()
        save(f"mm_{{tag}}", o.matmul(0, rhs))
        record(out, f"mm_{{tag}}", s.read("zero3_fused_matmuls"))
        o.free()
    cvar.set("coll_pallas", "off")

    eparams = {{"w": jnp.ones((6, 4), jnp.float32)}}
    o = Zero3Optimizer(comm, eparams, lr=0.1)
    errs = [eclass(lambda: o.fetch(5)),
            eclass(lambda: o.step([jnp.ones((6, 4), jnp.float32)] * 2))]
    o.free()
    errs += [eclass(lambda: ZeroOptimizer(comm, eparams, stage=3)),
             eclass(lambda: Zero3Plan({{}}, comm.size))]
    record(out, "z3_errors", errs)
    o = Zero3Optimizer(comm, {{"e": jnp.ones((6, 4), jnp.float32),
                              "l": [{{"w": jnp.ones((4, 4), jnp.float32)}}]}},
                       lr=0.1, deterministic="linear", error_feedback="bf16")
    s = pvar.session()
    for step in range(2):
        g = rand_grads(rank, step)
        o.step({{"e": jnp.asarray(g["embed"][:6, :4]),
                "l": [{{"w": jnp.asarray(g["layers"][0]["w"][:4, :4])}}]}})
    for i, leaf in enumerate(jax.tree.leaves(o.gathered_params())):
        save(f"z3_ef_{{i}}", leaf)
    record(out, "z3_ef", s.read("zero_ef_steps"))
    o.free()

    class _Gated:
        def __init__(self, inner):
            self._inner = inner
        def rebind(self, *a, **k):
            raise errors.MPIError(errors.ERR_NOT_SUPPORTED, "gated")
        def free(self):
            self._inner.free()
    o = Zero3Optimizer(comm, {{"w": jnp.ones((8, 4), jnp.float32)}}, lr=0.5,
                       deterministic="linear")
    o._reqs[0] = _Gated(o._reqs[0])
    o.step({{"w": jnp.ones((8, 4), jnp.float32)}})
    o.start_pass()
    with o.layer(0) as ws:
        save("gated", ws[0])
    o.free()

with open(f"{out_dir}/ref_r{{rank}}.json", "w") as fh:
    json.dump(out, fh)
"""

_PORT_PROG = """
import json
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.part import GradientSync
from ompi_tpu_torch.zero import (Zero3Optimizer, ZeroOptimizer,
                                 layout as zl)
from ompi_tpu_torch.zero.zero3 import Zero3Plan
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
{inputs}
out = {{}}
T = compat.tree_from_numpy

def save(name, a):
    np.save(f"{{out_dir}}/port_{{name}}_r{{rank}}.npy",
            compat.tensor_to_numpy(a) if isinstance(a, torch.Tensor)
            else np.asarray(a))

def eclass(fn):
    try:
        fn()
    except errors.MPIError as e:
        return int(e.error_class)
    return None

params = T(make_params())
for mode, grads in (("linear", const_grads), ("ring", rand_grads)):
    o3 = Zero3Optimizer(comm, params, lr={lr}, momentum={mu},
                        deterministic=mode)
    oref = ZeroOptimizer(comm, params, lr={lr}, momentum={mu},
                         stage=1 if mode == "linear" else 2,
                         deterministic=mode)
    reqs = list(o3._reqs)
    for step in range({steps}):
        o3.start_pass()
        for g in range(o3.plan.n_layers):
            with o3.layer(g):
                pass
        o3.step(T(grads(rank, step)))
        pref = oref.step(T(grads(rank, step)))
    # every layer's request survived the steps: rebind took
    assert all(a is b for a, b in zip(reqs, o3._reqs)), mode
    for i, leaf in enumerate(zl.tree_leaves(o3.gathered_params())):
        save(f"s3_{{mode}}_p{{i}}", leaf)
    for i, leaf in enumerate(zl.tree_leaves(o3.gathered_momentum())):
        save(f"s3_{{mode}}_m{{i}}", leaf)
    for i, leaf in enumerate(zl.tree_leaves(pref)):
        save(f"sref_{{mode}}_p{{i}}", leaf)
    mom = comm.Allgather_multi(oref.state.slots["momentum"])
    for i, leaf in enumerate(zl.tree_leaves(mom)):
        save(f"sref_{{mode}}_m{{i}}", leaf)
    o3.free()

if size == 2:
    o = Zero3Optimizer(comm, params, lr=0.05, momentum=0.9,
                       deterministic="linear")
    L = o.plan.n_layers
    s = pvar.session()
    for step in range(3):
        o.start_pass()
        for g in range(L):
            with o.layer(g) as ws:
                assert all(isinstance(w, torch.Tensor) for w in ws)
        o.start_pass(reverse=True)
        for g in reversed(range(L)):
            with o.layer(g):
                pass
        o.step(T(const_grads(rank, step)))
    record(out, "prefetch", {{
        "layers": L, "hits": s.read("zero_prefetch_hits"),
        "misses": s.read("zero_prefetch_misses"),
        "releases": s.read("zero3_releases"),
        "shard_bytes": o.shard_bytes, "replicated": o.replicated_bytes,
        "layer_bytes": list(o.plan.layer_bytes),
        "pad": sum(p.pad_bytes for p in o.plan.plans),
        "names": [o.plan.name_of(g) for g in range(L)]}})
    record(out, "hwm", pvar.read("zero3_resident_bytes"))
    o.free()

    o = Zero3Optimizer(comm, params, lr=0.05, deterministic="linear")
    s = pvar.session()
    o.start_pass()
    ws = o.fetch(3)
    record(out, "window_miss", s.read("zero_prefetch_misses"))
    save("window_b", ws[0])
    save("window_w", ws[1])
    o.release(3)
    o.free()

    template = [torch.zeros(40), torch.zeros(6, 5), torch.zeros(17)]
    sync = GradientSync(comm, template, deterministic="linear")
    pstate = zl.ShardedState.from_full(
        comm, [torch.ones(40), torch.full((6, 5), 2.0),
               torch.full((17,), 3.0)])
    req = comm.Allgather_multi_init(pstate)
    for cycle in range(3):
        sync.start()
        for i in reversed(range(sync.n_leaves)):
            sync.push(i, torch.full(template[i].shape,
                                    float(rank + cycle) + 0.5))
        summed = sync.finish()
        gstate = zl.ShardedState.from_full(comm, summed, plan=pstate.plan)
        pstate = pstate.map(lambda p, g: p - torch.tensor(0.1) * g, gstate)
        req.rebind(pstate)
        req.start()
        req.wait()
        for i, leaf in enumerate(req.array):
            save(f"compose_c{{cycle}}_{{i}}", leaf)
        req.discard()
        assert req.array is None
    req.free()
    record(out, "compose_freed", eclass(req.start))
    sync.free()

    st = zl.ShardedState.from_full(comm, [torch.ones(30)])
    req = comm.Allgather_multi_init(st)
    req.start(); req.wait()
    save("rebind_0", req.array[0])
    req.rebind(st.map(lambda s: s * torch.tensor(2.0)))
    req.start(); req.wait()
    save("rebind_1", req.array[0])
    other = zl.ShardedState.from_full(comm, [torch.ones(12),
                                             torch.ones(300)])
    errs = [eclass(lambda: req.rebind(other))]
    req.free()
    errs.append(eclass(lambda: req.rebind(st)))
    record(out, "rebind_errors", errs)

    cvar.set("coll_device_bucket_bytes", 64)
    fparams = {{"frozen_emb": torch.arange(16.).reshape(4, 4),
               "w1": torch.ones(4, 4), "w2": torch.ones(4, 4)}}
    opt = ZeroOptimizer(comm, fparams, lr=0.1, momentum=0.9,
                        deterministic="linear",
                        frozen={{"frozen_emb": True, "w1": False,
                                "w2": False}})
    s = pvar.session()
    g = {{k: torch.ones_like(v) for k, v in fparams.items()}}
    opt.step(g)
    p2 = opt.step(g)
    for i, leaf in enumerate(zl.tree_leaves(p2)):
        save(f"frozen_{{i}}", leaf)
    record(out, "frozen", [s.read("zero_ag_skipped"),
                           s.read("zero_rs_launches")])
    cvar.set("coll_device_bucket_bytes", 2048)

    mparams = {{"a": torch.arange(16.).reshape(4, 4), "b": torch.ones(4, 4)}}
    opt = ZeroOptimizer(comm, mparams, lr=0.1, momentum=0.9,
                        deterministic="linear",
                        frozen={{"a": True, "b": False}})
    mout = opt.step({{k: torch.ones_like(v) for k, v in mparams.items()}})
    save("mixed_a", mout["a"])
    save("mixed_b", mout["b"])
    record(out, "mixed_errors", [
        eclass(lambda: ZeroOptimizer(comm, mparams, frozen={{"a": True}})),
        eclass(lambda: ZeroOptimizer(comm, mparams, fused=True,
                                     frozen={{"a": True, "b": False}}))])

    hparams = {{"embed": np.arange(32, dtype=np.float32).reshape(8, 4),
               "layers": [{{"w": np.ones((4, 4), np.float32)}}
                          for _ in range(2)]}}
    o3 = Zero3Optimizer(comm, hparams, lr=0.1, momentum=0.9,
                        deterministic="linear")
    o1 = ZeroOptimizer(comm, hparams, lr=0.1, momentum=0.9, stage=1,
                       deterministic="linear")
    s = pvar.session()
    for step in range(3):
        o3.start_pass()
        for g in range(o3.plan.n_layers):
            with o3.layer(g):
                pass
        hg = {{"embed": np.full((8, 4), float(rank + 1), np.float32),
              "layers": [{{"w": np.full((4, 4), float(rank + 1),
                                       np.float32)}} for _ in range(2)]}}
        o3.step(hg)
        ref = o1.step(hg)
    record(out, "host_misses", s.read("zero_prefetch_misses"))
    for i, leaf in enumerate(zl.tree_leaves(o3.gathered_params())):
        assert isinstance(leaf, np.ndarray)
        save(f"host3_{{i}}", leaf)
    for i, leaf in enumerate(zl.tree_leaves(ref)):
        save(f"host1_{{i}}", leaf)

    so = Zero3Optimizer(mpi.COMM_SELF, {{"w": np.ones((4, 4), np.float32)}},
                        lr=0.5, deterministic="linear")
    for step in range(2):
        so.start_pass()
        with so.layer(0):
            pass
        so.step({{"w": np.ones((4, 4), np.float32)}})
    save("self_w", so.gathered_params()["w"])
    so.free()

    hb = [np.arange(50, dtype=np.float32) * (rank + 1),
          np.ones((7, 3), np.float64) * (rank + 0.5)]
    hst = comm.Reduce_scatter_multi(hb)
    assert all(isinstance(x, np.ndarray) for x in hst.shards)
    for b, sh in enumerate(hst.shards):
        save(f"hcycle_s{{b}}", sh)
    for i, leaf in enumerate(comm.Allgather_multi(hst)):
        save(f"hcycle_f{{i}}", leaf)

    cvar.set("coll_cuda", "on")
    fc = comm.dup()
    assert fc.coll.providers["zero3_gather_matmul_dev"] == "cuda"
    wparams = {{"wide": torch.arange(64.).reshape(8, 8) / 9}}
    rhs = torch.ones(8, 3) * 0.5
    for tag, c in (("fused", fc), ("plain", comm)):
        o = Zero3Optimizer(c, wparams, lr=0.1)
        s = pvar.session()
        o.start_pass()
        save(f"mm_{{tag}}", o.matmul(0, rhs))
        record(out, f"mm_{{tag}}", s.read("zero3_fused_matmuls"))
        o.free()
    cvar.set("coll_cuda", "off")

    eparams = {{"w": torch.ones(6, 4)}}
    o = Zero3Optimizer(comm, eparams, lr=0.1)
    errs = [eclass(lambda: o.fetch(5)),
            eclass(lambda: o.step([torch.ones(6, 4)] * 2))]
    o.free()
    errs += [eclass(lambda: ZeroOptimizer(comm, eparams, stage=3)),
             eclass(lambda: Zero3Plan({{}}, comm.size))]
    record(out, "z3_errors", errs)
    o = Zero3Optimizer(comm, {{"e": torch.ones(6, 4),
                              "l": [{{"w": torch.ones(4, 4)}}]}},
                       lr=0.1, deterministic="linear", error_feedback="bf16")
    s = pvar.session()
    for step in range(2):
        g = rand_grads(rank, step)
        o.step({{"e": torch.from_numpy(g["embed"][:6, :4].copy()),
                "l": [{{"w": torch.from_numpy(
                    g["layers"][0]["w"][:4, :4].copy())}}]}})
    for i, leaf in enumerate(zl.tree_leaves(o.gathered_params())):
        save(f"z3_ef_{{i}}", leaf)
    record(out, "z3_ef", s.read("zero_ef_steps"))
    o.free()

    class _Gated:
        def __init__(self, inner):
            self._inner = inner
        def rebind(self, *a, **k):
            raise errors.MPIError(errors.ERR_NOT_SUPPORTED, "gated")
        def free(self):
            self._inner.free()
    o = Zero3Optimizer(comm, {{"w": torch.ones(8, 4)}}, lr=0.5,
                       deterministic="linear")
    o._reqs[0] = _Gated(o._reqs[0])
    o.step({{"w": torch.ones(8, 4)}})
    assert not isinstance(o._reqs[0], _Gated)
    o.start_pass()
    with o.layer(0) as ws:
        save("gated", ws[0])
    o.free()

with open(f"{{out_dir}}/port_r{{rank}}.json", "w") as fh:
    json.dump(out, fh)
mpi.Finalize()
"""


def _port_job(src: str, n: int, mca) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n, mca=mca,
                                    timeout=180)
    finally:
        os.unlink(path)


_jobs = {}


def _results(n, tmp_path_factory):
    if n not in _jobs:
        out = tmp_path_factory.mktemp(f"zero3_n{n}")
        fmt = dict(inputs=_INPUTS, out_dir=str(out), steps=STEPS, lr=LR,
                   mu=MU)
        run_ranks("out_dir = " + repr(str(out)) + "\n"
                  + _REF_BODY.format(**fmt), n, mca=REF_MCA, timeout=300)
        rc = _port_job(_PORT_PROG.format(**fmt), n, PORT_MCA)
        assert rc == 0, f"port job exited {rc}"
        _jobs[n] = out
    return _jobs[n]


@pytest.fixture(params=[2, 3, 4], scope="module")
def results(request, tmp_path_factory):
    """(n, out_dir) of both packages' jobs on n ranks."""
    return request.param, _results(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def out2(tmp_path_factory):
    """The 2-rank jobs' output directory (the other cases)."""
    return _results(2, tmp_path_factory)


def _json(out, who, r):
    return json.loads((out / f"{who}_r{r}.json").read_text())


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _load(out, who, name, r):
    return np.load(out / f"{who}_{name}_r{r}.npy")


def _same_bits(out, name, n=2, who=("ref", "port")):
    for r in range(n):
        a, b = (_load(out, w, name, r) for w in who)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=name)


def _count(out, prefix):
    return len([p for p in os.listdir(out)
                if p.startswith(f"ref_{prefix}") and p.endswith("_r0.npy")])


def _inputs():
    ns = {"np": np}
    exec(_INPUTS, ns)
    return ns


def ring_bound(n: int, params, grads_for, steps: int, lr: float,
               mu: float, p):
    """Elementwise bound on |stage 3 'ring' - stage 2 'ring'| after
    ``steps`` momentum steps: two ring orders of an n-way sum differ by
    at most (n - 1) roundings of the running sum, so the averaged
    gradients differ by at most (n - 1) u sum_r |g_r| / n (u = 2**-24);
    momentum carries each step's difference with weight up to
    1 / (1 - mu), and every update may round the parameter once more
    differently (2 u |p|, both sides). Summed over the steps."""
    u = 2.0 ** -24
    leaves = [np.zeros_like(np.asarray(x), np.float64) for x in params]
    for step in range(steps):
        s = [np.zeros_like(x) for x in leaves]
        for r in range(n):
            for i, g in enumerate(grads_for(r, step)):
                s[i] += np.abs(g.astype(np.float64))
        for i in range(len(leaves)):
            leaves[i] += lr * (n - 1) * u * s[i] / n / (1 - mu)
    return [b * steps + 2 * steps * u * np.abs(x.astype(np.float64))
            for b, x in zip(leaves, p)]


def test_stage3_bit_identical_to_stage1_linear(results):
    """Stage 3 'linear': parameters and momentum bitwise equal to the
    reference's stage 3 and to the port's stage 1, after three momentum
    steps, on 2, 3 and 4 ranks (the 12 x 12 and 16 x 16 leaves pad on
    3)."""
    n, out = results
    for kind in ("p", "m"):
        for i in range(_count(out, f"s3_linear_{kind}")):
            _same_bits(out, f"s3_linear_{kind}{i}", n)
            for r in range(n):
                a = _load(out, "port", f"s3_linear_{kind}{i}", r)
                b = _load(out, "port", f"sref_linear_{kind}{i}", r)
                np.testing.assert_array_equal(_bits(a), _bits(b))


def test_stage3_ring_against_reference_and_stage2(results):
    """Stage 3 'ring' bitwise equal to the reference's stage 3 'ring'
    (the same per-layer buckets), and within :func:`ring_bound` of the
    port's stage 2 'ring' (whose buckets chunk the ring otherwise)."""
    import jax

    n, out = results
    ns = _inputs()
    params = jax.tree.leaves(ns["make_params"]())
    got = [_load(out, "port", f"s3_ring_p{i}", 0)
           for i in range(len(params))]
    want = [_load(out, "port", f"sref_ring_p{i}", 0)
            for i in range(len(params))]
    bound = ring_bound(n, params,
                       lambda r, s: jax.tree.leaves(ns["rand_grads"](r, s)),
                       STEPS, LR, MU, want)
    for g, w, b in zip(got, want, bound):
        assert (np.abs(g.astype(np.float64) - w) <= b).all()
    for kind in ("p", "m"):
        for i in range(_count(out, f"s3_ring_{kind}")):
            _same_bits(out, f"s3_ring_{kind}{i}", n)


def test_prefetch_steady_state_and_residency(out2):
    """Forward and backward passes: every fetch a hit, every layer
    released, the residency high watermark within shard + two layers,
    the shard O(1/n)."""
    for r in range(2):
        ref = _json(out2, "ref", r)["prefetch"]
        got = _json(out2, "port", r)["prefetch"]
        assert got == ref
        assert got["layers"] == 4 and got["misses"] == 0
        assert got["hits"] == got["releases"] == 3 * 2 * 4
        assert got["shard_bytes"] <= got["replicated"] / 2 + got["pad"] + 8
        hwm = _json(out2, "port", r)["hwm"]
        assert hwm <= got["shard_bytes"] + 2 * max(got["layer_bytes"]), hwm


def test_out_of_window_fetch_is_a_miss(out2):
    """A fetch outside the window is a miss and returns the layer."""
    for r in range(2):
        assert _json(out2, "port", r)["window_miss"] == \
            _json(out2, "ref", r)["window_miss"] == 1
    _same_bits(out2, "window_b")
    _same_bits(out2, "window_w")


def test_layer_prefetcher_window():
    """The run-ahead scheduler fires what the reference's fires."""
    from ompi_tpu.part.overlap import LayerPrefetcher as RefPrefetcher
    from ompi_tpu_torch import errors
    from ompi_tpu_torch.part.overlap import LayerPrefetcher

    logs = []
    for cls in (RefPrefetcher, LayerPrefetcher):
        fired, log = [], []
        pf = cls(fired.append, depth=2)
        pf.begin([10, 11, 12, 13, 14])
        log.append(list(fired))
        for layer in (10, 12, 99):
            pf.advance(layer)
            log.append(list(fired))
        log.append(pf.issued)
        pf.reset()
        pf.advance(13)
        log.append(list(fired))
        fired.clear()
        pf.begin(reversed(range(3)))
        log.append(list(fired))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][0] == [10, 11] and logs[1][-1] == [2, 1]
    with pytest.raises(errors.MPIError):
        LayerPrefetcher(print, depth=-1)


def test_gradient_sync_composed_with_persistent_allgather(out2):
    """GradientSync feeding a persistent Allgather_multi_init rebound to
    the updated shards each cycle; a start after free raises."""
    from ompi_tpu_torch import errors

    for c in range(3):
        for i in range(3):
            _same_bits(out2, f"compose_c{c}_{i}")
    for r in range(2):
        assert _json(out2, "port", r)["compose_freed"] == \
            _json(out2, "ref", r)["compose_freed"] == errors.ERR_REQUEST


def test_persistent_allgather_rebind_validation(out2):
    """rebind takes a same-plan state; another plan raises ERR_ARG and a
    freed request ERR_REQUEST."""
    from ompi_tpu_torch import errors

    _same_bits(out2, "rebind_0")
    _same_bits(out2, "rebind_1")
    for r in range(2):
        assert _json(out2, "port", r)["rebind_errors"] == \
            _json(out2, "ref", r)["rebind_errors"] == [errors.ERR_ARG,
                                                       errors.ERR_REQUEST]


def test_zero_ag_skipped_frozen_buckets(out2):
    """64-byte buckets: the all-frozen bucket's gather is skipped."""
    for i in range(3):
        _same_bits(out2, f"frozen_{i}")
    for r in range(2):
        ref = _json(out2, "ref", r)["frozen"]
        assert _json(out2, "port", r)["frozen"] == ref
        assert ref[0] >= 1 and ref[1] > 0


def test_frozen_mixed_bucket_and_validation(out2):
    """A frozen leaf in a live bucket stays put; a short flag tree raises
    ERR_COUNT and fused with frozen ERR_ARG."""
    from ompi_tpu_torch import errors

    _same_bits(out2, "mixed_a")
    _same_bits(out2, "mixed_b")
    for r in range(2):
        assert _json(out2, "port", r)["mixed_errors"] == \
            _json(out2, "ref", r)["mixed_errors"] == [errors.ERR_COUNT,
                                                      errors.ERR_ARG]


def test_zero3_host_cycle(out2):
    """Numpy parameters: the host stream, no misses, stage 1's result."""
    for r in range(2):
        assert _json(out2, "port", r)["host_misses"] == \
            _json(out2, "ref", r)["host_misses"] == 0
    for i in range(3):
        _same_bits(out2, f"host3_{i}")
        _same_bits(out2, f"host3_{i}", who=("port", "port"))
        for r in range(2):
            np.testing.assert_array_equal(
                _load(out2, "port", f"host3_{i}", r),
                _load(out2, "port", f"host1_{i}", r))


def test_zero3_size1_trivial_path(out2):
    """COMM_SELF: the stream degenerates to local arithmetic."""
    _same_bits(out2, "self_w")
    np.testing.assert_allclose(_load(out2, "port", "self_w", 0),
                               np.zeros((4, 4), np.float32))


def test_host_fallback_cycle(out2):
    """tests/test_zero.py's host cycle: numpy (float32 and float64)
    leaves, numpy shards, the reference's sums."""
    for b in range(_count(out2, "hcycle_s")):
        _same_bits(out2, f"hcycle_s{b}")
    for i in range(2):
        _same_bits(out2, f"hcycle_f{i}")
    np.testing.assert_allclose(_load(out2, "port", "hcycle_f1", 0),
                               np.full((7, 3), 2.0))


def test_zero3_fused_gather_matmul(out2):
    """coll_cuda on (CPU tensors): the product through
    zero3_gather_matmul_dev, counted; the reference's within 1e-6."""
    ref = np.arange(64, dtype=np.float32).reshape(8, 8) / 9 @ np.full(
        (8, 3), 0.5, np.float32)
    for r in range(2):
        assert _json(out2, "port", r)["mm_fused"] == \
            _json(out2, "ref", r)["mm_fused"] == 1
        got = _load(out2, "port", "mm_fused", r)
        np.testing.assert_allclose(got, _load(out2, "ref", "mm_fused", r),
                                   rtol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_zero3_matmul_fallthrough_without_cuda(out2):
    """Without coll/cuda the product is fetch + the local product."""
    for r in range(2):
        assert _json(out2, "port", r)["mm_plain"] == \
            _json(out2, "ref", r)["mm_plain"] == 0
        np.testing.assert_allclose(_load(out2, "port", "mm_plain", r),
                                   _load(out2, "ref", "mm_plain", r),
                                   rtol=1e-6)


def test_zero3_erroneous_calls_raise_mpierror(out2):
    """Fetch out of range and a wrong leaf count raise ERR_COUNT,
    stage=3 and an empty tree ERR_ARG. ``error_feedback='bf16'`` (which
    raised ERR_NOT_SUPPORTED before the hierarchy slice) runs: two
    'linear' steps over two layers, one residual each (zero_ef_steps 4),
    the gathered parameters bitwise the reference's."""
    from ompi_tpu_torch import errors

    for r in range(2):
        assert _json(out2, "port", r)["z3_errors"] == \
            _json(out2, "ref", r)["z3_errors"] == [
                errors.ERR_COUNT, errors.ERR_COUNT, errors.ERR_ARG,
                errors.ERR_ARG]
        assert _json(out2, "port", r)["z3_ef"] == \
            _json(out2, "ref", r)["z3_ef"] == 4
    for i in range(2):
        _same_bits(out2, f"z3_ef_{i}")


def test_refresh_falls_back_to_reinit_when_rebind_gated(out2):
    """A request whose rebind raises ERR_NOT_SUPPORTED is freed and
    re-initialized; the stream goes on with the updated values."""
    _same_bits(out2, "gated")
    np.testing.assert_allclose(_load(out2, "port", "gated", 0),
                               np.full((8, 4), 0.5, np.float32))


def test_layer_groups_match_reference_on_gpt2():
    """layer_groups on a GPT-2-shaped tree at tiny widths, and on the
    reference tests' trees: the same (name, leaf indices) tuples."""
    import jax

    from ompi_tpu.zero import layout as ref_zl
    from ompi_tpu_torch.examples.zero_training import gpt2_spec
    from ompi_tpu_torch.zero import layout as zl

    spec = gpt2_spec({"n_embd": 8, "n_layer": 12, "n_positions": 16,
                      "vocab_size": 31}, 12)
    tree = zl.tree_unflatten(zl.tree_flatten(spec)[1], [
        np.zeros(tuple(s), np.float32) for s in zl.tree_leaves(spec)])
    got = zl.layer_groups(tree)
    assert got == ref_zl.layer_groups(tree)
    assert [name for name, _ in got] == [f"['h'][{i}]" for i in range(12)] \
        + ["['ln_f']", "['wpe']", "['wte']"]
    for t in (_inputs()["make_params"](),
              [{"a": 1.0, "b": [2.0, 3.0]}, ({"c": 4.0}, 5.0)],
              ({"x": [1.0, (2.0, 3.0)]}, {"y": {"z": [4.0]}})):
        assert zl.layer_groups(t) == ref_zl.layer_groups(t)
        assert [zl.keystr(p) for p, _ in zl.tree_flatten_with_path(t)] == \
            [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(t)[0]]
