"""The port's ZeRO slice (zero/, stage 2 and stage 1, coll/device's bucket
slots and Allreduce_multi, coll/cuda's fused slots) against the JAX
package.

One job per package and comm size n: the reference runs through
``tests.harness.run_ranks`` with ``device_plane on``, ``coll_pallas on``
and a small ``coll_xla_bucket_bytes`` (several buckets); the port through
``ompi_tpu_torch.runtime.launcher`` with the same settings mapped by
``compat.mca_from_reference`` plus ``device_plane_platform cpu``. Both
make the same parameters and per-(rank, step) gradients from a seed with
numpy (a pytree with keys out of sorted order, a bfloat16 leaf beside
float32 ones and an odd element count), run ZeroOptimizer two steps with
momentum in each mode (stage 1 in 'linear' and 'ring' too), the
frozen-leaf run, Allreduce_multi of the gradients in each mode and the
fused matmuls, and write every result as ``.npy``.

Tolerances: unfused and fused ``'linear'``, stage 1 and
``Allreduce_multi`` in ``'linear'`` and ``'ring'`` bitwise (and stage 1
``'linear'`` bitwise equal to the port's stage 2); the fused default
within one rounding of the reference's fused default (rtol 1e-6 float32,
whose fused epilogue may contract a multiply-add; 2e-2 for the bfloat16
leaf); the port's own fused default bitwise equal to its unfused
``'ring'`` step; allgather_matmul |err| <= tol * (|x| @ |w|) with tol
1e-5 float32, 2e-2 bfloat16, int32 exact.

One more port job, on 4 ranks, runs the fused ring and the fused
'linear' step under the span recorder over the same multi-bucket plan:
each bucket one ``coll_device`` launch inside the optimizer's ``zero``
step span, each host step one ``transport`` sync / wait pair inside a
launch, the persistent allgather counting one launch a bucket, and no
span dropped at a traced benchmark run's length. In this process the
pytree walkers free their leaves without the cyclic collector.
"""

import json
import os
import sys
import tempfile
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from ompi_tpu_torch import compat
from ompi_tpu_torch.runtime import launcher as port_launcher
from ompi_tpu_torch.zero import layout as zl
from tests.harness import run_ranks
from tests.test_torch_coll_cuda_kernels import assert_bits_equal
from tests.test_torch_mpit import reference_only_state  # noqa: F401

REF_MCA = {"device_plane": "on", "coll_pallas": "on",
           "coll_xla_bucket_bytes": "64"}
PORT_MCA = dict(compat.mca_from_reference(REF_MCA),
                device_plane_platform="cpu")
#: (mode, fused, deterministic)
MODES = [("unfused_linear", False, "linear"),
         ("fused_linear", True, "linear"),
         ("unfused_ring", False, "ring"),
         ("fused_default", True, None)]
#: ZeRO stage 1 (Allreduce_multi, then the local shard): (mode, det)
STAGE1 = [("stage1_linear", "linear"), ("stage1_ring", "ring")]
#: Allreduce_multi of the step-0 gradients: (mode, deterministic)
ARM = [("linear", "linear"), ("ring", "ring"), ("default", None)]
#: matmul cases: (name, x dtype, w dtype)
MATMULS = [("f32", "float32", "float32"), ("bf16", "bfloat16", "bfloat16"),
           ("i32", "int32", "int32"), ("i32_bf16", "int32", "bfloat16")]

#: shared verbatim by both rank programs: numpy trees from a seed
_INPUTS = """
def make_params():
    rng = np.random.default_rng(21)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": f(5, 7), "b": f(13),
            "layers": [{"k": f(3, 3), "a": f(11)}, {"k": f(2, 9), "a": f(5)}],
            "emb": f(17, 4)}

def make_grads(rank, step):
    rng = np.random.default_rng(1000 + 10 * rank + step)
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    return {"w": f(5, 7), "b": f(13),
            "layers": [{"k": f(3, 3), "a": f(11)}, {"k": f(2, 9), "a": f(5)}],
            "emb": f(17, 4)}

BF16 = ("a",)  # leaves named so are bfloat16
FROZEN = {"w": False, "b": True,
          "layers": [{"k": True, "a": False}, {"k": True, "a": True}],
          "emb": False}

def matmul_inputs(name, xdt, wdt, rank):
    rng = np.random.default_rng(300 + rank)
    full = xdt == wdt == "int32"
    def m(shape, dt, rng):
        if dt == "int32":
            lo, hi = (-2**31, 2**31 - 1) if full else (-50, 50)
            return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)
        return rng.standard_normal(shape).astype(np.float32)
    return m((6, 10), xdt, rng), m((10, 4), wdt, np.random.default_rng(7))

def zero3_inputs():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((12, 10)).astype(np.float32),
            rng.standard_normal((10, 3)).astype(np.float32))
"""

_REF_BODY = """
import jax, jax.numpy as jnp
from ompi_tpu.core import pvar
from ompi_tpu.zero import layout as zl
from ompi_tpu.zero.optimizer import ZeroOptimizer
{inputs}
def to_jax(tree):
    def leaf(path, a):
        dt = "bfloat16" if getattr(path[-1], "key", None) in BF16 else a.dtype
        return jnp.asarray(a).astype(dt)
    return jax.tree_util.tree_map_with_path(leaf, tree)

def save(name, a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    np.save(f"{out_dir}/ref_{{name}}_r{{rank}}.npy", a)

params = to_jax(make_params())
plan = zl.plan_for(jax.tree.leaves(params), size)
if rank == 0:
    with open(f"{out_dir}/ref_plan.json", "w") as fh:
        json.dump({{"buckets": plan.buckets, "padded": plan.padded,
                    "shard_elems": plan.shard_elems,
                    "dtypes": list(plan.dtypes)}}, fh)
for mode, fused, det in {modes!r}:
    opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9,
                        deterministic=det, fused=fused)
    for step in range(2):
        out = opt.step(to_jax(make_grads(rank, step)))
    for i, leaf in enumerate(jax.tree.leaves(out)):
        save(f"{{mode}}_p{{i}}", leaf)
    for b, s in enumerate(opt.state.slots["momentum"].shards):
        save(f"{{mode}}_m{{b}}", s)
for mode, det in {stage1!r}:
    opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9, stage=1,
                        deterministic=det)
    for step in range(2):
        out = opt.step(to_jax(make_grads(rank, step)))
    for i, leaf in enumerate(jax.tree.leaves(out)):
        save(f"{{mode}}_p{{i}}", leaf)
    for b, s in enumerate(opt.state.slots["momentum"].shards):
        save(f"{{mode}}_m{{b}}", s)
for mode, det in {arm!r}:
    out = comm.Allreduce_multi(to_jax(make_grads(rank, 0)),
                               deterministic=det)
    for i, leaf in enumerate(jax.tree.leaves(out)):
        save(f"arm_{{mode}}_{{i}}", leaf)
s = pvar.session()
opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9,
                    deterministic="linear", frozen=FROZEN)
for step in range(2):
    out = opt.step(to_jax(make_grads(rank, step)))
for i, leaf in enumerate(jax.tree.leaves(out)):
    save(f"frozen_p{{i}}", leaf)
save("frozen_skipped", np.asarray(s.read("zero_ag_skipped")))
opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9,
                    deterministic="linear", error_feedback="bf16")
for step in range(2):
    out = opt.step(to_jax(make_grads(rank, step)))
for i, leaf in enumerate(jax.tree.leaves(out)):
    save(f"ef_p{{i}}", leaf)
for name, xdt, wdt in {matmuls!r}:
    x, w = matmul_inputs(name, xdt, wdt, rank)
    out = comm.coll.allgather_matmul_dev(
        comm, jnp.asarray(x).astype(xdt), jnp.asarray(w).astype(wdt))
    save(f"agmm_{{name}}", out)
wz, rhs = zero3_inputs()
st = zl.ShardedState.from_full(comm, {{"w": jnp.asarray(wz)}})
save("zero3", comm.coll.zero3_gather_matmul_dev(comm, st, jnp.asarray(rhs)))
"""

_PORT_PROG = """
import json
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.zero import ZeroOptimizer, layout as zl
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
assert comm.coll.providers["reduce_scatter_multi_dev"] == "device"
assert comm.coll.providers["fused_rs_update_dev"] == "cuda"
{inputs}
def to_torch(tree):
    def walk(t, key=None):
        if isinstance(t, dict):
            return {{k: walk(v, k) for k, v in t.items()}}
        if isinstance(t, list):
            return [walk(v) for v in t]
        x = compat.tensor_from_numpy(t)
        return x.to(torch.bfloat16) if key in BF16 else x
    return walk(tree)

def save(name, t):
    np.save(f"{{out_dir}}/port_{{name}}_r{{rank}}.npy",
            compat.tensor_to_numpy(t) if isinstance(t, torch.Tensor)
            else np.asarray(t))

def expect_error(cls, fn):
    try:
        fn()
    except errors.MPIError as e:
        assert e.error_class == cls, e
        return str(e)
    raise AssertionError("no MPIError raised")

params = to_torch(make_params())
plan = zl.plan_for(zl.tree_leaves(params), size)
if rank == 0:
    with open(f"{{out_dir}}/port_plan.json", "w") as fh:
        json.dump({{"buckets": plan.buckets, "padded": plan.padded,
                    "shard_elems": plan.shard_elems,
                    "dtypes": list(plan.dtypes)}}, fh)
for mode, fused, det in {modes!r}:
    opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9,
                        deterministic=det, fused=fused)
    s = pvar.session()
    for step in range(2):
        out = opt.step(to_torch(make_grads(rank, step)))
    assert s.read("coll_cuda_fused_launches") == (
        2 * len(plan.buckets) if fused else 0), mode
    assert s.read("coll_cuda_fallthrough") == 0, mode
    for i, leaf in enumerate(zl.tree_leaves(out)):
        save(f"{{mode}}_p{{i}}", leaf)
    for b, sh in enumerate(opt.state.slots["momentum"].shards):
        save(f"{{mode}}_m{{b}}", sh)
for mode, det in {stage1!r}:
    opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9, stage=1,
                        deterministic=det)
    s = pvar.session()
    for step in range(2):
        out = opt.step(to_torch(make_grads(rank, step)))
    # stage 1 allreduces whole buckets; it reduce-scatters nothing
    assert s.read("coll_device_fused_bytes") > 0, mode
    assert s.read("zero_rs_launches") == 0, mode
    for i, leaf in enumerate(zl.tree_leaves(out)):
        save(f"{{mode}}_p{{i}}", leaf)
    for b, sh in enumerate(opt.state.slots["momentum"].shards):
        save(f"{{mode}}_m{{b}}", sh)
for mode, det in {arm!r}:
    out = comm.Allreduce_multi(to_torch(make_grads(rank, 0)),
                               deterministic=det)
    for i, leaf in enumerate(zl.tree_leaves(out)):
        save(f"arm_{{mode}}_{{i}}", leaf)
s = pvar.session()
opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9,
                    deterministic="linear", frozen=FROZEN)
for step in range(2):
    out = opt.step(to_torch(make_grads(rank, step)))
for i, leaf in enumerate(zl.tree_leaves(out)):
    save(f"frozen_p{{i}}", leaf)
save("frozen_skipped", s.read("zero_ag_skipped"))
for name, xdt, wdt in {matmuls!r}:
    x, w = matmul_inputs(name, xdt, wdt, rank)
    out = comm.coll.allgather_matmul_dev(
        comm, compat.tensor_from_numpy(x).to(getattr(torch, xdt)),
        compat.tensor_from_numpy(w).to(getattr(torch, wdt)))
    save(f"agmm_{{name}}", out)
wz, rhs = zero3_inputs()
st = zl.ShardedState.from_full(comm, {{"w": compat.tensor_from_numpy(wz)}})
save("zero3", comm.coll.zero3_gather_matmul_dev(
    comm, st, compat.tensor_from_numpy(rhs)))

# the port's stated differences and its erroneous calls, on every rank
s = pvar.session()
# int16 is outside the kernels: coll/device's allgather, then the plain
# product (the reference composes coll/xla's allgather with jnp.dot)
xi = torch.arange(6, dtype=torch.int16).reshape(2, 3) - 2
wi = torch.arange(6, dtype=torch.int16).reshape(3, 2) * 3 - 7
got = comm.coll.allgather_matmul_dev(comm, xi + rank, wi)
full = torch.cat([xi + p for p in range(size)])
assert got.dtype == torch.int16 and torch.equal(got, full @ wi), got
assert s.read("coll_cuda_fallthrough") == 1
st = zl.ShardedState.from_full(comm, params)
assert comm.coll.zero3_gather_matmul_dev(comm, st, torch.ones(3, 2)) is None
assert s.read("coll_cuda_fallthrough") == 2
# error feedback: the 'linear' step with a bf16 wire, against the reference
opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9,
                    deterministic="linear", error_feedback="bf16")
for step in range(2):
    out = opt.step(to_torch(make_grads(rank, step)))
for i, leaf in enumerate(zl.tree_leaves(out)):
    save(f"ef_p{{i}}", leaf)
for kw in ({{"overlap": True, "fused": True}}, {{"fused": True,
                                                "frozen": FROZEN}}):
    expect_error(errors.ERR_ARG, lambda: ZeroOptimizer(comm, params, **kw))
# numpy leaves take the host bucket cycle: this rank's shards of the sums
hb = [np.arange(9, dtype=np.float32) * (rank + 1), np.ones((3, 2), np.float32)]
hst = comm.Reduce_scatter_multi(hb)
sums = [np.arange(9, dtype=np.float32) * sum(range(1, size + 1)),
        np.full((3, 2), float(size), np.float32)]
own = zl.ShardedState.from_full(comm, sums, plan=hst.plan)
assert all(isinstance(a, np.ndarray) and np.array_equal(a, b)
           for a, b in zip(hst.shards, own.shards))
expect_error(errors.ERR_COUNT, lambda: comm.Allgather_multi(
    zl.ShardedState(st.plan, st.metas, st.treedef, st.shards[:-1],
                    rank, size)))
open(f"{{out_dir}}/port_errors_r{{rank}}.ok", "w").close()
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


@pytest.fixture(params=[2, 3], scope="module")
def results(request, tmp_path_factory):
    """Run both packages' jobs once per n; returns (n, out_dir)."""
    n = request.param
    if n not in _jobs:
        out = tmp_path_factory.mktemp(f"zero_n{n}")
        fmt = dict(inputs=_INPUTS, modes=MODES, matmuls=MATMULS,
                   stage1=STAGE1, arm=ARM, out_dir=str(out))
        run_ranks("import json\nout_dir = " + repr(str(out)) + "\n"
                  + _REF_BODY.format(**fmt), n, mca=REF_MCA, timeout=300)
        rc = _port_job(_PORT_PROG.format(**fmt), n, PORT_MCA)
        assert rc == 0, f"port job exited {rc}"
        _jobs[n] = out
    return n, _jobs[n]


#: the traced 4-rank job: ZeRO-2 steps of the fused ring and of the
#: fused 'linear' over the multi-bucket plan, under the span recorder
_TRACED_PROG = """
import json
import numpy as np
from ompi_tpu_torch import compat, mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.trace import recorder
from ompi_tpu_torch.zero import ZeroOptimizer, layout as zl
comm = mpi.Init()
rank, size = comm.rank, comm.size
{inputs}
params = compat.tree_from_numpy(make_params())
doc = {{"buckets": len(zl.plan_for(zl.tree_leaves(params), size).buckets),
        "capacity": recorder.Recorder().capacity}}
for mode, det in (("ring", None), ("linear", "linear")):
    opt = ZeroOptimizer(comm, params, lr=0.1, momentum=0.9,
                        deterministic=det, fused=True)
    opt.step(compat.tree_from_numpy(make_grads(rank, 0)))  # arenas mapped
    rec = recorder.enable(rank=rank)
    rec.clear()
    s = pvar.session()
    for step in range({steps}):
        opt.step(compat.tree_from_numpy(make_grads(rank, step)))
    recorder.disable()
    doc[mode] = {{
        "spans": [[sp.name, sp.subsys, sp.t0, sp.t1,
                   (sp.args or {{}}).get("op")] for sp in rec.spans()],
        "launches": s.read("coll_device_launches"),
        "dropped": s.read("trace_dropped")}}
# the persistent form (stage 3's): one launch a bucket at each start
s = pvar.session()
req = comm.Allgather_multi_init(opt.state.params)
for _ in range(2):
    req.start()
    req.wait()
req.free()
doc["persistent"] = s.read("coll_device_launches")
with open({out!r} + f"/traced_r{{rank}}.json", "w") as fh:
    json.dump(doc, fh)
mpi.Finalize()
"""
#: ZeRO steps the traced job records a mode
TRACED_STEPS = 2
#: the steps of a traced run of a one-card cell the recorder holds (the
#: last four fifths of a 10 s window at about 14 ms a step)
TRACED_RUN_STEPS = 550


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Every rank's record of the traced 4-rank job."""
    out = tmp_path_factory.mktemp("zero_traced")
    rc = _port_job(_TRACED_PROG.format(inputs=_INPUTS, out=str(out),
                                       steps=TRACED_STEPS), 4, PORT_MCA)
    assert rc == 0, f"port job exited {rc}"
    return [json.loads((out / f"traced_r{r}.json").read_text())
            for r in range(4)]


def _inside(span, spans) -> bool:
    return any(o[2] <= span[2] and span[3] <= o[3] for o in spans)


@pytest.mark.parametrize("mode", ["ring", "linear"])
def test_transport_spans_pair_up_inside_the_launches(traced, mode):
    """Each host step of a schedule is one ``sync`` and one ``wait`` span
    in ``transport`` (the wait begins where the sync ends), naming the
    arena, and every one lies inside a ``coll_device`` launch: a bucket's
    ring is n host steps (its staging and n - 1 hops), 'linear''s fold
    two, the allgather's pull two."""
    for r, doc in enumerate(traced):
        spans = doc[mode]["spans"]
        tr = sorted((s for s in spans if s[1] == "transport"),
                    key=lambda s: s[2])
        launches = [s for s in spans if s[0] == "launch"
                    and s[1] == "coll_device"]
        per_bucket = (4 if mode == "ring" else 2) + 2
        assert len(tr) == 2 * per_bucket * doc["buckets"] * TRACED_STEPS
        for sync, wait in zip(tr[::2], tr[1::2]):
            assert (sync[0], wait[0]) == ("sync", "wait"), (r, sync, wait)
            assert wait[2] == sync[3] and sync[4] == wait[4]
            assert sync[4].startswith(("rs", "pull")), sync
        assert all(_inside(s, launches) for s in tr), r


@pytest.mark.parametrize("mode", ["ring", "linear"])
def test_each_bucket_is_one_launch_inside_the_zero_step(traced, mode):
    """The fused slot's buckets and the allgather's buckets each run as
    one launch of coll/device's funnel (``launch`` spans in
    ``coll_device`` naming the slot, one ``coll_device_launches`` each,
    as each of the reference's buckets is one ``coll_xla_launches``),
    inside the optimizer's ``step`` span in ``zero``; the fused slot
    stays one ``coll_cuda`` launch a step."""
    for doc in traced:
        spans, b = doc[mode]["spans"], doc["buckets"]
        steps = [s for s in spans if (s[0], s[1]) == ("step", "zero")]
        launches = [s for s in spans if s[0] == "launch"
                    and s[1] == "coll_device"]
        assert len(steps) == TRACED_STEPS
        assert sorted(s[4] for s in launches) == \
            ["allgather_multi"] * (b * TRACED_STEPS) \
            + ["fused_rs_update"] * (b * TRACED_STEPS)
        assert doc[mode]["launches"] == len(launches)
        assert all(_inside(s, steps) for s in launches)
        cuda = [s for s in spans if s[0] == "launch" and s[1] == "coll_cuda"]
        assert len(cuda) == TRACED_STEPS and all(
            _inside(s, cuda) for s in launches
            if s[4] == "fused_rs_update")
        assert not [s for s in spans if s[0] == "plan_cache_hit"]


def test_persistent_allgather_counts_each_bucket_once(traced):
    """Each start of the persistent allgather (ZeRO stage 3's request)
    launches every bucket once through the funnel, and nothing more."""
    for doc in traced:
        assert doc["persistent"] == 2 * doc["buckets"]


def test_a_traced_run_drops_no_span(traced):
    """A step's spans times the steps of a one-card cell's traced run
    fit the recorder's ring (``trace_buffer_spans``), so the benchmark's
    readers see every span: nothing was dropped here either."""
    for doc in traced:
        for mode in ("ring", "linear"):
            assert doc[mode]["dropped"] == 0
            per_step = len(doc[mode]["spans"]) / TRACED_STEPS + 1
            assert per_step * TRACED_RUN_STEPS < doc["capacity"], per_step


def test_tree_unflatten_frees_its_leaves_without_the_collector():
    """The pytree walkers hold no reference cycle: with the cyclic
    collector off, the leaves of a ``tree_unflatten`` result (dict, list,
    tuple and None nodes) and of a ``tree_flatten`` input die as soon as
    the last reference goes."""
    import gc
    import weakref

    was = gc.isenabled()
    gc.disable()
    try:
        leaves = [torch.ones(3), torch.ones(2), torch.ones(4),
                  torch.ones(1)]
        refs = [weakref.ref(x) for x in leaves]
        tree = {"b": [leaves[0], None, (leaves[1], {"a": leaves[2]})],
                "a": leaves[3]}
        flat, treedef = zl.tree_flatten(tree)
        out = zl.tree_unflatten(treedef, flat)
        assert zl.tree_leaves(out) == flat
        paths = zl.tree_flatten_with_path(out)
        assert [p for p, _ in paths][0] == (("key", "a"),)
        del leaves, tree, flat, out, paths
        assert [r() for r in refs] == [None] * 4
    finally:
        if was:
            gc.enable()


def _pair(out, name, r):
    return (np.load(out / f"ref_{name}_r{r}.npy"),
            np.load(out / f"port_{name}_r{r}.npy"))


def _count(out, prefix):
    return len([p for p in os.listdir(out)
                if p.startswith(f"ref_{prefix}") and p.endswith("_r0.npy")])


def _as_float(a):
    return (a.astype(np.uint32) << 16).view(np.float32) \
        if a.dtype == np.uint16 else a.astype(np.float64)


def test_zero_plan_matches_reference(results):
    """Same buckets (leaf order = jax's sorted-key flatten), padding,
    shard lengths and dtype names."""
    n, out = results
    ref = json.loads((out / "ref_plan.json").read_text())
    got = json.loads((out / "port_plan.json").read_text())
    assert got == ref
    assert len(ref["buckets"]) > 2 and set(ref["dtypes"]) == {"float32",
                                                             "bfloat16"}


@pytest.mark.parametrize("mode", ["unfused_linear", "fused_linear"])
def test_linear_step_bitwise_equal_to_reference(results, mode):
    """Parameters and momentum shards after two momentum steps."""
    n, out = results
    for kind in ("p", "m"):
        for i in range(_count(out, f"{mode}_{kind}")):
            for r in range(n):
                ref, got = _pair(out, f"{mode}_{kind}{i}", r)
                assert_bits_equal(ref, got, f"{mode} {kind}{i} rank {r}")


@pytest.mark.parametrize("mode", [m for m, _ in STAGE1])
def test_stage1_bitwise_equal_to_reference(results, mode):
    """ZeRO stage 1 (Allreduce_multi, then the local shard) under
    'linear' and 'ring': parameters and momentum shards after two steps,
    bitwise equal to the reference's stage 1."""
    n, out = results
    for kind in ("p", "m"):
        assert _count(out, f"{mode}_{kind}")
        for i in range(_count(out, f"{mode}_{kind}")):
            for r in range(n):
                ref, got = _pair(out, f"{mode}_{kind}{i}", r)
                assert_bits_equal(ref, got, f"{mode} {kind}{i} rank {r}")


def test_stage1_linear_bitwise_equal_to_stage2_linear(results):
    """Both fold each element in rank order: the port's stage-1 'linear'
    step equals its unfused stage-2 'linear' step bit for bit."""
    n, out = results
    for kind in ("p", "m"):
        for i in range(_count(out, f"unfused_linear_{kind}")):
            for r in range(n):
                a = np.load(out / f"port_stage1_linear_{kind}{i}_r{r}.npy")
                b = np.load(out / f"port_unfused_linear_{kind}{i}_r{r}.npy")
                assert_bits_equal(b, a, f"{kind}{i} rank {r}")


@pytest.mark.parametrize("mode", [m for m, _ in ARM])
def test_allreduce_multi_against_reference(results, mode):
    """Allreduce_multi over the gradient pytree (several buckets of
    coll_xla_bucket_bytes, odd lengths): 'linear' and 'ring' bitwise
    equal to coll/xla's, '' within one rounding (rtol 1e-5 float32, 2e-2
    bfloat16)."""
    n, out = results
    count = _count(out, f"arm_{mode}_")
    assert count == len(jax.tree.leaves(_load_inputs()["make_grads"](0, 0)))
    for i in range(count):
        for r in range(n):
            ref, got = _pair(out, f"arm_{mode}_{i}", r)
            if mode != "default":
                assert_bits_equal(ref, got, f"arm {mode} {i} rank {r}")
                continue
            tol = 2e-2 if ref.dtype == np.uint16 else 1e-5
            np.testing.assert_allclose(_as_float(got), _as_float(ref),
                                       rtol=tol, atol=tol)


def test_fused_default_within_one_rounding_of_reference(results):
    n, out = results
    for kind in ("p", "m"):
        for i in range(_count(out, f"fused_default_{kind}")):
            for r in range(n):
                ref, got = _pair(out, f"fused_default_{kind}{i}", r)
                tol = 2e-2 if ref.dtype == np.uint16 else 1e-6
                np.testing.assert_allclose(_as_float(got), _as_float(ref),
                                           rtol=tol, atol=tol)


def test_fused_default_bitwise_equal_to_unfused_ring(results):
    """K5 rounds after every op: the port's fused step is its unfused
    'ring' step, bit for bit (the reference only promises one rounding)."""
    n, out = results
    for kind in ("p", "m"):
        for i in range(_count(out, f"fused_default_{kind}")):
            for r in range(n):
                a = np.load(out / f"port_fused_default_{kind}{i}_r{r}.npy")
                b = np.load(out / f"port_unfused_ring_{kind}{i}_r{r}.npy")
                assert_bits_equal(b, a, f"{kind}{i} rank {r}")


def test_frozen_leaves_stay_put(results):
    """Frozen leaves keep their initial bits, the run matches the
    reference's bitwise, and the all-frozen buckets' allgathers were
    skipped as often as the reference skipped them."""
    n, out = results
    init = jax.tree.leaves(_load_inputs()["make_params"]())
    frozen = jax.tree.leaves(_load_inputs()["FROZEN"])
    for i in range(_count(out, "frozen_p")):
        for r in range(n):
            ref, got = _pair(out, f"frozen_p{i}", r)
            assert_bits_equal(ref, got, f"frozen p{i} rank {r}")
            if frozen[i] and got.dtype == np.float32:
                assert_bits_equal(init[i], got, f"frozen leaf {i}")
    ref, got = _pair(out, "frozen_skipped", 0)
    assert int(got) == int(ref) > 0


@pytest.mark.parametrize("case", MATMULS, ids=lambda c: c[0])
def test_allgather_matmul_against_reference(results, case):
    n, out = results
    name, xdt, wdt = case
    inp = _load_inputs()
    xs = [inp["matmul_inputs"](name, xdt, wdt, r)[0] for r in range(n)]
    w = inp["matmul_inputs"](name, xdt, wdt, 0)[1]
    mag = np.abs(np.concatenate(xs).astype(np.float64)) @ np.abs(
        w.astype(np.float64))
    for r in range(n):
        ref, got = _pair(out, f"agmm_{name}", r)
        assert ref.shape == got.shape == (n * 6, 4)
        assert ref.dtype == got.dtype
        if ref.dtype == np.int32:
            np.testing.assert_array_equal(got, ref)
        else:
            tol = 2e-2 if ref.dtype == np.uint16 else 1e-5
            assert (np.abs(_as_float(got) - _as_float(ref))
                    <= tol * mag + 1e-30).all(), name


def test_zero3_gather_matmul_against_reference(results):
    n, out = results
    wz, rhs = _load_inputs()["zero3_inputs"]()
    mag = np.abs(wz.astype(np.float64)) @ np.abs(rhs.astype(np.float64))
    for r in range(n):
        ref, got = _pair(out, "zero3", r)
        assert got.shape == (12, 3)
        assert (np.abs(got - ref) <= 1e-5 * mag).all()


def test_error_paths(results):
    """int16 allgather_matmul_dev returns the composed allgather + plain
    product and counts coll_cuda_fallthrough (as the reference falls
    through to coll/xla); overlap with fused raises ERR_ARG (the
    reference's rule); numpy leaves take the host bucket cycle, whose
    shards equal ShardedState.from_full of the sums; checked inside the
    port job. ``error_feedback='bf16'`` (which raised ERR_NOT_SUPPORTED
    before the hierarchy slice) runs: two 'linear' steps with momentum,
    every parameter bitwise the reference's."""
    n, out = results
    for r in range(n):
        assert (out / f"port_errors_r{r}.ok").exists()
        i = 0
        while (out / f"ref_ef_p{i}_r{r}.npy").exists():
            ref, got = _pair(out, f"ef_p{i}", r)
            assert_bits_equal(got, ref)
            i += 1
        assert i == 7, i


# ---------------------------------------------------------------------------
# single process: the layout and the compat converters


def _load_inputs():
    ns = {"np": np}
    exec(_INPUTS, ns)
    return ns


def test_tree_flatten_matches_jax_order():
    tree = {"z": 1, "b": [2, (3, {"y": 4, "x": 5})], "a": None,
            "m": {"q": 6, "c": [7]}}
    leaves, treedef = zl.tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    back = zl.tree_unflatten(treedef, leaves)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert jax.tree.leaves(back) == leaves


@pytest.mark.usefixtures("reference_only_state")
@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_state_from_reference(n):
    """A reference ShardedState carried across equals the port's own
    from_full of the same parameters (plan and shards, bitwise)."""
    import jax.numpy as jnp
    from ompi_tpu.core import cvar as ref_cvar
    from ompi_tpu.zero import layout as ref_zl
    from ompi_tpu_torch.core import cvar

    params = _load_inputs()["make_params"]()
    jparams = jax.tree.map(jnp.asarray, params)
    jparams["layers"][0]["a"] = jparams["layers"][0]["a"].astype("bfloat16")
    tparams = compat.tree_from_numpy(jax.tree.map(np.asarray, jparams))
    assert tparams["layers"][0]["a"].dtype == torch.bfloat16
    old = ref_cvar.get("coll_xla_bucket_bytes")
    try:
        ref_cvar.set("coll_xla_bucket_bytes", 64)
        cvar.set("coll_device_bucket_bytes", 64)
        for r in range(n):
            comm = SimpleNamespace(rank=r, size=n)
            ref = ref_zl.ShardedState.from_full(comm, jparams)
            got = compat.sharded_state_from_reference(
                ref.plan.buckets, ref.metas, [np.asarray(s)
                                              for s in ref.shards], r, n)
            own = zl.ShardedState.from_full(comm, tparams)
            assert got.plan.buckets == own.plan.buckets == ref.plan.buckets
            assert got.plan.padded == own.plan.padded == ref.plan.padded
            assert got.metas == own.metas
            for a, b in zip(got.shards, own.shards):
                assert a.dtype == b.dtype and torch.equal(a, b)
    finally:
        ref_cvar.set("coll_xla_bucket_bytes", old)
        cvar.set("coll_device_bucket_bytes", 4 << 20)


def test_tree_numpy_round_trip_keeps_bfloat16_bits():
    import ml_dtypes

    tree = {"b": np.arange(5, dtype=np.float32).astype(ml_dtypes.bfloat16),
            "a": [np.arange(3, dtype=np.int32), (np.ones(2, np.float32),)]}
    t = compat.tree_from_numpy(tree)
    assert t["b"].dtype == torch.bfloat16 and t["a"][0].dtype == torch.int32
    back = compat.tree_to_numpy(t)
    np.testing.assert_array_equal(back["b"], tree["b"].view(np.uint16))
    np.testing.assert_array_equal(back["a"][1][0], tree["a"][1][0])


def test_mca_maps_bucket_bytes():
    got = compat.mca_from_reference({"coll_xla_bucket_bytes": "64",
                                     "coll_xla_deterministic": "ring"})
    assert got == {"coll_device_bucket_bytes": "64",
                   "coll_device_deterministic": "ring"}
