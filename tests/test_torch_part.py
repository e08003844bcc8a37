"""The port's partitioned plane (part/: Psend_init / Precv_init,
Pallreduce_init, Preduce_scatter_init, GradientSync, ZeroGradientSync),
the persistent zero/ inits and ZeroOptimizer(overlap=True) against the
JAX package.

One job per package on 3 ranks: the reference through
``tests.harness.run_ranks`` under ``device_plane on`` with
``coll_xla_bucket_bytes`` 2048 (several buckets from small leaves), the
port through ``ompi_tpu_torch.runtime.launcher`` with the same settings
mapped by ``compat.mca_from_reference`` plus ``device_plane_platform
cpu``. Both make the same seeded numpy inputs and run the cases of
``tests/test_part.py`` (bar the pipeline handoff, which waits for
``models/``), ``tests/test_part_coll.py`` and ``tests/test_zero.py``'s
persistent-init, partitioned reduce-scatter, ZeroGradientSync and
overlap-optimizer cases; each rank writes its results as ``.npy`` and
its counters and error classes as JSON.

Tolerances: every result of 'linear' and 'ring' and every point-to-point
payload bitwise (compared as unsigned views); the default mode ('',
psum on the reference's side, the ring on the port's) within rtol 1e-5.
Counters as the reference's own assertions, with the reference's
``coll_xla_launches`` read as ``coll_device_launches``; in place of its
compile-cache misses, no arena is mapped after init. Error classes
equal, except that ``start_all`` of a non-startable entry raises
TypeError in the reference and ``MPIError(ERR_REQUEST)`` in the port.
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

N = 3
REF_MCA = {"device_plane": "on", "coll_xla_bucket_bytes": "2048"}
PORT_MCA = dict(compat.mca_from_reference(REF_MCA),
                device_plane_platform="cpu")
#: the partitioned collectives' modes: (name, deterministic)
MODES = [("linear", "linear"), ("ring", "ring"), ("default", None)]

#: shared verbatim by both rank programs (numpy inputs from a seed)
_INPUTS = """
def coll_inputs(rank):
    rng = np.random.default_rng(11)
    shapes = [(57,), (8, 9), (3,), (130,)]
    vals = []
    for s in shapes:
        v = (rng.standard_normal(s)
             * 10.0 ** rng.integers(-3, 4, s)).astype(np.float32)
        vals.append(np.roll(v, rank))
    return vals

def rs_inputs(rank):
    return [np.arange(512, dtype=np.float32) * (rank + 1) / 3,
            np.linspace(-1, 1, 600).astype(np.float32) * (rank + 2),
            np.arange(100, dtype=np.int32) * rank]

def record(out, name, value):
    out[name] = value
"""

_REF_BODY = """
import json, time
import jax, jax.numpy as jnp
from ompi_tpu import errors
from ompi_tpu.core import progress, pvar
from ompi_tpu.part import GradientSync, ZeroGradientSync
from ompi_tpu.zero import ZeroOptimizer
{inputs}
out = {{}}
J = jnp.asarray

def save(name, a):
    np.save(f"{out_dir}/ref_{{name}}_r{{rank}}.npy", np.asarray(a))

def eclass(fn):
    try:
        fn()
    except errors.MPIError as e:
        return int(e.error_class)
    except TypeError:
        return "TypeError"
    return None

# -- tests/test_part.py ----------------------------------------------------
n_part, k = 8, 1024
if rank == 0:
    buf = np.arange(n_part * k, dtype=np.float32)
    req = comm.Psend_init(buf, n_part, dest=1, tag=3)
    req.start()
    for i in (3, 0, 7, 1, 2, 6, 4, 5):
        req.Pready(i)
    req.wait()
elif rank == 1:
    buf = np.zeros(n_part * k, np.float32)
    req = comm.Precv_init(buf, n_part, source=0, tag=3)
    req.start()
    req.wait()
    save("p2p_basic", buf)

n_part, k = 4, 512
if rank == 0:
    buf = np.arange(n_part * k, dtype=np.float32)
    req = comm.Psend_init(buf, n_part, dest=1, tag=0)
    req.start()
    for i in range(n_part):
        req.Pready(i)
        time.sleep(0.01)
    req.wait()
elif rank == 1:
    buf = np.zeros(n_part * k, np.float32)
    req = comm.Precv_init(buf, n_part, source=0, tag=0)
    req.start()
    done = []
    while len(done) < n_part:
        progress.progress()
        for i in range(n_part):
            if i not in done and req.Parrived(i):
                assert (buf[i * k:(i + 1) * k]
                        == np.arange(i * k, (i + 1) * k)).all()
                done.append(i)
    req.wait()
    record(out, "stream_arrived", sorted(done))
    save("p2p_stream", buf)

n_part, k = 2, 256
if rank in (0, 1):
    buf = np.zeros(n_part * k, np.float32)
    if rank == 0:
        req = comm.Psend_init(buf, n_part, dest=1, tag=5)
    else:
        req = comm.Precv_init(buf, n_part, source=0, tag=5)
    for round_ in range(3):
        if rank == 0:
            buf[:] = float(round_) + 0.5
            req.start()
            req.Pready_range(0, n_part - 1)
        else:
            req.start()
        req.wait()
        if rank == 1:
            save(f"p2p_epoch{{round_}}", buf)

buf = np.zeros(8, np.float32)
req = comm.Psend_init(buf, 4, dest=rank, tag=1)
rreq = comm.Precv_init(np.zeros(8, np.float32), 4, source=rank, tag=1)
errs = [eclass(lambda: req.Pready(0)), eclass(lambda: rreq.Parrived(0))]
req.start(); rreq.start()
req.Pready(2)
errs += [eclass(lambda: req.Pready(2)), eclass(req.start)]
assert req.active and rreq.active
req.Pready_list([0, 1, 3])
req.wait(); rreq.wait()
assert not req.active and rreq.Parrived(0)
record(out, "p2p_errors", errs)

n_part, k = 4, 64
if rank == 0:
    pbuf = np.arange(n_part * k, dtype=np.float32)
    sbuf = np.full(16, 7.0, np.float32)
    preq = comm.Psend_init(pbuf, n_part, dest=1, tag=2)
    sreq = comm.Send_init(sbuf, 1, tag=3)
    mpi.Startall([preq, sreq])
    preq.Pready_range(0, n_part - 2)
    record(out, "startall_errors", [
        eclass(lambda: mpi.start_all([sreq, preq])),
        eclass(lambda: mpi.start_all([sreq, object()]))])
    preq.Pready(n_part - 1)
    mpi.wait_all([preq, sreq])
elif rank == 1:
    pbuf = np.zeros(n_part * k, np.float32)
    rbuf = np.zeros(16, np.float32)
    preq = comm.Precv_init(pbuf, n_part, source=0, tag=2)
    rreq = comm.Recv_init(rbuf, 0, tag=3)
    mpi.Startall([preq, rreq])
    mpi.wait_all([preq, rreq])
    save("startall_p", pbuf)
    save("startall_r", rbuf)

# -- tests/test_part_coll.py -----------------------------------------------
vals = [J(v) for v in coll_inputs(rank)]
for mode, det in {modes!r}:
    preq = comm.Pallreduce_init(vals, deterministic=det)
    preq.start()
    for i in (2, 0, 3, 1):
        preq.Pready(i)
    preq.wait()
    for i, leaf in enumerate(preq.array):
        save(f"pall_{{mode}}_c0_{{i}}", leaf)
    fresh = [v * 2 for v in vals]
    preq.start()
    for i in (1, 3, 0, 2):
        preq.Pready(i, fresh[i])
    preq.wait()
    for i, leaf in enumerate(preq.array):
        save(f"pall_{{mode}}_c1_{{i}}", leaf)
    for i, leaf in enumerate(comm.Allreduce_multi(fresh, deterministic=det)):
        save(f"arm_{{mode}}_{{i}}", leaf)

bufs = [jnp.full((300,), float(rank + i), jnp.float32) for i in range(4)]
preq = comm.Pallreduce_init(bufs, deterministic="linear")
s = pvar.session()
for cycle in range(3):
    preq.start()
    for i in (3, 1, 0, 2):
        preq.Pready(i)
    preq.wait()
assert s.read("coll_xla_cache_misses") == 0
record(out, "cycles", {{"launches": s.read("coll_xla_launches"),
                       "flushes": s.read("part_bucket_flushes")}})
save("cycles", preq.array[0])

bufs = [jnp.full((300,), float(rank + i), jnp.float32) for i in range(4)]
preq = comm.Pallreduce_init(bufs)
s = pvar.session()
preq.start()
for i in (0, 1):
    preq.Pready(i)
mid = [s.read("part_bucket_flushes"), s.read("coll_xla_launches"),
       s.read("part_overlap_flushes")]
for i in (2, 3):
    preq.Pready(i)
preq.wait()
record(out, "flush_order", mid + [s.read("part_bucket_flushes"),
                                  s.read("part_overlap_flushes")])

bufs = [jnp.ones((17,), jnp.float32), jnp.ones((9,), jnp.float32)]
preq = comm.Pallreduce_init(bufs)
errs = [eclass(lambda: preq.Pready(0))]
preq.start()
preq.Pready(0)
errs += [eclass(lambda: preq.Pready(0)), eclass(preq.wait),
         eclass(lambda: mpi.start_all([preq])),
         eclass(lambda: preq.Pready(1, jnp.ones((10,), jnp.float32)))]
preq.Pready(1)
preq.wait()
assert not preq.active
record(out, "pall_errors", errs)
save("pall_errors", preq.array[0])

bufs = [jnp.full((32,), float(rank + 1), jnp.float32),
        jnp.arange(16, dtype=jnp.float32)]
pers = comm.Allreduce_init(jnp.ones((8,), jnp.float32))
part = comm.Pallreduce_init(bufs)
mpi.Startall([pers, part])
part.Pready_list([1, 0])
mpi.wait_all([pers, part])
save("mixed_pers", pers.array)
save("mixed_part0", part.array[0])
save("mixed_part1", part.array[1])

template = {{"embed": jnp.zeros((300,), jnp.float32),
            "layers": [{{"w": jnp.zeros((300,), jnp.float32)}}
                       for _ in range(3)]}}
sync = GradientSync(comm, template, deterministic="linear")
paths = [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(template)[0]]
record(out, "keys", paths)
for step in range(2):
    sync.start()
    for key in reversed(paths):
        i = sync.index_of(key)
        sync.push(key, jnp.full((300,), float(rank + i + step), jnp.float32))
    synced = sync.finish()
for i, leaf in enumerate(jax.tree.leaves(synced)):
    save(f"gsync_{{i}}", leaf)

selfc = mpi.COMM_SELF
preq = selfc.Pallreduce_init([jnp.arange(4, dtype=jnp.float32)])
preq.start()
errs = [eclass(preq.wait)]
preq.Pready(0)
preq.wait()
save("self_pall", preq.array[0])
empty = comm.Pallreduce_init([])
empty.start()
empty.wait()
record(out, "trivial", errs + [empty.array == []])

# -- tests/test_zero.py: the persistent inits, the partitioned RS, the
# ZeroGradientSync wrapper and the overlapped optimizer ---------------------
bufs = [jnp.arange(96, dtype=jnp.float32) * (rank + 1),
        jnp.ones((40,), jnp.float32) * rank]
rs_req = comm.Reduce_scatter_multi_init(bufs, deterministic="linear")
rs_req.start()
rs_req.wait()
for b, sh in enumerate(rs_req.array.shards):
    save(f"pinit_rs_{{b}}", sh)
ag_req = comm.Allgather_multi_init(rs_req.array)
ag_req.start()
ag_req.wait()
for i, leaf in enumerate(ag_req.array):
    save(f"pinit_ag_{{i}}", leaf)
rs_req.free()
ag_req.free()

bufs = [J(b) for b in rs_inputs(rank)]
for mode, det in {modes!r}:
    req = comm.Preduce_scatter_init(bufs, deterministic=det)
    s = pvar.session()
    req.start()
    for i in (2, 0, 1):
        req.Pready(i, bufs[i])
    req.wait()
    record(out, f"prs_{{mode}}_overlap", s.read("zero_overlap_flushes"))
    for b, sh in enumerate(req.array.shards):
        save(f"prs_{{mode}}_c0_{{b}}", sh)
    fresh = [b * 2 for b in bufs]
    req.start()
    for i in (1, 2, 0):
        req.Pready(i, fresh[i])
    req.wait()
    for b, sh in enumerate(req.array.shards):
        save(f"prs_{{mode}}_c1_{{b}}", sh)
    req.free()

grads = {{"w": jnp.ones((64, 8), jnp.float32) * (rank + 1),
         "b": jnp.arange(16, dtype=jnp.float32) * (rank - 1)}}
zsync = ZeroGradientSync(comm, grads, deterministic="linear")
zpaths = [jax.tree_util.keystr(p) for p, _ in
          jax.tree_util.tree_flatten_with_path(grads)[0]]
zsync.start()
for key in reversed(zpaths):
    zsync.push(key)
for b, sh in enumerate(zsync.finish().shards):
    save(f"zsync_{{b}}", sh)

params = {{"w": jnp.ones((64,), jnp.float32) * 0.5,
          "b": J(np.linspace(-1, 1, 30).astype(np.float32))}}
g = {{"w": jnp.full((64,), 2.0 + rank, jnp.float32),
     "b": jnp.full((30,), 0.25 * rank, jnp.float32)}}
ov = ZeroOptimizer(comm, params, lr=0.5, momentum=0.9, overlap=True,
                   deterministic="linear")
for step in range(2):
    p = ov.step(g)
ov.free()
for i, leaf in enumerate(jax.tree.leaves(p)):
    save(f"ovopt_{{i}}", leaf)
record(out, "ovopt_errors", [
    eclass(lambda: ZeroOptimizer(comm, params, stage=3)),
    eclass(lambda: ZeroOptimizer(comm, params, stage=1, overlap=True)),
    eclass(lambda: ZeroOptimizer(comm, params, overlap=True, fused=True))])

with open(f"{out_dir}/ref_r{{rank}}.json", "w") as fh:
    json.dump(out, fh)
"""

_PORT_PROG = """
import json, time
import numpy as np
import torch
from ompi_tpu_torch import compat, errors, mpi
from ompi_tpu_torch.core import progress, pvar
from ompi_tpu_torch.part import GradientSync, ZeroGradientSync
from ompi_tpu_torch.zero import ZeroOptimizer, layout as zl
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}
{inputs}
out = {{}}
T = compat.tensor_from_numpy

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

# -- tests/test_part.py ----------------------------------------------------
n_part, k = 8, 1024
if rank == 0:
    buf = np.arange(n_part * k, dtype=np.float32)
    req = comm.Psend_init(buf, n_part, dest=1, tag=3)
    req.start()
    for i in (3, 0, 7, 1, 2, 6, 4, 5):
        req.Pready(i)
    req.wait()
elif rank == 1:
    buf = np.zeros(n_part * k, np.float32)
    req = comm.Precv_init(buf, n_part, source=0, tag=3)
    req.start()
    req.wait()
    save("p2p_basic", buf)

n_part, k = 4, 512
if rank == 0:
    buf = np.arange(n_part * k, dtype=np.float32)
    req = comm.Psend_init(buf, n_part, dest=1, tag=0)
    req.start()
    for i in range(n_part):
        req.Pready(i)
        time.sleep(0.01)
    req.wait()
elif rank == 1:
    buf = np.zeros(n_part * k, np.float32)
    req = comm.Precv_init(buf, n_part, source=0, tag=0)
    req.start()
    done = []
    while len(done) < n_part:
        progress.progress()
        for i in range(n_part):
            if i not in done and req.Parrived(i):
                assert (buf[i * k:(i + 1) * k]
                        == np.arange(i * k, (i + 1) * k)).all()
                done.append(i)
    req.wait()
    record(out, "stream_arrived", sorted(done))
    save("p2p_stream", buf)

n_part, k = 2, 256
if rank in (0, 1):
    buf = np.zeros(n_part * k, np.float32)
    if rank == 0:
        req = comm.Psend_init(buf, n_part, dest=1, tag=5)
    else:
        req = comm.Precv_init(buf, n_part, source=0, tag=5)
    for round_ in range(3):
        if rank == 0:
            buf[:] = float(round_) + 0.5
            req.start()
            req.Pready_range(0, n_part - 1)
        else:
            req.start()
        req.wait()
        if rank == 1:
            save(f"p2p_epoch{{round_}}", buf)

buf = np.zeros(8, np.float32)
req = comm.Psend_init(buf, 4, dest=rank, tag=1)
rreq = comm.Precv_init(np.zeros(8, np.float32), 4, source=rank, tag=1)
errs = [eclass(lambda: req.Pready(0)), eclass(lambda: rreq.Parrived(0))]
req.start(); rreq.start()
req.Pready(2)
errs += [eclass(lambda: req.Pready(2)), eclass(req.start)]
assert req.active and rreq.active
req.Pready_list([0, 1, 3])
req.wait(); rreq.wait()
assert not req.active and rreq.Parrived(0)
record(out, "p2p_errors", errs)
# the port's own refusals: a tensor buffer, an index out of range
record(out, "p2p_port_errors", [
    eclass(lambda: comm.Psend_init(torch.zeros(8), 4, dest=rank)),
    eclass(lambda: comm.Precv_init(np.zeros((4, 4))[:, 0], 2, source=0)),
    eclass(lambda: (req.start(), req.Pready(4)))])

n_part, k = 4, 64
if rank == 0:
    pbuf = np.arange(n_part * k, dtype=np.float32)
    sbuf = np.full(16, 7.0, np.float32)
    preq = comm.Psend_init(pbuf, n_part, dest=1, tag=2)
    sreq = comm.Send_init(sbuf, 1, tag=3)
    mpi.Startall([preq, sreq])
    preq.Pready_range(0, n_part - 2)
    record(out, "startall_errors", [
        eclass(lambda: mpi.start_all([sreq, preq])),
        eclass(lambda: mpi.start_all([sreq, object()]))])
    preq.Pready(n_part - 1)
    mpi.wait_all([preq, sreq])
elif rank == 1:
    pbuf = np.zeros(n_part * k, np.float32)
    rbuf = np.zeros(16, np.float32)
    preq = comm.Precv_init(pbuf, n_part, source=0, tag=2)
    rreq = comm.Recv_init(rbuf, 0, tag=3)
    mpi.Startall([preq, rreq])
    mpi.wait_all([preq, rreq])
    save("startall_p", pbuf)
    save("startall_r", rbuf)

# -- tests/test_part_coll.py -----------------------------------------------
vals = [T(v) for v in coll_inputs(rank)]
for mode, det in {modes!r}:
    preq = comm.Pallreduce_init(vals, deterministic=det)
    preq.start()
    for i in (2, 0, 3, 1):
        preq.Pready(i)
    preq.wait()
    for i, leaf in enumerate(preq.array):
        save(f"pall_{{mode}}_c0_{{i}}", leaf)
    fresh = [v * 2 for v in vals]
    preq.start()
    for i in (1, 3, 0, 2):
        preq.Pready(i, fresh[i])
    preq.wait()
    for i, leaf in enumerate(preq.array):
        save(f"pall_{{mode}}_c1_{{i}}", leaf)
    for i, leaf in enumerate(comm.Allreduce_multi(fresh, deterministic=det)):
        save(f"arm_{{mode}}_{{i}}", leaf)

bufs = [torch.full((300,), float(rank + i)) for i in range(4)]
preq = comm.Pallreduce_init(bufs, deterministic="linear")
s = pvar.session()
for cycle in range(3):
    preq.start()
    for i in (3, 1, 0, 2):
        preq.Pready(i)
    preq.wait()
assert s.read("device_plane_arenas") == 0, "an arena mapped after init"
record(out, "cycles", {{"launches": s.read("coll_device_launches"),
                       "flushes": s.read("part_bucket_flushes")}})
save("cycles", preq.array[0])

bufs = [torch.full((300,), float(rank + i)) for i in range(4)]
preq = comm.Pallreduce_init(bufs)
s = pvar.session()
preq.start()
for i in (0, 1):
    preq.Pready(i)
mid = [s.read("part_bucket_flushes"), s.read("coll_device_launches"),
       s.read("part_overlap_flushes")]
for i in (2, 3):
    preq.Pready(i)
preq.wait()
record(out, "flush_order", mid + [s.read("part_bucket_flushes"),
                                  s.read("part_overlap_flushes")])

bufs = [torch.ones(17), torch.ones(9)]
preq = comm.Pallreduce_init(bufs)
errs = [eclass(lambda: preq.Pready(0))]
preq.start()
preq.Pready(0)
errs += [eclass(lambda: preq.Pready(0)), eclass(preq.wait),
         eclass(lambda: mpi.start_all([preq])),
         eclass(lambda: preq.Pready(1, torch.ones(10)))]
record(out, "pall_port_errors", [
    eclass(lambda: preq.Pready(1, torch.ones(9, dtype=torch.int32))),
    eclass(lambda: preq.Pready(1, np.ones(9, np.float32))),
    eclass(lambda: preq.Pready(2)),
    eclass(lambda: comm.Pallreduce_init([np.ones(3, np.float32)]))])
preq.Pready(1)
preq.wait()
assert not preq.active
record(out, "pall_errors", errs)
save("pall_errors", preq.array[0])

bufs = [torch.full((32,), float(rank + 1)), torch.arange(16.)]
pers = comm.Allreduce_init(torch.ones(8))
part = comm.Pallreduce_init(bufs)
mpi.Startall([pers, part])
part.Pready_list([1, 0])
mpi.wait_all([pers, part])
save("mixed_pers", pers.array)
save("mixed_part0", part.array[0])
save("mixed_part1", part.array[1])

template = {{"embed": torch.zeros(300),
            "layers": [{{"w": torch.zeros(300)}} for _ in range(3)]}}
sync = GradientSync(comm, template, deterministic="linear")
paths = [zl.keystr(p) for p, _ in zl.tree_flatten_with_path(template)]
record(out, "keys", paths)
for step in range(2):
    sync.start()
    for key in reversed(paths):
        i = sync.index_of(key)
        sync.push(key, torch.full((300,), float(rank + i + step)))
    synced = sync.finish()
for i, leaf in enumerate(zl.tree_leaves(synced)):
    save(f"gsync_{{i}}", leaf)

selfc = mpi.COMM_SELF
preq = selfc.Pallreduce_init([torch.arange(4.)])
preq.start()
errs = [eclass(preq.wait)]
preq.Pready(0)
preq.wait()
save("self_pall", preq.array[0])
empty = comm.Pallreduce_init([])
empty.start()
empty.wait()
record(out, "trivial", errs + [empty.array == []])

# -- tests/test_zero.py ----------------------------------------------------
bufs = [torch.arange(96.) * (rank + 1), torch.ones(40) * rank]
rs_req = comm.Reduce_scatter_multi_init(bufs, deterministic="linear")
rs_req.start()
rs_req.wait()
for b, sh in enumerate(rs_req.array.shards):
    save(f"pinit_rs_{{b}}", sh)
ag_req = comm.Allgather_multi_init(rs_req.array)
ag_req.start()
ag_req.wait()
for i, leaf in enumerate(ag_req.array):
    save(f"pinit_ag_{{i}}", leaf)
rs_req.free()
ag_req.free()

bufs = [T(b) for b in rs_inputs(rank)]
for mode, det in {modes!r}:
    req = comm.Preduce_scatter_init(bufs, deterministic=det)
    s = pvar.session()
    req.start()
    for i in (2, 0, 1):
        req.Pready(i, bufs[i])
    req.wait()
    record(out, f"prs_{{mode}}_overlap", s.read("zero_overlap_flushes"))
    for b, sh in enumerate(req.array.shards):
        save(f"prs_{{mode}}_c0_{{b}}", sh)
    fresh = [b * 2 for b in bufs]
    req.start()
    for i in (1, 2, 0):
        req.Pready(i, fresh[i])
    req.wait()
    for b, sh in enumerate(req.array.shards):
        save(f"prs_{{mode}}_c1_{{b}}", sh)
    ref = comm.Reduce_scatter_multi(fresh, deterministic=det)
    assert all(torch.equal(a, b) for a, b in zip(ref.shards,
                                                 req.array.shards)), mode
    req.free()
    assert eclass(req.start) == errors.ERR_REQUEST

grads = {{"w": torch.ones(64, 8) * (rank + 1),
         "b": torch.arange(16.) * (rank - 1)}}
zsync = ZeroGradientSync(comm, grads, deterministic="linear")
zpaths = [zl.keystr(p) for p, _ in zl.tree_flatten_with_path(grads)]
zsync.start()
for key in reversed(zpaths):
    zsync.push(key)
for b, sh in enumerate(zsync.finish().shards):
    save(f"zsync_{{b}}", sh)

params = {{"w": torch.ones(64) * 0.5,
          "b": T(np.linspace(-1, 1, 30).astype(np.float32))}}
g = {{"w": torch.full((64,), 2.0 + rank), "b": torch.full((30,), 0.25 * rank)}}
ov = ZeroOptimizer(comm, params, lr=0.5, momentum=0.9, overlap=True,
                   deterministic="linear")
for step in range(2):
    p = ov.step(g)
ov.free()
for i, leaf in enumerate(zl.tree_leaves(p)):
    save(f"ovopt_{{i}}", leaf)
record(out, "ovopt_errors", [
    eclass(lambda: ZeroOptimizer(comm, params, stage=3)),
    eclass(lambda: ZeroOptimizer(comm, params, stage=1, overlap=True)),
    eclass(lambda: ZeroOptimizer(comm, params, overlap=True, fused=True))])

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


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Run both packages' jobs once; returns the output directory."""
    out = tmp_path_factory.mktemp("part")
    fmt = dict(inputs=_INPUTS, modes=MODES, out_dir=str(out))
    run_ranks("out_dir = " + repr(str(out)) + "\n"
              + _REF_BODY.format(**fmt), N, mca=REF_MCA, timeout=300)
    rc = _port_job(_PORT_PROG.format(**fmt), N, PORT_MCA)
    assert rc == 0, f"port job exited {rc}"
    return out


def _json(out, who, r):
    return json.loads((out / f"{who}_r{r}.json").read_text())


def _pair(out, name, r):
    return (np.load(out / f"ref_{name}_r{r}.npy"),
            np.load(out / f"port_{name}_r{r}.npy"))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _same_bits(out, name, ranks=range(N)):
    for r in ranks:
        ref, got = _pair(out, name, r)
        assert ref.shape == got.shape and ref.dtype == got.dtype, name
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=name)


def _count(out, prefix):
    return len([p for p in os.listdir(out)
                if p.startswith(f"ref_{prefix}") and p.endswith("_r0.npy")])


# -- tests/test_part.py ------------------------------------------------------

def test_partitioned_basic(results):
    """Eight partitions marked ready out of order land whole."""
    _same_bits(results, "p2p_basic", [1])
    np.testing.assert_array_equal(
        np.load(results / "port_p2p_basic_r1.npy"),
        np.arange(8 * 1024, dtype=np.float32))


def test_partitioned_parrived_streaming(results):
    """Parrived sees each partition complete (checked on arrival)."""
    _same_bits(results, "p2p_stream", [1])
    assert _json(results, "port", 1)["stream_arrived"] == [0, 1, 2, 3]


def test_partitioned_restart_epochs(results):
    """Three epochs on one request pair, each read at Pready time."""
    for e in range(3):
        _same_bits(results, f"p2p_epoch{e}", [1])


def test_partitioned_pready_errors(results):
    """Pready before start, Parrived never started, double Pready and
    restart of an active epoch raise the reference's classes; a tensor
    buffer raises ERR_BUFFER, as does a non-contiguous one, and an
    index out of range ERR_ARG (the port's own checks)."""
    from ompi_tpu_torch import errors

    for r in range(N):
        ref = _json(results, "ref", r)["p2p_errors"]
        assert _json(results, "port", r)["p2p_errors"] == ref == [
            errors.ERR_REQUEST, errors.ERR_REQUEST, errors.ERR_ARG,
            errors.ERR_REQUEST]
        assert _json(results, "port", r)["p2p_port_errors"] == [
            errors.ERR_BUFFER, errors.ERR_BUFFER, errors.ERR_ARG]


def test_startall_mixed_and_active_error(results):
    """One Startall over Psend_init and Send_init; an active entry
    raises ERR_REQUEST before anything starts; a non-startable one
    raises TypeError in the reference, ERR_REQUEST in the port."""
    from ompi_tpu_torch import errors

    _same_bits(results, "startall_p", [1])
    _same_bits(results, "startall_r", [1])
    assert _json(results, "ref", 0)["startall_errors"] == [
        errors.ERR_REQUEST, "TypeError"]
    assert _json(results, "port", 0)["startall_errors"] == [
        errors.ERR_REQUEST, errors.ERR_REQUEST]


# -- tests/test_part_coll.py -------------------------------------------------

@pytest.mark.parametrize("mode", [m for m, _ in MODES])
def test_pallreduce_against_reference(results, mode):
    """Pallreduce with leaves Pready'd out of order, then fresh values:
    bitwise the reference's under 'linear' and 'ring' (rtol 1e-5 under
    the default mode), and bitwise the port's own Allreduce_multi."""
    for c in ("c0", "c1"):
        for i in range(4):
            name = f"pall_{mode}_{c}_{i}"
            if mode != "default":
                _same_bits(results, name)
                continue
            for r in range(N):
                ref, got = _pair(results, name, r)
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for i in range(4):
        for r in range(N):
            a = np.load(results / f"port_arm_{mode}_{i}_r{r}.npy")
            b = np.load(results / f"port_pall_{mode}_c1_{i}_r{r}.npy")
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_pallreduce_launch_once_per_bucket(results):
    """Three cycles over two buckets: one launch and one flush per
    bucket and cycle, and no arena mapped after init."""
    for r in range(N):
        want = {"launches": 6, "flushes": 6}
        assert _json(results, "ref", r)["cycles"] == want
        assert _json(results, "port", r)["cycles"] == want
    _same_bits(results, "cycles")


def test_pallreduce_flush_before_final_pready(results):
    """Filling the first bucket flushes it mid-cycle (one overlapped
    flush); the last bucket's flush is not overlapped."""
    for r in range(N):
        assert _json(results, "port", r)["flush_order"] == \
            _json(results, "ref", r)["flush_order"] == [1, 1, 1, 2, 1]


def test_pallreduce_semantics_errors(results):
    """Pready inactive, double Pready, unready wait, active restart via
    start_all, a value of another shape: the reference's classes. The
    port also refuses another dtype and a numpy value (ERR_ARG), an
    index out of range (ERR_ARG) and numpy leaves at init (ERR_BUFFER)."""
    from ompi_tpu_torch import errors

    for r in range(N):
        ref = _json(results, "ref", r)["pall_errors"]
        assert _json(results, "port", r)["pall_errors"] == ref == [
            errors.ERR_REQUEST, errors.ERR_ARG, errors.ERR_REQUEST,
            errors.ERR_REQUEST, errors.ERR_ARG]
        assert _json(results, "port", r)["pall_port_errors"] == [
            errors.ERR_ARG, errors.ERR_ARG, errors.ERR_ARG,
            errors.ERR_BUFFER]
    _same_bits(results, "pall_errors")


def test_startall_mixed_device_partitioned(results):
    """One Startall over Allreduce_init and Pallreduce_init."""
    for name in ("mixed_pers", "mixed_part0", "mixed_part1"):
        _same_bits(results, name)


def test_gradient_sync_overlap_wrapper(results):
    """GradientSync pushed by keystr in reverse order with fresh values:
    the same key strings as jax's, the reference's result bitwise."""
    assert _json(results, "port", 0)["keys"] == _json(results, "ref",
                                                       0)["keys"]
    for i in range(4):
        _same_bits(results, f"gsync_{i}")


def test_pallreduce_size1_and_empty_trivial(results):
    """COMM_SELF and an empty pytree keep the partitioned semantics."""
    for r in range(N):
        assert _json(results, "port", r)["trivial"] == \
            _json(results, "ref", r)["trivial"]
    _same_bits(results, "self_pall")


# -- tests/test_zero.py ------------------------------------------------------

def test_persistent_inits_cycle(results):
    """Reduce_scatter_multi_init then Allgather_multi_init of its state."""
    for prefix in ("pinit_rs_", "pinit_ag_"):
        assert _count(results, prefix)
        for i in range(_count(results, prefix)):
            _same_bits(results, f"{prefix}{i}")


@pytest.mark.parametrize("mode", [m for m, _ in MODES])
def test_preduce_scatter_overlap_and_bit_identity(results, mode):
    """Preduce_scatter with an int32 leaf, out of order, fresh values in
    the second cycle: the reference's shards (bitwise under 'linear' and
    'ring', rtol 1e-5 under the default), and its overlap flushes."""
    for r in range(N):
        ref = _json(results, "ref", r)[f"prs_{mode}_overlap"]
        assert _json(results, "port", r)[f"prs_{mode}_overlap"] == ref >= 1
    for c in ("c0", "c1"):
        for b in range(_count(results, f"prs_{mode}_{c}_")):
            name = f"prs_{mode}_{c}_{b}"
            for r in range(N):
                ref, got = _pair(results, name, r)
                if mode != "default" or ref.dtype == np.int32:
                    np.testing.assert_array_equal(_bits(got), _bits(ref))
                else:
                    np.testing.assert_allclose(got, ref, rtol=1e-5,
                                               atol=1e-6)


def test_zero_gradient_sync_wrapper(results):
    """ZeroGradientSync pushed by keystr: the reference's shards."""
    assert _count(results, "zsync_")
    for b in range(_count(results, "zsync_")):
        _same_bits(results, f"zsync_{b}")


def test_optimizer_overlap_and_arg_validation(results):
    """ZeroOptimizer(overlap=True, momentum) two steps: the reference's
    parameters bitwise; stage 3, stage 1 + overlap and overlap + fused
    raise ERR_ARG."""
    from ompi_tpu_torch import errors

    for i in range(2):
        _same_bits(results, f"ovopt_{i}")
    for r in range(N):
        assert _json(results, "port", r)["ovopt_errors"] == \
            _json(results, "ref", r)["ovopt_errors"] == [errors.ERR_ARG] * 3
