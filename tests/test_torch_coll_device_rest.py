"""The rest of coll/device's slot table against the JAX package's coll/xla:
Reduce, Gather, Scatter, the v-collectives, Alltoallv, Reduce_scatter,
Scan / Exscan, Allreduce_multi, the device barrier, the nonblocking and
persistent forms.

One job pair on 3 ranks with ``coll_xla_rooted_threshold_bytes 0`` (the
rooted schedules at every size; odd lengths, so the ring's zero pad
shows) and one on 4 ranks at the default threshold (the orders 3 ranks
cannot tell apart; cases on both sides of the 1 MiB switch): the
reference runs through ``tests.harness.run_ranks`` with ``--mca
device_plane on``, the port through its launcher with the same settings
mapped by ``compat.mca_from_reference`` plus ``device_plane_platform
cpu``. Both make the same inputs from a seed with numpy, call the MPI
API and write every result as a ``.npy`` file (a ``.none`` file where a
rooted call returns None).

- bitwise: ``'linear'`` and ``'ring'``, the copies, the binomial tree and
  the prefixes (NaN payloads aside);
- within ``DEFAULT_RTOL`` of the operands' magnitudes: SUM under ``''``
  (the reference's psum / psum_scatter against the port's ring);
- the port's nonblocking results equal the reference's blocking ones,
  its persistent cycles the reference's blocking calls on the contents
  the buffer held at each start;
- the erroneous calls raise the same class on every rank of both
  packages (ERR_COUNT, ERR_REQUEST; ERR_ARG on the root alone for a
  changed scatter signature); ERR_ROOT is the port's own (the reference
  indexes with a bad root);
- a non-root never allocates the n-fold result (``_last_rooted_plan``),
  and the binomial takes the reference's rounds.

Plus the singleton (a one-rank world, no device plane) in a subprocess
of each package, and the request classes in one process.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from ompi_tpu_torch import compat, errors
from ompi_tpu_torch.coll import device as D
from ompi_tpu_torch.pml import request as rq
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_coll_device import DEFAULT_RTOL, assert_bits_equal

#: (case name, kind, dtype, op, argument): the argument is the root, the
#: mode, or both, per kind (see _CALLS)
CASES = [
    # Reduce: (root, mode); '' takes the rooted schedules at threshold 0
    ("red_f32_sum_linear", "red", "float32", "SUM", (1, "linear")),
    ("red_f32_sum_ring", "red", "float32", "SUM", (2, "ring")),
    ("red_f32_sum_default", "red", "float32", "SUM", (0, "")),
    ("red_f16_sum_default", "red", "float16", "SUM", (1, "")),
    ("red_bf16_max_default", "red", "bfloat16", "MAX", (2, "")),
    ("red_i32_prod_default", "red", "int32", "PROD", (0, "")),
    ("red_f32_min_default", "red", "float32", "MIN", (1, "")),
    ("red_u8_bxor_default", "red", "uint8", "BXOR", (2, "")),
    ("red_bool_land_default", "red", "bool", "LAND", (0, "")),
    # Gather, Scatter (root, like), Scatterv (root, like), Gatherv (root)
    ("gat_f32", "gat", "float32", None, 0),
    ("gat_bf16", "gat", "bfloat16", None, 2),
    ("gat_bool", "gat", "bool", None, 1),
    ("sca_f32", "sca", "float32", None, (0, False)),
    ("sca_i32_like", "sca", "int32", None, (2, True)),
    ("sca_bf16", "sca", "bfloat16", None, (1, True)),
    ("scv_f32", "scv", "float32", None, (0, False)),
    ("scv_u8_like", "scv", "uint8", None, (2, True)),
    ("agv_i32", "agv", "int32", None, None),
    ("agv_f16", "agv", "float16", None, None),
    ("gav_f32", "gav", "float32", None, 1),
    ("gav_bool", "gav", "bool", None, 0),
    # Alltoallv: max_count, or None (the count round)
    ("a2v_i32_cap", "a2v", "int32", None, "cap"),
    ("a2v_i32", "a2v", "int32", None, None),
    ("a2v_bf16", "a2v", "bfloat16", None, None),
    # Reduce_scatter: mode
    ("rsv_f32_sum_linear", "rsv", "float32", "SUM", "linear"),
    ("rsv_f32_sum_ring", "rsv", "float32", "SUM", "ring"),
    ("rsv_f32_sum_default", "rsv", "float32", "SUM", ""),
    ("rsv_u8_bor_ring", "rsv", "uint8", "BOR", "ring"),
    # Scan / Exscan
    ("scan_f32_sum", "scan", "float32", "SUM", None),
    ("scan_bf16_sum", "scan", "bfloat16", "SUM", None),
    ("scan_i32_max", "scan", "int32", "MAX", None),
    ("scan_bool_lor", "scan", "bool", "LOR", None),
    ("scan_f16_prod", "scan", "float16", "PROD", None),
    ("exscan_f32_sum", "exscan", "float32", "SUM", None),
    ("exscan_i32_min", "exscan", "int32", "MIN", None),
    ("exscan_u8_bxor", "exscan", "uint8", "BXOR", None),
    # Allreduce_multi over a mixed pytree: mode
    ("arm_linear", "arm", None, "SUM", "linear"),
    ("arm_ring", "arm", None, "SUM", "ring"),
    ("arm_default", "arm", None, "SUM", ""),
]

#: the 4-rank job: every case (the orders 3 ranks cannot tell apart) at
#: the default threshold, and cases past its 1 MiB of result (_big)
CASES4 = CASES + [
    ("red_f32_sum_default_big", "red", "float32", "SUM", (3, "")),
    ("red_bf16_max_default_big", "red", "bfloat16", "MAX", (1, "")),
    ("gat_f32_big", "gat", "float32", None, 2),
]

#: the nonblocking and persistent cases run by the port only, compared
#: with the reference's blocking calls
ICASES = ("red_bf16_max_default", "gat_f32",
          "sca_f32", "scv_f32", "agv_i32", "gav_f32", "a2v_i32_cap",
          "rsv_f32_sum_ring", "scan_f32_sum", "exscan_i32_min")

#: shared verbatim by both rank programs and the test
_INPUTS = """
def is_default_sum(kind, op, arg):
    mode = arg[1] if kind == "red" else arg
    return op == "SUM" and kind in ("red", "rsv", "arm") and mode == ""

def traps_for(name, kind, op, arg, size):
    # NaN and -0 only where both packages fix the operand order: not a SUM
    # under '', nor another op's '' allreduce (XLA's pmin / pmax), which
    # Reduce runs below the rooted threshold (the 4-rank job's default)
    if is_default_sum(kind, op, arg):
        return False
    return not (kind == "red" and arg[1] == "" and size == 4
                and not name.endswith("_big"))

def make_input(name, kind, dtype, rank, size, traps=True):
    rng = np.random.default_rng(sum(map(ord, name)) * 1009 + 100 * size
                                + rank)
    if kind in ("agv", "gav"):
        shape = (v_counts(name, size)[0][rank], 3)
    elif kind == "scv":
        shape = (sum(v_counts(name, size)[0]), 3)
    elif kind == "a2v":
        shape = (sum(v_counts(name, size)[rank]), 3)
    elif name.endswith("_big"):  # 1 MiB of result on 4 ranks
        shape = ({"float32": 1 << 16, "bfloat16": 1 << 17}[dtype] + 3,)
    else:
        shape = {"sca": (3 * size, 5), "scan": (19,), "exscan": (19,),
                 "rsv": (4 * size - 1, 3)}.get(kind, (257,))
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, shape,
                            dtype=np.int64).astype(np.int32)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)
    if dtype == "bool":
        return rng.random(shape) < 0.6
    h = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-2, 3, shape)).astype(np.float32)
    if "prod" in name:  # near 1: a product of n stays finite
        h = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    flat = h.reshape(-1)
    if traps and flat.size > 11:
        flat[9] = -0.0 if rank % 2 else 0.0
        if rank == 1:
            flat[5] = np.nan
    return h.astype(np.float16) if dtype == "float16" else h

def v_counts(name, size):
    # row counts: a vector for the v-collectives, a size x size matrix
    # (row p: what rank p sends each rank) for Alltoallv, zeros included
    rng = np.random.default_rng(sum(map(ord, name)) + size)
    if name.startswith("a2v"):
        m = rng.integers(0, 6, (size, size))
        m[0, size - 1] = 0
        return [[int(c) for c in row] for row in m]
    c = [int(v) for v in rng.integers(0, 6, size)]
    c[size // 2] = 0
    c[0] = max(c[0], 1)
    return [c]

def make_tree(rank):
    rng = np.random.default_rng(77 + rank)
    f = lambda *s: (rng.standard_normal(s) * 10).astype(np.float32)
    return {"w": f(5, 7), "b": f(13),
            "k": [rng.integers(-2**31, 2**31 - 1, (3, 3),
                               dtype=np.int64).astype(np.int32), f(11)]}
"""

#: one rank program for both packages: ``T(a, dtype)`` makes a device
#: array of a numpy array, ``S(name, out)`` saves a result (None: a
#: ``.none`` flag), ``O`` is the op module
_CALLS = """
def run_case(name, kind, dtype, op, arg):
    o = getattr(O, op) if op else None
    if kind == "arm":
        tree = make_tree(rank)
        tree = {{"w": T(tree["w"], "float32"), "b": T(tree["b"], "bfloat16"),
                 "k": [T(tree["k"][0], "int32"),
                       T(tree["k"][1], "float32")]}}
        return comm.Allreduce_multi(tree, o, deterministic=arg)
    x = T(make_input(name, kind, dtype, rank, size,
                     traps=traps_for(name, kind, op, arg, size)), dtype)
    if kind == "red":
        return comm.Reduce(x, op=o, root=arg[0], deterministic=arg[1])
    if kind == "gat":
        return comm.Gather(x, root=arg)
    if kind == "sca":
        root, like = arg
        tmpl = T(np.zeros((3, 5), np.float32), dtype) if like else None
        return comm.Scatter(x if rank == root else None, tmpl, root=root,
                            device=True)
    if kind == "scv":
        root, like = arg
        counts = v_counts(name, size)[0]
        tmpl = T(np.zeros((counts[rank], 3), np.float32), dtype) \\
            if like else None
        return comm.Scatterv(x if rank == root else None, tmpl, counts,
                             root=root, device=True)
    if kind == "agv":
        return comm.Allgatherv(x, None, v_counts(name, size)[0])
    if kind == "gav":
        return comm.Gatherv(x, None, v_counts(name, size)[0], root=arg)
    if kind == "a2v":
        m = v_counts(name, size)
        sc, rc = m[rank], [m[p][rank] for p in range(size)]
        cap = max(max(row) for row in m) if arg == "cap" else None
        return comm.Alltoallv(x, None, sc, rc, max_count=cap)
    if kind == "rsv":
        counts = [3, 0] + [4] * (size - 2)
        counts[-1] += x.shape[0] - sum(counts)
        return comm.Reduce_scatter(x, None, counts, op=o,
                                   deterministic=arg)
    if kind == "scan":
        return comm.Scan(x, op=o)
    return comm.Exscan(x, op=o)

def save_tree(name, out):
    if isinstance(out, dict):
        for i, leaf in enumerate([out["b"], out["k"][0], out["k"][1],
                                  out["w"]]):
            S(f"{{name}}_{{i}}", leaf)
    else:
        S(name, out)

for case in {cases!r}:
    reset_plan()
    save_tree(case[0], run_case(*case))
    if case[1] in ("red", "gat"):
        plans[case[0]] = rooted_plan()

def error_class(fn):
    try:
        fn()
    except MPIError as e:
        return e.error_class
    raise AssertionError("no MPIError raised")

classes = {{}}
root_sig = 1 % size
classes["scatter_indivisible"] = error_class(lambda: comm.Scatter(
    T(np.zeros((size + 1, 2), np.float32), "float32")
    if rank == root_sig else None, None, root=root_sig, device=True))
classes["scatterv_counts"] = error_class(lambda: comm.Scatterv(
    T(np.zeros(4, np.float32), "float32") if rank == 0 else None, None,
    [1] * (size + 1), root=0, device=True))
classes["allgatherv_counts"] = error_class(lambda: comm.Allgatherv(
    T(np.zeros((1, 2), np.float32), "float32"), None, [1] * (size - 1)))
classes["reduce_scatter_sum"] = error_class(lambda: comm.Reduce_scatter(
    T(np.zeros((size, 2), np.float32), "float32"), None, [2] * size))
classes["alltoallv_max_count"] = error_class(lambda: comm.Alltoallv(
    T(np.zeros((size, 2), np.int32), "int32"), None, [1] * size,
    [1] * size, max_count=0))
def start_after_free():
    req = comm.Allreduce_init(T(np.ones(3, np.int32), "int32"))
    req.start()
    req.wait()
    req.free()
    req.start()
classes["start_after_free"] = error_class(start_after_free)
if rank == root_sig:  # the root alone: its signature changed
    classes["scatter_signature"] = error_class(lambda: comm.Scatter(
        T(np.zeros((size, 3), np.float32), "float32"), None, root=root_sig,
        device=True))
with open(f"{{out_dir}}/{{tag}}_errors_r{{rank}}.json", "w") as fh:
    json.dump({{"classes": classes, "plans": plans}}, fh)
"""

_REF_BODY = """
import json
import jax.numpy as jnp
from ompi_tpu import op as O
from ompi_tpu.coll import xla
from ompi_tpu.errors import MPIError
tag, out_dir, plans = "ref", {out_dir!r}, {{}}
{inputs}
def T(a, dtype):
    return jnp.asarray(a).astype(dtype)

def S(name, out):
    if out is None:
        open(f"{{out_dir}}/ref_{{name}}_r{{rank}}.none", "w").close()
        return
    out = np.asarray(out)
    if out.dtype.name == "bfloat16":
        out = out.view(np.uint16)
    np.save(f"{{out_dir}}/ref_{{name}}_r{{rank}}.npy", out)

def rooted_plan():
    return dict(xla._last_rooted_plan or {{}})

def reset_plan():
    xla._last_rooted_plan = None
""" + _CALLS + """
# the persistent cycles' operands, blocking: what the port's starts read
for i in range(2):
    x = T(make_input("pers", "red", "int32", rank + 10 * i, size), "int32")
    S(f"pers_ar{{i}}", comm.Allreduce(x))
    S(f"pers_rsb{{i}}", comm.Reduce_scatter_block(x[:size * 40]))
    S(f"pers_bc{{i}}", comm.Bcast(x, root=size - 1))
    S(f"pers_ag{{i}}", comm.Allgather(x))
    S(f"pers_a2a{{i}}", comm.Alltoall(x[:size * 40]))
    out = comm.Allreduce_multi({{"a": x, "b": [x[:7] * 3]}})
    S(f"pers_arm{{i}}_0", out["a"])
    S(f"pers_arm{{i}}_1", out["b"][0])
# what the port's coll/device hands to the host collectives, on host
# buffers here (jax holds no float64): Scan of float64, Reduce
x64 = np.arange(5, dtype=np.float64) * 0.1 * (rank + 1)
out = np.empty_like(x64)
comm.Scan(x64, out)
S("lifted_scan_f64", out)
out = np.zeros(3, np.float32)
comm.Reduce(np.full(3, rank + 0.5, np.float32), out, root=0)
S("lifted_reduce_host", out)
"""

_PORT_PROG = """
import json
import numpy as np
import torch
from ompi_tpu_torch import compat, mpi, op as O
from ompi_tpu_torch.coll import device as D
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.errors import (MPIError, ERR_COUNT, ERR_ROOT,
                                  ERR_NOT_SUPPORTED)
from ompi_tpu_torch.pml import request as rq
comm = mpi.Init()
rank, size = comm.rank, comm.size
tag, out_dir, plans = "port", {out_dir!r}, {{}}
for slot in ("reduce_dev", "gather_dev", "scatterv_dev", "alltoallv_dev",
             "scan_dev", "allreduce_multi_dev", "iscan_dev", "barrier_dev",
             "allreduce_init_dev", "allreduce_multi_init_dev"):
    assert comm.coll.providers[slot] == "device", comm.coll.providers
{inputs}
def T(a, dtype):
    return compat.tensor_from_numpy(a).to(getattr(torch, dtype))

def S(name, out):
    if out is None:
        open(f"{{out_dir}}/port_{{name}}_r{{rank}}.none", "w").close()
        return
    np.save(f"{{out_dir}}/port_{{name}}_r{{rank}}.npy",
            compat.tensor_to_numpy(out))

def rooted_plan():
    return dict(D._last_rooted_plan or {{}})

def reset_plan():
    D._last_rooted_plan = None
""" + _CALLS + """
# the device barrier, blocking and not: one coll_device_launches each
s = pvar.session()
comm.Barrier(device=True)
assert rq.wait_all([comm.Ibarrier(device=True)])[0].error == 0
assert s.read("coll_device_launches") == 2

# every nonblocking form at once, completed by wait_all
icases = [c for c in {cases!r} if c[0] in {icases!r}]
reqs = []
for name, kind, dtype, op, arg in icases:
    x = T(make_input(name, kind, dtype, rank, size,
                     traps=traps_for(name, kind, op, arg, size)), dtype)
    o = getattr(O, op) if op else None
    if kind == "red":
        reqs.append(comm.Ireduce(x, op=o, root=arg[0]) if arg[1] == ""
                    else comm.Iallreduce(x, op=o, deterministic=arg[1]))
    elif kind == "gat":
        reqs.append(comm.Igather(x, root=arg))
    elif kind == "sca":
        reqs.append(comm.Iscatter(x if rank == arg[0] else None,
                                  root=arg[0], device=True))
    elif kind == "scv":
        reqs.append(comm.Iscatterv(x if rank == arg[0] else None, None,
                                   v_counts(name, size)[0], root=arg[0],
                                   device=True))
    elif kind == "agv":
        reqs.append(comm.Iallgatherv(x, None, v_counts(name, size)[0]))
    elif kind == "gav":
        reqs.append(comm.Igatherv(x, None, v_counts(name, size)[0],
                                  root=arg))
    elif kind == "a2v":
        m = v_counts(name, size)
        reqs.append(comm.Ialltoallv(
            x, None, m[rank], [m[p][rank] for p in range(size)],
            max_count=max(max(row) for row in m)))
    elif kind == "rsv":
        counts = [3, 0] + [4] * (size - 2)
        counts[-1] += x.shape[0] - sum(counts)
        reqs.append(comm.Ireduce_scatter(x, None, counts, op=o))
    elif kind == "scan":
        reqs.append(comm.Iscan(x, op=o))
    else:
        reqs.append(comm.Iexscan(x, op=o))
y = T(make_input("gat_f32", "gat", "float32", rank, size, traps=False),
      "float32")
extra = [comm.Ibcast(y, root=size - 1), comm.Iallgather(y),
         comm.Ialltoall(y[:size * 5]),
         comm.Ireduce_scatter_block(y[:size * 5], op=O.MAX),
         comm.Iallreduce(y, deterministic="linear"),
         comm.Ibarrier(device=True)]
statuses = rq.wait_all(reqs + extra)
assert len(statuses) == len(reqs) + len(extra)
assert rq.test_all(reqs) and rq.test_any(reqs) == 0
for (name, *_), req in zip(icases, reqs):
    assert req.completed and req.test()
    S(f"i_{{name}}", req.array)
blocking = [comm.Bcast(y.clone(), root=size - 1), comm.Allgather(y),
            comm.Alltoall(y[:size * 5]),
            comm.Reduce_scatter_block(y[:size * 5], op=O.MAX),
            comm.Allreduce(y, deterministic="linear")]
for req, want in zip(extra, blocking):
    assert torch.equal(req.array, want)

# persistent: bound tensors, changed in place between the two starts
x = T(make_input("pers", "red", "int32", rank, size), "int32")
tree = {{"a": x, "b": [x[:7] * 3]}}
preqs = {{"ar": comm.Allreduce_init(x),
          "rsb": comm.Reduce_scatter_block_init(x[:size * 40]),
          "bc": comm.Bcast_init(x, root=size - 1),
          "ag": comm.Allgather_init(x),
          "a2a": comm.Alltoall_init(x[:size * 40]),
          "arm": comm.Allreduce_multi_init(tree)}}
for req in preqs.values():
    assert req.completed and req.array is None  # inactive: complete
    req.wait()
s = pvar.session()
for i in range(2):
    if i:
        x.copy_(T(make_input("pers", "red", "int32", rank + 10, size),
                  "int32"))
        tree["b"][0].copy_(x[:7] * 3)
    for key, req in preqs.items():
        req.start()
        req.wait()
        if key == "arm":
            S(f"pers_arm{{i}}_0", req.array["a"])
            S(f"pers_arm{{i}}_1", req.array["b"][0])
        else:
            S(f"pers_{{key}}{{i}}", req.array)
assert s.read("coll_device_launches") == 2 * len(preqs)
for req in preqs.values():
    req.free()

# the port's own refusals, on every rank
for fn in (lambda: comm.Reduce(x, root=size),
           lambda: comm.Gather(x, root=-1),
           lambda: comm.Scatter(x, root=size),
           lambda: comm.Gatherv(x[:0], None, [0] * size, root=size)):
    assert error_class(fn) == ERR_ROOT
# once refused, served now: Scan of float64 stages through
# coll/accelerator, a host Reduce and the host Ibarrier run coll/tuned and
# libnbc (the results are compared with the reference's); MINLOC on
# tensors raises ERR_OP
from ompi_tpu_torch.errors import ERR_OP
x64 = np.arange(5, dtype=np.float64) * 0.1 * (rank + 1)
S("lifted_scan_f64", comm.Scan(torch.from_numpy(x64)))
out = np.zeros(3, np.float32)
assert comm.Reduce(np.full(3, rank + 0.5, np.float32), out, root=0) is None
np.save(f"{{out_dir}}/port_lifted_reduce_host_r{{rank}}.npy", out)
assert rq.wait_all([comm.Ibarrier()])[0].error == 0
assert error_class(lambda: comm.Allreduce_multi(
    [x], op=O.MINLOC)) == ERR_OP
# rank 0 expects 2 rows from the last rank, which sends it 1: the count
# round shows the mismatch to every rank, and all raise ERR_COUNT (the
# reference does not check)
bad_r = [1] * size
bad_r[-1] += rank == 0
assert error_class(lambda: comm.Alltoallv(
    T(np.zeros((size, 2), np.int32), "int32"), None, [1] * size,
    bad_r)) == ERR_COUNT
assert comm.Alltoallv(T(np.full((size, 2), rank, np.int32), "int32"), None,
                      [1] * size, [1] * size)[:, 0].tolist() \\
    == list(range(size))
open(f"{{out_dir}}/port_ok_r{{rank}}.ok", "w").close()
mpi.Finalize()
"""


def _port_job(src: str, n: int, mca) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n, mca=mca,
                                    timeout=150)
    finally:
        os.unlink(path)


def _mca(threshold):
    ref = {"device_plane": "on", "coll_xla_bucket_bytes": "64"}
    if threshold is not None:
        ref["coll_xla_rooted_threshold_bytes"] = str(threshold)
    return ref, dict(compat.mca_from_reference(ref),
                     device_plane_platform="cpu")


def _jobs(d, n, cases, threshold):
    ref_mca, port_mca = _mca(threshold)
    fmt = dict(inputs=_INPUTS, cases=cases, out_dir=str(d),
               icases=ICASES)
    run_ranks(_REF_BODY.format(**fmt), n, mca=ref_mca, timeout=300)
    rc = _port_job(_PORT_PROG.format(**fmt), n, port_mca)
    assert rc == 0, f"port job exited {rc}"
    return d


_done = {}


@pytest.fixture(params=[3, 4], scope="module")
def job(request, tmp_path_factory):
    """Both packages' jobs, once per n: (n, cases, results directory)."""
    n = request.param
    if n not in _done:
        cases, thr = (CASES, 0) if n == 3 else (CASES4, None)
        _done[n] = (n, cases, _jobs(tmp_path_factory.mktemp(f"rest{n}"),
                                    n, cases, thr))
    return _done[n]


def _names(name, out, r):
    """The saved names of a case (an Allreduce_multi case: one per leaf)."""
    if (out / f"ref_{name}_r{r}.npy").exists() \
            or (out / f"ref_{name}_r{r}.none").exists():
        return [name]
    return [f"{name}_{i}" for i in range(4)]


def _dtype_of(name):
    return "bfloat16" if "_bf16" in name or (
        name.startswith("arm") and name.endswith("_0")) else ""


def _ns():
    ns = {"np": np}
    exec(_INPUTS, ns)
    return ns


def _default_sum(case):
    return _ns()["is_default_sum"](case[1], case[3], case[4])


def _magnitude(case, n, r):
    """Per result element, the sum over ranks of the operands'
    magnitudes (a SUM under '' is held within DEFAULT_RTOL of it)."""
    ns = _ns()
    name, kind, dtype = case[:3]
    if kind == "arm":  # the leaves in flatten order: b, k[0], k[1], w
        leaves = [(t["b"], t["k"][0], t["k"][1], t["w"])
                  for t in map(ns["make_tree"], range(n))]
        return [sum(np.abs(t[i].astype(np.float64)) for t in leaves)
                for i in range(4)]
    mag = sum(np.abs(ns["make_input"](name, kind, dtype, p, n, traps=False)
                     .astype(np.float64)) for p in range(n))
    if kind == "rsv":
        counts = [3, 0] + [4] * (n - 2)
        counts[-1] += mag.shape[0] - sum(counts)
        off = sum(counts[:r])
        mag = mag[off:off + counts[r]]
    return [mag]


def _pair(out, name, r, pref="port"):
    none = [(out / f"{p}_{name}_r{r}.none").exists() for p in ("ref", pref)]
    assert none[0] == none[1], (name, r, none)
    if none[0]:
        return None, None
    return (np.load(out / f"ref_{name}_r{r}.npy"),
            np.load(out / f"{pref}_{name}_r{r}.npy"))


def _check(job, pred, within=False):
    n, cases, out = job
    picked = [c for c in cases if pred(c)]
    assert picked
    for case in picked:
        for r in range(n):
            names = _names(case[0], out, r)
            mags = _magnitude(case, n, r) if within else None
            for i, name in enumerate(names):
                ref, got = _pair(out, name, r)
                if ref is None:
                    continue
                dt = _dtype_of(name)
                if not within or ref.dtype.kind != "f" and not dt:
                    assert_bits_equal(ref, got, f"{name} rank {r}", dt)
                    continue
                a, b = ((x.astype(np.uint32) << 16).view(np.float32)
                        .astype(np.float64) if dt else x.astype(np.float64)
                        for x in (ref, got))
                rtol = DEFAULT_RTOL["bfloat16" if dt else ref.dtype.name]
                assert ref.shape == got.shape, name
                err = np.abs(a - b)
                assert (err <= rtol * mags[i].reshape(err.shape) + 1e-30
                        ).all(), f"{name} rank {r}: {err.max()}"


@pytest.mark.parametrize("kind", ["red", "rsv", "arm"])
def test_reductions_bitwise(job, kind):
    """Reduce, Reduce_scatter and Allreduce_multi under 'linear' and
    'ring', and Reduce's binomial tree (every op but SUM under ''),
    bitwise equal to coll/xla's."""
    _check(job, lambda c: c[1] == kind and not _default_sum(c))


def test_default_sum_within_tolerance(job):
    """SUM under '': the rooted reduce-scatter and the ring against
    psum_scatter / psum, within DEFAULT_RTOL of the result's size."""
    _check(job, _default_sum, within=True)


@pytest.mark.parametrize("kind", ["gat", "sca", "scv", "agv", "gav", "a2v"])
def test_copies_bitwise(job, kind):
    """Gather, Scatter, the v-collectives and Alltoallv (with max_count
    and with the count round): bitwise, None on the same ranks."""
    _check(job, lambda c: c[1] == kind)


@pytest.mark.parametrize("kind", ["scan", "exscan"])
def test_prefixes_bitwise(job, kind):
    """Scan / Exscan fold in rank order in every package: bitwise."""
    _check(job, lambda c: c[1] == kind)


def test_nonblocking_equals_reference_blocking(job):
    """Every I* form (and Ibarrier) completed by wait_all: each request's
    ``.array`` equals the reference's blocking result bitwise (None on
    the same ranks)."""
    n, cases, out = job
    for name, *_ in [c for c in cases if c[0] in ICASES]:
        for r in range(n):
            ref, got = _pair(out, name, r, pref="port_i")
            if ref is not None:
                assert_bits_equal(ref, got, f"I {name} rank {r}",
                                  _dtype_of(name))


def test_persistent_cycles_read_the_bound_buffers(job):
    """Each persistent form started twice, its buffer changed in place
    between the starts: each cycle equals the reference's blocking call
    on what the buffer then held (int32: every order is exact), and the
    two cycles differ."""
    n, _, out = job
    for key in ("ar", "rsb", "bc", "ag", "a2a", "arm0", "arm1"):
        for r in range(n):
            got = []
            for i in range(2):
                name = f"pers_{key[:3]}{i}_{key[3]}" if key.startswith(
                    "arm") else f"pers_{key}{i}"
                ref, g = _pair(out, name, r)
                assert_bits_equal(ref, g, f"{name} rank {r}")
                got.append(g)
            assert not np.array_equal(got[0], got[1]), key


def test_erroneous_calls_on_every_rank(job):
    """ERR_COUNT (indivisible Scatter, counts of the wrong length or sum,
    a max_count below the counts) and ERR_REQUEST (a start after free) on
    every rank of both packages; ERR_ARG on the root alone when its
    scatter signature changed after the cached round; the port's ERR_ROOT
    refusals, ERR_OP for MINLOC on tensors, and its ERR_COUNT on every
    rank for Alltoallv rcounts that one rank gets wrong, checked in its
    job. What this test once checked as refused is served now: a float64
    Scan (staged through coll/accelerator) and a host Reduce equal the
    reference's host collectives bitwise, and the host Ibarrier
    completes."""
    n, _, out = job
    for r in range(n):
        ref = json.loads((out / f"ref_errors_r{r}.json").read_text())
        got = json.loads((out / f"port_errors_r{r}.json").read_text())
        assert ref["classes"] == got["classes"]
        want = {"scatter_indivisible": 2, "scatterv_counts": 2,
                "allgatherv_counts": 2, "reduce_scatter_sum": 2,
                "alltoallv_max_count": 2, "start_after_free": 7}
        if r == 1 % n:
            want["scatter_signature"] = 13
        assert got["classes"] == want
        assert (out / f"port_ok_r{r}.ok").exists()
        for what in ("scan_f64", "reduce_host"):
            ref = np.load(out / f"ref_lifted_{what}_r{r}.npy")
            got = np.load(out / f"port_lifted_{what}_r{r}.npy")
            assert ref.dtype == got.dtype and np.array_equal(
                ref.view(np.uint8), got.view(np.uint8)), (what, r)


def test_non_roots_never_allocate_the_n_fold_result(job):
    """``_last_rooted_plan`` on every rank after each rooted Reduce /
    Gather: a non-root's outputs stay O(bytes) (at most two partials or
    one chunk), the root's hold its result, and the binomial takes the
    reference's rounds."""
    n, cases, out = job
    rooted = 0
    for r in range(n):
        ref = json.loads((out / f"ref_errors_r{r}.json").read_text())
        got = json.loads((out / f"port_errors_r{r}.json").read_text())
        for name, kind, dtype, op, arg in cases:
            if kind not in ("red", "gat"):
                continue
            root = arg[0] if kind == "red" else arg
            plan, rplan = got["plans"][name], ref["plans"][name]
            size = np.load(out / f"ref_{name}_r{root}.npy").size
            if not plan or (kind == "red" and arg[1]):
                continue  # the allreduce / allgather path
            rooted += 1
            elems = size // (n if kind == "gat" else 1)
            if plan["kind"] == "reduce_binomial":
                assert plan["rounds"] == rplan["rounds"] \
                    == (n - 1).bit_length(), (name, plan, rplan)
            if r != root:
                assert plan["alloc_elems"] <= 2 * elems, (name, r, plan)
                assert plan["alloc_elems"] < n * elems, (name, r, plan)
            else:
                assert plan["alloc_elems"] >= size, (name, plan)
    assert rooted


_SINGLETON_REF = """
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax.numpy as jnp
from ompi_tpu import mpi, op as O
comm = mpi.Init()
x = jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3) - 5.5)
outs = {{}}
for tag, c in (("world", comm), ("self", mpi.COMM_SELF)):
    outs[tag + "_red"] = c.Reduce(x, op=O.MAX, root=0)
    outs[tag + "_gat"] = c.Gather(x.astype(jnp.bfloat16), root=0)
    outs[tag + "_sca"] = c.Scatter(x.astype(jnp.int32), root=0)
    outs[tag + "_scv"] = c.Scatterv(x, None, [4], root=0)
    outs[tag + "_agv"] = c.Allgatherv(x, None, [4])
    outs[tag + "_gav"] = c.Gatherv(x, None, [4], root=0)
    outs[tag + "_a2v"] = c.Alltoallv(x.astype(jnp.int32), None, [4], [4])
    outs[tag + "_rsv"] = c.Reduce_scatter(x, None, [4], op=O.PROD)
    outs[tag + "_scan"] = c.Scan(x.astype(jnp.float16))
    outs[tag + "_exscan"] = c.Exscan(x.astype(jnp.int32), op=O.BXOR)
    outs[tag + "_arm"] = c.Allreduce_multi([x, x.astype(jnp.int32)])[1]
    c.Barrier(device=True)
for k, v in outs.items():
    v = np.asarray(v)
    np.save(os.path.join({out!r}, f"ref_{{k}}.npy"),
            v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
mpi.Finalize()
print("OK")
"""

_SINGLETON_PORT = """
import os
import numpy as np
import torch
from ompi_tpu_torch import compat, mpi, op as O
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.pml import request as rq
from ompi_tpu_torch.runtime import device_plane
comm = mpi.Init()
assert comm.size == 1 and not device_plane.active()
x = torch.arange(12, dtype=torch.float32).reshape(4, 3) - 5.5
outs = {{}}
for tag, c in (("world", comm), ("self", mpi.COMM_SELF)):
    outs[tag + "_red"] = c.Reduce(x, op=O.MAX, root=0)
    outs[tag + "_gat"] = c.Gather(x.bfloat16(), root=0)
    outs[tag + "_sca"] = c.Scatter(x.int(), root=0)
    outs[tag + "_scv"] = c.Scatterv(x, None, [4], root=0)
    outs[tag + "_agv"] = c.Allgatherv(x, None, [4])
    outs[tag + "_gav"] = c.Gatherv(x, None, [4], root=0)
    outs[tag + "_a2v"] = c.Alltoallv(x.int(), None, [4], [4])
    outs[tag + "_rsv"] = c.Reduce_scatter(x, None, [4], op=O.PROD)
    outs[tag + "_scan"] = c.Scan(x.half())
    outs[tag + "_exscan"] = c.Exscan(x.int(), op=O.BXOR)
    outs[tag + "_arm"] = c.Allreduce_multi([x, x.int()])[1]
    c.Barrier(device=True)
    # new tensors, never the caller's buffer
    assert all(v.data_ptr() != x.data_ptr() for k, v in outs.items()
               if k.startswith(tag))
    reqs = [c.Iscan(x), c.Ibarrier(device=True), c.Ireduce(x, root=0)]
    rq.wait_all(reqs)
    assert torch.equal(reqs[0].array, x) and reqs[1].array is None
    p = c.Allreduce_init(x)
    p.start()
    p.wait()
    assert torch.equal(p.array, x)
assert pvar.read("device_plane_arenas") == 0
for k, v in outs.items():
    np.save(os.path.join({out!r}, f"port_{{k}}.npy"),
            compat.tensor_to_numpy(v))
mpi.Finalize()
print("OK")
"""


def test_singleton_size1_serves_every_slot(tmp_path):
    """A one-rank world and COMM_SELF outside any launcher, with no device
    plane: every new slot returns what the reference's coll/xla returns,
    as a new tensor on the tensor's own device (Exscan: zeros)."""
    env = dict(os.environ)
    for key in [k for k in env if k.startswith("OMPI_TPU_")]:
        del env[key]
    for src in (_SINGLETON_REF, _SINGLETON_PORT):
        r = subprocess.run([sys.executable, "-c", src.format(out=str(
            tmp_path))], capture_output=True, text=True, timeout=120,
            env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    for tag in ("world", "self"):
        for kind in ("red", "gat", "sca", "scv", "agv", "gav", "a2v", "rsv",
                     "scan", "exscan", "arm"):
            ref = np.load(tmp_path / f"ref_{tag}_{kind}.npy")
            got = np.load(tmp_path / f"port_{tag}_{kind}.npy")
            assert_bits_equal(ref, got, f"{tag} {kind}",
                              "bfloat16" if kind == "gat" else "")
    assert not np.load(tmp_path / "port_world_exscan.npy").any()


# ---------------------------------------------------------------------------
# one process: the request classes


class _Pending:
    completed = False
    array = None


def test_persistent_request_lifecycle():
    """Inactive is complete; a start while a cycle is active, or after
    free, raises ERR_REQUEST; rebind raises ERR_NOT_SUPPORTED; each start
    runs the launcher anew."""
    calls = []
    req = D.PersistentDeviceRequest(
        lambda: calls.append(1) or torch.tensor(len(calls)), "cpu")
    assert req.completed and not req.active and req.array is None
    assert req.wait() is req.status
    req.start()
    assert req.completed and int(req.array) == 1
    req.start()
    assert int(req.array) == 2
    req._inner = _Pending()  # a cycle the device has not finished
    assert req.active and not req.completed
    with pytest.raises(errors.MPIError) as e:
        req.start()
    assert e.value.error_class == errors.ERR_REQUEST
    with pytest.raises(errors.MPIError) as e:
        req.rebind()
    assert e.value.error_class == errors.ERR_NOT_SUPPORTED
    req.free()
    for fn in (req.start, req.rebind):
        with pytest.raises(errors.MPIError) as e:
            fn()
        assert e.value.error_class == errors.ERR_REQUEST
    assert len(calls) == 2


def test_plural_helpers_poll_completed_live():
    """wait_all / wait_any / wait_some / test_all / test_any read each
    request's ``completed`` on every poll (a device request asks its
    event anew), and a timeout raises."""
    class Flips:
        def __init__(self, after):
            self.after, self.polls, self.status = after, 0, rq.Status()

        @property
        def completed(self):
            self.polls += 1
            return self.polls > self.after

        def retrieve_status(self):
            return self.status

    a, b = Flips(3), Flips(0)
    assert rq.test_any([a, b]) == 1 and not rq.test_all([a])
    assert rq.wait_any([a]) == 0 and a.polls > 3
    assert rq.wait_some([Flips(2), b]) == [1]
    assert len(rq.wait_all([Flips(5), b])) == 2
    with pytest.raises(TimeoutError):
        rq.wait_all([Flips(1 << 40)], timeout=0.05)
    req = D.DeviceRequest(torch.ones(2), "cpu")
    assert req.completed and req.test() and req.wait() is req.status


def test_mca_maps_the_coll_xla_settings():
    """The reference's rooted threshold carries over under coll/device's
    name; the Alltoallv pad factor (nothing is padded) and the two
    metadata-cache switches (coll/device keeps the reference's defaults:
    the scatter round cached, the Alltoallv round at every call) have no
    counterpart and are dropped."""
    got = compat.mca_from_reference({
        "coll_xla_rooted_threshold_bytes": "0",
        "coll_xla_scatter_meta_cache": "0",
        "coll_xla_a2av_meta_cache": "1",
        "coll_xla_alltoallv_pad_factor": "4"})
    assert got == {"coll_device_rooted_threshold_bytes": "0"}
    assert D.cvar.get("coll_device_rooted_threshold_bytes") == 1 << 20


def test_every_recorded_pvar_is_well_known():
    """Each pvar the port records (``pvar.record`` / ``record_hwm`` with a
    literal name) is listed in its ``core/pvar.py`` WELL_KNOWN, and each
    name it builds at run time (an f-string) opens with one of
    WELL_KNOWN_PREFIXES (profile.timing's ``profile_<op>_*`` among them)
    or with the listed names' common part."""
    import re

    from ompi_tpu_torch.core import pvar

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ompi_tpu_torch")
    names, dynamic = set(), set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    text = fh.read()
                # pvar records only: a trace recorder's ``rec.record``
                # takes a span name, not a pvar
                names |= set(re.findall(
                    r"pvar\.record(?:_hwm)?\(\s*\"([a-z0-9_]+)\"", text))
                dynamic |= set(re.findall(
                    r"pvar\.record(?:_hwm)?\(\s*f\"([a-z0-9_]*)\{", text))
    assert {"coll_device_fused_bytes", "coll_device_launches"} <= names
    assert names <= set(pvar.WELL_KNOWN), names - set(pvar.WELL_KNOWN)
    assert "profile_" in dynamic
    # a family of its own, or a name built from listed parts
    # (monitoring_{ctx}_msgs: the per-context names are listed)
    assert all(p.startswith(pvar.WELL_KNOWN_PREFIXES)
               or any(n.startswith(p) for n in pvar.WELL_KNOWN)
               for p in dynamic), dynamic
    assert pvar.is_well_known("profile_Neighbor_alltoall_calls")
    assert not pvar.is_well_known("profiles")
