"""coll/accelerator — device tensors staged through the host collectives.

The port's copy of ``ompi_tpu.coll.accelerator`` (coll/accelerator.py:32-458;
reference: ompi/mca/coll/accelerator, coll_accelerator_allreduce.c:32-115:
check the buffer, stage it to the host, run the host collective, copy the
result back). Priority 40, above coll/tuned: a ``*_dev`` slot that no
device component takes (a comm the device plane does not serve) lands
here, and coll/device sends here what its kernels and folds do not take
(an op coll/xla would not trace, a 64-bit or complex dtype), as coll/xla
falls to the reference's copy.

Each staged call copies its whole input once to the host
(:func:`_stage_in`: one ``copy_`` on the caller's stream into a host
buffer of the accelerator, pinned for a CUDA tensor, waited on before the
host collective starts), runs the comm's host slot (coll/tuned,
coll/basic) on numpy arrays, and copies the whole result once into a new
tensor on the input's device (:func:`_stage_out`, the accelerator's
``to_device``). Nothing is chunked. Every staged call counts one
``coll_accelerator_staged``. The slots return new tensors, as coll/device's
do; a rooted call's non-roots get None.

The ``i*_dev`` forms run the staged call at once and return a
:class:`~ompi_tpu_torch.coll.device.DeviceRequest` over its result; the
``*_init_dev`` forms re-run it at every start
(:class:`~ompi_tpu_torch.coll.device.PersistentDeviceRequest`).

Where the port differs from the reference:

- MINLOC and MAXLOC raise ``MPIError(ERR_OP)``: they combine the pair
  datatypes' (val, loc) records, which no torch dtype holds (the
  reference's staged path fails there too, on a plain array).
- A user op on a bfloat16 tensor raises ``MPIError(ERR_NOT_SUPPORTED)``
  (numpy has no bfloat16 to hand it); REPLACE and NO_OP, which pick an
  operand, move its bits.

On a topology comm it adds the staging neighbourhood slots
``neighbor_allgather_dev`` and ``neighbor_alltoall_dev``
(coll/accelerator.py:314-342) under coll/xla_neighbor's contract (every
rank passes a block of one shape; PROC_NULL rows are zeros): they serve
only where the device plane is down, since coll/device installs its own
on every topology comm the plane serves.

``pallreduce_init_dev`` and ``preduce_scatter_init_dev`` do the full
partitioned bookkeeping (``Pready``, double-Pready and unready-wait
errors) with the reduction deferred to ``wait()``, through coll/device's
deferred handles over the staged ``allreduce_multi_dev`` /
``reduce_scatter_multi_dev`` (coll/accelerator.py:375-395).
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch import accelerator, errors, op as op_mod
from ompi_tpu_torch.accelerator import stream
from ompi_tpu_torch.coll import device as _device
from ompi_tpu_torch.coll.basic import packed_displs
from ompi_tpu_torch.core import pvar, registry
from ompi_tpu_torch.datatype import dtype_of
from ompi_tpu_torch.pml import accel_p2p

#: numpy holds no bfloat16: a bfloat16 tensor stages as its bits
_BITS = {torch.bfloat16: torch.int16}


def check_op(kind: str, op) -> op_mod.Op:
    """The op of a staged tensor call: MINLOC / MAXLOC raise ERR_OP."""
    opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
    if opn is None:
        raise errors.MPIError(errors.ERR_OP, f"{kind}: unknown op {op!r}")
    if opn in (op_mod.MINLOC, op_mod.MAXLOC):
        raise errors.MPIError(
            errors.ERR_OP,
            f"{kind}: {opn.name} combines (val, loc) records of the pair "
            "datatypes (FLOAT_INT, DOUBLE_INT, LONG_INT, TWOINT, SHORT_INT), "
            "which no torch dtype holds: pass a numpy array of one")
    return opn


def _host_view(host: torch.Tensor, shape, dtype) -> np.ndarray:
    """A numpy array of ``shape`` over the uint8 host tensor ``host``."""
    dt = _BITS.get(dtype, dtype)
    n = _device._row_elems(shape)
    if n == 0:
        return torch.empty(tuple(shape), dtype=dt).numpy()
    return host[:n * dt.itemsize].view(dt).view(tuple(shape)).numpy()


def _host_like(shape, dtype, device) -> np.ndarray:
    """An uninitialised host array for a result bound to ``device``
    (pinned for a CUDA device)."""
    n = _device._row_elems(shape)
    acc = accelerator.for_device(device)
    host = acc.host_buffer(max(n, 1) * dtype.itemsize, device)
    return _host_view(host, shape, dtype)


def _stage_in(t: torch.Tensor) -> np.ndarray:
    """D2H: the whole tensor, one ``copy_`` on the caller's stream into a
    host buffer, waited on (reference: check_buf + memcpy)."""
    if not isinstance(t, torch.Tensor):
        raise errors.MPIError(
            errors.ERR_BUFFER,
            f"coll_accelerator: a {type(t).__name__}, not a torch.Tensor")
    accel_p2p.check_tensor(t, "coll_accelerator")
    if t.dtype == torch.complex32:
        raise errors.MPIError(errors.ERR_NOT_SUPPORTED,
                              f"coll_accelerator: numpy holds no {t.dtype}")
    host = _host_like(t.shape, t.dtype, t.device)
    src = t.detach().view(_BITS.get(t.dtype, t.dtype))
    if t.numel() and t.device.type == "cpu":
        np.copyto(host, src.numpy())  # numpy's copy: see Accelerator
    elif t.numel():
        torch.from_numpy(host).copy_(src, non_blocking=True)
        stream.Event(t.device).record().wait()
    return host


def _stage_out(host: np.ndarray, like) -> torch.Tensor:
    """H2D: the whole result, one copy into a new tensor on ``like``'s
    device (the rank's device without one), waited on."""
    dev = like.device if isinstance(like, torch.Tensor) \
        else accel_p2p.rank_device()
    dtype = like.dtype if isinstance(like, torch.Tensor) else None
    src = torch.from_numpy(np.ascontiguousarray(host))
    if dtype in _BITS:
        src = src.view(dtype)
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    if src.numel():
        acc = accelerator.for_device(dev)
        acc.begin_staging(dev)
        acc.to_device(src.reshape(-1).view(torch.uint8),
                      out.view(-1).view(torch.uint8)).wait()
    return out


def _host_op(kind: str, op, t: torch.Tensor) -> op_mod.Op:
    opn = check_op(kind, op)
    if t.dtype in _BITS and opn.name not in ("MPI_REPLACE", "MPI_NO_OP"):
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"{kind}: {opn.name} of {t.dtype} (numpy holds no {t.dtype}; "
            "REPLACE and NO_OP move its bits)")
    return opn


def _row(shape) -> int:
    """Elements per row (dim 0) of ``shape``; 1 for a 1-D shape."""
    return _device._row_elems(shape[1:])


def allreduce_dev(comm, sendbuf, op=op_mod.SUM, deterministic=None):
    """``deterministic`` is taken for the slot's signature: the host
    algorithm fixes the order (coll/basic's is the rank-order fold)."""
    opn = _host_op("allreduce", op, sendbuf)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    recv = _host_like(host.shape, sendbuf.dtype, sendbuf.device)
    comm.coll.allreduce(comm, host, recv, recv.size, None, opn)
    return _stage_out(recv, sendbuf)


def allreduce_multi_dev(comm, bufs, op=op_mod.SUM, deterministic=None):
    """The fused allreduce staged leaf by leaf: device-side fusion buys
    nothing once the payload crosses the host transports."""
    from ompi_tpu_torch.zero import layout as zl

    leaves, treedef = zl.tree_flatten(bufs)
    return zl.tree_unflatten(treedef, [
        allreduce_dev(comm, b, op, deterministic) for b in leaves])


def reduce_scatter_multi_dev(comm, bufs, op=op_mod.SUM, deterministic=None):
    """The zero/ bucketed reduce-scatter staged: every leaf to the host,
    one host allreduce of each padded flat bucket (the same ZeroPlan as
    coll/device), this rank's chunk back to the leaves' device."""
    from ompi_tpu_torch.zero import layout as zl

    leaves, treedef = zl.tree_flatten(bufs)
    opn = check_op("reduce_scatter_multi", op)
    for t in leaves:
        _host_op("reduce_scatter_multi", opn, t)
    pvar.record("coll_accelerator_staged")
    plan = zl.plan_for(leaves, comm.size)
    metas = zl._fuse_metas(leaves)
    hosts = [_stage_in(t).reshape(-1) for t in leaves]
    shards = []
    for b, idxs in enumerate(plan.buckets):
        flat = np.concatenate([hosts[i] for i in idxs])
        pad = plan.padded[b] - plan.elems[b]
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
        out = np.empty_like(flat)
        comm.coll.allreduce(comm, flat, out, out.size, dtype_of(out), opn)
        k = plan.shard_elems[b]
        like = leaves[idxs[0]]
        shards.append(_stage_out(out[comm.rank * k:(comm.rank + 1) * k],
                                 like))
        pvar.record("zero_rs_launches")
    pvar.record("zero_fused_bytes", plan.nbytes)
    pvar.record("zero_pad_bytes", plan.pad_bytes)
    return zl.ShardedState(plan, metas, treedef, shards, comm.rank,
                           comm.size)


def allgather_multi_dev(comm, state):
    """The zero/ bucketed allgather staged: each shard to the host, the
    object channel's allgather per bucket, the rebuilt leaves back to the
    shards' device."""
    pvar.record("coll_accelerator_staged")
    fulls = []
    for s in state.shards:
        parts = comm.coll.allgather_obj(comm, _stage_in(s))
        fulls.append(_stage_out(np.concatenate(parts), s))
        pvar.record("zero_ag_launches")
    pvar.record("zero_fused_bytes", state.plan.nbytes)
    return state.unpack(fulls)


def bcast_dev(comm, buf, root=0):
    _device._check_root("bcast", comm, root)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(buf)
    comm.coll.bcast(comm, host, host.size, None, root)
    return _stage_out(host, buf)


def reduce_dev(comm, sendbuf, op=op_mod.SUM, root=0, deterministic=None):
    opn = _host_op("reduce", op, sendbuf)
    _device._check_root("reduce", comm, root)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    recv = _host_like(host.shape, sendbuf.dtype, sendbuf.device)
    comm.coll.reduce(comm, host, recv, host.size, None, opn, root)
    if comm.rank != root:
        return None
    return _stage_out(recv, sendbuf)


def allgather_dev(comm, sendbuf):
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    recv = _host_like((comm.size,) + host.shape, sendbuf.dtype,
                      sendbuf.device)
    comm.coll.allgather(comm, host, recv, host.size, None)
    return _stage_out(recv, sendbuf)


def alltoall_dev(comm, sendbuf):
    """Dim 0 of sendbuf (n * k) splits by destination."""
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    if host.size % comm.size:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"alltoall: {host.size} elements not divisible by comm size "
            f"{comm.size}")
    recv = _host_like(host.shape, sendbuf.dtype, sendbuf.device)
    comm.coll.alltoall(comm, host, recv, host.size // comm.size, None)
    return _stage_out(recv, sendbuf)


def reduce_scatter_block_dev(comm, sendbuf, op=op_mod.SUM,
                             deterministic=None):
    opn = _host_op("reduce_scatter_block", op, sendbuf)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    n = comm.size
    if host.ndim < 1 or host.shape[0] % n:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"reduce_scatter_block: dim 0 of shape {host.shape} not "
            f"divisible by comm size {n}")
    recv = _host_like((host.shape[0] // n,) + host.shape[1:],
                      sendbuf.dtype, sendbuf.device)
    comm.coll.reduce_scatter_block(comm, host, recv, recv.size, None, opn)
    return _stage_out(recv, sendbuf)


def barrier_dev(comm):
    """No payload to stage: the host barrier is the semantics."""
    pvar.record("coll_accelerator_staged")
    comm.coll.barrier(comm)


def allgatherv_dev(comm, sendbuf, counts):
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    counts = [int(c) for c in counts]
    row = _row(host.shape)
    recv = _host_like((sum(counts),) + host.shape[1:], sendbuf.dtype,
                      sendbuf.device)
    comm.coll.allgatherv(comm, host.reshape(-1), recv.reshape(-1),
                         [c * row for c in counts],
                         [d * row for d in packed_displs(counts)], None)
    return _stage_out(recv, sendbuf)


def gatherv_dev(comm, sendbuf, counts, root=0):
    _device._check_root("gatherv", comm, root)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    counts = [int(c) for c in counts]
    row = _row(host.shape)
    recv = (_host_like((sum(counts),) + host.shape[1:], sendbuf.dtype,
                       sendbuf.device) if comm.rank == root else None)
    comm.coll.gatherv(comm, host.reshape(-1),
                      None if recv is None else recv.reshape(-1),
                      [c * row for c in counts],
                      [d * row for d in packed_displs(counts)], None, root)
    if comm.rank != root:
        return None
    return _stage_out(recv, sendbuf)


def alltoallv_dev(comm, sendbuf, scounts, rcounts, max_count=None):
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    row = _row(host.shape)
    scounts = [int(c) for c in scounts]
    rcounts = [int(c) for c in rcounts]
    recv = _host_like((sum(rcounts),) + host.shape[1:], sendbuf.dtype,
                      sendbuf.device)
    comm.coll.alltoallv(comm, host.reshape(-1), recv.reshape(-1),
                        [c * row for c in scounts],
                        [d * row for d in packed_displs(scounts)],
                        [c * row for c in rcounts],
                        [d * row for d in packed_displs(rcounts)], None)
    return _stage_out(recv, sendbuf)


def reduce_scatter_dev(comm, sendbuf, counts, op=op_mod.SUM,
                       deterministic=None):
    opn = _host_op("reduce_scatter", op, sendbuf)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    counts = [int(c) for c in counts]
    if sum(counts) != host.shape[0]:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"reduce_scatter: counts sum to {sum(counts)} but sendbuf dim "
            f"0 is {host.shape[0]}")
    recv = _host_like((counts[comm.rank],) + host.shape[1:], sendbuf.dtype,
                      sendbuf.device)
    row = _row(host.shape)
    comm.coll.reduce_scatter(comm, host.reshape(-1), recv.reshape(-1),
                             [c * row for c in counts], None, opn)
    return _stage_out(recv, sendbuf)


def scatterv_dev(comm, sendbuf, counts, root=0, like=None):
    """The ragged chunks ride the object channel with their shapes: one
    collective, so no metadata round."""
    _device._check_root("scatterv", comm, root)
    pvar.record("coll_accelerator_staged")
    chunks = None
    if comm.rank == root:
        host = _stage_in(sendbuf)
        offs = packed_displs(counts)
        chunks = [host[offs[i]:offs[i] + int(c)]
                  for i, c in enumerate(counts)]
    chunk = comm.coll.scatter_obj(comm, chunks, root)
    return _stage_out(np.asarray(chunk),
                      sendbuf if comm.rank == root else like)


def scatter_dev(comm, sendbuf, root=0, like=None):
    """One object-channel collective (one tag on every rank): the
    chunk's shape and dtype ride with its data."""
    _device._check_root("scatter", comm, root)
    pvar.record("coll_accelerator_staged")
    n = comm.size
    chunks = None
    if comm.rank == root:
        host = _stage_in(sendbuf)
        if host.ndim < 1 or host.shape[0] % n:
            raise errors.MPIError(
                errors.ERR_COUNT,
                f"scatter: dim 0 of shape {host.shape} not divisible by "
                f"comm size {n}")
        k = host.shape[0] // n
        chunks = [host[r * k:(r + 1) * k] for r in range(n)]
    chunk = comm.coll.scatter_obj(comm, chunks, root)
    return _stage_out(np.asarray(chunk),
                      sendbuf if comm.rank == root else like)


def gather_dev(comm, sendbuf, root=0):
    _device._check_root("gather", comm, root)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    recv = (_host_like((comm.size,) + host.shape, sendbuf.dtype,
                       sendbuf.device) if comm.rank == root else None)
    comm.coll.gather(comm, host, recv, host.size, None, root)
    if comm.rank != root:
        return None
    return _stage_out(recv, sendbuf)


def scan_dev(comm, sendbuf, op=op_mod.SUM, deterministic=None):
    opn = _host_op("scan", op, sendbuf)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    recv = _host_like(host.shape, sendbuf.dtype, sendbuf.device)
    comm.coll.scan(comm, host, recv, host.size, None, opn)
    return _stage_out(recv, sendbuf)


def exscan_dev(comm, sendbuf, op=op_mod.SUM, deterministic=None):
    """Rank 0 gets zeros (MPI leaves it undefined), as coll/device's
    exscan."""
    opn = _host_op("exscan", op, sendbuf)
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    recv = _host_like(host.shape, sendbuf.dtype, sendbuf.device)
    comm.coll.exscan(comm, host, recv, host.size, None, opn)
    if comm.rank == 0:
        recv[...] = 0
    return _stage_out(recv, sendbuf)


def neighbor_allgather_dev(comm, sendbuf):
    """``(n_in, *shape)``: row k is in-neighbour k's ``sendbuf`` (zeros
    for a PROC_NULL row). Every rank passes a buffer of the same shape: a
    receive-only rank's is a template only."""
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    ins = comm.topo.in_neighbors(comm.rank)
    recv = _host_like((len(ins),) + host.shape, sendbuf.dtype,
                      sendbuf.device)
    recv[...] = 0
    comm.coll.neighbor_allgather(comm, host, recv, host.size, None)
    return _stage_out(recv, sendbuf)


def neighbor_alltoall_dev(comm, sendbuf):
    """``sendbuf`` rows are per-out-neighbour blocks (row j to
    out-neighbour j); the result's rows per-in-neighbour (PROC_NULL rows
    zero). Zero-size blocks are a legal empty exchange."""
    pvar.record("coll_accelerator_staged")
    host = _stage_in(sendbuf)
    ins = comm.topo.in_neighbors(comm.rank)
    outs = comm.topo.out_neighbors(comm.rank)
    if host.ndim < 1 or host.shape[0] != len(outs):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"neighbor_alltoall: sendbuf dim 0 of shape {host.shape} != "
            f"out-degree {len(outs)}")
    recv = _host_like((len(ins),) + host.shape[1:], sendbuf.dtype,
                      sendbuf.device)
    recv[...] = 0
    comm.coll.neighbor_alltoall(comm, host, recv, _row(host.shape), None)
    return _stage_out(recv, sendbuf)


def _device_of(obj) -> torch.device:
    """Where a staged request's event records: the first tensor of
    ``obj`` (a buffer, a pytree, a ShardedState's shards), else the
    CPU."""
    from ompi_tpu_torch.zero import layout as zl

    obj = getattr(obj, "shards", obj)
    ts = [t for t in zl.tree_leaves(obj) if isinstance(t, torch.Tensor)]
    return ts[0].device if ts else torch.device("cpu")


def _istaged(fn):
    """The staged nonblocking form: the host collective runs at once
    (staging has nothing asynchronous to wait on), and the result comes
    back in the request coll/device's nonblocking forms return."""
    def islot(comm, buf, *args, **kwargs):
        out = fn(comm, buf, *args, **kwargs)
        return _device.DeviceRequest(out, _device_of(
            (buf, kwargs.get("like"))))
    islot.__name__ = "i" + fn.__name__
    return islot


def _pstaged(fn, name: str):
    """The staged persistent form: every start re-runs the staged call
    on the bound tensors' current contents."""
    def pslot(comm, buf, *args, **kwargs):
        return _device.PersistentDeviceRequest(
            lambda: fn(comm, buf, *args, **kwargs), _device_of(buf))
    pslot.__name__ = name
    return pslot


def ibarrier_dev(comm):
    barrier_dev(comm)
    return _device.DeviceRequest(None, torch.device("cpu"))


def pallreduce_init_dev(comm, bufs, op=op_mod.SUM, deterministic=None):
    """The partitioned fused allreduce staged: Pready bookkeeping, the
    reduction deferred to wait()."""
    return _device._TrivialPartitionedAllreduce(comm, bufs, op,
                                                deterministic)


def preduce_scatter_init_dev(comm, bufs, op=op_mod.SUM, deterministic=None):
    """The partitioned zero/ reduce-scatter staged, as
    :func:`pallreduce_init_dev`."""
    return _device._TrivialPartitionedReduceScatter(comm, bufs, op,
                                                    deterministic)


#: the blocking staged slots
_BLOCKING = {f.__name__: f for f in (
    allreduce_dev, bcast_dev, reduce_dev, allgather_dev, alltoall_dev,
    reduce_scatter_block_dev, scatter_dev, gather_dev, scan_dev,
    exscan_dev, barrier_dev, allgatherv_dev, gatherv_dev, alltoallv_dev,
    scatterv_dev, reduce_scatter_dev, reduce_scatter_multi_dev,
    allgather_multi_dev, allreduce_multi_dev)}
#: the nonblocking staged slots (coll/accelerator.py:403-458)
_NONBLOCKING = {"ibarrier_dev": ibarrier_dev, **{
    "i" + f.__name__: _istaged(f) for f in (
        reduce_scatter_dev, allreduce_dev, bcast_dev, reduce_dev,
        allgather_dev, gather_dev, alltoall_dev, reduce_scatter_block_dev,
        scatter_dev, scan_dev, exscan_dev, allgatherv_dev, gatherv_dev,
        alltoallv_dev, scatterv_dev)}}
#: the persistent staged slots
_PERSISTENT = {
    **{name: _pstaged(fn, name) for name, fn in (
        ("allreduce_multi_init_dev", allreduce_multi_dev),
        ("reduce_scatter_multi_init_dev", reduce_scatter_multi_dev),
        ("allgather_multi_init_dev", allgather_multi_dev),
        ("allreduce_init_dev", allreduce_dev),
        ("bcast_init_dev", bcast_dev),
        ("allgather_init_dev", allgather_dev),
        ("alltoall_init_dev", alltoall_dev),
        ("reduce_scatter_block_init_dev", reduce_scatter_block_dev))},
    "pallreduce_init_dev": pallreduce_init_dev,
    "preduce_scatter_init_dev": preduce_scatter_init_dev}


class CollAccelerator(registry.Component):
    """The component comm_select ranks."""

    NAME = "accelerator"
    PRIORITY = 40  # above tuned (30): takes the device slots

    def query(self, comm) -> int:
        return self.PRIORITY

    def slots(self, comm):
        nbr = {} if getattr(comm, "topo", None) is None else {
            "neighbor_allgather_dev": neighbor_allgather_dev,
            "neighbor_alltoall_dev": neighbor_alltoall_dev}
        return {**_BLOCKING, **_NONBLOCKING, **_PERSISTENT, **nbr}
