"""coll/device — the bucketed ZeRO collectives on the device plane.

The port's counterpart of ``ompi_tpu.coll.xla`` (priority 50, one level
below coll/cuda), reduced in this slice to coll/xla's zero/ bucket slots
(coll/xla.py:1668-1985): ``reduce_scatter_multi_dev`` (one reduce-scatter
of each padded flat bucket), ``allgather_multi_dev`` and
``allgather_multi_bucket_dev``. Each bucket runs through coll/cuda's
arena schedules (:mod:`ompi_tpu_torch.coll.cuda_kernels`) over the same
per-comm arenas: ``deterministic='linear'`` folds in rank order and
slices the own chunk (K3), otherwise the clockwise ring (K1); the
allgather is the clockwise ring (K2). The bucket size is
``coll_device_bucket_bytes`` (coll/xla's ``coll_xla_bucket_bytes``).

Like coll/xla it needs no opt-in: it qualifies whenever the device plane
is active and the comm has more than one rank. The rest of coll/xla
(Bcast, Alltoall, NCCL where one rank owns each card) is the slice after
this one; until then a dtype or op outside the kernels' support raises
``MPIError(ERR_NOT_SUPPORTED)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll import cuda as _cuda
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.runtime import device_plane

bucket_var = cvar.register(
    "coll_device_bucket_bytes", 4 << 20, int,
    help="target flat-bucket size of the zero/ scatter-gather pair "
         "(Reduce_scatter_multi / Allgather_multi, whose ZeroPlan pads "
         "each bucket to a multiple of the comm size): same-dtype "
         "buffers coalesce into flat buckets that close once they reach "
         "this many bytes, one collective per bucket. 0 fuses each dtype "
         "into a single bucket.", level=5)


def _check_leaf(kind: str, t) -> None:
    dev = device_plane.device()
    if not isinstance(t, torch.Tensor) or t.device.type != dev.type or (
            dev.type == "cuda" and t.device.index != dev.index):
        raise errors.MPIError(
            errors.ERR_BUFFER,
            f"coll_device: {kind} buffer "
            f"{getattr(t, 'device', type(t).__name__)} is not a tensor on "
            f"this rank's device {dev}")
    if t.dtype not in _cuda._SUPPORTED_DTYPES:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: {kind} of {t.dtype} (the kernels take float32, "
            "bfloat16 and int32; other dtypes come with the rest of the "
            "coll/xla counterpart)")


def reduce_scatter_multi_dev(comm, bufs, op=op_mod.SUM,
                             deterministic: Optional[str] = None):
    """Bucketed reduce-scatter over a pytree of device tensors (the ZeRO
    gradient-sharding step): dtype-segregated flat buckets padded to a
    multiple of the comm size, one reduce-scatter per bucket, returning
    this rank's ShardedState. ``'linear'`` is bit-identical to the
    per-buffer allreduce fold."""
    from ompi_tpu_torch.zero import layout as zl

    det = _cuda._det_ok(deterministic)
    opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
    if opn is None:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: reduce_scatter_multi op {op!r} is outside "
            "SUM/PROD/MIN/MAX")
    if comm.size == 1:
        # reducing over one rank is the identity: a local pack + slice
        return zl.ShardedState.from_full(comm, bufs)
    leaves, treedef = zl.tree_flatten(bufs)
    for t in leaves:
        _check_leaf("reduce_scatter_multi", t)
    metas = zl._fuse_metas(leaves)
    plan = zl.ZeroPlan(metas, int(bucket_var.get()), comm.size)
    algo = "linear" if det == "linear" else "ring"
    shards = []
    for b, idxs in enumerate(plan.buckets):
        flat = zl.pack(leaves, idxs, plan.padded[b] - plan.elems[b])
        out = flat.new_empty(plan.shard_elems[b])
        ep = _cuda._arena(comm, "rs", flat.numel() * flat.element_size())
        ep.run(K.reduce_scatter(ep, flat, opn.name, algo, 1, out))
        shards.append(out)
        pvar.record("zero_rs_launches")
    pvar.record("zero_fused_bytes", plan.nbytes)
    pvar.record("zero_pad_bytes", plan.pad_bytes)
    return zl.ShardedState(plan, metas, treedef, shards, comm.rank,
                           comm.size)


def _zero_state_check(comm, state) -> None:
    """Erroneous-call validation of the allgather direction
    (coll/xla.py:1830-1861)."""
    from ompi_tpu_torch.zero import layout as zl

    if not isinstance(state, zl.ShardedState):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"Allgather_multi: operand is {type(state).__name__}, "
            "expected a ShardedState (the Reduce_scatter_multi / "
            "ShardedState.from_full result)")
    if state.n != comm.size:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"Allgather_multi: state sharded {state.n} ways on a "
            f"size-{comm.size} communicator")
    if len(state.shards) != len(state.plan.buckets):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"Allgather_multi: {len(state.shards)} shards for "
            f"{len(state.plan.buckets)} plan buckets")
    for b, s in enumerate(state.shards):
        k = state.plan.shard_elems[b]
        if tuple(s.shape) != (k,) \
                or zl.dtype_name(s.dtype) != state.plan.dtypes[b]:
            raise errors.MPIError(
                errors.ERR_COUNT,
                f"Allgather_multi: bucket {b} shard is "
                f"{tuple(s.shape)}/{s.dtype}, plan expects "
                f"({k},)/{state.plan.dtypes[b]} (shard-wise updates "
                "must preserve shape and dtype)")


def _gather_bucket(comm, state, b: int):
    from ompi_tpu_torch.zero import layout as zl

    shard = state.shards[b]
    _check_leaf("allgather_multi", shard)
    full = shard.new_empty(state.plan.padded[b])
    ep = _cuda._arena(comm, "ag", shard.numel() * shard.element_size())
    ep.run(K.allgather(ep, shard, "ring", full))
    pvar.record("zero_ag_launches")
    return zl.split(full, state.metas, state.plan.buckets[b])


def allgather_multi_dev(comm, state):
    """Bucketed allgather of a ShardedState back to the full pytree (the
    ZeRO parameter-rebuild step): one allgather per bucket, rank-order
    concat (= the pack order), pad dropped, leaf shapes restored."""
    from ompi_tpu_torch.zero import layout as zl

    _zero_state_check(comm, state)
    if not state.shards:
        return zl.tree_unflatten(state.treedef, [])
    if comm.size == 1:
        # n=1 shards ARE the full padded buckets
        return state.unpack(state.shards)
    outs = [None] * sum(len(idxs) for idxs in state.plan.buckets)
    for b, idxs in enumerate(state.plan.buckets):
        for i, leaf in zip(idxs, _gather_bucket(comm, state, b)):
            outs[i] = leaf
    pvar.record("zero_fused_bytes", state.plan.nbytes)
    return zl.tree_unflatten(state.treedef, outs)


def allgather_multi_bucket_dev(comm, state, b: int):
    """Gather ONE bucket of a ShardedState: its member leaves in
    ``plan.buckets[b]`` order (the form ZeroOptimizer's frozen-bucket
    skip uses; ``zero_ag_skipped`` is counted by the caller)."""
    from ompi_tpu_torch.zero import layout as zl

    _zero_state_check(comm, state)
    if not 0 <= b < len(state.plan.buckets):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"allgather_multi_bucket: bucket {b} out of range for a "
            f"{len(state.plan.buckets)}-bucket plan")
    if comm.size == 1:
        return zl.split(state.shards[b], state.metas,
                        state.plan.buckets[b])
    return _gather_bucket(comm, state, b)


class CollDevice:
    """The component comm_select ranks."""

    NAME = "device"
    PRIORITY = 50  # coll/xla's level, below coll/cuda's 60

    def query(self, comm) -> int:
        if comm.size == 1 or not device_plane.active():
            return -1
        return self.PRIORITY

    def slots(self, comm):
        return {
            "reduce_scatter_multi_dev": reduce_scatter_multi_dev,
            "allgather_multi_dev": allgather_multi_dev,
            "allgather_multi_bucket_dev": allgather_multi_bucket_dev,
        }
