"""coll/device — the device-plane collectives below coll/cuda.

The port's counterpart of ``ompi_tpu.coll.xla`` (priority 50, one level
below coll/cuda, no opt-in). Its slots:

- the BASELINE slots (coll/xla.py:415-833): ``allreduce_dev``,
  ``reduce_scatter_block_dev`` (``deterministic=''|'ring'|'linear'``,
  default ``coll_device_deterministic``), ``allgather_dev``,
  ``bcast_dev`` and ``alltoall_dev``;
- the zero/ bucket slots (coll/xla.py:1668-1985):
  ``reduce_scatter_multi_dev`` (one reduce-scatter of each padded flat
  bucket), ``allgather_multi_dev`` and ``allgather_multi_bucket_dev``;
  the bucket size is ``coll_device_bucket_bytes`` (coll/xla's
  ``coll_xla_bucket_bytes``).

Everything runs over coll/cuda's per-comm arenas (the transport
coll/xla's ``_Ctx`` is to the reference), every byte moved by a
hand-written kernel (:mod:`ompi_tpu_torch.coll.cuda_kernels`): a
reduction the kernels take (float32, bfloat16, int32 x SUM, PROD, MIN,
MAX) folds in rank order under ``'linear'`` (K3) and runs the clockwise
ring otherwise (K1 + K2); ``bcast``, ``alltoall`` and ``allgather`` (the
zero/ bucket gathers too: coll/device has one allgather schedule) are
pull schedules (every rank stages, then K2 copies from the staged
inputs). Any other traceable op (coll/xla's ``_TRACEABLE_OPS``: LAND,
LOR, LXOR, BAND, BOR, BXOR too) on any other dtype gathers the inputs
with the pull schedule and folds them on the device with torch
elementwise ops (:data:`_FOLD`): in rank order for ``'linear'`` and
``''`` (the reference's ``_allreduce_linear``), in the ring's order per
chunk for ``'ring'`` (its ``ring_allreduce``, zero pad included), so the
bits equal the reference's. Logical ops fold as bool and cast back.

A one-rank comm needs no device plane: every slot returns a new tensor
(a clone; ``allgather_dev`` one with a leading axis of 1) on the
tensor's own device and touches no arena. The reference returns its
input there; a torch tensor is mutable, a jax array is not.

Still ``MPIError(ERR_NOT_SUPPORTED)``: ops that are not traceable
(MINLOC, MAXLOC, REPLACE, NO_OP; the reference stages them through the
host plane, ROADMAP queue 1 item 2) and dtypes a jax array does not hold
with 64-bit mode off (float64, int64, uint64, complex), which the
reference only meets as host buffers.
"""

from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll import cuda as _cuda
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.runtime import device_plane

_default_det = cvar.register(
    "coll_device_deterministic", "", str,
    help="default determinism mode of the device reductions, read by "
         "coll/device and coll/cuda alike: '' (each component's own "
         "choice), 'ring' (fixed ring chunk order), 'linear' (exact "
         "rank-order fold, bit-identical to the host linear fold)",
    choices=["", "ring", "linear"], level=4)

bucket_var = cvar.register(
    "coll_device_bucket_bytes", 4 << 20, int,
    help="target flat-bucket size of the zero/ scatter-gather pair "
         "(Reduce_scatter_multi / Allgather_multi, whose ZeroPlan pads "
         "each bucket to a multiple of the comm size): same-dtype "
         "buffers coalesce into flat buckets that close once they reach "
         "this many bytes, one collective per bucket. 0 fuses each dtype "
         "into a single bucket.", level=5)


def _det_ok(deterministic: Optional[str]) -> Optional[str]:
    """The slot's mode over the cvar default (coll/xla.py ``_det``);
    anything but None, '', 'ring' or 'linear' raises ERR_ARG."""
    det = deterministic if deterministic is not None \
        else _default_det.get()
    det = det or None
    if det not in (None, "ring", "linear"):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"coll_device: deterministic={det!r} (expected None, 'ring' or "
            "'linear' — anything else would void the fixed-reduction-"
            "order guarantee)")
    return det


#: dtypes a jax array does not hold with 64-bit mode off
_HOST_ONLY = frozenset((torch.float64, torch.int64, torch.uint64,
                        torch.complex32, torch.complex64, torch.complex128))


def _check_buf(kind: str, comm, t) -> None:
    """A tensor on this rank's device (any device on a one-rank comm,
    which needs no plane) of a dtype the device path holds."""
    if not isinstance(t, torch.Tensor):
        raise errors.MPIError(
            errors.ERR_BUFFER,
            f"coll_device: {kind} buffer is a {type(t).__name__}, not a "
            "torch.Tensor")
    if comm.size > 1:
        dev = device_plane.device()
        if t.device.type != dev.type or (
                dev.type == "cuda" and t.device.index != dev.index):
            raise errors.MPIError(
                errors.ERR_BUFFER,
                f"coll_device: {kind} buffer on {t.device} is not on this "
                f"rank's device {dev}")
    if t.dtype in _HOST_ONLY:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: {kind} of {t.dtype}, which a jax array does not "
            "hold with 64-bit mode off: the reference meets it only as a "
            "host buffer (the host plane, ROADMAP queue 1 item 2)")


def _check_leaf(kind: str, comm, t) -> None:
    """A zero/ bucket leaf: as :func:`_check_buf`, of a kernel dtype."""
    _check_buf(kind, comm, t)
    if t.dtype not in _cuda._SUPPORTED_DTYPES:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: {kind} of {t.dtype} (the bucket kernels take "
            "float32, bfloat16 and int32)")


# ---------------------------------------------------------------------------
# the fold of the gathered inputs (what the reference leaves to XLA)


def _minmax(a: torch.Tensor, b: torch.Tensor, is_min: bool):
    """jnp.minimum / jnp.maximum: a NaN operand propagates (the first
    one, where both are), and -0 orders below +0."""
    if not a.is_floating_point():
        return torch.minimum(a, b) if is_min else torch.maximum(a, b)
    pick_a = (a < b) if is_min else (a > b)
    tie = (a == b) & (torch.signbit(a) if is_min else ~torch.signbit(a))
    r = torch.where(pick_a | tie, a, b)
    r = torch.where(torch.isnan(b), b, r)
    return torch.where(torch.isnan(a), a, r)


#: coll/xla's traceable ops (``_TRACEABLE_OPS``) as torch elementwise ops
#: (parallel/collectives.py ``_JNP_FN``)
_FOLD = {
    "MPI_SUM": torch.add,
    "MPI_PROD": torch.mul,
    "MPI_MIN": lambda a, b: _minmax(a, b, True),
    "MPI_MAX": lambda a, b: _minmax(a, b, False),
    "MPI_LAND": torch.logical_and,
    "MPI_LOR": torch.logical_or,
    "MPI_LXOR": torch.logical_xor,
    "MPI_BAND": torch.bitwise_and,
    "MPI_BOR": torch.bitwise_or,
    "MPI_BXOR": torch.bitwise_xor,
}
_LOGICAL = frozenset(("MPI_LAND", "MPI_LOR", "MPI_LXOR"))
_BITWISE = frozenset(("MPI_BAND", "MPI_BOR", "MPI_BXOR"))


def _opn(kind: str, op, dtype) -> op_mod.Op:
    """The op, if coll/xla would trace it for this dtype."""
    opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
    if opn is None or opn.name not in _FOLD:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: {kind} op {getattr(opn, 'name', op)!r} is not "
            "traceable: the reference stages it through the host plane "
            "(ROADMAP queue 1 item 2)")
    if opn.name in _BITWISE and dtype.is_floating_point:
        raise errors.MPIError(
            errors.ERR_OP,
            f"coll_device: {kind} {opn.name} of {dtype}: bitwise ops take "
            "integers and bool")
    return opn


def _kernels_take(dtype, opn: op_mod.Op) -> bool:
    return dtype in _cuda._SUPPORTED_DTYPES and opn.name in K.OP_CODES


def _fold(rows, opn: op_mod.Op, dtype) -> torch.Tensor:
    """Fold the operands in list order, ``acc = fn(acc, x)``; logical ops
    on their truth values, cast back to ``dtype``."""
    fn = _FOLD[opn.name]
    if opn.name in _LOGICAL:
        rows = [x.bool() for x in rows]
    acc = rows[0]
    for x in rows[1:]:
        acc = fn(acc, x)
    return acc.to(dtype)


def _pull(comm, schedule, flat: torch.Tensor, out: torch.Tensor, *args):
    """Run one pull schedule of cuda_kernels over the comm's arena for
    ``flat``'s bytes."""
    ep = _cuda._arena(comm, "pull", flat.nbytes)
    ep.run(schedule(ep, flat, *args, out))
    return out


# ---------------------------------------------------------------------------
# the BASELINE slots (coll/xla.py:415-833)


def allreduce_dev(comm, sendbuf, op=op_mod.SUM,
                  deterministic: Optional[str] = None):
    det = _det_ok(deterministic)
    _check_buf("allreduce", comm, sendbuf)
    opn = _opn("allreduce", op, sendbuf.dtype)
    pvar.record("coll_device_launches")
    n, m = comm.size, sendbuf.numel()
    if n == 1 or m == 0:
        return sendbuf.clone()
    flat = sendbuf.reshape(-1)
    k = K.padded_chunk(m, n)
    if _kernels_take(sendbuf.dtype, opn):
        out = flat.new_empty(n * k)
        ep = _cuda._arena(comm, "rs", out.nbytes)
        ep.run(K.allreduce(ep, flat, opn.name,
                           "linear" if det == "linear" else "ring", out))
        return out[:m].view(sendbuf.shape)
    g = _pull(comm, K.gather, flat, flat.new_empty(n * m)).view(n, m)
    if det != "ring":  # the reference's _allreduce_linear
        return _fold(list(g), opn, sendbuf.dtype).view(sendbuf.shape)
    # ring_allreduce: chunk c of the zero-padded input folds ranks
    # c+1, ..., c; step i takes rank (c+1+i) % n's chunk c for every c
    g = torch.nn.functional.pad(g, (0, n * k - m)).view(n, n, k)
    chunks = torch.arange(n, device=g.device)
    rows = [g[(chunks + 1 + i) % n, chunks] for i in range(n)]
    return _fold(rows, opn, sendbuf.dtype).reshape(-1)[:m].view(
        sendbuf.shape)


def reduce_scatter_block_dev(comm, sendbuf, op=op_mod.SUM,
                             deterministic: Optional[str] = None):
    det = _det_ok(deterministic)
    _check_buf("reduce_scatter_block", comm, sendbuf)
    opn = _opn("reduce_scatter_block", op, sendbuf.dtype)
    n, r = comm.size, comm.rank
    if n > 1 and (sendbuf.dim() < 1 or sendbuf.shape[0] % n):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"reduce_scatter_block: dim 0 of shape {tuple(sendbuf.shape)} "
            f"is not divisible by the comm size {n}")
    pvar.record("coll_device_launches")
    if n == 1:
        return sendbuf.clone()
    rows = sendbuf.shape[0] // n
    out = sendbuf.new_empty((rows,) + tuple(sendbuf.shape[1:]))
    if out.numel() == 0:
        return out
    flat = sendbuf.reshape(-1)
    if _kernels_take(sendbuf.dtype, opn):
        ep = _cuda._arena(comm, "rs", flat.nbytes)
        ep.run(K.reduce_scatter(ep, flat, opn.name,
                                "linear" if det == "linear" else "ring",
                                out.numel() // rows, out.view(-1)))
        return out
    # every rank's chunk r (an all-to-all), folded in rank order or, for
    # 'ring', in ring_reduce_scatter's order: ranks r+1, ..., r
    a = _pull(comm, K.alltoall, flat, flat.new_empty(flat.numel()))
    a = a.view(n, out.numel())
    order = [(r + 1 + i) % n for i in range(n)] if det == "ring" \
        else range(n)
    return _fold([a[p] for p in order], opn, sendbuf.dtype).view(out.shape)


def allgather_dev(comm, sendbuf):
    """``(n, *shape)``, rank i's block at i."""
    _check_buf("allgather", comm, sendbuf)
    pvar.record("coll_device_launches")
    n = comm.size
    if n == 1:
        return sendbuf.unsqueeze(0).clone()
    out = sendbuf.new_empty((n,) + tuple(sendbuf.shape))
    if sendbuf.numel() == 0:
        return out
    _pull(comm, K.gather, sendbuf.reshape(-1), out.view(-1))
    return out


def bcast_dev(comm, buf, root: int = 0):
    """The root's ``buf`` on every rank (the others' ``buf`` gives only
    the shape and dtype)."""
    _check_buf("bcast", comm, buf)
    if not isinstance(root, int) or not 0 <= root < comm.size:
        raise errors.MPIError(
            errors.ERR_ROOT,
            f"bcast: root {root!r} outside [0, {comm.size})")
    pvar.record("coll_device_launches")
    if comm.size == 1 or buf.numel() == 0:
        return buf.clone()
    out = buf.new_empty(buf.shape)
    _pull(comm, K.bcast, buf.reshape(-1), out.view(-1), root)
    return out


def alltoall_dev(comm, sendbuf):
    """Dim 0 splits into n blocks; block p of the result is block
    ``rank`` of rank p's input."""
    _check_buf("alltoall", comm, sendbuf)
    n = comm.size
    if n > 1 and (sendbuf.dim() < 1 or sendbuf.shape[0] % n):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"alltoall: dim 0 of shape {tuple(sendbuf.shape)} is not "
            f"divisible by the comm size {n}")
    pvar.record("coll_device_launches")
    if n == 1 or sendbuf.numel() == 0:
        return sendbuf.clone()
    out = sendbuf.new_empty(sendbuf.shape)
    _pull(comm, K.alltoall, sendbuf.reshape(-1), out.view(-1))
    return out


# ---------------------------------------------------------------------------
# the zero/ bucket slots (coll/xla.py:1668-1985)


def reduce_scatter_multi_dev(comm, bufs, op=op_mod.SUM,
                             deterministic: Optional[str] = None):
    """Bucketed reduce-scatter over a pytree of device tensors (the ZeRO
    gradient-sharding step): dtype-segregated flat buckets padded to a
    multiple of the comm size, one reduce-scatter per bucket, returning
    this rank's ShardedState. ``'linear'`` is bit-identical to the
    per-buffer allreduce fold."""
    from ompi_tpu_torch.zero import layout as zl

    det = _det_ok(deterministic)
    opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
    if opn is None or opn.name not in K.OP_CODES:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: reduce_scatter_multi op {op!r} is outside "
            "SUM/PROD/MIN/MAX")
    if comm.size == 1:
        # reducing over one rank is the identity: a local pack + slice
        return zl.ShardedState.from_full(comm, bufs)
    leaves, treedef = zl.tree_flatten(bufs)
    for t in leaves:
        _check_leaf("reduce_scatter_multi", comm, t)
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
    _check_leaf("allgather_multi", comm, shard)
    full = _pull(comm, K.gather, shard, shard.new_empty(state.plan.padded[b]))
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
        if comm.size == 1:
            return self.PRIORITY  # the local path: no plane needed
        if not device_plane.active():
            return -1
        return self.PRIORITY

    def slots(self, comm):
        return {
            "allreduce_dev": allreduce_dev,
            "reduce_scatter_block_dev": reduce_scatter_block_dev,
            "allgather_dev": allgather_dev,
            "bcast_dev": bcast_dev,
            "alltoall_dev": alltoall_dev,
            "reduce_scatter_multi_dev": reduce_scatter_multi_dev,
            "allgather_multi_dev": allgather_multi_dev,
            "allgather_multi_bucket_dev": allgather_multi_bucket_dev,
        }
