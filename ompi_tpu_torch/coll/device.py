"""coll/device — the device-plane collectives below coll/cuda.

The port's counterpart of ``ompi_tpu.coll.xla`` (priority 50, one level
below coll/cuda, no opt-in), with every fixed slot of its table
(coll/xla.py:2723-2784):

- the BASELINE slots (coll/xla.py:415-833): ``allreduce_dev``,
  ``reduce_scatter_block_dev`` (``deterministic=''|'ring'|'linear'``,
  default ``coll_device_deterministic``), ``allgather_dev``,
  ``bcast_dev`` and ``alltoall_dev``;
- the rooted and v-collectives (coll/xla.py:477-1185): ``reduce_dev``,
  ``gather_dev`` (at or above ``coll_device_rooted_threshold_bytes`` of
  result a root-collecting schedule, so a non-root allocates O(bytes)),
  ``scatter_dev`` / ``scatterv_dev`` (a non-root's shape from ``like`` or
  one metadata round per (comm, root), always cached),
  ``allgatherv_dev``, ``gatherv_dev``, ``alltoallv_dev`` and
  ``reduce_scatter_dev``; ``scan_dev`` / ``exscan_dev``; ``barrier_dev``;
- ``allreduce_multi_dev`` (coll/xla.py:1241-1409): dtype-segregated flat
  buckets of ``coll_device_bucket_bytes``, one allreduce each;
- the nonblocking forms (15 ``i*_dev`` and ``ibarrier_dev``,
  :class:`DeviceRequest`) and the persistent ``allreduce_init_dev``,
  ``bcast_init_dev``, ``allgather_init_dev``, ``alltoall_init_dev``,
  ``reduce_scatter_block_init_dev`` and ``allreduce_multi_init_dev``
  (:class:`PersistentDeviceRequest`);
- the zero/ bucket slots (coll/xla.py:1668-1985):
  ``reduce_scatter_multi_dev`` (one reduce-scatter of each padded flat
  bucket), ``allgather_multi_dev`` and ``allgather_multi_bucket_dev``.

Everything runs over coll/cuda's per-comm arenas (the transport
coll/xla's ``_Ctx`` is to the reference), every byte moved by a
hand-written kernel (:mod:`ompi_tpu_torch.coll.cuda_kernels`): a
reduction the kernels take (float32, bfloat16, int32 x SUM, PROD, MIN,
MAX) folds in rank order under ``'linear'`` (K3) and runs the clockwise
ring otherwise (K1 + K2); the copies are pull schedules (every rank
stages, then K2 copies from the staged inputs: one allgather schedule for
Allgather and the zero/ bucket gathers, ragged pulls at per-peer offsets
for the v-collectives). Any other traceable op (coll/xla's
``_TRACEABLE_OPS``: LAND, LOR, LXOR, BAND, BOR, BXOR too) on any other
dtype gathers the inputs with the pull schedule and folds them on the
device with torch elementwise ops (:data:`_FOLD`): in rank order for
``'linear'`` and ``''`` (the reference's ``_allreduce_linear``), in the
ring's order per chunk for ``'ring'`` (its ``ring_allreduce``, zero pad
included), so the bits equal the reference's. Logical ops fold as bool
and cast back.

Where the port does something another way, and why:

- coll/xla compiles one program per (slot, shape, dtype); the port plans
  a schedule over an arena. A persistent request plans and maps at init
  and runs on the bound tensors' current contents at each start (a
  torch tensor is mutable; a jax array is not).
- Rooted SUM reduces with the ring's reduce-scatter (the reference's
  psum_scatter: bits within rounding, not equal), then the root pulls
  the chunks in one step (the reference: n-1 ppermute rounds); a rooted
  gather is one pull, and gatherv pulls on the root alone (the reference
  drops an allgatherv on the non-roots). The binomial tree keeps the
  reference's rounds, pairs and operand order, so its bits match.
- Alltoallv pads nothing (see :func:`alltoallv_dev`), so the
  reference's pad factor and its host fallback have no counterpart; its
  count round runs at every call without ``max_count`` (no signature
  cache: ``max_count`` is the way to skip it), and lets every rank see
  rcounts that disagree with the peers' scounts, so all raise ERR_COUNT.
- The scatter metadata round is always cached (the reference's default;
  its switch ``coll_xla_scatter_meta_cache`` has no counterpart).
- Scatter / Scatterv non-roots allocate their chunk only (the reference
  stages a zero buffer of the root's shape for its SPMD program).
- A root outside the comm raises ERR_ROOT (the reference indexes with
  it); a ``counts`` of the wrong length or a buffer too short for its
  counts raises ERR_COUNT.
- Nonblocking calls run their host steps inside the call
  (:class:`DeviceRequest`).

A one-rank comm needs no device plane: every slot returns a new tensor
(a clone; ``allgather_dev`` one with a leading axis of 1; ``exscan_dev``
zeros) on the tensor's own device and touches no arena. The reference
returns its input there; a torch tensor is mutable, a jax array is not.

Still ``MPIError(ERR_NOT_SUPPORTED)``: ops that are not traceable
(MINLOC, MAXLOC, REPLACE, NO_OP; the reference stages them through the
host collectives, ROADMAP queue 1 item 4) and dtypes a jax array does not hold
with 64-bit mode off (float64, int64, uint64, complex), which the
reference only meets as host buffers.
"""
from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.accelerator import stream
from ompi_tpu_torch.coll import cuda as _cuda
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.pml import request as rq
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
    help="target flat-bucket size of the fused device collectives: "
         "Allreduce_multi and the zero/ scatter-gather pair "
         "(Reduce_scatter_multi / Allgather_multi, whose ZeroPlan pads "
         "each bucket to a multiple of the comm size): same-dtype "
         "buffers coalesce into flat buckets that close once they reach "
         "this many bytes, one collective per bucket. 0 fuses each dtype "
         "into a single bucket.", level=5)

_rooted_var = cvar.register(
    "coll_device_rooted_threshold_bytes", 1 << 20, int,
    help="Reduce and Gather switch to a root-collecting schedule when the "
         "would-be-replicated result (n x bytes) reaches this size: below "
         "it every rank computes the allreduce / allgather; at or above "
         "it Reduce reduce-scatters and the root pulls the chunks (SUM) "
         "or runs the binomial tree (other ops), and Gather lets the root "
         "alone pull, so a non-root allocates O(bytes), not O(n x bytes). "
         "0 forces the rooted schedules; -1 disables them (coll/xla's "
         "coll_xla_rooted_threshold_bytes).", level=5)

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
            "host buffer (the host collectives, ROADMAP queue 1 item 4)")


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
            "traceable: the reference stages it through the host "
            "collectives (ROADMAP queue 1 item 4)")
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


def _ragged(comm, dtype, staged: int, pieces, spans, out) -> None:
    """Run :func:`cuda_kernels.ragged` over the comm's pull arena for a
    staged input of ``staged`` elements (every rank passes the same
    count, so every rank maps the same size class); nothing when every
    rank stages nothing."""
    if staged:
        ep = _cuda._arena(comm, "pull", staged * dtype.itemsize)
        ep.run(K.ragged(ep, dtype, pieces, spans, out))


def _launcher(fn):
    """A prepared call: each run counts in ``coll_device_launches``."""
    def launch():
        pvar.record("coll_device_launches")
        return fn()
    return launch


def _check_root(kind: str, comm, root) -> None:
    if not isinstance(root, int) or not 0 <= root < comm.size:
        raise errors.MPIError(
            errors.ERR_ROOT,
            f"{kind}: root {root!r} outside [0, {comm.size})")


def _zero_pad(flat: torch.Tensor, total: int) -> torch.Tensor:
    if flat.numel() == total:
        return flat
    return torch.cat([flat, flat.new_zeros(total - flat.numel())])


def _counts(counts, what: str, n: int):
    counts = tuple(int(c) for c in counts)
    if len(counts) != n:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"{what}: {len(counts)} counts for {n} ranks")
    if any(c < 0 for c in counts):
        raise errors.MPIError(errors.ERR_COUNT,
                              f"{what}: negative count in {counts}")
    return counts


def _offsets(counts):
    offs, o = [], 0
    for c in counts:
        offs.append(o)
        o += c
    return offs


def _row_elems(shape) -> int:
    k = 1
    for s in shape:
        k *= int(s)
    return k


# ---------------------------------------------------------------------------
# the reduction and copy schedules, planned once (the persistent requests
# plan at init and run at every start)


def _allreduce_run(comm, m: int, dtype, opn: op_mod.Op, det):
    """``run(flat)``: this rank's m-element allreduce of the 1-D ``flat``
    (n > 1, m > 0); the arena is mapped now."""
    n = comm.size
    k = K.padded_chunk(m, n)
    if _kernels_take(dtype, opn):
        algo = "linear" if det == "linear" else "ring"
        ep = _cuda._arena(comm, "rs", n * k * dtype.itemsize)

        def run(flat):
            out = flat.new_empty(n * k)
            ep.run(K.allreduce(ep, flat, opn.name, algo, out))
            return out[:m]
        return run
    ep = _cuda._arena(comm, "pull", m * dtype.itemsize)

    def run(flat):
        g = flat.new_empty(n * m)
        ep.run(K.gather(ep, flat, g))
        g = g.view(n, m)
        if det != "ring":  # the reference's _allreduce_linear
            return _fold(list(g), opn, dtype)
        # ring_allreduce: chunk c of the zero-padded input folds ranks
        # c+1, ..., c; step i takes rank (c+1+i) % n's chunk c for every c
        g = torch.cat([g, g.new_zeros(n, n * k - m)], 1).view(n, n, k)
        chunks = torch.arange(n, device=g.device)
        rows = [g[(chunks + 1 + i) % n, chunks] for i in range(n)]
        return _fold(rows, opn, dtype).reshape(-1)[:m]
    return run


def _reduce_scatter_run(comm, m: int, dtype, opn: op_mod.Op, det):
    """``run(flat)``: chunk ``rank`` (k = padded_chunk(m, n) elements) of
    the reduce-scatter of the 1-D m-element ``flat``, zero-padded to n
    chunks (n > 1, m > 0)."""
    n, r = comm.size, comm.rank
    k = K.padded_chunk(m, n)
    if _kernels_take(dtype, opn):
        algo = "linear" if det == "linear" else "ring"
        ep = _cuda._arena(comm, "rs", n * k * dtype.itemsize)

        def run(flat):
            out = flat.new_empty(k)
            ep.run(K.reduce_scatter(ep, flat, opn.name, algo, 1, out))
            return out
        return run
    # every rank's chunk r (an all-to-all), folded in rank order or, for
    # 'ring', in ring_reduce_scatter's order: ranks r+1, ..., r
    ep = _cuda._arena(comm, "pull", n * k * dtype.itemsize)
    order = [(r + 1 + i) % n for i in range(n)] if det == "ring" \
        else range(n)

    def run(flat):
        flat = _zero_pad(flat, n * k)
        a = flat.new_empty(n * k)
        ep.run(K.alltoall(ep, flat, a))
        a = a.view(n, k)
        return _fold([a[p] for p in order], opn, dtype)
    return run


# ---------------------------------------------------------------------------
# the BASELINE slots (coll/xla.py:415-833), each a prep (checks, plan,
# arena) whose launcher the blocking slot runs at once


def _allreduce_prep(comm, sendbuf, op=op_mod.SUM,
                    deterministic: Optional[str] = None):
    det = _det_ok(deterministic)
    _check_buf("allreduce", comm, sendbuf)
    opn = _opn("allreduce", op, sendbuf.dtype)
    n, m = comm.size, sendbuf.numel()
    if n == 1 or m == 0:
        return _launcher(sendbuf.clone)
    run = _allreduce_run(comm, m, sendbuf.dtype, opn, det)
    return _launcher(lambda: run(sendbuf.reshape(-1)).view(sendbuf.shape))


def allreduce_dev(comm, sendbuf, op=op_mod.SUM,
                  deterministic: Optional[str] = None):
    return _allreduce_prep(comm, sendbuf, op, deterministic)()


def _reduce_scatter_block_prep(comm, sendbuf, op=op_mod.SUM,
                               deterministic: Optional[str] = None):
    det = _det_ok(deterministic)
    _check_buf("reduce_scatter_block", comm, sendbuf)
    opn = _opn("reduce_scatter_block", op, sendbuf.dtype)
    n = comm.size
    if n > 1 and (sendbuf.dim() < 1 or sendbuf.shape[0] % n):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"reduce_scatter_block: dim 0 of shape {tuple(sendbuf.shape)} "
            f"is not divisible by the comm size {n}")
    if n == 1:
        return _launcher(sendbuf.clone)
    shape = (sendbuf.shape[0] // n,) + tuple(sendbuf.shape[1:])
    if sendbuf.numel() == 0:
        return _launcher(lambda: sendbuf.new_empty(shape))
    run = _reduce_scatter_run(comm, sendbuf.numel(), sendbuf.dtype, opn,
                              det)
    return _launcher(lambda: run(sendbuf.reshape(-1)).view(shape))


def reduce_scatter_block_dev(comm, sendbuf, op=op_mod.SUM,
                             deterministic: Optional[str] = None):
    return _reduce_scatter_block_prep(comm, sendbuf, op, deterministic)()


def _allgather_prep(comm, sendbuf):
    _check_buf("allgather", comm, sendbuf)
    n = comm.size
    if n == 1:
        return _launcher(lambda: sendbuf.unsqueeze(0).clone())
    shape = (n,) + tuple(sendbuf.shape)
    if sendbuf.numel() == 0:
        return _launcher(lambda: sendbuf.new_empty(shape))
    ep = _cuda._arena(comm, "pull", sendbuf.nbytes)

    def launch():
        out = sendbuf.new_empty(shape)
        ep.run(K.gather(ep, sendbuf.reshape(-1), out.view(-1)))
        return out
    return _launcher(launch)


def allgather_dev(comm, sendbuf):
    """``(n, *shape)``, rank i's block at i."""
    return _allgather_prep(comm, sendbuf)()


def _bcast_prep(comm, buf, root: int = 0):
    _check_buf("bcast", comm, buf)
    _check_root("bcast", comm, root)
    if comm.size == 1 or buf.numel() == 0:
        return _launcher(buf.clone)
    ep = _cuda._arena(comm, "pull", buf.nbytes)

    def launch():
        out = buf.new_empty(buf.shape)
        ep.run(K.bcast(ep, buf.reshape(-1), root, out.view(-1)))
        return out
    return _launcher(launch)


def bcast_dev(comm, buf, root: int = 0):
    """The root's ``buf`` on every rank (the others' ``buf`` gives only
    the shape and dtype)."""
    return _bcast_prep(comm, buf, root)()


def _alltoall_prep(comm, sendbuf):
    _check_buf("alltoall", comm, sendbuf)
    n = comm.size
    if n > 1 and (sendbuf.dim() < 1 or sendbuf.shape[0] % n):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"alltoall: dim 0 of shape {tuple(sendbuf.shape)} is not "
            f"divisible by the comm size {n}")
    if n == 1 or sendbuf.numel() == 0:
        return _launcher(sendbuf.clone)
    ep = _cuda._arena(comm, "pull", sendbuf.nbytes)

    def launch():
        out = sendbuf.new_empty(sendbuf.shape)
        ep.run(K.alltoall(ep, sendbuf.reshape(-1), out.view(-1)))
        return out
    return _launcher(launch)


def alltoall_dev(comm, sendbuf):
    """Dim 0 splits into n blocks; block p of the result is block
    ``rank`` of rank p's input."""
    return _alltoall_prep(comm, sendbuf)()


# ---------------------------------------------------------------------------
# rooted collectives (coll/xla.py:477-732)

#: test / diagnostic hook (coll/xla.py ``_last_rooted_plan``): this rank's
#: last rooted schedule — ``kind``, ``rounds`` (pulls, or the binomial's
#: rounds), ``round_out_elems`` (the elements one round moves to a rank)
#: and ``alloc_elems`` (the elements this rank allocated for the
#: schedule's outputs: a non-root's stay O(bytes), never the n-fold result)
_last_rooted_plan: Optional[dict] = None


def _rooted(nbytes_result: int) -> bool:
    thr = _rooted_var.get()
    return thr >= 0 and nbytes_result >= thr


def reduce_dev(comm, sendbuf, op=op_mod.SUM, root: int = 0,
               deterministic: Optional[str] = None):
    """MPI_Reduce (coll/xla.py:572-631): the root gets the reduction, the
    others None. In a deterministic mode, or while n x bytes stays below
    ``coll_device_rooted_threshold_bytes``, it is the allreduce. Above it,
    SUM reduce-scatters (the kernels' dtypes: K1's ring on the input
    zero-padded to n chunks) and the root pulls the n chunks (K2); any
    other op runs the reference's binomial tree, each receiver combining
    ``(its partial, the sender's)`` with one K1 (the kernels' dtypes and
    ops) or the fold. A non-root allocates O(bytes) either way
    (``_last_rooted_plan``)."""
    global _last_rooted_plan
    det = _det_ok(deterministic)
    _check_buf("reduce", comm, sendbuf)
    opn = _opn("reduce", op, sendbuf.dtype)
    _check_root("reduce", comm, root)
    n, r, m = comm.size, comm.rank, sendbuf.numel()
    if n == 1 or m == 0 or det is not None \
            or not _rooted(sendbuf.nbytes * n):
        out = allreduce_dev(comm, sendbuf, opn, det or "")
        return out if r == root else None
    pvar.record("coll_device_launches")
    flat, dt = sendbuf.reshape(-1), sendbuf.dtype
    if opn.name == "MPI_SUM":
        k = K.padded_chunk(m, n)
        chunk = _reduce_scatter_run(comm, m, dt, opn, None)(flat)
        out = chunk.new_empty(n * k) if r == root else None
        ep = _cuda._arena(comm, "pull", chunk.nbytes)
        ep.run(K.gather_to_root(ep, chunk, root, out))
        _last_rooted_plan = {"kind": "reduce_scatter_to_root", "rounds": 1,
                             "round_out_elems": k,
                             "alloc_elems": k + (n * k if r == root else 0)}
        return out[:m].view(sendbuf.shape) if r == root else None
    take = _kernels_take(dt, opn)

    def combine(cur, got, dst):
        if take:
            K.ring_rs_hop(cur, got, dst, opn.name)
        else:
            dst.copy_(_fold([cur, got], opn, dt))

    rounds = K.binomial_rounds(n, root)
    recv = sum(d == r for pairs in rounds for _, d in pairs)
    out = flat.new_empty(m) if r == root else None
    ep = _cuda._arena(comm, "pull", sendbuf.nbytes)
    ep.run(K.binomial_reduce(ep, flat, combine, root, out))
    _last_rooted_plan = {
        "kind": "reduce_binomial", "rounds": len(rounds),
        "round_out_elems": m,
        "alloc_elems": m * (1 + min(recv - 1, 2) if r == root
                            else min(recv, 2))}
    return out.view(sendbuf.shape) if r == root else None


def gather_dev(comm, sendbuf, root: int = 0):
    """MPI_Gather (coll/xla.py:719-732): ``(n, *shape)`` on the root, None
    elsewhere. Below the rooted threshold it is the allgather; above it
    every rank stages and the root alone pulls (K2), so a non-root
    allocates nothing."""
    global _last_rooted_plan
    _check_buf("gather", comm, sendbuf)
    _check_root("gather", comm, root)
    n, r = comm.size, comm.rank
    if n == 1 or not _rooted(sendbuf.nbytes * n):
        out = allgather_dev(comm, sendbuf)
        return out if r == root else None
    pvar.record("coll_device_launches")
    out = sendbuf.new_empty((n,) + tuple(sendbuf.shape)) if r == root \
        else None
    if sendbuf.numel():
        ep = _cuda._arena(comm, "pull", sendbuf.nbytes)
        ep.run(K.gather_to_root(ep, sendbuf.reshape(-1), root,
                                out.view(-1) if out is not None else None))
    _last_rooted_plan = {"kind": "gather_rooted", "rounds": 1,
                         "round_out_elems": sendbuf.numel(),
                         "alloc_elems": out.numel() if r == root else 0}
    return out


def _scatter_meta(comm, key, root: int, root_meta):
    """The scatter metadata round (coll/xla.py:835-877): the root passes
    its buffer signature, the others None and get it. One round per
    (comm, kind, root), cached; a root whose signature changed after the
    round was cached raises ERR_ARG (its peers reuse the cached shape and
    wait in the schedule until ``device_plane_timeout``)."""
    cache = comm.__dict__.setdefault("_coll_device_scatter_meta", {})
    cached = cache.get(key)
    if root_meta is None:
        if cached is None:
            cached = cache[key] = comm.coll.bcast_obj(comm, None, root)
        return cached
    if cached is None:
        comm.coll.bcast_obj(comm, root_meta, root)
        cache[key] = root_meta
    elif cached != root_meta:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"{key}: buffer signature changed {cached} -> {root_meta} after "
            "the metadata round was cached; the other ranks reuse the "
            "cached shape. Pass like= on every rank")
    return root_meta


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _scatter_shape(kind, comm, sendbuf, root, like, rest_only: bool):
    """(shape, dtype) of the root's buffer on every rank: the root's own,
    a non-root's ``like`` template (its receive buffer), or the metadata
    round. ``rest_only``: the trailing dims alone (scatterv)."""
    if comm.rank == root:
        _check_buf(kind, comm, sendbuf)
        shape = tuple(sendbuf.shape[1:] if rest_only else sendbuf.shape)
        if like is None:
            _scatter_meta(comm, (kind, root), root,
                          (shape, _dtype_name(sendbuf.dtype)))
        return shape, sendbuf.dtype
    if like is not None:
        _check_buf(kind, comm, like)
        rest = tuple(like.shape[1:])
        return (rest if rest_only else
                (comm.size * like.shape[0],) + rest), like.dtype
    shape, dtn = _scatter_meta(comm, (kind, root), root, None)
    return tuple(shape), getattr(torch, dtn)


def scatter_dev(comm, sendbuf, root: int = 0, like=None):
    """MPI_Scatter (coll/xla.py:880-923): rank r gets chunk r (dim 0 split
    n ways) of the root's ``sendbuf``. A non-root passes ``sendbuf`` None
    and takes the shape from ``like`` or from the metadata round. The
    root stages, each rank pulls its own chunk (K2); a non-root
    allocates its chunk only."""
    _check_root("scatter", comm, root)
    n = comm.size
    if n == 1:
        _check_buf("scatter", comm, sendbuf)
        return sendbuf.clone()
    shape, dtype = _scatter_shape("scatter", comm, sendbuf, root, like,
                                  False)
    if len(shape) < 1 or shape[0] % n:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"scatter: dim 0 of shape {shape} is not divisible by the comm "
            f"size {n}")
    pvar.record("coll_device_launches")
    out = torch.empty((shape[0] // n,) + shape[1:], dtype=dtype,
                      device=device_plane.device())
    if out.numel():
        ep = _cuda._arena(comm, "pull", n * out.nbytes)
        ep.run(K.scatter_from_root(
            ep, sendbuf.reshape(-1) if comm.rank == root else None, root,
            out.view(-1)))
    return out


def scatterv_dev(comm, sendbuf, counts, root: int = 0, like=None):
    """MPI_Scatterv (coll/xla.py:945-1018): rank r gets ``counts[r]`` rows
    of the root's packed ``sendbuf`` (the root's first sum(counts) rows).
    The root stages them unpadded; rank r pulls rows [sum(counts[:r]),
    +counts[r]) (K2). Non-roots: trailing dims and dtype from ``like`` or
    the metadata round, as :func:`scatter_dev`."""
    _check_root("scatterv", comm, root)
    n, r = comm.size, comm.rank
    if n == 1:
        _check_buf("scatterv", comm, sendbuf)
        return sendbuf.clone()
    counts = _counts(counts, "scatterv", n)
    rest, dtype = _scatter_shape("scatterv", comm, sendbuf, root, like,
                                 True)
    total, row = sum(counts), _row_elems(rest)
    if r == root and (sendbuf.dim() < 1 or sendbuf.shape[0] < total):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"scatterv: the root's {tuple(sendbuf.shape)} holds fewer than "
            f"the {total} rows of counts {counts}")
    pvar.record("coll_device_launches")
    out = torch.empty((counts[r],) + rest, dtype=dtype,
                      device=device_plane.device())
    pieces = [(sendbuf[:total].reshape(-1), 0)] if r == root else []
    _ragged(comm, dtype, total * row, pieces,
            [(root, _offsets(counts)[r] * row, counts[r] * row, 0)],
            out.view(-1))
    return out


def _v_block(kind: str, comm, sendbuf, counts):
    """(counts, trailing dims, elements per row) of a v-collective whose
    ranks each send ``counts[rank]`` rows."""
    _check_buf(kind, comm, sendbuf)
    counts = _counts(counts, kind, comm.size)
    if sendbuf.dim() < 1 or sendbuf.shape[0] != counts[comm.rank]:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"{kind}: this rank's {tuple(sendbuf.shape)} is not "
            f"counts[{comm.rank}] = {counts[comm.rank]} rows")
    rest = tuple(sendbuf.shape[1:])
    return counts, rest, _row_elems(rest)


def allgatherv_dev(comm, sendbuf, counts):
    """MPI_Allgatherv (coll/xla.py:1021-1054): the packed ``(sum(counts),
    *rest)``; every rank stages its block unpadded and pulls each rank's
    ``counts[p]`` rows into their place (K2)."""
    if comm.size == 1:
        _check_buf("allgatherv", comm, sendbuf)
        return sendbuf.clone()
    counts, rest, row = _v_block("allgatherv", comm, sendbuf, counts)
    pvar.record("coll_device_launches")
    out = sendbuf.new_empty((sum(counts),) + rest)
    offs = _offsets(counts)
    _ragged(comm, sendbuf.dtype, max(counts) * row,
            [(sendbuf.reshape(-1), 0)],
            [(p, 0, c * row, o * row) for p, (c, o) in
             enumerate(zip(counts, offs))], out.view(-1))
    return out


def gatherv_dev(comm, sendbuf, counts, root: int = 0):
    """MPI_Gatherv (coll/xla.py:1057-1059): the packed result on the root,
    None elsewhere. Every rank stages, the root alone pulls; the
    reference runs the allgatherv and drops it on the non-roots (same
    bits), the port allocates nothing there."""
    _check_root("gatherv", comm, root)
    if comm.size == 1:
        _check_buf("gatherv", comm, sendbuf)
        return sendbuf.clone()
    counts, rest, row = _v_block("gatherv", comm, sendbuf, counts)
    pvar.record("coll_device_launches")
    r = comm.rank
    out = sendbuf.new_empty((sum(counts),) + rest) if r == root else None
    spans = [(p, 0, c * row, o * row) for p, (c, o) in
             enumerate(zip(counts, _offsets(counts)))] if r == root else []
    _ragged(comm, sendbuf.dtype, max(counts) * row,
            [(sendbuf.reshape(-1), 0)], spans,
            out.view(-1) if out is not None else None)
    return out


def _a2av_meta(comm, scounts, rcounts):
    """Every rank's ``scounts`` from one ``allgather_obj`` round of every
    rank's (scounts, rcounts) (coll/xla.py:1085-1100 allgathers (max
    cell, total) instead). Every rank checks every pair, so rcounts that
    disagree with what a peer sends raise ERR_COUNT on all ranks
    together, before any rank enters the schedule."""
    every = [(tuple(int(c) for c in s), tuple(int(c) for c in rc))
             for s, rc in comm.coll.allgather_obj(comm, (scounts, rcounts))]
    bad = [(p, q) for p in range(comm.size) for q in range(comm.size)
           if every[p][0][q] != every[q][1][p]]
    if bad:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"alltoallv: rcounts disagree with the scounts sent, for the "
            f"(sender, receiver) pairs {bad}")
    return [s for s, _ in every]


def alltoallv_dev(comm, sendbuf, scounts, rcounts, max_count=None):
    """MPI_Alltoallv (coll/xla.py:1062-1157): block p of the result is the
    ``scounts_p[rank]`` rows rank p sends this rank, packed in rank order
    (``rcounts[p]`` rows each). Nothing is padded: a reader pulls each
    block at its offset in the sender's staged input (K2).

    - ``max_count`` M: every rank stages cell q of its rows at q x M rows,
      and a reader pulls from cell ``rank`` of each peer: no host round.
      A local count above M raises ERR_COUNT.
    - otherwise one ``allgather_obj`` of every rank's (scounts, rcounts)
      per call (the reference allgathers (max cell, total) to size its
      padding), so every reader knows its offsets, and every rank raises
      ERR_COUNT when some ``rcounts_q[p]`` is not ``scounts_p[q]``. With
      no padding there is no blowup to bound: the reference's
      ``coll_xla_alltoallv_pad_factor`` and its fallback to host staging
      have no counterpart."""
    _check_buf("alltoallv", comm, sendbuf)
    n, r = comm.size, comm.rank
    if n == 1:
        return sendbuf.clone()
    scounts = _counts(scounts, "alltoallv scounts", n)
    rcounts = _counts(rcounts, "alltoallv rcounts", n)
    if sendbuf.dim() < 1 or sendbuf.shape[0] < sum(scounts):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"alltoallv: {tuple(sendbuf.shape)} holds fewer than the "
            f"{sum(scounts)} rows of scounts {scounts}")
    rest = tuple(sendbuf.shape[1:])
    row, soffs = _row_elems(rest), _offsets(scounts)
    flat = sendbuf.reshape(-1)
    if max_count is not None:
        cap = int(max_count)
        if max(scounts + rcounts) > cap:
            raise errors.MPIError(
                errors.ERR_COUNT,
                f"alltoallv: max_count {cap} below local max "
                f"{max(scounts + rcounts)}")
        staged = n * cap * row
        pieces = [(flat[o * row:(o + c) * row], q * cap * row)
                  for q, (c, o) in enumerate(zip(scounts, soffs)) if c]
        src = [r * cap * row] * n
    else:
        every = _a2av_meta(comm, scounts, rcounts)
        staged = max(sum(s) for s in every) * row
        pieces = [(flat[:sum(scounts) * row], 0)]
        src = [sum(every[p][:r]) * row for p in range(n)]
    pvar.record("coll_device_launches")
    out = sendbuf.new_empty((sum(rcounts),) + rest)
    _ragged(comm, sendbuf.dtype, staged, pieces,
            [(p, src[p], c * row, o * row) for p, (c, o) in
             enumerate(zip(rcounts, _offsets(rcounts)))], out.view(-1))
    return out


def reduce_scatter_dev(comm, sendbuf, counts, op=op_mod.SUM,
                       deterministic: Optional[str] = None):
    """MPI_Reduce_scatter (coll/xla.py:1160-1185): the allreduce, then
    this rank's ``counts[rank]`` rows (a copy)."""
    _check_buf("reduce_scatter", comm, sendbuf)
    _opn("reduce_scatter", op, sendbuf.dtype)
    counts = _counts(counts, "reduce_scatter", comm.size)
    if sendbuf.dim() < 1 or sum(counts) != sendbuf.shape[0]:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"reduce_scatter: counts sum to {sum(counts)} but dim 0 of "
            f"{tuple(sendbuf.shape)} is not that")
    full = allreduce_dev(comm, sendbuf, op, deterministic)
    off = _offsets(counts)[comm.rank]
    return full[off:off + counts[comm.rank]].clone()


def _prefix(kind: str, comm, sendbuf, op, deterministic, exclusive: bool):
    """Scan / Exscan (coll/xla.py:1188-1238, parallel/collectives.py
    scan / exscan): rank r folds the inputs of ranks 0..r (0..r-1) in rank
    order, ``acc = g0; acc = fn(acc, g_i)``, in every mode (the mode is
    checked, as the reference takes it, and changes nothing). The
    kernels' dtypes and ops fold with K3 straight from the staged
    inputs; others pull the rows (K2) and fold; one row is a copy, and
    exscan's rank 0 gets zeros."""
    _det_ok(deterministic)
    _check_buf(kind, comm, sendbuf)
    opn = _opn(kind, op, sendbuf.dtype)
    pvar.record("coll_device_launches")
    n, r, m = comm.size, comm.rank, sendbuf.numel()
    rows = r if exclusive else r + 1
    if n == 1 or m == 0:
        return torch.zeros_like(sendbuf) if exclusive else sendbuf.clone()
    flat, dt = sendbuf.reshape(-1), sendbuf.dtype
    if _kernels_take(dt, opn):
        out = flat.new_empty(m)
        ep = _cuda._arena(comm, "pull", sendbuf.nbytes)
        ep.run(K.prefix(ep, flat, opn.name, rows, out))
    else:
        g = flat.new_empty(rows * m)
        _ragged(comm, dt, m, [(flat, 0)],
                [(p, 0, m, p * m) for p in range(rows)], g)
        out = _fold(list(g.view(rows, m)), opn, dt) if rows > 1 else g
    if rows == 0:
        out = torch.zeros_like(flat)
    return out.view(sendbuf.shape)


def scan_dev(comm, sendbuf, op=op_mod.SUM,
             deterministic: Optional[str] = None):
    """MPI_Scan (coll/xla.py:1188-1211): the inclusive prefix over ranks
    0..rank."""
    return _prefix("scan", comm, sendbuf, op, deterministic, False)


def exscan_dev(comm, sendbuf, op=op_mod.SUM,
               deterministic: Optional[str] = None):
    """MPI_Exscan (coll/xla.py:1214-1238): the exclusive prefix; rank 0
    gets zeros (MPI leaves it undefined; the reference's choice)."""
    return _prefix("exscan", comm, sendbuf, op, deterministic, True)


# ---------------------------------------------------------------------------
# fused (bucketed) allreduce (coll/xla.py:1241-1409)


def _allreduce_multi_prep(comm, bufs, op=op_mod.SUM,
                          deterministic: Optional[str] = None):
    """Plan the buckets (``zero/layout._FusePlan`` over
    ``coll_device_bucket_bytes``) and each bucket's allreduce schedule;
    the launcher packs each bucket's current contents into one flat
    tensor, runs the schedule on it and splits the result back into a
    new pytree."""
    from ompi_tpu_torch.zero import layout as zl

    det = _det_ok(deterministic)
    leaves, treedef = zl.tree_flatten(bufs)
    for t in leaves:
        _check_buf("allreduce_multi", comm, t)
    opn = None
    for dtype in {t.dtype for t in leaves} or {torch.int32}:
        opn = _opn("allreduce_multi", op, dtype)
    if comm.size == 1 or not leaves:
        return _launcher(lambda: zl.tree_unflatten(
            treedef, [t.clone() for t in leaves]))
    metas = zl._fuse_metas(leaves)
    plan = zl._FusePlan(metas, int(bucket_var.get()))
    runs = []
    for idxs in plan.buckets:
        m = sum(leaves[i].numel() for i in idxs)
        runs.append((idxs, _allreduce_run(comm, m, leaves[idxs[0]].dtype,
                                          opn, det) if m else None))

    def launch():
        outs = [None] * len(leaves)
        for idxs, run in runs:
            flat = zl.pack(leaves, idxs, 0)
            red = run(flat) if run is not None else flat.clone()
            for i, leaf in zip(idxs, zl.split(red, metas, idxs)):
                outs[i] = leaf
        pvar.record("coll_device_fused_bytes", plan.nbytes)
        return zl.tree_unflatten(treedef, outs)
    return _launcher(launch)


def allreduce_multi_dev(comm, bufs, op=op_mod.SUM,
                        deterministic: Optional[str] = None):
    """Fused allreduce over a pytree of device tensors (coll/xla.py:
    1241-1409): dtype-segregated flat buckets, one allreduce schedule per
    bucket, split back into a new pytree. Under ``'linear'`` every
    element folds in rank order, so the result is bitwise the per-buffer
    loop's."""
    return _allreduce_multi_prep(comm, bufs, op, deterministic)()


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
    full = shard.new_empty(state.plan.padded[b])
    ep = _cuda._arena(comm, "pull", shard.nbytes)
    ep.run(K.gather(ep, shard, full))
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


# ---------------------------------------------------------------------------
# barrier, nonblocking and persistent forms (coll/xla.py:926-942,
# 1412-1600, 2677-2703)


def _event_device(comm, obj) -> torch.device:
    """Where a request's event records: this rank's plane device, or on
    a one-rank comm (no plane needed) the first tensor's own device."""
    if comm.size > 1:
        return device_plane.device()
    from ompi_tpu_torch.zero import layout as zl

    ts = [t for t in zl.tree_leaves(obj) if isinstance(t, torch.Tensor)]
    return ts[0].device if ts else torch.device("cpu")


class DeviceRequest:
    """MPI request over a device collective (coll/xla.py:1412-1476
    ``DeviceRequest``;
    ``.array`` is the result, None on a rooted call's non-roots).

    Not the reference's overlap: coll/device's schedules step on the
    host (each arena step synchronises the stream and spins on the
    peers' counters), so an ``I*`` call runs its host steps inside the
    call, and the request holds an event recorded after its last launch.
    ``completed`` queries that event on every read (the plural helpers
    poll it); requests on one comm complete in call order. Overlapping
    the host steps with the caller's work waits for device-side flags
    (ROADMAP queue 2 item 2)."""

    def __init__(self, array, device) -> None:
        self.id = next(rq._req_ids)
        self.status = rq.Status()
        self.persistent = False
        self.array = array
        self._event = stream.Event(device).record()

    @property
    def completed(self) -> bool:
        return self._event.query()

    def test(self) -> bool:
        return self.completed

    def wait(self, timeout=None):
        self._event.wait()
        return self.status

    def cancel(self) -> None:  # a launched collective is not cancelable
        pass

    def free(self) -> None:
        pass

    def retrieve_status(self):
        return self.status


def ibarrier_dev(comm):
    """Nonblocking device barrier (coll/xla.py:1479-1498): a one-element
    int32 SUM allreduce under ``'linear'`` (K3), which no rank leaves
    before every member entered (and which counts the call in
    ``coll_device_launches``)."""
    if comm.size == 1:
        pvar.record("coll_device_launches")
        return DeviceRequest(None, torch.device("cpu"))
    token = torch.ones(1, dtype=torch.int32, device=device_plane.device())
    return DeviceRequest(allreduce_dev(comm, token, op_mod.SUM, "linear"),
                         token.device)


def barrier_dev(comm) -> None:
    """Device barrier (coll/xla.py:926-942): :func:`ibarrier_dev`,
    waited."""
    ibarrier_dev(comm).wait()


class PersistentDeviceRequest:
    """MPI-4 persistent device collective (coll/xla.py:1501-1600
    ``PersistentDeviceRequest``): init checks the arguments, picks the
    schedule and maps its arena; each :meth:`start` runs the prepared
    schedule once on the bound tensors' current contents (MPI's
    persistent semantics: change the buffer, start again, get the new
    result). An inactive request is complete; a start while a cycle is
    active, or after :meth:`free`, raises ERR_REQUEST. ``rebind`` raises
    ERR_NOT_SUPPORTED: no prep of this slice installs the reference's
    rebind hook (zero-3's, ROADMAP queue 1 item 5)."""

    def __init__(self, launch, device) -> None:
        self.id = next(rq._req_ids)
        self.status = rq.Status()
        self.persistent = True
        self._launch = launch
        self._device = device
        self._inner: Optional[DeviceRequest] = None

    def start(self) -> None:
        if self._launch is None:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                "start: persistent request already freed (MPI calls "
                "starting a freed request erroneous)")
        if self.active:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                "start: the previous cycle is still active — wait() it "
                "first")
        self._inner = DeviceRequest(self._launch(), self._device)

    def rebind(self, *args, **kwargs) -> None:
        if self._launch is None:
            raise errors.MPIError(errors.ERR_REQUEST,
                                  "rebind: persistent request already freed")
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            "rebind: this persistent request reads its bound tensors at "
            "every start — change them in place, or free() and re-init")

    @property
    def active(self) -> bool:
        return self._inner is not None and not self._inner.completed

    @property
    def completed(self) -> bool:
        return self._inner is None or self._inner.completed

    @property
    def array(self):
        return None if self._inner is None else self._inner.array

    def test(self) -> bool:
        return self.completed

    def wait(self, timeout=None):
        if self._inner is None:
            return self.status  # inactive: complete at once (MPI)
        return self._inner.wait(timeout)

    def retrieve_status(self):
        return self.status

    def cancel(self) -> None:
        pass

    def free(self) -> None:
        self._launch = None
        self._inner = None


def _irequest(fn):
    """The nonblocking form of a slot (coll/xla.py:2677-2703
    ``_irequest``): the slot, then a DeviceRequest over its result."""
    def islot(comm, buf, *args, **kwargs):
        out = fn(comm, buf, *args, **kwargs)
        return DeviceRequest(out, _event_device(
            comm, (buf, kwargs.get("like"))))
    islot.__name__ = "i" + fn.__name__
    islot.__doc__ = f"Nonblocking {fn.__name__}: see :class:`DeviceRequest`."
    return islot


def _pinit(prep, name: str):
    """The persistent form of a slot over its prep (coll/xla.py:1603-1665
    ``_pprep``; the gates run inside the prep: size 1 and an empty pytree
    clone at each start, a non-traceable op raises at init)."""
    def pslot(comm, buf, *args, **kwargs):
        return PersistentDeviceRequest(prep(comm, buf, *args, **kwargs),
                                       _event_device(comm, buf))
    pslot.__name__ = name
    pslot.__doc__ = (f"Persistent form of {name[:-len('_init_dev')]}_dev: "
                     "see :class:`PersistentDeviceRequest`.")
    return pslot


#: the blocking slots
_BLOCKING = {f.__name__: f for f in (
    allreduce_dev, allreduce_multi_dev, reduce_scatter_multi_dev,
    allgather_multi_dev, allgather_multi_bucket_dev, reduce_dev, bcast_dev,
    allgather_dev, gather_dev, alltoall_dev, reduce_scatter_block_dev,
    scatter_dev, scan_dev, exscan_dev, barrier_dev, allgatherv_dev,
    gatherv_dev, alltoallv_dev, scatterv_dev, reduce_scatter_dev)}
#: the nonblocking slots: ``ibarrier_dev`` and, through ``_irequest``
#: (coll/xla.py:2677-2703), ``i`` + a blocking slot's name
_NONBLOCKING = {"ibarrier_dev": ibarrier_dev, **{
    "i" + f.__name__: _irequest(f) for f in (
        allreduce_dev, bcast_dev, reduce_dev, allgather_dev, gather_dev,
        alltoall_dev, reduce_scatter_block_dev, scatter_dev, scan_dev,
        exscan_dev, allgatherv_dev, gatherv_dev, alltoallv_dev,
        scatterv_dev, reduce_scatter_dev)}}
#: the persistent slots over their preps (coll/xla.py:1603-1665)
_PERSISTENT = {name: _pinit(prep, name) for name, prep in (
    ("allreduce_init_dev", _allreduce_prep),
    ("bcast_init_dev", _bcast_prep),
    ("allgather_init_dev", _allgather_prep),
    ("alltoall_init_dev", _alltoall_prep),
    ("reduce_scatter_block_init_dev", _reduce_scatter_block_prep),
    ("allreduce_multi_init_dev", _allreduce_multi_prep))}


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
        return {**_BLOCKING, **_NONBLOCKING, **_PERSISTENT}
