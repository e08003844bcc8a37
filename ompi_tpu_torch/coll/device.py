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
- ``permute_dev``, ``lax.ppermute`` for :mod:`ompi_tpu_torch.parallel`
  (an internal slot with no MPI entry point, outside the comm's slot
  table): one arena exchange, each destination pulling its source's
  blocks with K2;
- on a topology comm, ``neighbor_allgather_dev`` and
  ``neighbor_alltoall_dev`` (:mod:`ompi_tpu_torch.coll.device_neighbor`,
  coll/xla_neighbor's counterpart): one arena exchange, K2 landing each
  in-edge's block;
- ``allreduce_multi_dev`` (coll/xla.py:1241-1409): dtype-segregated flat
  buckets of ``coll_device_bucket_bytes``, one allreduce each;
- the two-level mode (``coll_device_hier``, coll/xla's ``coll_xla_hier``):
  on a comm whose ranks form N > 1 slices (by node, or N forced),
  Allreduce with no deterministic mode, Bcast, Alltoall and the fused
  and partitioned bucket allreduces run
  :mod:`ompi_tpu_torch.parallel.hierarchical`'s compositions over the
  comm's ``low`` and ``up`` splits (:func:`grid_of`);
- the nonblocking forms (15 ``i*_dev`` and ``ibarrier_dev``,
  :class:`DeviceRequest`) and the persistent ``allreduce_init_dev``,
  ``bcast_init_dev``, ``allgather_init_dev``, ``alltoall_init_dev``,
  ``reduce_scatter_block_init_dev``, ``allreduce_multi_init_dev``,
  ``reduce_scatter_multi_init_dev`` and ``allgather_multi_init_dev``
  (:class:`PersistentDeviceRequest`; the last one's ``rebind`` swaps a
  same-plan ShardedState in, ZeRO stage 3's per-step refresh);
- the zero/ bucket slots (coll/xla.py:1668-1985):
  ``reduce_scatter_multi_dev`` (one reduce-scatter of each padded flat
  bucket), ``allgather_multi_dev`` and ``allgather_multi_bucket_dev``;
- the partitioned collectives (coll/xla.py:2006-2676):
  ``pallreduce_init_dev`` and ``preduce_scatter_init_dev``
  (:class:`PartitionedAllreduceRequest`,
  :class:`PartitionedReduceScatterRequest`), one partition per pytree
  leaf, each bucket's schedule run by the ``Pready`` of its last leaf.

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
  (:class:`DeviceRequest`), and so does a partitioned bucket's flush
  inside the ``Pready`` that releases it: the flush counts match the
  reference's, but its communication does not overlap the caller's work
  until the schedules wait on the device (ROADMAP queue 2 item 2). Every
  rank must reach the same flushes in the same order.

The monitoring plane (``monitoring_level`` >= 1) meters the slots where
coll/xla does (one ``TRAFFIC`` branch a call when it is off): each
blocking call on the device path of a comm of two or more ranks records
its op, payload and the reference's per-peer model (``TrafficMatrix.coll``),
a Reduce or Gather below the rooted threshold as the Allreduce or
Allgather it runs, Alltoallv with its actual splits (and, unless the
internal ``_expert_tokens=False``, its scounts as the per-expert load),
a partitioned bucket's flush in the ``part`` context. The nonblocking
forms meter as their blocking slot; persistent starts, Scatter,
Allgatherv / Gatherv and Exscan do not meter, as in the reference. The
axis collectives of :mod:`ompi_tpu_torch.parallel` run the unmetered
preps (``_allreduce_prep(...)()`` and the like): they are the reference's
``lax`` collectives inside a compiled program, which the plane does not
see either.

A one-rank comm needs no device plane: every slot returns a new tensor
(a clone; ``allgather_dev`` one with a leading axis of 1; ``exscan_dev``
zeros) on the tensor's own device and touches no arena. The reference
returns its input there; a torch tensor is mutable, a jax array is not.

The reference's fallthrough (coll/xla.py:401-410 ``_op_ok`` and its
call sites): a call whose op coll/xla would not trace (REPLACE, NO_OP, a
user op of ``op.create``), or whose tensor has a dtype a jax array does
not hold with 64-bit mode off (float64, int64, uint64, complex), goes to
the coll/accelerator function of the same signature (:func:`_stages`),
which stages it through the host collectives; its nonblocking and
persistent forms run that function. The decision is made from the op and
the dtype alone, before anything launches; a kernel that fails to build
or launch raises, and nothing stages on error. MINLOC and MAXLOC raise
``MPIError(ERR_OP)``: their (val, loc) records fit no torch dtype.
Scatter's non-roots learn the dtype from ``like`` or the metadata round
first, so every rank takes the same path.
"""
from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.accelerator import stream
from ompi_tpu_torch.coll import cuda as _cuda
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import cvar, pvar, registry
from ompi_tpu_torch.monitoring import matrix as _mon
from ompi_tpu_torch.pml import request as rq
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.telemetry import flight as _flight
from ompi_tpu_torch.trace import recorder as _trace
from ompi_tpu_torch.tune import observe as _tobs

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

_hier_var = cvar.register(
    "coll_device_hier", "auto", str,
    help="two-level execution for comms spanning nodes (coll/han's "
         "split-level algorithms on the device plane, coll_xla_hier's "
         "counterpart): 'auto' groups the ranks by node when they are "
         "node-contiguous, 'off' always flat, an integer N forces N "
         "equal slices. Allreduce without a deterministic mode, Bcast, "
         "Alltoall and the fused bucket allreduce then run "
         "parallel/hierarchical's compositions over the comm's low and "
         "up splits; deterministic modes stay flat (the split-level fold "
         "order differs from the rank-order contract).", level=5)


def grid_of(comm):
    """The comm's two-level grid under ``coll_device_hier`` (a
    ``parallel.hierarchical.Grid``), or None: flat. Decided at the comm's
    first call that asks and cached on it (coll/xla builds its ``mesh2d``
    with the comm's context); making the grid is collective (it splits
    the comm), so every member asks in the same call."""
    g = comm.__dict__.get("_coll_device_grid")
    if g is not None:
        return g or None
    from ompi_tpu_torch.parallel import hierarchical as H

    n, mode = comm.size, _hier_var.get().strip().lower()
    d = 0
    if n > 1 and mode == "auto":
        d = H.slice_split(H.node_names(comm))
    elif n > 1 and mode != "off":
        try:
            d = int(mode)
        except ValueError:
            d = 0
        d = d if d > 1 and n % d == 0 else 0
    g = H.grid(comm, d, n // d) if 1 < d < n else False
    comm._coll_device_grid = g
    return g or None


def _hier_run(comm, opn: op_mod.Op, det):
    """``run(x)``: the split-level allreduce of ``x`` over the comm's
    grid (coll/xla.py:427-441), or None when the comm is flat or a
    deterministic mode is asked for."""
    if det is not None or comm.size == 1:
        return None
    g = grid_of(comm)
    if g is None:
        return None
    from ompi_tpu_torch.parallel import hierarchical as H

    return lambda x: H.allreduce(x, g.low, g.up, opn)


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


def _stages(op, *tensors) -> bool:
    """True when the call goes to coll/accelerator's staging (coll/xla.py
    ``_op_ok``): an op coll/xla does not trace, or a dtype of
    :data:`_HOST_ONLY`. MINLOC and MAXLOC raise ERR_OP."""
    from ompi_tpu_torch.coll import accelerator

    if op is not None:
        opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
        if opn is not None:
            accelerator.check_op("coll_device", opn)
        if opn is None or opn.name not in _FOLD:
            return True
    return any(isinstance(t, torch.Tensor) and t.dtype in _HOST_ONLY
               for t in tensors)


def _stage(slot: str, *args, **kwargs):
    """The coll/accelerator function of the same signature (coll/xla's
    ``staging.<slot>``)."""
    from ompi_tpu_torch.coll import accelerator

    return getattr(accelerator, slot)(*args, **kwargs)


def _check_buf(kind: str, comm, t, any_dtype: bool = False) -> None:
    """A tensor on this rank's device (any device on a one-rank comm,
    which needs no plane) of a dtype the device path holds (any dtype
    where the caller stages the others itself)."""
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
    if t.dtype in _HOST_ONLY and not any_dtype:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: {kind} of {t.dtype}, which a jax array does not "
            "hold with 64-bit mode off: the slots that have a "
            "coll/accelerator counterpart stage it; this one has none")


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
    """The op, which coll/xla would trace (:func:`_stages` has sent the
    others to coll/accelerator), if it takes this dtype."""
    opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
    if opn is None or opn.name not in _FOLD:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: {kind} op {getattr(opn, 'name', op)!r} is not "
            "traceable and this slot has no staged counterpart")
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


def _meter(tm, kind: str, comm, t, op=None, **kw) -> None:
    """Record one slot call on the traffic matrices, as coll/xla does:
    a call on the device path of a comm of two or more ranks (a staged
    call is coll/accelerator's)."""
    if comm.size > 1 and not _stages(op, t):
        tm.coll(kind, comm, t.nbytes, dtype=_dtype_name(t.dtype), **kw)


def _launch(fn, *args, op: Optional[str] = None):
    """Run one launch: the one place that counts
    ``coll_device_launches`` (coll/xla.py:343-356 ``_Ctx.launch``). With
    the trace recorder up a ``launch`` span in ``coll_device`` covers the
    call; the kernels it queues run asynchronously, so on the card the
    span is the host's dispatch and schedule steps, as the reference's
    is PJRT's dispatch. ``op`` names the launch in the span's args (the
    ZeRO buckets: ``allgather_multi``, coll/cuda's ``fused_rs_update``),
    which the reference's span does not carry."""
    pvar.record("coll_device_launches")
    rec = _trace.RECORDER
    if rec is None:
        return fn(*args)
    t0 = _trace.now()
    out = fn(*args)
    rec.record("launch", "coll_device", t0, _trace.now(),
               None if op is None else {"op": op})
    return out


def _launcher(fn):
    """A prepared call: each run is one :func:`_launch`."""
    return lambda: _launch(fn)


def _observed(launcher, op: str, comm, buf, opn=None,
              deterministic: Optional[str] = None, nbytes=None):
    """The tune plane's hook on a slot's prepared launcher
    (coll/xla.py:156-167 ``_observed``): with the observatory up, time
    this dispatch under provider ``device`` — the backend that served
    after coll/cuda's and coll/hier's fallthrough; a call that stages
    through the host, or a one-rank call, is coll/accelerator's or no
    one's. One attribute load and one branch when off."""
    obs = _tobs.OBSERVER
    if obs is None:
        return launcher
    if comm.size == 1 or _stages(opn, buf):
        return launcher
    det = deterministic if deterministic is not None \
        else _default_det.get()
    return obs.timed("device", op, det or "auto", comm,
                     int(buf.nbytes if nbytes is None else nbytes),
                     _dtype_name(buf.dtype), launcher)


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
    (n > 1, m > 0); the arena is mapped now. Over a two-level grid
    (``coll_device_hier``) and with no deterministic mode, the
    split-level allreduce."""
    hier = _hier_run(comm, opn, det)
    if hier is not None:
        return hier
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
    if _stages(op, sendbuf):
        return lambda: _stage("allreduce_dev", comm, sendbuf, op,
                              deterministic)
    det = _det_ok(deterministic)
    _check_buf("allreduce", comm, sendbuf)
    opn = _opn("allreduce", op, sendbuf.dtype)
    n, m = comm.size, sendbuf.numel()
    if n == 1 or m == 0:
        return _launcher(sendbuf.clone)
    hier = _hier_run(comm, opn, det)
    if hier is not None:  # on the buffer's own shape, as the reference
        return _launcher(lambda: hier(sendbuf.contiguous()))
    run = _allreduce_run(comm, m, sendbuf.dtype, opn, det)
    return _launcher(lambda: run(sendbuf.reshape(-1)).view(sendbuf.shape))


def allreduce_dev(comm, sendbuf, op=op_mod.SUM,
                  deterministic: Optional[str] = None):
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter(tm, "allreduce", comm, sendbuf, op)
    launcher = _observed(_allreduce_prep(comm, sendbuf, op, deterministic),
                         "allreduce", comm, sendbuf, op, deterministic)
    fl = _flight.FLIGHT
    if fl is None:
        return launcher()
    tok = fl.enter("allreduce_dev", getattr(comm, "cid", -1),
                   getattr(sendbuf, "nbytes", 0))
    try:
        return launcher()
    finally:
        fl.exit(tok)


def _reduce_scatter_block_prep(comm, sendbuf, op=op_mod.SUM,
                               deterministic: Optional[str] = None):
    if _stages(op, sendbuf):
        return lambda: _stage("reduce_scatter_block_dev", comm, sendbuf, op,
                              deterministic)
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
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter(tm, "reduce_scatter_block", comm, sendbuf, op)
    launcher = _observed(
        _reduce_scatter_block_prep(comm, sendbuf, op, deterministic),
        "reduce_scatter_block", comm, sendbuf, op, deterministic)
    fl = _flight.FLIGHT
    if fl is None:
        return launcher()
    tok = fl.enter("reduce_scatter_block_dev", getattr(comm, "cid", -1),
                   getattr(sendbuf, "nbytes", 0))
    try:
        return launcher()
    finally:
        fl.exit(tok)


def _allgather_prep(comm, sendbuf):
    if _stages(None, sendbuf):
        return lambda: _stage("allgather_dev", comm, sendbuf)
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
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter(tm, "allgather", comm, sendbuf)
    launcher = _observed(_allgather_prep(comm, sendbuf), "allgather", comm,
                         sendbuf)
    fl = _flight.FLIGHT
    if fl is None:
        return launcher()
    tok = fl.enter("allgather_dev", getattr(comm, "cid", -1),
                   getattr(sendbuf, "nbytes", 0))
    try:
        return launcher()
    finally:
        fl.exit(tok)


def _bcast_prep(comm, buf, root: int = 0):
    if _stages(None, buf):
        return lambda: _stage("bcast_dev", comm, buf, root)
    _check_buf("bcast", comm, buf)
    _check_root("bcast", comm, root)
    if comm.size == 1 or buf.numel() == 0:
        return _launcher(buf.clone)
    g = grid_of(comm)
    if g is not None:  # up bcast, then low bcast (coll/xla.py:636-650)
        from ompi_tpu_torch.parallel import hierarchical as H

        ici = g.n_ici
        return _launcher(lambda: H.bcast(buf.contiguous(), root // ici,
                                         root % ici, g.low, g.up))
    ep = _cuda._arena(comm, "pull", buf.nbytes)

    def launch():
        out = buf.new_empty(buf.shape)
        ep.run(K.bcast(ep, buf.reshape(-1), root, out.view(-1)))
        return out
    return _launcher(launch)


def bcast_dev(comm, buf, root: int = 0):
    """The root's ``buf`` on every rank (the others' ``buf`` gives only
    the shape and dtype)."""
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter(tm, "bcast", comm, buf, root=root)
    launcher = _observed(_bcast_prep(comm, buf, root), "bcast", comm, buf)
    fl = _flight.FLIGHT
    if fl is None:
        return launcher()
    tok = fl.enter("bcast_dev", getattr(comm, "cid", -1),
                   getattr(buf, "nbytes", 0))
    try:
        return launcher()
    finally:
        fl.exit(tok)


def _alltoall_prep(comm, sendbuf):
    if _stages(None, sendbuf):
        return lambda: _stage("alltoall_dev", comm, sendbuf)
    _check_buf("alltoall", comm, sendbuf)
    n = comm.size
    if n > 1 and (sendbuf.dim() < 1 or sendbuf.shape[0] % n):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"alltoall: dim 0 of shape {tuple(sendbuf.shape)} is not "
            f"divisible by the comm size {n}")
    if n == 1 or sendbuf.numel() == 0:
        return _launcher(sendbuf.clone)
    g = grid_of(comm)
    if g is not None:  # ICI regroup, then DCN (coll/xla.py:744-757)
        from ompi_tpu_torch.parallel import hierarchical as H

        return _launcher(lambda: H.alltoall(sendbuf.contiguous(), g.low,
                                            g.up))
    ep = _cuda._arena(comm, "pull", sendbuf.nbytes)

    def launch():
        out = sendbuf.new_empty(sendbuf.shape)
        ep.run(K.alltoall(ep, sendbuf.reshape(-1), out.view(-1)))
        return out
    return _launcher(launch)


def alltoall_dev(comm, sendbuf):
    """Dim 0 splits into n blocks; block p of the result is block
    ``rank`` of rank p's input."""
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter(tm, "alltoall", comm, sendbuf)
    launcher = _observed(_alltoall_prep(comm, sendbuf), "alltoall", comm,
                         sendbuf)
    fl = _flight.FLIGHT
    if fl is None:
        return launcher()
    tok = fl.enter("alltoall_dev", getattr(comm, "cid", -1),
                   getattr(sendbuf, "nbytes", 0))
    try:
        return launcher()
    finally:
        fl.exit(tok)


def permute_dev(comm, blocks, perm):
    """``lax.ppermute`` over the comm (an internal slot of
    :mod:`ompi_tpu_torch.parallel`, no MPI entry point): ``perm`` holds
    (source, destination) pairs; each destination gets its source's
    ``blocks`` (a tensor, or a tuple / list of tensors that move together)
    and a rank that no pair names as a destination gets zeros. One
    ``Arena.exchange`` of the comm's ``perm`` arena: every source stages
    its blocks, and each destination pulls them with K2
    (:func:`cuda_kernels.permute`). Every member passes the same ``perm``
    and blocks of the same shapes and dtypes. A byte copy: any dtype,
    bitwise."""
    single = isinstance(blocks, torch.Tensor)
    ts = [blocks] if single else list(blocks)
    for t in ts:
        _check_buf("permute", comm, t, any_dtype=True)
    n, r = comm.size, comm.rank
    pairs = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if any(not 0 <= p < n for p in srcs + dsts) or len(set(srcs)) < \
            len(srcs) or len(set(dsts)) < len(dsts):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"permute: perm {pairs} is not a partial permutation of "
            f"range({n})")
    return _launch(_permute, comm, ts, pairs, single, blocks)


def _permute(comm, ts, pairs, single, blocks):
    n, r = comm.size, comm.rank
    src = next((s for s, d in pairs if d == r), None)
    outs = [torch.zeros_like(t) if src is None else torch.empty_like(t)
            for t in ts]
    offs, total = [], 0
    for t in ts:
        offs.append(total)
        total += _cuda.align(t.nbytes)
    if n == 1:
        if src is not None:
            for o, t in zip(outs, ts):
                o.copy_(t)
    elif any(t.numel() for t in ts):
        stage, land = K.permute(
            [t.reshape(-1) for t in ts], offs,
            [o.view(-1) for o in outs], src)
        ep = _cuda._arena(comm, "perm", total)
        ep.exchange(stage, [d for s, d in pairs if s == r], land,
                    [] if src is None else [src])
    return outs[0] if single else type(blocks)(outs)


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
    if _stages(op, sendbuf):
        return _stage("reduce_dev", comm, sendbuf, op, root, deterministic)
    det = _det_ok(deterministic)
    _check_buf("reduce", comm, sendbuf)
    opn = _opn("reduce", op, sendbuf.dtype)
    _check_root("reduce", comm, root)
    n, r, m = comm.size, comm.rank, sendbuf.numel()
    if n == 1 or m == 0 or det is not None \
            or not _rooted(sendbuf.nbytes * n):
        out = allreduce_dev(comm, sendbuf, opn, det or "")
        return out if r == root else None
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter(tm, "reduce", comm, sendbuf, opn, root=root)

    def run():
        global _last_rooted_plan
        flat, dt = sendbuf.reshape(-1), sendbuf.dtype
        if opn.name == "MPI_SUM":
            k = K.padded_chunk(m, n)
            chunk = _reduce_scatter_run(comm, m, dt, opn, None)(flat)
            out = chunk.new_empty(n * k) if r == root else None
            ep = _cuda._arena(comm, "pull", chunk.nbytes)
            ep.run(K.gather_to_root(ep, chunk, root, out))
            _last_rooted_plan = {
                "kind": "reduce_scatter_to_root", "rounds": 1,
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
    return _launch(run)


def gather_dev(comm, sendbuf, root: int = 0):
    """MPI_Gather (coll/xla.py:719-732): ``(n, *shape)`` on the root, None
    elsewhere. Below the rooted threshold it is the allgather; above it
    every rank stages and the root alone pulls (K2), so a non-root
    allocates nothing."""
    if _stages(None, sendbuf):
        return _stage("gather_dev", comm, sendbuf, root)
    _check_buf("gather", comm, sendbuf)
    _check_root("gather", comm, root)
    n, r = comm.size, comm.rank
    if n == 1 or not _rooted(sendbuf.nbytes * n):
        out = allgather_dev(comm, sendbuf)
        return out if r == root else None
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter(tm, "gather", comm, sendbuf, root=root)

    def run():
        global _last_rooted_plan
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
    return _launch(run)


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
        _check_buf(kind, comm, sendbuf, any_dtype=True)
        shape = tuple(sendbuf.shape[1:] if rest_only else sendbuf.shape)
        if like is None:
            _scatter_meta(comm, (kind, root), root,
                          (shape, _dtype_name(sendbuf.dtype)))
        return shape, sendbuf.dtype
    if like is not None:
        _check_buf(kind, comm, like, any_dtype=True)
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
        if _stages(None, sendbuf):
            return _stage("scatter_dev", comm, sendbuf, root, like)
        _check_buf("scatter", comm, sendbuf)
        return sendbuf.clone()
    shape, dtype = _scatter_shape("scatter", comm, sendbuf, root, like,
                                  False)
    if dtype in _HOST_ONLY:  # every rank knows it now
        return _stage("scatter_dev", comm, sendbuf, root, like)
    if len(shape) < 1 or shape[0] % n:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"scatter: dim 0 of shape {shape} is not divisible by the comm "
            f"size {n}")

    def run():
        out = torch.empty((shape[0] // n,) + shape[1:], dtype=dtype,
                          device=device_plane.device())
        if out.numel():
            ep = _cuda._arena(comm, "pull", n * out.nbytes)
            ep.run(K.scatter_from_root(
                ep, sendbuf.reshape(-1) if comm.rank == root else None, root,
                out.view(-1)))
        return out
    return _launch(run)


def scatterv_dev(comm, sendbuf, counts, root: int = 0, like=None):
    """MPI_Scatterv (coll/xla.py:945-1018): rank r gets ``counts[r]`` rows
    of the root's packed ``sendbuf`` (the root's first sum(counts) rows).
    The root stages them unpadded; rank r pulls rows [sum(counts[:r]),
    +counts[r]) (K2). Non-roots: trailing dims and dtype from ``like`` or
    the metadata round, as :func:`scatter_dev`."""
    _check_root("scatterv", comm, root)
    n, r = comm.size, comm.rank
    if n == 1:
        if _stages(None, sendbuf):
            return _stage("scatterv_dev", comm, sendbuf, counts, root, like)
        _check_buf("scatterv", comm, sendbuf)
        return sendbuf.clone()
    counts = _counts(counts, "scatterv", n)
    rest, dtype = _scatter_shape("scatterv", comm, sendbuf, root, like,
                                 True)
    if dtype in _HOST_ONLY:  # every rank knows it now
        return _stage("scatterv_dev", comm, sendbuf, counts, root, like)
    total, row = sum(counts), _row_elems(rest)
    if r == root and (sendbuf.dim() < 1 or sendbuf.shape[0] < total):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"scatterv: the root's {tuple(sendbuf.shape)} holds fewer than "
            f"the {total} rows of counts {counts}")
    tm = _mon.TRAFFIC
    if tm is not None and r == root:
        _meter(tm, "scatterv", comm, sendbuf, root=root, counts=counts,
               row_bytes=sendbuf.nbytes / sendbuf.shape[0]
               if sendbuf.shape[0] else 0.0)

    def run():
        out = torch.empty((counts[r],) + rest, dtype=dtype,
                          device=device_plane.device())
        pieces = [(sendbuf[:total].reshape(-1), 0)] if r == root else []
        _ragged(comm, dtype, total * row, pieces,
                [(root, _offsets(counts)[r] * row, counts[r] * row, 0)],
                out.view(-1))
        return out
    return _launch(run)


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
    if _stages(None, sendbuf):
        return _stage("allgatherv_dev", comm, sendbuf, counts)
    if comm.size == 1:
        _check_buf("allgatherv", comm, sendbuf)
        return sendbuf.clone()
    counts, rest, row = _v_block("allgatherv", comm, sendbuf, counts)

    def run():
        out = sendbuf.new_empty((sum(counts),) + rest)
        offs = _offsets(counts)
        _ragged(comm, sendbuf.dtype, max(counts) * row,
                [(sendbuf.reshape(-1), 0)],
                [(p, 0, c * row, o * row) for p, (c, o) in
                 enumerate(zip(counts, offs))], out.view(-1))
        return out
    return _launch(run)


def gatherv_dev(comm, sendbuf, counts, root: int = 0):
    """MPI_Gatherv (coll/xla.py:1057-1059): the packed result on the root,
    None elsewhere. Every rank stages, the root alone pulls; the
    reference runs the allgatherv and drops it on the non-roots (same
    bits), the port allocates nothing there."""
    _check_root("gatherv", comm, root)
    if _stages(None, sendbuf):
        return _stage("gatherv_dev", comm, sendbuf, counts, root)
    if comm.size == 1:
        _check_buf("gatherv", comm, sendbuf)
        return sendbuf.clone()
    counts, rest, row = _v_block("gatherv", comm, sendbuf, counts)

    def run():
        r = comm.rank
        out = sendbuf.new_empty((sum(counts),) + rest) if r == root else None
        spans = [(p, 0, c * row, o * row) for p, (c, o) in
                 enumerate(zip(counts, _offsets(counts)))] if r == root else []
        _ragged(comm, sendbuf.dtype, max(counts) * row,
                [(sendbuf.reshape(-1), 0)], spans,
                out.view(-1) if out is not None else None)
        return out
    return _launch(run)


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


def alltoallv_dev(comm, sendbuf, scounts, rcounts, max_count=None, *,
                  _expert_tokens: bool = True):
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
      have no counterpart.

    The monitoring plane records the actual splits (scounts[r] rows to
    rank r) and, as the EP dispatch site, scounts as the per-expert load;
    the internal ``_expert_tokens=False`` (coll/xla.py:1063) keeps a call
    whose scounts index ranks, not experts, out of the expert load."""
    if _stages(None, sendbuf):
        return _stage("alltoallv_dev", comm, sendbuf, scounts, rcounts,
                      max_count)
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
    tm = _mon.TRAFFIC
    if tm is not None:
        tm.coll("alltoallv", comm, sendbuf.nbytes,
                dtype=_dtype_name(sendbuf.dtype), counts=scounts,
                row_bytes=sendbuf.nbytes / sendbuf.shape[0]
                if sendbuf.shape[0] else 0.0)
        if _expert_tokens:
            tm.expert_tokens(scounts)

    def run():
        out = sendbuf.new_empty((sum(rcounts),) + rest)
        _ragged(comm, sendbuf.dtype, staged, pieces,
                [(p, src[p], c * row, o * row) for p, (c, o) in
                 enumerate(zip(rcounts, _offsets(rcounts)))], out.view(-1))
        return out
    return _launch(run)


def reduce_scatter_dev(comm, sendbuf, counts, op=op_mod.SUM,
                       deterministic: Optional[str] = None):
    """MPI_Reduce_scatter (coll/xla.py:1160-1185): the allreduce, then
    this rank's ``counts[rank]`` rows (a copy)."""
    if _stages(op, sendbuf):
        return _stage("reduce_scatter_dev", comm, sendbuf, counts, op,
                      deterministic)
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
    if _stages(op, sendbuf):
        return _stage(kind + "_dev", comm, sendbuf, op, deterministic)
    _det_ok(deterministic)
    _check_buf(kind, comm, sendbuf)
    opn = _opn(kind, op, sendbuf.dtype)

    def run():
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
    return _launch(run)


def scan_dev(comm, sendbuf, op=op_mod.SUM,
             deterministic: Optional[str] = None):
    """MPI_Scan (coll/xla.py:1188-1211): the inclusive prefix over ranks
    0..rank."""
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter(tm, "scan", comm, sendbuf, op)
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

    leaves, treedef = zl.tree_flatten(bufs)
    if _stages(op, *leaves):
        return lambda: _stage("allreduce_multi_dev", comm, bufs, op,
                              deterministic)
    det = _det_ok(deterministic)
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


def _tree_nbytes(bufs) -> int:
    """The bytes of a pytree's tensor leaves (a flight-recorder entry's
    size)."""
    from ompi_tpu_torch.zero import layout as zl

    return sum(getattr(t, "nbytes", 0) for t in zl.tree_leaves(bufs))


def _meter_multi(tm, kind: str, comm, bufs, op) -> None:
    """:func:`_meter` for a pytree: the leaves' bytes, the first leaf's
    dtype (coll/xla.py:1385, :1808)."""
    from ompi_tpu_torch.zero import layout as zl

    leaves, _ = zl.tree_flatten(bufs)
    if comm.size > 1 and leaves and not _stages(op, *leaves):
        tm.coll(kind, comm, sum(t.nbytes for t in leaves),
                dtype=_dtype_name(leaves[0].dtype))


def allreduce_multi_dev(comm, bufs, op=op_mod.SUM,
                        deterministic: Optional[str] = None):
    """Fused allreduce over a pytree of device tensors (coll/xla.py:
    1241-1409): dtype-segregated flat buckets, one allreduce schedule per
    bucket, split back into a new pytree. Under ``'linear'`` every
    element folds in rank order, so the result is bitwise the per-buffer
    loop's."""
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter_multi(tm, "allreduce_multi", comm, bufs, op)
    launcher = _allreduce_multi_prep(comm, bufs, op, deterministic)
    obs = _tobs.OBSERVER
    if obs is not None:
        from ompi_tpu_torch.zero import layout as zl

        leaves = zl.tree_leaves(bufs)
        if leaves:
            launcher = _observed(launcher, "allreduce_multi", comm,
                                 leaves[0], op, deterministic,
                                 nbytes=_tree_nbytes(bufs))
    fl = _flight.FLIGHT
    if fl is None:
        return launcher()
    tok = fl.enter("allreduce_multi_dev", getattr(comm, "cid", -1),
                   _tree_nbytes(bufs))
    try:
        return launcher()
    finally:
        fl.exit(tok)


# ---------------------------------------------------------------------------
# the zero/ bucket slots (coll/xla.py:1668-1985)


def _zero_rs_runs(comm, leaves, plan, opn, det) -> list:
    """Per bucket of ``plan``: ``run(flat) -> shard``, the padded flat's
    reduce-scatter (its arena mapped now), None for an empty bucket."""
    runs = []
    for b, idxs in enumerate(plan.buckets):
        if plan.padded[b] == 0:
            runs.append(None)
            continue
        runs.append(_reduce_scatter_run(comm, plan.padded[b],
                                        leaves[idxs[0]].dtype, opn, det))
    return runs


def _zero_rs_opn(op) -> op_mod.Op:
    opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
    if opn is None or opn.name not in K.OP_CODES:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_device: reduce_scatter_multi op {op!r} is outside "
            "SUM/PROD/MIN/MAX")
    return opn


def _reduce_scatter_multi_prep(comm, bufs, op=op_mod.SUM,
                               deterministic: Optional[str] = None):
    """Plan the ZeroPlan's buckets and each bucket's reduce-scatter
    schedule (arenas mapped now); the launcher packs each bucket's
    current contents, reduce-scatters it and returns this rank's
    ShardedState. A staged op or dtype, one rank or an empty pytree run
    the blocking slot at each call (no plan to hold)."""
    from ompi_tpu_torch.zero import layout as zl

    leaves, treedef = zl.tree_flatten(bufs)
    if _stages(op, *leaves):
        return lambda: _stage("reduce_scatter_multi_dev", comm, bufs, op,
                              deterministic)
    det = _det_ok(deterministic)
    opn = _zero_rs_opn(op)
    if comm.size == 1:
        # reducing over one rank is the identity: a local pack + slice
        return lambda: zl.ShardedState.from_full(comm, bufs)
    for t in leaves:
        _check_leaf("reduce_scatter_multi", comm, t)
    metas = zl._fuse_metas(leaves)
    plan = zl.ZeroPlan(metas, int(bucket_var.get()), comm.size)
    runs = _zero_rs_runs(comm, leaves, plan, opn, det)

    def launch():
        shards = []
        for b, idxs in enumerate(plan.buckets):
            flat = zl.pack(leaves, idxs, plan.padded[b] - plan.elems[b])
            shards.append(runs[b](flat) if runs[b] is not None
                          else flat.new_empty(0))
            pvar.record("zero_rs_launches")
        pvar.record("zero_fused_bytes", plan.nbytes)
        pvar.record("zero_pad_bytes", plan.pad_bytes)
        return zl.ShardedState(plan, metas, treedef, shards, comm.rank,
                               comm.size)
    return launch


def reduce_scatter_multi_dev(comm, bufs, op=op_mod.SUM,
                             deterministic: Optional[str] = None):
    """Bucketed reduce-scatter over a pytree of device tensors (the ZeRO
    gradient-sharding step): dtype-segregated flat buckets padded to a
    multiple of the comm size, one reduce-scatter per bucket, returning
    this rank's ShardedState. ``'linear'`` is bit-identical to the
    per-buffer allreduce fold."""
    tm = _mon.TRAFFIC
    if tm is not None:
        _meter_multi(tm, "reduce_scatter_multi", comm, bufs, op)
    launcher = _reduce_scatter_multi_prep(comm, bufs, op, deterministic)
    fl = _flight.FLIGHT
    if fl is None:
        return launcher()
    tok = fl.enter("reduce_scatter_multi_dev", getattr(comm, "cid", -1),
                   _tree_nbytes(bufs))
    try:
        return launcher()
    finally:
        fl.exit(tok)


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


def _gather(ep, shard, padded: int, metas, idxs):
    """One bucket's allgather (one :func:`_launch`, as each of coll/xla's
    buckets is one ``ctx.launch``, coll/xla.py:1894): every rank's shard
    into the padded bucket through the pull arena ``ep`` (None for an
    empty shard), split into the bucket's leaves."""
    from ompi_tpu_torch.zero import layout as zl

    full = shard.new_empty(padded)
    if ep is not None:
        ep.run(K.gather(ep, shard, full))
    return zl.split(full, metas, idxs)


def _gather_bucket(comm, state, b: int):
    shard = state.shards[b]
    _check_leaf("allgather_multi", comm, shard)
    ep = _cuda._arena(comm, "pull", shard.nbytes)
    leaves = _launch(_gather, ep, shard, state.plan.padded[b], state.metas,
                     state.plan.buckets[b], op="allgather_multi")
    pvar.record("zero_ag_launches")
    return leaves


def _allgather_multi_prep(comm, state):
    """Check the state and map each bucket's allgather arena now; the
    launcher gathers the bound shards into the full pytree. Beside it
    the two hooks of coll/xla's (coll/xla.py:1864-1920), which
    :class:`PersistentDeviceRequest` exposes for ZeRO stage 3's stream:
    ``rebind(new_state)`` swaps in a same-plan state's shards (no new
    plan, no new arena) and ``release()`` drops the bound shards. One
    rank, an empty state and staged dtypes gather at each call and have
    no hooks."""
    from ompi_tpu_torch.zero import layout as zl

    _zero_state_check(comm, state)
    if comm.size == 1 or not state.shards or _stages(None, *state.shards):
        return lambda: allgather_multi_dev(comm, state)
    plan = state.plan
    eps = []
    for b, shard in enumerate(state.shards):
        _check_leaf("allgather_multi", comm, shard)
        eps.append(_cuda._arena(comm, "pull", shard.nbytes)
                   if shard.numel() else None)
    bound = list(state.shards)
    n_leaves = sum(len(idxs) for idxs in plan.buckets)

    def launch():
        if bound[0] is None:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                "allgather_multi start: operands released — rebind() a "
                "fresh state first")
        outs = [None] * n_leaves
        for b, idxs in enumerate(plan.buckets):
            for i, leaf in zip(idxs, _launch(
                    _gather, eps[b], bound[b], plan.padded[b], state.metas,
                    idxs, op="allgather_multi")):
                outs[i] = leaf
            pvar.record("zero_ag_launches")
        pvar.record("zero_fused_bytes", plan.nbytes)
        return zl.tree_unflatten(state.treedef, outs)

    def rebind(new_state) -> None:
        _zero_state_check(comm, new_state)
        if new_state.plan.buckets != plan.buckets \
                or new_state.plan.dtypes != plan.dtypes:
            raise errors.MPIError(
                errors.ERR_ARG,
                "allgather_multi rebind: state packed by a different plan "
                "(the schedules and arenas are per layout; re-init for a "
                "new bucket layout)")
        for b, shard in enumerate(new_state.shards):
            _check_leaf("allgather_multi", comm, shard)
            bound[b] = shard

    def release() -> None:
        for b in range(len(bound)):
            bound[b] = None

    launch.rebind = rebind
    launch.release = release
    return launch


def allgather_multi_dev(comm, state):
    """Bucketed allgather of a ShardedState back to the full pytree (the
    ZeRO parameter-rebuild step): one allgather per bucket, rank-order
    concat (= the pack order), pad dropped, leaf shapes restored."""
    from ompi_tpu_torch.zero import layout as zl

    _zero_state_check(comm, state)
    if _stages(None, *state.shards):
        return _stage("allgather_multi_dev", comm, state)
    if not state.shards:
        return zl.tree_unflatten(state.treedef, [])
    if comm.size == 1:
        # n=1 shards ARE the full padded buckets
        return state.unpack(state.shards)
    tm = _mon.TRAFFIC
    if tm is not None:
        tm.coll("allgather_multi", comm, state.plan.nbytes,
                dtype=state.plan.dtypes[0] if state.plan.dtypes else "")
    launcher = _allgather_multi_prep(comm, state)
    fl = _flight.FLIGHT
    if fl is None:
        return launcher()
    tok = fl.enter("allgather_multi_dev", getattr(comm, "cid", -1),
                   state.plan.nbytes)
    try:
        return launcher()
    finally:
        fl.exit(tok)


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

    ts = [t for t in zl.tree_leaves(getattr(obj, "shards", obj))
          if isinstance(t, torch.Tensor)]
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
        return _launch(DeviceRequest, None, torch.device("cpu"))
    token = torch.ones(1, dtype=torch.int32, device=device_plane.device())
    return DeviceRequest(
        _allreduce_prep(comm, token, op_mod.SUM, "linear")(), token.device)


def barrier_dev(comm) -> None:
    """Device barrier (coll/xla.py:926-942): :func:`ibarrier_dev`,
    waited."""
    tm = _mon.TRAFFIC
    if tm is not None and comm.size > 1:
        tm.coll("barrier", comm, 0)
    fl = _flight.FLIGHT
    if fl is None:
        ibarrier_dev(comm).wait()
        return
    tok = fl.enter("barrier_dev", getattr(comm, "cid", -1), 0)
    try:
        ibarrier_dev(comm).wait()
    finally:
        fl.exit(tok)


class PersistentDeviceRequest:
    """MPI-4 persistent device collective (coll/xla.py:1501-1600
    ``PersistentDeviceRequest``): init checks the arguments, picks the
    schedule and maps its arena; each :meth:`start` runs the prepared
    schedule once on the bound tensors' current contents (MPI's
    persistent semantics: change the buffer, start again, get the new
    result). An inactive request is complete; a start while a cycle is
    active, or after :meth:`free`, raises ERR_REQUEST.

    :meth:`rebind` calls the launcher's ``rebind`` hook where its prep
    installed one (``allgather_multi_init_dev``'s: ZeRO stage 3 swaps a
    same-plan state's shards in after each step) and raises
    ERR_NOT_SUPPORTED where it did not (the other slots read their bound
    tensors at every start: change them in place). :meth:`discard` drops
    a finished cycle's result; :meth:`free` also calls the launcher's
    ``release`` hook."""

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
        """Swap the bound operands for same-signature values without a
        new plan (coll/xla.py:1526-1551). A request without the hook
        raises ERR_NOT_SUPPORTED whether or not a cycle is active (the
        reference asks about the cycle first)."""
        if self._launch is None:
            raise errors.MPIError(errors.ERR_REQUEST,
                                  "rebind: persistent request already freed")
        hook = getattr(self._launch, "rebind", None)
        if hook is None:
            raise errors.MPIError(
                errors.ERR_NOT_SUPPORTED,
                "rebind: this persistent request reads its bound tensors at "
                "every start — change them in place, or free() and re-init")
        if self.active:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                "rebind: cycle still active — wait() it to completion "
                "before swapping operands")
        hook(*args, **kwargs)

    def discard(self) -> None:
        """Drop the finished cycle's result, so nothing here pins its
        tensors (stage 3's free-after-use); the request stays usable."""
        self._inner = None

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
        release = getattr(self._launch, "release", None)
        if release is not None:
            release()
        self._launch = None
        self._inner = None


# ---------------------------------------------------------------------------
# the partitioned collectives (coll/xla.py:2006-2676): one partition per
# pytree leaf, a bucket's collective launched by the Pready of its last leaf


class _PartitionedBase:
    """The MPI-4 partitioned bookkeeping of a pytree request:
    ``start()`` opens a cycle, ``Pready(i[, value])`` marks leaf i ready
    (optionally rebinding this cycle's tensor), ``wait()`` closes the
    cycle and publishes ``.array``. Inactive reads as complete (MPI).
    Erroneous calls raise: Pready before start or twice in a cycle, a
    start while a cycle is active, a wait with leaves never made ready
    (every rank's collective would wait for them), and any call after
    :meth:`free`."""

    _NAME = ""

    def __init__(self, leaves, treedef) -> None:
        self.id = next(rq._req_ids)
        self.status = rq.Status()
        self.persistent = True
        self._treedef = treedef
        self._n = len(leaves)
        self._bound = list(leaves)
        self._ready = None  # None: inactive
        self._n_ready = 0
        self._arr = None
        self._freed = False

    @property
    def active(self) -> bool:
        return self._ready is not None

    @property
    def array(self):
        """The result of the last completed cycle."""
        return self._arr

    def start(self) -> None:
        if self._freed:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"{self._NAME} start: request already freed")
        if self.active:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"{self._NAME} start: previous cycle still active — wait() "
                "it to completion first (starting an active request is "
                "erroneous)")
        self._ready = [False] * self._n
        self._n_ready = 0
        self._open()

    def _open(self) -> None:
        pass

    def Pready(self, idx: int, value=None) -> None:
        if self._ready is None:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"Pready({idx}): request inactive — call start() before "
                "marking partitions ready")
        if not 0 <= idx < self._n:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"Pready({idx}): partition index out of [0,{self._n})")
        if self._ready[idx]:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"Pready({idx}): partition already marked ready this cycle "
                "(double-Pready is erroneous)")
        if value is not None:
            self._rebind(idx, value)
        self._ready[idx] = True
        self._n_ready += 1
        pvar.record("part_pready")
        self._arrived(idx)

    def _rebind(self, idx: int, value) -> None:
        self._bound[idx] = value

    def _arrived(self, idx: int) -> None:
        pass

    def Pready_range(self, lo: int, hi: int) -> None:
        for i in range(lo, hi + 1):
            self.Pready(i)

    def Pready_list(self, idxs) -> None:
        for i in idxs:
            self.Pready(i)

    @property
    def completed(self) -> bool:
        """Live, for the plural wait / test helpers: an active cycle with
        unready partitions is incomplete (only wait() raises on it)."""
        return self._ready is None or self._n_ready == self._n

    def test(self) -> bool:
        return self.completed

    def wait(self, timeout=None):
        if self._ready is None:
            return self.status  # inactive: complete at once
        if self._n_ready < self._n:
            missing = [i for i, r in enumerate(self._ready) if not r]
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"{self._NAME} wait: partitions {missing} never marked "
                "ready — the bucket collective cannot launch and the wait "
                "would deadlock every rank")
        self._arr = self._finalize()
        self._ready = None  # the cycle closed: inactive again
        return self.status

    def retrieve_status(self):
        # the plural helpers complete a request through completed +
        # retrieve_status, never wait(): a fully ready cycle closes here
        if self._ready is not None and self._n_ready == self._n:
            self.wait()
        return self.status

    def cancel(self) -> None:  # launched collectives are not cancelable
        pass

    def free(self) -> None:
        """Drop the bound tensors and results; a later start raises."""
        self._freed = True
        self._bound = [None] * self._n
        self._ready = None
        self._arr = None


class _BucketedPartitioned(_PartitionedBase):
    """Init plans the buckets and maps their arenas; the Pready of a
    bucket's last leaf runs the bucket's schedule at once (its host
    steps inside the call; an event recorded after the last launch says
    when the device is done). A value given to Pready must match the
    bound leaf's shape, dtype and device (``_VALUE_ERROR`` otherwise,
    the reference's class)."""

    _VALUE_ERROR = errors.ERR_ARG

    def __init__(self, comm, leaves, treedef, buckets) -> None:
        from ompi_tpu_torch.zero import layout as zl

        super().__init__(leaves, treedef)
        self._comm = comm
        self._metas = zl._fuse_metas(leaves)
        self._devices = [t.device for t in leaves]
        self._buckets = tuple(buckets)
        self._leaf_bucket = {i: b for b, idxs in enumerate(self._buckets)
                             for i in idxs}
        self._event: Optional[stream.Event] = None
        self._fl_tok: Optional[int] = None

    def _open(self) -> None:
        self._pending = [len(idxs) for idxs in self._buckets]
        self._results = [None] * len(self._buckets)
        # the cycle is one flight-recorder entry, start to wait
        # (coll/xla.py:2077-2079, :2190-2196)
        fl = _flight.FLIGHT
        self._fl_tok = None if fl is None else fl.enter(
            self._CYCLE, getattr(self._comm, "cid", -1), self.nbytes)

    def _rebind(self, idx: int, value) -> None:
        from ompi_tpu_torch.zero import layout as zl

        shape, dtype, _nb = self._metas[idx]
        if not isinstance(value, torch.Tensor) \
                or tuple(value.shape) != shape \
                or zl.dtype_name(value.dtype) != dtype \
                or value.device != self._devices[idx]:
            raise errors.MPIError(
                self._VALUE_ERROR,
                f"Pready({idx}): value {tuple(getattr(value, 'shape', ()))}"
                f"/{getattr(value, 'dtype', type(value).__name__)} on "
                f"{getattr(value, 'device', '?')} does not match the bound "
                f"leaf {shape}/{dtype} on {self._devices[idx]} (the "
                "schedules are planned per signature; re-init for a new "
                "one)")
        self._bound[idx] = value

    def _arrived(self, idx: int) -> None:
        rec = _trace.RECORDER
        if rec is not None:
            rec.instant("pready", self._SUBSYS, {"partition": idx})
        b = self._leaf_bucket[idx]
        self._pending[b] -= 1
        if self._pending[b] == 0:
            self._results[b] = self._flush(b, idx)
            self._event = stream.Event(self._devices[idx]).record()

    @property
    def completed(self) -> bool:
        if self._ready is None:
            return True
        if self._n_ready < self._n:
            return False
        return self._event is None or self._event.query()

    def _finalize(self):
        if self._event is not None:
            self._event.wait()
        out = self._collect()
        tok, self._fl_tok = self._fl_tok, None
        if tok is not None:
            fl = _flight.FLIGHT
            if fl is not None:
                fl.exit(tok)
        return out

    def free(self) -> None:
        super().free()
        self._results = []


class PartitionedAllreduceRequest(_BucketedPartitioned):
    """MPI-4 partitioned fused allreduce (``Pallreduce_init``;
    coll/xla.py:2006-2247): the buckets and schedules of
    ``allreduce_multi_dev`` (K3 under 'linear', K1 + K2 on the ring), so
    'linear' and 'ring' are bitwise the unpartitioned call's. A bucket
    flush counts ``coll_device_launches`` and ``part_bucket_flushes``,
    and ``part_overlap_flushes`` when later partitions are still
    pending; ``.array`` is the reduced pytree."""

    _NAME = "Pallreduce"
    _SUBSYS, _CYCLE = "part", "pallreduce_cycle"

    def __init__(self, comm, leaves, treedef, opn, det) -> None:
        from ompi_tpu_torch.zero import layout as zl

        plan = zl._FusePlan(zl._fuse_metas(leaves), int(bucket_var.get()))
        super().__init__(comm, leaves, treedef, plan.buckets)
        self.nbytes = plan.nbytes
        self._runs = []
        for idxs in plan.buckets:
            m = sum(leaves[i].numel() for i in idxs)
            self._runs.append(_allreduce_run(
                comm, m, leaves[idxs[0]].dtype, opn, det) if m else None)

    def _run_bucket(self, b: int):
        from ompi_tpu_torch.zero import layout as zl

        flat = zl.pack(self._bound, self._buckets[b], 0)
        return self._runs[b](flat) if self._runs[b] is not None \
            else flat.clone()

    def _flush(self, b: int, trigger: int):
        idxs = self._buckets[b]
        overlap = self._n_ready < self._n
        rec = _trace.RECORDER
        if rec is None:
            red = _launch(self._run_bucket, b)
        else:
            # the flush span names the Pready that released the bucket
            # and whether later partitions were still pending
            # (coll/xla.py:2119-2141)
            t0 = _trace.now()
            red = _launch(self._run_bucket, b)
            t1 = _trace.now()
            nb = sum(self._metas[i][2] for i in idxs)
            rec.record("part_bucket_flush", "part", t0, t1,
                       {"bucket": b, "trigger_partition": trigger,
                        "overlap": overlap, "nbytes": nb})
            _trace.hist("part_bucket_flush", nb, t1 - t0)
        tm = _mon.TRAFFIC
        if tm is not None:  # the bucket's allreduce, in the part context
            tm.coll("allreduce", self._comm,
                    sum(self._metas[i][2] for i in idxs),
                    dtype=self._metas[idxs[0]][1], ctx="part")
        pvar.record("part_bucket_flushes")
        if overlap:
            pvar.record("part_overlap_flushes")
        return red

    def _collect(self):
        from ompi_tpu_torch.zero import layout as zl

        outs = [None] * self._n
        for b, idxs in enumerate(self._buckets):
            for i, leaf in zip(idxs, zl.split(self._results[b], self._metas,
                                              idxs)):
                outs[i] = leaf
        pvar.record("coll_device_fused_bytes", self.nbytes)
        return zl.tree_unflatten(self._treedef, outs)


class PartitionedReduceScatterRequest(_BucketedPartitioned):
    """MPI-4 partitioned fused reduce-scatter (``Preduce_scatter_init``;
    coll/xla.py:2350-2549), the overlapped ZeRO gradient step: the
    ZeroPlan and schedules of ``reduce_scatter_multi_dev``, so 'linear'
    and 'ring' are bitwise its result. A flush counts
    ``zero_rs_launches``, and ``zero_overlap_flushes`` when later
    partitions are still pending; ``.array`` is the cycle's
    ShardedState."""

    _NAME = "Preduce_scatter"
    _VALUE_ERROR = errors.ERR_COUNT
    _SUBSYS, _CYCLE = "zero", "preduce_scatter_cycle"

    def __init__(self, comm, leaves, treedef, opn, det) -> None:
        from ompi_tpu_torch.zero import layout as zl

        metas = zl._fuse_metas(leaves)
        plan = zl.ZeroPlan(metas, int(bucket_var.get()), comm.size)
        super().__init__(comm, leaves, treedef, plan.buckets)
        self._plan = plan
        self.nbytes = plan.nbytes
        self._runs = _zero_rs_runs(comm, leaves, plan, opn, det)

    def _run_bucket(self, b: int):
        from ompi_tpu_torch.zero import layout as zl

        plan = self._plan
        flat = zl.pack(self._bound, self._buckets[b],
                       plan.padded[b] - plan.elems[b])
        return self._runs[b](flat) if self._runs[b] is not None \
            else flat.new_empty(0)

    def _flush(self, b: int, trigger: int):
        idxs = self._buckets[b]
        overlap = self._n_ready < self._n
        rec = _trace.RECORDER
        if rec is None:
            shard = self._run_bucket(b)
        else:  # coll/xla.py:2459-2477
            t0 = _trace.now()
            shard = self._run_bucket(b)
            t1 = _trace.now()
            nb = sum(self._metas[i][2] for i in idxs)
            rec.record("zero_bucket_flush", "zero", t0, t1,
                       {"bucket": b, "trigger_partition": trigger,
                        "overlap": overlap, "nbytes": nb})
            _trace.hist("zero_bucket_flush", nb, t1 - t0)
        tm = _mon.TRAFFIC
        if tm is not None:
            tm.coll("reduce_scatter", self._comm,
                    sum(self._metas[i][2] for i in idxs),
                    dtype=self._metas[idxs[0]][1], ctx="part")
        pvar.record("zero_rs_launches")
        if overlap:
            pvar.record("zero_overlap_flushes")
        return shard

    def _collect(self):
        from ompi_tpu_torch.zero import layout as zl

        pvar.record("zero_fused_bytes", self.nbytes)
        pvar.record("zero_pad_bytes", self._plan.pad_bytes)
        return zl.ShardedState(self._plan, self._metas, self._treedef,
                               list(self._results), self._comm.rank,
                               self._comm.size)


class _TrivialPartitioned(_PartitionedBase):
    """The gated cases (one rank, a staged op or dtype, an empty pytree;
    coll/accelerator's staged slots too): the full partitioned
    bookkeeping, with the collective deferred to wait() through the
    comm's ``_SLOT``. Correct, no early flush."""

    _SLOT = ""

    def __init__(self, comm, bufs, op, deterministic) -> None:
        from ompi_tpu_torch.zero import layout as zl

        leaves, treedef = zl.tree_flatten(bufs)
        super().__init__(leaves, treedef)
        self._comm = comm
        self._op = op
        self._det = deterministic

    def _finalize(self):
        from ompi_tpu_torch.zero import layout as zl

        tree = zl.tree_unflatten(self._treedef, self._bound)
        return getattr(self._comm.coll, self._SLOT)(
            self._comm, tree, self._op, deterministic=self._det)


class _TrivialPartitionedAllreduce(_TrivialPartitioned):
    """Pallreduce's gated handle (coll/xla.py:2250-2332)."""

    _NAME, _SLOT = "Pallreduce", "allreduce_multi_dev"


class _TrivialPartitionedReduceScatter(_TrivialPartitioned):
    """Preduce_scatter's gated handle (coll/xla.py:2552-2655)."""

    _NAME, _SLOT = "Preduce_scatter", "reduce_scatter_multi_dev"


def pallreduce_init_dev(comm, bufs, op=op_mod.SUM,
                        deterministic: Optional[str] = None):
    """Partitioned fused allreduce init (coll/xla.py:2334-2347): one
    partition per pytree leaf; each bucket's allreduce runs the moment
    its last leaf is Pready'd. One rank, a staged op or dtype and an
    empty pytree take the deferred handle."""
    from ompi_tpu_torch.zero import layout as zl

    leaves, treedef = zl.tree_flatten(bufs)
    if _stages(op, *leaves) or comm.size == 1 or not leaves:
        return _TrivialPartitionedAllreduce(comm, bufs, op, deterministic)
    det = _det_ok(deterministic)
    for t in leaves:
        _check_buf("pallreduce", comm, t)
    opn = None
    for dtype in {t.dtype for t in leaves}:
        opn = _opn("pallreduce", op, dtype)
    return PartitionedAllreduceRequest(comm, leaves, treedef, opn, det)


def preduce_scatter_init_dev(comm, bufs, op=op_mod.SUM,
                             deterministic: Optional[str] = None):
    """Partitioned fused reduce-scatter init (coll/xla.py:2658-2675): one
    partition per pytree leaf; each ZeroPlan bucket's reduce-scatter
    runs the moment its last leaf is Pready'd; wait() publishes the
    ShardedState. One rank, a staged op or dtype and an empty pytree take
    the deferred handle."""
    from ompi_tpu_torch.zero import layout as zl

    leaves, treedef = zl.tree_flatten(bufs)
    if _stages(op, *leaves) or comm.size == 1 or not leaves:
        return _TrivialPartitionedReduceScatter(comm, bufs, op,
                                                deterministic)
    det = _det_ok(deterministic)
    opn = _zero_rs_opn(op)
    for t in leaves:
        _check_leaf("preduce_scatter", comm, t)
    return PartitionedReduceScatterRequest(comm, leaves, treedef, opn, det)


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
_PERSISTENT = {**{name: _pinit(prep, name) for name, prep in (
    ("allreduce_init_dev", _allreduce_prep),
    ("bcast_init_dev", _bcast_prep),
    ("allgather_init_dev", _allgather_prep),
    ("alltoall_init_dev", _alltoall_prep),
    ("reduce_scatter_block_init_dev", _reduce_scatter_block_prep),
    ("allreduce_multi_init_dev", _allreduce_multi_prep),
    ("reduce_scatter_multi_init_dev", _reduce_scatter_multi_prep),
    ("allgather_multi_init_dev", _allgather_multi_prep))},
    "pallreduce_init_dev": pallreduce_init_dev,
    "preduce_scatter_init_dev": preduce_scatter_init_dev}


class CollDevice(registry.Component):
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
        from ompi_tpu_torch.coll import device_neighbor

        # the neighbourhood slots: topology comms only (coll/xla.py:2786)
        return {**_BLOCKING, **_NONBLOCKING, **_PERSISTENT,
                **device_neighbor.slots(comm)}
