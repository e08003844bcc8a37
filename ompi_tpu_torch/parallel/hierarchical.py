"""Hierarchical device collectives — the two-level composition layer.

The port of :mod:`ompi_tpu.parallel.hierarchical`. Reference:
ompi/mca/coll/han (coll_han.h:22-33,62-63) splits a communicator into an
intra-node ``low`` and an inter-node ``up`` communicator and composes
per-level algorithms (allreduce = low reduce_scatter -> up allreduce ->
low allgather), because the two levels have bandwidths an order of
magnitude apart. The JAX package maps the levels onto a TPU pod's ICI
(inside a slice) and DCN (between slices); on GPUs they are the NVLink
domain of one node and the network between nodes. The axis names stay
the reference's, ``("dcn", "ici")``.

The two levels are a 2-axis :class:`~ompi_tpu_torch.parallel.mesh.Mesh`
over the ranks of a communicator, rank = dcn x n_ici + ici, and each axis
is the ``comm.split`` sub-communicator that :mod:`parallel` already
builds: ``ici`` (the ranks of this slice, keyed by ici index) is the
``low`` communicator, ``dcn`` (the ranks with this ici index, keyed by dcn
index) the ``up`` one (:func:`grid`). Every composition below is a few
calls of :mod:`ompi_tpu_torch.parallel.collectives` on those axes, which
take a mesh axis name (resolved against the active mesh) or a
communicator; their gradients come from the collectives' autograd
Functions.

The slice grouping (:func:`slice_split`, :func:`parse_split`,
:func:`hier_mesh`) groups ranks by node in place of the reference's
``device.slice_index``: each rank's hostname (published through the
modex, :func:`node_names`), in contiguous runs of equal length, as
coll/han hashes it. On one machine every rank shares a node, so
``'auto'`` stays flat, and a grid is forced with ``'DxI'``.

The compressed DCN wire formats (:data:`WIRE_DTYPES`) are torch's
``bfloat16``, ``float8_e4m3fn`` and ``float8_e5m2`` (:func:`wire_dtype`);
torch always has fp8, so :func:`wire_degrade` is the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.parallel import collectives as C

#: canonical axis names for the two levels
DCN_AXIS = "dcn"
ICI_AXIS = "ici"

#: compressed-DCN wire formats: name -> (torch dtype, bytes per element,
#: finfo.max); the byte model's copy is ``monitoring.algo.WIRE_ITEMSIZE``
_WIRE = {
    "bf16": (torch.bfloat16, 2, float(torch.finfo(torch.bfloat16).max)),
    "fp8_e4m3": (torch.float8_e4m3fn, 1, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 1, 57344.0),
}
WIRE_DTYPES = tuple(_WIRE)

#: the smallest float32 magnitude that ml_dtypes' float8_e4m3fn cast
#: turns into NaN (e4m3fn has no infinity; 464 itself rounds to 448):
#: torch's cast saturates there instead, so :func:`_encode` maps it to NaN
_E4M3_NAN_ABOVE = 464.0


def wire_dtype(name: str):
    """The torch dtype of a wire-format name, or None for an unknown
    name."""
    spec = _WIRE.get(name)
    return spec[0] if spec is not None else None


def wire_itemsize(name: str) -> int:
    """Bytes per element of a wire format (0 for an unknown name)."""
    spec = _WIRE.get(name)
    return spec[1] if spec is not None else 0


def wire_finfo_max(name: str) -> float:
    """Largest finite value of a wire format (the fp8 scale's
    denominator): 448 for e4m3fn, 57344 for e5m2."""
    return _WIRE[name][2]


def wire_degrade(name: str) -> str:
    """The wire format to use for ``name``: the identity. The reference
    degrades fp8 to bf16 on a jax without fp8 casts; torch always has
    ``float8_e4m3fn`` and ``float8_e5m2``, on the CPU and the card."""
    return name


def _encode(v: torch.Tensor, wire: str) -> torch.Tensor:
    """``v`` cast to the wire dtype with ml_dtypes' rules (the reference
    casts through them): an e4m3fn overflow is NaN, not the largest
    value."""
    if wire == "fp8_e4m3":
        v = torch.where(v.abs() > _E4M3_NAN_ABOVE,
                        torch.full((), float("nan"), dtype=v.dtype,
                                   device=v.device), v)
    return v.to(_WIRE[wire][0])


def _fp8_scale(amax: torch.Tensor, wire: str, dtype) -> torch.Tensor:
    """``where(amax > 0, amax / finfo.max, 1)`` in ``dtype``."""
    return torch.where(amax > 0, amax / wire_finfo_max(wire),
                       torch.ones((), dtype=dtype, device=amax.device)
                       ).to(dtype)


def _unknown_wire(what: str, wire: str) -> errors.MPIError:
    return errors.MPIError(
        errors.ERR_ARG,
        f"{what}: wire dtype {wire!r} unavailable on this stack "
        f"(supported: {sorted(WIRE_DTYPES)})")


# ---------------------------------------------------------------------------
# the slice grouping and the grid


def slice_split(groups) -> int:
    """Number of DCN groups the ranks' labels form (0 = stay flat).

    ``groups`` holds one label per rank in rank order (the rank's node:
    :func:`node_names`); the labels must form contiguous runs of equal
    length, so that mesh rows are nodes. Anything else (interleaved
    ranks, ragged nodes, a label of None) returns 0, and the caller stays
    on the flat schedule. Pure: no cvar."""
    labels = list(groups)
    if any(s is None for s in labels):
        return 0
    runs = []
    for s in labels:  # must be contiguous runs of equal length
        if not runs or runs[-1][0] != s:
            runs.append([s, 0])
        runs[-1][1] += 1
    ids = [g[0] for g in runs]
    if len(set(ids)) != len(ids):  # a node appears twice: ranks
        return 0                   # interleave nodes -> flat
    if len({g[1] for g in runs}) != 1:
        return 0  # ragged nodes cannot form a mesh
    return len(runs) if len(runs) > 1 else 0


def parse_split(spec: str, n_devices: int,
                devices=None) -> Optional[Tuple[int, int]]:
    """Resolve a ``coll_hier_split`` spec to ``(n_dcn, n_ici)``.

    'off' -> None (flat); 'auto' -> group ``devices`` (the ranks' node
    labels) with :func:`slice_split` (None when they form no nested
    mesh); 'DxI' -> an explicit grid; an integer N -> N equal slices.
    Malformed or indivisible specs raise MPIError(ERR_ARG) naming the
    counts: a silently flat mis-spec would void the hierarchy the
    operator asked for."""
    spec = (spec or "auto").strip().lower()
    if spec == "off":
        return None
    if spec == "auto":
        n_dcn = slice_split(devices) if devices is not None else 0
        if n_dcn < 2:
            return None
        return n_dcn, n_devices // n_dcn
    if "x" in spec:
        parts = spec.split("x")
        try:
            d, i = (int(v) for v in parts)
        except ValueError:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"coll_hier_split={spec!r}: expected 'DxI' (e.g. "
                "'2x4'), an integer slice count, 'auto' or 'off'")
        if d < 1 or i < 1 or d * i != n_devices:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"coll_hier_split={spec!r}: a {d}x{i} grid needs "
                f"{d * i} devices, the communicator has {n_devices}")
        return d, i
    try:
        d = int(spec)
    except ValueError:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"coll_hier_split={spec!r}: expected 'DxI', an integer "
            "slice count, 'auto' or 'off'")
    if d < 1 or n_devices % d:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"coll_hier_split={spec!r}: {n_devices} devices do not "
            f"split into {d} equal slices")
    return (d, n_devices // d) if d > 1 else None


def node_names(comm) -> list:
    """Each member's hostname, in comm rank order: every rank publishes
    its own through the modex and reads the members' (no collective;
    every member must call it, as every member plans the grid)."""
    from ompi_tpu_torch.runtime import rte

    rte.modex_send("hier_host", rte.hostname())
    return [rte.modex_recv("hier_host", w) for w in comm.group.ranks]


def hier_mesh(comm=None, n_slices: Optional[int] = None,
              axis_names: Tuple[str, str] = (DCN_AXIS, ICI_AXIS)):
    """A 2-level :class:`~ompi_tpu_torch.parallel.mesh.Mesh` over the
    ranks of ``comm`` (``COMM_WORLD`` by default): outer axis the DCN
    groups, inner the ICI ranks of one group.

    Without ``n_slices`` the ranks group by node (:func:`node_names`),
    each row of the mesh one node, and ragged nodes raise ERR_ARG; with
    it the ranks split evenly in rank order (the reference's CPU-mesh
    stand-in for the slice boundary). Collective over ``comm``."""
    from ompi_tpu_torch.parallel import mesh as mesh_mod

    if comm is None:
        comm = mesh_mod._world()
    n = comm.size
    if n_slices is None:
        names = node_names(comm)
        rows = {}
        for r, h in enumerate(names):
            rows.setdefault(h, []).append(r)
        lens = [len(v) for v in rows.values()]
        if len(set(lens)) != 1:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"ragged slices: {lens} devices per slice; a mesh needs "
                "equal rows")
        n_slices = len(rows)
    if n % n_slices:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"{n} devices do not split into {n_slices} equal slices")
    return mesh_mod.make_mesh(axis_names, (n_slices, n // n_slices), comm)


class Grid:
    """A communicator's (n_dcn, n_ici) grid: the 2-axis mesh over its
    ranks and the two axis sub-communicators, ``low`` (``ici``: this
    slice, keyed by ici index) and ``up`` (``dcn``: this ici column,
    keyed by dcn index)."""

    __slots__ = ("n_dcn", "n_ici", "mesh", "low", "up")

    def __init__(self, comm, n_dcn: int, n_ici: int) -> None:
        from ompi_tpu_torch.parallel import mesh as mesh_mod

        self.n_dcn, self.n_ici = n_dcn, n_ici
        self.mesh = mesh_mod.Mesh(np.arange(n_dcn * n_ici).reshape(
            n_dcn, n_ici), (DCN_AXIS, ICI_AXIS), comm)
        self.low = self.mesh.comm_of(ICI_AXIS)
        self.up = self.mesh.comm_of(DCN_AXIS)
        for sub in (self.low, self.up):
            # a level's own collectives are flat: coll/device's two-level
            # mode never splits a level again
            sub.__dict__["_coll_device_grid"] = False

    def release(self) -> None:
        """Free ``low``, then ``up`` (collective, in this order on every
        rank)."""
        for sub in (self.low, self.up):
            if sub is not None:
                sub.free()
        self.low = self.up = None
        self.mesh = None


def grid(comm, n_dcn: int, n_ici: int) -> Grid:
    """The comm's grid of this shape, split on first use (collective)
    and cached on the comm; coll/hier and coll/device's two-level mode
    share it. :func:`release` frees it with the comm."""
    grids = comm.__dict__.setdefault("_hier_grids", {})
    g = grids.get((n_dcn, n_ici))
    if g is None:
        g = grids[(n_dcn, n_ici)] = Grid(comm, n_dcn, n_ici)
    return g


def release(comm) -> None:
    """Free every grid of ``comm`` (its ``low`` then ``up``
    sub-communicators; ``Communicator.free`` calls it before the
    parent's arenas go)."""
    for g in comm.__dict__.pop("_hier_grids", {}).values():
        g.release()


# ---------------------------------------------------------------------------
# compositions (each rank calls them on its own block)


def allreduce(x, ici_axis=ICI_AXIS, dcn_axis=DCN_AXIS, op=op_mod.SUM,
              deterministic: Optional[str] = None):
    """han-style split-level allreduce.

    low reduce_scatter (ICI) -> up allreduce (DCN, 1/ici_size of the
    bytes) -> low allgather (ICI). DCN traffic shrinks by the ICI group
    size versus a flat allreduce (coll_han.h:62-63).

    Falls back to a fold over both axes for shapes the scatter cannot
    tile (dim 0 not divisible by the ICI group size)."""
    n_ici = C.axis_size(ici_axis)
    if x.dim() == 0 or x.shape[0] % n_ici:
        return C.allreduce(C.allreduce(x, ici_axis, op,
                                       deterministic=deterministic),
                           dcn_axis, op, deterministic=deterministic)
    part = C.reduce_scatter(x, ici_axis, op, scatter_dim=0, tiled=True,
                            deterministic=deterministic)
    part = C.allreduce(part, dcn_axis, op, deterministic=deterministic)
    return C.allgather(part, ici_axis, tiled=True, gather_dim=0)


def reduce_scatter(x, ici_axis=ICI_AXIS, dcn_axis=DCN_AXIS,
                   op=op_mod.SUM, deterministic: Optional[str] = None):
    """Two-level reduce_scatter: ICI scatter first, then DCN scatter of
    the per-ICI-rank shard. Placement is ici-major: rank (dcn=s, ici=j)
    holds global row block j*dcn_size + s — :func:`allgather` inverts
    exactly this order."""
    part = C.reduce_scatter(x, ici_axis, op, scatter_dim=0, tiled=True,
                            deterministic=deterministic)
    return C.reduce_scatter(part, dcn_axis, op, scatter_dim=0,
                            tiled=True, deterministic=deterministic)


def allgather(x, ici_axis=ICI_AXIS, dcn_axis=DCN_AXIS):
    """Inverse of :func:`reduce_scatter`: DCN allgather of the small
    shard, then ICI allgather of the assembled row."""
    part = C.allgather(x, dcn_axis, tiled=True, gather_dim=0)
    return C.allgather(part, ici_axis, tiled=True, gather_dim=0)


def bcast(x, root_dcn: int = 0, root_ici: int = 0, ici_axis=ICI_AXIS,
          dcn_axis=DCN_AXIS):
    """Root's block everywhere (up bcast, then low bcast): the payload
    crosses DCN once, down the root's ICI column to every slice's
    delegate, then fans out inside each slice. Columns other than the
    root's move their own blocks in phase 1; phase 2 overwrites them from
    the delegate."""
    x = C.bcast(x, dcn_axis, root_dcn)
    return C.bcast(x, ici_axis, root_ici)


def alltoall(x, ici_axis=ICI_AXIS, dcn_axis=DCN_AXIS):
    """Global all-to-all over the flattened (dcn, ici) rank space as two
    exchanges: ICI first regroups the rows by destination slice, DCN
    then delivers slice to slice, so each payload byte crosses DCN once.

    Dim 0 must be divisible by dcn_size * ici_size; rows are in (dcn,
    ici)-major destination order, and come out source-rank-major (the MPI
    alltoall order)."""
    n_ici = C.axis_size(ici_axis)
    n_dcn = C.axis_size(dcn_axis)
    n = n_dcn * n_ici
    if x.dim() == 0 or x.shape[0] % n:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"hier alltoall: dim0 {x.shape[0] if x.dim() else 0} not "
            f"divisible by world {n}")
    blk = x.shape[0] // n
    rest = tuple(x.shape[1:])
    # phase 1 (ICI): rows (dcn_dst, ici_dst, blk) regrouped ici_dst-major
    body = x.reshape((n_dcn, n_ici, blk) + rest).transpose(0, 1)
    body = C.alltoall(body.reshape((n * blk,) + rest), ici_axis, 0, 0)
    # now rows (ici_src, dcn_dst, blk) with ici_dst == mine: regroup
    # dcn_dst-major for the DCN split
    body = body.reshape((n_ici, n_dcn, blk) + rest).transpose(0, 1)
    # phase 2 (DCN): rows come out (dcn_src, ici_src, blk)
    return C.alltoall(body.reshape((n * blk,) + rest), dcn_axis, 0, 0)


def dcn_wire_allreduce(x, wire: str, dcn_axis=DCN_AXIS):
    """SUM allreduce over the DCN axis with the payload moved in the
    ``wire`` dtype (the compressed inter-slice phase).

    Gather in the wire dtype, then a local upcast and sum: each rank
    ships its cast shard once, decodes it to the accumulate dtype and
    folds the ``n_dcn`` stack in stack order. fp8 first agrees a scale
    ``amax / finfo.max`` with an Allreduce MAX over the axis (every rank
    encodes and decodes with the same factor), divides by it before the
    cast and multiplies the sum by it; bf16 is a plain cast. fp8 moves
    through the arenas as its ``uint8`` bytes (the copy kernel is a byte
    copy). SUM only: the callers force exact for other ops."""
    spec = _WIRE.get(wire)
    if spec is None:
        raise _unknown_wire("dcn_wire_allreduce", wire)
    wdt, isz, _ = spec
    acc = x.dtype
    scale = None
    if wire.startswith("fp8"):
        amax = C.allreduce(x.abs().max().reshape(1), dcn_axis,
                           op_mod.MAX)[0]
        scale = _fp8_scale(amax, wire, acc)
        x = x / scale
    w = _encode(x, wire)
    if isz == 1:
        w = w.view(torch.uint8)
    g = C.allgather(w.contiguous(), dcn_axis, tiled=False, gather_dim=0)
    if isz == 1:
        g = g.view(wdt)
    red = g[0].to(acc)
    for i in range(1, g.shape[0]):
        red = red + g[i].to(acc)
    return red if scale is None else red * scale


def wire_quantize(x, wire: str):
    """``Q(x)``: the value a wire-dtype transport would deliver for
    ``x``, in ``x``'s dtype — the error-feedback residual is
    ``x - wire_quantize(x)``. Elementwise and deterministic. fp8 uses
    :func:`dcn_wire_allreduce`'s per-array ``amax / finfo.max`` scale;
    bf16 is a cast round trip. A tensor stays a tensor; a numpy array
    goes through torch on the CPU and comes back as numpy of its dtype
    (the host ZeRO path's leaves), with the same expressions in the same
    dtype order."""
    spec = _WIRE.get(wire)
    if spec is None:
        raise _unknown_wire("wire_quantize", wire)
    if isinstance(x, np.ndarray):
        return wire_quantize(torch.from_numpy(np.ascontiguousarray(x)),
                             wire).numpy()
    if wire.startswith("fp8"):
        scale = _fp8_scale(x.abs().max(), wire, x.dtype)
        return _encode(x / scale, wire).to(x.dtype) * scale
    return _encode(x, wire).to(x.dtype)


def barrier(ici_axis=ICI_AXIS, dcn_axis=DCN_AXIS):
    """Both levels' barriers; returns the sum of their tokens."""
    return C.barrier(ici_axis) + C.barrier(dcn_axis)


# ---------------------------------------------------------------------------
# flat-rank-order compositions (bitwise equal to the flat 'linear' fold)
#
# The split-level schedules above fold in (ici, dcn) group order, so their
# float results differ in the last ulp from a flat rank 0..n-1 fold. These
# reproduce the flat deterministic='linear' contract over the grid: gather
# everything into a rank-major stack (DCN first: the small payload crosses
# the slow level once, before ICI replicates it), then fold in rank order.


def _stack_rankorder(x, ici_axis, dcn_axis):
    """[n_ici, n_dcn, *shape]: entry [j, s] holds rank s * n_ici + j's
    block."""
    g = C.allgather(x.contiguous(), dcn_axis, tiled=False, gather_dim=0)
    return C.allgather(g, ici_axis, tiled=False, gather_dim=0)


def gather_rankorder(x, ici_axis=ICI_AXIS, dcn_axis=DCN_AXIS):
    """All ranks' blocks as a rank-major ``(n, *x.shape)`` stack (what a
    flat allgather yields): DCN gather, ICI gather, then the (ici, dcn)
    leading axes transposed to rank order."""
    g = _stack_rankorder(x, ici_axis, dcn_axis)
    n = g.shape[0] * g.shape[1]
    return g.transpose(0, 1).reshape((n,) + tuple(x.shape))


def rank_fold(rows: Sequence[torch.Tensor], opn, out=None) -> torch.Tensor:
    """``acc = fn(acc, row)`` over ``rows`` in list order: one K3
    (``linear_fold``) for the kernels' dtypes and ops, else coll/device's
    elementwise fold (logical ops on truth values, cast back) — the fold
    flat 'linear' runs, so the bits match it."""
    from ompi_tpu_torch.coll import cuda_kernels as K
    from ompi_tpu_torch.coll import device as cd

    opn = C._op_of(opn)
    dtype = rows[0].dtype
    if cd._kernels_take(dtype, opn):
        if out is None:
            out = torch.empty_like(rows[0])
        K.linear_fold([r.reshape(-1) for r in rows], out.view(-1),
                      opn.name)
        return out
    red = cd._fold(list(rows), opn, dtype)
    if out is not None:
        out.copy_(red)
        return out
    return red


def allreduce_rankorder(x, ici_axis=ICI_AXIS, dcn_axis=DCN_AXIS,
                        op=op_mod.SUM):
    """Allreduce folding in flat rank order, bitwise equal to the flat
    ``deterministic='linear'`` allreduce (same operands, same fold)."""
    g = _stack_rankorder(x, ici_axis, dcn_axis)
    n_ici, n_dcn = g.shape[0], g.shape[1]
    return rank_fold([g[j, s] for s in range(n_dcn)
                      for j in range(n_ici)], op)


def reduce_scatter_block_rankorder(x, ici_axis=ICI_AXIS,
                                   dcn_axis=DCN_AXIS, op=op_mod.SUM):
    """MPI rank-major reduce_scatter_block, bitwise equal to the flat
    'linear' one: the rank-order allreduce, then block ``world_rank``."""
    n_ici = C.axis_size(ici_axis)
    n = C.axis_size(dcn_axis) * n_ici
    full = allreduce_rankorder(x, ici_axis, dcn_axis, op)
    k = x.shape[0] // n
    idx = C.axis_index(dcn_axis) * n_ici + C.axis_index(ici_axis)
    return full[idx * k:(idx + 1) * k].contiguous()


def reduce_scatter_rankmajor(x, ici_axis=ICI_AXIS, dcn_axis=DCN_AXIS,
                             op=op_mod.SUM,
                             deterministic: Optional[str] = None,
                             wire: Optional[str] = None):
    """Split-level reduce_scatter with MPI rank-major placement.

    A row pre-permutation makes the two-phase schedule land block
    ``s*n_ici + j`` on rank (s, j): after it, body block j*n_dcn+s is
    original block s*n_ici+j; phase 1 hands ICI rank j the blocks
    {*, j}, phase 2 hands DCN rank s its block. DCN moves 1/n_ici of
    the input.

    ``wire`` compresses the DCN phase: a :func:`dcn_wire_allreduce` of
    the ICI shard, then this rank's DCN block."""
    n_ici = C.axis_size(ici_axis)
    n_dcn = C.axis_size(dcn_axis)
    n = n_dcn * n_ici
    k = x.shape[0] // n
    rest = tuple(x.shape[1:])
    body = x.reshape((n_dcn, n_ici, k) + rest).transpose(0, 1)
    body = body.reshape((n * k,) + rest)
    part = C.reduce_scatter(body, ici_axis, op, scatter_dim=0,
                            tiled=True, deterministic=deterministic)
    if wire is None:
        return C.reduce_scatter(part, dcn_axis, op, scatter_dim=0,
                                tiled=True, deterministic=deterministic)
    full = dcn_wire_allreduce(part, wire, dcn_axis)
    s = C.axis_index(dcn_axis)
    return full[s * k:(s + 1) * k].contiguous()
