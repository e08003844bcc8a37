"""Axis-keyed collective library — the port of
:mod:`ompi_tpu.parallel.collectives`.

Each function takes this rank's local tensor and an axis (a mesh axis
name or a tuple of them, resolved against the active mesh: see
:func:`ompi_tpu_torch.parallel.mesh.active_mesh`), or a communicator, and
calls the coll/device slot's schedule directly (the reference's
``DeviceCommunicator`` bypasses the coll framework too): the preps of
``allreduce_dev``, ``reduce_scatter_block_dev``, ``allgather_dev``,
``alltoall_dev`` and ``bcast_dev``, the prefix of ``scan_dev`` /
``exscan_dev``, ``ibarrier_dev`` and the internal ``permute_dev``. These
are the reference's ``lax`` collectives inside a compiled program, which
the monitoring plane does not meter, so they skip the slots' ``TRAFFIC``
records. A dim other than 0 moves to dim 0 (a contiguous
copy) before the slot and back after, so data movement stays bitwise.
``deterministic`` keeps the reference's three modes: None (the slot's ''),
'ring' (fixed ring order, bitwise equal to the reference's ring) and
'linear' (the rank-order fold, bitwise equal to the reference's).

Gradients: the reductions and copies are ``torch.autograd.Function``\\ s
whose backward is the conjugate collective (jax's transpose rules):
allreduce SUM <-> allreduce SUM, allgather <-> reduce-scatter SUM,
alltoall <-> the inverse alltoall, ppermute <-> the inverse permutation;
:func:`region_enter` is identity forward and psum backward,
:func:`region_exit` psum forward and identity backward. Every rank runs
the same backward graph, so the backward collectives pair up as the
forward ones do.

Where the port differs (each stated in ROADMAP queue 3): argument errors
raise ``errors.MPIError(ERR_ARG)`` with the reference's text where it
raises ValueError or asserts; :func:`reduce` and :func:`gather` return
the result on every rank, as the reference computes it on every device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll import device as cd
from ompi_tpu_torch.parallel import mesh as mesh_mod

#: MPI_Op -> the elementwise torch combine (coll/device's fold, which
#: keeps jnp's NaN and signed-zero rules for MIN / MAX)
_TORCH_FN = dict(cd._FOLD)
_LOGICAL = ("MPI_LAND", "MPI_LOR", "MPI_LXOR")


def _op_of(op) -> op_mod.Op:
    if isinstance(op, op_mod.Op):
        return op
    return op_mod.BUILTIN[op]


def combine_fn(op):
    """The torch elementwise combiner for an MPI op (a user op's own
    ``np_fn``, which must take tensors)."""
    op = _op_of(op)
    fn = _TORCH_FN.get(op.name)
    if fn is not None:
        return fn
    return op.np_fn


def builtin_name(fn) -> Optional[str]:
    """The builtin op whose combiner ``fn`` is (None for another
    callable)."""
    for name, f in _TORCH_FN.items():
        if f is fn:
            return name
    return None


def comm_of(axis):
    """The communicator of ``axis`` on the active mesh (a communicator
    passes through)."""
    if isinstance(axis, (str, tuple)):
        return mesh_mod.active_mesh().comm_of(axis)
    return axis


def axis_size(axis) -> int:
    return comm_of(axis).size


def axis_index(axis) -> int:
    return comm_of(axis).rank


def _det(deterministic: Optional[str]) -> str:
    if deterministic not in (None, "ring", "linear"):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"deterministic={deterministic!r}: expected None, 'ring' "
            "or 'linear' (silent fallthrough would void the "
            "fixed-reduction-order guarantee)")
    return deterministic or ""


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim() if x.dim() else 0


def _divisible(what: str, x: torch.Tensor, dim: int, n: int) -> None:
    if x.dim() == 0 or x.shape[dim] % n:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"{what}: dim {dim} of shape {tuple(x.shape)} not divisible "
            f"by the axis size {n}")


class _Coll(torch.autograd.Function):
    """A collective with its conjugate as the backward: ``fwd(*xs)`` and
    ``bwd(*grads)`` map tensors to a tensor or a tuple of them (``bwd``
    None: not differentiable)."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.bwd = bwd
        return fwd(*xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.bwd is None:
            raise errors.MPIError(
                errors.ERR_ARG, "this collective has no gradient (only "
                "SUM reductions and the copies have one)")
        got = ctx.bwd(*[g.contiguous() for g in gs])
        return (None, None) + (tuple(got) if isinstance(got, (tuple, list))
                               else (got,))


def _apply(fwd, bwd, *xs):
    return _Coll.apply(fwd, bwd, *xs)


# ---------------------------------------------------------------------------
# reductions


def _allreduce(comm, x, op, det: str):
    return cd._allreduce_prep(comm, x.contiguous(), op, det)()


def allreduce(x, axis, op=op_mod.SUM,
              deterministic: Optional[str] = None):
    """MPI_Allreduce over a mesh axis.

    deterministic=None  -> coll/device's '' (the ring for the kernels'
                           dtypes and ops);
    deterministic='ring'   -> fixed ring order (bit-identical run-to-run
                              and to the reference's ring);
    deterministic='linear' -> rank-order fold, bit-identical to
                              coll/basic's linear reduce+bcast.
    Logical ops fold on truth values and cast back (coll/device does so).
    """
    op = _op_of(op)
    det = _det(deterministic)
    comm = comm_of(axis)
    if op.name == "MPI_SUM":
        return _apply(lambda a: _allreduce(comm, a, op, det),
                      lambda g: _allreduce(comm, g, op, det), x)
    return _apply(lambda a: _allreduce(comm, a, op, det), None, x)


def reduce(x, axis, op=op_mod.SUM, root: int = 0,
           deterministic: Optional[str] = None):
    """MPI_Reduce: every rank gets the reduction (the reference computes
    it on every device; the result is only *meaningful* on root)."""
    return allreduce(x, axis, op, deterministic)


def _rs_sum(comm, x, dim: int, tiled: bool, det: str):
    """Reduce-scatter SUM of dim ``dim`` through the slot."""
    out = cd._reduce_scatter_block_prep(
        comm, x.movedim(dim, 0).contiguous(), op_mod.SUM, det)()
    if not tiled:
        return out[0]
    return out.movedim(0, dim).contiguous()


def _ag(comm, x, dim: int, tiled: bool):
    """Allgather along ``dim`` through the slot (tiled: concatenated;
    else a new axis at ``dim``)."""
    g = cd._allgather_prep(comm, x.contiguous())()
    if not tiled:
        return g.movedim(0, dim).contiguous()
    g = g.movedim(0, dim)
    return g.flatten(dim, dim + 1).contiguous()


def reduce_scatter(x, axis, op=op_mod.SUM, scatter_dim: int = 0,
                   tiled: bool = True,
                   deterministic: Optional[str] = None):
    """MPI_Reduce_scatter_block: reduce then scatter equal chunks.

    With tiled=True, dim `scatter_dim` of x (size n*k) shrinks to k;
    tiled=False takes a dim of size n and squeezes it away."""
    op = _op_of(op)
    det = _det(deterministic)
    comm = comm_of(axis)
    n = comm.size
    dim = _dim(x, scatter_dim)
    if det == "ring":
        from ompi_tpu_torch.parallel import ring

        if dim != 0:
            raise errors.MPIError(errors.ERR_ARG,
                                  "ring reduce_scatter: dim 0 only")
        return ring.ring_reduce_scatter(x, comm, combine_fn(op))
    _divisible("reduce_scatter", x, dim, n)
    if not tiled and x.shape[dim] != n:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"reduce_scatter(tiled=False): dim {dim} of shape "
            f"{tuple(x.shape)} is not the axis size {n}")
    if op.name == "MPI_SUM":
        if det == "":  # psum_scatter
            return _apply(lambda a: _rs_sum(comm, a, dim, tiled, det),
                          lambda g: _ag(comm, g, dim, tiled), x)

        def fwd(a):
            return _slice_own(comm, _allreduce(comm, a, op, det), dim,
                              tiled)
        return _apply(fwd, lambda g: _ag(comm, g, dim, tiled), x)
    # no native lowering: allreduce then slice own chunk
    return _apply(lambda a: _slice_own(
        comm, _allreduce(comm, a, op, det), dim, tiled), None, x)


def _slice_own(comm, full, dim: int, tiled: bool):
    n, idx = comm.size, comm.rank
    if tiled:
        k = full.shape[dim] // n
        return full.narrow(dim, idx * k, k).contiguous()
    return full.select(dim, idx).contiguous()


# ---------------------------------------------------------------------------
# data movement


def allgather(x, axis, tiled: bool = True, gather_dim: int = 0):
    """MPI_Allgather. tiled=True concatenates along gather_dim;
    tiled=False stacks a new axis there."""
    comm = comm_of(axis)
    dim = gather_dim if gather_dim >= 0 \
        else gather_dim + x.dim() + (0 if tiled else 1)
    return _apply(lambda a: _ag(comm, a, dim, tiled),
                  lambda g: _rs_sum(comm, g, dim, tiled, ""), x)


def _a2a(comm, x, split_dim: int, concat_dim: int):
    n = comm.size
    y = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
    y = y.movedim(split_dim, 0).contiguous()
    z = cd._alltoall_prep(comm, y)()  # block p: source p's chunk for us
    return z.movedim(0, concat_dim).flatten(
        concat_dim, concat_dim + 1).contiguous()


def alltoall(x, axis, split_dim: int = 0, concat_dim: int = 0):
    """MPI_Alltoall: split dim `split_dim` n-ways, exchange, concat on
    `concat_dim` in source-rank order (the MoE dispatch primitive)."""
    comm = comm_of(axis)
    sd, cdim = _dim(x, split_dim), _dim(x, concat_dim)
    _divisible("alltoall", x, sd, comm.size)
    return _apply(lambda a: _a2a(comm, a, sd, cdim),
                  lambda g: _a2a(comm, g, cdim, sd), x)


def bcast(x, axis, root: int = 0):
    """MPI_Bcast: every rank gets root's tensor."""
    comm = comm_of(axis)
    return _apply(lambda a: cd._bcast_prep(comm, a.contiguous(), root)(),
                  None, x)


def scatter(x, axis, root: int = 0, dim: int = 0):
    """MPI_Scatter from root's tensor: every rank holds x (same shape);
    rank i takes chunk i of root's value."""
    comm = comm_of(axis)
    d = _dim(x, dim)
    _divisible("scatter", x, d, comm.size)
    full = bcast(x, comm, root)
    return _slice_own(comm, full, d, True)


def gather(x, axis, root: int = 0, dim: int = 0):
    """MPI_Gather: the concatenation along ``dim``, on every rank (the
    reference computes it on every device)."""
    return allgather(x, axis, tiled=True, gather_dim=dim)


def ppermute(x, axis, perm: Sequence[Tuple[int, int]]):
    """Point-to-point permutation (``lax.ppermute``): rank d gets rank
    s's ``x`` for each (s, d) of ``perm``, and zeros where no pair names
    it. ``x`` may be a tuple of tensors, which move in one exchange."""
    comm = comm_of(axis)
    perm = [(int(s), int(d)) for s, d in perm]
    inv = [(d, s) for s, d in perm]
    if isinstance(x, torch.Tensor):
        return _apply(lambda a: cd.permute_dev(comm, a, perm),
                      lambda g: cd.permute_dev(comm, g, inv), x)
    out = _apply(lambda *a: cd.permute_dev(comm, a, perm),
                 lambda *g: cd.permute_dev(comm, g, inv), *x)
    return type(x)(out) if isinstance(x, list) else tuple(out)


def shift(x, axis, offset: int = 1):
    """Ring shift by `offset` (MPI_Cart_shift + Sendrecv on a ring)."""
    n = axis_size(axis)
    return ppermute(x, axis, [(i, (i + offset) % n) for i in range(n)])


# ---------------------------------------------------------------------------
# prefix ops


def scan(x, axis, op=op_mod.SUM):
    """MPI_Scan (inclusive prefix over rank order)."""
    comm = comm_of(axis)
    op = _op_of(op)
    return _apply(lambda a: cd._prefix("scan", comm, a.contiguous(), op, "",
                                        False), None, x)


def exscan(x, axis, op=op_mod.SUM, identity=None):
    """MPI_Exscan (exclusive prefix; rank 0 gets `identity` or zeros)."""
    comm = comm_of(axis)
    op = _op_of(op)

    def fwd(a):
        out = cd.exscan_dev(comm, a.contiguous(), op, "")
        if comm.rank == 0 and identity is not None:
            out = torch.full_like(a, identity)
        return out
    return _apply(fwd, None, x)


# ---------------------------------------------------------------------------
# AD-boundary collectives (Megatron's f/g pair)


def region_enter(x, axis):
    """Identity fwd / psum bwd: apply to a replicated activation as it
    enters a column-parallel (sharded-feature) region."""
    comm = comm_of(axis)
    return _apply(lambda a: a.view_as(a),
                  lambda g: _allreduce(comm, g, op_mod.SUM, ""), x)


def region_exit(x, axis):
    """psum fwd / identity bwd: apply to the partial output of a
    row-parallel matmul."""
    comm = comm_of(axis)
    return _apply(lambda a: _allreduce(comm, a, op_mod.SUM, ""),
                  lambda g: g, x)


def barrier(axis):
    """The device barrier, then an int32 zero on this rank's device (the
    reference's data-dependence token)."""
    comm = comm_of(axis)
    cd.ibarrier_dev(comm).wait()
    return torch.zeros((), dtype=torch.int32, device=_device())


def _device() -> torch.device:
    from ompi_tpu_torch.runtime import device_plane

    return device_plane.device() if device_plane.active() \
        else torch.device("cpu")
