"""Explicit ring schedules — the port of :mod:`ompi_tpu.parallel.ring`.

Why a fixed ring when the slots have their own schedules: (1)
**determinism** — the accumulation order of a ring is fixed by
construction, bitwise equal run-to-run and to the reference's ring; (2)
ring *dataflow* is the substrate of ring attention / context
parallelism (:mod:`ompi_tpu_torch.ops.ring_attention`).

A builtin op's combiner (:func:`collectives.combine_fn`) goes to
coll/device's 'ring' mode (K1 + K2 for the kernels' dtypes and ops, the
ring-ordered fold otherwise), whose chunk order, zero pad included, is the
reference's. Any other callable runs the reference's hop loop over
``permute_dev`` (one exchange a hop) with that callable. The axis is a
mesh axis name (resolved against the active mesh) or a communicator.

No overlap yet: ``permute_dev`` steps on the host (a stream
synchronisation and a hop-counter handshake per exchange), so a hop's
transfer does not run under the previous step's compute as XLA schedules
it in the reference (ROADMAP queue 2 item 2).
"""

from __future__ import annotations

from typing import Callable

import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll import device as cd
from ompi_tpu_torch.parallel import collectives as C


def _ring_perm(n: int, offset: int = 1):
    return [(i, (i + offset) % n) for i in range(n)]


def _builtin(fn, x):
    """(op, input) for a builtin combiner (a logical op folds the truth
    values, as the reference's fold of a bool buffer does), else None."""
    name = C.builtin_name(fn)
    if name is None:
        return None, x
    return op_mod.BUILTIN[name], (x.bool() if name in C._LOGICAL else x)


def ring_reduce_scatter(x, axis, fn: Callable = torch.add):
    """Reduce-scatter with fixed ring order: dim 0 of x (size n*k)
    shrinks to k; rank r ends with chunk r reduced in ring-visit order
    (ranks r+1, r+2, ..., r)."""
    comm = C.comm_of(axis)
    n = comm.size
    if n == 1:
        return x
    if x.dim() == 0 or x.shape[0] % n:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"ring_reduce_scatter: dim0 {x.shape[0] if x.dim() else 0} "
            f"not divisible by {n}")
    op, xin = _builtin(fn, x)
    if op is not None:
        def fwd(a):
            return cd._reduce_scatter_block_prep(comm, a.contiguous(), op,
                                                 "ring")()
        bwd = (lambda g: C._ag(comm, g, 0, True)) \
            if op.name == "MPI_SUM" else None
        return C._apply(fwd, bwd, xin)
    k = x.shape[0] // n
    chunks = x.reshape((n, k) + tuple(x.shape[1:]))
    r = comm.rank
    perm = _ring_perm(n)
    carry = chunks[(r - 1) % n]
    for s in range(n - 1):
        carry = C.ppermute(carry.contiguous(), comm, perm)
        own = chunks[(r - 2 - s) % n]
        carry = fn(carry, own)  # carry = earlier ring hosts -> left operand
    return carry


def ring_allgather(x, axis):
    """All-gather chunks around the ring: local [k, ...] -> [n*k, ...]
    with rank i's chunk at block i (coll/device's allgather: K2 copies,
    the same bits as the reference's hops)."""
    comm = C.comm_of(axis)
    if comm.size == 1:
        return x
    return C.allgather(x, comm, tiled=True, gather_dim=0)


def ring_allreduce(x, axis, fn: Callable = torch.add):
    """Bandwidth-optimal allreduce = ring reduce-scatter + ring
    allgather, deterministic accumulation order. Any size: the flat
    input is zero-padded to a multiple of n (pad lanes never mix with
    data lanes — reductions are elementwise)."""
    comm = C.comm_of(axis)
    n = comm.size
    if n == 1:
        return x
    op, xin = _builtin(fn, x)
    if op is not None:
        def fwd(a):
            return cd._allreduce_prep(comm, a.contiguous(), op, "ring")()
        bwd = fwd if op.name == "MPI_SUM" else None
        return C._apply(fwd, bwd, xin)
    shape = x.shape
    flat = x.reshape(-1)
    m = flat.shape[0]
    pad = (-m) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunk = ring_reduce_scatter(flat, comm, fn)
    full = ring_allgather(chunk, comm)
    return full[:m].reshape(shape)


def ring_rotate(block, axis, reverse: bool = False):
    """One ring hop: pass `block` (a tensor or a tuple of them, one
    exchange) to the next (or previous) rank. The ring-attention KV
    rotation primitive."""
    n = C.axis_size(axis)
    return C.ppermute(block, axis, _ring_perm(n, -1 if reverse else 1))


def ring_scan(body: Callable, carry, block, axis):
    """Run the n-step ring pipeline: at step s the local rank holds the
    block originally owned by rank (r - s) mod n and calls
    ``carry = body(step, src_rank, block, carry)``; the block is then
    rotated one hop. The hop and the compute run one after the other
    (see the module's note on overlap)."""
    comm = C.comm_of(axis)
    n, r = comm.size, comm.rank
    carry = body(0, r, block, carry)
    blk = block
    for s in range(1, n):
        blk = ring_rotate(blk, comm)
        carry = body(s, (r - s) % n, blk, carry)
    return carry
