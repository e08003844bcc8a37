"""coll/base — the base collective algorithm library.

The port's copy of ``ompi_tpu.coll.base_algos`` (coll/base_algos.py:28-551;
reference: ompi/mca/coll/base/, the ``ompi_coll_base_*_intra_*``
variants): barrier {recursive doubling, Bruck/dissemination}, bcast
{binomial, segmented pipeline}, allreduce {recursive doubling
(coll_base_allreduce.c:217), ring (:974), Rabenseifner's reduce-scatter +
allgather (:1267)}, allgather {ring, Bruck, recursive doubling}, alltoall
{pairwise, Bruck}, the binomial reduce, the recursive-halving
reduce_scatter and the ring reduce_scatter_block.

Each keeps the reference's fold order (which operand is on the left),
its non-power-of-two folding and its peer order, so a float result is
bitwise the reference's for the same inputs. They run over the pml on
the communicator's collective context and are chosen by coll/tuned's
decision rules or its forced-algorithm cvars.
"""

from __future__ import annotations

import numpy as np

from ompi_tpu_torch.coll.basic import (
    IN_PLACE, _irecv, _isend, _recv, _send, _tag, reduce_scatter_basic,
)
from ompi_tpu_torch.core import pvar


def _sbuf(sendbuf, recvbuf):
    """Resolve MPI_IN_PLACE."""
    if sendbuf is IN_PLACE or sendbuf is None:
        return np.asarray(recvbuf)
    return np.asarray(sendbuf)


def _sendrecv(comm, sarr, dst, rarr, src, tag):
    rq = _irecv(comm, rarr, rarr.size, None, src, tag)
    sq = _isend(comm, sarr, sarr.size, None, dst, tag)
    rq.wait()
    sq.wait()


# ---------------------------------------------------------------------------
# barrier
# ---------------------------------------------------------------------------

def barrier_recursivedoubling(comm) -> None:
    """coll_base_barrier.c recursive doubling (power-of-2 w/ fold)."""
    pvar.record("barrier")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    tok = np.zeros(1, dtype=np.uint8)
    rtok = np.zeros(1, dtype=np.uint8)
    adjsize = 1
    while adjsize * 2 <= size:
        adjsize *= 2
    extra = size - adjsize
    if rank < 2 * extra:
        if rank % 2 == 1:  # odd of the folded pairs: passive
            _send(comm, tok, 1, None, rank - 1, tag)
            _recv(comm, rtok, 1, None, rank - 1, tag)
            return
        _recv(comm, rtok, 1, None, rank + 1, tag)
    new_rank = rank // 2 if rank < 2 * extra else rank - extra
    mask = 1
    while mask < adjsize:
        peer_new = new_rank ^ mask
        peer = peer_new * 2 if peer_new < extra else peer_new + extra
        _sendrecv(comm, tok, peer, rtok, peer, tag)
        mask <<= 1
    if rank < 2 * extra and rank % 2 == 0:
        _send(comm, tok, 1, None, rank + 1, tag)


def barrier_bruck(comm) -> None:
    """Dissemination barrier (coll_base_barrier.c bruck)."""
    pvar.record("barrier")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    tok = np.zeros(1, dtype=np.uint8)
    rtok = np.zeros(1, dtype=np.uint8)
    dist = 1
    while dist < size:
        to = (rank + dist) % size
        frm = (rank - dist + size) % size
        rq = _irecv(comm, rtok, 1, None, frm, tag)
        sq = _isend(comm, tok, 1, None, to, tag)
        rq.wait()
        sq.wait()
        dist <<= 1


# ---------------------------------------------------------------------------
# bcast
# ---------------------------------------------------------------------------

def bcast_binomial(comm, buf, count, dtype, root: int) -> None:
    """Binomial tree bcast (coll_base_bcast.c binomial)."""
    pvar.record("bcast")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    vrank = (rank - root + size) % size
    arr = np.asarray(buf)
    # receive from parent (the lowest set bit names it)
    if vrank != 0:
        mask = 1
        while not (vrank & mask):
            mask <<= 1
        parent = (vrank - mask + root) % size
        _recv(comm, arr, count, dtype, parent, tag)
    # forward to children vrank+m for every m below my lowest set bit
    reqs = []
    m = 1
    while m < size:
        if vrank & m:
            break
        if vrank + m < size:
            child = (vrank + m + root) % size
            reqs.append(_isend(comm, arr, count, dtype, child, tag))
        m <<= 1
    for q in reversed(reqs):
        q.wait()


def bcast_pipeline(comm, buf, count, dtype, root: int,
                   segsize: int = 65536) -> None:
    """Segmented chain pipeline (coll_base_bcast.c pipeline): rank i
    receives from i-1 and forwards to i+1 segment by segment — O(1/p)
    working set, the long-message schedule ring-attention reuses."""
    pvar.record("bcast")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    if size == 1:
        return
    vrank = (rank - root + size) % size
    prev = (rank - 1 + size) % size
    nxt = (rank + 1) % size
    flat = np.asarray(buf).reshape(-1)
    elem = flat.itemsize
    seg_elems = max(1, segsize // elem)
    nseg = (flat.size + seg_elems - 1) // seg_elems
    pending = None
    for s in range(nseg):
        lo, hi = s * seg_elems, min((s + 1) * seg_elems, flat.size)
        seg = flat[lo:hi]
        if vrank != 0:
            _recv(comm, seg, hi - lo, dtype, prev, tag)
        if vrank != size - 1:
            if pending is not None:
                pending.wait()
            pending = _isend(comm, seg, hi - lo, dtype, nxt, tag)
    if pending is not None:
        pending.wait()


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

def allreduce_recursivedoubling(comm, sendbuf, recvbuf, count, dtype, op):
    """coll_base_allreduce.c:217 — log(p) exchange, good for small msgs."""
    pvar.record("allreduce")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf)
    sb = _sbuf(sendbuf, recvbuf)
    if rb is not sb:
        np.copyto(rb, sb, casting="same_kind")
    tmp = np.empty_like(rb)
    adjsize = 1
    while adjsize * 2 <= size:
        adjsize *= 2
    extra = size - adjsize
    if rank < 2 * extra:
        if rank % 2 == 1:
            _send(comm, rb, count, dtype, rank - 1, tag)
            _recv(comm, rb, count, dtype, rank - 1, tag)
            return
        _recv(comm, tmp, count, dtype, rank + 1, tag)
        # deterministic operand order: lower rank is left operand
        rb[...] = op.np_fn(rb, tmp)
    new_rank = rank // 2 if rank < 2 * extra else rank - extra
    mask = 1
    while mask < adjsize:
        peer_new = new_rank ^ mask
        peer = peer_new * 2 if peer_new < extra else peer_new + extra
        _sendrecv(comm, rb, peer, tmp, peer, tag)
        if peer_new < new_rank:
            rb[...] = op.np_fn(tmp, rb)
        else:
            rb[...] = op.np_fn(rb, tmp)
        mask <<= 1
    if rank < 2 * extra and rank % 2 == 0:
        _send(comm, rb, count, dtype, rank + 1, tag)


def allreduce_ring(comm, sendbuf, recvbuf, count, dtype, op):
    """coll_base_allreduce.c:974 — bandwidth-optimal reduce-scatter +
    allgather ring (the NCCL-style schedule)."""
    pvar.record("allreduce")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf).reshape(-1)
    sb = _sbuf(sendbuf, recvbuf).reshape(-1)
    if size == 1:
        if rb is not sb:
            rb[:] = sb
        return
    if rb is not sb:
        np.copyto(rb, sb, casting="same_kind")
    # chunk boundaries (count may not divide evenly)
    bounds = np.linspace(0, rb.size, size + 1).astype(np.int64)
    chunks = [(int(bounds[i]), int(bounds[i + 1])) for i in range(size)]
    nxt = (rank + 1) % size
    prv = (rank - 1 + size) % size
    maxchunk = max(hi - lo for lo, hi in chunks)
    tmp = np.empty(maxchunk, dtype=rb.dtype)
    # phase 1: reduce-scatter; after size-1 steps rank owns chunk
    # (rank+1)%size fully reduced
    for step in range(size - 1):
        send_idx = (rank - step + size) % size
        recv_idx = (rank - step - 1 + size) % size
        slo, shi = chunks[send_idx]
        rlo, rhi = chunks[recv_idx]
        view = tmp[:rhi - rlo]
        rq = _irecv(comm, view, rhi - rlo, dtype, prv, tag)
        sq = _isend(comm, rb[slo:shi].copy(), shi - slo, dtype, nxt, tag)
        rq.wait()
        sq.wait()
        rb[rlo:rhi] = op.np_fn(view, rb[rlo:rhi])
    # phase 2: allgather ring
    for step in range(size - 1):
        send_idx = (rank + 1 - step + size) % size
        recv_idx = (rank - step + size) % size
        slo, shi = chunks[send_idx]
        rlo, rhi = chunks[recv_idx]
        view = tmp[:rhi - rlo]
        rq = _irecv(comm, view, rhi - rlo, dtype, prv, tag)
        sq = _isend(comm, rb[slo:shi].copy(), shi - slo, dtype, nxt, tag)
        rq.wait()
        sq.wait()
        rb[rlo:rhi] = view


def allreduce_rabenseifner(comm, sendbuf, recvbuf, count, dtype, op):
    """coll_base_allreduce.c:1267 redscat_allgather — recursive halving
    reduce-scatter + recursive doubling allgather (power-of-2 folded)."""
    pvar.record("allreduce")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf).reshape(-1)
    sb = _sbuf(sendbuf, recvbuf).reshape(-1)
    if rb is not sb:
        np.copyto(rb, sb, casting="same_kind")
    if size == 1:
        return
    adjsize = 1
    while adjsize * 2 <= size:
        adjsize *= 2
    extra = size - adjsize
    tmp = np.empty_like(rb)
    # fold extras
    if rank < 2 * extra:
        if rank % 2 == 1:
            _send(comm, rb, count, dtype, rank - 1, tag)
            _recv(comm, rb, count, dtype, rank - 1, tag)
            return
        _recv(comm, tmp, count, dtype, rank + 1, tag)
        rb[...] = op.np_fn(rb, tmp)
    new_rank = rank // 2 if rank < 2 * extra else rank - extra

    def real(nr: int) -> int:
        return nr * 2 if nr < extra else nr + extra

    def segment(nr: int, down_to: int):
        """The data range rank ``nr`` is responsible for once the
        halving has descended to granularity ``down_to`` (handles
        counts not divisible by powers of two)."""
        s_lo, s_hi = 0, rb.size
        m = adjsize // 2
        while m >= down_to:
            s_mid = s_lo + (s_hi - s_lo) // 2
            if nr & m:
                s_lo = s_mid
            else:
                s_hi = s_mid
            m >>= 1
        return s_lo, s_hi

    # recursive halving reduce-scatter over adjsize ranks
    mask = adjsize // 2
    while mask >= 1:
        peer_new = new_rank ^ mask
        peer = real(peer_new)
        keep_lo, keep_hi = segment(new_rank, mask)
        give_lo, give_hi = segment(peer_new, mask)
        view = tmp[keep_lo:keep_hi]
        rq = _irecv(comm, view, keep_hi - keep_lo, dtype, peer, tag)
        sq = _isend(comm, rb[give_lo:give_hi].copy(),
                    give_hi - give_lo, dtype, peer, tag)
        rq.wait()
        sq.wait()
        if peer_new < new_rank:
            rb[keep_lo:keep_hi] = op.np_fn(view, rb[keep_lo:keep_hi])
        else:
            rb[keep_lo:keep_hi] = op.np_fn(rb[keep_lo:keep_hi], view)
        mask >>= 1
    # recursive doubling allgather (walk back up the same tree)
    mask = 1
    while mask < adjsize:
        peer_new = new_rank ^ mask
        peer = real(peer_new)
        my_lo, my_hi = segment(new_rank, mask)
        peer_lo, peer_hi = segment(peer_new, mask)
        rq = _irecv(comm, tmp[peer_lo:peer_hi], peer_hi - peer_lo,
                    dtype, peer, tag)
        sq = _isend(comm, rb[my_lo:my_hi].copy(), my_hi - my_lo,
                    dtype, peer, tag)
        rq.wait()
        sq.wait()
        rb[peer_lo:peer_hi] = tmp[peer_lo:peer_hi]
        mask <<= 1
    # unfold extras
    if rank < 2 * extra and rank % 2 == 0:
        _send(comm, rb, count, dtype, rank + 1, tag)


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------

def allgather_ring(comm, sendbuf, recvbuf, count, dtype):
    pvar.record("allgather")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf).reshape(size, -1)
    sb = _sbuf(sendbuf, recvbuf).reshape(-1)
    if sendbuf is not IN_PLACE:
        rb[rank][:] = sb
    nxt, prv = (rank + 1) % size, (rank - 1 + size) % size
    for step in range(size - 1):
        sidx = (rank - step + size) % size
        ridx = (rank - step - 1 + size) % size
        rq = _irecv(comm, rb[ridx], count, dtype, prv, tag)
        sq = _isend(comm, rb[sidx].copy(), count, dtype, nxt, tag)
        rq.wait()
        sq.wait()


def allgather_bruck(comm, sendbuf, recvbuf, count, dtype):
    """coll_base_allgather.c bruck: log(p) steps, then local rotate."""
    pvar.record("allgather")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    rb = np.asarray(recvbuf).reshape(size, -1)
    sb = _sbuf(sendbuf, recvbuf).reshape(-1)
    work = np.empty_like(rb)
    work[0][:] = sb if sendbuf is not IN_PLACE else rb[rank]
    have = 1
    dist = 1
    while dist < size:
        sendn = min(dist, size - have)
        to = (rank - dist + size) % size
        frm = (rank + dist) % size
        rq = _irecv(comm, work[have:have + sendn], sendn * work.shape[1],
                    dtype, frm, tag)
        sq = _isend(comm, work[:sendn].copy(), sendn * work.shape[1],
                    dtype, to, tag)
        rq.wait()
        sq.wait()
        have += sendn
        dist <<= 1
    # local inverse rotation: work[i] holds block (rank+i)%size
    for i in range(size):
        rb[(rank + i) % size][:] = work[i]


def allgather_recursivedoubling(comm, sendbuf, recvbuf, count, dtype):
    """Power-of-two only; falls back to ring otherwise."""
    rank, size = comm.rank, comm.size
    if size & (size - 1):
        return allgather_ring(comm, sendbuf, recvbuf, count, dtype)
    pvar.record("allgather")
    tag = _tag(comm)
    rb = np.asarray(recvbuf).reshape(size, -1)
    sb = _sbuf(sendbuf, recvbuf).reshape(-1)
    if sendbuf is not IN_PLACE:
        rb[rank][:] = sb
    mask = 1
    while mask < size:
        peer = rank ^ mask
        mine_lo = rank & ~(mask - 1)
        peer_lo = peer & ~(mask - 1)
        rq = _irecv(comm, rb[peer_lo:peer_lo + mask],
                    mask * rb.shape[1], dtype, peer, tag)
        sq = _isend(comm, rb[mine_lo:mine_lo + mask].copy(),
                    mask * rb.shape[1], dtype, peer, tag)
        rq.wait()
        sq.wait()
        mask <<= 1


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------

def alltoall_pairwise(comm, sendbuf, recvbuf, count, dtype):
    """coll_base_alltoall.c pairwise: size-1 rounds of sendrecv with
    rotating partners — bounded concurrency (vs basic's all-at-once)."""
    pvar.record("alltoall")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    sb = np.asarray(sendbuf).reshape(size, -1)
    rb = np.asarray(recvbuf).reshape(size, -1)
    rb[rank][:] = sb[rank]
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step + size) % size
        rq = _irecv(comm, rb[frm], count, dtype, frm, tag)
        sq = _isend(comm, sb[to], count, dtype, to, tag)
        rq.wait()
        sq.wait()


def alltoall_bruck(comm, sendbuf, recvbuf, count, dtype):
    """coll_base_alltoall.c:180 bruck — log(p) rounds of block batches;
    best for small messages at scale."""
    pvar.record("alltoall")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    sb = np.asarray(sendbuf).reshape(size, -1)
    rb = np.asarray(recvbuf).reshape(size, -1)
    blk = sb.shape[1]
    # phase 1: local rotation so block i is destined (rank+i)%size
    work = np.vstack([sb[(rank + i) % size] for i in range(size)])
    tmp = np.empty_like(work)
    dist = 1
    while dist < size:
        idx = [i for i in range(size) if i & dist]
        sendblocks = work[idx].copy()
        recvblocks = np.empty_like(sendblocks)
        to = (rank + dist) % size
        frm = (rank - dist + size) % size
        rq = _irecv(comm, recvblocks, len(idx) * blk, dtype, frm, tag)
        sq = _isend(comm, sendblocks, len(idx) * blk, dtype, to, tag)
        rq.wait()
        sq.wait()
        work[idx] = recvblocks
        dist <<= 1
    # phase 3: inverse rotation: final block for src s lands at
    # work[(s - rank + size) % size] reversed ordering
    for i in range(size):
        rb[(rank - i + size) % size][:] = work[i]


# ---------------------------------------------------------------------------
# reduce / reduce_scatter
# ---------------------------------------------------------------------------

def reduce_binomial(comm, sendbuf, recvbuf, count, dtype, op, root: int):
    """Binomial tree reduce (deterministic operand order per subtree)."""
    pvar.record("reduce")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    vrank = (rank - root + size) % size
    sb = _sbuf(sendbuf, recvbuf)
    acc = sb.copy()
    tmp = np.empty_like(acc)
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = (vrank - mask + root) % size
            _send(comm, acc, count, dtype, parent, tag)
            return
        child_v = vrank + mask
        if child_v < size:
            child = (child_v + root) % size
            _recv(comm, tmp, count, dtype, child, tag)
            # child covers higher v-ranks: child contributes on the right
            acc = op.np_fn(acc, tmp)
        mask <<= 1
    if recvbuf is not None:
        np.copyto(np.asarray(recvbuf), acc, casting="same_kind")


def reduce_scatter_recursivehalving(comm, sendbuf, recvbuf, counts,
                                    dtype, op):
    """coll_base_reduce_scatter.c recursive halving (pow2 only; ring
    fallback via basic otherwise)."""
    rank, size = comm.rank, comm.size
    if size & (size - 1):
        return reduce_scatter_basic(comm, sendbuf, recvbuf, counts,
                                    dtype, op)
    pvar.record("reduce_scatter")
    tag = _tag(comm)
    sb = _sbuf(sendbuf, recvbuf).reshape(-1).copy()
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    lo_r, hi_r = 0, size  # rank range whose chunks I still carry
    tmp = np.empty_like(sb)
    mask = size // 2
    while mask >= 1:
        mid = (lo_r + hi_r) // 2
        peer = rank ^ mask
        if (rank - lo_r) < (mid - lo_r):
            my_lo, my_hi = lo_r, mid
            give_lo, give_hi = mid, hi_r
        else:
            my_lo, my_hi = mid, hi_r
            give_lo, give_hi = lo_r, mid
        gl, gh = int(bounds[give_lo]), int(bounds[give_hi])
        ml, mh = int(bounds[my_lo]), int(bounds[my_hi])
        view = tmp[ml:mh]
        rq = _irecv(comm, view, mh - ml, dtype, peer, tag)
        sq = _isend(comm, sb[gl:gh].copy(), gh - gl, dtype, peer, tag)
        rq.wait()
        sq.wait()
        if peer < rank:
            sb[ml:mh] = op.np_fn(view, sb[ml:mh])
        else:
            sb[ml:mh] = op.np_fn(sb[ml:mh], view)
        lo_r, hi_r = my_lo, my_hi
        mask >>= 1
    rl, rh = int(bounds[rank]), int(bounds[rank + 1])
    np.asarray(recvbuf).reshape(-1)[:rh - rl] = sb[rl:rh]


def reduce_scatter_block_ring(comm, sendbuf, recvbuf, count, dtype, op):
    """Ring reduce-scatter phase only (phase 1 of allreduce_ring)."""
    pvar.record("reduce_scatter")
    tag = _tag(comm)
    rank, size = comm.rank, comm.size
    sb = _sbuf(sendbuf, recvbuf).reshape(-1)
    work = sb.copy()
    nxt, prv = (rank + 1) % size, (rank - 1 + size) % size
    tmp = np.empty(count, dtype=work.dtype)
    # schedule shifted by one vs allreduce_ring so the fully-reduced
    # chunk each rank ends with is its *own* chunk
    for step in range(size - 1):
        sidx = (rank - step - 1 + size) % size
        ridx = (rank - step - 2 + size) % size
        rq = _irecv(comm, tmp, count, dtype, prv, tag)
        sq = _isend(comm, work[sidx * count:(sidx + 1) * count].copy(),
                    count, dtype, nxt, tag)
        rq.wait()
        sq.wait()
        work[ridx * count:(ridx + 1) * count] = op.np_fn(
            tmp, work[ridx * count:(ridx + 1) * count])
    np.asarray(recvbuf).reshape(-1)[:count] = \
        work[rank * count:(rank + 1) * count]
