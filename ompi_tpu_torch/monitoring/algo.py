"""Algorithmic byte accounting for the device collectives — the port of
:mod:`ompi_tpu.monitoring.algo`.

coll/device's schedules never move bytes through the pml, so the traffic
matrices cannot see them by interposition: each collective launch
declares the bytes its algorithm moves per peer, given (op, rank, comm
size, payload). :func:`per_peer` holds the reference's models of coll/xla's
lowering (ring reduce_scatter / allgather: (n-1)/n of the payload to the
ring successor; allreduce twice that; bcast / reduce / scan one hop of
the full payload; alltoall(v) the actual splits; barrier a 4-byte
allreduce), which coll/device records under the same names so the
merged matrices agree with the reference's. :func:`pallas_per_peer`
splits coll/cuda's explicit schedules ('ring', 'bidir', 'linear') and
:func:`rma_per_peer` a one-sided fence's wire descriptors.

coll/hier declares the bytes each level of its two-level schedules moves
per rank: :func:`hier_level_bytes` (the nominal per-level transport
models), :func:`hier_wire_bytes` (what the DCN phase actually moves under
a compressed wire format) and :func:`hier_per_peer` (the same split onto
the ICI-axis and DCN-axis neighbour edges). :func:`log2_bucket` is the
size bucket both the switchpoint tables and the matrices' collective
records key on. All models count send-side bytes only and return 0 / {}
for a one-rank comm or an op they do not model (under-count rather than
guess).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

#: ops whose ring lowering sends (n-1)/n of the payload one hop
_RING_FRACTION = frozenset((
    "allgather", "allgatherv", "allgather_multi",
    "reduce_scatter", "reduce_scatter_block", "reduce_scatter_multi",
))

#: bandwidth-optimal allreduce = reduce_scatter + allgather
_RS_AG = frozenset(("allreduce", "allreduce_multi"))

#: pipelined chain ops: forward the full payload one hop
_PIPELINE = frozenset(("bcast", "reduce", "scan", "exscan"))

BARRIER_BYTES = 4


def log2_bucket(nbytes: int) -> int:
    """log2 size bucket for the (op, bucket, dtype, mesh) record key
    — the granularity coll/tuned switchpoint tables select on."""
    b = 0
    n = int(nbytes)
    while n > 1:
        n >>= 1
        b += 1
    return b


def pallas_per_peer(op: str, algorithm: str, rank: int, n: int,
                    nbytes: int) -> Dict[int, float]:
    """Bytes ``rank`` sends per peer for one coll/cuda launch (the
    reference's name: coll/pallas's explicit schedules, which coll/cuda
    keeps):

    - ``ring``: every step sends 1/n of the payload to the clockwise
      successor -> (n-1)/n * B to (rank+1) % n, doubled for allreduce;
    - ``bidir``: half the rows travel each ring direction -> the same
      total split evenly between (rank+1) % n and (rank-1) % n;
    - ``linear``: the rank-order fold gathers every contribution, so this
      rank ships its full block n-1 times along the ring edge."""
    if n <= 1:
        return {}
    nxt, prv = (rank + 1) % n, (rank - 1) % n
    if algorithm == "linear":
        return {nxt: float(nbytes) * (n - 1)}
    mult = 2.0 if op in _RS_AG else 1.0
    total = mult * nbytes * (n - 1) / n
    if algorithm == "bidir":
        return {nxt: total / 2.0, prv: total / 2.0}
    return {nxt: total}


def rma_per_peer(rank: int, edges, itemsize: int) -> Dict[int, float]:
    """Bytes ``rank`` sends per peer for one fence flush: ``edges`` are
    (sender, receiver, nelems) wire descriptors over comm-local ranks
    (puts origin -> target, gets target -> origin, oriented by the
    caller); only this rank's outgoing edges to another rank count."""
    out: Dict[int, float] = {}
    for s, d, n in edges:
        if s == rank and d != rank:
            out[d] = out.get(d, 0.0) + float(n) * float(itemsize)
    return out


def hier_level_bytes(op: str, n_dcn: int, n_ici: int,
                     nbytes: int, linear: bool = False):
    """(ici_bytes, dcn_bytes) one rank moves for a coll/hier launch —
    the two-level schedules' send-side transport models:

    - split-level **allreduce**: ICI ring reduce_scatter + allgather
      on the full payload (2 * (n_ici-1)/n_ici * B); the DCN phase
      allreduces the 1/n_ici chunk (2 * (B/n_ici) * (n_dcn-1)/n_dcn)
      — the whole point of the composition: DCN carries <= B/n_ici.
    - **reduce_scatter** family: one scatter per level, same chunk
      shrink; **allgather** family inverts it (DCN gathers the shard,
      ICI replicates the n_dcn-fold row).
    - **alltoall**: each byte crosses each level at most once.
    - **bcast**: one DCN column hop + the full ICI fanout row.
    - ``linear`` (the rank-order fold): gather transport — DCN ships
      the block to n_dcn-1 group peers, ICI replicates the gathered
      n_dcn-stack to n_ici-1 row peers.

    Unknown ops return (0, 0) — under-count rather than guess."""
    b = float(nbytes)
    if n_dcn <= 1 or n_ici <= 1:
        return (0.0, 0.0)
    if linear:
        return (b * n_dcn * (n_ici - 1), b * (n_dcn - 1))
    if op in _RS_AG:
        return (2.0 * b * (n_ici - 1) / n_ici,
                2.0 * (b / n_ici) * (n_dcn - 1) / n_dcn)
    if op in ("reduce_scatter", "reduce_scatter_block",
              "reduce_scatter_multi"):
        return (b * (n_ici - 1) / n_ici,
                (b / n_ici) * (n_dcn - 1) / n_dcn)
    if op in ("allgather", "allgatherv", "allgather_multi"):
        return (b * n_dcn * (n_ici - 1) / n_ici,
                b * (n_dcn - 1) / n_dcn)
    if op == "alltoall":
        return (b * (n_ici - 1) / n_ici, b * (n_dcn - 1) / n_dcn)
    if op == "bcast":
        return (b, b * (n_dcn - 1) / n_dcn)
    return (0.0, 0.0)


#: bytes/element of the compressed-DCN wire formats — a literal copy
#: of ``parallel.hierarchical``'s table, kept here so this accounting
#: module stays import-free (no torch just to model bytes)
WIRE_ITEMSIZE = {"bf16": 2.0, "fp8_e4m3": 1.0, "fp8_e5m2": 1.0}

#: scale-factor exchange cost of one fp8 launch (a 4-byte pmax over
#: the DCN axis inside the same program)
_FP8_SCALE_BYTES = 4.0

#: ops whose compressed-DCN transport the hier plane implements
_WIRE_OPS = _RS_AG | frozenset((
    "reduce_scatter", "reduce_scatter_block", "reduce_scatter_multi"))


def hier_wire_bytes(op: str, n_dcn: int, n_ici: int, nbytes: int,
                    wire: Optional[str] = None,
                    itemsize: int = 0, linear: bool = False) -> float:
    """ACTUAL DCN bytes one rank moves for a coll/hier launch — the
    figure ``hier_dcn_wire_bytes`` records next to the nominal model
    of :func:`hier_level_bytes`. Equal to the nominal DCN bytes for an
    exact launch (``wire`` None/unknown, linear fold, or unknown
    ``itemsize``); compressed launches transmit the ICI shard once in
    the wire dtype (gather + local upcast-sum replaces the exact
    phase's reduce_scatter+allgather pair), so:

    - allreduce family: ``(B·f/n_ici)·(n_dcn-1)/n_dcn`` with
      ``f = wire_itemsize/itemsize`` — nominal × f/2 (bf16 ¼, fp8 ⅛).
    - reduce_scatter family: nominal × f (bf16 ½, fp8 ¼).
    - fp8 adds the 4-byte scale-factor pmax.
    """
    _ici, dcn = hier_level_bytes(op, n_dcn, n_ici, nbytes,
                                 linear=linear)
    w = WIRE_ITEMSIZE.get(wire or "")
    if w is None or linear or itemsize <= 0 or op not in _WIRE_OPS:
        return dcn
    f = w / float(itemsize)
    wired = dcn * f / 2.0 if op in _RS_AG else dcn * f
    if str(wire).startswith("fp8"):
        wired += _FP8_SCALE_BYTES
    return wired


def hier_per_peer(op: str, rank: int, n_dcn: int, n_ici: int,
                  nbytes: int, linear: bool = False,
                  wire: Optional[str] = None,
                  itemsize: int = 0) -> Dict[int, float]:
    """Bytes `rank` SENDS per comm-local peer for one coll/hier
    launch, split by level: the ICI share rides the intra-slice ring
    edge (rank's row successor), the DCN share the inter-slice edge
    (same column, next slice) — so the link map separates fast-axis
    from slow-axis load instead of smearing both onto one flat ring
    edge. ``wire``/``itemsize`` charge the DCN edge the ACTUAL
    (compressed) transmit bytes of :func:`hier_wire_bytes`."""
    ici_b, _nom = hier_level_bytes(op, n_dcn, n_ici, nbytes,
                                   linear=linear)
    dcn_b = hier_wire_bytes(op, n_dcn, n_ici, nbytes, wire=wire,
                            itemsize=itemsize, linear=linear)
    if not ici_b and not dcn_b:
        return {}
    s, j = divmod(rank, n_ici)
    out: Dict[int, float] = {}
    if ici_b:
        out[s * n_ici + (j + 1) % n_ici] = float(ici_b)
    if dcn_b:
        peer = ((s + 1) % n_dcn) * n_ici + j
        out[peer] = out.get(peer, 0.0) + float(dcn_b)
    return out


def per_peer(op: str, rank: int, n: int, nbytes: int,
             root: int = 0,
             counts: Optional[Sequence[int]] = None,
             row_bytes: float = 0.0) -> Dict[int, float]:
    """Bytes ``rank`` sends per peer (comm-local ranks) for one launch of
    ``op`` over an n-rank comm moving ``nbytes`` of payload.
    ``counts`` / ``row_bytes`` give alltoallv (and scatterv) their actual
    splits: bytes to peer r = counts[r] * row_bytes; ``root`` shapes the
    rooted ops."""
    if n <= 1:
        return {}
    nxt = (rank + 1) % n
    if op in _RING_FRACTION:
        return {nxt: nbytes * (n - 1) / n}
    if op in _RS_AG:
        return {nxt: 2.0 * nbytes * (n - 1) / n}
    if op == "barrier":
        return {nxt: 2.0 * BARRIER_BYTES * (n - 1) / n}
    if op in _PIPELINE:
        if op in ("scan", "exscan"):
            # a chain, not a ring: the last rank has no successor
            return {rank + 1: float(nbytes)} if rank < n - 1 else {}
        if op == "bcast":
            # a ring pipeline rooted at ``root``; the rank whose
            # successor is the root closes it without sending
            return {} if nxt == root else {nxt: float(nbytes)}
        # reduce: one hop towards the root from every non-root
        return {} if rank == root else {nxt: float(nbytes)}
    if op in ("gather", "gatherv"):
        return {} if rank == root else {root: float(nbytes)}
    if op in ("scatter", "scatterv"):
        if rank != root:
            return {}
        if counts is not None:
            return {r: counts[r] * row_bytes
                    for r in range(n) if r != rank and counts[r]}
        chunk = nbytes / n
        return {r: chunk for r in range(n) if r != rank}
    if op == "alltoall":
        chunk = nbytes / n
        return {r: chunk for r in range(n) if r != rank}
    if op == "alltoallv":
        if counts is None:
            return {}
        return {r: counts[r] * row_bytes
                for r in range(n) if r != rank and counts[r]}
    return {}
