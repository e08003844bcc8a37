"""Algorithmic byte accounting for the device collectives — the part of
:mod:`ompi_tpu.monitoring.algo` the port's callers reach so far.

coll/hier declares the bytes each level of its two-level schedules moves
per rank, given the (op, grid, payload): :func:`hier_level_bytes` (the
nominal per-level transport models), :func:`hier_wire_bytes` (what the
DCN phase actually moves under a compressed wire format) and
:func:`hier_per_peer` (the same split onto the ICI-axis and DCN-axis
neighbour edges). :func:`log2_bucket` is the size bucket both coll/cuda's
and coll/hier's switchpoint tables key on. All models count send-side
bytes only and return 0 / {} for an op they do not model. The rest of the
reference's models (the flat ``per_peer``, the coll/pallas and RMA
per-peer splits) come with the traffic matrices (ROADMAP item 10).
"""

from __future__ import annotations

from typing import Dict, Optional

#: bandwidth-optimal allreduce = reduce_scatter + allgather
_RS_AG = frozenset(("allreduce", "allreduce_multi"))


def log2_bucket(nbytes: int) -> int:
    """log2 size bucket for the (op, bucket, dtype, mesh) record key
    — the granularity coll/tuned switchpoint tables select on."""
    b = 0
    n = int(nbytes)
    while n > 1:
        n >>= 1
        b += 1
    return b


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
