"""The traffic-matrix core (guarded global: ``TRAFFIC``) — the port of
:mod:`ompi_tpu.monitoring.matrix`.

One ``TrafficMatrix`` per rank, live only while the plane is enabled
(``monitoring_level >= 1``). Every instrumented site follows the
repo's one-branch guard discipline:

    tm = _matrix.TRAFFIC
    if tm is not None:
        tm.count("p2p", world_dst, nbytes)

so a disabled plane costs exactly one attribute load + one branch
(the same contract FLIGHT / RECORDER / SANITIZER keep, enforced by
the reference's ``unguarded-observability`` lint rule).

Counting is SEND-side only, per the reference ``common/monitoring``
design: each rank records what *it* transmits, and the cross-rank
merge recovers the receive view as the transpose (and checks the two
agree — see :mod:`merge`). Cells are per-(dst, ctx) with ctx one of
``p2p`` (pml host sends), ``coll`` (algorithmic device-collective
accounting, :mod:`algo`: coll/device's and coll/cuda's slots, coll/hier's
launches), ``osc`` (one-sided service traffic and fence flushes), and
``part`` (partitioned chunk sends).

Everything lands on the pvar plane twice: per-context totals under
literal names (``monitoring_p2p_bytes`` ...) and per-cell dynamic
families (``monitoring_tx_bytes_s0_d1_p2p`` ...) that
``telemetry.openmetrics`` decodes into labeled OpenMetrics series —
which also makes kvstore rollup inclusion automatic.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.errors import ERR_RANK, MPIError
from ompi_tpu_torch.monitoring import algo
from ompi_tpu_torch.monitoring.links import Link, LinkMap, link_name
from ompi_tpu_torch.pml.request import ANY_SOURCE, PROC_NULL

CTXS = ("p2p", "coll", "osc", "part")

# Bounded per-link time series for the Perfetto counter tracks: the
# plane is an accountant, not a tracer — cap the memory it can hold.
SERIES_CAP = 4096

TRAFFIC: Optional["TrafficMatrix"] = None


def world_rank(comm, peer: int) -> int:
    """Translate a comm-local peer to its world rank through the
    (remote, for inter-communicators) group — MPI_Group_translate_
    ranks against WORLD, as the reference monitoring_translate does.
    Raises MPIError(ERR_RANK) on a genuinely invalid peer instead of
    silently misattributing the traffic."""
    if peer in (PROC_NULL, ANY_SOURCE):
        return peer
    g = comm.remote_group if getattr(comm, "is_inter", False) \
        else comm.group
    ranks = getattr(g, "ranks", None)
    if ranks is None:  # groupless comm stub: local rank IS world rank
        return peer
    if not 0 <= peer < len(ranks):
        raise MPIError(
            ERR_RANK,
            f"invalid peer {peer} for monitoring translation "
            f"(group size {len(ranks)})")
    return ranks[peer]


class TrafficMatrix:
    """Per-rank send-side traffic matrix + link attribution state."""

    def __init__(self, rank: int, level: int, nranks: int):
        self.rank = int(rank)
        self.level = int(level)
        self.nranks = max(int(nranks), 1)
        self.lock = threading.Lock()
        # ctx -> dst(world) -> [msgs, bytes, latency_ns]
        self.tables: Dict[str, Dict[int, List[float]]] = \
            {c: {} for c in CTXS}
        # (op, log2 size bucket, dtype, mesh shape) -> [launches, bytes]
        self.coll_records: Dict[Tuple[str, int, str, Tuple[int, ...]],
                                List[float]] = {}
        # coll/hier per-level totals:
        # op -> [launches, ici_b, dcn_b, dcn_wire_b] — dcn_b is the
        # nominal (accumulate-dtype) model, dcn_wire_b what the wire
        # actually carried (equal unless the DCN phase is compressed)
        self.hier_levels: Dict[str, List[float]] = {}
        # serve/ plane per-policy accounting: policy -> counters +
        # log2(ns) latency histogram ({bucket: requests}) — the
        # [serve] report section's feed. Doc state only: the serve
        # plane records its pvars at the dispatch/loop sites, so this
        # table never double-counts.
        self.serve: Dict[str, Dict[str, object]] = {}
        self.link_bytes: Dict[Link, float] = {}
        self.expert: Dict[int, int] = {}
        self.series: List[Tuple[int, str, float]] = []
        self.linkmap: Optional[LinkMap] = \
            LinkMap.for_world(self.nranks) if level >= 2 else None

    # -- core cell update --------------------------------------------------

    def count(self, ctx: str, dst: int, nbytes: float,
              msgs: int = 1, ns: int = 0) -> None:
        """Record `msgs` sends totalling `nbytes` to world rank `dst`
        in context `ctx` (dst may be PROC_NULL: dropped here so call
        sites stay branch-free)."""
        if dst < 0:
            return
        nbytes = float(nbytes)
        with self.lock:
            cell = self.tables[ctx].get(dst)
            if cell is None:
                cell = self.tables[ctx][dst] = [0, 0.0, 0]
            cell[0] += msgs
            cell[1] += nbytes
            cell[2] += ns
        b = int(nbytes)
        pvar.record(f"monitoring_{ctx}_msgs", msgs)
        pvar.record(f"monitoring_{ctx}_bytes", b)
        pvar.record("monitoring_msgs", msgs)
        pvar.record("monitoring_bytes", b)
        pvar.record(f"monitoring_tx_msgs_s{self.rank}_d{dst}_{ctx}",
                    msgs)
        pvar.record(f"monitoring_tx_bytes_s{self.rank}_d{dst}_{ctx}",
                    b)
        if self.linkmap is not None:
            self._attribute({dst: nbytes})

    # -- collective launches (algorithmic accounting) ----------------------

    def coll(self, op: str, comm, nbytes: float, dtype: str = "",
             root: int = 0,
             per_peer: Optional[Dict[int, float]] = None,
             counts: Optional[Sequence[int]] = None,
             row_bytes: float = 0.0, ctx: str = "coll") -> None:
        """Account one collective launch: bytes this rank's share of
        the algorithm sends per peer (either the explicit `per_peer`
        comm-local dict, or the :mod:`algo` model for `op`), recorded
        into the `ctx` table after world-rank translation, plus the
        (op, size-bucket, dtype, mesh) record switchpoint tables
        derive from."""
        n = comm.size
        me = comm.rank
        if per_peer is None:
            per_peer = algo.per_peer(op, me, n, nbytes, root=root,
                                     counts=counts,
                                     row_bytes=row_bytes)
        mesh = self._mesh_shape(comm)
        key = (op, algo.log2_bucket(int(nbytes)), str(dtype), mesh)
        with self.lock:
            rec = self.coll_records.get(key)
            if rec is None:
                rec = self.coll_records[key] = [0, 0.0]
            rec[0] += 1
            rec[1] += float(nbytes)
        pvar.record("monitoring_coll_launches", 1)
        for peer, b in per_peer.items():
            self.count(ctx, world_rank(comm, peer), b)

    def hier(self, op: str, ici_bytes: float, dcn_bytes: float,
             dcn_wire_bytes: Optional[float] = None) -> None:
        """Account one coll/hier launch's per-level byte split — the
        table that lets the report answer "which level is the
        bottleneck" (the per-peer spatial view goes through
        :meth:`coll` separately). ``dcn_wire_bytes`` is the actual
        transmitted DCN figure (defaults to nominal = exact launch);
        the report recomputes its verdict from it."""
        if dcn_wire_bytes is None:
            dcn_wire_bytes = dcn_bytes
        with self.lock:
            rec = self.hier_levels.get(op)
            if rec is None:
                rec = self.hier_levels[op] = [0, 0.0, 0.0, 0.0]
            rec[0] += 1
            rec[1] += float(ici_bytes)
            rec[2] += float(dcn_bytes)
            rec[3] += float(dcn_wire_bytes)

    def serve_event(self, policy: str, *, requests: int = 0,
                    tokens: int = 0, kept: int = 0, rerouted: int = 0,
                    dropped: int = 0, dcn_tokens: int = 0,
                    dcn_bytes: int = 0, lat_ns: int = 0) -> None:
        """Accumulate one serve-plane event under its dispatch
        policy: the Dispatcher reports token accounting per dispatch,
        the decode loop reports request count + wall latency (log2-ns
        histogram bucket). Both call sites, one table — the report's
        ``[serve]`` section reads it whole."""
        with self.lock:
            rec = self.serve.get(policy)
            if rec is None:
                rec = self.serve[policy] = {
                    "requests": 0, "tokens": 0, "kept": 0,
                    "rerouted": 0, "dropped": 0, "dcn_tokens": 0,
                    "dcn_bytes": 0, "lat_ns": {}}
            rec["requests"] += int(requests)
            rec["tokens"] += int(tokens)
            rec["kept"] += int(kept)
            rec["rerouted"] += int(rerouted)
            rec["dropped"] += int(dropped)
            rec["dcn_tokens"] += int(dcn_tokens)
            rec["dcn_bytes"] += int(dcn_bytes)
            if lat_ns > 0:
                b = int(lat_ns).bit_length()
                hist = rec["lat_ns"]
                hist[b] = hist.get(b, 0) + 1

    @staticmethod
    def _mesh_shape(comm) -> Tuple[int, ...]:
        """The record's mesh: the comm's size (the reference reads a
        ``_device_comm`` mesh first, which no comm of either package
        carries)."""
        return (int(comm.size),)

    # -- link attribution (level 2) ----------------------------------------

    def _attribute(self, world_bytes: Dict[int, float]) -> None:
        lm = self.linkmap
        if lm is None:
            return
        with self.lock:
            for dst, b in world_bytes.items():
                lm.charge(self.link_bytes, self.rank, dst, b)
            loads = dict(self.link_bytes)
        for link, total in loads.items():
            d, a, bb = link
            pvar.record_hwm(
                f"monitoring_link_bytes_d{d}_r{a}_r{bb}", int(total))
        pvar.record_hwm("monitoring_link_imbalance_permille",
                        int(LinkMap.imbalance(loads) * 1000))
        hot = LinkMap.hottest(loads)
        if hot:
            from ompi_tpu_torch.trace import recorder as _rec

            with self.lock:
                self.series.append(
                    (_rec.now(), link_name(hot[0][0]), hot[0][1]))
                if len(self.series) > SERIES_CAP:
                    del self.series[:len(self.series) - SERIES_CAP]

    # -- expert load (EP alltoall path; ROADMAP item 5 feed) ---------------

    def expert_tokens(self, counts: Sequence[int]) -> None:
        """Per-expert routed-token counts from one EP dispatch; expert
        identity is the destination shard index."""
        total = 0
        with self.lock:
            for e, c in enumerate(counts):
                c = int(c)
                if c <= 0:
                    continue
                self.expert[e] = self.expert.get(e, 0) + c
                total += c
        for e, c in enumerate(counts):
            if int(c) > 0:
                pvar.record(f"monitoring_expert_tokens_e{e}", int(c))
        if total:
            pvar.record("monitoring_expert_tokens", total)

    # -- views --------------------------------------------------------------

    def peer_totals(self, ctx: Optional[str] = None
                    ) -> Dict[int, Tuple[int, int]]:
        """{world dst: (msgs, bytes)} for one ctx, or all ctxs summed
        — the shape pml/monitoring.matrix() has always returned."""
        out: Dict[int, List[float]] = {}
        with self.lock:
            tables = [self.tables[ctx]] if ctx else \
                list(self.tables.values())
            for t in tables:
                for dst, (m, b, _ns) in t.items():
                    cell = out.setdefault(dst, [0, 0.0])
                    cell[0] += m
                    cell[1] += b
        return {d: (int(m), int(b)) for d, (m, b) in out.items()}

    def hotspot(self) -> Optional[Dict[str, object]]:
        """Hottest-link summary for the watchdog hang dump: the link,
        its load, this rank's ICI neighbors, and the heaviest peer."""
        with self.lock:
            loads = dict(self.link_bytes)
        lm = self.linkmap
        doc: Dict[str, object] = {}
        peers = self.peer_totals()
        if peers:
            top = max(peers.items(), key=lambda kv: kv[1][1])
            doc["top_peer"] = {"rank": top[0], "bytes": top[1][1],
                               "msgs": top[1][0]}
        if lm is not None:
            doc["neighbors"] = lm.neighbors(self.rank)
            hot = LinkMap.hottest(loads)
            if hot:
                doc["hottest_link"] = {
                    "name": link_name(hot[0][0]),
                    "dim": hot[0][0][0],
                    "ranks": [hot[0][0][1], hot[0][0][2]],
                    "bytes": int(hot[0][1]),
                }
        return doc or None

    def link_series(self) -> List[Tuple[int, str, float]]:
        with self.lock:
            return list(self.series)


def enable(rank: int, level: int, nranks: int) -> "TrafficMatrix":
    global TRAFFIC
    if TRAFFIC is None:
        TRAFFIC = TrafficMatrix(rank, level, nranks)
    return TRAFFIC


def disable() -> None:
    global TRAFFIC
    TRAFFIC = None
