"""Skew plane core — the completed-collective ring behind ``SKEW``.

The port's copy of ``ompi_tpu/skew/record.py``.

The flight recorder owns the entry side (``(seq, op, cid, nbytes,
t_enter)`` in the in-flight table); this module owns the exit side:
``FlightRecorder.exit`` feeds each *completed* collective here, so
every rank accumulates a bounded ring of ``(seq, op, cid, nbytes,
t_enter_ns, t_exit_ns)`` records — the raw material the decomposition
engine turns into arrival-skew vs transfer time once all ranks'
rings meet (kvstore merge at Finalize, or per-rank dumps offline).

Hot-path contract (the ``FLIGHT``/``RECORDER``/``TRAFFIC``/
``OBSERVER`` discipline, held by ``tests/test_torch_trace.py``'s guard
scan): while the plane is off —
the default — the one instrumented site (flight exit) pays ONE
module-attribute load + ONE ``is None`` branch and constructs
nothing. Ring overflow overwrites the oldest record and counts in
``skew_dropped`` (the trace-recorder drop-accounting shape).

Timestamps are local ``time.monotonic()`` converted to ns; the
recorder carries the rank's clock offset/error and rank 0's base
(``telemetry/clock.py``) so merges rebase every ring into one
timebase and the report can state its error bar.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.core import cvar, pvar

#: THE disabled guard. The instrumented site does
#: ``sk = record.SKEW`` / ``if sk is not None: sk.complete(...)`` —
#: module attribute load plus one branch, nothing constructed on the
#: None path.
SKEW: Optional["SkewRecorder"] = None

_ring_var = cvar.register(
    "skew_ring", 8192, int,
    help="Completed-collective ring capacity per rank for the skew "
         "plane; overflow overwrites the oldest record and counts in "
         "the skew_dropped pvar.", level=6)

#: one completed collective:
#: (seq, op, comm_cid, nbytes, t_enter_ns, t_exit_ns) — both stamps
#: local monotonic ns
Record = Tuple[int, str, int, int, int, int]


class SkewRecorder:
    """Thread-safe bounded ring of completed collectives + the live
    cross-rank lag view (level 2)."""

    def __init__(self, rank: int = 0, nranks: int = 0,
                 level: int = 1,
                 capacity: Optional[int] = None) -> None:
        cap = int(capacity if capacity is not None
                  else _ring_var.get())
        self.capacity = max(1, cap)
        self.rank = rank
        self.nranks = nranks
        self.level = level
        self._buf: List[Optional[Record]] = [None] * self.capacity
        self._head = 0
        self._n = 0
        self._lock = threading.Lock()
        # this rank's clock bracket + rank 0's (telemetry/clock.py);
        # start() fills them in after the store sync
        self.clock_offset_ns = 0
        self.clock_err_ns = 0
        self.clock_base_ns = 0
        self.clock_base_err_ns = 0
        #: resolved arrival map {(cid, seq): last_arrival_ns in the
        #: SHARED timebase} — set after a merge so the trace export
        #: can split each record into wait + transfer spans
        self.arrivals: Dict[Tuple[int, int], int] = {}
        #: level-2 live view: the rank whose last collective arrival
        #: lags the job's freshest arrival the most (watchdog context)
        self.live_worst: Optional[Dict[str, Any]] = None

    # -- hot path (enabled only; fed by FlightRecorder.exit) -------------
    def complete(self, seq: int, op: str, cid: int, nbytes: int,
                 t0_s: float, t1_s: float) -> None:
        rec = (seq, op, cid, int(nbytes),
               int(t0_s * 1e9), int(t1_s * 1e9))
        with self._lock:
            if self._n == self.capacity:
                pvar.record("skew_dropped")
            else:
                self._n += 1
            depth = self._n
            self._buf[self._head] = rec
            self._head = (self._head + 1) % self.capacity
        pvar.record("skew_records")
        pvar.record_hwm("skew_ring_depth", depth)

    # -- merge/export side -----------------------------------------------
    def records(self) -> List[Record]:
        """Chronological (completion-order) snapshot."""
        with self._lock:
            if self._n < self.capacity:
                out = self._buf[:self._n]
            else:
                out = self._buf[self._head:] + self._buf[:self._head]
            return list(out)

    def shift_ns(self) -> int:
        """Local-monotonic -> shared-timebase rebase (clock.shift_ns
        over this recorder's synced offsets)."""
        from ompi_tpu_torch.telemetry import clock as _clock

        return _clock.shift_ns(self.clock_offset_ns,
                               self.clock_base_ns)

    def set_arrivals(self,
                     arrivals: Dict[Tuple[int, int], int]) -> None:
        """Install the merged last-arrival map (shared timebase) so
        this rank's records can be split into wait/transfer locally
        (trace export's skew lane, pvar accounting)."""
        with self._lock:
            self.arrivals = dict(arrivals)

    def observe_live(self, peers: Dict[Any, Any], my_rank: int,
                     my_arr_ns: int,
                     my_seq: int) -> Optional[Dict[str, Any]]:
        """Level-2 live sampling (one watchdog sweep): compare the
        ``arr`` wall-ns stamps riding the heartbeat payloads and name
        the rank whose last collective arrival lags the freshest
        arrival the most — the slow rank, named BEFORE it becomes a
        hung rank. Returns (and stashes) the worst-lag context."""
        arrs: Dict[int, Tuple[int, int]] = {}
        for r, p in peers.items():
            if isinstance(p, dict) and int(p.get("arr", 0)):
                arrs[int(r)] = (int(p.get("seq", 0)), int(p["arr"]))
        if my_arr_ns:
            arrs[my_rank] = (my_seq, my_arr_ns)
        if len(arrs) < 2:
            return None
        newest = max(a for _s, a in arrs.values())
        worst_r = min(arrs, key=lambda r: arrs[r][1])
        ws, wa = arrs[worst_r]
        lag = max(0, newest - wa)
        pvar.record_hwm("skew_live_lag_ns", lag)
        self.live_worst = {"rank": worst_r, "seq": ws,
                           "behind_s": round(lag / 1e9, 3)}
        return self.live_worst


def enable(rank: int = 0, nranks: int = 0, level: int = 1,
           capacity: Optional[int] = None) -> SkewRecorder:
    """Raise the SKEW guard (idempotent)."""
    global SKEW
    if SKEW is None:
        SKEW = SkewRecorder(rank=rank, nranks=nranks, level=level,
                            capacity=capacity)
    else:
        SKEW.rank = rank
        if nranks:
            SKEW.nranks = nranks
        SKEW.level = max(SKEW.level, level)
    return SKEW


def disable() -> Optional[SkewRecorder]:
    global SKEW
    sk, SKEW = SKEW, None
    return sk
