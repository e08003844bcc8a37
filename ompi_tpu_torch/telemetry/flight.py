"""Collective flight recorder — the in-flight table the watchdog reads.

Reference tradition: PyTorch c10d/NCCL's "flight recorder" — when a
distributed job hangs, the single highest-value diagnostic is naming
which rank never entered collective #N. Every collective entry (coll/
xla device dispatch, partitioned cycles, API-layer blocking calls)
registers ``(seq, op, comm_cid, nbytes, t_enter)`` in a small in-flight
table; the rank's latest entered/completed seq rides the kvstore
heartbeat payload (``hb_payload``) so the watchdog can diff seq numbers
across ranks and name the straggler(s).

Hot-path contract (same discipline as trace.recorder.RECORDER, and
regression-tested the same way): while disabled — the default — an
instrumented site pays ONE attribute load + ONE branch
(``flight.FLIGHT is None``) and constructs nothing.

Seq comparability: entries are counted per layer but every layer's
instrumentation is SPMD-uniform (all ranks run the same collective
sequence), so "rank r's last_entered < the stuck seq" means rank r
never reached that collective — the cross-rank diff the watchdog does.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.skew import record as _skew_record
from ompi_tpu_torch.telemetry import clock as _clock

#: THE disabled guard. Instrumented sites do
#: ``fl = flight.FLIGHT`` / ``if fl is None: <fast path>`` — module
#: attribute load plus one branch, nothing constructed on the None path.
FLIGHT: Optional["FlightRecorder"] = None

_api_handle: Optional[int] = None

#: blocking collectives interposed via the PMPI chain when telemetry is
#: on (nonblocking/persistent variants complete after the call returns,
#: so their entry/exit is owned by the coll/part layer hooks instead)
API_COLLECTIVES = (
    "Barrier", "barrier", "Bcast", "bcast", "Reduce", "reduce",
    "Allreduce", "allreduce", "Allreduce_multi",
    "Reduce_scatter_multi", "Allgather_multi",
    "Gather", "gather", "Gatherv", "Scatter", "scatter", "Scatterv",
    "Allgather", "allgather", "Allgatherv",
    "Alltoall", "alltoall", "Alltoallv",
    "Reduce_scatter", "Reduce_scatter_block", "Scan", "Exscan",
)


class FlightRecorder:
    """Thread-safe in-flight collective table + monotonic entry seq."""

    def __init__(self, rank: int = 0) -> None:
        self.rank = rank
        self._lock = threading.Lock()
        self._seq = 0
        # seq -> (seq, op, comm_cid, nbytes, t_enter monotonic seconds)
        self._inflight: Dict[int, Tuple[int, str, int, int, float]] = {}
        self.last_entered = 0
        self.last_completed = 0
        # wall-ns stamp of the latest collective ARRIVAL — rides the
        # heartbeat payload ("arr") so the watchdog can tell "never
        # entered" from "entered 40 s late" and the skew plane can
        # sample live lag; clock bracket from telemetry/clock.py
        self.clock_offset_ns, self.clock_err_ns = _clock.sample_offset()
        self.last_arrival_ns = 0
        # pml-level progress inside a collective context: ctx -> seq
        # (dump-only detail — shows the wire was still moving)
        self._pml: Dict[int, int] = {}

    # -- hot path (enabled only) ------------------------------------------
    def enter(self, op: str, comm_cid: int = -1, nbytes: int = 0) -> int:
        """Register a collective entry; returns the token for exit()."""
        t0 = time.monotonic()
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._inflight[seq] = (seq, op, comm_cid, int(nbytes), t0)
            self.last_entered = seq
            self.last_arrival_ns = int(t0 * 1e9) + self.clock_offset_ns
            depth = len(self._inflight)
        pvar.record("telemetry_flight_ops")
        pvar.record_hwm("telemetry_inflight", depth)
        return seq

    def exit(self, token: int) -> None:
        with self._lock:
            entry = self._inflight.pop(token, None)
            if token > self.last_completed:
                self.last_completed = token
        if entry is not None:
            # exit side of the skew plane: one attribute load + one
            # branch while skew is off — the completed collective's
            # (seq, op, cid, nbytes, t_enter, t_exit) feeds the
            # bounded per-rank ring only when SKEW is up
            sk = _skew_record.SKEW
            if sk is not None:
                sk.complete(entry[0], entry[1], entry[2], entry[3],
                            entry[4], time.monotonic())

    def mark_pml(self, ctx: int, seq: int) -> None:
        """Latest pml seq seen on a collective context (ob1 traffic)."""
        with self._lock:
            self._pml[ctx] = seq

    # -- watchdog/export side ---------------------------------------------
    def oldest(self) -> Optional[Tuple[int, str, int, int, float]]:
        """The longest-in-flight entry, or None when nothing is open."""
        with self._lock:
            if not self._inflight:
                return None
            return min(self._inflight.values(), key=lambda e: e[4])

    def snapshot(self) -> List[Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            entries = sorted(self._inflight.values())
            pml = dict(self._pml)
        out = [{"seq": s, "op": op, "comm_cid": cid, "nbytes": nb,
                "in_flight_s": round(now - t0, 3)}
               for s, op, cid, nb, t0 in entries]
        if pml:
            out.append({"pml_ctx_seqs": pml})
        return out

    def hb_dict(self) -> Dict[str, int]:
        """The heartbeat payload: latest entered/completed seq plus
        the wall-ns stamp of the latest arrival (0 before the first
        collective) — what lets a peer tell "rank 3 never entered"
        from "rank 3 entered 40 s late"."""
        with self._lock:
            return {"seq": self.last_entered,
                    "done": self.last_completed,
                    "inflight": len(self._inflight),
                    "arr": self.last_arrival_ns}


def hb_payload() -> Optional[Dict[str, int]]:
    """Heartbeat piggyback for ft.detector: None while disabled (the
    wire message stays the 2-tuple older stores understand)."""
    fl = FLIGHT
    return None if fl is None else fl.hb_dict()


def enable(rank: int = 0, api_hook: bool = True) -> FlightRecorder:
    """Turn the flight recorder on (idempotent). ``api_hook``
    interposes entry/exit on the blocking-collective API methods via
    the PMPI chain — only while enabled, so the disabled API path pays
    nothing at all."""
    global FLIGHT
    if FLIGHT is None:
        FLIGHT = FlightRecorder(rank=rank)
        if api_hook:
            _install_api_hook()
    else:
        FLIGHT.rank = rank
    return FLIGHT


def disable() -> Optional[FlightRecorder]:
    global FLIGHT, _api_handle
    fl, FLIGHT = FLIGHT, None
    if _api_handle is not None:
        from ompi_tpu_torch import profile

        profile.detach_tool(_api_handle)
        _api_handle = None
    return fl


def _install_api_hook() -> None:
    global _api_handle
    if _api_handle is not None:
        return
    from ompi_tpu_torch import profile

    tokens: Dict[tuple, int] = {}

    def pre(name, comm, args, kwargs):
        fl = FLIGHT
        if fl is None:
            return
        nbytes = getattr(args[0], "nbytes", 0) if args else 0
        tokens[id(comm), name, threading.get_ident()] = fl.enter(
            name, getattr(comm, "cid", -1), nbytes)

    def post(name, comm, result, error):
        tok = tokens.pop((id(comm), name, threading.get_ident()), None)
        fl = FLIGHT
        if fl is not None and tok is not None:
            fl.exit(tok)

    _api_handle = profile.attach_tool(pre, post,
                                      names=list(API_COLLECTIVES))
