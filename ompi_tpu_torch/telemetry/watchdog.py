"""Collective hang watchdog — straggler naming + dump-on-hang.

The port's copy of ``ompi_tpu.telemetry.watchdog`` (PyTorch c10d/NCCL
flight-recorder semantics, on the framework's planes): every sweep
publishes this rank's latest collective seq as the kvstore heartbeat
payload, then checks the flight recorder's
oldest in-flight entry. Once an entry is stuck past
``telemetry_hang_timeout``, the watchdog pulls every rank's published
seq from the store, and any LIVE rank whose last-entered seq is below
the stuck seq is named a straggler — the rank that never entered
collective #N. Ranks the ft detector (or the store's staleness
promotion) already declared dead are excluded, and a verdict whose
stragglers have ALL since been declared dead resolves itself: the
failure detector owns that diagnosis (no duplicate/conflicting
verdicts for one root cause).

On a new hang verdict the watchdog fires dump-on-hang exactly once per
stuck seq: one JSON file (verdict + in-flight table + pvar snapshot +
trace spans when the recorder is up), a ``telemetry_hang`` MPI-4
event, the ``telemetry_hangs`` pvar — and, under
``telemetry_hang_action=abort``, a job abort after the dump lands.

When the elastic plane reports an in-progress recovery (shrink or
hot-join regrow), a collective stuck past the timeout is expected
downtime rather than a hang: the verdict carries
``kind="recovery"`` with the recovery phase, the dump lands under
``ompi_tpu_recovery_*`` — and no hang pvar, event, or abort fires.

The dump also carries the tune observatory's run-over-run regression
verdicts (``tune_regressions``) and the skew plane's context (``skew``),
and at skew level 2 each sweep compares the heartbeat payloads'
last-arrival stamps to name the slow rank before it hangs, and the
check-plane sanitizer's last collective signature mismatch
(``check_mismatch``, the reference's :309-316).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ompi_tpu_torch.core import cvar, events, output, pvar
from ompi_tpu_torch.skew import record as _skew_record
from ompi_tpu_torch.telemetry import flight

_out = output.stream("telemetry")

_timeout_var = cvar.register(
    "telemetry_hang_timeout", 30.0, float,
    help="Seconds a collective may stay in flight before the "
         "watchdog declares a hang and dumps. 0 disables the "
         "watchdog (the sampler/flight recorder still run).", level=5)
_period_var = cvar.register(
    "telemetry_watchdog_period", 0.5, float,
    help="Watchdog sweep period in seconds (each sweep also "
         "publishes this rank's collective seq on the heartbeat "
         "plane).", level=6)
_action_var = cvar.register(
    "telemetry_hang_action", "dump", str,
    help="On a hang verdict: 'dump' writes the diagnosis and keeps "
         "waiting (the rank may yet arrive); 'abort' dumps then "
         "takes the job down via the store abort plane.", level=5,
    choices=["dump", "abort"])
_dump_dir_var = cvar.register(
    "telemetry_dump_dir", "", str,
    help="Directory for hang dumps (created if missing); default "
         "is the working directory.", level=6)

TELEMETRY_HANG = events.register_type(
    "telemetry_hang",
    "the watchdog declared a collective hung and named stragglers",
    ("op", "seq", "comm_cid", "waited_s", "stragglers", "dump_path"))

#: the reference's schema: a dump reads the same from either package
DUMP_SCHEMA = "ompi_tpu.telemetry.hang/1"


class Watchdog:
    """Sweep thread over the flight recorder + heartbeat seq plane.

    Every collaborator is injectable (store client, flight recorder,
    dead-set source, world ranks) and :meth:`sweep` is callable
    directly, so tests drive verdict logic without threads or
    timeouts."""

    def __init__(self, rank: int = 0, jobid: str = "singleton",
                 world=None, client=None, flight_rec=None,
                 dead_fn=None, period: Optional[float] = None,
                 timeout: Optional[float] = None,
                 action: Optional[str] = None,
                 dump_dir: Optional[str] = None,
                 recovery_fn=None) -> None:
        self.rank = rank
        self.jobid = jobid
        self._world = world  # iterable of world ranks; rte's on start
        self._client = client
        self._flight = flight_rec
        self._dead_fn = dead_fn
        self._recovery_fn = recovery_fn
        self.period = (_period_var.get() if period is None
                       else float(period))
        self.timeout = (_timeout_var.get() if timeout is None
                        else float(timeout))
        self.action = _action_var.get() if action is None else action
        self.dump_dir = (_dump_dir_var.get() if dump_dir is None
                         else dump_dir)
        #: current hang diagnosis (None = healthy); tests and the
        #: dump read the same dict
        self.verdict: Optional[Dict[str, Any]] = None
        # (stuck seq, verdict kind) -> dump path: one dump per seq
        # per kind, so a recovery that fails into a real hang (or the
        # reverse) still gets its own diagnosis
        self._dumped: Dict[Any, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Watchdog":
        if self._client is None:
            from ompi_tpu_torch.runtime import kvstore, rte

            # dedicated store connection (same reasoning as the ft
            # detector: never queue behind the shared rte socket)
            self._client = kvstore.Client(rte.client().addr)
        if self._world is None:
            from ompi_tpu_torch.runtime import rte

            self._world = rte.world_ranks()
        self._thread = threading.Thread(
            target=self._run, name="ompi-tpu-telemetry-watchdog",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.period + 1)
            self._thread = None
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.sweep()
            except Exception as exc:  # noqa: BLE001 — diagnosis must
                # never become the failure
                if self._stop.is_set():
                    return
                _out.verbose(1, "watchdog sweep failed: %r", exc)

    # -- one sweep ---------------------------------------------------------
    def sweep(self) -> Optional[Dict[str, Any]]:
        """Publish seq, check the oldest in-flight entry, update the
        verdict; returns the current verdict (None = healthy)."""
        pvar.record("telemetry_watchdog_sweeps")
        fl = self._flight if self._flight is not None else flight.FLIGHT
        if fl is None:
            return None
        if self._client is not None:
            self._client.heartbeat(self.rank, fl.hb_dict())
        sk = _skew_record.SKEW
        if sk is not None and sk.level >= 2 \
                and self._client is not None:
            # level-2 live skew: the heartbeat payloads' last-arrival
            # stamps name the SLOW rank while the job still makes
            # progress — before (or instead of) a hang verdict
            try:
                sk.observe_live(self._client.telemetry(), self.rank,
                                fl.last_arrival_ns, fl.last_entered)
            except Exception:  # noqa: BLE001 — diagnosis must never
                # become the failure
                pass
        oldest = fl.oldest()
        if oldest is None:
            self.verdict = None  # everything completed: healthy
            return None
        seq, op, cid, nbytes, t0 = oldest
        waited = time.monotonic() - t0
        dead = self._dead()
        if self.verdict is not None:
            named = self.verdict["stragglers"]
            if named and all(r in dead for r in named):
                # the failure detector declared every named straggler
                # dead — that diagnosis supersedes the hang verdict
                _out.verbose(1, "hang verdict seq %d resolved: "
                             "stragglers %s declared dead",
                             self.verdict["seq"], named)
                self.verdict = None
        if waited < self.timeout:
            if self.verdict is not None \
                    and self.verdict["seq"] != seq:
                self.verdict = None  # the stuck op completed
            return self.verdict
        rec_info = self._recovery()
        if rec_info is not None:
            # an elastic recovery legitimately parks this rank (and
            # its peers) in a collective past the timeout — name the
            # recovery instead of inventing stragglers
            self.verdict = {
                "kind": "recovery", "op": op, "seq": seq,
                "comm_cid": cid, "nbytes": nbytes,
                "waited_s": round(waited, 3), "stragglers": [],
                "recovery": rec_info,
            }
            if (seq, "recovery") not in self._dumped:
                self._dumped[(seq, "recovery")] = self._dump(fl)
            return self.verdict
        peers = (self._client.telemetry()
                 if self._client is not None else {})
        entered = {r: int(p.get("seq", 0))
                   for r, p in peers.items()
                   if isinstance(p, dict)}
        entered[self.rank] = fl.last_entered
        stragglers = sorted(
            r for r in (self._world or entered)
            if r not in dead and entered.get(r, 0) < seq)
        if not stragglers and any(entered.get(r, 0) < seq
                                  for r in dead):
            # the only ranks missing from the collective are ones the
            # failure detector already declared dead — that plane owns
            # the diagnosis, a hang verdict would just duplicate it
            self.verdict = None
            return None
        # per-rank last-arrival lateness (the heartbeat "arr" wall-ns
        # stamps), relative to the FIRST arrival into the stuck
        # collective: a rank that entered it shows how late it
        # entered ("rank 3 entered 40 s late"); a rank still missing
        # shows how late it already is — now minus the first arrival,
        # growing every sweep (everyone's stamps froze when the job
        # blocked, so a freshest-stamp comparison would hide the
        # stall); a rank with no stamp at all never entered anything
        # (late_s None)
        arrs = {r: int(p.get("arr", 0)) for r, p in peers.items()
                if isinstance(p, dict)}
        arrs[self.rank] = fl.last_arrival_ns
        first_in = min((a for r, a in arrs.items()
                        if a and entered.get(r, 0) >= seq),
                       default=0)
        now_ns = time.time_ns()
        arrivals = {}
        for r in (self._world or entered):
            a = arrs.get(r, 0)
            if not a or not first_in:
                late = None
            elif entered.get(r, 0) >= seq:
                late = round(max(0, a - first_in) / 1e9, 3)
            else:
                late = round(max(0, now_ns - first_in) / 1e9, 3)
            arrivals[r] = {"seq": entered.get(r, 0), "late_s": late}
        self.verdict = {
            "op": op, "seq": seq, "comm_cid": cid, "nbytes": nbytes,
            "waited_s": round(waited, 3), "stragglers": stragglers,
            "peer_seqs": entered, "dead": dict(dead),
            "arrivals": arrivals,
        }
        if (seq, "hang") not in self._dumped:
            self._dumped[(seq, "hang")] = self._dump(fl)
        return self.verdict

    def _recovery(self) -> Optional[Dict[str, Any]]:
        """The elastic recovery in progress on this rank, if any
        (injectable for tests; default: the elastic plane's
        process-wide recovery_info)."""
        if self._recovery_fn is not None:
            return self._recovery_fn()
        try:
            from ompi_tpu_torch import elastic

            return elastic.recovery_info()
        except Exception:  # noqa: BLE001 — diagnosis must never
            # become the failure
            return None

    def _dead(self) -> Dict[int, str]:
        """Failed ranks: the ft detector's live snapshot when it runs,
        else the store's authoritative dead set."""
        if self._dead_fn is not None:
            return dict(self._dead_fn())
        from ompi_tpu_torch.ft import detector as ft_detector

        det = ft_detector.get()
        if det is not None:
            return dict(det.dead)
        if self._client is not None:
            try:
                return self._client.faults(None)
            except Exception:  # noqa: BLE001
                return {}
        return {}

    # -- dump-on-hang ------------------------------------------------------
    def _dump(self, fl) -> str:
        v = self.verdict
        from ompi_tpu_torch.prof import ledger as _prof_ledger

        doc: Dict[str, Any] = {
            "schema": DUMP_SCHEMA,
            "rank": self.rank,
            "jobid": self.jobid,
            "wall_time": time.time(),
            "verdict": v,
            # phase from the attribution ledger: a rank stuck in
            # staging reports phase=staging instead of being
            # misattributed to the collective it never reached
            "phase": _prof_ledger.current_phase(),
            "inflight": fl.snapshot(),
            "pvars": pvar.snapshot(),
        }
        # a collective signature mismatch the check-plane sanitizer
        # observed is the likeliest root cause of this hang — put it
        # next to the verdict (optional key, same dump schema)
        from ompi_tpu_torch.check import sanitizer as _check_san

        san = _check_san.SANITIZER
        if san is not None and san.last_mismatch is not None:
            doc["check_mismatch"] = san.last_mismatch
        # an async snapshot in flight is expected d2h/commit work, not
        # a hang — name it (step, phase, chunk progress) so a dump
        # taken mid-snapshot reads as "busy checkpointing", and the
        # ckpt_* pvars above carry the corroborating counters
        from ompi_tpu_torch.io import async_ckpt as _ackpt

        snap = _ackpt.snapshot_info()
        if snap is not None:
            doc["ckpt_snapshot"] = snap
        # a rank blocked in a zero-3 parameter gather is a LATE
        # PREFETCH (the layer-ahead scheduler lost the race), not a
        # lost peer — name the layer so the dump reads as an overlap
        # tuning problem instead of a false hang (optional key)
        from ompi_tpu_torch.zero import zero3 as _zero3

        pf = _zero3.prefetch_info()
        if pf is not None:
            doc["zero3_prefetch"] = pf
        # a congested ICI link is another likely hang cause: name this
        # rank's hottest link + its top peer (optional key, level 2)
        from ompi_tpu_torch.monitoring import matrix as _mon

        tm = _mon.TRAFFIC
        if tm is not None:
            hot = tm.hotspot()
            if hot:
                doc["traffic_hotspot"] = hot
        # a hang that follows a 10x collective slowdown is likelier a
        # degraded link than a lost peer: the observatory's run-over-run
        # regression verdicts name the slow keys
        from ompi_tpu_torch import tune as _tune

        regs = _tune.regression_info()
        if regs is not None:
            doc["tune_regressions"] = regs
        # a hang on a rank the live skew view already saw falling behind
        # says so next to the verdict (skew level 2)
        from ompi_tpu_torch import skew as _skew

        sk_info = _skew.skew_info()
        if sk_info is not None:
            doc["skew"] = sk_info
        from ompi_tpu_torch.trace import recorder as _trace

        rec = _trace.RECORDER
        if rec is not None:
            doc["trace_spans"] = [
                {"name": s.name, "subsys": s.subsys, "t0": s.t0,
                 "t1": s.t1, "args": s.args}
                for s in rec.spans()[-2048:]]
        d = self.dump_dir or "."
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            d = "."
        kind = v.get("kind", "hang")
        prefix = ("ompi_tpu_recovery" if kind == "recovery"
                  else "ompi_tpu_hang")
        path = os.path.join(
            d, "%s_rank%d_seq%d.json" % (prefix, self.rank, v["seq"]))
        tmp = "%s.tmp.%d" % (path, os.getpid())
        try:
            with open(tmp, "w") as fh:
                json.dump(doc, fh, indent=1, default=repr)
            os.replace(tmp, path)
        except OSError as exc:
            _out.verbose(0, "hang dump write failed: %r", exc)
            path = ""
        if kind == "recovery":
            # an in-progress elastic recovery is expected downtime:
            # record the diagnosis but fire no hang pvar/event/abort
            rec = v.get("recovery") or {}
            _out.verbose(0, "RECOVERY: %s seq %d waited %.1fs — "
                         "elastic %s at phase %s in progress -> %s",
                         v["op"], v["seq"], v["waited_s"],
                         rec.get("kind", "?"), rec.get("phase", "?"),
                         path or "(dump failed)")
            return path
        pvar.record("telemetry_hangs")
        _out.verbose(0, "HANG: %s seq %d stuck %.1fs phase=%s, "
                     "stragglers %s -> %s", v["op"], v["seq"],
                     v["waited_s"], doc["phase"] or "?",
                     v["stragglers"], path or "(dump failed)")
        if events.active("telemetry_hang"):
            events.emit("telemetry_hang", op=v["op"], seq=v["seq"],
                        comm_cid=v["comm_cid"],
                        waited_s=v["waited_s"],
                        stragglers=tuple(v["stragglers"]),
                        dump_path=path)
        if self.action == "abort":
            from ompi_tpu_torch.runtime import rte

            rte.abort("collective hang: %s seq %d stragglers %s "
                      "(dump: %s)" % (v["op"], v["seq"],
                                      v["stragglers"], path), 1)
        return path
