"""Failure detector — heartbeat emitter and fault / revocation observer.

The port's copy of ``ompi_tpu.ft.detector`` (reference:
ompi/communicator/ft/comm_ft_detector.c:30-74, a ring where each process
heartbeats its successor; runtime-level detection is PRTE's job,
docs/features/ulfm.rst:260-262). As in the JAX package, detection is
star-shaped over the rendezvous store (the always-on daemon plane):
every rank heartbeats the store, the store judges staleness with one
monotonic clock, and the launcher's waitpid feeds death notices into the
same dead set (``--mca ft 1``). The observer half polls the store from
its own thread and leaves a snapshot; a progress-engine callback applies
it on the MPI thread: new deaths to the pml (``on_fault``, which errors
the requests towards them and fills its ``failed`` set) and to the
``ft_process_failure`` MPI_T event, revocations to their comms and the
pml (``on_revoke``). Revocation rides the same poll: ``revoke`` bumps a
job-wide epoch counter, and observers re-read the per-comm revoke keys
only when it moves.

Where the port differs from the reference: the heartbeat carries no
telemetry payload (the flight recorder comes with ROADMAP queue 1 item
10), and the eventful sweep's wall is timed by hand (``ft_sweep_ns``;
the port's pvars have no timer).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Set

from ompi_tpu_torch.core import cvar, events, output, progress, pvar
from ompi_tpu_torch.runtime import kvstore, rte

_out = output.stream("ft")

_ft_var = cvar.register(
    "ft", False, bool,
    help="Enable ULFM fault tolerance: heartbeat detector + failure "
         "sweeps. Set by the launcher's --mca ft 1.", level=3)
_period_var = cvar.register(
    "ft_heartbeat_period", 0.05, float,
    help="Heartbeat emission/observation period in seconds "
         "(reference: detector period, comm_ft_detector.c).", level=6)
_timeout_var = cvar.register(
    "ft_heartbeat_timeout", 1.0, float,
    help="Seconds without a heartbeat before a rank is declared dead "
         "(reference: detector timeout).", level=6)

_detector: Optional["Detector"] = None


def enabled() -> bool:
    return _ft_var.get()


def start() -> "Detector":
    """Start (or return) the process-wide detector."""
    global _detector
    if _detector is None:
        _detector = Detector()
        _detector.start()
    return _detector


def stop() -> None:
    global _detector
    if _detector is not None:
        _detector.stop()
        _detector = None


def get() -> Optional["Detector"]:
    return _detector


class Detector:
    """Emitter thread + observer snapshot + progress-side applier."""

    def __init__(self) -> None:
        self.period = _period_var.get()
        self.hb_timeout = _timeout_var.get()
        # the observer's snapshot (written by the thread, read by the
        # sweep)
        self.dead: Dict[int, str] = {}
        self.revoked_cids: Set[int] = set()
        self._applied_dead: Set[int] = set()
        self._applied_revokes: Set[int] = set()
        self._rev_epoch = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # a connection of its own: the emitter must never queue behind a
        # blocking RPC on the rte client's socket
        self._client = kvstore.Client(rte.client().addr)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="ompi-tpu-torch-ft-detector",
            daemon=True)
        self._thread.start()
        progress.register(self._sweep)

    def stop(self) -> None:
        self._stop.set()
        progress.unregister(self._sweep)
        if self._thread is not None:
            self._thread.join(timeout=2 * self.period + 1)
        self._client.close()

    # -- emitter / observer thread -----------------------------------------
    def _run(self) -> None:
        failures = 0
        while not self._stop.wait(self.period):
            try:
                self._client.heartbeat(rte.rank)
                pvar.record("ft_heartbeats")
                self.dead = self._client.faults(self.hb_timeout)
                epoch = self._client.inc(f"ft:rev_epoch:{rte.jobid}", 0)
                if epoch != self._rev_epoch:
                    self._rev_epoch = epoch
                    self._poll_revokes()
                failures = 0
            except Exception as exc:  # noqa: BLE001
                if self._stop.is_set():
                    return  # the shutdown race
                failures += 1
                _out.verbose(1, "detector RPC failed (%d/3): %s",
                             failures, exc)
                if failures < 3:
                    # transient (reset, timeout under load): reconnect and
                    # keep observing, or this rank goes blind to failures
                    # and its peers declare it stale-dead
                    try:
                        self._client.close()
                        self._client = kvstore.Client(rte.client().addr)
                        continue
                    except Exception:  # noqa: BLE001
                        pass
                from ompi_tpu_torch.util import show_help

                show_help.show("ft", "detector-dead", rank=rte.rank,
                               error=str(exc))
                return  # the store is gone: the job is coming down

    def _poll_revokes(self) -> None:
        from ompi_tpu_torch import comm as comm_mod
        from ompi_tpu_torch.ft import _revoke_key

        with comm_mod._comms_lock:
            cids = {c.cid: c for c in comm_mod._comms.values()}
        for cid, c in cids.items():
            if cid in self.revoked_cids:
                continue
            if self._client.get(_revoke_key(c), wait=False):
                self.revoked_cids.add(cid)

    # -- progress-engine applier (MPI thread) ----------------------------
    def _sweep(self) -> int:
        """Apply new faults / revocations to the pml and the comms. Runs
        on every progress tick, so the no-news path is two length checks
        (both applied sets grow monotonically out of the snapshots, so
        equal lengths mean equal sets); only the eventful path is timed
        (``ft_sweep_ns``)."""
        if (len(self._applied_dead) == len(self.dead)
                and len(self._applied_revokes) == len(self.revoked_cids)):
            return 0
        t0 = time.perf_counter_ns()
        n = 0
        new_dead = {r: why for r, why in self.dead.items()
                    if r not in self._applied_dead}
        if new_dead:
            self._applied_dead.update(new_dead)
            pvar.record("ft_faults_observed", len(new_dead))
            _out.verbose(1, "rank %d: failures detected: %s", rte.rank,
                         new_dead)
            for r, why in new_dead.items():
                if events.active("ft_process_failure"):
                    events.emit("ft_process_failure", rank=r, reason=why)
            n += self._apply_faults(set(new_dead))
        new_rev = self.revoked_cids - self._applied_revokes
        if new_rev:
            self._applied_revokes |= new_rev
            pvar.record("ft_revokes_applied", len(new_rev))
            n += self._apply_revokes(new_rev)
        pvar.record("ft_sweep_ns", time.perf_counter_ns() - t0)
        return n

    def _apply_faults(self, dead: Set[int]) -> int:
        from ompi_tpu_torch import pml

        fn = getattr(pml.instance(), "on_fault", None)
        return fn(dead) if fn is not None else 0

    def _apply_revokes(self, cids: Set[int]) -> int:
        from ompi_tpu_torch import comm as comm_mod, pml

        n = 0
        fn = getattr(pml.instance(), "on_revoke", None)
        for cid in cids:
            c = comm_mod.lookup_cid(cid)
            if c is not None and not c.revoked:
                c.revoked = True
                n += 1
            if fn is not None:
                n += fn(cid)
        return n
