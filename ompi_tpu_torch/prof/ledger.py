"""Wall-clock attribution ledger — phases + transfer spans.

The port's copy of ``ompi_tpu.prof.ledger``:

- **Phase ledger**: ``with ledger.phase("staging"): ...`` marks
  first-class ``staging`` / ``compile`` / ``train`` / ``teardown`` /
  ``snapshot`` regions (nestable, reentrant, thread-aware). Each exit
  records a ``prof_phase_<name>_ns`` pvar and — when the trace
  recorder is up — a span on the ``prof`` track, so Perfetto shows
  the run's wall breakdown as a top-level lane. Cross-thread
  different-phase concurrency accrues ``prof_phase_overlap_ns`` —
  how the ingest plane proves staging || compile and the async
  checkpoint plane proves snapshot || train.
- **Transfer accounting**: instrumented copy sites (the accelerator's
  ``to_host`` / ``to_device`` / ``copy_async`` / ``put_chunk``,
  coll/device's staging of a host operand) call :meth:`Profiler.xfer`
  with direction + bytes + [t0, t1): span on the ``xfer`` track,
  ``prof_xfer_<dir>_{bytes,ns}`` counters, a rolling-bandwidth window
  (gauge-published by the telemetry sampler), a peak-bandwidth
  watermark, and a log2 size/latency histogram
  (``trace_hist_xfer_<dir>_*``). On the card a copy is asynchronous:
  the accelerator's sites synchronise the copy's stream before the
  closing timestamp while the profiler is on (and only then), as the
  reference calls ``block_until_ready``.

Hot-path contract: while disabled — the default — an instrumented site
pays ONE module attribute load + ONE branch (``ledger.PROFILER is
None``) and constructs nothing; :func:`phase` returns a shared no-op
context manager.

Clock discipline: all timestamps are ``time.monotonic_ns`` — the same
timebase the trace recorder exports and ``sync_clock`` rebases.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, Optional

from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.trace import recorder as _trace

_enable_var = cvar.register(
    "prof_enable", False, bool,
    help="Enable the wall-clock attribution profiler at instance "
         "init: phase ledger + transfer spans + compile accounting "
         "(equivalently: any truthy OMPI_TPU_PROF env value).",
    level=5)
_window_var = cvar.register(
    "prof_bw_window", 32, int,
    help="Transfers kept per direction in the rolling-bandwidth "
         "window the telemetry sampler publishes as a gauge.", level=7)

#: THE disabled guard. Instrumented sites do
#: ``if ledger.PROFILER is not None: ...`` — module attribute load
#: plus one branch, nothing constructed on the None path.
PROFILER: Optional["Profiler"] = None


def now() -> int:
    return time.monotonic_ns()


class _Nop:
    """Shared no-op context manager — what :func:`phase` hands out
    while the profiler is disabled (nothing allocated per call)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOP = _Nop()


class _PhaseOpen:
    """One open phase region (the enabled-path object)."""

    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof: "Profiler", name: str) -> None:
        self._prof = prof
        self._name = name

    def __enter__(self) -> "_PhaseOpen":
        self._t0 = self._prof._push(self._name)
        return self

    def __exit__(self, *exc):
        self._prof._pop(self._name, self._t0)
        return False


class Profiler:
    """Process-wide attribution state: phase stacks + transfer window.

    Phase stacks are per-thread (nesting on one thread never
    interleaves with another thread's phases) but registered in one
    table so :meth:`current_phase` answers "what is this RANK doing"
    from any thread — the watchdog's dump-on-hang thread reads the
    main thread's stack."""

    def __init__(self, rank: int = 0) -> None:
        self.rank = rank
        self._lock = threading.Lock()
        #: thread ident -> stack of (phase name, t0) (innermost last)
        self._stacks: Dict[int, list] = {}
        self._totals_ns: Dict[str, int] = {}
        self._counts: Dict[str, int] = {}
        #: wall covered by concurrently-open DIFFERENT-name phases on
        #: different threads (ingest: staging || compile) — why
        #: phase_staging_s + phase_compile_s may exceed wall_s
        self._overlap_ns = 0
        win = max(1, int(_window_var.get()))
        #: per-direction rolling (nbytes, dur_ns) window
        self._windows: Dict[str, collections.deque] = {
            "h2d": collections.deque(maxlen=win),
            "d2h": collections.deque(maxlen=win),
        }
        self._main_ident = threading.main_thread().ident

    # -- phase ledger ------------------------------------------------------
    def phase(self, name: str) -> _PhaseOpen:
        return _PhaseOpen(self, name)

    def _push(self, name: str) -> int:
        ident = threading.get_ident()
        t0 = now()
        with self._lock:
            self._stacks.setdefault(ident, []).append((name, t0))
        return t0

    def _pop(self, name: str, t0: int) -> None:
        t1 = now()
        ident = threading.get_ident()
        ov = 0
        with self._lock:
            stack = self._stacks.get(ident)
            if stack and stack[-1][0] == name:
                stack.pop()
            if not stack:
                self._stacks.pop(ident, None)
            self._totals_ns[name] = \
                self._totals_ns.get(name, 0) + (t1 - t0)
            self._counts[name] = self._counts.get(name, 0) + 1
            # cross-thread overlap: wall this phase shared with a
            # DIFFERENT-name phase still open on another thread. The
            # earlier-closing side accounts the pair (the survivor
            # will only overlap against phases open at ITS close), so
            # each concurrent pair counts once; same-name phases on
            # two threads (N staging workers) deliberately don't
            # count — that is parallelism inside one phase, not
            # phase-vs-phase overlap.
            other_t0 = None
            for oid, ostack in self._stacks.items():
                if oid == ident:
                    continue
                for oname, ot0 in ostack:
                    if oname != name and (other_t0 is None
                                          or ot0 < other_t0):
                        other_t0 = ot0
            if other_t0 is not None:
                ov = max(0, t1 - max(t0, other_t0))
                self._overlap_ns += ov
        pvar.record("prof_phase_%s_ns" % name, t1 - t0)
        if ov > 0:
            pvar.record("prof_phase_overlap_ns", ov)
        rec = _trace.RECORDER
        if rec is not None:
            rec.record(name, "prof", t0, t1)

    def current_phase(self) -> Optional[str]:
        """Innermost open phase — this thread's if it has one, else
        the main thread's, else any thread's (the watchdog/sampler
        threads want the rank's phase, not their own)."""
        ident = threading.get_ident()
        with self._lock:
            for key in (ident, self._main_ident):
                stack = self._stacks.get(key)
                if stack:
                    return stack[-1][0]
            for stack in self._stacks.values():
                if stack:
                    return stack[-1][0]
        return None

    def phase_seconds(self) -> Dict[str, float]:
        """Accumulated wall seconds per phase name (closed phases
        only; a nested phase counts in itself AND its parent)."""
        with self._lock:
            return {k: v / 1e9 for k, v in self._totals_ns.items()}

    def phase_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def overlap_seconds(self) -> float:
        """Wall seconds spent under >= 2 concurrently-open
        different-name phases (closed pairs only): how far
        ``sum(phase_seconds())`` may legitimately exceed the wall."""
        with self._lock:
            return self._overlap_ns / 1e9

    # -- transfer accounting ----------------------------------------------
    def xfer(self, direction: str, nbytes: int, t0: int, t1: int,
             **args) -> None:
        """Account one completed host<->device copy: pvar counters,
        log2 size/latency histogram, rolling + peak bandwidth, and a
        span on the ``xfer`` track when the recorder is up. ``args``
        carry site detail (chunk count, stream index, site name)."""
        dur = max(0, t1 - t0)
        nbytes = int(nbytes)
        pvar.record("prof_xfer_%s_bytes" % direction, nbytes)
        pvar.record("prof_xfer_%s_ns" % direction, dur)
        _trace.hist("xfer_%s" % direction, nbytes, dur)
        if dur > 0:
            # bytes/ns == GB/s; watermark kept in MB/s so the integer
            # pvar plane resolves sub-GB/s links
            pvar.record_hwm("prof_xfer_%s_bw_mbps" % direction,
                            int(nbytes * 1e3 / dur))
        with self._lock:
            w = self._windows.get(direction)
            if w is None:
                w = self._windows[direction] = collections.deque(
                    maxlen=max(1, int(_window_var.get())))
            w.append((nbytes, dur))
        rec = _trace.RECORDER
        if rec is not None:
            rec.record(direction, "xfer", t0, t1,
                       dict(args, bytes=nbytes) if args
                       else {"bytes": nbytes})

    def xfer_chunk(self, direction: str, nbytes: int, t0: int, t1: int,
                   chunk: int, **args) -> None:
        """Span-only record for one chunk of a chunked transfer (the
        parent :meth:`xfer` call owns the byte/bandwidth accounting —
        chunks must not double-count)."""
        rec = _trace.RECORDER
        if rec is not None:
            rec.record("%s_chunk" % direction, "xfer", t0, t1,
                       dict(args, bytes=int(nbytes), chunk=chunk))

    def rolling_bw_bps(self, direction: str) -> Optional[float]:
        """Bytes/second over the rolling window (None: no samples or
        zero elapsed — e.g. all-async dispatches measuring 0 ns)."""
        with self._lock:
            w = self._windows.get(direction)
            if not w:
                return None
            nbytes = sum(b for b, _ in w)
            ns = sum(d for _, d in w)
        if ns <= 0:
            return None
        return nbytes * 1e9 / ns


# -- module-level convenience (the instrumented-site API) -----------------

def phase(name: str):
    """``with ledger.phase("staging"): ...`` — no-op (shared
    singleton, nothing constructed) while the profiler is off."""
    p = PROFILER
    if p is None:
        return _NOP
    return p.phase(name)


def current_phase() -> Optional[str]:
    p = PROFILER
    return None if p is None else p.current_phase()


def phase_seconds() -> Dict[str, float]:
    p = PROFILER
    return {} if p is None else p.phase_seconds()


def overlap_seconds() -> float:
    p = PROFILER
    return 0.0 if p is None else p.overlap_seconds()


# -- enable / disable ----------------------------------------------------

def requested() -> bool:
    """cvar prof_enable (incl. OMPI_TPU_PROF_ENABLE env) or the
    short-form OMPI_TPU_PROF env knob."""
    if _enable_var.get():
        return True
    raw = os.environ.get("OMPI_TPU_PROF", "").strip().lower()
    return raw not in ("", "0", "false", "no", "off")


def enable(rank: Optional[int] = None) -> Profiler:
    """Turn the profiler on (idempotent)."""
    global PROFILER
    if PROFILER is None:
        PROFILER = Profiler(rank=0 if rank is None else rank)
    elif rank is not None:
        PROFILER.rank = rank
    return PROFILER


def disable() -> Optional[Profiler]:
    """Turn the profiler off; returns it (totals stay readable)."""
    global PROFILER
    p, PROFILER = PROFILER, None
    return p
