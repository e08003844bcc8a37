"""Per-process bounded ring-buffer span recorder.

The port's copy of ``ompi_tpu.trace.recorder``: Score-P/OTF2 region
records and the Chrome trace-event recorder's tradition (bounded memory,
drop accounting, monotonic timestamps) layered on the MPI_T planes. Drops
surface as the ``trace_dropped`` pvar, span completion raises a
``trace_span`` MPI-4 event while a tool listens (``events.active``), and
the log2 latency histogram (:func:`hist`) is plain pvar counters
readable through ``pvar.snapshot()`` / ``mpit``.

Hot-path contract: while disabled (the default) an instrumented site
pays ONE attribute load and ONE branch (``recorder.RECORDER is None``)
and constructs nothing; ``tests/test_torch_trace.py`` scans every site.
A span covers host time: on the card the launches it brackets are
asynchronous, so a ``launch`` span is the dispatch, as in the reference
(PJRT's dispatch is asynchronous too).

Clocks: spans carry ``time.monotonic_ns`` timestamps. At enable each
rank samples ``wall - monotonic`` (``clock_offset_ns``); :func:`sync_clock`
exchanges these through the runtime store (modex) so every rank exports
in rank 0's timebase (``clock_base_ns``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from ompi_tpu_torch.core import cvar, events, pvar
from ompi_tpu_torch.telemetry import clock as _clock

_enable_var = cvar.register(
    "trace_enable", False, bool,
    help="Enable the span recorder at instance init (equivalently: "
         "any truthy OMPI_TPU_TRACE env value).", level=5)
_cap_var = cvar.register(
    "trace_buffer_spans", 65536, int,
    help="Span ring-buffer capacity; overflow overwrites the oldest "
         "span and counts in the trace_dropped pvar.", level=5)

#: span completion as an MPI-4 event (emitted only while a tool
#: listens — the standard events.active guard)
TRACE_SPAN = events.register_type(
    "trace_span",
    "a trace span closed (recorder plane)",
    ("name", "subsys", "t0_ns", "dur_ns"))

#: THE disabled guard. Instrumented sites do
#: ``if recorder.RECORDER is not None: ...`` — module attribute load
#: plus one branch, nothing constructed on the None path.
RECORDER: Optional["Recorder"] = None

_api_handle: Optional[int] = None


def now() -> int:
    return time.monotonic_ns()


class Span:
    """One closed region: [t0, t1) in monotonic ns."""

    __slots__ = ("name", "subsys", "t0", "t1", "args")

    def __init__(self, name: str, subsys: str, t0: int, t1: int,
                 args: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.subsys = subsys
        self.t0 = t0
        self.t1 = t1
        self.args = args

    def __repr__(self) -> str:
        return (f"Span({self.name}, {self.subsys}, "
                f"dur={self.t1 - self.t0}ns, {self.args})")


class Recorder:
    """Thread-safe bounded ring of spans (oldest overwritten)."""

    def __init__(self, capacity: Optional[int] = None,
                 rank: int = 0) -> None:
        cap = int(capacity if capacity is not None else _cap_var.get())
        self.capacity = max(1, cap)
        self._buf: List[Optional[Span]] = [None] * self.capacity
        self._head = 0
        self._n = 0
        self._lock = threading.Lock()
        self.rank = rank
        # bracketed wall-minus-monotonic at enable (telemetry/clock);
        # sync_clock rebases exports onto rank 0's offset
        self.clock_offset_ns, self.clock_err_ns = \
            _clock.sample_offset()
        self.clock_base_ns = self.clock_offset_ns
        self.clock_base_err_ns = self.clock_err_ns

    def record(self, name: str, subsys: str, t0: int, t1: int,
               args: Optional[Dict[str, Any]] = None) -> Span:
        sp = Span(name, subsys, t0, t1, args)
        with self._lock:
            if self._n == self.capacity:
                pvar.record("trace_dropped")
            else:
                self._n += 1
            self._buf[self._head] = sp
            self._head = (self._head + 1) % self.capacity
        if events.active("trace_span"):
            events.emit("trace_span", name=name, subsys=subsys,
                        t0_ns=t0, dur_ns=t1 - t0)
        return sp

    def instant(self, name: str, subsys: str,
                args: Optional[Dict[str, Any]] = None) -> Span:
        """Zero-duration marker (renders as a sliver in Perfetto)."""
        t = now()
        return self.record(name, subsys, t, t, args)

    class _Open:
        __slots__ = ("_rec", "_name", "_subsys", "_args", "_t0")

        def __init__(self, rec, name, subsys, args):
            self._rec = rec
            self._name = name
            self._subsys = subsys
            self._args = args

        def __enter__(self):
            self._t0 = now()
            return self

        def __exit__(self, *exc):
            self._rec.record(self._name, self._subsys, self._t0,
                             now(), self._args)
            return False

    def span(self, name: str, subsys: str, **args) -> "_Open":
        """``with rec.span("compile", "coll_xla", key=k): ...``"""
        return self._Open(self, name, subsys, args or None)

    def spans(self) -> List[Span]:
        """Chronological (completion-order) snapshot."""
        with self._lock:
            if self._n < self.capacity:
                out = self._buf[:self._n]
            else:
                out = self._buf[self._head:] + self._buf[:self._head]
            return list(out)

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._head = 0
            self._n = 0


# -- log2 latency histogram (pvar-plane export) --------------------------

HIST_PREFIX = "trace_hist_"


def hist(op: str, nbytes: int, dur_ns: int) -> None:
    """One histogram sample: counter ``trace_hist_<op>_sz<s>_lat<l>``
    with s = bit_length(nbytes) and l = bit_length(dur_ns) — log2
    bins per (op, size-bin), readable via ``pvar.snapshot()`` /
    ``mpit`` sessions, decoded by ``trace.export.histograms``.
    Callers guard on ``RECORDER is not None``; this records
    unconditionally."""
    pvar.record("%s%s_sz%d_lat%d" % (
        HIST_PREFIX, op, int(nbytes).bit_length(),
        max(0, int(dur_ns)).bit_length()))


# -- enable / disable ----------------------------------------------------

def requested() -> bool:
    """cvar trace_enable (incl. OMPI_TPU_TRACE_ENABLE env) or the
    short-form OMPI_TPU_TRACE env knob."""
    if _enable_var.get():
        return True
    raw = os.environ.get("OMPI_TPU_TRACE", "").strip().lower()
    return raw not in ("", "0", "false", "no", "off")


def enable(capacity: Optional[int] = None, rank: Optional[int] = None,
           api_spans: bool = True) -> Recorder:
    """Turn the recorder on (idempotent). ``api_spans`` interposes an
    entry/exit span tool on the MPI API through the PMPI chain
    (profile.attach_tool) — subsystem "api"."""
    global RECORDER
    if RECORDER is None:
        RECORDER = Recorder(capacity,
                            rank=0 if rank is None else rank)
        if api_spans:
            _install_api_hook()
    elif rank is not None:
        RECORDER.rank = rank
    return RECORDER


def disable() -> Optional[Recorder]:
    """Turn the recorder off; returns it (spans stay exportable)."""
    global RECORDER, _api_handle
    rec, RECORDER = RECORDER, None
    if _api_handle is not None:
        from ompi_tpu_torch import profile

        profile.detach_tool(_api_handle)
        _api_handle = None
    return rec


def _install_api_hook() -> None:
    """API entry/exit spans via the PMPI interposition chain."""
    global _api_handle
    if _api_handle is not None:
        return
    from ompi_tpu_torch import profile

    stack: Dict[tuple, int] = {}

    def pre(name, comm, args, kwargs):
        if RECORDER is not None:
            stack[id(comm), name, threading.get_ident()] = now()

    def post(name, comm, result, error):
        t0 = stack.pop((id(comm), name, threading.get_ident()), None)
        rec = RECORDER
        if rec is None or t0 is None:
            return
        rec.record(name, "api", t0, now(),
                   {"error": type(error).__name__}
                   if error is not None else None)

    _api_handle = profile.attach_tool(pre, post)


def sync_clock() -> None:
    """Exchange wall-vs-monotonic offsets through the runtime store
    so every rank exports in rank 0's monotonic timebase. All ranks
    must have tracing enabled (the env/cvar knobs are job-uniform by
    construction) — the modex read blocks until rank 0 publishes.
    The exchange itself is telemetry/clock.py's (shared with the
    skew plane's "skew_clock" sync)."""
    rec = RECORDER
    if rec is None:
        return
    from ompi_tpu_torch.runtime import rte

    rec.rank = rte.rank
    rec.clock_base_ns, rec.clock_base_err_ns = _clock.sync_via_store(
        "trace_clock", rec.clock_offset_ns, rec.clock_err_ns)
