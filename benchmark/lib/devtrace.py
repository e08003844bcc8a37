"""The device trace of a rank: ``torch.profiler`` (CUPTI, device
activity alone) over whole steps, each device operation put on the
host's monotonic clock.

Every rank's profiler has its own time base. Beside its start and its
stop the rank launches a few empty ``spin_kernel`` markers
(``torch.cuda._sleep``), each between a synchronise and a read of
``time.monotonic_ns`` before it and a synchronise and a read after it:
the marker ran inside that bracket, which bounds the offset from trace
time to the monotonic clock that every process of one host shares. The
tightest bracket gives the offset, known to half its width
(``align_err_ns``); the start's and the stop's offsets differ by the
drift (``align_drift_ns``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

#: chrome-trace categories of operations that run on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
_MARKS = 8


class DeviceTrace:
    def __init__(self, path: str, device) -> None:
        self.path = path
        self.device = device
        self.prof = None
        self.brackets: List[tuple] = []

    def _mark(self) -> None:
        import torch

        for _ in range(_MARKS):
            torch.cuda.synchronize(self.device)
            t0 = time.monotonic_ns()
            torch.cuda._sleep(1)
            torch.cuda.synchronize(self.device)
            self.brackets.append((t0, time.monotonic_ns()))

    def warm(self) -> None:
        """Start and stop a profiler once, in set-up: the tracer's first
        start in a process takes seconds (about 9 s with one rank per
        H100), which would otherwise fall inside the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1)
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._mark()

    def stop(self) -> None:
        """Stop tracing (the trace is read by :meth:`read`, after the
        window)."""
        self._mark()
        self.prof.stop()

    def read(self) -> Dict:
        """``{"ops": [[name, t0_ns, t1_ns], ...], ...}`` on the
        monotonic clock."""
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            return read_chrome(self.path, self.brackets)
        finally:
            os.unlink(self.path)


def read_chrome(path: str, brackets: List[tuple]) -> Dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    marks: List[tuple] = []
    ops: List[tuple] = []
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS]
    # microseconds from the first device event, then ns (an epoch-based
    # timestamp in ns would lose its last bits in a float)
    base = min((float(e["ts"]) for e in dev), default=0.0)
    for e in dev:
        ts = (float(e["ts"]) - base) * 1e3
        dur = float(e.get("dur", 0.0)) * 1e3
        if MARKER in e.get("name", ""):
            marks.append((ts, dur))
        else:
            ops.append((e.get("name", ""), ts, ts + dur))
    marks.sort()
    if len(marks) != len(brackets):
        raise RuntimeError(f"device trace: {len(marks)} markers in the "
                           f"trace, {len(brackets)} launched")
    # the marker ran inside its bracket: offset in [a - ts, b - dur - ts]
    cands = [((a - ts) + (b - dur - ts)) / 2 for (ts, dur), (a, b)
             in zip(marks, brackets)]
    widths = [(b - dur - ts) - (a - ts) for (ts, dur), (a, b)
              in zip(marks, brackets)]
    half = len(cands) // 2
    best = [min(range(lo, hi), key=lambda i: widths[i])
            for lo, hi in ((0, half), (half, len(cands)))]
    off = cands[best[0]]
    return {"ops": [[name, t0 + off, t1 + off] for name, t0, t1 in ops],
            "align_err_ns": max(widths[i] for i in best) / 2,
            "align_drift_ns": cands[best[1]] - cands[best[0]]}
