"""The progress engine — one poll loop driving every transport.

The port's copy of ``ompi_tpu.core.progress`` (reference:
opal/runtime/opal_progress.c — components register callbacks,
opal_progress_register :416; opal_progress() sweeps them, :216-224, and
yields after an idle spin threshold, :50-68). Blocking completion waits
call progress in a loop (ompi/request SYNC_WAIT,
opal/threads/wait_sync.h:52). ob1, the btls and the device-tensor
requests of ``pml/accel_p2p`` all spin on it; a callback that raises
``StopIteration`` is unregistered.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional

from ompi_tpu_torch.core import cvar

_callbacks: List[Callable[[], int]] = []
_lock = threading.Lock()

_spin_var = cvar.register(
    "progress_spin_count", 200, int,
    help="Idle progress iterations before yielding the CPU. The "
         "reference uses 10000 C-loop iterations (opal_progress.c:51); "
         "one Python sweep costs ~50x a C one, so the default is scaled "
         "down to keep the pre-yield spin time comparable.", level=8)

_yield_var = cvar.register(
    "yield_when_idle", "auto", str,
    help="Yield the CPU aggressively while waiting: 'on' drops the "
         "idle spin to a handful of sweeps, 'off' spins the full "
         "progress_spin_count, 'auto' turns on when local ranks "
         "oversubscribe the cores (the reference's mpi_yield_when_idle).",
    choices=["auto", "on", "off"], level=5)

_oversubscribed: Optional[bool] = None


def _spin_budget() -> int:
    """Idle sweeps before the first yield. An oversubscribed host (more
    local ranks than cores) must hand the core to the peer that owns the
    data almost at once."""
    mode = _yield_var.get()
    if mode == "off":
        return _spin_var.get()
    if mode == "on":
        return 4
    global _oversubscribed
    if _oversubscribed is None:
        local = int(os.environ.get("OMPI_TPU_LOCAL_SIZE", "1") or 1)
        try:  # affinity-aware: the cores we may actually run on
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            cores = os.cpu_count() or 1
        _oversubscribed = local > cores
    return 1 if _oversubscribed else _spin_var.get()


def register(cb: Callable[[], int]) -> None:
    with _lock:
        if cb not in _callbacks:
            _callbacks.append(cb)


def unregister(cb: Callable[[], int]) -> None:
    with _lock:
        try:
            _callbacks.remove(cb)
        except ValueError:
            pass


def progress() -> int:
    """Sweep all registered callbacks; returns the number of events."""
    events = 0
    # a snapshot: callbacks may register or unregister during the sweep
    for cb in tuple(_callbacks):
        try:
            events += cb() or 0
        except StopIteration:
            unregister(cb)
    return events


def wait_until(cond: Callable[[], bool],
               timeout: Optional[float] = None) -> bool:
    """Spin progress until cond() — the SYNC_WAIT equivalent. Returns
    cond() at the deadline when a timeout passes first."""
    spin_max = _spin_budget()
    deadline = None if timeout is None else time.monotonic() + timeout
    idle = 0
    yields = 0
    while not cond():
        if progress() > 0:
            idle = 0
            yields = 0
        else:
            idle += 1
            if idle >= spin_max:
                # yield first (latency), then real sleeps so an
                # oversubscribed host still makes progress
                yields += 1
                time.sleep(0 if yields < 4 else
                           min(100e-6 * yields, 2e-3))
                idle = 0
        if deadline is not None and time.monotonic() > deadline:
            return cond()
    return True
