"""Requests — completion objects for nonblocking operations.

The port's reduced copy of ``ompi_tpu.pml.request`` (reference:
ompi/request/, req_test.c / req_wait.c): ``Status``, the request id
counter and the plural wait / test helpers, which is what coll/device's
``DeviceRequest`` and ``PersistentDeviceRequest`` use. The host
``Request`` and its progress engine come with the pml slice (ROADMAP
queue 1 item 2); until then nothing here drives progress, so the plural
helpers poll each request's ``completed``, which a device request
answers live from its event.
"""

from __future__ import annotations

import itertools
import time
from typing import List, Optional, Sequence

ANY_SOURCE = -1
ANY_TAG = -1

_req_ids = itertools.count(1)


class Status:
    """MPI_Status."""

    __slots__ = ("source", "tag", "error", "count", "cancelled")

    def __init__(self) -> None:
        self.source = ANY_SOURCE
        self.tag = ANY_TAG
        self.error = 0
        self.count = 0
        self.cancelled = False

    def __repr__(self) -> str:
        return (f"Status(source={self.source}, tag={self.tag}, "
                f"count={self.count})")


def _wait_until(pred, timeout: Optional[float] = None) -> bool:
    """Poll ``pred`` (spinning, then yielding the CPU) until it holds or
    ``timeout`` seconds pass; returns whether it held."""
    deadline = None if timeout is None else time.monotonic() + timeout
    spins = 0
    while not pred():
        if deadline is not None and time.monotonic() > deadline:
            return False
        spins += 1
        if spins > 64:
            time.sleep(0 if spins < 4096 else 1e-4)
    return True


def wait_all(reqs: Sequence, timeout: Optional[float] = None) -> List[Status]:
    if not _wait_until(lambda: all(r.completed for r in reqs), timeout):
        raise TimeoutError("waitall timed out")
    return [r.retrieve_status() for r in reqs]


def wait_any(reqs: Sequence) -> int:
    _wait_until(lambda: any(r.completed for r in reqs))
    for i, r in enumerate(reqs):
        if r.completed:
            r.retrieve_status()
            return i
    raise AssertionError("wait_any: no request completed")


def wait_some(reqs: Sequence) -> List[int]:
    _wait_until(lambda: any(r.completed for r in reqs))
    done = [i for i, r in enumerate(reqs) if r.completed]
    for i in done:
        reqs[i].retrieve_status()
    return done


def test_all(reqs: Sequence) -> bool:
    if all(r.completed for r in reqs):
        for r in reqs:
            r.retrieve_status()
        return True
    return False


def test_any(reqs: Sequence) -> Optional[int]:
    for i, r in enumerate(reqs):
        if r.completed:
            r.retrieve_status()
            return i
    return None
