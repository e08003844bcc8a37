"""PMPI-style profiling interposition on the MPI API surface.

The port's copy of ``ompi_tpu.profile`` (reference: every C binding is a
weak symbol a tool can interpose, ompi/mpi/c/allreduce.c:37-41's
PMPI_Allreduce alias, and SPC_RECORD instruments each entry). The API
methods live in one table (``ompi_tpu_torch.mpi._API``) attached to
``Communicator``; a tool attaches pre / post hooks and every call of
those names on every communicator flows through them. Tools nest like
PMPI layers::

    from ompi_tpu_torch import profile
    h = profile.attach_tool(
        pre=lambda name, comm, args, kwargs: ...,
        post=lambda name, comm, result, error: ...)
    ...
    profile.detach_tool(h)

:func:`timing` is a ready-made tool: per-call counts and wall seconds,
also published as the pvars ``profile_<op>_calls`` and
``profile_<op>_ns`` (``core/pvar.py``'s ``profile_`` family), the
reference's test/monitoring/test_overhead.c pattern.
"""

from __future__ import annotations

import functools
import itertools
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

_handles = itertools.count(1)
_active: Dict[int, Dict[str, Callable]] = {}  # handle -> {name: wrapped}


def _wrap(name: str, fn: Callable, pre, post) -> Callable:
    @functools.wraps(fn)
    def wrapper(comm, *args, **kwargs):
        if pre is not None:
            pre(name, comm, args, kwargs)
        error = result = None
        try:
            result = fn(comm, *args, **kwargs)
            return result
        except BaseException as exc:
            error = exc
            raise
        finally:
            if post is not None:
                post(name, comm, result, error)
    wrapper.__profiled__ = True
    return wrapper


def attach_tool(pre: Optional[Callable] = None,
                post: Optional[Callable] = None,
                names: Optional[list] = None) -> int:
    """Interpose ``pre`` / ``post`` on the MPI API (``names``: only those
    calls); returns the handle :func:`detach_tool` takes."""
    from ompi_tpu_torch import mpi
    from ompi_tpu_torch.comm import Communicator

    saved: Dict[str, Callable] = {}
    for name in (names if names is not None else list(mpi._API)):
        cur = getattr(Communicator, name, None)
        if cur is None:
            continue
        saved[name] = cur  # what this tool wrapped (maybe another tool)
        setattr(Communicator, name, _wrap(name, cur, pre, post))
    handle = next(_handles)
    _active[handle] = saved
    return handle


def detach_tool(handle: int) -> None:
    """Remove a tool, restoring the methods it wrapped. Detach in LIFO
    order: detaching an inner tool first drops every tool attached after
    it on those names."""
    from ompi_tpu_torch.comm import Communicator

    for name, prev in _active.pop(handle, {}).items():
        setattr(Communicator, name, prev)


@contextmanager
def timing(names: Optional[list] = None):
    """Per-call counts and wall seconds (``{name: [calls, seconds]}``),
    each call also recorded as ``profile_<name>_calls`` and
    ``profile_<name>_ns``."""
    from ompi_tpu_torch.core import pvar

    stats: Dict[str, list] = {}
    stack: Dict[tuple, float] = {}

    def pre(name, comm, args, kwargs):
        stack[id(comm), name] = time.perf_counter()

    def post(name, comm, result, error):
        t0 = stack.pop((id(comm), name), None)
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        cell = stats.setdefault(name, [0, 0.0])
        cell[0] += 1
        cell[1] += dt
        pvar.record(f"profile_{name}_calls")
        pvar.record(f"profile_{name}_ns", int(dt * 1e9))

    handle = attach_tool(pre, post, names)
    try:
        yield stats
    finally:
        detach_tool(handle)
