"""memchecker — buffer definedness shadow-tracking (race tooling).

The port's copy of ``ompi_tpu/check/memchecker.py``;
``ompi_tpu_torch/core/memchecker.py`` re-exports it, as the JAX
package's ``core/memchecker.py`` does.

Reference: opal/mca/memchecker/valgrind + the ``MEMCHECKER()``
annotations every API binding carries (ompi/mpi/c/allreduce.c:52-66):
under Valgrind, receive buffers are marked *undefined* while a request
is pending and *defined* on completion, so user code reading — or
worse, sending — data that hasn't arrived yet is flagged at the exact
racy access.

TPU-first redesign: Valgrind cannot see Python/numpy, so the shadow
state lives here instead — an address-interval map of
currently-undefined regions, updated by the PML at request post and
completion time, consulted at every send/pack entry. What it catches
(each a real MPI usage race the reference's annotations catch):

- sending from a buffer with a pending receive into it,
- posting overlapping concurrent receives,
- reading a receive buffer before the request completed
  (via :func:`check_defined` from application code or tests).

Only host buffers have a shadow: a ``torch.Tensor``, on the CPU or on
the card, maps to the empty interval, as a jax array (no ``ctypes``,
no buffer protocol) does in the JAX package, so a tensor is never
flagged and never shadows anything.

Off by default (``--mca memchecker on`` enables): the shadow updates
sit on the p2p hot path, the same reason the reference compiles
MEMCHECKER() to nothing unless configured with valgrind support.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.errors import MPIError

_mode = cvar.register(
    "memchecker", "off", str,
    help="Buffer-definedness shadow tracking: 'on' flags sends from / "
         "overlapping posts of buffers with pending receives "
         "(reference: memchecker/valgrind MEMCHECKER annotations); "
         "'warn' reports without raising; 'off' compiles to no-ops.",
    choices=["on", "warn", "off"], level=6)

_lock = threading.Lock()
#: request-id -> (start, end) address interval marked undefined
_undefined: Dict[int, Tuple[int, int]] = {}


class MemcheckError(MPIError):
    """A definedness violation (the Valgrind report analog)."""


def enabled() -> bool:
    return _mode.get() != "off"


def _interval(arr, nbytes: int = 0) -> Tuple[int, int]:
    """Byte interval of a numpy-backed buffer (0,0 when addressless).
    ``nbytes`` > 0 limits the span to the bytes an operation actually
    touches (a recv of count elements into a larger buffer must not
    shadow the untouched tail). A tensor has no shadow (0, 0)."""
    if isinstance(arr, torch.Tensor):
        return 0, 0
    try:
        if isinstance(arr, np.ndarray):
            # byte_bounds handles non-contiguous/negative-stride views
            # where ctypes.data is not the lowest address and nbytes
            # overstates the touched span
            try:
                from numpy.lib.array_utils import byte_bounds
            except ImportError:  # numpy < 2
                byte_bounds = np.byte_bounds
            lo, hi = byte_bounds(arr)
            if nbytes > 0 and arr.flags["C_CONTIGUOUS"]:
                hi = min(hi, lo + nbytes)
            return lo, hi
        start = arr.ctypes.data
        total = arr.nbytes
    except AttributeError:
        try:
            mv = memoryview(arr)
            import ctypes

            start = ctypes.addressof(ctypes.c_char.from_buffer(mv))
            total = mv.nbytes
        except Exception:  # noqa: BLE001 — object path has no address
            return 0, 0
    if nbytes > 0:
        total = min(total, nbytes)
    return start, start + total


def _overlaps(ivl: Tuple[int, int]) -> List[Tuple[int, Tuple[int, int]]]:
    s, e = ivl
    if s == e:
        return []
    return [(rid, (a, b)) for rid, (a, b) in _undefined.items()
            if a < e and s < b]


def _flag(msg: str) -> None:
    pvar.record("memchecker_violations")
    if _mode.get() == "warn":
        from ompi_tpu_torch.core import output

        output.stream("memchecker").verbose(0, "%s", msg)
    else:
        raise MemcheckError(msg)


def mark_undefined(req_id: int, arr, nbytes: int = 0) -> None:
    """Receive posted: contents undefined until completion (``nbytes``
    bounds the shadow to the receive's true extent). Also flags a
    second receive overlapping a still-pending one."""
    if not enabled():
        return
    ivl = _interval(arr, nbytes)
    with _lock:
        clash = _overlaps(ivl)
        _undefined[req_id] = ivl
    if clash:
        _flag(f"receive posted into bytes [{ivl[0]:#x},{ivl[1]:#x}) "
              f"overlapping {len(clash)} pending receive(s) — "
              "concurrent receives into the same buffer race")


def mark_defined(req_id: int) -> None:
    """Receive completed (or cancelled): contents are the sender's.
    Runs even when disabled so toggling the cvar mid-job cannot strand
    stale shadow intervals."""
    if _undefined:
        with _lock:
            _undefined.pop(req_id, None)


def check_defined(arr, what: str = "send", nbytes: int = 0) -> None:
    """Flag use of a buffer whose bytes are undefined (pending recv);
    ``nbytes`` bounds the span to the bytes the operation actually
    reads. Called by the PML on every send pack; callable from
    applications as the ``MEMCHECKER(memchecker_call(...))`` analog."""
    if not enabled() or not _undefined:
        return
    ivl = _interval(arr, nbytes)
    with _lock:
        clash = _overlaps(ivl)
    if clash:
        _flag(f"{what} reads bytes [{ivl[0]:#x},{ivl[1]:#x}) that "
              f"overlap {len(clash)} pending receive(s) — data not "
              "yet defined")


def reset_for_testing() -> None:
    with _lock:
        _undefined.clear()
