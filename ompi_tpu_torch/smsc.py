"""smsc — shared-memory single copy (the cma component).

The port's copy of ``ompi_tpu.smsc`` (reference: opal/mca/smsc/cma):
same-host rendezvous messages skip the shared-memory ring's copy-in and
copy-out and move their payload with one copy between the two
processes' address spaces. The receiver pulls straight from the
sender's buffer with ``process_vm_readv`` once it learns (pid, address)
from the rendezvous envelope (ob1's ``HDR_RNDV_SC``, the RGET protocol
with CMA as the RDMA).

Availability is probed once with a self-read and can be turned off with
``--mca smsc off``. A cross-process EPERM at run time (yama ptrace
restrictions the self-read cannot see) disqualifies cma for the rest of
the job, and the message streams through the ring instead, as the
reference does.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from ompi_tpu_torch.core import cvar, output, pvar

_out = output.stream("smsc")

_mode_var = cvar.register(
    "smsc", "cma", str,
    help="Single-copy component for same-host RNDV: 'cma' "
         "(process_vm_readv) or 'off' (stream through the sm ring).",
    choices=["cma", "off"], level=5)

_lock = threading.Lock()
_available: Optional[bool] = None
_libc = None


class _iovec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p),
                ("iov_len", ctypes.c_size_t)]


def _lib():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
        _libc.process_vm_readv.restype = ctypes.c_ssize_t
    return _libc


def available() -> bool:
    """cma enabled and working (probed once with a self-read)."""
    global _available
    if _available is not None:
        return _available
    with _lock:
        if _available is not None:
            return _available
        if _mode_var.get() == "off":
            _available = False
            return False
        probe = np.arange(8, dtype=np.int64)
        out = np.zeros(8, dtype=np.int64)
        try:
            n = _read_raw(os.getpid(), probe.ctypes.data, out.ctypes.data,
                          probe.nbytes)
            _available = n == probe.nbytes and bool((out == probe).all())
        except (OSError, AttributeError) as exc:  # denied, or no symbol
            _out.verbose(1, "cma probe failed: %s", exc)
            _available = False
        _out.verbose(2, "smsc/cma available: %s", _available)
        return _available


def disqualify(reason: str) -> None:
    """Permanent run-time fallback to streaming (a cross-process
    EPERM)."""
    global _available
    _out.verbose(1, "smsc/cma disqualified: %s", reason)
    _available = False


def _read_raw(pid: int, remote_addr: int, local_addr: int,
              nbytes: int) -> int:
    local = _iovec(local_addr, nbytes)
    remote = _iovec(remote_addr, nbytes)
    n = _lib().process_vm_readv(
        pid, ctypes.byref(local), 1, ctypes.byref(remote), 1, 0)
    if n < 0:
        raise OSError(ctypes.get_errno(), "process_vm_readv failed")
    return n


def read(pid: int, remote_addr: int, dst: memoryview) -> int:
    """Pull len(dst) bytes from (pid, remote_addr) into dst, a writable
    contiguous buffer. Raises OSError on a permission or paging error
    (the caller streams instead)."""
    arr = np.frombuffer(dst, dtype=np.uint8)
    total = arr.nbytes
    moved = 0
    while moved < total:  # partial reads are legal at region splits
        n = _read_raw(pid, remote_addr + moved, arr.ctypes.data + moved,
                      total - moved)
        if n == 0:
            raise OSError("process_vm_readv returned 0")
        moved += n
    pvar.record("smsc_single_copies")
    pvar.record("smsc_bytes", total)
    return moved
