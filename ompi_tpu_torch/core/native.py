"""Loader for the sm ring's C code (``btl/csrc/sm_ring.c``) via ctypes.

The port's counterpart of ``ompi_tpu.core.native``: the Python plane
keeps the logic and the native library owns the sm SPSC ring's publish
and consume, with real acquire/release atomics instead of the x86-TSO
and GIL assumption of the Python ring. The library is built with the
system C compiler (``$CC``, else ``cc``) at first use into
``build/ompi_tpu_torch/`` beside the CUDA libraries, keyed by a hash of
the source; ranks that race serialize on a lock file. Without a
compiler, or with ``--mca native off``, the sm btl runs its Python ring
(the reference's behaviour).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional

from ompi_tpu_torch.core import cvar, output

_out = output.stream("native")

_enabled_var = cvar.register(
    "native", True, bool,
    help="Use the C sm ring (btl/csrc/sm_ring.c, built with cc at first "
         "use) when buildable; the Python ring otherwise.", level=4)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "btl", "csrc", "sm_ring.c")
CFLAGS = ("-O3", "-fPIC", "-std=c11", "-shared")


def build_dir() -> str:
    """``build/ompi_tpu_torch`` at the repo root (gitignored)."""
    return os.path.join(os.path.dirname(_PKG), "build", "ompi_tpu_torch")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CFLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir(), f"sm_ring-{digest.hexdigest()[:12]}.so")


def lib() -> Optional[ctypes.CDLL]:
    """The native ring library, built on first call; None if disabled
    or unbuildable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _enabled_var.get():
            return None
        path = _build()
        if path is not None:
            try:
                _lib = _bind(ctypes.CDLL(path))
            except (OSError, AttributeError) as exc:
                _out.verbose(1, "native ring unusable: %s", exc)
        return _lib


def _bind(L: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    L.otr_ring_push.restype = ctypes.c_int
    L.otr_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_char_p, ctypes.c_uint32]
    L.otr_ring_pop.restype = ctypes.c_int64
    L.otr_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                               ctypes.c_void_p, ctypes.c_uint64]
    L.otr_ring_readable.restype = ctypes.c_uint64
    L.otr_ring_readable.argtypes = [ctypes.c_void_p]
    L.otr_abi_version.restype = ctypes.c_int
    if L.otr_abi_version() != 1:
        _out.verbose(1, "native ring ABI mismatch; ignoring")
        return None
    return L


def _build() -> Optional[str]:
    """Compile into a private temp file, then publish it atomically (a
    half-written library must never be loaded by a racing rank)."""
    path = library_path()
    if os.path.exists(path):
        return path
    try:
        os.makedirs(build_dir(), exist_ok=True)
        with open(os.path.join(build_dir(), "sm_ring.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if os.path.exists(path):
                return path
            tmp = f"{path}.{os.getpid()}.tmp"
            cc = os.environ.get("CC", "cc")
            r = subprocess.run([cc, *CFLAGS, SRC, "-o", tmp],
                               capture_output=True, text=True, timeout=120)
            if r.returncode != 0:
                _out.verbose(1, "native ring build failed:\n%s", r.stderr)
                return None
            os.replace(tmp, path)
            return path
    except (OSError, subprocess.TimeoutExpired) as exc:
        _out.verbose(1, "native ring build unavailable: %s", exc)
        return None
