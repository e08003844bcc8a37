"""accelerator/ipc — same-host export of a buffer to another process.

Port of ``ompi_tpu.accelerator.ipc`` (reference: accelerator.h's
get_ipc_handle / open_ipc_handle, which smsc/accelerator builds on). As
there, a handle stages through POSIX shared memory: export snapshots the
buffer's bytes into a file under the shm dir, the handle
(:class:`IpcHandle`: the path, the shape, the dtype) is picklable, so it
travels in a modex or an object message, import maps the file, and
:func:`release` unlinks it. The components add the device side
(``Accelerator.ipc_export`` / ``ipc_import``): the null component
exports numpy arrays and CPU tensors and imports without a copy (a
read-only numpy view, or a tensor over a private mapping); the cuda
component exports a CUDA tensor with one device-to-host copy into the
mapped file and imports with one host-to-device copy onto the caller's
device. The arenas of ``coll/cuda.py`` keep their own CUDA IPC.

File names carry the launcher's prefix and the job id
(``{SHM_PREFIX}{jobid}_ipc_<pid>_<id>``), so the launcher sweeps a file
that a crashed exporter leaves behind.
"""

from __future__ import annotations

import mmap
import os
import uuid
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class IpcHandle:
    """Picklable handle a peer process can open (modex-transportable, as
    the reference's 64-byte CUipcMemHandle). ``dtype`` is a numpy dtype's
    name for an exported array, a torch dtype's (``"bfloat16"``) for a
    tensor."""

    path: str
    shape: Tuple[int, ...]
    dtype: str
    tensor: bool = False


def _new_path(shm_dir) -> str:
    from ompi_tpu_torch.runtime import launcher, rte

    return os.path.join(
        shm_dir or launcher.shm_dir(),
        f"{launcher.SHM_PREFIX}{rte.jobid}_ipc_{os.getpid()}_"
        f"{uuid.uuid4().hex[:8]}")


def _map(path: str, nbytes: int, access) -> mmap.mmap:
    fd = os.open(path, os.O_RDWR if access == mmap.ACCESS_WRITE
                 else os.O_RDONLY)
    try:
        return mmap.mmap(fd, max(nbytes, 1), access=access)
    finally:
        os.close(fd)


def export_array(host: np.ndarray, shm_dir=None) -> IpcHandle:
    """Snapshot a numpy array's bytes into a new shm file."""
    path = _new_path(shm_dir)
    with open(path, "wb") as fh:
        fh.write(np.ascontiguousarray(host).tobytes())
    return IpcHandle(path, tuple(host.shape), str(host.dtype))


def import_array(handle: IpcHandle, writable: bool = False) -> np.ndarray:
    """The exported array as a numpy view of the mapped file (read-only
    unless ``writable``, which writes through to the file)."""
    dt = np.dtype(handle.dtype)
    mm = _map(handle.path, os.stat(handle.path).st_size,
              mmap.ACCESS_WRITE if writable else mmap.ACCESS_READ)
    n = int(np.prod(handle.shape, dtype=np.int64))
    return np.frombuffer(mm, dtype=dt, count=n).reshape(handle.shape)


def export_tensor(t: torch.Tensor, shm_dir=None) -> IpcHandle:
    """Copy a tensor's bytes into a new shm file: straight from its
    device into the mapping (one copy; a device-to-host copy for a CUDA
    tensor)."""
    flat = t.detach().reshape(-1).contiguous()
    nbytes = flat.numel() * flat.element_size()
    path = _new_path(shm_dir)
    with open(path, "wb") as fh:
        fh.truncate(nbytes)
    if nbytes:
        mm = _map(path, nbytes, mmap.ACCESS_WRITE)
        dst = torch.frombuffer(mm, dtype=torch.uint8)
        dst.copy_(flat.view(torch.uint8))
        del dst  # the mapping's export, before it closes
        mm.close()
    return IpcHandle(path, tuple(t.shape),
                     str(t.dtype).removeprefix("torch."), True)


def import_tensor(handle: IpcHandle, device=None) -> torch.Tensor:
    """The exported tensor: over a private mapping of the file (no copy)
    on the CPU, or copied once onto ``device``."""
    dt = getattr(torch, handle.dtype)
    n = int(np.prod(handle.shape, dtype=np.int64))
    if n == 0:
        return torch.empty(handle.shape, dtype=dt, device=device)
    # ACCESS_COPY: writable for torch, and writes stay in this process
    mm = _map(handle.path, os.stat(handle.path).st_size, mmap.ACCESS_COPY)
    host = torch.frombuffer(mm, dtype=dt, count=n).view(handle.shape)
    if device is None or torch.device(device).type == "cpu":
        return host
    return host.to(device)


def release(handle: IpcHandle) -> None:
    """Exporter-side cleanup: unlink the file (mappings stay valid)."""
    try:
        os.unlink(handle.path)
    except OSError:
        pass
