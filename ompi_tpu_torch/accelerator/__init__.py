"""Accelerator framework — device buffer integration.

Reference: opal/mca/accelerator/ (accelerator.h:668-711: check_addr,
memcpy / memcpy_async, device info, synchronize, ...) and
``ompi_tpu.accelerator`` (to_device / copy_async,
``__init__.py:60-75``). In the port a device buffer is a
``torch.Tensor`` and a host buffer is numpy — the split the JAX package
draws between ``jax.Array`` and numpy. The ``cuda`` component serves
CUDA tensors when a GPU is usable; this base component (the reference's
``null``) serves CPU tensors, the device buffers of the CPU platform, with
copies that complete before they return.

The staging entries that device-tensor point-to-point uses
(``pml/accel_p2p``): :meth:`Accelerator.host_buffer` (a host chunk
buffer, pinned for CUDA), :meth:`Accelerator.copy_async` (device to
host into such a buffer, returning a :class:`.stream.CopyEvent`) and
:meth:`Accelerator.to_device` (host to device from one, returning an
:class:`.stream.Event`). There is no synchronous device-to-host copy:
staging goes through these alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch.accelerator import stream


class Accelerator:
    """The module interface, reduced to the port's entries; this base
    class serves CPU tensors. Its copies are numpy's: a torch copy of a
    CPU tensor past its grain size wakes the intra-op thread pool, which
    ranks sharing the cores oversubscribe."""

    NAME = "null"

    def check_addr(self, buf) -> bool:
        """True if buf is a device buffer (reference: check_addr)."""
        return isinstance(buf, torch.Tensor)

    def num_devices(self) -> int:
        return 0

    def device_info(self) -> dict:
        return {"name": "cpu", "count": 0}

    def synchronize(self) -> None:
        pass

    # -- staging (reference: memcpy, memcpy_async) ------------------------
    def host_buffer(self, nbytes: int, device) -> torch.Tensor:
        """A uint8 host buffer that copies to and from ``device`` stage
        through."""
        return torch.empty(nbytes, dtype=torch.uint8)

    def copy_async(self, src: torch.Tensor,
                   host: torch.Tensor) -> stream.CopyEvent:
        """Copy the uint8 tensor ``src`` into ``host[:src.numel()]``;
        the event's ``wait()`` returns the host bytes as numpy."""
        n = src.numel()
        np.copyto(host[:n].numpy(), src.detach().numpy())
        return stream.CopyEvent(src.device, host, n)

    def to_device(self, host: torch.Tensor,
                  dst: torch.Tensor) -> stream.Event:
        """Copy ``host[:dst.numel()]`` into the uint8 tensor ``dst``."""
        np.copyto(dst.detach().numpy(), host[:dst.numel()].numpy())
        return stream.Event(dst.device)

    def begin_staging(self, device) -> None:
        """Order the staging streams after the work queued so far on
        ``device``'s current stream (nothing to order on the CPU)."""

    # -- IPC (reference: get / open ipc mem handles) -----------------------
    def ipc_export(self, buf):
        """A picklable handle that a same-host process opens with
        :meth:`ipc_import`: the buffer's bytes snapshotted into a shm file
        (:mod:`.ipc`); the exporter unlinks it with ``ipc.release``."""
        from ompi_tpu_torch.accelerator import ipc

        if isinstance(buf, torch.Tensor):
            return ipc.export_tensor(buf)
        return ipc.export_array(np.asarray(buf))

    def ipc_import(self, handle, device=None):
        """The exported buffer without a copy: a read-only numpy view of
        an exported array, a CPU tensor over a private mapping of an
        exported tensor."""
        from ompi_tpu_torch.accelerator import ipc

        if handle.tensor:
            return ipc.import_tensor(handle)
        return ipc.import_array(handle)


_current: Optional[Accelerator] = None
_host = Accelerator()


def current() -> Accelerator:
    """The selected component (cuda when torch sees a GPU, else null)."""
    global _current
    if _current is None:
        if torch.cuda.is_available():
            from ompi_tpu_torch.accelerator.cuda import CudaAccelerator

            _current = CudaAccelerator()
        else:
            _current = _host
    return _current


def for_device(device) -> Accelerator:
    """The component that stages tensors of ``device``: cuda for a CUDA
    device, null for the CPU."""
    return current() if torch.device(device).type == "cuda" else _host


def is_device_buffer(buf) -> bool:
    """The one predicate every device-dispatch layer shares."""
    return current().check_addr(buf)
