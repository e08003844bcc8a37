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
staging goes through these alone. The streaming ingest plane's substrate
(reference ``accelerator/tpu.py:238-275``): :meth:`Accelerator.h2d_streams`
(a reused pool of upload streams), :meth:`Accelerator.put_chunk` (one
asynchronous put of a staged chunk into a device slice, returning a
:class:`.stream.Event`) and :meth:`Accelerator.close_h2d_streams`.

Selection is the registry's (``core/registry.py``, the ``accelerator``
framework and cvar): ``cuda`` (priority 50) where torch sees a GPU, else
``null`` (this base class, priority 1), as the reference's
``framework.select_one()`` picks tpu over null (``__init__.py:210-217``).

The prof plane's transfer sites (reference ``accelerator/tpu.py:110-225``):
:meth:`Accelerator.copy_async` is a ``d2h`` and :meth:`Accelerator.to_device`
an ``h2d`` :meth:`~ompi_tpu_torch.prof.ledger.Profiler.xfer` (bytes,
time, histogram, span on the ``xfer`` lane), :meth:`Accelerator.put_chunk`
an ``h2d_chunk`` span (``xfer_chunk``: the ingest plane accounts the
bytes of its units itself). Each reads ``ledger.PROFILER`` once and
branches; the CPU copies are done on return, and the cuda component
synchronises the copy's stream before the closing timestamp while the
profiler is on, and only then.
Where it differs: on the ``cuda`` platform (``device_plane_platform``,
the default) a cuda component that fails to open raises
``MPIError(ERR_INTERN)`` with its cause (the reference logs and skips
it), and with the device plane requested and no usable GPU the cuda
component fails to open; it never falls to ``null``. ``--mca accelerator
^cuda`` selects ``null`` as asked.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.accelerator import stream
from ompi_tpu_torch.core import registry
from ompi_tpu_torch.prof import ledger as _prof

framework = registry.framework("accelerator")

#: put_chunk's ordinal on the xfer lane (profiled puts only)
_put_seq = itertools.count()


@framework.register
class Accelerator(registry.Component):
    """The module interface, reduced to the port's entries; this base
    class serves CPU tensors. Its copies are numpy's: a torch copy of a
    CPU tensor past its grain size wakes the intra-op thread pool, which
    ranks sharing the cores oversubscribe."""

    NAME = "null"
    PRIORITY = 1  # the fallthrough

    def check_addr(self, buf) -> bool:
        """True if buf is a device buffer (reference: check_addr)."""
        return isinstance(buf, torch.Tensor)

    def num_devices(self) -> int:
        return 0

    def device_info(self) -> dict:
        return {"name": "cpu", "count": 0}

    def synchronize(self) -> None:
        pass

    # -- memory kinds (info_memkind.c) ------------------------------------
    def memkind_info(self) -> list:
        """The memory kinds this component serves (reference: the memkind
        info keys, ompi/info/info_memkind.*)."""
        return [{"name": "host", "kind": "system"}]

    def memkinds(self) -> list:
        """The MPI-4.1 ``mpi_memory_alloc_kinds`` strings this component
        contributes: its name as the kind and one ``name:region``
        restrictor per device row of :meth:`memkind_info` (nothing for
        this null component; ``cuda``, ``cuda:device`` for cuda)."""
        out = []
        for row in self.memkind_info():
            if row.get("kind") == "device":
                if self.NAME not in out:
                    out.append(self.NAME)
                out.append(f"{self.NAME}:{row['name']}")
        return out

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
        prof = _prof.PROFILER
        t0 = _prof.now() if prof is not None else 0
        np.copyto(host[:n].numpy(), src.detach().numpy())
        if prof is not None:
            prof.xfer("d2h", n, t0, _prof.now(), site="copy_async")
        return stream.CopyEvent(src.device, host, n)

    def to_device(self, host: torch.Tensor,
                  dst: torch.Tensor) -> stream.Event:
        """Copy ``host[:dst.numel()]`` into the uint8 tensor ``dst``."""
        prof = _prof.PROFILER
        t0 = _prof.now() if prof is not None else 0
        np.copyto(dst.detach().numpy(), host[:dst.numel()].numpy())
        if prof is not None:
            prof.xfer("h2d", dst.numel(), t0, _prof.now(), site="to_device")
        return stream.Event(dst.device)

    def begin_staging(self, device) -> None:
        """Order the staging streams after the work queued so far on
        ``device``'s current stream (nothing to order on the CPU)."""

    def d2h_stream(self, device):
        """The stream :meth:`copy_async` copies from ``device`` on, for
        timing events around a batch of copies (None on the CPU)."""
        return None

    # -- the ingest plane's upload pool (reference tpu.py:238-275) --------
    def h2d_streams(self, n: int, device=None) -> list:
        """``n`` upload streams of ``device``, created at first use and
        reused by every later call (the ingest ring's slot reuse relies on
        each stream's FIFO order across uploads). On the CPU there is no
        device queue: ``n`` Nones."""
        return [None] * n

    def close_h2d_streams(self) -> None:
        """Drop the upload pool."""

    def put_chunk(self, chunk: np.ndarray, dst: torch.Tensor,
                  h2d=None) -> stream.Event:
        """One put of the staged flat numpy view ``chunk`` into ``dst``
        (a 1-D tensor of its dtype and length) on the upload stream
        ``h2d``; the event completes when the staging memory may be
        packed again. On the CPU it is numpy's copy, done on return: a
        real copy, never an alias of the staging slot the ingest ring is
        about to repack (reference ``ingest/engine.py:104-111``)."""
        prof = _prof.PROFILER
        t0 = _prof.now() if prof is not None else 0
        np.copyto(dst.numpy(), chunk)
        if prof is not None:
            prof.xfer_chunk("h2d", chunk.nbytes, t0, _prof.now(),
                            chunk=next(_put_seq), site="put_chunk")
        return stream.Event(dst.device)

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
        from ompi_tpu_torch.accelerator import cuda  # noqa: F401 — registers
        from ompi_tpu_torch.runtime import device_plane

        framework.open_components()
        exc = framework.failures.get("cuda")
        if exc is not None and device_plane.platform() == "cuda":
            raise errors.MPIError(
                errors.ERR_INTERN,
                f"accelerator: the cuda component failed to open "
                f"({type(exc).__name__}: {exc}) on platform 'cuda' — pass "
                "--mca device_plane_platform cpu to run on the CPU") \
                from exc
        _current = framework.select_one()
    return _current


def reset_for_testing() -> None:
    global _current
    _current = None
    framework.close_components()


def for_device(device) -> Accelerator:
    """The component that stages tensors of ``device``: cuda for a CUDA
    device, null for the CPU."""
    return current() if torch.device(device).type == "cuda" else _host


def is_device_buffer(buf) -> bool:
    """The one predicate every device-dispatch layer shares."""
    return current().check_addr(buf)
