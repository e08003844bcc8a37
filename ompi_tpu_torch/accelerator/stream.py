"""Events — completion markers in a device's work queue.

The port's counterpart of ``ompi_tpu.accelerator.stream`` (reference:
opal/mca/accelerator/accelerator.h:668-711, create_event / record_event /
query_event / sync_event, which the CUDA component maps onto CUevent).
The JAX package needs a host-side executor because PJRT exposes
readiness per buffer; the port does not: an :class:`Event` is a
``torch.cuda.Event`` recorded on the device's current stream, and on the
CPU, whose torch ops finish before they return, it is complete at once.
The reference's ``Stream`` executor has no caller in the port.
"""

from __future__ import annotations

import torch


class Event:
    """A point in ``device``'s queue: complete once the work queued on
    its current stream before :meth:`record` has run."""

    def __init__(self, device=None) -> None:
        self.device = torch.device(device if device is not None else "cpu")
        self._ev = torch.cuda.Event() if self.device.type == "cuda" \
            else None

    def record(self) -> "Event":
        """record_event on the device's current stream."""
        if self._ev is not None:
            self._ev.record(torch.cuda.current_stream(self.device))
        return self

    def query(self) -> bool:
        """Nonblocking readiness probe (query_event), asked anew on every
        call."""
        return self._ev is None or self._ev.query()

    def wait(self) -> None:
        """Block until the recorded work completes (sync_event)."""
        if self._ev is not None:
            self._ev.synchronize()
