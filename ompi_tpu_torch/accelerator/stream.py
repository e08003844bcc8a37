"""Events — completion markers in a device's work queue.

The port's counterpart of ``ompi_tpu.accelerator.stream`` (reference:
opal/mca/accelerator/accelerator.h:668-711, create_event / record_event /
query_event / sync_event, which the CUDA component maps onto CUevent).
The JAX package needs a host-side executor because PJRT exposes
readiness per buffer; the port does not: an :class:`Event` is a
``torch.cuda.Event`` recorded on a stream of the device (its current
stream unless told otherwise), and on the CPU, whose torch ops finish
before they return, it is complete at once. :class:`CopyEvent` marks an
asynchronous copy into a host buffer (the accelerator's ``copy_async``).
"""

from __future__ import annotations

import torch


class Event:
    """A point in ``device``'s queue: complete once the work queued on
    the recorded stream before :meth:`record` has run."""

    def __init__(self, device=None) -> None:
        self.device = torch.device(device if device is not None else "cpu")
        self._ev = torch.cuda.Event() if self.device.type == "cuda" \
            else None

    def record(self, stream=None) -> "Event":
        """record_event on ``stream`` (default: the device's current
        stream)."""
        if self._ev is not None:
            self._ev.record(stream if stream is not None
                            else torch.cuda.current_stream(self.device))
        return self

    def query(self) -> bool:
        """Nonblocking readiness probe (query_event), asked anew on every
        call."""
        return self._ev is None or self._ev.query()

    def wait(self) -> None:
        """Block until the recorded work completes (sync_event)."""
        if self._ev is not None:
            self._ev.synchronize()

    def wait_on(self, stream) -> None:
        """Make ``stream`` wait for this event on the device (a no-op on
        the CPU)."""
        if self._ev is not None:
            stream.wait_event(self._ev)


class CopyEvent(Event):
    """An asynchronous copy of ``nbytes`` into the host buffer ``host``
    (a uint8 tensor, pinned for a CUDA source): :meth:`wait` blocks until
    the copy has landed and returns the numpy view of its bytes."""

    def __init__(self, device, host: torch.Tensor, nbytes: int) -> None:
        super().__init__(device)
        self.host = host
        self.nbytes = nbytes

    def wait(self):
        super().wait()
        return self.host[:self.nbytes].numpy()
