"""Accelerator framework — device buffer integration.

Reference: opal/mca/accelerator/ (accelerator.h:668-711: check_addr,
device info, synchronize, ...) and ``ompi_tpu.accelerator``. In the port
a device buffer is a ``torch.Tensor`` and a host buffer is numpy — the
split the JAX package draws between ``jax.Array`` and numpy. The port
carries what it uses: the buffer predicate, device info and
synchronisation, from the ``cuda`` component when a GPU is usable and the
``null`` component otherwise, and the event its device requests record
(:mod:`.stream`).
"""

from __future__ import annotations

from typing import Optional

import torch


class Accelerator:
    """The module interface, reduced to this slice's entries."""

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


_current: Optional[Accelerator] = None


def current() -> Accelerator:
    """The selected component (cuda when torch sees a GPU, else null)."""
    global _current
    if _current is None:
        if torch.cuda.is_available():
            from ompi_tpu_torch.accelerator.cuda import CudaAccelerator

            _current = CudaAccelerator()
        else:
            _current = Accelerator()
    return _current


def is_device_buffer(buf) -> bool:
    """The one predicate every device-dispatch layer shares."""
    return current().check_addr(buf)
