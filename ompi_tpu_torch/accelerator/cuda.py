"""The CUDA accelerator component (the counterpart of the JAX package's
``accelerator/tpu.py``): device info, synchronisation, the staging
copies of device-tensor point-to-point (``tpu.py:162-230``), and the IPC
import of an exported tensor onto the card (``tpu.py:367-385``; the
export is the base component's: one device-to-host copy into the file).

Staging runs on two side streams per device, created at first use and
kept for the process: one ordered stream for device-to-host copies and
one for host-to-device copies, each ordered after the caller's current
stream by :meth:`CudaAccelerator.begin_staging`. Host buffers are pinned
(``pin_memory=True``); a pinned allocation that fails raises, and no
copy falls back to pageable memory or to a synchronous copy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.accelerator import Accelerator, ipc, stream


class CudaAccelerator(Accelerator):
    NAME = "cuda"

    def __init__(self) -> None:
        # device index -> (d2h stream, h2d stream)
        self._streams: Dict[int, Tuple[torch.cuda.Stream,
                                       torch.cuda.Stream]] = {}

    def num_devices(self) -> int:
        return torch.cuda.device_count()

    def device_info(self) -> dict:
        return {"name": torch.cuda.get_device_name(
                    torch.cuda.current_device()),
                "count": torch.cuda.device_count()}

    def synchronize(self) -> None:
        torch.cuda.synchronize()

    def _side(self, device) -> Tuple[torch.cuda.Stream, torch.cuda.Stream]:
        idx = torch.device(device).index
        idx = torch.cuda.current_device() if idx is None else idx
        got = self._streams.get(idx)
        if got is None:
            got = self._streams[idx] = (torch.cuda.Stream(device=idx),
                                        torch.cuda.Stream(device=idx))
        return got

    def begin_staging(self, device) -> None:
        if torch.device(device).type != "cuda":
            return
        cur = torch.cuda.current_stream(device)
        for s in self._side(device):
            s.wait_stream(cur)

    def host_buffer(self, nbytes: int, device) -> torch.Tensor:
        if torch.device(device).type != "cuda":
            return super().host_buffer(nbytes, device)
        try:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        except RuntimeError as exc:
            raise errors.MPIError(
                errors.ERR_INTERN,
                f"pinned host allocation of {nbytes} bytes failed: "
                f"{exc}") from exc

    def copy_async(self, src: torch.Tensor,
                   host: torch.Tensor) -> stream.CopyEvent:
        if src.device.type != "cuda":
            return super().copy_async(src, host)
        d2h, _ = self._side(src.device)
        n = src.numel()
        with torch.cuda.stream(d2h):
            host[:n].copy_(src, non_blocking=True)
        # the caching allocator must not hand src's memory out again
        # before the side stream has read it
        src.record_stream(d2h)
        return stream.CopyEvent(src.device, host, n).record(d2h)

    def to_device(self, host: torch.Tensor,
                  dst: torch.Tensor) -> stream.Event:
        if dst.device.type != "cuda":
            return super().to_device(host, dst)
        _, h2d = self._side(dst.device)
        with torch.cuda.stream(h2d):
            dst.copy_(host[:dst.numel()], non_blocking=True)
        dst.record_stream(h2d)
        return stream.Event(dst.device).record(h2d)

    def ipc_import(self, handle, device=None):
        """An exported tensor lands on ``device`` (this process's current
        card by default) with one host-to-device copy, the reference's
        staging (``accelerator/ipc.py:1-12``); a CPU ``device`` or an
        exported array is the null component's import."""
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        if not handle.tensor or dev.type != "cuda":
            return super().ipc_import(handle)
        return ipc.import_tensor(handle, dev)
