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

The ingest plane's upload pool (``tpu.py:238-275``): :meth:`h2d_streams`
keeps ``n`` side streams per device for the process, and
:meth:`put_chunk` copies a pinned staging view into its slice of the
upload's device buffer on one of them (``copy_(non_blocking=True)``),
then records an event there; the consumer waits on the event
(``ingest/engine.py``).

With the prof ledger on (and only then) each copy (``to_device``,
``copy_async``, ``put_chunk``, ``ipc_import``; reference
``tpu.py:110-225``, ``:377-384``) synchronises its stream before the
closing timestamp, so the ``xfer`` span and the
bandwidth it reports are the copy's, as the reference calls
``block_until_ready`` (``tpu.py:179-199``); with it off a copy stays
asynchronous and the site pays one attribute load and one branch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.accelerator import (Accelerator, _put_seq, framework,
                                        ipc, stream)
from ompi_tpu_torch.prof import ledger as _prof


@framework.register
class CudaAccelerator(Accelerator):
    NAME = "cuda"
    PRIORITY = 50  # above null when usable

    def open(self) -> bool:
        """Usable when torch sees a GPU. Without one it is unavailable,
        unless the device plane is requested on the ``cuda`` platform:
        then it fails to open, with the cause."""
        from ompi_tpu_torch.runtime import device_plane

        if not torch.cuda.is_available():
            if device_plane.requested() and device_plane.platform() == "cuda":
                raise RuntimeError("torch.cuda.is_available() is false (no "
                                   "usable CUDA device)")
            return False
        torch.cuda.init()
        return True

    def __init__(self) -> None:
        # device index -> (d2h stream, h2d stream)
        self._streams: Dict[int, Tuple[torch.cuda.Stream,
                                       torch.cuda.Stream]] = {}
        # device index -> the ingest plane's upload streams
        self._h2d_pool: Dict[int, list] = {}

    def num_devices(self) -> int:
        return torch.cuda.device_count()

    def device_info(self) -> dict:
        return {"name": torch.cuda.get_device_name(
                    torch.cuda.current_device()),
                "count": torch.cuda.device_count()}

    def synchronize(self) -> None:
        torch.cuda.synchronize()

    def memkind_info(self) -> list:
        """Device memory (``cuda:device``, the MPI-4.1 side document's
        restrictor) beside host memory."""
        return [{"name": "device", "kind": "device"},
                {"name": "host", "kind": "system"}]

    def _side(self, device) -> Tuple[torch.cuda.Stream, torch.cuda.Stream]:
        idx = torch.device(device).index
        idx = torch.cuda.current_device() if idx is None else idx
        got = self._streams.get(idx)
        if got is None:
            got = self._streams[idx] = (torch.cuda.Stream(device=idx),
                                        torch.cuda.Stream(device=idx))
        return got

    def d2h_stream(self, device):
        if torch.device(device).type != "cuda":
            return None
        return self._side(device)[0]

    def begin_staging(self, device) -> None:
        if torch.device(device).type != "cuda":
            return
        cur = torch.cuda.current_stream(device)
        for s in self._side(device):
            s.wait_stream(cur)

    def h2d_streams(self, n: int, device=None) -> list:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        if dev.type != "cuda":
            return super().h2d_streams(n, dev)
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        pool = self._h2d_pool.setdefault(idx, [])
        while len(pool) < n:
            pool.append(torch.cuda.Stream(device=idx))
        return pool[:n]

    def close_h2d_streams(self) -> None:
        for pool in self._h2d_pool.values():
            for s in pool:
                s.synchronize()
        self._h2d_pool = {}

    def put_chunk(self, chunk, dst: torch.Tensor,
                  h2d=None) -> stream.Event:
        if dst.device.type != "cuda":
            return super().put_chunk(chunk, dst, h2d)
        s = h2d if h2d is not None else torch.cuda.current_stream(dst.device)
        prof = _prof.PROFILER
        t0 = _prof.now() if prof is not None else 0
        with torch.cuda.device(dst.device), torch.cuda.stream(s):
            # the source is a view of a pinned staging slot: an async DMA
            dst.copy_(torch.from_numpy(chunk), non_blocking=True)
        ev = stream.Event(dst.device).record(s)
        if prof is not None:
            ev.wait()
            prof.xfer_chunk("h2d", chunk.nbytes, t0, _prof.now(),
                            chunk=next(_put_seq), site="put_chunk")
        return ev

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
        prof = _prof.PROFILER
        t0 = _prof.now() if prof is not None else 0
        with torch.cuda.stream(d2h):
            host[:n].copy_(src, non_blocking=True)
        # the caching allocator must not hand src's memory out again
        # before the side stream has read it
        src.record_stream(d2h)
        ev = stream.CopyEvent(src.device, host, n).record(d2h)
        if prof is not None:
            d2h.synchronize()
            prof.xfer("d2h", n, t0, _prof.now(), site="copy_async",
                      stream="d2h")
        return ev

    def to_device(self, host: torch.Tensor,
                  dst: torch.Tensor) -> stream.Event:
        if dst.device.type != "cuda":
            return super().to_device(host, dst)
        _, h2d = self._side(dst.device)
        prof = _prof.PROFILER
        t0 = _prof.now() if prof is not None else 0
        with torch.cuda.stream(h2d):
            dst.copy_(host[:dst.numel()], non_blocking=True)
        dst.record_stream(h2d)
        ev = stream.Event(dst.device).record(h2d)
        if prof is not None:
            h2d.synchronize()
            prof.xfer("h2d", dst.numel(), t0, _prof.now(),
                      site="to_device", stream="h2d")
        return ev

    def ipc_import(self, handle, device=None):
        """An exported tensor lands on ``device`` (this process's current
        card by default) with one host-to-device copy, the reference's
        staging (``accelerator/ipc.py:1-12``); a CPU ``device`` or an
        exported array is the null component's import."""
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        if not handle.tensor or dev.type != "cuda":
            return super().ipc_import(handle)
        prof = _prof.PROFILER
        t0 = _prof.now() if prof is not None else 0
        out = ipc.import_tensor(handle, dev)
        if prof is not None:
            torch.cuda.synchronize(dev)
            prof.xfer("h2d", out.numel() * out.element_size(), t0,
                      _prof.now(), site="ipc_import")
        return out
