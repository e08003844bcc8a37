"""Device-tensor point-to-point: pipelined staging through pinned host
chunk buffers.

The port's counterpart of ``ompi_tpu.pml.accel_p2p`` (reference:
ompi/mca/pml/ob1/pml_ob1_accelerator.c:57-89 — ob1 moves device buffers
through host bounce buffers tracked by outstanding-copy events, so the
device-to-host copy of chunk k+1 overlaps the wire transfer of chunk k).
The wire protocol is the reference's: an int64 header with the element
count, then the payload in chunks of ``pml_accel_chunk_bytes`` (0 = one
chunk), each an ob1 message on the same (comm, peer, tag); both sides
derive the chunking from the cvar and the size, so the cvar must be
uniform across ranks (launcher-forwarded MCA values are).

Sender: the D2H copies run on the accelerator's ordered side stream
(ordered after the caller's current stream when the call is made) into a
ring of ``RING_DEPTH`` host buffers of one chunk each, pinned for a CUDA
tensor; each chunk goes to ob1 as its copy event fires, and its buffer
returns to the ring only when ob1's send of it has completed (an eager
send has copied it; RNDV and cma read it later). Receiver: each chunk's
irecv lands in a ring buffer, its H2D copy goes straight into the
receive tensor on the side stream, and the buffer is refilled only after
that copy's event has fired. At completion the caller's stream (the one
current at the call) waits on the last H2D event, so a kernel launched
after ``Recv`` sees the data. A message shorter than the template fills
the tensor's head and zeroes its tail (the Status counts the sender's
bytes); a longer one drains fully and then raises ``ERR_TRUNCATE``,
leaving the channel clean.

Every transfer is a progress-driven state machine (no helper threads),
queued on a per-(comm, peer, tag) FIFO, so two transfers on one channel
never interleave their frames. On the CPU platform, CPU tensors are the
device buffers and the copies complete before they return: the header,
chunk, ring and channel logic is the one the card runs.

A CUDA tensor must lie on the rank's device: on a rank whose device is
the CPU, or on another card, it raises ``MPIError(ERR_ARG)``; nothing is
staged through ``.cpu()``.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from ompi_tpu_torch import accelerator, errors
from ompi_tpu_torch.core import cvar, progress, pvar
from ompi_tpu_torch.datatype import BYTE
from ompi_tpu_torch.pml import request as rq

_chunk_var = cvar.register(
    "pml_accel_chunk_bytes", 4 << 20, int,
    help="Host chunk size of device-tensor point-to-point staging (the "
         "btl_accelerator pipeline analog): the D2H copy of chunk k+1 "
         "overlaps the send of chunk k. Must be uniform across ranks "
         "(chunk boundaries are derived, not negotiated); 0 = the whole "
         "message as one chunk.", level=6)

#: host chunk buffers per transfer (the ring each direction cycles)
RING_DEPTH = 4


def rank_device() -> torch.device:
    """The device this rank's tensors live on: the device plane's, else
    ``cuda:(local_rank % device_count)`` on the cuda platform with a
    usable GPU, else the CPU."""
    from ompi_tpu_torch.runtime import device_plane, rte

    if device_plane.active():
        return device_plane.device()
    if device_plane.platform() == "cpu" or not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", rte.local_rank % torch.cuda.device_count())


def check_tensor(t: torch.Tensor, what: str) -> None:
    """A CUDA tensor must lie on the rank's own device."""
    if t.device.type == "cpu":
        return
    want = rank_device()
    if t.device != want:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"{what}: tensor on {t.device}, but this rank's device is "
            f"{want} (a CUDA tensor is never staged through .cpu())")


def _chunk_bytes(itemsize: int) -> int:
    nbytes = _chunk_var.get()
    if nbytes <= 0:  # one chunk, whatever the size
        return 1 << 62
    return max(1, nbytes // itemsize) * itemsize


def _spans(nbytes: int, step: int) -> List[tuple]:
    return [(a, min(a + step, nbytes)) for a in range(0, nbytes, step)]


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous 1-D uint8 view of ``t`` (a copy when ``t`` is not
    contiguous)."""
    flat = t.reshape(-1).contiguous()
    if flat.numel() == 0:  # torch cannot re-view an empty tensor's dtype
        return flat.new_empty(0, dtype=torch.uint8)
    return flat.view(torch.uint8)


_channels: Dict[tuple, list] = {}


def _join(key, req) -> None:
    _channels.setdefault(key, []).append(req)


def _is_head(key, req) -> bool:
    q = _channels.get(key)
    return bool(q) and q[0] is req


def _leave(key, req) -> None:
    q = _channels.get(key)
    if q and req in q:
        q.remove(req)
    if not q:
        _channels.pop(key, None)


class _DevP2PRequest(rq.Request):
    """A transfer advanced by the progress engine. Construction only
    queues it on its channel (reference: ``_DevP2PChannel``,
    accel_p2p.py:48-77): one message occupies a (comm, peer, tag)
    matching channel at a time, until the sender has issued all its
    chunk sends / the receiver has posted all its chunk receives."""

    def __init__(self, comm, t: torch.Tensor, key) -> None:
        super().__init__()
        self.array = None
        self._comm = comm
        self._acc = accelerator.for_device(t.device)
        self._device = t.device
        self._stream = torch.cuda.current_stream(t.device) \
            if t.device.type == "cuda" else None
        self._key = key
        self._busy = False
        self._ring: List[torch.Tensor] = []
        self._nbufs = 0
        _join(key, self)
        progress.register(self._advance)

    def _take(self, nbytes: int):
        """A free ring buffer, or None while all RING_DEPTH are busy."""
        if self._ring:
            return self._ring.pop()
        if self._nbufs < RING_DEPTH:
            self._nbufs += 1
            return self._acc.host_buffer(nbytes, self._device)
        return None

    def _advance(self) -> int:
        # one state-machine step at a time: an ob1 send made from _step
        # can spin progress (a full transport) and re-enter here
        if self._busy:
            return 0
        self._busy = True
        try:
            return self._step()
        finally:
            self._busy = False

    def _step(self) -> int:
        raise NotImplementedError

    def _finish(self, error: int = 0) -> None:
        _leave(self._key, self)
        self._ring = []
        self.complete(error)
        raise StopIteration  # unregisters the progress callback


class _DevISend(_DevP2PRequest):
    """Nonblocking device send (reference ``_DevISend``,
    accel_p2p.py:136-190)."""

    def __init__(self, comm, buf: torch.Tensor, dest: int, tag: int) -> None:
        pvar.record("accel_p2p_send")
        self._dest, self._tag = dest, tag
        self._n = buf.numel()
        self._step_bytes = _chunk_bytes(buf.element_size())
        self._flat = _byte_view(buf)  # pins the source until shipped
        super().__init__(comm, buf, ("s", comm.cid, dest, tag))
        # the D2H copies read what the caller's stream wrote before now
        self._acc.begin_staging(buf.device)
        self._spans = None  # None: not started
        self._next = 0
        self._copies: deque = deque()   # (CopyEvent, host buffer)
        self._inflight: list = []       # (ob1 request, host buffer)
        self._issued = False

    def _start(self) -> None:
        from ompi_tpu_torch import pml

        self._inflight.append((pml.current().isend(
            self._comm, np.array([self._n], np.int64), 1, None,
            self._dest, self._tag), None))
        self._spans = _spans(self._flat.numel(), self._step_bytes)

    def _step(self) -> int:
        from ompi_tpu_torch import pml

        if self._spans is None:
            if not _is_head(self._key, self):
                return 0
            self._start()
        events = 0
        while self._next < len(self._spans):
            a, b = self._spans[self._next]
            host = self._take(self._spans[0][1])
            if host is None:
                break
            self._copies.append(
                (self._acc.copy_async(self._flat[a:b], host), host))
            self._next += 1
        while self._copies and self._copies[0][0].query():
            ev, host = self._copies.popleft()
            data = ev.wait()
            self._inflight.append((pml.current().isend(
                self._comm, data, data.size, BYTE, self._dest, self._tag),
                host))
            events += 1
        if not self._issued and self._next == len(self._spans) \
                and not self._copies:
            # every chunk handed to ob1 in order: the next transfer on
            # this channel may start
            self._issued = True
            _leave(self._key, self)
        still = []
        for req, host in self._inflight:
            if not req.completed:
                still.append((req, host))
            elif req.status.error:
                self._flat = None
                self._finish(req.status.error)
            elif host is not None:
                self._ring.append(host)  # ob1 is done with it
        self._inflight = still
        if self._issued and not self._inflight:
            self._flat = None
            self._finish()
        return events


class _DevIRecv(_DevP2PRequest):
    """Nonblocking device receive into ``buf`` in place (reference
    ``_DevIRecv``, accel_p2p.py:193-274, which assembles a new array)."""

    def __init__(self, comm, buf: torch.Tensor, source: int,
                 tag: int) -> None:
        pvar.record("accel_p2p_recv")
        self._buf = buf
        self._want_src, self._want_tag = source, tag
        self._cap = buf.numel() * buf.element_size()
        self._itemsize = buf.element_size()
        # a contiguous template receives in place; another one into a
        # contiguous temporary copied over at the end
        self._dst = _byte_view(buf) if buf.is_contiguous() \
            else torch.empty(self._cap, dtype=torch.uint8,
                             device=buf.device)
        super().__init__(comm, buf, ("r", comm.cid, source, tag))
        # the H2D copies land after the caller's earlier work on buf
        self._acc.begin_staging(buf.device)
        self._hdr = np.zeros(1, np.int64)
        self._hdr_req = None
        self._spans = None  # None: header not in yet
        self._next = 0
        self._posted: deque = deque()   # (ob1 request, host, a, b)
        self._h2d: deque = deque()      # (Event, host)
        self._last = None
        self._truncated = False

    def _step(self) -> int:
        from ompi_tpu_torch import pml

        if self._hdr_req is None:
            if not _is_head(self._key, self):
                return 0
            self._hdr_req = pml.current().irecv(
                self._comm, self._hdr, 1, None, self._want_src,
                self._want_tag)
        if self._spans is None:
            if not self._hdr_req.completed:
                return 0
            st = self._hdr_req.status
            if st.error:
                self._finish(st.error)
            nbytes = int(self._hdr[0]) * self._itemsize
            self._truncated = nbytes > self._cap
            self.status.source, self.status.tag = st.source, st.tag
            self.status.count = nbytes
            self._spans = _spans(nbytes, _chunk_bytes(self._itemsize))
        events = 0
        while self._h2d and self._h2d[0][0].query():
            self._ring.append(self._h2d.popleft()[1])  # H2D landed
        while self._next < len(self._spans):
            a, b = self._spans[self._next]
            host = self._take(self._spans[0][1])
            if host is None:
                break
            self._posted.append((pml.current().irecv(
                self._comm, host[:b - a].numpy(), b - a, BYTE,
                self.status.source, self.status.tag), host, a, b))
            self._next += 1
        if self._next == len(self._spans):
            _leave(self._key, self)  # every chunk receive posted in order
        while self._posted and self._posted[0][0].completed:
            req, host, a, b = self._posted.popleft()
            if req.status.error:
                self._finish(req.status.error)
            if self._truncated:
                self._ring.append(host)  # drained, dropped
            else:
                self._last = self._acc.to_device(host, self._dst[a:b])
                self._h2d.append((self._last, host))
            events += 1
        if self._next == len(self._spans) and not self._posted:
            self._complete_recv()
        return events

    def _complete_recv(self) -> None:
        if self._truncated:
            self._finish(errors.ERR_TRUNCATE)
        stream = self._stream
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            if self._last is not None and stream is not None:
                self._last.wait_on(stream)
            if self.status.count < self._cap:  # a short message
                self._dst[self.status.count:].zero_()
            if not self._buf.is_contiguous():
                self._buf.copy_(self._dst.view(self._buf.dtype)
                                .view(self._buf.shape))
        self.array = self._buf
        self._finish()


def isend_dev(comm, buf: torch.Tensor, dest: int, tag: int) -> rq.Request:
    check_tensor(buf, "Isend")
    if dest == rq.PROC_NULL:
        return rq.CompletedRequest()
    return _DevISend(comm, buf, dest, tag)


def irecv_dev(comm, buf: torch.Tensor, source: int,
              tag: int) -> rq.Request:
    check_tensor(buf, "Irecv")
    if source == rq.PROC_NULL:
        req = rq.CompletedRequest()
        req.status.source, req.status.tag = rq.PROC_NULL, rq.ANY_TAG
        req.array = buf
        return req
    return _DevIRecv(comm, buf, source, tag)


def send_dev(comm, buf: torch.Tensor, dest: int, tag: int) -> None:
    """Blocking device send: :func:`isend_dev`, waited."""
    isend_dev(comm, buf, dest, tag).wait()


def recv_dev(comm, buf: torch.Tensor, source: int, tag: int):
    """Blocking device receive into ``buf``; returns (buf, Status)."""
    req = irecv_dev(comm, buf, source, tag)
    st = req.wait()
    return buf, st
