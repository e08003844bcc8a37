"""btl/sm — shared-memory transport: SPSC byte rings per directed pair.

The port's copy of ``ompi_tpu.btl.sm`` (reference: opal/mca/btl/sm,
per-peer FIFOs and fast boxes over a shared segment, btl_sm_fbox.h:26-61).
One single-producer single-consumer byte ring per directed pair in
shared memory, head and tail as aligned u64s (the writer owns head, the
reader owns tail), frames as a 4-byte length and the payload with
wraparound. Every rank creates its outbound rings at open and attaches
its inbound ones after a fence. The ring files are named with the
launcher's job-scoped prefix (``ompi_tpu_torch_<jobid>_sm_<src>to<dst>``
under ``launcher.shm_dir()``), so the launcher's cleanup removes what a
crashed rank leaves.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
from typing import Dict, Optional

import numpy as np

from ompi_tpu_torch.btl import base
from ompi_tpu_torch.core import cvar, native, pvar
from ompi_tpu_torch.runtime import launcher, rte

_LEN = struct.Struct("<I")
_HDR_BYTES = 16  # head u64, tail u64


class _Ring:
    """One SPSC ring over an mmap'd file. Publish and consume go through
    the C ring (``btl/csrc/sm_ring.c``, acquire/release atomics) when it
    builds; the Python path's plain u64 stores are correct only under
    x86-TSO and the GIL's ordering."""

    def __init__(self, path: str, size: int, create: bool) -> None:
        self.path = path
        self.size = size
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, _HDR_BYTES + size)
            self.mm = mmap.mmap(fd, _HDR_BYTES + size)
        finally:
            os.close(fd)
        self.ptr = np.frombuffer(self.mm, dtype=np.uint64, count=2)
        self.data = memoryview(self.mm)[_HDR_BYTES:]
        self._L = native.lib()
        if self._L is not None:
            # the exporting object pins the mmap's buffer export; it is
            # dropped in close() before mm.close()
            self._cbuf = ctypes.c_char.from_buffer(self.mm)
            self._addr = ctypes.addressof(self._cbuf)
            self._popbuf = ctypes.create_string_buffer(min(size, 1 << 16))

    @property
    def head(self) -> int:
        return int(self.ptr[0])

    @head.setter
    def head(self, v: int) -> None:
        self.ptr[0] = v

    @property
    def tail(self) -> int:
        return int(self.ptr[1])

    @tail.setter
    def tail(self, v: int) -> None:
        self.ptr[1] = v

    def _write_at(self, pos: int, data) -> None:
        off = pos % self.size
        n = len(data)
        if off + n <= self.size:
            self.data[off:off + n] = data
        else:
            first = self.size - off
            self.data[off:] = data[:first]
            self.data[:n - first] = data[first:]

    def _read_at(self, pos: int, n: int) -> bytes:
        off = pos % self.size
        if off + n <= self.size:
            return bytes(self.data[off:off + n])
        first = self.size - off
        return bytes(self.data[off:]) + bytes(self.data[:n - first])

    def push(self, frame: bytes) -> bool:
        if self._L is not None:
            return bool(self._L.otr_ring_push(
                self._addr, self.size, frame, len(frame)))
        need = 4 + len(frame)
        if self.size - (self.head - self.tail) < need:
            return False
        h = self.head
        self._write_at(h, _LEN.pack(len(frame)))
        self._write_at(h + 4, frame)
        self.head = h + need  # publish after the payload is in place
        return True

    def pop(self) -> Optional[bytes]:
        if self._L is not None:
            n = self._L.otr_ring_pop(self._addr, self.size, self._popbuf,
                                     len(self._popbuf))
            if n == -2:  # frame larger than the scratch: grow, retry
                self._popbuf = ctypes.create_string_buffer(
                    min(self.size, 2 * len(self._popbuf)))
                return self.pop()
            if n < 0:
                return None
            return self._popbuf.raw[:n]
        t = self.tail
        if self.head == t:
            return None
        (n,) = _LEN.unpack(self._read_at(t, 4))
        frame = self._read_at(t + 4, n)
        self.tail = t + 4 + n
        return frame

    def close(self, unlink: bool) -> None:
        self.data = None
        self.ptr = None
        if self._L is not None:
            self._cbuf = None  # release the buffer export first
            self._addr = None
        self.mm.close()
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class SmBtl(base.Btl):
    NAME = "sm"
    PRIORITY = 50  # above tcp for same-host peers
    EAGER_LIMIT_DEFAULT = 4096       # reference: btl_sm_component.c:207
    MAX_SEND_DEFAULT = 32768         # reference rndv eager/frag sizing

    def __init__(self) -> None:
        super().__init__()
        self.ring_size = cvar.register(
            "btl_sm_ring_size", 1 << 20, int,
            help="Bytes per directed SPSC ring").get()
        self._out: Dict[int, _Ring] = {}
        self._in: Dict[int, _Ring] = {}

    def open(self) -> bool:
        rte.init()
        if rte.size == 1:
            return False  # btl/self covers a one-rank job
        rte.modex_send("btl_sm_host", rte.hostname())
        self._dir = launcher.shm_dir()
        if not os.path.isdir(self._dir):
            return False
        # every outbound ring now, inbound after a fence (the reference
        # maps peer segments during add_procs; setting up eagerly leaves
        # no attach-vs-unlink race at teardown)
        same_host = [p for p in rte.world_ranks() if p != rte.rank
                     and rte.modex_recv("btl_sm_host", p)
                     == rte.hostname()]
        for p in same_host:
            self._out[p] = _Ring(self._path(rte.rank, p), self.ring_size,
                                 create=True)
        rte.fence("btl_sm_setup")
        for p in same_host:
            self._in[p] = _Ring(self._path(p, rte.rank), self.ring_size,
                                create=False)
        return True

    def _path(self, src: int, dst: int) -> str:
        return os.path.join(
            self._dir, f"{launcher.SHM_PREFIX}{rte.jobid}_sm_{src}to{dst}")

    def reachable(self, peer: int) -> bool:
        return peer in self._out

    def send(self, dst: int, data: bytes) -> None:
        ring = self._out[dst]
        if 4 + len(data) > self.ring_size:
            raise ValueError(
                f"sm frame of {len(data)} bytes exceeds ring size "
                f"{self.ring_size}; lower btl_sm_max_send_size")
        while not ring.push(data):
            # ring full: drain our own inbound so the peer (possibly
            # blocked sending to us) can in turn drain this ring
            self.progress()
        pvar.record("bytes_sent", len(data))

    def progress(self) -> int:
        events = 0
        for ring in list(self._in.values()):
            while True:
                frame = ring.pop()
                if frame is None:
                    break
                pvar.record("bytes_received", len(frame))
                base.deliver(frame)
                events += 1
        return events

    def finalize(self) -> None:
        for ring in self._out.values():
            ring.close(unlink=True)
        for ring in self._in.values():
            ring.close(unlink=False)
        self._out.clear()
        self._in.clear()
