"""btl/tcp — sockets transport.

The port's copy of ``ompi_tpu.btl.tcp`` (reference: opal/mca/btl/tcp,
listen socket published through the modex, btl_tcp_component.c:1191-1240,
lazy connection setup, event-driven nonblocking IO). One unidirectional
connection per directed pair (the sender connects), which sidesteps the
simultaneous-connect problem and keeps per-direction order; the progress
engine polls with ``selectors``. Every rank publishes all of its IPv4
addresses (:mod:`ompi_tpu_torch.util.net`) and a sender dials the peer's
best-scored one: loopback between ranks of one host. Each connection
made emits the MPI_T event ``btl_endpoint_connected`` (reference
btl/tcp.py:91-96).
"""

from __future__ import annotations

import errno
import os
import selectors
import socket
import struct
from collections import deque
from typing import Dict, Optional

from ompi_tpu_torch.btl import base
from ompi_tpu_torch.core import events as mpit_events, output, pvar
from ompi_tpu_torch.runtime import rte
from ompi_tpu_torch.util import net

_LEN = struct.Struct("<I")
_out = output.stream("btl_tcp")


@base.framework.register
class TcpBtl(base.Btl):
    NAME = "tcp"
    PRIORITY = 10  # below sm: the catch-all
    EAGER_LIMIT_DEFAULT = 65536  # reference: btl_tcp_component.c:317

    def __init__(self) -> None:
        super().__init__()
        self._listen: Optional[socket.socket] = None
        self._sel = selectors.DefaultSelector()
        self._send_socks: Dict[int, socket.socket] = {}
        self._send_q: Dict[int, deque] = {}
        self._recv_bufs: Dict[socket.socket, bytearray] = {}
        self._addrs = []

    def open(self) -> bool:
        bind = os.environ.get("OMPI_TPU_BIND_ADDR")
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((bind or "0.0.0.0", 0))
        self._listen.listen(128)
        self._listen.setblocking(False)
        self._sel.register(self._listen, selectors.EVENT_READ, "accept")
        self._addrs = [bind] if bind else \
            [i.address for i in net.interfaces()]
        rte.init()
        rte.modex_send("btl_tcp", (self._addrs,
                                   self._listen.getsockname()[1]))
        return True

    def reachable(self, peer: int) -> bool:
        return peer != rte.rank

    # -- sending ----------------------------------------------------------
    def _connect(self, dst: int) -> socket.socket:
        addrs, port = rte.modex_recv("btl_tcp", dst)
        host = net.pick_peer_address(list(addrs), self._addrs)
        s = socket.create_connection((host, port), timeout=60)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        self._send_socks[dst] = s
        self._send_q[dst] = deque()
        _out.verbose(5, "connected to rank %d at %s:%d", dst, host, port)
        if mpit_events.active("btl_endpoint_connected"):
            mpit_events.emit("btl_endpoint_connected", btl="tcp",
                             peer=dst, addr=str((host, port)))
        return s

    def send(self, dst: int, data: bytes) -> None:
        if dst not in self._send_socks:
            self._connect(dst)
        self._send_q[dst].append(memoryview(_LEN.pack(len(data)) + data))
        pvar.record("bytes_sent", len(data))
        self._flush(dst)

    def _flush(self, dst: int) -> int:
        """Drain as much of dst's queue as the socket accepts."""
        s = self._send_socks[dst]
        q = self._send_q[dst]
        sent = 0
        while q:
            chunk = q[0]
            try:
                n = s.send(chunk)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as exc:
                if exc.errno == errno.EAGAIN:
                    break
                raise
            if n == len(chunk):
                q.popleft()
                sent += 1
            else:
                q[0] = chunk[n:]
        return sent

    # -- receiving --------------------------------------------------------
    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._listen.accept()
            except (BlockingIOError, InterruptedError):
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # no handshake: the PML's frame headers name the sender
            conn.setblocking(False)
            self._recv_bufs[conn] = bytearray()
            self._sel.register(conn, selectors.EVENT_READ, "stream")

    def _read(self, conn: socket.socket) -> int:
        buf = self._recv_bufs[conn]
        events = 0
        try:
            while True:
                chunk = conn.recv(1 << 16)
                if not chunk:  # the peer closed its send side
                    self._sel.unregister(conn)
                    conn.close()
                    del self._recv_bufs[conn]
                    break
                buf.extend(chunk)
        except (BlockingIOError, InterruptedError):
            pass
        while len(buf) >= 4:
            (n,) = _LEN.unpack_from(buf, 0)
            if len(buf) < 4 + n:
                break
            frame = bytes(buf[4:4 + n])
            del buf[:4 + n]
            pvar.record("bytes_received", n)
            base.deliver(frame)
            events += 1
        return events

    def progress(self) -> int:
        events = 0
        for dst, q in self._send_q.items():
            if q:
                events += self._flush(dst)
        for key, _ in self._sel.select(timeout=0):
            if key.data == "accept":
                self._accept()
            elif key.fileobj in self._recv_bufs:
                events += self._read(key.fileobj)
        return events

    def finalize(self) -> None:
        for s in self._send_socks.values():
            s.close()
        for conn in list(self._recv_bufs):
            self._sel.unregister(conn)
            conn.close()
        self._recv_bufs.clear()
        if self._listen is not None:
            self._sel.unregister(self._listen)
            self._listen.close()
        self._sel.close()
