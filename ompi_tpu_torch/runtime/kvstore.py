"""Rendezvous TCP key-value store — the PMIx server equivalent.

Reference role: OpenPMIx server inside prterun/prted daemons. Supplies the
modex (endpoint exchange), fences (PMIx_Fence) and ID allocation. The
port's own copy, without abort and the fault-tolerance commands (they
come with the slices that use them).

Protocol: length-prefixed pickled tuples, thread-per-connection (the store
is control plane only — no payload flows through it). SECURITY: pickle
framing means the store trusts its peers; it binds loopback.
Commands:
  ("put", key, value)            -> ("ok",)
  ("get", key, wait: bool)       -> ("val", value) | ("none",)
  ("fence", tag, nprocs, rank)   -> blocks until nprocs distinct ranks
                                    arrive -> ("ok",)
  ("inc", key, amount)           -> ("val", new_value)   # atomic counter
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

_LEN = struct.Struct("!I")


def send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(hdr)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("store connection closed")
        buf.extend(chunk)
    return bytes(buf)


class Store:
    """The in-process server. Run via start(); address via .addr."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._data: Dict[str, Any] = {}
        self._fences: Dict[str, list] = {}  # tag -> [arrived, released]
        self._counters: Dict[str, int] = {}
        self._cond = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.addr: Tuple[str, int] = self._sock.getsockname()
        self._stop = False

    def start(self) -> "Store":
        threading.Thread(target=self._accept_loop,
                         name="ompi-tpu-torch-store", daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                send_msg(conn, self._handle(recv_msg(conn)))
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: Tuple) -> Tuple:
        op = msg[0]
        if op == "put":
            _, key, value = msg
            with self._cond:
                self._data[key] = value
                self._cond.notify_all()
            return ("ok",)
        if op == "get":
            _, key, wait = msg
            with self._cond:
                while wait and key not in self._data:
                    self._cond.wait(timeout=1.0)
                if key in self._data:
                    return ("val", self._data[key])
                return ("none",)
        if op == "fence":
            # tags must be unique per epoch (the rte client appends an
            # epoch counter, mirroring PMIx fence instance uniqueness)
            _, tag, nprocs, rank = msg
            with self._cond:
                entry = self._fences.setdefault(tag, [set(), 0])
                entry[0].add(rank)
                self._cond.notify_all()
                while len(entry[0]) < nprocs:
                    self._cond.wait(timeout=1.0)
                entry[1] += 1
                if entry[1] >= nprocs:
                    self._fences.pop(tag, None)  # last releaser reclaims
                return ("ok",)
        if op == "inc":
            _, key, amount = msg
            with self._cond:
                self._counters[key] = self._counters.get(key, 0) + amount
                return ("val", self._counters[key])
        return ("err", f"unknown op {op!r}")


class Client:
    """Client handle to a Store (used by ompi_tpu_torch.runtime.rte).
    The initial connect retries with exponential backoff (a rank may race
    the store's startup); exhaustion raises ``MPIError(ERR_INTERN)``."""

    def __init__(self, addr: Tuple[str, int], attempts: int = 5,
                 backoff: float = 0.05) -> None:
        self.addr = addr
        delay = backoff
        for i in range(attempts):
            try:
                self._sock = socket.create_connection(addr, timeout=60)
                break
            except OSError as exc:
                if i + 1 >= attempts:
                    from ompi_tpu_torch import errors

                    raise errors.MPIError(
                        errors.ERR_INTERN,
                        f"kvstore: store {addr[0]}:{addr[1]} unreachable "
                        f"after {attempts} connect attempts: {exc}"
                    ) from exc
                time.sleep(delay)
                delay *= 2
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def _rpc(self, *msg: Any, timeout: Optional[float] = None) -> Tuple:
        with self._lock:
            send_msg(self._sock, msg)
            self._sock.settimeout(timeout)
            try:
                reply = recv_msg(self._sock)
            finally:
                self._sock.settimeout(None)
        if reply[0] == "err":
            raise RuntimeError(reply[1])
        return reply

    def put(self, key: str, value: Any) -> None:
        self._rpc("put", key, value)

    def get(self, key: str, wait: bool = True) -> Any:
        reply = self._rpc("get", key, wait)
        return reply[1] if reply[0] == "val" else None

    def fence(self, tag: str, nprocs: int, rank: int,
              timeout: Optional[float] = None) -> None:
        """Blocks until nprocs distinct ranks arrive; a timeout raises
        socket.timeout (shutdown paths that must not hang)."""
        self._rpc("fence", tag, nprocs, rank, timeout=timeout)

    def inc(self, key: str, amount: int = 1) -> int:
        """Atomic store-side counter: returns the value after adding."""
        return self._rpc("inc", key, amount)[1]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
