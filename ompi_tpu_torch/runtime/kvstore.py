"""Rendezvous TCP key-value store — the PMIx server equivalent.

Reference role: OpenPMIx server inside prterun/prted daemons. Supplies the
modex (endpoint exchange), fences (PMIx_Fence), ID allocation, abort
propagation and the fault-tolerance commands of the ULFM plane. The
port's own copy of ``ompi_tpu.runtime.kvstore``.

Protocol: length-prefixed pickled tuples, thread-per-connection (the store
is control plane only — no payload flows through it). SECURITY: pickle
framing means the store trusts its peers; it binds loopback.
Commands:
  ("put", key, value)            -> ("ok",)
  ("get", key, wait: bool)       -> ("val", value) | ("none",)
  ("fence", tag, nprocs, rank, base)
      -> blocks until nprocs distinct ranks arrive -> ("ok",); base is the
      first world rank of the fencing world, and a dead rank of
      [base, base+nprocs) that never arrived releases the fence, which
      then answers ("okdead", {rank: reason})
  ("inc", key, amount)           -> ("val", new_value)   # atomic counter
  ("abort", rank, reason, code)  -> ("ok",)  # marks the job aborted
  ("aborted?",)                  -> ("val", (reason, code) | None)

Fault tolerance (the PRRTE-daemon side of ULFM: the store is the daemon):
  ("hb", rank[, payload])        -> ("ok",)   # heartbeat timestamp; the
      optional payload (the telemetry plane's latest collective seq) is
      kept per rank and read back with ("telem?",)
  ("telem?",)                    -> ("val", {rank: payload})
  ("dead", rank, reason)         -> ("ok",)   # declare a rank failed
  ("faults?", hb_timeout|None)   -> ("val", {rank: reason})
  ("ftgather", tag, rank, value, ranks, hb_timeout)
      -> ("val", (contribs: {rank: value}, dead: {rank: reason}))
      releases once every rank of ``ranks`` has contributed or failed; the
      result is frozen once, so every caller of a tag sees the same
      contribution / failure split (the guarantee of the reference's ERA
      agreement, coll/ftagree).
The dead set only grows (once failed, always failed); a rank whose last
heartbeat is older than ``hb_timeout`` is promoted into it.

Once the job is aborted, a blocked ``get`` or ``fence`` (and any later
one) answers ``("aborted", (reason, code))``, and the client exits its
process with the code (:meth:`Client._rpc`).
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
        self._aborted = None  # (reason, exit code) once aborted
        # fault state: declared-dead ranks (monotonic, per ULFM) and the
        # last heartbeat times
        self._dead: Dict[int, str] = {}
        self._hb: Dict[int, float] = {}
        # the latest heartbeat payload per rank (telemetry seq payloads)
        self._telem: Dict[int, Any] = {}
        # tag -> {"contribs": {rank: val}, "result": frozen | None, "left"}
        self._gathers: Dict[str, dict] = {}
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

    def counter_value(self, key: str) -> int:
        """In-process read of an atomic counter (the head launcher's
        job-wide tally of its daemons' FT clean exits)."""
        with self._cond:
            return self._counters.get(key, 0)

    def seed_counter(self, key: str, value: int) -> None:
        """Pre-claim counter space: the launcher seeds the spawn
        watermark ``ww:<jobid>`` with its world size, so a spawned
        world's block of world ranks never meets the launcher's."""
        with self._cond:
            if self._counters.get(key, 0) < value:
                self._counters[key] = value

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
                while wait and key not in self._data and not self._aborted:
                    self._cond.wait(timeout=1.0)
                if key in self._data:
                    return ("val", self._data[key])
                if self._aborted:
                    return ("aborted", self._aborted)
                return ("none",)
        if op == "fence":
            # tags must be unique per epoch (the rte client appends an
            # epoch counter, mirroring PMIx fence instance uniqueness)
            _, tag, nprocs, rank, base = msg
            with self._cond:
                entry = self._fences.setdefault(tag, [set(), 0])
                entry[0].add(rank)
                self._cond.notify_all()

                def dead_absent():
                    # dead ranks release the fence (a PMIx fence over
                    # failed procs errors, never hangs); only this
                    # world's block counts, and a rank that arrived and
                    # then died is not counted twice
                    return sum(1 for r in self._dead
                               if base <= r < base + nprocs
                               and r not in entry[0])

                while (len(entry[0]) + dead_absent() < nprocs
                       and not self._aborted):
                    self._cond.wait(timeout=1.0)
                if self._aborted:
                    return ("aborted", self._aborted)
                entry[1] += 1
                if entry[1] >= nprocs - dead_absent():
                    self._fences.pop(tag, None)  # last releaser reclaims
                if len(entry[0]) < nprocs:
                    return ("okdead", dict(self._dead))
                return ("ok",)
        if op == "inc":
            _, key, amount = msg
            with self._cond:
                self._counters[key] = self._counters.get(key, 0) + amount
                return ("val", self._counters[key])
        if op == "abort":
            _, rank, reason, code = msg
            with self._cond:
                self._aborted = (f"rank {rank}: {reason}", int(code))
                self._cond.notify_all()
            return ("ok",)
        if op == "aborted?":
            with self._cond:
                return ("val", self._aborted)
        if op == "hb":
            payload = msg[2] if len(msg) > 2 else None
            with self._cond:
                self._hb[msg[1]] = time.monotonic()
                if payload is not None:
                    self._telem[msg[1]] = payload
            return ("ok",)
        if op == "telem?":
            with self._cond:
                return ("val", dict(self._telem))
        if op == "dead":
            _, rank, reason = msg
            self.mark_dead(rank, reason)
            return ("ok",)
        if op == "faults?":
            with self._cond:
                self._promote_stale(msg[1])
                return ("val", dict(self._dead))
        if op == "ftgather":
            _, tag, rank, value, ranks, hb_timeout = msg
            return self._ftgather(tag, rank, value, ranks, hb_timeout)
        return ("err", f"unknown op {op!r}")

    # -- fault tolerance --------------------------------------------------
    def mark_dead(self, rank: int, reason: str) -> None:
        """Declare a rank failed (the launcher's waitpid, or a peer)."""
        with self._cond:
            if rank not in self._dead:
                self._dead[rank] = reason
                self._cond.notify_all()

    def _promote_stale(self, hb_timeout: Optional[float]) -> None:
        """Move heartbeat-stale ranks into the dead set (caller holds the
        condition). Only ranks that ever sent a heartbeat can go stale."""
        if not hb_timeout:
            return
        now = time.monotonic()
        for rank, last in self._hb.items():
            if rank not in self._dead and now - last > hb_timeout:
                self._dead[rank] = f"heartbeat stale >{hb_timeout}s"
                self._cond.notify_all()

    def _ftgather(self, tag: str, rank: int, value: Any, ranks,
                  hb_timeout: Optional[float]) -> Tuple:
        with self._cond:
            entry = self._gathers.setdefault(
                tag, {"contribs": {}, "result": None, "left": 0})
            if entry["result"] is None:
                entry["contribs"][rank] = value
            entry["left"] += 1
            self._cond.notify_all()
            while entry["result"] is None and not self._aborted:
                self._promote_stale(hb_timeout)
                missing = [r for r in ranks if r not in entry["contribs"]
                           and r not in self._dead]
                if not missing:
                    entry["result"] = (dict(entry["contribs"]),
                                       {r: self._dead[r] for r in ranks
                                        if r in self._dead})
                    self._cond.notify_all()
                    break
                self._cond.wait(timeout=0.1)
            if self._aborted:
                return ("aborted", self._aborted)
            result = entry["result"]
            entry["left"] -= 1
            # reclaimed once every live contributor has its copy of the
            # frozen result
            if entry["left"] <= 0 and all(
                    r in entry["contribs"] or r in self._dead
                    for r in ranks):
                self._gathers.pop(tag, None)
            return ("val", result)


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
                from ompi_tpu_torch.core import pvar

                pvar.record("kvstore_connect_retries")
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
        if reply[0] == "aborted":
            # the job is going down: this rank exits with the abort's code
            # (SystemExit unwinds try / finally, so daemons still reap)
            raise SystemExit(reply[1][1] or 1)
        if reply[0] == "err":
            raise RuntimeError(reply[1])
        return reply

    def put(self, key: str, value: Any) -> None:
        self._rpc("put", key, value)

    def get(self, key: str, wait: bool = True) -> Any:
        reply = self._rpc("get", key, wait)
        return reply[1] if reply[0] == "val" else None

    def get_within(self, key: str, timeout: float) -> Any:
        """A value, polled until ``timeout`` seconds have passed (the
        blocking get has no deadline); raises TimeoutError."""
        deadline = time.monotonic() + timeout
        raw = self.get(key, wait=False)
        while raw is None:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{key} not published within {timeout} s")
            time.sleep(0.01)
            raw = self.get(key, wait=False)
        return raw

    def fence(self, tag: str, nprocs: int, rank: int, base: int = 0,
              timeout: Optional[float] = None) -> None:
        """Blocks until nprocs distinct ranks arrive; a timeout raises
        socket.timeout (shutdown paths that must not hang). ``base`` is
        the fencing world's first world rank; when failed ranks of that
        world released the fence, raises ProcFailedError."""
        reply = self._rpc("fence", tag, nprocs, rank, base,
                          timeout=timeout)
        if reply[0] == "okdead":
            from ompi_tpu_torch import errors

            raise errors.ProcFailedError(
                ranks=tuple(reply[1]),
                msg=f"fence {tag!r} released by failures: {reply[1]}")

    def inc(self, key: str, amount: int = 1) -> int:
        """Atomic store-side counter: returns the value after adding."""
        return self._rpc("inc", key, amount)[1]

    def abort(self, rank: int, reason: str, code: int = 1) -> None:
        """Mark the job aborted; best effort (the caller exits next)."""
        try:
            self._rpc("abort", rank, reason, int(code))
        except (OSError, ConnectionError, EOFError):
            pass

    def aborted(self):
        """(reason, code) once the job is aborted, else None."""
        return self._rpc("aborted?")[1]

    # -- fault tolerance --------------------------------------------------
    def heartbeat(self, rank: int, payload: Any = None) -> None:
        """Heartbeat, optionally carrying a telemetry payload (the rank's
        latest collective seq); without one the message stays the
        2-tuple."""
        if payload is None:
            self._rpc("hb", rank)
        else:
            self._rpc("hb", rank, payload)

    def telemetry(self) -> Dict[int, Any]:
        """The latest heartbeat payload per rank (the watchdog's seq
        diff)."""
        return self._rpc("telem?")[1]

    def mark_dead(self, rank: int, reason: str) -> None:
        self._rpc("dead", rank, reason)

    def faults(self, hb_timeout: Optional[float] = None) -> Dict[int, str]:
        """Failed ranks: launcher-declared and heartbeat-stale."""
        return self._rpc("faults?", hb_timeout)[1]

    def ftgather(self, tag: str, rank: int, value: Any, ranks,
                 hb_timeout: Optional[float] = None) -> Tuple:
        """The FT rendezvous: (contribs, dead), the same for every caller
        of ``tag`` (see the module docstring)."""
        return self._rpc("ftgather", tag, rank, value, tuple(ranks),
                         hb_timeout)[1]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
