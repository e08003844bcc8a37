"""pml/v and vprotocol/pessimist — sender-based message logging.

The port's copy of ``ompi_tpu.pml.vprotocol`` (reference: ompi/mca/pml/v
and vprotocol/pessimist): an interposition PML that keeps a copy of
every application message its rank sends (the sender-based log) and
records every nondeterministic receive outcome, which source and tag a
receive matched in completion order (the determinants), optionally on
stable storage (``vprotocol_log_dir``). After a failure, peers re-send
from their logs (:meth:`VprotocolPml.resend`) and the restarted process
consumes them in its determinant order. :func:`install` wraps the
selected PML at MPI_Init (``--mca pml_v 1``), after ``pml.select()`` and
before the monitoring plane's wrapper; :func:`installed` finds the layer
anywhere in the stack; :meth:`VprotocolPml.truncate` collects a peer's
log once its progress is stable; :func:`load_determinants` reads a
rank's persisted log. Collective-internal rounds are re-executed on
recovery, never replayed, so they are not logged.

Where the port differs from the reference:

- a device ``Send`` reaches the PML as ``pml/accel_p2p``'s header and
  chunks, each chunk a view of a pinned host buffer that the next chunk
  reuses; the log copies each message's bytes when it is sent (a view
  would be overwritten), so the log of a device ``Send`` is its header
  and its chunks, and a bfloat16 tensor is logged by its bits;
- a log entry keeps the Datatype the send used and :meth:`resend` sends
  the logged bytes with it (the reference re-sends with the numpy dtype
  alone), so a chunk re-sent as ``BFLOAT16`` lands as the original did;
- a ``torch.Tensor`` that reaches :meth:`VprotocolPml.isend` directly is
  logged by its bytes when it lies on the CPU; a CUDA tensor raises
  ``MPIError(ERR_BUFFER)``, since device tensors reach the PML only
  through ``pml/accel_p2p``'s staging and the log never copies one
  through the host itself.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.datatype import BFLOAT16

_enable_var = cvar.register(
    "pml_v", False, bool,
    help="Install the message-logging interposition PML at init "
         "(reference: pml/v + vprotocol/pessimist).", level=7)
_dir_var = cvar.register(
    "vprotocol_log_dir", "", str,
    help="Directory for determinant logs (stable storage). Empty = "
         "memory only (volatile, like the reference's sender log; "
         "determinants then survive only with the process).", level=7)


def _bytes_of(buf) -> Tuple[bytes, str]:
    """A copy of ``buf``'s bytes, taken now, and its element type's
    name."""
    import torch

    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise errors.MPIError(
                errors.ERR_BUFFER,
                f"pml/v: a tensor on {buf.device} reached the pml; device "
                "tensors go through pml/accel_p2p's staging")
        flat = buf.detach().reshape(-1).contiguous()
        raw = flat.view(torch.uint8).numpy().tobytes() if flat.numel() \
            else b""
        return raw, str(buf.dtype).removeprefix("torch.")
    arr = np.ascontiguousarray(buf)
    return arr.tobytes(), arr.dtype.str


class VprotocolPml:
    """Wraps the selected PML; logs sends and receive determinants."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self._lock = threading.Lock()
        # sender-based log: dst world rank -> [(kind, comm_cid, tag,
        # payload)] in send order; kind 'buf': payload (bytes, element
        # type name, count, Datatype or None); kind 'obj': the object
        self.send_log: Dict[int, List[Tuple]] = {}
        # determinants: the completion-order (source, tag, count) of every
        # receive, the nondeterministic outcomes
        self.determinants: List[Tuple[int, int, int]] = []
        self._det_fh = None
        d = _dir_var.get()
        if d:
            from ompi_tpu_torch.runtime import rte

            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"det_{rte.jobid}_{rte.rank}.log")
            self._det_fh = open(path, "ab")

    # -- send side: log a copy (sender-based logging) -------------------
    def _world(self, comm, dst: int) -> int:
        g = comm.remote_group if getattr(comm, "is_inter", False) \
            else comm.group
        try:
            return g.ranks[dst]
        except (IndexError, TypeError):
            return dst

    def _log_send(self, comm, dst: int, entry: Tuple) -> None:
        if dst < 0:
            return
        with self._lock:
            self.send_log.setdefault(
                self._world(comm, dst), []).append(entry)
        pvar.record("vprotocol_logged_sends")

    def isend(self, comm, buf, count, dtype, dst, tag, **kw):
        if kw.get("collective"):
            # collective-internal rounds are re-executed on recovery,
            # never replayed (the reference logs application messages)
            return self._inner.isend(comm, buf, count, dtype, dst, tag,
                                     **kw)
        if buf is not None:
            raw, name = _bytes_of(buf)
            self._log_send(comm, dst, (
                "buf", comm.cid, tag, (raw, name, count, dtype)))
        return self._inner.isend(comm, buf, count, dtype, dst, tag, **kw)

    def send(self, comm, buf, count, dtype, dst, tag, **kw):
        return self.isend(comm, buf, count, dtype, dst, tag, **kw).wait()

    def isend_obj(self, comm, obj, dst, tag, **kw):
        if not kw.get("collective"):
            self._log_send(comm, dst, ("obj", comm.cid, tag, obj))
        return self._inner.isend_obj(comm, obj, dst, tag, **kw)

    def send_obj(self, comm, obj, dst, tag, **kw):
        return self.isend_obj(comm, obj, dst, tag, **kw).wait()

    # -- receive side: determinant capture ---------------------------------
    def _record_det(self, req) -> None:
        det = (req.status.source, req.status.tag, req.status.count)
        with self._lock:
            self.determinants.append(det)
            if self._det_fh is not None:
                pickle.dump(det, self._det_fh)
                self._det_fh.flush()

    def _capture(self, req):
        if req.completed:
            # matched from the unexpected queue inside the inner irecv:
            # the outcome is already determined
            self._record_det(req)
            return req
        orig_complete = req.complete

        def complete(error: int = 0):
            orig_complete(error)
            self._record_det(req)

        req.complete = complete
        return req

    def irecv(self, comm, buf, count, dtype, src, tag, **kw):
        req = self._inner.irecv(comm, buf, count, dtype, src, tag, **kw)
        return req if kw.get("collective") else self._capture(req)

    def irecv_obj(self, comm, src, tag, **kw):
        req = self._inner.irecv_obj(comm, src, tag, **kw)
        return req if kw.get("collective") else self._capture(req)

    def recv(self, comm, buf, count, dtype, src, tag, **kw):
        return self.irecv(comm, buf, count, dtype, src, tag, **kw).wait()

    def recv_obj(self, comm, src, tag, **kw):
        req = self.irecv_obj(comm, src, tag, **kw)
        req.wait()
        return req._obj

    # -- replay channel ---------------------------------------------------
    def resend(self, peer_world: int, comm) -> int:
        """Re-send every logged message for a recovering peer on
        ``comm``, in the original order (the pessimist replay: the peer
        consumes them guided by its determinants). Returns the messages
        re-sent."""
        with self._lock:
            entries = list(self.send_log.get(peer_world, ()))
        g = comm.remote_group if getattr(comm, "is_inter", False) \
            else comm.group
        dst = g.ranks.index(peer_world)
        n = 0
        for kind, cid, tag, payload in entries:
            if cid != comm.cid:
                continue
            if kind == "buf":
                raw, name, count, dtype = payload
                if dtype is None and name == "bfloat16":
                    dtype = BFLOAT16
                # the bytes as the send typed them: by its Datatype, else
                # by the buffer's element type (a Datatype-less send)
                arr = np.frombuffer(raw, np.uint8 if dtype is not None
                                    else np.dtype(name))
                self._inner.send(comm, arr, count, dtype, dst, tag)
            else:
                self._inner.send_obj(comm, payload, dst, tag)
            n += 1
        pvar.record("vprotocol_resends", n)
        return n

    def truncate(self, peer_world: int, keep_last: int = 0) -> None:
        """Collect the send log for a peer once its progress is stable
        (the reference truncates on checkpoint / acknowledgement)."""
        with self._lock:
            log = self.send_log.get(peer_world)
            if log is not None:
                del log[:len(log) - keep_last]

    # -- passthrough -------------------------------------------------------
    def __getattr__(self, name):
        return getattr(self._inner, name)


def install() -> VprotocolPml:
    from ompi_tpu_torch import pml

    cur = pml.current()
    if isinstance(cur, VprotocolPml):
        return cur
    v = VprotocolPml(cur)
    pml.set_current(v)
    return v


def installed() -> Optional[VprotocolPml]:
    """The vprotocol layer anywhere in the interposition stack (another
    layer, pml/monitoring, may wrap it)."""
    from ompi_tpu_torch import pml

    cur = pml.instance()
    while cur is not None:
        if isinstance(cur, VprotocolPml):
            return cur
        cur = getattr(cur, "_inner", None)
    return None


def load_determinants(jobid: str, rank: int) -> List[Tuple]:
    """Read a (possibly dead) rank's persisted determinant log."""
    d = _dir_var.get()
    if not d:
        return []
    path = os.path.join(d, f"det_{jobid}_{rank}.log")
    out: List[Tuple] = []
    try:
        with open(path, "rb") as fh:
            while True:
                out.append(pickle.load(fh))
    except (FileNotFoundError, EOFError):
        pass
    return out
