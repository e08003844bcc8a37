"""Host-path partitioned point-to-point (MPI-4 Psend_init / Precv_init).

The port's copy of ``ompi_tpu.part.host`` (reference: ompi/mca/part/
part.h:124-185 and part/persist): a partitioned send is a persistent
request whose buffer is split into P partitions that the application
marks ready one by one (``Pready``); each ready partition moves on its
own, so a producer overlaps communication with the production of later
partitions.

Each partition rides ob1 as one message on a framework-internal
(negative) tag that encodes (user tag, pairing epoch, partition index).
Psend_init / Precv_init calls on the same (comm, peer, tag) pair up in
call order: a per-(side, peer, tag) epoch counter on both sides
(``comm._part_epochs``) tracks this without any wire traffic.

Erroneous calls (MPI 4.0 §4.2) raise ``MPIError``: ``Pready`` on an
inactive request or an already-ready partition, ``Parrived`` on a
never-started request, and ``start()`` while the previous epoch is
still in flight (a silent restart would orphan the in-flight
partitions' tags and desync the two sides' epochs).

Limits, checked: at most ``MAX_PARTITIONS`` (4096) partitions, user tags
below ``MAX_TAG`` (1024), 256 in-flight pairings per (peer, tag), so
every encoded tag fits the int32 wire field.

Where the port differs from the reference:

- A buffer is a C-contiguous numpy array (or anything ``np.asarray``
  views without a copy); a ``torch.Tensor`` raises
  ``MPIError(ERR_BUFFER)``: the reference's ``np.asarray`` would copy a
  device array, so its partitions would not alias the caller's buffer.
- A partition index outside ``[0, partitions)`` given to ``Pready``
  raises ``MPIError(ERR_ARG)`` (the reference indexes a list with it).

The trace and flight-recorder sites are the reference's (:114, :155,
:175, :224, :237): an epoch is one flight-recorder entry from start to
completion (``psend_epoch`` / ``precv_epoch``), a Pready's send is a
``psend_pready`` span and a receive epoch's posting a ``precv_start``
span in ``part``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ompi_tpu_torch import errors, pml
from ompi_tpu_torch.core import progress, pvar
from ompi_tpu_torch.part import partial as _partial
from ompi_tpu_torch.pml import request as rq
from ompi_tpu_torch.telemetry import flight as _flight
from ompi_tpu_torch.trace import recorder as _trace

_PART_BASE = -(1 << 24)  # below any other framework-internal tag
MAX_PARTITIONS = 4096
MAX_TAG = 1024  # keeps the encoded tag within int32 (see module doc)


def _part_tag(user_tag: int, epoch: int, idx: int) -> int:
    if not 0 <= user_tag < MAX_TAG:
        raise errors.MPIError(
            errors.ERR_TAG, f"partitioned tag must be in [0,{MAX_TAG})")
    return _PART_BASE - (((user_tag << 8) | (epoch & 0xFF))
                         * MAX_PARTITIONS + idx)


def _epoch(comm, peer: int, tag: int, side: str) -> int:
    # a dict of its own, not comm.attrs: epochs are transport pairing
    # state, which attribute copy callbacks must never clone onto a dup
    table = comm.__dict__.setdefault("_part_epochs", {})
    key = (side, peer, tag)
    n = table.get(key, 0)
    table[key] = n + 1
    return n


class _PartitionedBase(rq.Request):
    def __init__(self, comm, buf, partitions: int, peer: int,
                 tag: int) -> None:
        super().__init__()
        if partitions < 1 or partitions > MAX_PARTITIONS:
            raise errors.MPIError(
                errors.ERR_COUNT,
                f"partitions must be in [1,{MAX_PARTITIONS}]")
        if isinstance(buf, torch.Tensor):
            raise errors.MPIError(
                errors.ERR_BUFFER,
                "partitioned buffers are host (numpy) arrays; a "
                "torch.Tensor is refused (its partitions would not alias "
                "the tensor)")
        arr = np.asarray(buf)
        if not arr.flags.c_contiguous:
            # reshape(-1) would copy: partition views must alias the
            # caller's buffer (receives land in them, sends read them at
            # Pready time)
            raise errors.MPIError(
                errors.ERR_BUFFER, "partitioned buffers must be C-contiguous")
        flat = arr.reshape(-1)
        if flat.size % partitions:
            raise errors.MPIError(
                errors.ERR_COUNT,
                f"buffer of {flat.size} elements not divisible into "
                f"{partitions} partitions")
        self.persistent = True
        self.comm = comm
        self.peer = peer
        self.tag = tag
        self.partitions = partitions
        self._chunks = np.split(flat, partitions)  # views
        self._reqs: List[Optional[rq.Request]] = []
        self._started = False  # ever started (the Parrived precondition)
        self._fl_tok: Optional[int] = None  # the epoch's flight entry
        self.completed = True  # inactive until start()

    @property
    def completed(self) -> bool:
        """Live: the plural helpers poll ``completed`` while they spin
        progress, so it evaluates the epoch."""
        if not self._done:
            self._done = self._epoch_done()
            if self._done and self._fl_tok is not None:
                tok, self._fl_tok = self._fl_tok, None
                fl = _flight.FLIGHT
                if fl is not None:
                    fl.exit(tok)
        return self._done

    @completed.setter
    def completed(self, v: bool) -> None:  # the base __init__ writes here
        self._done = bool(v)

    @property
    def active(self) -> bool:
        """An epoch is open and not yet known complete (``start_all``
        refuses to restart these)."""
        return not self.completed

    def _check_start(self) -> None:
        if self._started and not self.completed:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                "partitioned start: previous epoch still active — wait/"
                "test the request to completion before restarting (MPI "
                "4.0 §4.2: starting an active request is erroneous)")

    def _epoch_done(self) -> bool:
        raise NotImplementedError

    def test(self) -> bool:
        if not self.completed:
            progress.progress()
        return self.completed

    def wait(self, timeout=None):
        progress.wait_until(lambda: self.completed, timeout=timeout)
        if not self.completed:
            raise TimeoutError(f"request {self.id} did not complete")
        return self.status


class PartitionedSendRequest(_PartitionedBase):
    """MPI_Psend_init's request: start() opens an epoch, Pready(i) sends
    partition i; complete once every partition is sent."""

    def start(self) -> None:
        self._check_start()
        self._ep = _epoch(self.comm, self.peer, self.tag, "send")
        self._reqs = [None] * self.partitions
        self._ready = [False] * self.partitions
        self._started = True
        self.completed = False
        pvar.record("part_send_start")
        fl = _flight.FLIGHT
        if fl is not None:
            self._fl_tok = fl.enter(
                "psend_epoch", getattr(self.comm, "cid", -1),
                sum(int(c.nbytes) for c in self._chunks))

    def Pready(self, idx: int) -> None:
        if self.completed:
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"Pready({idx}): request inactive — call start() before "
                "marking partitions ready")
        if not 0 <= idx < self.partitions:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"Pready({idx}): partition index out of "
                f"[0,{self.partitions})")
        if self._ready[idx]:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"Pready({idx}): partition already marked ready this "
                "epoch (double-Pready is erroneous)")
        self._ready[idx] = True
        pvar.record("part_pready")
        chunk = self._chunks[idx]
        rec = _trace.RECORDER
        if rec is None:
            self._reqs[idx] = pml.current().isend(
                self.comm, chunk, chunk.size, None, self.peer,
                _part_tag(self.tag, self._ep, idx))
            return
        t0 = _trace.now()
        self._reqs[idx] = pml.current().isend(
            self.comm, chunk, chunk.size, None, self.peer,
            _part_tag(self.tag, self._ep, idx))
        rec.record("psend_pready", "part", t0, _trace.now(),
                   {"partition": idx, "peer": self.peer,
                    "tag": self.tag, "nbytes": int(chunk.nbytes)})

    def Pready_range(self, lo: int, hi: int) -> None:
        for i in range(lo, hi + 1):
            self.Pready(i)

    def Pready_list(self, idxs) -> None:
        for i in idxs:
            self.Pready(i)

    def _epoch_done(self) -> bool:
        return all(self._ready) and all(r.test() for r in self._reqs)


class PartitionedRecvRequest(_PartitionedBase,
                             _partial.PartialAvailability):
    """MPI_Precv_init's request: start() posts every partition's
    receive; Parrived(i) / Parrived_range / Parrived_list poll;
    complete once all arrived."""

    _PARRIVED_PVAR = "part_parrived"

    def start(self) -> None:
        self._check_start()
        ep = _epoch(self.comm, self.peer, self.tag, "recv")
        p = pml.current()
        rec = _trace.RECORDER
        t0 = _trace.now() if rec is not None else 0
        self._reqs = [
            p.irecv(self.comm, self._chunks[i], self._chunks[i].size, None,
                    self.peer, _part_tag(self.tag, ep, i))
            for i in range(self.partitions)]
        if rec is not None:
            rec.record("precv_start", "part", t0, _trace.now(),
                       {"partitions": self.partitions,
                        "peer": self.peer, "tag": self.tag})
        self._started = True
        self.completed = False
        pvar.record("part_recv_start")
        fl = _flight.FLIGHT
        if fl is not None:
            self._fl_tok = fl.enter(
                "precv_epoch", getattr(self.comm, "cid", -1),
                sum(int(c.nbytes) for c in self._chunks))

    def _partial_started(self) -> bool:
        return self._started

    def _partial_probe(self, idx: int) -> bool:
        if not 0 <= idx < self.partitions:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"Parrived({idx}): partition index out of "
                f"[0,{self.partitions})")
        return self._reqs[idx].test()

    def _epoch_done(self) -> bool:
        return all(r.test() for r in self._reqs)


def _Psend_init(self, buf, partitions: int, dest: int,
                tag: int = 0) -> PartitionedSendRequest:
    return PartitionedSendRequest(self, buf, partitions, dest, tag)


def _Precv_init(self, buf, partitions: int, source: int,
                tag: int = 0) -> PartitionedRecvRequest:
    return PartitionedRecvRequest(self, buf, partitions, source, tag)


def attach() -> None:
    from ompi_tpu_torch.comm import Communicator

    Communicator.Psend_init = _Psend_init
    Communicator.Precv_init = _Precv_init


attach()
