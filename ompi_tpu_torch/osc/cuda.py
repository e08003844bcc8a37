"""osc/cuda — device-resident one-sided windows.

Port of ``ompi_tpu.osc.pallas`` (``PallasWindow``). The window is a tensor
on the rank's device, and every window mutation and read runs as one of
the kernels K7-K10 (:mod:`ompi_tpu_torch.osc.cuda_kernels`). The epochs
split as the reference splits them:

- **Fence** (active target, collective): ``Put`` / ``Put_strided`` /
  elementwise ``Accumulate`` / ``Get_epoch`` queue descriptors; the
  closing Fence runs one metadata allgather, groups the epoch's transfers
  by element count (sorted) and colours each group first-fit into partial
  matchings: the reference's rounds, in its order. Where the reference
  moves each round as one step, the port cuts the rounds, in order, into
  exchanges (:func:`plan_exchanges`: as many consecutive rounds as keep
  every rank's staged bytes within :data:`EXCHANGE_BYTES`) and moves each
  exchange through the window comm's peer-mapped arena in one host step
  (``coll.cuda.Arena.exchange``):

  - puts: the origin stages every payload it sends in the exchange in its
    own region, grouped by target, in round order (one ``torch.cat``);
    the target applies what it receives in exactly the reference's round
    order, reading each payload straight from its source's region: K8's
    grouped kernel over runs of disjoint descriptors, K7 for contiguous
    ones of 2**20 elements or more;
  - gets: the target stages every row it serves, grouped by origin, with
    one K9 batch; the origin pulls every source's block into a fresh
    landing tensor with one grouped K10 launch, and each
    ``GetHandle.array`` is a view of it.

  So same-location accumulates apply in the reference's round order and
  the windows end bitwise equal to the JAX package's;
  ``osc_cuda_rounds`` counts the reference's rounds and
  ``osc_cuda_exchanges`` the host steps run. The flush is the module's
  :func:`fence_flush`, which the device-epoch window
  (``osc/device_epoch.py``) runs too.
- **PSCW and passive target** (Post / Start / Complete / Wait, Lock /
  Unlock / Flush / Lock_all): synchronisation rides the host
  :class:`~ompi_tpu_torch.osc.Window`'s active-message (AM) service, which
  this class subclasses: per-peer exposure by post / complete messages,
  the lock manager, flush acks. Ops to a target under a Lock or a Start
  ride the AM plane as numpy payloads (a bfloat16 payload as its uint16
  bits), and the target's data path runs on the card: a put or an
  elementwise accumulate is K7 (stride 1) or K8 (``Put_strided``); every
  read (Get, Get_strided, Get_accumulate, Fetch_and_op, the compare of
  Compare_and_swap) is K9 into a fresh tensor that the reply copies to
  the host. A valid op the kernels do not fold (BAND, LOR, ...) is
  host-assisted: a K9 read, the reference's numpy fold ``np_fn(data,
  cur)``, then a K7 replace; the origin counts it in
  ``osc_cuda_fallthrough``. Every AM-plane call counts ``osc_cuda_am_ops``.
  The target launches its applies and reads on one stream the window
  records at creation, on the window's device; its host reads of window
  bytes (the reply's copy, CAS's compare) follow them on that stream, and
  where an epoch closes at the target (Wait, Fence, Sync, the service of
  Unlock and of a flush) the caller's current stream waits for it
  (``wait_stream``), so a flush or unlock ack implies every earlier op of
  that origin is applied for a later Get and for ``win.array``. Rput /
  Rget are allowed under a Lock only.

Addressing is by element: ``disp`` counts window elements, and operands
must have the window's dtype. Epoch discipline is enforced as the
reference enforces it: an op outside any epoch, ``Get_epoch`` outside a
fence, ``Unlock`` without ``Lock``, ``Complete`` without ``Start``,
``Rput`` / ``Rget`` outside a Lock, and ``Free`` with queued descriptors
raise ``MPIError(ERR_RMA_SYNC)``; an operand whose dtype differs from the
window's raises ``ERR_ARG``. A window the kernels cannot take (another
dtype, a host buffer on some rank, dtypes that differ across ranks) is
counted in ``osc_cuda_fallthrough`` at creation, and ``win_create``
serves the host window. Each fallthrough also emits the MPI_T event
``osc_cuda_fallthrough`` (the reference's ``osc_pallas_fallthrough``:
``what``, ``reason``), and the Fence emits ``osc_epoch_transition``'s
enter and exit as the host window's epochs do.

Where the port differs from the reference:

- the window is a tensor cloned from ``base`` at creation, so the
  caller's tensor is untouched, as a jax array is;
- applies update the window in place, and ``win.array`` is a view of it
  in ``base``'s shape (valid at epoch boundaries);
- a queued origin tensor is kept by reference, not cloned: MPI forbids
  changing an origin buffer before the closing fence;
- a ``GetHandle.array`` is a view of the exchange's fresh landing tensor,
  never of an arena region, which the next exchange reuses;
- a target rank outside the window is ``ERR_RANK`` at the call, through
  the window's errhandler, for every op and in every epoch (the
  reference's fence Put queues it): a callback that returns makes the
  op move nothing, ``Get_epoch`` return an empty handle and ``Rput`` /
  ``Rget`` a completed request (their rank check comes before their
  passive-target check);
- a contiguous ``Put`` / ``Accumulate`` / ``Get_epoch`` / ``Get`` /
  ``Get_accumulate`` / ``Fetch_and_op`` (and a ``Put_strided`` of stride
  1, which the target applies as one) of more elements than the target's
  window raises ``ERR_ARG`` at the call, from ``peer_info``, so nothing
  reaches the target that it cannot apply (the reference sends it); a
  strided put still drops what falls outside;
- a host-assisted fold of bfloat16 (numpy has none) raises
  ``ERR_NOT_SUPPORTED`` at the call, and one numpy cannot compute for
  the window's dtype (BAND on float32) raises ``ERR_OP`` at the call (the
  reference's target fails inside its service loop); ``Fetch_and_op``
  with such an op counts ``osc_cuda_fallthrough`` too (the reference
  counts Accumulate and Get_accumulate only).
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll import cuda as _coll_cuda
from ompi_tpu_torch.core import cvar, events as mpit_events, pvar
from ompi_tpu_torch.monitoring import algo as _algo
from ompi_tpu_torch.monitoring import matrix as _mon
from ompi_tpu_torch.osc import (LOCK_EXCLUSIVE, Window, _numel,
                                _tensor_bits, _wire_dtype, to_wire)
from ompi_tpu_torch.osc import cuda_kernels as O
from ompi_tpu_torch.osc.device_epoch import GetHandle, _color
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.telemetry import flight as _flight
from ompi_tpu_torch.trace import recorder as _trace

_enable_var = cvar.register(
    "osc_cuda", "off", str,
    help="Enable the device-resident one-sided windows (osc/pallas's "
         "counterpart): 'on' serves win_create over a supported device "
         "tensor with CudaWindow (kernel-applied RMA: fence epochs over "
         "the peer-mapped arenas, PSCW and passive target over the host "
         "window's active-message service); 'off' [default] serves every "
         "window with the host window (a tensor staged through a host "
         "mirror).",
    choices=["off", "on"], level=4)
#: bytes a rank may stage for one exchange of a fence (a run of the
#: reference's coloured rounds moved in one host step); a round whose
#: payload is larger runs alone. The embedding path's fences (256 KiB a
#: rank) and the halo columns (64 KiB) each fit one exchange; the halo
#: tile's 256 MiB put runs alone.
EXCHANGE_BYTES = 64 << 20

#: the kernels' support matrix
_SUPPORTED_DTYPES = frozenset((torch.float32, torch.bfloat16, torch.int32))

FALLTHROUGH_EVENT = mpit_events.register_type(
    "osc_cuda_fallthrough",
    "an osc/cuda window or operation fell through to the host path "
    "(unsupported dtype/shape/op)",
    ("what", "reason"))


def _fallthrough_note(what: str, reason: str) -> None:
    """Count a fallthrough to the host path (``osc_cuda_fallthrough``)
    and emit the MPI_T event of the same name (the reference's
    ``osc_pallas_fallthrough``, osc/pallas.py:94-123)."""
    pvar.record("osc_cuda_fallthrough")
    if mpit_events.active("osc_cuda_fallthrough"):
        mpit_events.emit("osc_cuda_fallthrough", what=what, reason=reason)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _op_name(op) -> str:
    return str(getattr(op, "name", op))


def _flight_slot(op: str, cid: int, nbytes: int = 0):
    """A flight-recorder entry for one synchronisation call
    (osc/pallas.py:127-140), or None while the recorder is off; pair
    with :func:`_flight_exit`. The op names the window and the peers, so
    a hang dump attributes a stuck epoch by itself."""
    fl = _flight.FLIGHT
    if fl is None:
        return None
    return (fl, fl.enter(op, cid, nbytes))


def _flight_exit(tok) -> None:
    if tok is not None:
        tok[0].exit(tok[1])


class CudaWindow(Window):
    """Device-resident MPI window: the authoritative buffer is a flat
    tensor on the rank's device (``.array`` views it in ``base``'s
    shape); all target-side RMA runs as kernels; a fence epoch runs its
    edge-coloured rounds as exchanges over the window comm's arenas, and
    PSCW and passive-target epochs ride the AM plane.

    Created by ``osc.win_create`` under ``--mca osc_cuda on`` (see
    :func:`maybe_window`), or directly with :func:`win_create_cuda`."""

    def __init__(self, comm, base: torch.Tensor,
                 disp_unit: int = 1, info=None) -> None:
        self._shape = tuple(base.shape)
        self._win = base.detach().clone(
            memory_format=torch.contiguous_format).reshape(-1)
        self._fence_open = False
        # fence-epoch descriptor queues: puts (target, disp, payload,
        # kind, stride), gets (handle, target, disp, nelems, stride)
        self._fput: List[Tuple] = []
        self._fget: List[Tuple] = []
        # passive-target epoch starts per target (the trace's epoch spans)
        self._lock_t0: Dict[int, int] = {}
        self._target = O.Target(self._win)  # the launch record, checked once
        # the stream every apply and read of this window runs on
        self._stream = torch.cuda.current_stream(self._win.device) \
            if self._win.is_cuda else None
        super().__init__(comm, self._win, disp_unit, info=info)
        pvar.record("osc_cuda_windows")

    def _adopt(self, base):
        return base  # device-authoritative: no host mirror

    def _nbytes(self) -> int:
        return self._win.numel() * self._win.element_size()

    # -- device state ---------------------------------------------------
    @property
    def array(self) -> torch.Tensor:
        """The window contents in ``base``'s shape: a view of the live
        window (read it at epoch boundaries)."""
        return self._win.view(self._shape)

    def device_array(self) -> torch.Tensor:
        return self.array

    def _on_stream(self):
        """The window's stream as the current stream (the CPU has none)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _join(self) -> None:
        """Order the window's stream and the caller's current stream both
        ways (nothing to do when they are one stream): the caller's
        earlier work on origin tensors and the window comes before the
        window's next launches, and the window's launches before the
        caller's later work."""
        if self._stream is None:
            return
        cur = torch.cuda.current_stream(self._win.device)
        if cur != self._stream:
            self._stream.wait_stream(cur)
            cur.wait_stream(self._stream)

    def _publish(self) -> None:
        if self._stream is None:
            return
        cur = torch.cuda.current_stream(self._win.device)
        if cur != self._stream:
            cur.wait_stream(self._stream)

    # -- epoch discipline -----------------------------------------------
    def _epoch_for(self, target: int) -> str:
        """The epoch covering an op to ``target``: passive lock > PSCW
        access > open fence; none is erroneous (MPI-3.1 §11.5)."""
        if target in self._granted:
            return "lock"
        if self._access_group is not None and target in self._access_group:
            return "pscw"
        if self._fence_open:
            return "fence"
        raise errors.MPIError(
            errors.ERR_RMA_SYNC,
            f"RMA op on {self.name} outside any epoch: no Fence, Start "
            f"group, or Lock covers rank {target}")

    def _payload(self, buf, what: str) -> torch.Tensor:
        """Validate and flatten an origin operand: its dtype must match
        the window's (element-typed addressing). A numpy operand is
        wrapped as a CPU tensor; the fence stages it onto the device."""
        name = _dtype_name(buf.dtype) if isinstance(buf, torch.Tensor) \
            else str(np.asarray(buf).dtype)
        if name != _dtype_name(self._win.dtype):
            raise errors.MPIError(
                errors.ERR_ARG,
                f"{what} operand dtype {name} != window dtype "
                f"{_dtype_name(self._win.dtype)} on {self.name} "
                "(element-typed device window; cast at the origin)")
        if isinstance(buf, torch.Tensor):
            return buf.reshape(-1)
        a = np.ascontiguousarray(buf)
        if name == "bfloat16":  # numpy's bfloat16 comes through its bits
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).reshape(-1)
        return torch.from_numpy(a.copy()).reshape(-1)

    def _check_fits(self, what: str, k: int, target: int) -> None:
        """Raise ``MPIError(ERR_ARG)`` for a contiguous transfer of more
        elements than ``target``'s window holds (every rank's window has
        this window's dtype)."""
        size = self.peer_info[target][0] // self._win.element_size()
        if k > size:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"{what} of {k} elements on {self.name}: rank {target}'s "
                f"window holds {size}")

    @staticmethod
    def _acc_kind(op) -> str:
        return _op_name(op).lower().removeprefix("mpi_")

    def _check_host_fold(self, op, what: str) -> None:
        """An op the kernels do not fold is host-assisted at the target
        (numpy's fold): count it, and refuse at the call what numpy
        cannot fold in the window's dtype."""
        name = _op_name(op)
        if self._acc_kind(op) in O.ELEMENTWISE or name == "MPI_NO_OP":
            return
        _fallthrough_note(what.lower(), f"op {name!r} is not elementwise")
        if self._win.dtype == torch.bfloat16:
            raise errors.MPIError(
                errors.ERR_NOT_SUPPORTED,
                f"{what}: {name} on {self.name} is host-assisted, and numpy "
                "has no bfloat16 to fold it in")
        fn = op_mod.BUILTIN[name].np_fn if name in op_mod.BUILTIN \
            else None
        z = np.zeros(1, _wire_dtype(self._win))
        try:
            if fn is None:
                raise TypeError(  # check: disable=bare-public-raise; -> ERR_OP
                    f"{name} is not a predefined op")
            fn(z, z)
        except TypeError as exc:
            raise errors.MPIError(
                errors.ERR_OP,
                f"{what}: {name} is not defined on "
                f"{_dtype_name(self._win.dtype)} ({exc})") from None

    # -- origin API -----------------------------------------------------
    def _queue_put(self, a: torch.Tensor, target: int, disp: int,
                   kind: str, stride: int) -> None:
        pvar.record("osc_cuda_bytes", a.numel() * a.element_size())
        self._fput.append((int(target), int(disp), a, kind, int(stride)))

    def Put(self, buf, target: int, disp: int = 0) -> None:
        pvar.record("osc_cuda_put")
        ep = self._epoch_for(target)
        if not self._check_target(target):
            return
        data = self._payload(buf, "Put")
        self._check_fits("Put", data.numel(), target)
        if ep == "fence":
            self._queue_put(data, target, disp, "put", 1)
            return
        pvar.record("osc_cuda_am_ops")
        Window.Put(self, to_wire(data), target, disp)

    def Put_strided(self, buf, target: int, disp: int = 0,
                    stride: int = 1) -> None:
        """Elements of buf land at disp, disp+stride, ... (the halo
        column); those past either end of the window are dropped (stride
        1 is a contiguous Put)."""
        pvar.record("osc_cuda_put")
        ep = self._epoch_for(target)
        if not self._check_target(target):
            return
        data = self._payload(buf, "Put")
        if stride == 1:
            self._check_fits("Put_strided", data.numel(), target)
        if ep == "fence":
            self._queue_put(data, target, disp, "put", stride)
            return
        pvar.record("osc_cuda_am_ops")
        Window.Put_strided(self, to_wire(data), target, disp, stride)

    def Accumulate(self, buf, target: int, disp: int = 0,
                   op: op_mod.Op = op_mod.SUM) -> None:
        pvar.record("osc_cuda_acc")
        ep = self._epoch_for(target)
        kind = self._acc_kind(op)
        data = self._payload(buf, "Accumulate")
        if not self._check_target(target):
            return
        self._check_fits("Accumulate", data.numel(), target)
        self._check_host_fold(op, "Accumulate")
        if ep == "fence" and kind in O.ELEMENTWISE:
            self._queue_put(data, target, disp, kind, 1)
            return
        # a Lock or Start epoch, or a host-assisted op (in any epoch: the
        # next Fence flushes it before its descriptors)
        pvar.record("osc_cuda_am_ops")
        Window.Accumulate(self, to_wire(data), target, disp, op)

    def Get_epoch(self, nelems: int, target: int, disp: int = 0,
                  stride: int = 1) -> GetHandle:
        """Device-resident Get: records a descriptor; the handle's
        ``.array`` is filled at the closing Fence, fetched over the same
        coloured rounds and exchanges as puts (data flows target ->
        origin). Fence epochs only: PSCW and lock epochs use :meth:`Get`."""
        pvar.record("osc_cuda_get")
        if not self._fence_open:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Get_epoch on {self.name} outside a fence epoch")
        if not self._check_target(target):
            return GetHandle()  # recovered: nothing is fetched
        if stride == 1:
            self._check_fits("Get_epoch", int(nelems), target)
        h = GetHandle()
        self._fget.append((h, int(target), int(disp), int(nelems),
                           int(stride)))
        return h

    def Get(self, buf, target: int, disp: int = 0):
        """Synchronous Get (the host window's contract): the target reads
        its window with K9 and the reply rides the AM plane; ``buf`` (a
        tensor or a numpy array) is filled in place, a tensor is
        returned. For fence-batched device gets use :meth:`Get_epoch`."""
        pvar.record("osc_cuda_get")
        self._epoch_for(target)
        if not self._check_target(target):
            return None
        self._check_fits("Get", _numel(buf), target)
        pvar.record("osc_cuda_am_ops")
        # the internal transport, not the Rget override (which enforces
        # the passive-target-only rule on user calls)
        self._rget(buf, target, disp).wait()
        return buf if isinstance(buf, torch.Tensor) else None

    def Get_strided(self, buf, target: int, disp: int = 0,
                    stride: int = 1) -> None:
        pvar.record("osc_cuda_get")
        self._epoch_for(target)
        if not self._check_target(target):
            return
        if stride == 1:
            self._check_fits("Get_strided", _numel(buf), target)
        pvar.record("osc_cuda_am_ops")
        Window.Get_strided(self, buf, target, disp, stride)

    def Get_accumulate(self, origin, result, target: int, disp: int = 0,
                       op: op_mod.Op = op_mod.SUM) -> None:
        """Atomic fetch-and-accumulate through the AM plane (the target's
        service loop is the serialisation point): a K9 read of the old
        slice, then the op applied by K7."""
        self._epoch_for(target)
        data = self._payload(origin, "Get_accumulate")
        if not self._check_target(target):
            return
        self._check_fits("Get_accumulate", data.numel(), target)
        self._check_host_fold(op, "Get_accumulate")
        pvar.record("osc_cuda_am_ops")
        Window.Get_accumulate(self, to_wire(data), result, target, disp, op)

    def Fetch_and_op(self, value, result, target: int, disp: int = 0,
                     op: op_mod.Op = op_mod.SUM) -> None:
        self._epoch_for(target)
        data = self._payload(value, "Fetch_and_op")
        if not self._check_target(target):
            return
        self._check_fits("Fetch_and_op", data.numel(), target)
        self._check_host_fold(op, "Fetch_and_op")
        pvar.record("osc_cuda_am_ops")
        Window.Fetch_and_op(self, to_wire(data), result, target, disp, op)

    def Compare_and_swap(self, value, compare, result, target: int,
                         disp: int = 0) -> None:
        self._epoch_for(target)
        v = self._payload(value, "Compare_and_swap")
        c = self._payload(compare, "Compare_and_swap")
        if not self._check_target(target):
            return
        pvar.record("osc_cuda_am_ops")
        Window.Compare_and_swap(self, to_wire(v), to_wire(c), result,
                                target, disp)

    def Rput(self, buf, target: int, disp: int = 0):
        if not self._check_target(target):
            return self._completed()
        # request-based RMA is passive-target only (MPI-3.1 §11.3.5)
        if target not in self._granted:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Rput on {self.name}: no passive-target (Lock) epoch covers "
                f"rank {target}")
        return super().Rput(buf, target, disp)

    def Rget(self, buf, target: int, disp: int = 0):
        if not self._check_target(target):
            return self._completed()
        if target not in self._granted:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Rget on {self.name}: no passive-target (Lock) epoch covers "
                f"rank {target}")
        self._check_fits("Rget", _numel(buf), target)
        return super().Rget(buf, target, disp)

    # -- synchronization ------------------------------------------------
    def Fence(self) -> None:
        """Active-target fence: flush the AM-plane ops, run this epoch's
        queued descriptors as coloured rounds, moved in exchanges, then
        barrier. The first Fence opens the epoch chain (nothing queued by
        definition)."""
        pvar.record("osc_cuda_fence")
        self._epoch_event("fence", "enter")
        tok = _flight_slot(f"osc_cuda_fence win={self.name}",
                           getattr(self.comm, "cid", -1))
        rec = _trace.RECORDER
        t0 = _trace.now() if rec is not None else 0
        try:
            self.Flush_all()
            self._join()
            if self._fence_open:
                with self._on_stream():
                    self._flush_fence()
            self._publish()
            self.comm.coll.barrier(self.comm)
        finally:
            _flight_exit(tok)
        if rec is not None:
            rec.record("epoch", "osc_cuda", t0, _trace.now(),
                       {"op": "fence", "win": self.name})
        self._fence_open = True
        self._epoch_event("fence", "exit")

    def Lock(self, target: int, lock_type: str = LOCK_EXCLUSIVE) -> None:
        self._join()
        tok = _flight_slot(f"osc_cuda_lock win={self.name} peer={target}",
                           getattr(self.comm, "cid", -1))
        try:
            super().Lock(target, lock_type)
        finally:
            _flight_exit(tok)
        self._lock_t0[target] = _trace.now()

    def Unlock(self, target: int) -> None:
        if target not in self._granted:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Unlock on {self.name}: rank {target} is not locked by this "
                "origin")
        tok = _flight_slot(f"osc_cuda_unlock win={self.name} peer={target}",
                           getattr(self.comm, "cid", -1))
        try:
            super().Unlock(target)
        finally:
            _flight_exit(tok)
        t0 = self._lock_t0.pop(target, None)
        rec = _trace.RECORDER
        if rec is not None:
            t1 = _trace.now()
            rec.record("epoch", "osc_cuda", t1 if t0 is None else t0, t1,
                       {"op": "passive", "win": self.name, "peer": target})

    def Post(self, group_ranks: List[int]) -> None:
        self._join()
        super().Post(group_ranks)

    def Start(self, group_ranks: List[int]) -> None:
        self._join()
        tok = _flight_slot(
            f"osc_cuda_start win={self.name} peer={list(group_ranks)}",
            getattr(self.comm, "cid", -1))
        try:
            super().Start(group_ranks)
        finally:
            _flight_exit(tok)

    def Complete(self) -> None:
        if self._access_group is None:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Complete on {self.name} without a matching Start")
        tok = _flight_slot(
            f"osc_cuda_complete win={self.name} "
            f"peer={list(self._access_group)}",
            getattr(self.comm, "cid", -1))
        try:
            super().Complete()
        finally:
            _flight_exit(tok)

    def Wait(self) -> None:
        tok = _flight_slot(
            f"osc_cuda_wait win={self.name} "
            f"peer={list(self._exposure_group or [])}",
            getattr(self.comm, "cid", -1))
        try:
            super().Wait()
        finally:
            _flight_exit(tok)

    def Free(self) -> None:
        if self._fput or self._fget:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Free on {self.name} with {len(self._fput)} put / "
                f"{len(self._fget)} get descriptors still queued — close "
                "the fence epoch first")
        super().Free()

    # -- target-side data path (kernel applies and reads) ---------------
    def _from_wire(self, data: np.ndarray) -> torch.Tensor:
        """An AM payload as a tensor of the window's dtype on its device
        (a host-to-device copy on the window's stream)."""
        t = _tensor_bits(np.asarray(data).reshape(-1), self._win.dtype)
        return t.to(self._win.device) if self._win.is_cuda else t

    def _apply_local(self, data, disp: int, kind: str,
                     stride: int = 1) -> None:
        """Apply one landed payload to the window: K7 for stride 1, K8
        otherwise. The caller holds ``_local_mutex`` (the Accumulate
        atomicity discipline)."""
        with self._on_stream():
            O.apply(self._win, self._from_wire(data), int(disp), kind,
                    int(stride))

    def _target_view(self, disp: int, count: int, dtstr: str,
                     stride: int = 1) -> np.ndarray:
        """K9's read of ``count`` elements at element ``disp`` (and
        ``stride``) into a fresh tensor, copied to the host on the
        window's stream after every earlier apply (the reply's payload)."""
        if count == 0:
            return to_wire(self._win[:0])
        with self._on_stream():
            out = torch.empty(count, dtype=self._win.dtype,
                              device=self._win.device)
            return to_wire(O.rma_read(self._win, int(disp), int(stride),
                                      out))

    def _target_put(self, disp: int, data: np.ndarray) -> None:
        with self._local_mutex:
            self._apply_local(data, disp, "put")

    def _target_acc(self, disp: int, opname: str, data: np.ndarray,
                    locked: bool = False) -> None:
        ctx = self._local_mutex if not locked else None
        if ctx:
            ctx.acquire()
        try:
            if opname == "MPI_NO_OP":
                return
            kind = "replace" if opname == "MPI_REPLACE" \
                else self._acc_kind(opname)
            if kind in O.ELEMENTWISE:
                self._apply_local(data, disp, kind)
                return
            # host-assisted: the op folds on the host (the host window's
            # operand order, np_fn(data, current)); the result replaces
            # the slice through K7
            cur = self._target_view(disp, data.size, data.dtype.str)
            fn = op_mod.BUILTIN[opname].np_fn
            self._apply_local(fn(data.reshape(-1).astype(cur.dtype), cur),
                              disp, "replace")
        finally:
            if ctx:
                ctx.release()

    def _fill(self, buf, data: np.ndarray) -> None:
        """A reply (the window's dtype, bfloat16 as its bits) into the
        origin's result buffer, cast to its dtype as the reference's
        ``astype`` casts."""
        vals = _tensor_bits(data, self._win.dtype)
        if isinstance(buf, torch.Tensor):
            buf.view(-1)[:vals.numel()].copy_(vals)
            return
        flat = np.asarray(buf).reshape(-1)
        if flat.dtype.name == "bfloat16" and \
                self._win.dtype == torch.bfloat16:
            flat.view(np.uint16)[:data.size] = data
            return
        if self._win.dtype == torch.bfloat16:
            vals = vals.float()
        flat[:data.size] = vals.numpy().astype(flat.dtype, copy=False)

    def _handle(self, msg: tuple, src: int) -> None:
        kind = msg[0]
        if kind == "puts":  # strided put: K8, not a host view
            _, disp, stride, data = msg
            if data.size:
                with self._local_mutex:
                    self._apply_local(data, disp, "put", stride)
            self._send(src, ("ack",))
        elif kind == "cas":  # K9 read, a host compare, a K7 replace
            _, req_id, disp, compare, value = msg
            with self._local_mutex:
                old = self._target_view(disp, 1, value.dtype.str)
                if bool(_tensor_bits(old, self._win.dtype)[0]
                        == _tensor_bits(compare, self._win.dtype)[0]):
                    self._apply_local(value[:1], disp, "replace")
            self._send(src, ("get_reply", req_id, old))
        else:
            super()._handle(msg, src)

    # -- the fence flush ------------------------------------------------
    def _flush_fence(self) -> None:
        fence_flush(self.comm, self._target, self._fput, self._fget)
        self._fput = []
        self._fget = []


# ---------------------------------------------------------------------------
# a fence epoch's exchanges, shared by CudaWindow and the device-epoch
# window (osc/device_epoch.py): the window comm, the window's Target (its
# flat tensor is ``target.window``) and the epoch's descriptor queues


def _rounds(edges):
    """Group same-nelems edges (sorted by nelems), colour each group into
    partial matchings — edges are (src, dst, disp, nelems, ...)."""
    by_n: dict = {}
    for e in edges:
        by_n.setdefault(e[3], []).append(e)
    for n, group in sorted(by_n.items()):
        for rnd in _color(group):
            yield n, rnd


def _exchanges(comm, win: torch.Tensor, edges):
    """The reference's rounds of these edges, in its order, cut into
    exchanges: yields each exchange's edges (round order) with their
    :func:`exchange_layout`."""
    rounds = [rnd for _n, rnd in _rounds(edges)]
    pvar.record("osc_cuda_rounds", len(rounds))
    es = win.element_size()
    cuts = plan_exchanges([[(e[0], e[3] * es) for e in rnd]
                           for rnd in rounds], EXCHANGE_BYTES)
    for a, b in cuts:
        pvar.record("osc_cuda_exchanges")
        run = [e for rnd in rounds[a:b] for e in rnd]
        yield run, exchange_layout(run, comm.size)


def _arena(comm, win: torch.Tensor, totals: List[int]):
    return _coll_cuda._arena(comm, "osc", max(totals) * win.element_size())


def fence_flush(comm, target: O.Target, fput, fget) -> None:
    """Run a closing fence's queued descriptors (collective): one
    metadata allgather of every rank's descriptors, then every put before
    every get, each as the reference's coloured rounds moved in
    exchanges. ``fput`` holds this rank's puts ``(target, disp, payload,
    kind, stride)`` (payloads of the window's dtype), ``fget`` its gets
    ``(GetHandle, target, disp, nelems, stride)``; the caller empties
    them."""
    put_desc = [(t, d, a.numel(), k, s) for t, d, a, k, s in fput]
    get_desc = [(t, d, n, s) for _h, t, d, n, s in fget]
    all_desc = comm.coll.allgather_obj(comm, (put_desc, get_desc))
    puts = [(o, t, d, n, k, s)
            for o, (pd, _) in enumerate(all_desc)
            for t, d, n, k, s in pd]
    gets = [(o, t, d, n, s)
            for o, (_, gd) in enumerate(all_desc)
            for t, d, n, s in gd]
    tm = _mon.TRAFFIC
    if tm is not None:
        # the flush's wire bytes per peer: puts I originate, gets I serve
        # (osc/pallas.py:613-626)
        wire = [(o, t, n) for o, t, _d, n, _k, _s in puts] \
            + [(t, o, n) for o, t, _d, n, _s in gets]
        for peer, b in _algo.rma_per_peer(
                comm.rank, wire, target.window.element_size()).items():
            tm.count("osc", _mon.world_rank(comm, peer), int(b))
    if puts:
        _fence_puts(comm, target, fput, puts)
    if gets:
        _fence_gets(comm, target, fget, gets)


def _fence_puts(comm, target: O.Target, fput, puts) -> None:
    """Every rank's puts ``(origin, target, disp, nelems, kind, stride)``,
    in the allgathered order: each origin stages its payloads (``fput``,
    this rank's queue), each target applies what it receives in round
    order."""
    me, win = comm.rank, target.window
    dt = win.dtype
    queued: Dict[tuple, deque] = {}
    for t, dd, a, k, st in fput:
        queued.setdefault((t, dd, a.numel(), k, st), deque()).append(a)
    for run, (offs, totals, _blocks) in _exchanges(comm, win, puts):
        # pop MY first queued op matching each descriptor, round order
        mine = {j: queued[(d, disp, n, kind, stride)].popleft()
                for j, (s, d, disp, n, kind, stride) in enumerate(run)
                if s == me}
        sent = sorted(mine, key=offs.__getitem__)  # region order
        incoming = [j for j, e in enumerate(run) if e[1] == me]
        srcs = sorted({run[j][0] for j in incoming})

        def stage(region):
            _stage(region.view(dt), [mine[j] for j in sent])

        def land(regions):
            bases = [regions[p].view(dt) for p in srcs]
            at = {p: i for i, p in enumerate(srcs)}
            target.apply(bases, [
                (at[run[j][0]], offs[j], run[j][3], run[j][2],
                 run[j][5], run[j][4]) for j in incoming])

        _arena(comm, win, totals).exchange(stage, {run[j][1] for j in sent},
                                           land, srcs)


def _fence_gets(comm, target: O.Target, fget, gets) -> None:
    """Every rank's gets ``(origin, target, disp, nelems, stride)``: each
    target stages the rows it serves (one K9 batch), each origin lands
    every source's block with one grouped K10 launch and fills its
    handles (``fget``, this rank's queue) in order."""
    # data flows target -> origin: edges (src=target, dst=origin)
    me, win = comm.rank, target.window
    dt = win.dtype
    holders: Dict[tuple, deque] = {}
    for h, t, d, n, st in fget:
        holders.setdefault((t, d, n, st), deque()).append(h)
    edges = [(t, o, d, n, s) for o, t, d, n, s in gets]
    for run, (offs, totals, blocks) in _exchanges(comm, win, edges):
        served = sorted((j for j, e in enumerate(run) if e[0] == me),
                        key=offs.__getitem__)
        srcs = sorted({e[0] for e in run if e[1] == me})
        # my incoming blocks, one after another in source order
        at, n_in = {}, 0
        for p in srcs:
            at[p] = n_in - blocks[(p, me)][0]
            n_in += blocks[(p, me)][1]

        def stage(region):  # I am the target: every row I serve
            target.read([(run[j][2], run[j][4], run[j][3], offs[j])
                         for j in served], region.view(dt))

        def land(regions):
            got = torch.empty(n_in, dtype=dt, device=win.device)
            pulls = []  # every source's block: one grouped K10 launch
            for p in srcs:
                start, n = blocks[(p, me)]
                pulls.append((regions[p].view(dt)[start:start + n],
                              got[at[p] + start:at[p] + start + n]))
            O.rma_permute_recv_batch(pulls)
            for j, (s, o, disp, n, stride) in enumerate(run):
                if o == me:  # the first open handle of this read
                    h = holders[(s, disp, n, stride)].popleft()
                    h.array = got[at[s] + offs[j]:at[s] + offs[j] + n]

        _arena(comm, win, totals).exchange(stage, {run[j][1] for j in served},
                                           land, srcs)


def _stage(region: torch.Tensor, payloads: List[torch.Tensor]) -> None:
    """Lay payloads end to end at the start of a typed region: one
    ``torch.cat`` when they all lie on the region's device, else a copy
    each (a host operand on a card's window)."""
    n = sum(p.numel() for p in payloads)
    if all(p.device == region.device for p in payloads):
        torch.cat(payloads, out=region[:n])
        return
    at = 0
    for p in payloads:
        region[at:at + p.numel()].copy_(p)
        at += p.numel()


def plan_exchanges(rounds, budget: int) -> List[Tuple[int, int]]:
    """Cut consecutive rounds into exchanges: ``rounds[i]`` lists the
    ``(rank, bytes)`` each rank stages in round i. An exchange is as long
    as keeps every rank's staged bytes within ``budget``, and holds at
    least one round (a round above the budget runs alone). Returns
    ``(start, stop)`` round indices; every rank computes the same cuts
    from the same allgathered descriptors."""
    cuts, start, staged = [], 0, {}
    for i, rnd in enumerate(rounds):
        if i > start and any(staged.get(p, 0) + b > budget for p, b in rnd):
            cuts.append((start, i))
            start, staged = i, {}
        for p, b in rnd:
            staged[p] = staged.get(p, 0) + b
    if rounds:
        cuts.append((start, len(rounds)))
    return cuts


def exchange_layout(run, n: int):
    """Where each payload of an exchange lies in its source's region:
    ``run`` holds the exchange's edges ``(src, dst, disp, nelems, ...)`` in
    round order. A source lays its payloads end to end, grouped by
    destination in rank order and in round order within. Returns (element
    offset of each edge, elements each rank stages, ``{(src, dst):
    (start, elements)}`` of each source's block for each destination)."""
    offs, totals, blocks = [0] * len(run), [0] * n, {}
    for j in sorted(range(len(run)), key=lambda j: (run[j][0], run[j][1],
                                                     j)):
        s, d, nel = run[j][0], run[j][1], run[j][3]
        offs[j] = totals[s]
        start, cnt = blocks.get((s, d), (totals[s], 0))
        blocks[(s, d)] = (start, cnt + nel)
        totals[s] += nel
    return offs, totals, blocks


def _window_ok(base, disp_unit: int) -> bool:
    return bool(
        isinstance(base, torch.Tensor) and device_plane.active()
        and base.device == device_plane.device()
        and base.dtype in _SUPPORTED_DTYPES and base.numel() > 0
        and disp_unit in (1, base.element_size()))


def maybe_window(comm, base, disp_unit: int = 1,
                 info=None) -> Optional[CudaWindow]:
    """The creation-time selection ``osc.win_create`` calls (collective):
    None when the component is off; a :class:`CudaWindow` when every rank
    passes a supported tensor on its device-plane device (agreed by one
    metadata allgather: one dtype on every rank; per-rank sizes are fine);
    otherwise the fallthrough is counted and None returned on every rank,
    so ``win_create`` serves the host window."""
    if _enable_var.get() != "on":
        return None
    ok = _window_ok(base, disp_unit)
    dt = _dtype_name(base.dtype) if isinstance(base, torch.Tensor) else ""
    meta = comm.coll.allgather_obj(comm, (ok, dt))
    if not all(m[0] for m in meta) or len({m[1] for m in meta}) != 1:
        dtypes = sorted({m[1] or "<host buffer>" for m in meta})
        _fallthrough_note(
            "win_create",
            f"unsupported or rank-asymmetric window (dtypes {dtypes}; "
            f"supported {sorted(map(_dtype_name, _SUPPORTED_DTYPES))}, "
            "device tensors only)")
        return None
    return CudaWindow(comm, base, disp_unit, info=info)


def win_create_cuda(comm, base, disp_unit: int = 1,
                    info=None) -> CudaWindow:
    """Create a device-resident window unconditionally (collective; every
    rank passes a supported tensor) — the explicit spelling when the
    cvar-gated :func:`maybe_window` selection is not wanted."""
    if not _window_ok(base, disp_unit):
        raise errors.MPIError(
            errors.ERR_ARG,
            "win_create_cuda needs a float32, bfloat16 or int32 tensor on "
            "this rank's device-plane device and disp_unit 1 or its item "
            f"size (got {getattr(base, 'dtype', type(base).__name__)} on "
            f"{getattr(base, 'device', '-')}, disp_unit {disp_unit})")
    return CudaWindow(comm, base, disp_unit, info=info)
