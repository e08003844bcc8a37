"""One-sided communication (MPI RMA windows).

Reference: ompi/mca/osc/ (osc.h module interface; osc/rdma implements
windows over BTL remote atomics, osc_rdma_lock.h:26-61 exclusive / shared
locks) and the JAX package's ``ompi_tpu.osc``. As there, every window
runs an active-message (AM) service on a private duplicated
communicator, driven by the progress engine: origin calls send their
operations as objects over ob1's object channel (tag
:data:`_SERVICE_TAG`), and the target applies them when it enters the
library. Operations are ordered per origin-target pair (the transports
deliver per-pair FIFO), so same-origin accumulates apply in order and a
flush or unlock acknowledgement implies that every earlier operation of
that origin is applied.

Epochs: fence, lock / unlock (and lock_all), flush (and flush_all),
post / start / complete / wait (PSCW), the request-based Rput / Rget.

The host :class:`Window` addresses bytes (``disp * disp_unit``) of a
numpy buffer. A tensor base is the reference's documented staging: the
target-side storage is a host mirror, tensor origins are copied to the
host on entry, a tensor template given to Get is filled in place and
returned, and :meth:`Window.device_array` re-uploads the mirror only when
RMA traffic dirtied it. numpy holds no bfloat16: a bfloat16 tensor moves
as its bits (put, REPLACE and NO_OP), and a fold of bfloat16 raises
``ERR_NOT_SUPPORTED``.

:func:`win_create` serves a :class:`~ompi_tpu_torch.osc.cuda.CudaWindow`
where ``osc.cuda.maybe_window`` takes the buffer (``--mca osc_cuda on``)
and this window otherwise. Also here: :class:`DynamicWindow` (Attach /
Detach), :class:`SharedWindow` (a /dev/shm segment a rank,
``Shared_query``), :func:`win_allocate`, :func:`win_allocate_shared` and
:func:`win_create_dynamic`.

``win_create_device`` (re-exported from :mod:`.device_epoch`) serves the
compiled-fence :class:`~ompi_tpu_torch.osc.device_epoch.DeviceEpochWindow`.

Every window carries an errhandler (``ERRORS_ARE_FATAL`` by default,
``Set_errhandler`` / ``Get_errhandler``) and an info (``Set_info`` /
``Get_info`` and the creation's ``info``, whose ``mpi_memory_alloc_kinds``
request is answered with the granted subset). A target rank outside the
window is ``ERR_RANK`` through the errhandler (:meth:`Window._check_target`,
called by every RMA op): a callback that returns makes the op a no-op that
moves nothing, and a request-based op returns a completed request. Every
service message counts on the monitoring plane (ctx
``osc``, its arrays' bytes) in :meth:`Window._send`; every epoch
transition emits the MPI_T event ``osc_epoch_transition`` (reference
``osc/__init__.py:578-687``). A device window's synchronisation calls are
flight-recorder entries and trace ``epoch`` spans (``osc/cuda.py``, the
reference's osc/pallas.py:127-140, :367-455).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod, pml
from ompi_tpu_torch.attr import AttrHost
from ompi_tpu_torch.info import apply_memkinds, as_info
from ompi_tpu_torch.core import (events as mpit_events, output, progress,
                                 pvar)
from ompi_tpu_torch.monitoring import matrix as _mon
from ompi_tpu_torch.pml.request import ANY_SOURCE, Request

_out = output.stream("osc")

_SERVICE_TAG = -64  # on the window's private dup comm

LOCK_EXCLUSIVE = "exclusive"
LOCK_SHARED = "shared"

#: ops that pick an operand and fold nothing (a bfloat16 operand moves
#: as its bits)
_PICK_OPS = ("MPI_REPLACE", "MPI_NO_OP")


def to_wire(t: torch.Tensor) -> np.ndarray:
    """A tensor's contents as a fresh C-contiguous numpy array on the
    host: a device-to-host copy for a CUDA tensor (on the current
    stream), bfloat16 as its uint16 bits."""
    bits = t.dtype == torch.bfloat16
    t = t.detach().view(torch.int16) if bits else t.detach()
    a = t.contiguous().cpu().numpy() if t.is_cuda else np.array(t.numpy())
    return a.view(np.uint16) if bits else a


def _tensor_bits(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """numpy -> a CPU tensor of ``dtype``; a bfloat16 tensor from the
    uint16 bits numpy carries it in."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind in "ui":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _wire_dtype(buf) -> np.dtype:
    """The numpy dtype ``buf``'s elements travel as (bfloat16: uint16)."""
    if isinstance(buf, torch.Tensor):
        if buf.dtype == torch.bfloat16:
            return np.dtype(np.uint16)
        return np.dtype(torch.empty(0, dtype=buf.dtype).numpy().dtype)
    return np.asarray(buf).dtype


def _numel(buf) -> int:
    return buf.numel() if isinstance(buf, torch.Tensor) \
        else int(np.asarray(buf).size)


def _is_bf16(buf) -> bool:
    return isinstance(buf, torch.Tensor) and buf.dtype == torch.bfloat16


class _WinRequest(Request):
    """Request handle for Rput / Rget (completion = remote ack / data)."""

    def __init__(self, win: "Window") -> None:
        super().__init__()
        self.win = win

    def test(self) -> bool:
        if not self.completed:
            progress.progress()
        return self.completed

    def wait(self, timeout: Optional[float] = None):
        progress.wait_until(lambda: self.completed, timeout)
        return self.status


class Window(AttrHost):
    """MPI_Win over a local numpy buffer (Win_create semantics).

    A tensor ``base`` is staged: the authoritative target-side storage is
    a host mirror (a copy; the caller's tensor is untouched), tensor
    origins of Put / Accumulate are copied to the host on entry, a tensor
    given to Get is filled in place, and :meth:`device_array` returns the
    window contents as a tensor like ``base`` (re-uploaded only when RMA
    traffic dirtied the mirror)."""

    def __init__(self, comm, base, disp_unit: int = 1, info=None) -> None:
        # a mpi_memory_alloc_kinds request is answered with the granted
        # subset (info_memkind.c)
        self.info = apply_memkinds(as_info(info))
        self.errhandler = errors.ERRORS_ARE_FATAL  # the reference default
        self.comm = comm.dup()  # private comm: tag isolation
        self._dev_like = None
        self._dev_cache = None
        self._dirty = False
        self.base = self._adopt(base)
        self.disp_unit = disp_unit
        self.rank = self.comm.rank
        self.size = self.comm.size
        # exchange per-rank (nbytes, disp_unit): MPI_Win_get_attr data
        self.peer_info: List[Tuple[int, int]] = \
            self.comm.coll.allgather_obj(self.comm,
                                         (self._nbytes(), disp_unit))
        self.attrs: Dict[Any, Any] = {}
        self.name = f"win#{self.comm.cid}"

        # target-side state
        self._lock_mode: Optional[str] = None
        self._lock_holders: Set[int] = set()
        self._lock_queue: List[Tuple[str, int]] = []
        self._local_mutex = threading.Lock()
        # origin-side state
        self._next_id = 0
        self._pending: Dict[int, Tuple[str, Any]] = {}  # id -> (kind, ctx)
        self._targets: Set[int] = set()        # peers with ops outstanding
        # put/acc only: the ops whose target replies with an 'ack';
        # get-type ops complete via 'get_reply' and must not raise the
        # Rput completion threshold (they would make it unreachable)
        self._ackable_counts: Dict[int, int] = {}
        self._ack_counts: Dict[int, int] = {}  # target -> acks seen
        self._in_progress = False
        self._granted: Set[int] = set()        # targets we hold a lock on
        self._flush_acked: Set[int] = set()
        self._unlock_acked: Set[int] = set()
        self._posted_from: Set[int] = set()    # PSCW: posts received
        self._completes_from: Set[int] = set()
        self._exposure_group: Optional[List[int]] = None
        self._access_group: Optional[List[int]] = None

        self._service_req = None
        self._closed = False
        self._progress_cb = self._progress
        progress.register(self._progress_cb)
        self.comm.coll.barrier(self.comm)  # creation is collective

    # Attribute caching (Set/Get/Delete_attr) comes from AttrHost; the
    # predefined WIN_BASE / WIN_SIZE / WIN_DISP_UNIT / ... answer from
    # the window's own fields (attribute_predefined.c:119-195).
    _attr_kind = "win"

    def _adopt(self, base):
        """The target-side storage for ``base``: a numpy buffer itself,
        a tensor's host mirror (staging)."""
        if isinstance(base, torch.Tensor):
            self._dev_like = base
            return to_wire(base)
        return base

    def _nbytes(self) -> int:
        return 0 if self.base is None else int(self.base.nbytes)

    # ------------------------------------------------------------------
    # service plumbing

    def _post_service_recv(self) -> None:
        self._service_req = pml.current().irecv_obj(self.comm, ANY_SOURCE,
                                                    _SERVICE_TAG)

    def _progress(self) -> int:
        if self._closed:
            raise StopIteration
        if self._in_progress:
            # _handle may block (a reply send spinning the progress
            # engine), which re-enters this callback; one service loop per
            # window at a time keeps the recursion bounded.
            return 0
        if self._service_req is None:
            self._post_service_recv()
        events = 0
        self._in_progress = True
        try:
            # Poll .completed directly: the enclosing sweep already drives
            # the btl / pml progress; calling test() here would re-enter
            # progress.progress() and recurse without bound.
            while self._service_req.completed:
                msg = self._service_req._obj
                src = self._service_req.status.source
                self._post_service_recv()
                self._handle(msg, src)
                events += 1
        finally:
            self._in_progress = False
        return events

    def _send(self, target: int, msg: tuple) -> None:
        tm = _mon.TRAFFIC
        if tm is not None:
            # every service message (origin requests and the target's
            # replies) funnels through here; payload = the arrays riding
            # the message (osc/__init__.py:188-197)
            tm.count("osc", _mon.world_rank(self.comm, target),
                     sum(getattr(m, "nbytes", 0) for m in msg))
        pml.current().send_obj(self.comm, msg, target, _SERVICE_TAG)

    # ------------------------------------------------------------------
    # target-side message handling

    def _handle(self, msg: tuple, src: int) -> None:
        kind = msg[0]
        if kind == "put":
            _, disp, data = msg
            self._target_put(disp, data)
            self._send(src, ("ack",))
        elif kind == "puts":  # strided put (shmem_iput transport)
            _, disp, stride, data = msg
            if data.size:
                with self._local_mutex:
                    view = self._target_view(disp, data.size,
                                             data.dtype.str, stride)
                    view[:] = data.reshape(-1)
                    self._dirty = True
            self._send(src, ("ack",))
        elif kind == "gets":  # strided get (shmem_iget transport)
            _, req_id, disp, stride, count, dtstr = msg
            view = (self._target_view(disp, count, dtstr, stride)
                    if count else np.empty(0, np.dtype(dtstr)))
            self._send(src, ("get_reply", req_id, np.array(view)))
        elif kind == "get":
            _, req_id, disp, count, dtstr = msg
            flat = self._target_view(disp, count, dtstr)
            self._send(src, ("get_reply", req_id, np.array(flat)))
        elif kind == "acc":
            _, disp, opname, data = msg
            self._target_acc(disp, opname, data)
            self._send(src, ("ack",))
        elif kind in ("get_acc", "fetch_op"):
            _, req_id, disp, opname, data = msg
            with self._local_mutex:
                old = np.array(self._target_view(
                    disp, data.size, data.dtype.str))
                self._target_acc(disp, opname, data, locked=True)
            self._send(src, ("get_reply", req_id, old))
        elif kind == "cas":
            _, req_id, disp, compare, value = msg
            with self._local_mutex:
                view = self._target_view(disp, 1, value.dtype.str)
                old = np.array(view)
                if old[0] == compare[0]:
                    view[0] = value[0]
                    self._dirty = True
            self._send(src, ("get_reply", req_id, old))
        elif kind == "lock_req":
            _, mode = msg
            self._try_grant(mode, src)
        elif kind == "unlock_req":
            self._release(src)
            self._publish()
            self._send(src, ("unlock_ack",))
        elif kind == "flush_req":
            # per-pair FIFO: every op src issued before this is applied
            self._publish()
            self._send(src, ("flush_ack",))
        elif kind == "post":
            self._posted_from.add(src)
        elif kind == "complete":
            self._completes_from.add(src)
        elif kind == "ack":
            self._ack_counts[src] = self._ack_counts.get(src, 0) + 1
        elif kind == "flush_ack":
            self._flush_acked.add(src)
        elif kind == "unlock_ack":
            self._unlock_acked.add(src)
        elif kind == "lock_grant":
            self._granted.add(src)
        elif kind == "get_reply":
            _, req_id, data = msg
            _k, (buf, req) = self._pending.pop(req_id)
            self._fill(buf, data)
            if req is not None:
                req.completed = True
        else:
            _out.verbose(1, "unknown osc message %r", kind)

    def _publish(self) -> None:
        """Make the window's applied writes visible to the caller (the
        host window's writes are host stores: nothing to do)."""

    def _fill(self, buf, data: np.ndarray) -> None:
        """Write a reply's elements into the origin's result buffer: a
        numpy buffer or a tensor, in place (bfloat16 from its bits)."""
        n = data.size
        if isinstance(buf, torch.Tensor):
            buf.view(-1)[:n].copy_(_tensor_bits(data, buf.dtype))
            return
        flat = np.asarray(buf).reshape(-1)
        if flat.dtype.name == "bfloat16" and data.dtype == np.uint16:
            flat.view(np.uint16)[:n] = data
            return
        flat[:n] = data.astype(flat.dtype, copy=False)

    def _target_view(self, disp: int, count: int, dtstr: str,
                     stride: int = 1):
        """count elements at element-stride ``stride`` from byte
        displacement disp. The byte slice is taken before .view(dt):
        viewing the whole window tail would need its length to be an
        itemsize multiple, which arbitrary disp / window sizes are not."""
        dt = np.dtype(dtstr)
        start = disp * self.disp_unit
        span = ((count - 1) * stride + 1) * dt.itemsize if count else 0
        flat = self.base.reshape(-1).view(np.uint8)[start:start + span]
        return flat.view(dt)[::stride]

    def _target_put(self, disp: int, data: np.ndarray) -> None:
        with self._local_mutex:
            view = self._target_view(disp, data.size, data.dtype.str)
            view[:] = data.reshape(-1)
            self._dirty = True

    def _target_acc(self, disp: int, opname: str, data: np.ndarray,
                    locked: bool = False) -> None:
        ctx = self._local_mutex if not locked else None
        op = op_mod.BUILTIN[opname]
        if ctx:
            ctx.acquire()
        try:
            if opname == "MPI_NO_OP":
                return  # MPI-3.1 §11.3.4: no-op reads (Fetch_and_op /
                # Get_accumulate) must not modify the target; the
                # generic fold below would write the origin operand
            view = self._target_view(disp, data.size, data.dtype.str)
            if opname == "MPI_REPLACE":
                view[:] = data.reshape(-1)
            else:
                view[:] = op.np_fn(data.reshape(-1), view)
            self._dirty = True
        finally:
            if ctx:
                ctx.release()

    # lock management (reference: osc_rdma_lock.h exclusive / shared) ---
    def _try_grant(self, mode: str, src: int) -> None:
        grantable = (
            self._lock_mode is None
            or (mode == LOCK_SHARED and self._lock_mode == LOCK_SHARED))
        if grantable:
            self._lock_mode = mode
            self._lock_holders.add(src)
            self._send(src, ("lock_grant",))
        else:
            self._lock_queue.append((mode, src))

    def _release(self, src: int) -> None:
        self._lock_holders.discard(src)
        if not self._lock_holders:
            self._lock_mode = None
            # grant queued requests (a shared batch or one exclusive)
            while self._lock_queue:
                mode, nxt = self._lock_queue[0]
                if self._lock_mode is None or (
                        mode == LOCK_SHARED
                        and self._lock_mode == LOCK_SHARED):
                    self._lock_queue.pop(0)
                    self._lock_mode = mode
                    self._lock_holders.add(nxt)
                    self._send(nxt, ("lock_grant",))
                    if mode == LOCK_EXCLUSIVE:
                        break
                else:
                    break

    # ------------------------------------------------------------------
    # origin-side API

    def _count_op(self, target: int, ackable: bool = False) -> None:
        self._targets.add(target)
        if ackable:
            self._ackable_counts[target] = \
                self._ackable_counts.get(target, 0) + 1

    def _local_or_send(self, target: int, msg: tuple) -> None:
        if target == self.rank:
            self._handle(msg, self.rank)
        else:
            self._send(target, msg)

    # -- the errhandler and info planes ---------------------------------
    def Set_errhandler(self, eh) -> None:
        """MPI_Win_set_errhandler: a string mode or an Errhandler
        (Win_create_errhandler)."""
        self.errhandler = eh

    def Get_errhandler(self):
        return self.errhandler

    def Set_info(self, info) -> None:
        self.info = apply_memkinds(as_info(info))

    def Get_info(self):
        """MPI_Win_get_info: a new Info."""
        return self.info.dup()

    def _check_target(self, target: int) -> bool:
        """Whether an op to ``target`` goes on: a rank outside the window
        is ``RankError`` through the window's errhandler (the
        OMPI_ERRHANDLER_INVOKE at every osc binding's error exit), which
        raises, or returns False when a callback handled it (the op
        recovers as a no-op)."""
        if 0 <= target < self.size:
            return True
        return not errors.dispatch(self, errors.RankError(
            f"RMA target rank {target} out of range for {self.name} "
            f"(size {self.size})"))

    def _completed(self) -> "_WinRequest":
        """The request a recovered request-based op returns."""
        req = _WinRequest(self)
        req.complete()
        return req

    @staticmethod
    def _stage_origin(buf) -> np.ndarray:
        """Origin operands as contiguous numpy arrays: tensors are copied
        to the host on entry (bfloat16 as its bits)."""
        if isinstance(buf, torch.Tensor):
            return to_wire(buf)
        return np.ascontiguousarray(buf)

    @staticmethod
    def _check_fold(buf, op, what: str) -> None:
        """numpy holds no bfloat16: a bfloat16 tensor operand moves as its
        bits, which only the ops that pick an operand may take."""
        if _is_bf16(buf) and getattr(op, "name", op) not in _PICK_OPS:
            raise errors.MPIError(
                errors.ERR_NOT_SUPPORTED,
                f"{what}: {getattr(op, 'name', op)} folds bfloat16, which "
                "the host window holds as its bits (numpy has no bfloat16); "
                "REPLACE and NO_OP move the bits")

    def Put(self, buf, target: int, disp: int = 0) -> None:
        pvar.record("osc_put")
        if not self._check_target(target):
            return
        data = self._stage_origin(buf)
        self._count_op(target, ackable=True)
        self._local_or_send(target, ("put", disp, data))

    def Get(self, buf, target: int, disp: int = 0):
        """A numpy buf is filled in place (returns None); a tensor buf
        is filled in place and returned."""
        pvar.record("osc_get")
        if not self._check_target(target):
            return None
        self._rget(buf, target, disp).wait()
        return buf if isinstance(buf, torch.Tensor) else None

    def device_array(self):
        """The window contents as a tensor like ``base`` (tensor windows
        only). Re-uploads only when RMA traffic dirtied the host mirror
        since the last call: call it at epoch boundaries (after Fence,
        Wait or Unlock) to hand the window back to device code."""
        if self._dev_like is None:
            raise errors.MPIError(
                errors.ERR_WIN,
                "device_array() on a host window: create the window over "
                "a tensor (win_create accepts device buffers)")
        with self._local_mutex:
            dirty, host = self._dirty, np.array(self.base)
            self._dirty = False
        if self._dev_cache is None or dirty:
            like = self._dev_like
            self._dev_cache = _tensor_bits(host, like.dtype).reshape(
                like.shape).to(like.device)
        return self._dev_cache

    def Rput(self, buf, target: int, disp: int = 0) -> Request:
        """The request completes when the put is applied at the target
        (remote ack), stronger than MPI's local-completion minimum."""
        if not self._check_target(target):
            return self._completed()
        self.Put(buf, target, disp)
        want = self._ackable_counts.get(target, 0)
        win = self

        class _R(Request):
            def test(s):
                progress.progress()
                s.completed = win._ack_counts.get(target, 0) >= want
                return s.completed

            def wait(s, timeout=None):
                progress.wait_until(
                    lambda: win._ack_counts.get(target, 0) >= want,
                    timeout)
                s.completed = True
                return s.status

        return _R()

    def Put_strided(self, buf, target: int, disp: int = 0,
                    stride: int = 1) -> None:
        """Elements of buf land at disp, disp+stride, ... (element stride
        in buf's dtype units): the shmem_iput transport, one AM message
        whatever the element count."""
        pvar.record("osc_put")
        if not self._check_target(target):
            return
        data = self._stage_origin(buf)
        self._count_op(target, ackable=True)
        self._local_or_send(target, ("puts", disp, int(stride), data))

    def Get_strided(self, buf, target: int, disp: int = 0,
                    stride: int = 1) -> None:
        """Fills buf with the target's elements at disp, disp+stride, ...
        (the shmem_iget transport)."""
        pvar.record("osc_get")
        if not self._check_target(target):
            return
        req = self._request("get", buf)
        self._count_op(target)
        self._local_or_send(
            target, ("gets", req.req_id, disp, int(stride), _numel(buf),
                     _wire_dtype(buf).str))
        req.wait()

    def _request(self, kind: str, buf) -> _WinRequest:
        req = _WinRequest(self)
        req.req_id = self._alloc_id()
        self._pending[req.req_id] = (kind, (buf, req))
        return req

    def _rget(self, buf, target: int, disp: int) -> _WinRequest:
        req = self._request("get", buf)
        self._count_op(target)
        self._local_or_send(target, ("get", req.req_id, disp, _numel(buf),
                                     _wire_dtype(buf).str))
        return req

    def Rget(self, buf, target: int, disp: int = 0) -> Request:
        if not self._check_target(target):
            return self._completed()
        return self._rget(buf, target, disp)

    def Accumulate(self, buf, target: int, disp: int = 0,
                   op: op_mod.Op = op_mod.SUM) -> None:
        pvar.record("osc_acc")
        if not self._check_target(target):
            return
        self._check_fold(buf, op, "Accumulate")
        data = self._stage_origin(buf)
        self._count_op(target, ackable=True)
        self._local_or_send(target, ("acc", disp, op.name, data))

    def Get_accumulate(self, origin, result, target: int, disp: int = 0,
                       op: op_mod.Op = op_mod.SUM) -> None:
        if not self._check_target(target):
            return
        self._check_fold(origin, op, "Get_accumulate")
        req = self._request("get_acc", result)
        data = self._stage_origin(origin)
        self._count_op(target)
        self._local_or_send(target,
                            ("get_acc", req.req_id, disp, op.name, data))
        req.wait()

    def Fetch_and_op(self, value, result, target: int, disp: int = 0,
                     op: op_mod.Op = op_mod.SUM) -> None:
        if not self._check_target(target):
            return
        self._check_fold(value, op, "Fetch_and_op")
        req = self._request("fetch_op", result)
        v = self._stage_origin(value)
        self._count_op(target)
        self._local_or_send(target,
                            ("fetch_op", req.req_id, disp, op.name, v))
        req.wait()

    def Compare_and_swap(self, value, compare, result, target: int,
                         disp: int = 0) -> None:
        if not self._check_target(target):
            return
        req = self._request("cas", result)
        self._count_op(target)
        self._local_or_send(
            target, ("cas", req.req_id, disp, self._stage_origin(compare),
                     self._stage_origin(value)))
        req.wait()

    def _alloc_id(self) -> int:
        self._next_id += 1
        return self._next_id

    # -- synchronization ------------------------------------------------
    def _epoch_event(self, kind: str, phase: str, peer: int = -1) -> None:
        """The MPI_T event at every epoch transition (the reference
        instruments its whole API surface through SPC,
        ompi_spc.h:46-153)."""
        if mpit_events.active("osc_epoch_transition"):
            mpit_events.emit("osc_epoch_transition", kind=kind,
                             phase=phase, win=self.name, peer=peer)

    def Fence(self) -> None:
        """Active-target fence: flush all, then barrier."""
        pvar.record("osc_fence")
        self._epoch_event("fence", "enter")
        self.Flush_all()
        self.comm.coll.barrier(self.comm)
        self._epoch_event("fence", "exit")

    def Lock(self, target: int, lock_type: str = LOCK_EXCLUSIVE) -> None:
        """Self locks flow through the same message path: the service
        loop is the single serialization point."""
        self._send(target, ("lock_req", lock_type))
        progress.wait_until(lambda: target in self._granted)
        self._epoch_event("lock", "enter", target)

    def Unlock(self, target: int) -> None:
        self._unlock_acked.discard(target)
        self._send(target, ("unlock_req",))
        progress.wait_until(lambda: target in self._unlock_acked)
        self._granted.discard(target)
        self._epoch_event("lock", "exit", target)

    def Lock_all(self) -> None:
        for t in range(self.size):
            self.Lock(t, LOCK_SHARED)

    def Unlock_all(self) -> None:
        for t in range(self.size):
            self.Unlock(t)

    def Flush(self, target: int) -> None:
        if target == self.rank:
            return
        self._flush_acked.discard(target)
        self._send(target, ("flush_req",))
        progress.wait_until(lambda: target in self._flush_acked)

    def Flush_all(self) -> None:
        for t in [t for t in self._targets if t != self.rank]:
            self.Flush(t)

    def Sync(self) -> None:
        """MPI_Win_sync: this window keeps one authoritative copy, so a
        progress sweep (delivering in-flight AM updates) is the whole
        operation."""
        progress.progress()
        self._publish()

    def Get_group(self):
        """MPI_Win_get_group: a new group of the window's comm."""
        return self.comm.Get_group()

    # -- PSCW (generalized active target) -------------------------------
    def Post(self, group_ranks: List[int]) -> None:
        """Expose the window to ``group_ranks`` (MPI_Win_post)."""
        self._exposure_group = list(group_ranks)
        self._completes_from.clear()
        for r in group_ranks:
            if r != self.rank:
                self._send(r, ("post",))
        self._epoch_event("pscw_exposure", "enter")

    def Start(self, group_ranks: List[int]) -> None:
        """Begin an access epoch to ``group_ranks`` (MPI_Win_start)."""
        self._access_group = list(group_ranks)
        need = set(r for r in group_ranks if r != self.rank)
        progress.wait_until(lambda: need <= self._posted_from)
        self._posted_from -= need
        self._epoch_event("pscw_access", "enter")

    def Complete(self) -> None:
        """End the access epoch: flush, notify the targets
        (MPI_Win_complete)."""
        for r in self._access_group or []:
            if r != self.rank:
                self.Flush(r)
                self._send(r, ("complete",))
        self._access_group = None
        self._epoch_event("pscw_access", "exit")

    def Wait(self) -> None:
        """End the exposure epoch (MPI_Win_wait)."""
        need = set(r for r in self._exposure_group or []
                   if r != self.rank)
        progress.wait_until(lambda: need <= self._completes_from)
        self._exposure_group = None
        self._publish()
        self._epoch_event("pscw_exposure", "exit")

    # -------------------------------------------------------------------
    def Free(self) -> None:
        if self.attrs:  # delete callbacks fire before destruction
            from ompi_tpu_torch import attr as _attr

            _attr.delete_attrs(self)
        self.comm.coll.barrier(self.comm)
        self._closed = True
        progress.unregister(self._progress_cb)
        self.comm.free()


class DynamicWindow(Window):
    """MPI_Win_create_dynamic (reference: osc/rdma dynamic windows): a
    window with no initial buffer; memory regions attach and detach at
    run time, and origins address them by the target-side "address"
    ``Attach`` returned (the target ships its addresses to the origins
    itself)."""

    def __init__(self, comm) -> None:
        self._regions: List[Tuple[int, np.ndarray]] = []
        self._next_disp = 16  # 0 stays invalid, like NULL
        super().__init__(comm, None, disp_unit=1)

    def Attach(self, arr: np.ndarray) -> int:
        """Expose ``arr`` (a writable C-contiguous ndarray: RMA lands in
        it directly); returns its address in this window."""
        if not (isinstance(arr, np.ndarray)
                and arr.flags["C_CONTIGUOUS"]):
            raise errors.MPIError(
                errors.ERR_BUFFER,
                "Win_attach needs a C-contiguous ndarray (RMA writes land "
                "in the attached memory itself)")
        with self._local_mutex:
            disp = self._next_disp
            self._regions.append((disp, arr))
            # pad between regions so an out-of-range disp faults instead
            # of silently touching a neighbour
            self._next_disp = disp + arr.nbytes + 64
        return disp

    def Detach(self, arr: np.ndarray) -> None:
        with self._local_mutex:
            self._regions = [(d, a) for d, a in self._regions
                             if a is not arr]

    def _target_view(self, disp: int, count: int, dtstr: str,
                     stride: int = 1):
        dt = np.dtype(dtstr)
        span = ((count - 1) * stride + 1) * dt.itemsize if count else 0
        for start, arr in self._regions:
            if start <= disp and disp + span <= start + arr.nbytes:
                off = disp - start
                flat = arr.view(np.uint8).reshape(-1)[off:off + span]
                return flat.view(dt)[::stride]
        raise errors.MPIError(
            errors.ERR_ARG,
            f"dynamic window {self.name}: [{disp}, {disp + span}) is not "
            "within any attached region")


class SharedWindow(Window):
    """MPI_Win_allocate_shared (reference: osc/sm): the window's local
    region lives in a /dev/shm segment, and :meth:`Shared_query` returns
    a direct load / store numpy view of any peer's region, zero-copy
    same-host RMA. All members must share a host (create the comm with
    ``split_type('shared')``)."""

    def __init__(self, comm, nbytes: int, disp_unit: int = 1) -> None:
        import mmap
        import os

        from ompi_tpu_torch.runtime import rte

        hosts = comm.coll.allgather_obj(comm, rte.hostname())
        if len(set(hosts)) != 1:
            raise errors.MPIError(
                errors.ERR_ARG,
                "Win_allocate_shared: members span hosts "
                f"{sorted(set(hosts))}; use comm.split_type('shared') to "
                "get a node-local communicator first")
        wid = comm.coll.bcast_obj(
            comm, rte.next_id("winshm") if comm.rank == 0 else None, 0)
        # the launcher sweeps the job's ompi_tpu_torch_<jobid>_* files
        self._seg_fmt = os.path.join(
            os.environ.get("OMPI_TPU_SHM_DIR", "/dev/shm"),
            f"ompi_tpu_torch_{rte.jobid}_winshm{wid}_{{}}")
        self._peer_views: Dict[int, np.ndarray] = {}
        fd = os.open(self._seg_fmt.format(comm.rank),
                     os.O_RDWR | os.O_CREAT, 0o600)
        try:
            os.ftruncate(fd, max(nbytes, 1))
            mm = mmap.mmap(fd, max(nbytes, 1))
        finally:
            os.close(fd)
        base = np.frombuffer(mm, dtype=np.uint8, count=nbytes)
        # Window.__init__ ends with a barrier: every segment exists
        # before any Shared_query can map it
        super().__init__(comm, base, disp_unit)

    def Shared_query(self, rank: int):
        """(live numpy view of rank's region, disp_unit): the direct
        load / store path; AM Put / Get still work for uniformity."""
        if rank == self.rank:
            return self.base, self.disp_unit
        view = self._peer_views.get(rank)
        if view is None:
            import mmap
            import os

            # the peer's size: per-rank sizes are legal, and mapping past
            # a smaller peer file would SIGBUS on access
            peer_nbytes = self.peer_info[rank][0]
            fd = os.open(self._seg_fmt.format(rank), os.O_RDWR)
            try:
                mm = mmap.mmap(fd, max(peer_nbytes, 1))
            finally:
                os.close(fd)
            view = np.frombuffer(mm, dtype=np.uint8, count=peer_nbytes)
            self._peer_views[rank] = view
        return view, self.peer_info[rank][1]

    def Free(self) -> None:
        import os

        super().Free()
        try:
            os.unlink(self._seg_fmt.format(self.rank))
        except OSError:
            pass


def win_create(comm, base, disp_unit: int = 1, info=None) -> Window:
    """MPI_Win_create (collective). Under ``--mca osc_cuda on`` the
    device-resident :class:`~ompi_tpu_torch.osc.cuda.CudaWindow` serves a
    supported tensor on every rank's device; everything else, including
    every case its selection counts as a fallthrough, gets the host
    :class:`Window`. ``info``'s memkind request is answered with the
    granted subset (``Get_info``)."""
    from ompi_tpu_torch.osc import cuda as _cuda

    win = _cuda.maybe_window(comm, base, disp_unit, info=info)
    if win is not None:
        return win
    return Window(comm, base, disp_unit, info=info)


def win_allocate_shared(comm, nbytes: int,
                        disp_unit: int = 1) -> SharedWindow:
    """MPI_Win_allocate_shared."""
    return SharedWindow(comm, nbytes, disp_unit)


def win_create_dynamic(comm) -> DynamicWindow:
    """MPI_Win_create_dynamic."""
    return DynamicWindow(comm)


def win_allocate(comm, shape, dtype=np.uint8,
                 disp_unit: Optional[int] = None, info=None) -> Window:
    """MPI_Win_allocate: a zeroed numpy buffer of ``shape``."""
    arr = np.zeros(shape, dtype)
    du = disp_unit if disp_unit is not None else arr.dtype.itemsize
    return Window(comm, arr, du, info=info)


# the compiled-fence device window (active-target fence epochs over
# CudaWindow's exchanges)
from ompi_tpu_torch.osc.device_epoch import (  # noqa: E402,F401
    DeviceEpochWindow, win_create_device)
