"""osc/device_epoch — the compiled-fence device window.

Port of ``ompi_tpu.osc.device_epoch``. The reference batches a fence
epoch's Puts, elementwise Accumulates and Gets on a device-resident window
and lowers them at the closing Fence into edge-coloured ``lax.ppermute``
rounds (payloads stay on the device; only descriptors ride one host
metadata round), applying each round's arrivals as ``.at[]``
scatter-updates. The port runs the same rounds through the machinery of
:class:`~ompi_tpu_torch.osc.cuda.CudaWindow`'s fence
(``osc.cuda.fence_flush``): one ``allgather_obj`` of every rank's
descriptors, every put before every get, each grouped by element count
(sorted) and coloured first-fit in the reference's order
(:func:`_color`), the rounds cut into exchanges over the window comm's
peer-mapped arena; the target applies with K8's grouped kernel (K7 for
contiguous rows of 2**20 elements or more), serves reads with K9, and the
origin lands them with K10's grouped launch. Same-location accumulates
therefore apply in the reference's round order, and the window ends
bitwise equal to the reference's.

Division of labour, as in the reference: this window serves active target
(Fence) only; passive target (Lock / Unlock / Flush) and PSCW (Post /
Start) count ``osc_device_fallbacks``, warn once per (op, reason) and
raise ``ERR_RMA_SYNC``, and an Accumulate op other than sum / replace /
min / max / prod does the same with ``ERR_OP``; the host window
(``osc.win_create``) and ``CudaWindow`` serve those.

Semantics: every rank passes a tensor of the same shape and dtype on its
device-plane device; ``Put`` / ``Accumulate`` record, ``Get(nelems,
target, disp)`` returns a :class:`GetHandle` whose ``.array`` fills at the
closing Fence. The first Fence only opens the epoch; an epoch with no ops
and two fences in a row are legal. ``osc_device_epoch_op`` counts the ops
queued.

Where the port differs from the reference:

- the window is a clone of the creation tensor (the caller's stays as it
  was, as a jax array does), updated in place; ``win.array`` is a view of
  it in the base's shape (read it at epoch boundaries);
- a payload is cast to the window's dtype at the call (``.to(dtype)``;
  the reference casts when its round runs: the same values), and a queued
  payload of the window's dtype is kept by reference: MPI forbids changing
  an origin buffer before the closing fence;
- a numpy base raises ``ERR_BUFFER`` (the reference fails at its first
  ``.at[]``); a base the kernels do not take (a dtype other than float32,
  bfloat16 and int32, an empty tensor, another device, no device plane) or
  shapes and dtypes that differ across ranks raise ``ERR_ARG`` on every
  rank;
- an op whose elements are not all inside the target's window raises
  ``ERR_ARG`` at the call, and a target outside the comm is ``ERR_RANK``
  through the window's errhandler (``ERRORS_ARE_FATAL`` by default,
  ``Set_errhandler``): a callback that returns makes the op a no-op (a
  recovered Get's handle holds an empty tensor after the fence). The
  reference's window has no errhandler: its slice clamps and its update
  fails at the fence.

Each fallback also emits the MPI_T event ``osc_device_fallback`` with the
reference's ``(op, reason)``.

:class:`GetHandle` and :func:`_color` are shared with ``osc/cuda.py``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import events as mpit_events, output, pvar

_out = output.stream("osc_device")

_FALLBACK_EVENT = mpit_events.register_type(
    "osc_device_fallback",
    "a device-epoch window routed an operation to the host path "
    "(non-elementwise accumulate, passive target)",
    ("op", "reason"))

_warned: set = set()

#: the Accumulate ops the fence applies (K7 / K8's elementwise kinds)
_FUSABLE = ("replace", "sum", "min", "max", "prod")


def _fallback(op: str, reason: str) -> None:
    """The device-epoch window cannot serve ``op``; the host window (or
    CudaWindow) must. Counted every time, warned once per (op, reason),
    and emitted as the MPI_T event ``osc_device_fallback``."""
    pvar.record("osc_device_fallbacks")
    key = (op, reason)
    if key not in _warned:
        _warned.add(key)
        _out.verbose(0, "WARNING: device-epoch window %s falls back to the "
                     "host path: %s", op, reason)
    if mpit_events.active("osc_device_fallback"):
        mpit_events.emit("osc_device_fallback", op=op, reason=reason)


class GetHandle:
    """Result handle for an epoch Get: ``.array`` is a fresh device tensor
    after the closing Fence (never a view of an arena slot, which the next
    round reuses)."""

    __slots__ = ("array",)

    def __init__(self) -> None:
        self.array = None


def _color(edges) -> List[list]:
    """Greedy partition of directed edges ``(src, dst, ...)`` into partial
    matchings (unique src and unique dst per round), first fit in edge
    order — each round is one valid permutation. The order decides the
    order of same-location accumulates, so it is the reference's exactly
    (``ompi_tpu.coll.xla_neighbor._color``, xla_neighbor.py:127-144): its
    passes (each pass takes, in order, every remaining edge whose src and
    dst the pass has not used yet) give every edge the smallest round
    that neither its src nor its dst uses among earlier edges, which is
    what this computes in one pass, with a per-endpoint floor below which
    every round is taken (the 2048 updates of one owner take 2048 rounds:
    the reference's passes cost quadratic time there)."""
    used: dict = {}  # ("s", src) / ("d", dst) -> rounds it takes
    floor: dict = {}  # the same keys -> every round below is taken
    rounds: List[list] = []
    for e in edges:
        ks, kd = ("s", e[0]), ("d", e[1])
        us, ud = used.setdefault(ks, set()), used.setdefault(kd, set())
        c = max(floor.get(ks, 0), floor.get(kd, 0))
        while c in us or c in ud:
            c += 1
        us.add(c)
        ud.add(c)
        for k, u in ((ks, us), (kd, ud)):
            f = floor.get(k, 0)
            while f in u:
                f += 1
            floor[k] = f
        if c == len(rounds):
            rounds.append([])
        rounds[c].append(e)
    return rounds


def _base_error(base):
    """Why ``base`` cannot back a device-epoch window: (error class,
    message), or None."""
    from ompi_tpu_torch.osc import cuda as _cuda

    if not isinstance(base, torch.Tensor):
        return (errors.ERR_BUFFER,
                f"win_create_device takes a device tensor, not "
                f"{type(base).__name__} (a host buffer goes to "
                "osc.win_create)")
    if not _cuda._window_ok(base, 1):
        return (errors.ERR_ARG,
                "win_create_device needs a non-empty float32, bfloat16 or "
                "int32 tensor on this rank's device-plane device (got "
                f"{base.dtype} x {base.numel()} on {base.device})")
    return None


class DeviceEpochWindow:
    """Active-target device window: the reference's compiled fence over
    CudaWindow's exchanges and K7-K10.

    Created collectively (:func:`win_create_device`); every rank passes a
    same-shape, same-dtype tensor on its device. The fence discipline::

        win = osc.win_create_device(comm, torch.zeros(n, device=dev))
        win.Fence()
        win.Put(payload, target=1, disp=4)
        h = win.Get(8, target=2, disp=0)   # nelems, not a template
        win.Fence()                        # ops execute HERE
        h.array                            # the fetched device tensor
        win.array                          # local window content
    """

    def __init__(self, comm, array) -> None:
        self.comm = comm.dup()  # private comm: tag isolation
        err = _base_error(array)
        meta = self.comm.coll.allgather_obj(self.comm, (
            err, None if err else (tuple(array.shape), str(array.dtype))))
        me = self.comm.rank
        bad = [(q, e) for q, (e, _m) in enumerate(meta) if e]
        if not bad and len({m for _e, m in meta}) != 1:
            bad = [(me, (errors.ERR_ARG,
                         "win_create_device needs the same shape and dtype "
                         f"on every rank: {[m for _e, m in meta]}"))]
        if bad:  # every rank raises, its own error first
            self.comm.free()
            q, (cls, msg) = next((b for b in bad if b[0] == me), bad[0])
            raise errors.MPIError(cls, msg if q == me else f"rank {q}: {msg}")
        from ompi_tpu_torch.osc import cuda_kernels as O

        self._shape = tuple(array.shape)
        self._win = array.detach().clone(
            memory_format=torch.contiguous_format).reshape(-1)
        self._target = O.Target(self._win)
        self.rank = self.comm.rank
        self.size = self.comm.size
        # this rank's epoch queues: puts (target, disp, payload, kind, 1),
        # gets (handle, target, disp, nelems, 1), and the empty gets
        self._pending: List[tuple] = []
        self._gets: List[tuple] = []
        self._empty: List[GetHandle] = []
        self._in_epoch = False
        self.errhandler = errors.ERRORS_ARE_FATAL
        self.comm.coll.barrier(self.comm)  # creation is collective

    @property
    def array(self) -> torch.Tensor:
        """The window contents in the base's shape: a view of the live
        window (read it at epoch boundaries)."""
        return self._win.view(self._shape)

    def Set_errhandler(self, eh) -> None:
        self.errhandler = eh

    def Get_errhandler(self):
        return self.errhandler

    def _check_target(self, what: str, target: int) -> bool:
        """Whether an op to ``target`` goes on: a rank outside the comm is
        ``RankError`` through the errhandler (False: a callback handled
        it)."""
        if 0 <= target < self.size:
            return True
        return not errors.dispatch(self, errors.RankError(
            f"{what}: target {target} outside the window's {self.size} "
            "ranks"))

    def _check(self, what: str, target: int, disp: int, n: int) -> None:
        if disp < 0 or disp + n > self._win.numel():
            raise errors.MPIError(
                errors.ERR_ARG,
                f"{what} of {n} elements at {disp}: rank {target}'s window "
                f"holds {self._win.numel()}")

    def _queue(self, arr, target: int, disp: int, kind: str,
               what: str) -> None:
        a = arr if isinstance(arr, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(arr))
        a = a.detach().reshape(-1).to(self._win.dtype)
        target, disp = int(target), int(disp)
        if not self._check_target(what, target):
            return
        self._check(what, target, disp, a.numel())
        if a.numel():  # an empty payload moves nothing
            self._pending.append((target, disp, a, kind, 1))

    # -- epoch ops --------------------------------------------------------
    def Put(self, arr, target: int, disp: int = 0) -> None:
        """Record a put of ``arr`` into target's window at element offset
        ``disp``; executes at the closing Fence."""
        pvar.record("osc_device_epoch_op")
        self._queue(arr, target, disp, "put", "Put")

    def Accumulate(self, arr, target: int, disp: int = 0,
                   op="sum") -> None:
        """Record an elementwise accumulate into target's window, applied
        at the closing Fence in the epoch's round order. ``op``: sum /
        replace / min / max / prod, as a string or an ``op.Op``."""
        name = getattr(op, "name", op)  # op.Op -> "MPI_SUM"
        kind = str(name).lower().removeprefix("mpi_")
        if kind not in _FUSABLE:
            _fallback("accumulate",
                      f"op {name!r} is not fusable into the fence program")
            raise errors.MPIError(
                errors.ERR_OP,
                f"device-epoch accumulate op {name!r} not fusable; use the "
                "host window's AM path for other ops")
        pvar.record("osc_device_epoch_op")
        self._queue(arr, target, disp, kind, "Accumulate")

    def Get(self, nelems: int, target: int, disp: int = 0) -> GetHandle:
        """Record a get of ``nelems`` elements from target's window; the
        handle's ``.array`` fills at the closing Fence."""
        pvar.record("osc_device_epoch_op")
        target, disp, nelems = int(target), int(disp), int(nelems)
        h = GetHandle()
        if not self._check_target("Get", target):
            self._empty.append(h)
            return h
        self._check("Get", target, disp, nelems)
        if nelems:
            self._gets.append((h, target, disp, nelems, 1))
        else:
            self._empty.append(h)
        return h

    # -- fence ------------------------------------------------------------
    def Fence(self) -> None:
        """Epoch boundary (collective): runs this epoch's queued Puts,
        Accumulates and Gets as the reference's rounds, then barriers. The
        first Fence only opens the epoch."""
        if not self._in_epoch:
            self._in_epoch = True
            self.comm.coll.barrier(self.comm)
            return
        from ompi_tpu_torch.osc import cuda as _cuda

        _cuda.fence_flush(self.comm, self._target, self._pending, self._gets)
        for h in self._empty:
            h.array = self._win[:0].clone()
        self._pending, self._gets, self._empty = [], [], []
        self.comm.coll.barrier(self.comm)

    def Free(self) -> None:
        """Barrier, then free the window comm (and its arenas)."""
        self.comm.coll.barrier(self.comm)
        self.comm.free()

    # -- passive target and PSCW: not a fence program -----------------------
    def _no_passive(self, op: str):
        _fallback(op, "passive target needs the host window's AM path or "
                  "a CudaWindow")
        return errors.MPIError(
            errors.ERR_RMA_SYNC,
            f"device-epoch windows are fence-only; {op} needs a host window "
            "(osc.win_create) or a CudaWindow (--mca osc_cuda on)")

    def Lock(self, target: int, lock_type: str = "exclusive"):
        raise self._no_passive("Lock")

    def Unlock(self, target: int):
        raise self._no_passive("Unlock")

    def Flush(self, target: int):
        raise self._no_passive("Flush")

    def Post(self, group_ranks):
        raise self._no_passive("Post")

    def Start(self, group_ranks):
        raise self._no_passive("Start")


def win_create_device(comm, array) -> DeviceEpochWindow:
    """Create a compiled-fence device window (collective; every rank
    passes a same-shape, same-dtype tensor on its device)."""
    return DeviceEpochWindow(comm, array)
