"""osc/cuda — device-resident one-sided windows, fence epochs.

Port of ``ompi_tpu.osc.pallas`` (``PallasWindow``), reduced to the fence
epoch: ``win_create`` -> ``Fence`` -> ``Put`` / ``Put_strided`` /
``Accumulate`` / ``Get_epoch`` -> ``Fence``. The window is a tensor on
the rank's device, and every window mutation and read runs as one of the
kernels K7-K10 (:mod:`ompi_tpu_torch.osc.cuda_kernels`). Origin calls
queue descriptors; the closing Fence runs one metadata allgather,
groups the epoch's transfers by element count (sorted), colours each
group first-fit into partial matchings, and moves each round through the
window comm's peer-mapped arena (``coll.cuda.Arena.round``): the origin
stages its payload in its own slot (a ``copy_`` for a put, K9 for a get,
read at the target), the receiver pulls it through the peer pointer
(K10) and, for a put, applies it to its window (K7, or K8 when strided).
The round order is the reference's exactly, so same-origin accumulates
to one location apply in descriptor order and the windows end bitwise
equal to the JAX package's.

Epoch discipline is enforced as the reference enforces it: an op outside
any epoch, ``Get_epoch`` outside a fence, ``Unlock`` without ``Lock``,
``Complete`` without ``Start``, ``Rput`` / ``Rget`` outside a Lock, and
``Free`` with queued descriptors raise ``MPIError(ERR_RMA_SYNC)``; an
operand whose dtype differs from the window's raises ``ERR_ARG``. Those
checks come first; then what the reference serves over the host
window's active-message plane (PSCW, passive target, the synchronous
Get, Get_accumulate, Fetch_and_op, Compare_and_swap) and what it falls
through to the host for (a window the kernels do not take, a
non-elementwise Accumulate) counts ``osc_cuda_fallthrough`` and raises
``ERR_NOT_SUPPORTED``: there is no host window to fall to before the pml
slice (ROADMAP queue 1, item 2).

Where the port differs from the reference:

- the window is a tensor cloned from ``base`` at creation, so the
  caller's tensor is untouched, as a jax array is;
- applies update the window in place, and ``win.array`` is a view of it
  in ``base``'s shape (valid at epoch boundaries);
- a queued origin tensor is kept by reference, not cloned: MPI forbids
  changing an origin buffer before the closing fence;
- a ``GetHandle.array`` is a fresh device tensor, never a view of an
  arena slot, since the next round reuses the slot;
- a target rank outside the window raises ``ERR_RANK`` at the call
  (the reference queues it).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll import cuda as _coll_cuda
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.osc import AM_ITEM, Window
from ompi_tpu_torch.osc import cuda_kernels as O
from ompi_tpu_torch.osc.device_epoch import GetHandle, _color
from ompi_tpu_torch.runtime import device_plane

_enable_var = cvar.register(
    "osc_cuda", "off", str,
    help="Enable the device-resident one-sided windows (osc/pallas's "
         "counterpart): 'on' serves win_create over a supported device "
         "tensor with CudaWindow (kernel-applied RMA, fence epochs over "
         "the peer-mapped arenas); 'off' [default] leaves win_create "
         "without a window (the host window comes with the pml).",
    choices=["off", "on"], level=4)

#: the kernels' support matrix
_SUPPORTED_DTYPES = frozenset((torch.float32, torch.bfloat16, torch.int32))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _fallthrough(what: str, reason: str) -> None:
    """Count a case the reference falls through to the host window for,
    and refuse it: the port has no host window yet."""
    pvar.record("osc_cuda_fallthrough")
    raise errors.MPIError(
        errors.ERR_NOT_SUPPORTED,
        f"osc_cuda: {what} {reason}; the host window the reference falls "
        f"through to comes with {AM_ITEM}")


class CudaWindow(Window):
    """Device-resident MPI window: the authoritative buffer is a flat
    tensor on the rank's device (``.array`` views it in ``base``'s
    shape); all target-side RMA runs as kernels; fence epochs run as
    edge-coloured rounds over the window comm's arenas.

    Created by ``osc.win_create`` under ``--mca osc_cuda on`` (see
    :func:`maybe_window`), or directly with :func:`win_create_cuda`."""

    def __init__(self, comm, base: torch.Tensor,
                 disp_unit: int = 1) -> None:
        self._shape = tuple(base.shape)
        self._win = base.detach().clone(
            memory_format=torch.contiguous_format).reshape(-1)
        self._fence_open = False
        # fence-epoch descriptor queues: puts (target, disp, payload,
        # kind, stride), gets (handle, target, disp, nelems, stride)
        self._fput: List[Tuple] = []
        self._fget: List[Tuple] = []
        super().__init__(comm, self._win, disp_unit)
        pvar.record("osc_cuda_windows")

    # -- device state ---------------------------------------------------
    @property
    def array(self) -> torch.Tensor:
        """The window contents in ``base``'s shape: a view of the live
        window (read it at epoch boundaries)."""
        return self._win.view(self._shape)

    # -- epoch discipline -----------------------------------------------
    def _epoch_for(self, target: int) -> None:
        """Raise unless an epoch covers an op to ``target``; with no Lock
        or Start (they need the AM plane), only an open fence does."""
        if self._fence_open:
            return
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

    @staticmethod
    def _acc_kind(op) -> str:
        name = getattr(op, "name", op)  # op_mod.Op -> "MPI_SUM"
        return str(name).lower().removeprefix("mpi_")

    # -- origin API -----------------------------------------------------
    def _queue_put(self, a: torch.Tensor, target: int, disp: int,
                   kind: str, stride: int) -> None:
        pvar.record("osc_cuda_bytes", a.numel() * a.element_size())
        self._fput.append((int(target), int(disp), a, kind, int(stride)))

    def Put(self, buf, target: int, disp: int = 0) -> None:
        pvar.record("osc_cuda_put")
        self._epoch_for(target)
        self._check_target(target)
        self._queue_put(self._payload(buf, "Put"), target, disp, "put", 1)

    def Put_strided(self, buf, target: int, disp: int = 0,
                    stride: int = 1) -> None:
        """Elements of buf land at disp, disp+stride, ... (the halo
        column); those past either end of the window are dropped."""
        pvar.record("osc_cuda_put")
        self._epoch_for(target)
        self._check_target(target)
        self._queue_put(self._payload(buf, "Put"), target, disp, "put",
                        stride)

    def Accumulate(self, buf, target: int, disp: int = 0,
                   op: op_mod.Op = op_mod.SUM) -> None:
        pvar.record("osc_cuda_acc")
        self._epoch_for(target)
        kind = self._acc_kind(op)
        data = self._payload(buf, "Accumulate")
        if kind not in O.ELEMENTWISE:
            _fallthrough("Accumulate", f"op {getattr(op, 'name', op)!r} "
                         "is not elementwise")
        self._check_target(target)
        self._queue_put(data, target, disp, kind, 1)

    def Get_epoch(self, nelems: int, target: int, disp: int = 0,
                  stride: int = 1) -> GetHandle:
        """Device-resident Get: records a descriptor; the handle's
        ``.array`` is filled at the closing Fence, fetched over the same
        coloured rounds as puts (data flows target -> origin)."""
        pvar.record("osc_cuda_get")
        if not self._fence_open:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Get_epoch on {self.name} outside a fence epoch")
        self._check_target(target)
        h = GetHandle()
        self._fget.append((h, int(target), int(disp), int(nelems),
                           int(stride)))
        return h

    # -- the AM plane's verbs: epoch rules first, then ERR_NOT_SUPPORTED -
    def _am(self, verb: str) -> None:
        pvar.record("osc_cuda_fallthrough")
        super()._am(verb)

    def Get(self, buf, target: int, disp: int = 0):
        pvar.record("osc_cuda_get")
        self._epoch_for(target)
        self._am("Get")

    def Get_strided(self, buf, target: int, disp: int = 0,
                    stride: int = 1) -> None:
        pvar.record("osc_cuda_get")
        self._epoch_for(target)
        self._am("Get_strided")

    def Get_accumulate(self, origin, result, target: int, disp: int = 0,
                       op: op_mod.Op = op_mod.SUM) -> None:
        self._epoch_for(target)
        self._am("Get_accumulate")

    def Fetch_and_op(self, value, result, target: int, disp: int = 0,
                     op: op_mod.Op = op_mod.SUM) -> None:
        self._epoch_for(target)
        self._am("Fetch_and_op")

    def Compare_and_swap(self, value, compare, result, target: int,
                         disp: int = 0) -> None:
        self._epoch_for(target)
        self._am("Compare_and_swap")

    # No Lock is ever granted and no Start opens an access epoch (both
    # need the AM plane), so these are always outside their epoch.
    def Rput(self, buf, target: int, disp: int = 0):
        # request-based RMA is passive-target only (MPI-3.1 §11.3.5)
        raise errors.MPIError(
            errors.ERR_RMA_SYNC,
            f"Rput on {self.name}: no passive-target (Lock) epoch covers "
            f"rank {target}")

    def Rget(self, buf, target: int, disp: int = 0):
        raise errors.MPIError(
            errors.ERR_RMA_SYNC,
            f"Rget on {self.name}: no passive-target (Lock) epoch covers "
            f"rank {target}")

    def Unlock(self, target: int) -> None:
        raise errors.MPIError(
            errors.ERR_RMA_SYNC,
            f"Unlock on {self.name}: rank {target} is not locked by this "
            "origin")

    def Unlock_all(self) -> None:
        self.Unlock(0)

    def Complete(self) -> None:
        raise errors.MPIError(
            errors.ERR_RMA_SYNC,
            f"Complete on {self.name} without a matching Start")

    # -- synchronization ------------------------------------------------
    def Fence(self) -> None:
        """Active-target fence: run this epoch's queued descriptors as
        coloured rounds, then barrier. The first Fence opens the epoch
        chain (nothing queued by definition)."""
        pvar.record("osc_cuda_fence")
        if self._fence_open:
            self._flush_fence()
        self.comm.coll.barrier(self.comm)
        self._fence_open = True

    def Free(self) -> None:
        if self._fput or self._fget:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Free on {self.name} with {len(self._fput)} put / "
                f"{len(self._fget)} get descriptors still queued — close "
                "the fence epoch first")
        super().Free()

    # -- the fence flush ------------------------------------------------
    @staticmethod
    def _rounds(edges):
        """Group same-nelems edges (sorted by nelems), colour each group
        into partial matchings — edges are (src, dst, disp, nelems,
        ...)."""
        by_n: dict = {}
        for e in edges:
            by_n.setdefault(e[3], []).append(e)
        for n, group in sorted(by_n.items()):
            for rnd in _color(group):
                yield n, rnd

    def _transport(self, nelems: int, tgt: int, src: int, stage,
                   land) -> None:
        """One round through the window comm's arena for this payload
        size: ``stage(slot)`` fills this rank's slot for ``tgt``,
        ``land(src_slot)`` takes what ``src`` staged (typed views of
        ``nelems`` elements); -1 means no partner."""
        pvar.record("osc_cuda_rounds")
        dt = self._win.dtype
        ep = _coll_cuda._arena(self.comm, "osc",
                               nelems * self._win.element_size())
        ep.round(tgt, src, lambda s: stage(s.view(dt)[:nelems]),
                 lambda s: land(s.view(dt)[:nelems]))

    def _landing(self, nelems: int) -> torch.Tensor:
        return torch.empty(nelems, dtype=self._win.dtype,
                           device=self._win.device)

    def _flush_fence(self) -> None:
        put_desc = [(t, d, a.numel(), k, s) for t, d, a, k, s in self._fput]
        get_desc = [(t, d, n, s) for _h, t, d, n, s in self._fget]
        all_desc = self.comm.coll.allgather_obj(self.comm,
                                                (put_desc, get_desc))
        puts = [(o, t, d, n, k, s)
                for o, (pd, _) in enumerate(all_desc)
                for t, d, n, k, s in pd]
        gets = [(o, t, d, n, s)
                for o, (_, gd) in enumerate(all_desc)
                for t, d, n, s in gd]
        if puts:
            self._run_fence_puts(puts)
        if gets:
            self._run_fence_gets(gets)
        self._fput = []
        self._fget = []

    def _run_fence_puts(self, puts) -> None:
        mine = list(self._fput)
        for nelems, rnd in self._rounds(puts):
            payload: Optional[torch.Tensor] = None
            my_in: Optional[Tuple[int, str, int]] = None
            tgt = src = -1
            for s, d, disp, _n, kind, stride in rnd:
                if s == self.rank:
                    # pop MY first queued op matching the descriptor
                    tgt = d
                    for i, (t, dd, a, k, st) in enumerate(mine):
                        if (t, dd, a.numel(), k, st) == (
                                d, disp, nelems, kind, stride):
                            payload = mine.pop(i)[2]
                            break
                if d == self.rank:
                    src, my_in = s, (disp, kind, stride)

            def stage(slot):
                slot.copy_(payload)

            def land(peer):
                landing = O.rma_permute_recv(peer, self._landing(nelems))
                O.apply(self._win, landing, my_in[0], my_in[1], my_in[2])

            self._transport(nelems, tgt, src, stage, land)

    def _run_fence_gets(self, gets) -> None:
        # data flows target -> origin: edges (src=target, dst=origin)
        holders = list(self._fget)
        edges = [(t, o, d, n, s) for o, t, d, n, s in gets]
        for nelems, rnd in self._rounds(edges):
            serve: Optional[Tuple[int, int]] = None
            my_in: Optional[Tuple[int, int, int]] = None
            tgt = src = -1
            for s, d, disp, _n, stride in rnd:
                if s == self.rank:  # I am the target: kernel-read
                    tgt, serve = d, (disp, stride)
                if d == self.rank:
                    src, my_in = s, (s, disp, stride)

            def stage(slot):
                O.rma_read(self._win, serve[0], serve[1], slot)

            def land(peer):
                got = O.rma_permute_recv(peer, self._landing(nelems))
                for i, (h, t, d, n, st) in enumerate(holders):
                    if h.array is None and (t, d, n, st) == (
                            my_in[0], my_in[1], nelems, my_in[2]):
                        h.array = got
                        holders.pop(i)
                        break

            self._transport(nelems, tgt, src, stage, land)


def _window_ok(base, disp_unit: int) -> bool:
    return bool(
        isinstance(base, torch.Tensor) and device_plane.active()
        and base.device == device_plane.device()
        and base.dtype in _SUPPORTED_DTYPES and base.numel() > 0
        and disp_unit in (1, base.element_size()))


def maybe_window(comm, base, disp_unit: int = 1) -> Optional[CudaWindow]:
    """The creation-time selection ``osc.win_create`` calls (collective):
    None when the component is off; a :class:`CudaWindow` when every rank
    passes a supported tensor on its device-plane device (agreed by one
    metadata allgather: one dtype on every rank; per-rank sizes are fine);
    otherwise the fallthrough is counted and ``ERR_NOT_SUPPORTED``
    raised on every rank."""
    if _enable_var.get() != "on":
        return None
    ok = _window_ok(base, disp_unit)
    dt = _dtype_name(base.dtype) if isinstance(base, torch.Tensor) else ""
    meta = comm.coll.allgather_obj(comm, (ok, dt))
    if not all(m[0] for m in meta) or len({m[1] for m in meta}) != 1:
        reasons = sorted({m[1] or "<host buffer>" for m in meta})
        _fallthrough(
            "win_create", f"cannot serve this window (dtypes {reasons}; "
            "supported: float32, bfloat16, int32 tensors on each rank's "
            "device-plane device, disp_unit 1 or the item size, one dtype "
            "on every rank)")
    return CudaWindow(comm, base, disp_unit)


def win_create_cuda(comm, base, disp_unit: int = 1) -> CudaWindow:
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
    return CudaWindow(comm, base, disp_unit)
