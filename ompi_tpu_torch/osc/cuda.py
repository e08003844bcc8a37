"""osc/cuda — device-resident one-sided windows, fence epochs.

Port of ``ompi_tpu.osc.pallas`` (``PallasWindow``), reduced to the fence
epoch: ``win_create`` -> ``Fence`` -> ``Put`` / ``Put_strided`` /
``Accumulate`` / ``Get_epoch`` -> ``Fence``. The window is a tensor on
the rank's device, and every window mutation and read runs as one of the
kernels K7-K10 (:mod:`ompi_tpu_torch.osc.cuda_kernels`). Origin calls
queue descriptors; the closing Fence runs one metadata allgather, groups
the epoch's transfers by element count (sorted) and colours each group
first-fit into partial matchings: the reference's rounds, in its order.
Where the reference moves each round as one step, the port cuts the
rounds, in order, into exchanges (:func:`plan_exchanges`: as many
consecutive rounds as keep every rank's staged bytes within
:data:`EXCHANGE_BYTES`) and moves each exchange through the window
comm's peer-mapped arena in one host step (``coll.cuda.Arena.exchange``):

- puts: the origin stages every payload it sends in the exchange in its
  own region, grouped by target, in round order (one ``torch.cat``); the
  target applies what it receives in exactly the reference's round order,
  reading each payload straight from its source's region: K8's grouped
  kernel over runs of disjoint descriptors, K7 for contiguous ones of
  2**20 elements or more;
- gets: the target stages every row it serves, grouped by origin, with one
  K9 batch; the origin pulls every source's block into a fresh landing
  tensor with one grouped K10 launch, and each ``GetHandle.array`` is a
  view of it.

So same-location accumulates apply in the reference's round order and the
windows end bitwise equal to the JAX package's; ``osc_cuda_rounds`` counts
the reference's rounds and ``osc_cuda_exchanges`` the host steps run.

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
- a ``GetHandle.array`` is a view of the exchange's fresh landing tensor,
  never of an arena region, which the next exchange reuses;
- a target rank outside the window raises ``ERR_RANK`` at the call
  (the reference queues it);
- a contiguous ``Put`` / ``Accumulate`` / ``Get_epoch`` (and a
  ``Put_strided`` of stride 1, which the target applies as one) of more
  elements than the target's window raises ``ERR_ARG`` at the call, from
  ``peer_info``, so nothing is queued that the target cannot apply (the
  reference queues it too); a strided put still drops what falls outside.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

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
#: bytes a rank may stage for one exchange of a fence (a run of the
#: reference's coloured rounds moved in one host step); a round whose
#: payload is larger runs alone. The embedding path's fences (256 KiB a
#: rank) and the halo columns (64 KiB) each fit one exchange; the halo
#: tile's 256 MiB put runs alone.
EXCHANGE_BYTES = 64 << 20

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
    shape); all target-side RMA runs as kernels; a fence epoch runs its
    edge-coloured rounds as exchanges over the window comm's arenas.

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
        self._target = O.Target(self._win)  # the launch record, checked once
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
        data = self._payload(buf, "Put")
        self._check_fits("Put", data.numel(), target)
        self._queue_put(data, target, disp, "put", 1)

    def Put_strided(self, buf, target: int, disp: int = 0,
                    stride: int = 1) -> None:
        """Elements of buf land at disp, disp+stride, ... (the halo
        column); those past either end of the window are dropped (stride
        1 is a contiguous Put)."""
        pvar.record("osc_cuda_put")
        self._epoch_for(target)
        self._check_target(target)
        data = self._payload(buf, "Put")
        if stride == 1:
            self._check_fits("Put_strided", data.numel(), target)
        self._queue_put(data, target, disp, "put", stride)

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
        self._check_fits("Accumulate", data.numel(), target)
        self._queue_put(data, target, disp, kind, 1)

    def Get_epoch(self, nelems: int, target: int, disp: int = 0,
                  stride: int = 1) -> GetHandle:
        """Device-resident Get: records a descriptor; the handle's
        ``.array`` is filled at the closing Fence, fetched over the same
        coloured rounds and exchanges as puts (data flows target ->
        origin)."""
        pvar.record("osc_cuda_get")
        if not self._fence_open:
            raise errors.MPIError(
                errors.ERR_RMA_SYNC,
                f"Get_epoch on {self.name} outside a fence epoch")
        self._check_target(target)
        if stride == 1:
            self._check_fits("Get_epoch", int(nelems), target)
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
        coloured rounds, moved in exchanges, then barrier. The first Fence
        opens the epoch chain (nothing queued by definition)."""
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

    def _exchanges(self, edges):
        """The reference's rounds of these edges, in its order, cut into
        exchanges: yields each exchange's edges (round order) with their
        :func:`exchange_layout`."""
        rounds = [rnd for _n, rnd in self._rounds(edges)]
        pvar.record("osc_cuda_rounds", len(rounds))
        es = self._win.element_size()
        cuts = plan_exchanges([[(e[0], e[3] * es) for e in rnd]
                               for rnd in rounds], EXCHANGE_BYTES)
        for a, b in cuts:
            pvar.record("osc_cuda_exchanges")
            run = [e for rnd in rounds[a:b] for e in rnd]
            yield run, exchange_layout(run, self.comm.size)

    def _arena(self, totals: List[int]):
        return _coll_cuda._arena(self.comm, "osc",
                                 max(totals) * self._win.element_size())

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
        me, dt = self.rank, self._win.dtype
        queued: Dict[tuple, deque] = {}
        for t, dd, a, k, st in self._fput:
            queued.setdefault((t, dd, a.numel(), k, st), deque()).append(a)
        for run, (offs, totals, _blocks) in self._exchanges(puts):
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
                self._target.apply(bases, [
                    (at[run[j][0]], offs[j], run[j][3], run[j][2],
                     run[j][5], run[j][4]) for j in incoming])

            self._arena(totals).exchange(stage, {run[j][1] for j in sent},
                                         land, srcs)

    def _run_fence_gets(self, gets) -> None:
        # data flows target -> origin: edges (src=target, dst=origin)
        me, dt = self.rank, self._win.dtype
        holders: Dict[tuple, deque] = {}
        for h, t, d, n, st in self._fget:
            holders.setdefault((t, d, n, st), deque()).append(h)
        edges = [(t, o, d, n, s) for o, t, d, n, s in gets]
        for run, (offs, totals, blocks) in self._exchanges(edges):
            served = sorted((j for j, e in enumerate(run) if e[0] == me),
                            key=offs.__getitem__)
            srcs = sorted({e[0] for e in run if e[1] == me})
            # my incoming blocks, one after another in source order
            at, n_in = {}, 0
            for p in srcs:
                at[p] = n_in - blocks[(p, me)][0]
                n_in += blocks[(p, me)][1]

            def stage(region):  # I am the target: every row I serve
                self._target.read([(run[j][2], run[j][4], run[j][3], offs[j])
                                   for j in served], region.view(dt))

            def land(regions):
                got = torch.empty(n_in, dtype=dt, device=self._win.device)
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

            self._arena(totals).exchange(stage, {run[j][1] for j in served},
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
