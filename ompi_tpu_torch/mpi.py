"""The public MPI-style API of the port.

Reference: ompi/mpi/c/ and the JAX package's ``ompi_tpu.mpi``. The
surface follows the mpi4py convention: lower-case methods move pickled
Python objects, capitalised methods move buffers. A host buffer is numpy
(or any object with the buffer protocol), given as ``array``,
``(array, count)`` or ``(array, count, Datatype)`` with any Datatype,
predefined (the MINLOC / MAXLOC pair types among them) or derived
(``datatype.vector``, ``create_struct``, ``subarray``, ...) over a
C-contiguous array; a non-contiguous numpy array raises
``MPIError(ERR_BUFFER)`` (describe its layout with a derived type over
the base array instead). A device buffer is a ``torch.Tensor``, bare or
as ``(tensor, count[, Datatype])``: that tuple form packs on the
tensor's own device (``datatype.device``, one gather), moves the packed
form, and scatters a received result back into the tensor in place (the
type's gaps keep their values). It works on Send / Isend / Rsend / Recv
/ Irecv / Sendrecv / Isendrecv / Bcast / Allreduce / Ibcast /
Iallreduce; any other entry given one raises
``MPIError(ERR_NOT_SUPPORTED)``.

Point-to-point (ompi_tpu/mpi.py:69-660): Send / Recv / Isend / Irecv /
Ssend / Issend / Rsend / Bsend (with Buffer_attach / Buffer_detach) /
Sendrecv / Sendrecv_replace / Isendrecv / Isendrecv_replace, the probe
family (Probe / Iprobe / Mprobe / Improbe / Mrecv), Send_init / Recv_init
/ start_all, Pack / Unpack / Pack_size, and the object API (send / recv /
isend / irecv / sendrecv, and bcast / gather / scatter / allgather /
alltoall / allreduce / reduce / barrier of Python objects) over ob1. A
tensor given to Send / Isend / Rsend / Recv / Irecv / Sendrecv /
Isendrecv goes through ``pml/accel_p2p``'s pipelined staging; unlike the
reference, which returns a new array (jax arrays are immutable), the
port receives in place: ``Recv`` fills the template tensor and returns
it, and an Irecv request's ``.array`` is that tensor. ``Pack`` /
``Unpack`` / ``Pack_size`` take derived types, and ``Pack_external`` /
``Unpack_external`` write and read external32. A CUDA tensor on a
rank whose device is the CPU, or on another card than the rank's, raises
``MPIError(ERR_ARG)``.

Collectives (ompi_tpu/mpi.py:663-1320): Barrier, Bcast, Reduce,
Allreduce, Gather(v), Scatter(v), Allgather(v), Alltoall(v),
Reduce_scatter(_block), Scan, Exscan and Allreduce_multi; their
nonblocking forms (``I*``, Ibarrier) and the persistent Barrier_init,
Bcast_init, Allreduce_init, Reduce_init, Gather_init, Scatter_init,
Allgather_init, Alltoall_init and Reduce_scatter_block_init; the zero/
pair Reduce_scatter_multi / Allgather_multi (numpy leaves take the host
bucket cycle, ``zero/layout.host_*``); :func:`Reduce_local` and
:func:`Op_create`. The persistent Allreduce_multi_init,
Reduce_scatter_multi_init and Allgather_multi_init (whose request's
``rebind`` takes a same-plan ShardedState) and the MPI-4 partitioned
Pallreduce_init / Preduce_scatter_init (one partition per pytree leaf,
a bucket's collective run by its last leaf's ``Pready``) take tensors
only: a numpy leaf raises ``MPIError(ERR_BUFFER)`` (the reference:
TypeError). Psend_init / Precv_init (``part/host``) take numpy buffers,
and :func:`start_all` starts any mix of persistent and partitioned
requests, all or nothing.

- Host buffers go to the comm's host slots (coll/tuned, coll/basic,
  coll/libnbc): the call fills ``recvbuf`` in place and returns None (a
  request, for the ``I*`` and ``*_init`` forms), as the reference does.
  ``IN_PLACE`` as the send buffer takes ``recvbuf``'s contents
  (Allreduce, Reduce, Scan, Exscan, Allgather(v) and their ``I*``
  forms).
- A tensor goes to the ``*_dev`` slots (coll/cuda, coll/device, or
  coll/accelerator's staging): a blocking call returns a new tensor (a
  rooted call's non-roots get None) and a recvbuf tensor, where given,
  receives a copy; a request's ``.array`` holds its result and writes no
  recvbuf (as the reference's device branch).

Barrier is the host barrier (coll/tuned's) over the pml, or with
``device=True`` the device plane's.

Errors (ompi_tpu/mpi.py:1366-1431): every communicator carries an
errhandler (``ERRORS_ARE_FATAL`` by default; ``Set_errhandler`` /
``Get_errhandler``; dup, split, create and create_group inherit it). The
capitalised buffer operations of :data:`_ERRHANDLED`, on host buffers and
tensors alike, route an MPIError through it (:func:`_with_errhandler`); a
request from Isend / Irecv dispatches through its comm at ``wait``.
``Comm_create_errhandler`` / ``Win_create_errhandler`` make a callback
handler; ``Add_error_class`` / ``_code`` / ``_string``, ``Error_class``
and ``Error_string`` keep the user error space above ``ERR_LASTCODE``.

The instance (ompi_tpu/mpi.py:1586-1679): ``Init`` / ``Finalize``, the
MPI-4 ``Session_init`` (``Group_from_session_pset``,
``Comm_create_from_group``; no COMM_WORLD), ``Is_initialized``,
``Abort``, ``Request_get_status``, ``Wtime``, ``Wtick``,
``Get_version``, ``Get_library_version``, ``Info_env`` and
``MEMORY_ALLOC_KINDS``. MPI-IO (ompi_tpu/mpi.py:1505-1510): ``File``,
``File_open``, ``File_delete``, the ``MODE_*`` and ``SEEK_*`` constants
(:mod:`ompi_tpu_torch.io`), and ``File_create_errhandler`` (:1541).

Topologies (ompi_tpu/mpi.py:1490-1492): importing this module attaches
:mod:`ompi_tpu_torch.topo`'s methods (Create_cart, Cart_sub, the graph
constructors and queries, and the eight ``Neighbor_*`` /
``Ineighbor_*`` entries). Intercommunicators and dynamic processes
(:1494-1517): ``Intercomm_create``, ``Open_port``, ``Comm_accept``,
``Comm_connect``, ``ROOT``, ``Intercommunicator``, ``Comm_spawn``,
``Comm_spawn_multiple``, ``Comm_get_parent`` and ``Appnum``; the
capitalised collectives of an intercommunicator run coll/inter's
group-vs-group algorithms on host buffers, and its point-to-point ranks
(and a non-ROOT root) index the remote group. :data:`_API` lists the
names bound here, the ones :mod:`ompi_tpu_torch.profile` interposes by
default.
"""

from __future__ import annotations

import numbers
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod, pml
from ompi_tpu_torch.coll.basic import IN_PLACE, packed_displs
from ompi_tpu_torch.comm import Communicator, Group, UNDEFINED  # noqa: F401
from ompi_tpu_torch.comm.intercomm import (  # noqa: F401
    ROOT, Intercommunicator, comm_accept as Comm_accept,
    comm_connect as Comm_connect, intercomm_create as Intercomm_create,
    open_port as Open_port,
)
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.coll.device import DeviceRequest
from ompi_tpu_torch.datatype import Datatype, dtype_of
from ompi_tpu_torch.datatype import device as dtdev
from ompi_tpu_torch.pml import request as rq
from ompi_tpu_torch.pml.request import (  # noqa: F401  (re-exports)
    ANY_SOURCE, ANY_TAG, PROC_NULL, Request, Status, test_all, test_any,
    wait_all, wait_any, wait_some,
)

SUM, PROD, MIN, MAX = op_mod.SUM, op_mod.PROD, op_mod.MIN, op_mod.MAX
LAND, LOR, BAND, BOR = op_mod.LAND, op_mod.LOR, op_mod.BAND, op_mod.BOR
MINLOC, MAXLOC = op_mod.MINLOC, op_mod.MAXLOC
REPLACE, NO_OP = op_mod.REPLACE, op_mod.NO_OP


def Op_create(fn, commute: bool = True) -> op_mod.Op:
    """MPI_Op_create: ``fn(invec, inoutvec)`` returns the elementwise
    result over numpy arrays. A tensor collective with a user op stages
    through the host (coll/accelerator)."""
    return op_mod.create(fn, commute=commute)


def _is_dev(buf) -> bool:
    return isinstance(buf, torch.Tensor)


def _deliver(out, recvbuf):
    """The device path returns a new tensor; a recvbuf tensor given
    by the caller receives a copy of it too (where there is a result:
    a rooted call's non-roots get None)."""
    if recvbuf is not None and out is not None:
        recvbuf.copy_(out)
    return out


def _host_op(op) -> op_mod.Op:
    """An Op (or a builtin's MPI name) for the host slots."""
    opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
    if opn is None:
        raise errors.MPIError(errors.ERR_OP, f"unknown op {op!r}")
    return opn


def _check_root(comm, root) -> None:
    """A root in [0, size); on an intercommunicator ROOT, PROC_NULL or a
    rank of the remote group."""
    n = comm.size
    if getattr(comm, "is_inter", False):
        if root in (ROOT, PROC_NULL):
            return
        n = comm.remote_size
    if not isinstance(root, numbers.Integral) or not 0 <= root < n:
        raise errors.MPIError(errors.ERR_ROOT,
                              f"root {root!r} outside [0, {n})")


def _require_recvbuf(recvbuf, what: str):
    """A host collective needs the caller's recvbuf (recvbuf=None is the
    tensor form, which returns a new tensor)."""
    if recvbuf is None:
        raise errors.MPIError(
            errors.ERR_BUFFER,
            f"{what}: a host buffer needs a recvbuf (recvbuf=None is the "
            "tensor form, which returns a new tensor)")
    return recvbuf


def _in_place_block(rarr, lo: int, n: int):
    """IN_PLACE for Allgather(v): this rank's block of the receive
    buffer, copied out as the send buffer."""
    return np.asarray(rarr).reshape(-1)[lo:lo + n].copy()


def _host_tree(bufs) -> bool:
    """A pytree (or ShardedState) whose first leaf is a numpy array:
    the host bucket cycle's operand."""
    from ompi_tpu_torch.zero import layout as zl

    leaves = zl.tree_leaves(getattr(bufs, "shards", bufs))
    return bool(leaves) and isinstance(leaves[0], np.ndarray)


def _device_tree_or_raise(name: str, bufs) -> None:
    """The persistent and partitioned zero/ entries take tensors only, as
    the reference's (its host cycle has no persistent form)."""
    from ompi_tpu_torch.zero import layout as zl

    for leaf in zl.tree_leaves(getattr(bufs, "shards", bufs)):
        if not _is_dev(leaf):
            raise errors.MPIError(
                errors.ERR_BUFFER,
                f"{name}: a {type(leaf).__name__} leaf; this call takes "
                "tensors (host leaves: the blocking call per step)")


def _packed_displs_or_raise(counts, displs, name: str) -> None:
    """The device v-collectives read the send buffer as packed segments;
    another send-side layout would move the wrong rows
    (ompi_tpu/mpi.py:636-648)."""
    if displs is None:
        return
    if [int(d) for d in displs] != packed_displs(counts):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"{name}: the device path needs the packed send displacements "
            f"{packed_displs(counts)}, got {list(displs)}")


# -- the blocking collectives ------------------------------------------------

def _Allreduce(self, sendbuf, recvbuf=None, op=op_mod.SUM,
               deterministic=None):
    """deterministic (tensors): None lets the component pick the
    algorithm; 'ring'/'linear' fix the operand order — 'linear' is
    bit-identical to the host linear fold. A ``(tensor, count,
    datatype)`` sendbuf reduces its packed form and scatters the result
    back into the tensor, which is returned."""
    self.check_revoked()
    self.check_failed()
    d = _parse_dev(sendbuf)
    if d is not None:
        arr, count, dt = d
        out = self.coll.allreduce_dev(self, _dev_pack(arr, count, dt), op,
                                      deterministic=deterministic)
        if count is not None:
            out = dtdev.unpack(out, dt, count, arr)
        return _deliver(out, recvbuf)
    if sendbuf is IN_PLACE:
        rarr, count, dt = _parse_buf(_require_recvbuf(recvbuf, "Allreduce"))
        self.coll.allreduce(self, IN_PLACE, rarr, count, dt, _host_op(op))
        return None
    sarr, count, dt = _parse_buf(sendbuf)
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Allreduce"))[0]
    self.coll.allreduce(self, sarr, rarr, count, dt, _host_op(op))
    return None


def _Reduce(self, sendbuf, recvbuf=None, op=op_mod.SUM, root: int = 0,
            deterministic=None):
    """Tensors: the reduction on the root, None elsewhere (the root's
    recvbuf receives a copy). Host: the root's recvbuf is filled."""
    self.check_revoked()
    self.check_failed()
    if _is_dev(sendbuf):
        return _deliver(self.coll.reduce_dev(
            self, sendbuf, op, root, deterministic=deterministic), recvbuf)
    _check_root(self, root)
    rarr = None if recvbuf is None else _parse_buf(recvbuf)[0]
    if sendbuf is IN_PLACE:
        sarr = IN_PLACE
        count, dt = _parse_buf(_require_recvbuf(recvbuf, "Reduce"))[1:]
    else:
        sarr, count, dt = _parse_buf(sendbuf)
    self.coll.reduce(self, sarr, rarr, count, dt, _host_op(op), root)
    return None


def _Reduce_scatter_block(self, sendbuf, recvbuf=None, op=op_mod.SUM,
                          deterministic=None):
    """Tensors: dim 0 of sendbuf divides by the comm size; returns this
    rank's (dim0/size, ...) block."""
    self.check_revoked()
    if _is_dev(sendbuf):
        return _deliver(self.coll.reduce_scatter_block_dev(
            self, sendbuf, op, deterministic=deterministic), recvbuf)
    rarr, count, dt = _parse_buf(
        _require_recvbuf(recvbuf, "Reduce_scatter_block"))
    self.coll.reduce_scatter_block(self, _parse_buf(sendbuf)[0], rarr,
                                   count, dt, _host_op(op))
    return None


def _Reduce_scatter(self, sendbuf, recvbuf, counts, op=op_mod.SUM,
                    deterministic=None):
    """Tensors: this rank's counts[rank] rows of the reduction."""
    self.check_revoked()
    if _is_dev(sendbuf):
        return _deliver(self.coll.reduce_scatter_dev(
            self, sendbuf, counts, op, deterministic=deterministic),
            recvbuf)
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Reduce_scatter"))[0]
    self.coll.reduce_scatter(self, _parse_buf(sendbuf)[0], rarr,
                             [int(c) for c in counts], dtype_of(rarr),
                             _host_op(op))
    return None


def _Allgather(self, sendbuf, recvbuf=None):
    """Tensors: returns (size, *sendbuf.shape), rank i's block at i."""
    self.check_revoked()
    self.check_failed()
    if _is_dev(sendbuf):
        return _deliver(self.coll.allgather_dev(self, sendbuf), recvbuf)
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Allgather"))[0]
    if sendbuf is IN_PLACE:
        k = np.asarray(rarr).size // self.size
        sendbuf = _in_place_block(rarr, self.rank * k, k)
    sarr, count, dt = _parse_buf(sendbuf)
    self.coll.allgather(self, sarr, rarr, count, dt)
    return None


def _Allgatherv(self, sendbuf, recvbuf, counts, displs=None):
    """Tensors: returns the packed (sum(counts), *rest)."""
    self.check_revoked()
    self.check_failed()
    if _is_dev(sendbuf):
        return _deliver(self.coll.allgatherv_dev(self, sendbuf, counts),
                        recvbuf)
    counts = [int(c) for c in counts]
    displs = packed_displs(counts) if displs is None \
        else [int(d) for d in displs]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Allgatherv"))[0]
    if sendbuf is IN_PLACE:
        sendbuf = _in_place_block(rarr, displs[self.rank], counts[self.rank])
    sarr = _parse_buf(sendbuf)[0]
    self.coll.allgatherv(self, sarr, rarr, counts, displs, dtype_of(sarr))
    return None


def _Bcast(self, buf, root: int = 0):
    """Tensors: returns the root's buf on every rank; the other ranks'
    buf gives the shape and dtype and receives a copy of the result too
    (MPI's in-place receive); a ``(tensor, count, datatype)`` buf moves
    its packed form and the other ranks scatter it into the tensor. A
    root outside [0, size) raises ERR_ROOT."""
    self.check_revoked()
    self.check_failed()
    d = _parse_dev(buf)
    if d is not None:
        arr, count, dt = d
        if count is None:
            out = self.coll.bcast_dev(self, arr, root)
            return _deliver(out, arr if self.rank != root else None)
        out = self.coll.bcast_dev(self, _dev_send_or_plan(
            self.rank == root, arr, count, dt), root)
        return arr if self.rank == root \
            else dtdev.unpack(out, dt, count, arr)
    _check_root(self, root)
    arr, count, dt = _parse_buf(buf)
    self.coll.bcast(self, arr, count, dt, root)
    return None


def _Alltoall(self, sendbuf, recvbuf=None):
    """Tensors: dim 0 of sendbuf splits into size blocks; block p of the
    result is block ``rank`` of rank p's sendbuf (the MoE dispatch
    pattern)."""
    self.check_revoked()
    self.check_failed()
    if _is_dev(sendbuf):
        return _deliver(self.coll.alltoall_dev(self, sendbuf), recvbuf)
    sarr = _parse_buf(sendbuf)[0]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Alltoall"))[0]
    self.coll.alltoall(self, sarr, rarr, np.asarray(sarr).size // self.size,
                       dtype_of(sarr))
    return None


def _Alltoallv(self, sendbuf, recvbuf, scounts, rcounts, sdispls=None,
               rdispls=None, max_count=None):
    """Tensors: block p of the result is the rcounts[p] rows rank p sends
    this rank. ``max_count`` (e.g. a fixed MoE expert capacity) skips
    the count round."""
    self.check_revoked()
    self.check_failed()
    if _is_dev(sendbuf):
        _packed_displs_or_raise(scounts, sdispls, "Alltoallv")
        return _deliver(self.coll.alltoallv_dev(
            self, sendbuf, scounts, rcounts, max_count=max_count), recvbuf)
    scounts = [int(c) for c in scounts]
    rcounts = [int(c) for c in rcounts]
    sarr = _parse_buf(sendbuf)[0]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Alltoallv"))[0]
    self.coll.alltoallv(
        self, sarr, rarr, scounts,
        packed_displs(scounts) if sdispls is None else list(sdispls),
        rcounts, packed_displs(rcounts) if rdispls is None
        else list(rdispls), dtype_of(sarr))
    return None


def _Gather(self, sendbuf, recvbuf=None, root: int = 0):
    """Tensors: returns (size, *sendbuf.shape) on the root, None
    elsewhere."""
    self.check_revoked()
    self.check_failed()
    if _is_dev(sendbuf):
        return _deliver(self.coll.gather_dev(self, sendbuf, root), recvbuf)
    _check_root(self, root)
    sarr, count, dt = _parse_buf(sendbuf)
    rarr = None if recvbuf is None else _parse_buf(recvbuf)[0]
    self.coll.gather(self, sarr, rarr, count, dt, root)
    return None


def _Gatherv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0):
    """Tensors: returns the packed (sum(counts), *rest) on the root, None
    elsewhere (displs is a host-layout argument: the device result is
    packed)."""
    self.check_revoked()
    self.check_failed()
    if _is_dev(sendbuf):
        return _deliver(self.coll.gatherv_dev(self, sendbuf, counts, root),
                        recvbuf)
    _check_root(self, root)
    counts = [int(c) for c in counts]
    sarr = _parse_buf(sendbuf)[0]
    rarr = None if recvbuf is None else _parse_buf(recvbuf)[0]
    self.coll.gatherv(self, sarr, rarr, counts,
                      packed_displs(counts) if displs is None
                      else list(displs), dtype_of(sarr), root)
    return None


def _Scatter(self, sendbuf, recvbuf=None, root: int = 0,
             device: bool = False):
    """Rank r gets chunk r of the root's sendbuf. Tensors: a non-root
    passes sendbuf None with ``device=True``; its recvbuf, when given,
    is the shape template (``like``, every rank or none) and receives
    the chunk."""
    self.check_revoked()
    self.check_failed()
    if device or _is_dev(sendbuf):
        return _deliver(self.coll.scatter_dev(self, sendbuf, root,
                                              like=recvbuf), recvbuf)
    _check_root(self, root)
    rarr, count, dt = _parse_buf(_require_recvbuf(recvbuf, "Scatter"))
    sarr = None if sendbuf is None else _parse_buf(sendbuf)[0]
    self.coll.scatter(self, sarr, rarr, count, dt, root)
    return None


def _Scatterv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0,
              device: bool = False):
    """Rank r gets counts[r] rows of the root's sendbuf. Tensors: the
    root's sendbuf is packed; a non-root as for Scatter (recvbuf is the
    template of the trailing dims and dtype)."""
    self.check_revoked()
    self.check_failed()
    if device or _is_dev(sendbuf):
        _packed_displs_or_raise(counts, displs, "Scatterv")
        return _deliver(self.coll.scatterv_dev(self, sendbuf, counts, root,
                                               like=recvbuf), recvbuf)
    _check_root(self, root)
    counts = [int(c) for c in counts]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Scatterv"))[0]
    sarr = None if sendbuf is None else _parse_buf(sendbuf)[0]
    self.coll.scatterv(self, sarr, rarr, counts,
                       packed_displs(counts) if displs is None
                       else list(displs), dtype_of(rarr), root)
    return None


def _Scan(self, sendbuf, recvbuf=None, op=op_mod.SUM):
    """The inclusive prefix over ranks 0..rank, folded in rank order."""
    self.check_revoked()
    if _is_dev(sendbuf):
        return _deliver(self.coll.scan_dev(self, sendbuf, op), recvbuf)
    rarr, count, dt = _parse_buf(_require_recvbuf(recvbuf, "Scan"))
    sarr = IN_PLACE if sendbuf is IN_PLACE else _parse_buf(sendbuf)[0]
    self.coll.scan(self, sarr, rarr, count, dt, _host_op(op))
    return None


def _Exscan(self, sendbuf, recvbuf=None, op=op_mod.SUM):
    """The exclusive prefix. Tensors: rank 0 gets zeros; host: rank 0's
    recvbuf is left as it was (MPI leaves it undefined)."""
    self.check_revoked()
    if _is_dev(sendbuf):
        return _deliver(self.coll.exscan_dev(self, sendbuf, op), recvbuf)
    rarr, count, dt = _parse_buf(_require_recvbuf(recvbuf, "Exscan"))
    sarr = IN_PLACE if sendbuf is IN_PLACE else _parse_buf(sendbuf)[0]
    self.coll.exscan(self, sarr, rarr, count, dt, _host_op(op))
    return None


def _Barrier(self, device: bool = False) -> None:
    """MPI_Barrier through the comm's table: the host barrier over the
    pml, or with ``device=True`` the device plane's
    (ompi_tpu/mpi.py:663-670)."""
    self.check_revoked()
    self.check_failed()
    if device:
        return self.coll.barrier_dev(self)
    self.coll.barrier(self)


def Reduce_local(inbuf, inoutbuf, op=op_mod.SUM) -> None:
    """MPI_Reduce_local: ``inoutbuf = op(inbuf, inoutbuf)`` in place, on
    host buffers (``inbuf`` is the left operand)."""
    iarr, count, _ = _parse_buf(inbuf)
    oarr, ocount, _ = _parse_buf(inoutbuf)
    if count != ocount:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"Reduce_local: {count} elements in, {ocount} in-out")
    op_mod.reduce_local(np.asarray(iarr).reshape(-1)[:count],
                        np.asarray(oarr).reshape(-1)[:count], _host_op(op))


# -- the multi-buffer collectives (tensors; Allreduce_multi also host) -------

def _Allreduce_multi(self, bufs, op=op_mod.SUM, deterministic=None):
    """Fused (bucketed) allreduce over a pytree of tensors: dtype buckets
    of ``coll_device_bucket_bytes``, one allreduce each; returns a new
    pytree ('linear' is bitwise the per-buffer loop). A pytree of numpy
    arrays runs one host allreduce per buffer and returns new arrays in
    the same structure."""
    self.check_revoked()
    self.check_failed()
    if _host_tree(bufs):
        from ompi_tpu_torch.zero import layout as zl

        leaves, treedef = zl.tree_flatten(bufs)
        outs = []
        for a in leaves:
            arr = np.ascontiguousarray(a)
            out = np.empty_like(arr)
            self.coll.allreduce(self, arr, out, out.size, dtype_of(arr),
                                _host_op(op))
            outs.append(out)
        return type(bufs)(outs) if isinstance(bufs, (list, tuple)) \
            else zl.tree_unflatten(treedef, outs)
    return self.coll.allreduce_multi_dev(self, bufs, op,
                                         deterministic=deterministic)


def _Allreduce_multi_init(self, bufs, op=op_mod.SUM):
    """Persistent Allreduce_multi of tensors: planned at init, each
    start() runs the buckets on the tensors' current contents; req.array
    holds each cycle's pytree."""
    self.check_revoked()
    self.check_failed()
    _device_tree_or_raise("Allreduce_multi_init", bufs)
    return self.coll.allreduce_multi_init_dev(self, bufs, op)


def _Pallreduce_init(self, bufs, op=op_mod.SUM, deterministic=None):
    """MPI-4 partitioned fused allreduce of tensors: one partition per
    pytree leaf. start() opens a cycle; Pready(i[, value]) hands over
    leaf i, optionally with this cycle's tensor, and a bucket's
    allreduce runs the moment its last leaf is ready (the
    buckets and schedules of Allreduce_multi: 'linear' stays bitwise);
    wait() closes the cycle into req.array."""
    self.check_revoked()
    self.check_failed()
    _device_tree_or_raise("Pallreduce_init", bufs)
    return self.coll.pallreduce_init_dev(self, bufs, op,
                                         deterministic=deterministic)


def _Reduce_scatter_multi(self, bufs, op=op_mod.SUM, deterministic=None):
    """Bucketed reduce-scatter over a pytree (the zero/ gradient step):
    dtype-segregated buckets, each padded to a multiple of the comm size
    and reduce-scattered once; returns a zero.ShardedState of this
    rank's 1-D shard per bucket ('linear' stays bit-identical to the
    per-buffer allreduce fold). Numpy leaves run the host bucket cycle
    (one host allreduce per bucket, numpy shards)."""
    self.check_revoked()
    self.check_failed()
    if _host_tree(bufs):
        from ompi_tpu_torch.zero import layout as zl

        return zl.host_reduce_scatter_multi(self, bufs, _host_op(op))
    return self.coll.reduce_scatter_multi_dev(
        self, bufs, op, deterministic=deterministic)


def _Reduce_scatter_multi_init(self, bufs, op=op_mod.SUM,
                               deterministic=None):
    """Persistent Reduce_scatter_multi of tensors: planned and mapped at
    init, each start() reduce-scatters the buckets' current contents;
    req.array holds the cycle's ShardedState."""
    self.check_revoked()
    self.check_failed()
    _device_tree_or_raise("Reduce_scatter_multi_init", bufs)
    return self.coll.reduce_scatter_multi_init_dev(
        self, bufs, op, deterministic=deterministic)


def _Allgather_multi(self, state):
    """Rebuild the full pytree from a zero.ShardedState: one allgather
    per bucket, rank-order concat (= the pack order), pad dropped, leaf
    shapes restored. Numpy shards gather over the host object channel."""
    self.check_revoked()
    self.check_failed()
    if _host_tree(state):
        from ompi_tpu_torch.zero import layout as zl

        return zl.host_allgather_multi(self, state)
    return self.coll.allgather_multi_dev(self, state)


def _Allgather_multi_init(self, state):
    """Persistent Allgather_multi of tensor shards: checked and mapped at
    init, each start() gathers the bound shards; req.array holds the
    pytree. ``req.rebind(new_state)`` swaps in a same-plan state's shards
    without a new plan (ZeRO stage 3's per-step refresh);
    ``req.discard()`` drops a finished cycle's result."""
    self.check_revoked()
    self.check_failed()
    _device_tree_or_raise("Allgather_multi_init", state)
    return self.coll.allgather_multi_init_dev(self, state)


def _Preduce_scatter_init(self, bufs, op=op_mod.SUM, deterministic=None):
    """MPI-4 partitioned fused reduce-scatter of tensors, the overlapped
    ZeRO gradient step: one partition per pytree leaf, Pready(i[, value])
    hands leaf i over and a bucket's reduce-scatter runs the moment its
    last leaf is ready (zero_overlap_flushes counts the buckets that beat
    the final Pready); wait() closes the cycle, req.array is the
    ShardedState (Reduce_scatter_multi's bits)."""
    self.check_revoked()
    self.check_failed()
    _device_tree_or_raise("Preduce_scatter_init", bufs)
    return self.coll.preduce_scatter_init_dev(
        self, bufs, op, deterministic=deterministic)


# -- the nonblocking collectives (coll/libnbc for host buffers; a tensor's
# request is coll/device's DeviceRequest, whose .array is the result) ------

def _Ibarrier(self, device: bool = False):
    """libnbc's dissemination schedule, or with ``device=True`` the
    device barrier's request."""
    if device:
        return self.coll.ibarrier_dev(self)
    return self.coll.ibarrier(self)


def _Ibcast(self, buf, root: int = 0):
    """A ``(tensor, count, datatype)`` buf: as Bcast's, and the request's
    ``.array`` is the tensor once the scatter has run."""
    d = _parse_dev(buf)
    if d is not None:
        arr, count, dt = d
        if count is None:
            return self.coll.ibcast_dev(self, arr, root)
        req = self.coll.ibcast_dev(self, _dev_send_or_plan(
            self.rank == root, arr, count, dt), root)
        if self.rank != root:
            dtdev.unpack(req.array, dt, count, arr)
        # complete once the scatter queued on arr's device has run
        return DeviceRequest(arr, arr.device)
    _check_root(self, root)
    arr, count, dt = _parse_buf(buf)
    return self.coll.ibcast(self, arr, count, dt, root)


def _Iallreduce(self, sendbuf, recvbuf=None, op=op_mod.SUM,
                deterministic=None):
    """A ``(tensor, count, datatype)`` sendbuf: as Allreduce's, and the
    request's ``.array`` is the tensor once the scatter has run."""
    d = _parse_dev(sendbuf)
    if d is not None:
        arr, count, dt = d
        req = self.coll.iallreduce_dev(self, _dev_pack(arr, count, dt), op,
                                       deterministic=deterministic)
        if count is None:
            return req
        dtdev.unpack(req.array, dt, count, arr)
        # complete once the scatter queued on arr's device has run
        return DeviceRequest(arr, arr.device)
    rarr, rcount, rdt = _parse_buf(_require_recvbuf(recvbuf, "Iallreduce"))
    if sendbuf is IN_PLACE:
        return self.coll.iallreduce(self, IN_PLACE, rarr, rcount, rdt,
                                    _host_op(op))
    sarr, count, dt = _parse_buf(sendbuf)
    return self.coll.iallreduce(self, sarr, rarr, count, dt, _host_op(op))


def _Ireduce(self, sendbuf, recvbuf=None, op=op_mod.SUM, root: int = 0,
             deterministic=None):
    if _is_dev(sendbuf):
        return self.coll.ireduce_dev(self, sendbuf, op, root,
                                     deterministic=deterministic)
    _check_root(self, root)
    rarr = None if recvbuf is None else _parse_buf(recvbuf)[0]
    if sendbuf is IN_PLACE:
        sarr = IN_PLACE
        count, dt = _parse_buf(_require_recvbuf(recvbuf, "Ireduce"))[1:]
    else:
        sarr, count, dt = _parse_buf(sendbuf)
    return self.coll.ireduce(self, sarr, rarr, count, dt, _host_op(op),
                             root)


def _Igather(self, sendbuf, recvbuf=None, root: int = 0):
    if _is_dev(sendbuf):
        return self.coll.igather_dev(self, sendbuf, root)
    _check_root(self, root)
    sarr, count, dt = _parse_buf(sendbuf)
    rarr = None if recvbuf is None else _parse_buf(recvbuf)[0]
    return self.coll.igather(self, sarr, rarr, count, dt, root)


def _Iscatter(self, sendbuf, recvbuf=None, root: int = 0,
              device: bool = False):
    if device or _is_dev(sendbuf):
        return self.coll.iscatter_dev(self, sendbuf, root, like=recvbuf)
    _check_root(self, root)
    rarr, count, dt = _parse_buf(_require_recvbuf(recvbuf, "Iscatter"))
    sarr = None if sendbuf is None else _parse_buf(sendbuf)[0]
    return self.coll.iscatter(self, sarr, rarr, count, dt, root)


def _Iallgather(self, sendbuf, recvbuf=None):
    if _is_dev(sendbuf):
        return self.coll.iallgather_dev(self, sendbuf)
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Iallgather"))[0]
    if sendbuf is IN_PLACE:
        return self.coll.iallgather(self, IN_PLACE, rarr,
                                    np.asarray(rarr).size // self.size,
                                    dtype_of(rarr))
    sarr, count, dt = _parse_buf(sendbuf)
    return self.coll.iallgather(self, sarr, rarr, count, dt)


def _Ialltoall(self, sendbuf, recvbuf=None):
    if _is_dev(sendbuf):
        return self.coll.ialltoall_dev(self, sendbuf)
    sarr = _parse_buf(sendbuf)[0]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Ialltoall"))[0]
    return self.coll.ialltoall(self, sarr, rarr,
                               np.asarray(sarr).size // self.size,
                               dtype_of(sarr))


def _Igatherv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0):
    if _is_dev(sendbuf):
        return self.coll.igatherv_dev(self, sendbuf, counts, root)
    _check_root(self, root)
    counts = [int(c) for c in counts]
    sarr = _parse_buf(sendbuf)[0]
    rarr = None if recvbuf is None else _parse_buf(recvbuf)[0]
    return self.coll.igatherv(self, sarr, rarr, counts,
                              packed_displs(counts) if displs is None
                              else list(displs), dtype_of(sarr), root)


def _Iscatterv(self, sendbuf, recvbuf, counts, displs=None, root: int = 0,
               device: bool = False):
    if device or _is_dev(sendbuf):
        _packed_displs_or_raise(counts, displs, "Iscatterv")
        return self.coll.iscatterv_dev(self, sendbuf, counts, root,
                                       like=recvbuf)
    _check_root(self, root)
    counts = [int(c) for c in counts]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Iscatterv"))[0]
    sarr = None if sendbuf is None else _parse_buf(sendbuf)[0]
    return self.coll.iscatterv(self, sarr, rarr, counts,
                               packed_displs(counts) if displs is None
                               else list(displs), dtype_of(rarr), root)


def _Iallgatherv(self, sendbuf, recvbuf, counts, displs=None):
    if _is_dev(sendbuf):
        return self.coll.iallgatherv_dev(self, sendbuf, counts)
    counts = [int(c) for c in counts]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Iallgatherv"))[0]
    sarr = IN_PLACE if sendbuf is IN_PLACE else _parse_buf(sendbuf)[0]
    return self.coll.iallgatherv(self, sarr, rarr, counts,
                                 packed_displs(counts) if displs is None
                                 else list(displs), dtype_of(rarr))


def _Ialltoallv(self, sendbuf, recvbuf, scounts, rcounts, sdispls=None,
                rdispls=None, max_count=None):
    if _is_dev(sendbuf):
        _packed_displs_or_raise(scounts, sdispls, "Ialltoallv")
        return self.coll.ialltoallv_dev(self, sendbuf, scounts, rcounts,
                                        max_count=max_count)
    scounts = [int(c) for c in scounts]
    rcounts = [int(c) for c in rcounts]
    sarr = _parse_buf(sendbuf)[0]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Ialltoallv"))[0]
    return self.coll.ialltoallv(
        self, sarr, rarr, scounts,
        packed_displs(scounts) if sdispls is None else list(sdispls),
        rcounts, packed_displs(rcounts) if rdispls is None
        else list(rdispls), dtype_of(sarr))


def _Iscan(self, sendbuf, recvbuf=None, op=op_mod.SUM, deterministic=None):
    if _is_dev(sendbuf):
        return self.coll.iscan_dev(self, sendbuf, op,
                                   deterministic=deterministic)
    rarr, count, dt = _parse_buf(_require_recvbuf(recvbuf, "Iscan"))
    sarr = IN_PLACE if sendbuf is IN_PLACE else _parse_buf(sendbuf)[0]
    return self.coll.iscan(self, sarr, rarr, count, dt, _host_op(op))


def _Iexscan(self, sendbuf, recvbuf=None, op=op_mod.SUM,
             deterministic=None):
    if _is_dev(sendbuf):
        return self.coll.iexscan_dev(self, sendbuf, op,
                                     deterministic=deterministic)
    rarr, count, dt = _parse_buf(_require_recvbuf(recvbuf, "Iexscan"))
    sarr = IN_PLACE if sendbuf is IN_PLACE else _parse_buf(sendbuf)[0]
    return self.coll.iexscan(self, sarr, rarr, count, dt, _host_op(op))


def _Ireduce_scatter_block(self, sendbuf, recvbuf=None, op=op_mod.SUM,
                           deterministic=None):
    if _is_dev(sendbuf):
        return self.coll.ireduce_scatter_block_dev(
            self, sendbuf, op, deterministic=deterministic)
    rarr, count, dt = _parse_buf(
        _require_recvbuf(recvbuf, "Ireduce_scatter_block"))
    return self.coll.ireduce_scatter_block(
        self, _parse_buf(sendbuf)[0], rarr, count, dt, _host_op(op))


def _Ireduce_scatter(self, sendbuf, recvbuf, counts, op=op_mod.SUM,
                     deterministic=None):
    if _is_dev(sendbuf):
        return self.coll.ireduce_scatter_dev(self, sendbuf, counts, op,
                                             deterministic=deterministic)
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Ireduce_scatter"))[0]
    return self.coll.ireduce_scatter(
        self, _parse_buf(sendbuf)[0], rarr, [int(c) for c in counts],
        dtype_of(rarr), _host_op(op))


# -- MPI-4 persistent collectives (coll/libnbc's *_init for host buffers,
# coll/device's PersistentDeviceRequest for tensors) -------------------------

def _Barrier_init(self):
    return self.coll.barrier_init(self)


def _Bcast_init(self, buf, root: int = 0):
    if _is_dev(buf):
        return self.coll.bcast_init_dev(self, buf, root)
    _check_root(self, root)
    arr, count, dt = _parse_buf(buf)
    return self.coll.bcast_init(self, arr, count, dt, root)


def _Allreduce_init(self, sendbuf, recvbuf=None, op=op_mod.SUM,
                    deterministic=None):
    if _is_dev(sendbuf):
        return self.coll.allreduce_init_dev(self, sendbuf, op,
                                            deterministic=deterministic)
    sarr, count, dt = _parse_buf(sendbuf)
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Allreduce_init"))[0]
    return self.coll.allreduce_init(self, sarr, rarr, count, dt,
                                    _host_op(op))


def _Reduce_init(self, sendbuf, recvbuf, op=op_mod.SUM, root: int = 0):
    _check_root(self, root)
    sarr, count, dt = _parse_buf(sendbuf)
    rarr = None if recvbuf is None else _parse_buf(recvbuf)[0]
    return self.coll.reduce_init(self, sarr, rarr, count, dt, _host_op(op),
                                 root)


def _Gather_init(self, sendbuf, recvbuf, root: int = 0):
    _check_root(self, root)
    sarr, count, dt = _parse_buf(sendbuf)
    rarr = None if recvbuf is None else _parse_buf(recvbuf)[0]
    return self.coll.gather_init(self, sarr, rarr, count, dt, root)


def _Scatter_init(self, sendbuf, recvbuf, root: int = 0):
    _check_root(self, root)
    rarr, count, dt = _parse_buf(_require_recvbuf(recvbuf, "Scatter_init"))
    sarr = None if sendbuf is None else _parse_buf(sendbuf)[0]
    return self.coll.scatter_init(self, sarr, rarr, count, dt, root)


def _Allgather_init(self, sendbuf, recvbuf=None):
    if _is_dev(sendbuf):
        return self.coll.allgather_init_dev(self, sendbuf)
    sarr, count, dt = _parse_buf(sendbuf)
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Allgather_init"))[0]
    return self.coll.allgather_init(self, sarr, rarr, count, dt)


def _Alltoall_init(self, sendbuf, recvbuf=None):
    if _is_dev(sendbuf):
        return self.coll.alltoall_init_dev(self, sendbuf)
    sarr = _parse_buf(sendbuf)[0]
    rarr = _parse_buf(_require_recvbuf(recvbuf, "Alltoall_init"))[0]
    return self.coll.alltoall_init(self, sarr, rarr,
                                   np.asarray(sarr).size // self.size,
                                   dtype_of(sarr))


def _Reduce_scatter_block_init(self, sendbuf, recvbuf=None, op=op_mod.SUM,
                               deterministic=None):
    if _is_dev(sendbuf):
        return self.coll.reduce_scatter_block_init_dev(
            self, sendbuf, op, deterministic=deterministic)
    rarr, count, dt = _parse_buf(
        _require_recvbuf(recvbuf, "Reduce_scatter_block_init"))
    return self.coll.reduce_scatter_block_init(
        self, _parse_buf(sendbuf)[0], rarr, count, dt, _host_op(op))


# ---------------------------------------------------------------------------
# the errhandler plane (ompi_tpu/mpi.py:1366-1431)
# ---------------------------------------------------------------------------

def _Set_errhandler(self, eh) -> None:
    """MPI_Comm_set_errhandler: a string mode (``ERRORS_RETURN``,
    ``ERRORS_ARE_FATAL``) or an Errhandler (Comm_create_errhandler).
    dup, split, create and create_group inherit it."""
    self.errhandler = eh


def _Get_errhandler(self):
    return self.errhandler


def _with_errhandler(fn):
    """Route an MPIError escaping a binding through the comm's
    errhandler (the reference's OMPI_ERRHANDLER_INVOKE at every binding's
    error exit, e.g. allreduce.c). The string modes re-raise; a callback
    that returns makes the call recover (it returns None); a callback
    that raises propagates.

    The same holds for host buffers and tensors. On the device plane a
    recovery is safe only for an error that every rank detects before
    its first hop (a root outside the comm, which raises ERR_ROOT on
    every rank; an op the kernels do not take; a bad argument checked
    at entry): every rank then recovers at the same call and the next
    collective pairs up. An error that one rank meets after the
    schedule has begun leaves its peers inside the schedule, so it
    stays fatal, as in the reference."""
    def wrapped(self, *a, **kw):
        try:
            return fn(self, *a, **kw)
        except errors.MPIError as exc:
            errors.dispatch(self, exc)  # raises unless a callback
            return None                 # handled it
    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


#: the capitalised buffer operations whose errors route through the
#: comm's errhandler (the OMPI_ERRHANDLER_INVOKE set). The I-forms
#: surface errors at wait: Isend / Irecv stamp ``.comm`` on their
#: requests and ``Request.wait`` dispatches on it.
_ERRHANDLED = (
    "Send", "Recv", "Ssend", "Rsend", "Bsend", "Sendrecv",
    "Sendrecv_replace", "Mrecv", "Probe", "Barrier", "Bcast",
    "Reduce", "Allreduce", "Gather", "Gatherv", "Scatter", "Scatterv",
    "Allgather", "Allgatherv", "Alltoall", "Alltoallv",
    "Reduce_scatter", "Reduce_scatter_block", "Scan", "Exscan",
    "Allreduce_multi", "Reduce_scatter_multi", "Allgather_multi",
)


#: the API functions bound to Communicator, by name (the reference's
#: ``_API`` table; :mod:`ompi_tpu_torch.profile` interposes on these)
_API: dict = {}


def _bind(name: str, fn) -> None:
    """Attach an API function to Communicator, wrapped in the errhandler
    dispatch where the reference's binding invokes it."""
    _API[name] = fn
    setattr(Communicator, name,
            _with_errhandler(fn) if name in _ERRHANDLED else fn)


for _fn in (_Allreduce, _Reduce, _Reduce_scatter_block, _Reduce_scatter,
            _Allgather, _Allgatherv, _Bcast, _Alltoall, _Alltoallv, _Gather,
            _Gatherv, _Scatter, _Scatterv, _Scan, _Exscan, _Barrier,
            _Allreduce_multi, _Allreduce_multi_init, _Reduce_scatter_multi,
            _Allgather_multi, _Pallreduce_init, _Reduce_scatter_multi_init,
            _Allgather_multi_init, _Preduce_scatter_init, _Ibarrier,
            _Ibcast, _Iallreduce, _Ireduce, _Igather, _Iscatter,
            _Iallgather, _Ialltoall, _Igatherv, _Iscatterv, _Iallgatherv,
            _Ialltoallv, _Iscan, _Iexscan,
            _Ireduce_scatter_block, _Ireduce_scatter, _Barrier_init,
            _Bcast_init, _Allreduce_init, _Reduce_init, _Gather_init,
            _Scatter_init, _Allgather_init, _Alltoall_init,
            _Reduce_scatter_block_init):
    _bind(_fn.__name__[1:], _fn)


# ---------------------------------------------------------------------------
# point-to-point (ompi_tpu/mpi.py:37-660)
# ---------------------------------------------------------------------------

#: the entries whose device branch takes a (tensor, count[, datatype])
DEV_TUPLE_ENTRIES = ("Send", "Isend", "Rsend", "Recv", "Irecv", "Sendrecv",
                     "Isendrecv", "Bcast", "Allreduce", "Ibcast",
                     "Iallreduce")


def _parse_buf(buf) -> Tuple[Any, int, Optional[Datatype]]:
    """(buffer, count, datatype) from a host buffer spec: ``array``,
    ``(array, count)`` or ``(array, count, Datatype)``."""
    if isinstance(buf, tuple):
        if _is_dev(buf[0]):
            raise errors.MPIError(
                errors.ERR_NOT_SUPPORTED,
                "a (tensor, count[, datatype]) buffer packs on the device "
                "in " + " / ".join(DEV_TUPLE_ENTRIES) + "; this call has "
                "no device derived-datatype route")
        _contiguous_or_raise(buf[0])
        if len(buf) == 2:
            arr, count = buf
            return arr, int(count), dtype_of(arr)
        arr, count, dt = buf
        if not isinstance(dt, Datatype):
            raise errors.MPIError(errors.ERR_TYPE,
                                  f"{dt!r} is not a Datatype")
        return arr, int(count), dt
    if _is_dev(buf):
        raise TypeError(
            "tensor passed to an operation without a device path: the "
            "device entries are Send / Isend / Rsend / Recv / Irecv / "
            "Sendrecv / Isendrecv and the collectives")
    if isinstance(buf, np.ndarray):
        _contiguous_or_raise(buf)
        return buf, buf.size, dtype_of(buf)
    return buf, memoryview(buf).nbytes, None


def _contiguous_or_raise(arr) -> None:
    """A numpy buffer is read and written through its byte view, which a
    non-contiguous array does not have."""
    if isinstance(arr, np.ndarray) and not arr.flags["C_CONTIGUOUS"]:
        raise errors.MPIError(
            errors.ERR_BUFFER,
            "a non-contiguous numpy buffer: describe its layout with a "
            "derived datatype over the contiguous base array, e.g. "
            "(base, 1, datatype.vector(...)), or pass "
            "np.ascontiguousarray(buf)")


def _parse_dev(buf):
    """(tensor, count, datatype) when ``buf`` takes the device branch: a
    bare tensor (count and datatype None) or a (tensor, count[,
    datatype]) tuple; None for host buffers. Built by hand, not through
    _parse_buf, so nothing reads the tensor on the host."""
    if _is_dev(buf):
        return buf, None, None
    if isinstance(buf, tuple) and len(buf) in (2, 3) and _is_dev(buf[0]):
        dt = buf[2] if len(buf) == 3 else None
        if dt is not None and not isinstance(dt, Datatype):
            raise errors.MPIError(errors.ERR_TYPE,
                                  f"{dt!r} is not a Datatype")
        return buf[0], int(buf[1]), dt
    return None


def _dev_pack(arr, count, dt):
    """The send side's device convertor: the packed form (one gather on
    arr's device) of a tuple form; a bare tensor as it is."""
    return arr if count is None else dtdev.pack(arr, dt, count)


def _dev_packed_like(arr, count, dt):
    """An empty packed receive tensor of a tuple form, on arr's device."""
    return torch.zeros(dtdev.packed_elems(dt, count, arr.element_size()),
                       dtype=arr.dtype, device=arr.device)


def _dev_send_or_plan(sending: bool, arr, count, dt):
    """The packed operand of a rooted tuple-form call: the root's pack,
    the others' empty receive tensor (no gather of what the call
    overwrites)."""
    return _dev_pack(arr, count, dt) if sending \
        else _dev_packed_like(arr, count, dt)


def _dev_recv_plan(arr, count, dt):
    """(receive tensor, transform) of a device receive: a bare tensor
    receives in place; a tuple form receives its packed form, which the
    transform scatters into arr."""
    if count is None:
        return arr, None
    return (_dev_packed_like(arr, count, dt),
            lambda packed: dtdev.unpack(packed, dt, count, arr))


def _check_rank(comm, rank: int) -> None:
    """A peer rank of the comm (of the remote group on an
    intercommunicator)."""
    if rank in (PROC_NULL, ANY_SOURCE):
        return
    n = comm.remote_size if getattr(comm, "is_inter", False) else comm.size
    if not 0 <= rank < n:
        raise errors.RankError(f"rank {rank} out of range for {comm}")


def _copy_status(st: Status, status: Optional[Status]) -> None:
    if status is not None:
        status.source, status.tag = st.source, st.tag
        status.count, status.error = st.count, st.error


# -- the object (pickled) point-to-point --

def _send(self, obj, dest: int, tag: int = 0) -> None:
    self.check_revoked()
    _check_rank(self, dest)
    pvar.record("send")
    pml.current().send_obj(self, obj, dest, tag)


def _isend(self, obj, dest: int, tag: int = 0) -> Request:
    self.check_revoked()
    _check_rank(self, dest)
    return pml.current().isend_obj(self, obj, dest, tag)


def _recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
          status: Optional[Status] = None):
    self.check_revoked()
    req = pml.current().irecv_obj(self, source, tag)
    _copy_status(req.wait(), status)
    return req._obj


def _irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Request:
    """The object arrives in the request's ``_obj`` at completion."""
    self.check_revoked()
    return pml.current().irecv_obj(self, source, tag)


def _sendrecv(self, obj, dest: int, source: int = ANY_SOURCE,
              sendtag: int = 0, recvtag: int = ANY_TAG):
    rreq = pml.current().irecv_obj(self, source, recvtag)
    sreq = pml.current().isend_obj(self, obj, dest, sendtag)
    rreq.wait()
    sreq.wait()
    return rreq._obj


# -- the buffer point-to-point --

def _Send(self, buf, dest: int, tag: int = 0) -> None:
    """A tensor goes through the pipelined staging of
    ``pml/accel_p2p``."""
    self.check_revoked()
    _check_rank(self, dest)
    pvar.record("send")
    d = _parse_dev(buf)
    if d is not None:
        from ompi_tpu_torch.pml import accel_p2p

        arr, count, dt = d
        accel_p2p.check_tensor(arr, "Send")
        return accel_p2p.send_dev(self, _dev_pack(arr, count, dt), dest,
                                  tag)
    arr, count, dt = _parse_buf(buf)
    pml.current().send(self, arr, count, dt, dest, tag)


def _Isend(self, buf, dest: int, tag: int = 0) -> Request:
    self.check_revoked()
    _check_rank(self, dest)
    d = _parse_dev(buf)
    if d is not None:
        from ompi_tpu_torch.pml import accel_p2p

        arr, count, dt = d
        accel_p2p.check_tensor(arr, "Isend")
        req = accel_p2p.isend_dev(self, _dev_pack(arr, count, dt), dest,
                                  tag)
    else:
        arr, count, dt = _parse_buf(buf)
        req = pml.current().isend(self, arr, count, dt, dest, tag)
    req.comm = self  # the errhandler dispatch at wait (pml/request.py)
    return req


def _Ssend(self, buf, dest: int, tag: int = 0) -> None:
    """Synchronous send: completes once the receiver has matched."""
    self.check_revoked()
    arr, count, dt = _parse_buf(buf)
    pml.current().send(self, arr, count, dt, dest, tag, sync=True)


def _Issend(self, buf, dest: int, tag: int = 0) -> Request:
    arr, count, dt = _parse_buf(buf)
    return pml.current().isend(self, arr, count, dt, dest, tag, sync=True)


def _Rsend(self, buf, dest: int, tag: int = 0) -> None:
    """Ready send: the receive is posted, so the eager path is the
    same as Send's."""
    _Send(self, buf, dest, tag)


#: MPI_BSEND_OVERHEAD: per-message bookkeeping charged against an
#: attached buffer
BSEND_OVERHEAD = 64

#: None: no buffer attached, Bsend buffers without bound (the
#: reference's documented extension); attaching one opts into MPI's
#: capacity contract
_bsend_capacity: Optional[int] = None
_pending_bsends: List[Tuple[Request, int]] = []


def Buffer_attach(buf_or_size) -> None:
    """MPI_Buffer_attach: cap buffered-send memory at a byte count or a
    buffer's size (the copies are heap allocations; only the size
    counts). With a buffer attached, a Bsend past the capacity raises
    ERR_BUFFER."""
    global _bsend_capacity
    if _bsend_capacity is not None:
        raise errors.MPIError(errors.ERR_BUFFER,
                              "a bsend buffer is already attached")
    # numbers.Integral takes numpy ints too (which expose the buffer
    # protocol and would otherwise attach as 8 bytes)
    size = (int(buf_or_size) if isinstance(buf_or_size, numbers.Integral)
            else memoryview(buf_or_size).nbytes)
    if size < 0:
        raise errors.MPIError(errors.ERR_BUFFER,
                              f"negative buffer size {size}")
    _bsend_capacity = size


def Buffer_detach() -> int:
    """MPI_Buffer_detach: blocks until every outstanding buffered send
    has delivered, then returns the detached size."""
    global _bsend_capacity
    if _bsend_capacity is None:
        raise errors.MPIError(errors.ERR_BUFFER, "no bsend buffer attached")
    _flush_bsends()
    size, _bsend_capacity = _bsend_capacity, None
    return size


def _flush_bsends() -> None:
    for r, _ in list(_pending_bsends):
        r.wait()
    _pending_bsends.clear()


def _bsend_used() -> int:
    """Reclaim delivered copies (after one progress sweep: rendezvous
    completions flip inside a sweep), then the live charge."""
    from ompi_tpu_torch.core import progress

    progress.progress()
    _pending_bsends[:] = [(r, nb) for r, nb in _pending_bsends
                          if not r.completed]
    return sum(nb for _, nb in _pending_bsends)


def _Bsend(self, buf, dest: int, tag: int = 0) -> None:
    """Buffered send: copy now, deliver in the background."""
    arr, count, dt = _parse_buf(buf)
    if isinstance(arr, np.ndarray):
        copy = np.array(arr, copy=True)
    else:  # a raw buffer keeps its byte semantics
        copy = np.frombuffer(bytes(arr), dtype=np.uint8).copy()
    charge = copy.nbytes + BSEND_OVERHEAD
    if _bsend_capacity is not None \
            and _bsend_used() + charge > _bsend_capacity:
        raise errors.MPIError(
            errors.ERR_BUFFER,
            f"bsend of {copy.nbytes} bytes exceeds the attached buffer "
            f"({_bsend_capacity} bytes, {_bsend_used()} in flight)")
    _pending_bsends.append(
        (pml.current().isend(self, copy, count, dt, dest, tag), charge))


def _Recv(self, buf, source: int = ANY_SOURCE, tag: int = ANY_TAG,
          status: Optional[Status] = None):
    """A host buffer is filled in place and the Status returned; a
    tensor is received in place through ``pml/accel_p2p`` and returned
    (the Status goes to ``status``); a ``(tensor, count, datatype)``
    receives its packed form and scatters it into the tensor."""
    self.check_revoked()
    if _parse_dev(buf) is not None:
        req = _Irecv(self, buf, source, tag)
        _copy_status(req.wait(), status)
        return req.array
    arr, count, dt = _parse_buf(buf)
    st = pml.current().recv(self, arr, count, dt, source, tag)
    _copy_status(st, status)
    return st


def _Irecv(self, buf, source: int = ANY_SOURCE,
           tag: int = ANY_TAG) -> Request:
    """For a tensor (or a tuple form's tensor), the request's ``.array``
    is that tensor once complete."""
    self.check_revoked()
    d = _parse_dev(buf)
    if d is not None:
        from ompi_tpu_torch.pml import accel_p2p

        arr, count, dt = d
        accel_p2p.check_tensor(arr, "Irecv")
        if source == PROC_NULL:  # nothing arrives: arr stays as it is
            req = accel_p2p.irecv_dev(self, arr, source, tag)
        else:
            like, tr = _dev_recv_plan(arr, count, dt)
            req = accel_p2p.irecv_dev(self, like, source, tag, transform=tr)
    else:
        arr, count, dt = _parse_buf(buf)
        req = pml.current().irecv(self, arr, count, dt, source, tag)
    req.comm = self  # the errhandler dispatch at wait (pml/request.py)
    return req


def _Sendrecv(self, sendbuf, dest: int, recvbuf, source: int = ANY_SOURCE,
              sendtag: int = 0, recvtag: int = ANY_TAG) -> Status:
    rreq = _Irecv(self, recvbuf, source, recvtag)
    sreq = _Isend(self, sendbuf, dest, sendtag)
    st = rreq.wait()
    sreq.wait()
    return st


class _PairRequest(rq.Request):
    """One request over a (recv, send) pair, MPI-4's Isendrecv handle:
    complete when both are; its status is the receive's."""

    def __init__(self, rreq: Request, sreq: Request) -> None:
        super().__init__()
        self._rreq = rreq
        self._sreq = sreq

    @property
    def completed(self) -> bool:
        return self._rreq.completed and self._sreq.completed

    @completed.setter
    def completed(self, v: bool) -> None:
        pass  # the base __init__ writes here; the property is derived

    @property
    def status(self) -> Status:
        return self._rreq.status

    @status.setter
    def status(self, st) -> None:
        pass

    @property
    def array(self):
        return getattr(self._rreq, "array", None)

    def wait(self, timeout=None) -> Status:
        import time

        t0 = time.perf_counter()
        st = self._rreq.wait(timeout=timeout)
        rem = (None if timeout is None else
               max(0.0, timeout - (time.perf_counter() - t0)))
        self._sreq.wait(timeout=rem)  # one budget for both halves
        return st


def _Isendrecv(self, sendbuf, dest: int, recvbuf, source: int = ANY_SOURCE,
               sendtag: int = 0, recvtag: int = ANY_TAG) -> Request:
    """MPI_Isendrecv: both halves post now."""
    return _PairRequest(_Irecv(self, recvbuf, source, recvtag),
                        _Isend(self, sendbuf, dest, sendtag))


def _Isendrecv_replace(self, buf, dest: int, source: int = ANY_SOURCE,
                       sendtag: int = 0, recvtag: int = ANY_TAG) -> Request:
    """MPI_Isendrecv_replace: the send's snapshot is taken now (the
    receive overwrites ``buf`` as it lands)."""
    arr, count, dt = _parse_buf(buf)
    tmp = np.array(arr, copy=True)
    return _PairRequest(_Irecv(self, (arr, count, dt), source, recvtag),
                        _Isend(self, (tmp, count, dt), dest, sendtag))


def _Sendrecv_replace(self, buf, dest: int, source: int = ANY_SOURCE,
                      sendtag: int = 0, recvtag: int = ANY_TAG) -> Status:
    return _Isendrecv_replace(self, buf, dest, source, sendtag,
                              recvtag).wait()


def _Probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Status:
    return pml.current().probe(self, source, tag)


def _Iprobe(self, source: int = ANY_SOURCE,
            tag: int = ANY_TAG) -> Optional[Status]:
    return pml.current().iprobe(self, source, tag)


def _Mprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
    """(Message, Status) of a matched message, removed from matching."""
    return pml.current().mprobe(self, source, tag)


def _Improbe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
    return pml.current().improbe(self, source, tag)


def _Mrecv(self, msg, buf) -> Status:
    arr, count, dt = _parse_buf(buf)
    return pml.current().mrecv(msg, arr, count, dt)


class _PersistentRequest(rq.Request):
    """MPI_Send_init / MPI_Recv_init handles, restarted by start().
    ``completed`` / ``status`` follow the live inner request, so the
    plural waits see completion; an inactive request is complete."""

    def __init__(self, comm, kind: str, args: tuple) -> None:
        super().__init__()
        self.persistent = True
        self.comm = comm
        self.kind = kind
        self.args = args
        self._live: Optional[Request] = None

    @property
    def completed(self) -> bool:
        return self._live is None or self._live.completed

    @completed.setter
    def completed(self, v: bool) -> None:
        pass  # the base __init__ writes here; the property is derived

    @property
    def status(self) -> Status:
        return self._live.status if self._live is not None \
            else self._idle_status

    @status.setter
    def status(self, st) -> None:
        self._idle_status = st

    def start(self) -> None:
        p = pml.current()
        buf, count, dt, peer, tag = self.args
        self._live = (p.isend if self.kind == "send" else p.irecv)(
            self.comm, buf, count, dt, peer, tag)

    @property
    def active(self) -> bool:
        """Started and not yet known complete."""
        return self._live is not None and not self._live.completed

    def wait(self, timeout=None):
        if self._live is None:
            return self.status
        return self._live.wait(timeout=timeout)


def _Send_init(self, buf, dest: int, tag: int = 0) -> _PersistentRequest:
    arr, count, dt = _parse_buf(buf)
    return _PersistentRequest(self, "send", (arr, count, dt, dest, tag))


def _Recv_init(self, buf, source: int = ANY_SOURCE,
               tag: int = ANY_TAG) -> _PersistentRequest:
    arr, count, dt = _parse_buf(buf)
    return _PersistentRequest(self, "recv", (arr, count, dt, source, tag))


def start_all(reqs: Sequence[Request]) -> None:
    """MPI_Startall over any mix of persistent and partitioned requests
    (Send_init / Recv_init, the ``*_init`` collectives, Psend_init /
    Precv_init, Pallreduce_init, Preduce_scatter_init), all or nothing:
    the whole set is checked before any request starts. A request that
    is not startable raises ERR_REQUEST (the reference: TypeError), and
    so does one whose last cycle is still active (MPI 4.0 §4.2)."""
    for r in reqs:
        if not getattr(r, "persistent", False) \
                or not callable(getattr(r, "start", None)):
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"start_all: request {getattr(r, 'id', r)!r} is not a "
                "startable (persistent or partitioned) request (no request "
                "was started)")
    for r in reqs:
        if getattr(r, "active", False):
            raise errors.MPIError(
                errors.ERR_REQUEST,
                f"start_all: request {getattr(r, 'id', '?')} is still "
                "active — wait/test it to completion before restarting (no "
                "request was started)")
    for r in reqs:
        r.start()


Startall = start_all


def _Pack(self, inbuf, outbuf, position: int = 0) -> int:
    """MPI_Pack: inbuf's packed bytes into outbuf at position; returns
    the new position."""
    from ompi_tpu_torch.datatype import BYTE, Convertor

    arr, count, dt = _parse_buf(inbuf)
    data = Convertor(arr, dt or BYTE, count).pack()
    out = memoryview(outbuf).cast("B")
    if position + len(data) > len(out):
        raise errors.TruncateError(
            f"Pack: need {position + len(data)} bytes, outbuf has "
            f"{len(out)}")
    out[position:position + len(data)] = data
    return position + len(data)


def _Unpack(self, inbuf, position: int, outbuf) -> int:
    """MPI_Unpack: packed bytes of inbuf at position into outbuf;
    returns the new position."""
    from ompi_tpu_torch.datatype import BYTE, Convertor

    arr, count, dt = _parse_buf(outbuf)
    conv = Convertor(arr, dt or BYTE, count)
    src = memoryview(inbuf).cast("B")
    need = conv.packed_size
    if position + need > len(src):
        raise errors.TruncateError(
            f"Unpack: need {need} bytes at position {position}, inbuf "
            f"has {len(src)}")
    conv.unpack(bytes(src[position:position + need]))
    return position + need


def _Pack_size(self, count: int, dtype) -> int:
    """MPI_Pack_size: an upper bound on Pack's output bytes."""
    dt = dtype if isinstance(dtype, Datatype) else dtype_of(
        np.empty(0, dtype))
    return count * dt.size


# the MPI_Pack family as module functions, as the reference's, with the
# canonical big-endian external32 representation
from ompi_tpu_torch.datatype.convertor import (  # noqa: E402,F401
    pack as Pack, pack_external as Pack_external, unpack as Unpack,
    unpack_external as Unpack_external,
)


# -- the object collectives (coll/basic over the pml) --

def _barrier(self) -> None:
    self.coll.barrier(self)


def _bcast(self, obj=None, root: int = 0):
    self.check_revoked()
    return self.coll.bcast_obj(self, obj, root)


def _gather(self, obj, root: int = 0):
    return self.coll.gather_obj(self, obj, root)


def _scatter(self, objs=None, root: int = 0):
    return self.coll.scatter_obj(self, objs, root)


def _allgather(self, obj):
    return self.coll.allgather_obj(self, obj)


def _alltoall(self, objs):
    return self.coll.alltoall_obj(self, objs)


def _obj_fn(op):
    """An op for the object reductions: a callable, an Op (its numpy
    function, as the reference folds) or None (+)."""
    if isinstance(op, op_mod.Op):
        return op.np_fn
    return op if callable(op) else (lambda a, b: a + b)


def _allreduce(self, obj, op=None):
    return self.coll.allreduce_obj(self, obj, _obj_fn(op))


def _reduce(self, obj, op=None, root: int = 0):
    vals = self.coll.gather_obj(self, obj, root)
    if vals is None:
        return None
    fn = _obj_fn(op)
    acc = vals[0]
    for v in vals[1:]:
        acc = fn(acc, v)
    return acc


for _name, _fn in {
        "send": _send, "isend": _isend, "recv": _recv, "irecv": _irecv,
        "sendrecv": _sendrecv, "Send": _Send, "Isend": _Isend,
        "Ssend": _Ssend, "Issend": _Issend, "Rsend": _Rsend,
        "Bsend": _Bsend, "Recv": _Recv, "Irecv": _Irecv,
        "Sendrecv": _Sendrecv, "Sendrecv_replace": _Sendrecv_replace,
        "Isendrecv": _Isendrecv, "Isendrecv_replace": _Isendrecv_replace,
        "Probe": _Probe, "Iprobe": _Iprobe, "Mprobe": _Mprobe,
        "Improbe": _Improbe, "Mrecv": _Mrecv, "Send_init": _Send_init,
        "Recv_init": _Recv_init, "Pack": _Pack, "Unpack": _Unpack,
        "Pack_size": _Pack_size, "barrier": _barrier, "bcast": _bcast,
        "gather": _gather, "scatter": _scatter, "allgather": _allgather,
        "alltoall": _alltoall, "allreduce": _allreduce,
        "reduce": _reduce, "Set_errhandler": _Set_errhandler,
        "Get_errhandler": _Get_errhandler}.items():
    _bind(_name, _fn)


# attribute caching (ompi/attribute/attribute.c; the predefined
# attributes of attribute_predefined.c:119-195) and Info objects
from ompi_tpu_torch.attr import (  # noqa: E402,F401
    APPNUM, HOST, IO, KEYVAL_INVALID, LASTUSEDCODE, NO_COPY, TAG_UB,
    UNIVERSE_SIZE, WIN_BASE, WIN_CREATE_FLAVOR, WIN_DISP_UNIT, WIN_MODEL,
    WIN_SIZE, WTIME_IS_GLOBAL, dup_fn, null_copy_fn,
)
from ompi_tpu_torch.info import (  # noqa: E402,F401
    Info, MEMORY_ALLOC_KINDS, env_info as Info_env,
)
# the errhandler factories (ompi/errhandler/errhandler.h:401; one
# factory serves comms, windows and files) and the user error space
# (add_error_class.c, add_error_code.c, add_error_string.c)
from ompi_tpu_torch.errors import (  # noqa: E402,F401
    ERRORS_ABORT, ERRORS_ARE_FATAL, ERRORS_RETURN, Errhandler,
    add_error_class as Add_error_class,
    add_error_code as Add_error_code,
    add_error_string as Add_error_string,
    create_errhandler as Comm_create_errhandler,
    create_errhandler as Win_create_errhandler,
    create_errhandler as File_create_errhandler,
    error_class as Error_class,
    error_string as Error_string,
)

# MPI-4 partitioned point-to-point: Psend_init / Precv_init attach at
# import (ompi/mca/part)
from ompi_tpu_torch import part as _part  # noqa: E402,F401

# the topology API (Create_cart, Cart_sub, Neighbor_*) attaches its own
# Communicator methods at import (ompi/mca/topo)
from ompi_tpu_torch import topo as _topo  # noqa: E402,F401

# dynamic processes (ompi/dpm: the PMIx_Spawn counterpart)
from ompi_tpu_torch.dpm import (  # noqa: E402,F401
    appnum as Appnum, comm_spawn as Comm_spawn,
    comm_spawn_multiple as Comm_spawn_multiple,
    get_parent as Comm_get_parent,
)

# MPI-IO (ompio: ompi/mca/io + fs/fbtl/fcoll/sharedfp)
from ompi_tpu_torch.io import (  # noqa: E402,F401
    File, File_delete, File_open, MODE_APPEND, MODE_CREATE,
    MODE_DELETE_ON_CLOSE, MODE_EXCL, MODE_RDONLY, MODE_RDWR,
    MODE_SEQUENTIAL, MODE_WRONLY, SEEK_CUR, SEEK_END, SEEK_SET,
)


def Comm_create_keyval(copy_fn=None, delete_fn=None, extra_state=None):
    """MPI_Comm_create_keyval: ``copy_fn(obj, keyval, extra_state,
    value)`` -> the dup's value (NO_COPY drops it; None never copies);
    ``delete_fn(obj, keyval, value, extra_state)`` on delete, overwrite
    and free."""
    from ompi_tpu_torch import attr

    return attr.create_keyval("comm", copy_fn, delete_fn, extra_state)


def Win_create_keyval(copy_fn=None, delete_fn=None, extra_state=None):
    """MPI_Win_create_keyval: the same callbacks, on windows (``Free``
    deletes, before the window goes)."""
    from ompi_tpu_torch import attr

    return attr.create_keyval("win", copy_fn, delete_fn, extra_state)


def Type_create_keyval(copy_fn=None, delete_fn=None, extra_state=None):
    """MPI_Type_create_keyval: the same callbacks, on datatypes
    (``Datatype.dup`` copies, ``Datatype.free`` deletes)."""
    from ompi_tpu_torch import attr

    return attr.create_keyval("type", copy_fn, delete_fn, extra_state)


def Comm_free_keyval(keyval: int) -> int:
    from ompi_tpu_torch import attr

    return attr.free_keyval(keyval)


Win_free_keyval = Comm_free_keyval
Type_free_keyval = Comm_free_keyval


def Grequest_start(query_fn=None, free_fn=None, cancel_fn=None):
    """MPI_Grequest_start: a request the application completes with
    ``req.complete()`` (MPI_Grequest_complete)."""
    return rq.GeneralizedRequest(query_fn, free_fn, cancel_fn)


def Request_get_status(request) -> Tuple[bool, Status]:
    """MPI_Request_get_status (ompi/mpi/c/request_get_status.c): (flag,
    status). MPI_Test frees the handle, which the C binding exists to
    avoid; test() here frees nothing, so this is test() with the status
    beside it."""
    return request.test(), request.retrieve_status()


def Get_processor_name() -> str:
    from ompi_tpu_torch.runtime import rte

    return rte.hostname()


def Init(thread_level: int = 0):
    from ompi_tpu_torch.runtime import state

    return state.init(thread_level)


def Finalize() -> None:
    """MPI_Finalize: outstanding buffered sends deliver first."""
    from ompi_tpu_torch.runtime import state

    _flush_bsends()
    state.finalize()


def Is_initialized() -> bool:
    from ompi_tpu_torch.runtime import state

    return state.is_initialized()


def Session_init(info=None):
    """MPI-4 MPI_Session_init: a handle on the instance with no world
    model (reference: ompi/mpi/c/session_init.c over ompi/instance): query
    process sets, derive groups, build comms with Comm_create_from_group
    (see ``runtime.state.Session``)."""
    from ompi_tpu_torch.runtime import state

    return state.Session(info)


def Group_from_session_pset(session, pset_name: str):
    return session.group_from_pset(pset_name)


def Comm_create_from_group(group, tag: str = "org.ompi_tpu.default"):
    """MPI_Comm_create_from_group: collective over ``group``'s members,
    no parent comm; a group derived from a session ties the comm to it
    (Session.finalize frees it)."""
    from ompi_tpu_torch.runtime import state

    return state.comm_from_group(group, tag)


def Abort(comm=None, errorcode: int = 1) -> None:
    """MPI_Abort: the store broadcasts the abort, every rank blocked in a
    store call exits with ``errorcode``, this rank exits with it, and the
    launcher brings the rest of the job down (an errorcode of 0 exits
    with 1: the job still comes down)."""
    from ompi_tpu_torch.runtime import state

    state.abort(errorcode,
                f"MPI_Abort on {getattr(comm, 'name', 'the job')}")


def Wtime() -> float:
    import time

    return time.perf_counter()


def Wtick() -> float:
    """MPI_Wtick: the resolution of Wtime."""
    import time

    return time.get_clock_info("perf_counter").resolution


def Get_version():
    """MPI_Get_version: the standard level the reference targets (3.1
    with MPI-4's sessions, partitioned point-to-point and persistent
    collectives)."""
    return (3, 1)


def Get_library_version() -> str:
    return ("ompi_tpu_torch: the PyTorch/CUDA port of ompi_tpu "
            "(Open MPI big-count fork parity build)")


def __getattr__(name: str):
    if name == "COMM_WORLD":
        from ompi_tpu_torch.runtime import state

        return state.world()
    if name == "COMM_SELF":
        from ompi_tpu_torch.runtime import state

        return state.comm_self()
    raise AttributeError(name)
