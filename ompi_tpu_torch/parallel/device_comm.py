"""DeviceCommunicator — the communicator face of the device plane.

The port of :mod:`ompi_tpu.parallel.device_comm`. A communicator bound to
one or more axes of a :class:`~ompi_tpu_torch.parallel.mesh.Mesh`: its
collectives run on this rank's local tensor over the axis's
sub-communicator (:meth:`Mesh.comm_of`), through the coll/device slots
(:mod:`ompi_tpu_torch.parallel.collectives`). ``size`` and ``rank`` are
plain ints. :meth:`run` stands in for ``shard_map``: it slices this
rank's block of global inputs by their specs and calls the function on
it with the mesh active; :meth:`assemble` allgathers local results back
into global arrays.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.parallel import collectives as C
from ompi_tpu_torch.parallel.mesh import P

Axis = Union[str, Tuple[str, ...]]


class DeviceCommunicator:
    """A communicator bound to one or more axes of a mesh of ranks.

    Collective methods take this rank's local tensor; ``size`` and
    ``rank`` are this axis's (``rank`` the row-major index over the axes
    in the order given)."""

    def __init__(self, mesh, axis: Axis) -> None:
        self.mesh = mesh
        self.axis = axis if isinstance(axis, str) else tuple(axis)

    # -- identity ---------------------------------------------------------
    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def rank(self) -> int:
        """This rank's index along the axis."""
        return self.mesh.axis_index(self.axis)

    @property
    def comm(self):
        """The axis's sub-communicator (split on first use)."""
        return self.mesh.comm_of(self.axis)

    def sub(self, axis: Axis) -> "DeviceCommunicator":
        """Communicator over a different axis subset of the same mesh
        (MPI_Cart_sub analog)."""
        return DeviceCommunicator(self.mesh, axis)

    def replica_groups(self):
        """Rank groups along the axis — the groups the reference's
        communicator compiles to (introspection)."""
        names = self.mesh.axis_names
        ids = np.arange(self.mesh.devices.size).reshape(
            self.mesh.devices.shape)
        ax = (self.axis,) if isinstance(self.axis, str) else self.axis
        keep = [i for i, n in enumerate(names) if n not in ax]
        move = [i for i, n in enumerate(names) if n in ax]
        perm = keep + move
        t = ids.transpose(perm).reshape(-1, math.prod(
            [ids.shape[i] for i in move]) if move else 1)
        return [list(row) for row in t]

    # -- collectives (MPI names, device semantics) ------------------------
    def Allreduce(self, x, op=op_mod.SUM,
                  deterministic: Optional[str] = None):
        return C.allreduce(x, self.comm, op, deterministic)

    def Reduce(self, x, op=op_mod.SUM, root: int = 0,
               deterministic: Optional[str] = None):
        return C.reduce(x, self.comm, op, root, deterministic)

    def Reduce_scatter_block(self, x, op=op_mod.SUM, dim: int = 0,
                             deterministic: Optional[str] = None):
        return C.reduce_scatter(x, self.comm, op, scatter_dim=dim,
                                deterministic=deterministic)

    def Allgather(self, x, dim: int = 0, tiled: bool = True):
        return C.allgather(x, self.comm, tiled=tiled, gather_dim=dim)

    def Alltoall(self, x, split_dim: int = 0, concat_dim: int = 0):
        return C.alltoall(x, self.comm, split_dim, concat_dim)

    def Bcast(self, x, root: int = 0):
        return C.bcast(x, self.comm, root)

    def Scatter(self, x, root: int = 0, dim: int = 0):
        return C.scatter(x, self.comm, root, dim)

    def Gather(self, x, root: int = 0, dim: int = 0):
        return C.gather(x, self.comm, root, dim)

    def Scan(self, x, op=op_mod.SUM):
        return C.scan(x, self.comm, op)

    def Exscan(self, x, op=op_mod.SUM):
        return C.exscan(x, self.comm, op)

    def Barrier(self):
        return C.barrier(self.comm)

    def Sendrecv(self, x, perm: Sequence[Tuple[int, int]]):
        return C.ppermute(x, self.comm, perm)

    def Shift(self, x, offset: int = 1):
        return C.shift(x, self.comm, offset)

    # -- observability ----------------------------------------------------
    def record_expert_load(self, counts) -> None:
        """Feed per-expert token counts (e.g. the MoE router's dispatch
        histogram) into the monitoring plane's ``monitoring_expert_tokens``
        (a no-op while the plane is off)."""
        from ompi_tpu_torch import monitoring

        monitoring.expert_load([int(c) for c in counts])

    # -- launch -----------------------------------------------------------
    def run(self, fn: Callable, in_specs, out_specs=None):
        """``shard_map``'s counterpart: a callable that takes the global
        inputs (the same on every rank; numpy arrays or tensors), slices
        this rank's block of each by its spec (one :class:`P` for every
        argument, or a tuple of them, one per argument), moves it to this
        rank's device and calls ``fn`` on the blocks with the mesh
        active. Returns ``fn``'s local output (``out_specs``, the
        reference's argument, is what :meth:`assemble` takes)."""
        mesh = self.mesh

        def call(*args):
            specs = (in_specs,) * len(args) if isinstance(in_specs, P) \
                else tuple(in_specs)
            if len(specs) != len(args):
                raise errors.MPIError(
                    errors.ERR_ARG,
                    f"run: {len(specs)} in_specs for {len(args)} arguments")
            blocks = [local_block(mesh, a, s) for a, s in zip(args, specs)]
            with mesh:
                return fn(*blocks)
        return call

    def assemble(self, local, out_spec) -> np.ndarray:
        """The global array of every rank's ``local`` block placed by
        ``out_spec`` (an allgather over the mesh; bfloat16 comes back as
        its uint16 bits). A tuple of blocks with a tuple of specs gives a
        tuple."""
        if isinstance(local, (tuple, list)):
            specs = (out_spec,) * len(local) if isinstance(out_spec, P) \
                else out_spec
            return tuple(self.assemble(x, s) for x, s in zip(local, specs))
        return assemble(self.mesh, local, out_spec)


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_block(mesh, x, spec) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec``, on its
    device."""
    from ompi_tpu_torch import compat

    t = x if isinstance(x, torch.Tensor) else compat.tensor_from_numpy(
        np.asarray(x))
    spec = P() if spec is None else spec
    for dim, entry in enumerate(spec):
        ax = _spec_axes(entry)
        if not ax:
            continue
        n, idx = mesh.axis_size(ax), mesh.axis_index(ax)
        if t.shape[dim] % n:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"run: dim {dim} of shape {tuple(t.shape)} not divisible "
                f"by {n} (spec {spec!r})")
        k = t.shape[dim] // n
        t = t.narrow(dim, idx * k, k)
    return t.contiguous().to(C._device())


def assemble(mesh, local: torch.Tensor, spec) -> np.ndarray:
    """Every mesh rank's ``local`` block placed by ``spec`` into the
    global numpy array (collective over the mesh)."""
    from ompi_tpu_torch import compat
    from ompi_tpu_torch.coll import device as cd

    spec = P() if spec is None else spec
    g = compat.tensor_to_numpy(cd._allgather_prep(mesh.comm,
                                                  local.contiguous())())
    shape = list(local.shape)
    for dim, entry in enumerate(spec):
        ax = _spec_axes(entry)
        if ax:
            shape[dim] *= mesh.axis_size(ax)
    out = np.empty(shape, g.dtype)
    names = mesh.axis_names
    for p in range(mesh.size):
        coords = dict(zip(names, np.unravel_index(p, mesh.devices.shape)))
        idx = [slice(None)] * local.dim()
        for dim, entry in enumerate(spec):
            ax = _spec_axes(entry)
            if not ax:
                continue
            i = 0
            for a in ax:
                i = i * mesh.shape[a] + int(coords[a])
            k = local.shape[dim]
            idx[dim] = slice(i * k, (i + 1) * k)
        out[tuple(idx)] = g[p]
    return out


def world_comm(axis_names: Sequence[str] = ("x",),
               shape=None, devices=None) -> DeviceCommunicator:
    """The device plane's COMM_WORLD: a communicator over every axis of
    a fresh mesh of the ranks (``devices``: a parent communicator)."""
    from ompi_tpu_torch.parallel import mesh as mesh_mod

    m = mesh_mod.make_mesh(axis_names, shape, devices)
    ax = axis_names[0] if len(axis_names) == 1 else tuple(axis_names)
    return DeviceCommunicator(m, ax)
