"""A mesh of ranks — the topology plane.

The port of :mod:`ompi_tpu.parallel.mesh`. A mesh position is a rank of
a parent communicator (``COMM_WORLD`` unless given), laid out row-major
as ``np.arange(size).reshape(shape)``; an axis, or a tuple of axes, is a
``comm.split`` sub-communicator, made on first use and cached per axes
(:meth:`Mesh.comm_of`). Every rank of the mesh runs the same program, so
every rank makes the same splits in the same order, as ``comm.split``
requires.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.comm import UNDEFINED

Axis = Union[str, Tuple[str, ...]]


def _world():
    from ompi_tpu_torch import mpi

    return mpi.COMM_WORLD


def local_device_count() -> int:
    """The mesh positions there are: the ranks of ``COMM_WORLD``."""
    return _world().size


def mesh_shape_for(n: int, naxes: int = 1) -> Tuple[int, ...]:
    """Factor n ranks into `naxes` near-square mesh dims (largest
    factors first). E.g. (8, 2) -> (4, 2); (16, 3) -> (4, 2, 2)."""
    dims = [1] * naxes
    remaining = n
    for i in range(naxes - 1):
        # biggest divisor of `remaining` <= the even split
        target = int(round(remaining ** (1.0 / (naxes - i))))
        best = 1
        for d in range(1, remaining + 1):
            if remaining % d == 0 and d <= max(target, 1):
                best = d
        dims[i] = best
        remaining //= best
    dims[naxes - 1] = remaining
    dims.sort(reverse=True)
    return tuple(dims)


class P(tuple):
    """A partition spec: one entry per dim, None (replicated) or the axis
    name, or tuple of names, that the dim is split over (jax's
    ``PartitionSpec``); trailing dims left out are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


_active = threading.local()


def active_mesh() -> "Mesh":
    """The mesh of the innermost ``with mesh:`` (or running
    ``DeviceCommunicator.run``) on this thread."""
    stack = getattr(_active, "stack", None)
    if not stack:
        raise errors.MPIError(
            errors.ERR_ARG,
            "no active mesh: call axis collectives inside "
            "DeviceCommunicator.run or `with mesh:`")
    return stack[-1]


class Mesh:
    """Ranks ``devices`` (a numpy array of the parent's ranks, one per
    position) under named axes. ``comm`` is the parent split down to the
    mesh's members (the parent itself when every rank is one); a rank
    outside the mesh holds ``comm`` None and ``coords`` None."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 comm) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.comm = comm
        self._comms: dict = {}
        self.coords: Optional[Tuple[int, ...]] = None
        if comm is not None:  # the mesh comm's rank is the position
            self.coords = tuple(int(c) for c in
                                np.unravel_index(comm.rank, devices.shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axes(self, axis: Axis) -> Tuple[str, ...]:
        ax = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in ax:
            if a not in self.axis_names:
                raise errors.MPIError(
                    errors.ERR_ARG,
                    f"axis {a!r} is not an axis of the mesh "
                    f"{self.axis_names}")
        return ax

    def axis_size(self, axis: Axis) -> int:
        shape = self.shape
        return math.prod(shape[a] for a in self.axes(axis))

    def axis_index(self, axis: Axis) -> int:
        """This rank's row-major index over ``axis`` (in the order given),
        ``lax.axis_index``."""
        self._member()
        shape, at = self.shape, dict(zip(self.axis_names, self.coords))
        idx = 0
        for a in self.axes(axis):
            idx = idx * shape[a] + at[a]
        return idx

    def comm_of(self, axis: Axis):
        """The sub-communicator over ``axis`` (collective over the mesh on
        first use, then cached): colour from this rank's coordinates on
        the other axes, key the row-major index over ``axis``, so its
        rank is :meth:`axis_index`."""
        self._member()
        ax = self.axes(axis)
        c = self._comms.get(ax)
        if c is None:
            if ax == self.axis_names:  # the mesh's own rank order
                c = self.comm
            else:
                rest = [i for i, a in enumerate(self.axis_names)
                        if a not in ax]
                shape = self.devices.shape
                color = 0
                for i in rest:
                    color = color * shape[i] + self.coords[i]
                c = self.comm.split(color, self.axis_index(ax))
            self._comms[ax] = c
        return c

    def _member(self) -> None:
        if self.comm is None:
            raise errors.MPIError(
                errors.ERR_ARG, "this rank is not a position of the mesh")

    def __enter__(self) -> "Mesh":
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _active.stack.pop()


class AbstractMesh:
    """Axis names and sizes with no ranks behind them (shape-only use,
    jax's ``AbstractMesh``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_sizes = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(axis_names: Sequence[str] = ("x",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A :class:`Mesh` of the ranks of ``devices`` (a parent
    communicator, ``COMM_WORLD`` by default).

    - ``axis_names`` names the mesh axes (e.g. ``("dp", "tp")``).
    - ``shape`` (optional) gives the per-axis sizes; by default all the
      parent's ranks are factored near-square across the axes.

    Collective over the parent when the mesh takes fewer ranks than it
    has (the first ``prod(shape)`` ranks are the members)."""
    parent = devices if devices is not None else _world()
    n = parent.size
    if shape is None:
        shape = mesh_shape_for(n, len(axis_names))
    if len(shape) != len(axis_names):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"mesh shape {tuple(shape)} for axes {tuple(axis_names)}")
    total = math.prod(shape)
    if total > n:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"mesh shape {tuple(shape)} needs {total} devices, "
            f"have {n}")
    comm = parent
    if total < n:
        comm = parent.split(0 if parent.rank < total else UNDEFINED,
                            parent.rank)
    grid = np.arange(total).reshape(tuple(int(s) for s in shape))
    return Mesh(grid, axis_names, comm)


def abstract_mesh(axis_names: Sequence[str], shape: Sequence[int]):
    """An :class:`AbstractMesh` for shape-only use (no ranks needed)."""
    return AbstractMesh(tuple(shape), tuple(axis_names))


def require_devices(n: int) -> None:
    """Ensure >= n ranks exist (``COMM_WORLD``'s size)."""
    have = local_device_count()
    if have >= n:
        return
    raise errors.MPIError(
        errors.ERR_ARG,
        f"need {n} devices, have {have}; start the job with "
        f"`python -m ompi_tpu_torch.runtime.launcher -n {n} ...`")
