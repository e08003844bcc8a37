"""The device plane's SPMD layer — a mesh of ranks, axis collectives with
their gradients, and ring schedules over a device permute.

The port of :mod:`ompi_tpu.parallel` (without ``hierarchical``). The
reference runs this package inside one process's ``shard_map``, where a
mesh axis stands for a communicator (``ompi_tpu/parallel/
collectives.py:1-21``, ``device_comm.py:1-15``). The port has no SPMD
tracer; every rank is a process running the same program, and the
mapping is:

=====================================  =====================================
Reference                              Port
=====================================  =====================================
A mesh position (a device)             A rank of the parent comm (default
                                       ``COMM_WORLD``). The mesh is
                                       ``np.arange(size).reshape(shape)``
                                       over the parent's ranks.
An axis, or a tuple of axes            A ``comm.split`` sub-communicator.
                                       Its colour is this rank's
                                       coordinates on the other axes; its
                                       key is the row-major index over the
                                       given axes, in the order given, so
                                       ``rank`` equals
                                       ``lax.axis_index(axes)``. The split
                                       is collective: every rank builds the
                                       same communicators in the same
                                       order, cached per (mesh, axes).
``axis_size`` / ``axis_index``         ``comm.size`` / ``comm.rank``, plain
(traced)                               ints.
An axis collective                     A call on this rank's local tensor,
                                       made directly to the coll/device
                                       slot: ``allreduce_dev``,
                                       ``reduce_scatter_block_dev``,
                                       ``allgather_dev``, ``alltoall_dev``,
                                       ``bcast_dev``, ``scan_dev``,
                                       ``exscan_dev``, ``barrier_dev``
                                       (coll/device is coll/xla's
                                       counterpart; the reference's
                                       ``DeviceCommunicator`` bypasses the
                                       coll framework too, so no coll
                                       selection runs).
A dim other than 0 (``scatter_dim``,   ``movedim`` to dim 0, a contiguous
``gather_dim``, ``split_dim`` /        copy, then the slot. Data movement
``concat_dim``, ``tiled=False``)       stays bitwise.
``lax.ppermute`` / ``shift`` /         ``permute_dev(comm, t, perm)``, an
``ring_rotate``                        internal coll/device slot: each
                                       destination pulls its source's block
                                       with K2 (``otc_ag_hop``) in one
                                       ``Arena.exchange`` step; a rank with
                                       no source gets zeros; a tuple of
                                       blocks (ring attention's ``(k, v)``)
                                       moves as one exchange. Not an MPI
                                       entry point.
A gradient (``jax.custom_vjp``, or     A ``torch.autograd.Function`` whose
jax's transpose rules for psum /       backward is the conjugate
all_gather / psum_scatter /            collective. ``region_enter`` is
all_to_all / ppermute)                 identity forward and psum backward;
                                       ``region_exit`` psum forward and
                                       identity backward.
``DeviceCommunicator.run(fn,           A callable that takes the global
in_specs, out_specs)``                 inputs (the same on every rank),
                                       slices this rank's block by the
                                       specs (the port's own :class:`P`, a
                                       tuple of axis names or None per
                                       dim), moves it to the rank's device,
                                       calls ``fn`` and returns the local
                                       output. ``assemble(local,
                                       out_spec)`` allgathers results back
                                       to global numpy for checks.
=====================================  =====================================

``reduce`` and ``gather`` return the result on every rank, through
``allreduce_dev`` and ``allgather_dev``, as the reference computes them
on every device.

- :mod:`ompi_tpu_torch.parallel.mesh` — the mesh of ranks and its axis
  sub-communicators;
- :mod:`ompi_tpu_torch.parallel.collectives` — the axis collectives;
- :mod:`ompi_tpu_torch.parallel.ring` — the ring schedules;
- :mod:`ompi_tpu_torch.parallel.device_comm` — ``DeviceCommunicator``.
"""

from ompi_tpu_torch.parallel.mesh import (  # noqa: F401
    P, make_mesh, mesh_shape_for, local_device_count, abstract_mesh,
    require_devices,
)
from ompi_tpu_torch.parallel.device_comm import (  # noqa: F401
    DeviceCommunicator, world_comm,
)
from ompi_tpu_torch.parallel import collectives, ring  # noqa: F401
