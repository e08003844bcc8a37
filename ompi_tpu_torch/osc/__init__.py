"""One-sided communication (MPI RMA windows), reduced.

Reference: ompi/mca/osc/ and the JAX package's ``ompi_tpu.osc``, whose
host :class:`Window` runs every window through an active-message (AM)
service on a private duplicated communicator over the pml. The port's
pml has landed, but not that service (ROADMAP queue 1 item 7), so this
module carries the ``Window`` base without it: the private dup communicator, the
``peer_info`` allgather, ``name``, ``disp_unit``, ``_check_target``, the
``LOCK_*`` constants and the :func:`win_create` entry point. Every verb
that rides the AM service (passive target, PSCW, the synchronous Get,
Get_accumulate, Fetch_and_op, Compare_and_swap) raises
``MPIError(ERR_NOT_SUPPORTED)`` naming that item. The device-resident
window, :class:`ompi_tpu_torch.osc.cuda.CudaWindow`, serves fence epochs
without it.
"""

from __future__ import annotations

from typing import List, Tuple

from ompi_tpu_torch import errors

LOCK_EXCLUSIVE = "exclusive"
LOCK_SHARED = "shared"

#: where the host window and its active-message service come from
AM_ITEM = ("ROADMAP queue 1 item 7 (the host window's active-message "
           "service over the pml)")

#: the synchronisation verbs of the host window's active-message service
#: (a subclass serves or refuses the data verbs itself)
_AM_VERBS = ("Lock", "Lock_all", "Flush", "Flush_all", "Sync", "Post",
             "Start", "Wait")


class Window:
    """MPI_Win over a local buffer (Win_create semantics), without the
    active-message service: creation is collective over ``comm`` and
    dups it (the window's traffic never meets the parent's), every
    member learns every member's ``(nbytes, disp_unit)``, and the AM
    verbs raise ``ERR_NOT_SUPPORTED``. Subclasses serve what they can."""

    def __init__(self, comm, base, disp_unit: int = 1) -> None:
        self.comm = comm.dup()  # private comm: its own keys and arenas
        self.base = base
        self.disp_unit = disp_unit
        self.rank = self.comm.rank
        self.size = self.comm.size
        nbytes = 0 if base is None else base.numel() * base.element_size()
        self.peer_info: List[Tuple[int, int]] = \
            self.comm.coll.allgather_obj(self.comm, (nbytes, disp_unit))
        self.name = f"win#{self.comm.cid}"
        self.comm.coll.barrier(self.comm)  # creation is collective

    def _check_target(self, target: int) -> None:
        """Raise ``MPIError(ERR_RANK)`` for a rank outside the window."""
        if not 0 <= target < self.size:
            raise errors.MPIError(
                errors.ERR_RANK,
                f"RMA target rank {target} out of range for {self.name} "
                f"(size {self.size})")

    def _am(self, verb: str) -> None:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"{verb} on {self.name} rides the host window's active-message "
            f"service, which the port does not have yet: {AM_ITEM}")

    def Free(self) -> None:
        """Collective: a barrier, then the private comm (and its arenas)
        is freed."""
        self.comm.coll.barrier(self.comm)
        self.comm.free()


def _am_verb(verb: str):
    def call(self, *args, **kwargs):
        self._am(verb)

    call.__name__ = call.__qualname__ = verb
    call.__doc__ = (f"MPI_Win {verb}: rides the active-message service; "
                    f"raises ERR_NOT_SUPPORTED until {AM_ITEM}.")
    return call


for _verb in _AM_VERBS:
    setattr(Window, _verb, _am_verb(_verb))


def win_create(comm, base, disp_unit: int = 1) -> Window:
    """MPI_Win_create (collective). Under ``--mca osc_cuda on`` a
    supported device tensor on every rank gets a
    :class:`~ompi_tpu_torch.osc.cuda.CudaWindow`; any other buffer raises
    ``MPIError(ERR_NOT_SUPPORTED)`` (counted in ``osc_cuda_fallthrough``
    when the component is on), because the host window it would fall to
    comes with the pml."""
    from ompi_tpu_torch.osc import cuda as _cuda

    win = _cuda.maybe_window(comm, base, disp_unit)
    if win is None:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            "win_create: device windows need --mca osc_cuda on (and --mca "
            f"device_plane on); the host window comes with {AM_ITEM}")
    return win
