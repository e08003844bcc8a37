"""Attribute/keyval caching — the pattern external libraries (PETSc
and friends) layer on MPI (reference: ompi/attribute/attribute.c;
MPI-3.1 §6.7 "Caching").

A "library" attaches per-communicator state under its own keyval; the
copy callback makes dup'd communicators inherit (and version) the
cache, the delete callback releases it, and predefined attributes
answer environment queries.

Run:  python -m ompi_tpu_torch.runtime.launcher -n 3 \
      --mca device_plane_platform cpu \
      ompi_tpu_torch/examples/library_caching.py
"""

import numpy as np

from ompi_tpu_torch import mpi

comm = mpi.Init()
rank, size = comm.rank, comm.size


class LibState:
    """Per-communicator state a library would cache (tables, plans)."""

    def __init__(self, generation: int) -> None:
        self.generation = generation
        self.plan = np.arange(8) * generation


released = []

KEYVAL = mpi.Comm_create_keyval(
    copy_fn=lambda c, k, extra, st: LibState(st.generation + 1),
    delete_fn=lambda c, k, st, extra: released.append(st.generation),
    extra_state="mylib")

# first call on a comm: install the cache
comm.Set_attr(KEYVAL, LibState(generation=1))
assert comm.Get_attr(KEYVAL).generation == 1

# a dup'd comm inherits a REFRESHED cache via the copy callback
work = comm.dup()
assert work.Get_attr(KEYVAL).generation == 2
assert comm.Get_attr(KEYVAL).generation == 1  # parent untouched

# predefined attributes answer environment queries
assert comm.Get_attr(mpi.TAG_UB) >= 32767
assert comm.Get_attr(mpi.UNIVERSE_SIZE) == size

work.free()                      # delete callback releases gen 2
comm.Delete_attr(KEYVAL)         # ... and gen 1
assert released == [2, 1], released

if rank == 0:
    print(f"caching example OK on {size} ranks "
          f"(TAG_UB={comm.Get_attr(mpi.TAG_UB)})")
mpi.Finalize()
