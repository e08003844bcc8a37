"""Pairwise connectivity check (reference analog:
examples/connectivity_c.c): every pair exchanges a message; rank 0
reports the verdict.

Run:  python -m ompi_tpu_torch.runtime.launcher -n 4 \
      --mca device_plane_platform cpu \
      ompi_tpu_torch/examples/connectivity.py -v
"""

import sys

import numpy as np

from ompi_tpu_torch import mpi

verbose = "-v" in sys.argv

comm = mpi.Init()
rank, size = comm.rank, comm.size

for i in range(size):
    for j in range(i + 1, size):
        if rank == i:
            comm.Send(np.array([rank], dtype=np.int32), dest=j, tag=7)
            ack = np.zeros(1, dtype=np.int32)
            comm.Recv(ack, source=j, tag=8)
            assert ack[0] == j
            if verbose:
                print(f"Checking connection between rank {i} and rank {j}")
        elif rank == j:
            got = np.zeros(1, dtype=np.int32)
            comm.Recv(got, source=i, tag=7)
            assert got[0] == i
            comm.Send(np.array([rank], dtype=np.int32), dest=i, tag=8)

comm.Barrier()
if rank == 0:
    print(f"Connectivity test on {size} processes PASSED.")
mpi.Finalize()
