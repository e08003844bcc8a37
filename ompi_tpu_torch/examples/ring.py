"""Ring message-passing example — the examples/ring_c.c equivalent
(reference: examples/ring_c.c; BASELINE.md config #1).

Run:  python -m ompi_tpu_torch.runtime.launcher -n 4 \
      --mca device_plane_platform cpu ompi_tpu_torch/examples/ring.py
"""

import numpy as np

from ompi_tpu_torch import mpi

comm = mpi.Init()
rank, size = comm.rank, comm.size
nxt, prv = (rank + 1) % size, (rank - 1 + size) % size

message = np.array([10], dtype=np.int32)
if rank == 0:
    print(f"Process 0 sending {message[0]} to {nxt}, "
          f"tag 201 ({size} processes in ring)")
    comm.Send(message, dest=nxt, tag=201)
    print("Process 0 sent to", nxt)

while True:
    comm.Recv(message, source=prv, tag=201)
    if rank == 0:
        message[0] -= 1
        print(f"Process 0 decremented value: {message[0]}")
    comm.Send(message, dest=nxt, tag=201)
    if message[0] == 0:
        print(f"Process {rank} exiting")
        break

if rank == 0:
    comm.Recv(message, source=prv, tag=201)

mpi.Finalize()
