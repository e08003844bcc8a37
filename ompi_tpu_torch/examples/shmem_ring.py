"""OpenSHMEM ring over symmetric memory (reference analog:
examples/ring_oshmem_c.c): each PE waits for the token from its left
neighbor and puts the (PE 0: decremented) value to its right neighbor;
PE 0 absorbs the final zero after it travels the full ring.

Run:  python -m ompi_tpu_torch.runtime.launcher -n 4 \
      --mca device_plane_platform cpu ompi_tpu_torch/examples/shmem_ring.py
"""

import numpy as np

from ompi_tpu_torch import shmem

shmem.init()
me, n = shmem.my_pe(), shmem.n_pes()
nxt = (me + 1) % n

ring = shmem.zeros(1, dtype=np.int64)
ring.local[0] = -1
shmem.barrier_all()

value = 10
if me == 0:
    shmem.p(ring, value, nxt)
    print(f"PE 0 put {value} to PE {nxt}")

while True:
    shmem.wait_until(ring, shmem.CMP_GE, 0)
    got = int(ring.local[0])
    ring.local[0] = -1
    if me == 0:
        got -= 1
        print(f"PE 0 decremented value: {got}")
    shmem.p(ring, got, nxt)
    if got == 0:
        break

if me == 0:  # absorb the final zero so no put targets an exited PE
    shmem.wait_until(ring, shmem.CMP_GE, 0)
print(f"PE {me} exiting")
shmem.barrier_all()  # everyone drains before teardown
shmem.finalize()
