"""OpenSHMEM hello (reference analog: examples/hello_oshmem_c.c).

Run:  python -m ompi_tpu_torch.runtime.launcher -n 4 \
      --mca device_plane_platform cpu ompi_tpu_torch/examples/shmem_hello.py
"""

from ompi_tpu_torch import shmem

shmem.init()
print(f"Hello, world, I am {shmem.my_pe()} of {shmem.n_pes()}")
shmem.finalize()
