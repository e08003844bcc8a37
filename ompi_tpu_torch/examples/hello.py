"""Hello world (reference analog: examples/hello_c.c).

Run:  python -m ompi_tpu_torch.runtime.launcher -n 4 \
      --mca device_plane_platform cpu ompi_tpu_torch/examples/hello.py
"""

from ompi_tpu_torch import mpi

comm = mpi.Init()
print(f"Hello, world, I am {comm.rank} of {comm.size} "
      f"({mpi.Get_processor_name()})")
mpi.Finalize()
