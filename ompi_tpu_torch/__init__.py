"""ompi_tpu_torch — the PyTorch/CUDA port of ompi_tpu.

A package of its own beside the JAX package, which stays the reference
the port is tested against. It imports torch and never jax, and nothing
of ``ompi_tpu``. A device buffer is a ``torch.Tensor``, a host buffer is
numpy. Entry points run on the CUDA device unless the caller asks for
the CPU (``--mca device_plane_platform cpu``).

Usage, one rank program under the launcher::

    python -m ompi_tpu_torch.runtime.launcher -n 4 \\
        --mca device_plane on --mca coll_cuda on prog.py

    from ompi_tpu_torch import mpi
    comm = mpi.Init()
    out = comm.Allreduce(t, op=mpi.SUM, deterministic="linear")
    mpi.Finalize()
"""
