"""Tools — introspection and operator utilities.

Reference: ompi/tools/ (ompi_info, mpirun wrapper, wrapper compilers)
and ``ompi_tpu/tools``. The launcher lives in
``ompi_tpu_torch.runtime.launcher``; this package holds ompi_info's
equivalent (``python -m ompi_tpu_torch.tools.info``) and the
message-queue dump (:mod:`.msgq`, the MPIR debugger analog).
"""
