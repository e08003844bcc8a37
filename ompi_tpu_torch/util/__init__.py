"""Host utilities of the port (reference: opal/util and
``ompi_tpu.util``): :mod:`.net`, the interface selection btl/tcp uses,
:mod:`.show_help`, the tagged, once-per-process user diagnostics, and
:mod:`.topology`, the sysfs cores / packages / NUMA nodes the launcher's
``--bind-to`` maps ranks over."""
