"""Host utilities of the port (reference: opal/util and
``ompi_tpu.util``): :mod:`.net`, the interface selection btl/tcp uses,
and :mod:`.show_help`, the tagged, once-per-process user diagnostics.
``topology`` comes with the launcher's bind-to-core (ROADMAP queue 1
item 4d)."""
