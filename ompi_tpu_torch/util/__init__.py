"""Host utilities of the port (reference: opal/util and
``ompi_tpu.util``): :mod:`.net`, the interface selection btl/tcp uses.
``topology`` / ``show_help`` come with the launcher's bind-to-core
(ROADMAP queue 1 item 4)."""
