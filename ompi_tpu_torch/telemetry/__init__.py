"""The telemetry plane's guards (``ompi_tpu/telemetry``): only the
flight recorder's, :mod:`~ompi_tpu_torch.telemetry.flight`, so far
(ROADMAP item 10)."""
