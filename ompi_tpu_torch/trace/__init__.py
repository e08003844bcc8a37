"""The trace plane's guards (``ompi_tpu/trace``): only the span
recorder's, :mod:`~ompi_tpu_torch.trace.recorder`, so far (ROADMAP
item 10)."""
