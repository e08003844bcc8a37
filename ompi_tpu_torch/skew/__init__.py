"""The skew plane's guard (``ompi_tpu/skew``): only
:mod:`~ompi_tpu_torch.skew.record`'s, so far (ROADMAP item 10b)."""
