"""The tune plane's guards (``ompi_tpu/tune``): the observatory's
guard and the switchpoint-table error surfacing,
:mod:`~ompi_tpu_torch.tune.observe` (the rest is ROADMAP item 10b)."""
