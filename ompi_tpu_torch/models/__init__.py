"""Model families built on the device plane, the port of
:mod:`ompi_tpu.models`.

- :mod:`ompi_tpu_torch.models.transformer` — the decoder-only transformer
  whose training step runs dp (grad Allreduce), tp (Megatron column / row
  sharding), sp (ring attention or Ulysses) and ep (MoE Alltoall);
- :mod:`ompi_tpu_torch.models.pipeline` — its GPipe pipeline over pp
  (``permute_dev`` hand-offs) and the host stage hand-off over the
  partitioned plane.
"""

from ompi_tpu_torch.models import transformer  # noqa: F401
