"""Compute ops built on the device plane, the port of
:mod:`ompi_tpu.ops`.

- :mod:`ompi_tpu_torch.ops.ring_attention` — context-parallel attention:
  KV blocks rotate around a ring of ranks (``permute_dev``) while each
  hop's block feeds flash-style online-softmax accumulation.
- :mod:`ompi_tpu_torch.ops.ulysses` — the all-to-all context-parallel
  schedule: one batched head-reshard, exact full-sequence attention per
  head subset, reshard back.
- :mod:`ompi_tpu_torch.ops.moe` — expert-parallel dispatch/combine over
  Alltoall.
- :mod:`ompi_tpu_torch.ops.attention` — single-device attention.
"""
