"""The CUDA accelerator component (the counterpart of the JAX package's
``accelerator/tpu.py``): device info and synchronisation through torch."""

from __future__ import annotations

import torch

from ompi_tpu_torch.accelerator import Accelerator


class CudaAccelerator(Accelerator):
    NAME = "cuda"

    def num_devices(self) -> int:
        return torch.cuda.device_count()

    def device_info(self) -> dict:
        return {"name": torch.cuda.get_device_name(
                    torch.cuda.current_device()),
                "count": torch.cuda.device_count()}

    def synchronize(self) -> None:
        torch.cuda.synchronize()
