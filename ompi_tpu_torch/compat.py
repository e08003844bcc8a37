"""State carried across from the JAX package: configuration and buffers.

There are no weights; what must match between the two packages for a
test to compare like with like is the MCA configuration and the data.

- :func:`mca_from_reference` maps the reference's MCA settings to the
  port's names (``coll_pallas*`` -> ``coll_cuda*``,
  ``coll_xla_deterministic`` -> ``coll_cuda_deterministic``,
  ``device_plane_platform`` tpu -> cuda). Settings of the reference's
  TPU transport that have no counterpart are dropped; anything else
  passes through unchanged.
- :func:`tensor_from_numpy` / :func:`tensor_to_numpy` convert buffers,
  carrying bfloat16 through its uint16 bit pattern (numpy has no
  bfloat16 of its own).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: reference settings of the Pallas TPU transport, with no port analog
_DROPPED = frozenset(("coll_pallas_interpret", "coll_pallas_dma_max_bytes",
                      "coll_pallas_min_bytes"))


def mca_from_reference(mca: Dict[str, str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for key, val in mca.items():
        if key in _DROPPED:
            continue
        if key == "coll_pallas" or key.startswith("coll_pallas_"):
            key = "coll_cuda" + key[len("coll_pallas"):]
        elif key == "coll_xla_deterministic":
            key = "coll_cuda_deterministic"
        elif key == "device_plane_platform":
            val = {"tpu": "cuda"}.get(val, val)
        out[key] = val
    return out


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy -> tensor on ``device``; a bfloat16 array (the ml_dtypes
    type jax uses) comes through its uint16 view."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy on the host; bfloat16 comes out as its uint16
    bit pattern."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
