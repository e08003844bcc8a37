"""State carried across from the JAX package: configuration, buffers
and ZeRO state.

What must match between the two packages for a test to compare like
with like is the MCA configuration, the data and the parameters.

- :func:`mca_from_reference` maps the reference's MCA settings to the
  port's names (``coll_pallas*`` -> ``coll_cuda*``, ``osc_pallas*`` ->
  ``osc_cuda*``,
  ``coll_xla_deterministic`` -> ``coll_cuda_deterministic``,
  ``coll_xla_bucket_bytes`` -> ``coll_device_bucket_bytes``,
  ``device_plane_platform`` tpu -> cuda). Settings of the reference's
  TPU transport that have no counterpart are dropped; anything else
  passes through unchanged.
- :func:`tensor_from_numpy` / :func:`tensor_to_numpy` convert buffers,
  carrying bfloat16 through its uint16 bit pattern (numpy has no
  bfloat16 of its own); :func:`tree_from_numpy` / :func:`tree_to_numpy`
  do the same over a pytree of dicts, lists and tuples (a parameter
  tree), and :func:`sharded_state_from_reference` rebuilds a ZeRO
  ShardedState from the reference's plan and shards.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: reference settings of the Pallas TPU transport, with no port analog
_DROPPED = frozenset(("coll_pallas_interpret", "coll_pallas_dma_max_bytes",
                      "coll_pallas_min_bytes", "osc_pallas_interpret"))


def mca_from_reference(mca: Dict[str, str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for key, val in mca.items():
        if key in _DROPPED:
            continue
        if key == "coll_pallas" or key.startswith("coll_pallas_"):
            key = "coll_cuda" + key[len("coll_pallas"):]
        elif key == "osc_pallas" or key.startswith("osc_pallas_"):
            key = "osc_cuda" + key[len("osc_pallas"):]
        elif key == "coll_xla_deterministic":
            key = "coll_cuda_deterministic"
        elif key == "coll_xla_bucket_bytes":
            key = "coll_device_bucket_bytes"
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


def _map_tree(fn, tree):
    from ompi_tpu_torch.zero import layout as zl

    leaves, treedef = zl.tree_flatten(tree)
    return zl.tree_unflatten(treedef, [fn(x) for x in leaves])


def tree_from_numpy(tree, device="cpu"):
    """A pytree of numpy arrays -> the same pytree of tensors on
    ``device`` (bfloat16 through its bits)."""
    return _map_tree(lambda a: tensor_from_numpy(np.asarray(a), device),
                     tree)


def tree_to_numpy(tree):
    """A pytree of tensors -> the same pytree of numpy arrays on the host
    (bfloat16 as its uint16 bit pattern)."""
    return _map_tree(tensor_to_numpy, tree)


def sharded_state_from_reference(plan_buckets, metas, shards, rank: int,
                                 n: int):
    """The port's ShardedState (CPU tensors) for a reference
    ShardedState's ``plan.buckets``, ``metas`` (shape, dtype name,
    nbytes per leaf) and numpy ``shards`` (bfloat16 as ml_dtypes or as
    the uint16 bits of a ``"bfloat16"`` bucket). Its tree is the flat
    list of the leaves."""
    from ompi_tpu_torch.zero import layout as zl

    metas = tuple((tuple(int(d) for d in shape), str(dt), int(nb))
                  for shape, dt, nb in metas)
    plan = zl.ZeroPlan(metas, 0, n, buckets=plan_buckets)
    ts = []
    for b, a in enumerate(shards):
        a = np.asarray(a)
        if plan.dtypes[b] == "bfloat16" and a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = tensor_from_numpy(a)
        ts.append(t.reshape(-1))
    treedef = zl.tree_flatten(list(range(len(metas))))[1]
    return zl.ShardedState(plan, metas, treedef, ts, rank, n)
