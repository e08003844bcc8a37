"""State carried across from the JAX package: configuration, buffers
and ZeRO state.

What must match between the two packages for a test to compare like
with like is the MCA configuration, the data and the parameters.

- :func:`mca_from_reference` maps the reference's MCA settings to the
  port's names (``coll_pallas*`` -> ``coll_cuda*``, ``osc_pallas*`` ->
  ``osc_cuda*``,
  ``coll_xla_deterministic`` -> ``coll_device_deterministic`` (the one
  default mode, which coll/cuda reads as coll/pallas reads coll/xla's),
  and likewise ``coll_xla_{bucket_bytes, rooted_threshold_bytes, hier}``
  -> ``coll_device_*`` (same defaults; ``coll_device_hier`` groups by
  node where the reference groups by ``slice_index``), ``device_plane_platform`` tpu ->
  cuda, and the component names inside a framework's include / exclude
  list: ``coll`` pallas -> cuda and xla -> device, ``accelerator`` tpu
  -> cuda). Settings with no counterpart are dropped: the Pallas TPU
  transport's; ``coll_xla_alltoallv_pad_factor`` (coll/device's
  Alltoallv pads nothing, so there is no blowup for it to bound);
  ``coll_xla_scatter_meta_cache`` (coll/device always caches the
  scatter metadata round, the reference's default) and
  ``coll_xla_a2av_meta_cache`` (coll/device runs Alltoallv's count
  round at every call, the reference's default; ``max_count`` skips
  it). Anything else passes through unchanged: the host collectives'
  ``coll_tuned_*`` (the forced algorithms and the switchpoints),
  ``coll_sync_*`` and ``coll_adapt_*`` cvars among them, which the port
  registers under the reference's names.
- :func:`event_name` maps a reference MPI_T event type's or pvar's name
  to the port's (``osc_pallas_fallthrough`` -> ``osc_cuda_fallthrough``,
  the event and its pvar; the pvar ``coll_xla_device`` ->
  ``coll_device_launches``); :func:`ext_name` an MPI extension's
  (``MPIX_Query_tpu_support`` -> ``MPIX_Query_cuda_support``) and
  :func:`memkinds` a ``mpi_memory_alloc_kinds`` list's device kinds
  (``tpu`` -> ``cuda``, ``tpu:hbm`` -> ``cuda:device``).
- :func:`tensor_from_numpy` / :func:`tensor_to_numpy` convert buffers,
  carrying bfloat16 through its uint16 bit pattern (numpy has no
  bfloat16 of its own); :func:`tree_from_numpy` / :func:`tree_to_numpy`
  do the same over a pytree of dicts, lists and tuples (a parameter
  tree), and :func:`sharded_state_from_reference` rebuilds a ZeRO
  ShardedState from the reference's plan and shards.
- :func:`moe_params_from_reference` takes the reference's numpy MoE
  weights to this rank's share (attention has no parameters);
  :func:`model_config_from_reference` maps a reference transformer
  ``Config`` (numpy / jnp / ml_dtypes dtypes) to the port's (torch
  dtypes), and :func:`model_params_from_reference` takes the reference's
  numpy parameter tree to this rank's local shards by the model's specs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: reference settings with no port analog
_DROPPED = frozenset(("coll_pallas_interpret", "coll_pallas_dma_max_bytes",
                      "coll_pallas_min_bytes", "osc_pallas_interpret",
                      "coll_xla_alltoallv_pad_factor",
                      "coll_xla_scatter_meta_cache",
                      "coll_xla_a2av_meta_cache"))
#: component names inside a framework's include / exclude list
_COMPONENTS = {"coll": {"pallas": "cuda", "xla": "device"},
               "accelerator": {"tpu": "cuda"}}
#: reference MPI_T event types (and pvars) the port names its own way
_EVENT_NAMES = {"osc_pallas_fallthrough": "osc_cuda_fallthrough",
                "coll_xla_device": "coll_device_launches"}
#: reference MPI extensions the port names its own way
_EXT_NAMES = {"MPIX_Query_tpu_support": "MPIX_Query_cuda_support"}
#: the reference's device memory kinds and the port's
_MEMKINDS = {"tpu": "cuda", "tpu:hbm": "cuda:device"}
#: coll/xla settings coll/device keeps under its own prefix
_XLA_TO_DEVICE = frozenset(("deterministic", "bucket_bytes",
                            "rooted_threshold_bytes", "hier"))


def mca_from_reference(mca: Dict[str, str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for key, val in mca.items():
        if key in _DROPPED:
            continue
        if key == "coll_pallas" or key.startswith("coll_pallas_"):
            key = "coll_cuda" + key[len("coll_pallas"):]
        elif key == "osc_pallas" or key.startswith("osc_pallas_"):
            key = "osc_cuda" + key[len("osc_pallas"):]
        elif key.startswith("coll_xla_") \
                and key[len("coll_xla_"):] in _XLA_TO_DEVICE:
            key = "coll_device_" + key[len("coll_xla_"):]
        elif key == "device_plane_platform":
            val = {"tpu": "cuda"}.get(val, val)
        elif key in _COMPONENTS:
            val = _component_list(val, _COMPONENTS[key])
        out[key] = val
    return out


def _component_list(spec: str, names: Dict[str, str]) -> str:
    """A framework's include / exclude list with the reference's
    component names mapped to the port's (``^`` kept)."""
    out = []
    for e in str(spec).split(","):
        e = e.strip()
        neg = e.startswith("^")
        name = e[1:] if neg else e
        out.append(("^" if neg else "") + names.get(name, name))
    return ",".join(x for x in out if x.strip("^"))


def event_name(name: str) -> str:
    """The port's name of a reference MPI_T event type (or pvar)."""
    return _EVENT_NAMES.get(name, name)


def ext_name(name: str) -> str:
    """The port's name of a reference MPIX_* extension."""
    return _EXT_NAMES.get(name, name)


def memkinds(spec: str) -> str:
    """A reference ``mpi_memory_alloc_kinds`` list in the port's kind
    names."""
    return ",".join(_MEMKINDS.get(k.strip(), k.strip())
                    for k in spec.split(",") if k.strip())


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


def moe_params_from_reference(wg, w1_all, w2_all, rank: int, n: int,
                              device="cpu"):
    """``(wg, w1, w2)`` tensors on ``device`` for rank ``rank`` of an
    n-rank expert axis from the reference's numpy weights: the router
    ``wg`` [D, E_total] whole (replicated), and this rank's experts of
    ``w1_all`` [E_total, D, F] and ``w2_all`` [E_total, F, D], the slice
    ``P("ep")`` gives it on dim 0."""
    e_total = np.asarray(w1_all).shape[0]
    if e_total % n:
        from ompi_tpu_torch import errors

        raise errors.MPIError(
            errors.ERR_ARG,
            f"moe_params_from_reference: {e_total} experts over {n} ranks")
    e = e_total // n
    sl = slice(rank * e, (rank + 1) * e)
    return (tensor_from_numpy(np.asarray(wg), device),
            tensor_from_numpy(np.asarray(w1_all)[sl], device),
            tensor_from_numpy(np.asarray(w2_all)[sl], device))


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy, jnp or ml_dtypes dtype (or its name)."""
    if isinstance(dt, torch.dtype):
        return dt
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    return getattr(torch, name)


def model_config_from_reference(cfg):
    """The port's ``models.transformer.Config`` with the reference
    ``cfg``'s fields, ``dtype`` and ``param_dtype`` as torch dtypes."""
    import dataclasses

    from ompi_tpu_torch.models import transformer as tfm

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["dtype"] = torch_dtype(kw["dtype"])
    kw["param_dtype"] = torch_dtype(kw["param_dtype"])
    return tfm.Config(**kw)


def model_params_from_reference(params, cfg, ax, mesh, stacked=False):
    """This rank's local shards (on its device) of the reference's numpy
    parameter tree, sliced by ``param_specs(cfg, ax)`` on ``mesh``: ep
    experts, tp columns and rows. ``stacked``: the tree has its layers
    stacked (the reference's ``pipeline.stack_layers``) and is sliced by
    ``stacked_param_specs``, dim 0 of the stacked layers over pp.
    bfloat16 comes through its bit pattern, as in
    :func:`tree_from_numpy`."""
    from ompi_tpu_torch.models import pipeline, transformer as tfm
    from ompi_tpu_torch.parallel.device_comm import local_block

    specs = pipeline.stacked_param_specs(cfg, ax) if stacked \
        else tfm.param_specs(cfg, ax)
    return tfm.tree_map(lambda a, spec: local_block(mesh, a, spec),
                        params, specs)
