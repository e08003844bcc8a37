"""Bucketed gradient synchronisation — the DDP/Horovod pattern on the
device plane (the port's ``examples/fused_gradients.py``).

A training step produces one gradient per parameter; syncing them with
a per-tensor Allreduce pays a host dispatch round for every tensor.
``Allreduce_multi`` flattens the gradient pytree into dtype-segregated
flat buckets (target size: ``--mca coll_device_bucket_bytes``, default
4 MiB) and runs ONE collective schedule per bucket.
``Allreduce_multi_init`` is the MPI-4 persistent form: the plan and the
arenas are made once at init, so each ``start()`` / ``wait()`` cycle
only runs the schedules on the bound tensors' current contents.

The gradients are built under the attribution ledger's ``staging``
phase and the persistent loop runs under ``train`` (both no-ops unless
the job runs with ``--mca prof_enable 1``).

Run::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        ompi_tpu_torch/examples/fused_gradients.py

Add ``--mca device_plane_platform cpu`` on a machine without a GPU.
"""

import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.prof import ledger as prof
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import layout


def grads_for(rank: int, dev) -> dict:
    """A params-like pytree: many small tensors, mixed dtypes — the shape
    of a real model's gradient set, where per-tensor dispatch
    dominates."""
    return {
        "embed": torch.full((256, 32), float(rank + 1), device=dev),
        "layers": [
            {"w": torch.ones(64, 64, device=dev) * (rank + 1),
             "b": torch.arange(64, dtype=torch.float32, device=dev) * rank}
            for _ in range(4)
        ],
        "step": torch.tensor([rank], dtype=torch.int32, device=dev),
    }


def main() -> None:
    comm = mpi.Init()
    rank, size = comm.rank, comm.size
    dev = device_plane.device()
    with prof.phase("staging"):
        grads = grads_for(rank, dev)

    # one fused call replaces ~10 per-tensor Allreduces; 'linear' keeps
    # the result bitwise the per-tensor loop's (the rank-order fold)
    s = pvar.session()
    synced = comm.Allreduce_multi(grads, deterministic="linear")
    launches = s.read("coll_device_launches")
    assert float(synced["embed"][0, 0]) == sum(range(1, size + 1))

    # the persistent form for the training loop: init once, start each
    # step
    preq = comm.Allreduce_multi_init(grads)
    with prof.phase("train"):
        for _ in range(3):  # the "training loop"
            preq.start()
            preq.wait()
            synced = preq.array  # a fresh result pytree each cycle
    preq.free()
    assert float(synced["embed"][0, 0]) == sum(range(1, size + 1))

    if rank == 0:
        n_leaves = len(layout.tree_leaves(grads))
        print(f"synced {n_leaves} gradient tensors in {launches} fused "
              f"launches (vs {n_leaves} per-tensor)")
    mpi.Finalize()


if __name__ == "__main__":
    main()
