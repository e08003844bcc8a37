"""Backward-overlap gradient sync: MPI-4 partitioned collectives as the
DDP / Horovod hook pattern (the port's ``examples/partitioned_gradients.py``).

A backward pass produces gradients last layer first. ``Pallreduce_init``
binds the gradient pytree once; each step ``start()``-s a cycle and
hands every leaf over with ``Pready`` as the backward produces it, and a
bucket's allreduce runs the moment its last leaf arrives.
``GradientSync`` does the key-path bookkeeping.

Run::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_device_bucket_bytes 16384 \\
        ompi_tpu_torch/examples/partitioned_gradients.py

(the small bucket target splits this toy model into several buckets, so
the mid-backward flushes show in ``part_overlap_flushes``). Add ``--mca
device_plane_platform cpu`` on a machine without a GPU.
"""

import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.part import GradientSync
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import layout as zl


def main() -> int:
    comm = mpi.Init()
    rank, size = comm.rank, comm.size
    dev = device_plane.device()
    # the gradient template: shapes and dtypes fixed across steps (what
    # the bucket schedules are planned for); values rebind every step
    grads = {"embed": torch.zeros(256, 32, device=dev),
             "layers": [{"w": torch.zeros(64, 64, device=dev),
                         "b": torch.zeros(64, device=dev)}
                        for _ in range(4)]}
    sync = GradientSync(comm, grads, deterministic="linear")
    paths = [zl.keystr(p) for p, _ in zl.tree_flatten_with_path(grads)]
    leaves = zl.tree_leaves(grads)
    s = pvar.session()
    for step in range(3):
        sync.start()
        # the backward: gradients in reverse-layer order, each handed
        # over as it is made; buckets flush mid-backward
        for key in reversed(paths):
            i = sync.index_of(key)
            sync.push(key, torch.full_like(leaves[i], float(rank + 1)))
        synced = sync.finish()
    want = size * (size + 1) / 2
    assert float(synced["embed"][0, 0]) == want, synced["embed"][0, 0]
    if rank == 0:
        print(f"3 steps: {s.read('part_bucket_flushes')} bucket flushes, "
              f"{s.read('part_overlap_flushes')} launched before the final "
              f"Pready (overlapped), {s.read('device_plane_arenas')} arenas "
              "mapped after init", flush=True)
    sync.free()
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
