"""ZeRO stage 3: parameter sharding with a layer-ahead prefetch (the
port's ``examples/zero3_params.py``).

Stages 1 and 2 shard the gradients and the optimizer state, but every
rank still holds all parameters. Stage 3 shards the parameters too: each
rank keeps its 1/n flat shard, and a layer's full weights exist only
while they are used. A per-layer persistent ``Allgather_multi_init``
request starts one layer ahead of the consumer
(``part.overlap.LayerPrefetcher``), ``fetch`` consumes it (a hit: the
gather was started) and ``release`` frees it. Residency is the shard
plus the prefetch window: O(1/n) plus two layers, not O(P).

Run::

    python -m ompi_tpu_torch.runtime.launcher -n 2 --mca device_plane on \\
        ompi_tpu_torch/examples/zero3_params.py [summary_dir]

Add ``--mca device_plane_platform cpu`` on a machine without a GPU.
"""

import json
import os
import sys

import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import Zero3Optimizer


def main() -> int:
    comm = mpi.Init()
    rank, size = comm.rank, comm.size
    dev = device_plane.device()

    params = {"embed": torch.ones(256, 32, device=dev),
              "layers": [{"w": torch.full((64, 64), float(i + 1),
                                          device=dev),
                          "b": torch.zeros(64, device=dev)}
                         for i in range(4)]}
    opt = Zero3Optimizer(comm, params, lr=0.1, momentum=0.9,
                         deterministic="linear")
    L = opt.plan.n_layers
    shard, replicated = opt.shard_bytes, opt.replicated_bytes
    window = 2 * max(opt.plan.layer_bytes)
    s = pvar.session()
    for step in range(4):
        # forward: the layers front to back, each fetched a layer ahead
        # of use and freed right after
        opt.start_pass()
        for g in range(L):
            with opt.layer(g) as ws:
                assert len(ws) >= 1
        # backward: the same stream reversed
        opt.start_pass(reverse=True)
        for g in reversed(range(L)):
            with opt.layer(g):
                pass
        opt.step({"embed": torch.full((256, 32), 0.5, device=dev),
                  "layers": [{"w": torch.full((64, 64), 0.5, device=dev),
                              "b": torch.full((64,), 0.5, device=dev)}
                             for _ in range(4)]})
    hits = s.read("zero_prefetch_hits")
    misses = s.read("zero_prefetch_misses")
    resident_hwm = pvar.read("zero3_resident_bytes")
    # the prefetch beat the consumer every time, and residency never
    # passed the shard plus the two-layer window
    assert misses == 0, f"prefetch misses: {misses}"
    assert hits == 4 * 2 * L, (hits, L)
    assert resident_hwm <= shard + window, (resident_hwm, shard, window)
    assert shard * size <= replicated + L * 8 * size, (shard, replicated)
    # the trajectory is replicated though the parameters never are
    probe = float(opt.gathered_params()["embed"][0, 0])
    assert all(v == probe for v in comm.allgather(probe)), probe
    hit_rate = 100.0 * hits / max(hits + misses, 1)
    if rank == 0:
        print(f"prefetch hit rate {hit_rate:.0f}% over {hits + misses} "
              f"fetches ({misses} misses)")
        print(f"param residency {resident_hwm} B <= shard {shard} B + "
              f"2-layer window {window} B (replicated {replicated} B, "
              f"n={size})", flush=True)
        if len(sys.argv) > 1:
            os.makedirs(sys.argv[1], exist_ok=True)
            with open(os.path.join(sys.argv[1], "zero3_summary.json"),
                      "w") as fh:
                json.dump({"ranks": size, "layers": L,
                           "prefetch_hits": hits,
                           "prefetch_misses": misses,
                           "prefetch_hit_rate_pct": hit_rate,
                           "param_resident_bytes_hwm": int(resident_hwm),
                           "param_shard_bytes": shard,
                           "param_window_bytes": window,
                           "param_replicated_bytes": replicated}, fh,
                          indent=1)
    opt.free()
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
