"""A rank-sharded embedding table served one-sided: the recommender pattern.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca osc_cuda on ompi_tpu_torch/examples/embedding_table.py

The table is sharded row-wise: each rank's window holds ``--rows`` rows
of ``--dim`` float32 (by default 2**20 x 128, 512 MiB; 128 is DLRM's
embedding width, MLPerf DLRM-DCNv2). As the JAX package's
``examples/embedding_table.py`` does it:

1. lookup: one fence epoch of ``--batch`` ``Get_epoch`` row reads per
   rank, of global rows drawn from a seed every rank shares (one K9 batch
   at each owner stages every row it serves, one K10 pull per owner at
   the reader);
2. update: one fence epoch of ``--batch`` ``Accumulate(SUM)`` gradient
   rows per rank into rank-disjoint global rows ``rank + size * i``, so
   no row receives two updates (K8's grouped kernel at the owner, reading
   the rows straight from the senders' arena regions: at full size all
   rows land on rank 0, 2048 rounds moved in one exchange).

Each rank checks its lookups and its final shard bitwise against a plain
recomputation (the owners' rows regenerated from the seed; the shard
plus the gradients that land on it, added in torch on the same device),
and reports each fence's time, the reference's rounds and the exchanges
that moved them. With ``--out DIR`` each rank writes ``DIR/rank<r>.json``
(cases, the kernels' launch counts, zeroed just before the path, fence
ms, rounds, exchanges, pvars). ``--tiny`` runs the JAX
package's example's own 16 x 8 shards, 6 lookups and 6 updates, made
from the same numpy seeds, and with ``--out`` also saves each rank's
lookups and final shard as ``rank<r>_rows.npy`` / ``rank<r>_window.npy``
(the tests compare them with the JAX package's). Shards otherwise come
from ``--seed``, on the device, ``CHUNK`` rows per generator.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi, osc
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.osc import cuda_kernels as O
from ompi_tpu_torch.osc.cuda import CudaWindow
from ompi_tpu_torch.runtime import device_plane

#: the kernels this path runs
PATH_KERNELS = (O.rma_apply_strided_batch, O.rma_read_batch,
                O.rma_permute_recv)
PVARS = ("osc_cuda_get", "osc_cuda_acc", "osc_cuda_fence",
         "osc_cuda_rounds", "osc_cuda_bytes")
TINY = (16, 8, 6)  # rows per shard, dim, lookups: the reference example's
CHUNK = 1024  # rows per seeded generator (a looked-up row's chunk is remade)


def _gen(device, *key):
    seed = 0
    for k in key:
        seed = (seed * 1_000_003 + int(k)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(seed)


class Table:
    """Rank q's initial shard, its rows and the gradients it sends."""

    def __init__(self, rows, dim, batch, seed, tiny, device):
        self.rows, self.dim, self.batch = rows, dim, batch
        self.seed, self.tiny, self.device = seed, tiny, device

    def _tiny(self, q):
        # the reference draws the shard, then the gradients, from one rng
        rng = np.random.default_rng(23 + q)
        shard = rng.standard_normal((self.rows, self.dim)).astype(np.float32)
        grads = rng.standard_normal((self.batch, self.dim)).astype(np.float32)
        return (torch.from_numpy(shard).to(self.device),
                torch.from_numpy(grads).to(self.device))

    def _chunk(self, q, c):
        n = min(CHUNK, self.rows - c * CHUNK)
        return torch.randn(n, self.dim, generator=_gen(
            self.device, self.seed, 1, q, c), device=self.device)

    def shard(self, q):
        if self.tiny:
            return self._tiny(q)[0]
        return torch.cat([self._chunk(q, c) for c in
                          range(-(-self.rows // CHUNK))])

    def row(self, q, i):
        if self.tiny:
            return self._tiny(q)[0][i]
        return self._chunk(q, i // CHUNK)[i % CHUNK]

    def grads(self, q):
        if self.tiny:
            return self._tiny(q)[1]
        return torch.randn(self.batch, self.dim, generator=_gen(
            self.device, self.seed, 2, q), device=self.device)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="table rows per rank")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=512,
                    help="lookups (and gradient rows) per rank")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="the JAX package's 16 x 8 shards (CPU rehearsal)")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    rows, dim, batch = TINY if ns.tiny else (ns.rows, ns.dim, ns.batch)

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    table = Table(rows, dim, batch, ns.seed, ns.tiny, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    shard = table.shard(r)
    win = osc.win_create(comm, shard, disp_unit=4)
    assert isinstance(win, CudaWindow), type(win).__name__
    # every rank draws the same global row ids (a rank-independent seed)
    global_ids = np.random.default_rng(99).integers(0, rows * n, batch)
    owners, local_rows = global_ids // rows, global_ids % rows
    upd_global = r + n * np.arange(batch)
    upd_owners, upd_rows = upd_global // rows, upd_global % rows
    grads = table.grads(r)
    O.reset_launches()
    s = pvar.session()
    fence_ms, rounds, exchanges = {}, {}, {}

    def fence(name):
        r0, x0 = s.read("osc_cuda_rounds"), s.read("osc_cuda_exchanges")
        sync()
        t0 = time.perf_counter()
        win.Fence()
        sync()
        fence_ms[name] = (time.perf_counter() - t0) * 1e3
        rounds[name] = s.read("osc_cuda_rounds") - r0
        exchanges[name] = s.read("osc_cuda_exchanges") - x0

    # -- lookup: one fence epoch, one Get_epoch per row ------------------
    win.Fence()
    handles = [win.Get_epoch(dim, int(o), disp=int(i) * dim)
               for o, i in zip(owners, local_rows)]
    fence("lookup")
    got_rows = torch.stack([h.array for h in handles])
    # -- sparse update: gradient rows accumulated at their owners --------
    win.Fence()
    for g, o, i in zip(grads, upd_owners, upd_rows):
        win.Accumulate(g, int(o), disp=int(i) * dim)
    fence("update")
    launches = {k.__name__: k.launches for k in PATH_KERNELS}
    pv = {k: s.read(k) for k in PVARS}

    cases = []

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[embedding_table n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    want_rows = torch.stack([table.row(int(o), int(i))
                             for o, i in zip(owners, local_rows)])
    case(f"{batch} lookups == the owners' rows", bits_equal(got_rows,
                                                              want_rows))
    want = shard.clone()
    for q in range(n):
        gq = table.grads(q)
        for j, gl in enumerate(q + n * np.arange(batch)):
            if gl // rows == r:
                want[gl % rows] = torch.add(want[gl % rows], gq[j])
    case(f"shard after {batch * n} gradient rows == shard + its gradients",
         bits_equal(win.array, want))
    case("one get per lookup, one accumulate per gradient row",
         pv["osc_cuda_get"] == batch and pv["osc_cuda_acc"] == batch,
         gets=pv["osc_cuda_get"], accs=pv["osc_cuda_acc"])
    if r == 0:
        print(f"[embedding_table n={n}] {rows} x {dim} float32 shard per "
              f"rank, {batch} lookups + {batch} gradient rows per rank: "
              f"fence ms {({k: round(v, 3) for k, v in fence_ms.items()})}, "
              f"rounds {rounds}, exchanges {exchanges}; kernel launches "
              f"(rank 0) {launches}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "shard": [rows, dim], "batch": batch,
                       "launches": launches, "fence_ms": fence_ms,
                       "rounds": rounds, "exchanges": exchanges,
                       "pvars": pv, "cases": cases}, f)
        if ns.tiny:
            np.save(os.path.join(ns.out, f"rank{r}_rows.npy"),
                    got_rows.cpu().numpy())
            np.save(os.path.join(ns.out, f"rank{r}_window.npy"),
                    win.array.cpu().numpy())
    win.Free()
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    # K8 runs only at the owners of updated rows (rank 0 at full size):
    # whether each kernel ran on the path is read from all ranks' counts
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
