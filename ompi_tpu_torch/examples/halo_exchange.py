"""Halo exchange as fence-epoch one-sided puts: the stencil pattern.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca osc_cuda on ompi_tpu_torch/examples/halo_exchange.py

Every rank owns an H x W float32 tile of a 2-D Jacobi/heat stencil as its
window (``--size 8192``: 8192 x 8192, 256 MiB, one GPU's subdomain).
Column 0 is the left ghost, column W-1 the right ghost, columns 1..W-2
are owned. Each of ``--steps`` steps, as the JAX package's
``examples/halo_exchange.py`` does it:

1. one fence epoch with two ``Put_strided`` halo columns (H elements at
   stride W): my rightmost owned column into my right neighbour's left
   ghost, my leftmost owned column into my left neighbour's right ghost.
   Both columns a rank receives land in one exchange and one launch of
   K8's grouped kernel, read straight from the senders' arena regions;
2. the interior relaxes, ``(left + centre + right) / 3`` (plain torch);
3. one fence epoch with a self ``Put`` of the relaxed tile (K7: 2**20
   elements or more), so the window carries the next step.

Each rank then checks its window bitwise against a plain recomputation
of the same schedule (every rank's tile regenerated from the seed, the
halos copied and the tiles relaxed in torch on the same device), and
reports the fence times, the reference's rounds and the exchanges that
moved them. With ``--out DIR`` each rank writes ``DIR/rank<r>.json``
(cases, the kernels' launch counts, zeroed just before the path, fence
ms, rounds, exchanges, pvars). ``--tiny`` runs the JAX
package's example's own 6 x 8 tiles, made from the same numpy seeds, and
with ``--out`` also saves each final window as ``rank<r>_window.npy`` (the
tests compare it with the JAX package's). Tiles otherwise come from
``--seed``, on the device.
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
PATH_KERNELS = (O.rma_apply, O.rma_apply_strided_batch)
PVARS = ("osc_cuda_put", "osc_cuda_fence", "osc_cuda_rounds",
         "osc_cuda_bytes")


def make_tile(q: int, h: int, w: int, seed: int, tiny: bool, device):
    """Rank q's initial tile."""
    if tiny:  # the JAX package's example: numpy's default_rng(11 + rank)
        a = np.random.default_rng(11 + q).standard_normal((h, w))
        return torch.from_numpy(a.astype(np.float32)).to(device)
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + q)
    return torch.randn(h, w, generator=g, device=device)


def relax(g: torch.Tensor) -> torch.Tensor:
    w = g.shape[1]
    nxt = g.clone()
    nxt[:, 1:w - 1] = (g[:, :w - 2] + g[:, 1:w - 1] + g[:, 2:]) / 3.0
    return nxt


def plain_run(tiles, steps: int):
    """The whole job's schedule without windows: halos copied, tiles
    relaxed, one step at a time."""
    n, w = len(tiles), tiles[0].shape[1]
    g = [t.clone() for t in tiles]
    for _ in range(steps):
        right_owned = [x[:, w - 2].clone() for x in g]
        left_owned = [x[:, 1].clone() for x in g]
        for q in range(n):
            g[q][:, 0] = right_owned[(q - 1) % n]
            g[q][:, w - 1] = left_owned[(q + 1) % n]
        g = [relax(x) for x in g]
    return g


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=8192,
                    help="tile rows and columns per rank")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="the JAX package's 6 x 8 tiles (CPU rehearsal)")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    h, w = (6, 8) if ns.tiny else (ns.size, ns.size)

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    left, right = (r - 1) % n, (r + 1) % n

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tile = make_tile(r, h, w, ns.seed, ns.tiny, dev)
    win = osc.win_create(comm, tile, disp_unit=4)
    assert isinstance(win, CudaWindow), type(win).__name__
    O.reset_launches()
    s = pvar.session()
    fence_ms, rounds, exchanges = [], [], []

    def fence():
        r0, x0 = s.read("osc_cuda_rounds"), s.read("osc_cuda_exchanges")
        sync()
        t0 = time.perf_counter()
        win.Fence()
        sync()
        fence_ms.append((time.perf_counter() - t0) * 1e3)
        rounds.append(s.read("osc_cuda_rounds") - r0)
        exchanges.append(s.read("osc_cuda_exchanges") - x0)

    grid = tile
    for _ in range(ns.steps):  # the reference example's fences, one by one
        win.Fence()
        # my rightmost owned column -> right neighbour's left ghost (col 0)
        win.Put_strided(grid[:, w - 2].contiguous(), right, disp=0, stride=w)
        # my leftmost owned column -> left neighbour's right ghost (W-1)
        win.Put_strided(grid[:, 1].contiguous(), left, disp=w - 1, stride=w)
        fence()
        grid = relax(win.array)
        # the window carries the next step (a self put of the whole tile)
        win.Fence()
        win.Put(grid.reshape(-1), r, disp=0)
        fence()
    launches = {k.__name__: k.launches for k in PATH_KERNELS}
    pv = {k: s.read(k) for k in PVARS}

    cases = []

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[halo_exchange n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    want = plain_run([make_tile(q, h, w, ns.seed, ns.tiny, dev)
                      for q in range(n)], ns.steps)[r]
    case(f"window == plain recomputation ({h} x {w}, {ns.steps} steps)",
         bits_equal(win.array, want))
    case("tile passed to win_create untouched",
         bits_equal(tile, make_tile(r, h, w, ns.seed, ns.tiny, dev)))
    case("one put per halo column and tile", pv["osc_cuda_put"]
         == 3 * ns.steps, puts=pv["osc_cuda_put"])
    if r == 0:
        print(f"[halo_exchange n={n}] {h} x {w} float32 tile per rank, "
              f"{ns.steps} steps: fence ms (halo, tile) "
              f"{[round(x, 3) for x in fence_ms]}, rounds {rounds}, "
              f"exchanges {exchanges}; kernel launches (rank 0) "
              f"{launches}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "grid": [h, w], "steps": ns.steps,
                       "launches": launches, "fence_ms": fence_ms,
                       "rounds": rounds, "exchanges": exchanges,
                       "pvars": pv, "cases": cases,
                       # nothing on this path may stage through the host
                       "coll_accelerator_staged":
                           pvar.read("coll_accelerator_staged")}, f)
        if ns.tiny:
            np.save(os.path.join(ns.out, f"rank{r}_window.npy"),
                    win.array.cpu().numpy())
    win.Free()
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    # on the card every kernel of the path must have run
    assert dev.type != "cuda" or all(v > 0 for v in launches.values()), \
        f"rank {r}: a kernel of the path never launched: {launches}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
