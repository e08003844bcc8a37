"""Derived datatypes on the card: halo columns and collectives of a
strided layout, and a heterogeneous host exchange.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on ompi_tpu_torch/examples/datatype_exchange.py
    python -m ompi_tpu_torch.runtime.launcher -n 2 \\
        ompi_tpu_torch/examples/datatype_exchange.py --hetero

Device mode (the default): every rank owns an H x W float32 tile
(``--size 8192``: 8192 x 8192, 256 MiB, one GPU's subdomain), and the halo
column type is ``vector(H, 1, W, FLOAT)``. Each rank

1. sends its rightmost owned column (W-2) as a ``(tensor, 1, column)``
   tuple to its right neighbour, whose ``Recv`` scatters it into its left
   ghost column (0) in place, and its leftmost owned column (1) to its
   left neighbour's right ghost (W-1): the device convertor packs on the
   card, the packed column moves through the device point-to-point;
2. runs ``Allreduce((tile, 1, column))`` under ``'linear'`` (K3) and
   ``'ring'`` (K1 and K2), which sums column 0 of every rank's tile and
   scatters the sum back into the caller's column, the rest of the tile
   kept; then ``Bcast((tile, 1, column))`` from the last rank.

Each rank checks its results bitwise: the ghost columns against the
neighbours' tiles regenerated from ``--seed``, the 'linear' sum against
the host's rank-order fold of those columns in numpy, the 'ring' sum
against the plain fold in the ring's order, the Bcast against the root's
column, and every other element of the tile against its start. The
kernels' launch counts are zeroed just before the path and read just
after. With ``--out DIR`` each rank writes ``DIR/rank<r>.json`` (cases,
launches, the kernels the path requires, p50 ms per call).

``--hetero`` (host buffers, no device plane): rank 1 advertises
big-endian (``OMPI_TPU_ARCH=big``, set here before the package loads),
so it byteswaps its wire and its peers convert. Rank 0 sends rank 1 an
array of a {float64, int32} struct type and rank 1 sends it back; then
an Allreduce of float64 and of int32 over every rank; each checked
against the values sent.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__" and "--hetero" in sys.argv \
        and os.environ.get("OMPI_TPU_RANK") == "1":
    os.environ["OMPI_TPU_ARCH"] = "big"  # before the cvars register

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ompi_tpu_torch import mpi  # noqa: E402
from ompi_tpu_torch.coll import cuda_kernels as K  # noqa: E402
from ompi_tpu_torch.core import arch, pvar  # noqa: E402
from ompi_tpu_torch.datatype import datatype as D  # noqa: E402
from ompi_tpu_torch.examples.device_collectives import (  # noqa: E402
    expected_allreduce,
)
from ompi_tpu_torch.runtime import device_plane  # noqa: E402

#: the kernels the device path runs: K1 and K2 ('ring'), K3 ('linear')
PATH_KERNELS = (K.ring_rs_hop, K.ring_ag_hop, K.linear_fold)
REPS = 5


def make_tile(q: int, size: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + q)
    return torch.randn(size, size, generator=g, device=device)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def device_mode(comm, ns, report) -> None:
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    h = w = ns.size
    col = D.vector(h, 1, w, D.FLOAT).commit()
    left, right = (r - 1) % n, (r + 1) % n
    tiles = [make_tile(q, h, ns.seed, dev) for q in range(n)]
    cols = [t[:, 0].clone() for t in tiles]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(name, fn):
        """One call's result, then the p50 ms of REPS more."""
        out = fn()
        ms = []
        for _ in range(REPS):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        report["p50_ms"][name] = sorted(ms)[len(ms) // 2]
        return out

    K.reset_launches()
    tile = tiles[r].clone()
    flat = tile.view(-1)

    def halo():
        req = comm.Isend((flat[w - 2:], 1, col), right, tag=1)
        comm.Recv((flat, 1, col), left, tag=1)
        req.wait()
        req = comm.Isend((flat[1:], 1, col), left, tag=2)
        comm.Recv((flat[w - 1:], 1, col), right, tag=2)
        req.wait()
        return tile

    timed("halo Send/Recv", halo)
    want = tiles[r].clone()
    want[:, 0] = tiles[left][:, w - 2]
    want[:, w - 1] = tiles[right][:, 1]
    report["case"]("halo columns from both neighbours, interior kept",
                   torch.equal(bits(tile), bits(want)))

    host = np.stack([c.cpu().numpy() for c in cols])
    fold = host[0].copy()
    for x in host[1:]:
        fold = fold + x  # the host's rank-order fold, float32
    for mode in ("linear", "ring"):
        t = tiles[r].clone()

        def call():
            t[:, 0] = cols[r]
            return comm.Allreduce((t, 1, col), deterministic=mode)

        out = timed(f"Allreduce {mode}", call)
        exp = torch.from_numpy(fold).to(dev) if mode == "linear" else \
            expected_allreduce(cols, "MPI_SUM", mode, n)
        keep = tiles[r].clone()
        keep[:, 0] = exp
        report["case"](f"Allreduce((tile, 1, column)) {mode} == "
                       f"{'host' if mode == 'linear' else 'ring-order'} "
                       "fold, interior kept",
                       out is t and torch.equal(bits(t), bits(keep)))
    t = tiles[r].clone()
    out = timed("Bcast", lambda: comm.Bcast((t, 1, col), root=n - 1))
    keep = tiles[r].clone()
    keep[:, 0] = cols[n - 1]
    report["case"]("Bcast((tile, 1, column)) from the last rank",
                   out is t and torch.equal(bits(t), bits(keep)))
    report["launches"] = {k.__name__: k.launches for k in PATH_KERNELS}
    report["required"] = [k.__name__ for k in PATH_KERNELS]
    report["device"] = str(dev)


def hetero_mode(comm, ns, report) -> None:
    n, r = comm.size, comm.rank
    pair = D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32]).commit()
    rec = np.dtype([("d", np.float64), ("i", np.int32)])  # packed: 12 B
    rng = np.random.default_rng(ns.seed)
    send = np.zeros(ns.count, rec)
    send["d"] = rng.standard_normal(ns.count)
    send["i"] = rng.integers(-2 ** 31, 2 ** 31 - 1, ns.count)
    if r == 0:
        comm.Send((send, ns.count, pair), dest=1, tag=3)
        back = np.zeros_like(send)
        comm.Recv((back, ns.count, pair), source=1, tag=4)
        report["case"]("struct round trip through the big-endian rank",
                       back.tobytes() == send.tobytes())
    elif r == 1:
        got = np.zeros_like(send)
        comm.Recv((got, ns.count, pair), source=0, tag=3)
        report["case"]("struct from the little-endian rank",
                       got.tobytes() == send.tobytes())
        comm.Send((got, ns.count, pair), dest=0, tag=4)
    x = np.full(ns.count, float(r + 1))
    out = np.zeros_like(x)
    comm.Allreduce(x, out)
    report["case"]("float64 Allreduce across the orders",
                   (out == n * (n + 1) / 2).all())
    xi = np.arange(ns.count, dtype=np.int32) * (r + 1)
    oi = np.zeros_like(xi)
    comm.Allreduce(xi, oi)
    report["case"]("int32 Allreduce across the orders",
                   (oi == np.arange(ns.count, dtype=np.int32)
                    * (n * (n + 1) // 2)).all())
    report["arch"] = arch.advertised()
    report["device"] = "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=8192,
                    help="tile rows and columns per rank (device mode)")
    ap.add_argument("--hetero", action="store_true",
                    help="the host exchange with rank 1 forced big-endian")
    ap.add_argument("--count", type=int, default=1 << 16,
                    help="struct elements and Allreduce length (--hetero)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    cases = []

    def case(name, ok):
        cases.append({"name": name, "ok": bool(ok)})
        if r == 0:
            print(f"[datatype_exchange n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)

    report = {"rank": r, "size": n, "cases": cases, "p50_ms": {},
              "launches": {}, "case": case}
    (hetero_mode if ns.hetero else device_mode)(comm, ns, report)
    del report["case"]
    # nothing on this path may stage through the host
    report["coll_accelerator_staged"] = pvar.read("coll_accelerator_staged")
    if r == 0 and report["p50_ms"]:
        print(f"[datatype_exchange n={n}] {ns.size} x {ns.size} float32 "
              f"tiles, column vector({ns.size}, 1, {ns.size}): p50 ms "
              f"{report['p50_ms']}; kernel launches (rank 0) "
              f"{report['launches']}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump(report, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
