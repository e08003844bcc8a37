"""ingest_profile.py — where the ingest plane's upload time goes: a rank
uploads GPT-2 small's whole parameter tree (124,439,808 float32, seeded
host arrays) through ``IngestEngine`` at several stream and depth
settings, beside the stages alone.

A rank program::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        scripts/ingest_profile.py [--reps 3]

(``-n 1`` for one rank alone on the card; add ``--mca
device_plane_platform cpu --tiny`` to rehearse on the CPU). After a
barrier each rank times, ``--reps`` times each, in turns:

- ``upload s<S> d<D>``: ``IngestEngine(streams=S, depth=D)``'s
  ``upload(tree).tree()`` with the device synchronised, 4 MiB units;
- ``pack``: every leaf ``np.copyto``'d into one pinned buffer, one
  thread (the staging copies alone);
- ``h2d pinned``: that pinned buffer to the card, one ``copy_`` (the link
  alone);
- ``h2d pageable``: one ``torch.from_numpy(leaf).to(dev)`` per leaf.

Rank 0 prints each case's times in ms and GB/s a rank, with the card's
name and power limit; every rank's medians go to ``--out``/rank<r>.json
when ``--out`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.examples import zero_training as zt
from ompi_tpu_torch.ingest import engine as ie
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import layout as zl

CASES = ((1, 2), (4, 1), (4, 2), (4, 4), (8, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    spec = zt.gpt2_spec(zt.TINY if ns.tiny else zt.GPT2,
                        zt.GPT2["n_layer"])
    leaves, treedef = zl.tree_flatten(spec)
    rng = np.random.default_rng([3, r])
    host = [rng.standard_normal(tuple(s), dtype=np.float32) for s in leaves]
    tree = zl.tree_unflatten(treedef, host)
    nbytes = sum(a.nbytes for a in host)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def upload(streams, depth):
        eng = ie.IngestEngine(streams=streams, depth=depth)
        try:
            eng.upload(tree, device=dev).tree()  # warm: staging, streams
            sync()
            comm.Barrier()
            t0 = time.perf_counter()
            out = eng.upload(tree, device=dev).tree()
            sync()
            return time.perf_counter() - t0, out
        finally:
            eng.close()

    pinned = torch.empty(nbytes, dtype=torch.uint8,
                         pin_memory=dev.type == "cuda")
    flat = pinned.numpy()

    def pack():
        comm.Barrier()
        t0 = time.perf_counter()
        off = 0
        for a in host:
            np.copyto(flat[off:off + a.nbytes].view(a.dtype), a.reshape(-1))
            off += a.nbytes
        return time.perf_counter() - t0

    def h2d_pinned():
        dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        sync()
        comm.Barrier()
        t0 = time.perf_counter()
        dst.copy_(pinned, non_blocking=True)
        sync()
        return time.perf_counter() - t0

    def h2d_pageable():
        comm.Barrier()
        t0 = time.perf_counter()
        outs = [torch.from_numpy(a).to(dev) for a in host]
        sync()
        del outs
        return time.perf_counter() - t0

    times: dict = {}
    for _ in range(ns.reps):
        for s, d in CASES:
            dt, out = upload(s, d)
            ok = all(torch.equal(o.cpu() if o.device.type != "cpu" else o,
                                 torch.from_numpy(a))
                     for o, a in zip(zl.tree_leaves(out), host))
            if not ok:
                raise SystemExit(f"rank {r}: upload s{s} d{d} differs")
            times.setdefault(f"upload s{s} d{d}", []).append(dt)
            del out
        times.setdefault("pack", []).append(pack())
        times.setdefault("h2d pinned", []).append(h2d_pinned())
        times.setdefault("h2d pageable", []).append(h2d_pageable())
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    if r == 0:
        for k, v in times.items():
            print(f"[ingest_profile n={n}] {k}: "
                  f"{[round(x * 1e3, 1) for x in v]} ms, median "
                  f"{med[k] * 1e3:.1f} ms = {nbytes / med[k] / 1e9:.2f} "
                  f"GB/s a rank ({nbytes} B) [{card}]", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"n": n, "bytes": nbytes, "card": card,
                       "ms": {k: [x * 1e3 for x in v]
                              for k, v in times.items()}}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
