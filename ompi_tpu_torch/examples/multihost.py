"""Multi-host job: per-host daemons, locality-aware transports, and the
device collectives across the hosts (the port's ``examples/multihost.py``).

Run with a hostfile (ssh agent; addresses optional when DNS works)::

    python -m ompi_tpu_torch.runtime.launcher --hostfile hosts \\
        ompi_tpu_torch/examples/multihost.py

or on ONE machine with two fake hosts on loopback::

    python -m ompi_tpu_torch.runtime.launcher \\
        --host nodeA:2:127.0.0.2,nodeB:2:127.0.0.3 --launch-agent local \\
        --mca device_plane_platform cpu ompi_tpu_torch/examples/multihost.py

Each rank prints its host, its place on the host and a host Allreduce.

``--device`` (under ``--mca device_plane on``, ``coll_cuda on`` and
``coll_device_hier 2``) adds the main path's device Allreduce across the
hosts: a ``--bytes`` float32 SUM Allreduce (256 MiB by default) on every
rank, ``--calls`` times in each of three modes in turns — coll/cuda's
``'linear'`` (K3) and ``'ring'`` (K1 + K2), and coll/device's two-level
grid (``device.allreduce_dev`` on the comm, the 2 x 2 grid that matches
the two hosts: a ring reduce-scatter inside each host, a ring Allreduce
of the half across them, a gather inside each host). Rank ``--straggler``
sleeps ``--delay-s`` before every other call. Checks: every result
bitwise equal to the fold its mode fixes (the rank-order fold; the
ring's chunk order; ``(x0 + x1) + (x2 + x3)`` for the grid), each
host's shared split of size 2, each rank's affinity its ``--bind-to``
set, the grid (2, 2), nothing staged through the host, and the K1-K3
launches (zeroed before, read after) equal to what the schedules imply.
``--out DIR`` writes ``rank<r>.json`` (the device collectives' report
shape: ``cases``, ``launches``, ``expected_launches``; ``p50_ms`` over
the calls the straggler did not delay, ``late_p50_ms`` over those it
did).
On the card the inputs are made on the device from the seed; add
``--mca device_plane_platform cpu`` and ``--tiny`` without a GPU.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.coll import device as coll_device
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.examples import kernel_counts as KC
from ompi_tpu_torch.examples.device_collectives import (bits_equal,
                                                        expected_allreduce)
from ompi_tpu_torch.runtime import device_plane

MODES = ("linear", "ring", "grid")


def _size(text: str) -> int:
    text = text.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(text[-1:], 1)
    return int(text.rstrip("kmg")) * mult


def inputs(rank: int, numel: int, seed: int, dev) -> torch.Tensor:
    """Rank ``rank``'s float32 input, made on ``dev`` from the seed (any
    rank makes any rank's)."""
    g = torch.Generator(device=dev).manual_seed(seed * 1000003 + rank)
    return torch.randn(numel, generator=g, device=dev)


def _p50(v):
    return sorted(v)[len(v) // 2] if v else None


def grid_launches(n_dcn: int, n_ici: int) -> dict:
    """K1-K3 launches of one grid Allreduce on each rank: the ring
    reduce-scatter over the host (n_ici - 1 K1 hops), the ring Allreduce
    of the host's share across the hosts (n_dcn - 1 hops each way) and
    the gather inside the host (one K2 per host rank)."""
    return KC.merged(KC.add({}, K1=KC.ring_hops(n_ici)),
                     KC.ring_allreduce(n_dcn), KC.add({}, K2=n_ici))


def expected(xs, mode: str, n_ici: int):
    """The fold each mode fixes, over every rank's input."""
    if mode == "grid":
        acc = None
        for h in range(len(xs) // n_ici):
            part = xs[h * n_ici]
            for x in xs[h * n_ici + 1:(h + 1) * n_ici]:
                part = part + x
            acc = part if acc is None else acc + part
        return acc
    return expected_allreduce(xs, "MPI_SUM", mode, len(xs))


def device_part(comm, ns, cases, report) -> None:
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    cuda = dev.type == "cuda"
    numel = _size(ns.bytes) // 4
    counts = KC.Counts(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[multihost n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    x = inputs(r, numel, ns.seed, dev)
    calls = {"linear": lambda: comm.Allreduce(x, deterministic="linear"),
             "ring": lambda: comm.Allreduce(x, deterministic="ring"),
             "grid": lambda: coll_device.allreduce_dev(comm, x)}
    first = {m: calls[m]() for m in MODES}  # warm-up: maps every arena
    sync()
    grid = coll_device.grid_of(comm)
    shape = (grid.n_dcn, grid.n_ici) if grid is not None else None
    case("the coll_device_hier grid matches the hosts", shape == (2, 2),
         grid=shape)
    times = {m: [] for m in MODES}
    same = dict.fromkeys(MODES, True)
    staged = pvar.read("coll_accelerator_staged")
    counts.reset()
    for i in range(ns.calls):
        for m in MODES:
            if r == ns.straggler and i % 2 == 0:
                time.sleep(ns.delay_s)
            sync()
            t0 = time.perf_counter()
            out = calls[m]()
            sync()
            times[m].append((time.perf_counter() - t0) * 1e3)
            same[m] = same[m] and bits_equal(out, first[m])
    launched = counts.read()
    derived = KC.merged(KC.add({}, K3=1), KC.ring_allreduce(n),
                        grid_launches(*shape) if shape else {})
    derived = {k: v * ns.calls for k, v in derived.items()}
    case("K1-K3 launches as the schedules imply", launched == derived,
         got=launched, derived=derived)
    case("nothing staged through the host",
         pvar.read("coll_accelerator_staged") == staged)
    for m in MODES:
        case(f"{m}: every call bitwise equal", same[m])
    n_ici = shape[1] if shape else n
    for m in MODES:  # one mode's peers' inputs at a time
        xs = [x if p == r else inputs(p, numel, ns.seed, dev)
              for p in range(n)]
        case(f"{m}: bitwise the fold the mode fixes",
             bits_equal(first[m], expected(xs, m, n_ici)))
        del xs
    report["launches"] = launched
    report["expected_launches"] = derived
    # the calls rank --straggler did not delay, and those it did
    report["p50_ms"] = {m: _p50(t[1::2]) for m, t in times.items()}
    report["late_p50_ms"] = {m: _p50(t[0::2]) for m, t in times.items()}
    report["times_ms"] = times
    report["bytes"] = numel * 4
    report["device"] = str(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", action="store_true",
                    help="the device Allreduce across the hosts")
    ap.add_argument("--bytes", default="256m")
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--straggler", type=int, default=3)
    ap.add_argument("--delay-s", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="a 64 KiB payload (CPU runs)")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if ns.tiny:
        ns.bytes = "64k"

    comm = mpi.Init()
    rank, size = comm.rank, comm.size
    node = mpi.Get_processor_name()
    local = comm.split_type("shared")  # this host's ranks
    out = np.zeros(1, np.float64)
    comm.Allreduce(np.array([float(rank + 1)]), out)
    print(f"rank {rank}/{size} on {node} (local {local.rank}/{local.size}):"
          f" allreduce -> {out[0]}", flush=True)
    cases: list = []
    report: dict = {"rank": rank, "host": node, "local_size": local.size,
                    "bind_cpus": os.environ.get("OMPI_TPU_BIND_CPUS", ""),
                    "affinity": sorted(os.sched_getaffinity(0))}
    cpus = report["bind_cpus"]
    cases.append({"name": "affinity is the bound set", "ok": not cpus or (
        set(report["affinity"]) == {int(c) for c in cpus.split(",")})})
    cases.append({"name": "host Allreduce", "ok":
                  bool(out[0] == size * (size + 1) / 2)})
    if ns.device:
        device_part(comm, ns, cases, report)
    report["cases"] = cases
    report["coll_accelerator_staged"] = pvar.read("coll_accelerator_staged")
    report["required"] = list(KC.NAMES) if ns.device else []
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    mpi.Finalize()
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    raise SystemExit(main())
