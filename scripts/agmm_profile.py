"""agmm_profile.py — allgather_matmul_dev at GPT-2's MLP up-projection,
timed and traced: where a call's time goes when the ranks share a card.

A rank program; it uses only ``comm.coll.allgather_matmul_dev``, so it
runs against any tree of the port (the launcher imports the package of
the directory it is started from)::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on scripts/agmm_profile.py [--iters 10]

Every rank times ``--iters`` calls per dtype (host clock around a
synchronised call after a barrier; float32 and bfloat16, x (2048, 768)
per rank, w (768, 3072), as ``zero_training.py``). Rank 0 then traces 3
more calls per dtype with ``torch.profiler`` and prints, per dtype, the
p50 and every call's time, its own device time per call and the device
time per kernel name, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.runtime import device_plane

ROWS, D, F = 2048, 768, 3072


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ns = ap.parse_args(argv)
    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0] \
        if dev.type == "cuda" else "cpu"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    g = torch.Generator(device=dev).manual_seed(r)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(ROWS, D, generator=g, device=dev).to(dtype)
        w = torch.randn(D, F, generator=torch.Generator(device=dev)
                        .manual_seed(99), device=dev).to(dtype)

        def call():
            comm.Barrier()
            sync()
            t0 = time.perf_counter()
            comm.coll.allgather_matmul_dev(comm, x, w)
            sync()
            return (time.perf_counter() - t0) * 1e3

        ts = [call() for _ in range(ns.iters)]
        prof = None
        if r == 0 and dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    call()
        else:
            for _ in range(3):
                call()
        if r == 0:
            name = str(dtype).split(".")[-1]
            print(f"[agmm n={n}] {name}: p50 "
                  f"{sorted(ts)[len(ts) // 2]:.3f} ms, calls "
                  f"{[round(t, 3) for t in ts]} [{card}]", flush=True)
            if prof is not None:
                rows = [(e.key, getattr(e, "self_device_time_total", 0),
                         e.count) for e in prof.key_averages()
                        if getattr(e, "self_device_time_total", 0) > 0]
                rows.sort(key=lambda t: -t[1])
                total = sum(t[1] for t in rows) / 3e3
                print(f"[agmm n={n}] {name}: rank 0 device {total:.3f} ms "
                      f"per call; per kernel (us per launch, launches): "
                      + "; ".join(f"{k[:48]} {us / c:.1f} x{c}"
                                  for k, us, c in rows[:6])
                      + f" [{card}]", flush=True)
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
