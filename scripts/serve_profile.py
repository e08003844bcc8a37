"""serve_profile.py — where a decode request's time goes on the serving
path: ``ompi_tpu_torch/examples/moe_serving.py``'s ``drop`` policy at
bench.py's MoE widths (d_model 7168, d_ff 28672, 16 float32 experts over
4 ranks, 32 tokens a rank). A rank program::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        scripts/serve_profile.py [--requests 16] [--tiny]

After two warm dispatches, every rank runs ``--requests`` requests of the
Dispatcher's ``drop`` op sequence (``serve.dispatch.routed_ffn``: the
routing, ``ops/moe.ep_apply``, the stats read) split into phases, each
ended by a device synchronisation (host clock): the token batch to the
card and the routing; the slot packing; the dispatch Alltoall; the
experts' two products; the combine Alltoall; the combine and the stats
read. The Alltoalls wait for the slowest rank, so their phases take in
the other ranks' time. Then each rank times ``--requests`` whole
dispatches, and traces 4 of them with ``torch.profiler``: its kernels'
device time in all and by name. The four ranks share the card by time
slices, and a kernel's traced span takes in the slices of the other
ranks' contexts. Rank 0 prints the phases' p50, the whole dispatch's p50
and the trace, with the card's name and power limit. ``--tiny`` runs the
reference example's widths (a CPU run under ``--mca
device_plane_platform cpu``, no trace).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.examples import moe_serving as ms
from ompi_tpu_torch.ops import moe
from ompi_tpu_torch.parallel import collectives as C
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.serve import Dispatcher, ZipfTraffic

PHASES = ("route", "pack", "alltoall_1", "experts", "alltoall_2",
          "combine_stats")


def phased(x, wg, w1, w2, comm, dev, sync):
    """The drop dispatch's ops (``routed_ffn`` with ``ep_apply``
    inlined), with the wall of each phase; returns {phase: ms}."""
    times = {}
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        sync()
        t1 = time.perf_counter()
        times[name] = (t1 - t0) * 1e3
        t0 = t1

    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n, (t, d) = comm.size, xt.shape
    e_local = w1.shape[0]
    cap = max(int(ms.CAPACITY_FACTOR * t / (e_local * n)), 1)
    route = moe._route(xt @ wg, cap)
    mark("route")
    slots = torch.einsum("tec,td->ecd", route.dispatch, xt)
    slots = slots.reshape(n, e_local, cap, d)
    mark("pack")
    slots = C.alltoall(slots, comm, 0, 0)
    mark("alltoall_1")
    slots = slots.transpose(0, 1).reshape(e_local, n * cap, d)
    hidden = torch.relu(torch.einsum("ekd,edf->ekf", slots, w1))
    out = torch.einsum("ekf,efd->ekd", hidden, w2)
    mark("experts")
    out = out.reshape(e_local, n, cap, d).transpose(0, 1)
    out = C.alltoall(out, comm, 0, 0)
    mark("alltoall_2")
    y = torch.einsum("tec,ecd->td", route.combine,
                     out.reshape(n * e_local, cap, d))
    stats = torch.cat([route.dropped.reshape(1), route.counts])
    stats.cpu()
    y.sum()
    mark("combine_stats")
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--tiny", action="store_true")
    ns = ap.parse_args(argv)
    comm = mpi.Init()
    r, n = comm.rank, comm.size
    dev = device_plane.device()
    cuda = dev.type == "cuda"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0] \
        if cuda else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    width = "tiny" if ns.tiny else "full"
    d, _f = ms.WIDTHS[width]
    traffic = ZipfTraffic(ms.E_LOCAL * n, d, hotness=ms.HOTNESS,
                          seed=ms.SEED)
    w1, w2 = ms.draw_experts(width, 300 + r, dev)
    disp = Dispatcher(comm, traffic.wg, w1, w2, policy="drop",
                      capacity_factor=ms.CAPACITY_FACTOR)
    wg, w1, w2 = disp._weights()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for _ in range(2):
        disp(traffic.request(ms.T)[1])
        sync()
    phases = {k: [] for k in PHASES}
    for _ in range(ns.requests):
        got = phased(traffic.request(ms.T)[1], wg, w1, w2, comm, dev, sync)
        for k, v in got.items():
            phases[k].append(v)
    whole = []
    for _ in range(ns.requests):
        x = traffic.request(ms.T)[1]
        t0 = time.perf_counter()
        out, _info = disp(x)
        sync()
        whole.append((time.perf_counter() - t0) * 1e3)
    trace = ""
    if cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                disp(traffic.request(ms.T)[1])
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda kv: -kv[1])
        total = sum(v for _k, v, _c in rows)
        trace = (f"4 traced dispatches {wall:.3f} ms of wall; kernels "
                 f"{total:.3f} ms of device time: " + "; ".join(
                     f"{k[:48]} {v:.3f} ms x{c}" for k, v, c in rows[:8]))
    pm = {k: float(np.median(v)) for k, v in phases.items()}
    line = (f"serve_profile rank {r} of {n} {width}: phases p50 ms "
            + ", ".join(f"{k} {v:.3f}" for k, v in pm.items())
            + f" (sum {sum(pm.values()):.3f}); whole dispatch p50 "
            f"{float(np.median(whole)):.3f} ms of {ns.requests}")
    lines = comm.coll.allgather_obj(comm, (line, trace))
    if r == 0:
        for ln, tr in lines:
            print(f"{ln} [{card}]", flush=True)
            if tr:
                print(f"  {tr} [{card}]", flush=True)
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
