"""model_profile.py — where a tp x sp training step's time goes:
bench.py's d7168/L3 bfloat16 transformer on a 2 x 2 ``("tp", "sp")``
mesh, as ``ompi_tpu_torch/examples/transformer_training.py``'s first part
runs it. A rank program::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        scripts/model_profile.py [--steps 3] [--tiny]

After one warm step, every rank times ``--steps`` steps split into their
phases, each between device synchronisations (host clock): the forward
alone (no graph kept, a step of its own), the forward with the backward
(tp's Allreduces and ring attention's hops inside), the loss sum and the
gradient sync (one Allreduce per leaf over sp), and the SGD update. Then
every rank traces one whole step with ``torch.profiler`` (after a traced
warm-up step) and prints its kernels' device time, in all and by name.
The four ranks share the card by time slices, and a kernel's traced span
takes in the slices given to the other ranks' contexts: a rank's kernel
time over-counts its own work, and the four summed can pass the wall
time. Rank 0 prints the phases' p50, with the card's name and
power limit. ``--tiny`` runs the narrow widths (a CPU run under
``--mca device_plane_platform cpu``, no trace).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.examples import transformer_training as tt
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel import P, make_mesh
from ompi_tpu_torch.parallel.device_comm import local_block
from ompi_tpu_torch.runtime import device_plane


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ns = ap.parse_args(argv)
    world = mpi.Init()
    r = world.rank
    dev = device_plane.device()
    cuda = dev.type == "cuda"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0] \
        if cuda else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    w = tt.WIDTHS["tiny" if ns.tiny else "full"]
    name, layers, axes, shape, axkw, dspec, _ = tt.PARTS[0]
    cfg, ax = tt.config(w, layers), tfm.Axes(**axkw)
    mesh = make_mesh(axes, shape)
    specs = tfm.param_specs(cfg, ax)
    extra = tfm.grad_extra_axes(cfg, ax)
    params = tfm.init_params_device(cfg, tt.PARAM_SEED, dev, ax, mesh)
    tokens, labels = tt.batch(w, dev)
    tk = local_block(mesh, tokens, P(*dspec))
    lb = local_block(mesh, labels, P(*dspec))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def step(times=None):
        def mark(key, t0):
            sync()
            t1 = time.perf_counter()
            if times is not None:
                times.setdefault(key, []).append((t1 - t0) * 1e3)
            return t1

        t0 = time.perf_counter()
        (nll, cnt), grads = tfm.value_and_grads(
            lambda p: tfm.loss_local(p, tk, lb, cfg, ax), params)
        t1 = mark("forward_backward", t0)
        nll, cnt = tfm._psum_pair(nll, cnt, ax.batch_axes())
        grads = tfm.grad_sync(grads, specs, ax, extra)
        t2 = mark("loss_sum_grad_sync", t1)
        tfm.sgd_update(params, grads, tfm.sgd_scale(tt.LR, cnt))
        mark("sgd_update", t2)
        mark("step", t0)

    times: dict = {}
    with mesh:
        step()
        for _ in range(ns.steps):
            sync()
            t0 = time.perf_counter()
            with torch.no_grad():
                tfm.loss_local(params, tk, lb, cfg, ax)
            sync()
            times.setdefault("forward", []).append(
                (time.perf_counter() - t0) * 1e3)
            step(times)
        if cuda:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile, schedule

            # the first traced step carries the tracer's start-up: trace
            # the second
            traced = []
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: traced.append(
                             p.key_averages())) as prof:
                for _ in range(2):
                    sync()
                    t0 = time.perf_counter()
                    step()
                    wall = (time.perf_counter() - t0) * 1e3
                    prof.step()
            # kernels only: the step's own annotation has a device span
            rows = [(e.key, e.self_device_time_total, e.count)
                    for e in traced[0] if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep")]
            rows.sort(key=lambda t: -t[1])
            dev_ms = sum(t[1] for t in rows) / 1e3
            print(f"[model_profile rank {r}] traced step {wall:.1f} ms wall, "
                  f"this rank's kernels {dev_ms:.1f} ms of device time; by "
                  f"kernel (ms, launches): " + "; ".join(
                      f"{k[:60]} {us / 1e3:.2f} x{c}" for k, us, c in rows[:8])
                  + f" [{card}]", flush=True)
    if r == 0:
        print(f"[model_profile {name} n={world.size} {dev}] p50 ms of "
              f"{ns.steps}: " + ", ".join(
                  f"{k} {sorted(v)[len(v) // 2]:.1f}"
                  for k, v in times.items()) + f" [{card}]", flush=True)
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
