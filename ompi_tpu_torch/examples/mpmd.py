"""MPMD app contexts + spawn_multiple (the port's ``examples/mpmd.py``).

Run the launcher-side MPMD (two app contexts, ONE world)::

    python -m ompi_tpu_torch.runtime.launcher -n 1 \\
        ompi_tpu_torch/examples/mpmd.py driver \\
        : -n 2 ompi_tpu_torch/examples/mpmd.py worker

or from an appfile of ``[-n K] prog args`` lines (``--app FILE``). Every
process shares COMM_WORLD; ``dpm.appnum()`` (``MPI_APPNUM``) tells each
its app context. The driver also demonstrates ``Comm_spawn_multiple``:
two child app contexts merged into one child world bridged by an
intercommunicator (``--no-spawn`` leaves it out).

``--device`` (under ``--mca device_plane on``) adds a device Allreduce
across the apps: a float32 tensor on the rank's device (a CUDA tensor on
the card, a CPU tensor under ``device_plane_platform cpu``), checked
bitwise against the rank-order fold, with ``--apps K,K,...`` giving each
app's rank count so every rank checks its ``MPI_APPNUM``. ``--msgq``
(under ``--mca mpir_dump_on_signal on``) parks world rank 1 in a blocking
``Recv`` from rank 0 (tag 77) while rank 0 sends it SIGUSR1: rank 1's
handler dumps its message queues to its stderr, the posted receive among
them, and then rank 0 sends. ``--out DIR`` writes ``rank<r>.json``.
"""

import argparse
import json
import os
import signal
import sys
import time

import numpy as np
import torch

from ompi_tpu_torch import dpm, mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.runtime import device_plane

#: the tag of the receive rank 1 blocks in under ``--msgq``
MSGQ_TAG = 77


def app_of(rank: int, apps) -> int:
    """The app context world rank ``rank`` belongs to (app k's ranks
    follow app k-1's)."""
    for a, k in enumerate(apps):
        if rank < k:
            return a
        rank -= k
    raise ValueError("rank beyond the app contexts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("role", nargs="?", default="driver")
    ap.add_argument("--no-spawn", action="store_true")
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--apps", default="")
    ap.add_argument("--msgq", action="store_true")
    ap.add_argument("--numel", type=int, default=1 << 20)
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    comm = mpi.Init()
    rank, size = comm.rank, comm.size
    cases: list = []

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if not ok:
            print(f"[mpmd {ns.role}] rank {rank}: {name}: MISMATCH {info}",
                  flush=True)

    tot = np.zeros(1, np.int64)
    comm.Allreduce(np.ones(1, np.int64), tot)
    print(f"[{ns.role}] rank {rank}/{size} appnum={dpm.appnum()} "
          f"world-sum={int(tot[0])}", flush=True)
    case("one world across the apps", int(tot[0]) == size)
    if ns.apps:
        apps = [int(k) for k in ns.apps.split(",")]
        case("MPI_APPNUM", comm.Get_attr(mpi.APPNUM) == app_of(rank, apps)
             == dpm.appnum(), appnum=dpm.appnum())
    if ns.device:
        dev = device_plane.device()
        xs = [torch.full((ns.numel,), 0.1 * (p + 1)) + torch.arange(
            ns.numel) * 1e-7 for p in range(size)]
        got = comm.Allreduce(xs[rank].to(dev), deterministic="linear")
        want = xs[0]
        for x in xs[1:]:
            want = want + x
        case("device Allreduce across the apps, bitwise the linear fold",
             got.device.type == dev.type and torch.equal(got.cpu(), want))
    if ns.msgq:
        pids = comm.allgather(os.getpid())
        buf = np.zeros(4, np.float32)
        if rank == 0:
            time.sleep(1.0)  # rank 1 is in its Recv by now
            os.kill(pids[1], signal.SIGUSR1)
            time.sleep(1.0)  # its handler dumps before the message lands
            comm.Send(np.full(4, 7.0, np.float32), dest=1, tag=MSGQ_TAG)
        elif rank == 1:
            comm.Recv(buf, source=0, tag=MSGQ_TAG)
            case("the receive completed after the dump", (buf == 7).all())
    comm.Barrier()

    parent = mpi.Comm_get_parent()
    if parent is not None:
        # spawned child: bridge-allreduce with the parents
        out = np.zeros(1, np.int64)
        parent.Allreduce(np.ones(1, np.int64), out)
        print(f"[{ns.role}] spawned child sees {int(out[0])} parents "
              "across the bridge", flush=True)
    elif not ns.no_spawn:
        # Comm_spawn_multiple: two child app contexts merged into ONE
        # child world, bridged to us by an intercommunicator
        inter = mpi.Comm_spawn_multiple(
            [(__file__, ("spawned-a", "--no-spawn"), 1),
             (__file__, ("spawned-b", "--no-spawn"), 2)], comm=comm)
        out = np.zeros(1, np.int64)
        inter.Allreduce(np.ones(1, np.int64), out)
        print(f"[{ns.role}] spawned {inter.remote_size} children (child "
              f"contribution sum {int(out[0])})", flush=True)
        case("the children's contributions", int(out[0]) == 3)
        if rank == 0:
            case("the children exited 0",
                 dpm.wait_children(timeout=120) == [0, 0, 0])
        comm.Barrier()
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "role": ns.role,
                       "appnum": dpm.appnum(), "cases": cases,
                       "coll_accelerator_staged":
                           pvar.read("coll_accelerator_staged")}, f)
    mpi.Finalize()
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
