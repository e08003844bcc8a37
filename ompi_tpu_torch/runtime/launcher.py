"""The mpirun equivalent for the PyTorch port (single host).

Reference: ompi/tools/mpirun/main.c:32-180 execs prterun, whose daemons
fork/exec the ranks. Here the launcher itself plays the daemon: it
serves the rendezvous store in-process and forks N rank processes with
the environment contract of :mod:`ompi_tpu_torch.runtime.rte`.

Usage:
    python -m ompi_tpu_torch.runtime.launcher -n 4 [--mca KEY VALUE]... prog.py ...

Each rank learns its local rank (``OMPI_TPU_LOCAL_RANK``); the device
plane maps it to ``cuda:(local_rank % torch.cuda.device_count())``, so
on a one-card machine every rank shares ``cuda:0``.

Exit code: 0 if every rank exits 0; otherwise the first nonzero rank code.
On a rank crash the remaining ranks are terminated (mpirun behavior), and
a ``--timeout`` that passes kills every rank and returns 124.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional, Sequence

from ompi_tpu_torch.runtime import kvstore

#: prefix of every job-scoped shared-memory file (arenas, hop counters,
#: btl/sm rings)
SHM_PREFIX = "ompi_tpu_torch_"


def build_env(rank: int, size: int, store_addr, jobid: str,
              mca: Optional[Dict[str, str]] = None,
              base_env: Optional[Dict[str, str]] = None,
              local_rank: Optional[int] = None,
              local_size: Optional[int] = None) -> Dict[str, str]:
    env = dict(base_env if base_env is not None else os.environ)
    env["OMPI_TPU_RANK"] = str(rank)
    env["OMPI_TPU_SIZE"] = str(size)
    env["OMPI_TPU_LOCAL_RANK"] = str(
        rank if local_rank is None else local_rank)
    env["OMPI_TPU_LOCAL_SIZE"] = str(
        size if local_size is None else local_size)
    env["OMPI_TPU_JOBID"] = jobid
    env["OMPI_TPU_STORE_ADDR"] = f"{store_addr[0]}:{store_addr[1]}"
    for k, v in (mca or {}).items():
        env[f"OMPI_TPU_{k.upper()}"] = str(v)
    # make ompi_tpu_torch importable in ranks regardless of install state
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pp = env.get("PYTHONPATH", "")
    if pkg_root not in pp.split(os.pathsep):
        env["PYTHONPATH"] = (pkg_root + os.pathsep + pp) if pp else pkg_root
    return env


def launch(argv: Sequence[str], nprocs: int,
           mca: Optional[Dict[str, str]] = None,
           timeout: Optional[float] = None) -> int:
    """Spawn nprocs ranks running ``argv``; returns the job exit code."""
    store = kvstore.Store().start()
    jobid = uuid.uuid4().hex[:12]
    argv = _wrap_py(list(argv))
    procs: List[subprocess.Popen] = []
    try:
        for r in range(nprocs):
            procs.append(subprocess.Popen(
                argv, env=build_env(r, nprocs, store.addr, jobid, mca)))
        return _wait_all(procs, timeout)
    finally:
        reap(procs)
        cleanup_shm(jobid)
        store.stop()


def _wrap_py(argv: List[str]) -> List[str]:
    """Run *.py commands under THIS interpreter (mpirun ergonomics)."""
    if argv and argv[0].endswith(".py"):
        return [sys.executable] + argv
    return argv


def shm_dir() -> str:
    return os.environ.get("OMPI_TPU_SHM_DIR", "/dev/shm")


def cleanup_shm(jobid: str) -> None:
    """Reap the job's shared-memory files that crashed ranks could not
    unlink themselves (tmpfs is RAM: leaks last until reboot)."""
    for p in glob.glob(os.path.join(shm_dir(), f"{SHM_PREFIX}{jobid}_*")):
        try:
            os.unlink(p)
        except OSError:
            pass


def reap(procs: Sequence[subprocess.Popen], grace: float = 5.0) -> None:
    """Terminate stragglers, then kill after a grace period."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _wait_all(procs: List[subprocess.Popen],
              timeout: Optional[float]) -> int:
    deadline = None if timeout is None else time.monotonic() + timeout
    pending = set(range(len(procs)))
    first_bad = 0
    while pending:
        for i in list(pending):
            rc = procs[i].poll()
            if rc is None:
                continue
            pending.discard(i)
            if rc < 0:  # by signal: shell convention 128+signum
                rc = 128 - rc
            if rc != 0 and first_bad == 0:
                first_bad = rc
                # a rank died abnormally: bring the job down
                for j in pending:
                    procs[j].send_signal(signal.SIGTERM)
        if pending:
            time.sleep(0.02)
            if deadline is not None and time.monotonic() > deadline:
                for j in pending:
                    procs[j].kill()
                return 124
    return first_bad


def main(args: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.runtime.launcher",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "-np", dest="nprocs", type=int, default=1)
    ap.add_argument("--mca", nargs=2, action="append", default=[],
                    metavar=("KEY", "VALUE"))
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    ns = ap.parse_args(args)
    cmd = list(ns.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given")
    return launch(cmd, ns.nprocs, dict(ns.mca), ns.timeout)


if __name__ == "__main__":
    sys.exit(main())
