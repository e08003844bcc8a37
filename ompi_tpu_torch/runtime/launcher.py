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
a ``--timeout`` that passes kills every rank and returns 124. ``MPI_Abort``
(``rte.abort``) is such a crash: the aborting rank exits with its code,
ranks blocked in the store exit with the same code, the rest are
terminated, and the job exits with the code. Whatever way the job ends,
the launcher then removes the job's shared-memory files (btl/sm rings,
the device arenas and their hop counters, the shmem heaps, IPC files:
every ``ompi_tpu_torch_<jobid>_*`` under the shm dir).

FT mode (``--mca ft 1``, the ULFM model, reference ``launcher.py:200-210,
:538-590``): a rank killed by a signal is declared failed in the store
and the job goes on (runtime-level detection is the launcher daemon's
job, docs/features/ulfm.rst:260-262); a rank that exits nonzero still
fails the job, and so does a job whose every rank was killed (nothing
survived).
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
    # world ranks [0, nprocs) are this job's: MPI_Comm_spawn takes fresh
    # blocks above the watermark (ompi_tpu_torch.dpm)
    store.seed_counter(f"ww:{jobid}", nprocs)
    argv = _wrap_py(list(argv))
    ft = str((mca or {}).get("ft", "0")).lower() not in ("0", "false", "")
    procs: List[subprocess.Popen] = []
    try:
        for r in range(nprocs):
            procs.append(subprocess.Popen(
                argv, env=build_env(r, nprocs, store.addr, jobid, mca)))
        return _wait_all(procs, timeout, store=store if ft else None)
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
              timeout: Optional[float], store=None) -> int:
    """The job's exit code. ``store`` (a :class:`kvstore.Store`) turns on
    FT mode: a rank killed by a signal is marked dead there and the
    survivors keep running."""
    deadline = None if timeout is None else time.monotonic() + timeout
    pending = set(range(len(procs)))
    first_bad = 0
    clean_exits = 0
    last_killed_rc = 0
    while pending:
        for i in list(pending):
            rc = procs[i].poll()
            if rc is None:
                continue
            pending.discard(i)
            killed = rc < 0
            if killed:  # by signal: shell convention 128+signum
                rc = 128 - rc
            if rc == 0:
                clean_exits += 1
            if killed and store is not None:
                store.mark_dead(i, f"killed by signal {rc - 128}")
                last_killed_rc = rc
                continue  # ULFM: the survivors keep running
            if rc != 0 and first_bad == 0:
                first_bad = rc
                if killed:
                    from ompi_tpu_torch.util import show_help

                    show_help.show("launcher", "rank-died", rank=i,
                                   cause=f"signal {rc - 128}")
                # a rank died abnormally: bring the job down
                for j in pending:
                    procs[j].send_signal(signal.SIGTERM)
        if pending:
            time.sleep(0.02)
            if deadline is not None and time.monotonic() > deadline:
                for j in pending:
                    procs[j].kill()
                return 124
    if first_bad == 0 and clean_exits == 0 and last_killed_rc:
        # FT mode with every rank killed: nothing survived the faults
        return last_killed_rc
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
