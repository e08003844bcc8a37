"""Where a snapshot's commit and restore spend their time: runs
``ckpt_training.py`` with timers around the parts of
``AsyncCheckpointer.commit`` and ``restore``, then times the disk alone.

Run under the launcher as ``ckpt_training.py`` runs, with its arguments::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on ompi_tpu_torch/examples/ckpt_profile.py \\
        --phase full --out DIR

Each rank prints one ``PROFILE`` line: per part, the milliseconds summed
over the job and the number of calls (``two_phase_write``: fcoll's
extent exchange, shuffle and aggregation, of which ``aggregator pwrite``
is the writes; ``fsync (File.Sync)``; ``publish``; ``wait_d2h``;
``materialize`` and its ``read_chunk``; ``digest (all threads)`` sums
the drain's and the restore's sha256 calls). Rank 0 then writes 1 GiB
into ``--out`` with one pwrite, fsyncs it and removes it, and hashes 256
MiB (``DISK`` line). ``--drain-nice N`` runs the snapshots' drain
threads at niceness N (this process's own threads only).
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import sys
import threading
import time

import numpy as np

from ompi_tpu_torch import io as io_mod
from ompi_tpu_torch.examples import ckpt_training
from ompi_tpu_torch.io import async_ckpt as A, fcoll, manifest
from ompi_tpu_torch.runtime import rte

T = collections.defaultdict(float)
N = collections.Counter()


def timed(obj, name: str, key: str) -> None:
    f = getattr(obj, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return f(*a, **k)
        finally:
            T[key] += time.perf_counter() - t0
            N[key] += 1
    setattr(obj, name, wrapper)


def nice_drains(level: int) -> None:
    run = threading.Thread.run

    def niced(self):
        if self.name == "ckpt-d2h":
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), level)
        return run(self)
    threading.Thread.run = niced


def disk(out: str) -> str:
    path = os.path.join(out, "disk.bin")
    buf = np.ones(1 << 28, np.float32).tobytes()
    t0 = time.perf_counter()
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    os.pwrite(fd, buf, 0)
    t1 = time.perf_counter()
    os.fsync(fd)
    t2 = time.perf_counter()
    os.close(fd)
    os.unlink(path)
    t3 = time.perf_counter()
    hashlib.sha256(buf[:1 << 28]).hexdigest()
    t4 = time.perf_counter()
    return (f"DISK 1 GiB pwrite {1e3 * (t1 - t0):.1f} ms, fsync "
            f"{1e3 * (t2 - t1):.1f} ms; sha256 of 256 MiB "
            f"{1e3 * (t4 - t3):.1f} ms; cpus {os.cpu_count()}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--drain-nice" in argv:
        i = argv.index("--drain-nice")
        nice_drains(int(argv[i + 1]))
        del argv[i:i + 2]
    timed(fcoll, "two_phase_write", "two_phase_write")
    timed(fcoll, "_pwritev_retry", "aggregator pwrite")
    timed(io_mod.File, "Sync", "fsync (File.Sync)")
    timed(io_mod, "File_open", "File_open")
    timed(A.AsyncCheckpointer, "_publish", "publish")
    timed(A.AsyncCheckpointer, "_agree_write", "agree vote")
    timed(A.AsyncCheckpointer, "_prune", "prune")
    timed(A.AsyncCheckpointer, "_write_data", "write_data")
    timed(A.Snapshot, "wait_d2h", "wait_d2h")
    timed(A.AsyncCheckpointer, "_materialize", "materialize")
    timed(manifest, "read_chunk_into", "read_chunk")
    timed(manifest, "digest", "digest (all threads)")
    rc = ckpt_training.main(argv)
    print(f"PROFILE rank {rte.rank}: " + json.dumps(
        {k: [round(v * 1e3, 1), N[k]] for k, v in sorted(T.items())}),
        flush=True)
    if rte.rank == 0:
        print(disk(argv[argv.index("--out") + 1]), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
