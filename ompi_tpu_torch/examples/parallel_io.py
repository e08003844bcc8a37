"""Parallel IO — darray fileviews + ordered shared-pointer output
(reference: ompi/mpi/c/type_create_darray.c + file_write_ordered.c; the
HPC-IO checkpoint/log pattern). The port of ``examples/parallel_io.py``.

Each rank owns a block of a 2-D global array via a darray fileview and
writes it with ONE collective call; then every rank appends a
different-sized log record in rank order off the shared pointer.

Run (4 ranks, a 2 x 2 process grid)::

    python -m ompi_tpu_torch.runtime.launcher -n 4 \\
        ompi_tpu_torch/examples/parallel_io.py

writes the reference's 8 x 8 int32 array from numpy blocks. With
``--device`` (under ``--mca device_plane on``; add ``--mca
device_plane_platform cpu`` and ``--tiny`` to rehearse on the CPU) each
rank's block is a ``--block`` square float32 tensor on its device (4096:
an 8192 x 8192 global array, a 256 MiB file), written by one
``Write_all`` through the darray view (one device-to-host copy into
pinned staging, then the two-phase write); every rank checks its rows of
the file against numpy's row-major global array, appends its ragged
record with ``Write_ordered``, reads its block back with ``Read_all``
into numpy (bitwise against its tensor), and rank 0 checks the records'
layout. ``--out DIR`` writes rank<r>.json with the ``Write_all`` time and
rate beside the time of the block's device-to-host copy alone.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ompi_tpu_torch import io as io_mod
from ompi_tpu_torch import mpi
from ompi_tpu_torch.datatype import datatype as D


def pattern(rows: np.ndarray, cols: np.ndarray, width: int) -> np.ndarray:
    """The global array's float32 values at (rows x cols): integers below
    2**23 (exact in float32) from the row-major index."""
    idx = rows[:, None].astype(np.int64) * width + cols[None, :]
    return ((idx * 2654435761) % (1 << 23)).astype(np.float32)


def host_main(comm, path: str) -> None:
    rank, size = comm.rank, comm.size
    # -- collective write through a darray fileview -----------------------
    gs = [8, 8]                       # global 8x8 int32 array
    local = np.arange(16, dtype=np.int32).reshape(4, 4) + 100 * (rank + 1)
    ft = D.darray(size, rank, gs, [D.DISTRIBUTE_BLOCK] * 2,
                  [D.DISTRIBUTE_DFLT_DARG] * 2, [2, 2], D.INT32)
    f = io_mod.File_open(comm, path, io_mod.MODE_CREATE | io_mod.MODE_RDWR)
    f.Set_view(0, etype=D.INT32, filetype=ft)
    f.Write_at_all(0, local.reshape(-1))
    # read the assembled global array back through the plain byte view
    f.Set_view(0)
    world = np.zeros(64, dtype=np.int32)
    f.Read_at_all(0, world)
    world = world.reshape(8, 8)
    i, j = rank // 2, rank % 2
    np.testing.assert_array_equal(world[4 * i:4 * i + 4,
                                        4 * j:4 * j + 4], local)
    # -- rank-ordered log records off the shared pointer ------------------
    f.Seek_shared(0, io_mod.SEEK_END)          # append after the array
    rec = np.full(2 + rank, 1000 + rank, np.int32)   # ragged records
    f.Write_ordered(rec)
    comm.Barrier()
    if rank == 0:
        total = 64 + sum(2 + r for r in range(size))
        out = np.zeros(total, dtype=np.int32)
        f.Read_at(0, out)
        pos = 64
        for r in range(size):
            n = 2 + r
            assert (out[pos:pos + n] == 1000 + r).all(), out[pos:pos + n]
            pos += n
        print(f"parallel IO example OK: 8x8 darray + {size} ordered "
              f"records in {path}", flush=True)
    f.Close()


def device_main(comm, path: str, block: int, out_dir: str) -> None:
    from ompi_tpu_torch.runtime import device_plane

    rank, size = comm.rank, comm.size
    dev = device_plane.device()
    width = 2 * block
    i, j = rank // 2, rank % 2
    rows = np.arange(i * block, (i + 1) * block)
    cols = np.arange(j * block, (j + 1) * block)
    local = torch.from_numpy(pattern(rows, cols, width)).to(dev)
    ft = D.darray(size, rank, [width, width], [D.DISTRIBUTE_BLOCK] * 2,
                  [D.DISTRIBUTE_DFLT_DARG] * 2, [2, 2], D.FLOAT)
    f = io_mod.File_open(comm, path, io_mod.MODE_CREATE | io_mod.MODE_RDWR)
    f.Set_view(0, etype=D.FLOAT, filetype=ft)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    # the block's device-to-host copy alone, for scale: the second of
    # two (the first makes the side streams and the pinned block, which
    # the allocator keeps for the calls after it)
    io_mod.host_array(local)
    sync()
    t0 = time.perf_counter()
    io_mod.host_array(local)
    d2h_ms = (time.perf_counter() - t0) * 1e3
    comm.Barrier()
    sync()
    t0 = time.perf_counter()
    n = f.Write_all(local)
    comm.Barrier()
    write_ms = (time.perf_counter() - t0) * 1e3
    assert n == local.numel() * 4, n
    # every rank checks its quarter of the file's rows against numpy's
    # row-major global array
    f.Sync()
    comm.Barrier()
    q = width // size
    mine = np.memmap(path, dtype=np.float32, mode="r", shape=(width, width))
    want = pattern(np.arange(rank * q, (rank + 1) * q), np.arange(width),
                   width)
    file_ok = bool(np.array_equal(mine[rank * q:(rank + 1) * q], want))
    del mine
    # the ragged records after the array, in rank order
    f.Set_view(0)
    f.Seek_shared(0, io_mod.SEEK_END)
    f.Write_ordered(np.full(2 + rank, 1000 + rank, np.int32))
    comm.Barrier()
    records_ok = True
    if rank == 0:
        total = sum(2 + r for r in range(size))
        rec = np.zeros(total, dtype=np.int32)
        f.Read_at(width * width * 4, rec)
        pos = 0
        for r in range(size):
            records_ok &= bool((rec[pos:pos + 2 + r] == 1000 + r).all())
            pos += 2 + r
    # the block back through the same view, into numpy
    f.Set_view(0, etype=D.FLOAT, filetype=ft)
    back = np.zeros((block, block), dtype=np.float32)
    comm.Barrier()
    t0 = time.perf_counter()
    f.Read_all(back)
    comm.Barrier()
    read_ms = (time.perf_counter() - t0) * 1e3
    back_ok = back.tobytes() == io_mod.host_array(local).tobytes()
    f.Close()
    file_bytes = width * width * 4
    doc = {"rank": rank, "device": str(dev), "block": block,
           "file_bytes": file_bytes, "write_all_ms": write_ms,
           "write_all_gbps": file_bytes / write_ms / 1e6,
           "read_all_ms": read_ms, "d2h_ms": d2h_ms,
           "d2h_gbps": local.numel() * 4 / d2h_ms / 1e6,
           "cases": [{"name": "file == numpy's row-major global array "
                              "(this rank's rows)", "ok": file_ok},
                     {"name": "ordered records in rank order",
                      "ok": bool(records_ok)},
                     {"name": "Read_all == the block, bitwise",
                      "ok": bool(back_ok)}]}
    if rank == 0:
        print(f"[parallel_io n={size} device] {width} x {width} float32 "
              f"({file_bytes} B): Write_all {write_ms:.1f} ms "
              f"({doc['write_all_gbps']:.3f} GB/s), the block's D2H alone "
              f"{d2h_ms:.2f} ms ({doc['d2h_gbps']:.2f} GB/s), Read_all "
              f"{read_ms:.1f} ms; "
              + "; ".join(f"{c['name']}: {'ok' if c['ok'] else 'MISMATCH'}"
                          for c in doc["cases"]), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(doc, fh)
    if not all(c["ok"] for c in doc["cases"]):
        raise SystemExit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--tiny", action="store_true",
                    help="--block 64 (CPU rehearsal)")
    ap.add_argument("--out", default="")
    ap.add_argument("--dir", default="",
                    help="where the file goes (default: the temp dir)")
    ns = ap.parse_args(argv)
    comm = mpi.Init()
    assert comm.size == 4, "run with -n 4 (2x2 process grid)"
    path = os.path.join(ns.dir or tempfile.gettempdir(),
                        f"ompitpu_pario_{os.environ['OMPI_TPU_JOBID']}")
    try:
        if ns.device:
            device_main(comm, path, 64 if ns.tiny else ns.block, ns.out)
        else:
            host_main(comm, path)
    finally:
        comm.Barrier()
        if comm.rank == 0:
            try:
                os.unlink(path)
            except OSError:
                pass
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
