"""Seeded communication fuzz, the port against the JAX package: the
counterparts of ``tests/test_fuzz.py``'s 2 cases.

One 4-rank job per package, both under the device plane (the port's on
the CPU platform: CPU tensors through coll/device), runs the same program
(:data:`_PROG`): the mixed schedule of p2p, collectives, v-variants and
object traffic for seeds 7 and 2026 (the schedule drawn identically on
every rank), then the device schedule (seed 99: device Allreduce,
Iallgather, a host Allreduce on the same comm, ragged Allgatherv). Every
step's result is recorded; the tests hold the port's records equal to the
reference's, and each step to its own expected value, and no device call
may stage through the host (``coll_accelerator_staged`` 0).
"""

import json
import os
import sys
import tempfile

import pytest

from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

SEEDS = (7, 2026)

_PROG = '''
import json, os
import numpy as np
from {pkg} import mpi
from {pkg}.core import pvar
PORT = {port}
comm = mpi.Init()
rank, size = comm.rank, comm.size
if PORT:
    import torch
    from ompi_tpu_torch.runtime import device_plane
    DEV = device_plane.device()

    def dev_full(n, v):
        return torch.full((n,), float(v), dtype=torch.float32, device=DEV)

    def host(x):
        return x.cpu().numpy()
else:
    import jax.numpy as jnp

    def dev_full(n, v):
        return jnp.full(n, float(v), jnp.float32)

    def host(x):
        return np.asarray(x)
doc = {{"mixed": {{}}}}
for SEED in {seeds!r}:
    res = []
    rng = np.random.default_rng(SEED)  # the same seed everywhere
    for step in range(40):
        op = rng.integers(0, 7)
        n = int(rng.integers(1, 64))
        root = int(rng.integers(0, size))
        if op == 0:  # allreduce
            out = np.zeros(n)
            comm.Allreduce(np.full(n, float(rank + step), np.float64), out)
            assert (out == sum(r + step for r in range(size))).all()
            res.append(out.tolist())
        elif op == 1:  # bcast
            buf = (np.arange(n, dtype=np.int64) + step if rank == root
                   else np.zeros(n, np.int64))
            comm.Bcast(buf, root=root)
            assert (buf == np.arange(n) + step).all(), step
            res.append(buf.tolist())
        elif op == 2:  # ring sendrecv
            dst, src = (rank + 1) % size, (rank - 1) % size
            got = np.zeros(n, np.float32)
            comm.Sendrecv(np.full(n, float(rank), np.float32), dest=dst,
                          recvbuf=got, source=src)
            assert (got == src).all(), step
            res.append(got.tolist())
        elif op == 3:  # gatherv with random counts
            counts = [int(c) for c in rng.integers(1, 5, size)]
            mine = np.full(counts[rank], float(rank), np.float64)
            recv = np.zeros(sum(counts)) if rank == root else None
            comm.Gatherv(mine, recv, counts, root=root)
            if rank == root:
                exp = np.concatenate([np.full(c, float(r))
                                      for r, c in enumerate(counts)])
                assert (recv == exp).all(), step
            res.append(None if recv is None else recv.tolist())
        elif op == 4:  # nonblocking pairs
            dst, src = (rank + 1) % size, (rank - 1) % size
            rbuf = np.zeros(n, np.int32)
            rr = comm.Irecv(rbuf, source=src, tag=step)
            sr = comm.Isend(np.full(n, rank, np.int32), dest=dst, tag=step)
            sr.wait()
            rr.wait()
            res.append(rbuf.tolist())
        elif op == 5:  # object traffic
            objs = comm.allgather({{"r": rank, "s": step}})
            assert [o["r"] for o in objs] == list(range(size)), step
            res.append(objs)
        else:  # alltoall
            sendv = np.arange(size * n, dtype=np.float64) + rank * 1000
            recv = np.zeros_like(sendv)
            comm.Alltoall(sendv, recv)
            for s in range(size):
                want = np.arange(rank * n, (rank + 1) * n) + s * 1000
                assert (recv[s * n:(s + 1) * n] == want).all(), step
            res.append(recv.tolist())
    comm.Barrier()
    doc["mixed"][str(SEED)] = res

# the device schedule: compiled / kernel collectives interleaved with host
# traffic on the same comm
staged0 = pvar.read("coll_accelerator_staged")
res = []
rng = np.random.default_rng(99)
for step in range(12):
    op = rng.integers(0, 4)
    n = int(rng.integers(4, 48))
    if op == 0:
        r = host(comm.Allreduce(dev_full(n, rank + 1)))
        assert r[0] == sum(range(1, size + 1)), step
        res.append(r.tolist())
    elif op == 1:
        req = comm.Iallgather(dev_full(2, rank))
        req.wait()
        a = host(req.array)
        assert a.shape == (size, 2), step
        res.append(a.tolist())
    elif op == 2:
        out = np.zeros(n)
        comm.Allreduce(np.full(n, 1.0), out)
        assert (out == size).all(), step
        res.append(out.tolist())
    else:  # ragged device allgatherv
        counts = [int(c) for c in rng.integers(1, 4, size)]
        packed = host(comm.Allgatherv(dev_full(counts[rank], rank), None,
                                      counts))
        assert packed.size == sum(counts), step
        res.append(packed.tolist())
doc["device"] = res
doc["staged"] = pvar.read("coll_accelerator_staged") - staged0
mpi.Finalize()
with open(os.path.join({out!r}, f"doc_r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    """[(port doc, reference doc)] per rank."""
    ref = tmp_path_factory.mktemp("fuzz_ref")
    port = tmp_path_factory.mktemp("fuzz_port")
    run_ranks(_PROG.format(pkg="ompi_tpu", port=False, seeds=SEEDS,
                           out=str(ref)), 4, mca={"device_plane": "on"},
              prelude=False, timeout=240)
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(_PROG.format(pkg="ompi_tpu_torch", port=True, seeds=SEEDS,
                              out=str(port)))
        path = fh.name
    try:
        rc = port_launcher.launch(
            [sys.executable, path], 4,
            mca={"device_plane": "on", "device_plane_platform": "cpu"},
            timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job exited {rc}"
    return [(json.loads((port / f"doc_r{r}.json").read_text()),
             json.loads((ref / f"doc_r{r}.json").read_text()))
            for r in range(4)]


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_mixed_schedule(docs, seed):
    """Every step of the seeded mixed schedule (each rank asserted its
    expected value in the job) equal to the reference's, on every rank."""
    for p, r in docs:
        assert len(p["mixed"][str(seed)]) == 40
        assert p["mixed"][str(seed)] == r["mixed"][str(seed)]


def test_fuzz_device_schedule(docs):
    """The device schedule's results equal to the reference's, and nothing
    staged through the host in either package."""
    for p, r in docs:
        assert len(p["device"]) == 12
        assert p["device"] == r["device"]
        assert p["staged"] == r["staged"] == 0
