"""Device-tensor point-to-point bandwidth and correctness.

Ping-pong between ranks 0 and 1 of float32 tensors made on the rank's
device from a seeded ``torch.Generator``, through ``comm.Send`` /
``comm.Recv`` (``pml/accel_p2p``'s pipelined pinned staging); every
received tensor is compared bitwise on the device with what was sent.
Reports the round trip's p50 per size and chunk setting, one-way GB/s,
and, at the same sizes, the rates of the pipeline's stages: a pinned
device-to-host ``copy_``, a pinned host-to-device ``copy_`` and a host
numpy ping-pong of the same bytes through the same pml. Then bfloat16
and int32 messages and a float32 message with a ragged last chunk,
bitwise. With ``--ring-bytes N`` every rank instead sends N bytes of
float32 to the next rank with ``Sendrecv`` and checks what the previous
one sent, bitwise. The report names the sm btl's ring each rank ran
(``"c"``, the port's C ring, or ``"python"``).

Run (CPU tensors, tiny sizes):
    python -m ompi_tpu_torch.runtime.launcher -n 2 \\
        --mca device_plane_platform cpu \\
        ompi_tpu_torch/examples/p2p_bandwidth.py --sizes 4k,64k --iters 3
On the card drop the platform (each rank uses cuda:(local_rank %
device_count)); ``--out DIR`` writes rank 0's report as ``p2p.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import cvar, native
from ompi_tpu_torch.pml import accel_p2p

TAG = 77


def parse_bytes(s: str) -> int:
    s = s.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}
    if s and s[-1] in mult:
        return int(float(s[:-1]) * mult[s[-1]])
    return int(s)


def make(nbytes: int, dtype: torch.dtype, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    n = nbytes // torch.tensor([], dtype=dtype).element_size()
    if dtype == torch.int32:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g,
                             device=dev, dtype=torch.int32)
    return torch.rand(n, generator=g, device=dev).to(dtype)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p50(xs) -> float:
    return float(np.median(xs))


def pingpong(comm, x: torch.Tensor, iters: int, dev) -> dict:
    """Rank 0 sends x and receives it back from rank 1; returns the
    round trips (ms) and whether every echo was bitwise x."""
    peer = 1 - comm.rank
    buf = torch.empty_like(x)
    times, ok = [], True
    for _ in range(iters + 1):  # the first round trip warms up
        buf.fill_(0)
        sync(dev)
        comm.Barrier()
        t0 = time.perf_counter()
        if comm.rank == 0:
            comm.Send(x, dest=peer, tag=TAG)
            comm.Recv(buf, source=peer, tag=TAG)
        else:
            comm.Recv(buf, source=peer, tag=TAG)
            comm.Send(buf, dest=peer, tag=TAG)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        ok &= bitwise_equal(buf, x)
    return {"ms": times[1:], "ok": bool(ok)}


def host_pingpong(comm, nbytes: int, iters: int) -> list:
    """The same bytes as numpy through the same pml (round trips, ms)."""
    peer = 1 - comm.rank
    a = np.arange(nbytes, dtype=np.uint8)
    b = np.empty_like(a)
    times = []
    for _ in range(iters + 1):
        comm.Barrier()
        t0 = time.perf_counter()
        if comm.rank == 0:
            comm.Send(a, dest=peer, tag=TAG)
            comm.Recv(b, source=peer, tag=TAG)
        else:
            comm.Recv(b, source=peer, tag=TAG)
            comm.Send(b, dest=peer, tag=TAG)
        times.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(a, b):
        raise AssertionError("host ping-pong: echo differs")
    return times[1:]


def copy_ms(dst: torch.Tensor, src: torch.Tensor, iters: int, dev) -> list:
    times = []
    for _ in range(iters + 1):
        sync(dev)
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return times[1:]


def gbps(nbytes: int, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9


def run_pairs(comm, args, dev) -> dict:
    cases = [(s, None) for s in args.sizes] + \
        [(s, 0) for s in args.whole_sizes]
    default_chunk = cvar.get("pml_accel_chunk_bytes")
    report = {"pingpong": [], "stages": [], "dtypes": []}
    for i, (nbytes, chunk) in enumerate(cases):
        cvar.set("pml_accel_chunk_bytes",
                 default_chunk if chunk is None else chunk)
        x = make(nbytes, torch.float32, args.seed + i, dev)
        got = pingpong(comm, x, args.iters, dev)
        rt = p50(got["ms"])
        report["pingpong"].append({
            "bytes": nbytes, "chunk_bytes": cvar.get("pml_accel_chunk_bytes"),
            "iters": args.iters, "rt_p50_ms": rt, "oneway_ms": rt / 2,
            "oneway_gbps": gbps(nbytes, rt / 2), "ok": got["ok"]})
        del x
    cvar.set("pml_accel_chunk_bytes", default_chunk)
    for nbytes in args.sizes:
        x = make(nbytes, torch.float32, args.seed, dev).view(torch.uint8)
        host = torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        d2h = p50(copy_ms(host, x, args.iters, dev))
        h2d = p50(copy_ms(x, host, args.iters, dev))
        hp = p50(host_pingpong(comm, nbytes, args.iters))
        report["stages"].append({
            "bytes": nbytes, "d2h_ms": d2h, "d2h_gbps": gbps(nbytes, d2h),
            "h2d_ms": h2d, "h2d_gbps": gbps(nbytes, h2d),
            "host_oneway_ms": hp / 2,
            "host_oneway_gbps": gbps(nbytes, hp / 2)})
        del x, host
    # the other dtypes, and a ragged last chunk (3 MiB + 4 B of float32)
    for j, (name, dtype, nbytes) in enumerate((
            ("bfloat16", torch.bfloat16, args.dtype_bytes),
            ("int32", torch.int32, args.dtype_bytes),
            ("float32_ragged", torch.float32, args.ragged_bytes))):
        x = make(nbytes, dtype, args.seed + 100 + j, dev)
        got = pingpong(comm, x, 1, dev)
        report["dtypes"].append({"name": name, "bytes": nbytes,
                                 "ok": got["ok"]})
    return report


def run_ring(comm, args, dev) -> dict:
    """Every rank sends to the next and receives from the previous with
    one Sendrecv of float32 tensors; bitwise against the previous rank's
    tensor, made anew here from its seed."""
    n, r = comm.size, comm.rank
    x = make(args.ring_bytes, torch.float32, args.seed + r, dev)
    buf = torch.empty_like(x)
    times = []
    for _ in range(args.iters + 1):
        buf.fill_(0)
        sync(dev)
        comm.Barrier()
        t0 = time.perf_counter()
        st = comm.Sendrecv(x, (r + 1) % n, buf, source=(r - 1) % n,
                           sendtag=TAG, recvtag=TAG)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    want = make(args.ring_bytes, torch.float32, args.seed + (r - 1) % n, dev)
    return {"bytes": args.ring_bytes, "ranks": n,
            "p50_ms": p50(times[1:]), "source": st.source,
            "count": st.count,
            "ok": bitwise_equal(buf, want) and st.count == x.nbytes}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="4k,1m,64m,256m")
    ap.add_argument("--whole-sizes", default="64m",
                    help="sizes also run at pml_accel_chunk_bytes 0")
    ap.add_argument("--dtype-bytes", default="1m")
    ap.add_argument("--ragged-bytes", default=str((3 << 20) + 4))
    ap.add_argument("--ring-bytes", default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    args.sizes = [parse_bytes(s) for s in args.sizes.split(",") if s]
    args.whole_sizes = [parse_bytes(s) for s in args.whole_sizes.split(",")
                        if s]
    args.dtype_bytes = parse_bytes(args.dtype_bytes)
    args.ragged_bytes = parse_bytes(args.ragged_bytes)

    comm = mpi.Init()
    dev = accel_p2p.rank_device()
    if args.ring_bytes is not None:
        args.ring_bytes = parse_bytes(args.ring_bytes)
        doc = {"ring": run_ring(comm, args, dev)}
        oks = comm.allgather(doc["ring"]["ok"])
    else:
        if comm.size != 2:
            raise SystemExit("p2p_bandwidth: run the ping-pong on 2 ranks")
        doc = run_pairs(comm, args, dev)
        oks = [all(c["ok"] for c in doc["pingpong"] + doc["dtypes"])]
    doc["device"] = str(dev)
    doc["sm_ring"] = comm.allgather(
        "c" if native.lib() is not None else "python")
    doc["ok"] = all(oks)
    if comm.rank == 0:
        print(json.dumps(doc), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "p2p.json"), "w") as f:
                json.dump(doc, f)
    mpi.Finalize()
    if not doc["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
