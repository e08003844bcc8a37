"""Device-buffer collectives, checked and timed — the port's main path.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        [--mca coll_cuda on] ompi_tpu_torch/examples/device_collectives.py

With ``coll_cuda on`` the hand-written ring collectives (coll/cuda) serve
Allreduce, Reduce_scatter_block and Allgather and hand what their kernels
do not take to coll/device; without it coll/device (the coll/xla
counterpart) serves them all. Bcast and Alltoall are coll/device's in
either case.

Each rank makes its input from ``(seed, rank)`` with a seeded generator on
its own device and runs the families named by ``--kinds``: ``allreduce``
(linear, ring and the default mode at every size of ``--sizes``, then
bfloat16 and int32), ``rsag`` (Reduce_scatter_block in the three modes and
Allgather at each ``--rsag-bytes``), ``bcast`` (float32 from root 0 and
root n-1), ``alltoall`` (int32, the MoE dispatch pattern), ``ops`` (the
traceable ops outside the kernels' matrix in the three modes: float16
SUM, int32 BXOR, bool LAND) and ``self`` (every slot on COMM_SELF). It
checks every result against the result it computes on its own device
from all ranks' regenerated inputs: bitwise under ``linear`` and
``ring`` (whose fold orders are known: rank order, and ranks c+1, ...,
c+n for chunk c) and for the copies, and to a stated tolerance in the
default mode (whose algorithm the selection may change). It prints one
line of timings per case (rank 0) and, with ``--out DIR``, writes each
rank's results and kernel launch counts to ``DIR/rank<r>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from ompi_tpu_torch import mpi, op as op_mod
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import cvar
from ompi_tpu_torch.runtime import device_plane

#: the kernels this path runs (the fused ones run in zero_training.py)
PATH_KERNELS = (K.ring_rs_hop, K.ring_ag_hop, K.linear_fold)
KINDS = ("allreduce", "rsag", "bcast", "alltoall", "ops", "self")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
#: default-mode tolerance (the fold order is the selection's choice):
#: relative to the sum of magnitudes, per element
DEFAULT_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2,
                torch.float16: 2e-3}
#: the ops family: traceable ops outside the kernels' dtypes and ops
OPS_CASES = (("MPI_SUM", torch.float16), ("MPI_BXOR", torch.int32),
             ("MPI_LAND", torch.bool))
#: this example's own oracle of the ops outside the kernels
_ORACLE = {"MPI_BXOR": torch.bitwise_xor, "MPI_LAND": torch.logical_and}


def make_input(seed: int, rank: int, numel: int, dtype, device):
    g = torch.Generator(device=device).manual_seed(seed * 1000003 + rank)
    if dtype == torch.int32:
        return torch.randint(-(1 << 31), (1 << 31) - 1, (numel,),
                             generator=g, device=device, dtype=torch.int32)
    x = torch.randn(numel, generator=g, device=device)
    return x > -0.5 if dtype == torch.bool else x.to(dtype)


def _fold(xs, op):
    acc = xs[0]
    for x in xs[1:]:
        acc = _ORACLE[op](acc, x) if op in _ORACLE else \
            K.combine(op, acc, x)
    return acc


def expected_allreduce(xs, op, algo, n):
    """The plain-version result of each algorithm's fold order."""
    m = xs[0].numel()
    if algo == "linear":
        return _fold(xs, op)
    k = K.padded_chunk(m, n)
    pad = [torch.nn.functional.pad(x, (0, n * k - m)) for x in xs]
    parts = ([(1, 0, k // 2), (-1, k // 2, k - k // 2)] if algo == "bidir"
             else [(1, 0, k)])
    out = torch.empty_like(pad[0])
    for c in range(n):
        for d, lo, w in parts:
            sl = slice(c * k + lo, c * k + lo + w)
            out[sl] = _fold([pad[p][sl] for p in K.ring_order(n, c, d)], op)
    return out[:m]


def bits_equal(a, b) -> bool:
    """Bitwise equality; where both are NaN any payload is accepted."""
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False
        a, b = a[~na], b[~nb]
        iv = torch.int16 if a.element_size() == 2 else torch.int32
        return a.dtype == b.dtype and torch.equal(a.view(iv), b.view(iv))
    return torch.equal(a, b)


def close(got, exp, xs, dtype) -> bool:
    if dtype not in DEFAULT_RTOL:  # integers: the sum is order-free
        return torch.equal(got, exp)
    mag = sum(x.float().abs() for x in xs)
    return bool(((got.float() - exp.float()).abs()
                 <= DEFAULT_RTOL[dtype] * mag + 1e-30).all())


def timed(comm, fn, iters: int, device, profile: bool = False):
    """(result, p50 host-clock ms, device ms per call or None) of fn()
    over iters calls after one warm-up, each ended by a device
    synchronise. With ``profile``, torch.profiler records the timed
    calls and the device time is the sum of this rank's device
    activities (kernels, copies, fills) over the window, per call."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn()
    prof = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        prof = tprofile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    ts = []
    with prof:
        for _ in range(iters):
            comm.Barrier()
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
    dev_ms = None
    if profile:
        dev_us = sum(getattr(e, "self_device_time_total", 0)
                     for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA"))
        dev_ms = dev_us / 1e3 / iters
    ts.sort()
    return out, ts[len(ts) // 2], dev_ms


def _sizes(spec: str):
    out = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(tok[-1:], 1)
        out.append(int(tok.rstrip("kmg")) * mult)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="families to run, of " + ", ".join(KINDS))
    ap.add_argument("--sizes", default="1k,1m,64m,256m",
                    help="float32 Allreduce payloads in bytes (k/m/g)")
    ap.add_argument("--dtype-bytes", default="1m",
                    help="payload of the bfloat16 and int32 Allreduce")
    ap.add_argument("--rsag-bytes", default="64m",
                    help="Reduce_scatter_block / Allgather payloads")
    ap.add_argument("--bcast-bytes", default="1m",
                    help="float32 Bcast payloads")
    ap.add_argument("--alltoall-bytes", default="1m,64m",
                    help="int32 Alltoall payloads per rank")
    ap.add_argument("--ops-bytes", default="1m",
                    help="payload of the ops family")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", action="store_true",
                    help="on a card, rank 0 traces its timed calls with "
                         "torch.profiler and reports its device ms per call "
                         "beside the wall")
    ns = ap.parse_args(argv)
    kinds = [k for k in ns.kinds.split(",") if k]
    unknown = set(kinds) - set(KINDS)
    if unknown:
        ap.error(f"unknown kinds {sorted(unknown)}")

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    provider = "cuda" if cvar.get("coll_cuda") == "on" else "device"
    for slot in ("allreduce_dev", "reduce_scatter_block_dev",
                 "allgather_dev"):
        assert comm.coll.providers.get(slot) == provider, \
            (slot, comm.coll.providers)
    for slot in ("bcast_dev", "alltoall_dev"):
        assert comm.coll.providers.get(slot) == "device", \
            (slot, comm.coll.providers)
    K.reset_launches()
    cases = []

    prof = ns.profile and r == 0 and dev.type == "cuda"

    def record(kind, dtype, nbytes, mode, timing, ok, bus_bytes, c=comm):
        """bus_bytes: the bytes of the bus-bandwidth convention
        (2(n-1)/n x payload for Allreduce, (n-1)/n x total for RS/AG and
        Alltoall, the payload for Bcast)."""
        _, ms, dev_ms = timing
        busbw = bus_bytes / ms / 1e6
        cases.append({"kind": kind, "dtype": str(dtype).split(".")[-1],
                      "bytes": nbytes, "mode": mode, "ranks": c.size,
                      "p50_ms": ms, "device_ms": dev_ms,
                      "busbw_GBps": busbw, "ok": ok})
        if r == 0:
            dv = "" if dev_ms is None else \
                f", rank 0 device time {dev_ms:.3f} ms/call"
            print(f"[device_collectives n={c.size} {provider}] {kind} "
                  f"{cases[-1]['dtype']} {nbytes} B mode={mode}: p50 "
                  f"{ms:.3f} ms{dv}, bus bandwidth {busbw:.2f} GB/s, "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)

    def elems(nbytes, dtype, multiple=1):
        size = torch.empty(0, dtype=dtype).element_size()
        return nbytes // size // multiple * multiple

    def allreduces(dtype, nbytes, op):
        numel = elems(nbytes, dtype)
        xs = [make_input(ns.seed, p, numel, dtype, dev) for p in range(n)]
        for mode in ("linear", "ring", None):
            t = timed(comm, lambda: comm.Allreduce(
                xs[r], op=op_mod.BUILTIN[op], deterministic=mode),
                ns.iters, dev, prof)
            exp = expected_allreduce(xs, op, mode or "linear", n)
            ok = close(t[0], exp, xs, dtype) if mode is None and \
                op == "MPI_SUM" else bits_equal(t[0], exp)
            record("Allreduce" if op == "MPI_SUM" else f"Allreduce {op}",
                   dtype, numel * xs[0].element_size(), mode or "default",
                   t, ok, 2 * (n - 1) / n * nbytes)

    if "allreduce" in kinds:
        for nbytes in _sizes(ns.sizes):
            allreduces(torch.float32, nbytes, "MPI_SUM")
        for dname in ("bfloat16", "int32"):
            allreduces(DTYPES[dname], _sizes(ns.dtype_bytes)[0], "MPI_SUM")
    if "ops" in kinds:
        for op, dtype in OPS_CASES:
            allreduces(dtype, _sizes(ns.ops_bytes)[0], op)

    for nbytes in _sizes(ns.rsag_bytes) if "rsag" in kinds else ():
        rows = elems(nbytes, torch.float32, n) // n
        total = rows * n * 4
        xs = [make_input(ns.seed + 1, p, rows * n, torch.float32, dev)
              for p in range(n)]
        for mode in ("linear", "ring", None):
            t = timed(comm, lambda: comm.Reduce_scatter_block(
                xs[r], op=mpi.SUM, deterministic=mode), ns.iters, dev, prof)
            exp = expected_allreduce(xs, "MPI_SUM", mode or "linear", n)[
                r * rows:(r + 1) * rows]
            ok = close(t[0], exp, [x[r * rows:(r + 1) * rows] for x in xs],
                       torch.float32) if mode is None \
                else bits_equal(t[0], exp)
            record("Reduce_scatter_block", torch.float32, total,
                   mode or "default", t, ok, (n - 1) / n * total)
        del xs
        block = make_input(ns.seed + 2, r, rows, torch.float32, dev)
        t = timed(comm, lambda: comm.Allgather(block), ns.iters, dev, prof)
        exp = torch.stack([make_input(ns.seed + 2, p, rows, torch.float32,
                                      dev) for p in range(n)])
        record("Allgather", torch.float32, total, "default", t,
               bits_equal(t[0], exp), (n - 1) / n * total)

    for nbytes in _sizes(ns.bcast_bytes) if "bcast" in kinds else ():
        numel = elems(nbytes, torch.float32)
        for root in sorted({0, n - 1}):
            src = make_input(ns.seed + 3, root, numel, torch.float32, dev)
            buf = src if r == root else torch.zeros_like(src)
            t = timed(comm, lambda: comm.Bcast(buf, root=root), ns.iters,
                      dev, prof)
            record(f"Bcast root={root}", torch.float32, numel * 4,
                   "default", t, bits_equal(t[0], src) and
                   bits_equal(buf, src), numel * 4)

    for nbytes in _sizes(ns.alltoall_bytes) if "alltoall" in kinds else ():
        numel = elems(nbytes, torch.int32, n)
        b = numel // n
        x = make_input(ns.seed + 4, r, numel, torch.int32, dev)
        t = timed(comm, lambda: comm.Alltoall(x), ns.iters, dev, prof)
        exp = torch.cat([make_input(ns.seed + 4, p, numel, torch.int32,
                                    dev)[r * b:(r + 1) * b]
                         for p in range(n)])
        record("Alltoall", torch.int32, numel * 4, "default", t,
               torch.equal(t[0], exp), (n - 1) / n * numel * 4)

    if "self" in kinds:  # every slot on a one-rank comm: a new tensor
        one = mpi.COMM_SELF
        x = make_input(ns.seed + 5, r, elems(_sizes(ns.ops_bytes)[0],
                                             torch.float32), torch.float32,
                       dev)
        for kind, fn in (
                ("Allreduce", lambda: one.Allreduce(x)),
                ("Reduce_scatter_block",
                 lambda: one.Reduce_scatter_block(x)),
                ("Allgather", lambda: one.Allgather(x)[0]),
                ("Bcast", lambda: one.Bcast(x)),
                ("Alltoall", lambda: one.Alltoall(x))):
            t = timed(one, fn, ns.iters, dev, prof)
            record(f"{kind} COMM_SELF", torch.float32, x.numel() * 4,
                   "default", t, bits_equal(t[0], x) and
                   t[0].data_ptr() != x.data_ptr(), 0, one)

    launches = {k.__name__: k.launches for k in PATH_KERNELS}
    # K2 moves every byte of a multi-rank case; K1 and K3 run the
    # reductions the kernels take (float32 / bfloat16 / int32 SUM)
    required = ["ring_ag_hop"] if set(kinds) - {"self"} else []
    if {"allreduce", "rsag"} & set(kinds):
        required += ["ring_rs_hop", "linear_fold"]
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "provider": provider, "launches": launches,
                       "required": required, "cases": cases}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: mismatching results: {bad}"
    # the plain versions (CPU tensors) launch nothing; on the card every
    # kernel the run needs must have run
    assert dev.type != "cuda" or all(launches[k] > 0 for k in required), \
        f"rank {r}: a kernel of the path never launched: {launches}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
