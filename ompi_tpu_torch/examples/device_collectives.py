"""Device-buffer collectives, checked and timed — the port's main path.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        [--mca coll_cuda on] ompi_tpu_torch/examples/device_collectives.py

With ``coll_cuda on`` the hand-written ring collectives (coll/cuda) serve
Allreduce, Reduce_scatter_block and Allgather and hand what their kernels
do not take to coll/device; without it coll/device (the coll/xla
counterpart) serves them all. Every other call is coll/device's in
either case.

Each rank makes its input from ``(seed, rank)`` with a seeded generator on
its own device and runs the families named by ``--kinds``: ``allreduce``
(linear, ring and the default mode at every size of ``--sizes``, then
bfloat16 and int32), ``rsag`` (Reduce_scatter_block in the three modes and
Allgather at each ``--rsag-bytes``), ``bcast`` (float32 from root 0 and
root n-1), ``alltoall`` (int32, the MoE dispatch pattern), ``ops`` (the
traceable ops outside the kernels' matrix in the three modes: float16
SUM, int32 BXOR, bool LAND), ``rooted`` (Reduce float32 SUM to root 0 in
the three modes and bfloat16 MAX, the binomial tree, at
``--rooted-bytes``; Gather float32 of ``--gather-bytes`` a rank to root
n-1; Scatter float32 from root 0; a non-root's peak of allocated device
bytes must stay below n x the payload), ``vcoll`` (Allgatherv, Gatherv
and Scatterv int32 and Reduce_scatter float32 'linear' and default, with
skewed seeded counts, at ``--vcoll-bytes`` a rank; Alltoallv int32 of
``--a2av-tokens`` tokens of ``--a2av-lanes`` lanes a rank with skewed
seeded counts, BASELINE config 5's pattern, with ``max_count`` and with
the count round), ``scan`` (Scan / Exscan float32 SUM and int32 MAX),
``barrier`` (the device Barrier's p50), ``nonblocking`` (every ``I*``
call and Ibarrier, completed by ``wait_all``, each equal to its blocking
call bitwise; then Iallreduce + wait at ``--rooted-bytes``),
``persistent`` (each ``*_init`` started 3 times, its buffers refilled
before each start; then Allreduce_init's start + wait timed), ``self``
(every slot on COMM_SELF), ``host`` (numpy buffers through the host
collectives, coll/tuned: float32 SUM Allreduce at each
``--host-sizes`` under the default decision, each beside the same
call on a CUDA tensor (the device path); float32 and int32 under each
forced algorithm at ``--host-forced-bytes``; float32 Bcast of
``--host-bcast-bytes`` from root 0 and n-1 under the default decision
(binomial) and forced ``linear``, beside the device Bcast; int32 exact
and float32 ``basic`` bitwise against a numpy rank-order fold, the other
float32 algorithms within ``HOST_RTOL``) and ``staged`` (tensors that
coll/device hands to coll/accelerator: float64 Allreduce at
``--staged-bytes``, REPLACE and an ``op.create`` user op at
``--staged-op-bytes``, one staged Iallreduce; each bitwise equal to the
same host collective on numpy copies, on the rank's own device, and
``coll_accelerator_staged`` equal to the staged calls made). ``staged``
runs last: the ``coll_accelerator_staged`` count before it (every other
family: nothing may stage there) is reported beside the kernels'
launches. ``host`` and ``staged`` run only when ``--kinds`` names them. It checks every result against the
result it computes on its own device from all ranks' regenerated
inputs: bitwise under ``linear`` and ``ring`` (whose fold orders are
known: rank order, and ranks c+1, ..., c+n for chunk c; the rooted SUM's
reduce-scatter folds in the ring's order too), for the binomial MAX, the
prefixes and the copies, and to a stated tolerance in the default mode
(whose algorithm the selection may change). It prints one line of
timings per case (rank 0) and, with ``--out DIR``, writes each rank's
results and kernel launch counts to ``DIR/rank<r>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi, op as op_mod
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.pml import request as rq
from ompi_tpu_torch.runtime import device_plane

#: the kernels this path runs (the fused ones run in zero_training.py)
PATH_KERNELS = (K.ring_rs_hop, K.ring_ag_hop, K.linear_fold)
#: the device families, the default of --kinds
DEVICE_KINDS = ("allreduce", "rsag", "bcast", "alltoall", "ops", "rooted",
                "vcoll", "scan", "barrier", "nonblocking", "persistent",
                "self")
KINDS = DEVICE_KINDS + ("host", "staged")
#: coll/tuned's forced allreduce algorithms (coll_tuned_allreduce_algorithm)
HOST_ALGOS = ("recursivedoubling", "ring", "rabenseifner", "basic")
#: tolerance of a float32 host allreduce whose fold order is not the
#: rank order: relative to the sum of magnitudes, per element
HOST_RTOL = 1e-5
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


def _elems(nbytes, dtype, multiple=1):
    size = torch.empty(0, dtype=dtype).element_size()
    return nbytes // size // multiple * multiple


def _sizes(spec: str):
    out = []
    for tok in filter(None, spec.split(",")):
        tok = tok.strip().lower()
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(tok[-1:], 1)
        out.append(int(tok.rstrip("kmg")) * mult)
    return out


def _started(req):
    req.start()
    return req


def skewed_counts(seed: int, n: int, total: int, skew=(8, 4, 2, 1)):
    """An n x n matrix of rows: row p splits ``total`` tokens of rank p
    over the n ranks (multinomial, from the seed alone so every rank
    draws the same matrix), the hot destination rotating with p — the
    MoE dispatch's skew (BASELINE config 5)."""
    g = torch.Generator().manual_seed(seed)
    probs = torch.tensor([float(skew[i % len(skew)]) for i in range(n)])
    rows = []
    for p in range(n):
        pick = torch.multinomial(probs.roll(p), total, replacement=True,
                                 generator=g)
        rows.append([int(c) for c in torch.bincount(pick, minlength=n)])
    return rows


def _offsets(counts):
    return [sum(counts[:i]) for i in range(len(counts))]


def run_rest(comm, ns, kinds, dev, prof, record, check) -> None:
    """The families past BASELINE's slots: ``rooted``, ``vcoll``,
    ``scan``, ``barrier``, ``nonblocking`` and ``persistent`` (see the
    module docstring), each checked against a plain recomputation."""
    n, r = comm.size, comm.rank
    f32, i32 = torch.float32, torch.int32

    def inputs(seed, numel, dtype):
        return [make_input(seed, p, numel, dtype, dev) for p in range(n)]

    def nonroot_peak(fn, root):
        """A non-root's peak of allocated device bytes during fn() (0 off
        the card, where the torch allocator keeps no count)."""
        if dev.type != "cuda" or r == root:
            fn()
            return 0
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) - base

    def rooted(kind, fn, exp, root, nbytes, dtype, mode="default"):
        t = timed(comm, fn, ns.iters, dev, prof)
        peak = nonroot_peak(fn, root)
        ok = bits_equal(t[0], exp) if r == root else t[0] is None
        # a non-root holds O(bytes) (one chunk, two partials or nothing),
        # never the n-fold result
        ok = ok and peak < n * nbytes
        record(f"{kind} root={root}", dtype, nbytes, mode, t, ok, nbytes,
               nonroot_peak_bytes=peak)

    if "rooted" in kinds:
        nbytes = _sizes(ns.rooted_bytes)[0]
        numel = _elems(nbytes, f32, n)
        xs = inputs(ns.seed + 6, numel, f32)
        for mode in ("linear", "ring", None):
            # the rooted SUM (''): K1's ring reduce-scatter folds chunk c
            # in the ring's order, as the ring allreduce does
            rooted("Reduce", lambda: comm.Reduce(xs[r], root=0,
                                                 deterministic=mode),
                   expected_allreduce(xs, "MPI_SUM", mode or "ring", n)
                   if r == 0 else None, 0, numel * 4, f32,
                   mode or "default")
        bf = [x.to(torch.bfloat16) for x in xs]
        del xs
        rooted("Reduce MAX (binomial)",
               lambda: comm.Reduce(bf[r], op=mpi.MAX, root=0),
               _fold(bf, "MPI_MAX") if r == 0 else None, 0, numel * 2,
               torch.bfloat16)
        del bf
        gnumel = _elems(_sizes(ns.gather_bytes)[0], f32)
        xs = inputs(ns.seed + 7, gnumel, f32)
        rooted("Gather", lambda: comm.Gather(xs[r], root=n - 1),
               torch.stack(xs) if r == n - 1 else None, n - 1,
               gnumel * 4, f32)
        del xs
        src = make_input(ns.seed + 8, 0, numel, f32, dev)
        t = timed(comm, lambda: comm.Scatter(src if r == 0 else None,
                                             root=0, device=True),
                  ns.iters, dev, prof)
        b = numel // n
        record("Scatter root=0", f32, numel * 4, "default", t,
               bits_equal(t[0], src[r * b:(r + 1) * b]), numel * 4)
        del src

    if "vcoll" in kinds:
        lanes = ns.vcoll_lanes
        rows = _elems(_sizes(ns.vcoll_bytes)[0], i32) // lanes
        counts = skewed_counts(ns.seed + 10, n, rows * n)[0]
        offs = _offsets(counts)
        blocks = [make_input(ns.seed + 11, p, c * lanes, i32, dev).view(
            c, lanes) for p, c in enumerate(counts)]
        full = torch.cat(blocks)
        t = timed(comm, lambda: comm.Allgatherv(blocks[r], None, counts),
                  ns.iters, dev, prof)
        record("Allgatherv", i32, full.nbytes, "default", t,
               torch.equal(t[0], full), (n - 1) / n * full.nbytes)
        root = 1 % n
        t = timed(comm, lambda: comm.Gatherv(blocks[r], None, counts,
                                             root=root), ns.iters, dev, prof)
        record(f"Gatherv root={root}", i32, full.nbytes, "default", t,
               torch.equal(t[0], full) if r == root else t[0] is None,
               full.nbytes)
        t = timed(comm, lambda: comm.Scatterv(
            full if r == 0 else None, None, counts, root=0, device=True),
            ns.iters, dev, prof)
        record("Scatterv root=0", i32, full.nbytes, "default", t,
               torch.equal(t[0], blocks[r]), full.nbytes)
        del blocks, full
        # Reduce_scatter: float32 rows of lanes, ragged counts
        xs = [x.view(-1, lanes) for x in inputs(
            ns.seed + 12, _elems(_sizes(ns.vcoll_bytes)[0], f32) // lanes
            * lanes, f32)]
        rcounts = skewed_counts(ns.seed + 13, n, xs[0].shape[0])[0]
        lo = _offsets(rcounts)[r]
        for mode in ("linear", None):
            t = timed(comm, lambda: comm.Reduce_scatter(
                xs[r], None, rcounts, op=mpi.SUM, deterministic=mode),
                ns.iters, dev, prof)
            exp = expected_allreduce([x.reshape(-1) for x in xs], "MPI_SUM",
                                     mode or "ring", n).view(-1, lanes)[
                lo:lo + rcounts[r]]
            ok = bits_equal(t[0], exp) if mode else close(
                t[0], exp, [x[lo:lo + rcounts[r]] for x in xs], f32)
            record("Reduce_scatter", f32, xs[0].nbytes, mode or "default",
                   t, ok, (n - 1) / n * xs[0].nbytes)
        del xs
        # Alltoallv: each rank routes a2av_tokens tokens of a2av_lanes
        # int32 lanes over the n ranks with skewed counts
        toks, width = ns.a2av_tokens, ns.a2av_lanes
        mat = skewed_counts(ns.seed + 14, n, toks)
        send = make_input(ns.seed + 15, r, toks * width, i32, dev).view(
            toks, width)
        sc, rc = mat[r], [mat[p][r] for p in range(n)]
        exp = torch.cat([
            make_input(ns.seed + 15, p, toks * width, i32, dev).view(
                toks, width)[_offsets(mat[p])[r]:][:mat[p][r]]
            for p in range(n)])
        cap = max(max(row) for row in mat)
        for label, mc in (("max_count", cap), ("count round", None)):
            t = timed(comm, lambda: comm.Alltoallv(send, None, sc, rc,
                                                   max_count=mc),
                      ns.iters, dev, prof)
            record(f"Alltoallv ({label})", i32, send.nbytes, "default", t,
                   torch.equal(t[0], exp), (n - 1) / n * send.nbytes)
        del send, exp

    if "scan" in kinds:
        for dtype, op in ((f32, "MPI_SUM"), (i32, "MPI_MAX")):
            numel = _elems(_sizes(ns.scan_bytes)[0], dtype)
            xs = inputs(ns.seed + 16, numel, dtype)
            for name, fn, rows in (
                    ("Scan", comm.Scan, r + 1), ("Exscan", comm.Exscan, r)):
                t = timed(comm, lambda: fn(xs[r], op=op_mod.BUILTIN[op]),
                          ns.iters, dev, prof)
                exp = _fold(xs[:rows], op) if rows else \
                    torch.zeros_like(xs[r])
                record(f"{name} {op}", dtype, numel * xs[0].element_size(),
                       "default", t, bits_equal(t[0], exp),
                       numel * xs[0].element_size())
            del xs

    if "barrier" in kinds:
        t = timed(comm, lambda: comm.Barrier(device=True), ns.iters, dev,
                  prof)
        record("Barrier(device=True)", i32, 4, "linear", t, True, 4)

    if "nonblocking" in kinds:
        numel = _elems(_sizes(ns.ops_bytes)[0], f32, n)
        x = make_input(ns.seed + 17, r, numel, f32, dev)
        counts = [numel // n] * n
        chunk = torch.empty(numel // n, device=dev)
        calls = [
            ("Iallreduce", lambda: comm.Iallreduce(x, deterministic="linear"),
             lambda: comm.Allreduce(x, deterministic="linear")),
            ("Ibcast", lambda: comm.Ibcast(x, root=n - 1),
             lambda: comm.Bcast(x.clone(), root=n - 1)),
            ("Ireduce", lambda: comm.Ireduce(x, root=0),
             lambda: comm.Reduce(x, root=0)),
            ("Iallgather", lambda: comm.Iallgather(x),
             lambda: comm.Allgather(x)),
            ("Igather", lambda: comm.Igather(x, root=0),
             lambda: comm.Gather(x, root=0)),
            ("Ialltoall", lambda: comm.Ialltoall(x),
             lambda: comm.Alltoall(x)),
            ("Ireduce_scatter_block", lambda: comm.Ireduce_scatter_block(x),
             lambda: comm.Reduce_scatter_block(x)),
            # a receive template on every rank: no metadata round, so
            # no signature cached against the rooted family's Scatter
            ("Iscatter", lambda: comm.Iscatter(x, chunk, root=0),
             lambda: comm.Scatter(x, chunk.clone(), root=0)),
            ("Iscan", lambda: comm.Iscan(x), lambda: comm.Scan(x)),
            ("Iexscan", lambda: comm.Iexscan(x), lambda: comm.Exscan(x)),
            ("Iallgatherv", lambda: comm.Iallgatherv(x, None, [numel] * n),
             lambda: comm.Allgatherv(x, None, [numel] * n)),
            ("Igatherv", lambda: comm.Igatherv(x, None, [numel] * n),
             lambda: comm.Gatherv(x, None, [numel] * n)),
            ("Ialltoallv", lambda: comm.Ialltoallv(x, None, counts, counts),
             lambda: comm.Alltoallv(x, None, counts, counts)),
            ("Iscatterv", lambda: comm.Iscatterv(x, chunk, counts, root=0),
             lambda: comm.Scatterv(x, chunk.clone(), counts, root=0)),
            ("Ireduce_scatter", lambda: comm.Ireduce_scatter(x, None,
                                                             counts),
             lambda: comm.Reduce_scatter(x, None, counts)),
            # the barrier's allreduce counts the members that entered
            ("Ibarrier", lambda: comm.Ibarrier(device=True),
             lambda: torch.full((1,), n, dtype=i32, device=dev))]
        reqs = [issue() for _, issue, _ in calls]
        rq.wait_all(reqs)
        for (name, _, block), req in zip(calls, reqs):
            want = block()
            ok = req.completed and (req.array is None if want is None
                                    else bits_equal(req.array, want))
            check(f"{name} == its blocking call", ok)
        big = _elems(_sizes(ns.rooted_bytes)[0], f32)
        xs = inputs(ns.seed + 18, big, f32)

        def iallreduce():
            req = comm.Iallreduce(xs[r], deterministic="linear")
            req.wait()
            return req.array
        t = timed(comm, iallreduce, ns.iters, dev, prof)
        record("Iallreduce + wait", f32, big * 4, "linear", t,
               bits_equal(t[0], _fold(xs, "MPI_SUM")),
               2 * (n - 1) / n * big * 4)
        del xs

    if "persistent" in kinds:
        big = _elems(_sizes(ns.rooted_bytes)[0], f32, n)
        numel = _elems(_sizes(ns.ops_bytes)[0], f32, n)
        buf = make_input(ns.seed + 19, r, big, f32, dev)
        small = make_input(ns.seed + 20, r, numel, i32, dev)
        tree = {"a": small, "b": [buf[:numel // 3 + 1]]}
        reqs = {"Allreduce_init": comm.Allreduce_init(buf),
                "Bcast_init": comm.Bcast_init(small, root=n - 1),
                "Allgather_init": comm.Allgather_init(small),
                "Alltoall_init": comm.Alltoall_init(small),
                "Reduce_scatter_block_init":
                    comm.Reduce_scatter_block_init(small, op=mpi.MAX),
                "Allreduce_multi_init": comm.Allreduce_multi_init(tree)}
        for cycle in range(3):  # each start reads the buffers' contents
            buf.copy_(make_input(ns.seed + 21 + cycle, r, big, f32, dev))
            small.copy_(make_input(ns.seed + 31 + cycle, r, numel, i32,
                                   dev))
            bufs = inputs(ns.seed + 21 + cycle, big, f32)
            smalls = inputs(ns.seed + 31 + cycle, numel, i32)
            k = numel // n
            want = {"Allreduce_init": expected_allreduce(
                        bufs, "MPI_SUM", "ring", n),
                    "Bcast_init": smalls[n - 1],
                    "Allgather_init": torch.stack(smalls),
                    "Alltoall_init": torch.cat(
                        [s[r * k:(r + 1) * k] for s in smalls]),
                    "Reduce_scatter_block_init": _fold(
                        smalls, "MPI_MAX")[r * k:(r + 1) * k],
                    "Allreduce_multi_init": None}
            for name, req in reqs.items():
                req.start()
                req.wait()
                got = req.array
                if name == "Allreduce_multi_init":
                    ok = torch.equal(got["a"], _fold(smalls, "MPI_SUM")) \
                        and close(got["b"][0],
                                  want["Allreduce_init"][:numel // 3 + 1],
                                  [b[:numel // 3 + 1] for b in bufs], f32)
                else:
                    ok = bits_equal(got, want[name])
                check(f"{name} start {cycle}", ok)
            del bufs, smalls
        ar = reqs["Allreduce_init"]

        def restart():
            ar.start()
            ar.wait()
            return ar.array
        t = timed(comm, restart, ns.iters, dev, prof)
        record("Allreduce_init start + wait", f32, big * 4, "default", t,
               t[0].shape == buf.shape, 2 * (n - 1) / n * big * 4)
        for req in reqs.values():
            req.free()


def host_input(seed: int, rank: int, numel: int, dtype) -> np.ndarray:
    """A rank's numpy input, from ``(seed, rank)``."""
    g = np.random.default_rng(seed * 1000003 + rank)
    if dtype == np.int32:
        return g.integers(-(1 << 31), (1 << 31) - 1, numel, dtype=np.int32)
    return (g.random(numel, dtype=np.float32) - 0.5).astype(dtype)


def run_host(comm, ns, dev, prof, record) -> None:
    """The ``host`` family: numpy buffers through coll/tuned, each case
    beside the device path's call of the same size."""
    n, r = comm.size, comm.rank
    cpu = torch.device("cpu")

    def fold(xs):  # the rank-order numpy fold (coll/basic's order)
        acc = xs[0].copy()
        for x in xs[1:]:
            acc = acc + x
        return acc

    def host_allreduce(x):
        out = np.empty_like(x)
        comm.Allreduce(x, out)
        return out

    def ok_f32(got, xs, exp, bitwise):
        if bitwise:
            return np.array_equal(got.view(np.uint32), exp.view(np.uint32))
        mag = sum(np.abs(x) for x in xs)
        return bool((np.abs(got - exp) <= HOST_RTOL * mag + 1e-30).all())

    for nbytes in _sizes(ns.host_sizes):
        numel = nbytes // 4
        x = host_input(ns.seed + 6, r, numel, np.float32)
        t = timed(comm, lambda: host_allreduce(x), ns.iters, cpu)
        xs = [host_input(ns.seed + 6, p, numel, np.float32)
              for p in range(n)]
        exp = fold(xs)
        record("host Allreduce", torch.float32, nbytes, "tuned default",
               t, ok_f32(t[0], xs, exp, False), 2 * (n - 1) / n * nbytes)
        xd = torch.from_numpy(x).to(dev)
        t = timed(comm, lambda: comm.Allreduce(xd), ns.iters, dev, prof)
        record("device Allreduce beside host", torch.float32, nbytes,
               "default", t, ok_f32(t[0].cpu().numpy(), xs, exp, False),
               2 * (n - 1) / n * nbytes)
        del xs, exp, xd
    for nbytes in _sizes(ns.host_forced_bytes):
        numel = nbytes // 4
        for dtype in (np.float32, np.int32):
            xs = [host_input(ns.seed + 7, p, numel, dtype)
                  for p in range(n)]
            exp = fold(xs)
            for algo in HOST_ALGOS + ("",):
                cvar.set("coll_tuned_allreduce_algorithm", algo)
                t = timed(comm, lambda: host_allreduce(xs[r]), ns.iters,
                          cpu)
                ok = np.array_equal(t[0], exp) if dtype == np.int32 else \
                    ok_f32(t[0], xs, exp, algo == "basic")
                record("host Allreduce by algorithm",
                       torch.int32 if dtype == np.int32 else torch.float32,
                       nbytes,
                       f"tuned {algo or 'default'}", t, ok,
                       2 * (n - 1) / n * nbytes)
            cvar.set("coll_tuned_allreduce_algorithm", "")
    for nbytes in _sizes(ns.host_bcast_bytes):
        numel = nbytes // 4
        for root in sorted({0, n - 1}):
            src = host_input(ns.seed + 8, root, numel, np.float32)
            buf = src.copy() if r == root else np.zeros_like(src)

            def bcast():
                comm.Bcast(buf, root=root)
                return buf
            for algo in _host_algos(ns.host_bcast_algos):
                cvar.set("coll_tuned_bcast_algorithm", algo)
                if r != root:
                    buf[:] = 0
                t = timed(comm, bcast, ns.iters, cpu)
                record(f"host Bcast root={root}", torch.float32, nbytes,
                       f"tuned {algo or 'default'}", t,
                       np.array_equal(buf.view(np.uint32),
                                      src.view(np.uint32)), nbytes)
            cvar.set("coll_tuned_bcast_algorithm", "")
            sd = torch.from_numpy(src).to(dev)
            bd = sd if r == root else torch.zeros_like(sd)
            t = timed(comm, lambda: comm.Bcast(bd, root=root), ns.iters,
                      dev, prof)
            record(f"device Bcast root={root} beside host", torch.float32,
                   nbytes, "default", t, bits_equal(t[0], sd), nbytes)
    for nbytes in _sizes(ns.host_allgather_bytes):
        numel = max(1, nbytes // 4 // n)
        xs = [host_input(ns.seed + 11, p, numel, np.int32) for p in range(n)]
        out = np.empty(numel * n, np.int32)
        for algo in ("ring", "bruck", "recursivedoubling", "basic", ""):
            cvar.set("coll_tuned_allgather_algorithm", algo)
            t = timed(comm, lambda: comm.Allgather(xs[r], out) or out,
                      ns.iters, cpu)
            record("host Allgather by algorithm", torch.int32,
                   numel * n * 4, f"tuned {algo or 'default'}", t,
                   np.array_equal(out, np.concatenate(xs)),
                   (n - 1) / n * numel * n * 4)
        cvar.set("coll_tuned_allgather_algorithm", "")


def _host_algos(spec: str):
    """A comma list of forced-algorithm names; ``default`` is coll/tuned's
    own decision (the cvar's empty value)."""
    return ["" if a == "default" else a for a in spec.split(",") if a]


def run_staged(comm, ns, dev, prof, record, check) -> None:
    """The ``staged`` family: tensors that coll/device hands to
    coll/accelerator, each result bitwise the same host collective's on
    numpy copies and on this rank's device."""
    n, r = comm.size, comm.rank
    s = pvar.session()
    calls = 0
    user = op_mod.create(lambda a, b: a * 0.5 + b, commute=False)
    cases = (("float64", np.float64, _sizes(ns.staged_bytes)[0], mpi.SUM),
             ("REPLACE", np.float32, _sizes(ns.staged_op_bytes)[0],
              mpi.REPLACE),
             ("op.create", np.float32, _sizes(ns.staged_op_bytes)[0], user))
    for name, dtype, nbytes, op in cases:
        x = host_input(ns.seed + 9, r, nbytes // np.dtype(dtype).itemsize,
                       dtype)
        xd = torch.from_numpy(x).to(dev)
        t = timed(comm, lambda: comm.Allreduce(xd, op=op), ns.iters, dev,
                  prof)
        calls += 1 + ns.iters
        want = np.empty_like(x)
        comm.Allreduce(x, want, op=op)
        got = t[0].cpu().numpy()
        record(f"staged Allreduce {name}", xd.dtype, nbytes, "staged", t,
               t[0].device == dev and np.array_equal(
                   got.view(np.uint8), want.view(np.uint8)),
               2 * (n - 1) / n * nbytes)
    x = host_input(ns.seed + 10, r, _sizes(ns.staged_op_bytes)[0] // 8,
                   np.float64)
    req = comm.Iallreduce(torch.from_numpy(x).to(dev))
    mpi.wait_all([req])
    calls += 1
    want = np.empty_like(x)
    comm.Allreduce(x, want)
    check("staged Iallreduce float64", req.array.device == dev
          and np.array_equal(req.array.cpu().numpy().view(np.uint8),
                             want.view(np.uint8)))
    got = s.read("coll_accelerator_staged")
    check(f"coll_accelerator_staged {got} == {calls} staged calls",
          got == calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kinds", default=",".join(DEVICE_KINDS),
                    help="families to run, of " + ", ".join(KINDS)
                    + " (default: all but host and staged)")
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
    ap.add_argument("--rooted-bytes", default="64m",
                    help="float32 Reduce / Scatter payload (rooted), and of "
                         "the timed Iallreduce and Allreduce_init")
    ap.add_argument("--gather-bytes", default="16m",
                    help="float32 Gather payload per rank")
    ap.add_argument("--vcoll-bytes", default="64m",
                    help="payload per rank (on average) of Allgatherv / "
                         "Gatherv / Scatterv (int32) and Reduce_scatter "
                         "(float32)")
    ap.add_argument("--vcoll-lanes", type=int, default=1024,
                    help="elements per row of the v-collectives")
    ap.add_argument("--a2av-tokens", type=int, default=4096,
                    help="Alltoallv tokens each rank routes")
    ap.add_argument("--a2av-lanes", type=int, default=4096,
                    help="int32 lanes per Alltoallv token")
    ap.add_argument("--scan-bytes", default="1m",
                    help="Scan / Exscan payload")
    ap.add_argument("--host-sizes", default="1k,1m,64m,256m",
                    help="float32 host Allreduce payloads (coll/tuned's "
                         "default decision, beside the device path)")
    ap.add_argument("--host-forced-bytes", default="1m",
                    help="payload of the forced-algorithm host Allreduces")
    ap.add_argument("--host-bcast-bytes", default="1m",
                    help="float32 host Bcast payloads")
    ap.add_argument("--host-bcast-algos", default="default,linear",
                    help="coll_tuned_bcast_algorithm values to time the host "
                         "Bcast under ('default': coll/tuned's decision)")
    ap.add_argument("--host-allgather-bytes", default="",
                    help="int32 host Allgather totals, each under every "
                         "forced coll_tuned_allgather_algorithm (none by "
                         "default)")
    ap.add_argument("--staged-bytes", default="64m",
                    help="float64 staged Allreduce payload")
    ap.add_argument("--staged-op-bytes", default="1m",
                    help="payload of the REPLACE, op.create and Iallreduce "
                         "staged calls")
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

    def record(kind, dtype, nbytes, mode, timing, ok, bus_bytes, c=comm,
               **extra):
        """bus_bytes: the bytes of the bus-bandwidth convention
        (2(n-1)/n x payload for Allreduce, (n-1)/n x total for RS/AG and
        Alltoall, the payload for Bcast and the rooted calls)."""
        _, ms, dev_ms = timing
        busbw = bus_bytes / ms / 1e6
        cases.append({"kind": kind, "dtype": str(dtype).split(".")[-1],
                      "bytes": nbytes, "mode": mode, "ranks": c.size,
                      "p50_ms": ms, "device_ms": dev_ms,
                      "busbw_GBps": busbw, "ok": ok, **extra})
        if r == 0:
            dv = "" if dev_ms is None else \
                f", rank 0 device time {dev_ms:.3f} ms/call"
            print(f"[device_collectives n={c.size} {provider}] {kind} "
                  f"{cases[-1]['dtype']} {nbytes} B mode={mode}: p50 "
                  f"{ms:.3f} ms{dv}, bus bandwidth {busbw:.2f} GB/s, "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)

    def check(kind, ok):
        """An untimed check (a request's result, a persistent cycle)."""
        cases.append({"kind": kind, "ok": bool(ok)})
        if r == 0:
            print(f"[device_collectives n={n} {provider}] {kind}: "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)

    def allreduces(dtype, nbytes, op):
        numel = _elems(nbytes, dtype)
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
        rows = _elems(nbytes, torch.float32, n) // n
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
        numel = _elems(nbytes, torch.float32)
        for root in sorted({0, n - 1}):
            src = make_input(ns.seed + 3, root, numel, torch.float32, dev)
            buf = src if r == root else torch.zeros_like(src)
            t = timed(comm, lambda: comm.Bcast(buf, root=root), ns.iters,
                      dev, prof)
            record(f"Bcast root={root}", torch.float32, numel * 4,
                   "default", t, bits_equal(t[0], src) and
                   bits_equal(buf, src), numel * 4)

    for nbytes in _sizes(ns.alltoall_bytes) if "alltoall" in kinds else ():
        numel = _elems(nbytes, torch.int32, n)
        b = numel // n
        x = make_input(ns.seed + 4, r, numel, torch.int32, dev)
        t = timed(comm, lambda: comm.Alltoall(x), ns.iters, dev, prof)
        exp = torch.cat([make_input(ns.seed + 4, p, numel, torch.int32,
                                    dev)[r * b:(r + 1) * b]
                         for p in range(n)])
        record("Alltoall", torch.int32, numel * 4, "default", t,
               torch.equal(t[0], exp), (n - 1) / n * numel * 4)

    run_rest(comm, ns, kinds, dev, prof, record, check)
    if "host" in kinds:
        run_host(comm, ns, dev, prof, record)

    if "self" in kinds:  # every slot on a one-rank comm: a new tensor
        one = mpi.COMM_SELF
        x = make_input(ns.seed + 5, r, _elems(_sizes(ns.ops_bytes)[0],
                                              torch.float32), torch.float32,
                       dev)
        m = [x.numel()]

        def wait(req):
            req.wait()
            return req.array
        for kind, fn in (
                ("Allreduce", lambda: one.Allreduce(x)),
                ("Reduce_scatter_block",
                 lambda: one.Reduce_scatter_block(x)),
                ("Allgather", lambda: one.Allgather(x)[0]),
                ("Bcast", lambda: one.Bcast(x)),
                ("Alltoall", lambda: one.Alltoall(x)),
                ("Reduce", lambda: one.Reduce(x, op=mpi.MAX)),
                ("Gather", lambda: one.Gather(x)[0]),
                ("Scatter", lambda: one.Scatter(x)),
                ("Scatterv", lambda: one.Scatterv(x, None, m)),
                ("Allgatherv", lambda: one.Allgatherv(x, None, m)),
                ("Gatherv", lambda: one.Gatherv(x, None, m)),
                ("Alltoallv", lambda: one.Alltoallv(x, None, m, m)),
                ("Reduce_scatter", lambda: one.Reduce_scatter(x, None, m)),
                ("Scan", lambda: one.Scan(x)),
                ("Allreduce_multi", lambda: one.Allreduce_multi([x])[0]),
                ("Iallreduce", lambda: wait(one.Iallreduce(x))),
                ("Allreduce_init", lambda: wait(_started(
                    one.Allreduce_init(x))))):
            t = timed(one, fn, ns.iters, dev, prof)
            record(f"{kind} COMM_SELF", torch.float32, x.numel() * 4,
                   "default", t, bits_equal(t[0], x) and
                   t[0].data_ptr() != x.data_ptr(), 0, one)
        t = timed(one, lambda: one.Exscan(x), ns.iters, dev, prof)
        record("Exscan COMM_SELF", torch.float32, x.numel() * 4, "default",
               t, not t[0].any(), 0, one)
        one.Barrier(device=True)

    launches = {k.__name__: k.launches for k in PATH_KERNELS}
    # every family before staged: nothing may stage there
    staged_before = pvar.read("coll_accelerator_staged")
    if "staged" in kinds:
        run_staged(comm, ns, dev, prof, record, check)
    # K2 moves every byte of a multi-rank case; K1 and K3 run the
    # reductions the kernels take (float32 / bfloat16 / int32 SUM); the
    # host family's device Allreduce is the default mode's ring (K1, K2)
    kernel_kinds = set(kinds) - {"self", "barrier", "staged"}
    required = ["ring_ag_hop"] if kernel_kinds else []
    if {"allreduce", "rsag", "rooted", "vcoll", "nonblocking",
            "persistent"} & set(kinds):
        required += ["ring_rs_hop", "linear_fold"]
    elif {"scan", "barrier"} & set(kinds):
        required += ["linear_fold"]
    elif "host" in kinds and ns.host_sizes:
        required += ["ring_rs_hop"]
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "provider": provider, "launches": launches,
                       "required": required, "cases": cases,
                       "coll_accelerator_staged": staged_before}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: mismatching results: {bad}"
    assert staged_before == 0, \
        f"rank {r}: {staged_before} calls staged outside the staged family"
    # the plain versions (CPU tensors) launch nothing; on the card every
    # kernel the run needs must have run
    assert dev.type != "cuda" or all(launches[k] > 0 for k in required), \
        f"rank {r}: a kernel of the path never launched: {launches}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
