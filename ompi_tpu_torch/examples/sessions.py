"""MPI-4 sessions: communicators without a world model.

The counterpart of ``examples/sessions.py``: query the process sets, derive
groups, build communicators; ``MPI_COMM_WORLD`` never exists and
``Is_initialized()`` stays False.

Run::

    python -m ompi_tpu_torch.runtime.launcher -n 4 \\
        ompi_tpu_torch/examples/sessions.py

With ``--device`` (under ``--mca device_plane on --mca coll_cuda on --mca
osc_cuda on``; add ``--mca device_plane_platform cpu`` and ``--tiny`` to
rehearse on the CPU) the same session comm runs on device tensors, and each
rank checks, in order:

1. ``Session_init`` with ``mpi_memory_alloc_kinds`` =
   ``system,mpi,cuda,cuda:device,cuda:managed,bogus``: the grant reads
   ``system,mpi,cuda,cuda:device`` on the card (``system,mpi`` on the CPU
   platform, where the null accelerator contributes nothing), and
   ``MPIX_Query_cuda_support()`` is True on the card;
2. a comm from ``mpi://WORLD`` by ``Comm_create_from_group``;
3. device ``Allreduce(SUM)`` of a ``--f32-bytes`` float32 payload (256 MiB)
   and a ``--bf16-bytes`` bfloat16 one (64 MiB), each under ``'ring'`` (K1
   + K2) and ``'linear'`` (K3), bitwise equal to the plain fold of every
   rank's regenerated input in that mode's order (rank order for
   ``'linear'``; ranks c+1, ..., c+n for the ring's chunk c); then the
   float32 payload timed in turns (ring, linear, linear, ring, ...);
4. a device ``Bcast`` with root 99 under a callback errhandler: every rank
   sees ERR_ROOT once (the root is checked before any hop, on every rank),
   the call returns None, and the next device Allreduce is still bitwise;
5. a CudaWindow (``osc.win_create`` under ``osc_cuda``) with a window
   callback: a ``Put`` and an ``Rget`` to target 99 inside a fence epoch
   are recovered (nothing moves, the Rget's request is complete); the
   epoch's Put to the right neighbour and ``Get_epoch`` from the left are
   bitwise against a numpy replay; then a Lock epoch's Put and Get to the
   right neighbour (one K7 and one K9 at each target);
6. the launches of K1-K3 and K7-K10 (zeroed after step 2, read after step
   5) equal to what the rank derives from the calls it made (on the card;
   on the CPU the wrappers run their plain versions and count nothing);
7. the reference's device fuzz schedule (``tests/test_fuzz.py:73-101``) on
   device tensors, with ``coll_accelerator_staged`` 0;
8. ``Wtime`` / ``Wtick``;
9. ``Session.finalize``: the device plane is down and no arena file of the
   job is left; a second ``Session_init`` / ``finalize`` works (a device
   Allreduce on its comm, bitwise).

``--abort R:C`` is the Abort check instead: after one device Allreduce,
rank R calls ``mpi.Abort(comm, C)`` while the others wait in a Barrier; the
job exits with C. With ``--out DIR`` each rank writes ``DIR/rank<r>.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import errors, ext, mpi, osc

#: the memkind request and the grant on the card and on the CPU platform
REQUEST = "system,mpi,cuda,cuda:device,cuda:managed,bogus"
GRANT = {"cuda": "system,mpi,cuda,cuda:device", "cpu": "system,mpi"}
BAD = 99  # the root / target outside every comm
REPS = 9  # timed Allreduces per mode


def _sizes(tok: str) -> int:
    tok = tok.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(tok[-1:], 1)
    return int(tok.rstrip("kmg")) * mult


def host_example() -> int:
    """The reference example's program, on numpy buffers."""
    session = mpi.Session_init({"thread_level": "single"})
    assert not mpi.Is_initialized()  # no world model
    names = [session.get_nth_pset(i) for i in range(session.num_psets())]
    group = mpi.Group_from_session_pset(session, "mpi://WORLD")
    comm = session.comm_from_group(group, "examples.sessions")
    out = np.zeros(1, np.int64)
    comm.Allreduce(np.array([comm.rank + 1], np.int64), out)
    if comm.rank == 0:
        print(f"psets: {names}")
        print(f"sessions-only allreduce over {comm.size} ranks -> {out[0]}")
    host_comm = session.comm_from_group(
        session.group_from_pset("ompi_tpu://HOST"), "examples.host")
    print(f"rank {comm.rank}: {host_comm.size} rank(s) on my host")
    session.finalize()
    return 0


def abort_job(spec: str) -> int:
    who, code = (int(v) for v in spec.split(":"))
    from ompi_tpu_torch.runtime import device_plane

    s = mpi.Session_init()
    comm = s.comm_from_group(s.group_from_pset("mpi://WORLD"), "abort")
    x = torch.ones(1 << 18, device=device_plane.device())
    got = comm.Allreduce(x, deterministic="ring")
    assert bool(got.eq(comm.size).all())
    if comm.rank == who:
        mpi.Abort(comm, code)
    comm.Barrier()  # never completes: the launcher ends the job
    return 3


def device_job(ns) -> int:
    from ompi_tpu_torch.core import pvar
    from ompi_tpu_torch.examples import kernel_counts as KC
    from ompi_tpu_torch.examples.device_collectives import (
        bits_equal, expected_allreduce, make_input)
    from ompi_tpu_torch.examples.device_epoch import (derived_launches,
                                                      reference_rounds)
    from ompi_tpu_torch.osc import cuda_kernels as O
    from ompi_tpu_torch.osc.cuda import CudaWindow
    from ompi_tpu_torch.runtime import device_plane, launcher, rte

    cases, report = [], {}

    def case(name, ok, **info):
        cases.append({"kind": name, "ok": bool(ok), **info})

    # 1. the session, its memkind grant, the extension query
    s = mpi.Session_init({mpi.MEMORY_ALLOC_KINDS: REQUEST})
    dev = device_plane.device()
    cuda = dev.type == "cuda"
    grant = s.get_info().get(mpi.MEMORY_ALLOC_KINDS)
    report["grant"] = grant
    case("memkind grant", grant == GRANT[dev.type], grant=grant)
    query = ext.MPIX_Query_cuda_support()
    report["query_cuda_support"] = query
    case("MPIX_Query_cuda_support", query == cuda, got=query)
    # 2. the comm, from the WORLD pset
    g = mpi.Group_from_session_pset(s, "mpi://WORLD")
    comm = mpi.Comm_create_from_group(g, "examples.sessions.device")
    n, r = comm.size, comm.rank
    left, right = (r - 1) % n, (r + 1) % n
    case("session comm over mpi://WORLD", comm.size == g.size
         == s.pset_info("mpi://WORLD")["mpi_size"] and comm.rank == g.rank)
    counts = KC.Counts(dev)
    counts.reset()
    O.reset_launches()
    staged0 = pvar.read("coll_accelerator_staged")
    want: dict = {}

    def allreduce(x, mode):
        KC.add(want, **({"K3": 1} if mode == "linear" else
                        {"K1": n - 1, "K2": n - 1}))
        return comm.Allreduce(x, deterministic=mode)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # 3. the main path's Allreduces, checked, then timed in turns
    for dtype, nbytes, seed in ((torch.float32, ns.f32_bytes, 1),
                                (torch.bfloat16, ns.bf16_bytes, 2)):
        numel = nbytes // torch.empty(0, dtype=dtype).element_size()
        xs = [make_input(seed, p, numel, dtype, dev) for p in range(n)]
        for mode in ("ring", "linear"):
            got = allreduce(xs[r], mode)
            case(f"Allreduce {str(dtype)[6:]} {nbytes} B {mode}",
                 bits_equal(got, expected_allreduce(xs, "MPI_SUM", mode, n)))
            del got
        if dtype == torch.float32:
            times = {"ring": [], "linear": []}
            for k in range(2 * ns.reps):
                mode = ("ring", "linear")[(k + k // 2) % 2]
                comm.Barrier()
                sync()
                t0 = time.perf_counter()
                allreduce(xs[r], mode)
                sync()
                times[mode].append((time.perf_counter() - t0) * 1e3)
            report["allreduce_f32"] = {
                "bytes": nbytes, "times_ms": times,
                "p50_ms": {m: sorted(t)[len(t) // 2]
                           for m, t in times.items()}}
        del xs

    # 4. a recovered device Bcast (root outside the comm), then a bitwise
    # Allreduce
    seen = []
    comm.Set_errhandler(mpi.Comm_create_errhandler(
        lambda c, e: seen.append(e.error_class)))
    x = make_input(3, r, 1 << 18, torch.float32, dev)
    out = comm.Bcast(x, root=BAD)
    case("Bcast root 99 recovered: ERR_ROOT once, None returned",
         out is None and seen == [errors.ERR_ROOT], seen=seen)
    xs = [make_input(3, p, 1 << 18, torch.float32, dev) for p in range(n)]
    case("the Allreduce after the recovery",
         bits_equal(allreduce(xs[r], "ring"),
                    expected_allreduce(xs, "MPI_SUM", "ring", n)))
    report["comm_recoveries"] = len(seen)
    comm.Set_errhandler(mpi.ERRORS_ARE_FATAL)

    # 5. a CudaWindow whose callback recovers an erroneous op
    size, big, small = ns.window, ns.window // 4, ns.window // 16

    def gen(q, key, m):
        gq = torch.Generator(device=dev).manual_seed(1000 * key + q)
        return torch.randn(m, generator=gq, device=dev)

    win = osc.win_create(comm, gen(r, 5, size), disp_unit=4)
    case("the window is a CudaWindow", isinstance(win, CudaWindow))
    wseen = []
    win.Set_errhandler(mpi.Win_create_errhandler(
        lambda w, e: wseen.append(e.error_class)))
    puts = [(q, (q + 1) % n, 0, big, "put") for q in range(n)]
    gets = [((q - 1) % n, q, big, small) for q in range(n)]
    wanted_rma = derived_launches(reference_rounds(puts),
                                  reference_rounds(gets), r, n, size, 4)
    win.Fence()
    win.Put(gen(r, 6, small), BAD, disp=0)
    req = win.Rget(torch.zeros(small, device=dev), BAD, disp=0)
    case("Put / Rget to target 99 recovered, the request complete",
         wseen == [errors.ERR_RANK] * 2 and req.test(), seen=wseen)
    req.wait()
    win.Put(gen(r, 7, big), right, disp=0)
    h = win.Get_epoch(small, left, disp=big)
    win.Fence()
    replay = gen(r, 5, size).cpu().numpy()
    replay[:big] = gen(left, 7, big).cpu().numpy()
    lwin = gen(left, 5, size).cpu().numpy()
    case("fence epoch == its numpy replay",
         np.array_equal(win.array.cpu().numpy().view(np.int32),
                        replay.view(np.int32))
         and np.array_equal(h.array.cpu().numpy().view(np.int32),
                            lwin[big:big + small].view(np.int32)))
    # every rank has read its window before any Lock epoch's put can land
    comm.Barrier()
    # a Lock epoch: one K7 (the put) and one K9 (the get) at each target
    got = torch.zeros(small, device=dev)
    win.Lock(right)
    win.Put(gen(r, 8, small), right, disp=2 * big)
    win.Get(got, right, disp=3 * big)
    win.Unlock(right)
    comm.Barrier()
    for k in ("rma_apply", "rma_read"):
        wanted_rma[k] = wanted_rma.get(k, 0) + 1
    rwin = gen(right, 5, size)
    case("lock epoch put and get",
         bits_equal(win.array[2 * big:2 * big + small], gen(left, 8, small))
         and bits_equal(got, rwin[3 * big:3 * big + small]))
    report["window_recoveries"] = len(wseen)
    # the launches of steps 3-5 against the calls made
    got_k = {**counts.read(), **{k: getattr(O, k).launches
                                 for k in wanted_rma}}
    expected = {**{k: want.get(k, 0) for k in KC.NAMES}, **wanted_rma}
    case("launches == derived", not cuda or got_k == expected,
         got=got_k, want=expected)

    # 7. the reference's device fuzz schedule, on device tensors
    rng = np.random.default_rng(99)
    fuzz_ok = True
    for step in range(12):
        op = rng.integers(0, 4)
        m = int(rng.integers(4, 48))
        if op == 0:
            res = comm.Allreduce(torch.full((m,), float(r + 1), device=dev))
            fuzz_ok &= float(res[0]) == sum(range(1, n + 1))
        elif op == 1:
            rq = comm.Iallgather(torch.full((2,), float(r), device=dev))
            rq.wait()
            fuzz_ok &= tuple(rq.array.shape) == (n, 2)
        elif op == 2:
            o = np.zeros(m)
            comm.Allreduce(np.full(m, 1.0), o)
            fuzz_ok &= bool((o == n).all())
        else:
            cs = [int(c) for c in rng.integers(1, 4, n)]
            packed = comm.Allgatherv(
                torch.full((cs[r],), float(r), device=dev), None, cs)
            fuzz_ok &= packed.numel() == sum(cs)
    staged = pvar.read("coll_accelerator_staged") - staged0
    case("fuzz schedule, nothing staged", fuzz_ok and staged == 0,
         staged=staged)

    # 8. the clock
    t0, tick = mpi.Wtime(), mpi.Wtick()
    report["wtick"] = tick
    case("Wtime / Wtick", mpi.Wtime() >= t0 and 0 < tick < 1e-3)

    win.Free()

    # 9. finalize; then a second session in the same process
    case("no world model", not mpi.Is_initialized())
    s.finalize()

    def arenas():
        return glob.glob(os.path.join(
            launcher.shm_dir(), f"{launcher.SHM_PREFIX}{rte.jobid}_c*"))

    case("finalize: the device plane is down, no arena file left",
         not device_plane.active() and not arenas(), left=arenas())
    s2 = mpi.Session_init()
    c2 = s2.comm_from_group(s2.group_from_pset("mpi://WORLD"),
                            "examples.sessions.again")
    xs = [make_input(4, p, 1 << 16, torch.float32, device_plane.device())
          for p in range(n)]
    case("a second session's Allreduce",
         bits_equal(c2.Allreduce(xs[r], deterministic="linear"),
                    expected_allreduce(xs, "MPI_SUM", "linear", n)))
    s2.finalize()
    case("second finalize: device plane down, no arena file left",
         not device_plane.active() and not arenas()
         and not mpi.Is_initialized())
    if r == 0:
        print(f"[sessions n={n}] {json.dumps(report)}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "cases": cases, "launches": got_k,
                       "expected_launches": expected,
                       "required": [k for k, v in expected.items() if v],
                       "coll_accelerator_staged": staged,
                       "report": report}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--abort", default="", metavar="RANK:CODE")
    ap.add_argument("--f32-bytes", type=_sizes, default=256 << 20)
    ap.add_argument("--bf16-bytes", type=_sizes, default=64 << 20)
    ap.add_argument("--window", type=int, default=1 << 22,
                    help="float32 elements of the window")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if ns.tiny:
        ns.f32_bytes, ns.bf16_bytes, ns.window, ns.reps = \
            64 << 10, 16 << 10, 1 << 12, 3
    if ns.abort:
        return abort_job(ns.abort)
    if ns.device:
        return device_job(ns)
    return host_example()


if __name__ == "__main__":
    raise SystemExit(main())
