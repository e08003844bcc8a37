"""A halo exchange on a cartesian topology's neighbourhood collectives.

Run::

    python -m ompi_tpu_torch.runtime.launcher -n 4 \\
        ompi_tpu_torch/examples/neighbor_halo.py

runs the exchange on numpy buffers (the host slots: coll/basic's linear
round). With ``--device`` (under ``--mca device_plane on --mca coll_cuda
on``; add ``--mca device_plane_platform cpu`` and ``--tiny`` to rehearse
on the CPU) every rank checks, in order, on 4 ranks:

1. ``tests/test_device_path.py``'s four device cases on device tensors
   (the 2 x 2 periodic cart's allgather, its degenerate size-2 alltoall,
   the open ring's zero PROC_NULL rows, the ragged dist graph), each
   bitwise equal to the host path on numpy copies, coll/device the
   provider, nothing staged;
2. the halo: a ``--tile`` square float32 tile a rank (8192: 256 MiB) on
   ``Create_cart([2, 2], periods=[True, True], reorder=True)``; a step
   packs the four edge strips of depth ``--depth`` into a
   ``(4, depth, tile)`` sendbuf (rows: up, down, left, right), runs
   ``Neighbor_alltoall`` and writes the four strips it got into the
   tile's edges; ``--steps`` timed steps after ``--warmup`` under
   ``profile.timing(names=["Neighbor_alltoall"])`` (its
   ``profile_Neighbor_alltoall_calls`` must count the steps), the last
   step's exchange bitwise against a numpy replay of every rank's
   sendbuf;
3. a wide block: ``Neighbor_allgather`` of ``--wide-bytes`` float32
   (64 MiB) a rank, bitwise, then timed;
4. the one exchange against the reference's schedule
   (``coll/xla_neighbor.py``'s greedy colour rounds over
   ``_edges_allgather``, one ``permute_dev`` a colour: 4 rounds of the
   2 x 2 cart's 16 edges) at ``--small-bytes`` and ``--wide-bytes``,
   bitwise equal, timed in turns (one, rounds, rounds, one, ...);
5. ``--allreduce-bytes`` float32 (64 MiB) Allreduces on an ``Idup`` of
   the cart ('ring' and 'linear') and on a ``Cart_sub`` row comm
   ('ring'), each bitwise against the plain fold in that mode's order;
6. a ``--small-bytes`` Allreduce ('ring') on COMM_WORLD maps its
   arenas (cid 0); then rank 0 spawns ``--children`` children
   (``Comm_spawn``) while they are mapped: each child runs an ``--allreduce-bytes``
   device Allreduce on its own COMM_WORLD ('ring', bitwise) on its own
   device plane, both sides then run a numpy Allreduce across the
   intercommunicator, and ``Intercomm_merge`` gives one comm of parents
   and children with a host Allreduce; the children report to rank 0
   and exit 0.

Each part's K1-K3 launches (zeroed just before it, read just after:
on the card the wrappers' own counts, on the CPU the plain versions'
calls) must equal what the rank derives from its calls: one K2 per
non-PROC_NULL in-edge of a neighbourhood call (one per round a rank is a
destination in for the colour rounds), and K1 + K2 (n - 1 each) per
'ring' and one K3 per 'linear' Allreduce. With ``--out DIR`` each rank
writes ``DIR/rank<r>.json``; rank 0's holds the children's reports.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.pml.request import PROC_NULL

TILE, DEPTH = 8192, 8


def _sizes(tok: str) -> int:
    tok = tok.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(tok[-1:], 1)
    return int(tok.rstrip("kmg")) * mult


def _p50(ts):
    return sorted(ts)[len(ts) // 2]


def _c0_owners(name: str):
    """The world rank that owns a COMM_WORLD (cid 0) arena file, as a
    one-element list ([] for another comm's file)."""
    if "_c0_" not in name:
        return []
    return [int(name.rsplit("_w", 1)[1].split("_")[0])]


def _nonnull(lst) -> int:
    return sum(1 for p in lst if p != PROC_NULL)


def pack(tile: torch.Tensor, d: int, out: torch.Tensor) -> torch.Tensor:
    """The four edge strips of depth ``d`` (up, down, left, right: the
    cart's out-neighbour order) into ``out`` of shape (4, d, tile)."""
    out[0].copy_(tile[:d])
    out[1].copy_(tile[-d:])
    out[2].copy_(tile[:, :d].t())
    out[3].copy_(tile[:, -d:].t())
    return out


def unpack(tile: torch.Tensor, d: int, got: torch.Tensor) -> None:
    """The strips from the up, down, left and right neighbours into the
    tile's edges."""
    tile[:d].copy_(got[0])
    tile[-d:].copy_(got[1])
    tile[:, :d].copy_(got[2].t())
    tile[:, -d:].copy_(got[3].t())


def host_example(ns) -> int:
    """The exchange on numpy buffers (coll/basic's linear round)."""
    comm = mpi.Init()
    cart = comm.Create_cart([2, 2], periods=[True, True])
    t, d = 64, 2
    rng = np.random.default_rng(cart.rank)
    tile = rng.standard_normal((t, t)).astype(np.float32)
    sb = np.stack([tile[:d], tile[-d:], tile[:, :d].T, tile[:, -d:].T])
    got = np.zeros_like(sb)
    cart.Neighbor_alltoall(np.ascontiguousarray(sb), got)
    ins = cart.topo.in_neighbors(cart.rank)
    every = cart.allgather(sb)
    ok = all(np.array_equal(got[k], every[s][k ^ 1])
             for k, s in enumerate(ins))
    print(f"rank {cart.rank}: halo of {t} x {t} from {ins}: "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    mpi.Finalize()
    return 0 if ok else 1


def child_job(ns, comm, parent) -> int:
    """A spawned child: its own device Allreduce, the bridge, the merge;
    rank 0 reports every child's results to the parents' rank 0."""
    from ompi_tpu_torch.examples import kernel_counts as KC
    from ompi_tpu_torch.examples.device_collectives import (
        bits_equal, expected_allreduce, make_input)
    from ompi_tpu_torch.runtime import device_plane, launcher, rte

    dev = device_plane.device()
    n, r = comm.size, comm.rank
    counts = KC.Counts(dev)
    numel = ns.allreduce_bytes // 4
    xs = [make_input(31, p, numel, torch.float32, dev) for p in range(n)]
    counts.reset()
    got = comm.Allreduce(xs[r], deterministic="ring")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = counts.read()
    files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        launcher.shm_dir(), f"{launcher.SHM_PREFIX}{rte.jobid}_c*")))
    doc = {"world": [r, n, rte.world_offset, list(comm.group.ranks)],
           "device": str(dev), "leader": device_plane.leader(),
           "allreduce_ok": bits_equal(
               got, expected_allreduce(xs, "MPI_SUM", "ring", n)),
           "launches": launches,
           "expected_launches": KC.ring_allreduce(n),
           "arena_files": files}
    del xs, got
    out = np.zeros(1, np.int64)
    parent.Allreduce(np.array([r + 1], np.int64), out)
    doc["bridge"] = int(out[0])
    merged = parent.merge(high=True)
    tot = np.zeros(1, np.int64)
    merged.Allreduce(np.array([merged.rank], np.int64), tot)
    doc["merged"] = [merged.size, merged.rank, int(tot[0])]
    docs = comm.gather(doc, root=0)
    if r == 0:
        parent.send(docs, dest=0, tag=14)
    mpi.Finalize()
    return 0


def device_job(ns) -> int:
    from ompi_tpu_torch import dpm, profile
    from ompi_tpu_torch.coll import device as CD
    from ompi_tpu_torch.coll import device_neighbor as DN
    from ompi_tpu_torch.core import pvar
    from ompi_tpu_torch.examples import kernel_counts as KC
    from ompi_tpu_torch.examples.device_collectives import (
        bits_equal, expected_allreduce, make_input)
    from ompi_tpu_torch.runtime import device_plane, launcher, rte

    comm = mpi.Init()
    parent = mpi.Comm_get_parent()
    if parent is not None:
        return child_job(ns, comm, parent)
    dev = device_plane.device()
    cuda = dev.type == "cuda"
    n, r = comm.size, comm.rank
    assert n == 4, "the halo job runs on 4 ranks"
    cases, report, parts, want = [], {}, {}, {}
    counts = KC.Counts(dev)
    staged0 = pvar.read("coll_accelerator_staged")

    def case(name, ok, **info):
        cases.append({"kind": name, "ok": bool(ok), **info})

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def part(name, derived):
        """Close a part: its launches read, beside what it derived."""
        sync()
        parts[name] = counts.read()
        want[name] = {k: derived.get(k, 0) for k in KC.NAMES}
        counts.reset()

    def turns(fns, reps):
        """p50 ms of each of two calls, timed in turns (A B B A ...),
        each after a Barrier and a device sync."""
        times = [[], []]
        for k in range(2 * reps):
            i = (k + k // 2) % 2
            comm.Barrier()
            sync()
            t0 = time.perf_counter()
            fns[i]()
            sync()
            times[i].append((time.perf_counter() - t0) * 1e3)
        return times

    # 1. the contract cases (tests/test_device_path.py:21-113)
    counts.reset()
    k2 = 0
    cart = comm.Create_cart([2, 2], periods=[True, True], reorder=True)
    cr = cart.rank
    nb = cart.topo.in_neighbors(cr)
    x = torch.arange(3, dtype=torch.float32, device=dev) + 10 * cr
    out = cart.Neighbor_allgather(x)
    k2 += _nonnull(nb)
    h = np.zeros((len(nb), 3), np.float32)
    cart.Neighbor_allgather(x.cpu().numpy(), h)
    case("2 x 2 periodic cart Neighbor_allgather == host",
         np.array_equal(out.cpu().numpy().view(np.int32), h.view(np.int32))
         and cart.coll.providers["neighbor_allgather_dev"] == "device")
    sb = torch.arange(len(nb) * 2, dtype=torch.float32,
                      device=dev).reshape(len(nb), 2) + 100 * cr
    out = cart.Neighbor_alltoall(sb)
    k2 += _nonnull(nb)
    h = np.zeros((len(nb), 2), np.float32)
    cart.Neighbor_alltoall(sb.cpu().numpy(), h)
    case("degenerate size-2 dims Neighbor_alltoall == host",
         np.array_equal(out.cpu().numpy().view(np.int32), h.view(np.int32))
         and cart.coll.providers["neighbor_alltoall_dev"] == "device")
    ring = comm.Create_cart([4], periods=[False])
    x = torch.full((2,), float(ring.rank + 1), device=dev)
    out = ring.Neighbor_allgather(x)
    rin = ring.topo.in_neighbors(ring.rank)
    k2 += _nonnull(rin)
    h = np.zeros((2, 2), np.float32)
    ring.Neighbor_allgather(x.cpu().numpy(), h)
    zero_rows = all(not out[k].any() for k, s in enumerate(rin)
                    if s == PROC_NULL)
    case("open ring: PROC_NULL rows zero, == host",
         zero_rows and np.array_equal(out.cpu().numpy(), h))
    gouts = {0: [1, 2], 1: [2], 2: [3], 3: [0]}[r]
    gins = {0: [3], 1: [0], 2: [1, 0], 3: [2]}[r]
    g = comm.Create_dist_graph_adjacent(gins, gouts)
    out = g.Neighbor_allgather(torch.full((2,), float(g.rank), device=dev))
    sb = torch.arange(len(gouts) * 2, dtype=torch.float32,
                      device=dev).reshape(len(gouts), 2) + 100 * g.rank
    a2a = g.Neighbor_alltoall(sb)
    k2 += 2 * len(gins)
    h = np.zeros((len(gins), 2), np.float32)
    g.Neighbor_alltoall(sb.cpu().numpy(), h)
    case("ragged dist graph: allgather rows, alltoall == host",
         tuple(out.shape) == (len(gins), 2)
         and all(float(out[k, 0]) == s for k, s in enumerate(gins))
         and np.array_equal(a2a.cpu().numpy(), h))
    part("contract", {"ring_ag_hop": k2})
    del out, a2a

    # 2. the halo at full size
    t, d = ns.tile, ns.depth
    gen = torch.Generator(device=dev).manual_seed(1400 + rte.rank)
    tile = torch.randn((t, t), generator=gen, device=dev)
    sendbuf = torch.empty((4, d, t), device=dev)
    pv = pvar.session()
    step_ms = []

    def step():
        got = cart.Neighbor_alltoall(pack(tile, d, sendbuf))
        unpack(tile, d, got)
        return got
    for _ in range(ns.warmup):
        step()
    with profile.timing(names=["Neighbor_alltoall"]) as stats:
        for _ in range(ns.steps):
            comm.Barrier()
            sync()
            t0 = time.perf_counter()
            got = step()
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    # the exchange leaves sendbuf as the last step packed it
    last_sb = sendbuf.cpu().numpy()
    calls = pv.read("profile_Neighbor_alltoall_calls")
    part("halo", {"ring_ag_hop": (ns.warmup + ns.steps) * _nonnull(nb)})
    every = np.empty((4,) + last_sb.shape, np.float32)
    cart.Allgather(last_sb, every)
    replay = np.stack([every[s][k ^ 1] for k, s in enumerate(nb)])
    case("halo: the last step's exchange == the numpy replay",
         np.array_equal(got.cpu().numpy().view(np.int32),
                        replay.view(np.int32)))
    case("halo: profile_Neighbor_alltoall_calls == the timed steps",
         calls == ns.steps == stats["Neighbor_alltoall"][0], calls=calls)
    report["halo"] = {
        "tile": t, "depth": d, "sendbuf_bytes": sendbuf.nbytes,
        "steps": ns.steps, "step_ms": step_ms, "step_p50_ms": _p50(step_ms),
        "profile_calls": calls,
        "profile_ms_per_call": stats["Neighbor_alltoall"][1] * 1e3
        / max(stats["Neighbor_alltoall"][0], 1),
        "ranks": [cr, list(nb)]}
    del tile, sendbuf, got

    # 3. the wide block
    numel = ns.wide_bytes // 4
    xw = make_input(14, cr, numel, torch.float32, dev)
    out = cart.Neighbor_allgather(xw)
    ok = all(bits_equal(out[k], make_input(14, s, numel, torch.float32, dev))
             for k, s in enumerate(nb))
    case(f"Neighbor_allgather {ns.wide_bytes} B == every in-neighbour's "
         "block", ok)
    del out
    ts = []
    for _ in range(ns.reps):
        comm.Barrier()
        sync()
        t0 = time.perf_counter()
        cart.Neighbor_allgather(xw)
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    part("wide", {"ring_ag_hop": (1 + ns.reps) * _nonnull(nb)})
    report["wide"] = {"bytes": ns.wide_bytes, "times_ms": ts,
                      "p50_ms": _p50(ts), "in_edges": _nonnull(nb)}

    # 4. one exchange against the reference's colour rounds
    edges, _ = DN._edges_allgather(cart.topo, n)
    rounds = DN._color(edges)

    def colour_rounds(x):
        res = torch.zeros((len(nb),) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        for rnd in rounds:
            got = CD.permute_dev(cart, x, [(s, dd) for s, dd, _ in rnd])
            for s, dd, slot in rnd:
                if dd == cr:
                    res[slot].copy_(got)
        return res
    dest_rounds = sum(1 for rnd in rounds if any(e[1] == cr for e in rnd))
    cmp = {}
    for label, nbytes in (("small", ns.small_bytes), ("wide", ns.wide_bytes)):
        x = make_input(15, cr, nbytes // 4, torch.float32, dev)
        same = bits_equal(cart.Neighbor_allgather(x), colour_rounds(x))
        case(f"one exchange == {len(rounds)} colour rounds at {nbytes} B",
             same)
        one, rr = turns([lambda: cart.Neighbor_allgather(x),
                         lambda: colour_rounds(x)], ns.turns)
        cmp[label] = {"bytes": nbytes, "one_ms": one, "rounds_ms": rr,
                      "one_p50_ms": _p50(one), "rounds_p50_ms": _p50(rr)}
        del x
    part("rounds", {"ring_ag_hop": 2 * (1 + ns.turns)
                    * (_nonnull(nb) + dest_rounds)})
    report["rounds"] = {"edges": len(edges), "colours": len(rounds), **cmp}

    # 5. Allreduces on an Idup of the cart and on a Cart_sub row comm
    req = cart.Idup()
    req.wait()
    dup = req.result["comm"]
    numel = ns.allreduce_bytes // 4
    xs = [make_input(16, p, numel, torch.float32, dev) for p in range(n)]
    for mode in ("ring", "linear"):
        case(f"Idup'd cart Allreduce {ns.allreduce_bytes} B {mode}",
             bits_equal(dup.Allreduce(xs[dup.rank], deterministic=mode),
                        expected_allreduce(xs, "MPI_SUM", mode, n))
             and dup.coll.providers["allreduce_dev"] == "cuda")
    del xs
    row = cart.Cart_sub([False, True])
    xs = [make_input(17, p, numel, torch.float32, dev)
          for p in range(row.size)]
    case(f"Cart_sub row Allreduce {ns.allreduce_bytes} B ring",
         bits_equal(row.Allreduce(xs[row.rank], deterministic="ring"),
                    expected_allreduce(xs, "MPI_SUM", "ring", row.size))
         and bits_equal(expected_allreduce(xs, "MPI_SUM", "ring", row.size),
                        expected_allreduce(xs, "MPI_SUM", "linear",
                                           row.size)))
    del xs
    part("idup_cart_sub", KC.merged(KC.ring_allreduce(n), {"linear_fold": 1},
                                    KC.ring_allreduce(row.size)))

    # 6. spawn, while this world's arenas stay mapped
    def arenas():
        return sorted(os.path.basename(p) for p in glob.glob(os.path.join(
            launcher.shm_dir(), f"{launcher.SHM_PREFIX}{rte.jobid}_c*")))
    # COMM_WORLD's own arenas (cid 0, as each child world's COMM_WORLD)
    xs = [make_input(18, p, ns.small_bytes // 4, torch.float32, dev)
          for p in range(n)]
    case("COMM_WORLD Allreduce before the spawn",
         bits_equal(comm.Allreduce(xs[r], deterministic="ring"),
                    expected_allreduce(xs, "MPI_SUM", "ring", n)))
    del xs
    part("world", KC.ring_allreduce(n))
    mine_before = arenas()
    args = ["--device", "--allreduce-bytes", str(ns.allreduce_bytes)]
    t0 = time.perf_counter()
    inter = mpi.Comm_spawn(os.path.abspath(__file__), args=args,
                           maxprocs=ns.children)
    out = np.zeros(1, np.int64)
    inter.Allreduce(np.array([r + 100], np.int64), out)
    merged = inter.merge(high=False)
    tot = np.zeros(1, np.int64)
    merged.Allreduce(np.array([merged.rank], np.int64), tot)
    m = ns.children
    case("bridge Allreduce, merged comm",
         int(out[0]) == sum(range(1, m + 1)) and merged.size == n + m
         and merged.rank == r and int(tot[0]) == sum(range(n + m)))
    if r == 0:
        kids = inter.recv(source=0, tag=14)
        codes = dpm.wait_children(timeout=ns.child_timeout)
        spawn_s = time.perf_counter() - t0
        owners = {w for f in mine_before for w in _c0_owners(f)}
        case("spawned children: exit 0, own planes, bitwise Allreduces, "
             "their cid-0 arenas beside the parents'", codes == [0] * m
             and owners == set(range(n))
             and all(k["allreduce_ok"] and k["device"] == str(dev)
                     and k["leader"] == k["world"][2]
                     and k["launches"] == k["expected_launches"]
                     and k["bridge"] == 100 * n + n * (n - 1) // 2
                     and {w for f in k["arena_files"]
                          for w in _c0_owners(f)} >= owners | set(
                              k["world"][3]) for k in kids), codes=codes)
        report["spawn"] = {"children": kids, "codes": codes,
                           "seconds": spawn_s,
                           "parent_arenas": mine_before}
    comm.Barrier()

    staged = pvar.read("coll_accelerator_staged") - staged0
    case("nothing staged", staged == 0, staged=staged)
    got_k = KC.merged(*parts.values())
    exp_k = KC.merged(*want.values())
    case("launches == derived (every part)", all(
        parts[p] == want[p] for p in parts), got=parts, want=want)
    if r == 0:
        brief = {k: v for k, v in report.items() if k != "spawn"}
        if "spawn" in report:
            brief["spawn"] = {"codes": report["spawn"]["codes"],
                              "seconds": report["spawn"]["seconds"]}
        print(f"[neighbor_halo n={n}] {json.dumps(brief)}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "cases": cases, "launches": got_k,
                       "expected_launches": exp_k,
                       "part_launches": parts,
                       "expected_part_launches": want,
                       "required": ["ring_rs_hop", "ring_ag_hop",
                                    "linear_fold"],
                       "coll_accelerator_staged": staged,
                       "report": report}, f)
    bad = [c for c in cases if not c["ok"]]
    mpi.Finalize()
    assert not bad, f"rank {r}: failed checks: {bad}"
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--tile", type=int, default=TILE)
    ap.add_argument("--depth", type=int, default=DEPTH)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--wide-bytes", type=_sizes, default=64 << 20)
    ap.add_argument("--small-bytes", type=_sizes, default=1 << 20)
    ap.add_argument("--allreduce-bytes", type=_sizes, default=64 << 20)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--children", type=int, default=2)
    ap.add_argument("--child-timeout", type=float, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if ns.tiny:
        ns.tile, ns.depth, ns.steps, ns.warmup = 64, 2, 3, 1
        ns.wide_bytes, ns.small_bytes = 16 << 10, 4 << 10
        ns.allreduce_bytes, ns.reps, ns.turns = 16 << 10, 2, 2
    if ns.device:
        return device_job(ns)
    return host_example(ns)


if __name__ == "__main__":
    raise SystemExit(main())
