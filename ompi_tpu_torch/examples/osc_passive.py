"""PSCW and passive-target one-sided epochs on device windows: the halo
over generalized active target, the embedding shard under Lock_all, and
atomics.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca osc_cuda on ompi_tpu_torch/examples/osc_passive.py

Every window is a ``CudaWindow``; these epochs ride the host window's
active-message (AM) service, and the target applies each landed payload
with K7 (contiguous) or K8 (strided) and serves each read with K9. Three
parts, each run ``--reps`` times (3) and timed on rank 0's host clock,
the card synchronised on both sides:

1. **PSCW halo** (``--size`` 8192: an 8192 x 8192 float32 tile a rank,
   256 MiB, ranks in a ring). Each step posts to and starts on both
   neighbours, ``Put_strided``s its right owned column (8192 elements at
   stride 8192) into the right neighbour's left ghost column and its left
   owned column into the left neighbour's right ghost column (K8), puts
   its first row's interior into the right neighbour's last row (K7), and
   ``Get_strided``s the left neighbour's column 1 above its last row
   (K9), then completes and waits. The payloads come from a snapshot of
   the window taken before the epoch opens (plus the step number), so no
   read races a landing put. A second window runs the same puts and a
   ``Get_epoch`` in fence epochs; the two windows and every step's gets
   must be bitwise equal.
2. **Passive target on an embedding shard** (``--rows`` 2**20 x
   ``--dim`` 128 float32 a rank, 512 MiB, DLRM's width): under
   ``Lock_all`` each rank Accumulate(SUM)s ``--batch`` (512) seeded rows
   to their owners (integer values in float32, so any arrival order gives
   the same bits), ``Flush_all``, a barrier, then ``--batch`` synchronous
   row Gets of the rows it accumulated, then ``Unlock_all``. Then one
   exclusive-lock round: each rank locks every rank in turn and puts
   ``EXCL_ROWS`` random float32 rows into rows of its own. The Gets and
   every touched row of the rank's shard are checked bitwise against a
   numpy replay of every rank's seeded schedule.
3. **Atomics** (one int32 counter window a rank): under ``Lock_all``,
   ``--fetches`` (64) ``Fetch_and_op(SUM, 1)`` into rank 0 per rank (the
   fetched values must be a permutation of 0..n*64-1 and the counter end
   at n*64), a ``Compare_and_swap`` ring, a NO_OP ``Get_accumulate`` that
   leaves the window unchanged, and one BAND ``Accumulate`` (host-assisted
   at the target: a K9 read, numpy's fold, a K7 replace; counted in
   ``osc_cuda_fallthrough``).

Each part's K7 / K8 / K9 launches (``rma_apply``, ``rma_apply_strided``,
``rma_read``, zeroed just before the part and read just after) must
equal what the rank derives from every rank's schedule (on the card; on
the CPU the wrappers take their plain versions and count nothing). Rank
0 also reports the AM messages it sent per epoch (pvar ``isend``) and a
per-message split of the host time, measured alone at the update
epoch's message shape: at the target (rank 0) the object channel's
receive and unpickle of a message from rank 1, the payload's
host-to-device copy and K7's launch; at the origin the row's
device-to-host copy (rank 0) and the object send (rank 1). With ``--out DIR`` each rank writes ``DIR/rank<r>.json``.
``--tiny`` runs 12 x 12 tiles, 64 x 8 shards, 16 rows and 8 fetches (the
CPU rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi, op as op_mod, osc, pml
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.osc import cuda_kernels as O
from ompi_tpu_torch.osc.cuda import CudaWindow
from ompi_tpu_torch.runtime import device_plane

#: the kernels this path runs, by the names of their rows
PATH_KERNELS = (O.rma_apply, O.rma_apply_strided, O.rma_read)
EXCL_ROWS = 4  # rows each origin puts into each target under the lock
SPLIT_MSGS = 256  # messages of the per-message split
_TAG = 7  # the split's messages, on a dup of the world comm


def launches() -> dict:
    return {k.__name__: k.launches for k in PATH_KERNELS}


def shard_init(q: int, rows: int, dim: int, device) -> torch.Tensor:
    """Rank q's initial shard: integer values in float32 from its global
    row and column (the numpy replay computes any row the same way)."""
    g = (torch.arange(rows, dtype=torch.int32, device=device)
         + q * rows).view(-1, 1)
    j = torch.arange(dim, dtype=torch.int32, device=device).view(1, -1)
    return ((g * 131 + j * 7) % 2001 - 1000).to(torch.float32)


def row_init(g: int, dim: int) -> np.ndarray:
    return (((g * 131 + np.arange(dim) * 7) % 2001) - 1000).astype(
        np.float32)


def updates(q: int, k: int, n: int, rows: int, batch: int, dim: int,
            seed: int):
    """Rank q's rep-k accumulate rows: distinct global row ids and their
    integer-valued float32 rows."""
    rng = np.random.default_rng(seed * 7919 + 1000 * k + q)
    ids = rng.choice(n * rows, size=batch, replace=False)
    return ids, rng.integers(-8, 9, (batch, dim)).astype(np.float32)


def excl_rows(q: int, t: int, rows: int, dim: int, seed: int):
    """The rows origin q puts into target t's shard under the exclusive
    lock: local row ids distinct per origin, random float32 rows."""
    rng = np.random.default_rng(seed * 104729 + 97 * q + t)
    base = (rows // 2 + q * EXCL_ROWS) % max(rows - EXCL_ROWS, 1)
    return (np.arange(EXCL_ROWS) + base,
            rng.standard_normal((EXCL_ROWS, dim)).astype(np.float32))


def bits_equal(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=8192,
                    help="halo tile rows and columns per rank")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--fetches", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="12 x 12 tiles, 64 x 8 shards (CPU rehearsal)")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if ns.tiny:
        ns.size, ns.rows, ns.dim, ns.batch, ns.fetches = 12, 64, 8, 16, 8

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    cuda = dev.type == "cuda"
    left, right = (r - 1) % n, (r + 1) % n
    cases, report = [], {}
    got_launches, want_launches = {}, {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[osc_passive n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def timed(fn):
        """fn() on rank 0's host clock, the card synchronised on both
        sides; with the AM messages rank 0 sent in it."""
        sync()
        m0 = pvar.read("isend")
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, pvar.read("isend") - m0, \
            out

    def part(name, want):
        got = launches()
        got_launches[name], want_launches[name] = got, want
        if cuda:
            case(f"{name}: K7 / K8 / K9 launches as scheduled", got == want,
                 got=got, want=want)

    # -- 1. the PSCW halo --------------------------------------------------
    h = w = ns.size
    g = torch.Generator(device=dev).manual_seed(ns.seed * 1_000_003 + r)
    tile = torch.randn(h, w, generator=g, device=dev)
    wa = osc.win_create(comm, tile, disp_unit=4)
    wb = osc.win_create(comm, tile, disp_unit=4)
    assert isinstance(wa, CudaWindow) and isinstance(wb, CudaWindow), \
        (type(wa).__name__, type(wb).__name__)
    group = sorted({left, right})

    def halo_puts(win, src, step):
        win.Put_strided(src[:, w - 2] + step, right, disp=0, stride=w)
        win.Put_strided(src[:, 1] + step, left, disp=w - 1, stride=w)
        win.Put((src[0, 1:w - 1] + step).contiguous(), right,
                disp=(h - 1) * w + 1)

    O.reset_launches()
    pscw_ms, pscw_msgs, gets_a = [], [], []
    for step in range(ns.reps):
        src = wa.array.clone()  # no epoch is open: nothing lands now

        def pscw():
            wa.Post(group)
            wa.Start(group)
            halo_puts(wa, src, step)
            col = torch.empty(h - 1, device=dev)
            wa.Get_strided(col, left, disp=1, stride=w)
            wa.Complete()
            wa.Wait()
            return col

        ms, msgs, col = timed(pscw)
        pscw_ms.append(ms)
        pscw_msgs.append(msgs)
        gets_a.append(col)
    part("pscw halo", {"rma_apply": ns.reps, "rma_apply_strided":
                       2 * ns.reps, "rma_read": ns.reps})
    fence_ms, gets_b = [], []
    wb.Fence()
    for step in range(ns.reps):
        src = wb.array.clone()

        def fence():
            halo_puts(wb, src, step)
            hb = wb.Get_epoch(h - 1, left, disp=1, stride=w)
            wb.Fence()
            return hb.array

        ms, _msgs, col = timed(fence)
        fence_ms.append(ms)
        gets_b.append(col)
    case(f"PSCW halo window == fence window ({h} x {w}, {ns.reps} steps)",
         torch.equal(wa.array.view(torch.int32), wb.array.view(torch.int32)))
    case("PSCW Get_strided == fence Get_epoch, every step", all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(gets_a, gets_b)))
    case("tile passed to win_create untouched", torch.equal(
        tile, torch.randn(h, w, generator=torch.Generator(
            device=dev).manual_seed(ns.seed * 1_000_003 + r), device=dev)))
    report["pscw_halo"] = {"epoch_ms": pscw_ms, "messages": pscw_msgs,
                           "fence_ms": fence_ms}
    wa.Free()
    wb.Free()
    del tile, src, gets_a, gets_b

    # -- 2. passive target on the embedding shard ---------------------------
    rows, dim, batch = ns.rows, ns.dim, ns.batch
    shard = shard_init(r, rows, dim, dev).reshape(-1)
    we = osc.win_create(comm, shard, disp_unit=4)
    assert isinstance(we, CudaWindow), type(we).__name__
    del shard
    sched = [[updates(q, k, n, rows, batch, dim, ns.seed) for q in range(n)]
             for k in range(ns.reps)]
    O.reset_launches()
    upd_ms, upd_msgs, look_ms, look_msgs, looked = [], [], [], [], []
    for k in range(ns.reps):
        ids, vals = sched[k][r]
        rows_dev = torch.from_numpy(vals).to(dev)

        def update():
            we.Lock_all()
            for i in range(batch):
                g_id = int(ids[i])
                we.Accumulate(rows_dev[i], g_id // rows,
                              disp=(g_id % rows) * dim, op=op_mod.SUM)
            we.Flush_all()

        ms, msgs, _ = timed(update)
        upd_ms.append(ms)
        upd_msgs.append(msgs)
        comm.Barrier()  # every rank's accumulates are applied

        def lookup():
            out = np.empty((batch, dim), np.float32)
            for i in range(batch):
                g_id = int(ids[i])
                we.Get(out[i], g_id // rows, disp=(g_id % rows) * dim)
            return out

        ms, msgs, out = timed(lookup)
        look_ms.append(ms)
        look_msgs.append(msgs)
        looked.append(out)
        we.Unlock_all()
        comm.Barrier()
    # one exclusive-lock round: every origin puts its rows into every rank
    for t in [(r + i) % n for i in range(n)]:
        local, vals = excl_rows(r, t, rows, dim, ns.seed)
        we.Lock(t, osc.LOCK_EXCLUSIVE)
        for i in range(EXCL_ROWS):
            we.Put(torch.from_numpy(vals[i]).to(dev), t,
                   disp=int(local[i]) * dim)
        we.Unlock(t)
    comm.Barrier()
    we.Sync()
    # the numpy replay: every touched row, rep by rep, then the puts
    want_rows: dict = {}
    ok_gets = True
    landed = served = 0
    for k in range(ns.reps):
        for q in range(n):
            ids, vals = sched[k][q]
            for i, g_id in enumerate(ids.tolist()):
                row = want_rows.setdefault(g_id, row_init(g_id, dim))
                row += vals[i]
                landed += g_id // rows == r
        ids, _ = sched[k][r]
        ok_gets &= all(bits_equal(looked[k][i], want_rows[int(g_id)])
                       for i, g_id in enumerate(ids))
        served += sum(int(sched[k][q][0][i]) // rows == r
                      for q in range(n) for i in range(batch))
    for q in range(n):
        local, vals = excl_rows(q, r, rows, dim, ns.seed)
        for i in range(EXCL_ROWS):
            want_rows[r * rows + int(local[i])] = vals[i]
    mine = {g_id: v for g_id, v in want_rows.items() if g_id // rows == r}
    idx = torch.tensor(sorted(mine), dtype=torch.int64) - r * rows
    have = we.array.view(rows, dim)[idx.to(dev)].cpu().numpy()
    case(f"{batch} row Gets a rep == numpy replay ({ns.reps} reps)", ok_gets)
    case(f"{len(mine)} touched rows of the shard == numpy replay",
         bits_equal(have, np.stack([mine[g] for g in sorted(mine)])))
    part("passive embedding", {"rma_apply": landed + n * EXCL_ROWS,
                               "rma_apply_strided": 0, "rma_read": served})
    report["passive_embedding"] = {
        "update_ms": upd_ms, "update_messages": upd_msgs,
        "lookup_ms": look_ms, "lookup_messages": look_msgs}

    # the per-message split, at the update epoch's message shape
    split = {}
    c2 = comm.dup()  # collective: the split's messages keep to it
    p = pml.current()
    msg = ("acc", 0, "MPI_SUM", np.ones(dim, np.float32))
    if n >= 2 and r == 1:
        t0 = time.perf_counter()
        for _ in range(SPLIT_MSGS):
            p.send_obj(c2, msg, 0, _TAG)
        p.send_obj(c2, (time.perf_counter() - t0) * 1e6 / SPLIT_MSGS, 0,
                   _TAG)
    elif n >= 2 and r == 0:
        t0 = time.perf_counter()
        for _ in range(SPLIT_MSGS):
            p.recv_obj(c2, 1, _TAG)
        split["receive_unpickle_us"] = \
            (time.perf_counter() - t0) * 1e6 / SPLIT_MSGS
        split["origin_send_us"] = p.recv_obj(c2, 1, _TAG)
        row = torch.ones(dim, device=dev)
        t0 = time.perf_counter()
        for _ in range(SPLIT_MSGS):
            osc.to_wire(row)
        split["origin_d2h_us"] = (time.perf_counter() - t0) * 1e6 / SPLIT_MSGS
        scratch = torch.zeros(4096 * dim, device=dev)
        t0 = time.perf_counter()
        pays = [torch.from_numpy(msg[3]).to(dev) for _ in range(SPLIT_MSGS)]
        split["h2d_us"] = (time.perf_counter() - t0) * 1e6 / SPLIT_MSGS
        k7 = O.rma_apply.launches
        sync()
        t0 = time.perf_counter()
        for i, pay in enumerate(pays):
            O.rma_apply(scratch, pay, (i % 4096) * dim, "sum")
        split["launch_us"] = (time.perf_counter() - t0) * 1e6 / SPLIT_MSGS
        sync()
        O.rma_apply.launches = k7  # not the path's
        # the whole update epoch per row rank 0 sent (origin and target)
        split["update_epoch_us_per_row"] = \
            float(np.median(upd_ms)) * 1e3 / batch
    c2.free()
    report["split"] = split
    we.Free()

    # -- 3. atomics -----------------------------------------------------------
    F = ns.fetches
    wc = osc.win_create(comm, torch.tensor(
        [0, 0, 1000 + r, 0x7FFF], dtype=torch.int32, device=dev),
        disp_unit=4)
    assert isinstance(wc, CudaWindow), type(wc).__name__
    one = torch.ones(1, dtype=torch.int32, device=dev)
    s = pvar.session()
    O.reset_launches()
    atom_ms, atom_msgs = [], []
    ok_perm = ok_cas = ok_noop = True
    for k in range(ns.reps):
        if r == 0:  # the counter starts each rep at 0
            wc.Lock(0, osc.LOCK_EXCLUSIVE)
            wc.Put(torch.zeros(1, dtype=torch.int32, device=dev), 0, disp=0)
            wc.Unlock(0)
        comm.Barrier()
        value = (r + 1) * 100 + k
        compare = 0 if k == 0 else value - 1

        def atomics():
            fetched = []
            res = np.zeros(1, np.int32)
            wc.Lock_all()
            for _ in range(F):
                wc.Fetch_and_op(one, res, 0, disp=0, op=op_mod.SUM)
                fetched.append(int(res[0]))
            cas = np.zeros(1, np.int32)
            wc.Compare_and_swap(np.array([value], np.int32),
                                np.array([compare], np.int32), cas, right,
                                disp=1)
            noop = np.zeros(1, np.int32)
            wc.Get_accumulate(one, noop, right, disp=2, op=op_mod.NO_OP)
            wc.Accumulate(torch.tensor([~(1 << k)], dtype=torch.int32,
                                       device=dev), right, disp=3,
                          op=op_mod.BAND)
            wc.Unlock_all()
            return fetched, int(cas[0]), int(noop[0])

        ms, msgs, (fetched, cas, noop) = timed(atomics)
        atom_ms.append(ms)
        atom_msgs.append(msgs)
        everyone = comm.allgather(fetched)
        ok_perm &= sorted(v for f in everyone for v in f) == list(
            range(n * F))
        ok_cas &= cas == compare
        ok_noop &= noop == 1000 + right
        comm.Barrier()
    wc.Sync()
    final = wc.array.cpu().tolist()
    mask = 0x7FFF
    for k in range(ns.reps):
        mask &= ~(1 << k)
    case(f"fetched values a permutation of 0..{n * F - 1} each rep",
         ok_perm)
    case(f"counter ends at {n * F}", r != 0 or final[0] == n * F,
         counter=final[0])
    case("Compare_and_swap ring: each swap hit, the slot holds the left "
         "neighbour's value", ok_cas
         and final[1] == (left + 1) * 100 + ns.reps - 1)
    case("NO_OP Get_accumulate read the slot and left it unchanged",
         ok_noop and final[2] == 1000 + r)
    case("BAND host-assisted: the slot == 0x7FFF & the masks, counted in "
         "osc_cuda_fallthrough", final[3] == mask
         and s.read("osc_cuda_fallthrough") == ns.reps,
         fallthrough=s.read("osc_cuda_fallthrough"))
    served = (n * F + 1) * ns.reps if r == 0 else 0
    part("atomics", {"rma_apply": served + 2 * ns.reps,
                     "rma_apply_strided": 0,
                     "rma_read": (n * F if r == 0 else 0) * ns.reps
                     + 3 * ns.reps})
    report["atomics"] = {"epoch_ms": atom_ms, "messages": atom_msgs}
    wc.Free()

    total = {k.__name__: sum(p[k.__name__] for p in got_launches.values())
             for k in PATH_KERNELS}
    expected = {k.__name__: sum(p[k.__name__] for p in want_launches.values())
                for k in PATH_KERNELS}
    if r == 0:
        print(f"[osc_passive n={n}] {h} x {w} halo, {rows} x {dim} shard, "
              f"{batch} rows, {F} fetches, {ns.reps} reps (rank 0): "
              f"{json.dumps(report)}; launches per part "
              f"{json.dumps(got_launches)}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "launches": total, "expected_launches": expected,
                       "part_launches": got_launches,
                       "part_expected": want_launches,
                       "required": [k.__name__ for k in PATH_KERNELS],
                       "report": report, "cases": cases,
                       "coll_accelerator_staged":
                           pvar.read("coll_accelerator_staged")}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
