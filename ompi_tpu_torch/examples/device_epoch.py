"""Device-epoch windows: an embedding table's lookups and sparse updates,
a block exchange, and an IPC hand-off.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        ompi_tpu_torch/examples/device_epoch.py

Every window of the path is a ``DeviceEpochWindow``
(``osc.win_create_device``): a fence epoch's Puts, Accumulates and Gets
run at the closing Fence as the reference's coloured rounds, moved in
exchanges over the window comm's arena, applied at the target by K8's
grouped kernel (K7 for contiguous rows of 2**20 elements or more), served
by K9 and landed by K10. Beside each one, a ``CudaWindow``
(``win_create_cuda``) over a copy of the same tensor takes the same ops
in fence epochs, in turns with it (the first to run alternates): after
every epoch the two windows and every Get must be bitwise equal. Three
parts:

1. **Embedding epochs** (``--rows`` 2**20 x ``--dim`` 128 float32 a
   rank, 512 MiB, DLRM's width; the shard drawn on the device from seeded
   generators, ``CHUNK`` rows each): a warm SUM epoch, ``--reps`` (3)
   timed SUM epochs, then a MAX and a REPLACE epoch. A SUM epoch holds
   ``--batch`` (512) ``Get(dim, owner, row * dim)`` lookups and 512
   ``Accumulate(SUM)`` gradient rows a rank; MAX and REPLACE 512 rows.
   Rows, owners and values come from a seeded numpy generator: half the
   rows from a hot set every rank shares, so several origins hit one row,
   and the values' magnitudes spread over 2**-12 .. 2**12, so a sum's bits
   show its order. Every lookup and every touched row of the rank's shard
   is checked bitwise against a numpy float32 replay, on the host, of
   every rank's ops in the reference's round order (the rounds computed
   by the reference's own passes, grouped by element count).
2. **Block epochs** (``--block`` 2**26 float32 a rank, 256 MiB, the halo
   tile's size): each rank Puts a seeded block to its right neighbour
   (one contiguous row: K7) and Gets its left neighbour's window (K9, K10)
   in one epoch; a warm epoch and ``--reps`` timed. The window must hold
   the left neighbour's block, the Get the left neighbour's left
   neighbour's (puts run before gets).
3. **IPC**: rank 0 ``ipc_export``s a seeded ``--ipc-bytes`` (64 MiB)
   tensor and sends the handle with ``bcast``; rank 1 imports it onto its
   device and checks it bitwise; rank 0 then releases it.

Each part zeroes the K7-K10 launch counts just before it and reads them
just after; on the card the device-epoch window's launches (counted
around its fences) and the CudaWindow's must each equal what the rank
derives from every rank's schedule (the reference's rounds cut into
exchanges by ``osc.cuda.plan_exchanges``, each target's rows planned by
``cuda_kernels.plan_apply`` / ``plan_read``, one K10 launch per
``COPY_CAP`` sources landing at an origin), and the part's total their
sum. ``osc_device_epoch_op`` must equal the ops queued, and
``coll_accelerator_staged`` and the host window's ``osc_put`` /
``osc_get`` / ``osc_acc`` must stay 0. Rank 0 reports each part's epoch
times (its host clock, the card synchronised on both sides) beside the
CudaWindow's, part 2's rate, the rounds and exchanges of each epoch, and
every rank its peak memory and ``device_plane_arena_bytes``. With
``--out DIR`` each rank writes ``DIR/rank<r>.json``. ``--tiny`` runs 64 x
8 shards, 16 rows, 4096-float blocks and a 64 KiB hand-off (the CPU
rehearsal; on the CPU the wrappers take their plain versions and count
nothing).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import accelerator, mpi, op as op_mod, osc
from ompi_tpu_torch.accelerator import ipc
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.osc import cuda as osc_cuda
from ompi_tpu_torch.osc import cuda_kernels as O
from ompi_tpu_torch.runtime import device_plane

#: the kernels of the path (K7, K8, K9, K10), by the names of their rows
KERNELS = (O.rma_apply, O.rma_apply_strided_batch, O.rma_read_batch,
           O.rma_permute_recv_batch)
CHUNK = 1024  # shard rows per seeded generator
_OPS = {"sum": op_mod.SUM, "max": op_mod.MAX, "replace": op_mod.REPLACE}


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def _diff(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def _add(acc: dict, d: dict) -> None:
    for k, v in d.items():
        acc[k] = acc.get(k, 0) + v


def _gen(device, *key) -> torch.Generator:
    seed = 0
    for k in key:
        seed = (seed * 1_000_003 + int(k)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(seed)


def shard_chunk(seed, q, c, rows, dim, dev) -> torch.Tensor:
    n = min(CHUNK, rows - c * CHUNK)
    return torch.randn(n, dim, generator=_gen(dev, seed, 1, q, c),
                       device=dev)


def shard(seed, q, rows, dim, dev) -> torch.Tensor:
    return torch.cat([shard_chunk(seed, q, c, rows, dim, dev)
                      for c in range(-(-rows // CHUNK))]).reshape(-1)


def block(seed, q, k, n, dev) -> torch.Tensor:
    """Rank q's epoch-k block."""
    return torch.randn(n, generator=_gen(dev, seed, 3, q, k), device=dev)


def schedule(seed, k, q, n, rows, batch, hot, dim):
    """Rank q's epoch-k ops: updated global rows, looked-up global rows,
    and the update values (float32, magnitudes 2**-12 .. 2**12)."""
    hotset = np.random.default_rng([seed, k]).choice(n * rows, hot,
                                                     replace=False)
    rng = np.random.default_rng([seed, k, q])

    def draw():
        pick = hotset[rng.integers(0, hot, batch)]
        return np.where(rng.random(batch) < 0.5, pick,
                        rng.integers(0, n * rows, batch))

    upd, look = draw(), draw()
    vals = (rng.standard_normal((batch, dim))
            * 2.0 ** rng.integers(-12, 13, (batch, 1))).astype(np.float32)
    return upd, look, vals


def reference_rounds(edges):
    """The reference's rounds of a fence's edges ``(src, dst, disp,
    nelems, ...)``: grouped by element count (sorted), each group cut by
    its greedy passes into partial matchings (ompi_tpu's
    ``coll/xla_neighbor._color``), written out here as the replay's
    independent oracle."""
    by_n: dict = {}
    for e in edges:
        by_n.setdefault(e[3], []).append(e)
    out = []
    for nel in sorted(by_n):
        remaining = by_n[nel]
        while remaining:
            used_s, used_d, rnd, rest = set(), set(), [], []
            for e in remaining:
                if e[0] in used_s or e[1] in used_d:
                    rest.append(e)
                else:
                    used_s.add(e[0])
                    used_d.add(e[1])
                    rnd.append(e)
            out.append(rnd)
            remaining = rest
    return out


def derived_launches(put_rounds, get_rounds, me, n, size, esize) -> dict:
    """The K7-K10 launches one closing fence makes at rank ``me``, from
    the reference's rounds of every rank's puts (edges ``(src, dst, disp,
    nelems, kind, ...)``) and gets (``(target, origin, disp, nelems)``):
    the rounds cut into exchanges, then each exchange's rows as the
    target plans them."""
    got = {k.__name__: 0 for k in KERNELS}
    for rounds, is_put in ((put_rounds, True), (get_rounds, False)):
        cuts = osc_cuda.plan_exchanges(
            [[(e[0], e[3] * esize) for e in rnd] for rnd in rounds],
            osc_cuda.EXCHANGE_BYTES)
        for a, b in cuts:
            run = [e for rnd in rounds[a:b] for e in rnd]
            offs, _totals, _blocks = osc_cuda.exchange_layout(run, n)
            if is_put:
                rows = [(0, offs[j], e[3], e[2], 1, e[4])
                        for j, e in enumerate(run) if e[1] == me]
                for what, _r in O.plan_apply(size, rows):
                    got["rma_apply" if what == "k7"
                        else "rma_apply_strided_batch"] += 1
                continue
            served = [(e[2], 1, e[3], offs[j])
                      for j, e in enumerate(run) if e[0] == me]
            got["rma_read_batch"] += len(O.plan_read(size, served))
            srcs = {e[0] for e in run if e[1] == me}
            got["rma_permute_recv_batch"] += -(-len(srcs) // O.COPY_CAP)
    return got


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def p50(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--hot", type=int, default=64,
                    help="rows of the shared hot set")
    ap.add_argument("--block", type=int, default=1 << 26,
                    help="part 2's block, float32 elements a rank")
    ap.add_argument("--ipc-bytes", type=int, default=64 << 20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="64 x 8 shards, 16 rows, 4096-float blocks")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if ns.tiny:
        ns.rows, ns.dim, ns.batch, ns.hot = 64, 8, 16, 8
        ns.block, ns.ipc_bytes = 4096, 1 << 16

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    assert n >= 2, "the example needs 2 ranks or more"
    dev = device_plane.device()
    cuda = dev.type == "cuda"
    s = pvar.session()
    cases, report = [], {}
    part_launches, part_cw, part_total, part_expected = {}, {}, {}, {}
    ops_queued = 0

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[device_epoch n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def epoch(win, ops, acc):
        """One epoch on ``win``: the opening Fence, then ``ops()`` (which
        queues the epoch's ops and returns what to keep) and the closing
        Fence, timed on the host clock with the card synchronised on both
        sides; the window's launches, rounds and exchanges are counted
        around it."""
        win.Fence()
        sync()
        l0 = launches()
        r0, x0 = s.read("osc_cuda_rounds"), s.read("osc_cuda_exchanges")
        t0 = time.perf_counter()
        kept = ops()
        win.Fence()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        _add(acc, _diff(l0, launches()))
        return ms, (s.read("osc_cuda_rounds") - r0,
                    s.read("osc_cuda_exchanges") - x0), kept

    # -- 1. embedding epochs ------------------------------------------------
    rows, dim, batch = ns.rows, ns.dim, ns.batch
    # (Accumulate kind, with lookups, timed): a warm SUM epoch, the timed
    # SUM epochs, a MAX and a REPLACE epoch
    epochs = ([("sum", True, False)] + [("sum", True, True)] * ns.reps
              + [("max", False, False), ("replace", False, False)])
    base = shard(ns.seed, r, rows, dim, dev)
    we = osc.win_create_device(comm, base)
    wc = osc_cuda.win_create_cuda(comm, base, disp_unit=4)
    del base
    sched = [[schedule(ns.seed, k, q, n, rows, batch, ns.hot, dim)
              for q in range(n)] for k in range(len(epochs))]
    # the replay: every row this rank looks up or owns and sees updated
    need = set()
    for k, (_kind, look, _t) in enumerate(epochs):
        for q in range(n):
            upd = sched[k][q][0]
            need.update(int(g) for g in upd if g // rows == r)
        if look:
            need.update(int(g) for g in sched[k][r][1])
    state = {}
    by_chunk: dict = {}
    for g in sorted(need):
        by_chunk.setdefault((g // rows, (g % rows) // CHUNK), []).append(g)
    for (q, c), gs in by_chunk.items():
        at = torch.tensor([(g % rows) % CHUNK for g in gs], device=dev)
        got = shard_chunk(ns.seed, q, c, rows, dim, dev)[at].cpu().numpy()
        for g, row in zip(gs, got):
            state[g] = row
    O.reset_launches()
    de_acc, cw_acc = {}, {}
    t_de, t_cw, emb_rounds = [], [], []
    ok_cw = ok_look = True
    for k, (kind, look, timed) in enumerate(epochs):
        upd, lk, vals = sched[k][r]
        vals_dev = torch.from_numpy(vals).to(dev)
        handles = {}

        def ops(de):
            win, hs = (we if de else wc), []
            if look:
                for g in lk:
                    o, i = int(g) // rows, int(g) % rows
                    hs.append(win.Get(dim, o, disp=i * dim) if de else
                              win.Get_epoch(dim, o, disp=i * dim))
            for j, g in enumerate(upd):
                o, i = int(g) // rows, int(g) % rows
                win.Accumulate(vals_dev[j], o, disp=i * dim,
                               op=kind if de else _OPS[kind])
            return hs

        order = (True, False) if k % 2 == 0 else (False, True)
        for de in order:
            ms, rx, handles[de] = epoch(we if de else wc,
                                        lambda: ops(de),
                                        de_acc if de else cw_acc)
            if de:
                emb_rounds.append(rx)
                ops_queued += len(upd) + (len(lk) if look else 0)
            if timed:
                (t_de if de else t_cw).append(ms)
        ok_cw &= bits_equal(we.array, wc.array) and all(
            bits_equal(a.array, b.array)
            for a, b in zip(handles[True], handles[False]))
        # the replay of every rank's ops, in the reference's round order
        puts = [(q, int(g) // rows, (int(g) % rows) * dim, dim, kind, j)
                for q in range(n) for j, g in enumerate(sched[k][q][0])]
        put_rounds = reference_rounds(puts)
        for rnd in put_rounds:
            for q, o, d, _nel, _k, j in rnd:
                g = o * rows + d // dim
                if g in state:
                    v = sched[k][q][2][j]
                    if kind == "sum":
                        state[g] = state[g] + v
                    elif kind == "max":
                        state[g] = np.maximum(state[g], v)
                    else:
                        state[g] = v.copy()
        if look:
            got = torch.stack([h.array for h in handles[True]]).cpu().numpy()
            want = np.stack([state[int(g)] for g in lk])
            ok_look &= got.tobytes() == want.tobytes()
        gets = [(int(g) // rows, q, (int(g) % rows) * dim, dim)
                for q in range(n) for g in sched[k][q][1]] if look else []
        _add(part_expected.setdefault("embedding", {}), derived_launches(
            put_rounds, reference_rounds(gets), r, n, rows * dim, 4))
    part_total["embedding"] = launches()
    part_launches["embedding"], part_cw["embedding"] = de_acc, cw_acc
    mine = sorted(g for g in state if g // rows == r)
    idx = torch.tensor([g - r * rows for g in mine], dtype=torch.int64)
    have = we.array.view(rows, dim)[idx.to(dev)].cpu().numpy()
    case(f"embedding: every epoch's window and lookups == CudaWindow's "
         f"({len(epochs)} epochs)", ok_cw)
    case(f"embedding: {batch} lookups a SUM epoch == numpy replay", ok_look)
    case(f"embedding: {len(mine)} touched rows of the shard == numpy replay",
         have.tobytes() == np.stack([state[g] for g in mine]).tobytes()
         if mine else True)
    report["embedding"] = {"epoch_ms": t_de, "cuda_window_ms": t_cw,
                           "rounds_exchanges": emb_rounds,
                           "rows": rows, "dim": dim, "batch": batch}
    we.Free()
    wc.Free()

    # -- 2. block epochs ------------------------------------------------------
    nb = ns.block
    left, right = (r - 1) % n, (r + 1) % n
    base = block(ns.seed, r, -1, nb, dev)
    wbe = osc.win_create_device(comm, base)
    wbc = osc_cuda.win_create_cuda(comm, base, disp_unit=4)
    del base
    O.reset_launches()
    de_acc, cw_acc = {}, {}
    t_de, t_cw, blk_rounds = [], [], []
    ok_blk = ok_cw = True
    for k in range(1 + ns.reps):
        payload = block(ns.seed, r, k, nb, dev)
        got = {}
        order = (True, False) if k % 2 == 0 else (False, True)
        def ops(de):
            win = wbe if de else wbc
            win.Put(payload, right, disp=0)
            return win.Get(nb, left, disp=0) if de else \
                win.Get_epoch(nb, left, disp=0)

        for de in order:
            ms, rx, h = epoch(wbe if de else wbc, lambda: ops(de),
                              de_acc if de else cw_acc)
            got[de] = h.array
            if de:
                blk_rounds.append(rx)
                ops_queued += 2
            if k:
                (t_de if de else t_cw).append(ms)
        ok_cw &= bits_equal(wbe.array, wbc.array) and bits_equal(
            got[True], got[False])
        ok_blk &= bits_equal(wbe.array, block(ns.seed, left, k, nb, dev)) \
            and bits_equal(got[True], block(ns.seed, (left - 1) % n, k, nb,
                                            dev))
        del payload, got
        _add(part_expected.setdefault("block", {}), derived_launches(
            reference_rounds([(q, (q + 1) % n, 0, nb, "put")
                              for q in range(n)]),
            reference_rounds([((q - 1) % n, q, 0, nb) for q in range(n)]),
            r, n, nb, 4))
    part_total["block"] = launches()
    part_launches["block"], part_cw["block"] = de_acc, cw_acc
    case(f"block: window == left neighbour's block, Get == its left "
         f"neighbour's ({1 + ns.reps} epochs of {nb} float32)", ok_blk)
    case("block: every epoch's window and Get == CudaWindow's", ok_cw)
    ms = p50(t_de)
    report["block"] = {
        "epoch_ms": t_de, "cuda_window_ms": t_cw,
        "rounds_exchanges": blk_rounds, "elements": nb,
        # per rank: a block out (the put) and a block in (the get)
        "gbps_per_rank": 2 * nb * 4 / (ms * 1e-3) / 1e9 if ms else None}
    wbe.Free()
    wbc.Free()

    # -- 3. IPC ---------------------------------------------------------------
    acc = accelerator.current()
    m = ns.ipc_bytes // 4
    src = torch.randn(m, generator=_gen(dev, ns.seed, 4), device=dev)
    ipc_ms = {}
    h = None
    if r == 0:
        t0 = time.perf_counter()
        h = acc.ipc_export(src)
        ipc_ms["export"] = (time.perf_counter() - t0) * 1e3
    h = comm.bcast(h, 0)
    ok_ipc = True
    if r == 1:
        t0 = time.perf_counter()
        back = acc.ipc_import(h, dev)
        sync()
        ipc_ms["import"] = (time.perf_counter() - t0) * 1e3
        ok_ipc = back.device == src.device and bits_equal(back, src)
        del back
    comm.Barrier()
    if r == 0:
        ipc.release(h)
        ok_ipc = not os.path.exists(h.path)
    ipc_ms = {k: v for d in comm.allgather(ipc_ms) for k, v in d.items()}
    case(f"IPC: rank 1's import of rank 0's {ns.ipc_bytes}-byte tensor is "
         "bitwise equal, and the release unlinks it", ok_ipc)
    report["ipc"] = {"bytes": ns.ipc_bytes, "ms": ipc_ms}

    # -- the counts ---------------------------------------------------------
    if cuda:
        for part in part_expected:
            want, got = part_expected[part], part_launches[part]
            case(f"{part}: device-epoch launches as derived", got == want,
                 got=got, want=want)
            case(f"{part}: CudaWindow launches as derived",
                 part_cw[part] == want, got=part_cw[part])
            case(f"{part}: the part's launches are the two windows'",
                 part_total[part] == {k: 2 * v for k, v in want.items()},
                 got=part_total[part])
    pv = {k: s.read(k) for k in ("osc_device_epoch_op", "osc_put",
                                 "osc_get", "osc_acc",
                                 "coll_accelerator_staged")}
    case("osc_device_epoch_op == the ops queued; nothing staged, no host "
         "window op", pv["osc_device_epoch_op"] == ops_queued
         and not any(pv[k] for k in pv if k != "osc_device_epoch_op"),
         **pv, queued=ops_queued)
    report["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda \
        else 0
    report["arena_bytes"] = pvar.read("device_plane_arena_bytes")
    total = {}
    for d in part_launches.values():
        _add(total, d)
    if r == 0:
        print(f"[device_epoch n={n}] {json.dumps(report)}; device-epoch "
              f"launches per part {json.dumps(part_launches)}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "launches": total, "part_launches": part_launches,
                       "part_cuda_window": part_cw,
                       "part_expected": part_expected,
                       "required": [k.__name__ for k in KERNELS],
                       "report": report, "pvars": pv, "cases": cases,
                       "coll_accelerator_staged":
                           pv["coll_accelerator_staged"]}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
