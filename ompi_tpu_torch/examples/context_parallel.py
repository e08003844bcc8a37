"""Context- and expert-parallel ops on a mesh of ranks: the port's
``parallel/`` and ``ops/`` at bench.py's d7168 attention and FFN widths
(``bench.py:113-115``: d_model 7168, 56 heads of 128, d_ff 28672, T 1024,
B 4, bfloat16).

Run::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        ompi_tpu_torch/examples/context_parallel.py [--out DIR]

On a machine without a GPU add ``--mca device_plane_platform cpu`` and
``--tiny`` (narrow widths, the same checks). Needs 4 ranks: a 1-D
``("sp",)`` mesh and a 2 x 2 ``("dp", "sp")`` mesh over the same ranks.
Inputs and weights are drawn on each rank's device from seeded
generators; a check regenerates other ranks' inputs from their seeds
where it can. Parts, each with the kernels' launch counts read before
and after:

1. axis collectives: a float32 Allreduce over ``sp``, ``dp`` and
   ``("dp", "sp")`` in 'linear', 'ring' and '' (the first two bitwise
   equal to the rank-order fold and to the ring's per-chunk fold of the
   allgathered inputs, '' within ``AR_RTOL`` of the magnitudes);
   Reduce_scatter_block ('linear' and 'ring'), Allgather, Alltoall and
   Shift of bfloat16 [4, T, d_model] tensors over ``sp``, bitwise; Scan
   float32, bitwise;
2. context-parallel attention, causal, bfloat16, [B, T/4, H, D] a rank:
   ``ring_attention`` and ``ulysses_attention`` against the plain
   ``mha`` of the allgathered q, k, v (this rank's query rows), and ring
   against Ulysses, each ``max|err| <= ATT_TOL * max|ref|``; a float32
   pass at the reference test's shape (B 2, T 16, H 4, D 8) within
   ``F32_ATOL`` (TF32 off); times (rank 0's p50 of ``REPS``) of ring
   attention, its compute alone (the n online-softmax steps over the
   local block, no hop), Ulysses, the whole sequence's ``mha`` on rank 0
   alone and one ``permute_dev`` hop of the (k, v) block; ``mha_auto``
   (PyTorch's SDPA on the card) against ``mha`` and its time, rank 0;
3. expert-parallel MoE: ``moe_ffn`` with 8 experts (2 a rank) at
   capacity factor 1.25 over B*T/4 tokens a rank; rank 0 gathers every
   rank's tokens, outputs and experts (coll/device's rooted Gather) and
   holds each output against the dense oracle of ``tests/test_ops.py``
   (top-1 routing, capacity in token order, each kept token through its
   expert, float32) within ``MOE_TOL * max|ref|``; ``dropped`` and the
   per-expert counts; times of the layer and of its two Alltoalls.

Writes ``rank<r>.json`` under ``--out`` (cases, launches per part,
times); exits non-zero when a case fails or, on the card, a kernel of a
part never launched.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.coll import device as cd
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.ops import attention as att
from ompi_tpu_torch.ops import moe
from ompi_tpu_torch.ops.ring_attention import ring_attention
from ompi_tpu_torch.ops.ulysses import ulysses_attention
from ompi_tpu_torch.parallel import (DeviceCommunicator, P, collectives as C,
                                     make_mesh, ring)
from ompi_tpu_torch.runtime import device_plane

#: bench.py's d7168 widths (the attention and FFN of one layer), and the
#: narrow ones of ``--tiny``; ``ar_elems``: the float32 Allreduce's
#: elements a rank (64 MiB on the card)
WIDTHS = {
    "full": dict(d_model=7168, heads=56, head_dim=128, d_ff=28672,
                 seq=1024, batch=4, ar_elems=16 << 20, scan_elems=1 << 20),
    "tiny": dict(d_model=64, heads=8, head_dim=8, d_ff=128, seq=32,
                 batch=2, ar_elems=1000, scan_elems=100),
}
N_EXPERTS = 8
CAPACITY_FACTOR = 1.25
#: the reference test's float32 attention shape (tests/test_ops.py:32)
F32_SHAPE = (2, 16, 4, 8)
#: bfloat16 attention and MoE outputs against their float32 oracles:
#: max|err| <= tol * max|ref| (one bfloat16 rounding of the output is at
#: most 2**-8 of a value; the rest is the float32 sums' order)
ATT_TOL = 2e-2
MOE_TOL = 2e-2
#: the float32 attention pass (the reference test's atol)
F32_ATOL = 2e-5
#: '' Allreduce against the rank-order fold, relative to sum |x|
AR_RTOL = 1e-5
REPS = 5
PATH_KERNELS = (K.ring_rs_hop, K.ring_ag_hop, K.linear_fold)


def seeded(shape, seed: int, dev, dtype=torch.float32, scale=1.0):
    """Normal values from a generator seeded with ``seed`` on ``dev``
    (the same values on every rank that asks for this seed)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    return (t * scale).to(dtype)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def fold(rows):
    acc = rows[0]
    for x in rows[1:]:
        acc = acc + x
    return acc


def ring_fold(xs):
    """The ring allreduce's result: the flat inputs zero-padded to n
    chunks; chunk c folds ranks c+1, c+2, ..., c (the reference's
    ``ring_allreduce``)."""
    n, m = len(xs), xs[0].numel()
    k = -(-m // n)
    g = torch.stack([torch.cat([x.reshape(-1), x.new_zeros(n * k - m)])
                     for x in xs]).view(n, n, k)
    c = torch.arange(n, device=g.device)
    return fold([g[(c + 1 + i) % n, c] for i in range(n)]).reshape(-1)[:m]


def timed(fn, dev, reps=REPS):
    """p50 and all of ``reps`` timed calls (ms) after one warm-up; every
    rank calls, each call between two device syncs."""
    fn()
    ms = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2], ms


class Report:
    def __init__(self, rank: int) -> None:
        self.rank = rank
        self.cases = []
        self.times = {}

    def case(self, name: str, ok: bool, **info) -> None:
        self.cases.append({"name": name, "ok": bool(ok), **info})
        if not ok:
            print(f"[context_parallel] rank {self.rank}: FAILED {name} "
                  f"{info}", flush=True)


def collectives_part(world, sp, mesh2, w, dev, rep: Report) -> None:
    r = world.rank
    m = w["ar_elems"]
    for label, mesh, ax in (("sp", sp, "sp"), ("dp", mesh2, "dp"),
                            ("dp,sp", mesh2, ("dp", "sp"))):
        comm = mesh.comm_of(ax)
        x = seeded((m,), 100 + r, dev)
        with mesh:  # the members' inputs in comm rank order
            xs = list(C.allgather(x, ax, tiled=False))
        lin, rng = fold(xs), ring_fold(xs)
        mag = fold([t.abs() for t in xs])
        for det in ("linear", "ring", None):
            with mesh:
                out = C.allreduce(x, ax, deterministic=det)
            if det is None:
                ok = bool(((out - lin).abs() <= AR_RTOL * mag).all())
            else:
                ok = bits_equal(out, lin if det == "linear" else rng)
            rep.case(f"allreduce float32 {m * 4} B over {label} "
                     f"(size {comm.size}) {det or chr(39) * 2}", ok)
    n = sp.comm.size
    shape = (4, w["seq"], w["d_model"])
    xs = [seeded(shape, 200 + j, dev, torch.bfloat16) for j in range(n)]
    x = xs[r]
    with sp:
        got = C.reduce_scatter(x, "sp", deterministic="linear")
        rep.case("reduce_scatter bfloat16 linear", bits_equal(
            got, fold(xs).chunk(n)[r]))
        got = C.reduce_scatter(x, "sp", deterministic="ring")
        exp = fold([xs[(r + 1 + i) % n].chunk(n)[r] for i in range(n)])
        rep.case("reduce_scatter bfloat16 ring", bits_equal(got, exp))
        rep.case("allgather bfloat16", bits_equal(
            C.allgather(x, "sp"), torch.cat(xs)))
        rep.case("alltoall bfloat16", bits_equal(
            C.alltoall(x, "sp"), torch.cat([t.chunk(n)[r] for t in xs])))
        rep.case("shift bfloat16", bits_equal(
            C.shift(x, "sp", 1), xs[(r - 1) % n]))
        ys = [seeded((w["scan_elems"],), 300 + j, dev) for j in range(n)]
        rep.case("scan float32", bits_equal(
            C.scan(ys[r], "sp"), fold(ys[:r + 1])))


def attention_part(world, sp, w, dev, rep: Report) -> None:
    r, n = world.rank, world.size
    b, t, h, d = w["batch"], w["seq"], w["heads"], w["head_dim"]
    tl = t // n
    q, k, v = (seeded((b, t, h, d), s, dev, torch.bfloat16)
               for s in (7, 8, 9))
    dc = DeviceCommunicator(sp, "sp")
    specs = (P(None, "sp"),) * 3
    ring_fn = dc.run(lambda a, bb, c: ring_attention(a, bb, c, "sp"), specs)
    uly_fn = dc.run(lambda a, bb, c: ulysses_attention(a, bb, c, "sp"),
                    specs)
    out_ring, out_uly = ring_fn(q, k, v), uly_fn(q, k, v)
    # the oracle: plain mha over the allgathered blocks, this rank's rows
    ql, kl, vl = (x[:, r * tl:(r + 1) * tl].contiguous() for x in (q, k, v))
    with sp:
        qa, ka, va = (C.allgather(x, "sp", gather_dim=1)
                      for x in (ql, kl, vl))
    ref = att.mha(qa[:, r * tl:(r + 1) * tl], ka, va, q_offset=r * tl)
    bound = ATT_TOL * float(ref.float().abs().max())
    for name, out in (("ring_attention", out_ring),
                      ("ulysses_attention", out_uly)):
        err = float((out.float() - ref.float()).abs().max())
        rep.case(f"{name} bfloat16 vs mha", err <= bound, err=err,
                 bound=bound)
    err = float((out_ring.float() - out_uly.float()).abs().max())
    rep.case("ring_attention vs ulysses bfloat16", err <= bound, err=err,
             bound=bound)
    # float32 at the reference test's shape
    fq, fk, fv = (seeded(F32_SHAPE, s, dev) for s in (17, 18, 19))
    fl = F32_SHAPE[1] // n
    fref = att.mha(fq, fk, fv)[:, r * fl:(r + 1) * fl]
    for name, fn in (("ring_attention", ring_attention),
                     ("ulysses_attention", ulysses_attention)):
        got = dc.run(lambda a, bb, c, fn=fn: fn(a, bb, c, "sp"),
                     specs)(fq, fk, fv)
        err = float((got - fref).abs().max())
        rep.case(f"{name} float32 {F32_SHAPE} vs mha", err <= F32_ATOL,
                 err=err)
    # times: every rank runs the collective ones; rank 0 alone the mha
    with sp:
        rep.times["ring_attention"] = timed(
            lambda: ring_attention(ql, kl, vl, "sp"), dev)
        rep.times["ulysses_attention"] = timed(
            lambda: ulysses_attention(ql, kl, vl, "sp"), dev)
        rep.times["permute_hop_kv"] = timed(
            lambda: ring.ring_rotate((kl, vl), "sp"), dev)
        rep.times["ring_attention_compute"] = timed(
            lambda: ring_compute(ql, kl, vl, r, n), dev)
        C.barrier("sp")
        if r == 0:
            rep.times["mha_whole_sequence"] = timed(
                lambda: att.mha(q, k, v), dev)
            # mha_auto: PyTorch's SDPA on the card (no path runs it)
            full = att.mha(q, k, v).float()
            err = float((att.mha_auto(q, k, v).float() - full).abs().max())
            bound = ATT_TOL * float(full.abs().max())
            del full
            rep.case("mha_auto vs mha, whole sequence (rank 0)",
                     err <= bound, err=err, bound=bound)
            rep.times["mha_auto_whole_sequence"] = timed(
                lambda: att.mha_auto(q, k, v), dev)
        C.barrier("sp")
    rep.times["permute_hop_kv_bytes"] = kl.nbytes + vl.nbytes


def ring_compute(q, k, v, r: int, n: int):
    """Ring attention's compute without its hops: the n online-softmax
    steps of rank r, each over the local (k, v) under the causal mask of
    the block it stands in for."""
    b, t, h, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), -torch.inf, dtype=torch.float32,
                   device=q.device)
    pos = torch.arange(t, device=q.device)
    for s in range(n):
        mask = (r * t + pos)[:, None] >= (((r - s) % n) * t + pos)[None, :]
        o, l, m = att.online_softmax_block(q, k, v, o, l, m, mask=mask)
    return att.finalize_online_softmax(o, l)


def moe_oracle(x, wg, w1_all, w2_all, cap):
    """tests/test_ops.py's per-token oracle, with the FFN batched per
    expert: top-1 routing, each expert keeping its first ``cap`` tokens
    in token order, each kept token through its expert in float32 times
    its gate."""
    gates = torch.softmax((x @ wg).float(), -1)
    pick = gates.argmax(-1).tolist()
    counts = [0] * wg.shape[1]
    rows = [[] for _ in counts]
    for i, ex in enumerate(pick):
        if counts[ex] < cap:
            counts[ex] += 1
            rows[ex].append(i)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for ex, idx in enumerate(rows):
        if not idx:
            continue
        idx = torch.tensor(idx, device=x.device)
        hid = torch.relu(x[idx].float() @ w1_all[ex].float())
        out[idx] = gates[idx, ex][:, None] * (hid @ w2_all[ex].float())
    return out


def moe_part(world, sp, w, dev, rep: Report) -> dict:
    r, n = world.rank, world.size
    d, f = w["d_model"], w["d_ff"]
    e_local = N_EXPERTS // n
    tokens = w["batch"] * w["seq"] // n
    x = seeded((tokens, d), 1000 + r, dev, torch.bfloat16)
    wg = seeded((d, N_EXPERTS), 2000, dev, torch.bfloat16, d ** -0.5)
    mine = range(r * e_local, (r + 1) * e_local)
    w1 = torch.stack([seeded((d, f), 3000 + e, dev, torch.bfloat16,
                             d ** -0.5) for e in mine])
    w2 = torch.stack([seeded((f, d), 4000 + e, dev, torch.bfloat16,
                             f ** -0.5) for e in mine])
    cap = max(int(CAPACITY_FACTOR * tokens / N_EXPERTS), 1)
    s = pvar.session()
    with sp:
        y = moe.moe_ffn(x, wg, w1, w2, "sp", CAPACITY_FACTOR)
    route = moe._route(x @ wg, cap)
    dropped = int(route.dropped)
    counts = route.counts.tolist()
    rep.case("moe dropped metered", s.read("serve_dropped_tokens")
             == dropped, dropped=dropped)
    # rank 0 holds every rank's output against the dense oracle
    got = [cd.gather_dev(world, t, root=0) for t in (x, y, w1, w2)]
    if r == 0:
        xs, ys, w1s, w2s = got
        w1_all = w1s.reshape(N_EXPERTS, d, f)
        w2_all = w2s.reshape(N_EXPERTS, f, d)
        errs, bounds = [], []
        for src in range(n):
            ref = moe_oracle(xs[src], wg, w1_all, w2_all, cap)
            errs.append(float((ys[src].float() - ref).abs().max()))
            bounds.append(MOE_TOL * float(ref.abs().max()))
        rep.case("moe_ffn vs the dense oracle (every rank)",
                 all(e <= b for e, b in zip(errs, bounds)), errs=errs,
                 bounds=bounds)
    del got
    with sp:
        rep.times["moe_ffn"] = timed(
            lambda: moe.moe_ffn(x, wg, w1, w2, "sp", CAPACITY_FACTOR), dev)
        slots = torch.zeros((N_EXPERTS, cap, d), dtype=torch.float32,
                            device=dev)
        # the layer's two Alltoalls (dispatch and return), back to back
        rep.times["moe_alltoalls"] = timed(
            lambda: C.alltoall(C.alltoall(slots, "sp", 0, 0), "sp", 0, 0),
            dev)
    return {"dropped": dropped, "counts": counts, "capacity": cap,
            "tokens": tokens, "alltoall_bytes": slots.nbytes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="narrow widths (a CPU run)")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    w = WIDTHS["tiny" if ns.tiny else "full"]
    world = mpi.Init()
    r, n = world.rank, world.size
    if n != 4:
        raise SystemExit("context_parallel.py needs 4 ranks")
    dev = device_plane.device()
    # the float32 products in full float32 (the f32 pass's tolerance)
    torch.backends.cuda.matmul.allow_tf32 = False
    sp = make_mesh(("sp",), (n,))
    mesh2 = make_mesh(("dp", "sp"), (2, 2))
    rep = Report(r)
    part_launches = {}
    s = pvar.session()
    K.reset_launches()
    for name, part in (
            ("collectives", lambda: collectives_part(world, sp, mesh2, w,
                                                     dev, rep)),
            ("attention", lambda: attention_part(world, sp, w, dev, rep)),
            ("moe", lambda: moe_part(world, sp, w, dev, rep))):
        before = {k.__name__: k.launches for k in PATH_KERNELS}
        got = part()
        part_launches[name] = {k.__name__: k.launches - before[k.__name__]
                               for k in PATH_KERNELS}
        if name == "moe":
            moe_stats = got
    launches = {k.__name__: k.launches for k in PATH_KERNELS}
    staged = s.read("coll_accelerator_staged")
    p2p = {k: s.read(k) for k in ("accel_p2p_send", "accel_p2p_recv")}
    if r == 0:
        card = f"n={n} {dev}"
        for key, val in rep.times.items():
            if isinstance(val, tuple):
                print(f"[context_parallel {card}] {key} p50 {val[0]:.3f} ms "
                      f"of {[round(v, 3) for v in val[1]]}", flush=True)
        print(f"[context_parallel {card}] moe dropped {moe_stats['dropped']}"
              f" of {moe_stats['tokens']} tokens (capacity "
              f"{moe_stats['capacity']} a expert), per-expert counts "
              f"{moe_stats['counts']}; launches per part {part_launches}",
              flush=True)
    bad = [c for c in rep.cases if not c["ok"]]
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as fh:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "cases": rep.cases, "times": rep.times,
                       "moe": moe_stats, "launches": launches,
                       "part_launches": part_launches,
                       "required": [k.__name__ for k in PATH_KERNELS],
                       "coll_accelerator_staged": staged, **p2p}, fh)
    mpi.Finalize()
    if bad:
        return 1
    if staged or any(p2p.values()):
        print(f"rank {r}: staged {staged}, p2p {p2p}", flush=True)
        return 1
    if dev.type == "cuda":
        need = {"collectives": ("ring_rs_hop", "ring_ag_hop", "linear_fold"),
                "attention": ("ring_ag_hop",), "moe": ("ring_ag_hop",)}
        missing = [(p, k) for p, ks in need.items() for k in ks
                   if part_launches[p][k] <= 0]
        if missing:
            print(f"rank {r}: kernels never launched {missing}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
