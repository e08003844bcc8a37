"""coll/hier's two-level collectives, checked against the flat schedules
and timed: the hierarchy slice's main path.

Run under the launcher on a 2 x 2 grid::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on --mca coll_hier on --mca coll_hier_split 2x2 \\
        --mca coll_hier_inner ring ompi_tpu_torch/examples/hier_collectives.py

coll/hier (priority 70) splits the comm into ``low`` (the ranks of a slice)
and ``up`` (one rank of each slice) and runs each collective as per-level
phases; ``coll_hier_force flat`` hands the same call one level down, to
coll/cuda (or coll/device for the slots coll/cuda does not serve), which
is how the flat side of every comparison runs in the same job. Each rank
makes its inputs on its device from ``--seed`` and its rank.

- Allreduce float32 SUM at each of ``--sizes`` (64 KiB, 1 MiB, 16 MiB and
  256 MiB), and bfloat16 at ``--bf16-bytes``: the split-level schedule
  (ICI ring reduce-scatter, DCN allreduce of the half, ICI ring
  allgather) and the flat coll/cuda schedule in turns, one warm and
  ``--reps`` timed calls of each; the split-level result within
  ``TOL[dtype] x n x max|x|`` of a float64 sum of every rank's input,
  and 'linear' (the rank-order fold of the DCN-then-ICI gathered stack,
  K3) bitwise the flat 'linear' (K3) at every size;
- Reduce_scatter_block 'linear', Allgather, Bcast from root 3 and
  Alltoall at ``--other-bytes`` (64 MiB), each bitwise the flat slot's;
- ``allreduce_multi_dev`` 'linear' over GPT-2 small's 148 parameter
  leaves (124,439,808 float32; ``zero_training.gpt2_spec``), bitwise the
  flat fused form;
- ``allreduce_init_dev`` started 3 times, each bitwise the blocking
  call's;
- the pvars: ``hier_ici_bytes`` and ``hier_dcn_bytes`` equal
  ``monitoring.algo.hier_level_bytes`` for every call, and
  ``deterministic='ring'`` falls through (``hier_fallthrough``).

Each part's K1-K3 counts are zeroed just before it and read just after,
and must equal what the part's schedules imply (:func:`expected`); K1 and
K2 must launch, and K3 in the 'linear' calls. ``--tiny`` runs the JAX
package's example sizes (a CPU rehearsal with ``--mca
device_plane_platform cpu``). With ``--out DIR`` each rank writes
``DIR/rank<r>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.examples import kernel_counts as KC
from ompi_tpu_torch.examples.zero_training import (GPT2, TINY, _gen,
                                                   bits_equal, gpt2_spec,
                                                   make_tree)
from ompi_tpu_torch.monitoring import algo
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import layout as zl

#: the split-level result against a float64 sum: |err| <= TOL x n x max|x|
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def nbytes_of(s: str) -> int:
    s = s.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(s[-1:], 1)
    return int(s[:-1] if s[-1:] in "kmg" else s) * mult


def expected(kind: str, n_dcn: int, n_ici: int, inner: str = "ring",
             flat_algo: str = "ring", buckets: int = 1) -> dict:
    """K1-K3 launches one rank makes for one call (``kind``): the
    two-level schedules over ``low`` (n_ici ranks) and ``up`` (n_dcn)
    and the flat ones over n = n_dcn x n_ici."""
    n = n_dcn * n_ici
    bi = inner == "bidir"
    if kind == "hier_allreduce":  # ICI rs, DCN ring allreduce, ICI ag
        h = KC.ring_hops(n_ici, bi)
        return KC.merged(KC.add({}, K1=h, K2=h), KC.ring_allreduce(n_dcn))
    if kind == "hier_linear":  # two gathers + fold
        return KC.add({}, K2=n_dcn + n_ici, K3=1)
    if kind == "hier_multi_linear":
        return KC.add({}, K2=(n_dcn + n_ici) * buckets, K3=buckets)
    if kind == "hier_allgather":
        return KC.add({}, K2=n_dcn + n_ici)
    if kind == "hier_bcast":  # one pull per level
        return KC.add({}, K2=2)
    if kind == "hier_alltoall":  # one all-to-all pull per level
        return KC.add({}, K2=n_dcn + n_ici)
    if kind == "flat_allreduce":  # coll/cuda's ring or bidir
        return KC.ring_allreduce(n, flat_algo == "bidir")
    if kind == "flat_linear":
        return KC.add({}, K3=1)
    if kind == "flat_multi_linear":  # coll/device, one fold a bucket
        return KC.add({}, K3=buckets)
    if kind == "flat_allgather":  # coll/cuda's ring or bidir
        return KC.add({}, K2=KC.ring_hops(n, flat_algo == "bidir"))
    if kind == "flat_bcast":  # coll/device's pull
        return KC.add({}, K2=1)
    if kind == "flat_alltoall":
        return KC.add({}, K2=n)
    raise ValueError(kind)


def flat_algo(nbytes: int, chunk: int) -> str:
    """coll/cuda's built-in choice with no deterministic mode: bidir at
    or above coll_cuda_bidir_min_bytes (when a chunk holds two rows)."""
    bmin = cvar.get("coll_cuda_bidir_min_bytes")
    return "bidir" if 0 <= bmin <= nbytes and chunk >= 2 else "ring"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sizes", default="64k,1m,16m,256m")
    ap.add_argument("--bf16-bytes", default="16m")
    ap.add_argument("--other-bytes", default="64m")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="the JAX package's example sizes (CPU rehearsal)")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if ns.tiny:
        ns.sizes, ns.bf16_bytes, ns.other_bytes = "4k,16k", "4k", "16k"
        ns.reps = 2

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    for slot in ("allreduce_dev", "reduce_scatter_block_dev",
                 "allgather_dev", "bcast_dev", "alltoall_dev",
                 "allreduce_multi_dev", "allreduce_init_dev",
                 "allreduce_multi_init_dev"):
        assert comm.coll.providers[slot] == "hier", (slot, comm.coll.providers)
    inner = cvar.get("coll_hier_inner")
    counts = KC.Counts(dev)
    cases, parts, times = [], {}, {}

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[hier_collectives n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        comm.Barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def flat(fn):
        cvar.set("coll_hier_force", "flat")
        try:
            return fn()
        finally:
            cvar.set("coll_hier_force", "")

    def part(name, fn):
        """Run a part with the counts zeroed just before it and read just
        after; ``fn`` returns the counts its calls imply."""
        comm.Barrier()
        counts.reset()
        want = fn()
        sync()
        got = counts.read()
        want = {k: want.get(k, 0) for k in KC.NAMES}
        parts[name] = {"got": got, "want": want}
        case(f"{name}: K1-K3 launches as derived", got == want, got=got,
             want=want)

    # the first collective builds the plan (the low and up splits)
    comm.coll.allreduce_dev(comm, torch.zeros(4 * n, device=dev))
    plan = comm._coll_hier_plan
    nd, ni = plan.n_dcn, plan.n_ici

    def inputs(m, dtype, rank):
        return torch.randn(m, generator=_gen(dev, ns.seed, 1, m, rank),
                           device=dev).to(dtype)

    def float64_sum(m, dtype):
        acc = torch.zeros(m, dtype=torch.float64, device=dev)
        mx = 0.0
        for q in range(n):
            x = inputs(m, dtype, q)
            acc += x.double()
            mx = max(mx, float(x.abs().max()))
            del x
        return acc, mx

    # -- Allreduce: split-level vs flat, 'linear' vs flat 'linear' ---------
    def allreduce_part():
        want = {}
        sizes = [(nbytes_of(s), torch.float32) for s in ns.sizes.split(",")]
        sizes.append((nbytes_of(ns.bf16_bytes), torch.bfloat16))
        for nb, dtype in sizes:
            m = nb // dtype.itemsize
            x = inputs(m, dtype, r)
            label = f"{nb} B {str(dtype)[6:]}"
            fa = flat_algo(nb, -(-m // n))
            th, tf = [], []
            for rep in range(ns.reps + 1):  # 1 warm, then timed, in turns
                s = pvar.session()
                got, ms = timed(lambda: comm.coll.allreduce_dev(comm, x))
                ib, db = algo.hier_level_bytes("allreduce", nd, ni, nb)
                if rep == 0:
                    case(f"allreduce {label} per-level bytes",
                         s.read("hier_ici_bytes") == int(ib)
                         and s.read("hier_dcn_bytes") == int(db)
                         and s.read("hier_launches") == 1,
                         ici=s.read("hier_ici_bytes"),
                         dcn=s.read("hier_dcn_bytes"))
                else:
                    th.append(ms)
                del got
                _, ms = timed(lambda: flat(
                    lambda: comm.coll.allreduce_dev(comm, x)))
                if rep:
                    tf.append(ms)
                for k, v in KC.merged(
                        expected("hier_allreduce", nd, ni, inner),
                        expected("flat_allreduce", nd, ni,
                                 flat_algo=fa)).items():
                    want[k] = want.get(k, 0) + v
            got = comm.coll.allreduce_dev(comm, x)
            ref, mx = float64_sum(m, dtype)
            err = float((got.double() - ref).abs().max())
            case(f"allreduce {label} split-level vs float64 sum",
                 err <= TOL[dtype] * n * mx, err=err,
                 bound=TOL[dtype] * n * mx)
            del ref, got
            hl = comm.coll.allreduce_dev(comm, x, deterministic="linear")
            fl = flat(lambda: comm.coll.allreduce_dev(
                comm, x, deterministic="linear"))
            case(f"allreduce {label} 'linear' == flat 'linear'",
                 bits_equal(hl, fl))
            del hl, fl, x
            for k, v in KC.merged(
                    expected("hier_allreduce", nd, ni, inner),
                    expected("hier_linear", nd, ni),
                    expected("flat_linear", nd, ni)).items():
                want[k] = want.get(k, 0) + v
            times[label] = {"hier": th, "flat": tf,
                            "hier_p50": sorted(th)[len(th) // 2],
                            "flat_p50": sorted(tf)[len(tf) // 2],
                            "flat_algo": fa,
                            "ici_bytes": int(algo.hier_level_bytes(
                                "allreduce", nd, ni, nb)[0]),
                            "dcn_bytes": int(algo.hier_level_bytes(
                                "allreduce", nd, ni, nb)[1])}
            if r == 0:
                print(f"[hier_collectives n={n}] allreduce {label}: "
                      f"hier p50 {times[label]['hier_p50']:.3f} ms, flat "
                      f"({fa}) p50 {times[label]['flat_p50']:.3f} ms",
                      flush=True)
        return want

    part("allreduce", allreduce_part)

    # -- the other slots at --other-bytes, bitwise the flat slots ----------
    def others_part():
        want: dict = {}
        nb = nbytes_of(ns.other_bytes)
        m = nb // 4
        x = inputs(m, torch.float32, r).reshape(n, -1)
        s = pvar.session()
        hr = comm.coll.reduce_scatter_block_dev(comm, x,
                                                deterministic="linear")
        fr = flat(lambda: comm.coll.reduce_scatter_block_dev(
            comm, x, deterministic="linear"))
        ib, db = algo.hier_level_bytes("reduce_scatter_block", nd, ni, nb,
                                       linear=True)
        case(f"reduce_scatter_block {nb} B 'linear' == flat",
             bits_equal(hr, fr) and s.read("hier_ici_bytes") == int(ib)
             and s.read("hier_dcn_bytes") == int(db))
        want = KC.merged(want, expected("hier_linear", nd, ni),
                         expected("flat_linear", nd, ni))
        del hr, fr
        blk = x[0]  # this rank's block of nb / n bytes
        s = pvar.session()
        hg = comm.coll.allgather_dev(comm, blk)
        fg = flat(lambda: comm.coll.allgather_dev(comm, blk))
        ib, db = algo.hier_level_bytes("allgather", nd, ni, blk.nbytes)
        case(f"allgather {blk.nbytes} B a rank == flat",
             bits_equal(hg, fg) and hg.shape == (n,) + tuple(blk.shape)
             and s.read("hier_ici_bytes") == int(ib)
             and s.read("hier_dcn_bytes") == int(db))
        want = KC.merged(want, expected("hier_allgather", nd, ni),
                         expected("flat_allgather", nd, ni, flat_algo=
                                  flat_algo(blk.nbytes, blk.numel())))
        del hg, fg
        flatx = x.reshape(-1)
        s = pvar.session()
        hb = comm.coll.bcast_dev(comm, flatx, 3 % n)
        fb = flat(lambda: comm.coll.bcast_dev(comm, flatx, 3 % n))
        ib, db = algo.hier_level_bytes("bcast", nd, ni, nb)
        case(f"bcast {nb} B from root {3 % n} == flat",
             bits_equal(hb, fb) and bits_equal(hb, inputs(m, torch.float32,
                                                          3 % n))
             and s.read("hier_ici_bytes") == int(ib)
             and s.read("hier_dcn_bytes") == int(db))
        want = KC.merged(want, expected("hier_bcast", nd, ni),
                         expected("flat_bcast", nd, ni))
        del hb, fb
        s = pvar.session()
        ha = comm.coll.alltoall_dev(comm, flatx)
        fa = flat(lambda: comm.coll.alltoall_dev(comm, flatx))
        ib, db = algo.hier_level_bytes("alltoall", nd, ni, nb)
        case(f"alltoall {nb} B == flat",
             bits_equal(ha, fa) and s.read("hier_ici_bytes") == int(ib)
             and s.read("hier_dcn_bytes") == int(db))
        want = KC.merged(want, expected("hier_alltoall", nd, ni),
                         expected("flat_alltoall", nd, ni))
        del ha, fa, x, flatx, blk
        # 'ring' falls through to coll/cuda's ring, counted
        y = inputs(4096, torch.float32, r)
        s = pvar.session()
        comm.coll.allreduce_dev(comm, y, deterministic="ring")
        case("deterministic='ring' falls through",
             s.read("hier_fallthrough") == 1 and s.read("hier_launches") == 0)
        want = KC.merged(want, expected("flat_allreduce", nd, ni))
        return want

    part("others", others_part)

    # -- the fused multi form over GPT-2 small's leaves --------------------
    def multi_part():
        spec = gpt2_spec(TINY if ns.tiny else GPT2,
                         (TINY if ns.tiny else GPT2)["n_layer"])
        grads = make_tree(spec, dev, 0.01, ns.seed, 7, r)
        leaves = zl.tree_leaves(grads)
        fplan = zl._FusePlan(zl._fuse_metas(leaves),
                             int(cvar.get("coll_device_bucket_bytes")))
        s = pvar.session()
        hm, ms_h = timed(lambda: comm.coll.allreduce_multi_dev(
            comm, grads, deterministic="linear"))
        fm, ms_f = timed(lambda: flat(lambda: comm.coll.allreduce_multi_dev(
            comm, grads, deterministic="linear")))
        nb = sum(t.nbytes for t in leaves)
        ib, db = algo.hier_level_bytes("allreduce_multi", nd, ni, nb,
                                       linear=True)
        case(f"allreduce_multi 'linear' {len(leaves)} leaves "
             f"({sum(t.numel() for t in leaves)} float32) == flat fused",
             all(bits_equal(a, b) for a, b in
                 zip(zl.tree_leaves(hm), zl.tree_leaves(fm)))
             and s.read("hier_fused_launches") == len(fplan.buckets)
             and s.read("hier_ici_bytes") == int(ib)
             and s.read("hier_dcn_bytes") == int(db),
             buckets=len(fplan.buckets), hier_ms=ms_h, flat_ms=ms_f)
        times["allreduce_multi"] = {"leaves": len(leaves),
                                    "elements": sum(t.numel()
                                                    for t in leaves),
                                    "buckets": len(fplan.buckets),
                                    "hier_ms": ms_h, "flat_ms": ms_f}
        del hm, fm, grads, leaves
        nbk = len(fplan.buckets)
        return KC.merged(expected("hier_multi_linear", nd, ni, buckets=nbk),
                         expected("flat_multi_linear", nd, ni, buckets=nbk))

    part("allreduce_multi", multi_part)

    # -- persistence: three starts of allreduce_init_dev -------------------
    def persistent_part():
        m = nbytes_of("1m" if not ns.tiny else "4k") // 4
        x = inputs(m, torch.float32, r)
        want: dict = {}
        for det in (None, "linear"):
            once = comm.coll.allreduce_dev(comm, x, deterministic=det)
            req = comm.coll.allreduce_init_dev(comm, x, deterministic=det)
            s = pvar.session()
            ok = True
            for _ in range(3):
                req.start()
                req.wait()
                ok = ok and bits_equal(req.array, once)
            req.free()
            case(f"allreduce_init_dev ({det or 'default'}) 3 starts == "
                 "the blocking call", ok and s.read("hier_launches") == 3)
            kind = "hier_allreduce" if det is None else "hier_linear"
            for _ in range(4):
                want = KC.merged(want, expected(kind, nd, ni, inner))
        return want

    part("persistent", persistent_part)

    arenas = {name: sum(a.nbytes for a in c.__dict__.get(
        "_coll_cuda_arenas", {}).values())
        for name, c in (("comm", comm), ("low", plan.low), ("up", plan.up))}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    total = {k: sum(p["got"][k] for p in parts.values()) for k in KC.NAMES}
    need_k3 = parts["allreduce"]["got"]["linear_fold"] > 0
    case("K1 and K2 launched; K3 in the 'linear' calls",
         total["ring_rs_hop"] > 0 and total["ring_ag_hop"] > 0 and need_k3)
    if r == 0:
        print(f"[hier_collectives n={n}] {nd}x{ni} grid, inner {inner}: "
              f"launches per part {parts}; arena bytes {arenas}",
              flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "grid": [nd, ni], "inner": inner, "cases": cases,
                       "launches": total, "parts": parts, "times": times,
                       "arena_bytes": arenas,
                       "device_plane_arena_bytes":
                           pvar.read("device_plane_arena_bytes"),
                       "peak_bytes": peak,
                       "coll_accelerator_staged":
                           pvar.read("coll_accelerator_staged")}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
