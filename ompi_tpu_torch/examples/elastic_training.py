"""Elastic training — a rank killed mid-run, the survivors shrink and
re-shard in memory, a replacement joins, and the card's collectives go on
over each comm.

Run under the launcher with the ULFM plane on and the failure armed::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca ft 1 \\
        --mca device_plane on --mca coll_cuda on --mca ingest_enable 1 \\
        --mca elastic_inject_kill_step 3 --mca elastic_inject_rank 2 \\
        ompi_tpu_torch/examples/elastic_training.py --out DIR

(add ``--mca device_plane_platform cpu`` and ``--tiny`` to rehearse on
the CPU). The parameters have GPT-2 small's shapes (``--layers`` cuts the
depth), seeded host float32; ``ElasticContext`` trains them with ZeRO
stage 2 and momentum under ``deterministic='linear'`` on host state (the
reference's snapshots are host numpy, so its optimizer runs the host
bucket cycle), with ``async_checkpoint=True``. The gradient of a step is
a deterministic function of the parameters and the step, never of the
comm size, so a replay reproduces the run. In order:

1. a device Allreduce (float32 SUM, 'linear': coll/cuda's K3) of a
   seeded tensor a rank on a dup of COMM_WORLD, bitwise against the host
   linear fold of every member's tensor;
2. steps 0..2 on the 4 ranks, then an asynchronous checkpoint of step 2;
3. steps up to ``--steps``: world rank 2 SIGKILLs itself entering step 3
   (``elastic/inject``); the survivors revoke, shrink to 3, agree on the
   resume step 2, re-shard the momentum in memory from their snapshots
   and the buddy replica of rank 2's chunk, and finish;
4. a device Allreduce on the shrunken comm of 3, bitwise; then the dup of
   COMM_WORLD (which has the dead member) is freed, timed: it must not
   hang;
5. ``ElasticContext.from_checkpoint`` on the shrunken comm replays from
   step 2: its parameters and momentum shards must equal the run's,
   bitwise;
6. rank 0 spawns a replacement (``spawn_replacement``, a world rank from
   the ``ww:`` watermark) that joins at step ``--steps`` (``join_at``):
   its parameters arrive by p2p and go through the ingest plane to its
   card and back (``hot_join``), it must hold the survivors' parameters
   before its first step, and two more steps train on the 4 ranks;
7. a device Allreduce on the regrown comm of 4, joiner included, bitwise.

Every member checks its K3 launches per Allreduce (zeroed just before the
call, read just after) and writes ``--out``/rank<world rank>.json: its
cases, launches, the failures the store recorded, the recovery and free
times and the host step times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from ompi_tpu_torch import elastic, ft, mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.examples import kernel_counts as kc
from ompi_tpu_torch.examples import zero_training as zt
from ompi_tpu_torch.runtime import device_plane, rte
from ompi_tpu_torch.zero import layout as zl

LR, MOMENTUM = 0.01, 0.9
KILL_STEP = 3
#: the seeded tensor of a device Allreduce: float32 elements a rank
ALLREDUCE_ELEMS = 4 << 20
TINY_ALLREDUCE_ELEMS = 4096
#: the environment variable that carries the arguments to a joiner
ARGV_ENV = "OMPI_TPU_ELASTIC_EXAMPLE_ARGV"


def host_params(cfg, layers: int, seed: int):
    """GPT-2's parameter shapes as seeded host float32 (0.02 x normal)."""
    spec = zt.gpt2_spec(cfg, layers)
    leaves, treedef = zl.tree_flatten(spec)
    out = []
    for i, shape in enumerate(leaves):
        rng = np.random.default_rng([seed, i])
        out.append((0.02 * rng.standard_normal(tuple(shape)))
                   .astype(np.float32))
    return zl.tree_unflatten(treedef, out)


def grad_fn(p, step, c):
    """A deterministic stand-in for a backward pass: a function of the
    parameters and the step only."""
    leaves, treedef = zl.tree_flatten(p)
    g = np.float32(0.125 * (step + 1))
    return zl.tree_unflatten(treedef, [
        np.float32(0.01) * a + g for a in leaves])


def digest(tree) -> str:
    h = hashlib.sha256()
    for leaf in zl.tree_leaves(tree):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def seeded(world: int, elems: int) -> np.ndarray:
    return np.random.default_rng([7, world]).standard_normal(
        elems).astype(np.float32)


def main(argv=None) -> int:
    if argv is None and elastic.is_joiner():
        argv = json.loads(os.environ.get(ARGV_ENV, "[]"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=zt.GPT2["n_layer"])
    ap.add_argument("--steps", type=int, default=6,
                    help="steps before the join (the join is at this step)")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink every width (CPU rehearsal)")
    ap.add_argument("--out", required=True)
    ns = ap.parse_args(argv)
    cfg = zt.TINY if ns.tiny else zt.GPT2
    elems = TINY_ALLREDUCE_ELEMS if ns.tiny else ALLREDUCE_ELEMS

    comm = mpi.Init()
    joiner = elastic.is_joiner()
    dev = device_plane.device()
    counts = kc.Counts(dev)
    cases = []
    report = {"joiner": joiner}
    launches: dict = {}

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if not ok or rte.rank == 0:
            print(f"[elastic_training w{rte.rank}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def allreduce(c, what):
        """Device Allreduce 'linear' of each member's seeded tensor,
        bitwise against the host linear fold; one K3 a rank."""
        x = torch.from_numpy(seeded(rte.rank, elems)).to(dev)
        counts.reset()
        got = c.Allreduce(x, deterministic="linear")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        got_l = counts.read()
        for k, v in got_l.items():
            launches[k] = launches.get(k, 0) + v
        want = seeded(c.group.ranks[0], elems)
        for w in c.group.ranks[1:]:
            want = want + seeded(w, elems)
        host = got.cpu().numpy()
        case(f"device Allreduce 'linear' on the {what} comm of {c.size} "
             "== the host linear fold, bitwise",
             host.view(np.uint32).tobytes() == want.view(np.uint32)
             .tobytes())
        exp = {"ring_rs_hop": 0, "ring_ag_hop": 0, "linear_fold": 1}
        case(f"K3 launches of the {what} Allreduce as derived",
             got_l == exp, got=got_l, want=exp)

    ctx_times: list = []  # each host step's start

    def timed_grad(p, step, c):
        ctx_times.append(time.perf_counter())
        if step == ns.steps:
            # the first step on the regrown comm: the joiner must already
            # hold the survivors' parameters
            ds = c.allgather(digest(p))
            case("every member holds the same parameters before the "
                 "joiner's first step", len(set(ds)) == 1 and c.size == 4,
                 size=c.size)
        return grad_fn(p, step, c)

    proc = None
    if joiner:
        t0 = time.perf_counter()
        ctx, target = elastic.hot_join()
        report["join_ms"] = (time.perf_counter() - t0) * 1e3
        case("the joiner was admitted at the survivors' boundary",
             ctx.joins == 1 and target == ns.steps + 2,
             target=target)
        case("its parameters went through the ingest plane",
             pvar.read("ingest_uploads") >= 1
             and pvar.read("ingest_bytes") > 0,
             bytes=pvar.read("ingest_bytes"))
        out = ctx.run(timed_grad, target)
    else:
        params = host_params(cfg, ns.layers, ns.seed)
        report["parameters"] = sum(int(a.size)
                                   for a in zl.tree_leaves(params))
        dcomm = comm.dup()
        allreduce(dcomm, "world")
        ckdir = os.path.join(ns.out, "ckpt")
        ctx = elastic.ElasticContext(comm, params, lr=LR, momentum=MOMENTUM,
                                     checkpoint_dir=ckdir,
                                     async_checkpoint=True)
        del params
        ctx.run(timed_grad, KILL_STEP)
        ctx.save_checkpoint()
        t0 = time.perf_counter()
        out = ctx.run(timed_grad, ns.steps)
        report["run_after_kill_ms"] = (time.perf_counter() - t0) * 1e3
        report["recovery_ms"] = pvar.read("elastic_recovery_ns") / 1e6
        case("the survivors shrank to 3 and resumed at step 2 from memory",
             ctx.comm.size == comm.size - 1 and ctx.shrinks == 1
             and ctx.last_resume == KILL_STEP - 1
             and ctx.restored_from == "memory",
             size=ctx.comm.size, resume=ctx.last_resume,
             origin=ctx.restored_from)
        report["failures"] = {str(k): v for k, v in ft.faults().items()}
        allreduce(ctx.comm, "shrunken")
        t0 = time.perf_counter()
        dcomm.free()
        report["free_ms"] = (time.perf_counter() - t0) * 1e3
        case("freeing the comm with a dead member returned",
             report["free_ms"] < 30e3, ms=report["free_ms"])
        ref = elastic.ElasticContext.from_checkpoint(
            ctx.comm, ckdir, lr=LR, momentum=MOMENTUM, async_checkpoint=True)
        case("from_checkpoint restored step 2",
             ref.step_done == KILL_STEP - 1
             and ref.restored_from == "checkpoint", step=ref.step_done)
        ref_out = ref.run(grad_fn, ns.steps)
        same_p = all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
                     for a, b in zip(zl.tree_leaves(out),
                                     zl.tree_leaves(ref_out)))
        same_m = all(
            np.asarray(a).tobytes() == np.asarray(b).tobytes()
            for name, st in ctx.opt.state.slots.items()
            for a, b in zip(st.shards, ref.opt.state.slots[name].shards))
        case("the in-memory recovery == the checkpoint replay on the "
             "shrunken comm: parameters, bitwise", same_p)
        case("... and momentum shards, bitwise", same_m)
        ref.opt.free()
        del ref, ref_out
        if ctx.comm.rank == 0:
            os.environ[ARGV_ENV] = json.dumps(
                list(argv if argv is not None else sys.argv[1:]))
            proc = elastic.spawn_replacement(
                script=os.path.abspath(__file__), mca={"ft": "1"})
        t0 = time.perf_counter()
        out = ctx.run(timed_grad, ns.steps + 2, join_at=ns.steps)
        report["run_after_join_ms"] = (time.perf_counter() - t0) * 1e3
        case("the regrown comm has 4 members and one join",
             ctx.comm.size == comm.size and ctx.joins == 1,
             size=ctx.comm.size)
    report["parity_checked"] = any(
        c["name"].startswith("every member holds the same parameters "
                             "before") for c in cases)
    allreduce(ctx.comm, "regrown")
    ds = ctx.comm.allgather(digest(out))
    case("every member of the regrown comm holds the same parameters",
         len(set(ds)) == 1 and ctx.step_done == ns.steps + 1,
         step=ctx.step_done)
    report["host_step_ms"] = [(b - a) * 1e3 for a, b in
                              zip(ctx_times, ctx_times[1:])]
    if proc is not None:
        rc = proc.wait(timeout=300)
        case("the replacement exited 0", rc == 0, rc=rc)
    doc = {"rank": rte.rank, "device": str(dev), "cases": cases,
           "launches": launches, "report": report,
           "coll_accelerator_staged": pvar.read("coll_accelerator_staged")}
    os.makedirs(ns.out, exist_ok=True)
    with open(os.path.join(ns.out, f"rank{rte.rank}.json"), "w") as f:
        json.dump(doc, f)
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    raise SystemExit(main())
