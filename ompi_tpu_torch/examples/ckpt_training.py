"""ZeRO stage-2 training at GPT-2-small width, snapshotted from the card
while the next step runs, killed mid-write and resumed bitwise.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on ompi_tpu_torch/examples/ckpt_training.py \\
        --phase full --out DIR

(add ``--mca device_plane_platform cpu`` and ``--tiny`` to rehearse on
the CPU). The parameters have GPT-2 small's exact shapes, seeded
(``zero_training.gpt2_spec``: 124,439,808 float32 parameters); the
gradients of training step s are seeded from (seed, rank, s) as in
``zero_training.py``. The optimizer is ``ZeroOptimizer`` stage 2 with
momentum under ``deterministic='linear'`` (a K3 fold per bucket for the
reduce-scatter, n K2 copies per bucket for the allgather), so a resumed
run folds in the same order as an unbroken one.

Steps are numbered 1..``--steps`` (8). After every odd step s the rank
begins snapshot epoch (s + 1) / 2 with :class:`~ompi_tpu_torch.io.
async_ckpt.AsyncCheckpointer`: the step's gathered parameters (the
checkpointer keeps this rank's ZeroPlan shard of them) and the momentum
shard of every bucket as parts (``momentum.<b>``); the drain runs while
step s + 1 trains, and the epoch is committed after it. Epoch e thus
holds the state after step 2e - 1. Phases (``--phase``):

- ``full``: every epoch, each step timed (a snapshot in flight during
  the even steps, none during the odd ones); after the last commit the
  newest epoch's restore must equal, bitwise, the parameter and momentum
  shards of the step it was taken at (clones held on the card since
  then); prints each epoch's copy and drain times, its staged bytes and
  rate, the commit's write time and the restore time; records the final
  parameters' sha256.
- ``crash``: epochs 1 and 2 commit; epoch 3's commit is armed with
  ``ckpt_inject_kill_chunk 0`` and ``ckpt_inject_kill_rank -1``, so every
  rank SIGKILLs itself once its first chunk of epoch 3 is on disk: the
  job must exit non-zero and leave no manifest 3. Each rank writes its
  record just before that commit.
- ``restore``: restores the newest epoch of ``--ckpt`` (the crash run's:
  epoch 2, the state after step 3), rebuilds the optimizer on the
  device (parameters from the restored tree, the momentum state from the
  restored parts) and trains steps 4..``--steps``; the final digest must
  equal the full run's.

Each rank checks its K2 / K3 launches over the phase against the counts
the schedule implies (a K3 per bucket and n K2 per bucket a step) and
writes ``--out``/rank<r>.json (cases, launches, expected launches,
``coll_accelerator_staged``, the report). The checkpoint directory is
``--ckpt`` (default ``--out``/ckpt).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import io as io_mod
from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.examples import kernel_counts as kc
from ompi_tpu_torch.examples import zero_training as zt
from ompi_tpu_torch.io.async_ckpt import AsyncCheckpointer
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import ZeroOptimizer, layout as zl

LR, MOMENTUM = zt.LR, zt.MOMENTUM
#: the phase whose checkpoint the kill interrupts, and the epoch it dies in
KILL_EPOCH = 3
RESUME_EPOCH = 2


def epoch_after(step: int) -> int:
    """The snapshot epoch begun after odd step ``step``."""
    return (step + 1) // 2


def step_of_epoch(epoch: int) -> int:
    return 2 * epoch - 1


def momentum_parts(opt) -> dict:
    return {f"momentum.{b:03d}": s for b, s in
            enumerate(opt.state.slots["momentum"].shards)}


def tree_digest(tree) -> str:
    """sha256 over the leaves' bytes in flatten order (each crossing with
    one D2H into pinned staging)."""
    h = hashlib.sha256()
    for leaf in zl.tree_leaves(tree):
        h.update(np.ascontiguousarray(io_mod.host_array(leaf)).data)
    return h.hexdigest()


def _host_bytes(t) -> bytes:
    return np.ascontiguousarray(io_mod.host_array(t)).tobytes()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("full", "crash", "restore"),
                    default="full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=zt.GPT2["n_layer"])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink every width (CPU rehearsal)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default="",
                    help="the checkpoint directory (default OUT/ckpt)")
    ns = ap.parse_args(argv)
    cfg = zt.TINY if ns.tiny else zt.GPT2
    ckdir = ns.ckpt or os.path.join(ns.out, "ckpt")

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    spec = zt.gpt2_spec(cfg, ns.layers)
    shapes = zl.tree_leaves(spec)
    treedef = zl.tree_flatten(spec)[1]
    counts = kc.Counts(dev)
    cases = []
    report = {"phase": ns.phase,
              "parameters": sum(int(np.prod(s)) for s in shapes)}
    staged0 = pvar.read("coll_accelerator_staged")

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[ckpt_training n={n} {ns.phase}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def grads_for(step):
        return zl.tree_unflatten(treedef, [
            zt.grad_leaf(shapes, dev, ns.seed, r, step, i)
            for i in range(len(shapes))])

    def timed(fn):
        comm.Barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def optimizer(params):
        return ZeroOptimizer(comm, params, lr=LR, momentum=MOMENTUM,
                             stage=2, deterministic="linear")

    def write(expected_steps):
        nb = len(opt.state.params.plan.buckets)
        expected = {"ring_rs_hop": 0,
                    "ring_ag_hop": expected_steps * nb * n if n > 1 else 0,
                    "linear_fold": expected_steps * nb if n > 1 else 0}
        launches = counts.read()
        case("K2 / K3 launches as the schedule implies",
             launches == expected, got=launches, want=expected)
        doc = {"rank": r, "size": n, "device": str(dev), "cases": cases,
               "launches": launches, "expected_launches": expected,
               "required": [k for k, v in expected.items() if v],
               "coll_accelerator_staged":
                   pvar.read("coll_accelerator_staged") - staged0,
               "buckets": nb, "report": report}
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())

    ck = AsyncCheckpointer(ckdir, comm=comm)
    if ns.phase == "restore":
        t0 = time.perf_counter()
        tree, epoch, parts = ck.restore()
        restore_ms = (time.perf_counter() - t0) * 1e3
        case(f"restored the newest epoch {epoch} (the crash run's "
             f"{RESUME_EPOCH})", epoch == RESUME_EPOCH, epoch=epoch)
        params = zl.tree_unflatten(treedef, [
            torch.as_tensor(np.asarray(leaf)).to(dev)
            for leaf in zl.tree_leaves(tree)])
        del tree
        opt = optimizer(params)
        mom = opt.state.slots["momentum"]
        shards = []
        for b, k in enumerate(mom.plan.shard_elems):
            flat = parts[f"momentum.{b:03d}"]
            shards.append(torch.as_tensor(flat[r * k:(r + 1) * k]).to(dev))
        # elastic.ElasticContext.from_checkpoint rebuilds host-state
        # contexts; this optimizer's state lives on the card, so its
        # momentum slot is rebuilt from the restored parts here (the
        # ingest-gated form of this restore is streaming_ingest.py)
        opt.state.slots["momentum"] = zl.ShardedState(
            mom.plan, mom.metas, mom.treedef, shards, mom.rank, mom.n)
        first = step_of_epoch(epoch) + 1
        counts.reset()
        out = None
        for step in range(first, ns.steps + 1):
            grads = grads_for(step)
            out, _ = timed(lambda: opt.step(grads))
            del grads
        steps_run = ns.steps - first + 1
        report.update(resumed_from=epoch, first_step=first,
                      restore_ms=restore_ms)
        if r == 0:
            report["digest"] = tree_digest(out)
            print(f"[ckpt_training n={n} restore] epoch {epoch} restored in "
                  f"{restore_ms:.1f} ms (rank 0), steps {first}..{ns.steps}, "
                  f"final digest {report['digest']}", flush=True)
        write(steps_run)
        return 0 if all(c["ok"] for c in cases) else 1

    params = zt.make_tree(spec, dev, 0.02, ns.seed, 0)
    opt = optimizer(params)
    del params
    last = ns.steps if ns.phase == "full" else step_of_epoch(KILL_EPOCH) + 1
    counts.reset()
    snap, held = None, None
    quiet, busy, epochs = [], [], []
    out = None
    for step in range(1, last + 1):
        grads = grads_for(step)
        out, ms = timed(lambda: opt.step(grads))
        del grads
        (busy if snap is not None else quiet).append(ms)
        if snap is None:
            epoch = epoch_after(step)
            if ns.phase == "full" and step + 1 >= ns.steps:
                # the last epoch is held against its restore: clones of
                # the shards the snapshot reads, taken on the stream that
                # produced them
                held = ([s.clone() for s in opt.state.params.shards],
                        [s.clone() for s in
                         opt.state.slots["momentum"].shards])
            snap = ck.begin(out, epoch, parts=momentum_parts(opt))
            continue
        if ns.phase == "crash" and snap.step == KILL_EPOCH:
            write(last)
            cvar.set("ckpt_inject_kill_rank", -1)
            cvar.set("ckpt_inject_kill_chunk", 0)
            ck.commit(snap)
            print(f"[ckpt_training rank {r}] the kill did not fire",
                  flush=True)
            return 3
        w0 = pvar.read("ckpt_write_ns")
        t0 = time.perf_counter()
        ck.commit(snap)
        commit_ms = (time.perf_counter() - t0) * 1e3
        epochs.append({
            "epoch": snap.step, "staged_bytes": snap.staged_bytes,
            "copy_ms": snap.copy_ms, "drain_ms": snap.drain_ns / 1e6,
            "commit_ms": commit_ms,
            "write_ms": (pvar.read("ckpt_write_ns") - w0) / 1e6,
            "copy_gbps": (snap.staged_bytes / snap.copy_ms / 1e6
                          if snap.copy_ms else None)})
        snap = None
    if ns.phase == "crash":
        case("the kill fired before the crash run's last step", False)
        write(last)
        return 1
    report.update(quiet_ms=quiet, busy_ms=busy,
                  quiet_p50_ms=sorted(quiet)[len(quiet) // 2],
                  busy_p50_ms=sorted(busy)[len(busy) // 2],
                  epochs=epochs)
    # the newest epoch against the state it was taken from
    t0 = time.perf_counter()
    tree, epoch, parts = ck.restore()
    report["restore_ms"] = (time.perf_counter() - t0) * 1e3
    want = epoch_after(ns.steps - 1)
    pshards, mshards = held
    plan = opt.state.params.plan
    leaves = zl.tree_leaves(tree)
    ok_p, ok_m = True, True
    for b, idxs in enumerate(plan.buckets):
        k = plan.shard_elems[b]
        flat = zl.pack([np.asarray(leaves[i]) for i in idxs],
                       list(range(len(idxs))), plan.padded[b] - plan.elems[b])
        ok_p &= flat[r * k:(r + 1) * k].tobytes() == _host_bytes(pshards[b])
        part = parts[f"momentum.{b:03d}"]
        ok_m &= part[r * k:(r + 1) * k].tobytes() == _host_bytes(mshards[b])
    case(f"restore of epoch {epoch} == its parameter shards, bitwise",
         epoch == want and ok_p, epoch=epoch, want=want)
    case(f"restore of epoch {epoch} == its momentum shards, bitwise", ok_m)
    del tree, leaves, parts, held
    if r == 0:
        report["digest"] = tree_digest(out)
    report["ckpt_d2h_ns"] = pvar.read("ckpt_d2h_ns")
    report["ckpt_bytes"] = pvar.read("ckpt_bytes")
    report["ckpt_write_ns"] = pvar.read("ckpt_write_ns")
    if r == 0:
        e = epochs[-1]
        print(f"[ckpt_training n={n} full] step p50 quiet "
              f"{report['quiet_p50_ms']:.3f} ms {quiet}, with a snapshot in "
              f"flight {report['busy_p50_ms']:.3f} ms {busy}; epoch "
              f"{e['epoch']}: {e['staged_bytes']} B staged, copy "
              f"{e['copy_ms']} ms, drain {e['drain_ms']:.1f} ms, commit "
              f"{e['commit_ms']:.1f} ms (write {e['write_ms']:.1f} ms); "
              f"restore {report['restore_ms']:.1f} ms; final digest "
              f"{report['digest']}", flush=True)
    write(ns.steps)
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    raise SystemExit(main())
