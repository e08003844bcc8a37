"""Streaming ingest — restore GPT-2 small's ZeRO state to the card through
the ingest plane and start the first step before the upload has landed.

Run under the launcher, one rank per process, on a checkpoint written by
``ckpt_training.py`` (``--phase crash`` leaves epochs 1 and 2)::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on --mca ingest_enable 1 \\
        ompi_tpu_torch/examples/streaming_ingest.py --ckpt CKPT \\
        --expect-digest HEX --out DIR

(add ``--mca device_plane_platform cpu``, ``--tiny`` and a small
``--mca ingest_chunk_bytes`` to rehearse on the CPU). Every rank restores
the newest epoch with ``AsyncCheckpointer.restore_to_device``: the whole
parameter tree (the gathered parameters, every leaf on every rank) goes
up through the ingest plane in ``ingest_chunk_bytes`` units over
``ingest_streams`` streams and ``ingest_depth`` pinned staging slots a
stream, gated on its first leaf; the first step then gates on the
leaves of the first ZeRO bucket, the ones its update touches first
(``ingest_early_starts``), and while the tail uploads the kernel
library's first-use load runs on the plane's compile lane
(``overlap_compile``) and the step's gradients are drawn on the card. Then the optimizer
(``ZeroOptimizer`` stage 2 with momentum, ``deterministic='linear'``) is
rebuilt from the uploaded tree and the restored momentum parts, and
steps ``2e``..``--steps`` train; the final digest must equal
``--expect-digest`` (the uninterrupted run's), bitwise.

Each rank checks: the plane is up (a bring-up failure would make the
restore the identity), every restored leaf lies on the rank's device,
``ingest_bytes`` equals the plan's bytes, the K2 / K3 launches over the
steps equal what the schedule implies (a K3 per bucket and n K2 per
bucket a step; zeroed just before the steps, read just after), and, on
the card, that the gate released before the upload's tail. It writes
``--out``/rank<r>.json with the upload's wall, its rate and the gate's
release time.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.examples import ckpt_training as ct
from ompi_tpu_torch.examples import kernel_counts as kc
from ompi_tpu_torch.examples import zero_training as zt
from ompi_tpu_torch.ingest import engine as ingest_engine
from ompi_tpu_torch.io.async_ckpt import AsyncCheckpointer
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import ZeroOptimizer, layout as zl


def load_kernels(dev) -> str:
    """The port's compile: the first-use build and load of the ring
    kernels' library that the step launches (nothing on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    from ompi_tpu_torch.coll import cuda_kernels as K

    K.lib()
    return "ring_kernels"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--expect-digest", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=zt.GPT2["n_layer"])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink every width (CPU rehearsal)")
    ap.add_argument("--out", required=True)
    ns = ap.parse_args(argv)
    cfg = zt.TINY if ns.tiny else zt.GPT2

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    spec = zt.gpt2_spec(cfg, ns.layers)
    shapes = zl.tree_leaves(spec)
    treedef = zl.tree_flatten(spec)[1]
    counts = kc.Counts(dev)
    cases = []
    report = {"parameters": sum(int(np.prod(s)) for s in shapes)}
    staged0 = pvar.read("coll_accelerator_staged")
    eng = ingest_engine.INGEST

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[streaming_ingest n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    case("the ingest plane is up (ingest_enable)", eng is not None)
    if eng is None:
        return 1
    report.update(streams=eng.n_streams, chunk_bytes=eng.chunk_bytes,
                  depth=eng.depth)
    early0 = pvar.read("ingest_early_starts")
    bytes0 = pvar.read("ingest_bytes")
    comm.Barrier()
    ck = AsyncCheckpointer(ns.ckpt, comm=comm)
    t0 = time.perf_counter()
    req, epoch, parts = ck.restore_to_device()
    report["restore_to_device_ms"] = (time.perf_counter() - t0) * 1e3
    # restore_to_device returned on its gate of the first leaf; the first
    # step's update touches the first bucket's leaves first: gate on them
    gate0_ns = time.monotonic_ns() - req.started_ns
    case("restore_to_device returned a gated upload",
         isinstance(req, ingest_engine.IngestRequest), got=type(req).__name__)
    report["upload_units"] = req.n_units
    report["upload_bytes"] = req.plan.total_bytes
    plan0 = zl.plan_for(req.plan.leaves, n)
    req.gate(list(plan0.buckets[0]))
    gate_ns = time.monotonic_ns() - req.started_ns
    tail_left = req.n_units - sum(1 for i in range(req.n_units)
                                  if req.unit_done_ns(i))
    # while the tail uploads: the kernel library's first-use load on the
    # plane's compile lane, and the first step's gradients on the card
    job = eng.overlap_compile(load_kernels, dev)
    first = ct.step_of_epoch(epoch) + 1
    grads = zl.tree_unflatten(treedef, [
        zt.grad_leaf(shapes, dev, ns.seed, r, first, i)
        for i in range(len(shapes))])
    report["compile"] = job.wait(600)
    params = req.tree()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    upload_ns = max(req.unit_done_ns(i) for i in range(req.n_units)) \
        - req.started_ns
    report.update(gate_leaf0_ms=gate0_ns / 1e6, gate_ms=gate_ns / 1e6,
                  upload_ms=upload_ns / 1e6,
                  gbps=req.plan.total_bytes / upload_ns,
                  tail_units_at_gate=tail_left,
                  compile_overlaps=pvar.read("ingest_compile_overlaps"),
                  inflight_hwm=req.inflight_hwm)
    leaves = zl.tree_leaves(params)
    case("every restored leaf lies on the rank's device",
         all(t.device == dev for t in leaves),
         devices=sorted({str(t.device) for t in leaves}))
    case("ingest_bytes == the plan's bytes",
         pvar.read("ingest_bytes") - bytes0 == req.plan.total_bytes,
         got=pvar.read("ingest_bytes") - bytes0, want=req.plan.total_bytes)
    early = pvar.read("ingest_early_starts") - early0
    report["early_starts"] = early
    if dev.type == "cuda":
        case("the first step's gate released before the tail landed",
             early >= 1, early_starts=early, tail_units=tail_left)
    opt = ZeroOptimizer(comm, params, lr=ct.LR, momentum=ct.MOMENTUM,
                        stage=2, deterministic="linear")
    del params, leaves
    mom = opt.state.slots["momentum"]
    shards = []
    for b, k in enumerate(mom.plan.shard_elems):
        flat = parts[f"momentum.{b:03d}"]
        shards.append(torch.as_tensor(flat[r * k:(r + 1) * k]).to(dev))
    opt.state.slots["momentum"] = zl.ShardedState(
        mom.plan, mom.metas, mom.treedef, shards, mom.rank, mom.n)
    counts.reset()
    out = None
    step_ms = []
    for step in range(first, ns.steps + 1):
        if grads is None:
            grads = zl.tree_unflatten(treedef, [
                zt.grad_leaf(shapes, dev, ns.seed, r, step, i)
                for i in range(len(shapes))])
        t1 = time.perf_counter()
        out = opt.step(grads)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        grads = None
    steps_run = ns.steps - first + 1
    launches = counts.read()
    nb = len(opt.state.params.plan.buckets)
    expected = {"ring_rs_hop": 0,
                "ring_ag_hop": steps_run * nb * n if n > 1 else 0,
                "linear_fold": steps_run * nb if n > 1 else 0}
    case("K2 / K3 launches as the schedule implies", launches == expected,
         got=launches, want=expected)
    digest = ct.tree_digest(out)
    report.update(resumed_from=epoch, first_step=first, digest=digest,
                  step_ms=step_ms)
    if ns.expect_digest:
        case("the final digest == the uninterrupted run's",
             digest == ns.expect_digest, got=digest, want=ns.expect_digest)
    if r == 0:
        print(f"[streaming_ingest n={n}] epoch {epoch}: {req.n_units} units "
              f"({req.plan.total_bytes} B) uploaded in "
              f"{report['upload_ms']:.1f} ms ({report['gbps']:.2f} GB/s a "
              f"rank); the first leaf's gate released at "
              f"{report['gate_leaf0_ms']:.1f} ms, the first bucket's at "
              f"{report['gate_ms']:.1f} ms with {tail_left} units in "
              f"flight; steps {first}..{ns.steps}, digest {digest}",
              flush=True)
    doc = {"rank": r, "size": n, "device": str(dev), "cases": cases,
           "launches": launches, "expected_launches": expected,
           "required": [k for k, v in expected.items() if v],
           "coll_accelerator_staged":
               pvar.read("coll_accelerator_staged") - staged0,
           "buckets": nb, "report": report}
    os.makedirs(ns.out, exist_ok=True)
    with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
        json.dump(doc, f)
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    raise SystemExit(main())
