"""The rank-side program of the ZeRO cells: data-parallel SGD steps with
momentum through the port's ``ZeroOptimizer``.

Run by ``benchmark/run.py`` under the port's launcher, one process per
rank, with the path of the run's spec file::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on ... benchmark/drivers/zero_step.py SPEC.json

Each rank:

1. makes the configuration's parameters and a pool of gradient sets on
   its device from the seed (:mod:`benchmark.lib.inputs`; rank r's set s
   from (seed, r, s)), in the run's dtype;
2. builds ``ZeroOptimizer(comm, params, lr, momentum, stage,
   deterministic, fused)`` as the traffic file says and runs its first
   steps with sets 0, 1, 2 (set-up; what they produced is kept for the
   check);
3. runs whole steps (step t takes set t mod the pool size), each ended
   by ``torch.cuda.synchronize()``, with Python's cyclic garbage
   collected before every step and what survives frozen, as Megatron-LM
   runs a training loop under ``--manual-gc --manual-gc-interval 1``
   (the port's ``zero/layout.tree_unflatten`` holds each step's gathered
   parameters in a reference cycle until a collection; left to the
   automatic collector, GPT-2 XL's four cards run out of memory; the
   collections' time is recorded), until rank 0 has measured
   ``seconds``; rank 0 names the last step in a shared flag file, which
   every rank reads before each step, so all run the same steps. The
   lowest rank on each card samples the card's used memory
   (``torch.cuda.mem_get_info``) after every step. With ``trace`` the
   window has three phases, each begun at a step rank 0 names in the
   flag file: the first fifth with no instrument on (its steps give
   ``step_mfu`` its time); then ``torch.profiler`` and the port's span
   recorder (the driver records a ``step`` span around each call) for
   at least ``PROF_STEPS`` steps and ``PROF_SECONDS`` (the device
   metrics and the breakdown); then the recorder alone to the end (the
   host layers' spans and counters, clear of the profiler's start and
   stop, which take seconds). ``trace_parts`` in the spec turns
   instruments off, to measure what each costs;
4. reads the momentum and the replicated parameters after the last
   step, frees the program's state (``mpi.Finalize``), runs the plain
   reference (:mod:`benchmark.reference.zero_sgd`) and writes its record
   ``rank<r>.json``. Under ``deterministic='linear'`` the reference also
   folds the ranks' gradients in rank order in float32, and the sampled
   parameters and momentum must equal it bit for bit.
"""

from __future__ import annotations

import gc
import json
import mmap
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import devtrace, inputs, model  # noqa: E402
from benchmark.reference import zero_sgd as ref  # noqa: E402
from ompi_tpu_torch import mpi  # noqa: E402
from ompi_tpu_torch.coll import cuda_kernels as K  # noqa: E402
from ompi_tpu_torch.core import pvar  # noqa: E402
from ompi_tpu_torch.runtime import device_plane, rte  # noqa: E402
from ompi_tpu_torch.trace import recorder as trace_rec  # noqa: E402
from ompi_tpu_torch.zero import ZeroOptimizer  # noqa: E402

#: the kernel wrappers whose launches a step counts (K1, K2, K3, K5, K5b)
WRAPPERS = (K.ring_rs_hop, K.ring_ag_hop, K.linear_fold,
            K.ring_rs_update_hop, K.linear_fold_update)
#: elements of the final state compared with the reference, beside the
#: first and last of every leaf
SAMPLE = 1 << 20
#: flag file slots: the last window step, the first and the end of the
#: profiled steps
LAST, PROF_START, PROF_STOP = 0, 1, 2
#: where in the window the traced run's profiler starts, and how long it
#: runs at least: seconds and steps (the last phase has as many steps)
PROF_AFTER, PROF_SECONDS, PROF_STEPS = 0.2, 2.0, 10
#: the instruments of a traced run: the span recorder, its hook on the
#: MPI API, and the profiler
TRACE_PARTS = ("spans", "api", "profiler")
FORBIDDEN = ("jax", "jaxlib", "flax", "ompi_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def launches() -> int:
    return sum(w.launches for w in WRAPPERS)


def main(spec_path: str) -> int:
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    cfg, traffic = spec["config"], spec["traffic"]
    seed, seconds, trace = int(spec["seed"]), float(spec["seconds"]), \
        bool(spec["trace"])
    parts = set(spec.get("trace_parts") or TRACE_PARTS) if trace else set()
    opt_cfg = cfg["optimizer"]
    lr, mu = float(opt_cfg["lr"]), float(opt_cfg["momentum"])
    dtype = getattr(torch, cfg["control_dtype"] if spec.get("control")
                    else cfg["dtype"])
    pool_n = int(traffic["grad_sets"])
    warm = int(traffic["warmup_steps"])
    if spec.get("fault"):
        from benchmark.tests import faults
        faults.plant(spec["fault"])

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    spec_leaves = model.leaves(cfg)
    names = [nm for nm, _ in spec_leaves]
    offs = model.offsets(spec_leaves)
    count = offs[-1]

    def tree_of(flat):
        return model.tree(names, [flat[a:b].view(shape) for (a, b, (_, shape))
                                  in zip(offs[:-1], offs[1:], spec_leaves)])

    # -- inputs, made on the device from the seed -------------------------
    p0 = inputs.params_flat(count, dev, seed)
    pool = [inputs.grads_flat(count, dev, seed, r, s).to(dtype)
            for s in range(pool_n)]
    grads = [tree_of(g) for g in pool]
    opt = ZeroOptimizer(comm, tree_of(p0.to(dtype)), lr=lr, momentum=mu,
                        stage=int(traffic["stage"]),
                        deterministic=traffic["deterministic"],
                        fused=bool(traffic["fused"]))

    # -- the first steps: set-up, kept for the check ----------------------
    out = opt.step(grads[0])
    mom = comm.Allgather_multi(opt.state.slots["momentum"])
    v1 = [float(x.double().square().sum())
          for x in model.by_name(mom, names)]
    del mom
    for t in range(1, warm):
        out = None
        gc.collect()
        out = opt.step(grads[t % pool_n])
    d3 = [float((x.float().reshape(-1) - p0[a:b]).double().square().sum())
          for x, a, b in zip(model.by_name(out, names), offs[:-1], offs[1:])]
    idx = inputs.sample_index(offs, dev, seed, SAMPLE)
    del p0
    gc.collect()
    gc.freeze()
    gc.disable()
    sync()

    # -- the window ---------------------------------------------------------
    fd = os.open(spec["flags"], os.O_RDWR)
    fmap = mmap.mmap(fd, 64)
    os.close(fd)
    flags = np.frombuffer(fmap, dtype=np.int64)
    sampler = on_card and rte.local_rank < torch.cuda.device_count()
    mem = []
    rec = None
    dtr = devtrace.DeviceTrace(os.path.join(spec["out"], f"prof{r}.json"),
                               dev) if "profiler" in parts and on_card \
        else None
    prof_span, dev_trace, after = None, None, None
    if dtr is not None:
        dtr.warm()
    l0, w0 = launches(), pvar.read("device_plane_wait_ns")
    reserved0 = torch.cuda.memory_reserved(dev) if on_card else 0
    comm.Barrier()
    sync()
    t_start = time.perf_counter()
    mono_start = time.monotonic()
    ends, s, t, gc_s = [], 0, warm, 0.0
    while not (flags[LAST] and s > flags[LAST]):
        if flags[PROF_START] and s == flags[PROF_START]:
            sync()
            if "spans" in parts:
                rec = trace_rec.enable(api_spans="api" in parts, rank=r)
                rec.clear()
            if dtr is not None:
                dtr.start()
                prof_span = [time.monotonic_ns(), None]
        elif flags[PROF_STOP] and s == flags[PROF_STOP]:
            sync()
            if prof_span is not None:
                prof_span[1] = time.monotonic_ns()
                dtr.stop()
            after = {"step": s, "t0_ns": trace_rec.now(),
                     "launches": launches(),
                     "wait_ns": pvar.read("device_plane_wait_ns")}
        g = grads[t % pool_n]
        out = None
        tg = time.perf_counter()
        gc.collect()
        gc.freeze()
        gc_s += time.perf_counter() - tg
        t0 = trace_rec.now()
        out = opt.step(g)
        sync()
        if rec is not None:
            rec.record("step", "bench", t0, trace_rec.now())
        ends.append(time.perf_counter())
        if sampler:
            free, total = torch.cuda.mem_get_info(dev)
            mem.append(total - free)
        s += 1
        t += 1
        if r == 0:
            elapsed = ends[-1] - t_start
            start, stop = int(flags[PROF_START]), int(flags[PROF_STOP])
            if trace and not start and elapsed >= PROF_AFTER * seconds:
                flags[PROF_START] = s + 2
            elif trace and start and not stop and s - start >= PROF_STEPS \
                    and (elapsed >= seconds
                         or ends[-1] - ends[start - 1] >= PROF_SECONDS):
                flags[PROF_STOP] = stop = s + 2
            if not flags[LAST] and elapsed >= seconds \
                    and (stop or not trace):
                flags[LAST] = max(s + 1, stop + PROF_STEPS if trace else 0)
    if prof_span is not None:
        dev_trace = dtr.read()
    gc.enable()
    gc.unfreeze()
    spans = []
    if rec is not None:
        spans = [[sp.name, sp.subsys, sp.t0, sp.t1,
                  (sp.args or {}).get("op")] for sp in rec.spans()]
        trace_rec.disable()
    record = {
        "rank": r, "size": n, "device": str(dev),
        "dtype": str(dtype).replace("torch.", ""),
        "card": dev.index if on_card else 0,
        "steps": s, "warmup_steps": warm, "trace_parts": sorted(parts),
        "window_s": ends[-1] - t_start,
        "step_s": [b - a for a, b in zip([t_start] + ends[:-1], ends)],
        "gc_s": gc_s,
        "window_start_mono": mono_start,
        "mem_used_bytes": max(mem) if mem else None,
        "launches": launches() - l0,
        "wait_ns": pvar.read("device_plane_wait_ns") - w0,
        "arena_bytes": pvar.read("device_plane_arena_bytes"),
        "reserved_bytes": [reserved0, torch.cuda.memory_reserved(dev),
                           torch.cuda.max_memory_reserved(dev)]
        if on_card else None,
        "spans": spans, "dev_trace": dev_trace, "prof_span": prof_span,
        "prof_steps": [int(flags[PROF_START]), int(flags[PROF_STOP])]
        if dev_trace is not None else None,
        "plain_steps": int(flags[PROF_START]) if trace else None,
        # the last phase of a traced run: from its first step on
        "after": None if after is None else dict(
            after, steps=s - after["step"],
            launches=launches() - after["launches"],
            wait_ns=pvar.read("device_plane_wait_ns") - after["wait_ns"]),
    }
    if on_card and r == 0:
        record["card_name"] = torch.cuda.get_device_name(dev)
        nc = torch.cuda.device_count()
        record["peer_access"] = [[i == j or torch.cuda.can_device_access_peer(
            i, j) for j in range(nc)] for i in range(nc)]

    # -- the program's answers, then its state freed ------------------------
    mom = comm.Allgather_multi(opt.state.slots["momentum"])
    prog_p = torch.cat([x.float().reshape(-1)
                        for x in model.by_name(out, names)])[idx]
    prog_v = torch.cat([x.float().reshape(-1)
                        for x in model.by_name(mom, names)])[idx]
    opt.free()
    del opt, out, mom, grads, pool
    mpi.Finalize()
    if on_card:
        torch.cuda.empty_cache()

    # -- the plain reference ------------------------------------------------
    t_ref = time.perf_counter()
    gm = ref.mean_grads(count, n, dev, seed, pool_n)
    p0 = inputs.params_flat(count, dev, seed)
    v1_ref, d3_ref = ref.first_steps(p0, gm, offs, lr, mu)
    p0_s = p0[idx]
    del p0
    p_ref, v_ref = ref.sampled(p0_s, [x[idx] for x in gm], warm + s, lr, mu)
    del gm
    checks = {
        "grad1_gap": ref.norm_gap(v1, v1_ref),
        "change3_gap": ref.norm_gap(d3, d3_ref),
        "final_param_err": ref.sample_error(prog_p, p_ref, p0_s),
        "final_mom_err": ref.sample_error(prog_v, v_ref,
                                          torch.zeros_like(v_ref)),
    }
    if traffic["deterministic"] == "linear":
        folds = ref.rank_order_means(count, n, dev, seed, pool_n, idx)
        p_bit, v_bit = ref.sampled(p0_s, folds, warm + s, lr, mu)
        checks["bitwise_mismatch"] = float(
            ref.bit_mismatch(prog_p, p_bit) + ref.bit_mismatch(prog_v, v_bit))
        del folds, p_bit, v_bit
    record["checks"] = checks
    record["sampled"] = int(idx.numel())
    record["reference_s"] = time.perf_counter() - t_ref
    record["forbidden_modules"] = forbidden_modules()
    with open(os.path.join(spec["out"], f"rank{r}.json"), "w",
              encoding="utf-8") as f:
        json.dump(record, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
