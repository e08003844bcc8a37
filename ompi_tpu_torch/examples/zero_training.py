"""The ZeRO training step (stages 2 and 1) at GPT-2-small width, checked
and timed: the port's training slice.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on ompi_tpu_torch/examples/zero_training.py

The parameters have the exact shapes of GPT-2 small (Radford et al.
2019; the public ``gpt2`` config: n_embd 768, n_layer 12, n_head 12,
n_positions 1024, vocab_size 50257; 124,439,808 float32 parameters):
``wte``, ``wpe``, ``h`` (a list of ``--layers`` blocks of ln_1, attn.c_attn,
attn.c_proj, ln_2, mlp.c_fc, mlp.c_proj) and ``ln_f``. Nothing is
downloaded: values come from ``--seed``, and each rank makes the
gradients of step s from (seed, rank, s), leaf by leaf, on its device.

From the same parameters it runs ``--steps`` steps of
``ZeroOptimizer(comm, params, lr, momentum, stage, deterministic, fused)``
in six modes: stage 2 unfused 'linear', fused 'linear', unfused 'ring' and
fused default (coll/cuda's ``fused_rs_update_dev``: K1 hops + K5), and
stage 1 (``Allreduce_multi`` of the gradients, then the local shard)
'linear' and 'ring'. It checks:

- fused == unfused bitwise in both modes, and stage-1 'linear' ==
  stage-2 unfused 'linear' bitwise (both fold each element in rank
  order), for the gathered parameters and the momentum shards;
- ``Allreduce_multi`` under 'linear' == the per-leaf ``Allreduce`` loop
  bitwise, for the gradients of wte, h[0].mlp.c_fc.w and
  h[0].attn.c_attn.b;
- for wte, h[0].mlp.c_fc.w and h[0].attn.c_attn.b, the 'linear' result
  equals a plain recomputation (every rank's seeded gradients summed in
  rank order, then the update), bitwise;
- ``allgather_matmul_dev`` at GPT-2's MLP up-projection under a
  row-gathered layout (x (2048, 768) per rank, w (768, 3072)), float32
  and bfloat16, against ``torch.matmul`` of the gathered x to
  |err| <= tol * (|x| @ |w|) (tol 1e-5 float32, 2e-2 bfloat16), and
  ``zero3_gather_matmul_dev`` of a sharded c_fc.w the same way.

With ``--out DIR`` each rank writes ``DIR/rank<r>.json``: the cases, the
path's kernels' launch counts (zeroed just before the path; K6 also per
variant, ``block_matmul_wgmma`` and ``block_matmul_simt``) and the p50
step time of each mode. ``--tiny`` shrinks every width (for a CPU rehearsal
with ``--mca device_plane_platform cpu``; the chip runs full width).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import ZeroOptimizer, layout as zl

GPT2 = {"n_embd": 768, "n_layer": 12, "n_positions": 1024,
        "vocab_size": 50257}
TINY = {"n_embd": 48, "n_layer": 12, "n_positions": 64, "vocab_size": 503}
#: (name, ZeRO stage, fused, deterministic)
MODES = (("unfused-linear", 2, False, "linear"),
         ("fused-linear", 2, True, "linear"),
         ("unfused-ring", 2, False, "ring"),
         ("fused-default", 2, True, None),
         ("stage1-linear", 1, False, "linear"),
         ("stage1-ring", 1, False, "ring"))
SAMPLES = ("wte", "h[0].mlp.c_fc.w", "h[0].attn.c_attn.b")
LR, MOMENTUM = 0.01, 0.9
ROWS = 2048  # per-rank rows of the K6 activation: 8 x 1024 tokens / 4
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: the kernels this path runs (K5b has no caller: 'linear' runs K3)
PATH_KERNELS = (K.ring_rs_hop, K.ring_ag_hop, K.linear_fold,
                K.ring_rs_update_hop, K.block_matmul)


def gpt2_spec(cfg, layers):
    """The parameter pytree with torch.Size leaves."""
    e, S = cfg["n_embd"], torch.Size

    def ln():
        return {"g": S((e,)), "b": S((e,))}

    def lin(i, o):
        return {"w": S((i, o)), "b": S((o,))}

    return {"wte": S((cfg["vocab_size"], e)),
            "wpe": S((cfg["n_positions"], e)),
            "h": [{"ln_1": ln(),
                   "attn": {"c_attn": lin(e, 3 * e), "c_proj": lin(e, e)},
                   "ln_2": ln(),
                   "mlp": {"c_fc": lin(e, 4 * e), "c_proj": lin(4 * e, e)}}
                  for _ in range(layers)],
            "ln_f": ln()}


def leaf_names(spec):
    """Dotted names of the leaves, in flatten order."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(t)]
        return path
    return zl.tree_leaves(walk(spec, ""))


def _gen(device, *key):
    seed = 0
    for k in key:
        seed = (seed * 1_000_003 + int(k)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(seed)


def make_tree(spec, device, scale, *key):
    """Leaf i of the tree: randn(shape) * scale from (key..., i)."""
    shapes, treedef = zl.tree_flatten(spec)
    return zl.tree_unflatten(treedef, [
        torch.randn(s, generator=_gen(device, *key, i), device=device)
        .mul_(scale) for i, s in enumerate(shapes)])


def grad_leaf(spec_shapes, device, seed, rank, step, i):
    return torch.randn(spec_shapes[i], generator=_gen(device, seed, 1, rank,
                                                      step, i),
                       device=device).mul_(0.01)


def bits_equal(a, b) -> bool:
    iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(iv), b.contiguous().view(iv))


def within(got, want, mag, tol) -> bool:
    return bool(((got.float() - want.float()).abs() <= tol * mag).all())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=GPT2["n_layer"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink every width (CPU rehearsal)")
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", action="store_true",
                    help="on a card, rank 0 traces each mode's steps with "
                         "torch.profiler and reports its device ms per step")
    ns = ap.parse_args(argv)
    cfg = TINY if ns.tiny else GPT2
    rows = 64 if ns.tiny else ROWS

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    assert comm.coll.providers.get("fused_rs_update_dev") == "cuda", \
        comm.coll.providers
    assert comm.coll.providers.get("reduce_scatter_multi_dev") == "device", \
        comm.coll.providers
    spec = gpt2_spec(cfg, ns.layers)
    shapes = zl.tree_leaves(spec)
    names = leaf_names(spec)
    params = make_tree(spec, dev, 0.02, ns.seed, 0)
    n_params = sum(p.numel() for p in zl.tree_leaves(params))
    plan = zl.plan_for(zl.tree_leaves(params), n)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def grads_for(step):
        return zl.tree_unflatten(zl.tree_flatten(spec)[1], [
            grad_leaf(shapes, dev, ns.seed, r, step, i)
            for i in range(len(shapes))])

    prof_on = ns.profile and r == 0 and dev.type == "cuda"
    K.reset_launches()
    cases, step_ms, device_ms, results = [], {}, {}, {}

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[zero_training n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    for mode, stage, fused, det in MODES:
        opt = ZeroOptimizer(comm, params, lr=LR, momentum=MOMENTUM,
                            stage=stage, deterministic=det, fused=fused)
        s = pvar.session()
        ts, out = [], None
        prof = contextlib.nullcontext()
        if prof_on:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        with prof:
            for step in range(ns.steps):
                grads = grads_for(step)
                comm.Barrier()
                sync()
                t0 = time.perf_counter()
                out = opt.step(grads)
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
                del grads
        if prof_on:
            dev_us = sum(getattr(e, "self_device_time_total", 0)
                         for e in prof.key_averages()
                         if str(getattr(e, "device_type", "")).endswith(
                             "CUDA"))
            device_ms[mode] = dev_us / 1e3 / ns.steps
        step_ms[mode] = {"p50": sorted(ts)[len(ts) // 2], "all": ts}
        # a fused mode must have gone through the fused slot every step
        fl = s.read("coll_cuda_fused_launches")
        want = len(plan.buckets) * ns.steps if fused else 0
        case(f"{mode} fused launches", fl == want and
             s.read("coll_cuda_fallthrough") == 0, got=fl, want=want)
        results[mode] = (zl.tree_leaves(out),
                         opt.state.slots["momentum"].shards)
        if r == 0:
            dv = f", rank 0 device {device_ms[mode]:.3f} ms/step" \
                if mode in device_ms else ""
            print(f"[zero_training n={n}] {mode}: p50 step "
                  f"{step_ms[mode]['p50']:.3f} ms over {ns.steps} steps "
                  f"({len(plan.buckets)} buckets, {n_params} parameters)"
                  f"{dv}", flush=True)
        del opt, out

    for a, b in (("unfused-linear", "fused-linear"),
                 ("unfused-ring", "fused-default"),
                 ("unfused-linear", "stage1-linear")):
        pa, ma = results[a]
        pb, mb = results[b]
        case(f"{b} == {a} (parameters)",
             all(bits_equal(x, y) for x, y in zip(pa, pb)))
        case(f"{b} == {a} (momentum shards)",
             all(bits_equal(x, y) for x, y in zip(ma, mb)))

    # the 'linear' trajectory recomputed plainly for a few leaves
    pl, _ = results["unfused-linear"]
    for name in SAMPLES:
        i = names.index(name)
        p = zl.tree_leaves(params)[i]
        v = torch.zeros_like(p)
        c = [K.shard_const(x, p.dtype) for x in (LR, MOMENTUM, 1.0 / n)]
        for step in range(ns.steps):
            g = grad_leaf(shapes, dev, ns.seed, 0, step, i)
            for q in range(1, n):
                g = torch.add(g, grad_leaf(shapes, dev, ns.seed, q, step, i))
            p, v = K.shard_update_plain(g, p, v, c[0], c[1], c[2])
        case(f"linear {name} == plain recomputation", bits_equal(pl[i], p))
    del results

    # Allreduce_multi's buckets against the per-leaf loop, 'linear'
    sample = [grad_leaf(shapes, dev, ns.seed, r, 0, names.index(name))
              for name in SAMPLES]
    fusedl = comm.Allreduce_multi(sample, deterministic="linear")
    case("Allreduce_multi 'linear' == the per-leaf Allreduce loop "
         f"({', '.join(SAMPLES)})", all(
             bits_equal(f, comm.Allreduce(g, deterministic="linear"))
             for f, g in zip(fusedl, sample)))
    del sample, fusedl

    # K6: allgather_matmul at the MLP up-projection, and the zero-3 use
    e = cfg["n_embd"]
    agmm_ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = [torch.randn(rows, e, generator=_gen(dev, ns.seed, 2, q),
                          device=dev).to(dtype) for q in range(n)]
        w = torch.randn(e, 4 * e, generator=_gen(dev, ns.seed, 3),
                        device=dev).to(dtype)
        ts = []
        for _ in range(3):
            comm.Barrier()
            sync()
            t0 = time.perf_counter()
            got = comm.coll.allgather_matmul_dev(comm, xs[r], w)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        full = torch.cat(xs)
        want = torch.matmul(full, w)
        mag = full.float().abs() @ w.float().abs()
        agmm_ms[str(dtype).split(".")[-1]] = sorted(ts)[1]
        case(f"allgather_matmul {tuple(xs[r].shape)} @ {tuple(w.shape)} "
             f"{dtype}", got.shape == (n * rows, 4 * e)
             and got.dtype == dtype and within(got, want, mag, TOL[dtype]),
             p50_ms=agmm_ms[str(dtype).split(".")[-1]])
        del xs, w, got, full, want, mag
    wfc = make_tree({"w": torch.Size((e, 4 * e))}, dev, 0.02, ns.seed, 4)
    rhs = torch.randn(4 * e, 256, generator=_gen(dev, ns.seed, 5), device=dev)
    st = zl.ShardedState.from_full(comm, wfc)
    got = comm.coll.zero3_gather_matmul_dev(comm, st, rhs)
    mag = wfc["w"].abs() @ rhs.abs()
    case("zero3_gather_matmul c_fc.w", got is not None and within(
        got, torch.matmul(wfc["w"], rhs), mag, TOL[torch.float32]))

    launches = {k.__name__: k.launches for k in PATH_KERNELS}
    launches.update({f"block_matmul_{v}": c
                     for v, c in K.block_matmul.variants.items()})
    if r == 0:
        print(f"[zero_training n={n}] kernel launches (rank 0) {launches}",
              flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "layers": ns.layers, "parameters": n_params,
                       "buckets": len(plan.buckets),
                       "pad_bytes": plan.pad_bytes, "launches": launches,
                       "step_ms": step_ms, "device_ms": device_ms,
                       "allgather_matmul_ms": agmm_ms, "cases": cases,
                       # nothing on this path may stage through the host
                       "coll_accelerator_staged":
                           pvar.read("coll_accelerator_staged")}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    # on the card every kernel of the path must have run
    assert dev.type != "cuda" or all(v > 0 for v in launches.values()), \
        f"rank {r}: a kernel of the path never launched: {launches}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
