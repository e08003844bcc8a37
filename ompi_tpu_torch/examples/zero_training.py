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
``ZeroOptimizer(comm, params, lr, momentum, stage, deterministic, fused,
overlap)`` in eight modes: stage 2 unfused 'linear', fused 'linear',
unfused 'ring' and fused default (coll/cuda's ``fused_rs_update_dev``: K1
hops + K5), stage 1 (``Allreduce_multi`` of the gradients, then the local
shard) 'linear' and 'ring', and stage 2 ``overlap=True`` (one
``Preduce_scatter_init``, the gradient leaves Pready'd last first with
each step's values) 'linear' and 'ring'. Then ``GradientSync``
(``Pallreduce_init``) over the gradient tree in 'linear', the leaves
pushed last first; ``Zero3Optimizer`` (stage 3) in 'linear' and 'ring'
over the whole tree (15 layers with 12 blocks: wte, wpe, h[0..11],
ln_f), one persistent ``Allgather_multi_init`` per layer, and its
forward pass (``start_pass``, then ``fetch`` / ``release`` of every
layer, ``prefetch_depth`` 1); and a ``Zero3Optimizer`` over the blocks'
``h[i].mlp.c_fc.w`` alone (768 x 3072, a layer each), whose
``matmul(g, rhs)`` of a (3072, 256) float32 ``rhs`` goes through
``zero3_gather_matmul_dev`` (K6 on this rank's row block). It checks:

- fused == unfused and overlap == unfused bitwise in both modes, and
  stage-1 'linear' == stage-2 unfused 'linear' bitwise (both fold each
  element in rank order), for the gathered parameters and the momentum
  shards; each overlap step flushed all buckets but the last before the
  final Pready (``zero_overlap_flushes``);
- ``Allreduce_multi`` under 'linear' == the per-leaf ``Allreduce`` loop
  bitwise, for the gradients of wte, h[0].mlp.c_fc.w and
  h[0].attn.c_attn.b, and ``GradientSync`` == ``Allreduce_multi``
  'linear' bitwise over the whole tree;
- for wte, h[0].mlp.c_fc.w and h[0].attn.c_attn.b, the 'linear' result
  equals a plain recomputation (every rank's seeded gradients summed in
  rank order, then the update), bitwise;
- stage 3 'linear' == stage 1 'linear' bitwise (parameters and
  momentum), stage 3 'ring' within :func:`ring_bound` of stage 2
  unfused 'ring', every layer's request object the same after the steps
  (``rebind`` took), no prefetch miss in the forward pass and the
  residency high watermark (``zero3_resident_bytes``) within the shards
  plus ``(prefetch_depth + 1)`` times the largest layer;
- every c_fc product through K6 (``zero3_fused_matmuls`` 12 a pass on 12
  blocks) within tol x (|W| @ |rhs|) of ``torch.matmul`` of the whole
  weight, tol 1e-5;
- ``allgather_matmul_dev`` at GPT-2's MLP up-projection under a
  row-gathered layout (x (2048, 768) per rank, w (768, 3072)), float32
  and bfloat16, against ``torch.matmul`` of the gathered x to
  |err| <= tol * (|x| @ |w|) (tol 1e-5 float32, 2e-2 bfloat16), and
  ``zero3_gather_matmul_dev`` of a sharded c_fc.w the same way.

``--error-feedback WIRE`` runs, in place of all that, stage 2 unfused
'linear' with ``error_feedback=WIRE`` beside the same step without it on
a seeded quadratic loss (:func:`error_feedback_main`).

The kernels' launch counts are zeroed just before each phase and read
just after, and summed. With ``--out DIR`` each rank writes
``DIR/rank<r>.json``: the cases, the summed launch counts (K6 also per
variant, ``block_matmul_wgmma`` and ``block_matmul_simt``), each phase's
counts, the p50 step time of each mode (the stage-3 modes and the
GradientSync cycle among them), the forward pass's and the c_fc pass's
p50 and the residency figures. ``--tiny`` shrinks every width (for a CPU
rehearsal with ``--mca device_plane_platform cpu``; the chip runs full
width).
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
from ompi_tpu_torch.part import GradientSync
from ompi_tpu_torch.zero import Zero3Optimizer, ZeroOptimizer, layout as zl

GPT2 = {"n_embd": 768, "n_layer": 12, "n_positions": 1024,
        "vocab_size": 50257}
TINY = {"n_embd": 48, "n_layer": 12, "n_positions": 64, "vocab_size": 503}
#: (name, ZeRO stage, fused, overlap, deterministic)
MODES = (("unfused-linear", 2, False, False, "linear"),
         ("fused-linear", 2, True, False, "linear"),
         ("unfused-ring", 2, False, False, "ring"),
         ("fused-default", 2, True, False, None),
         ("stage1-linear", 1, False, False, "linear"),
         ("stage1-ring", 1, False, False, "ring"),
         ("overlap-linear", 2, False, True, "linear"),
         ("overlap-ring", 2, False, True, "ring"))
#: the modes held bitwise equal: (reference mode, mode)
BITWISE = (("unfused-linear", "fused-linear"),
           ("unfused-ring", "fused-default"),
           ("unfused-linear", "stage1-linear"),
           ("unfused-linear", "overlap-linear"),
           ("unfused-ring", "overlap-ring"))
#: stage 3's modes and the mode each is held against
ZERO3 = (("zero3-linear", "linear", "stage1-linear"),
         ("zero3-ring", "ring", "unfused-ring"))
PASSES = 3  # stage 3's timed forward passes and c_fc matmul passes
SAMPLES = ("wte", "h[0].mlp.c_fc.w", "h[0].attn.c_attn.b")
LR, MOMENTUM = 0.01, 0.9
#: --error-feedback: the step size on ef_loss, and how far above the
#: exact step's loss an error-feedback step's may be (the JAX package's
#: examples/hier_dcn_compress.py bound)
EF_LR, EF_LOSS_SLACK = 0.5, 1e-2
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


def ring_bound(n: int, sum_abs, p, steps: int, lr: float, mu: float):
    """Elementwise bound on |stage 3 'ring' - stage 2 'ring'| of a
    parameter after ``steps`` momentum steps. ``sum_abs[t]`` is
    sum_r |g_r| of step t's gradients. Two ring orders of an n-way sum
    differ by at most (n - 1) roundings of the running sum, so the
    averaged gradients differ by at most (n - 1) u sum_r |g_r| / n
    (u = 2**-24); momentum carries a step's difference with weight up to
    1 / (1 - mu); every update may round the parameter once more
    differently (2 u |p|, both sides). The bound takes steps times the
    carried sum, plus the roundings."""
    u = 2.0 ** -24
    carried = sum(lr * (n - 1) * u / n / (1 - mu) * s.double()
                  for s in sum_abs)
    return steps * carried + 2 * steps * u * p.double().abs()


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
    ap.add_argument("--error-feedback", default="", metavar="WIRE",
                    help="instead of the modes: stage 2 unfused 'linear' "
                         "with error_feedback=WIRE (a comma list runs each) "
                         "beside the same step without it")
    ns = ap.parse_args(argv)
    cfg = TINY if ns.tiny else GPT2
    rows = 64 if ns.tiny else ROWS

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    if ns.error_feedback:
        return error_feedback_main(comm, ns, cfg, dev)
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
    cases, step_ms, device_ms, results = [], {}, {}, {}
    launches = {k.__name__: 0 for k in PATH_KERNELS}
    launches.update({f"block_matmul_{v}": 0
                     for v in K.block_matmul.variants})
    phase_launches = {}

    @contextlib.contextmanager
    def phase(name):
        """The kernels' launch counts zeroed just before the phase, read
        just after and summed."""
        K.reset_launches()
        yield
        got = {k.__name__: k.launches for k in PATH_KERNELS}
        got.update({f"block_matmul_{v}": c
                    for v, c in K.block_matmul.variants.items()})
        phase_launches[name] = got
        for k, v in got.items():
            launches[k] += v

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[zero_training n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def timed(fn):
        comm.Barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    for mode, stage, fused, overlap, det in MODES:
        opt = ZeroOptimizer(comm, params, lr=LR, momentum=MOMENTUM,
                            stage=stage, deterministic=det, fused=fused,
                            overlap=overlap)
        s = pvar.session()
        ts, out = [], None
        prof = contextlib.nullcontext()
        if prof_on:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        with phase(mode), prof:
            for step in range(ns.steps):
                grads = grads_for(step)
                out, ms = timed(lambda: opt.step(grads))
                ts.append(ms)
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
        if overlap:
            # every bucket but the one holding leaf 0 (Pready'd last)
            # flushed before the cycle's final Pready
            ov = s.read("zero_overlap_flushes")
            want = (len(plan.buckets) - 1) * ns.steps
            case(f"{mode} overlap flushes", ov == want, got=ov, want=want)
        opt.free()
        results[mode] = (zl.tree_leaves(out),
                         opt.state.slots["momentum"])
        if r == 0:
            dv = f", rank 0 device {device_ms[mode]:.3f} ms/step" \
                if mode in device_ms else ""
            print(f"[zero_training n={n}] {mode}: p50 step "
                  f"{step_ms[mode]['p50']:.3f} ms over {ns.steps} steps "
                  f"({len(plan.buckets)} buckets, {n_params} parameters)"
                  f"{dv}", flush=True)
        del opt, out
        # compare each pair once both sides ran, then drop what no later
        # comparison needs (the card holds every rank's copies)
        for a, b in BITWISE:
            if mode in (a, b) and a in results and b in results:
                (pa, ma), (pb, mb) = results[a], results[b]
                case(f"{b} == {a} (parameters)",
                     all(bits_equal(x, y) for x, y in zip(pa, pb)))
                case(f"{b} == {a} (momentum shards)",
                     all(bits_equal(x, y)
                         for x, y in zip(ma.shards, mb.shards)))
        keep = {m for pair in BITWISE for m in pair
                if any(q not in results for q in pair)}
        keep |= {"unfused-linear"} | {ref for _, _, ref in ZERO3}
        for m in [m for m in results if m not in keep]:
            del results[m]

    # the 'linear' trajectory recomputed plainly for a few leaves
    pl, _ = results["unfused-linear"]
    with phase("plain recomputation"):
        for name in SAMPLES:
            i = names.index(name)
            p = zl.tree_leaves(params)[i]
            v = torch.zeros_like(p)
            c = [K.shard_const(x, p.dtype) for x in (LR, MOMENTUM, 1.0 / n)]
            for step in range(ns.steps):
                g = grad_leaf(shapes, dev, ns.seed, 0, step, i)
                for q in range(1, n):
                    g = torch.add(g, grad_leaf(shapes, dev, ns.seed, q, step,
                                               i))
                p, v = K.shard_update_plain(g, p, v, c[0], c[1], c[2])
            case(f"linear {name} == plain recomputation",
                 bits_equal(pl[i], p))
    del pl

    # Allreduce_multi's buckets against the per-leaf loop, 'linear'
    with phase("Allreduce_multi"):
        sample = [grad_leaf(shapes, dev, ns.seed, r, 0, names.index(name))
                  for name in SAMPLES]
        fusedl = comm.Allreduce_multi(sample, deterministic="linear")
        case("Allreduce_multi 'linear' == the per-leaf Allreduce loop "
             f"({', '.join(SAMPLES)})", all(
                 bits_equal(f, comm.Allreduce(g, deterministic="linear"))
                 for f, g in zip(fusedl, sample)))
        del sample, fusedl

    # GradientSync (Pallreduce_init): the leaves pushed last first, each
    # step's values, against Allreduce_multi 'linear' of the same tree
    treedef = zl.tree_flatten(spec)[1]
    with phase("gradient-sync"):
        gsync = GradientSync(comm, params, deterministic="linear")
        s = pvar.session()
        ts = []
        for step in range(ns.steps):
            def cycle():
                gsync.start()
                for i in reversed(range(len(shapes))):
                    gsync.push(i, grad_leaf(shapes, dev, ns.seed, r, step,
                                            i))
                return gsync.finish()
            synced, ms = timed(cycle)
            ts.append(ms)
        step_ms["gradient-sync"] = {"p50": sorted(ts)[len(ts) // 2],
                                    "all": ts}
        fplan = zl._FusePlan(zl._fuse_metas(zl.tree_leaves(params)),
                             int(zl.bucket_var.get()))
        ov, want = s.read("part_overlap_flushes"), \
            (len(fplan.buckets) - 1) * ns.steps
        ref = comm.Allreduce_multi(grads_for(ns.steps - 1),
                                   deterministic="linear")
        case("GradientSync 'linear' == Allreduce_multi 'linear'",
             all(bits_equal(a, b) for a, b in zip(
                 zl.tree_leaves(synced), zl.tree_leaves(ref)))
             and ov == want, overlap_flushes=ov, want=want,
             p50_ms=step_ms["gradient-sync"]["p50"])
        gsync.free()
        del synced, ref

    # ZeRO stage 3 over the whole tree, in 'linear' and 'ring'
    zero3 = {}
    for mode, det, ref_mode in ZERO3:
        with phase(mode):
            opt = Zero3Optimizer(comm, params, lr=LR, momentum=MOMENTUM,
                                 deterministic=det)
            reqs = list(opt._reqs)
            ts = []
            for step in range(ns.steps):
                grads = grads_for(step)
                _, ms = timed(lambda: opt.step(grads))
                ts.append(ms)
                del grads
            step_ms[mode] = {"p50": sorted(ts)[len(ts) // 2], "all": ts}
            case(f"{mode}: every layer's request rebound, not "
                 "re-initialized", all(a is b for a, b in zip(reqs,
                                                              opt._reqs)),
                 layers=opt.plan.n_layers)
            got = zl.tree_leaves(opt.gathered_params())
            want, wmom = results[ref_mode]
            if det == "linear":
                gm = zl.tree_leaves(opt.gathered_momentum())
                wm = zl.tree_leaves(comm.Allgather_multi(wmom))
                case(f"{mode} == {ref_mode} (parameters)",
                     all(bits_equal(x, y) for x, y in zip(got, want)))
                case(f"{mode} == {ref_mode} (momentum)",
                     all(bits_equal(x, y) for x, y in zip(gm, wm)))
                del gm, wm
            else:
                worst = 0.0
                for i in range(len(shapes)):
                    sums = []
                    for step in range(ns.steps):
                        acc = torch.zeros(shapes[i], device=dev)
                        for q in range(n):
                            acc += grad_leaf(shapes, dev, ns.seed, q, step,
                                             i).abs()
                        sums.append(acc)
                    bound = ring_bound(n, sums, want[i], ns.steps, LR,
                                       MOMENTUM)
                    diff = (got[i].double() - want[i].double()).abs()
                    worst = max(worst, float((diff / bound).max()))
                    del sums, bound, diff
                case(f"{mode} within ring_bound of {ref_mode} (parameters)",
                     worst <= 1.0, worst_share_of_bound=worst)
            del got, want
            if det == "linear":
                # the forward pass: every layer fetched and released with
                # a layer-ahead prefetch
                s = pvar.session()
                ts = []
                for _ in range(PASSES):
                    def forward():
                        opt.start_pass()
                        for g in range(opt.plan.n_layers):
                            with opt.layer(g):
                                pass
                    _, ms = timed(forward)
                    ts.append(ms)
                limit = opt.shard_bytes + 2 * max(opt.plan.layer_bytes)
                hwm = pvar.read("zero3_resident_bytes")
                zero3 = {"forward_p50_ms": sorted(ts)[len(ts) // 2],
                         "forward_ms": ts, "layers": opt.plan.n_layers,
                         "hits": s.read("zero_prefetch_hits"),
                         "misses": s.read("zero_prefetch_misses"),
                         "late_ns": s.read("zero_prefetch_late_ns"),
                         "resident_hwm_bytes": hwm,
                         "resident_limit_bytes": limit,
                         "shard_bytes": opt.shard_bytes,
                         "max_layer_bytes": max(opt.plan.layer_bytes),
                         # the 15 layers' requests share the comm's
                         # size-class arenas: mapped by this rank so far
                         "arenas": pvar.read("device_plane_arenas")}
                case(f"{mode} forward pass: no prefetch miss, residency "
                     "within shards + 2 layers", zero3["misses"] == 0
                     and zero3["hits"] == PASSES * opt.plan.n_layers
                     and hwm <= limit, **{k: zero3[k] for k in (
                         "hits", "misses", "resident_hwm_bytes",
                         "resident_limit_bytes", "forward_p50_ms")})
            opt.free()
            del opt
    del results

    # stage 3's fused product: the blocks' c_fc.w, one layer each,
    # through K6 on this rank's row block
    e = cfg["n_embd"]
    with phase("zero3-matmul"):
        wtree = {"h": [{"mlp": {"c_fc": {"w": blk["mlp"]["c_fc"]["w"]}}}
                       for blk in params["h"]]}
        opt = Zero3Optimizer(comm, wtree, lr=LR)
        rhs = torch.randn(4 * e, 256, generator=_gen(dev, ns.seed, 6),
                          device=dev)
        s = pvar.session()
        ts, ok = [], True
        for _ in range(PASSES):
            outs, ms = timed(lambda: [opt.matmul(g, rhs)
                                      for g in range(opt.plan.n_layers)])
            ts.append(ms)
        for blk, got in zip(params["h"], outs):
            w = blk["mlp"]["c_fc"]["w"]
            ok = ok and within(got, torch.matmul(w, rhs),
                               w.abs() @ rhs.abs(), TOL[torch.float32])
        fm = s.read("zero3_fused_matmuls")
        zero3["matmul_pass_p50_ms"] = sorted(ts)[len(ts) // 2]
        case(f"zero3 matmul of {len(outs)} c_fc.w through K6, "
             f"{len(outs)} fused a pass", ok
             and fm == PASSES * ns.layers, fused=fm,
             p50_ms=zero3["matmul_pass_p50_ms"])
        opt.free()
        del opt, outs

    # K6: allgather_matmul at the MLP up-projection, and the zero-3 use
    agmm_ms = {}
    with phase("allgather_matmul"):
        for dtype in (torch.float32, torch.bfloat16):
            xs = [torch.randn(rows, e, generator=_gen(dev, ns.seed, 2, q),
                              device=dev).to(dtype) for q in range(n)]
            w = torch.randn(e, 4 * e, generator=_gen(dev, ns.seed, 3),
                            device=dev).to(dtype)
            ts = []
            for _ in range(3):
                got, ms = timed(lambda: comm.coll.allgather_matmul_dev(
                    comm, xs[r], w))
                ts.append(ms)
            full = torch.cat(xs)
            want = torch.matmul(full, w)
            mag = full.float().abs() @ w.float().abs()
            agmm_ms[str(dtype).split(".")[-1]] = sorted(ts)[1]
            case(f"allgather_matmul {tuple(xs[r].shape)} @ "
                 f"{tuple(w.shape)} {dtype}", got.shape == (n * rows, 4 * e)
                 and got.dtype == dtype
                 and within(got, want, mag, TOL[dtype]),
                 p50_ms=agmm_ms[str(dtype).split(".")[-1]])
            del xs, w, got, full, want, mag
        wfc = make_tree({"w": torch.Size((e, 4 * e))}, dev, 0.02, ns.seed,
                        4)
        rhs = torch.randn(4 * e, 256, generator=_gen(dev, ns.seed, 5),
                          device=dev)
        st = zl.ShardedState.from_full(comm, wfc)
        got = comm.coll.zero3_gather_matmul_dev(comm, st, rhs)
        mag = wfc["w"].abs() @ rhs.abs()
        case("zero3_gather_matmul c_fc.w", got is not None and within(
            got, torch.matmul(wfc["w"], rhs), mag, TOL[torch.float32]))

    if r == 0:
        print(f"[zero_training n={n}] kernel launches (rank 0) {launches}",
              flush=True)
        print(f"[zero_training n={n}] stage 3: forward pass p50 "
              f"{zero3['forward_p50_ms']:.3f} ms over {zero3['layers']} "
              f"layers ({zero3['hits']} hits, {zero3['misses']} misses), "
              f"residency high watermark {zero3['resident_hwm_bytes']} B "
              f"<= {zero3['resident_limit_bytes']} B (shards "
              f"{zero3['shard_bytes']} B + 2 x {zero3['max_layer_bytes']} "
              f"B); c_fc matmul pass p50 {zero3['matmul_pass_p50_ms']:.3f} "
              "ms", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "layers": ns.layers, "parameters": n_params,
                       "buckets": len(plan.buckets),
                       "pad_bytes": plan.pad_bytes, "launches": launches,
                       "phase_launches": phase_launches,
                       "step_ms": step_ms, "device_ms": device_ms,
                       "allgather_matmul_ms": agmm_ms, "zero3": zero3,
                       "cases": cases,
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

def ef_loss(params, target) -> float:
    """0.5 x the mean squared distance of the parameters to the target,
    in float64: the loss whose gradient :func:`error_feedback_main`'s
    ranks feed the optimizer."""
    tot, cnt = 0.0, 0
    for p, t in zip(zl.tree_leaves(params), zl.tree_leaves(target)):
        tot += float(((p.double() - t.double()) ** 2).sum())
        cnt += p.numel()
    return 0.5 * tot / cnt


def error_feedback_main(comm, ns, cfg, dev) -> int:
    """``--error-feedback WIRE[,WIRE]``: ZeroOptimizer stage 2 unfused
    'linear' with ``error_feedback=WIRE`` beside the same step without it
    (the exact step), ``--steps`` steps each, on the loss :func:`ef_loss`
    (a seeded target tree): each rank's gradient of a step is the loss's
    gradient ``p - t`` plus its own seeded noise, so the averaged gradient
    is the loss's plus the noise's mean. Checks each step's loss is at
    most ``EF_LOSS_SLACK`` above the exact step's (the JAX package
    example's bound), and ``zero_ef_steps`` / ``zero_ef_bytes`` equal what
    the bucket plan derives (every float32 bucket quantised once a step,
    its elements at the wire's item size); the K1-K3 launches of each run
    equal the plan's (per step and bucket one K3 fold, then n K2 copies of
    the allgather)."""
    from ompi_tpu_torch.examples import kernel_counts as KC
    from ompi_tpu_torch.parallel import hierarchical as H

    n, r = comm.size, comm.rank
    counts = KC.Counts(dev)
    spec = gpt2_spec(cfg, ns.layers)
    shapes = zl.tree_leaves(spec)
    params = make_tree(spec, dev, 0.02, ns.seed, 0)
    target = make_tree(spec, dev, 1.0, ns.seed, 9)
    plan = zl.plan_for(zl.tree_leaves(params), n)
    treedef = zl.tree_flatten(spec)[1]
    cases, report, launches = [], {}, {}

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[zero_training n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(wire):
        opt = ZeroOptimizer(comm, params, lr=EF_LR, stage=2,
                            deterministic="linear",
                            error_feedback=wire or None)
        cur, losses, ts = params, [], []
        s = pvar.session()
        counts.reset()
        for step in range(ns.steps):
            grads = zl.tree_unflatten(treedef, [
                p - t + grad_leaf(shapes, dev, ns.seed, r, step, i)
                for i, (p, t) in enumerate(zip(zl.tree_leaves(cur),
                                               zl.tree_leaves(target)))])
            comm.Barrier()
            sync()
            t0 = time.perf_counter()
            cur = opt.step(grads)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
            losses.append(ef_loss(cur, target))
            del grads
        got = counts.read()
        opt.free()
        return losses, ts, s, got

    exact, t_exact, _, l_exact = run("")
    report["exact"] = {"loss": exact, "ms": t_exact,
                       "p50_ms": sorted(t_exact)[len(t_exact) // 2]}
    launches["exact"] = l_exact
    for wire in ns.error_feedback.split(","):
        losses, ts, s, got = run(wire)
        isz = H.wire_itemsize(wire)
        want_bytes = ns.steps * sum(
            e * isz for e, dt in zip(plan.elems, plan.dtypes)
            if torch_dtype_wider(dt, isz))
        case(f"error_feedback={wire}: every step's loss <= the exact "
             f"step's + {EF_LOSS_SLACK}",
             all(a <= b + EF_LOSS_SLACK for a, b in zip(losses, exact)),
             loss=losses, exact=exact)
        case(f"error_feedback={wire}: zero_ef_steps / zero_ef_bytes as "
             "the plan derives",
             s.read("zero_ef_steps") == ns.steps
             and s.read("zero_ef_bytes") == want_bytes,
             steps=s.read("zero_ef_steps"), bytes=s.read("zero_ef_bytes"),
             want_bytes=want_bytes)
        report[wire] = {"loss": losses, "ms": ts,
                        "p50_ms": sorted(ts)[len(ts) // 2],
                        "zero_ef_bytes": s.read("zero_ef_bytes")}
        launches[wire] = got
        if r == 0:
            print(f"[zero_training n={n}] error_feedback={wire}: p50 step "
                  f"{report[wire]['p50_ms']:.3f} ms, exact "
                  f"{report['exact']['p50_ms']:.3f} ms; losses {losses} "
                  f"vs exact {exact}", flush=True)
    # per step and bucket: one 'linear' fold (K3), then the allgather's n
    # K2 copies; no ring hop
    want = {"ring_rs_hop": 0, "ring_ag_hop": ns.steps * len(plan.buckets) * n,
            "linear_fold": ns.steps * len(plan.buckets)}
    case("K1-K3 launches of each run as the plan derives",
         all(v == want for v in launches.values()), got=launches,
         want=want)
    total = {k: sum(v[k] for v in launches.values()) for k in want}
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "layers": ns.layers,
                       "parameters": sum(p.numel()
                                         for p in zl.tree_leaves(params)),
                       "buckets": len(plan.buckets), "launches": total,
                       "runs": launches, "expected": want,
                       "error_feedback": report, "cases": cases,
                       "required": ["ring_ag_hop", "linear_fold"],
                       "coll_accelerator_staged":
                           pvar.read("coll_accelerator_staged")}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    mpi.Finalize()
    return 0


def torch_dtype_wider(name: str, wire_itemsize: int) -> bool:
    """Whether ErrorFeedback quantises a bucket of dtype ``name``: a
    float dtype wider than the wire."""
    dt = zl.torch_dtype(name)
    return dt.is_floating_point and dt.itemsize > wire_itemsize


if __name__ == "__main__":
    raise SystemExit(main())
