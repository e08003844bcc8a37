"""Train bench.py's d7168/L3 transformer on a mesh of ranks: the port's
``models/`` at bench.py's bfloat16 widths (``bench.py:113-116``: vocab
32768, d_model 7168, 3 layers, 56 heads of 128, d_ff 28672, T 1024, B 4,
lr 1e-3, bfloat16 activations and storage).

Run the job, then the oracle in its own process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        ompi_tpu_torch/examples/transformer_training.py --out DIR
    python -m ompi_tpu_torch.examples.transformer_training --oracle \\
        --out DIR

On a machine without a GPU add ``--mca device_plane_platform cpu`` and
``--tiny`` to the job, and ``--tiny --cpu`` to the oracle (narrow widths,
the same checks). The job needs 4 ranks. Weights and tokens are drawn on
each rank's device from seeded generators (every rank draws each full
leaf and keeps its shard). Its parts, each with the kernels' launch
counts zeroed just before it and read just after:

1. ``tp_sp``: the L3 model on a 2 x 2 ``("tp", "sp")`` mesh,
   ``Axes(tp="tp", sp="sp")``, ring attention: tp's Megatron pairs run
   Allreduces (K1 + K2), sp's ring attention hands (k, v) on with
   ``permute_dev`` (K2), the gradient sync reduces every leaf over sp;
   one warm step, then 3 timed ones;
2. ``pp``: the same widths with 4 layers on a ``("pp",)`` mesh of 4, one
   layer a stage, ``N_MICRO`` microbatches (GPipe, ``permute_dev``
   hand-offs, K2): one warm step, then 2 timed ones.

Rank 0 writes, per part: the first (warm) step's loss; each leaf's
synced gradient at ``N_SAMPLES`` seeded global positions, gathered from
their owners (``samples_<part>.npy``); its p50 step time, tokens/s and
model TFLOP/s by bench.py's formula (``bench.py:177``: 6 x params x
tokens / time); every rank writes its peak device memory and launches.

The oracle (``--oracle``) is bench.py's own step: the port's one-rank
``Axes()`` step of each part's config on the same seeds (the pp part's
gradients stacked as the pipeline holds them). It holds the job's first
loss within ``LOSS_RTOL`` and each leaf's sampled gradients within
``GRAD_RTOL`` of the leaf's max |g|, and times its own steps. Writes
``oracle.json``; exits non-zero when a check misses.
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
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.models import pipeline, transformer as tfm
from ompi_tpu_torch.parallel import P, collectives as C, make_mesh
from ompi_tpu_torch.parallel.device_comm import local_block
from ompi_tpu_torch.runtime import device_plane

#: bench.py's d7168 bfloat16 config, and the narrow one of ``--tiny``
WIDTHS = {
    "full": dict(vocab=32768, d_model=7168, n_heads=56, d_ff=28672,
                 max_seq=1024, seq=1024, batch=4),
    "tiny": dict(vocab=64, d_model=32, n_heads=4, d_ff=64, max_seq=32,
                 seq=32, batch=4),
}
#: the parts: (name, layers, mesh axes, mesh shape, Axes kwargs, token
#: spec, timed steps)
PARTS = (
    ("tp_sp", 3, ("tp", "sp"), (2, 2), {"tp": "tp", "sp": "sp"},
     (None, "sp"), 3),
    ("pp", 4, ("pp",), (4,), {"pp": "pp"}, (), 2),
)
N_MICRO = 4
LR = 1e-3
PARAM_SEED, DATA_SEED, SAMPLE_SEED = 0, 1, 2
N_SAMPLES = 4096
#: the job against the one-rank step, bfloat16 throughout. Gradients:
#: max |g_job - g_one| over the sampled positions within GRAD_RTOL of the
#: leaf's max |g|; the first loss within LOSS_RTOL of the oracle's. The
#: bfloat16 roundings of a sharded step (row-parallel partial sums, ring
#: attention's blocks) differ from the one-rank step's: at the tiny
#: widths on the CPU the reference's own 2 x 2 tp x sp gradients differ
#: from its one-rank ones by up to 0.155 of a leaf's max |g|, the port's
#: by up to 0.167 (in float32 both agree to 1e-6); the CPU parity test's
#: bfloat16 tp x sp case holds whole leaves to GRAD_RTOL.
GRAD_RTOL = 0.25
LOSS_RTOL = 5e-3
PATH_KERNELS = (K.ring_rs_hop, K.ring_ag_hop, K.linear_fold)
#: the kernels each part must launch on the card
REQUIRED = {"tp_sp": ("ring_rs_hop", "ring_ag_hop"), "pp": ("ring_ag_hop",)}


def config(w, layers: int) -> tfm.Config:
    return tfm.Config(vocab=w["vocab"], d_model=w["d_model"],
                      n_layers=layers, n_heads=w["n_heads"], d_ff=w["d_ff"],
                      max_seq=w["max_seq"], dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)


def batch(w, dev):
    """The whole batch's tokens from a seeded generator on ``dev``, and
    bench.py's labels (the tokens rolled by one)."""
    g = torch.Generator(device=dev).manual_seed(DATA_SEED)
    tokens = torch.randint(0, w["vocab"], (w["batch"], w["seq"]),
                           generator=g, device=dev)
    return tokens, torch.roll(tokens, -1, 1)


def sample_positions(shapes):
    """Per leaf, ``N_SAMPLES`` flat global positions from a seeded numpy
    generator (the same on every rank and in the oracle)."""
    return [np.random.default_rng([SAMPLE_SEED, i]).integers(
        0, int(np.prod(s)), N_SAMPLES) for i, s in enumerate(shapes)]


def global_shape(local: torch.Tensor, spec, mesh):
    shape = list(local.shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            shape[dim] *= mesh.axis_size(entry)
    return tuple(shape)


def owned(flat, shape, spec, mesh):
    """(mask, local flat index) of the global positions ``flat`` this
    rank owns: its block on every sharded dim, and mesh coordinate 0 on
    every axis the leaf is replicated over (one owner each)."""
    coords = list(np.unravel_index(flat, shape))
    local = list(shape)
    mask = np.ones(len(flat), bool)
    named = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        named.add(entry)
        n, i = mesh.axis_size(entry), mesh.axis_index(entry)
        k = shape[dim] // n
        mask &= coords[dim] // k == i
        coords[dim] = coords[dim] - i * k
        local[dim] = k
    if any(mesh.axis_index(a) for a in mesh.axis_names if a not in named):
        mask[:] = False
    # positions another rank owns fall outside this block: clamp them in
    # (the mask drops them)
    coords = [np.clip(c, 0, m - 1) for c, m in zip(coords, local)]
    return mask, np.ravel_multi_index(coords, local)


def local_samples(grads, specs, mesh, positions):
    """[leaves, N_SAMPLES] float32: this rank's owned sampled values,
    zeros elsewhere (their sum over the mesh is every sample)."""
    out = []
    for g, spec, pos in zip(tfm.tree_leaves(grads), tfm.tree_leaves(specs),
                            positions):
        mask, idx = owned(pos, global_shape(g, spec, mesh), spec, mesh)
        vals = g.reshape(-1)[torch.from_numpy(idx).to(g.device)].float()
        out.append(torch.where(torch.from_numpy(mask).to(g.device), vals,
                               0.0))
    return torch.stack(out)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p50(ms):
    return sorted(ms)[len(ms) // 2]


def run_part(part, w, dev, world, rank0_doc, out):
    name, layers, axes, shape, axkw, dspec, steps = part
    cfg, ax = config(w, layers), tfm.Axes(**axkw)
    mesh = make_mesh(axes, shape)
    stacked = ax.pp is not None
    specs = (pipeline.stacked_param_specs if stacked
             else tfm.param_specs)(cfg, ax)
    params = tfm.init_params_device(cfg, PARAM_SEED, dev, ax, mesh, stacked)
    tokens, labels = batch(w, dev)
    tk = local_block(mesh, tokens, P(*dspec))
    lb = local_block(mesh, labels, P(*dspec))
    del tokens, labels
    if stacked:
        grad_fn = pipeline.make_pp_grad_fn(cfg, ax, specs, N_MICRO)
    else:
        grad_fn = tfm.make_grad_fn(cfg, ax, specs)
    shapes = [global_shape(p, s, mesh) for p, s in
              zip(tfm.tree_leaves(params), tfm.tree_leaves(specs))]
    n_params = sum(int(np.prod(s)) for s in shapes)
    positions = sample_positions(shapes)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    K.reset_launches()
    with mesh:
        t0 = time.perf_counter()
        loss, cnt, grads = grad_fn(params, tk, lb)
        params = tfm.sgd_update(params, grads, tfm.sgd_scale(LR, cnt))
        sync(dev)
        warm_ms = (time.perf_counter() - t0) * 1e3
        samples = local_samples(grads, specs, mesh, positions)
        first_loss = float(loss)
        del grads
        ms = []
        for _ in range(steps):
            sync(dev)
            t0 = time.perf_counter()
            loss, cnt, grads = grad_fn(params, tk, lb)
            params = tfm.sgd_update(params, grads, tfm.sgd_scale(LR, cnt))
            del grads
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k.__name__: k.launches for k in PATH_KERNELS}
        samples = C.allreduce(samples, axes)  # one owner per position
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    del params, tk, lb
    if dev.type == "cuda":  # the card is shared with the other ranks
        torch.cuda.empty_cache()
    tokens_n = w["batch"] * w["seq"]
    step_s = p50(ms) / 1e3
    doc = {"layers": layers, "mesh": dict(zip(axes, shape)),
           "first_loss": first_loss, "last_loss": float(loss),
           "warm_ms": warm_ms, "step_ms": ms, "p50_ms": p50(ms),
           "tokens_per_s": tokens_n / step_s,
           "tflops": 6.0 * n_params * tokens_n / step_s / 1e12,
           "params": n_params, "launches": launches,
           "peak_bytes": peak, "leaf_shapes": shapes}
    if world.rank == 0:
        np.save(os.path.join(out, f"samples_{name}.npy"),
                samples.cpu().numpy())
    rank0_doc["parts"][name] = doc
    return launches


def job(ns, w) -> int:
    world = mpi.Init()
    r, n = world.rank, world.size
    if n != 4:
        raise SystemExit("transformer_training.py needs 4 ranks")
    dev = device_plane.device()
    torch.backends.cuda.matmul.allow_tf32 = False  # the float32 head
    os.makedirs(ns.out, exist_ok=True)
    doc = {"rank": r, "size": n, "device": str(dev), "parts": {},
           "cases": []}
    s = pvar.session()
    total: dict = {}
    for part in PARTS:
        got = run_part(part, w, dev, world, doc, ns.out)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    doc["launches"] = total
    doc["required"] = sorted({k for ks in REQUIRED.values() for k in ks})
    doc["coll_accelerator_staged"] = s.read("coll_accelerator_staged")
    doc["arena_bytes"] = s.read("device_plane_arena_bytes")
    for name, part in doc["parts"].items():
        doc["cases"].append({
            "name": f"{name} first loss finite",
            "ok": bool(np.isfinite(part["first_loss"]))})
        if dev.type == "cuda":
            for k in REQUIRED[name]:
                doc["cases"].append({
                    "name": f"{name} launched {k}",
                    "ok": part["launches"][k] > 0,
                    "launches": part["launches"][k]})
    if r == 0:
        for name, part in doc["parts"].items():
            print(f"[transformer_training {name} n={n} {dev}] first loss "
                  f"{part['first_loss']:.6f}; step p50 {part['p50_ms']:.1f}"
                  f" ms of {[round(v, 1) for v in part['step_ms']]} (warm "
                  f"{part['warm_ms']:.1f}); {part['tokens_per_s']:.1f} "
                  f"tokens/s, {part['tflops']:.2f} TFLOP/s by 6 x "
                  f"{part['params']} params x tokens; launches (rank 0) "
                  f"{part['launches']}", flush=True)
    with open(os.path.join(ns.out, f"rank{r}.json"), "w") as fh:
        json.dump(doc, fh)
    mpi.Finalize()
    return 0 if all(c["ok"] for c in doc["cases"]) else 1


def oracle_part(part, w, dev, job_doc, out):
    """The one-rank step of a part's config on the job's seeds: its first
    loss and sampled grads against the job's, and its own step times."""
    name, layers, *_, steps = part
    cfg, ax = config(w, layers), tfm.Axes()
    grad_fn = tfm.make_grad_fn(cfg, ax, tfm.param_specs(cfg, ax))
    params = tfm.init_params_device(cfg, PARAM_SEED, dev)
    n_params = sum(p.numel() for p in tfm.tree_leaves(params))
    tk, lb = batch(w, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    jd = job_doc["parts"][name]
    sync(dev)
    t0 = time.perf_counter()
    loss, cnt, grads = grad_fn(params, tk, lb)
    params = tfm.sgd_update(params, grads, tfm.sgd_scale(LR, cnt))
    sync(dev)
    warm_ms = (time.perf_counter() - t0) * 1e3
    if name == "pp":
        grads = pipeline.stack_layers(grads)
    leaves = tfm.tree_leaves(grads)
    shapes = [tuple(g.shape) for g in leaves]
    if shapes != [tuple(s) for s in jd["leaf_shapes"]]:
        raise SystemExit(f"oracle {name}: leaf shapes {shapes} are not "
                         f"the job's {jd['leaf_shapes']}")
    got = np.load(os.path.join(out, f"samples_{name}.npy"))
    errs = []
    for g, pos, js in zip(leaves, sample_positions(shapes), got):
        ref = g.reshape(-1)[torch.from_numpy(pos).to(dev)].float().cpu()
        scale = float(g.float().abs().max())
        err = float((torch.from_numpy(js) - ref).abs().max())
        errs.append(err / scale if scale else err)
    del grads, leaves
    loss_err = abs(jd["first_loss"] - float(loss)) / abs(float(loss))
    step = tfm.make_train_step(cfg, ax, tfm.param_specs(cfg, ax), LR)
    ms = []
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        params, _ = step(params, tk, lb)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    del params, tk, lb
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tokens_n = w["batch"] * w["seq"]
    step_s = p50(ms) / 1e3
    return {"first_loss": float(loss), "job_first_loss": jd["first_loss"],
            "loss_rel_err": loss_err, "grad_rel_errs": errs,
            "grad_rel_err_max": max(errs), "warm_ms": warm_ms,
            "step_ms": ms, "p50_ms": p50(ms),
            "tokens_per_s": tokens_n / step_s,
            "tflops": 6.0 * n_params * tokens_n / step_s / 1e12,
            "peak_bytes": peak,
            "ok": loss_err <= LOSS_RTOL and max(errs) <= GRAD_RTOL}


def head_times(w, dev, reps: int = 5):
    """The weight-tied head alone at the oracle's shape (its float32
    products without TF32, the upcast operands included): p50 ms of the
    forward and of the forward with its backward, and the forward's
    operations."""
    g = torch.Generator(device=dev).manual_seed(DATA_SEED)
    d = w["d_model"]
    h = torch.randn((w["batch"], w["seq"], d), generator=g, device=dev)
    emb = torch.randn((w["vocab"], d), generator=g, device=dev).to(
        torch.bfloat16).requires_grad_()

    def fwd():
        return tfm._head(h, emb, torch.bfloat16)

    def both():
        torch.autograd.grad(fwd().sum(), emb)

    out = {"flop": 2.0 * w["batch"] * w["seq"] * d * w["vocab"]}
    for name, fn in (("forward_ms", fwd), ("forward_backward_ms", both)):
        fn()
        ms = []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = p50(ms)
    return out


def oracle(ns, w) -> int:
    dev = torch.device("cpu") if ns.cpu else torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(ns.out, "rank0.json")) as fh:
        job_doc = json.load(fh)
    doc = {"device": str(dev), "parts": {}, "head": head_times(w, dev)}
    hd = doc["head"]
    print(f"[transformer_training oracle head {dev}] the float32 head of "
          f"{w['batch'] * w['seq']} tokens: forward {hd['forward_ms']:.1f} ms "
          f"({hd['flop'] / hd['forward_ms'] / 1e9:.1f} TFLOP/s), with its "
          f"backward {hd['forward_backward_ms']:.1f} ms", flush=True)
    for part in PARTS:
        res = doc["parts"][part[0]] = oracle_part(part, w, dev, job_doc,
                                                  ns.out)
        print(f"[transformer_training oracle {part[0]} {dev}] first loss "
              f"{res['first_loss']:.6f} (job {res['job_first_loss']:.6f}, "
              f"rel err {res['loss_rel_err']:.2e} <= {LOSS_RTOL}); grads' "
              f"max rel err {res['grad_rel_err_max']:.2e} <= {GRAD_RTOL}; "
              f"step p50 {res['p50_ms']:.1f} ms, {res['tokens_per_s']:.1f} "
              f"tokens/s, {res['tflops']:.2f} TFLOP/s", flush=True)
    with open(os.path.join(ns.out, "oracle.json"), "w") as fh:
        json.dump(doc, fh)
    return 0 if all(p["ok"] for p in doc["parts"].values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="narrow widths (a CPU run)")
    ap.add_argument("--oracle", action="store_true",
                    help="the one-rank step against the job's output")
    ap.add_argument("--cpu", action="store_true",
                    help="run the oracle on the CPU")
    ap.add_argument("--out", required=True)
    ns = ap.parse_args(argv)
    w = WIDTHS["tiny" if ns.tiny else "full"]
    return oracle(ns, w) if ns.oracle else job(ns, w)


if __name__ == "__main__":
    sys.exit(main())
