"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on
a GPU. Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the kernels from ``ompi_tpu_torch/coll/csrc/ring_kernels.cu``
   with nvcc for sm_90a (into ``build/ompi_tpu_torch/``);
2. hold every kernel against its plain PyTorch version on the card:
   K1 ring_rs_hop, K2 ring_ag_hop, K3 linear_fold for float32, bfloat16
   and int32 x SUM/PROD/MIN/MAX at the collectives path's shape (a
   256 MiB payload over 4 ranks) and at two ragged small shapes (one of
   them not 16-byte aligned), bitwise, inputs carrying NaN and +-0; K5
   ring_rs_update_hop for the three dtypes with and without momentum and
   scaling at the training path's largest chunk (the bucket that holds
   GPT-2's ln_f, wpe and wte: 9,846,336 elements per rank over 4 ranks)
   and the ragged shapes, bitwise; K6 block_matmul at GPT-2's MLP
   up-projection block
   ((2048, 768) @ (768, 3072)) and ragged and mixed-dtype shapes,
   |err| <= tol * (|x| @ |w|) with tol 1e-5 float32 and 2e-2 bfloat16,
   int32 exact. Then time each kernel (CUDA events, median of 10) beside
   its plain version, one PyTorch library call where one computes the
   same function, and its bound;
3. the main paths, each with the kernels' launch counts zeroed by the
   ranks just before it and read just after: the launcher runs
   ``ompi_tpu_torch/examples/device_collectives.py`` (Allreduce,
   Reduce_scatter_block, Allgather; 4 ranks on this card, then 3) and
   ``ompi_tpu_torch/examples/zero_training.py`` (the ZeRO stage-2 step
   over GPT-2 small's full-width parameters, unfused and fused, 'linear'
   and ring, plus allgather_matmul_dev and zero3_gather_matmul_dev; 4
   ranks with all 12 layers, then 3 ranks with 4), ``--mca device_plane
   on --mca coll_cuda on``. Each rank checks its results (bitwise where
   the fold order is fixed, fused == unfused bitwise) and reports its
   launch counts; every kernel of a path must have launched on it.

Output: one line per measurement with the card's name and power limit,
then ``{"kernels": [...]}`` (K1-K3 launches from the collectives path,
K5 and K6 from the training path), the card line, and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bfloat16 tensor cores, dense
N_RANKS = 4
MAIN_BYTES = 256 << 20  # the collectives path's largest Allreduce payload
#: K5: per-rank chunk of the training path's largest bucket (ln_f, wpe and
#: wte of GPT-2 small, 39,385,344 float32 over 4 ranks)
WTE_CHUNK = (2 + 1024 + 50257) * 768 // N_RANKS
MM_SHAPE = (2048, 768, 3072)  # K6: (m, d, f) of one block's product
SRC = "ompi_tpu_torch/coll/csrc/ring_kernels.cu"
REPS = 10
LAUNCH_TIMEOUT = 200  # seconds per launcher job (four jobs)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        fail("nvidia-smi not found")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, torch) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def make(torch, numel, dtype, seed, dev, traps=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-(1 << 31), (1 << 31) - 1, (numel,),
                             generator=g, device=dev, dtype=torch.int32)
    x = torch.randn(numel, generator=g, device=dev).to(dtype)
    if not traps:
        return x
    # the numerical traps: NaN, and both zeros against each other
    x[3 + seed::1009] = float("nan")
    x[5::997] = 0.0
    x[7::991] = -0.0
    return x


def bits(torch, t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def compare(torch, got, exp):
    """(bitwise equal, max |got - exp| over non-NaN entries)."""
    eq = torch.equal(bits(torch, got), bits(torch, exp))
    if got.is_floating_point():
        both = ~(torch.isnan(got) | torch.isnan(exp))
        err = (got[both].float() - exp[both].float()).abs().max().item() \
            if both.any() else 0.0
        nan_ok = torch.equal(torch.isnan(got), torch.isnan(exp))
        return eq and nan_ok, err
    return eq, float((got.long() - exp.long()).abs().max().item())


def kernel_checks(torch, K, dev, card):
    """Phase 2: every kernel against its plain version, then timings."""
    n = N_RANKS
    results = {"ring_rs_hop": 0.0, "ring_ag_hop": 0.0, "linear_fold": 0.0}
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        main = MAIN_BYTES // torch.empty(0, dtype=dtype).element_size()
        for numel, off in ((main, 0), (4099, 0), (1027, 1)):
            chunk = numel // n if numel == main else numel
            srcs = [make(torch, numel + off, dtype, 10 + p, dev)[off:]
                    for p in range(n)]
            a, b = srcs[0][:chunk], srcs[1][:chunk]
            for op in K.OP_CODES:
                where = f"{dtype} {op} numel={numel} offset={off}"
                d1, d2 = torch.empty_like(a), torch.empty_like(a)
                p1 = torch.empty_like(a)
                K.ring_rs_hop(a, b, d1, op, dst2=d2)
                K.ring_rs_hop_plain(a, b, p1, op)
                for got in (d1, d2):
                    ok, err = compare(torch, got, p1)
                    if not ok:
                        fail(f"ring_rs_hop != plain ({where}), err {err}")
                    results["ring_rs_hop"] = max(results["ring_rs_hop"], err)
                f1 = torch.empty_like(srcs[0])
                fp = torch.empty_like(srcs[0])
                K.linear_fold(srcs, f1, op)
                K.linear_fold_plain(srcs, fp, op)
                ok, err = compare(torch, f1, fp)
                if not ok:
                    fail(f"linear_fold != plain ({where}), err {err}")
                results["linear_fold"] = max(results["linear_fold"], err)
            g1, g2 = torch.empty_like(a), torch.empty_like(a)
            q1, q2 = torch.empty_like(a), torch.empty_like(a)
            K.ring_ag_hop(a, g1, dst2=g2)
            K.ring_ag_hop_plain(a, q1, dst2=q2)
            for got, exp in ((g1, q1), (g2, q2)):
                ok, err = compare(torch, got, exp)
                if not ok:
                    fail(f"ring_ag_hop != plain ({dtype} numel={numel} "
                         f"offset={off}), err {err}")
                results["ring_ag_hop"] = max(results["ring_ag_hop"], err)
            torch.cuda.synchronize()
            del srcs, a, b, d1, d2, p1, f1, fp, g1, g2, q1, q2
    print(f"kernels: K1-K3 bitwise equal to their plain versions for "
          f"float32/bfloat16/int32 x SUM/PROD/MIN/MAX at {MAIN_BYTES} B "
          f"over {n} ranks and two ragged shapes [{card}]", flush=True)

    fused_checks(torch, K, dev, card, results)

    # timings at the main paths' shapes: K1-K3 float32 SUM over the
    # 256 MiB Allreduce, K5 float32 with momentum and scaling at the wte
    # chunk, K6 float32 (and bfloat16, printed) at the MLP block
    numel = MAIN_BYTES // 4
    chunk = numel // n
    srcs = [make(torch, numel, torch.float32, 20 + p, dev) for p in range(n)]
    carry, own = srcs[0][:chunk], srcs[1][:chunk]
    dst, dst2 = torch.empty_like(carry), torch.empty_like(carry)
    pair = torch.empty(2, chunk, device=dev)
    fold = torch.empty_like(srcs[0])
    cb = chunk * 4
    rows = []

    def row(name, replaces, ms, plain_ms, lib_ms, nbytes, ops,
            ops_per_s=F32_OPS_PER_S, record=True, why_no_library=""):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        if record:
            rows.append({"name": name, "route": "cuda", "source": SRC,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": results[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "library_ms": lib_ms})
        lib = f"library {lib_ms:.4f} ms" if lib_ms is not None else \
            f"library none: {why_no_library}"
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"{lib}, bound {bound:.4f} ms by {by}) at {nbytes} B moved, "
              f"{ops} operations [{card}]", flush=True)

    K.reset_launches()
    row("ring_rs_hop", "ompi_tpu/coll/pallas_kernels.py:529",
        median_ms(lambda: K.ring_rs_hop(carry, own, dst, "MPI_SUM"), torch),
        median_ms(lambda: K.ring_rs_hop_plain(carry, own, dst, "MPI_SUM"),
                  torch),
        median_ms(lambda: torch.add(carry, own, out=dst), torch),
        3 * cb, chunk)
    row("ring_ag_hop", "ompi_tpu/coll/pallas_kernels.py:565",
        median_ms(lambda: K.ring_ag_hop(carry, dst, dst2=dst2), torch),
        median_ms(lambda: K.ring_ag_hop_plain(carry, dst, dst2=dst2),
                  torch),
        median_ms(lambda: torch.stack((carry, carry), out=pair), torch),
        3 * cb, 0)
    row("linear_fold", "ompi_tpu/coll/pallas_kernels.py:389",
        median_ms(lambda: K.linear_fold(srcs, fold, "MPI_SUM"), torch),
        median_ms(lambda: K.linear_fold_plain(srcs, fold, "MPI_SUM"), torch),
        median_ms(lambda: torch.sum(torch.stack(srcs), 0), torch),
        (n + 1) * numel * 4, (n - 1) * numel)
    del srcs, carry, own, dst, dst2, pair, fold

    k = WTE_CHUNK
    a, b, p, v = (make(torch, k, torch.float32, 30 + i, dev, traps=False)
                  for i in range(4))
    po, vo = torch.empty_like(p), torch.empty_like(v)
    c = [K.shard_const(x, torch.float32) for x in (0.01, 0.9, 1 / n)]

    def k5(fn):
        return lambda: fn(a, b, p, v, po, vo, c[0], c[1], c[2])

    row("ring_rs_update_hop", "ompi_tpu/coll/pallas_kernels.py:601",
        median_ms(k5(K.ring_rs_update_hop), torch),
        median_ms(k5(K.ring_rs_update_hop_plain), torch), None,
        6 * 4 * k, 6 * k,
        why_no_library="no single PyTorch call reduces two chunks and "
                       "applies the momentum-SGD update")
    del a, b, p, v, po, vo

    m, d, f = MM_SHAPE
    for dtype, rate, record in ((torch.float32, F32_OPS_PER_S, True),
                                (torch.bfloat16, BF16_OPS_PER_S, False)):
        x = torch.randn(m, d, device=dev).to(dtype)
        w = torch.randn(d, f, device=dev).to(dtype)
        o = torch.empty(m, f, device=dev, dtype=dtype)
        row("block_matmul" if record else "block_matmul (bfloat16)",
            "ompi_tpu/coll/pallas_kernels.py:659",
            median_ms(lambda: K.block_matmul(x, w, o), torch),
            median_ms(lambda: K.block_matmul_plain(x, w, o), torch),
            median_ms(lambda: torch.matmul(x, w, out=o), torch),
            (m * d + d * f + m * f) * x.element_size(), 2 * m * d * f,
            ops_per_s=rate, record=record)
        del x, w, o
    torch.cuda.empty_cache()
    return rows


def fused_checks(torch, K, dev, card, results):
    """Phase 2 for the training path's kernels: K5 bitwise, K6 to its
    tolerance, each against its plain version on the card."""
    results["ring_rs_update_hop"] = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for numel, off in ((WTE_CHUNK, 0), (4099, 0), (1027, 1)):
            a, b, p, v = (make(torch, numel + off, dtype, 40 + i, dev,
                               traps=False)[off:] for i in range(4))
            c = [K.shard_const(x, dtype) for x in (0.01, 0.9, 1 / N_RANKS)]
            for mom in (False, True):
                for inv in (False, True):
                    got = [torch.empty_like(p), torch.empty_like(p)]
                    exp = [torch.empty_like(p), torch.empty_like(p)]
                    for fn, o in ((K.ring_rs_update_hop, got),
                                  (K.ring_rs_update_hop_plain, exp)):
                        fn(a, b, p, v if mom else None, o[0],
                           o[1] if mom else None, c[0],
                           c[1] if mom else None, c[2] if inv else None)
                    for j in range(2 if mom else 1):
                        ok, err = compare(torch, got[j], exp[j])
                        if not ok:
                            fail(f"ring_rs_update_hop != plain ({dtype} "
                                 f"numel={numel} offset={off} momentum="
                                 f"{mom} inv={inv}), err {err}")
                        results["ring_rs_update_hop"] = max(
                            results["ring_rs_update_hop"], err)
            torch.cuda.synchronize()
            del a, b, p, v, got, exp
    print(f"kernels: K5 bitwise equal to its plain version for "
          f"float32/bfloat16/int32, with and without momentum and "
          f"scaling, at {WTE_CHUNK} elements and two ragged shapes "
          f"[{card}]", flush=True)

    results["block_matmul"] = 0.0
    g = torch.Generator(device=dev).manual_seed(50)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    cases = [(MM_SHAPE, dt, dt) for dt in (torch.float32, torch.bfloat16,
                                             torch.int32)]
    cases += [((130, 70, 200), dt, dt) for dt in (torch.float32,
                                                  torch.bfloat16,
                                                  torch.int32)]
    cases += [((1, 5, 3), torch.float32, torch.float32),
              ((33, 65, 17), torch.int32, torch.bfloat16),
              ((33, 65, 17), torch.float32, torch.bfloat16),
              ((33, 65, 17), torch.int32, torch.float32)]
    errs = {}
    for (m, d, f), xdt, wdt in cases:
        def operand(shape, dt):
            if dt == torch.int32:
                lim = 1 << 31 if xdt == wdt else 50
                return torch.randint(-lim, lim - 1, shape, generator=g,
                                     device=dev, dtype=dt)
            return torch.randn(shape, generator=g, device=dev).to(dt)

        x, w = operand((m, d), xdt), operand((d, f), wdt)
        dt = torch.promote_types(xdt, wdt)
        got = torch.empty(m, f, device=dev, dtype=dt)
        exp = torch.empty_like(got)
        K.block_matmul(x, w, got)
        K.block_matmul_plain(x, w, exp)
        torch.cuda.synchronize()
        where = f"{tuple(x.shape)} {xdt} @ {tuple(w.shape)} {wdt}"
        if dt == torch.int32:
            if not torch.equal(got, exp):
                fail(f"block_matmul != plain ({where})")
            continue
        mag = x.to(dt).float().abs() @ w.to(dt).float().abs()
        diff = (got.float() - exp.float()).abs()
        if not bool((diff <= tol[dt] * mag).all()):
            fail(f"block_matmul != plain beyond {tol[dt]} x (|x| @ |w|) "
                 f"({where})")
        err = diff.max().item()
        errs[str(dt)] = max(errs.get(str(dt), 0.0), err)
        results["block_matmul"] = max(results["block_matmul"], err)
        del x, w, got, exp, mag, diff
    print(f"kernels: K6 within tol x (|x| @ |w|) of its plain version "
          f"(float32 1e-5, bfloat16 2e-2; max abs err {errs}), int32 "
          f"exact, at {MM_SHAPE} and ragged and mixed-dtype shapes "
          f"[{card}]", flush=True)


def main_path(example: str, nranks: int, args, card: str, root: str):
    """Phase 3: one launcher job of an example; returns the ranks'
    summed launches and rank 0's report."""
    name = os.path.splitext(example)[0]
    out = os.path.join(root, "build", "ompi_tpu_torch",
                       f"smoke_{name}_n{nranks}")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
           "-n", str(nranks), "--timeout", str(LAUNCH_TIMEOUT),
           "--mca", "device_plane", "on", "--mca", "coll_cuda", "on",
           os.path.join(root, "ompi_tpu_torch", "examples", example),
           *args, "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT + 30)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"{line} [{card}]", flush=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"{name}: {nranks}-rank launcher job exited {proc.returncode}")
    launches: dict = {}
    docs = []
    for r in range(nranks):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            doc = json.load(f)
        docs.append(doc)
        bad = [c for c in doc["cases"] if not c["ok"]]
        if bad:
            fail(f"{name}: rank {r} of {nranks}: mismatches {bad}")
        if not doc["device"].startswith("cuda"):
            fail(f"{name}: rank {r} ran on {doc['device']}")
        for k, v in doc["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if not launches or min(launches.values()) <= 0:
        fail(f"{name} n={nranks}: a kernel of the path never launched: "
             f"{launches}")
    print(f"main path {name} n={nranks}: {wall:.1f} s wall, kernel "
          f"launches (all ranks) {launches} [{card}]", flush=True)
    return launches, docs[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        from ompi_tpu_torch.coll import cuda_kernels as K
    except ImportError as exc:
        fail(f"the ompi_tpu_torch package is not beside this script: {exc}")
    card = card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} [{card}]", flush=True)

    t0 = time.perf_counter()
    K.build(verbose=True)
    K.lib()
    print(f"build: kernels built for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # the plain and library float32 products run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = kernel_checks(torch, K, dev, card)
    coll, _ = main_path("device_collectives.py", N_RANKS,
                        ["--sizes", "1k,1m,64m,256m"], card, root)
    main_path("device_collectives.py", 3, ["--sizes", "1k,1m,64m"], card,
              root)
    train, doc = main_path("zero_training.py", N_RANKS, [], card, root)
    if doc["parameters"] != 124_439_808:
        fail(f"zero_training ran {doc['parameters']} parameters, not "
             "GPT-2 small's 124,439,808")
    print(f"training step n={N_RANKS} (rank 0 p50 ms): "
          + ", ".join(f"{m} {v['p50']:.3f}" for m, v in
                      doc["step_ms"].items())
          + f"; allgather_matmul p50 ms {doc['allgather_matmul_ms']} "
          f"[{card}]", flush=True)
    main_path("zero_training.py", 3, ["--layers", "4"], card, root)
    for r in rows:
        r["launches"] = (coll if r["name"] in coll else train)[r["name"]]

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
