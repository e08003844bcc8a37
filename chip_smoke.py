"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on
a GPU. Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the ring kernels from ``ompi_tpu_torch/coll/csrc/ring_kernels.cu``
   with nvcc for sm_90a (into ``build/ompi_tpu_torch/``);
2. hold every kernel (K1 ring_rs_hop, K2 ring_ag_hop, K3 linear_fold)
   against its plain PyTorch version on the card, for float32, bfloat16
   and int32 x SUM/PROD/MIN/MAX, at the main path's shape (a 256 MiB
   payload over 4 ranks) and at two ragged small shapes (one of them not
   16-byte aligned) — bitwise; inputs carry NaN and +-0. Then time each
   kernel (float32 SUM, CUDA events, median of 10) beside its plain
   version, one PyTorch library call and its bound;
3. the main path: the launcher runs
   ``ompi_tpu_torch/examples/device_collectives.py`` with 4 ranks (every
   rank on this card) and then 3 ranks, ``--mca device_plane on --mca
   coll_cuda on``: Allreduce float32 at 1 KiB, 1 MiB, 64 MiB and 256 MiB
   under linear, ring and the default mode, bfloat16 and int32 at 1 MiB,
   Reduce_scatter_block and Allgather at 64 MiB. Each rank checks its
   results against plain-version results and reports its kernels'
   launch counts, which the ranks zero just before the path runs.

Output: one line per measurement with the card's name and power limit,
then ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
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
N_RANKS = 4
MAIN_BYTES = 256 << 20  # the main path's largest Allreduce payload
REPS = 10
LAUNCH_TIMEOUT = 420  # seconds per launcher job


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


def make(torch, numel, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-(1 << 31), (1 << 31) - 1, (numel,),
                             generator=g, device=dev, dtype=torch.int32)
    x = torch.randn(numel, generator=g, device=dev).to(dtype)
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

    # timings at the main path's shape, float32 SUM
    numel = MAIN_BYTES // 4
    chunk = numel // n
    srcs = [make(torch, numel, torch.float32, 20 + p, dev) for p in range(n)]
    carry, own = srcs[0][:chunk], srcs[1][:chunk]
    dst, dst2 = torch.empty_like(carry), torch.empty_like(carry)
    pair = torch.empty(2, chunk, device=dev)
    fold = torch.empty_like(srcs[0])
    cb = chunk * 4
    rows = []

    def row(name, src, replaces, ms, plain_ms, lib_ms, nbytes, ops):
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S \
            else "operations"
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": results[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms})
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {bound:.4f} ms by {by}) "
              f"at {nbytes} B moved [{card}]", flush=True)

    src = "ompi_tpu_torch/coll/csrc/ring_kernels.cu"
    K.reset_launches()
    row("ring_rs_hop", src, "ompi_tpu/coll/pallas_kernels.py:529",
        median_ms(lambda: K.ring_rs_hop(carry, own, dst, "MPI_SUM"), torch),
        median_ms(lambda: K.ring_rs_hop_plain(carry, own, dst, "MPI_SUM"),
                  torch),
        median_ms(lambda: torch.add(carry, own, out=dst), torch),
        3 * cb, chunk)
    row("ring_ag_hop", src, "ompi_tpu/coll/pallas_kernels.py:565",
        median_ms(lambda: K.ring_ag_hop(carry, dst, dst2=dst2), torch),
        median_ms(lambda: K.ring_ag_hop_plain(carry, dst, dst2=dst2),
                  torch),
        median_ms(lambda: torch.stack((carry, carry), out=pair), torch),
        3 * cb, 0)
    row("linear_fold", src, "ompi_tpu/coll/pallas_kernels.py:389",
        median_ms(lambda: K.linear_fold(srcs, fold, "MPI_SUM"), torch),
        median_ms(lambda: K.linear_fold_plain(srcs, fold, "MPI_SUM"), torch),
        median_ms(lambda: torch.sum(torch.stack(srcs), 0), torch),
        (n + 1) * numel * 4, (n - 1) * numel)
    del srcs, carry, own, dst, dst2, pair, fold
    torch.cuda.empty_cache()
    return rows


def main_path(nranks: int, sizes: str, card: str, root: str):
    """Phase 3: one launcher job; returns the ranks' summed launches."""
    out = os.path.join(root, "build", "ompi_tpu_torch", f"smoke_n{nranks}")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
           "-n", str(nranks), "--timeout", str(LAUNCH_TIMEOUT),
           "--mca", "device_plane", "on", "--mca", "coll_cuda", "on",
           os.path.join(root, "ompi_tpu_torch", "examples",
                        "device_collectives.py"),
           "--sizes", sizes, "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT + 60)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"{line} [{card}]", flush=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"{nranks}-rank launcher job exited {proc.returncode}")
    launches: dict = {}
    for r in range(nranks):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            doc = json.load(f)
        bad = [c for c in doc["cases"] if not c["ok"]]
        if bad:
            fail(f"rank {r} of {nranks}: mismatches {bad}")
        if not doc["device"].startswith("cuda"):
            fail(f"rank {r} ran on {doc['device']}")
        for k, v in doc["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if not launches or min(launches.values()) <= 0:
        fail(f"{nranks}-rank main path: a kernel never launched: "
             f"{launches}")
    print(f"main path n={nranks}: {wall:.1f} s wall, kernel launches "
          f"(all ranks) {launches} [{card}]", flush=True)
    return launches


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
    print(f"build: ring kernels built for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    rows = kernel_checks(torch, K, dev, card)
    launches = main_path(N_RANKS, "1k,1m,64m,256m", card, root)
    main_path(3, "1k,1m,64m", card, root)
    for r in rows:
        r["launches"] = launches[r["name"]]

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
