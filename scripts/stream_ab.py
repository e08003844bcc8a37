"""stream_ab.py — K1 (``otc_rs_hop``) and K7 (``orm_apply``) of several
trees, in turns, beside the port's wrapper and the PyTorch call for the
same function.

Each ``--build LABEL=DIR`` compiles ``ring_kernels.cu`` and
``rma_kernels.cu`` of the tree at DIR (``.`` is this checkout; a parent
unpacked with ``git archive <commit> | tar -x -C build/parent``) into
``build/stream_ab/`` — one nvcc per source, side by side, with
``-Xptxas -v`` (each K1 / K7 kernel's registers, spills and shared memory
are printed) — and calls its C entry point through ctypes. ``wrapper`` is
this checkout's ``ring_rs_hop`` / ``rma_apply``, the call the paths make.
Every build and the wrapper are held bitwise against the plain versions at
every shape first (float32 SUM and put, outputs poisoned; one that does
not build or disagrees is reported and left out); then each case is timed
per call (CUDA events around one call, median of 10:
``chip_smoke.median_ms``), on the device alone and on the host alone
(launches queued behind a sleeping kernel: ``chip_smoke.queued_ms``; the
host time is the enqueueing of one call), all in turns, forward then
backward, ``--rounds`` times. Run from the repository root on a machine
with a CUDA card::

    python3 scripts/stream_ab.py --build old=build/parent --build new=. \\
        [--rounds 4] [--out chiprun_out/stream_ab]

Shapes (float32): K1 SUM at the collectives path's chunks (64 MiB, with
and without ``dst2``, the last hop's second output; 16 MiB; 1 MiB, a ZeRO
bucket's; 256 KiB and 256 B, of the 1 MiB and 1 KiB Allreduce); K7 put
and SUM at the halo tile (2**26 floats), SUM of one 128-float row of a
2**20 x 128 embedding shard. Prints a table per case (median over rounds
[min-max] of the per-call and device times, the host time, achieved TB/s
on the device, share of the bound at 3.35 TB/s) with the card's name and
power limit, and writes every sample to ``<out>/samples.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402
from ompi_tpu_torch.coll import cuda_kernels as K  # noqa: E402
from ompi_tpu_torch.osc import cuda_kernels as O  # noqa: E402

SOURCES = {"ring": "ompi_tpu_torch/coll/csrc/ring_kernels.cu",
           "rma": "ompi_tpu_torch/osc/csrc/rma_kernels.cu"}
#: -Xptxas -v lines are kept for entry functions whose name holds one
KERNEL_WORDS = ("rs_hop", "apply_kernel", "stream")
POISON = 0x5A  # every byte of an output before a check


def build(label: str, tree: str, out: str) -> dict:
    """Compile both sources of ``tree``; returns {source: (.so, ptxas)},
    or None (printed) when one does not build."""
    def one(kind):
        so = os.path.join(out, f"{label}_{kind}.so")
        cmd = [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
               os.path.join(tree, SOURCES[kind])]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"stream_ab: {label} {kind} does not build:\n"
                  f"{proc.stderr[-3000:]}", flush=True)
            return kind, None
        return kind, (so, ptxas_lines(proc.stderr))

    with ThreadPoolExecutor(2) as pool:
        got = dict(pool.map(one, SOURCES))
    return None if None in got.values() else got


def ptxas_lines(text: str):
    """The registers / spills / shared memory of the K1 and K7 kernels."""
    keep, name = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            name = name if any(w in name for w in KERNEL_WORDS) else None
        elif name and ("Used" in line or "spill" in line):
            keep.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return keep


def load(paths: dict):
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    ring = ctypes.CDLL(paths["ring"][0])
    ring.otc_rs_hop.argtypes = [i, i, p, p, p, p, i64, p]
    rma = ctypes.CDLL(paths["rma"][0])
    rma.orm_apply.argtypes = [i, i, p, i64, p, i64, i64, p]
    return ring.otc_rs_hop, rma.orm_apply


def cases(dev):
    """(name, bytes moved, {build: fn} maker, the wrapper's call, the
    library call or None, outputs to poison and compare with their plain
    results, a fold's input to restore) for every shape; buffers made
    here."""
    f32 = torch.float32
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    out = []
    for label, numel, two in (("K1 64MiB", 1 << 24, False),
                              ("K1 64MiB dst2", 1 << 24, True),
                              ("K1 16MiB", 1 << 22, False),
                              ("K1 1MiB", 1 << 18, False),
                              ("K1 256KiB", 1 << 16, False),
                              ("K1 256B", 64, False)):
        a = S.make(torch, numel, f32, 1, dev, traps=False)
        b = S.make(torch, numel, f32, 2, dev, traps=False)
        d, d2, want = (torch.empty_like(a) for _ in range(3))
        torch.add(a, b, out=want)
        outs = [d, d2] if two else [d]

        def k1(fn, a=a, b=b, d=d, d2=d2, two=two, n=numel):
            return lambda: check_rc(fn(0, 0, a.data_ptr(), b.data_ptr(),
                                       d.data_ptr(),
                                       d2.data_ptr() if two else None, n,
                                       stream))

        wrap = (lambda a=a, b=b, d=d, d2=d2 if two else None:
                K.ring_rs_hop(a, b, d, "MPI_SUM", d2))
        # no single PyTorch call writes two outputs
        lib = None if two else (lambda a=a, b=b, d=d: torch.add(a, b, out=d))
        out.append((label, (4 if two else 3) * numel * 4, k1, wrap, lib,
                    [(o, want) for o in outs], None))
    tile = 1 << 26
    win = S.make(torch, tile, f32, 3, dev, traps=False)
    pay = S.make(torch, tile, f32, 4, dev, traps=False)
    row_win = S.make(torch, (1 << 20) * 128, f32, 5, dev, traps=False)
    row = S.make(torch, 128, f32, 6, dev, traps=False)
    at = (1 << 20) // 3 * 128
    for label, w, p, op, d in (("K7 put 2**26", win, pay, 4, 0),
                               ("K7 sum 2**26", win, pay, 0, 0),
                               ("K7 sum 128", row_win, row, 0, at)):
        k = p.numel()
        view = w[d:d + k]
        snap = view.clone()
        want = pay.clone() if op == 4 else torch.add(snap, p)

        def k7(fn, w=w, p=p, op=op, d=d, k=k):
            return lambda: check_rc(fn(0, op, w.data_ptr(), w.numel(),
                                       p.data_ptr(), k, d, stream))

        wrap = (lambda w=w, p=p, d=d, kind="put" if op == 4 else "sum":
                O.rma_apply(w, p, d, kind))
        lib = (lambda v=view, p=p: v.copy_(p)) if op == 4 else \
            (lambda v=view, p=p: v.add_(p))
        # a put's window is poisoned first; a fold's is its own input
        out.append((label, (2 if op == 4 else 3) * k * 4, k7, wrap, lib,
                    [(view, want)], snap if op != 4 else None))
    return out


def check_rc(rc: int) -> None:
    if rc != 0:
        raise SystemExit(f"stream_ab: a launch returned CUDA error {rc}")


def verify(fn, outs, restore) -> str:
    """'' when ``fn`` writes the plain version's bits, else why not."""
    for o, _want in outs:
        if restore is None:
            o.view(torch.uint8).fill_(POISON)
        else:
            o.copy_(restore)
    try:
        fn()
    except (SystemExit, K.KernelError) as exc:  # a refused launch
        return str(exc)
    torch.cuda.synchronize()
    for o, want in outs:
        ok, err = S.compare(torch, o, want)
        if not ok:
            bad = (S.bits(torch, o) != S.bits(torch, want)).nonzero()
            return (f"!= plain at {bad.numel()} elements, first "
                    f"{bad[:4].flatten().tolist()}, max err {err}")
    return ""


def summary(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[0], xs[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--build", action="append", required=True,
                    help="LABEL=DIR")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "stream_ab"))
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_ab: needs a CUDA card")
    card = S.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    specs = []
    for spec in ns.build:
        label, _, tree = spec.partition("=")
        specs.append((label, os.path.join(ROOT, tree)))
    libdir = os.path.join(K.build_dir(), "stream_ab")
    os.makedirs(libdir, exist_ok=True)
    os.makedirs(ns.out, exist_ok=True)
    with ThreadPoolExecutor(len(specs) + 2) as pool:
        # the wrapper's two libraries, beside the builds
        wrapped = [pool.submit(K.build, src) for src in (K._SRC, O._SRC)]
        built = list(pool.map(lambda s: build(*s, libdir), specs))
        for w in wrapped:
            w.result()
    fns = {}
    for (label, _tree), paths in zip(specs, built):
        if paths is None:
            continue
        fns[label] = load(paths)
        for kind in SOURCES:
            for line in paths[kind][1]:
                print(f"ptxas {label} {kind}: {line}", flush=True)
    samples = {}
    for name, nbytes, maker, wrap, lib, outs, restore in cases(dev):
        made = {lb: maker(fns[lb][0 if name.startswith("K1") else 1])
                for lb in fns}
        made["wrapper"] = wrap
        calls = {}
        for lb, fn in made.items():  # one that computes wrong is untimed
            why = verify(fn, outs, restore)
            if why:
                print(f"stream_ab: {lb} {name} {why} [{card}]", flush=True)
            else:
                calls[lb] = fn
        if lib is not None:
            calls["library"] = lib
        order = list(calls)
        got = {lb: {"ms": [], "queued_ms": [], "host_ms": []}
               for lb in order}
        for r in range(ns.rounds):
            for lb in (order if r % 2 == 0 else order[::-1]):
                got[lb]["ms"].append(S.median_ms(calls[lb], torch))
                got[lb]["queued_ms"].append(S.queued_ms(
                    calls[lb], torch, host_ms=got[lb]["host_ms"]))
        if restore is not None:  # the folds ran many times: restore it
            outs[0][0].copy_(restore)
        samples[name] = {"bytes": nbytes, **got}
        bound = nbytes / S.HBM_BYTES_PER_S * 1e3
        print(f"{name}: {nbytes} B, bound {bound:.4f} ms [{card}]",
              flush=True)
        for lb in order:
            m, q = summary(got[lb]["ms"]), summary(got[lb]["queued_ms"])
            h = summary(got[lb]["host_ms"])
            print(f"  {lb:>8}: per call {m[0]:.4f} ms [{m[1]:.4f}-"
                  f"{m[2]:.4f}], device {q[0]:.4f} ms [{q[1]:.4f}-"
                  f"{q[2]:.4f}], host {h[0]:.4f} ms [{h[1]:.4f}-"
                  f"{h[2]:.4f}], {nbytes / q[0] / 1e9:.3f} TB/s, "
                  f"{bound / q[0]:.0%} of bound", flush=True)
    with open(os.path.join(ns.out, "samples.json"), "w") as f:
        json.dump({"card": card, "builds": [f"{lb}={tree}"
                                            for lb, tree in specs],
                   "rounds": ns.rounds, "cases": samples}, f, indent=1)
    print(f"stream_ab: {len(samples)} cases x {len(fns) + 2} in "
          f"{ns.rounds} rounds [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
