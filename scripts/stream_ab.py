"""stream_ab.py — the HBM-bound kernels of several trees, in turns,
beside the port's wrapper and the PyTorch call for the same function: K1
(``otc_rs_hop``) and K7 (``orm_apply``) on the streaming engine, K10
(``orm_permute_recv``, and its grouped launch ``orm_permute_recv_batch``)
and K5b (``otc_linear_fold_update``).

Each ``--build LABEL=DIR`` compiles ``ring_kernels.cu`` and
``rma_kernels.cu`` of the tree at DIR (``.`` is this checkout; a parent
unpacked with ``git archive <commit> | tar -x -C build/parent``) into
``build/stream_ab/`` — one nvcc per source, side by side, with
``-Xptxas -v`` (each kernel's registers, spills and shared memory are
printed) — and calls its C entry points through ctypes. ``wrapper`` is
this checkout's ``ring_rs_hop`` / ``rma_apply`` /
``rma_permute_recv(_batch)`` / ``linear_fold_update``, the call the paths
make. Every build and the wrapper are held bitwise against
the plain versions at every shape first (outputs poisoned; one that does
not build or disagrees is reported and left out); then each case is
timed per call (CUDA events around one call, median of 10:
``chip_smoke.median_ms``), on the device alone and on the host alone
(launches queued behind a sleeping kernel: ``chip_smoke.queued_ms``; the
host time is the enqueueing of one call), all in turns, forward then
backward, ``--rounds`` times. Run from the repository root on a machine
with a CUDA card::

    python3 scripts/stream_ab.py --build old=build/parent --build new=. \\
        [--rounds 4] [--only K5b,K10] [--out DIR]

Shapes: K1 float32 SUM at the collectives path's chunks (64 MiB, with
and without ``dst2``, the last hop's second output; 16 MiB; 1 MiB, a ZeRO
bucket's; 256 KiB and 256 B, of the 1 MiB and 1 KiB Allreduce); K7 float32
put and SUM at the halo tile (2**26 floats), SUM of one 128-float row of a
2**20 x 128 embedding shard; K10 the 2**26-float block (beside ``copy_``)
and the 4-rank embedding lookup's exchange at one reader (4 blocks of 128
rows of 128 floats, beside ``torch.cat(out=)``); K5b at the training
path's largest chunk (9,846,336 elements), momentum and scaling, float32
and bfloat16 over 4 and 3 slices, int32 over 4. Prints a table per case
(median over rounds [min-max] of the per-call and device times, the host
time, achieved TB/s on the device, share of the bound at 3.35 TB/s) with
the card's name and power limit, and writes every sample to
``<out>/samples.json``.
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
KERNEL_WORDS = ("rs_hop", "apply_kernel", "stream", "copy", "fold_update")
#: K5b's chunk: the training path's largest bucket over 4 ranks
WTE_CHUNK = S.WTE_CHUNK
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


def load(paths: dict) -> dict:
    """A build's C entry points: K1, K7, K10 (single and grouped) and
    K5b."""
    p, i, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_uint32
    ring = ctypes.CDLL(paths["ring"][0])
    ring.otc_rs_hop.argtypes = [i, i, p, p, p, p, i64, p]
    ring.otc_linear_fold_update.argtypes = [i, i, ctypes.POINTER(p), i, p,
                                            p, p, p, u32, u32, u32, i, i64,
                                            p]
    rma = ctypes.CDLL(paths["rma"][0])
    rma.orm_apply.argtypes = [i, i, p, i64, p, i64, i64, p]
    rma.orm_permute_recv.argtypes = [i, p, p, i64, p]
    rma.orm_permute_recv_batch.argtypes = [i, ctypes.c_char_p, i, p]
    return {"K1": ring.otc_rs_hop, "K7": rma.orm_apply,
            "K5b": ring.otc_linear_fold_update, "K10": rma.orm_permute_recv,
            "K10 batch": rma.orm_permute_recv_batch}


def cases(dev):
    """(name, bytes moved, maker of a build's call from its entry points,
    the wrapper's call, the library call or None, outputs to poison and
    compare with their plain results, a fold's input to restore) for
    every shape; buffers made here."""
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

        def k1(fns, a=a, b=b, d=d, d2=d2, two=two, n=numel):
            fn = fns["K1"]
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

        def k7(fns, w=w, p=p, op=op, d=d, k=k):
            fn = fns["K7"]
            return lambda: check_rc(fn(0, op, w.data_ptr(), w.numel(),
                                       p.data_ptr(), k, d, stream))

        wrap = (lambda w=w, p=p, d=d, kind="put" if op == 4 else "sum":
                O.rma_apply(w, p, d, kind))
        lib = (lambda v=view, p=p: v.copy_(p)) if op == 4 else \
            (lambda v=view, p=p: v.add_(p))
        # a put's window is poisoned first; a fold's is its own input
        out.append((label, (2 if op == 4 else 3) * k * 4, k7, wrap, lib,
                    [(view, want)], snap if op != 4 else None))
    out += k10_cases(dev, stream, pay)
    out += k5b_cases(dev, stream)
    return out


def k10_cases(dev, stream, pay):
    """K10 at the 2**26-float block and at the 4-rank lookup's exchange."""
    land = torch.empty_like(pay)

    def single(fns):
        fn = fns["K10"]
        return lambda: check_rc(fn(0, pay.data_ptr(), land.data_ptr(),
                                   pay.numel(), stream))

    out = [("K10 2**26", 2 * pay.numel() * 4, single,
            lambda: O.rma_permute_recv(pay, land),
            lambda: land.copy_(pay), [(land, pay.clone())], None)]
    per = 128 * 128
    staged = [pay[q * 2 * per:q * 2 * per + per] for q in range(4)]
    got = land[:4 * per]
    pulls = [(staged[q], got[q * per:(q + 1) * per]) for q in range(4)]

    def batch(fns):
        fn = fns["K10 batch"]
        (tab, n), = O.copy_tables(pulls)
        return lambda: check_rc(fn(0, tab, n, stream))

    out.append(("K10 lookup 4x64KiB", 2 * 4 * per * 4, batch,
                lambda: O.rma_permute_recv_batch(pulls),
                lambda: torch.cat(staged, out=got),
                [(got, torch.cat(staged))], None))
    return out


def k5b_cases(dev, stream):
    """K5b at the training chunk, momentum and scaling: float32 and
    bfloat16 over 4 and 3 slices, int32 over 4."""
    out = []
    k = WTE_CHUNK
    for label, dtype, n in (("K5b f32 n=4", torch.float32, 4),
                            ("K5b f32 n=3", torch.float32, 3),
                            ("K5b bf16 n=4", torch.bfloat16, 4),
                            ("K5b bf16 n=3", torch.bfloat16, 3),
                            ("K5b i32 n=4", torch.int32, 4)):
        srcs = [S.make(torch, k, dtype, 30 + j, dev, traps=False)
                for j in range(n)]
        p = S.make(torch, k, dtype, 40, dev, traps=False)
        v = S.make(torch, k, dtype, 41, dev, traps=False)
        po, vo = torch.empty_like(p), torch.empty_like(v)
        c = [K.shard_const(x, dtype) for x in (0.01, 0.9, 1 / n)]
        wp, wv = torch.empty_like(p), torch.empty_like(v)
        K.linear_fold_update_plain(srcs, p, v, wp, wv, *c)
        code = K.DTYPE_CODES[dtype]
        bits = [K._const_bits(x) for x in c]

        def k5b(fns, srcs=srcs, p=p, v=v, po=po, vo=vo, code=code,
                bits=bits, n=n):
            fn = fns["K5b"]
            ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in srcs])
            return lambda: check_rc(fn(code, 0, ptrs, n, p.data_ptr(),
                                       v.data_ptr(), po.data_ptr(),
                                       vo.data_ptr(), *bits, 1, k, stream))

        wrap = (lambda srcs=srcs, p=p, v=v, po=po, vo=vo, c=c:
                K.linear_fold_update(srcs, p, v, po, vo, *c))
        out.append((label, (n + 4) * k * p.element_size(), k5b, wrap, None,
                    [(po, wp), (vo, wv)], None))
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
    ap.add_argument("--only", default="",
                    help="comma-separated case prefixes (K1,K7,K10,K5b)")
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
        if ns.only and not name.startswith(tuple(ns.only.split(","))):
            continue
        made = {lb: maker(fns[lb]) for lb in fns}
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
        json.dump({"card": card, "builds": [
            f"{lb}={tree}" for lb, tree in specs],
                   "rounds": ns.rounds, "cases": samples}, f, indent=1)
    print(f"stream_ab: {len(samples)} cases x {len(fns) + 2} in "
          f"{ns.rounds} rounds [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
