"""rma_host_split.py — where the time of one K8 / K9 call goes on the card.

Times the strided apply (K8: an 8192-element halo column at stride 8192
into an 8192 x 8192 float32 tile) and the row read (K9: one 128-float row
of a 2**20 x 128 float32 shard), at the one-sided paths' shapes, three
ways: per call (CUDA events around one call, ``chip_smoke.median_ms``),
device only (50 launches queued behind a sleeping kernel,
``chip_smoke.queued_ms``) and, on the host clock, the parts of the
wrapper: its operand checks (and, for the grouped kernels, the strided
span and the packing of the one-row table), the stream lookup
(``torch.cuda.current_stream(dev).cuda_stream`` against ``torch._C.
_cuda_getCurrentRawStream(index)``), the ctypes call of the entry point
with nothing to launch, ``cudaGetLastError`` through ctypes, and the
whole wrapper call; and the entry point alone with its arguments made
beforehand (per call and on the host clock). The library calls the
kernels are held against (a strided view's ``copy_``, a row's
``clone()``) are timed the same ways.
Run from the repository root on a machine with a CUDA card::

    python3 scripts/rma_host_split.py [--tree DIR] [--out FILE]

``--tree`` imports ``ompi_tpu_torch`` from another checkout (a parent
unpacked with ``git archive``), so two versions are split in one call.
Prints one JSON line per kernel with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOST_CALLS = 2000  # host-clock repetitions per part


def host_us(fn, reps: int = HOST_CALLS) -> float:
    """Mean host microseconds per call of ``fn`` (after a warm-up)."""
    for _ in range(50):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    return (time.perf_counter_ns() - t0) / reps / 1e3


def cudart():
    """The CUDA runtime library, for a bare ``cudaGetLastError`` call."""
    import torch

    cands = []
    for base in (os.path.dirname(torch.__file__), *sys.path):
        cands += glob.glob(os.path.join(base, "nvidia", "cuda_runtime", "lib",
                                        "libcudart.so*"))
        cands += glob.glob(os.path.join(base, "lib", "libcudart*.so*"))
    cands += glob.glob("/usr/local/cuda/lib64/libcudart.so*")
    for path in cands:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.cudaGetLastError.restype = ctypes.c_int
        lib.cudaGetLastError.argtypes = []
        return lib
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose ompi_tpu_torch is measured")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    tree = os.path.abspath(ns.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as S  # noqa: E402  (this checkout's timers)
    sys.path.insert(0, tree)
    for mod in [m for m in sys.modules if m.startswith("ompi_tpu_torch")]:
        del sys.modules[mod]
    import torch
    from ompi_tpu_torch.osc import cuda_kernels as O

    if not torch.cuda.is_available():
        raise SystemExit("rma_host_split: needs a CUDA card")
    if not O.__file__.startswith(tree):
        raise SystemExit(f"imported {O.__file__}, not from {tree}")
    card = S.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    L = O.lib()
    rt = cudart()
    col, emb = S.HALO, S.EMB_ROWS * S.EMB_DIM
    big = S.make(torch, col * col, torch.float32, 70, dev, traps=False)
    colp = S.make(torch, col, torch.float32, 71, dev, traps=False)
    strided = torch.as_strided(big, (col,), (col,), col - 1)
    win = S.make(torch, emb, torch.float32, 72, dev, traps=False)
    row = torch.empty(S.EMB_DIM, device=dev)
    d = (S.EMB_ROWS // 3) * S.EMB_DIM
    view = win[d:d + S.EMB_DIM]
    dt = O.K.DTYPE_CODES[torch.float32]
    stream = torch.cuda.current_stream(dev).cuda_stream
    docs = []

    def report(name, kern, lib, parts, launch):
        doc = {
            "kernel": name, "tree": tree,
            "median_ms": S.median_ms(kern, torch),
            # the entry point alone, its arguments made beforehand
            "launch_median_ms": S.median_ms(launch, torch),
            "queued_ms": S.queued_ms(kern, torch),
            "library_median_ms": S.median_ms(lib, torch),
            "library_queued_ms": S.queued_ms(lib, torch),
            "host_us": {
                "wrapper": host_us(kern),
                **{k: host_us(fn) for k, fn in parts.items()},
                "launch": host_us(launch),
                "current_stream": host_us(
                    lambda: torch.cuda.current_stream(dev).cuda_stream),
                "raw_stream": host_us(
                    lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
                "cudaGetLastError": host_us(rt.cudaGetLastError)
                if rt is not None else None,
                "library": host_us(lib),
            }}
        torch.cuda.synchronize()
        docs.append(doc)
        print(json.dumps(doc) + f" [{card}]", flush=True)

    fill = O.FILL_BITS[torch.float32]
    grouped = hasattr(O, "rma_apply_strided_batch")
    one_apply = one_read = None
    if grouped:  # the grouped kernels
        one_apply = O._ONE_APPLY.pack(colp.data_ptr(), col - 1, col, col, 4,
                                      0)
        one_read = O._ONE_READ.pack(d, 1, 0, S.EMB_DIM, 0)
        # n = 0: the entry point returns before any launch
        apply_parts = {
            "check": lambda: O._check("rma_apply_strided", big, colp, "put"),
            "span": lambda: O.strided_span(big.numel(), col, col - 1, col),
            "pack": lambda: O._ONE_APPLY.pack(colp.data_ptr(), col - 1, col,
                                              col, 4, 0),
            "ctypes_no_launch": lambda: L.orm_apply_strided_batch(
                dt, big.data_ptr(), one_apply, 0, stream)}
        read_parts = {
            "check": lambda: O._check("rma_read", win, row),
            "pack": lambda: O._ONE_READ.pack(d, 1, 0, S.EMB_DIM, 0),
            "ctypes_no_launch": lambda: L.orm_read_batch(
                dt, win.data_ptr(), win.numel(), row.data_ptr(), fill,
                one_read, 0, stream)}
    else:  # one kernel per descriptor
        # k = 0: the entry point returns before any launch
        apply_parts = {
            "check": lambda: O._check("rma_apply_strided", big, colp, "put"),
            "ctypes_no_launch": lambda: L.orm_apply_strided(
                dt, 4, big.data_ptr(), big.numel(), colp.data_ptr(), 0,
                col - 1, col, stream)}
        read_parts = {
            "check": lambda: O._check("rma_read", win, row),
            "ctypes_no_launch": lambda: L.orm_read(
                dt, win.data_ptr(), win.numel(), row.data_ptr(), 0, d, 1,
                fill, stream)}
    args8 = ((dt, big.data_ptr(), one_apply, 1, stream) if grouped else
             (dt, 4, big.data_ptr(), big.numel(), colp.data_ptr(), col,
              col - 1, col, stream))
    args9 = ((dt, win.data_ptr(), win.numel(), row.data_ptr(), fill,
              one_read, 1, stream) if grouped else
             (dt, win.data_ptr(), win.numel(), row.data_ptr(), S.EMB_DIM, d,
              1, fill, stream))
    entry8 = L.orm_apply_strided_batch if grouped else L.orm_apply_strided
    entry9 = L.orm_read_batch if grouped else L.orm_read
    report("rma_apply_strided",
           lambda: O.rma_apply_strided(big, colp, col - 1, col, "put"),
           lambda: strided.copy_(colp), apply_parts,
           lambda: entry8(*args8))
    report("rma_read", lambda: O.rma_read(win, d, 1, row),
           lambda: view.clone(), read_parts, lambda: entry9(*args9))
    if ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
        with open(ns.out, "w") as f:
            json.dump({"card": card, "kernels": docs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
