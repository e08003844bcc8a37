"""gemm_ab.py — K6's ``wgmma`` kernel at other ring depths, in turns.

Builds copies of ``ompi_tpu_torch/coll/csrc/gemm_kernels.cu`` that differ
only in ``WG_STAGES`` (the shared-memory ring's stages) into
``build/gemm_ab/``, checks each copy's ``otc_wgmma_matmul`` against
``torch.matmul`` (|err| <= 2e-2 x (|x| @ |w|)) and times it with its
launches queued behind a sleeping kernel (``chip_smoke.queued_ms``), in
the order given and then reversed, beside ``torch.matmul``. Run from the
repository root on a machine with a CUDA card::

    python3 scripts/gemm_ab.py [--stages 4,5,6] [--shapes 2048x768x3072]

Prints one line per measurement with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402
from ompi_tpu_torch.coll import cuda_kernels as K  # noqa: E402

LINE = "#define WG_STAGES 4"


def variant(stages: int) -> str:
    """The checkout's gemm_kernels.cu with ``stages`` ring stages."""
    with open(K.GEMM_SRC) as f:
        src = f.read()
    if LINE not in src:
        raise SystemExit(f"{K.GEMM_SRC}: no '{LINE}' to vary")
    out = os.path.join(K.build_dir(), "gemm_ab")
    os.makedirs(out, exist_ok=True)
    for header in K.HEADERS:
        shutil.copy(header, out)
    path = os.path.join(out, f"gemm_s{stages}.cu")
    with open(path, "w") as f:
        f.write(src.replace(LINE, f"#define WG_STAGES {stages}"))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", default="4,5,6")
    ap.add_argument("--shapes", default="2048x768x3072,4096x768x3072")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_ab: needs a CUDA card")
    card = S.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fns = {}
    for st in (int(s) for s in ns.stages.split(",")):
        lib = ctypes.CDLL(K.build(variant(st)))
        lib.otc_wgmma_matmul.argtypes = [p, p, p, i64, i64, i64, i, p]
        fns[st] = lib.otc_wgmma_matmul
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(1)
    for shape in ns.shapes.split(","):
        m, d, f = (int(v) for v in shape.split("x"))
        x = torch.randn(m, d, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(d, f, generator=g, device=dev).to(torch.bfloat16)
        o = torch.empty(m, f, device=dev, dtype=torch.bfloat16)
        ref = torch.matmul(x, w)
        mag = x.float().abs() @ w.float().abs()

        def call(st):
            rc = fns[st](x.data_ptr(), w.data_ptr(), o.data_ptr(), m, d, f,
                         sms, stream)
            if rc != 0:
                raise SystemExit(f"stages {st}: launch returned {rc}")

        for st in fns:
            call(st)
            torch.cuda.synchronize()
            if not bool(((o.float() - ref.float()).abs()
                         <= 2e-2 * mag).all()):
                raise SystemExit(f"stages {st} at {shape}: wrong product")
        order = list(fns) + list(fns)[::-1]
        for st in order:
            print(f"gemm_ab {shape} stages {st}: queued "
                  f"{S.queued_ms(lambda: call(st), torch):.4f} ms "
                  f"[{card}]", flush=True)
        lib_ms = S.queued_ms(lambda: torch.matmul(x, w, out=o), torch)
        print(f"gemm_ab {shape} torch.matmul: queued {lib_ms:.4f} ms "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
