"""rma_table_ab.py — how K8's descriptor table reaches the card, in turns.

``orm_apply_strided_batch`` (``ompi_tpu_torch/osc/csrc/rma_kernels.cu``)
passes its table by value in the kernel's parameter block
(``__grid_constant__``). This script builds a copy of the source with one
more entry point that instead copies the table with ``cudaMemcpyAsync``
from pinned host memory into a device buffer (an event guards the pinned
buffer's reuse) and launches the same tile loop over it, checks both
against the plain version, and times both per call (CUDA events around
one call, ``chip_smoke.median_ms``) in the order parameter, copy, copy,
parameter, at tables of 1, 16, 128, 1016 and 2048 embedding rows of 128
float32 (SUM into a 2**20 x 128 shard). Run from the repository root on a
machine with a CUDA card::

    python3 scripts/rma_table_ab.py

Prints one line per measurement with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402
from ompi_tpu_torch.coll import cuda_kernels as K  # noqa: E402
from ompi_tpu_torch.osc import cuda_kernels as O  # noqa: E402

#: the copy transport, appended to a copy of rma_kernels.cu
COPY_ENTRY = r'''
template <typename T>
__global__ void __launch_bounds__(OTC_THREADS)
apply_batch_copied(T* __restrict__ win, const ApplyDesc* tab, int n,
                   int tiles) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        apply_tile<T>(win, tab, n, t);
}

static ApplyDesc* ab_host = nullptr;
static ApplyDesc* ab_dev = nullptr;
static cudaEvent_t ab_copied = nullptr;

extern "C" int orm_apply_strided_batch_copied(int dtype, void* win,
                                              const void* descs, int n,
                                              void* stream) {
    if (n <= 0 || n > ORM_TABLE_MAX) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int rc;
    if (ab_host == nullptr) {
        size_t bytes = sizeof(ApplyDesc) * ORM_TABLE_MAX;
        if ((rc = (int)cudaMallocHost((void**)&ab_host, bytes))) return rc;
        if ((rc = (int)cudaMalloc((void**)&ab_dev, bytes))) return rc;
        if ((rc = (int)cudaEventCreateWithFlags(
                 &ab_copied, cudaEventDisableTiming))) return rc;
    } else if ((rc = (int)cudaEventSynchronize(ab_copied))) {
        return rc;  // the last copy has left the pinned buffer
    }
    const ApplyDesc* in = (const ApplyDesc*)descs;
    int64_t tiles = 0;
    for (int i = 0; i < n; ++i) {
        const int64_t te = in[i].s == 1 ? ORM_TILE_BYTES / esize(dtype)
                                        : OTC_THREADS;
        ab_host[i] = in[i];
        ab_host[i].tile0 = (int32_t)tiles;
        tiles += (in[i].k + te - 1) / te;
    }
    if ((rc = (int)cudaMemcpyAsync(ab_dev, ab_host, sizeof(ApplyDesc) * n,
                                   cudaMemcpyHostToDevice, st))) return rc;
    if ((rc = (int)cudaEventRecord(ab_copied, st))) return rc;
    int grid = grid_for(tiles * OTC_THREADS);
    switch (dtype) {
    case DT_F32:
        apply_batch_copied<float><<<grid, OTC_THREADS, 0, st>>>(
            (float*)win, ab_dev, n, (int)tiles);
        break;
    case DT_BF16:
        apply_batch_copied<__nv_bfloat16><<<grid, OTC_THREADS, 0, st>>>(
            (__nv_bfloat16*)win, ab_dev, n, (int)tiles);
        break;
    case DT_I32:
        apply_batch_copied<int32_t><<<grid, OTC_THREADS, 0, st>>>(
            (int32_t*)win, ab_dev, n, (int)tiles);
        break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
'''


def variant() -> str:
    """The checkout's rma_kernels.cu with the copy transport appended."""
    with open(O._SRC) as f:
        src = f.read()
    out = os.path.join(K.build_dir(), "rma_ab", "osc", "csrc")
    os.makedirs(out, exist_ok=True)
    inc = os.path.join(K.build_dir(), "rma_ab", "coll", "csrc")
    os.makedirs(inc, exist_ok=True)
    for header in K.HEADERS:
        shutil.copy(header, inc)
    path = os.path.join(out, "rma_kernels_copied.cu")
    with open(path, "w") as f:
        f.write(src + COPY_ENTRY)
    return path


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rma_table_ab: needs a CUDA card")
    card = S.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lib = ctypes.CDLL(K.build(variant()))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("orm_apply_strided_batch", "orm_apply_strided_batch_copied"):
        getattr(lib, name).argtypes = [i, p, p, i, p]
        getattr(lib, name).restype = i
    fns = {"parameter": lib.orm_apply_strided_batch,
           "copy": lib.orm_apply_strided_batch_copied}
    rows_n, dim = S.EMB_ROWS, S.EMB_DIM
    win = S.make(torch, rows_n * dim, torch.float32, 90, dev, traps=False)
    grads = S.make(torch, 2048 * dim, torch.float32, 91, dev, traps=False)
    g = torch.Generator().manual_seed(92)
    ids = torch.randperm(rows_n, generator=g)[:2048].tolist()
    code = K.DTYPE_CODES[torch.float32]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def tables(n):
        rows = [(grads.data_ptr() + j * dim * 4, r * dim, dim, 1,
                 O.KINDS["sum"], 0) for j, r in enumerate(ids[:n])]
        return [np.array(rows[c:c + O.TABLE_CAP], dtype=O._APPLY_DESC)
                for c in range(0, n, O.TABLE_CAP)]

    for how, fn in fns.items():  # both transports against the plain loop
        tabs = tables(2048)
        got, want = win.clone(), win.clone()
        for tab in tabs:
            rc = fn(code, got.data_ptr(), tab.ctypes.data, len(tab), stream)
            if rc != 0:
                raise SystemExit(f"{how}: launch returned {rc}")
        O.rma_apply_strided_batch_plain(want, [
            (grads[j * dim:(j + 1) * dim], r * dim, 1, "sum")
            for j, r in enumerate(ids)])
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"{how}: the batch differs from the plain loop")
        del got, want
    for n in (1, 16, 128, O.TABLE_CAP, 2048):
        tabs = tables(n)

        def call(fn):
            for tab in tabs:
                fn(code, win.data_ptr(), tab.ctypes.data, len(tab), stream)

        for how in ("parameter", "copy", "copy", "parameter"):
            ms = S.median_ms(lambda: call(fns[how]), torch)
            print(f"rma_table_ab {n} rows of {dim} ({len(tabs)} launches) "
                  f"{how}: {ms:.4f} ms per call [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
