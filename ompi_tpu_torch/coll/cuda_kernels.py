"""coll/cuda_kernels — the ring collective kernels and their schedules.

Port of :mod:`ompi_tpu.coll.pallas_kernels` (the reference's K1-K6 and K5b).
Kernels written by hand in CUDA C++ for Hopper, built with nvcc for
``sm_90a`` into plain C libraries loaded with ctypes
(``csrc/ring_kernels.cu``: K1-K5b; ``csrc/gemm_kernels.cu``: K6):

- :func:`ring_rs_hop` (K1) — one reduce-scatter hop, ``dst = fn(carry,
  own)`` with the carry read from the ring neighbour's arena slot;
- :func:`ring_ag_hop` (K2) — one allgather hop, the neighbour's block
  copied into the own slot and the output (a byte copy, so any dtype);
- :func:`linear_fold` (K3) — the rank-order fold over every rank's staged
  input, ``acc = g0; acc = fn(acc, g_i)``;
- :func:`ring_rs_update_hop` (K5) — the last reduce-scatter hop fused
  with the ZeRO shard update (``g *= inv; v' = mu*v + g; p' = p -
  lr*v'``), rounded op by op so it equals the eager update bitwise;
- :func:`linear_fold_update` (K5b) — K3's fold of every rank's own slice
  fused with K5's update; no entry point of the JAX package calls its
  reference, so no path of the port does (only the schedule
  :func:`linear_reduce_scatter_update`);
- :func:`block_matmul` (K6) — one arrived block of a row-gathered
  activation times the weight, into the block's rows of the output: a
  ``wgmma`` + TMA kernel for bfloat16, a register-tiled CUDA-core kernel
  for the rest, chosen by :func:`block_matmul_variant`.

Each has a plain PyTorch version beside it (``*_plain``) doing the same
steps on the same views. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``.

The schedules (K4: :func:`allreduce`, :func:`reduce_scatter`,
:func:`allgather`; the fused :func:`reduce_scatter_update` and
:func:`allgather_matmul`; the pull schedules of coll/device,
:func:`bcast`, :func:`alltoall`, :func:`gather`, :func:`ragged` and its
rooted forms :func:`gather_to_root` and :func:`scatter_from_root`: every
rank stages its input, then K2 copies from the staged inputs; and
coll/device's :func:`binomial_reduce` and :func:`prefix`) are generators
over a
:class:`Ring` — a rank's
view of the symmetric buffers (every rank's staged input and carry
slots). They
follow the reference's chunk schedule exactly (carry starts at chunk r-d;
hop s folds ``fn(carry, own chunk r-(s+2)d)``; allgather hop s delivers
rank r-(s+1)d's block; the allreduce zero-pads to a multiple of n), so
'ring' and 'linear' results are bitwise equal to the JAX package's. A
generator yields after every step that a peer depends on; whoever runs
it then makes the step visible and waits for the ring neighbours (the
multi-process arena transport of :mod:`ompi_tpu_torch.coll.cuda`)
or simply steps the other ranks (:func:`run_lockstep`, n ranks in one
process, as the tests do).

Slot protocol: each rank owns two carry slots per ring direction. Hop
number h of direction d (counted across calls) reads the predecessor's
slot h%2 and writes the own slot (h+1)%2; an initial copy of local data
counts as a hop that reads nothing. Before hop h+1 a rank waits until
both neighbours in direction d have finished hop h: the predecessor has
written what this rank reads, and the successor has read what this rank
is about to overwrite (the two-sided handshake of the reference's
``_neighbor_handshake``).

:func:`permute` (coll/device's ``permute_dev``) is no generator: it gives
the stage and land steps of one ``Arena.exchange``, whose handshake
waits for the exchange's actual partners only.

A wrapper's argument checks raise ``ValueError``: a contract between the
wrappers and their callers inside the port (coll/cuda, coll/device,
osc/cuda), which check what a user passes at the API and raise
``MPIError`` there; the tests hold these checks as ``ValueError``. Each
such ``raise`` carries ``# check: disable=bare-public-raise; wrapper
contract`` for the check plane's lint.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.prof import ledger as _prof
from ompi_tpu_torch.trace import recorder as _trace

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
OP_CODES = {"MPI_SUM": 0, "MPI_PROD": 1, "MPI_MIN": 2, "MPI_MAX": 3}

#: the most sources K3 and K5b fold (OTC_MAX_PEERS in ring_kernels.cu)
MAX_PEERS = 64
#: marker a schedule yields for a step every rank must pass (linear)
ALL = "all"

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SRC = os.path.join(_CSRC, "ring_kernels.cu")
GEMM_SRC = os.path.join(_CSRC, "gemm_kernels.cu")
#: the headers the kernel sources include (part of each library's key)
HEADERS = (os.path.join(_CSRC, "combine.cuh"),
           os.path.join(_CSRC, "stream.cuh"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


class KernelError(RuntimeError):
    """A kernel library that does not build or load, or a launch that
    the CUDA runtime refused."""


# ---------------------------------------------------------------------------
# build + load


def build_dir() -> str:
    """``build/ompi_tpu_torch`` beside the package (the repo root's
    ``build/``, which git ignores)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "build", "ompi_tpu_torch")


def library_path(src: str = _SRC) -> str:
    """The library built from ``src``, keyed by the source, the shared
    header and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *HEADERS):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir(), f"{stem}-{digest.hexdigest()[:12]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                      "kernels cannot be built")


def build(src: str = _SRC, verbose: bool = False) -> str:
    """Build one kernel library from the checkout's ``src`` (once per
    version: ranks that race here serialize on a lock file per source and
    the first one builds; two sources build side by side). Returns the
    library path."""
    path = library_path(src)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir(), exist_ok=True)
    stem = os.path.splitext(os.path.basename(src))[0]
    with open(os.path.join(build_dir(), f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, src]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise KernelError(f"cannot run {cmd[0]}: {exc}") from exc
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
        if verbose and proc.stderr:
            print(proc.stderr, end="")
        os.replace(tmp, path)
    return path


_lib = None


def load(src: str = _SRC, subsys: str = "coll_cuda"):
    """``ctypes.CDLL`` of the library built from ``src`` (``nvcc`` at its
    first use in the build directory). The port's counterpart of a
    compile (``prof/__init__.py``): timed always, it counts
    ``prof_compile_misses`` and ``prof_compile_ns`` with the prof ledger
    on, and leaves a ``compile`` span in ``subsys`` with the recorder on
    (coll/xla.py:281-301)."""
    t0 = _trace.now()
    L = ctypes.CDLL(build(src))
    t1 = _trace.now()
    if _prof.PROFILER is not None:
        pvar.record("prof_compile_misses")
        pvar.record("prof_compile_ns", t1 - t0)
    rec = _trace.RECORDER
    if rec is not None:
        rec.record("compile", subsys, t0, t1,
                   {"cache": "miss", "key": os.path.basename(src)})
    return L


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        L = load()
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        L.otc_rs_hop.argtypes = [i, i, p, p, p, p, i64, p]
        L.otc_ag_hop.argtypes = [p, p, p, i64, p]
        L.otc_linear_fold.argtypes = [i, i, ctypes.POINTER(p), i, p, i64, p]
        u32 = ctypes.c_uint32
        L.otc_rs_update_hop.argtypes = [i, i, p, p, p, p, p, p, u32, u32,
                                        u32, i, i64, p]
        L.otc_linear_fold_update.argtypes = [i, i, ctypes.POINTER(p), i, p,
                                             p, p, p, u32, u32, u32, i, i64,
                                             p]
        L.otc_set_device.argtypes = [i]
        L.otc_malloc.argtypes = [i64, ctypes.POINTER(p)]
        L.otc_free.argtypes = [p]
        L.otc_ipc_get_handle.argtypes = [p, p]
        L.otc_ipc_open.argtypes = [p, ctypes.POINTER(p)]
        L.otc_ipc_close.argtypes = [p]
        L.otc_ipc_handle_size.argtypes = []
        L.otc_max_peers.argtypes = []
        L.otc_error_string.argtypes = [i]
        L.otc_error_string.restype = ctypes.c_char_p
        for fn in (L.otc_rs_hop, L.otc_ag_hop, L.otc_linear_fold,
                   L.otc_rs_update_hop, L.otc_linear_fold_update,
                   L.otc_set_device, L.otc_malloc, L.otc_free,
                   L.otc_ipc_get_handle, L.otc_ipc_open, L.otc_ipc_close,
                   L.otc_ipc_handle_size, L.otc_max_peers):
            fn.restype = ctypes.c_int
        if L.otc_max_peers() != MAX_PEERS:
            raise KernelError(f"ring_kernels.cu folds {L.otc_max_peers()} "
                              f"sources at most, not {MAX_PEERS}")
        _lib = L
    return _lib


_gemm_lib = None


def gemm_lib():
    """The loaded K6 library (built on first use)."""
    global _gemm_lib
    if _gemm_lib is None:
        L = load(GEMM_SRC)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        L.otc_wgmma_matmul.argtypes = [p, p, p, i64, i64, i64, i, p]
        L.otc_simt_matmul.argtypes = [i, p, p, p, p, i64, i64, i64, i64, i,
                                      p]
        for fn in (L.otc_wgmma_matmul, L.otc_simt_matmul):
            fn.restype = ctypes.c_int
        L.otc_gemm_error_string.argtypes = [i]
        L.otc_gemm_error_string.restype = ctypes.c_char_p
        _gemm_lib = L
    return _gemm_lib


def check(rc: int, what: str, error_string=None) -> None:
    """Raise KernelError for a nonzero cudaError_t (``error_string``: the
    library's own message function, the ring library's by default)."""
    if rc != 0:
        msg = (error_string or lib().otc_error_string)(rc)
        raise KernelError(f"{what}: CUDA error {rc} "
                          f"({msg.decode(errors='replace')})")


# ---------------------------------------------------------------------------
# the elementwise combine (plain versions; the kernels mirror it)


def _minmax(a: torch.Tensor, b: torch.Tensor, is_min: bool):
    """jnp.minimum / jnp.maximum semantics, written out as the kernel
    does: the first NaN operand propagates, and -0 orders below +0."""
    if not a.is_floating_point():
        return torch.minimum(a, b) if is_min else torch.maximum(a, b)
    first = a < b if is_min else a > b
    second = b < a if is_min else b > a
    tie_a = torch.signbit(a) if is_min else ~torch.signbit(a)
    r = torch.where(first | (~second & tie_a), a, b)
    r = torch.where(torch.isnan(b), b, r)
    return torch.where(torch.isnan(a), a, r)


def combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fn(a, b)`` for a supported op name, rounded to the tensors'
    type after the one step (int32 SUM/PROD wrap around)."""
    if op == "MPI_SUM":
        return torch.add(a, b)
    if op == "MPI_PROD":
        return torch.mul(a, b)
    if op in ("MPI_MIN", "MPI_MAX"):
        return _minmax(a, b, op == "MPI_MIN")
    raise ValueError(  # check: disable=bare-public-raise; wrapper contract
        f"unsupported op {op!r}")


# ---------------------------------------------------------------------------
# the kernels: wrapper + plain version


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_tensors(what: str, tensors: Sequence[torch.Tensor],
                   numel: int) -> str:
    """Common argument checks; returns the device type. CUDA operands
    may lie on other cards than the output (peer memory the kernel reads
    over NVLink); the kernel runs on the output's card."""
    kind = tensors[0].device.type
    for t in tensors:
        if t.device.type != kind:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: tensors on {tensors[0].device} and "
                f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: non-contiguous operand")
        if t.numel() != numel:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: operand of {t.numel()} elements, "
                f"expected {numel}")
        if t.dtype != tensors[0].dtype:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: mixed dtypes {tensors[0].dtype} "
                f"and {t.dtype}")
    if tensors[0].dtype not in DTYPE_CODES:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: unsupported dtype {tensors[0].dtype}")
    if kind not in ("cpu", "cuda"):
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: unsupported device {tensors[0].device}")
    return kind


def ring_rs_hop_plain(carry, own, dst, op: str, dst2=None) -> None:
    r = combine(op, carry, own)
    dst.copy_(r)
    if dst2 is not None:
        dst2.copy_(r)


def ring_rs_hop(carry: torch.Tensor, own: torch.Tensor, dst: torch.Tensor,
                op: str, dst2: Optional[torch.Tensor] = None) -> None:
    """K1: ``dst = fn(carry, own)`` (and ``dst2``, the output, on a
    ring's last hop). Replaces pallas_kernels.py ``_dma_reduce_scatter``
    (:529, body ``_combine_body`` :86)."""
    ops = [carry, own, dst] + ([dst2] if dst2 is not None else [])
    if _check_tensors("ring_rs_hop", ops, dst.numel()) == "cpu":
        ring_rs_hop_plain(carry, own, dst, op, dst2)
        return
    check(lib().otc_rs_hop(
        DTYPE_CODES[dst.dtype], OP_CODES[op], carry.data_ptr(),
        own.data_ptr(), dst.data_ptr(),
        dst2.data_ptr() if dst2 is not None else None, dst.numel(),
        _stream_ptr(dst)), "ring_rs_hop launch")
    ring_rs_hop.launches += 1


ring_rs_hop.launches = 0


def ring_ag_hop_plain(src, dst, dst2=None) -> None:
    dst.copy_(src)
    if dst2 is not None:
        dst2.copy_(src)


def _check_copy(what: str, tensors: Sequence[torch.Tensor]) -> str:
    """K2's argument checks: it copies bytes, so any dtype, the same for
    every operand (the plain version's copy then moves the same bits),
    and the same byte count; returns the device type."""
    kind, nbytes = tensors[0].device.type, tensors[0].nbytes
    for t in tensors:
        if t.device.type != kind:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: tensors on {tensors[0].device} and "
                f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: non-contiguous operand")
        if t.dtype != tensors[0].dtype:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: mixed dtypes {tensors[0].dtype} "
                f"and {t.dtype}")
        if t.nbytes != nbytes:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: operand of {t.nbytes} bytes, "
                f"expected {nbytes}")
    if kind not in ("cpu", "cuda"):
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: unsupported device {tensors[0].device}")
    return kind


def ring_ag_hop(src: torch.Tensor, dst: torch.Tensor,
                dst2: Optional[torch.Tensor] = None) -> None:
    """K2: ``dst = src`` (and ``dst2``, the block's place in the
    output), a byte copy of any dtype. Replaces pallas_kernels.py
    ``_dma_allgather`` (:565)."""
    ops = [src, dst] + ([dst2] if dst2 is not None else [])
    if _check_copy("ring_ag_hop", ops) == "cpu":
        ring_ag_hop_plain(src, dst, dst2)
        return
    check(lib().otc_ag_hop(
        src.data_ptr(), dst.data_ptr(),
        dst2.data_ptr() if dst2 is not None else None,
        dst.nbytes, _stream_ptr(dst)), "ring_ag_hop launch")
    ring_ag_hop.launches += 1


ring_ag_hop.launches = 0


def linear_fold_plain(srcs: Sequence[torch.Tensor], dst, op: str) -> None:
    acc = srcs[0]
    for g in srcs[1:]:
        acc = combine(op, acc, g)
    dst.copy_(acc)


def linear_fold(srcs: Sequence[torch.Tensor], dst: torch.Tensor,
                op: str) -> None:
    """K3: ``dst = fold(fn, srcs)`` in list (rank) order. Replaces
    pallas_kernels.py ``linear_allreduce`` (:389, ``_fold_body`` :93)
    and ``linear_reduce_scatter`` (:278, ``_fold_slice_body`` :165)."""
    if _check_tensors("linear_fold", [dst, *srcs], dst.numel()) == "cpu":
        linear_fold_plain(srcs, dst, op)
        return
    if len(srcs) > MAX_PEERS:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"linear_fold: {len(srcs)} sources, at most "
            f"{MAX_PEERS}")
    L = lib()
    ptrs = (ctypes.c_void_p * len(srcs))(*[s.data_ptr() for s in srcs])
    check(L.otc_linear_fold(
        DTYPE_CODES[dst.dtype], OP_CODES[op], ptrs, len(srcs),
        dst.data_ptr(), dst.numel(), _stream_ptr(dst)),
        "linear_fold launch")
    linear_fold.launches += 1


linear_fold.launches = 0


def shard_const(value: float, dtype) -> torch.Tensor:
    """``value`` cast to a shard's dtype, as a 0-d CPU tensor: the
    ``jnp.asarray(value, dtype)`` of the reference's update (1/3 rounds
    to bfloat16; 0.9 truncates to 0 for int32)."""
    return torch.tensor(value, dtype=dtype)


def _const_bits(c: Optional[torch.Tensor]) -> int:
    if c is None:
        return 0
    if c.element_size() == 2:
        return int(c.view(torch.int16).item()) & 0xFFFF
    return int(c.view(torch.int32).item()) & 0xFFFFFFFF


def shard_update_plain(g, p, v, lr, mu, inv):
    """The eager ZeRO shard update, one rounded op at a time: ``g *=
    inv; v' = mu*v + g; p' = p - lr*v'`` (ompi_tpu ZeroOptimizer.step and
    pallas_kernels.py ``_apply_update`` :120, in their op order). The
    constants are :func:`shard_const` tensors; v and inv may be None.
    Returns (p', v'). Never ``add(alpha=)``, ``addcmul`` or ``lerp``:
    those round once for two ops."""
    if inv is not None:
        g = torch.mul(g, inv)
    vn = None
    if v is not None:
        vn = torch.add(torch.mul(mu, v), g)
        g = vn
    return torch.sub(p, torch.mul(lr, g)), vn


def ring_rs_update_hop_plain(carry, own, p, v, p_out, v_out, lr, mu, inv,
                             op: str = "MPI_SUM") -> None:
    pn, vn = shard_update_plain(combine(op, carry, own), p, v, lr, mu, inv)
    p_out.copy_(pn)
    if v_out is not None:
        v_out.copy_(vn)


def _check_update(what: str, ins: List[torch.Tensor], p, v, p_out, v_out,
                  lr, mu, inv) -> str:
    """The update kernels' (K5, K5b) argument checks; returns the device
    type. ``ins`` are the operands the update's gradient comes from."""
    if (v is None) != (v_out is None) or (v is not None and mu is None):
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: v, v_out and mu go together")
    ins = ins + [p] + ([v] if v is not None else [])
    outs = [p_out] + ([v_out] if v_out is not None else [])
    kind = _check_tensors(what, ins + outs, p.numel())
    for c in (lr, mu, inv):
        if c is not None and (c.dim() != 0 or c.dtype != p.dtype):
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: constants must be 0-d tensors of "
                f"{p.dtype}")
    if {o.data_ptr() for o in outs} & {t.data_ptr() for t in ins}:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: an output is also an input")
    return kind


def _update_args(p, v, p_out, v_out, lr, mu, inv) -> tuple:
    """The ctypes arguments of an update kernel after its gradient's."""
    return (p.data_ptr(), v.data_ptr() if v is not None else None,
            p_out.data_ptr(), v_out.data_ptr() if v_out is not None else None,
            _const_bits(lr), _const_bits(mu), _const_bits(inv),
            int(inv is not None), p.numel(), _stream_ptr(p_out))


def ring_rs_update_hop(carry: torch.Tensor, own: torch.Tensor,
                       p: torch.Tensor, v: Optional[torch.Tensor],
                       p_out: torch.Tensor, v_out: Optional[torch.Tensor],
                       lr: torch.Tensor, mu: Optional[torch.Tensor],
                       inv: Optional[torch.Tensor],
                       op: str = "MPI_SUM") -> None:
    """K5: ``g = fn(carry, own)``, then the shard update into ``p_out``
    (and ``v_out`` when the momentum ``v`` is given; ``inv`` None skips
    the scaling). The constants are 0-d tensors of the shard dtype
    (:func:`shard_const`); the kernel gets their bit patterns. Outputs
    must not be inputs. Replaces pallas_kernels.py
    ``_dma_reduce_scatter_update`` (:601, bodies ``_combine_update_body``
    :143 and ``_apply_update`` :120)."""
    if _check_update("ring_rs_update_hop", [carry, own], p, v, p_out, v_out,
                     lr, mu, inv) == "cpu":
        ring_rs_update_hop_plain(carry, own, p, v, p_out, v_out, lr, mu,
                                 inv, op)
        return
    check(lib().otc_rs_update_hop(
        DTYPE_CODES[p.dtype], OP_CODES[op], carry.data_ptr(),
        own.data_ptr(), *_update_args(p, v, p_out, v_out, lr, mu, inv)),
        "ring_rs_update_hop launch")
    ring_rs_update_hop.launches += 1


ring_rs_update_hop.launches = 0


def linear_fold_update_plain(srcs, p, v, p_out, v_out, lr, mu, inv,
                             op: str = "MPI_SUM") -> None:
    g = torch.empty_like(p)
    linear_fold_plain(srcs, g, op)
    pn, vn = shard_update_plain(g, p, v, lr, mu, inv)
    p_out.copy_(pn)
    if v_out is not None:
        v_out.copy_(vn)


def linear_fold_update(srcs: Sequence[torch.Tensor], p: torch.Tensor,
                       v: Optional[torch.Tensor], p_out: torch.Tensor,
                       v_out: Optional[torch.Tensor], lr: torch.Tensor,
                       mu: Optional[torch.Tensor],
                       inv: Optional[torch.Tensor],
                       op: str = "MPI_SUM") -> None:
    """K5b: ``g = fold(fn, srcs)`` in list (rank) order, then the shard
    update of :func:`ring_rs_update_hop` into ``p_out`` (and ``v_out``),
    in one pass; equal bit for bit to K3 followed by
    :func:`shard_update_plain`. Replaces pallas_kernels.py
    ``linear_reduce_scatter_update`` (:447, bodies
    ``_fold_slice_update_body`` :179 and ``_apply_update`` :120)."""
    if _check_update("linear_fold_update", list(srcs), p, v, p_out, v_out,
                     lr, mu, inv) == "cpu":
        linear_fold_update_plain(srcs, p, v, p_out, v_out, lr, mu, inv, op)
        return
    if len(srcs) > MAX_PEERS:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"linear_fold_update: {len(srcs)} sources, at most "
            f"{MAX_PEERS}")
    L = lib()
    ptrs = (ctypes.c_void_p * len(srcs))(*[t.data_ptr() for t in srcs])
    check(L.otc_linear_fold_update(
        DTYPE_CODES[p.dtype], OP_CODES[op], ptrs, len(srcs),
        *_update_args(p, v, p_out, v_out, lr, mu, inv)),
        "linear_fold_update launch")
    linear_fold_update.launches += 1


linear_fold_update.launches = 0


def _matmul_i32_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` mod 2**32 for int32 operands, exactly (torch.matmul has
    no int32 path on CUDA): 16-bit halves multiplied in float64, where
    every partial sum stays below 2**53 for d < 2**20, recombined in
    int64."""
    if x.shape[1] >= 1 << 20:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            "block_matmul: int32 depth of 2**20 or more")

    def halves(t):
        u = t.long() & 0xFFFFFFFF
        return (u & 0xFFFF).double(), (u >> 16).double()

    xl, xh = halves(x)
    wl, wh = halves(w)
    lo = torch.matmul(xl, wl).long()
    mid = torch.matmul(xh, wl).long() + torch.matmul(xl, wh).long()
    r = (lo + ((mid & 0xFFFF) << 16)) & 0xFFFFFFFF
    return torch.where(r >= 1 << 31, r - (1 << 32), r).int()


def block_matmul_plain(x, w, out) -> None:
    x, w = x.to(out.dtype), w.to(out.dtype)
    if out.dtype == torch.int32:
        out.copy_(_matmul_i32_plain(x, w))
    else:
        torch.matmul(x, w, out=out)


def block_matmul_variant(x: torch.Tensor, w: torch.Tensor,
                         out: torch.Tensor) -> str:
    """Which K6 kernel takes ``out = x @ w`` for these operands, as the
    kernel gets them (already of ``out``'s dtype): ``"wgmma"`` (TMA and
    the tensor cores) only for bfloat16 with m, d, f > 0, every base
    pointer 16-byte aligned and rows of x and w a multiple of 16 bytes
    (TMA's stride rule: d and f multiples of 8); ``"simt"`` (the
    register-tiled CUDA-core kernel) for everything else."""
    m, d = x.shape
    f = w.shape[1]
    if not (x.dtype == w.dtype == out.dtype == torch.bfloat16):
        return "simt"
    if min(m, d, f) <= 0 or (d * 2) % 16 or (f * 2) % 16:
        return "simt"
    if any(t.data_ptr() % 16 for t in (x, w, out)):
        return "simt"
    return "wgmma"


#: the SIMT kernel's block tile (rows, columns) and depth per stage
SIMT_TILE, SIMT_DEPTH = 128, 16


def simt_splits(m: int, d: int, f: int, sms: int) -> Tuple[int, int]:
    """``(splits, kchunk)``: how the SIMT kernel cuts K. One slice where
    its 128 x 128 tiles already give every SM a block; else as many
    slices as fill the SMs, each a multiple of 16 deep and at least 64
    (the zero-3 product (192, 3072) @ (3072, 256) has 4 tiles: 32 slices
    of 96 on 132 SMs). A second pass adds the slices in order."""
    tiles = -(-m // SIMT_TILE) * -(-f // SIMT_TILE)
    want = min(sms // max(tiles, 1), d // 64)
    if tiles >= sms or want <= 1:
        return 1, max(d, 1)
    kchunk = -(-d // want)
    kchunk = -(-kchunk // SIMT_DEPTH) * SIMT_DEPTH
    return -(-d // kchunk), kchunk


_sms = {}


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def block_matmul(x: torch.Tensor, w: torch.Tensor,
                 out: torch.Tensor) -> None:
    """K6: ``out = x @ w`` for one (m, d) block and the (d, f) weight, in
    ``out``'s dtype, which must be ``torch.promote_types(x, w)`` (it
    agrees with ``jnp.result_type`` over float32/bfloat16/int32); mixed
    operands are cast to it first. float32 and bfloat16 accumulate in
    float32, int32 wraps. On CUDA tensors :func:`block_matmul_variant`
    picks the kernel; each launch counts in ``block_matmul.launches`` and
    in ``block_matmul.variants[variant]``, and an empty output launches
    nothing. Replaces pallas_kernels.py ``_dma_allgather_matmul`` (:659,
    body ``_matmul_body`` :112)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or tuple(out.shape) != (x.shape[0], w.shape[1]):
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"block_matmul: shapes {tuple(x.shape)} @ "
            f"{tuple(w.shape)} -> {tuple(out.shape)}")
    dt = torch.promote_types(x.dtype, w.dtype)
    if out.dtype != dt or dt not in DTYPE_CODES:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"block_matmul: {x.dtype} @ {w.dtype} -> "
            f"{out.dtype} (expected {dt}, one of float32, "
            "bfloat16, int32)")
    kind = out.device.type
    for t in (x, w, out):
        if t.device.type != kind:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"block_matmul: tensors on {out.device} and "
                f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                "block_matmul: non-contiguous operand")
    if kind == "cpu":
        block_matmul_plain(x, w, out)
        return
    if kind != "cuda":
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"block_matmul: unsupported device {out.device}")
    if out.numel() == 0:
        return
    if x.dtype != dt:
        x = x.to(dt)
    if w.dtype != dt:
        w = w.to(dt)
    (m, d), f = x.shape, w.shape[1]
    variant = block_matmul_variant(x, w, out)
    G = gemm_lib()
    if variant == "wgmma":
        rc = G.otc_wgmma_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                m, d, f, _sm_count(out.device),
                                _stream_ptr(out))
    else:
        splits, kchunk = simt_splits(m, d, f, _sm_count(out.device))
        ws = None
        if splits > 1:  # the slices' partial sums, in the accumulator type
            ws = torch.empty(splits * m * f, device=out.device,
                             dtype=torch.int32 if dt == torch.int32
                             else torch.float32)
        rc = G.otc_simt_matmul(
            DTYPE_CODES[dt], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, m, d, f, kchunk,
            splits, _stream_ptr(out))
    check(rc, f"block_matmul ({variant}) launch", G.otc_gemm_error_string)
    block_matmul.launches += 1
    block_matmul.variants[variant] += 1


block_matmul.launches = 0
block_matmul.variants = {"wgmma": 0, "simt": 0}

KERNELS = (ring_rs_hop, ring_ag_hop, linear_fold, ring_rs_update_hop,
           linear_fold_update, block_matmul)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    block_matmul.variants = dict.fromkeys(block_matmul.variants, 0)


# ---------------------------------------------------------------------------
# the symmetric buffers a schedule runs over


class Ring:
    """Rank ``rank``'s view of the n ranks' symmetric buffers: each
    rank's staged input (``inputs[p]``) and carry slots
    (``slotbufs[p]``: two per direction, ``slot_bytes`` each), all uint8
    tensors, plus this rank's hop counters."""

    def __init__(self, rank: int, n: int, inputs: List[torch.Tensor],
                 slotbufs: List[torch.Tensor], slot_bytes: int) -> None:
        self.rank, self.n = rank, n
        self.inputs = inputs
        self.slotbufs = slotbufs
        self.slot_bytes = slot_bytes
        self.hops = {1: 0, -1: 0}  # hops done per ring direction
        self.linear = 0  # ALL steps passed

    def slot(self, p: int, d: int, i: int) -> torch.Tensor:
        j = (0 if d == 1 else 2) + i
        return self.slotbufs[p][j * self.slot_bytes:
                                (j + 1) * self.slot_bytes]

    @classmethod
    def local(cls, n: int, in_bytes: int, slot_bytes: int,
              device="cpu") -> List["Ring"]:
        """n ranks in one process over plain tensors (the tests)."""
        inputs = [torch.zeros(in_bytes, dtype=torch.uint8, device=device)
                  for _ in range(n)]
        slots = [torch.zeros(4 * slot_bytes, dtype=torch.uint8,
                             device=device) for _ in range(n)]
        return [cls(r, n, inputs, slots, slot_bytes) for r in range(n)]

    def advance(self, dirs: Tuple) -> None:
        for d in dirs:
            if d == ALL:
                self.linear += 1
            else:
                self.hops[d] += 1


def _view(buf: torch.Tensor, dtype, off: int, n: int) -> torch.Tensor:
    return buf.view(dtype)[off:off + n]


def _zip(*gens: Iterator[Tuple]) -> Iterator[Tuple]:
    """Run schedules side by side (the two directions of bidir): one
    step of each per yield."""
    while True:
        dirs, done = [], 0
        for g in gens:
            try:
                dirs.extend(next(g))
            except StopIteration:
                done += 1
        if done:
            assert done == len(gens), "bidir halves out of step"
            return
        yield tuple(dirs)


def run_lockstep(rings: Sequence[Ring], gens: Sequence[Iterator]) -> None:
    """Drive n in-process ranks: every rank takes step t before any
    takes step t+1, which satisfies every wait of the slot protocol."""
    live = list(zip(rings, gens))
    while live:
        nxt = []
        for ring, g in live:
            try:
                ring.advance(next(g))
                nxt.append((ring, g))
            except StopIteration:
                pass
        live = nxt


# ---------------------------------------------------------------------------
# schedules (K4: compositions of K1-K3)


def _rs_steps(ep: Ring, dtype, op: str, d: int, k: int, lo: int, w: int,
              out: Optional[torch.Tensor], last=None) -> Iterator[Tuple]:
    """Ring reduce-scatter over the staged input's chunks (chunk j =
    elements [j*k+lo, j*k+lo+w)); the last hop also writes ``out``.
    ``last(carry, own)``, when given, is the last hop instead (the fused
    update): it writes no slot, since nothing reads the last hop's slot,
    and still counts as a hop of direction d."""
    n, r = ep.n, ep.rank
    prev = (r - d) % n
    mine = ep.inputs[r]

    def own(j):
        return _view(mine, dtype, j * k + lo, w)

    def slot(p, i):
        return _view(ep.slot(p, d, i), dtype, 0, w)

    slot(r, (ep.hops[d] + 1) % 2).copy_(own((r - d) % n))
    yield (d,)
    for s in range(n - 1):
        h = ep.hops[d]
        carry, chunk = slot(prev, h % 2), own((r - (s + 2) * d) % n)
        if s == n - 2 and last is not None:
            last(carry, chunk)
        else:
            ring_rs_hop(carry, chunk, slot(r, (h + 1) % 2), op,
                        dst2=out if s == n - 2 else None)
        yield (d,)


def _ag_steps(ep: Ring, dtype, d: int, k: int, lo: int, w: int,
              out: Optional[torch.Tensor], init: Optional[torch.Tensor],
              arrived=None) -> Iterator[Tuple]:
    """Ring allgather of w-element blocks into ``out`` (block j at
    [j*k+lo, j*k+lo+w)). ``init`` is this rank's block; None continues
    from the block the own current slot already holds (the allreduce's
    reduce-scatter result). ``arrived(block, j)``, when given, takes each
    arrived block j (in the own slot) in place of the copy into ``out``."""
    n, r = ep.n, ep.rank
    prev = (r - d) % n

    def slot(p, i):
        return _view(ep.slot(p, d, i), dtype, 0, w)

    def block(j):
        return out[j * k + lo:j * k + lo + w]

    if init is not None:
        slot(r, (ep.hops[d] + 1) % 2).copy_(init)
        if arrived is None:
            block(r).copy_(init)
        yield (d,)
    for s in range(n - 1):
        h = ep.hops[d]
        j = (r - (s + 1) * d) % n
        mine = slot(r, (h + 1) % 2)
        if arrived is None:
            ring_ag_hop(slot(prev, h % 2), mine, dst2=block(j))
        else:
            ring_ag_hop(slot(prev, h % 2), mine)
            arrived(mine, j)
        yield (d,)


def _fold_steps(ep: Ring, dtype, op: str, off: int, m: int,
                out: torch.Tensor) -> Iterator[Tuple]:
    yield (ALL,)  # every rank has staged its input
    linear_fold([_view(ep.inputs[p], dtype, off, m) for p in range(ep.n)],
                out, op)
    yield (ALL,)  # every rank has read every input: safe to restage


def _pull_steps(ep: Ring, pieces, copies) -> Iterator[Tuple]:
    """The pull schedule: stage each ``(1-D tensor, element offset)`` of
    ``pieces`` into the own staged input (none: this rank sends nothing),
    let every rank stage, then K2-copy each ``(source view, destination)``
    of ``copies`` (views of the ranks' staged inputs), and let every
    rank finish reading before any restages."""
    for t, off in pieces:
        _view(ep.inputs[ep.rank], t.dtype, off, t.numel()).copy_(t)
    yield (ALL,)  # every rank has staged what it sends
    for src, dst in copies:
        ring_ag_hop(src, dst)
    yield (ALL,)  # every rank has read every input: safe to restage


def bcast(ep: Ring, flat: torch.Tensor, root: int,
          out: torch.Tensor) -> Iterator[Tuple]:
    """Broadcast of the root's 1-D ``flat`` into every rank's ``out``: the
    root stages it, every rank copies it (one K2); ``flat`` of the other
    ranks is only read for its dtype and length. The counterpart of
    coll/xla's ``_bcast_body`` (all_gather, then the root's block)."""
    src = _view(ep.inputs[root], flat.dtype, 0, flat.numel())
    return _pull_steps(ep, [(flat, 0)] if ep.rank == root else [],
                       [(src, out)])


def alltoall(ep: Ring, flat: torch.Tensor,
             out: torch.Tensor) -> Iterator[Tuple]:
    """All-to-all of the 1-D ``flat`` (n blocks): block p of ``out`` is
    block ``rank`` of rank p's input (n K2 copies), as ``lax.all_to_all``
    with split and concat on dim 0."""
    n, r = ep.n, ep.rank
    b = flat.numel() // n
    return _pull_steps(ep, [(flat, 0)], [
        (_view(ep.inputs[p], flat.dtype, r * b, b), out[p * b:(p + 1) * b])
        for p in range(n)])


def gather(ep: Ring, flat: torch.Tensor,
           out: torch.Tensor) -> Iterator[Tuple]:
    """Gather of every rank's 1-D ``flat`` (m elements) into ``out`` (n*m,
    rank p's block at p*m): n K2 copies, as ``lax.all_gather``."""
    m = flat.numel()
    return _pull_steps(ep, [(flat, 0)], [
        (_view(ep.inputs[p], flat.dtype, 0, m), out[p * m:(p + 1) * m])
        for p in range(ep.n)])


def ragged(ep: Ring, dtype, pieces, spans,
           out: Optional[torch.Tensor]) -> Iterator[Tuple]:
    """The pull schedule with per-peer offsets and lengths (coll/device's
    v-variants and rooted copies): stage ``pieces`` as
    :func:`_pull_steps` does, then copy each span ``(peer, src, count,
    dst)`` (elements of ``dtype``) from that peer's staged input at
    ``src`` into ``out[dst:dst + count]`` with one K2; empty spans copy
    nothing, and a rank with no spans (``out`` None) only stages."""
    return _pull_steps(ep, pieces, [
        (_view(ep.inputs[p], dtype, src, c), out[dst:dst + c])
        for p, src, c, dst in spans if c])


def gather_to_root(ep: Ring, flat: torch.Tensor, root: int,
                   out: Optional[torch.Tensor]) -> Iterator[Tuple]:
    """Rooted gather of every rank's 1-D ``flat`` (m elements): every rank
    stages, the root alone copies rank p's block into ``out[p*m:(p+1)*m]``
    (n K2 copies); the others pass ``out`` None and allocate nothing."""
    m = flat.numel()
    spans = [(p, 0, m, p * m) for p in range(ep.n)] if ep.rank == root \
        else []
    return ragged(ep, flat.dtype, [(flat, 0)], spans, out)


def scatter_from_root(ep: Ring, flat: Optional[torch.Tensor], root: int,
                      out: torch.Tensor) -> Iterator[Tuple]:
    """Scatter of the root's 1-D ``flat`` (n blocks of ``out.numel()``):
    the root stages it, rank r copies block r into ``out`` (one K2); the
    other ranks pass ``flat`` None."""
    b = out.numel()
    return ragged(ep, out.dtype, [(flat, 0)] if ep.rank == root else [],
                  [(root, ep.rank * b, b, 0)], out)


def permute(blocks: Sequence[torch.Tensor], offs: Sequence[int],
            outs: Sequence[torch.Tensor], src: Optional[int]):
    """``(stage, land)`` of one ``Arena.exchange`` that moves a
    permutation's blocks (coll/device's ``permute_dev``, the pull schedule
    of :func:`alltoall` with one source a rank): ``stage(region)`` copies
    each 1-D block of ``blocks`` to its byte offset of ``offs`` in the own
    region; ``land(regions)`` K2-copies each block of source ``src``'s
    region into the 1-D tensor of ``outs`` at the same offset."""
    def stage(region):
        for b, off in zip(blocks, offs):
            _view(region, b.dtype, off // b.element_size(),
                  b.numel()).copy_(b)

    def land(regions):
        reg = regions[src]
        for o, off in zip(outs, offs):
            ring_ag_hop(_view(reg, o.dtype, off // o.element_size(),
                              o.numel()), o)
    return stage, land


def binomial_rounds(n: int, root: int) -> List[Tuple[Tuple[int, int], ...]]:
    """The binomial tree's rounds of (sender, receiver) pairs, as the
    reference builds them (coll/xla.py ``_reduce_binomial``): in round
    ``mask`` (1, 2, 4, ...) the vrank v = (rank - root) % n with v % 2mask
    == mask sends to vrank v - mask. Each rank sends once, after its
    last receive."""
    rounds, mask = [], 1
    while mask < n:
        pairs = tuple(((v + root) % n, (v - mask + root) % n)
                      for v in range(n) if v % (2 * mask) == mask)
        if pairs:
            rounds.append(pairs)
        mask <<= 1
    return rounds


def binomial_reduce(ep: Ring, flat: torch.Tensor, combine, root: int,
                    out: Optional[torch.Tensor]) -> Iterator[Tuple]:
    """Binomial reduction of every rank's 1-D ``flat`` to ``out`` on the
    root (None elsewhere): per round of :func:`binomial_rounds` the
    senders stage their partial, every rank passes one step, and each
    receiver folds ``combine(cur, got, dst)`` (its partial first, the
    sender's staged partial second: the reference's operand order) into
    a buffer of its own, the root's last into ``out``; a last step lets
    every receiver finish reading. ceil(log2 n) + 1 steps on every rank;
    a non-root holds at most two ``flat``-sized partials."""
    r, m = ep.rank, flat.numel()
    rounds = binomial_rounds(ep.n, root)
    cur, bufs = flat, []
    for t, pairs in enumerate(rounds):
        if any(s == r for s, _ in pairs):
            _stage(ep, cur, m)
        yield (ALL,)  # this round's senders have staged
        src = next((s for s, d in pairs if d == r), None)
        if src is not None:
            if t == len(rounds) - 1:  # only the root receives last
                dst = out
            else:  # the two partials ping-pong
                dst = next((b for b in bufs if b is not cur), None)
                if dst is None:
                    dst = flat.new_empty(m)
                    bufs.append(dst)
            combine(cur, _view(ep.inputs[src], flat.dtype, 0, m), dst)
            cur = dst
    yield (ALL,)  # every receiver has read: safe to restage


def prefix(ep: Ring, flat: torch.Tensor, op: str, rows: int,
           out: torch.Tensor) -> Iterator[Tuple]:
    """Scan / Exscan of every rank's 1-D ``flat``: every rank stages, then
    this rank folds the staged inputs of ranks 0..rows-1 in rank order
    into ``out`` (K3; one row: a K2 copy; none: nothing)."""
    _stage(ep, flat, flat.numel())
    yield (ALL,)  # every rank has staged its input
    srcs = [_view(ep.inputs[p], flat.dtype, 0, flat.numel())
            for p in range(rows)]
    if rows == 1:
        ring_ag_hop(srcs[0], out)
    elif rows > 1:
        linear_fold(srcs, out, op)
    yield (ALL,)  # every rank has read every input: safe to restage


def _stage(ep: Ring, flat: torch.Tensor, total: int) -> None:
    """The ``to_global`` analog: one copy of the caller's tensor into
    the own staged input, zero-padded to ``total`` elements."""
    inp = _view(ep.inputs[ep.rank], flat.dtype, 0, total)
    inp[:flat.numel()].copy_(flat)
    if total > flat.numel():
        inp[flat.numel():].zero_()


def padded_chunk(m: int, n: int) -> int:
    """Elements per chunk of an m-element allreduce (zero-padded to a
    multiple of n, pallas_kernels.py:372-386)."""
    return -(-m // n)


def allreduce(ep: Ring, flat: torch.Tensor, op: str, algo: str,
              out: torch.Tensor) -> Iterator[Tuple]:
    """Allreduce of the 1-D ``flat``; ``out`` holds n*padded_chunk(m)
    elements and its first m are the result. algo: linear | ring |
    bidir (bidir needs >= 2 elements per chunk)."""
    m, n = flat.numel(), ep.n
    k = padded_chunk(m, n)
    _stage(ep, flat, n * k)
    if algo == "linear":
        yield from _fold_steps(ep, flat.dtype, op, 0, m, out[:m])
        return

    def one_way(d, lo, w):
        r = ep.rank
        yield from _rs_steps(ep, flat.dtype, op, d, k, lo, w,
                             out[r * k + lo:r * k + lo + w])
        yield from _ag_steps(ep, flat.dtype, d, k, lo, w, out, None)

    if algo == "bidir":
        h = k // 2
        yield from _zip(one_way(1, 0, h), one_way(-1, h, k - h))
    else:
        yield from one_way(1, 0, k)


def reduce_scatter(ep: Ring, flat: torch.Tensor, op: str, algo: str,
                   row: int, out: torch.Tensor) -> Iterator[Tuple]:
    """Reduce-scatter of the 1-D ``flat`` (n chunks of ``out.numel()``
    elements, rows of ``row``; a shorter ``flat`` is zero-padded to n
    chunks as it is staged) into ``out`` (one chunk). bidir sends the
    front half of each chunk's rows clockwise and the back half
    counterclockwise."""
    n, r = ep.n, ep.rank
    k = out.numel()
    _stage(ep, flat, n * k)
    if algo == "linear":
        yield from _fold_steps(ep, flat.dtype, op, r * k, k, out)
    elif algo == "bidir":
        h = (k // row) // 2 * row
        yield from _zip(
            _rs_steps(ep, flat.dtype, op, 1, k, 0, h, out[:h]),
            _rs_steps(ep, flat.dtype, op, -1, k, h, k - h, out[h:]))
    else:
        yield from _rs_steps(ep, flat.dtype, op, 1, k, 0, k, out)


def allgather(ep: Ring, flat: torch.Tensor, algo: str,
              out: torch.Tensor) -> Iterator[Tuple]:
    """Allgather of the 1-D ``flat`` (k elements) into ``out`` (n*k,
    rank i's block at i*k). bidir: front half clockwise, back half
    counterclockwise."""
    k = flat.numel()
    if algo == "bidir":
        h = k // 2
        yield from _zip(
            _ag_steps(ep, flat.dtype, 1, k, 0, h, out, flat[:h]),
            _ag_steps(ep, flat.dtype, -1, k, h, k - h, out, flat[h:]))
    else:
        yield from _ag_steps(ep, flat.dtype, 1, k, 0, k, out, flat)


def reduce_scatter_update(ep: Ring, flat: torch.Tensor, p: torch.Tensor,
                          v: Optional[torch.Tensor], lr, mu, inv,
                          p_out: torch.Tensor,
                          v_out: Optional[torch.Tensor],
                          op: str = "MPI_SUM") -> Iterator[Tuple]:
    """The fused ZeRO step of one bucket: the clockwise ring
    reduce-scatter of the 1-D ``flat`` (n chunks of the shard length),
    its first n-2 hops K1 and its last K5, which updates this rank's
    shard ``p`` (and momentum ``v``) into ``p_out`` / ``v_out`` with the
    reduced chunk (pallas_kernels.py ``ring_reduce_scatter_update``
    :410, chunk order :425-444). Never bidirectional, as the reference."""
    k = flat.numel() // ep.n
    _stage(ep, flat, flat.numel())

    def last(carry, chunk):
        ring_rs_update_hop(carry, chunk, p, v, p_out, v_out, lr, mu, inv, op)

    yield from _rs_steps(ep, flat.dtype, op, 1, k, 0, k, None, last)


def linear_reduce_scatter_update(ep: Ring, flat: torch.Tensor,
                                 p: torch.Tensor, v: Optional[torch.Tensor],
                                 lr, mu, inv, p_out: torch.Tensor,
                                 v_out: Optional[torch.Tensor],
                                 op: str = "MPI_SUM") -> Iterator[Tuple]:
    """The 'linear' fused ZeRO step of one bucket: every rank stages the
    1-D ``flat`` (n chunks of the shard length), then one K5b folds every
    rank's own chunk in rank order and updates this rank's shard ``p``
    (and momentum ``v``) into ``p_out`` / ``v_out`` (pallas_kernels.py
    ``linear_reduce_scatter_update`` :447). Bitwise equal to the 'linear'
    reduce_scatter followed by :func:`shard_update_plain`. Nothing calls
    it on a path: coll/cuda's 'linear' fused slot runs K3 and the eager
    update, as the reference's does."""
    n, r = ep.n, ep.rank
    k = flat.numel() // n
    _stage(ep, flat, flat.numel())
    yield (ALL,)  # every rank has staged its input
    linear_fold_update([_view(ep.inputs[q], flat.dtype, r * k, k)
                        for q in range(n)], p, v, p_out, v_out, lr, mu, inv,
                       op)
    yield (ALL,)  # every rank has read every input: safe to restage


def allgather_matmul(ep: Ring, x: torch.Tensor, w: torch.Tensor,
                     out: torch.Tensor) -> Iterator[Tuple]:
    """``allgather(x) @ w`` into ``out`` (n*m, f): the own (m, d) block
    first, then per clockwise hop a K2 copy of the neighbour's block and
    a K6 product of it into its rank-order rows (pallas_kernels.py
    ``allgather_matmul`` :478, chunk order :492-503). x and w must have
    out's dtype already (the slot promotes them once, not per hop)."""
    m = x.shape[0]

    def multiply(blk, j):
        block_matmul(blk.view(x.shape), w, out[j * m:(j + 1) * m])

    multiply(x, ep.rank)
    yield from _ag_steps(ep, x.dtype, 1, x.numel(), 0, x.numel(), None,
                         x.reshape(-1), arrived=multiply)


def ring_order(n: int, c: int, d: int) -> List[int]:
    """The rank order in which the ring folds chunk c (direction d):
    ranks c+d, c+2d, ..., c+n*d = c — an oracle independent of the hop
    machinery, used by the examples and tests."""
    return [(c + i * d) % n for i in range(1, n + 1)]

