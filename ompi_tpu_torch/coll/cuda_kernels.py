"""coll/cuda_kernels — the ring collective kernels and their schedules.

Port of :mod:`ompi_tpu.coll.pallas_kernels` (the reference's K1-K4).
Three kernels written by hand in CUDA C++ for Hopper
(``csrc/ring_kernels.cu``, built with nvcc for ``sm_90a`` into a plain C
library loaded with ctypes):

- :func:`ring_rs_hop` (K1) — one reduce-scatter hop, ``dst = fn(carry,
  own)`` with the carry read from the ring neighbour's arena slot;
- :func:`ring_ag_hop` (K2) — one allgather hop, the neighbour's block
  copied into the own slot and the output;
- :func:`linear_fold` (K3) — the rank-order fold over every rank's staged
  input, ``acc = g0; acc = fn(acc, g_i)``.

Each has a plain PyTorch version beside it (``*_plain``) doing the same
steps on the same views. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``.

The schedules (K4: :func:`allreduce`, :func:`reduce_scatter`,
:func:`allgather`) are generators over a :class:`Ring` — a rank's view of
the symmetric buffers (every rank's staged input and carry slots). They
follow the reference's chunk schedule exactly (carry starts at chunk r-d;
hop s folds ``fn(carry, own chunk r-(s+2)d)``; allgather hop s delivers
rank r-(s+1)d's block; the allreduce zero-pads to a multiple of n), so
'ring' and 'linear' results are bitwise equal to the JAX package's. A
generator yields after every step that a peer depends on; whoever runs
it then makes the step visible and waits for the ring neighbours (the
multi-process transport in :mod:`ompi_tpu_torch.runtime.device_plane`)
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

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
OP_CODES = {"MPI_SUM": 0, "MPI_PROD": 1, "MPI_MIN": 2, "MPI_MAX": 3}

#: marker a schedule yields for a step every rank must pass (linear)
ALL = "all"

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "ring_kernels.cu")
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


def library_path() -> str:
    """The built library's path, keyed by the source and flags."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(),
                        f"ring_kernels-{digest.hexdigest()[:12]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                      "ring kernels cannot be built")


def build(verbose: bool = False) -> str:
    """Build the kernel library from the checkout's source (once per
    source version: ranks that race here serialize on a lock file and
    the first one builds). Returns the library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(build_dir(), exist_ok=True)
    with open(os.path.join(build_dir(), "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, _SRC]
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


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build())
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        L.otc_rs_hop.argtypes = [i, i, p, p, p, p, i64, p]
        L.otc_ag_hop.argtypes = [p, p, p, i64, p]
        L.otc_linear_fold.argtypes = [i, i, ctypes.POINTER(p), i, p, i64, p]
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
                   L.otc_set_device, L.otc_malloc, L.otc_free,
                   L.otc_ipc_get_handle, L.otc_ipc_open, L.otc_ipc_close,
                   L.otc_ipc_handle_size, L.otc_max_peers):
            fn.restype = ctypes.c_int
        _lib = L
    return _lib


def check(rc: int, what: str) -> None:
    """Raise KernelError for a nonzero cudaError_t."""
    if rc != 0:
        msg = lib().otc_error_string(rc).decode(errors="replace")
        raise KernelError(f"{what}: CUDA error {rc} ({msg})")


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
    raise ValueError(f"unsupported op {op!r}")


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
            raise ValueError(f"{what}: tensors on {tensors[0].device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous operand")
        if t.numel() != numel:
            raise ValueError(f"{what}: operand of {t.numel()} elements, "
                             f"expected {numel}")
        if t.dtype != tensors[0].dtype:
            raise ValueError(f"{what}: mixed dtypes {tensors[0].dtype} "
                             f"and {t.dtype}")
    if tensors[0].dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {tensors[0].dtype}")
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {tensors[0].device}")
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


def ring_ag_hop(src: torch.Tensor, dst: torch.Tensor,
                dst2: Optional[torch.Tensor] = None) -> None:
    """K2: ``dst = src`` (and ``dst2``, the block's place in the
    output). Replaces pallas_kernels.py ``_dma_allgather`` (:565)."""
    ops = [src, dst] + ([dst2] if dst2 is not None else [])
    if _check_tensors("ring_ag_hop", ops, dst.numel()) == "cpu":
        ring_ag_hop_plain(src, dst, dst2)
        return
    check(lib().otc_ag_hop(
        src.data_ptr(), dst.data_ptr(),
        dst2.data_ptr() if dst2 is not None else None,
        dst.numel() * dst.element_size(), _stream_ptr(dst)),
        "ring_ag_hop launch")
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
    L = lib()
    if len(srcs) > L.otc_max_peers():
        raise ValueError(f"linear_fold: {len(srcs)} sources, at most "
                         f"{L.otc_max_peers()}")
    ptrs = (ctypes.c_void_p * len(srcs))(*[s.data_ptr() for s in srcs])
    check(L.otc_linear_fold(
        DTYPE_CODES[dst.dtype], OP_CODES[op], ptrs, len(srcs),
        dst.data_ptr(), dst.numel(), _stream_ptr(dst)),
        "linear_fold launch")
    linear_fold.launches += 1


linear_fold.launches = 0

KERNELS = (ring_rs_hop, ring_ag_hop, linear_fold)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


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
              out: Optional[torch.Tensor]) -> Iterator[Tuple]:
    """Ring reduce-scatter over the staged input's chunks (chunk j =
    elements [j*k+lo, j*k+lo+w)); the last hop also writes ``out``."""
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
        ring_rs_hop(slot(prev, h % 2), own((r - (s + 2) * d) % n),
                    slot(r, (h + 1) % 2), op,
                    dst2=out if s == n - 2 else None)
        yield (d,)


def _ag_steps(ep: Ring, dtype, d: int, k: int, lo: int, w: int,
              out: torch.Tensor,
              init: Optional[torch.Tensor]) -> Iterator[Tuple]:
    """Ring allgather of w-element blocks into ``out`` (block j at
    [j*k+lo, j*k+lo+w)). ``init`` is this rank's block; None continues
    from the block the own current slot already holds (the allreduce's
    reduce-scatter result)."""
    n, r = ep.n, ep.rank
    prev = (r - d) % n

    def slot(p, i):
        return _view(ep.slot(p, d, i), dtype, 0, w)

    def block(j):
        return out[j * k + lo:j * k + lo + w]

    if init is not None:
        slot(r, (ep.hops[d] + 1) % 2).copy_(init)
        block(r).copy_(init)
        yield (d,)
    for s in range(n - 1):
        h = ep.hops[d]
        ring_ag_hop(slot(prev, h % 2), slot(r, (h + 1) % 2),
                    dst2=block((r - (s + 1) * d) % n))
        yield (d,)


def _fold_steps(ep: Ring, dtype, op: str, off: int, m: int,
                out: torch.Tensor) -> Iterator[Tuple]:
    yield (ALL,)  # every rank has staged its input
    linear_fold([_view(ep.inputs[p], dtype, off, m) for p in range(ep.n)],
                out, op)
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
    """Reduce-scatter of the 1-D ``flat`` (n chunks of rows of ``row``
    elements) into ``out`` (one chunk). bidir sends the front half of
    each chunk's rows clockwise and the back half counterclockwise."""
    n, r = ep.n, ep.rank
    k = flat.numel() // n
    _stage(ep, flat, flat.numel())
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


def ring_order(n: int, c: int, d: int) -> List[int]:
    """The rank order in which the ring folds chunk c (direction d):
    ranks c+d, c+2d, ..., c+n*d = c — an oracle independent of the hop
    machinery, used by the examples and tests."""
    return [(c + i * d) % n for i in range(1, n + 1)]

