"""osc/cuda_kernels — the one-sided (RMA) kernels K7-K10.

Port of :mod:`ompi_tpu.osc.pallas_kernels`. Kernels written by hand in
CUDA C++ for Hopper (``csrc/rma_kernels.cu``, built with nvcc for
``sm_90a`` into a plain C library loaded with ctypes, beside the ring
kernels' library and by the same :func:`ompi_tpu_torch.coll.cuda_kernels.
build`):

- :func:`rma_apply` (K7) — ``window[d:d+k] = C(window[d:d+k], payload)``
  in place, ``d`` the reference's start (:func:`clamp_start`: a ``disp``
  in ``[-size, 0)`` counts from the end, then clamped into
  ``[0, size-k]``);
- :func:`rma_apply_strided_batch` (K8, grouped) — a list of descriptors
  ``(payload, disp, stride, kind)`` applied in order, each as the
  reference's ``apply`` does it: K7's rule for stride 1, else
  ``window[d+i*s] = C(window[d+i*s], payload[i])`` for the ``i < k`` whose
  index lies in the window (the rest are dropped). The host cuts the list,
  in order, into runs of descriptors that touch disjoint elements, and
  each run is one launch over a table of at most :data:`TABLE_CAP`
  descriptors; contiguous descriptors of :data:`K7_MIN` elements or more
  go to K7. :func:`rma_apply_strided` is its batch of one, with the
  strided rule at every stride;
- :func:`rma_read_batch` (K9, grouped) — a list of reads ``(disp, stride,
  k, out offset)`` from one window into one output: ``window[d:d+k]``
  (stride 1, the same start), or ``window[d+i*s]`` with jnp.take's fill
  mode: an index in ``[-size, 0)`` counts from the end, one outside
  ``[-size, size)`` reads NaN (float32, bfloat16) or INT_MIN (int32).
  :func:`rma_read` is its batch of one;
- :func:`rma_permute_recv_batch` (K10, grouped) — the blocks source
  ranks staged in their arena regions, each copied through the peer
  pointer into its landing tensor, or zeros where there is no source: one
  launch per table of at most :data:`COPY_CAP` spans (every source of an
  exchange). :func:`rma_permute_recv` is its batch of one.

``C(current, payload)`` is ``payload`` for the kinds ``put`` and
``replace``, and for ``sum``, ``prod``, ``min`` and ``max`` the ring
kernels' combine (:func:`ompi_tpu_torch.coll.cuda_kernels.combine`, with
jnp's NaN, -0/+0, bfloat16 and int32 rules), in the reference's operand
order (``_COMBINE``, pallas_kernels.py:50-57).

Each has a plain PyTorch version beside it (``*_plain``; a batch's is the
loop of the single plain versions). A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. Each wrapper counts its launches in ``<wrapper>.launches``.
Unlike the reference, whose arrays are immutable, the applies update the
window tensor in place.

The public wrappers check every operand on every call. The one-sided
fence instead keeps a :class:`Target` per window, checked once at
creation (pointer, element count, dtype code, fill bits, device), whose
``apply`` / ``read`` take only descriptors: the launch path reads the raw
stream handle (``torch._C._cuda_getCurrentRawStream``) and passes a
packed table, so a call costs a few ctypes arguments.

A wrapper's argument checks raise ``ValueError``: a contract between the
wrappers and their callers inside the port (coll/cuda, coll/device,
osc/cuda), which check what a user passes at the API and raise
``MPIError`` there; the tests hold these checks as ``ValueError``. Each
such ``raise`` carries ``# check: disable=bare-public-raise; wrapper
contract`` for the check plane's lint.
"""

from __future__ import annotations

import ctypes
import os
import struct
from bisect import bisect_left, bisect_right
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch.coll import cuda_kernels as K

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "rma_kernels.cu")

#: accumulate kind -> the kernels' op code (put and replace overwrite)
KINDS = {"sum": 0, "prod": 1, "min": 2, "max": 3, "put": 4, "replace": 4}
ELEMENTWISE = frozenset(KINDS)
_OP_NAME = {"sum": "MPI_SUM", "prod": "MPI_PROD", "min": "MPI_MIN",
            "max": "MPI_MAX"}
#: K9's fill for indices outside the window, as bit patterns
FILL_BITS = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC0,
             torch.int32: 0x80000000}
#: a contiguous apply of at least this many elements keeps K7: it fills
#: the card on its own (a grid-stride loop of 16-byte vectors over 132 x 16
#: blocks), where a batch table would only add a search per tile
K7_MIN = 1 << 20
#: descriptors per launch of a batch (ORM_TABLE_MAX in rma_kernels.cu: the
#: table travels in the kernel's parameter block, at most 32,764 bytes)
TABLE_CAP = 1016
_I32_MAX = (1 << 31) - 1
#: spans per launch of K10's batch (ORM_COPY_MAX in rma_kernels.cu: at
#: least a source per rank of the largest communicator, OTC_MAX_PEERS)
COPY_CAP = 64

#: the kernels' descriptor layouts (ApplyDesc, ReadDesc: 32 bytes each)
_APPLY_DESC = np.dtype([("pay", "<u8"), ("d", "<i8"), ("k", "<i4"),
                        ("s", "<i4"), ("op", "<i4"), ("tile0", "<i4")])
_READ_DESC = np.dtype([("d", "<i8"), ("s", "<i8"), ("out", "<i8"),
                       ("k", "<i4"), ("tile0", "<i4")])
_ONE_APPLY = struct.Struct("<Qqiiii")
_ONE_READ = struct.Struct("<qqqii")
#: K10's span as the host hands it over (CopyDesc: src or 0, dst, count)
_COPY_DESC = "QQq"


def build(verbose: bool = False) -> str:
    """Build the RMA kernel library (see ``coll.cuda_kernels.build``)."""
    return K.build(_SRC, verbose)


_lib = None


def lib():
    """The loaded RMA kernel library (built on first use)."""
    global _lib
    if _lib is None:
        L = K.load(_SRC, "osc_cuda")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        L.orm_apply.argtypes = [i, i, p, i64, p, i64, i64, p]
        L.orm_apply_strided_batch.argtypes = [i, p, p, i, p]
        L.orm_read_batch.argtypes = [i, p, i64, p, ctypes.c_uint32, p, i, p]
        L.orm_permute_recv.argtypes = [i, p, p, i64, p]
        L.orm_permute_recv_batch.argtypes = [i, ctypes.c_char_p, i, p]
        L.orm_table_max.argtypes = []
        L.orm_copy_max.argtypes = []
        L.orm_error_string.argtypes = [i]
        L.orm_error_string.restype = ctypes.c_char_p
        for fn in (L.orm_apply, L.orm_apply_strided_batch, L.orm_read_batch,
                   L.orm_permute_recv, L.orm_permute_recv_batch,
                   L.orm_table_max, L.orm_copy_max):
            fn.restype = ctypes.c_int
        if L.orm_table_max() != TABLE_CAP or L.orm_copy_max() != COPY_CAP:
            raise K.KernelError(
                f"rma_kernels.cu takes {L.orm_table_max()} descriptors and "
                f"{L.orm_copy_max()} spans per launch, not {TABLE_CAP} and "
                f"{COPY_CAP}")
        _lib = L
    return _lib


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().orm_error_string(rc).decode(errors="replace")
        raise K.KernelError(f"{what}: CUDA error {rc} ({msg})")


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's card as a raw handle (no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check(what: str, window: torch.Tensor, other: torch.Tensor,
           kind: Optional[str] = None) -> str:
    """Operand checks; returns the device type."""
    if other.dtype != window.dtype:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: mixed dtypes {window.dtype} and "
            f"{other.dtype}")
    if window.dtype not in K.DTYPE_CODES:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: unsupported dtype {window.dtype}")
    if window.dim() != 1 or other.dim() != 1 or not (
            window.is_contiguous() and other.is_contiguous()):
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: operands must be 1-D and contiguous")
    if kind is not None and kind not in KINDS:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: unsupported kind {kind!r}")
    if window.is_cuda:
        if not other.is_cuda:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"{what}: tensors on {window.device} and "
                f"{other.device}")
        return "cuda"
    if window.device.type != "cpu" or other.device.type != "cpu":
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: tensors on {window.device} and "
            f"{other.device} (cpu or cuda only)")
    return "cpu"


def clamp_start(size: int, k: int, disp: int) -> int:
    """The start the reference's k-slice at ``disp`` takes: a ``disp`` in
    ``[-size, 0)`` counts from the end (as Pallas indexing does), then the
    start is clamped into ``[0, size-k]`` (as ``lax.dynamic_slice``
    clamps it)."""
    d = int(disp)
    if d < 0:
        d += size
    return min(max(d, 0), size - k)


def strided_span(size: int, k: int, disp: int,
                 stride: int) -> Optional[Tuple[int, int, int]]:
    """What a strided apply of k elements at ``disp`` lands: (first window
    index, elements, first payload index), or None when nothing does (k
    == 0, a stride <= 0, every index outside the window)."""
    d, s = int(disp), int(stride)
    if k <= 0 or s <= 0 or d > size - 1:
        return None
    i0 = 0 if d >= 0 else -(d // s)  # the first i with d + i*s >= 0
    i1 = min(k - 1, (size - 1 - d) // s)
    if i0 > i1:
        return None
    return d + i0 * s, i1 - i0 + 1, i0


def combine_plain(kind: str, cur: torch.Tensor,
                  payload: torch.Tensor) -> torch.Tensor:
    if kind in ("put", "replace"):
        return payload
    return K.combine(_OP_NAME[kind], cur, payload)


def _fill(dtype, device) -> torch.Tensor:
    bits = FILL_BITS[dtype]
    if dtype == torch.bfloat16:
        return torch.tensor(bits, dtype=torch.int16,
                            device=device).view(torch.bfloat16)
    t = torch.tensor(bits - (1 << 32) if bits >= 1 << 31 else bits,
                     dtype=torch.int32, device=device)
    return t.view(dtype)


# ---------------------------------------------------------------------------
# the plans: a descriptor list cut into launches (pure host code, the
# same on every device, so the CPU tests reach it)


class _Cover:
    """Sorted, disjoint closed intervals of integers."""

    __slots__ = ("lo", "hi")

    def __init__(self) -> None:
        self.lo: List[int] = []
        self.hi: List[int] = []

    def hits(self, a: int, b: int) -> bool:
        i = bisect_right(self.lo, b)  # intervals starting at or before b
        return i > 0 and self.hi[i - 1] >= a

    def add(self, a: int, b: int) -> None:
        i, j = bisect_left(self.hi, a), bisect_right(self.lo, b)
        if i < j:  # merge what [a, b] overlaps
            a, b = min(a, self.lo[i]), max(b, self.hi[j - 1])
        self.lo[i:j] = [a]
        self.hi[i:j] = [b]


def disjoint_runs(spans: Sequence[Tuple[int, int, int]]
                  ) -> List[Tuple[int, int]]:
    """Cut a list of footprints ``(lo, hi, s)`` — the elements lo, lo+s,
    ..., hi — in order into maximal runs of pairwise disjoint footprints;
    returns each run as ``(start, stop)`` indices. Two footprints of one
    stride are tested exactly (the same residue mod s and overlapping
    ranges); of two strides conservatively (overlapping ranges)."""
    if not spans:
        return []
    s0 = spans[0][2]
    if all(s == s0 for _lo, _hi, s in spans):  # one stride: one sort
        iv = sorted((lo % s0, lo, hi) for lo, hi, _s in spans)
        if all(a[0] != b[0] or a[2] < b[1] for a, b in zip(iv, iv[1:])):
            return [(0, len(spans))]
    runs, start = [], 0
    exact: dict = {}  # (s, residue) -> _Cover
    hull: dict = {}  # s -> _Cover of its ranges
    for i, (lo, hi, s) in enumerate(spans):
        key = (s, lo % s)
        if (key in exact and exact[key].hits(lo, hi)) or any(
                c.hits(lo, hi) for t, c in hull.items() if t != s):
            runs.append((start, i))
            start, exact, hull = i, {}, {}
        exact.setdefault(key, _Cover()).add(lo, hi)
        hull.setdefault(s, _Cover()).add(lo, hi)
    runs.append((start, len(spans)))
    return runs


def plan_apply(size: int, rows, cap: int = TABLE_CAP) -> List[Tuple]:
    """The launches that apply ``rows`` — ``(payload index, payload offset,
    k, disp, stride, kind)``, in order — to a window of ``size`` elements
    exactly as a loop of :func:`apply_plain` would: ``("k7", (b, off, d, k,
    op))`` for a contiguous row of :data:`K7_MIN` elements or more, and
    ``("k8", [(b, off, d, k, s, op), ...])`` tables of at most ``cap``
    pairwise disjoint rows whose every index lands (contiguous starts
    clamped, strided rows cut to what lies in the window, rows that land
    nothing dropped)."""
    plan: List[Tuple] = []
    run: list = []
    spans: list = []

    def flush() -> None:
        for a, b in disjoint_runs(spans):
            for c in range(a, b, cap):
                plan.append(("k8", run[c:min(b, c + cap)]))
        run.clear()
        spans.clear()

    for b, off, k, disp, stride, kind in rows:
        op = KINDS[kind]
        if stride == 1:
            if k > size:
                raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                    f"apply: payload of {k} elements into a "
                    f"window of {size}")
            if k == 0:
                continue
            d = clamp_start(size, k, disp)
            if k >= K7_MIN:
                flush()
                plan.append(("k7", (b, off, d, k, op)))
                continue
            n, s = k, 1
        else:
            span = strided_span(size, k, disp, stride)
            if span is None:
                continue
            d, n, i0 = span
            off += i0
            s = stride if n > 1 else 1
            if s > _I32_MAX or n > _I32_MAX:
                raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                    f"apply: stride {stride} x {n} elements "
                    "exceeds the kernel's 32-bit fields")
        run.append((b, off, d, n, s, op))
        spans.append((d, d + (n - 1) * s, s))
    flush()
    return plan


def plan_read(size: int, rows, cap: int = TABLE_CAP) -> List[list]:
    """K9 tables for ``rows`` — ``(disp, stride, k, out offset)`` — of at
    most ``cap`` descriptors ``(d, s, out offset, k)`` each: contiguous
    starts clamped, empty reads dropped."""
    tab = []
    for disp, stride, k, off in rows:
        if k <= 0:
            continue
        if stride == 1:
            if k > size:
                raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                    f"read: {k} elements from a window of "
                    f"{size}")
            tab.append((clamp_start(size, k, disp), 1, off, k))
        else:
            if k > _I32_MAX:
                raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                    f"read: {k} elements exceed the kernel's "
                    "32-bit count")
            tab.append((int(disp), int(stride), off, k))
    return [tab[c:c + cap] for c in range(0, len(tab), cap)]


# ---------------------------------------------------------------------------
# K7


def rma_apply_plain(window, payload, disp: int, kind: str) -> None:
    k = payload.numel()
    if k == 0:
        return
    d = clamp_start(window.numel(), k, disp)
    view = window[d:d + k]
    view.copy_(combine_plain(kind, view, payload))


def rma_apply(window: torch.Tensor, payload: torch.Tensor, disp: int,
              kind: str) -> None:
    """K7: ``window[d:d+k] = C(window[d:d+k], payload)`` in place, d =
    :func:`clamp_start` of ``disp``. Replaces osc/pallas_kernels.py
    ``_apply_fn`` (:92, call :105; via ``apply`` :161 with stride 1).
    Bound: bytes, 2k elements for put/replace and 3k for the folds."""
    kind_dev = _check("rma_apply", window, payload, kind)
    if payload.numel() > window.numel():
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"rma_apply: payload of {payload.numel()} elements "
            f"into a window of {window.numel()}")
    if kind_dev == "cpu":
        rma_apply_plain(window, payload, disp, kind)
        return
    if payload.numel() == 0:
        return
    _check_rc(lib().orm_apply(
        K.DTYPE_CODES[window.dtype], KINDS[kind], window.data_ptr(),
        window.numel(), payload.data_ptr(), payload.numel(), int(disp),
        _stream(window)), "rma_apply launch")
    rma_apply.launches += 1


rma_apply.launches = 0


# ---------------------------------------------------------------------------
# K8


def _strided_index(size: int, k: int, disp: int, stride: int, device):
    return int(disp) + int(stride) * torch.arange(k, dtype=torch.int64,
                                                  device=device)


def rma_apply_strided_plain(window, payload, disp: int, stride: int,
                            kind: str) -> None:
    k = payload.numel()
    if k == 0 or stride <= 0:
        return
    idx = _strided_index(window.numel(), k, disp, stride, window.device)
    keep = (idx >= 0) & (idx < window.numel())
    idx = idx[keep]
    window[idx] = combine_plain(kind, window[idx], payload[keep])


def apply_plain(window, payload, disp: int, kind: str,
                stride: int = 1) -> None:
    """The reference's ``apply`` (:161) in plain PyTorch: K7's plain version
    for stride 1, K8's otherwise."""
    if stride == 1:
        rma_apply_plain(window, payload, disp, kind)
    else:
        rma_apply_strided_plain(window, payload, disp, stride, kind)


def rma_apply_strided(window: torch.Tensor, payload: torch.Tensor,
                      disp: int, stride: int, kind: str) -> None:
    """K8, the batch of one: ``window[d+i*s] = C(window[d+i*s],
    payload[i])`` for every ``i < k`` with ``0 <= d+i*s < size``; a stride
    <= 0 hits nothing. Replaces osc/pallas_kernels.py ``_apply_strided_fn``
    (:111, call :127). Bound: one 32-byte sector read and one written per
    element that lands, plus the payload read."""
    if _check("rma_apply_strided", window, payload, kind) == "cpu":
        rma_apply_strided_plain(window, payload, disp, stride, kind)
        return
    span = strided_span(window.numel(), payload.numel(), disp, stride)
    if span is None:
        return
    d, n, i0 = span
    s = stride if n > 1 else 1
    if s > _I32_MAX or n > _I32_MAX:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"rma_apply_strided: stride {stride} x {n} elements "
            "exceeds the kernel's 32-bit fields")
    _check_rc(lib().orm_apply_strided_batch(
        K.DTYPE_CODES[window.dtype], window.data_ptr(), _ONE_APPLY.pack(
            payload.data_ptr() + i0 * payload.element_size(), d, n, s,
            KINDS[kind], 0), 1, _stream(window)), "rma_apply_strided launch")
    rma_apply_strided.launches += 1


rma_apply_strided.launches = 0


def rma_apply_strided_batch_plain(window, descs) -> None:
    """The loop of the single plain versions, in order."""
    for payload, disp, stride, kind in descs:
        apply_plain(window, payload, disp, kind, stride)


def rma_apply_strided_batch(window: torch.Tensor, descs) -> None:
    """K8, grouped: apply ``descs`` — ``(payload, disp, stride, kind)`` —
    to the window in order, each as :func:`apply` does it (K7's rule for
    stride 1, K8's otherwise), through :func:`plan_apply`: one launch per
    table of pairwise disjoint descriptors, K7 for contiguous ones of
    :data:`K7_MIN` elements or more. Replaces osc/pallas_kernels.py
    ``_apply_strided_fn`` (:111, call :127), grouped. Bound: bytes, each
    payload read once and each element that lands read and written once
    (a 32-byte sector each when strided)."""
    target = Target(window)
    for payload, _d, _s, kind in descs:
        _check("rma_apply_strided_batch", window, payload, kind)
    target.apply([p for p, *_ in descs],
                 [(i, 0, p.numel(), d, s, kind)
                  for i, (p, d, s, kind) in enumerate(descs)])


rma_apply_strided_batch.launches = 0


# ---------------------------------------------------------------------------
# K9


def rma_read_plain(window, disp: int, stride: int, out) -> None:
    size, k = window.numel(), out.numel()
    if k == 0:
        return
    if stride == 1:
        d = clamp_start(size, k, disp)
        out.copy_(window[d:d + k])
        return
    idx = _strided_index(size, k, disp, stride, window.device)
    idx = torch.where(idx < 0, idx + size, idx)
    ok = (idx >= 0) & (idx < size)
    vals = window[idx.clamp(0, size - 1)]
    out.copy_(torch.where(ok, vals, _fill(window.dtype, window.device)))


def rma_read(window: torch.Tensor, disp: int, stride: int,
             out: torch.Tensor) -> torch.Tensor:
    """K9, the batch of one: ``out = window[d:d+k]`` (stride 1, d =
    :func:`clamp_start` of ``disp``) or ``window[d+i*s]`` with the fill
    mode of jnp.take, k = ``out.numel()``; returns ``out``. Replaces
    osc/pallas_kernels.py ``_read_fn`` (:133, calls :144 and :152; via
    ``read`` :175). Bound: bytes, k elements read (a 32-byte sector each
    when strided) and k written."""
    kind_dev = _check("rma_read", window, out)
    k = out.numel()
    if stride == 1 and k > window.numel():
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"rma_read: {k} elements from a window "
            f"of {window.numel()}")
    if kind_dev == "cpu":
        rma_read_plain(window, disp, stride, out)
        return out
    if k == 0:
        return out
    if k > _I32_MAX:
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"rma_read: {k} elements exceed the kernel's "
            "32-bit count")
    d = clamp_start(window.numel(), k, disp) if stride == 1 else int(disp)
    dt = window.dtype
    _check_rc(lib().orm_read_batch(
        K.DTYPE_CODES[dt], window.data_ptr(), window.numel(), out.data_ptr(),
        FILL_BITS[dt], _ONE_READ.pack(d, int(stride), 0, k, 0), 1,
        _stream(window)), "rma_read launch")
    rma_read.launches += 1
    return out


rma_read.launches = 0


def rma_read_batch_plain(window, descs, out) -> torch.Tensor:
    """The loop of the single plain versions, in order."""
    for disp, stride, k, off in descs:
        rma_read_plain(window, disp, stride, out[off:off + k])
    return out


def rma_read_batch(window: torch.Tensor, descs,
                   out: torch.Tensor) -> torch.Tensor:
    """K9, grouped: for each ``(disp, stride, k, out offset)`` of
    ``descs``, ``out[off:off+k]`` = :func:`rma_read` of the window, in one
    launch per table of :data:`TABLE_CAP`; the output ranges must not
    overlap. Returns ``out``. Replaces osc/pallas_kernels.py ``_read_fn``
    (:133), grouped. Bound: bytes, every element read once (a 32-byte
    sector when strided) and written once."""
    target = Target(window)
    _check("rma_read_batch", window, out)
    ranges = sorted((off, off + k) for _d, _s, k, off in descs if k > 0)
    if any(a < 0 or b > out.numel() for a, b in ranges) or any(
            ranges[i][1] > ranges[i + 1][0] for i in range(len(ranges) - 1)):
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            "rma_read_batch: output ranges overlap or leave "
            f"out's {out.numel()} elements")
    target.read(descs, out)
    return out


rma_read_batch.launches = 0


# ---------------------------------------------------------------------------
# K10


def rma_permute_recv_plain(src: Optional[torch.Tensor], out) -> None:
    if src is None:
        out.zero_()
    else:
        out.copy_(src)


def _check_land(what: str, src: Optional[torch.Tensor],
                out: torch.Tensor) -> bool:
    """K10's operand checks; returns whether out lies on a card."""
    cuda = out.is_cuda
    if out.dtype not in K.DTYPE_CODES or out.dim() != 1 \
            or not out.is_contiguous() or not (cuda or out.is_cpu):
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: out must be a 1-D contiguous float32, "
            "bfloat16 or int32 tensor")
    # src may lie on a peer's card: only the device type must match
    if src is not None and (
            src.dtype != out.dtype or src.numel() != out.numel()
            or not (src.is_cuda if cuda else src.is_cpu)
            or not src.is_contiguous()):
        raise ValueError(  # check: disable=bare-public-raise; wrapper contract
            f"{what}: source {tuple(src.shape)} {src.dtype} on "
            f"{src.device} does not match out "
            f"{tuple(out.shape)} {out.dtype} on {out.device}")
    return cuda


def rma_permute_recv(src: Optional[torch.Tensor],
                     out: torch.Tensor) -> torch.Tensor:
    """K10, the batch of one: ``out = src`` — a block a source rank staged
    in its own arena region, read through the peer pointer — or zeros
    when there is no source (``src`` None, the reference's -1); returns
    ``out``. Replaces osc/pallas_kernels.py ``dma_permute`` (:192, call
    :247), whose partner handshake is the host's here
    (``coll.cuda.Arena.exchange``). Bound: bytes, k elements read and k
    written (k written for zeros)."""
    if not _check_land("rma_permute_recv", src, out):
        rma_permute_recv_plain(src, out)
        return out
    k = out.numel()
    if k:
        rc = lib().orm_permute_recv(
            K.DTYPE_CODES[out.dtype], src.data_ptr() if src is not None
            else None, out.data_ptr(), k,
            torch._C._cuda_getCurrentRawStream(out.get_device()))
        if rc:
            _check_rc(rc, "rma_permute_recv launch")
        rma_permute_recv.launches += 1
    return out


rma_permute_recv.launches = 0


def rma_permute_recv_batch_plain(pairs) -> None:
    """The loop of the single plain versions, in order."""
    for src, out in pairs:
        rma_permute_recv_plain(src, out)


def copy_tables(pairs, cap: int = COPY_CAP) -> List[Tuple[bytes, int]]:
    """K10's launches for ``pairs`` — ``(src or None, out)``, each checked,
    every ``out`` of one dtype on one device — as packed tables of at most
    ``cap`` spans ``(src pointer or 0, out pointer, elements)`` (the
    kernel's CopyDesc) with their span counts, in order; a table whose
    every span is empty is dropped (it launches nothing)."""
    flat: list = []
    if pairs:
        dt, dev = pairs[0][1].dtype, pairs[0][1].get_device()
    for src, out in pairs:  # one pass: the checks and the spans
        _check_land("rma_permute_recv_batch", src, out)
        if out.dtype != dt or out.get_device() != dev:
            raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                f"rma_permute_recv_batch: outputs {dt} on "
                f"{pairs[0][1].device} and {out.dtype} on "
                f"{out.device}")
        flat += (0 if src is None else src.data_ptr(), out.data_ptr(),
                 out.numel())
    tables = []
    for c in range(0, len(flat), 3 * cap):
        part = flat[c:c + 3 * cap]
        if any(part[2::3]):
            n = len(part) // 3
            tables.append((struct.pack(f"<{_COPY_DESC * n}", *part), n))
    return tables


def rma_permute_recv_batch(pairs: Sequence[Tuple[Optional[torch.Tensor],
                                                 torch.Tensor]]) -> None:
    """K10, grouped: for every ``(src, out)`` of ``pairs``, ``out = src``
    (a source rank's staged block, read through the peer pointer) or
    zeros where ``src`` is None, in one launch per table of at most
    :data:`COPY_CAP` spans (:func:`copy_tables`). Every ``out`` has one
    dtype and lies on one device; the outputs must not overlap. Replaces
    osc/pallas_kernels.py ``dma_permute`` (:192, call :247) for every
    source of an exchange. Bound: bytes, every element read once and
    written once (written only, for zeros)."""
    tables = copy_tables(pairs)
    if not pairs or not pairs[0][1].is_cuda:
        rma_permute_recv_batch_plain(pairs)
        return
    out0 = pairs[0][1]
    L, code = lib(), K.DTYPE_CODES[out0.dtype]
    st = torch._C._cuda_getCurrentRawStream(out0.get_device())
    for tab, n in tables:
        rc = L.orm_permute_recv_batch(code, tab, n, st)
        if rc:
            _check_rc(rc, "rma_permute_recv_batch launch")
        rma_permute_recv_batch.launches += 1


rma_permute_recv_batch.launches = 0

KERNELS = (rma_apply, rma_apply_strided, rma_apply_strided_batch, rma_read,
           rma_read_batch, rma_permute_recv, rma_permute_recv_batch)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def apply(window: torch.Tensor, payload: torch.Tensor, disp: int, kind: str,
          stride: int = 1) -> None:
    """Apply one RMA descriptor to the flat window in place: K7 for
    stride 1, K8 otherwise (the reference's ``apply`` :161)."""
    if stride == 1:
        rma_apply(window, payload, disp, kind)
    else:
        rma_apply_strided(window, payload, disp, stride, kind)


class Target:
    """A window's launch record, checked once at creation: the flat
    window, its element count and, on the card, its pointer, dtype code,
    item size, fill bits and device. :meth:`apply` and :meth:`read` take
    descriptors only, so the one-sided fence pays no per-call operand
    checks (the window is updated in place and never reallocated)."""

    def __init__(self, window: torch.Tensor) -> None:
        _check("Target", window, window)
        self.window = window
        self.size = window.numel()
        self.cuda = window.is_cuda
        if self.cuda:
            self.ptr = window.data_ptr()
            self.code = K.DTYPE_CODES[window.dtype]
            self.esize = window.element_size()
            self.fill = FILL_BITS[window.dtype]
            self.device = window.get_device()

    def apply(self, bases: Sequence[torch.Tensor], rows) -> None:
        """Apply ``rows`` — ``(base index, offset, k, disp, stride,
        kind)`` — in order, each payload ``bases[b][off:off+k]`` (a 1-D
        tensor of the window's dtype: an arena region, on the card a
        peer's through its mapping), as a loop of :func:`apply_plain`
        would: on the card through :func:`plan_apply`'s launches."""
        if not self.cuda:
            if any(s == 1 and k > self.size for _b, _o, k, _d, s, _k in rows):
                raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                    f"apply: a payload larger than the window "
                    f"of {self.size}")
            rma_apply_strided_batch_plain(self.window, [
                (bases[b][off:off + k], disp, stride, kind)
                for b, off, k, disp, stride, kind in rows])
            return
        L, es = lib(), self.esize
        st = torch._C._cuda_getCurrentRawStream(self.device)
        ptrs = [t.data_ptr() for t in bases]
        for what, rs in plan_apply(self.size, rows):
            if what == "k7":
                b, off, d, k, op = rs
                _check_rc(L.orm_apply(self.code, op, self.ptr, self.size,
                                      ptrs[b] + off * es, k, d, st),
                          "rma_apply launch")
                rma_apply.launches += 1
                continue
            tab = np.array([(ptrs[b] + off * es, d, k, s, op, 0)
                            for b, off, d, k, s, op in rs],
                           dtype=_APPLY_DESC)
            _check_rc(L.orm_apply_strided_batch(
                self.code, self.ptr, tab.ctypes.data, len(tab), st),
                "rma_apply_strided_batch launch")
            rma_apply_strided_batch.launches += 1

    def read(self, rows, out: torch.Tensor) -> None:
        """``out[off:off+k]`` = the read ``(disp, stride, k, off)`` of the
        window for every row, in order (the output ranges are disjoint):
        on the card one launch per :func:`plan_read` table."""
        if not self.cuda:
            if any(s == 1 and k > self.size for _d, s, k, _o in rows):
                raise ValueError(  # check: disable=bare-public-raise; wrapper contract
                    f"read: more elements than the window's "
                    f"{self.size}")
            rma_read_batch_plain(self.window, rows, out)
            return
        L, op = lib(), out.data_ptr()
        st = torch._C._cuda_getCurrentRawStream(self.device)
        for rs in plan_read(self.size, rows):
            tab = np.array([(d, s, o, k, 0) for d, s, o, k in rs],
                           dtype=_READ_DESC)
            _check_rc(L.orm_read_batch(self.code, self.ptr, self.size, op,
                                       self.fill, tab.ctypes.data, len(tab),
                                       st), "rma_read_batch launch")
            rma_read_batch.launches += 1
