"""osc/cuda_kernels — the one-sided (RMA) kernels K7-K10.

Port of :mod:`ompi_tpu.osc.pallas_kernels`. Four kernels written by hand
in CUDA C++ for Hopper (``csrc/rma_kernels.cu``, built with nvcc for
``sm_90a`` into a plain C library loaded with ctypes, beside the ring
kernels' library and by the same :func:`ompi_tpu_torch.coll.cuda_kernels.
build`):

- :func:`rma_apply` (K7) — ``window[d:d+k] = C(window[d:d+k], payload)``
  in place, ``d`` the reference's start (:func:`clamp_start`: a ``disp``
  in ``[-size, 0)`` counts from the end, then clamped into
  ``[0, size-k]``);
- :func:`rma_apply_strided` (K8) — ``window[d+i*s] = C(window[d+i*s],
  payload[i])`` for the ``i < k`` whose index lies in the window; the rest
  are dropped;
- :func:`rma_read` (K9) — ``window[d:d+k]`` (the same start), or
  ``window[d+i*s]`` with jnp.take's fill mode: an index in ``[-size, 0)``
  counts from the end, one outside ``[-size, size)`` reads NaN (float32,
  bfloat16) or INT_MIN (int32); written into the caller's ``out``;
- :func:`rma_permute_recv` (K10) — the receive side of one edge-coloured
  round: the payload the round's source staged in its arena slot, copied
  through the peer pointer into the landing tensor, or zeros when the
  round gives no source.

``C(current, payload)`` is ``payload`` for the kinds ``put`` and
``replace``, and for ``sum``, ``prod``, ``min`` and ``max`` the ring
kernels' combine (:func:`ompi_tpu_torch.coll.cuda_kernels.combine`, with
jnp's NaN, -0/+0, bfloat16 and int32 rules), in the reference's operand
order (``_COMBINE``, pallas_kernels.py:50-57).

Each has a plain PyTorch version beside it (``*_plain``). A wrapper takes
the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``. Unlike the reference, whose arrays are immutable,
the applies update the window tensor in place.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

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


def build(verbose: bool = False) -> str:
    """Build the RMA kernel library (see ``coll.cuda_kernels.build``)."""
    return K.build(_SRC, verbose)


_lib = None


def lib():
    """The loaded RMA kernel library (built on first use)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build())
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        L.orm_apply.argtypes = [i, i, p, i64, p, i64, i64, p]
        L.orm_apply_strided.argtypes = [i, i, p, i64, p, i64, i64, i64, p]
        L.orm_read.argtypes = [i, p, i64, p, i64, i64, i64, ctypes.c_uint32,
                               p]
        L.orm_permute_recv.argtypes = [p, p, i64, p]
        L.orm_error_string.argtypes = [i]
        L.orm_error_string.restype = ctypes.c_char_p
        for fn in (L.orm_apply, L.orm_apply_strided, L.orm_read,
                   L.orm_permute_recv):
            fn.restype = ctypes.c_int
        _lib = L
    return _lib


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().orm_error_string(rc).decode(errors="replace")
        raise K.KernelError(f"{what}: CUDA error {rc} ({msg})")


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(what: str, window: torch.Tensor, other: torch.Tensor,
           kind: Optional[str] = None) -> str:
    """Operand checks; returns the device type."""
    for t in (window, other):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be 1-D and contiguous")
        if t.device.type != window.device.type:
            raise ValueError(f"{what}: tensors on {window.device} and "
                             f"{t.device}")
        if t.dtype != window.dtype:
            raise ValueError(f"{what}: mixed dtypes {window.dtype} and "
                             f"{t.dtype}")
    if window.dtype not in K.DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {window.dtype}")
    if kind is not None and kind not in KINDS:
        raise ValueError(f"{what}: unsupported kind {kind!r}")
    if window.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {window.device}")
    return window.device.type


def clamp_start(size: int, k: int, disp: int) -> int:
    """The start the reference's k-slice at ``disp`` takes: a ``disp`` in
    ``[-size, 0)`` counts from the end (as Pallas indexing does), then the
    start is clamped into ``[0, size-k]`` (as ``lax.dynamic_slice``
    clamps it)."""
    d = int(disp)
    if d < 0:
        d += size
    return min(max(d, 0), size - k)


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
        raise ValueError(f"rma_apply: payload of {payload.numel()} elements "
                         f"into a window of {window.numel()}")
    if kind_dev == "cpu":
        rma_apply_plain(window, payload, disp, kind)
        return
    if payload.numel() == 0:
        return
    _check_rc(lib().orm_apply(
        K.DTYPE_CODES[window.dtype], KINDS[kind], window.data_ptr(),
        window.numel(), payload.data_ptr(), payload.numel(), int(disp),
        _stream_ptr(window)), "rma_apply launch")
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


def rma_apply_strided(window: torch.Tensor, payload: torch.Tensor,
                      disp: int, stride: int, kind: str) -> None:
    """K8: ``window[d+i*s] = C(window[d+i*s], payload[i])`` for every
    ``i < k`` with ``0 <= d+i*s < size``; a stride <= 0 hits nothing.
    Replaces osc/pallas_kernels.py ``_apply_strided_fn`` (:111, call
    :127). Bound: one 32-byte sector read and one written per element
    that lands, plus the payload read."""
    if _check("rma_apply_strided", window, payload, kind) == "cpu":
        rma_apply_strided_plain(window, payload, disp, stride, kind)
        return
    if payload.numel() == 0 or stride <= 0:
        return
    _check_rc(lib().orm_apply_strided(
        K.DTYPE_CODES[window.dtype], KINDS[kind], window.data_ptr(),
        window.numel(), payload.data_ptr(), payload.numel(), int(disp),
        int(stride), _stream_ptr(window)), "rma_apply_strided launch")
    rma_apply_strided.launches += 1


rma_apply_strided.launches = 0


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
    """K9: ``out = window[d:d+k]`` (stride 1, d = :func:`clamp_start` of
    ``disp``) or
    ``window[d+i*s]`` with the fill mode of jnp.take, k = ``out.numel()``;
    returns ``out``. Replaces osc/pallas_kernels.py ``_read_fn`` (:133,
    calls :144 and :152; via ``read`` :175). Bound: bytes, k elements
    read (a 32-byte sector each when strided) and k written."""
    kind_dev = _check("rma_read", window, out)
    if stride == 1 and out.numel() > window.numel():
        raise ValueError(f"rma_read: {out.numel()} elements from a window "
                         f"of {window.numel()}")
    if kind_dev == "cpu":
        rma_read_plain(window, disp, stride, out)
        return out
    if out.numel() == 0:
        return out
    _check_rc(lib().orm_read(
        K.DTYPE_CODES[window.dtype], window.data_ptr(), window.numel(),
        out.data_ptr(), out.numel(), int(disp), int(stride),
        FILL_BITS[window.dtype], _stream_ptr(out)), "rma_read launch")
    rma_read.launches += 1
    return out


rma_read.launches = 0


# ---------------------------------------------------------------------------
# K10


def rma_permute_recv_plain(src: Optional[torch.Tensor], out) -> None:
    if src is None:
        out.zero_()
    else:
        out.copy_(src)


def rma_permute_recv(src: Optional[torch.Tensor],
                     out: torch.Tensor) -> torch.Tensor:
    """K10: ``out = src`` — the payload a round's source rank staged in
    its own arena slot, read through the peer pointer — or zeros when the
    round gives this rank no source (``src`` None, the reference's -1);
    returns ``out``. Replaces osc/pallas_kernels.py ``dma_permute`` (:192,
    call :247), whose partner handshake is the host's here
    (``coll.cuda.Arena.round``). Bound: bytes, k elements read and k
    written."""
    if out.dim() != 1 or not out.is_contiguous() \
            or out.dtype not in K.DTYPE_CODES \
            or out.device.type not in ("cpu", "cuda"):
        raise ValueError("rma_permute_recv: out must be a 1-D contiguous "
                         "float32, bfloat16 or int32 tensor")
    # src may lie on a peer's card: only the device type must match
    if src is not None and (
            src.numel() != out.numel() or src.dtype != out.dtype
            or not src.is_contiguous()
            or src.device.type != out.device.type):
        raise ValueError(f"rma_permute_recv: source {tuple(src.shape)} "
                         f"{src.dtype} on {src.device} does not match out "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if out.device.type == "cpu":
        rma_permute_recv_plain(src, out)
        return out
    if out.numel() == 0:
        return out
    _check_rc(lib().orm_permute_recv(
        src.data_ptr() if src is not None else None, out.data_ptr(),
        out.numel() * out.element_size(), _stream_ptr(out)),
        "rma_permute_recv launch")
    rma_permute_recv.launches += 1
    return out


rma_permute_recv.launches = 0

KERNELS = (rma_apply, rma_apply_strided, rma_read, rma_permute_recv)


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
