"""The device convertor: derived datatypes over ``torch.Tensor``s.

The port's counterpart of ``ompi_tpu.datatype.device`` (reference: the
accelerator-aware convertor, opal/datatype/opal_datatype_copy.h, consumed
at ompi/mca/pml/ob1/pml_ob1_sendreq.h:399: a device buffer with a
non-contiguous datatype packs on the device, never through a host bounce
of its whole extent). The span table (``datatype.py``) compiles to an
element-index vector; pack is one gather on the tensor's own device
(``index_select``), unpack one in-place scatter (``index_copy_``) into
the caller's tensor, whose elements outside the type keep their values.
The packed element layout equals the host convertor's pack.

The index vector and its (min, max) bounds are cached per (datatype,
count, itemsize, device) in a registration cache: the vector goes to the
card once per key, and the bounds check reads the cached host ints (no
``.item()``, no synchronise). Spans that do not align to the tensor's
element size (structs of mixed fields) have no device route and raise,
as the reference's do; nothing is staged through the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import mpool

#: (device index vector, (min, max)) per (datatype, count, itemsize,
#: device): the span-table cache's discipline (datatype._span_cache)
_idx_cache = mpool.Rcache()

#: dtypes whose indexing kernels some builds lack, gathered through the
#: signed type of the same size (a view, not a cast: the bits move as is)
_SAME_SIZE = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64, torch.bool: torch.uint8}


def supports(dt, arr) -> bool:
    """True when ``dt`` has a device route over ``arr`` (spans aligned to
    arr's elements)."""
    if dt is None or dt.is_contiguous:
        return True
    k = arr.element_size()
    spans = dt.spans
    return not ((spans[:, 0] % k).any() or (spans[:, 1] % k).any())


def element_indices(dt, count: int, itemsize: int) -> np.ndarray:
    """Flat element indices of ``count`` elements of ``dt`` over an array
    of ``itemsize``-byte elements, in typemap order: the compiled form
    of the datatype for the device convertor."""
    spans = dt.spans_for_count(count)
    if len(spans) == 0:
        return np.empty(0, np.int64)
    if (spans[:, 0] % itemsize).any() or (spans[:, 1] % itemsize).any():
        raise errors.MPIError(
            errors.ERR_TYPE,
            f"datatype {dt.name}: spans are not aligned to the tensor's "
            f"{itemsize}-byte elements, so it has no device route")
    offs = spans[:, 0] // itemsize
    lens = spans[:, 1] // itemsize
    prefix = np.concatenate([[0], np.cumsum(lens[:-1])])
    return (np.repeat(offs, lens)
            + np.arange(int(lens.sum()), dtype=np.int64)
            - np.repeat(prefix, lens))


def _indices(dt, count: int, itemsize: int, device: torch.device):
    """(device index vector, (min, max)) of (dt, count) over
    ``itemsize``-byte elements on ``device``, cached per key."""
    key = mpool.buffer_key(dt, _idx_cache)
    sub = (int(count), itemsize, str(device))
    per = {} if key is None else (_idx_cache.lookup(key) or {})
    got = per.get(sub)
    if got is None:
        idx = element_indices(dt, count, itemsize)
        bounds = (int(idx.min()), int(idx.max())) if len(idx) else (0, -1)
        got = (torch.from_numpy(idx).to(device), bounds)
        if key is not None:
            per = dict(per)
            per[sub] = got
            _idx_cache.insert(key, per,
                              sum(v[0].numel() * 8 for v in per.values()))
    return got


def _check_bounds(dt, count, bounds, numel: int, what: str) -> None:
    lo, hi = bounds
    if hi >= numel or lo < 0:
        raise errors.MPIError(
            errors.ERR_TYPE,
            f"datatype {dt.name} x {count} spans element {hi} but the "
            f"{what} has {numel}")


def _flat(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1)
    return flat.view(_SAME_SIZE[flat.dtype]) if flat.dtype in _SAME_SIZE \
        else flat


def pack(arr: torch.Tensor, dt, count) -> torch.Tensor:
    """Device pack: gather ``count`` elements of ``dt`` out of ``arr``
    into a packed 1-D tensor (the wire layout) on arr's device."""
    flat = arr.reshape(-1)
    if dt is None:
        return flat if count is None else flat[:int(count)]
    k = arr.element_size()
    if dt.is_contiguous:
        return flat[:(dt.size * int(count)) // k]
    idx, bounds = _indices(dt, count, k, arr.device)
    _check_bounds(dt, count, bounds, flat.numel(), "tensor")
    return torch.index_select(_flat(arr), 0, idx).view(arr.dtype)


def unpack(packed: torch.Tensor, dt, count, arr: torch.Tensor):
    """Device unpack: scatter the packed 1-D ``packed`` into ``arr`` in
    place (the port receives in place); arr's elements outside the type
    keep their values. Returns ``arr``."""
    src = packed.reshape(-1)
    work = arr if arr.is_contiguous() else arr.contiguous()
    if dt is None or dt.is_contiguous:
        work.view(-1)[:src.numel()].copy_(src)
    else:
        idx, bounds = _indices(dt, count, arr.element_size(), arr.device)
        _check_bounds(dt, count, bounds, arr.numel(), "tensor")
        _flat(work).index_copy_(0, idx, _flat(src))
    if work is not arr:
        arr.copy_(work)
    return arr


def packed_elems(dt, count, itemsize: int) -> int:
    """The number of wire elements a (dt, count) pack produces."""
    if dt is None:
        return int(count)
    return (dt.size * int(count)) // itemsize
