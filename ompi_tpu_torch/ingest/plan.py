"""IngestPlan — the deterministic cut of a pytree into upload units.

The port's copy of ``ompi_tpu.ingest.plan``: the pytree is flattened in
jax's order (``zero/layout.tree_flatten``), each leaf is cut into
contiguous flat element ranges of at most ``ingest_chunk_bytes``, and
the units go round-robin to the upload streams. Everything is a pure
function of (leaf shapes and dtypes, chunk_bytes, n_streams), so two
ranks building a plan from the same pytree agree on every unit, and a
gate ("step 1 touches leaves 0 and 3") can be stated in plan indices.
Units are the ``Parrived`` granularity: one unit is one staged put and
one completion on the request.

Leaves are numpy arrays (or scalars) or CPU tensors; a bfloat16 tensor
(numpy has no bfloat16) is staged as its int16 bits and its device leaf
reinterpreted (``leaf_dtypes``), so the upload moves the same bytes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.zero import layout as _layout

#: byte alignment of a leaf in the upload's device buffer
ALIGN = 256


class Unit:
    """One upload unit: elements [lo, hi) of flat leaf ``leaf``."""

    __slots__ = ("idx", "leaf", "lo", "hi", "nbytes", "stream")

    def __init__(self, idx: int, leaf: int, lo: int, hi: int,
                 nbytes: int, stream: int) -> None:
        self.idx = idx
        self.leaf = leaf
        self.lo = lo
        self.hi = hi
        self.nbytes = nbytes
        self.stream = stream

    def key(self) -> Tuple[int, int, int, int, int, int]:
        return (self.idx, self.leaf, self.lo, self.hi, self.nbytes,
                self.stream)

    def __repr__(self) -> str:
        return (f"Unit(idx={self.idx}, leaf={self.leaf}, "
                f"[{self.lo},{self.hi}), {self.nbytes}B, "
                f"stream={self.stream})")


def _flatten(tree):
    """(leaves, treedef, keystrs) in jax's order and spelling."""
    pairs = _layout.tree_flatten_with_path(tree)
    leaves, treedef = _layout.tree_flatten(tree)
    return leaves, treedef, [_layout.keystr(p) for p, _ in pairs]


def _host_leaf(leaf) -> Tuple[np.ndarray, Optional[torch.dtype]]:
    """(numpy array over the leaf's bytes, the torch dtype to give its
    device copy when numpy cannot name it)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            raise errors.MPIError(
                errors.ERR_BUFFER,
                f"ingest uploads host leaves; got a tensor on {t.device}")
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), torch.bfloat16
        return t.contiguous().numpy(), None
    return np.asarray(leaf), None


class IngestPlan:
    """The deterministic unit decomposition of one pytree upload."""

    def __init__(self, leaves: Sequence[Any], chunk_bytes: int,
                 n_streams: int, treedef=None,
                 keystrs: Optional[List[str]] = None) -> None:
        if chunk_bytes < 1:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"ingest_chunk_bytes must be >= 1 (got {chunk_bytes})")
        if n_streams < 1:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"ingest_streams must be >= 1 (got {n_streams})")
        self.chunk_bytes = int(chunk_bytes)
        self.n_streams = int(n_streams)
        self.treedef = treedef
        self.keystrs = keystrs or [f"[{i}]" for i in range(len(leaves))]
        #: host leaves, C-contiguous (views where they already are; the
        #: copy keeps a 0-d leaf's shape)
        self.leaves: List[np.ndarray] = []
        #: per leaf, the torch dtype of its device copy where numpy's
        #: differs (bfloat16 staged as int16), else None
        self.leaf_dtypes: List[Optional[torch.dtype]] = []
        for lf in leaves:
            arr, tdt = _host_leaf(lf)
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr).reshape(arr.shape)
            self.leaves.append(arr)
            self.leaf_dtypes.append(tdt)
        self.units: List[Unit] = []
        #: leaf index -> its units, in flat order
        self.leaf_units: List[List[Unit]] = []
        idx = 0
        for li, arr in enumerate(self.leaves):
            mine: List[Unit] = []
            size = int(arr.size)
            itemsize = max(1, int(arr.itemsize))
            if size == 0:
                # a zero-size leaf still gets one unit, so the Parrived
                # and gate indices cover the whole tree
                u = Unit(idx, li, 0, 0, 0, idx % self.n_streams)
                self.units.append(u)
                mine.append(u)
                idx += 1
                self.leaf_units.append(mine)
                continue
            chunk_elems = max(1, self.chunk_bytes // itemsize)
            nch = -(-size // chunk_elems)
            base, rem = divmod(size, nch)
            lo = 0
            for c in range(nch):
                hi = lo + base + (1 if c < rem else 0)
                u = Unit(idx, li, lo, hi, (hi - lo) * itemsize,
                         idx % self.n_streams)
                self.units.append(u)
                mine.append(u)
                idx += 1
                lo = hi
            self.leaf_units.append(mine)
        self.n_units = len(self.units)
        self.total_bytes = sum(u.nbytes for u in self.units)
        #: each leaf's byte offset in the upload's one device buffer
        #: (ALIGN-aligned, so every leaf views its dtype there)
        self.offsets: List[int] = []
        off = 0
        for arr in self.leaves:
            self.offsets.append(off)
            off += -(-int(arr.nbytes) // ALIGN) * ALIGN
        self.buffer_bytes = off
        #: the largest unit: sizes the engine's staging slots
        self.max_unit_bytes = max((u.nbytes for u in self.units),
                                  default=0)
        self._key_index: Dict[str, int] = {
            k: i for i, k in enumerate(self.keystrs)}

    @classmethod
    def from_tree(cls, tree, chunk_bytes: int,
                  n_streams: int) -> "IngestPlan":
        leaves, treedef, keystrs = _flatten(tree)
        return cls(leaves, chunk_bytes, n_streams, treedef=treedef,
                   keystrs=keystrs)

    def leaf_index(self, key) -> int:
        """A leaf reference: an int index, an exact keystr (``"['w0']"``)
        or the bare dict key (``"w0"``)."""
        if isinstance(key, int):
            if not 0 <= key < len(self.leaves):
                raise errors.MPIError(
                    errors.ERR_ARG,
                    f"leaf index {key} out of [0,{len(self.leaves)})")
            return key
        if key in self._key_index:
            return self._key_index[key]
        sugar = f"['{key}']"
        if sugar in self._key_index:
            return self._key_index[sugar]
        raise errors.MPIError(
            errors.ERR_ARG,
            f"unknown leaf {key!r} (known: {self.keystrs})")

    def units_for(self, keys) -> List[Unit]:
        """The units covering the given leaves (a gate's input)."""
        out: List[Unit] = []
        for key in keys:
            out.extend(self.leaf_units[self.leaf_index(key)])
        return out

    def stream_units(self, stream: int) -> List[Unit]:
        """This stream's units, in submission order."""
        return [u for u in self.units if u.stream == stream]

    def signature(self) -> Tuple:
        """Equal signatures <=> identical plans (the determinism
        contract)."""
        return (self.chunk_bytes, self.n_streams,
                tuple(u.key() for u in self.units))
