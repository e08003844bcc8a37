"""File views — datatype-driven file decomposition.

The port's copy of ``ompi_tpu.io.fileview``, over the port's
``datatype/datatype.py`` span tables (darray among them).

Reference: ompi/mca/common/ompio/common_ompio_file_view.c — a view is
(disp, etype, filetype); the bytes a rank sees are the filetype's
non-hole spans, tiled by its extent from disp onwards. The reference
flattens the filetype into an (offset, length) iovec list; here the
datatype engine's vectorized span tables (ompi_tpu_torch/datatype) already
ARE that list, so view arithmetic is numpy over span arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.datatype import datatype as dt_mod


class FileView:
    """Maps visible-byte positions to absolute file offsets."""

    def __init__(self, disp: int = 0,
                 etype: dt_mod.Datatype = dt_mod.BYTE,
                 filetype: dt_mod.Datatype = None) -> None:
        self.disp = disp
        self.etype = etype
        self.filetype = filetype if filetype is not None else etype
        spans = self.filetype.spans  # (N, 2) [offset, length] per tile
        self._offs = spans[:, 0].astype(np.int64)
        self._lens = spans[:, 1].astype(np.int64)
        self._cum = np.concatenate(
            ([0], np.cumsum(self._lens)))  # visible bytes before span i
        self.bytes_per_tile = int(self._cum[-1])
        self.tile_extent = self.filetype.extent
        if self.bytes_per_tile == 0:
            raise errors.MPIError(errors.ERR_ARG,
                                  "filetype has no data bytes")
        if self.etype.size and self.bytes_per_tile % self.etype.size:
            raise errors.MPIError(
                errors.ERR_ARG,
                "filetype size not a multiple of etype size")

    def is_contiguous(self) -> bool:
        return (len(self._offs) == 1 and self._offs[0] == 0
                and self._lens[0] == self.tile_extent)

    def visible_size(self, file_size: int) -> int:
        """Inverse of :meth:`map` for SEEK_END: how many VISIBLE bytes
        lie below absolute file offset ``file_size`` (both file
        pointers live in visible space; the physical size does not)."""
        rel = file_size - self.disp
        if rel <= 0:
            return 0
        tiles = rel // self.tile_extent
        within = rel - tiles * self.tile_extent
        part = int(np.minimum(np.maximum(within - self._offs, 0),
                              self._lens).sum())
        return int(tiles * self.bytes_per_tile + part)

    def map(self, pos: int, nbytes: int) -> List[Tuple[int, int]]:
        """Visible range [pos, pos+nbytes) -> merged absolute
        (file_offset, length) extents."""
        if nbytes <= 0:
            return []
        if self.is_contiguous():
            return [(self.disp + pos, nbytes)]
        out: List[Tuple[int, int]] = []
        end = pos + nbytes
        tile = pos // self.bytes_per_tile
        within = pos - tile * self.bytes_per_tile
        while pos < end:
            # span containing `within` visible bytes into this tile
            i = int(np.searchsorted(self._cum, within, side="right")) - 1
            span_rem = int(self._lens[i] - (within - self._cum[i]))
            take = min(span_rem, end - pos)
            file_off = (self.disp + tile * self.tile_extent
                        + int(self._offs[i]) + int(within - self._cum[i]))
            if out and out[-1][0] + out[-1][1] == file_off:
                prev = out[-1]  # coalesce adjacent extents
                out[-1] = (prev[0], prev[1] + take)
            else:
                out.append((file_off, take))
            pos += take
            within += take
            if within >= self.bytes_per_tile:
                tile += 1
                within = 0
        return out
