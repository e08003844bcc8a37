"""btl/self — loopback transport.

The port's copy of ``ompi_tpu.btl.self_btl`` (reference: opal/mca/btl/self):
a send to one's own rank is queued and delivered at the next progress
sweep, so matching never recurses inside a send made by the matching
engine itself.
"""

from __future__ import annotations

from collections import deque

from ompi_tpu_torch.btl import base
from ompi_tpu_torch.runtime import rte


class SelfBtl(base.Btl):
    NAME = "self"
    PRIORITY = 100  # exclusively owns self-sends (reference exclusivity)
    EAGER_LIMIT_DEFAULT = 1 << 30  # loopback copies once either way

    def __init__(self) -> None:
        super().__init__()
        self._queue: deque = deque()

    def reachable(self, peer: int) -> bool:
        return peer == rte.rank

    def send(self, dst: int, data: bytes) -> None:
        if dst != rte.rank:
            raise ValueError(f"btl/self cannot reach rank {dst}")
        self._queue.append(data)

    def progress(self) -> int:
        n = 0
        while self._queue:
            base.deliver(self._queue.popleft())
            n += 1
        return n
