"""BTL base interface and the BML endpoint multiplexer.

The port's copy of ``ompi_tpu.btl.base`` (reference: opal/mca/btl/btl.h,
the module interface, and ompi/mca/bml/r2, which picks one BTL per peer
by priority). The PML registers one receive callback
(mca_bml_base_register AM callbacks, pml_ob1.c:478-527).

Selection is a plain tuple of components (``COMPONENTS``, in priority
order: self, sm, tcp) filtered by the ``btl`` cvar, an include list
(``self,tcp``) or an exclude list (``^sm``) as in the reference's
framework selection; ``core/registry.py`` is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ompi_tpu_torch.core import cvar, output, progress
from ompi_tpu_torch.runtime import rte

_out = output.stream("btl")

_select_var = cvar.register(
    "btl", "", str,
    help="Comma list of btl components to include (self, sm, tcp), or "
         "to exclude when prefixed with ^ (reference: --mca btl)",
    level=2)

# the PML's AM callback: fn(data: bytes) — framing is PML-private
_recv_cb: Optional[Callable[[bytes], None]] = None


def set_recv_callback(cb: Optional[Callable[[bytes], None]]) -> None:
    global _recv_cb
    _recv_cb = cb


def deliver(data: bytes) -> None:
    if _recv_cb is not None:
        _recv_cb(data)


class Btl:
    """One transport: reliable, ordered delivery per directed pair."""

    NAME = "base"
    PRIORITY = 0
    #: max payload the PML may push in one eager send (btl_eager_limit)
    EAGER_LIMIT_DEFAULT = 65536
    #: max bytes per rndv fragment (btl_max_send_size)
    MAX_SEND_DEFAULT = 131072

    def __init__(self) -> None:
        self.eager_limit = cvar.register(
            f"btl_{self.NAME}_eager_limit", self.EAGER_LIMIT_DEFAULT, int,
            help=f"Max eager message size for btl/{self.NAME} "
                 "(reference: btl_eager_limit)").get()
        self.max_send = cvar.register(
            f"btl_{self.NAME}_max_send_size", self.MAX_SEND_DEFAULT, int,
            help="Max rndv fragment size").get()

    def open(self) -> bool:
        return True

    def reachable(self, peer: int) -> bool:
        raise NotImplementedError

    def send(self, dst: int, data: bytes) -> None:
        """Reliable ordered AM send of one framed message."""
        raise NotImplementedError

    def progress(self) -> int:
        return 0

    def finalize(self) -> None:
        pass


def selected(components) -> list:
    """The component classes the ``btl`` cvar lets through, in the
    tuple's order."""
    entries = [e.strip() for e in _select_var.get().split(",") if e.strip()]
    excludes = {e[1:] for e in entries if e.startswith("^")}
    includes = {e for e in entries if not e.startswith("^")}
    if includes and excludes:
        raise ValueError("btl: cannot mix include and exclude entries "
                         f"({_select_var.get()!r})")
    names = {c.NAME for c in components}
    unknown = (includes | excludes) - names
    if unknown:
        raise ValueError(f"btl: unknown component(s) {sorted(unknown)}; "
                         f"known {sorted(names)}")
    return [c for c in components
            if (c.NAME in includes if includes else c.NAME not in excludes)]


class Bml:
    """Endpoint table: the highest-priority reachable BTL per peer
    (btl/self for self, sm for same-host peers, tcp otherwise)."""

    def __init__(self) -> None:
        from ompi_tpu_torch.btl import COMPONENTS

        self.btls: List[Btl] = []
        for cls in selected(COMPONENTS):
            comp = cls()
            if comp.open():
                self.btls.append(comp)
                _out.verbose(5, "opened btl %s", comp.NAME)
        self.btls.sort(key=lambda b: -b.PRIORITY)
        self.endpoints: Dict[int, Btl] = {}
        for btl in self.btls:
            progress.register(btl.progress)

    def endpoint(self, peer: int) -> Btl:
        ep = self.endpoints.get(peer)
        if ep is None:
            ep = next((b for b in self.btls if b.reachable(peer)), None)
            if ep is None:
                raise RuntimeError(
                    f"rank {rte.rank}: no BTL reaches peer {peer} (btl "
                    f"{[b.NAME for b in self.btls]})")
            self.endpoints[peer] = ep
        return ep

    def send(self, peer: int, data: bytes) -> None:
        self.endpoint(peer).send(peer, data)

    def finalize(self) -> None:
        for btl in self.btls:
            progress.unregister(btl.progress)
            btl.finalize()
