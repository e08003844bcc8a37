"""BTL base interface and the BML endpoint multiplexer.

The port's copy of ``ompi_tpu.btl.base`` (reference: opal/mca/btl/btl.h,
the module interface, and ompi/mca/bml/r2, which picks one BTL per peer
by priority). The PML registers one receive callback
(mca_bml_base_register AM callbacks, pml_ob1.c:478-527).

Selection is the registry's (``core/registry.py``): the components
``self``, ``sm`` and ``tcp`` register with the ``btl`` framework, whose
cvar of the same name includes (``self,tcp``) or excludes (``^sm``) them
as in the reference; the Bml opens them highest priority first. Where it
differs: a btl whose ``open()`` raises fails the Bml with
``MPIError(ERR_INTERN)`` (the reference logs and skips it, while its
peers may already have mapped rings to it).

:meth:`Bml.send` is the pml's framed-message exit point, so with the
trace recorder up a ``send`` span in ``btl`` covers every wire handoff
(reference ``btl/base.py:91-102``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import cvar, output, progress, registry
from ompi_tpu_torch.runtime import rte
from ompi_tpu_torch.trace import recorder as _trace

_out = output.stream("btl")

framework = registry.framework("btl")

# the PML's AM callback: fn(data: bytes) — framing is PML-private
_recv_cb: Optional[Callable[[bytes], None]] = None


def set_recv_callback(cb: Optional[Callable[[bytes], None]]) -> None:
    global _recv_cb
    _recv_cb = cb


def deliver(data: bytes) -> None:
    if _recv_cb is not None:
        _recv_cb(data)


class Btl(registry.Component):
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


class Bml:
    """Endpoint table: the highest-priority reachable BTL per peer
    (btl/self for self, sm for same-host peers, tcp otherwise)."""

    def __init__(self) -> None:
        self.btls: List[Btl] = [c for c in framework.open_components()
                                if isinstance(c, Btl)]
        if framework.failures:
            # a transport its peers may already count on (sm maps its
            # rings across a fence): fail Init rather than skip it
            name, exc = next(iter(framework.failures.items()))
            framework.close_components()
            raise errors.MPIError(
                errors.ERR_INTERN,
                f"rank {rte.rank}: btl {name} failed to open "
                f"({type(exc).__name__}: {exc})") from exc
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
        ep = self.endpoint(peer)
        rec = _trace.RECORDER
        if rec is None:
            ep.send(peer, data)
            return
        t0 = _trace.now()
        ep.send(peer, data)
        rec.record("send", "btl", t0, _trace.now(),
                   {"peer": peer, "nbytes": len(data), "btl": ep.NAME})

    def finalize(self) -> None:
        for btl in self.btls:
            progress.unregister(btl.progress)
            btl.finalize()
        framework.close_components()
