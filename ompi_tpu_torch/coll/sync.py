"""coll/sync — the barrier-injection debug component.

The port's copy of ``ompi_tpu.coll.sync`` (reference: ompi/mca/coll/sync):
with ``coll_sync_barrier_before N`` (0, the default, is off) it wraps the
host collective slots of every communicator and runs the comm's barrier
before every Nth collective, to flush out programs that rely on the
timing of unsynchronised collectives (a bcast racing a later p2p). Its
priority (90) puts it above every real component, and it installs no
slot of its own: :meth:`CollSync.post_stack` wraps the table once every
component has stacked. Device slots (``*_dev``) are not wrapped.
"""

from __future__ import annotations

from ompi_tpu_torch.core import cvar, pvar, registry

_before_var = cvar.register(
    "coll_sync_barrier_before", 0, int,
    help="Inject a barrier before every Nth collective (0=off). "
         "Debug aid for flushing collective/p2p races "
         "(reference: coll/sync).", level=7)

#: slots never wrapped: wrapping barrier with barrier is recursion
_SKIP = {"barrier", "ibarrier"}


class _Wrapped:
    """One wrapped slot; counts calls per comm, barriers every Nth."""

    def __init__(self, inner, table) -> None:
        self._inner = inner
        self._table = table  # the table's real barrier (post-stack)

    def __call__(self, comm, *args, **kwargs):
        n = _before_var.get()
        if n > 0:
            self._table.calls += 1
            if self._table.calls % n == 0:
                pvar.record("sync_injected_barriers")
                self._table.fns["barrier"](comm)
        return self._inner(comm, *args, **kwargs)


class CollSync(registry.Component):
    """The component comm_select ranks."""

    NAME = "sync"
    PRIORITY = 90  # above everything: it wraps what is stacked below

    def query(self, comm) -> int:
        return self.PRIORITY if _before_var.get() > 0 else -1

    def slots(self, comm):
        return {}  # interposition happens in post_stack, which sees
        # the fully stacked table (slots() would see a partial one)

    def post_stack(self, comm, table) -> None:
        """Wrap every host collective slot already stacked."""
        from ompi_tpu_torch.coll import SLOTS

        table.calls = 0
        for name in list(table.fns):
            if name in _SKIP or name.endswith("_dev"):
                continue
            if name in SLOTS or name.startswith("i"):
                table.fns[name] = _Wrapped(table.fns[name], table)
                table.providers[name] = f"sync({table.providers[name]})"
