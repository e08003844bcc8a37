"""elastic/inject — deterministic fault injection for recovery tests.

The port's copy of ``ompi_tpu.elastic.inject``. A real rank death is a
SIGKILL mid-step: no shutdown path runs, and the launcher's waitpid and
the store's staleness promotion are what notice. :func:`maybe_kill` does
exactly that at a configured (step, world rank), so the whole detect ->
revoke -> shrink -> re-shard -> resume chain runs in the tests and on the
card. :func:`maybe_delay` is its non-fatal sibling, a deterministic
straggler. :class:`ChaosClient` is a store client that adds latency
and drops its first N RPCs (the ``OSError`` a reset connection raises).
"""

from __future__ import annotations

import os
import signal
import time

from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.runtime import kvstore, rte

_kill_step_var = cvar.register(
    "elastic_inject_kill_step", -1, int,
    help="Training step at which the injected rank failure fires "
         "(-1 disables). Deterministic: the same run always dies at "
         "the same step.", level=9)
_kill_rank_var = cvar.register(
    "elastic_inject_rank", -1, int,
    help="World rank that SIGKILLs itself at "
         "elastic_inject_kill_step — no shutdown path runs, exactly "
         "like a real crash.", level=9)
_delay_rank_var = cvar.register(
    "elastic_inject_delay_rank", -1, int,
    help="World rank that sleeps elastic_inject_delay_s at the top "
         "of each step from elastic_inject_delay_step on (-1 "
         "disables) — a deterministic straggler for the skew plane's "
         "attribution tests.", level=9)
_delay_s_var = cvar.register(
    "elastic_inject_delay_s", 0.0, float,
    help="Injected per-step compute delay in seconds (see "
         "elastic_inject_delay_rank).", level=9)
_delay_step_var = cvar.register(
    "elastic_inject_delay_step", -1, int,
    help="First step at which the injected delay fires; every step "
         ">= this sleeps. -1 disables.", level=9)


def armed(step: int) -> bool:
    """True when the injection fires for this process at ``step`` (a
    world-rank match: the same decision on every run of a config)."""
    ks = _kill_step_var.get()
    return ks >= 0 and step == ks and rte.rank == _kill_rank_var.get()


def maybe_kill(step: int) -> None:
    """SIGKILL this process if the injection is armed for (step, rank).
    Called at the top of every elastic step, before its first collective,
    so the survivors see a peer that never entered."""
    if not armed(step):
        return
    pvar.record("elastic_injected_kills")
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_delay(step: int) -> None:
    """Sleep the configured delay if it is armed for (step, rank): a
    straggler that arrives late into every collective from
    ``elastic_inject_delay_step`` on."""
    ds = _delay_step_var.get()
    delay = _delay_s_var.get()
    if (ds < 0 or step < ds or delay <= 0
            or rte.rank != _delay_rank_var.get()):
        return
    pvar.record("elastic_injected_delays")
    time.sleep(delay)


class ChaosClient(kvstore.Client):
    """A store client with deterministic RPC chaos: latency per RPC and
    drop-the-first-N (an ``OSError``, what a reset TCP connection gives).
    Tests point a retry loop at it to prove resilience without real
    network faults."""

    def __init__(self, addr, latency_s: float = 0.0,
                 drop_first: int = 0) -> None:
        self.latency_s = float(latency_s)
        self.drops_left = int(drop_first)
        super().__init__(addr)

    def _rpc(self, *msg, timeout=None):
        if self.drops_left > 0:
            self.drops_left -= 1
            raise OSError("injected store-RPC drop (elastic chaos shim)")
        if self.latency_s:
            time.sleep(self.latency_s)
        return super()._rpc(*msg, timeout=timeout)
