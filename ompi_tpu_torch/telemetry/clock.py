"""Store-synced clock-offset estimation — the ONE timebase helper.

The port's copy of ``ompi_tpu.telemetry.clock``.

Every cross-rank timeline in the framework (trace merge, skew
decomposition, monitoring series alignment) needs the same two
numbers per rank: the wall-vs-monotonic offset, and how wrong it can
be. Before this module, ``trace.recorder`` sampled the offset with a
single unpaired read and ``trace/merge.py`` carried its own rebase
arithmetic; skew decomposition needs an *error bar* on top (a wait
smaller than the clock error is noise, not a straggler), so the
logic lives here once and trace/, skew/, and monitoring/ import it.

Offset estimation (:func:`sample_offset`): the monotonic read is
bracketed by two wall reads, so the true offset at that instant lies
within the bracket — the tightest bracket over a few tries gives
both the offset (bracket midpoint) and a bound on its error (the
bracket width). Cross-rank sync (:func:`sync_via_store`) exchanges
``(offset, err)`` through the runtime store so every rank can rebase
into rank 0's timebase; the pairwise comparison error is the sum of
both ranks' brackets plus whatever the hosts' wall clocks disagree
by (NTP-quality on multi-host jobs — the best any post-hoc merge can
do, same caveat ``trace/merge.py`` documents).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple


def sample_offset(samples: int = 7) -> Tuple[int, int]:
    """Estimate ``wall - monotonic`` in ns with a bounded error.

    Each try reads ``time_ns / monotonic_ns / time_ns``; the true
    offset lies in ``[w0 - m, w1 - m]``. Returns the midpoint of the
    tightest bracket seen and its half-width-rounded-up error bound
    ``(offset_ns, err_ns)``.
    """
    best_off = time.time_ns() - time.monotonic_ns()
    best_err: Optional[int] = None
    for _ in range(max(1, int(samples))):
        w0 = time.time_ns()
        m = time.monotonic_ns()
        w1 = time.time_ns()
        err = max(0, w1 - w0)
        if best_err is None or err < best_err:
            best_err = err
            best_off = (w0 + w1) // 2 - m
    return best_off, int(best_err or 0)


def sync_via_store(component: str, offset_ns: int,
                   err_ns: int = 0) -> Tuple[int, int]:
    """Exchange this rank's ``(offset, err)`` through the store and
    return rank 0's ``(base_offset_ns, base_err_ns)``.

    Collective over the world (every rank publishes under its own
    modex key; non-base ranks block until the base rank's lands) —
    callers gate on job-uniform knobs, the same contract
    ``trace.recorder.sync_clock`` always had. Rebasing a local
    monotonic timestamp ``t`` into the shared (rank 0 monotonic)
    timebase is then ``t + shift_ns(offset_ns, base_ns)``.
    """
    from ompi_tpu_torch.runtime import rte

    rte.modex_send(component, [int(offset_ns), int(err_ns)])
    base_rank = rte.world_ranks()[0]
    if rte.rank == base_rank:
        return int(offset_ns), int(err_ns)
    got = rte.modex_recv(component, base_rank)
    if isinstance(got, (list, tuple)) and len(got) >= 2:
        return int(got[0]), int(got[1])
    return int(got), 0  # pre-clock.py peers published a bare offset


def shift_ns(offset_ns: Optional[int],
             base_ns: Optional[int]) -> int:
    """The additive rebase from a rank's local monotonic clock into
    the shared timebase: ``local + shift = wall - base = rank-0
    monotonic equivalent``. 0 when either side is unknown (unsynced
    single-rank exports stay in their own timebase)."""
    if offset_ns is None or base_ns is None:
        return 0
    return int(offset_ns) - int(base_ns)


def pair_err_ns(err_a_ns: int, err_b_ns: int) -> int:
    """Worst-case error comparing two ranks' rebased timestamps:
    both brackets stack (wall-clock disagreement across hosts comes
    on top and is not observable from inside the job)."""
    return max(0, int(err_a_ns)) + max(0, int(err_b_ns))
