"""transport_sync_ms: per step, the union of the port's ``sync`` spans
in ``transport`` (coll/cuda's ``Arena``: each host step's stream
synchronise, the host blocked until this rank's own launches are done)
inside the driver's step span; mean over the steps of a traced run's
last phase (the recorder alone, no profiler) and over ranks. None where
the program records no such span. Host time."""

from benchmark.lib import hostspans


def read(run):
    per_rank = []
    for rec in run.ranks:
        steps = run.step_spans(rec)
        sync = hostspans.Union(hostspans.named(rec, "sync", "transport"))
        if not steps or not sync:
            return None
        per_rank.append(sum(sync.within(a, b) for a, b in steps)
                        / len(steps))
    return sum(per_rank) / len(per_rank) / 1e6
