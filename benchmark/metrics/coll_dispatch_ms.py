"""coll_dispatch_ms: per step, the union of the port's collective spans
(``Run.coll_spans``: the ``launch`` spans of coll/cuda and coll/device
and the MPI API's spans) less the part of it that the ``transport``
spans cover (coll/cuda's ``Arena``: ``sync``, the stream synchronise,
and ``wait``, the counter publish and the spin on the partners), inside
the driver's step span: the collective slots' own host code (the
launches, the schedules, the arena lookups, the checks, the split of
the gathered buckets). Mean over the steps of a traced run's last phase
(the recorder alone, no profiler) and over ranks. None where the
program records no transport span. Host time; with the transport spans
nested in the collective ones, ``coll_host_ms`` is this plus
``transport_sync_ms`` plus the union of the ``wait`` spans."""

from benchmark.lib import hostspans


def read(run):
    per_rank = []
    for rec in run.ranks:
        steps = run.step_spans(rec)
        coll = hostspans.Union(run.coll_spans(rec))
        transport = hostspans.Union(
            hostspans.named(rec, "sync", "transport")
            + hostspans.named(rec, "wait", "transport"))
        if not steps or not coll or not transport:
            return None
        inner = coll & transport
        per_rank.append(sum(coll.within(a, b) - inner.within(a, b)
                            for a, b in steps) / len(steps))
    return sum(per_rank) / len(per_rank) / 1e6
