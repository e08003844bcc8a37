"""optimizer_self_ms: per step, the driver's span around
``ZeroOptimizer.step`` less the union of the port's collective spans
inside it (coll/cuda's and coll/device's ``launch`` spans and the MPI
API's entry-to-exit spans, nested ones counted once); mean over the
steps of a traced run's last phase (the recorder alone, no profiler)
and over ranks. Host time."""

from benchmark.lib import stats


def read(run):
    per_rank = []
    for rec in run.ranks:
        steps = run.step_spans(rec)
        coll = run.coll_spans(rec)
        if not steps:
            return None
        self_ns = [(b - a) - stats.covered(coll, a, b) for a, b in steps]
        per_rank.append(sum(self_ns) / len(self_ns))
    return sum(per_rank) / len(per_rank) / 1e6
