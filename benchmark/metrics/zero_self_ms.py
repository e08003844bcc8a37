"""zero_self_ms: per step, the program's own ``step`` span in ``zero``
(``ZeroOptimizer.step``, fused or not) less the union of the port's
collective spans inside it (``Run.coll_spans``: coll/cuda's and
coll/device's ``launch`` spans and the MPI API's spans, nested ones
counted once), inside the driver's step span: the optimizer's own code
(the state's bookkeeping, the unfused update's launches), without the
driver's span or its trailing synchronise. Mean over the steps of a
traced run's last phase (the recorder alone, no profiler) and over
ranks. None where the program records no such span. Host time."""

from benchmark.lib import hostspans


def read(run):
    per_rank = []
    for rec in run.ranks:
        steps = run.step_spans(rec)
        zero = hostspans.Union(hostspans.named(rec, "step", "zero"))
        if not steps or not zero:
            return None
        inner = zero & hostspans.Union(run.coll_spans(rec))
        per_rank.append(sum(zero.within(a, b) - inner.within(a, b)
                            for a, b in steps) / len(steps))
    return sum(per_rank) / len(per_rank) / 1e6
