"""coll_host_ms: per step, the union of the port's collective spans
inside the driver's step span (``launch`` spans of coll/cuda and
coll/device, the MPI API's spans; nested ones counted once); mean over
the steps of a traced run's last phase (the recorder alone, no
profiler) and over ranks. Host time, dispatch and host steps: never
device time."""

from benchmark.lib import stats


def read(run):
    per_rank = []
    for rec in run.ranks:
        steps = run.step_spans(rec)
        coll = run.coll_spans(rec)
        if not steps or not coll:
            return None
        per_rank.append(sum(stats.covered(coll, a, b) for a, b in steps)
                        / len(steps))
    return sum(per_rank) / len(per_rank) / 1e6
