"""transport_wait_ms: the growth of the port's counter
``device_plane_wait_ns`` (the time coll/cuda's hop protocol spins for a
peer's counter) per step, mean over ranks; over a traced run's last
phase, which runs without the profiler (``Run.counted``)."""


def read(run):
    vals = [c["wait_ns"] / c["steps"] for c in map(run.counted, run.ranks)
            if c["steps"]]
    return sum(vals) / len(vals) / 1e6 if vals else None
