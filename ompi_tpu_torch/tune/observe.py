"""In-band collective observation — the OBSERVER guard + aggregator.

The port's copy of ``ompi_tpu/tune/observe.py`` (the measurement half of
the coll/tuned story, reference ompi/mca/coll/tuned's measured
dynamic-rules files): every device collective dispatch funnel — coll/cuda's
``_launch`` (provider ``cuda``), coll/device's slots (provider ``device``)
and coll/hier's ``_launch`` (provider ``hier``) — wraps its zero-arg
launcher behind the process-wide :data:`OBSERVER` guard (the
``FLIGHT``/``TRAFFIC`` one-branch discipline,
``tests/test_torch_trace.py``'s guard scan) and, when the plane is up,
times the dispatch and folds the sample into an associative per-key
table. On the card a launch's kernels run asynchronously, so a sample is
the host's dispatch and schedule steps (the hop-counter waits included),
as the reference's is PJRT's dispatch.

Keys are exactly what every switchpoint table already selects on —
``(op, dtype, log2-size-bucket, mesh-shape, provider, algorithm)`` —
and the provider is the backend that ACTUALLY served the call after
staged fallthrough (only the serving backend's launch funnel fires),
so the table answers "which algorithm ran, on what, how fast" without
replaying traces. Per-key stats are count/sum/min/max plus a log2
latency histogram (the serve-plane ``lat_ns`` shape): every component
merges associatively, which is what lets :mod:`ompi_tpu.tune.perfdb`
accumulate across ranks and across runs.

Sampling cost when enabled: two ``perf_counter_ns`` reads + one dict
update under the lock + two pvar bumps. Disabled: one module-attribute
load and one ``is None`` branch per dispatch site — the level-0
contract ``bench.py --tune`` bounds against the 256 KiB payload floor.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ompi_tpu_torch.core import cvar, events, output, pvar

_out = output.stream("tune")

_max_keys_var = cvar.register(
    "tune_max_keys", 4096, int,
    help="Cap on distinct (op, dtype, log2-size, mesh, provider, "
         "algorithm) keys the observer aggregates; samples for new "
         "keys past the cap are counted in tune_dropped instead of "
         "growing the table without bound (shape-churn jobs).",
    level=7)

#: providers the observe hooks name (the reference's ``xla`` and
#: ``pallas`` are the port's ``device`` and ``cuda``) — the report and
#: the OpenMetrics ``tune_obs_<op>_<provider>`` decode both key off this
#: set
PROVIDERS = ("device", "cuda", "hier")

TUNE_TABLE_ERROR = events.register_type(
    "tune_table_error",
    "a switchpoint-table cvar points at a malformed/unreadable file",
    ("cvar", "path", "error"))

#: stats record layout: [count, sum_ns, min_ns, max_ns, {log2bin: n}]
Key = Tuple[str, str, int, Tuple[int, ...], str, str]


def log2_bucket(nbytes: int) -> int:
    """The monitoring.algo.log2_bucket size key (duplicated here so
    the hot sample path needs no cross-plane import)."""
    b = 0
    n = int(nbytes)
    while n > 1:
        n >>= 1
        b += 1
    return b


def _mesh_of(comm) -> Tuple[int, ...]:
    """The comm's flat device-mesh shape, ``(size,)`` — what the
    reference's coll/xla ctx mesh is (one device a rank); coll/hier
    passes its ``(n_dcn, n_ici)`` grid itself."""
    if comm is None:
        return ()
    return (int(getattr(comm, "size", 0)),)


class Observer:
    """Per-rank sample aggregator behind the OBSERVER guard."""

    def __init__(self, rank: int = 0) -> None:
        self.rank = rank
        self.lock = threading.Lock()
        self.stats: Dict[Key, list] = {}
        self.max_keys = int(_max_keys_var.get())

    # -- the dispatch-site hook -------------------------------------------
    def timed(self, provider: str, op: str, algorithm: str, comm,
              nbytes: int, dtype: str, launcher,
              mesh: Optional[Tuple[int, ...]] = None):
        """Wrap a zero-arg launcher: time the dispatch, fold the
        sample. Mesh resolves ONCE here (wrap time), not per call."""
        mesh = _mesh_of(comm) if mesh is None else tuple(
            int(d) for d in mesh)
        lg = log2_bucket(nbytes)

        def run():
            t0 = time.perf_counter_ns()
            out = launcher()
            self.sample(op, dtype, lg, mesh, provider, algorithm,
                        time.perf_counter_ns() - t0)
            return out

        return run

    def sample(self, op: str, dtype: str, lg: int,
               mesh: Tuple[int, ...], provider: str, algorithm: str,
               dur_ns: int) -> None:
        key = (op, dtype, lg, mesh, provider, algorithm)
        dur_ns = int(dur_ns)
        with self.lock:
            rec = self.stats.get(key)
            if rec is None:
                if len(self.stats) >= self.max_keys:
                    pvar.record("tune_dropped")
                    return
                rec = self.stats[key] = [0, 0, dur_ns, dur_ns, {}]
            rec[0] += 1
            rec[1] += dur_ns
            if dur_ns < rec[2]:
                rec[2] = dur_ns
            if dur_ns > rec[3]:
                rec[3] = dur_ns
            b = dur_ns.bit_length()
            rec[4][b] = rec[4].get(b, 0) + 1
        pvar.record("tune_samples")
        # per-(op, provider) counter family for OpenMetrics
        # (dynamically named, decoded by telemetry.openmetrics)
        pvar.record("tune_obs_%s_%s" % (op, provider))

    def snapshot(self) -> Dict[Key, list]:
        """Copy of the stats table (histograms copied too)."""
        with self.lock:
            return {k: [v[0], v[1], v[2], v[3], dict(v[4])]
                    for k, v in self.stats.items()}


#: process-wide guard — None = off, every hook pays ONE branch
OBSERVER: Optional[Observer] = None


def enable(rank: int = 0) -> Observer:
    global OBSERVER
    if OBSERVER is None:
        OBSERVER = Observer(rank=rank)
    return OBSERVER


def disable() -> Optional[Observer]:
    """Drop the guard; returns the observer so Finalize can persist
    its samples after the hooks went quiet."""
    global OBSERVER
    obs, OBSERVER = OBSERVER, None
    return obs


# -- switchpoint-table error surfacing ------------------------------------
# (a fat-fingered coll_*_switchpoints path would otherwise be one
# verbose(1) line and a silent revert to the defaults)

_warned_tables: set = set()


def table_error(var_name: str, path: str, exc: BaseException) -> None:
    """A switchpoint-table file failed to load: count it
    (``tune_table_errors``), warn once per path at verbose 0, and
    emit the ``tune_table_error`` MPI_T event for listening tools."""
    pvar.record("tune_table_errors")
    if path not in _warned_tables:
        _warned_tables.add(path)
        _out.verbose(0, "WARNING: %s %s unreadable (%s) — falling "
                        "back to built-in thresholds; fix the path "
                        "or the JSON (tune_table_errors counts every "
                        "load attempt)", var_name, path, exc)
    if events.active("tune_table_error"):
        events.emit("tune_table_error", cvar=var_name, path=path,
                    error=repr(exc))
