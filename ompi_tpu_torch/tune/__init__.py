"""tune/ — the in-band collective performance observatory.

The port's copy of ``ompi_tpu/tune`` (the coll/tuned measured
dynamic-rules story): the decision tables (``coll_cuda_switchpoints``,
``coll_hier_switchpoints``, ``coll_device_bucket_bytes``) carry
thresholds taken on a TPU; this plane measures real collectives
**in-band** on the card instead, and writes candidate tables for them.

Four cooperating pieces, all opt-in via ``tune_observe`` (or the
short ``OMPI_TPU_TUNE`` env knob):

- :mod:`observe` — the ``OBSERVER`` guard (one attribute load + one
  ``is None`` branch per dispatch site when off — the ``FLIGHT``/
  ``TRAFFIC`` discipline) timing every served device-collective
  launch in coll/device, coll/cuda and coll/hier, keyed ``(op,
  dtype, log2-size, mesh-shape, provider, algorithm)`` — the
  provider being whichever backend actually served after
  fallthrough (``device``, ``cuda`` or ``hier``).
- :mod:`perfdb` — the persistent PerfDB: associative per-key
  count/sum/min/max + log2 latency histograms, merged across ranks
  through the kvstore (the ``monitoring/merge`` publish/collect
  shape) and folded across **runs** into a per-``(device_kind,
  world size)`` JSON alongside the compile cache
  (``tune_db_dir``, default ``compile_cache_dir``).
- :mod:`report` + ``python -m ompi_tpu_torch.tune report`` — measured
  cuda-vs-device and hier-vs-flat crossovers, candidate switchpoint
  tables in the exact reader JSON shapes (suggestions only — the
  observatory never self-applies), and run-over-run regression
  verdicts against the stored baseline, folded into the watchdog
  hang-dump context and the OpenMetrics ``tune_*`` family.
- :func:`observe.table_error`: malformed switchpoint-table files
  surface as a once-per-path warning + ``tune_table_errors`` pvar +
  ``tune_table_error`` event instead of a verbose(1) whisper.

Lifecycle: ``start(rank)`` at init loads the baseline DB and raises
the guard; ``stop()`` at Finalize computes regression verdicts,
dumps the per-rank doc (``tune_dump``), exchanges through the
kvstore, and rank 0 folds the merged run into the on-disk DB.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ompi_tpu_torch.core import cvar, output, pvar

_out = output.stream("tune")

_observe_var = cvar.register(
    "tune_observe", 0, int,
    help="Collective performance observatory: 0 off (every dispatch "
         "site pays one attribute load + one branch — the OBSERVER "
         "guard), 1 records per-launch samples keyed (op, dtype, "
         "log2-size, mesh, provider, algorithm) into the persistent "
         "PerfDB. Equivalently: OMPI_TPU_TUNE=1.", level=5)

_db_dir_var = cvar.register(
    "tune_db_dir", "", str,
    help="Directory holding the persistent PerfDB "
         "(tune_perfdb_<device_kind>_n<nranks>.json, device_kind the "
         "card's name, sanitised, or cpu). Empty: compile_cache_dir "
         "when set, else no cross-run persistence (in-run merge + dump "
         "still work).", level=6)

_dump_var = cvar.register(
    "tune_dump", "", str,
    help="Finalize-time per-rank PerfDB doc dump path; '{rank}' "
         "expands to the world rank (e.g. /tmp/tune_r{rank}.json). "
         "Feed the files to `python -m ompi_tpu_torch.tune report`.",
    level=6)

_regress_var = cvar.register(
    "tune_regress_threshold", 1.5, float,
    help="Run-over-run regression bar: a key whose p50 is this many "
         "times slower than the PerfDB baseline gets a named "
         "regression verdict (report, watchdog hang-dump context, "
         "tune_regressions pvar).", level=7)

#: baseline stats loaded at start() — what regressions compare against
_BASELINE: Optional[Dict] = None
_baseline_runs = 0


def requested() -> bool:
    """Cvar or the short OMPI_TPU_TUNE env knob (monitoring-style
    truthy parse)."""
    if int(_observe_var.get()) > 0:
        return True
    raw = os.environ.get("OMPI_TPU_TUNE", "").strip().lower()
    return bool(raw and raw not in ("0", "false", "no", "off"))


def device_kind() -> str:
    """The accelerator kind the DB is keyed by: the card's name
    (``torch.cuda.get_device_name``) where the device plane bound a card,
    else ``cpu`` (the host ranks', as the reference's CPU ranks name
    theirs); :func:`perfdb.db_path` sanitises it for the file name."""
    try:
        from ompi_tpu_torch.runtime import device_plane

        if device_plane.active() and device_plane.device().type == "cuda":
            import torch

            return str(torch.cuda.get_device_name(device_plane.device()))
        return "cpu"
    except Exception:  # noqa: BLE001 — naming must not sink init
        return "unknown"


def db_dir() -> str:
    d = _db_dir_var.get().strip()
    if d:
        return d
    from ompi_tpu_torch import prof as _prof

    return _prof._cache_dir_var.get().strip()


def _db_path(nranks: int) -> str:
    from ompi_tpu_torch.tune import perfdb as _perfdb

    d = db_dir()
    if not d:
        return ""
    return _perfdb.db_path(d, device_kind(), nranks)


def start(rank: int = 0, nranks: int = 0) -> None:
    """Bring the observatory up (idempotent): load the baseline DB
    for this (device_kind, world size) and raise the OBSERVER guard
    before any traffic flows."""
    global _BASELINE, _baseline_runs
    if not requested():
        return
    from ompi_tpu_torch.tune import observe as _observe
    from ompi_tpu_torch.tune import perfdb as _perfdb

    if nranks <= 0:
        from ompi_tpu_torch.runtime import rte

        nranks = rte.size
    path = _db_path(nranks)
    if path:
        doc = _perfdb.load(path)
        _BASELINE = _perfdb.stats_of(doc.get("entries", []))
        _baseline_runs = int(doc.get("runs", 0))
        if _BASELINE:
            _out.verbose(1, "perfdb baseline: %d keys over %d runs "
                            "(%s)", len(_BASELINE), _baseline_runs,
                         path)
    else:
        _BASELINE = None
        _baseline_runs = 0
    _observe.enable(rank=rank)


def stop() -> None:
    """Finalize: regression verdicts vs the baseline, per-rank doc
    dump, cross-rank kvstore merge, and (rank 0) fold the run into
    the on-disk DB. Every step is failure-proof — teardown must not
    sink Finalize."""
    global _BASELINE
    from ompi_tpu_torch.tune import observe as _observe

    obs = _observe.disable()
    if obs is None:
        return
    from ompi_tpu_torch.tune import perfdb as _perfdb
    from ompi_tpu_torch.tune import report as _report

    stats = obs.snapshot()

    # 1. run-over-run regression verdicts (pvar + named lines)
    if _BASELINE:
        try:
            regs = _report.regressions(stats, _BASELINE,
                                       float(_regress_var.get()))
            for r in regs:
                pvar.record("tune_regressions")
                _out.verbose(0, "REGRESSION: %s", r["verdict"])
        except Exception as exc:  # noqa: BLE001
            _out.verbose(0, "tune regression check failed: %r", exc)

    from ompi_tpu_torch.runtime import rte

    doc = _perfdb.doc_of(stats, device_kind=device_kind(),
                         nranks=rte.size)

    # 2. per-rank artifact dump ({rank} expansion, atomic write)
    path = _dump_var.get()
    if path:
        try:
            _perfdb.save(path.replace("{rank}", str(obs.rank)), doc)
        except Exception as exc:  # noqa: BLE001
            _out.verbose(0, "tune dump failed: %r", exc)

    # 3. cross-rank merge + cross-run fold into the on-disk DB
    merged = doc
    if rte.size > 1:
        try:
            got = _perfdb.exchange(doc, rte.client(), rte.jobid,
                                   obs.rank, rte.size)
            if got is not None:
                merged = got
            elif obs.rank != 0:
                merged = None  # non-zero ranks don't write the DB
        except Exception as exc:  # noqa: BLE001
            _out.verbose(0, "tune kvstore exchange failed "
                            "(keeping local doc): %r", exc)
    if merged is not None and obs.rank == 0:
        dbp = _db_path(rte.size)
        if dbp:
            try:
                prior = _perfdb.load(dbp)
                _perfdb.save(dbp, _perfdb.merge([prior, merged]))
            except Exception as exc:  # noqa: BLE001
                _out.verbose(0, "perfdb update failed: %r", exc)
    _BASELINE = None


def regression_info() -> Optional[List[str]]:
    """Live regression verdicts for the watchdog hang-dump context
    (None when the plane is off or nothing regressed) — a hang that
    follows a 10x collective slowdown should say so in the dump."""
    from ompi_tpu_torch.tune import observe as _observe

    obs = _observe.OBSERVER
    if obs is None or not _BASELINE:
        return None
    try:
        from ompi_tpu_torch.tune import report as _report

        regs = _report.regressions(obs.snapshot(), _BASELINE,
                                   float(_regress_var.get()))
    except Exception:  # noqa: BLE001 — dump context must not sink
        return None
    return [r["verdict"] for r in regs[:8]] or None
