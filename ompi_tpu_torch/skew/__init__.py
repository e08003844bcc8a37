"""skew/ — cross-rank straggler attribution + critical-path plane.

The port's copy of ``ompi_tpu/skew``.

Every other observability plane answers "how long did MY rank
spend"; this one answers the distributed-training question — **which
rank made everyone else wait, and in which collective**. It rides
the flight recorder's entry instrumentation (coll/device, coll/cuda,
partitioned, hier, and API-level blocking collectives all register
``(seq, op, cid, nbytes, t_enter)``) and adds the exit side:
completed collectives land in a bounded per-rank ring
(:mod:`record`), rings merge through the kvstore at Finalize
(:mod:`merge`, the ``monitoring/merge`` shape), and the
decomposition engine (:mod:`decompose`) splits each rank's wall time
into ``arrival_skew`` (waiting for stragglers) vs ``transfer``
(actually moving data), walks the per-step critical path, and names
persistent stragglers — rendered by :mod:`report` and
``python -m ompi_tpu_torch.skew report``.

Level semantics: 0 = off (the flight exit path pays one attribute
load + one branch — the ``SKEW is None`` guard, same discipline as
``FLIGHT``/``RECORDER``/``TRAFFIC``/``OBSERVER``); 1 = post-hoc
(ring + Finalize merge + verdicts); 2 = + live sampling through the
heartbeat payload's last-arrival stamp, so the watchdog can name a
*slow* rank before it becomes a *hung* rank
(``skew_live_lag_ns``, hang-dump ``skew`` context).

Clocks: arrival comparisons ride ``telemetry/clock.py`` — each rank
samples a bracketed wall-vs-monotonic offset at start and syncs rank
0's base through the store, and every report states the resulting
timestamp error bar.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ompi_tpu_torch.core import cvar, output

_out = output.stream("skew")

_level_var = cvar.register(
    "skew_level", 0, int,
    help="Cross-rank skew attribution plane: 0 off (the flight exit "
         "path pays one attribute load + one branch — the SKEW "
         "guard), 1 completed-collective ring + Finalize kvstore "
         "merge + arrival-skew/transfer decomposition + persistent-"
         "straggler verdicts, 2 adds live lag sampling through the "
         "heartbeat payload (watchdog names slow ranks before they "
         "hang). Equivalently: OMPI_TPU_SKEW=<level>.", level=5)

_dump_var = cvar.register(
    "skew_dump", "", str,
    help="Finalize-time per-rank skew-ring dump path; '{rank}' "
         "expands to the world rank (e.g. /tmp/skew_r{rank}.json). "
         "Feed the files to `python -m ompi_tpu_torch.skew report`.",
    level=6)


def level() -> int:
    """Requested plane level: max of the cvar and the short
    OMPI_TPU_SKEW env knob (monitoring-style truthy parse)."""
    lvl = int(_level_var.get())
    raw = os.environ.get("OMPI_TPU_SKEW", "").strip().lower()
    if raw and raw not in ("0", "false", "no", "off"):
        try:
            lvl = max(lvl, int(raw))
        except ValueError:
            lvl = max(lvl, 1)  # any other truthy value: level 1
    return lvl


def requested() -> bool:
    return level() > 0


def start(rank: int = 0, nranks: int = 0) -> None:
    """Bring the plane up (idempotent): enable the flight recorder
    (the entry/exit instrumentation the ring rides), sync the clock
    bracket through the store, raise the SKEW guard."""
    from ompi_tpu_torch.runtime import rte
    from ompi_tpu_torch.skew import record as _record
    from ompi_tpu_torch.telemetry import clock as _clock
    from ompi_tpu_torch.telemetry import flight as _flight

    lvl = level()
    if lvl <= 0:
        return
    if nranks <= 0:
        nranks = rte.size
    fl = _flight.enable(rank=rank)
    sk = _record.enable(rank=rank, nranks=nranks, level=lvl)
    sk.clock_offset_ns = fl.clock_offset_ns
    sk.clock_err_ns = fl.clock_err_ns
    if nranks > 1:
        sk.clock_base_ns, sk.clock_base_err_ns = \
            _clock.sync_via_store("skew_clock", sk.clock_offset_ns,
                                  sk.clock_err_ns)
    else:
        sk.clock_base_ns = sk.clock_offset_ns
        sk.clock_base_err_ns = sk.clock_err_ns


def stop() -> None:
    """Tear the plane down: per-rank ring dump, kvstore merge, rank-0
    decomposition + named verdicts, pvar fold-in on every rank. Every
    step is failure-proof — teardown must not sink Finalize."""
    import json

    from ompi_tpu_torch.skew import record as _record

    sk = _record.SKEW
    if sk is None:
        return
    from ompi_tpu_torch.runtime import rte
    from ompi_tpu_torch.skew import decompose as _decompose
    from ompi_tpu_torch.skew import merge as _merge
    from ompi_tpu_torch.skew import report as _report

    # 1. per-rank artifact dump ({rank} expansion, atomic write) —
    # lands even if the merge below fails
    path = _dump_var.get()
    if path:
        try:
            path = path.replace("{rank}", str(sk.rank))
            tmp = "%s.tmp.%d" % (path, os.getpid())
            with open(tmp, "w") as fh:
                json.dump(_merge.snapshot_doc(sk), fh, indent=1)
            os.replace(tmp, path)
            _out.verbose(1, "skew ring dump written: %s", path)
        except Exception as exc:  # noqa: BLE001 — dumps must not sink
            _out.verbose(0, "skew dump failed: %r", exc)

    # 2. cross-rank merge; rank 0 decomposes and publishes the
    # analysis back so every rank folds its own exposed-wait figures
    # into the pvar plane
    analysis: Optional[Dict[str, Any]] = None
    ana_key = "skew:ana:%s" % rte.jobid
    try:
        if rte.size > 1:
            merged = _merge.exchange(sk, rte.client(), rte.jobid,
                                     rte.size)
            if merged is not None:  # rank 0
                analysis = _decompose.analyze(
                    merged["records"],
                    clock_err_ns=merged["clock_err_ns"])
                rte.client().put(ana_key, json.dumps(analysis))
            else:
                raw = rte.client().get_within(ana_key, 15.0)
                analysis = json.loads(raw)
        else:
            merged = _merge.merge([_merge.snapshot_doc(sk)])
            analysis = _decompose.analyze(
                merged["records"],
                clock_err_ns=merged["clock_err_ns"])
    except Exception as exc:  # noqa: BLE001 — teardown must not sink
        _out.verbose(0, "skew merge failed: %r", exc)

    if analysis is not None:
        try:
            sk.set_arrivals({(g["cid"], g["seq"]): g["last_arrival_ns"]
                             for g in analysis["groups"]})
            _decompose.record_pvars(analysis, sk.rank)
            if sk.rank == 0:
                for v in analysis["stragglers"]:
                    _out.verbose(0, "%s", _report.verdict_line(v))
                _out.verbose(1, "skew: %d collectives decomposed, "
                             "error bar ±%.1f us",
                             analysis["collectives"],
                             analysis["clock_err_ns"] / 1e3)
        except Exception as exc:  # noqa: BLE001
            _out.verbose(0, "skew verdict failed: %r", exc)
    _record.disable()


def skew_info() -> Optional[Dict[str, Any]]:
    """Current worst-skew context for the watchdog hang dump (None
    while the plane is off) — a hang on a rank the live view already
    saw falling behind should say so next to the verdict."""
    from ompi_tpu_torch.core import pvar
    from ompi_tpu_torch.skew import record as _record

    sk = _record.SKEW
    if sk is None:
        return None
    info: Dict[str, Any] = {
        "level": sk.level,
        "records": pvar.read("skew_records"),
        "dropped": pvar.read("skew_dropped"),
    }
    if sk.live_worst is not None:
        info["live_worst"] = dict(sk.live_worst)
    return info
