"""Monitoring plane — traffic matrices and link loads, the port of
:mod:`ompi_tpu.monitoring`.

Reference: ompi/mca/common/monitoring (the MPI_T traffic-matrix plane the
pml / osc / coll monitoring components feed). Opt-in through
``monitoring_level`` (or the short ``OMPI_TPU_MONITORING`` env knob, the
reference's name, as the port keeps its other cvar and env names):

- :mod:`.matrix` — per-(dst, ctx) send-side message / byte cells (ctx
  ``p2p``, ``coll``, ``osc``, ``part``), fed by the pml interposition
  (:mod:`ompi_tpu_torch.pml.monitoring`), the host window's service-send
  funnel and the device windows' fence flush, and the algorithmic byte
  accounting of coll/device's, coll/cuda's and coll/hier's launches
  (:mod:`.algo`), plus the per-level, serve and expert-load tables;
- :mod:`.links` — level 2: cells walked along ``topo.CartTopo`` routes
  onto the links of the job's mesh (per-link loads, the imbalance gauge,
  the hottest link);
- :mod:`.merge` and :mod:`.report` (``python -m ompi_tpu_torch.monitoring
  report``) — the cross-rank merge (kvstore or dumped JSON, transpose
  check) and the heatmap / link / hotspot / ``[serve]`` report.

Levels: 0 off (every instrumented site pays one attribute load and one
branch: the ``TRAFFIC is None`` guard); 1 matrices and per-cell pvars; 2
adds per-link attribution. The deprecated ``pml_monitoring`` cvar maps to
level 1. ``runtime/state`` starts the plane after the pml is selected,
before any traffic flows, and stops it (the Finalize-time dump) before
the pml is torn down.
"""

from __future__ import annotations

import os

from ompi_tpu_torch.core import cvar, output

_out = output.stream("monitoring")

_level_var = cvar.register(
    "monitoring_level", 0, int,
    help="Traffic-monitoring plane level: 0 off (one branch per "
         "instrumented site), 1 per-(src,dst,ctx) traffic matrices + "
         "pvars, 2 adds per-link attribution (CartTopo minimal-hop "
         "routing). Equivalently: OMPI_TPU_MONITORING=<level>. "
         "Supersedes the deprecated pml_monitoring cvar (compat: level "
         "1).", level=5)

_dump_var = cvar.register(
    "monitoring_dump", "", str,
    help="Finalize-time per-rank matrix dump path; '{rank}' expands "
         "to the world rank (e.g. /tmp/mon_r{rank}.json). Feed the "
         "files to `python -m ompi_tpu_torch.monitoring report`. Empty "
         "with pml_monitoring/monitoring_level set still logs the "
         "matrix through the output stream.", level=6)


def level() -> int:
    """The requested level: the max of the cvar, the
    ``OMPI_TPU_MONITORING`` env knob and the deprecated
    ``pml_monitoring`` mapping (truthy -> 1)."""
    lvl = int(_level_var.get())
    raw = os.environ.get("OMPI_TPU_MONITORING", "").strip().lower()
    if raw and raw not in ("0", "false", "no", "off"):
        try:
            lvl = max(lvl, int(raw))
        except ValueError:
            lvl = max(lvl, 1)  # any other truthy value: level 1
    from ompi_tpu_torch.pml import monitoring as _pml_mon

    if _pml_mon._enable_var.get():
        lvl = max(lvl, 1)
    return lvl


def requested() -> bool:
    return level() > 0


def start(rank: int = 0, nranks: int = 0) -> None:
    """Bring the plane up (idempotent): the TRAFFIC matrix at the
    requested level, and the pml interposition so host sends count."""
    from ompi_tpu_torch.monitoring import matrix as _matrix
    from ompi_tpu_torch.pml import monitoring as _pml_mon

    lvl = level()
    if lvl <= 0:
        return
    if _pml_mon._enable_var.get() and not int(_level_var.get()):
        _out.verbose(1, "pml_monitoring is deprecated; it now maps "
                        "to monitoring_level 1 (use --mca "
                        "monitoring_level N)")
    if nranks <= 0:
        from ompi_tpu_torch.runtime import rte

        nranks = rte.size
    _matrix.enable(rank=rank, level=lvl, nranks=nranks)
    _pml_mon.install()


def stop() -> None:
    """Tear the plane down: the Finalize-time dump, then the guard."""
    from ompi_tpu_torch.monitoring import matrix as _matrix

    if _matrix.TRAFFIC is None:
        return
    try:
        finalize_dump()
    finally:
        _matrix.disable()


def finalize_dump() -> str:
    """Write this rank's snapshot: the per-peer lines through the output
    stream, and the JSON dump when ``monitoring_dump`` names a path
    (returned)."""
    import json

    from ompi_tpu_torch.monitoring import matrix as _matrix
    from ompi_tpu_torch.monitoring import merge as _merge

    tm = _matrix.TRAFFIC
    if tm is None:
        return ""
    doc = _merge.snapshot_doc(tm)
    for ctx, table in sorted(doc["tables"].items()):
        for dst, (msgs, nbytes, _ns) in sorted(table.items(),
                                               key=lambda kv: int(kv[0])):
            _out.verbose(1, "rank %d -> %s [%s]: %d msgs, %d bytes",
                         tm.rank, dst, ctx, msgs, nbytes)
    path = _dump_var.get()
    if not path:
        return ""
    path = path.replace("{rank}", str(tm.rank))
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)
    _out.verbose(1, "matrix dump written: %s", path)
    return path


def expert_load(counts) -> None:
    """Record per-expert token counts on the plane
    (``monitoring_expert_tokens``); one branch when off."""
    from ompi_tpu_torch.monitoring import matrix as _matrix

    tm = _matrix.TRAFFIC
    if tm is not None:
        tm.expert_tokens(counts)
