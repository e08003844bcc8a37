"""Cross-rank timeline merge.

Per-rank trace files (trace.export output) -> ONE Chrome trace with
one pid per rank. Ranks of a synced job already share rank 0's
timebase (recorder.sync_clock exchanged the wall-vs-monotonic
offsets through the store at init), so their events are directly
comparable; files exported against *different* bases (separate jobs,
no sync) are rebased here using the recorded ``clock_base_ns`` —
comparable to wall-clock quality, which is the best any post-hoc
merge can do.

pid collisions (two files claiming the same rank — e.g. re-runs of a
single-rank bench) are resolved by bumping to the next free pid so
the merged view always shows distinct timelines. The port's copy of
``ompi_tpu.trace.merge``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Union

from ompi_tpu_torch.telemetry import clock as _clock

Traceish = Union[str, Dict[str, Any]]


def _load(t: Traceish) -> Dict[str, Any]:
    if isinstance(t, dict):
        return t
    with open(t) as fh:
        return json.load(fh)


def merge(traces: Sequence[Traceish]) -> Dict[str, Any]:
    """Merge trace docs/paths into one timeline dict."""
    if not traces:
        raise ValueError("nothing to merge")
    docs = [_load(t) for t in traces]
    used_pids = set()
    base0 = None
    meta_rows: List[Dict[str, Any]] = []
    rows: List[Dict[str, Any]] = []
    ranks = []
    hist: Dict[str, int] = {}
    for i, doc in enumerate(docs):
        md = doc.get("metadata", {})
        base = md.get("clock_base_ns")
        if base0 is None:
            base0 = base
        # rebase onto the first doc's timebase (0 when either side
        # never synced — telemetry/clock semantics)
        shift_us = _clock.shift_ns(base, base0) / 1e3
        pid = int(md.get("rank", i))
        while pid in used_pids:
            pid += 1
        used_pids.add(pid)
        ranks.append(pid)
        for k, v in md.get("hist", {}).items():
            hist[k] = hist.get(k, 0) + v
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M":
                meta_rows.append(ev)
                continue
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            rows.append(ev)
    rows.sort(key=lambda e: (e.get("ts", 0.0), -e.get("dur", 0.0)))
    return {
        "traceEvents": meta_rows + rows,
        "displayTimeUnit": "ms",
        "metadata": {"ranks": ranks, "merged_from": len(docs),
                     "hist": hist},
    }


def merge_files(out_path: str, paths: Sequence[str]) -> Dict[str, Any]:
    doc = merge(paths)
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
    return doc
