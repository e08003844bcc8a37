"""Chrome trace-event JSON export + histogram decoding.

Output is the JSON Object Format the Chrome/Perfetto tradition
defines: a ``traceEvents`` list of ``ph: "X"`` complete events
(ts/dur in microseconds) plus ``ph: "M"`` metadata naming processes
and threads. pid = MPI rank, tid = subsystem (api, coll_device,
coll_cuda, part, pml, btl, ...), so a merged multi-rank file renders one
track group per rank with one lane per layer. ``ui.perfetto.dev`` opens
the file directly. The port's copy of ``ompi_tpu.trace.export``; its
lanes are the reference's, coll/device's in coll/xla's place.

Timestamps: span clocks are per-process monotonic; export shifts by
``clock_offset_ns - clock_base_ns`` (see recorder.sync_clock) so all
ranks of a synced job share rank 0's timebase. Events are sorted by
(ts, -dur) — per-tid timestamps come out monotone and nested spans
stack correctly.

The export also embeds the pvar-plane log2 latency histograms
(``metadata.hist``) so a trace file is self-contained for
``python -m ompi_tpu_torch.trace report``. The skew lane reads the
skew plane's ring (``skew/record.py``): one span per completed
collective, split into wait and transfer once the Finalize merge has
resolved the group's last arrival; it is empty while the plane is off.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.trace import recorder as _rec

#: stable tids for the layers the tentpole instruments; anything else
#: gets the next free id at export time. "prof" (phase ledger) and
#: "xfer" (host<->device copies) are the attribution-profiler tracks.
_TIDS = {"api": 1, "coll_device": 2, "part": 3, "pml": 4, "btl": 5,
         "prof": 6, "xfer": 7, "skew": 8}


def _xfer_counters(spans: Sequence, rank: int,
                   shift_ns: int) -> List[Dict[str, Any]]:
    """Perfetto counter tracks from the xfer spans: per-direction
    achieved GB/s (sampled at each transfer's completion) and
    bytes-in-flight (+nbytes at t0, -nbytes at t1 — overlapping
    chunked streams stack)."""
    rows: List[Dict[str, Any]] = []
    for direction in ("h2d", "d2h"):
        deltas: List[Tuple[int, int]] = []
        for sp in spans:
            if sp.subsys != "xfer" or sp.name != direction:
                continue
            nb = int((sp.args or {}).get("bytes", 0))
            deltas.append((sp.t0, nb))
            deltas.append((sp.t1, -nb))
            dur = sp.t1 - sp.t0
            if dur > 0 and nb:
                rows.append({
                    "ph": "C", "name": f"xfer_{direction}_GBps",
                    "pid": rank, "tid": 0,
                    "ts": (sp.t1 + shift_ns) / 1e3,
                    # bytes/ns == GB/s
                    "args": {"GBps": round(nb / dur, 3)}})
        inflight = 0
        for t, d in sorted(deltas):
            inflight += d
            rows.append({
                "ph": "C",
                "name": f"xfer_{direction}_bytes_in_flight",
                "pid": rank, "tid": 0, "ts": (t + shift_ns) / 1e3,
                "args": {"bytes": inflight}})
    return rows


def _link_counters(rank: int, shift_ns: int) -> List[Dict[str, Any]]:
    """Perfetto counter tracks from the monitoring plane's per-link
    series (level 2): cumulative bytes over the hottest ICI link at
    each attribution sample (NVLink on the card) — renders congestion
    ramps next to the span lanes."""
    from ompi_tpu_torch.monitoring import matrix as _mon

    tm = _mon.TRAFFIC
    if tm is None:
        return []
    rows: List[Dict[str, Any]] = []
    for t_ns, link, cum_bytes in tm.link_series():
        rows.append({
            "ph": "C", "name": f"ici_link {link}",
            "pid": rank, "tid": 0,
            "ts": (t_ns + shift_ns) / 1e3,
            "args": {"bytes": int(cum_bytes)}})
    return rows


def _skew_rows(rank: int, shift_ns: int) -> List[Dict[str, Any]]:
    """The "skew" lane from the skew plane's completed-collective
    ring: one span per collective, split into "<op> wait"
    [entry, last peer's arrival] + "<op> xfer" [arrival, exit] when
    the Finalize merge resolved the group's last arrival — the
    straggler tax rendered next to the span lanes."""
    from ompi_tpu_torch.skew import record as _skew_rec

    sk = _skew_rec.SKEW
    if sk is None:
        return []
    rows: List[Dict[str, Any]] = []
    tid = _TIDS["skew"]
    sk_shift = sk.shift_ns()
    for seq, op, cid, nbytes, t0, t1 in sk.records():
        arr = sk.arrivals.get((cid, seq))
        args = {"seq": seq, "cid": cid, "nbytes": nbytes}
        if arr is not None:
            # merged arrival is in the SHARED timebase; back to local
            arr_local = min(max(int(arr) - sk_shift, t0), t1)
            rows.append({"ph": "X", "name": f"{op} wait",
                         "cat": "skew", "pid": rank, "tid": tid,
                         "ts": (t0 + shift_ns) / 1e3,
                         "dur": (arr_local - t0) / 1e3, "args": args})
            rows.append({"ph": "X", "name": f"{op} xfer",
                         "cat": "skew", "pid": rank, "tid": tid,
                         "ts": (arr_local + shift_ns) / 1e3,
                         "dur": (t1 - arr_local) / 1e3, "args": args})
        else:
            rows.append({"ph": "X", "name": op, "cat": "skew",
                         "pid": rank, "tid": tid,
                         "ts": (t0 + shift_ns) / 1e3,
                         "dur": max(t1 - t0, 0) / 1e3, "args": args})
    return rows


def to_chrome(rec: Optional["_rec.Recorder"] = None,
              spans: Optional[Sequence] = None) -> Dict[str, Any]:
    """Recorder (default: the live one) -> Chrome trace dict."""
    rec = rec if rec is not None else _rec.RECORDER
    if rec is None:
        raise RuntimeError("tracing is not enabled and no recorder "
                           "was passed")
    spans = rec.spans() if spans is None else list(spans)
    rank = rec.rank
    shift_ns = rec.clock_offset_ns - rec.clock_base_ns
    tids = dict(_TIDS)
    evs: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
        "args": {"name": f"rank {rank}"},
    }]
    named = set()
    rows: List[Dict[str, Any]] = []
    for sp in spans:
        tid = tids.get(sp.subsys)
        if tid is None:
            tid = tids[sp.subsys] = max(tids.values()) + 1
        if sp.subsys not in named:
            named.add(sp.subsys)
            evs.append({"ph": "M", "name": "thread_name", "pid": rank,
                        "tid": tid, "args": {"name": sp.subsys}})
        row = {"ph": "X", "name": sp.name, "cat": sp.subsys,
               "pid": rank, "tid": tid,
               "ts": (sp.t0 + shift_ns) / 1e3,
               "dur": max(sp.t1 - sp.t0, 0) / 1e3}
        if sp.args:
            row["args"] = sp.args
        rows.append(row)
    rows.extend(_xfer_counters(spans, rank, shift_ns))
    rows.extend(_link_counters(rank, shift_ns))
    sk_rows = _skew_rows(rank, shift_ns)
    if sk_rows and "skew" not in named:
        evs.append({"ph": "M", "name": "thread_name", "pid": rank,
                    "tid": _TIDS["skew"], "args": {"name": "skew"}})
    rows.extend(sk_rows)
    rows.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    snap = pvar.snapshot()
    return {
        "traceEvents": evs + rows,
        "displayTimeUnit": "ms",
        "metadata": {
            "rank": rank,
            "clock_offset_ns": rec.clock_offset_ns,
            "clock_base_ns": rec.clock_base_ns,
            "dropped": snap.get("trace_dropped", 0),
            "hist": {k: v for k, v in snap.items()
                     if k.startswith(_rec.HIST_PREFIX)},
        },
    }


def write(path: str, rec: Optional["_rec.Recorder"] = None,
          spans: Optional[Sequence] = None) -> Dict[str, Any]:
    doc = to_chrome(rec, spans)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc


# -- log2 histogram decoding (pvar plane -> numbers) ---------------------

def histograms(snapshot: Optional[Dict[str, int]] = None
               ) -> Dict[str, Dict[Tuple[int, int], int]]:
    """{op: {(size_bin, lat_bin): count}} from trace_hist_* counters.
    Bins are bit_length values: bin b holds samples in
    [2^(b-1), 2^b) (b=0 holds exact zeros)."""
    snap = snapshot if snapshot is not None else pvar.snapshot()
    out: Dict[str, Dict[Tuple[int, int], int]] = {}
    for name, v in snap.items():
        if not name.startswith(_rec.HIST_PREFIX):
            continue
        body, sep, lat = name[len(_rec.HIST_PREFIX):].rpartition("_lat")
        op, sep2, sz = body.rpartition("_sz")
        if not sep or not sep2 or not op:
            continue
        try:
            key = (int(sz), int(lat))
        except ValueError:
            continue
        out.setdefault(op, {})[key] = v
    return out


def _bin_mid(b: int) -> float:
    """Representative value for log2 bin b (midpoint of
    [2^(b-1), 2^b))."""
    if b <= 0:
        return 0.0
    if b == 1:
        return 1.0
    return 3.0 * 2.0 ** (b - 2)


def percentiles(op: str, qs: Sequence[float] = (0.5, 0.99),
                snapshot: Optional[Dict[str, int]] = None
                ) -> Optional[List[float]]:
    """Approximate latency percentiles (ns) for one op, collapsing
    size bins. None when no samples exist (e.g. tracing disabled)."""
    h = histograms(snapshot).get(op)
    if not h:
        return None
    lat: Dict[int, int] = {}
    for (_s, b), c in h.items():
        lat[b] = lat.get(b, 0) + c
    total = sum(lat.values())
    out = []
    for q in qs:
        target = q * total
        cum = 0
        val = 0.0
        for b in sorted(lat):
            cum += lat[b]
            val = _bin_mid(b)
            if cum >= target:
                break
        out.append(val)
    return out
