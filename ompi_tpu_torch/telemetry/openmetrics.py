"""OpenMetrics text rendering of the pvar plane.

The port's copy of ``ompi_tpu.telemetry.openmetrics``; the tune plane's
providers are the port's (``device``, ``cuda``, ``hier``).

Semantics mapping (the acceptance contract, round-tripped by
:func:`parse` in the tests): monotonically-increasing pvar counters
become OpenMetrics ``counter`` families (sample suffix ``_total``);
high-watermark pvars (``*_hwm`` keys of ``pvar.snapshot()``) and any
explicitly-listed gauge keys become ``gauge`` families. The trace
plane's log2 latency bins (``trace_hist_<op>_sz<s>_lat<l>`` counters,
:func:`ompi_tpu_torch.trace.recorder.hist`) become real ``histogram``
families — one per op, ``sz`` as a label, cumulative ``_bucket``
samples with ``le`` = the bin's upper bound 2^l ns (bin l holds
[2^(l-1), 2^l); l=0 holds exact zeros, le=1), plus ``_count`` and an
approximate midpoint-weighted ``_sum``. ``le`` is rendered as a plain
integer so :func:`parse` can invert it exactly
(l = le.bit_length()-1) and rebuild the original counter names by
cumulative differencing. Every sample carries the per-rank labels,
names get the ``ompi_tpu_`` namespace prefix, and the exposition ends
with the mandatory ``# EOF``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple

PREFIX = "ompi_tpu_"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

#: one rendered label, inverse of :func:`_labelstr` (escapes included)
_LABEL_RE = re.compile(r'([a-zA-Z0-9_:]+)="((?:[^"\\]|\\.)*)"')


def _safe(name: str) -> str:
    return _NAME_OK.sub("_", name)


def _labelstr(labels: Optional[Mapping[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (_safe(k), str(v).replace("\\", "\\\\")
                     .replace('"', '\\"').replace("\n", "\\n"))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _hist_split(name: str) -> Optional[Tuple[str, int, int]]:
    """``trace_hist_<op>_sz<s>_lat<l>`` -> (op, s, l); None for
    anything else (same decode as trace.export.histograms)."""
    from ompi_tpu_torch.trace import recorder as _rec

    if not name.startswith(_rec.HIST_PREFIX):
        return None
    body, sep, lat = name[len(_rec.HIST_PREFIX):].rpartition("_lat")
    op, sep2, sz = body.rpartition("_sz")
    if not sep or not sep2 or not op:
        return None
    try:
        return op, int(sz), int(lat)
    except ValueError:
        return None


_MON_TX_RE = re.compile(
    r"^monitoring_tx_(msgs|bytes)_s(\d+)_d(\d+)_([a-z0-9]+)$")
_MON_LINK_RE = re.compile(
    r"^monitoring_link_bytes_d(\d+)_r(\d+)_r(\d+)(_hwm)?$")
_MON_EXPERT_RE = re.compile(r"^monitoring_expert_tokens_e(\d+)$")
_TUNE_OBS_RE = re.compile(r"^tune_obs_(.+)_(device|cuda|hier)$")
_SKEW_OP_RE = re.compile(r"^skew_op_wait_ns_(.+)$")


def _mon_split(name: str
               ) -> Optional[Tuple[str, Dict[str, str], bool]]:
    """Dynamically-named per-cell pvar -> (family, labels, is_gauge):
    the matrix cells (``monitoring_tx_*_s<i>_d<j>_<ctx>``), per-link
    loads (``monitoring_link_bytes_d<d>_r<a>_r<b>``, hwm-backed so a
    gauge), per-expert token counts, the tune plane's per-(op,
    provider) observation counters (``tune_obs_<op>_<provider>`` ->
    ``tune_observed{op=...,provider=...}``), and the skew plane's
    per-op exposed-wait counters (``skew_op_wait_ns_<op>`` ->
    ``skew_op_wait_ns{op=...}``) fold into labelled families
    instead of one flat metric per cell."""
    m = _SKEW_OP_RE.match(name)
    if m:
        return ("skew_op_wait_ns", {"op": m.group(1)}, False)
    m = _TUNE_OBS_RE.match(name)
    if m:
        return ("tune_observed",
                {"op": m.group(1), "provider": m.group(2)}, False)
    m = _MON_TX_RE.match(name)
    if m:
        return ("monitoring_tx_" + m.group(1),
                {"src": m.group(2), "dst": m.group(3),
                 "ctx": m.group(4)}, False)
    m = _MON_LINK_RE.match(name)
    if m:
        return ("monitoring_link_bytes",
                {"dim": m.group(1), "rank_a": m.group(2),
                 "rank_b": m.group(3)}, True)
    m = _MON_EXPERT_RE.match(name)
    if m:
        return ("monitoring_expert_tokens",
                {"expert": m.group(1)}, False)
    return None


def _bin_mid(b: int) -> float:
    """Representative value for log2 bin b (midpoint of
    [2^(b-1), 2^b); b=0 holds exact zeros)."""
    if b <= 0:
        return 0.0
    if b == 1:
        return 1.0
    return 3.0 * 2.0 ** (b - 2)


def render(snap: Mapping[str, int],
           labels: Optional[Mapping[str, str]] = None,
           gauges: Iterable[str] = (),
           terminate: bool = True) -> str:
    """One rank's pvar snapshot as OpenMetrics text. ``gauges`` lists
    extra keys to render as gauges (``*_hwm`` keys always are);
    ``trace_hist_*`` counters fold into per-op histogram families.
    ``terminate=False`` omits ``# EOF`` so a job-rollup block can be
    appended before the terminator."""
    gauge_keys: Set[str] = set(gauges)
    lbl = _labelstr(labels)
    lines = []
    hists: Dict[str, Dict[int, Dict[int, int]]] = {}
    mon_typed: Set[str] = set()  # TYPE emitted once per mon family
    for name in sorted(snap):
        value = snap[name]
        h = _hist_split(name)
        if h is not None:
            op, s, l = h
            hists.setdefault(op, {}).setdefault(s, {})[l] = value
            continue
        mon = _mon_split(name)
        if mon is not None:
            fam, extra, is_gauge = mon
            metric = PREFIX + _safe(fam)
            mlbl = _labelstr({**(labels or {}), **extra})
            if metric not in mon_typed:
                mon_typed.add(metric)
                lines.append("# TYPE %s %s" % (
                    metric, "gauge" if is_gauge else "counter"))
            if is_gauge:
                lines.append("%s%s %d" % (metric, mlbl, value))
            else:
                lines.append("%s_total%s %d" % (metric, mlbl, value))
            continue
        metric = PREFIX + _safe(name)
        if name.endswith("_hwm") or name in gauge_keys:
            lines.append("# TYPE %s gauge" % metric)
            lines.append("%s%s %d" % (metric, lbl, value))
        else:
            lines.append("# TYPE %s counter" % metric)
            lines.append("%s_total%s %d" % (metric, lbl, value))
    base = dict(labels or {})
    for op in sorted(hists):
        metric = PREFIX + "trace_hist_" + _safe(op)
        lines.append("# TYPE %s histogram" % metric)
        for s in sorted(hists[op]):
            cum, total = 0, 0.0
            for l in sorted(hists[op][s]):
                v = hists[op][s][l]
                cum += v
                total += v * _bin_mid(l)
                blbl = _labelstr({**base, "sz": str(s),
                                  "le": str(1 << l)})
                lines.append("%s_bucket%s %d" % (metric, blbl, cum))
            slbl = _labelstr({**base, "sz": str(s)})
            lines.append("%s_bucket%s %d" % (
                metric, _labelstr({**base, "sz": str(s),
                                   "le": "+Inf"}), cum))
            lines.append("%s_count%s %d" % (metric, slbl, cum))
            lines.append("%s_sum%s %g" % (metric, slbl, total))
    if terminate:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _parse_labels(lbl: str) -> Dict[str, str]:
    """Inverse of :func:`_labelstr` ({} form, escapes undone)."""
    if not lbl:
        return {}
    return {m.group(1): m.group(2)
            .replace('\\"', '"').replace("\\n", "\n")
            .replace("\\\\", "\\")
            for m in _LABEL_RE.finditer(lbl)}


def parse(text: str) -> Dict[str, Dict[str, int]]:
    """Inverse of :func:`render` (tests + scrape checks): returns
    ``{pvar_name: {labelstr: value}}`` with the prefix and the
    counter ``_total`` suffix stripped, so keys match the original
    ``pvar.snapshot()`` names. Histogram families invert back to the
    original ``trace_hist_<op>_sz<s>_lat<l>`` counters: cumulative
    ``_bucket`` samples are differenced in ascending-``le`` order
    (l = le.bit_length()-1), zero bins dropped; ``_count`` (= the
    +Inf bucket) and the approximate ``_sum`` carry no extra
    information and are skipped."""
    types: Dict[str, str] = {}
    out: Dict[str, Dict[str, int]] = {}
    # (family, labelstr-sans-le/sz, sz) -> [(le, cumulative), ...]
    groups: Dict[Tuple[str, str, str], List[Tuple[int, int]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name_part, _, value = line.rpartition(" ")
        metric, lbl = name_part, ""
        if "{" in name_part:
            metric, _, rest = name_part.partition("{")
            lbl = "{" + rest
        if metric.endswith("_total") \
                and types.get(metric[:-len("_total")]) == "counter":
            # counter sample: the family is declared without _total
            metric = metric[:-len("_total")]
        for suffix in ("_bucket", "_count", "_sum"):
            if metric.endswith(suffix) and types.get(
                    metric[:-len(suffix)]) == "histogram":
                if suffix != "_bucket":
                    break  # derived samples: nothing to invert
                labels = _parse_labels(lbl)
                le = labels.pop("le", "")
                sz = labels.pop("sz", "0")
                if le == "+Inf":
                    break  # total: equals the last finite bucket
                groups.setdefault(
                    (metric[:-len("_bucket")], _labelstr(labels), sz),
                    []).append((int(le), int(value)))
                break
        else:
            name = metric[len(PREFIX):] if metric.startswith(PREFIX) \
                else metric
            out.setdefault(name, {})[lbl] = int(value)
    for (family, lbl, sz), buckets in groups.items():
        base = family[len(PREFIX):] if family.startswith(PREFIX) \
            else family
        prev = 0
        for le, cum in sorted(buckets):
            if cum > prev:
                name = "%s_sz%s_lat%d" % (base, sz,
                                          le.bit_length() - 1)
                out.setdefault(name, {})[lbl] = cum - prev
            prev = cum
    return out


def aggregate(snaps: Iterable[Mapping[str, int]]) -> Dict[str, int]:
    """Job-level rollup: counters sum across ranks, watermarks take
    the max (the MPI_T reduction semantics for each class)."""
    out: Dict[str, int] = {}
    for snap in snaps:
        for name, value in snap.items():
            if name.endswith("_hwm"):
                if value > out.get(name, 0):
                    out[name] = value
            else:
                out[name] = out.get(name, 0) + value
    return out
