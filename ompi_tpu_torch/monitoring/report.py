"""Terminal + JSON reporting over merged traffic matrices (the port of
:mod:`ompi_tpu.monitoring.report`; plain Python, the port's own copy: the
text is the reference's line for line, so scripts that grep it read both
packages' reports).

Renders the rank×rank heatmap per context, the per-link load table
with the hottest ICI links ranked, top-N (src, dst, ctx) hotspot
cells, collective-launch records, and expert-token imbalance — the
human face of ``python -m ompi_tpu_torch.monitoring report``.
"""

from __future__ import annotations

from typing import Dict, List

# Shade ramp for the terminal heatmap: cell byte count relative to
# the matrix max.
_RAMP = " .:-=+*#%@"


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return (f"{b:.0f}{unit}" if unit == "B"
                    else f"{b:.1f}{unit}")
        b /= 1024
    return f"{b:.1f}GiB"


def heatmap_lines(rows: Dict[int, Dict[int, List[float]]],
                  nranks: int, ctx: str) -> List[str]:
    """rank×rank byte heatmap for one context: shaded cells plus the
    per-row send totals (send-side counting means row r is exactly
    what rank r transmitted)."""
    peak = max((cell[1] for row in rows.values()
                for cell in row.values()), default=0.0)
    out = [f"[{ctx}] send-side bytes, {nranks}x{nranks} "
           f"(peak cell {_fmt_bytes(peak)})"]
    hdr = "      " + "".join(f"{d:>4d}" for d in range(nranks))
    out.append(hdr + "   tx_total")
    for src in range(nranks):
        row = rows.get(src, {})
        cells = []
        total = 0.0
        for dst in range(nranks):
            b = row.get(dst, [0, 0.0])[1]
            total += b
            if src == dst:
                cells.append("   -")
            elif b <= 0:
                cells.append("   .")
            else:
                shade = _RAMP[min(len(_RAMP) - 1,
                                  int(b / peak * (len(_RAMP) - 1)))] \
                    if peak > 0 else "."
                cells.append(f"   {shade}")
        out.append(f"  r{src:<3d}" + "".join(cells) +
                   f"   {_fmt_bytes(total)}")
    return out


def link_lines(links: List[Dict[str, object]],
               imbalance: float, top: int) -> List[str]:
    if not links:
        return ["[links] no link attribution recorded "
                "(needs monitoring_level 2)"]
    peak = float(links[0]["bytes"]) or 1.0
    out = [f"[links] {len(links)} ICI links, "
           f"imbalance max/mean = {imbalance:.2f}; "
           f"hottest: {links[0]['name']} "
           f"({_fmt_bytes(float(links[0]['bytes']))})"]
    for row in links[:top]:
        b = float(row["bytes"])
        bar = "#" * max(1, int(b / peak * 40))
        out.append(f"  {row['name']:>12s} {_fmt_bytes(b):>10s} {bar}")
    return out


def hotspot_lines(merged: Dict[str, object], top: int) -> List[str]:
    cells = []
    for ctx, rows in merged.get("matrices", {}).items():
        for src, row in rows.items():
            for dst, (msgs, b) in row.items():
                cells.append((float(b), int(msgs), int(src),
                              int(dst), ctx))
    cells.sort(key=lambda c: (-c[0], c[2], c[3]))
    out = [f"[hotspots] top {min(top, len(cells))} of "
           f"{len(cells)} cells"]
    for b, msgs, src, dst, ctx in cells[:top]:
        out.append(f"  r{src} -> r{dst} [{ctx}]: "
                   f"{_fmt_bytes(b)} in {msgs} msgs")
    return out


def _hist_percentile(hist: Dict[int, int], q: float) -> float:
    """Approximate percentile in ms from a log2(ns)-bucket histogram
    (bucket upper bound — the same conservative read the trace
    plane's exporter uses)."""
    if not hist:
        return 0.0
    items = sorted((int(b), int(c)) for b, c in hist.items())
    total = sum(c for _, c in items)
    target = q / 100.0 * total
    run = 0
    for b, c in items:
        run += c
        if run >= target:
            return float(2 ** b) / 1e6
    return float(2 ** items[-1][0]) / 1e6


def serve_lines(serve: Dict[str, Dict[str, object]],
                experts: Dict[object, int], top: int) -> List[str]:
    """The serving-plane section: per-policy token accounting + tail
    latency, the per-expert load heatmap, and the hot-expert verdict
    (expert NAMED with its load share — the smoke lane greps for
    it)."""
    out: List[str] = []
    for pol, rec in sorted(serve.items()):
        toks = max(int(rec.get("tokens", 0)), 1)
        out.append(
            f"[serve] policy {pol}: {rec.get('requests', 0)} requests,"
            f" {rec.get('tokens', 0)} tokens; "
            f"kept {rec.get('kept', 0)} "
            f"({100.0 * int(rec.get('kept', 0)) / toks:.1f}%), "
            f"dropped {rec.get('dropped', 0)} "
            f"({100.0 * int(rec.get('dropped', 0)) / toks:.1f}%), "
            f"rerouted {rec.get('rerouted', 0)}, "
            f"DCN {rec.get('dcn_tokens', 0)} tokens / "
            f"{_fmt_bytes(float(rec.get('dcn_bytes', 0)))}")
        hist = rec.get("lat_ns", {})
        if hist:
            out.append(
                f"  latency ~p50 {_hist_percentile(hist, 50):.2f}ms"
                f"  ~p95 {_hist_percentile(hist, 95):.2f}ms"
                f"  ~p99 {_hist_percentile(hist, 99):.2f}ms"
                " (log2-bin upper bounds)")
    if serve and experts:
        counts = {int(e): int(c) for e, c in experts.items()}
        peak = max(counts.values())
        total = sum(counts.values()) or 1
        out.append(f"  expert load ({len(counts)} experts, "
                   f"{total} routed tokens):")
        for e in sorted(counts):
            c = counts[e]
            bar = "#" * max(1, int(c / peak * 40)) if c else ""
            out.append(f"    e{e:<3d} {c:>8d} {bar}")
        hot_e, hot_c = max(counts.items(), key=lambda kv: kv[1])
        share = hot_c / total
        fair = 1.0 / max(len(counts), 1)
        verdict = "HOT" if share >= 2.0 * fair else "balanced"
        out.append(f"  hot expert: e{hot_e} — {100.0 * share:.1f}% "
                   f"of routed tokens ({share / fair:.1f}x fair "
                   f"share, {verdict})")
    return out


def render(merged: Dict[str, object], top: int = 5) -> str:
    nranks = int(merged["nranks"])
    out: List[str] = [
        f"traffic report: {nranks} ranks, "
        f"tx {_fmt_bytes(sum(merged['tx_bytes']))} total"]
    for ctx in sorted(merged.get("matrices", {})):
        out.extend(heatmap_lines(merged["matrices"][ctx], nranks,
                                 ctx))
        skew = merged.get("transpose_skew", {}).get(ctx)
        if skew is not None:
            out.append(f"  transpose skew: {skew:.3f} "
                       "(0.0 = send/recv views agree)")
    out.extend(link_lines(merged.get("links", []),
                          float(merged.get("link_imbalance", 0.0)),
                          top))
    out.extend(hotspot_lines(merged, top))
    recs = merged.get("coll_records", [])
    if recs:
        out.append(f"[collectives] {len(recs)} (op, size-bucket, "
                   "dtype, mesh) records")
        for rec in recs[:top]:
            out.append(
                f"  {rec['op']:<22s} 2^{rec['bucket']:<2d}B "
                f"{rec['dtype'] or '?':<10s} "
                f"mesh{tuple(rec['mesh'])!r:<10} "
                f"{rec['launches']:.0f} launches "
                f"{_fmt_bytes(float(rec['bytes']))}")
    hier = merged.get("hier_levels", {})
    if hier:
        tot_ici = sum(rec[1] for rec in hier.values())
        tot_dcn = sum(rec[2] for rec in hier.values())
        # actual transmitted DCN bytes (compressed wire formats);
        # 3-element records predate compression — wire == nominal
        tot_wire = sum(rec[3] if len(rec) > 3 else rec[2]
                       for rec in hier.values())
        # which level is the bottleneck: weight the slow axis by the
        # nominal ICI/DCN bandwidth gap (order of magnitude) before
        # comparing byte loads — against what the wire ACTUALLY
        # carried, else a compressed job would keep reading DCN-bound
        if tot_dcn > 0:
            verdict = "DCN-bound" if tot_wire * 10.0 >= tot_ici \
                else "ICI-bound"
            line = (f"[hier] two-level collectives: "
                    f"ICI {_fmt_bytes(tot_ici)} / "
                    f"DCN {_fmt_bytes(tot_wire)} on the wire")
            if tot_wire < tot_dcn:
                line += (f" ({_fmt_bytes(tot_dcn)} nominal, "
                         f"{tot_dcn / max(tot_wire, 1e-9):.1f}x "
                         "compressed)")
            line += (f" (ratio {tot_ici / max(tot_wire, 1e-9):.1f}:1;"
                     f" {verdict} at a nominal 10x slower DCN)")
            out.append(line)
        else:
            out.append(f"[hier] two-level collectives: "
                       f"ICI {_fmt_bytes(tot_ici)} / DCN 0B")
        for op, rec in list(hier.items())[:top]:
            wire = float(rec[3] if len(rec) > 3 else rec[2])
            line = (f"  {op:<22s} {rec[0]:.0f} launches  "
                    f"ICI {_fmt_bytes(float(rec[1])):>10s}  "
                    f"DCN {_fmt_bytes(wire):>10s}")
            if wire < float(rec[2]):
                line += (f" (nominal "
                         f"{_fmt_bytes(float(rec[2]))})")
            out.append(line)
    experts = merged.get("expert_tokens", {})
    serve = merged.get("serve", {})
    if serve:
        out.extend(serve_lines(serve, experts, top))
    if experts:
        total = sum(experts.values()) or 1
        hot = max(experts.items(), key=lambda kv: kv[1])
        out.append(f"[experts] {len(experts)} experts, "
                   f"{total} tokens; hottest expert {hot[0]} "
                   f"({hot[1]} tokens, "
                   f"{hot[1] * len(experts) / total:.2f}x fair "
                   "share)")
    return "\n".join(out)
