"""Cross-rank matrix merge — kvstore exchange + transpose check (the port
of :mod:`ompi_tpu.monitoring.merge`; plain Python, the port's own copy,
with the reference's schema so dumps of both packages merge alike).

Counting is send-side (each rank records only what it transmits), so
the job-wide matrix assembles by stacking per-rank rows; the receive
view is its transpose. On a clean run the p2p/coll contexts must be
transpose-consistent for symmetric traffic patterns — the merge
computes the worst relative |M[i][j] - M[j][i]| skew per context and
reports it, which catches both lost counts and misattributed peers
(the bug class the old inter-communicator fallback hid).

Two transports: ranks publish JSON snapshot docs to the kvstore under
``mon:mat:{jobid}:{rank}`` (the telemetry rollup pattern), or dump
them as files at Finalize (``--mca monitoring_dump``) for the report
CLI to merge offline. Schema ``ompi_tpu.monitoring.matrix/1``. The
port's :func:`collect` polls the store until ``timeout`` and raises
``MPIError(ERR_INTERN)`` naming the missing rank (the reference passes
the timeout as the store's blocking flag, so it waits without end).
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from ompi_tpu_torch.monitoring.links import Link, LinkMap, link_name, sum_links

SCHEMA = "ompi_tpu.monitoring.matrix/1"


def snapshot_doc(tm) -> Dict[str, object]:
    """One rank's JSON-able matrix snapshot (keys stringified for
    JSON round-tripping; parse back with int())."""
    with tm.lock:
        tables = {ctx: {str(d): list(cell) for d, cell in t.items()}
                  for ctx, t in tm.tables.items() if t}
        coll_records = [
            {"op": op, "bucket": bucket, "dtype": dt,
             "mesh": list(mesh), "launches": rec[0],
             "bytes": rec[1]}
            for (op, bucket, dt, mesh), rec in
            sorted(tm.coll_records.items())]
        link_bytes = {link_name(k): v
                      for k, v in tm.link_bytes.items()}
        expert = {str(e): c for e, c in tm.expert.items()}
        hier = {op: list(rec)
                for op, rec in sorted(tm.hier_levels.items())}
        serve = {
            pol: {**{k: v for k, v in rec.items() if k != "lat_ns"},
                  "lat_ns": {str(b): c
                             for b, c in sorted(rec["lat_ns"].items())}}
            for pol, rec in sorted(tm.serve.items())}
    return {
        "schema": SCHEMA,
        "rank": tm.rank,
        "nranks": tm.nranks,
        "level": tm.level,
        "tables": tables,
        "coll_records": coll_records,
        "link_bytes": link_bytes,
        "expert_tokens": expert,
        "hier_levels": hier,
        "serve": serve,
    }


def _key(jobid: str, rank: int) -> str:
    return f"mon:mat:{jobid}:{rank}"


def publish(client, jobid: str, rank: int,
            doc: Dict[str, object]) -> None:
    client.put(_key(jobid, rank), json.dumps(doc))


def collect(client, jobid: str, nranks: int,
            timeout: float = 10.0) -> List[Dict[str, object]]:
    """Gather every rank's published snapshot, polling the store until
    ``timeout`` seconds have passed."""
    deadline = time.monotonic() + timeout
    docs = []
    for r in range(nranks):
        raw = client.get(_key(jobid, r), wait=False)
        while raw is None:
            if time.monotonic() > deadline:
                from ompi_tpu_torch import errors

                raise errors.MPIError(
                    errors.ERR_INTERN,
                    f"monitoring: rank {r}'s matrix snapshot not "
                    f"published within {timeout} s")
            time.sleep(0.01)
            raw = client.get(_key(jobid, r), wait=False)
        docs.append(json.loads(raw))
    return docs


def _parse_link(name: str) -> Link:
    # inverse of links.link_name: "d0:r1-r3"
    d, rest = name.split(":", 1)
    a, b = rest.split("-")
    return (int(d[1:]), int(a[1:]), int(b[1:]))


def merge(docs: List[Dict[str, object]]) -> Dict[str, object]:
    """Assemble per-rank snapshots into the job view.

    Returns {ctx: {src: {dst: [msgs, bytes]}}} matrices, per-rank
    send/recv byte totals, the per-context transpose skew, summed
    link loads + imbalance + hottest link, merged collective records,
    and merged expert-token counts.
    """
    for doc in docs:
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"not a monitoring matrix dump (schema="
                f"{doc.get('schema')!r}, want {SCHEMA!r})")
    nranks = max([int(d.get("nranks", 0)) for d in docs] +
                 [int(d["rank"]) + 1 for d in docs])
    mats: Dict[str, Dict[int, Dict[int, List[float]]]] = {}
    for doc in docs:
        src = int(doc["rank"])
        for ctx, table in doc.get("tables", {}).items():
            row = mats.setdefault(ctx, {}).setdefault(src, {})
            for dst, cell in table.items():
                got = row.setdefault(int(dst), [0, 0.0])
                got[0] += cell[0]
                got[1] += cell[1]

    tx = [0.0] * nranks
    rx = [0.0] * nranks
    for rows in mats.values():
        for src, row in rows.items():
            for dst, (_m, b) in row.items():
                tx[src] += b
                if 0 <= dst < nranks:
                    rx[dst] += b

    skew = {ctx: transpose_skew(rows) for ctx, rows in mats.items()}

    link_loads = sum_links(
        [{_parse_link(k): v
          for k, v in doc.get("link_bytes", {}).items()}
         for doc in docs])
    hot = LinkMap.hottest(link_loads, top=len(link_loads))

    coll_records: Dict[Tuple[str, int, str, Tuple[int, ...]],
                       List[float]] = {}
    for doc in docs:
        for rec in doc.get("coll_records", []):
            key = (rec["op"], int(rec["bucket"]), rec["dtype"],
                   tuple(rec["mesh"]))
            got = coll_records.setdefault(key, [0, 0.0])
            got[0] += rec["launches"]
            got[1] += rec["bytes"]

    expert: Dict[int, int] = {}
    for doc in docs:
        for e, c in doc.get("expert_tokens", {}).items():
            expert[int(e)] = expert.get(int(e), 0) + int(c)

    hier_levels: Dict[str, List[float]] = {}
    for doc in docs:
        for op, rec in doc.get("hier_levels", {}).items():
            got = hier_levels.setdefault(op, [0, 0.0, 0.0, 0.0])
            got[0] += rec[0]
            got[1] += rec[1]
            got[2] += rec[2]
            # pre-compression dumps carry 3 elements: the wire figure
            # IS the nominal one (every launch was exact)
            got[3] += rec[3] if len(rec) > 3 else rec[2]

    serve: Dict[str, Dict[str, object]] = {}
    for doc in docs:
        for pol, rec in doc.get("serve", {}).items():
            got = serve.setdefault(pol, {
                "requests": 0, "tokens": 0, "kept": 0, "rerouted": 0,
                "dropped": 0, "dcn_tokens": 0, "dcn_bytes": 0,
                "lat_ns": {}})
            for k in ("requests", "tokens", "kept", "rerouted",
                      "dropped", "dcn_tokens", "dcn_bytes"):
                got[k] += int(rec.get(k, 0))
            for b, c in rec.get("lat_ns", {}).items():
                got["lat_ns"][int(b)] = (got["lat_ns"].get(int(b), 0)
                                         + int(c))

    return {
        "schema": SCHEMA + "+merged",
        "nranks": nranks,
        "matrices": mats,
        "tx_bytes": tx,
        "rx_bytes": rx,
        "transpose_skew": skew,
        "links": [{"name": link_name(k), "bytes": v}
                  for k, v in hot],
        "link_imbalance": LinkMap.imbalance(link_loads),
        "coll_records": [
            {"op": op, "bucket": bucket, "dtype": dt,
             "mesh": list(mesh), "launches": rec[0],
             "bytes": rec[1]}
            for (op, bucket, dt, mesh), rec in
            sorted(coll_records.items())],
        "expert_tokens": expert,
        "hier_levels": {op: list(rec)
                        for op, rec in sorted(hier_levels.items())},
        "serve": {pol: dict(rec)
                  for pol, rec in sorted(serve.items())},
    }


def transpose_skew(rows: Dict[int, Dict[int, List[float]]]) -> float:
    """Worst relative |M[i][j] - M[j][i]| over byte cells — 0.0 for
    transpose-consistent (symmetric-pattern) traffic; send-side
    counting makes asymmetry here mean lost or misattributed counts
    when the pattern itself is symmetric."""
    worst = 0.0
    seen = set()
    for i, row in rows.items():
        for j in row:
            if (j, i) in seen:
                continue
            seen.add((i, j))
            a = row.get(j, [0, 0.0])[1]
            b = rows.get(j, {}).get(i, [0, 0.0])[1]
            hi = max(a, b)
            if hi > 0:
                worst = max(worst, abs(a - b) / hi)
    return worst


def exchange(tm, client, jobid: str, nranks: int,
             timeout: float = 10.0) -> Optional[Dict[str, object]]:
    """All ranks publish; rank 0 collects and merges (the telemetry
    rollup shape). Non-zero ranks return None."""
    publish(client, jobid, tm.rank, snapshot_doc(tm))
    if tm.rank != 0:
        return None
    return merge(collect(client, jobid, nranks, timeout))
