"""Cross-rank skew-ring merge — kvstore exchange + timebase rebase.

The ``monitoring/merge`` shape: ranks publish JSON snapshot docs to
the kvstore under ``skew:rec:{jobid}:{rank}`` (or dump them as files
at Finalize via ``--mca skew_dump`` for the offline CLI), rank 0
collects and merges. Schema ``ompi_tpu.skew/1``.

Records are published in LOCAL monotonic ns alongside the rank's
synced clock numbers; :func:`merge` rebases every rank's ring into
the shared (rank 0 monotonic) timebase via ``telemetry/clock.py``
and carries the worst pairwise comparison error so the analysis can
state its error bar.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ompi_tpu_torch.telemetry import clock as _clock

SCHEMA = "ompi_tpu.skew/1"


def snapshot_doc(sk) -> Dict[str, Any]:
    """One rank's JSON-able skew-ring snapshot."""
    return {
        "schema": SCHEMA,
        "rank": sk.rank,
        "nranks": sk.nranks,
        "level": sk.level,
        "clock_offset_ns": sk.clock_offset_ns,
        "clock_err_ns": sk.clock_err_ns,
        "clock_base_ns": sk.clock_base_ns,
        "clock_base_err_ns": sk.clock_base_err_ns,
        "records": [
            {"seq": s, "op": op, "cid": cid, "nbytes": nb,
             "t0": t0, "t1": t1}
            for s, op, cid, nb, t0, t1 in sk.records()],
    }


def _key(jobid: str, rank: int) -> str:
    return f"skew:rec:{jobid}:{rank}"


def publish(client, jobid: str, rank: int,
            doc: Dict[str, Any]) -> None:
    client.put(_key(jobid, rank), json.dumps(doc))


def collect(client, jobid: str, nranks: int,
            timeout: float = 10.0) -> List[Dict[str, Any]]:
    """Gather every rank's published snapshot, polling the store up to
    ``timeout`` seconds for each."""
    return [json.loads(client.get_within(_key(jobid, r), timeout))
            for r in range(nranks)]


def merge(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-rank snapshots -> one shared-timebase record map.

    Every doc's records shift by ``clock.shift_ns(offset, base)``
    (= 0 for the base rank and for unsynced single-rank docs).
    Returns ``{"records": {rank: [...]}, "clock_err_ns": worst
    pairwise comparison error, ...}`` — the input
    ``decompose.analyze`` wants."""
    for doc in docs:
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"not a skew ring dump (schema="
                f"{doc.get('schema')!r}, want {SCHEMA!r})")
    per_rank: Dict[int, List[Dict[str, Any]]] = {}
    errs: List[int] = []
    level = 0
    for doc in docs:
        rank = int(doc["rank"])
        shift = _clock.shift_ns(doc.get("clock_offset_ns"),
                                doc.get("clock_base_ns"))
        errs.append(int(doc.get("clock_err_ns", 0))
                    + int(doc.get("clock_base_err_ns", 0)))
        level = max(level, int(doc.get("level", 0)))
        out = per_rank.setdefault(rank, [])
        for rec in doc.get("records", ()):
            rec = dict(rec)
            rec["t0"] = int(rec["t0"]) + shift
            rec["t1"] = int(rec["t1"]) + shift
            out.append(rec)
    worst_pair = 0
    top = sorted(errs, reverse=True)[:2]
    if len(top) == 2:
        worst_pair = _clock.pair_err_ns(top[0], top[1])
    elif top:
        worst_pair = top[0]
    return {
        "schema": SCHEMA + "+merged",
        "nranks": max([len(per_rank)]
                      + [int(d.get("nranks", 0)) for d in docs]),
        "level": level,
        "clock_err_ns": worst_pair,
        "records": per_rank,
    }


def exchange(sk, client, jobid: str, nranks: int,
             timeout: float = 10.0) -> Optional[Dict[str, Any]]:
    """All ranks publish; rank 0 collects and merges (the
    monitoring/merge rollup shape). Non-zero ranks return None."""
    publish(client, jobid, sk.rank, snapshot_doc(sk))
    if sk.rank != 0:
        return None
    return merge(collect(client, jobid, nranks, timeout))
