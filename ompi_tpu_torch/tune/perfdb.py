"""PerfDB — the persistent collective performance database.

The coll/tuned analogue of a measured dynamic-rules file: observer
stats (:class:`ompi_tpu_torch.tune.observe.Observer` snapshots) serialize
to a JSON doc keyed ``(op, dtype, log2-size, mesh, provider,
algorithm)`` with the associative record ``[count, sum_ns, min_ns,
max_ns, {log2-latency-bin: n}]``, and because every component merges
associatively — counts/sums add, min/max fold, histograms add —
docs combine across ranks (kvstore exchange, the
``monitoring/merge.py`` publish/collect shape) and across **runs**
(rank 0 folds the fresh merge into the on-disk DB at Finalize), so
measurements accumulate instead of dying with the process.

The DB lives alongside the compile cache (``tune_db_dir``, default
``compile_cache_dir``), one file per ``(device_kind, world size)``:
``tune_perfdb_<device_kind>_n<nranks>.json``. Loading is failure-
proof by contract: a corrupt/alien file degrades to an empty DB with
``tune_db_errors`` bumped — never an exception at init.

Schema ``ompi_tpu.tune.perfdb/1``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from ompi_tpu_torch.core import output, pvar

_out = output.stream("tune")

SCHEMA = "ompi_tpu.tune.perfdb/1"

#: in-memory stats key (the observe.Observer key)
Key = Tuple[str, str, int, Tuple[int, ...], str, str]


def entries_of(stats: Dict[Key, list]) -> List[Dict[str, object]]:
    """Stats table -> sorted JSON-able entry list."""
    return [
        {"op": op, "dtype": dt, "log2": lg, "mesh": list(mesh),
         "provider": prov, "algorithm": algo,
         "count": rec[0], "sum_ns": rec[1],
         "min_ns": rec[2], "max_ns": rec[3],
         "hist": {str(b): c for b, c in sorted(rec[4].items())}}
        for (op, dt, lg, mesh, prov, algo), rec in
        sorted(stats.items())]


def stats_of(entries: List[Dict[str, object]]) -> Dict[Key, list]:
    """Entry list -> stats table (inverse of :func:`entries_of`)."""
    stats: Dict[Key, list] = {}
    for e in entries:
        key = (str(e["op"]), str(e["dtype"]), int(e["log2"]),
               tuple(int(d) for d in e["mesh"]),
               str(e["provider"]), str(e["algorithm"]))
        rec = stats.get(key)
        if rec is None:
            rec = stats[key] = [0, 0, None, 0, {}]
        rec[0] += int(e["count"])
        rec[1] += int(e["sum_ns"])
        mn = int(e["min_ns"])
        rec[2] = mn if rec[2] is None else min(rec[2], mn)
        rec[3] = max(rec[3], int(e["max_ns"]))
        for b, c in dict(e.get("hist", {})).items():
            rec[4][int(b)] = rec[4].get(int(b), 0) + int(c)
    for rec in stats.values():
        if rec[2] is None:
            rec[2] = 0
    return stats


def doc_of(stats: Dict[Key, list], device_kind: str = "",
           nranks: int = 0, runs: int = 1) -> Dict[str, object]:
    return {
        "schema": SCHEMA,
        "device_kind": device_kind,
        "nranks": int(nranks),
        "runs": int(runs),
        "entries": entries_of(stats),
    }


def db_path(dirpath: str, device_kind: str, nranks: int) -> str:
    kind = "".join(c if (c.isalnum() or c in "-_") else "_"
                   for c in (device_kind or "unknown"))
    return os.path.join(dirpath, f"tune_perfdb_{kind}_n{nranks}.json")


def load(path: str) -> Dict[str, object]:
    """Load a PerfDB doc; NEVER raises — a missing file is an empty
    DB, a corrupt/alien one degrades to empty with ``tune_db_errors``
    bumped (init must not die on a stale cache dir)."""
    if not path or not os.path.exists(path):
        return doc_of({}, runs=0)
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("schema") != SCHEMA:
            raise ValueError(f"schema {doc.get('schema')!r}, "
                             f"want {SCHEMA!r}")
        stats_of(doc.get("entries", []))  # validate entry shapes
    except (OSError, ValueError, KeyError, TypeError) as exc:
        pvar.record("tune_db_errors")
        _out.verbose(0, "WARNING: perfdb %s unreadable (%s) — "
                        "starting from an empty database", path, exc)
        return doc_of({}, runs=0)
    pvar.record("tune_db_loads")
    return doc


def save(path: str, doc: Dict[str, object]) -> bool:
    """Atomic write (tmp + rename); False on OSError, never raises."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as exc:
        pvar.record("tune_db_errors")
        _out.verbose(0, "WARNING: perfdb save to %s failed: %s",
                     path, exc)
        return False
    pvar.record("tune_db_saves")
    return True


def merge(docs: List[Dict[str, object]]) -> Dict[str, object]:
    """Fold PerfDB docs into one — associative and commutative in
    every component, so rank order and run order don't matter."""
    for doc in docs:
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"not a tune perfdb doc (schema="
                f"{doc.get('schema')!r}, want {SCHEMA!r})")
    stats: Dict[Key, list] = {}
    for doc in docs:
        for key, rec in stats_of(doc.get("entries", [])).items():
            got = stats.get(key)
            if got is None:
                stats[key] = [rec[0], rec[1], rec[2], rec[3],
                              dict(rec[4])]
                continue
            got[0] += rec[0]
            got[1] += rec[1]
            got[2] = min(got[2], rec[2])
            got[3] = max(got[3], rec[3])
            for b, c in rec[4].items():
                got[4][b] = got[4].get(b, 0) + c
    device_kind = next((d["device_kind"] for d in docs
                        if d.get("device_kind")), "")
    nranks = max([int(d.get("nranks", 0)) for d in docs] + [0])
    runs = sum(int(d.get("runs", 1)) for d in docs)
    return doc_of(stats, device_kind=device_kind, nranks=nranks,
                  runs=runs)


# -- cross-rank kvstore exchange (the monitoring/merge.py shape) ----------

def _key(jobid: str, rank: int) -> str:
    return f"tune:db:{jobid}:{rank}"


def publish(client, jobid: str, rank: int,
            doc: Dict[str, object]) -> None:
    client.put(_key(jobid, rank), json.dumps(doc))


def collect(client, jobid: str, nranks: int,
            timeout: float = 10.0) -> List[Dict[str, object]]:
    """Gather every rank's published doc, polling the store up to
    ``timeout`` seconds for each."""
    return [json.loads(client.get_within(_key(jobid, r), timeout))
            for r in range(nranks)]


def exchange(doc: Dict[str, object], client, jobid: str, rank: int,
             nranks: int,
             timeout: float = 10.0) -> Optional[Dict[str, object]]:
    """All ranks publish; rank 0 collects and merges (the telemetry
    rollup shape). Non-zero ranks return None."""
    publish(client, jobid, rank, doc)
    if rank != 0:
        return None
    return merge(collect(client, jobid, nranks, timeout))
