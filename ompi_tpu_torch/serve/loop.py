"""Decode-shaped serving loop: per-request wall timing -> tail latency
(the port of :mod:`ompi_tpu.serve.loop`).

Serving is measured by its tail: each request is one dispatch through a
:class:`~ompi_tpu_torch.serve.dispatch.Dispatcher`, wall-timed until its
output is ready on the device (a synchronise of the output's stream, the
counterpart of ``block_until_ready``), and the percentile summary
(p50 / p95 / p99) is reported next to throughput. Every timed request
feeds ``serve_requests`` on the pvar plane and, with the monitoring plane
on, its latency into the ``[serve]`` table's log2 histogram; per-dispatch
token accounting is the Dispatcher's. With the trace recorder up each
timed request also lands in the ``serve_decode`` log2 latency histogram
(``trace_hist_serve_decode_*``, reference ``loop.py:67-69``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.monitoring import matrix as _mon
from ompi_tpu_torch.trace import recorder as _trace


def _percentile(sorted_ns, q: float) -> float:
    """Nearest-rank percentile in milliseconds over sorted ns."""
    if not len(sorted_ns):
        return 0.0
    i = min(len(sorted_ns) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_ns) - 1)))))
    return float(sorted_ns[i]) / 1e6


def _ready(out) -> None:
    """Wait until ``out`` is computed: a CUDA tensor's stream
    synchronised; a host value is ready."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
    else:
        np.asarray(out)


def run_decode(dispatcher, traffic, *, n_requests: int = 32,
               tokens_per_request: int = 32, warmup: int = 2,
               on_request=None) -> dict:
    """Drive ``n_requests`` decode-shaped requests (after ``warmup``
    untimed ones); return the tail summary. ``on_request(i, info,
    lat_ns)`` (optional) observes each timed request."""
    lat_ns = []
    agg = {"tokens": 0, "kept": 0, "dropped": 0, "rerouted": 0,
           "dcn_tokens": 0, "dcn_bytes": 0}
    counts: Optional[np.ndarray] = None
    for i in range(warmup + n_requests):
        _ids, x = traffic.request(tokens_per_request)
        t0 = time.perf_counter_ns()
        out, info = dispatcher(x)
        _ready(out)
        dt = time.perf_counter_ns() - t0
        if i < warmup:
            continue
        lat_ns.append(dt)
        pvar.record("serve_requests")
        for k in agg:
            agg[k] += int(info.get(k, 0))
        c = np.asarray(info["counts"], dtype=np.int64)
        counts = c if counts is None else counts + c
        rec = _trace.RECORDER
        if rec is not None:
            _trace.hist("serve_decode", x.nbytes, dt)
        tm = _mon.TRAFFIC
        if tm is not None:
            tm.serve_event(info["policy"], requests=1, lat_ns=dt)
        if on_request is not None:
            on_request(i - warmup, info, dt)
    lat = np.sort(np.asarray(lat_ns, dtype=np.int64))
    total_s = float(lat.sum()) / 1e9 if len(lat) else 0.0
    counts = (counts if counts is not None
              else np.zeros(0, dtype=np.int64))
    hot = int(np.argmax(counts)) if counts.size else -1
    hot_share = (float(counts[hot]) / max(int(counts.sum()), 1)
                 if counts.size else 0.0)
    return {
        "policy": dispatcher.policy,
        "requests": int(len(lat)),
        "tokens": agg["tokens"],
        "kept": agg["kept"],
        "dropped": agg["dropped"],
        "rerouted": agg["rerouted"],
        "dcn_tokens": agg["dcn_tokens"],
        "dcn_bytes": agg["dcn_bytes"],
        "drop_rate": agg["dropped"] / max(agg["tokens"], 1),
        "p50_ms": _percentile(lat, 50.0),
        "p95_ms": _percentile(lat, 95.0),
        "p99_ms": _percentile(lat, 99.0),
        "tokens_per_s": (agg["tokens"] / total_s) if total_s else 0.0,
        "expert_counts": [int(c) for c in counts],
        "hot_expert": hot,
        "hot_share": hot_share,
    }
