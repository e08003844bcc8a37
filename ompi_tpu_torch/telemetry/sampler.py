"""Metrics sampler — periodic pvar snapshots as OpenMetrics text.

The port's copy of ``ompi_tpu.telemetry.sampler``.

The live half of the MPI_T story: the reference exports SPC counters
as MPI_T pvars precisely so external agents can scrape a running job;
here a daemon thread snapshots ``pvar.snapshot()`` every
``telemetry_interval`` seconds and publishes the rendering three ways,
all optional:

- HTTP: ``telemetry_port`` > 0 binds ``127.0.0.1:port+local_rank``
  (one scrape endpoint per rank on a shared host); -1 binds an
  ephemeral port (tests — read it back from ``.http_addr``). 0 (the
  default) serves nothing.
- file: ``telemetry_file`` writes atomically (tmp + rename, so a
  scraper never reads a torn page); ``{rank}`` in the path expands.
- kvstore rollup: ``telemetry_rollup`` puts each snapshot under
  ``telem:pvars:<jobid>:<rank>``; rank 0 appends a job-scope block
  (counters summed, watermarks maxed) to its own page.

Sampler overhead is itself on the pvar plane (telemetry_samples /
telemetry_sample_ns), so any scrape can read the cost of being
watched.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from ompi_tpu_torch.core import cvar, output, pvar
from ompi_tpu_torch.prof import ledger as _prof_ledger
from ompi_tpu_torch.telemetry import flight, openmetrics

_out = output.stream("telemetry")

_interval_var = cvar.register(
    "telemetry_interval", 1.0, float,
    help="Seconds between pvar-snapshot samples of the telemetry "
         "sampler thread.", level=6)
_port_var = cvar.register(
    "telemetry_port", 0, int,
    help="OpenMetrics HTTP endpoint: >0 binds 127.0.0.1:port+"
         "local_rank (/metrics), -1 binds an ephemeral port, "
         "0 disables HTTP (file/rollup export still run).", level=5)
_file_var = cvar.register(
    "telemetry_file", "", str,
    help="Write each OpenMetrics sample to this path (atomic "
         "tmp+rename; '{rank}' expands) — the airgapped-run export.",
    level=6)
_rollup_var = cvar.register(
    "telemetry_rollup", False, bool,
    help="Publish per-rank pvar snapshots through the kvstore and "
         "append a job-level rollup block (counters summed, "
         "watermarks maxed) on rank 0's page.", level=6)

#: kvstore key prefix for the rollup snapshots
ROLLUP_KEY = "telem:pvars"


class Sampler:
    """Daemon thread: sample -> render -> serve/write/publish."""

    def __init__(self, rank: int = 0, jobid: str = "singleton",
                 size: int = 1, interval: Optional[float] = None,
                 port: Optional[int] = None,
                 path: Optional[str] = None,
                 rollup: Optional[bool] = None,
                 client=None) -> None:
        self.rank = rank
        self.jobid = jobid
        self.size = size
        self.interval = (_interval_var.get() if interval is None
                         else float(interval))
        self.port = _port_var.get() if port is None else int(port)
        self.path = _file_var.get() if path is None else path
        self.rollup = (_rollup_var.get() if rollup is None
                       else bool(rollup))
        self._client = client  # injected in tests; else rte's on start
        self.text = ""  # latest rendered exposition (served over HTTP)
        self.http_addr = None  # (host, port) once bound
        self._server = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Sampler":
        if self.rollup and self._client is None:
            from ompi_tpu_torch.runtime import kvstore, rte

            # dedicated store connection: the sampler must never queue
            # behind a blocking RPC on the shared rte client socket
            self._client = kvstore.Client(rte.client().addr)
        if self.port:
            self._serve_http()
        self.sample()  # page is valid before the first interval ticks
        self._thread = threading.Thread(
            target=self._run, name="ompi-tpu-telemetry-sampler",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval + 1)
            self._thread = None
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except Exception:  # noqa: BLE001
                pass
            self._server = None
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample()
            except Exception as exc:  # noqa: BLE001 — sampling must
                # never take the job down
                if self._stop.is_set():
                    return
                _out.verbose(1, "sampler tick failed: %r", exc)

    # -- one sample --------------------------------------------------------
    def sample(self) -> str:
        t0 = time.perf_counter_ns()
        snap = pvar.snapshot()
        fl = flight.FLIGHT
        if fl is not None:
            hb = fl.hb_dict()
            snap["telemetry_seq_entered"] = hb["seq"]
            snap["telemetry_seq_completed"] = hb["done"]
            snap["telemetry_inflight_now"] = hb["inflight"]
        gauges = ("telemetry_seq_entered", "telemetry_seq_completed",
                  "telemetry_inflight_now")
        prof = _prof_ledger.PROFILER
        if prof is not None:
            # rolling achieved bandwidth over the profiler's transfer
            # window — the live "is staging making progress" gauge
            for d in ("h2d", "d2h"):
                bw = prof.rolling_bw_bps(d)
                if bw is not None:
                    snap["prof_xfer_%s_rolling_bps" % d] = int(bw)
                    gauges += ("prof_xfer_%s_rolling_bps" % d,)
        labels = {"rank": str(self.rank), "job": self.jobid}
        text = openmetrics.render(snap, labels, gauges=gauges,
                                  terminate=not self.rollup)
        if self.rollup and self._client is not None:
            text += self._rollup_block(snap)
            text += "# EOF\n"
        self.text = text
        if self.path:
            self._write_file(text)
        pvar.record("telemetry_samples")
        pvar.record("telemetry_sample_ns",
                    time.perf_counter_ns() - t0)
        return text

    def _rollup_block(self, snap: Dict[str, int]) -> str:
        self._client.put(
            f"{ROLLUP_KEY}:{self.jobid}:{self.rank}", snap)
        if self.rank != 0:
            return ""
        snaps = [snap]
        for r in range(1, self.size):
            peer = self._client.get(
                f"{ROLLUP_KEY}:{self.jobid}:{r}", wait=False)
            if peer is not None:
                snaps.append(peer)
        return openmetrics.render(
            openmetrics.aggregate(snaps),
            {"job": self.jobid, "scope": "job",
             "ranks": str(len(snaps))},
            terminate=False)

    def _write_file(self, text: str) -> None:
        path = self.path.replace("{rank}", str(self.rank))
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)

    # -- HTTP --------------------------------------------------------------
    def _serve_http(self) -> None:
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        from ompi_tpu_torch.runtime import rte

        sampler = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server contract
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = sampler.text.encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes stay off stderr
                pass

        port = 0 if self.port < 0 else self.port + rte.local_rank
        self._server = ThreadingHTTPServer(("127.0.0.1", port),
                                           _Handler)
        self._server.daemon_threads = True
        self.http_addr = self._server.server_address
        threading.Thread(target=self._server.serve_forever,
                         name="ompi-tpu-telemetry-http",
                         daemon=True).start()
        _out.verbose(2, "metrics endpoint on http://%s:%d/metrics",
                     *self.http_addr)
