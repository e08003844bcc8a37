"""Telemetry plane — live observability over the MPI_T planes.

The port's copy of ``ompi_tpu.telemetry``. Three cooperating pieces,
all opt-in via ``telemetry_enable`` (or the short ``OMPI_TPU_TELEMETRY``
env knob) and brought up by the instance init engine
(runtime.state.init_instance):

- :mod:`flight` — the collective flight recorder: every coll/device,
  coll/cuda, partitioned, and API-level collective entry lands in a small
  in-flight table, and the rank's latest seq rides the kvstore
  heartbeat payload (ft.detector piggybacks it; the watchdog publishes
  it on its own sweep too).
- :mod:`sampler` — periodic pvar snapshots rendered as OpenMetrics
  text: HTTP endpoint (``telemetry_port``), atomic file export
  (``telemetry_file``), optional kvstore job rollup
  (``telemetry_rollup``).
- :mod:`watchdog` — detects a collective stuck past
  ``telemetry_hang_timeout``, diffs seqs across ranks to name the
  straggler(s), and fires dump-on-hang (JSON dump + ``telemetry_hang``
  event + optional abort via ``telemetry_hang_action``).

Disabled (the default), the collective hot paths pay one attribute
load + one branch per entry (``flight.FLIGHT is None`` — the trace
recorder's guard discipline), and nothing else exists.
"""

from __future__ import annotations

import os

from ompi_tpu_torch.core import cvar

_enable_var = cvar.register(
    "telemetry_enable", False, bool,
    help="Enable the telemetry plane at instance init: collective "
         "flight recorder + metrics sampler + hang watchdog "
         "(equivalently: any truthy OMPI_TPU_TELEMETRY env value).",
    level=5)

_sampler = None
_watchdog = None


def requested() -> bool:
    """cvar telemetry_enable (incl. OMPI_TPU_TELEMETRY_ENABLE env) or
    the short-form OMPI_TPU_TELEMETRY env knob."""
    if _enable_var.get():
        return True
    raw = os.environ.get("OMPI_TPU_TELEMETRY", "").strip().lower()
    return raw not in ("", "0", "false", "no", "off")


def start(rank: int = 0) -> None:
    """Bring the plane up (idempotent): flight recorder + API hook,
    sampler thread, watchdog thread (unless telemetry_hang_timeout
    is 0)."""
    global _sampler, _watchdog
    from ompi_tpu_torch.runtime import rte
    from ompi_tpu_torch.telemetry import flight, sampler, watchdog

    flight.enable(rank=rank)
    if _sampler is None:
        _sampler = sampler.Sampler(rank=rank, jobid=rte.jobid,
                                   size=rte.size).start()
    if _watchdog is None and watchdog._timeout_var.get() > 0:
        _watchdog = watchdog.Watchdog(rank=rank,
                                      jobid=rte.jobid).start()


def stop() -> None:
    """Tear the plane down (idempotent; threads first, guard last so
    instrumented sites never observe a half-stopped plane)."""
    global _sampler, _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None
    if _sampler is not None:
        _sampler.stop()
        _sampler = None
    from ompi_tpu_torch.telemetry import flight

    flight.disable()


def get_sampler():
    return _sampler


def get_watchdog():
    return _watchdog
