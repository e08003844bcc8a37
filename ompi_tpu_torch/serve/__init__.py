"""serve/ — the production-skew MoE serving plane (the port of
:mod:`ompi_tpu.serve`).

Latency-shaped decode traffic where a Zipf-skewed token -> expert
distribution makes hot experts overflow their capacity, served over the
EP Alltoall path (:mod:`ompi_tpu_torch.ops.moe`, coll/device's
``alltoall_dev`` / ``alltoallv_dev``, K2's pull schedule on the card):

- :mod:`.dispatch` — the capacity-factor policies ``drop`` (bitwise
  ``moe_ffn``, metered), ``reroute`` (overflow to the least-loaded
  experts, token-conserving) and ``dcn_overflow`` (overflow to the next
  slice's replica over coll/hier's DCN level, budget-bounded);
- :mod:`.traffic` — a seeded Zipf token -> expert generator with a
  hotness dial, whose tokens' router argmax is the drawn expert;
- :mod:`.loop` — the decode latency harness: per-request wall time,
  p50 / p95 / p99 next to throughput, fed into the ``serve_*`` pvars and
  the monitoring report's ``[serve]`` section.
"""

from ompi_tpu_torch.serve.dispatch import POLICIES, Dispatcher, routed_ffn
from ompi_tpu_torch.serve.loop import run_decode
from ompi_tpu_torch.serve.traffic import ZipfTraffic

__all__ = ["POLICIES", "Dispatcher", "ZipfTraffic", "routed_ffn",
           "run_decode"]
