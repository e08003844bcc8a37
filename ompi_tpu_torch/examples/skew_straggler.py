"""skew/ — cross-rank straggler attribution, end to end (the port's
``examples/skew_straggler.py``).

One rank is made deterministically slow (``elastic_inject_delay_*``
sleeps before each step's collectives — the non-fatal sibling of the
elastic kill injection), every rank runs the same
allreduce+barrier step loop, and the skew plane must attribute the
resulting lateness: fast ranks accumulate exposed wait (time blocked
on the straggler), the slow rank accumulates almost none, the
Finalize merge walks the critical path through the slow rank, and
rank 0 prints the ``PERSISTENT STRAGGLER: rank N ...`` verdict (the
smoke lane's grep target). At ``skew_level=2`` with telemetry on,
the watchdog additionally names the slow rank LIVE (heartbeat
last-arrival stamps -> ``skew_live_lag_ns``, hang dumps with
``skew`` context + per-rank ``arrivals`` lateness).

The step's Allreduce takes a tensor on the device plane's device when
the plane is on (a CUDA tensor on the card, a CPU tensor under
``device_plane_platform cpu``), else a numpy buffer.

Run:  python -m ompi_tpu_torch.runtime.launcher -n 4 \
          --mca skew_level 2 \
          --mca skew_dump '/tmp/skew_r{rank}.json' \
          --mca elastic_inject_delay_rank 3 \
          --mca elastic_inject_delay_s 0.6 \
          --mca elastic_inject_delay_step 1 \
          ompi_tpu_torch/examples/skew_straggler.py

Then render the offline report:
      python -m ompi_tpu_torch.skew report /tmp/skew_r*.json

Set OMPI_TPU_SKEW_ARTIFACT=<path> for a JSON summary (the CI smoke
lane uploads it).
"""

import json
import os

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.elastic import inject
from ompi_tpu_torch.runtime import device_plane

STEPS = 6

comm = mpi.Init()
rank, size = comm.rank, comm.size

delay_rank = int(cvar.get("elastic_inject_delay_rank"))
delay_s = float(cvar.get("elastic_inject_delay_s"))
delay_step = int(cvar.get("elastic_inject_delay_step"))

if device_plane.active():
    buf = torch.ones(4096, device=device_plane.device())
else:
    buf = np.ones(4096, np.float32)
out = np.empty(4096, np.float32)
for step in range(STEPS):
    inject.maybe_delay(step)  # the deterministic straggler
    if isinstance(buf, torch.Tensor):
        got = comm.Allreduce(buf)
        assert float(got[0]) == size, got[0]
    else:
        comm.Allreduce(buf, out)
        assert out[0] == size, out[0]
    comm.Barrier()

# ring filled while the plane was up (3 collectives interposed per
# step would be 2*STEPS at minimum; exact count depends on layer)
recorded = pvar.read("skew_records")
assert recorded >= 2 * STEPS, \
    f"skew ring recorded only {recorded} collectives"
delays = pvar.read("elastic_injected_delays")
if rank == delay_rank and 0 <= delay_step < STEPS:
    assert delays == STEPS - delay_step, \
        f"injected straggler fired {delays} times"

mpi.Finalize()  # skew rings merge; rank 0 prints the verdict

# post-Finalize: the merged decomposition folded each rank's OWN
# exposed wait into the pvar plane — fast ranks paid the straggler
# tax, the straggler itself (last to arrive) paid ~none
wait_ns = pvar.read("skew_exposed_wait_ns")
injected_ns = int(delay_s * 1e9) * max(0, STEPS - max(delay_step, 0))
if 0 <= delay_rank < size and injected_ns > 0:
    if rank == delay_rank:
        assert wait_ns < injected_ns // 2, \
            f"straggler rank charged {wait_ns}ns of exposed wait"
    else:
        assert wait_ns > injected_ns // 3, \
            f"fast rank {rank} only {wait_ns}ns exposed wait " \
            f"(injected {injected_ns}ns)"

summary = {
    "rank": rank,
    "ranks": size,
    "steps": STEPS,
    "skew_records": recorded,
    "skew_dropped": pvar.read("skew_dropped"),
    "exposed_wait_ns": wait_ns,
    "worst_arrival_skew_ns": pvar.read("skew_arrival_skew_ns"),
    "live_lag_ns": pvar.read("skew_live_lag_ns"),
    "stragglers_named": pvar.read("skew_stragglers"),
    "injected_delays": delays,
}
art = os.environ.get("OMPI_TPU_SKEW_ARTIFACT")
if art and rank == 0:
    with open(art, "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=1)
if rank == 0:
    print(f"skew attribution over {size} ranks: {recorded} collectives "
          f"recorded, exposed wait {wait_ns / 1e9:.2f}s on rank 0, "
          f"{summary['stragglers_named']} persistent straggler(s) named")
