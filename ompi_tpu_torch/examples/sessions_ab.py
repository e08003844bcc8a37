"""A session comm's device Allreduce against COMM_WORLD's, in turns, on one
card.

Runs 4-rank jobs of ``ompi_tpu_torch/examples/device_collectives.py``
(the 256 MiB float32 Allreduce under 'ring' and 'linear' on COMM_WORLD)
and of ``ompi_tpu_torch/examples/sessions.py --device`` (the same payload
on a comm built from a session's ``mpi://WORLD``, with no COMM_WORLD),
both under coll/cuda, in the order world, session, session, world for
each of ``--rounds``, and prints every job's rank-0 p50 per mode, then
the median of each side's p50s. Each job checks its results (bitwise)
as ``chip_smoke.py`` does, and fails the script if one does not hold.

    python3 ompi_tpu_torch/examples/sessions_ab.py [--rounds 2]

(from the repository root, on a machine with a GPU: it drives the jobs
through ``chip_smoke.py``'s ``main_path``).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def world(card: str) -> dict:
    _, doc = cs.main_path("device_collectives.py", cs.N_RANKS,
                          ["--sizes", "256m", "--kinds", "allreduce",
                           "--dtype-bytes", "1m"], card, ROOT)
    return {c["mode"]: c["p50_ms"] for c in doc["cases"]
            if c.get("kind") == "Allreduce" and c.get("dtype") == "float32"
            and c.get("bytes") == cs.MAIN_BYTES}


def session(card: str) -> dict:
    _, doc = cs.main_path("sessions.py", cs.N_RANKS, ["--device"], card,
                          ROOT, "coll_cuda", cs.SESSION_MCA)
    return doc["report"]["allreduce_f32"]["p50_ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ns = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("no GPU")
    card = cs.card_line()
    got = {"world": [], "session": []}
    for _ in range(ns.rounds):
        for side in ("world", "session", "session", "world"):
            p50 = (world if side == "world" else session)(card)
            got[side].append(p50)
            print(f"sessions_ab {side}: ring {p50['ring']:.3f} ms, linear "
                  f"{p50['linear']:.3f} ms [{card}]", flush=True)
    for side, rows in got.items():
        meds = ", ".join(f"{m} {statistics.median(r[m] for r in rows):.3f} ms"
                         for m in ("ring", "linear"))
        print(f"sessions_ab {side} median of {len(rows)} jobs' p50: {meds} "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
