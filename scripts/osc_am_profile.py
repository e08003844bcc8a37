"""Where a rank's host time goes on the one-sided active-message plane.

Runs ``ompi_tpu_torch/examples/osc_passive.py`` under ``cProfile`` on
every rank of a launcher job and prints, for the ranks named by
``--show`` (default rank 0), the functions that hold the most time (own
and cumulative) and the calls of the AM path: the origin verbs, the
target's service loop (``_progress``, ``_handle``, the re-posted service
receive), ob1's object channel, the progress sweeps and the kernels'
wrappers. Run it like the example, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca osc_cuda on scripts/osc_am_profile.py --out DIR [example args]

(``--mca device_plane_platform cpu --tiny`` on a machine without a card).
Each rank writes ``DIR/rank<r>.prof`` (``pstats``) beside the example's
``DIR/rank<r>.json``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the AM path's functions, as pstats restrictions
AM_CALLS = (r"osc/__init__.py.*\((Put|Put_strided|Accumulate|Get|_rget|"
            r"Flush|Flush_all|Lock|Unlock|_progress|_handle|_send|"
            r"_post_service_recv)\)|osc/cuda.py.*\((_apply_local|"
            r"_target_view|_from_wire|Accumulate|Get)\)|ob1.py.*\("
            r"(send_obj|irecv_obj|recv_obj|isend|_finish_recv)\)|"
            r"progress.py.*\((progress|wait_until)\)|cuda_kernels.py.*\("
            r"(rma_apply|rma_read|rma_apply_strided)\)|sleep")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--show", default="0",
                    help="comma-separated ranks whose profile is printed")
    ap.add_argument("--top", type=int, default=20)
    ns, rest = ap.parse_known_args()
    sys.path.insert(0, ROOT)
    from ompi_tpu_torch.examples import osc_passive

    rank = int(os.environ.get("OMPI_TPU_RANK", "0"))
    prof = cProfile.Profile()
    prof.enable()
    try:
        osc_passive.main([*rest, "--out", ns.out])
    finally:
        prof.disable()
        os.makedirs(ns.out, exist_ok=True)
        prof.dump_stats(os.path.join(ns.out, f"rank{rank}.prof"))
    if str(rank) in ns.show.split(","):
        buf = io.StringIO()
        st = pstats.Stats(prof, stream=buf)
        st.sort_stats("tottime").print_stats(ns.top)
        st.sort_stats("cumulative").print_stats(AM_CALLS)
        print(f"--- rank {rank} profile ---\n{buf.getvalue()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
