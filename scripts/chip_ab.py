"""chip_ab.py — the PyTorch port's main paths on two trees, in turns.

Runs the 4-rank collectives, training, halo and embedding paths of
``ompi_tpu_torch/examples/`` (as ``chip_smoke.py`` runs them) from two
checkouts — a parent tree and this one — in the order parent, change,
change, parent, so that two versions are compared inside one call on one
card. Each tree builds its own kernels first (its ``build/``), outside
the timed jobs. Run from the repository root on a machine with a CUDA
card::

    git archive <parent> | tar -x -C build/parent
    python3 scripts/chip_ab.py --parent build/parent [--out DIR]

Prints one line per run: the float32 Allreduce p50 per size and mode,
the Reduce_scatter_block and Allgather p50s (``device_collectives.py``,
5 calls each), the ZeRO step p50 per mode and the
``allgather_matmul_dev`` p50 per dtype (rank 0, ``zero_training.py``),
the halo path's fences after the first pair (``halo_exchange.py``) and
the embedding path's lookup and update fences (``embedding_table.py``),
with their rounds and exchanges, each with the card's name and power
limit; ``--out`` also gets the
numbers as JSON. ``--cpu`` rehearses the same runs at tiny widths on the
CPU (no times worth reading).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

N_RANKS = 4
JOB_TIMEOUT = 300  # seconds per launcher job
#: (example, its arguments at full size, at --cpu, the component to enable)
JOBS = (("device_collectives.py", ["--iters", "5"],
         ["--sizes", "1k,64k", "--dtype-bytes", "4k", "--rsag-bytes", "12k",
          "--iters", "2"], "coll_cuda"),
        ("zero_training.py", [], ["--tiny", "--layers", "2"], "coll_cuda"),
        ("halo_exchange.py", [], ["--tiny"], "osc_cuda"),
        ("embedding_table.py", [], ["--tiny"], "osc_cuda"))


def card_line(cpu: bool) -> str:
    if cpu:
        return "cpu rehearsal"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def prebuild(tree: str) -> None:
    """Build every kernel source of the tree into its own build dir."""
    code = ("import glob; from ompi_tpu_torch.coll import cuda_kernels as K\n"
            "for s in sorted(glob.glob('ompi_tpu_torch/*/csrc/*.cu')):\n"
            "    K.build(s)\n")
    subprocess.run([sys.executable, "-c", code], cwd=tree, check=True)


def run_job(tree: str, example: str, args, component: str,
            cpu: bool) -> dict:
    """One launcher job of the tree's example; rank 0's report."""
    out = tempfile.mkdtemp(prefix="ab_")
    try:
        cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
               "-n", str(N_RANKS), "--timeout", str(JOB_TIMEOUT),
               "--mca", "device_plane", "on", "--mca", component, "on"]
        if cpu:
            cmd += ["--mca", "device_plane_platform", "cpu"]
        cmd += [os.path.join("ompi_tpu_torch", "examples", example), *args,
                "--out", out]
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                              timeout=JOB_TIMEOUT + 30)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
            raise SystemExit(f"{tree}: {example} exited {proc.returncode}")
        with open(os.path.join(out, "rank0.json")) as f:
            doc = json.load(f)
        if not all(c["ok"] for c in doc["cases"]):
            raise SystemExit(f"{tree}: {example}: a check failed")
        return doc
    finally:
        shutil.rmtree(out, ignore_errors=True)


def summary(docs) -> dict:
    coll, zero, halo, emb = docs
    return {
        "collectives_p50_ms": {
            f"{c['kind']} {c['bytes']} {c['mode']}": c["p50_ms"]
            for c in coll["cases"] if c["dtype"] == "float32"},
        "step_p50_ms": {m: v["p50"] for m, v in zero["step_ms"].items()},
        "allgather_matmul_p50_ms": zero["allgather_matmul_ms"],
        # the first halo and tile fences map the arenas: steady ones only
        "halo_fence_ms": halo["fence_ms"][2::2],
        "tile_fence_ms": halo["fence_ms"][3::2],
        "embedding_fence_ms": emb["fence_ms"],
        # rounds and exchanges per fence (a parent tree may predate the
        # exchanges: one host step per round)
        "halo_rounds": halo["rounds"][2:],
        "halo_exchanges": halo.get("exchanges", halo["rounds"])[2:],
        "embedding_rounds": emb["rounds"],
        "embedding_exchanges": emb.get("exchanges", emb["rounds"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the parent tree (e.g. a git archive)")
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at tiny widths")
    ns = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(ns.parent), "change": here}
    if not glob.glob(os.path.join(trees["parent"], "ompi_tpu_torch")):
        raise SystemExit(f"{ns.parent}: no ompi_tpu_torch package")
    card = card_line(ns.cpu)
    if not ns.cpu:
        for tree in trees.values():
            prebuild(tree)
    runs = []
    for label in ("parent", "change", "change", "parent"):
        docs = [run_job(trees[label], ex, cpu_args if ns.cpu else args,
                        comp, ns.cpu)
                for ex, args, cpu_args, comp in JOBS]
        runs.append({"tree": label, **summary(docs)})
        print(f"ab {len(runs)} {label}: {json.dumps(runs[-1])} [{card}]",
              flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, "chip_ab.json"), "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
