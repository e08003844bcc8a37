"""tune/ — the in-band collective performance observatory (the port's
``examples/tune_observe.py``).

With ``tune_observe=1`` every served device-collective launch is timed
and keyed ``(op, dtype, log2-size, mesh, provider, algorithm)`` — the
provider being whichever backend actually served after fallthrough. At
Finalize each rank dumps its PerfDB doc (``tune_dump``), the ranks merge
through the store, and rank 0 folds the run into the persistent
per-``(device_kind, world size)`` DB (``tune_db_dir``), which later runs
read as the regression baseline. The default part drives mixed-provider
traffic under ``coll_cuda on``:

- float32 Allreduce — coll/cuda owns the slot, so samples land under
  provider ``cuda``; the same buffer through coll/device's slot directly
  gives the *same key* under provider ``device``, so the report can name
  a measured cuda-vs-device crossover;
- int16 Allreduce — outside the kernels' dtypes, coll/cuda falls through
  to coll/device and the sample goes to the backend that *served*;
- Bcast — a slot coll/cuda does not have, more provider-``device``
  traffic;
- correctness is asserted alongside (observation must not perturb).

``--table PATH`` reads a candidate table back instead (the one ``python
-m ompi_tpu_torch.tune report --tables PREFIX`` writes as
``PREFIX_cuda.json``, given to the job as ``--mca coll_cuda_switchpoints
PATH``): ``--calls`` float32 SUM Allreduces of ``--bytes`` with no
deterministic mode, so the table decides; checks ``tune_table_errors``
0, every result bitwise the fold of the algorithm the table names
(``xla``: coll/device's ring), and that algorithm the one that ran
(``coll_cuda_<algorithm>_bytes``, or ``coll_cuda_fallthrough`` for
``xla``, grew by every call's bytes or calls).

Run::

    python -m ompi_tpu_torch.runtime.launcher -n 2 \\
        --mca device_plane on --mca coll_cuda on --mca tune_observe 1 \\
        --mca tune_dump '/tmp/tune_r{rank}.json' --mca tune_db_dir /tmp/db \\
        ompi_tpu_torch/examples/tune_observe.py
    python -m ompi_tpu_torch.tune report /tmp/tune_r*.json

Add ``--mca device_plane_platform cpu`` without a GPU. ``--out DIR``
writes ``rank<r>.json`` (``cases``, ``launches``, ``p50_ms``).
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.coll import cuda as coll_cuda
from ompi_tpu_torch.coll import device as coll_device
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.examples import kernel_counts as KC
from ompi_tpu_torch.examples.device_collectives import (bits_equal,
                                                        expected_allreduce)
from ompi_tpu_torch.runtime import device_plane


def _size(text: str) -> int:
    text = text.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(text[-1:], 1)
    return int(text.rstrip("kmg")) * mult


def mixed(comm, dev, case) -> dict:
    """The reference example's traffic; returns the observed counts."""
    n, r = comm.size, comm.rank
    case("coll/cuda serves allreduce_dev",
         comm.coll.providers.get("allreduce_dev") == "cuda")
    s = pvar.session()
    rng = np.random.default_rng(23)
    host = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    x = host.to(dev)
    ref = host * n
    ok = True
    for _ in range(3):
        got = comm.coll.allreduce_dev(comm, x).cpu()
        ok = ok and torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
        got = coll_device.allreduce_dev(comm, x).cpu()
        ok = ok and torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
    case("observed float32 allreduces", ok)
    xi = torch.from_numpy((np.arange(64) % 9 + r).astype(np.int16)).to(dev)
    got = comm.coll.allreduce_dev(comm, xi).cpu().numpy()
    want = sum((np.arange(64) % 9 + p).astype(np.int16) for p in range(n))
    case("int16 falls through and is observed", np.array_equal(got, want))
    b = torch.from_numpy(np.arange(512, dtype=np.int32) * (r == 0)).to(dev)
    ok = True
    for _ in range(3):
        got = comm.coll.bcast_dev(comm, b, 0).cpu().numpy()
        ok = ok and np.array_equal(got, np.arange(512, dtype=np.int32))
    case("observed bcasts", ok)
    got = {k: s.read(k) for k in (
        "tune_obs_allreduce_cuda", "tune_obs_allreduce_device",
        "tune_obs_bcast_device", "tune_samples", "coll_cuda_fallthrough")}
    case("every launch attributed to its serving provider",
         got["tune_obs_allreduce_cuda"] == 3
         and got["tune_obs_allreduce_device"] == 4
         and got["tune_obs_bcast_device"] == 3
         and got["coll_cuda_fallthrough"] >= 1
         and got["tune_samples"] >= 10, **got)
    return got


def table_part(comm, dev, ns, case, report) -> None:
    """The candidate table read back: the algorithm it names runs."""
    n, r = comm.size, comm.rank
    with open(ns.table) as f:
        entries = json.load(f)
    numel = _size(ns.bytes) // 4
    nbytes = numel * 4
    lg = coll_cuda.log2_bucket(nbytes)
    rules = sorted((e["log2"], e["algorithm"]) for e in entries
                   if e["op"] == "allreduce" and e["dtype"] == "float32"
                   and list(e["mesh"]) == [n] and e["log2"] <= lg)
    named = rules[-1][1] if rules else ""
    case("the table names an algorithm at this size", bool(named),
         named=named)
    xs = [torch.randn(numel, generator=torch.Generator(device=dev)
                      .manual_seed(ns.seed * 1000003 + p), device=dev)
          for p in range(n)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    counts = KC.Counts(dev)
    s = pvar.session()
    counts.reset()
    first, same, times = None, True, []
    for _ in range(ns.calls):
        sync()
        t0 = time.perf_counter()
        out = comm.Allreduce(xs[r])
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        first = out if first is None else first
        same = same and bits_equal(out, first)
    ran = {"linear": s.read("coll_cuda_linear_bytes") // nbytes,
           "ring": s.read("coll_cuda_ring_bytes") // nbytes,
           "bidir": s.read("coll_cuda_bidir_bytes") // nbytes,
           "xla": s.read("coll_cuda_fallthrough")}
    case("tune_table_errors == 0", pvar.read("tune_table_errors") == 0)
    case("the algorithm the table names ran every call",
         ran.get(named) == ns.calls
         and sum(ran.values()) == ns.calls, ran=ran)
    fold = "ring" if named == "xla" else named
    case(f"every call bitwise the {fold} fold",
         same and bits_equal(first, expected_allreduce(xs, "MPI_SUM", fold,
                                                       n)))
    report["named"] = named
    report["ran"] = ran
    report["launches"] = counts.read()
    report["p50_ms"] = sorted(times)[len(times) // 2]
    report["bytes"] = nbytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--table", default="")
    ap.add_argument("--bytes", default="256m")
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    comm = mpi.Init()
    r = comm.rank
    dev = device_plane.device()
    cases: list = []
    report: dict = {"rank": r, "device": str(dev)}

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[tune_observe n={comm.size}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    if ns.table:
        table_part(comm, dev, ns, case, report)
    else:
        report["observed"] = mixed(comm, dev, case)
    report["cases"] = cases
    report["coll_accelerator_staged"] = pvar.read("coll_accelerator_staged")
    report.setdefault("launches", {})
    report["required"] = []
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump(report, f)
    mpi.Finalize()
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    raise SystemExit(main())
