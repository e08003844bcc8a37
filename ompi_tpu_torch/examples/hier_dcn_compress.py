"""coll/hier's compressed DCN wire formats — bf16 and fp8 cast-compress —
checked and timed.

Run under the launcher on a 2 x 2 grid::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on --mca coll_hier on --mca coll_hier_split 2x2 \\
        --mca coll_hier_inner ring ompi_tpu_torch/examples/hier_dcn_compress.py

The split-level Allreduce puts payload/ici_size bytes on the DCN level;
``coll_hier_dcn_dtype`` shrinks that further by moving the DCN phase in a
narrow wire dtype (a gather in the wire dtype, then a local upcast and
sum; fp8 first agrees a per-launch scale with an Allreduce MAX over the
``up`` comm). A float32 SUM Allreduce of ``--bytes`` (256 MiB; positive
seeded values spanning five decades) runs with the cvar at ``off``,
``bf16``, ``fp8_e4m3`` and ``fp8_e5m2`` in turns, one warm and ``--reps``
timed calls of each, and checks:

- ``off`` is bitwise the exact split-level result, before and after the
  toggles, and moves its nominal DCN bytes (``hier_dcn_wire_bytes`` ==
  ``hier_dcn_bytes``);
- ``bf16`` moves at most 1/2 and fp8 at most 1/4 of the nominal DCN bytes,
  and each compressed result is within the JAX package example's bounds
  of the exact one (rtol 0.02 bf16, 0.35 fp8; atol 0.1); the worst
  element error is reported in units of the wire's epsilon times the
  element's exact magnitude;
- ``deterministic='linear'`` ignores the cvar (wire bytes == nominal);
- toggling maps no new arena once each wire has run;
- error feedback: SGD on a two-parameter quadratic whose gradients go
  through :class:`~ompi_tpu_torch.zero.layout.ErrorFeedback` ends within
  1e-2 of the exact run's loss (the JAX package example's bound).

The part's K1-K3 counts are zeroed just before it and read just after,
and must equal what the schedules imply. ``--tiny`` runs the JAX
package's example size (4096 floats) for a CPU rehearsal. With ``--out
DIR`` each rank writes ``DIR/rank<r>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.examples import kernel_counts as KC
from ompi_tpu_torch.examples.hier_collectives import nbytes_of
from ompi_tpu_torch.examples.zero_training import _gen, bits_equal
from ompi_tpu_torch.monitoring import algo
from ompi_tpu_torch.parallel import hierarchical as H
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import layout as zlayout

#: (wire, wire bytes / nominal DCN bytes at most, rtol against exact)
WIRES = (("bf16", 0.5, 0.02), ("fp8_e4m3", 0.25, 0.35),
         ("fp8_e5m2", 0.25, 0.35))
#: the wires' epsilon (the spacing above 1): 2**-7, 2**-3, 2**-2
EPS = {"bf16": 2.0 ** -7, "fp8_e4m3": 2.0 ** -3, "fp8_e5m2": 2.0 ** -2}


def expected(wire, n_dcn: int, n_ici: int) -> dict:
    """K1-K3 launches of one split-level Allreduce (inner ring) per rank:
    the ICI ring's hops, then the DCN phase: the exact ring allreduce
    over ``up``; a wire's gather (the pull schedule, n_dcn copies), fp8
    after the scale's 1-element ring allreduce."""
    h = KC.ring_hops(n_ici)
    acc = KC.add({}, K1=h, K2=h)
    if wire is None:
        return KC.merged(acc, KC.ring_allreduce(n_dcn))
    acc = KC.add(acc, K2=n_dcn)
    if wire.startswith("fp8"):
        acc = KC.merged(acc, KC.ring_allreduce(n_dcn))
    return acc


def sgd(quant, steps: int = 200):
    """The JAX package example's quadratic: loss after ``steps`` SGD
    steps whose gradient passes through ``quant``."""
    curv = np.array([2.0, 0.004], np.float32)
    tgt = np.array([1.0, 500.0], np.float32)
    w = np.zeros(2, np.float32)
    for _ in range(steps):
        g = curv * (w - tgt)
        if quant is not None:
            g = quant(g)
        w = w - np.float32(0.4) * g
    return float(0.5 * np.sum(curv * (w - tgt) ** 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=61)
    ap.add_argument("--bytes", default="256m")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="the JAX package's example size (CPU rehearsal)")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if ns.tiny:
        ns.bytes, ns.reps = "16k", 2

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    assert comm.coll.providers["allreduce_dev"] == "hier", \
        comm.coll.providers.get("allreduce_dev")
    counts = KC.Counts(dev)
    cases, report = [], {}

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[hier_dcn_compress n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    nb = nbytes_of(ns.bytes)
    m = nb // 4
    # positive payload: the relative agreement bound would not survive the
    # cancellation of signed partials (that is float math, not compression)
    g = _gen(dev, ns.seed, r)
    x = ((torch.rand(m, generator=g, device=dev) + 0.1)
         * 10.0 ** torch.randint(-2, 3, (m,), generator=g, device=dev))
    comm.coll.allreduce_dev(comm, torch.zeros(4 * n, device=dev))
    plan = comm._coll_hier_plan
    nd, ni = plan.n_dcn, plan.n_ici

    def launch(wire):
        """One Allreduce under ``wire``: the result, its time and the
        launch's (nominal, wire) DCN bytes."""
        cvar.set("coll_hier_dcn_dtype", wire or "off")
        try:
            s = pvar.session()
            comm.Barrier()
            sync()
            t0 = time.perf_counter()
            out = comm.coll.allreduce_dev(comm, x)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            return out, ms, s.read("hier_dcn_bytes"), \
                s.read("hier_dcn_wire_bytes")
        finally:
            cvar.set("coll_hier_dcn_dtype", "off")

    def arenas():
        return sum(len(c.__dict__.get("_coll_cuda_arenas", {}))
                   for c in (comm, plan.low, plan.up))

    comm.Barrier()
    counts.reset()
    want: dict = {}
    exact, _, nominal, w_off = launch(None)
    want = KC.merged(want, expected(None, nd, ni))
    case("off moves the nominal DCN bytes",
         nominal > 0 and w_off == nominal
         and nominal == int(algo.hier_level_bytes("allreduce", nd, ni,
                                                  nb)[1]),
         nominal=nominal, wire=w_off)
    times = {"off": []}
    rows = {}
    for wire, bound, rtol in WIRES:
        times[wire] = []
    seen_arenas = None
    for rep in range(ns.reps + 1):  # 1 warm, then timed, in turns
        for wire, bound, rtol in (("off", 1.0, 0.0),) + WIRES:
            w = None if wire == "off" else wire
            out, ms, nom, wb = launch(w)
            want = KC.merged(want, expected(w, nd, ni))
            if rep:
                times[wire].append(ms)
            if w is None:
                if not bits_equal(out, exact):
                    case(f"off rep {rep} bitwise the exact result", False)
                continue
            if rep == 0:
                diff = (out - exact).abs()
                close = bool((diff <= rtol * exact.abs() + 0.1).all())
                units = float((diff / (EPS[w] * exact.abs())).max())
                isz = 4
                model = algo.hier_wire_bytes("allreduce", nd, ni, nb,
                                             wire=w, itemsize=isz)
                rows[wire] = {"nominal": nom, "wire_bytes": wb,
                              "ratio": wb / nom, "model": model,
                              "worst_eps_units": units,
                              "max_abs_err": float(diff.max())}
                case(f"{wire} moves <= {bound} of the nominal DCN bytes, "
                     "within the example's bounds of exact",
                     0 < wb <= nom * bound and wb == int(model) and close,
                     ratio=wb / nom, worst_eps_units=units)
            del out
        if rep == 0:
            seen_arenas = (arenas(), pvar.read("device_plane_arena_bytes"))
    case("off stays bitwise the exact result across the toggles",
         not any(c["name"].startswith("off rep") for c in cases))
    case("toggling maps no new arena once each wire ran",
         (arenas(), pvar.read("device_plane_arena_bytes")) == seen_arenas,
         arenas=seen_arenas)
    # 'linear' ignores the wire
    cvar.set("coll_hier_dcn_dtype", "bf16")
    try:
        s = pvar.session()
        comm.coll.allreduce_dev(comm, x, deterministic="linear")
        case("'linear' runs exact under a wire",
             s.read("hier_dcn_wire_bytes") == s.read("hier_dcn_bytes"))
    finally:
        cvar.set("coll_hier_dcn_dtype", "off")
    want = KC.add(want, K2=nd + ni, K3=1)
    sync()
    got = counts.read()
    want = {k: want.get(k, 0) for k in KC.NAMES}
    case("K1-K3 launches as derived", got == want, got=got, want=want)
    for wire, ts in times.items():
        report[wire] = {"ms": ts, "p50_ms": sorted(ts)[len(ts) // 2],
                        **rows.get(wire, {})}
    # error feedback: the carry keeps SGD on the exact trajectory
    ef = zlayout.ErrorFeedback("fp8_e4m3")
    loss_exact = sgd(None)
    loss_ef = sgd(lambda gr: ef.apply([gr], n)[0])
    loss_no = sgd(lambda gr: H.wire_quantize(gr, "fp8_e4m3"))
    case("error-feedback SGD within 1e-2 of the exact loss",
         loss_ef <= loss_exact + 1e-2, exact=loss_exact, ef=loss_ef,
         carry_free=loss_no)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if r == 0:
        print(f"[hier_dcn_compress n={n}] {nb} B float32, {nd}x{ni} grid: "
              + "; ".join(f"{w} p50 {v['p50_ms']:.3f} ms"
                          + (f" ratio {v['ratio']:.4f} worst "
                             f"{v['worst_eps_units']:.3f} eps"
                             if "ratio" in v else "")
                          for w, v in report.items()), flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "bytes": nb, "grid": [nd, ni], "cases": cases,
                       "launches": got, "expected": want,
                       "wires": report,
                       "ef": {"exact": loss_exact, "ef": loss_ef,
                              "carry_free": loss_no},
                       "arena_bytes": pvar.read("device_plane_arena_bytes"),
                       "peak_bytes": peak,
                       "coll_accelerator_staged":
                           pvar.read("coll_accelerator_staged")}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
