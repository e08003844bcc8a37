"""serve/ on the port — production-skew MoE decode with the live
imbalance view and the merged ``[serve]`` report (the port of
``examples/moe_serving.py``).

16 experts over 4 ranks (4 a rank), Zipf traffic at hotness 2.0 (seed 23)
hot enough that one expert draws about 60% of the tokens, 32 tokens a rank
a request, capacity factor 1.25, 2 warm-up and 32 timed requests a
policy. Parts (``--parts``):

- ``drop``: one dispatch bitwise against ``ops/moe.moe_ffn`` on the same
  inputs, then the decode loop;
- ``reroute``: the decode loop with the reference's live view (every
  request conserves its tokens, nothing is double-assigned; rank 0
  prints the load every 8 requests); the skew must reroute tokens and the
  loop must find the traffic's hot expert; then every rank's monitoring
  snapshot is gathered and rank 0 renders the merged report, whose
  ``[serve]`` section must name the hot expert;
- ``monitoring`` (with ``drop``): the monitoring plane's cost on the
  drop policy's decode: levels 0 (the guard alone), 1 (matrices) and 2
  (links) in turns, :data:`MON_REQUESTS` timed requests a level a turn,
  the plane switched by ``matrix.disable()`` / ``matrix.enable()`` and
  the job's own plane put back after; one request's output bitwise equal
  at every level, and the K2 launches as derived;
- ``dcn_overflow`` (its own job, under ``--mca coll_hier_split 2x2``):
  the slices are expert replicas (8 experts, 4 a rank, ranks r and r + 2
  holding the same ones); one dispatch with an unbounded budget must
  drop nothing and match a float64 oracle that recomputes each token's
  picked expert from the seeded draw; a budget of half the overflow must
  bound ``dcn_bytes`` and drop the rest; then the decode loop.

Each part's K2 launches (``ring_ag_hop``: the EP Alltoalls' pull copies
and the DCN legs' ragged pulls) must equal what the ranks derive from the
schedules; on the CPU ``kernel_counts.Counts`` counts the plain version's
calls instead.

Widths: ``--width tiny`` is the reference example's (d_model 32, d_ff 64,
numpy weights from ``default_rng(300 + rank)``); ``--width full`` is
bench.py's MoE FFN (d_model 7168, d_ff 28672), float32 experts drawn on
the device from per-expert seeded ``torch.Generator``s with 1/sqrt(fan-in)
scale: 6.58 GB a rank, 26.3 GB on one card for 4 ranks.

Run (CPU)::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca monitoring_level 1 --mca device_plane_platform cpu \\
        ompi_tpu_torch/examples/moe_serving.py --width tiny
    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca monitoring_level 1 --mca coll_hier_split 2x2 \\
        --mca device_plane_platform cpu \\
        ompi_tpu_torch/examples/moe_serving.py --width tiny \\
        --parts dcn_overflow

On the card drop the platform and pass ``--width full``. ``--out DIR``
writes ``rank<r>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.examples.kernel_counts import Counts
from ompi_tpu_torch.monitoring import matrix as mon_matrix
from ompi_tpu_torch.monitoring import merge as mon_merge
from ompi_tpu_torch.monitoring import report as mon_report
from ompi_tpu_torch.ops import moe
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.serve import Dispatcher, ZipfTraffic, run_decode

#: (d_model, d_ff) per width; tiny is the reference example's
WIDTHS = {"tiny": (32, 64), "full": (7168, 28672)}
E_LOCAL, T = 4, 32
HOTNESS, SEED = 2.0, 23
CAPACITY_FACTOR = 1.25
WARMUP, REQUESTS = 2, 32
#: the monitoring part: levels, turns, timed requests a level a turn
MON_LEVELS, MON_TURNS, MON_REQUESTS = (0, 1, 2), 4, 8
N_ICI = 2  # dcn_overflow's grid: 2 slices of 2 ranks
SERVE_PVARS = ("serve_requests", "serve_tokens", "serve_dropped_tokens",
               "serve_rerouted_tokens", "serve_dcn_overflow_tokens",
               "serve_dcn_overflow_bytes")


def draw_expert(width: str, seed: int, e: int, dev, out=(None, None)):
    """(w1[e], w2[e]) of the experts drawn from ``seed`` (float32 on
    ``dev``): tiny takes expert e of the reference example's numpy draw,
    full draws expert e alone from its own generator, into ``out`` where
    given (no temporary: the draw is the rank's largest allocation)."""
    d, f = WIDTHS[width]
    if width == "tiny":
        rng = np.random.default_rng(seed)
        w1 = rng.standard_normal((E_LOCAL, d, f)).astype(np.float32)
        w2 = rng.standard_normal((E_LOCAL, f, d)).astype(np.float32)
        return (torch.from_numpy(w1[e]).to(dev),
                torch.from_numpy(w2[e]).to(dev))
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + e)
    w1 = torch.randn((d, f), generator=g, device=dev, out=out[0])
    w2 = torch.randn((f, d), generator=g, device=dev, out=out[1])
    return w1.mul_(d ** -0.5), w2.mul_(f ** -0.5)


def draw_experts(width: str, seed: int, dev):
    """A rank's experts [E_LOCAL, D, F] / [E_LOCAL, F, D]: numpy at tiny
    (the Dispatcher stages them), float32 tensors on ``dev`` at full."""
    d, f = WIDTHS[width]
    if width == "tiny":
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((E_LOCAL, d, f)).astype(np.float32),
                rng.standard_normal((E_LOCAL, f, d)).astype(np.float32))
    w1 = torch.empty((E_LOCAL, d, f), device=dev)
    w2 = torch.empty((E_LOCAL, f, d), device=dev)
    for e in range(E_LOCAL):
        draw_expert(width, seed, e, dev, out=(w1[e], w2[e]))
    return w1, w2


class Counted:
    """The Dispatcher with the K2 launches its schedules imply summed
    over every dispatch: a flat dispatch's two EP Alltoalls copy n
    blocks each; a dcn_overflow dispatch's ICI Alltoalls copy n_ici each,
    and its two DCN legs one block per peer with rows."""

    def __init__(self, disp, n: int) -> None:
        self.disp, self.n = disp, n
        self.policy = disp.policy
        self.derived = 0

    def __call__(self, x):
        out, info = self.disp(x)
        if self.policy == "dcn_overflow":
            sc, rc = self.disp.last_dcn_counts
            self.derived += 2 * N_ICI + sum(c > 0 for c in sc) \
                + sum(c > 0 for c in rc)
        else:
            self.derived += 2 * self.n
        return out, info


class Part:
    """One part's checks, summary and launches."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.cases: list = []
        self.doc: dict = {"name": name}

    def check(self, name: str, ok, **info) -> None:
        self.cases.append({"name": f"{self.name}: {name}", "ok": bool(ok),
                           **info})


def loop(part: Part, disp, traffic, counts: Counts, n: int,
         on_request=None) -> dict:
    """The decode loop of one part with its K2 launches against the
    derived count and its serve pvars."""
    counted = Counted(disp, n)
    s = pvar.session()
    before = counts.read()["ring_ag_hop"]
    res = run_decode(counted, traffic, n_requests=REQUESTS,
                     tokens_per_request=T, warmup=WARMUP,
                     on_request=on_request)
    got = counts.read()["ring_ag_hop"] - before
    part.check("K2 launches as derived", got == counted.derived,
               got=got, derived=counted.derived)
    part.doc.update(summary=res, k2={"got": got, "derived": counted.derived},
                    pvars={k: s.read(k) for k in SERVE_PVARS})
    return res


def drop_part(comm, width, traffic, w1, w2, counts, dev) -> Part:
    part = Part("drop")
    disp = Dispatcher(comm, traffic.wg, w1, w2, policy="drop",
                      capacity_factor=CAPACITY_FACTOR)
    _ids, x = traffic.request(T)
    out, info = disp(x)
    wg_t, w1_t, w2_t = disp._weights()
    ref = moe.moe_ffn(torch.as_tensor(x, device=dev), wg_t, w1_t, w2_t, comm,
                      CAPACITY_FACTOR)
    part.check("bitwise moe_ffn", torch.equal(out.view(torch.int32),
                                              ref.view(torch.int32)))
    part.check("tokens kept + dropped",
               info["kept"] + info["dropped"] == T
               and info["rerouted"] == 0 and info["multi_assigned"] == 0,
               info={k: v for k, v in info.items() if k != "counts"})
    part.check("skew overflows", info["dropped"] > 0)
    loop(part, disp, traffic, counts, comm.size)
    return part


def reroute_part(comm, traffic, w1, w2, counts) -> Part:
    part = Part("reroute")
    disp = Dispatcher(comm, traffic.wg, w1, w2, policy="reroute",
                      capacity_factor=CAPACITY_FACTOR)
    load = np.zeros(traffic.n_experts, np.int64)
    bad: list = []

    def live_view(i, info, lat_ns):
        """Per-request conservation + the live imbalance printout."""
        if info["kept"] + info["rerouted"] + info["dropped"] \
                != info["tokens"] or info["multi_assigned"] != 0:
            bad.append((i, {k: v for k, v in info.items()
                            if k != "counts"}))
        load[:] += np.asarray(info["counts"], np.int64)
        if comm.rank == 0 and (i + 1) % 8 == 0:
            peak = max(int(load.max()), 1)
            bars = " ".join(
                f"e{e}:{'#' * max(1, int(c * 8 // peak))}"
                for e, c in enumerate(load) if c)
            print(f"[req {i + 1:3d}] {lat_ns / 1e6:6.2f}ms  "
                  f"rerouted {info['rerouted']:2d}/{info['tokens']}  "
                  f"load {bars}", flush=True)

    res = loop(part, disp, traffic, counts, comm.size, live_view)
    part.check("every request conserves its tokens", not bad, bad=bad[:4])
    part.check("conserved overall", res["kept"] + res["rerouted"]
               + res["dropped"] == res["tokens"])
    part.check("skew this hot reroutes", res["rerouted"] > 0)
    part.check("hot expert found", res["hot_expert"] == traffic.hot_expert,
               got=res["hot_expert"], want=traffic.hot_expert)
    return part


def report_part(comm, traffic, policy: str) -> Part:
    """Every rank's snapshot gathered; rank 0 renders the merged report,
    which must name the policy and the hot expert."""
    part = Part(f"report {policy}")
    tm = mon_matrix.TRAFFIC
    part.check("monitoring plane up (monitoring_level 1)", tm is not None)
    if tm is None:
        return part
    docs = comm.coll.allgather_obj(comm, mon_merge.snapshot_doc(tm))
    merged = mon_merge.merge(list(docs))
    text = mon_report.render(merged)
    hot_line = f"hot expert: e{traffic.hot_expert}"
    part.check(f"[serve] policy {policy} in the report",
               f"[serve] policy {policy}" in text)
    part.check(f"the report names {hot_line!r}", hot_line in text)
    part.doc.update(coll_records=merged["coll_records"],
                    hier_levels=merged["hier_levels"], hot_line=hot_line)
    if comm.rank == 0:
        print(text, flush=True)
        part.doc["text"] = text
    return part


def monitoring_part(comm, traffic, w1, w2, counts) -> Part:
    """The monitoring plane's cost on the drop policy's decode, levels
    in turns (ABC, CBA, ...); the job's own plane is put back after."""
    part = Part("monitoring")
    r, n = comm.rank, comm.size
    disp = Counted(Dispatcher(comm, traffic.wg, w1, w2, policy="drop",
                              capacity_factor=CAPACITY_FACTOR), n)
    _ids, x = traffic.request(T)
    own = mon_matrix.TRAFFIC
    lat = {lvl: [] for lvl in MON_LEVELS}
    first = {}
    before = counts.read()["ring_ag_hop"]
    try:
        for turn in range(MON_TURNS):
            for lvl in (MON_LEVELS if turn % 2 == 0
                        else MON_LEVELS[::-1]):
                mon_matrix.disable()
                if lvl:
                    mon_matrix.enable(rank=r, level=lvl, nranks=n)
                out, _info = disp(x)
                first.setdefault(lvl, out.view(torch.int32).clone())
                part.check(f"level {lvl}: the output bitwise level 0's",
                           torch.equal(out.view(torch.int32),
                                       first.get(0, first[lvl])))
                run_decode(disp, traffic, n_requests=MON_REQUESTS,
                           tokens_per_request=T, warmup=0,
                           on_request=lambda i, info, dt, lvl=lvl:
                           lat[lvl].append(dt / 1e6))
    finally:
        # the job's own plane (level 1) back for its report and dump
        mon_matrix.disable()
        mon_matrix.TRAFFIC = own
    got = counts.read()["ring_ag_hop"] - before
    part.check("K2 launches as derived", got == disp.derived, got=got,
               derived=disp.derived)

    def p50(v):
        return sorted(v)[len(v) // 2]
    part.doc.update(levels={str(lvl): {"p50_ms": p50(v), "ms": v}
                            for lvl, v in lat.items()},
                    k2={"got": got, "derived": disp.derived})
    return part


def dcn_part(comm, width, dev, counts) -> Part:
    part = Part("dcn_overflow")
    d, _f = WIDTHS[width]
    seed = 300 + comm.rank % N_ICI
    traffic = ZipfTraffic(E_LOCAL * N_ICI, d, hotness=HOTNESS, seed=SEED)
    w1, w2 = draw_experts(width, seed, dev)
    disp = Dispatcher(comm, traffic.wg, w1, w2, policy="dcn_overflow",
                      capacity_factor=CAPACITY_FACTOR)
    ids, x = traffic.request(T)
    s = pvar.session()
    out, info = disp(x)
    part.check("kept + dropped + dcn == tokens",
               info["kept"] + info["dropped"] + info["dcn_tokens"] == T,
               info={k: v for k, v in info.items() if k != "counts"})
    part.check("skew overflows to the replica", info["dcn_tokens"] > 0)
    part.check("unbounded budget drops nothing", info["dropped"] == 0)
    part.check("pvars meter the DCN leg",
               s.read("serve_dcn_overflow_tokens") == info["dcn_tokens"]
               and s.read("serve_dcn_overflow_bytes") == info["dcn_bytes"])
    tm = mon_matrix.TRAFFIC
    rec = tm.hier_levels.get("serve_overflow") if tm is not None else None
    part.check("attributed to the DCN level",
               rec is not None and rec[2] == info["dcn_bytes"]
               and rec[1] == 0.0)
    # the float64 oracle: each token's picked expert recomputed from the
    # seeded draw, one expert at a time
    x64 = torch.as_tensor(x, device=dev).double()
    logits = x64 @ torch.as_tensor(traffic.wg, device=dev).double()
    gates = torch.softmax(logits, -1)
    oracle = torch.zeros_like(x64)
    for e in np.unique(ids):
        rows = torch.as_tensor(np.nonzero(ids == e)[0], device=dev)
        w1e, w2e = draw_expert(width, 300 + int(e) // E_LOCAL,
                               int(e) % E_LOCAL, dev)
        h = torch.relu(x64[rows] @ w1e.double())
        oracle[rows] = gates[rows, int(e)][:, None] * (h @ w2e.double())
        del w1e, w2e, h
    err = float((out.double() - oracle).abs().max())
    scale = float(oracle.abs().max())
    part.check("float64 oracle", err <= 1e-4 * scale, max_abs_err=err,
               max_abs_oracle=scale)
    part.doc["oracle"] = {"max_abs_err": err, "max_abs_oracle": scale}
    del oracle, x64
    # the budget: half the overflow's bytes bounds the remote leg
    cost = (d + 2 + d) * 4
    budget = max(info["dcn_tokens"] // 2, 1) * cost
    cvar.set("serve_dcn_budget_bytes", budget)
    try:
        _out, binfo = disp(x)
    finally:
        cvar.set("serve_dcn_budget_bytes", 0)
    part.check("budget bounds dcn_bytes", binfo["dcn_bytes"] <= budget
               and binfo["dcn_tokens"] < info["dcn_tokens"]
               and binfo["dropped"] > 0
               and binfo["kept"] + binfo["dropped"] + binfo["dcn_tokens"]
               == T, budget=budget,
               info={k: v for k, v in binfo.items() if k != "counts"})
    part.doc["budget"] = {"bytes": budget, "dcn_bytes": binfo["dcn_bytes"],
                          "dcn_tokens": binfo["dcn_tokens"],
                          "dropped": binfo["dropped"]}
    loop(part, disp, traffic, counts, comm.size)
    part.doc["traffic"] = traffic
    return part


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", choices=sorted(WIDTHS), default="tiny")
    ap.add_argument("--parts", default="drop,reroute",
                    help="comma-separated: drop, reroute, monitoring (one "
                         "job), or dcn_overflow (its own job, under --mca "
                         "coll_hier_split 2x2)")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    parts = [p for p in ns.parts.split(",") if p]
    if not set(parts) <= {"drop", "reroute", "monitoring",
                          "dcn_overflow"} or (
            "dcn_overflow" in parts and len(parts) > 1):
        raise SystemExit(f"--parts {ns.parts!r}: drop, reroute and "
                         "monitoring run together, dcn_overflow alone")
    comm = mpi.Init()
    r, n = comm.rank, comm.size
    if n != 4:
        raise SystemExit("moe_serving.py runs on 4 ranks")
    dev = device_plane.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = Counts(dev)
    counts.reset()
    d, _f = WIDTHS[ns.width]
    done = []
    if parts == ["dcn_overflow"]:
        part = dcn_part(comm, ns.width, dev, counts)
        traffic = part.doc.pop("traffic")
        done += [part, report_part(comm, traffic, "dcn_overflow")]
    else:
        traffic = ZipfTraffic(E_LOCAL * n, d, hotness=HOTNESS, seed=SEED)
        w1, w2 = draw_experts(ns.width, 300 + r, dev)
        if "drop" in parts:
            done.append(drop_part(comm, ns.width, traffic, w1, w2, counts,
                                  dev))
        if "reroute" in parts:
            done.append(reroute_part(comm, traffic, w1, w2, counts))
            done.append(report_part(comm, traffic, "reroute"))
        if "monitoring" in parts:
            done.append(monitoring_part(comm, traffic, w1, w2, counts))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    cases = [c for p in done for c in p.cases]
    if r == 0:
        for p in done:
            res = p.doc.get("summary")
            if res is not None:
                print(f"[moe_serving {ns.width} n={n} {dev}] {p.name}: "
                      f"{res['requests']} requests x {T} tokens, p50 "
                      f"{res['p50_ms']:.2f}ms p95 {res['p95_ms']:.2f}ms "
                      f"p99 {res['p99_ms']:.2f}ms, "
                      f"{res['tokens_per_s']:.0f} tokens/s, drop "
                      f"{100 * res['drop_rate']:.1f}%, rerouted "
                      f"{res['rerouted']}, DCN {res['dcn_tokens']} tokens; "
                      f"K2 {p.doc['k2']}", flush=True)
    bad = [c for c in cases if not c["ok"]]
    for c in bad:
        print(f"rank {r}: FAILED {c}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as fh:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "width": ns.width, "cases": cases,
                       "parts": {p.name: p.doc for p in done},
                       "launches": counts.read(),
                       "required": ["ring_ag_hop"],
                       "peak_bytes": int(peak),
                       "coll_accelerator_staged":
                           pvar.read("coll_accelerator_staged")}, fh)
    if r == 0 and not bad:
        print("moe_serving OK", flush=True)
    mpi.Finalize()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
