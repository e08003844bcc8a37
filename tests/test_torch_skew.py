"""The port's skew plane (``skew/``: the completed-collective ring behind
``SKEW``, the wait / transfer decomposition, the store merge and rebase,
the report and its CLI, the plane's cvars and hooks) against the JAX
package's: the counterparts of ``tests/test_skew.py``'s 24 cases.

The arithmetic runs in this process on synthetic records, the same for
both packages, and must give the reference's numbers exactly: the clock
helper, the ring's order and drop accounting, the decomposition oracle,
the critical path, the straggler verdicts with their edges and window,
the merge's rebase and error bar, the pvar fold-in, the OpenMetrics
family, the live lag view, the hang dump's ``skew`` context and the
report text. The level-0 guard on the flight recorder's exit is held for
the port (a disabled plane is never touched).

Launcher jobs: the reference's pooled 2-rank exchange as a port job (the
ring filled by real collectives, exchanged through the live store, each
group's wall = wait + transfer within the merged error bar), and the
sleep-injected straggler of ``examples/skew_straggler.py`` run by both
packages on 4 ranks (rank 3 sleeps 0.3 s before each step from step 1):
both name rank 3 (at a 35% bar), its lateness put down to compute.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import pytest

import ompi_tpu.skew as R_skew
import ompi_tpu_torch.skew as P_skew
from ompi_tpu.core import pvar as R_pvar
from ompi_tpu.skew import decompose as R_dec, merge as R_merge
from ompi_tpu.skew import record as R_rec, report as R_rep
from ompi_tpu.telemetry import clock as R_clock, flight as R_flight
from ompi_tpu.telemetry import openmetrics as R_om
from ompi_tpu_torch.core import pvar as P_pvar
from ompi_tpu_torch.runtime import launcher as P_launcher
from ompi_tpu_torch.skew import decompose as P_dec, merge as P_merge
from ompi_tpu_torch.skew import record as P_rec, report as P_rep
from ompi_tpu_torch.telemetry import clock as P_clock, flight as P_flight
from ompi_tpu_torch.telemetry import openmetrics as P_om
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: side -> (record, decompose, merge, report, clock, flight, openmetrics,
#: pvar, the skew package)
SIDES = {"ref": (R_rec, R_dec, R_merge, R_rep, R_clock, R_flight, R_om,
                 R_pvar, R_skew),
         "port": (P_rec, P_dec, P_merge, P_rep, P_clock, P_flight, P_om,
                  P_pvar, P_skew)}


def both(fn):
    """fn(side modules...) on each package; the two answers."""
    return {side: fn(*mods) for side, mods in SIDES.items()}


def same(fn):
    got = both(fn)
    assert got["port"] == got["ref"], got
    return got["port"]


@pytest.fixture
def no_skew():
    """Both packages' skew and flight guards down before and after."""
    def down():
        for mods in SIDES.values():
            mods[0].disable()  # the skew recorder
            mods[5].disable()  # the flight recorder
    down()
    yield
    down()


# -- the clock helper ------------------------------------------------------

def test_clock_bracketed_offset_with_error_bound():
    off, err = P_clock.sample_offset()
    naive = time.time_ns() - time.monotonic_ns()
    assert abs(off - naive) < 1_000_000_000
    assert 0 <= err < 1_000_000_000


def test_clock_shift_and_pair_err_arithmetic():
    got = same(lambda *m: [m[4].shift_ns(None, 5), m[4].shift_ns(5, None),
                           m[4].shift_ns(10, 4), m[4].shift_ns(4, 10),
                           m[4].pair_err_ns(3, 4), m[4].pair_err_ns(-3, 4)])
    assert got == [0, 0, 6, -6, 7, 4]


# -- ring bounds and drop accounting ---------------------------------------

def test_ring_overwrites_oldest_and_counts_drops(no_skew):
    def run(rec, *m):
        pvar = m[6]
        sk = rec.SkewRecorder(rank=0, nranks=1, capacity=4)
        s = pvar.session()
        for seq in range(1, 7):
            sk.complete(seq, "allreduce_dev", 3, 64, 1.0 + seq, 2.0 + seq)
        return [sk.records(), s.read("skew_records"),
                s.read("skew_dropped"), pvar.read("skew_ring_depth") >= 4]
    got = same(run)
    assert [r[0] for r in got[0]] == [3, 4, 5, 6]
    assert got[1:] == [6, 2, True]


def test_ring_capacity_floor_and_enable_idempotent(no_skew):
    def run(rec, *m):
        floor = rec.SkewRecorder(capacity=0).capacity
        sk = rec.enable(rank=1, nranks=4, level=1, capacity=8)
        again = rec.enable(rank=1, nranks=4, level=2)
        out = [floor, again is sk, sk.level, sk.capacity]
        out += [rec.disable() is sk, rec.SKEW is None]
        return out
    assert same(run) == [1, True, 2, 8, True, True]


def test_level0_flight_exit_skips_skew(monkeypatch, no_skew):
    """While SKEW is down the flight recorder's exit never touches a
    skew recorder (the one-branch guard)."""
    assert P_rec.SKEW is None

    def boom(*a, **k):
        raise AssertionError("skew recorder touched while disabled")

    monkeypatch.setattr(P_rec.SkewRecorder, "complete", boom)
    fl = P_flight.FlightRecorder()
    fl.exit(fl.enter("allreduce_dev", comm_cid=3, nbytes=256))
    assert fl.last_completed == 1


def test_flight_exit_feeds_ring_when_enabled(no_skew):
    def run(rec, dec, mer, rep, clock, flight, *m):
        sk = rec.enable(rank=0, nranks=1, level=1, capacity=16)
        fl = flight.FlightRecorder()
        fl.exit(fl.enter("allreduce_dev", comm_cid=7, nbytes=1024))
        fl.exit(fl.enter("bcast_dev", comm_cid=7))
        recs = sk.records()
        return [[(r[0], r[1], r[2], r[3]) for r in recs],
                recs[0][5] >= recs[0][4] > 0]
    got = same(run)
    assert got == [[(1, "allreduce_dev", 7, 1024), (2, "bcast_dev", 7, 0)],
                   True]


# -- the decomposition oracle ----------------------------------------------

def _rec(seq, t0, t1, op="allreduce_dev", cid=1, nbytes=64):
    return {"seq": seq, "op": op, "cid": cid, "nbytes": nbytes, "t0": t0,
            "t1": t1}


def _oracle_per_rank():
    """rank 1 arrives 2000 ns late into seq 1; rank 0 arrives 1000 ns
    late into seq 2 after sitting outside collectives since t=5000."""
    return {0: [_rec(1, 1000, 5000), _rec(2, 9000, 12000)],
            1: [_rec(1, 3000, 5500), _rec(2, 8000, 12500)]}


def test_decompose_oracle_wait_plus_transfer_is_wall():
    groups = same(lambda rec, dec, *m: dec.groups_of(_oracle_per_rank()))
    g1, g2 = groups
    assert (g1["last_rank"], g1["arrival_skew_ns"], g1["cause"]) == \
        (1, 2000, "unknown")
    assert g1["ranks"][0] == {"wall_ns": 4000, "wait_ns": 2000,
                              "transfer_ns": 2000}
    assert (g2["last_rank"], g2["arrival_skew_ns"], g2["cause"]) == \
        (0, 1000, "compute")
    assert g2["ranks"][1] == {"wall_ns": 4500, "wait_ns": 1000,
                              "transfer_ns": 3500}
    for g in groups:
        for cell in g["ranks"].values():
            assert cell["wall_ns"] == cell["wait_ns"] + cell["transfer_ns"]
    assert same(lambda rec, dec, *m: dec.exposed_wait(groups)) == \
        {0: 2000, 1: 1000}


def test_decompose_comm_cause_when_dragged_upstream():
    per_rank = {0: [_rec(1, 0, 100), _rec(2, 150, 400)],
                1: [_rec(1, 0, 280), _rec(2, 300, 400)]}
    g2 = same(lambda rec, dec, *m: dec.groups_of(per_rank))[1]
    assert (g2["last_rank"], g2["arrival_skew_ns"], g2["cause"]) == \
        (1, 150, "comm")


def test_decompose_skips_singleton_groups():
    per_rank = {0: [_rec(1, 0, 10, op="bcast_dev", cid=9, nbytes=8)], 1: []}
    assert same(lambda rec, dec, *m: dec.groups_of(per_rank)) == []


def test_analyze_doc_shape_and_per_op_table():
    ana = same(lambda rec, dec, *m: dec.analyze(_oracle_per_rank(),
                                                clock_err_ns=35))
    assert ana["schema"] == "ompi_tpu.skew/1+analysis"
    assert (ana["nranks"], ana["collectives"], ana["clock_err_ns"]) == \
        (2, 2, 35)
    assert ana["exposed_wait_ns"] == {"0": 2000, "1": 1000}
    (row,) = ana["per_op"]
    assert (row["n"], row["mean_skew_ns"], row["max_skew_ns"],
            row["wait_ns"]) == (2, 1500, 2000, 3000)
    assert [h["rank"] for h in ana["critical_path"]] == [1, 0]
    assert {v["rank"] for v in ana["stragglers"]} == {0, 1}


# -- merge: timebase rebase and schema gate --------------------------------

def test_merge_rebases_rings_into_one_timebase():
    oracle = _oracle_per_rank()
    shift1 = 4000

    def run(rec, dec, mer, *m):
        def doc(rank, offset, base, err, base_err, recs):
            return {"schema": mer.SCHEMA, "rank": rank, "nranks": 2,
                    "level": 1, "clock_offset_ns": offset,
                    "clock_err_ns": err, "clock_base_ns": base,
                    "clock_base_err_ns": base_err, "records": recs}
        d0 = doc(0, 1000, 1000, 10, 0, oracle[0])
        d1 = doc(1, 1000 + shift1, 1000, 20, 5,
                 [dict(r, t0=r["t0"] - shift1, t1=r["t1"] - shift1)
                  for r in oracle[1]])
        merged = mer.merge([d0, d1])
        ana = dec.analyze(merged["records"],
                          clock_err_ns=merged["clock_err_ns"])
        return merged, ana["exposed_wait_ns"]
    merged, wait = same(run)
    assert merged["schema"] == "ompi_tpu.skew/1+merged"
    assert (merged["nranks"], merged["level"], merged["clock_err_ns"]) == \
        (2, 1, 35)
    assert merged["records"][1] == oracle[1]
    assert wait == {"0": 2000, "1": 1000}


def test_merge_rejects_wrong_schema():
    for mer in (R_merge, P_merge):
        with pytest.raises(ValueError, match="not a skew ring dump"):
            mer.merge([{"schema": "ompi_tpu.trace/1", "rank": 0}])


def test_snapshot_doc_json_roundtrip(no_skew):
    def run(rec, dec, mer, *m):
        sk = rec.enable(rank=2, nranks=4, level=1, capacity=8)
        sk.clock_offset_ns, sk.clock_err_ns = 500, 7
        sk.clock_base_ns, sk.clock_base_err_ns = 100, 3
        sk.complete(1, "barrier", 0, 0, 1.0, 1.5)
        doc = json.loads(json.dumps(mer.snapshot_doc(sk)))
        merged = mer.merge([doc])
        rec.disable()
        return doc, merged["records"][2], merged["clock_err_ns"]
    doc, (rec,), err = same(run)
    assert doc["schema"] == "ompi_tpu.skew/1" and doc["rank"] == 2
    assert rec["t0"] == 1_000_000_000 + 400 and err == 10


# -- critical path and verdict ---------------------------------------------

def test_critical_path_three_ranks_names_the_rotor():
    per_rank = {r: [_rec(seq, 1000 * seq + (500 if r == 2 else r * 10),
                         1000 * seq + (500 if r == 2 else r * 10) + 100,
                         nbytes=32)
                    for seq in (1, 2, 3)] for r in range(3)}

    def run(rec, dec, *m):
        groups = dec.groups_of(per_rank)
        return dec.critical_path(groups), dec.verdict(groups), \
            sum(g["arrival_skew_ns"] for g in groups)
    path, verdicts, total = same(run)
    assert [h["rank"] for h in path] == [2, 2, 2]
    assert [h["cause"] for h in path] == ["unknown", "compute", "compute"]
    (v,) = verdicts
    assert (v["rank"], v["share_pct"], v["of"], v["cause"],
            v["arrival_skew_ns"]) == (2, 100.0, 3, "compute", total)


def _synthetic_groups():
    """5 groups: rank 2 last into 3 (60%), rank 0 into the final 2."""
    return [{"cid": 1, "seq": seq, "op": "allreduce_dev", "nbytes": 0,
             "last_rank": last, "last_arrival_ns": 0,
             "arrival_skew_ns": skew, "cause": cause, "ranks": {}}
            for seq, (last, cause, skew) in enumerate(
                [(2, "compute", 100), (2, "comm", 50), (2, "compute", 80),
                 (0, "compute", 10), (0, "compute", 20)], start=1)]


def test_verdict_threshold_edges_and_window():
    def run(rec, dec, *m):
        g = _synthetic_groups()
        return [dec.verdict(g), dec.verdict(g, pct=60.0),
                dec.verdict(g, pct=60.1), dec.verdict(g, pct=40),
                dec.verdict(g, win=2), dec.verdict([], pct=1)]
    default, at60, above, low, win2, empty = same(run)
    (v,) = default
    assert (v["rank"], v["last"], v["of"], v["share_pct"], v["cause"],
            v["arrival_skew_ns"]) == (2, 3, 5, 60.0, "compute", 230)
    assert at60[0]["rank"] == 2 and above == [] and empty == []
    assert [v["rank"] for v in low] == [2, 0]
    (w,) = win2
    assert (w["rank"], w["share_pct"], w["of"]) == (0, 100.0, 2)


# -- pvar fold-in and the OpenMetrics family -------------------------------

def test_record_pvars_folds_own_rank_view(no_skew):
    def run(rec, dec, mer, rep, clock, fl, om, pvar, sk):
        ana = dec.analyze(_oracle_per_rank(), clock_err_ns=35)
        s = pvar.session()
        dec.record_pvars(ana, rank=0)
        return [s.read("skew_exposed_wait_ns"),
                s.read("skew_op_wait_ns_allreduce_dev"),
                pvar.read("skew_arrival_skew_ns") >= 2000,
                s.read("skew_stragglers")]
    assert same(run) == [2000, 3000, True, 2]


def test_openmetrics_skew_op_family(no_skew):
    def run(rec, dec, mer, rep, clock, fl, om, *m):
        text = om.render({"skew_op_wait_ns_allreduce_dev": 123,
                          "skew_exposed_wait_ns": 5}, {"rank": "0"})
        return text, om.parse(text)["skew_op_wait_ns"]
    text, fam = same(run)
    assert ('ompi_tpu_skew_op_wait_ns_total'
            '{op="allreduce_dev",rank="0"} 123') in text
    assert 'ompi_tpu_skew_exposed_wait_ns_total{rank="0"} 5' in text
    assert sum(fam.values()) == 123


# -- the level-2 live lag view ---------------------------------------------

def test_observe_live_names_the_laggard(no_skew):
    now = time.time_ns()

    def run(rec, *m):
        sk = rec.SkewRecorder(rank=0, nranks=3, level=2)
        worst = sk.observe_live(
            {1: {"seq": 5, "arr": now - 2_000_000_000},
             2: {"seq": 9, "arr": now}, 3: "not-a-dict"},
            my_rank=0, my_arr_ns=now - 500_000_000, my_seq=7)
        return worst, sk.live_worst == worst, \
            m[6].read("skew_live_lag_ns") >= 2_000_000_000
    assert same(run) == ({"rank": 1, "seq": 5, "behind_s": 2.0}, True, True)


def test_observe_live_needs_two_arrivals(no_skew):
    def run(rec, *m):
        sk = rec.SkewRecorder(rank=0, nranks=2, level=2)
        return [sk.observe_live({}, my_rank=0, my_arr_ns=0, my_seq=0),
                sk.observe_live({1: {"seq": 1, "arr": 0}}, 0, 5, 1),
                sk.live_worst]
    assert same(run) == [None, None, None]


def test_skew_info_for_hang_dumps(no_skew):
    def run(rec, dec, mer, rep, clock, fl, om, pvar, sk_pkg):
        off = sk_pkg.skew_info()
        sk = rec.enable(rank=0, nranks=2, level=2, capacity=8)
        sk.complete(1, "allreduce_dev", 1, 64, 1.0, 2.0)
        sk.live_worst = {"rank": 1, "seq": 4, "behind_s": 3.1}
        info = sk_pkg.skew_info()
        rec.disable()
        return off, info["level"], info["records"] >= 1, info["live_worst"]
    assert same(run) == (None, 2, True, {"rank": 1, "seq": 4,
                                         "behind_s": 3.1})


# -- report rendering ------------------------------------------------------

def test_report_verdict_line_format():
    v = {"rank": 3, "last": 5, "of": 6, "share_pct": 83.3,
         "cause": "compute", "arrival_skew_ns": 3_600_000_000}
    assert same(lambda rec, dec, mer, rep, *m: rep.verdict_line(v)) == (
        "PERSISTENT STRAGGLER: rank 3 last into 83% of 6 collectives "
        "(compute, +3600.000 ms skew)")


def test_report_render_sections():
    def run(rec, dec, mer, rep, *m):
        return (rep.render(dec.analyze(_oracle_per_rank(), clock_err_ns=35)),
                rep.render(dec.analyze(_oracle_per_rank(), pct=99.0)))
    text, quiet = same(run)
    for part in ("2 collectives across 2 ranks", "timestamp error bar",
                 "exposed wait by rank", "critical path",
                 "PERSISTENT STRAGGLER"):
        assert part in text
    assert "no persistent straggler" in quiet


# -- the watchdog hang dump's skew context ---------------------------------

def test_watchdog_dump_carries_skew_context(tmp_path, no_skew):
    """At level 2 a hang dump says what the live view knew, round-tripped
    through the JSON file, in both packages."""
    from tests.test_torch_telemetry import _stuck_watchdog

    got = {}
    for side, (rec, *_m) in SIDES.items():
        sk = rec.enable(rank=0, nranks=2, level=2, capacity=8)
        wd, fl, client = _stuck_watchdog(side, tmp_path, peers={}, dead={})
        client.peers[1] = {"seq": 1, "done": 1, "inflight": 0,
                           "arr": fl.last_arrival_ns - 3_000_000_000}
        wd.sweep()
        assert sk.live_worst is not None and sk.live_worst["rank"] == 1
        assert 2.9 <= sk.live_worst["behind_s"] <= 3.1
        dumps = sorted((tmp_path / side).glob("ompi_tpu_hang_rank*.json"))
        assert dumps, "a stuck sweep dumps"
        doc = json.loads(dumps[0].read_text())
        got[side] = (doc["skew"]["level"], doc["skew"]["live_worst"]["rank"],
                     doc["verdict"]["arrivals"]["1"]["late_s"] >= 0.0)
        rec.disable()
    assert got["port"] == got["ref"] == (2, 1, True)


# -- end to end ------------------------------------------------------------

_EXCHANGE = textwrap.dedent('''
    import numpy as np
    import torch
    from ompi_tpu_torch import mpi
    from ompi_tpu_torch.runtime import rte
    from ompi_tpu_torch.skew import decompose, merge, record
    comm = mpi.Init()
    rank, size = comm.rank, comm.size
    sk = record.SKEW
    assert sk is not None and sk.level >= 1, "plane not raised"
    start_n = len(sk.records())
    buf = np.ones(1024, np.float32)
    out = np.empty_like(buf)
    for _ in range(4):
        comm.Allreduce(buf, out)
        comm.Barrier()
    assert out[0] == size
    assert len(sk.records()) >= start_n + 8
    merged = merge.exchange(sk, rte.client(), "skewtest-" + rte.jobid,
                            size, timeout=30)
    if rank != 0:
        assert merged is None
    else:
        assert merged["schema"] == merge.SCHEMA + "+merged"
        assert merged["nranks"] == 2
        ana = decompose.analyze(merged["records"],
                                clock_err_ns=merged["clock_err_ns"])
        assert ana["collectives"] >= 6, ana["collectives"]
        slack = int(merged["clock_err_ns"]) + 5_000_000
        for g in ana["groups"]:
            assert set(g["ranks"]) == {0, 1}
            for cell in g["ranks"].values():
                assert cell["wall_ns"] >= 0 and cell["wait_ns"] >= 0
                gap = abs(cell["wall_ns"] - (cell["wait_ns"]
                                             + cell["transfer_ns"]))
                assert gap <= slack, (cell, slack)
        assert len(ana["critical_path"]) == ana["collectives"]
    comm.Barrier()
    mpi.Finalize()
''')


def test_two_rank_exchange_and_decomposition():
    """skew_level=1 raises the plane at init; real collectives fill both
    rings; the store exchange merges them and rank 0's decomposition
    holds wall = wait + transfer within the stated error bar."""
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(_EXCHANGE)
        path = fh.name
    try:
        rc = P_launcher.launch([sys.executable, path], 2,
                               mca={"skew_level": "1",
                                    "device_plane_platform": "cpu"},
                               timeout=120)
    finally:
        os.unlink(path)
    assert rc == 0, rc


_DELAY = {"elastic_inject_delay_rank": "3", "elastic_inject_delay_s": "0.3",
          "elastic_inject_delay_step": "1", "skew_level": "2"}
#: the CLI's straggler bar: rank 3 is last into the 5 delayed Allreduces
#: of the example's 12 or 13 groups (38% or more) by construction; the
#: Barriers' and the first Allreduce's last ranks fall where they may
STRAGGLER_PCT = "35"


def _straggler(pkg: str, out) -> dict:
    """The skew_straggler example of ``pkg`` on 4 ranks, its dumps
    reported by that package's CLI (--json)."""
    script = (os.path.join(ROOT, "examples", "skew_straggler.py")
              if pkg == "ompi_tpu" else
              os.path.join(ROOT, "ompi_tpu_torch", "examples",
                           "skew_straggler.py"))
    mca = dict(_DELAY, skew_dump=str(out / "skew_r{rank}.json"))
    if pkg == "ompi_tpu_torch":
        mca["device_plane_platform"] = "cpu"
    cmd = [sys.executable, "-m", f"{pkg}.runtime.launcher", "-n", "4",
           "--timeout", "150"]
    for k, v in mca.items():
        cmd += ["--mca", k, v]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(cmd + [script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    ana = out / "analysis.json"
    r = subprocess.run([sys.executable, "-m", f"{pkg}.skew", "report",
                        "--pct", STRAGGLER_PCT, "--json", str(ana)]
                       + [str(out / f"skew_r{k}.json") for k in range(4)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "PERSISTENT STRAGGLER: rank 3" in r.stdout, r.stdout
    return json.loads(ana.read_text())


def test_sleep_injected_straggler_named_by_both(tmp_path):
    """The same injected straggler, the same verdict: rank 3, named by
    the reference's and the port's CLI over their own jobs' dumps."""
    got = {}
    for pkg in ("ompi_tpu", "ompi_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        ana = _straggler(pkg, d)
        named = {v["rank"]: v for v in ana["stragglers"]}
        # the fast ranks paid the straggler tax, rank 3 almost none
        wait = {int(r): w for r, w in ana["exposed_wait_ns"].items()}
        assert wait[3] < min(wait[r] for r in range(3)), wait
        # 6 steps' Allreduce and Barrier (the reference's Finalize adds a
        # barrier of its own; the port's ends in a store fence)
        assert ana["collectives"] >= 12, ana["collectives"]
        got[pkg] = (3 in named, named.get(3, {}).get("cause"))
    assert got["ompi_tpu_torch"] == got["ompi_tpu"] == (True, "compute"), got
