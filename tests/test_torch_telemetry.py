"""The port's telemetry plane (``telemetry/``: the flight recorder, the
OpenMetrics rendering, the sampler, the watchdog, the store's heartbeat
payload) against the JAX package's: the counterparts of
``tests/test_telemetry.py``'s 21 cases and of
``tests/test_monitoring.py``'s ``test_openmetrics_monitoring_labels``.

In this process: the flight recorder's seq semantics, pml marks and
thread safety, the heartbeat payload gate, the one-branch guard on
coll/device's one-rank path, the API hook's install and detach on the
port's Communicator, every OpenMetrics case on the same snapshots (the
two packages' expositions equal, text for text), the sampler's file,
HTTP and store rollup exports over the port's store, the store's
heartbeat payloads, and every watchdog verdict (straggler, lateness,
healthy, dead-rank resolution, a dead-only gap, the abort action) from
the same flight tables and peer seqs, the verdicts and dumps equal but
for their clocks. Launcher jobs, one per package on 2 ranks, run the
same program under ``telemetry_enable``: the plane up at init, the seq
moving with the collectives, the sampler's page, the heartbeat payloads
in the store.
"""

import json
import os
import textwrap
import threading
import types
import urllib.error
import urllib.request

import pytest
import torch

from ompi_tpu.core import pvar as R_pvar
from ompi_tpu.telemetry import flight as R_flight
from ompi_tpu.telemetry import openmetrics as R_om
from ompi_tpu.telemetry import watchdog as R_wd
from ompi_tpu_torch.core import pvar as P_pvar
from ompi_tpu_torch.telemetry import flight as P_flight
from ompi_tpu_torch.telemetry import openmetrics as P_om
from ompi_tpu_torch.telemetry import watchdog as P_wd
from ompi_tpu_torch.telemetry.sampler import Sampler
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse
from tests.test_torch_trace import planes_off, port_job  # noqa: F401

pytestmark = pytest.mark.usefixtures("planes_off")

#: side -> (flight, openmetrics, watchdog, pvar)
SIDES = {"ref": (R_flight, R_om, R_wd, R_pvar),
         "port": (P_flight, P_om, P_wd, P_pvar)}


# ---------------------------------------------------------------------------
# launcher jobs

_PROG = '''
import json, os, time
from {pkg} import telemetry
from {pkg}.runtime import rte
from {pkg}.telemetry import flight
out_dir = {out!r}
doc = {{}}
fl = flight.FLIGHT
doc["up"] = [fl is not None, telemetry.get_sampler() is not None,
             telemetry.get_watchdog() is not None]
before = fl.last_entered
comm.allreduce(rank)
comm.Barrier()
doc["moved"] = fl.last_entered - before
doc["inflight"] = fl.hb_dict()["inflight"]
text = telemetry.get_sampler().sample()
doc["flight_ops"] = "ompi_tpu_telemetry_flight_ops_total" in text
time.sleep(0.5)  # two watchdog sweeps: every rank's seq in the store
doc["hb_ranks"] = sorted(int(k) for k in rte.client().telemetry())
comm.Barrier()
with open(os.path.join(out_dir, f"doc_r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''

_PORT_PRELUDE = '''
from ompi_tpu_torch import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size
'''

_MCA = {"telemetry_enable": "1", "telemetry_watchdog_period": "0.2"}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    ref = tmp_path_factory.mktemp("telem_ref")
    port = tmp_path_factory.mktemp("telem_port")
    run_ranks(_PROG.format(pkg="ompi_tpu", out=str(ref)), 2, mca=_MCA,
              timeout=120, isolate=True)
    port_job(textwrap.dedent(_PORT_PRELUDE)
             + _PROG.format(pkg="ompi_tpu_torch", out=str(port))
             + "\nmpi.Finalize()\n", 2, dict(_MCA))
    return ref, port


def _doc(d, r):
    return json.loads((d / f"doc_r{r}.json").read_text())


# ---------------------------------------------------------------------------
# the flight recorder


def test_flight_enter_exit_seq_semantics():
    got = {}
    for side, (flight, _om, _wd, pvar) in SIDES.items():
        fl = flight.FlightRecorder(rank=3)
        s = pvar.session()
        t1 = fl.enter("allreduce_dev", comm_cid=7, nbytes=1024)
        t2 = fl.enter("bcast_dev")
        oldest = fl.oldest()
        snap = fl.snapshot()
        hb = fl.hb_dict()
        fl.exit(t2)
        fl.exit(t1)  # out of order: the done high-water stays
        got[side] = [(t1, t2), fl.last_entered, fl.last_completed,
                     oldest[:4], [e["seq"] for e in snap],
                     (hb["seq"], hb["done"], hb["inflight"]),
                     hb["arr"] > 0, fl.oldest(), fl.snapshot(),
                     s.read("telemetry_flight_ops"),
                     pvar.read("telemetry_inflight") >= 2]
    assert got["port"] == got["ref"]
    assert got["port"][:3] == [(1, 2), 2, 2]


def test_flight_pml_marks_are_dump_only_detail():
    for side, (flight, *_rest) in SIDES.items():
        fl = flight.FlightRecorder()
        fl.enter("allreduce_dev")
        fl.mark_pml(ctx=5, seq=42)
        assert fl.snapshot()[-1] == {"pml_ctx_seqs": {5: 42}}, side
        assert fl.hb_dict()["seq"] == 1, side


def test_flight_thread_safety_exact_seq_accounting():
    for side, (flight, *_rest) in SIDES.items():
        fl = flight.FlightRecorder()
        n_threads, per = 4, 200
        start = threading.Barrier(n_threads)

        def worker(fl=fl, start=start):
            start.wait()
            for _ in range(per):
                fl.exit(fl.enter("op"))

        ts = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert fl.last_entered == fl.last_completed == n_threads * per
        assert fl.oldest() is None, side


def test_hb_payload_none_while_disabled():
    """The heartbeat stays the 2-tuple while telemetry is off."""
    for side, (flight, *_rest) in SIDES.items():
        assert flight.hb_payload() is None, side
        flight.enable(rank=1, api_hook=False)
        hb = flight.hb_payload()
        assert (hb["seq"], hb["done"], hb["inflight"], hb["arr"]) \
            == (0, 0, 0, 0), side
        flight.disable()


def test_disabled_guard_constructs_nothing(monkeypatch):
    """Telemetry off never touches the flight recorder on coll/device's
    path (one-rank comms: no plane) nor on the reference's coll/xla."""
    import jax.numpy as jnp

    from ompi_tpu.coll import xla as cx
    from ompi_tpu_torch.coll import device as D

    def boom(*a, **k):
        raise AssertionError("flight recorder touched while disabled")

    for flight in (P_flight, R_flight):
        assert flight.FLIGHT is None
        monkeypatch.setattr(flight.FlightRecorder, "enter", boom)
        monkeypatch.setattr(flight.FlightRecorder, "exit", boom)
    comm = types.SimpleNamespace(size=1, rank=0, cid=0)
    s = P_pvar.session()
    x = torch.ones(16)
    D.allreduce_dev(comm, x)
    D.bcast_dev(comm, x)
    D.allreduce_multi_dev(comm, [x, x])
    D.barrier_dev(comm)
    assert s.read("coll_device_launches") == 4  # the path really ran
    ctx = cx._Ctx.local()
    rs = R_pvar.session()
    cx._allreduce_prep(types.SimpleNamespace(_coll_xla_ctx=ctx),
                       jnp.ones(16, jnp.float32))()
    assert rs.read("coll_xla_launches") >= 1


def test_api_hook_installs_and_detaches():
    """Enabling interposes the blocking collectives of the port's API
    (the reference's list) through its PMPI chain; disabling restores
    them exactly."""
    import ompi_tpu_torch.mpi  # noqa: F401 — binds the API methods
    from ompi_tpu_torch.comm import Communicator

    assert P_flight.API_COLLECTIVES == R_flight.API_COLLECTIVES
    originals = {n: getattr(Communicator, n)
                 for n in P_flight.API_COLLECTIVES}
    assert len(originals) == len(P_flight.API_COLLECTIVES)
    P_flight.enable(rank=0, api_hook=True)
    try:
        for name, orig in originals.items():
            wrapped = getattr(Communicator, name)
            assert wrapped is not orig, name
            assert getattr(wrapped, "__profiled__", False), name
    finally:
        P_flight.disable()
    for name, orig in originals.items():
        assert getattr(Communicator, name) is orig, name


# ---------------------------------------------------------------------------
# OpenMetrics


def test_openmetrics_full_pvar_roundtrip():
    """Every registered pvar of either package round-trips through the
    port's exposition with counter / watermark semantics, and the port
    renders the reference's snapshot as the reference does."""
    names = sorted(set(P_pvar.WELL_KNOWN) | set(R_pvar.WELL_KNOWN))
    snap = {name: i + 1 for i, name in enumerate(names)}
    snap["part_inflight_hwm"] = 7
    labels = {"rank": "2", "job": "j1"}
    text = P_om.render(snap, labels)
    assert text == R_om.render(snap, labels)
    assert text.rstrip().endswith("# EOF")
    parsed = P_om.parse(text)
    lbl = '{job="j1",rank="2"}'
    for name, value in snap.items():
        assert parsed[name] == {lbl: value}, name
        metric = P_om.PREFIX + name
        if name.endswith("_hwm"):
            assert f"# TYPE {metric} gauge" in text
        else:
            assert f"{metric}_total{lbl} {value}" in text


def test_openmetrics_gauge_override_and_aggregate():
    for side, (_f, om, *_rest) in SIDES.items():
        text = om.render({"telemetry_seq_entered": 5},
                         gauges=("telemetry_seq_entered",))
        assert "ompi_tpu_telemetry_seq_entered 5" in text, side
        assert "_total" not in text, side
        agg = om.aggregate([{"allreduce": 3, "depth_hwm": 4},
                            {"allreduce": 5, "depth_hwm": 2}])
        assert agg == {"allreduce": 8, "depth_hwm": 4}, side


_HIST = {
    "trace_hist_allreduce_dev_sz10_lat0": 2,
    "trace_hist_allreduce_dev_sz10_lat14": 7,
    "trace_hist_allreduce_dev_sz10_lat15": 1,
    "trace_hist_allreduce_dev_sz4_lat13": 4,
    "allreduce": 5,
}


def test_openmetrics_histogram_family_shape():
    text = P_om.render(_HIST, {"rank": "0"})
    assert text == R_om.render(_HIST, {"rank": "0"})
    fam = P_om.PREFIX + "trace_hist_allreduce_dev"
    assert text.count(f"# TYPE {fam} ") == 1
    assert f'{fam}_bucket{{le="1",rank="0",sz="10"}} 2' in text
    assert f'{fam}_bucket{{le="16384",rank="0",sz="10"}} 9' in text
    assert f'{fam}_bucket{{le="32768",rank="0",sz="10"}} 10' in text
    assert f'{fam}_bucket{{le="+Inf",rank="0",sz="10"}} 10' in text
    assert f'{fam}_count{{rank="0",sz="10"}} 10' in text
    assert f'{fam}_bucket{{le="+Inf",rank="0",sz="4"}} 4' in text
    assert 'ompi_tpu_allreduce_total{rank="0"} 5' in text


def test_openmetrics_histogram_parse_aggregate_roundtrip():
    a = {"trace_hist_allreduce_dev_sz10_lat0": 2,
         "trace_hist_allreduce_dev_sz10_lat14": 7,
         "trace_hist_bcast_sz0_lat12": 9,
         "allreduce": 3, "telemetry_flight_ops_hwm": 5}
    b = {"trace_hist_allreduce_dev_sz10_lat14": 4,
         "allreduce": 2, "telemetry_flight_ops_hwm": 1}
    for side, (_f, om, *_rest) in SIDES.items():
        flat = {}
        for snap, rank in ((a, "0"), (b, "1")):
            parsed = om.parse(om.render(snap, {"rank": rank}))
            got = {k: v['{rank="%s"}' % rank] for k, v in parsed.items()}
            assert got == snap, (side, got, snap)
            flat[rank] = got
        agg = om.aggregate([flat["0"], flat["1"]])
        assert agg == om.aggregate([a, b]), side
        assert agg["trace_hist_allreduce_dev_sz10_lat14"] == 11
        assert agg["telemetry_flight_ops_hwm"] == 5


def test_openmetrics_monitoring_labels():
    """The monitoring plane's per-cell, per-link and per-expert pvars and
    the tune plane's per-provider counters render as labelled families
    (the port's providers: device, cuda, hier)."""
    snap = {"monitoring_tx_bytes_s0_d1_p2p": 2048,
            "monitoring_tx_msgs_s0_d1_p2p": 2,
            "monitoring_link_bytes_d0_r0_r1_hwm": 4096,
            "monitoring_expert_tokens_e3": 17}
    text = P_om.render(snap, labels={"rank": "0"})
    assert text == R_om.render(snap, labels={"rank": "0"})
    assert ('ompi_tpu_monitoring_tx_bytes_total'
            '{ctx="p2p",dst="1",rank="0",src="0"} 2048') in text
    assert ('ompi_tpu_monitoring_link_bytes'
            '{dim="0",rank="0",rank_a="0",rank_b="1"} 4096') in text
    assert ('ompi_tpu_monitoring_expert_tokens_total'
            '{expert="3",rank="0"} 17') in text
    assert P_om.parse(text)["monitoring_link_bytes"][
        '{dim="0",rank="0",rank_a="0",rank_b="1"}'] == 4096
    tune = P_om.render({"tune_obs_allreduce_cuda": 3})
    assert 'ompi_tpu_tune_observed_total{op="allreduce",provider="cuda"} 3' \
        in tune


# ---------------------------------------------------------------------------
# the sampler


def test_sampler_file_export_and_flight_gauges(tmp_path):
    fl = P_flight.enable(rank=0, api_hook=False)
    fl.enter("allreduce_dev")
    path = str(tmp_path / "metrics_rank{rank}.txt")
    smp = Sampler(rank=4, jobid="jf", size=1, interval=3600, port=0,
                  path=path, rollup=False)
    try:
        smp.start()
        smp.sample()
        text = open(str(tmp_path / "metrics_rank4.txt")).read()
    finally:
        smp.stop()
    assert text.rstrip().endswith("# EOF")
    parsed = P_om.parse(text)
    lbl = '{job="jf",rank="4"}'
    assert parsed["telemetry_seq_entered"][lbl] == 1
    assert parsed["telemetry_inflight_now"][lbl] == 1
    assert parsed["telemetry_samples"][lbl] >= 1


def test_sampler_http_endpoint():
    smp = Sampler(rank=0, jobid="jh", size=1, interval=3600, port=-1,
                  path="", rollup=False)
    try:
        smp.start()
        smp.sample()  # the page after a sample: telemetry_samples counted
        host, port = smp.http_addr[:2]
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=5) as resp:
            assert resp.status == 200
            assert "openmetrics-text" in resp.headers["Content-Type"]
            body = resp.read().decode()
        assert body.rstrip().endswith("# EOF")
        assert "ompi_tpu_telemetry_samples_total" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=5)
    finally:
        smp.stop()


def test_sampler_kvstore_rollup():
    from ompi_tpu_torch.runtime import kvstore

    store = kvstore.Store().start()
    s0 = s1 = None
    try:
        s1 = Sampler(rank=1, jobid="jr", size=2, interval=3600, port=0,
                     path="", rollup=True,
                     client=kvstore.Client(store.addr))
        s1.sample()
        s1.sample()  # rank 1's published page counts its first sample
        s0 = Sampler(rank=0, jobid="jr", size=2, interval=3600, port=0,
                     path="", rollup=True,
                     client=kvstore.Client(store.addr))
        text = s0.sample()
        parsed = P_om.parse(text)
        job_lbl = next(lb for lb in parsed["telemetry_samples"]
                       if 'scope="job"' in lb)
        assert 'ranks="2"' in job_lbl
        rank_lbl = '{job="jr",rank="0"}'
        assert parsed["telemetry_samples"][job_lbl] \
            >= parsed["telemetry_samples"][rank_lbl] + 1
        assert text.rstrip().endswith("# EOF")
    finally:
        for smp in (s0, s1):
            if smp is not None:
                smp.stop()
        store.stop()


def test_kvstore_heartbeat_payload_roundtrip():
    """The port's store keeps each rank's latest heartbeat payload; a
    payload-less heartbeat keeps it (the reference's protocol)."""
    from ompi_tpu_torch.runtime import kvstore

    store = kvstore.Store().start()
    try:
        c = kvstore.Client(store.addr)
        c.heartbeat(0)
        assert c.telemetry() == {}
        c.heartbeat(1, {"seq": 9, "done": 8, "inflight": 1})
        c.heartbeat(0, {"seq": 11, "done": 11, "inflight": 0})
        telem = c.telemetry()
        assert telem[0]["seq"] == 11 and telem[1]["seq"] == 9
        c.heartbeat(0)
        assert c.telemetry()[0]["seq"] == 11
        assert c.faults(None) == {}  # heartbeats declared nobody dead
        c.close()
    finally:
        store.stop()


# ---------------------------------------------------------------------------
# the watchdog


class _FakeClient:
    """Injected store client: records heartbeats, serves peer seqs."""

    def __init__(self, peers=None):
        self.peers = dict(peers or {})
        self.beats = []

    def heartbeat(self, rank, payload=None):
        self.beats.append((rank, payload))

    def telemetry(self):
        return dict(self.peers)

    def close(self):
        pass


def _stuck_watchdog(side, tmp_path, peers, dead, world=range(2), **kw):
    """Rank 0 with collective seq 2 in flight, timeout 0 (the first
    sweep evaluates the stuck branch)."""
    flight, _om, wd_mod, _pv = SIDES[side]
    fl = flight.FlightRecorder()
    fl.exit(fl.enter("warmup"))
    fl.enter("allreduce_dev", comm_cid=3, nbytes=256)
    client = _FakeClient(peers)
    d = tmp_path / side
    wd = wd_mod.Watchdog(rank=0, jobid="jw", world=world, client=client,
                         flight_rec=fl, dead_fn=lambda: dead,
                         period=3600, timeout=0.0, action="dump",
                         dump_dir=str(d), **kw)
    return wd, fl, client


def _stable(v):
    """A verdict without its clocks (waits and arrival lateness)."""
    if v is None:
        return None
    v = dict(v)
    v.pop("waited_s", None)
    if "arrivals" in v:
        v["arrivals"] = {r: a["seq"] for r, a in v["arrivals"].items()}
    return v


def test_watchdog_names_straggler_and_dumps(tmp_path):
    got = {}
    for side in SIDES:
        wd, fl, client = _stuck_watchdog(
            side, tmp_path, peers={1: {"seq": 1, "done": 1, "inflight": 0}},
            dead={})
        v = wd.sweep()
        beats = [(r, p["seq"], p["done"], p["inflight"])
                 for r, p in client.beats]
        doc = json.load(open(wd._dumped[(2, "hang")]))
        wd.sweep()
        dumped = list(wd._dumped)
        fl.exit(2)
        cleared = wd.sweep() is None and wd.verdict is None
        got[side] = (_stable(v), beats, doc["verdict"]["stragglers"],
                     doc["inflight"][0]["op"],
                     "telemetry_watchdog_sweeps" in doc["pvars"],
                     dumped, cleared)
    assert got["port"] == got["ref"]
    v = got["port"][0]
    assert v["stragglers"] == [1] and v["op"] == "allreduce_dev"
    assert v["peer_seqs"] == {0: 2, 1: 1}
    assert got["port"][1:] == ([(0, 2, 1, 1)], [1], "allreduce_dev", True,
                               [(2, "hang")], True)


def test_watchdog_verdict_arrival_lateness(tmp_path):
    for side in SIDES:
        wd, fl, client = _stuck_watchdog(side, tmp_path, peers={}, dead={},
                                         world=range(4))
        fl.last_arrival_ns -= 40_000_000_000
        client.peers[1] = {"seq": 2, "done": 1, "inflight": 1,
                           "arr": fl.last_arrival_ns + 40_000_000_000}
        client.peers[3] = {"seq": 1, "done": 1, "inflight": 0,
                           "arr": fl.last_arrival_ns + 1_000_000_000}
        v = wd.sweep()
        assert sorted(v["stragglers"]) == [2, 3], side
        arr = v["arrivals"]
        assert arr[0]["seq"] == 2 and arr[0]["late_s"] == 0.0
        assert arr[1]["seq"] == 2 and 39.0 <= arr[1]["late_s"] <= 41.0
        assert arr[2]["seq"] == 0 and arr[2]["late_s"] is None
        assert arr[3]["seq"] == 1 and arr[3]["late_s"] >= 39.0
        dumped = json.load(open(wd._dumped[(2, "hang")]))["verdict"]
        assert dumped["arrivals"]["1"]["late_s"] >= 39.0
        assert dumped["arrivals"]["2"]["late_s"] is None


def test_watchdog_healthy_below_timeout(tmp_path):
    for side in SIDES:
        wd, fl, _ = _stuck_watchdog(side, tmp_path, peers={}, dead={})
        wd.timeout = 3600.0
        assert wd.sweep() is None and wd._dumped == {}, side


def test_dead_rank_resolves_hang_verdict_naming_it(tmp_path):
    for side in SIDES:
        dead = {}
        wd, fl, _ = _stuck_watchdog(
            side, tmp_path, peers={1: {"seq": 1, "done": 1, "inflight": 0}},
            dead=dead)
        assert wd.sweep()["stragglers"] == [1]
        dead[1] = "heartbeat timeout"
        assert wd.sweep() is None and wd.verdict is None, side


def test_watchdog_dead_only_gap_is_not_a_hang(tmp_path):
    for side in SIDES:
        wd, fl, _ = _stuck_watchdog(
            side, tmp_path, peers={1: {"seq": 1, "done": 1, "inflight": 0}},
            dead={1: "killed"})
        assert wd.sweep() is None and wd.verdict is None, side
        assert wd._dumped == {}, side


def test_watchdog_abort_action_reaches_rte(tmp_path, monkeypatch):
    from ompi_tpu.runtime import rte as R_rte
    from ompi_tpu_torch.runtime import rte as P_rte

    for side, rte in (("ref", R_rte), ("port", P_rte)):
        aborts = []
        monkeypatch.setattr(rte, "abort",
                            lambda reason, code=1, a=aborts: a.append(reason))
        wd, fl, _ = _stuck_watchdog(
            side, tmp_path, peers={1: {"seq": 1, "done": 1, "inflight": 0}},
            dead={})
        wd.action = "abort"
        wd.sweep()
        assert len(aborts) == 1 and "allreduce_dev" in aborts[0], side


def test_hang_event_fields_match_reference(tmp_path):
    """A hang verdict raises ``telemetry_hang`` with the reference's
    payload (the dump's path aside) while a tool listens."""
    from ompi_tpu.core import events as R_events
    from ompi_tpu_torch.core import events as P_events

    got = {}
    for side, events in (("ref", R_events), ("port", P_events)):
        seen = []
        h = events.handle_alloc("telemetry_hang",
                                callback=lambda e, s=seen: s.append(e.data))
        try:
            wd, fl, _ = _stuck_watchdog(
                side, tmp_path,
                peers={1: {"seq": 1, "done": 1, "inflight": 0}}, dead={})
            wd.sweep()
        finally:
            h.free()
        got[side] = [{k: v for k, v in d.items()
                      if k not in ("waited_s", "dump_path")} for d in seen]
    assert got["port"] == got["ref"] == [
        {"op": "allreduce_dev", "seq": 2, "comm_cid": 3,
         "stragglers": (1,)}]


# ---------------------------------------------------------------------------
# end to end


def test_telemetry_enabled_two_ranks_end_to_end(jobs):
    """``telemetry_enable`` brings the flight recorder, the sampler and
    the watchdog up at init; the blocking collectives move the seq as
    the reference's do; the sampler's page counts the entries; every
    rank's seq payload reaches the store."""
    ref, port = jobs
    for r in range(2):
        a, b = _doc(ref, r), _doc(port, r)
        assert b == a, (r, b, a)
        assert b["up"] == [True, True, True] and b["moved"] == 2
        assert b["inflight"] == 0 and b["flight_ops"]
        assert b["hb_ranks"] == [0, 1]


def test_telemetry_requested_env_and_cvar(monkeypatch):
    """``requested()`` reads the cvar and the short env knob, as the
    reference's."""
    from ompi_tpu import telemetry as R_tel
    from ompi_tpu_torch import telemetry as P_tel

    for tel in (R_tel, P_tel):
        monkeypatch.delenv("OMPI_TPU_TELEMETRY", raising=False)
        assert tel.requested() is False
        monkeypatch.setenv("OMPI_TPU_TELEMETRY", "1")
        assert tel.requested() is True
        monkeypatch.setenv("OMPI_TPU_TELEMETRY", "off")
        assert tel.requested() is False
        assert tel.get_sampler() is None and tel.get_watchdog() is None


def test_cvars_match_reference():
    """The port registers the reference's telemetry cvars with the same
    defaults, so ``compat.mca_from_reference`` passes the reference's
    settings through unchanged."""
    import ompi_tpu.telemetry.sampler  # noqa: F401 — registers its cvars
    import ompi_tpu.telemetry.watchdog  # noqa: F401
    from ompi_tpu.core import cvar as R_cvar
    from ompi_tpu_torch import compat
    from ompi_tpu_torch.core import cvar as P_cvar

    ref = {n: v.default for n, v in R_cvar._registry._vars.items()
           if n.startswith("telemetry_")}
    port = {n: v.default for n, v in P_cvar._registry._vars.items()
            if n.startswith("telemetry_")}
    assert port == ref, (port, ref)
    assert compat.mca_from_reference({k: str(v) for k, v in ref.items()}) \
        == {k: str(v) for k, v in ref.items()}


def test_clock_helpers_match_reference():
    from ompi_tpu.telemetry import clock as R_clock
    from ompi_tpu_torch.telemetry import clock as P_clock

    off, err = P_clock.sample_offset()
    roff, _rerr = R_clock.sample_offset()
    assert abs(off - roff) < 50_000_000 and 0 <= err < 50_000_000
    for a, b in ((5, 3), (None, 3), (5, None)):
        assert P_clock.shift_ns(a, b) == R_clock.shift_ns(a, b)
    assert P_clock.pair_err_ns(3, -2) == R_clock.pair_err_ns(3, -2) == 3


def test_monitoring_cost_part_tiny(tmp_path):
    """The card's phase 17 C at the CPU example widths: the monitoring
    plane switched between levels 0, 1 and 2 in turns inside
    ``moe_serving.py``'s job, the outputs bitwise at every level, the K2
    launches as derived, every level timed, and the job's own plane back
    after (its report parts and Finalize dump untouched)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "moe")
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
         "4", "--timeout", "200", "--mca", "device_plane", "on", "--mca",
         "monitoring_level", "1", "--mca", "device_plane_platform", "cpu",
         os.path.join("ompi_tpu_torch", "examples", "moe_serving.py"),
         "--width", "tiny", "--parts", "monitoring", "--out", out],
        cwd=root, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    for rank in range(4):
        d = json.load(open(os.path.join(out, f"rank{rank}.json")))
        assert all(c["ok"] for c in d["cases"]), d["cases"]
        mon = d["parts"]["monitoring"]
        assert sorted(mon["levels"]) == ["0", "1", "2"]
        assert all(len(v["ms"]) == 32 for v in mon["levels"].values())
        assert mon["k2"]["got"] == mon["k2"]["derived"] > 0
