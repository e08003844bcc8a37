"""The port's collective performance observatory (``tune/``: the
``OBSERVER`` guard and ``Observer``, the PerfDB, the crossover /
candidate-table / regression report, its CLI and the cvars) against the
JAX package's: the counterparts of ``tests/test_tune.py``'s 10 cases.

In this process both packages run the same steps on the same samples,
the reference's provider names mapped to the port's (``pallas`` ->
``cuda``, ``xla`` -> ``device``), and their answers must be equal: the
PerfDB documents, merges and corrupt-file handling, the off state, the
crossovers, candidate tables and named regression verdicts, the CLI's
output and files. The candidate tables parse through the port's own
readers (``coll/cuda._switchpoint``, ``coll/hier._switchpoint``) and
select the measured winner; a table that does not load counts in
``tune_table_errors``; the OpenMetrics family folds the port's providers.

Launcher jobs of the port, one per layout: on 2 ranks
``ompi_tpu_torch/examples/tune_observe.py`` under ``coll_cuda`` (each
launch attributed to the provider that served, the per-rank dumps, the
store merge and rank 0's PerfDB fold, whose candidates the reader
accepts); on 4 ranks coll/hier's (2, 2) grid, the key its switchpoint
table selects on.
"""

import json
import os
import sys
import tempfile
import textwrap

import pytest

from ompi_tpu.core import pvar as R_pvar
from ompi_tpu.tune import __main__ as R_cli
from ompi_tpu.tune import observe as R_obs
from ompi_tpu.tune import perfdb as R_db
from ompi_tpu.tune import report as R_rep
from ompi_tpu_torch.core import cvar as P_cvar, pvar as P_pvar
from ompi_tpu_torch.runtime import launcher as P_launcher
from ompi_tpu_torch.tune import __main__ as P_cli
from ompi_tpu_torch.tune import observe as P_obs
from ompi_tpu_torch.tune import perfdb as P_db
from ompi_tpu_torch.tune import report as P_rep
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: side -> (observe, perfdb, report, CLI, pvar, providers: reference name
#: -> this side's)
SIDES = {"ref": (R_obs, R_db, R_rep, R_cli, R_pvar,
                 {"pallas": "pallas", "xla": "xla", "hier": "hier"}),
         "port": (P_obs, P_db, P_rep, P_cli, P_pvar,
                  {"pallas": "cuda", "xla": "device", "hier": "hier"})}
#: the port's names of the reference's words in documents and text
TO_PORT = (("pallas-vs-xla", "cuda-vs-device"), ("pallas", "cuda"),
           ("xla", "device"))


def to_port(obj):
    """A reference document (or text) in the port's provider names."""
    text = json.dumps(obj) if not isinstance(obj, str) else obj
    for a, b in TO_PORT:
        text = text.replace(a, b)
    return json.loads(text) if not isinstance(obj, str) else text


def _stats(side, samples):
    """An observer stats table from (key, durations) pairs, the key's
    provider in the reference's name."""
    obs_mod, *_rest, prov = SIDES[side]
    obs = obs_mod.Observer(rank=0)
    for (op, dt, lg, mesh, p, algo), durs in samples:
        for d in durs:
            obs.sample(op, dt, lg, mesh, prov[p], algo, d)
    return obs.snapshot()


@pytest.fixture
def observers_off():
    for m in (R_obs, P_obs):
        m.disable()
    yield
    for m in (R_obs, P_obs):
        m.disable()


# ---------------------------------------------------------------------------
# PerfDB persistence + merge


KEY = ("allreduce", "float32", 20, (2,), "pallas", "ring")


def test_perfdb_roundtrip_and_associative_merge(tmp_path):
    got = {}
    for side, (_o, db, _r, _c, _p, prov) in SIDES.items():
        a = _stats(side, [(KEY, [100, 200, 300])])
        b = _stats(side, [(KEY, [400]),
                          (("bcast", "int32", 10, (4,), "xla", "auto"),
                           [50])])
        c = _stats(side, [(KEY, [800, 900])])
        path = str(tmp_path / f"{side}_db.json")
        assert db.save(path, db.doc_of(a, "cpu", 2))
        doc = db.load(path)
        assert doc["schema"] == db.SCHEMA == "ompi_tpu.tune.perfdb/1"
        assert db.stats_of(doc["entries"]) == a
        docs = [db.doc_of(s, "cpu", 2) for s in (a, b, c)]
        left = db.merge([db.merge(docs[:2]), docs[2]])
        right = db.merge([docs[0], db.merge(docs[1:])])
        assert db.stats_of(left["entries"]) == \
            db.stats_of(right["entries"])
        key = KEY[:4] + (prov["pallas"],) + KEY[5:]
        rec = db.stats_of(left["entries"])[key]
        assert rec[0] == 6 and rec[1] == 2700
        assert rec[2] == 100 and rec[3] == 900 and sum(rec[4].values()) == 6
        assert left["runs"] == 3
        got[side] = left
    assert got["port"] == to_port(got["ref"])


def test_perfdb_corrupt_degrades_to_empty(tmp_path):
    got = {}
    for side, (_o, db, _r, _c, pvar, _p) in SIDES.items():
        s = pvar.session()
        d = tmp_path / side
        d.mkdir()
        seen = [db.load(str(d / "nope.json"))["entries"],
                s.read("tune_db_errors")]
        (d / "garbage.json").write_text("{not json")
        doc = db.load(str(d / "garbage.json"))
        seen += [doc["entries"], doc["runs"], s.read("tune_db_errors")]
        (d / "alien.json").write_text(
            json.dumps({"schema": "other/1", "entries": []}))
        seen += [db.load(str(d / "alien.json"))["entries"],
                 s.read("tune_db_errors")]
        (d / "broken.json").write_text(json.dumps(
            {"schema": db.SCHEMA, "entries": [{"op": "x"}]}))
        seen += [db.load(str(d / "broken.json"))["entries"],
                 s.read("tune_db_errors")]
        got[side] = seen
    assert got["port"] == got["ref"] == [[], 0, [], 0, 1, [], 2, [], 3]


def test_observe_level_zero_plane_is_off(observers_off):
    import ompi_tpu.tune as R_tune
    import ompi_tpu_torch.tune as P_tune

    for tune, obs in ((R_tune, R_obs), (P_tune, P_obs)):
        assert obs.OBSERVER is None
        assert not tune.requested()
        assert tune.regression_info() is None
        tune.stop()  # idempotent no-op with the guard down
        assert obs.OBSERVER is None


# ---------------------------------------------------------------------------
# crossovers + candidate tables + regressions


def _crossover_samples():
    return [
        (("allreduce", "float32", 20, (2,), "pallas", "ring"), [1000] * 8),
        (("allreduce", "float32", 20, (2,), "xla", "auto"), [5000] * 8),
        (("allreduce", "float32", 24, (2, 2), "hier", "hier"), [9000] * 8),
        (("allreduce", "float32", 24, (4,), "xla", "auto"), [3000] * 8),
    ]


def test_crossovers_and_candidate_tables_accepted_by_readers(tmp_path):
    """The emitted candidate tables parse through the port's coll/cuda
    and coll/hier readers verbatim and select the measured winner; the
    rows and tables equal the reference's."""
    from ompi_tpu_torch.coll import cuda as ccuda
    from ompi_tpu_torch.coll import hier as chier

    out = {}
    for side in SIDES:
        rep = SIDES[side][2]
        stats = _stats(side, _crossover_samples())
        out[side] = (rep.crossovers(stats), rep.candidate_tables(stats))
    assert list(out["port"]) == to_port(list(out["ref"]))
    rows, tables = out["port"]
    pairs = {r["pair"]: r for r in rows}
    assert pairs["cuda-vs-device"]["winner"] == "cuda"
    assert pairs["cuda-vs-device"]["speedup"] > 2.0
    assert pairs["hier-vs-flat"]["winner"] == "device"
    cpath, hpath = tmp_path / "cand_cuda.json", tmp_path / "cand_hier.json"
    cpath.write_text(json.dumps(tables["cuda"]))
    hpath.write_text(json.dumps(tables["hier"]))
    try:
        P_cvar.set("coll_cuda_switchpoints", str(cpath))
        ccuda._sw_cache.clear()
        assert ccuda._switchpoint("allreduce", 1 << 20, "float32",
                                  (2,)) == "ring"
        P_cvar.set("coll_hier_switchpoints", str(hpath))
        chier._sw_cache.clear()
        assert chier._switchpoint("allreduce", 1 << 24, "float32",
                                  (2, 2)) == "flat"
    finally:
        P_cvar.set("coll_cuda_switchpoints", "")
        P_cvar.set("coll_hier_switchpoints", "")
        ccuda._sw_cache.clear()
        chier._sw_cache.clear()


def test_regression_verdicts_named():
    key = ("allreduce", "float32", 24, (2, 2), "hier", "hier")
    got = {}
    for side in SIDES:
        rep = SIDES[side][2]
        base = _stats(side, [(key, [4096] * 10)])
        cur = _stats(side, [(key, [4096 * 8] * 10)])
        regs = rep.regressions(cur, base, threshold=1.5)
        assert rep.regressions(base, base, threshold=1.5) == []
        got[side] = (regs, rep.render(cur, baseline=base))
    assert got["port"][0] == to_port(got["ref"][0])
    regs, text = got["port"]
    assert len(regs) == 1 and regs[0]["ratio"] == pytest.approx(8.0)
    assert "allreduce float32 2^24 on 2x2 [hier/hier]" in regs[0]["verdict"]
    assert "slower than PerfDB baseline" in regs[0]["verdict"]
    assert "REGRESSION: allreduce float32 2^24" in text
    assert text == to_port(got["ref"][1])


def test_switchpoint_table_errors_are_counted(tmp_path):
    """A malformed table file counts in tune_table_errors (each load
    attempt) and the readers go on with the built-in thresholds."""
    from ompi_tpu_torch.coll import cuda as ccuda
    from ompi_tpu_torch.coll import hier as chier

    bad = tmp_path / "bad_table.json"
    bad.write_text("{not json")
    s = P_pvar.session()
    try:
        P_cvar.set("coll_cuda_switchpoints", str(bad))
        ccuda._sw_cache.clear()
        assert ccuda._switchpoint("allreduce", 1 << 20, "float32",
                                  (2,)) == ""
        assert s.read("tune_table_errors") == 1
        P_cvar.set("coll_hier_switchpoints", str(bad))
        chier._sw_cache.clear()
        assert chier._switchpoint("allreduce", 1 << 20, "float32",
                                  (2, 2)) == ""
        assert s.read("tune_table_errors") == 2
    finally:
        P_cvar.set("coll_cuda_switchpoints", "")
        P_cvar.set("coll_hier_switchpoints", "")
        ccuda._sw_cache.clear()
        chier._sw_cache.clear()


def test_tune_cli_report(tmp_path, capsys):
    """The report CLI on both packages: the merged doc, the candidate
    tables and the regression verdicts against --db equal (in the
    port's names); missing or corrupt input is one stderr line and
    exit 1."""
    key = ("allreduce", "float32", 20, (2,), "pallas", "ring")
    got = {}
    for side, (_o, db, _r, cli, _p, prov) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        stats = _stats(side, _crossover_samples())
        fast = _stats(side, [(key, [100] * 10)])
        for r in range(2):
            (d / f"tune_r{r}.json").write_text(
                json.dumps(db.doc_of(stats, "cpu", 2)))
        (d / "baseline.json").write_text(
            json.dumps(db.doc_of(fast, "cpu", 2)))
        capsys.readouterr()
        assert cli.main(["report", str(d / "tune_r0.json"),
                         str(d / "tune_r1.json"), "--db",
                         str(d / "baseline.json"), "--json",
                         str(d / "merged.json"), "--tables",
                         str(d / "cand")]) == 0
        text = capsys.readouterr().out.replace(str(d), "DIR")
        merged = json.loads((d / "merged.json").read_text())
        kind = prov["pallas"]
        cand = json.loads((d / f"cand_{kind}.json").read_text())
        hier = json.loads((d / "cand_hier.json").read_text())
        pkey = key[:4] + (kind,) + key[5:]
        assert db.stats_of(merged["entries"])[pkey][0] == 16
        assert cand and cand[0]["algorithm"] == "ring"
        errs = [cli.main(["report", str(d / "missing.json")])]
        (d / "bad.json").write_text("garbage")
        errs += [cli.main(["report", str(d / "bad.json")]),
                 cli.main(["report", str(d / "tune_r0.json"), "--db",
                           str(d / "bad.json")])]
        err = capsys.readouterr().err
        assert errs == [1, 1, 1] and len(err.strip().splitlines()) == 3
        got[side] = (text, merged, cand, hier)
    assert list(got["port"]) == to_port(list(got["ref"]))


def test_openmetrics_tune_family():
    from ompi_tpu_torch.telemetry import openmetrics as om

    snap = {"tune_obs_allreduce_cuda": 7, "tune_obs_allreduce_device": 3,
            "tune_samples": 10}
    text = om.render(snap, labels={"rank": "0"})
    assert ('ompi_tpu_tune_observed_total'
            '{op="allreduce",provider="cuda",rank="0"} 7') in text
    assert ('ompi_tpu_tune_observed_total'
            '{op="allreduce",provider="device",rank="0"} 3') in text
    assert 'ompi_tpu_tune_samples_total{rank="0"} 10' in text
    assert text.count("# TYPE ompi_tpu_tune_observed counter") == 1
    assert om.parse(text)["tune_observed"][
        '{op="allreduce",provider="cuda",rank="0"}'] == 7


# ---------------------------------------------------------------------------
# launcher jobs


def _job(src_or_path, n: int, mca: dict, args=()) -> int:
    if src_or_path.endswith(".py"):
        return P_launcher.launch([sys.executable, src_or_path, *args], n,
                                 mca=mca, timeout=150)
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(src_or_path)
        path = fh.name
    try:
        return P_launcher.launch([sys.executable, path, *args], n, mca=mca,
                                 timeout=150)
    finally:
        os.unlink(path)


def test_observatory_two_ranks_mixed_providers(tmp_path):
    """tune_observe=1 over mixed coll/cuda + coll/device collectives
    (the tune_observe example): each launch attributed to the provider
    that served, per-rank dumps at Finalize, the store merge and rank 0's
    fold into the PerfDB — whose candidate tables the reader accepts."""
    from ompi_tpu_torch.coll import cuda as ccuda

    rc = _job(os.path.join(ROOT, "ompi_tpu_torch", "examples",
                           "tune_observe.py"), 2,
              {"device_plane": "on", "device_plane_platform": "cpu",
               "coll_cuda": "on", "tune_observe": "1",
               "tune_dump": str(tmp_path / "tune_r{rank}.json"),
               "tune_db_dir": str(tmp_path)},
              ["--out", str(tmp_path)])
    assert rc == 0, rc
    for r in range(2):
        doc = json.loads((tmp_path / f"tune_r{r}.json").read_text())
        assert doc["schema"] == P_db.SCHEMA and doc["device_kind"] == "cpu"
        rank = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert all(c["ok"] for c in rank["cases"]), rank["cases"]
    db = json.loads((tmp_path / "tune_perfdb_cpu_n2.json").read_text())
    stats = P_db.stats_of(db["entries"])
    key = next(k for k in stats if k[0] == "allreduce" and k[4] == "cuda")
    assert stats[key][0] == 6, stats[key]  # 2 ranks x 3 launches
    assert {k[4] for k in stats} == {"cuda", "device"}
    tables = P_rep.candidate_tables(stats)
    assert tables["cuda"], P_rep.crossovers(stats)
    p = tmp_path / "cand_cuda.json"
    p.write_text(json.dumps(tables["cuda"]))
    try:
        P_cvar.set("coll_cuda_switchpoints", str(p))
        ccuda._sw_cache.clear()
        e = tables["cuda"][0]
        assert ccuda._switchpoint(e["op"], 1 << e["log2"], e["dtype"],
                                  tuple(e["mesh"])) == e["algorithm"]
    finally:
        P_cvar.set("coll_cuda_switchpoints", "")
        ccuda._sw_cache.clear()


_HIER = textwrap.dedent('''
    import json, sys
    import torch
    from ompi_tpu_torch import mpi
    from ompi_tpu_torch.core import pvar
    from ompi_tpu_torch.tune import observe
    import ompi_tpu_torch.tune as tune
    comm = mpi.Init()
    assert observe.OBSERVER is not None
    s = pvar.session()
    x = torch.arange(2048, dtype=torch.float32) + comm.rank
    comm.coll.allreduce_dev(comm, x)
    assert s.read("tune_obs_allreduce_hier") == 1
    stats = observe.OBSERVER.snapshot()
    key = next(k for k in stats if k[4] == "hier")
    op, dt, lg, mesh, prov, algo = key
    assert (op, dt, mesh, algo) == ("allreduce", "float32", (2, 2),
                                    "hier"), key
    tune.stop()
    assert observe.OBSERVER is None
    mpi.Finalize()
''')


def test_observatory_hier_four_ranks():
    """coll/hier's samples key on its (n_dcn, n_ici) grid, the shape its
    switchpoint table selects on."""
    assert _job(_HIER, 4, {"device_plane": "on",
                           "device_plane_platform": "cpu",
                           "coll_hier": "on", "coll_hier_split": "2x2",
                           "tune_observe": "1"}) == 0
