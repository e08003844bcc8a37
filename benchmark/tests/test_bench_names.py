"""BENCHMARK.json against the benchmark's contract: its keys, the
characters of names and units, the files it names, and each cell's
files found by name."""

import json
import os

import pytest

from benchmark.lib import cells
from benchmark.tests.helpers import BENCH, REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    B = json.load(f)


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 << 10


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            yield e["name"]
    for w in B["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in B["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert cells.NAME.match(name)


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert cells.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    names = [x["name"] for x in B["end_to_end"]]
    if m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert m["moves"] in names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert os.path.exists(cells.path("metrics", m["name"], ".py"))


def test_unique_names_and_pairs():
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in B[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(ms) == len(set(ms))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in ms


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(w):
    files = cells.cell(w["name"])
    assert files["cell"]["config"] == w["config"]
    assert files["cell"]["traffic"] == w["traffic"]
    assert files["cell"]["chips"] == w["chips"] in (1, 4)
    assert files["config"]["name"] == w["config"]
    assert files["traffic"]["name"] == w["traffic"]
    assert os.path.exists(cells.driver_path(files["cell"]["driver"]))
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    checks = files["cell"]["checks"]
    linear = files["traffic"]["deterministic"] == "linear"
    assert set(checks) == {"grad1_gap", "change3_gap", "final_param_err",
                           "final_mom_err"} | (
        {"bitwise_mismatch"} if linear else set())
    if linear:  # an exact comparison
        assert checks["bitwise_mismatch"] == 0
    # the bucket size and the ranks are the configuration's, stated once
    dep = files["config"]["deployment"]
    assert "coll_device_bucket_bytes" not in files["cell"]["mca"]
    assert w["chips"] * dep["ranks_per_card"] == dep["ranks"]


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configuration_files(c):
    path = os.path.join(REPO, c["file"])
    assert path.startswith(BENCH + os.sep)
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["source"] == c["source"] and len(c["source"]) <= 200
    assert cfg["reduced"] == c["reduced"]
    assert os.path.exists(os.path.join(BENCH, "reference",
                                       cfg["reference"] + ".py"))


def test_four_chip_cells_within_the_allowance():
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in B["workloads"]:
        e2e = cells.metrics_for(B, w["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert cells.metrics_for(B, w["name"], True)


def test_refuses_a_name_that_leads_out_of_its_folder():
    with pytest.raises(ValueError):
        cells.path("workloads", "../BENCHMARK")
