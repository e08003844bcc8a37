"""Whole runs of the harness on the port's CPU platform at tiny widths:
sound runs come out correct; the control (the configuration's lower
precision) and every planted fault of ``faults.py`` come out not
correct; a machine without a card and a checkout without the program
give no result; cells, drivers and metrics are found by name."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests import faults
from benchmark.tests.helpers import REPO, run_cpu, tiny_copy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["tiny.zero2-ring", "tiny.zero2-linear"])
def test_sound_run_is_correct(root, cell):
    rc, res, err = run_cpu(root, cell, 3_000_000_019)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) >= {"step_ms", "setup_s"}
    assert "device_mem_GiB" not in res["metrics"]  # no card, no reading
    assert list(res)[-1] == "checks"
    for name, v in res["checks"].items():
        assert v["value"] <= v["limit"], name
        assert f"check {name} " in err


def test_control_is_not_correct(root):
    rc, res, err = run_cpu(root, "tiny.zero2-ring", 3_000_000_021,
                           "--control")
    assert rc == 0, err[-3000:]
    assert res["correct"] is False


@pytest.mark.parametrize("cell,fault", [
    ("tiny.zero2-ring", f) for f in sorted(faults.FAULTS)
    if f not in faults.LINEAR_ONLY] + [
    ("tiny.zero2-linear", f) for f in faults.LINEAR_ONLY])
def test_planted_fault_is_not_correct(root, cell, fault):
    rc, res, err = run_cpu(root, cell, 3_000_000_023, "--fault", fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]


def test_ring_order_fails_only_the_bitwise_check(root):
    rc, res, err = run_cpu(root, "tiny.zero2-linear", 3_000_000_041,
                           "--fault", "ring_order")
    assert rc == 0, err[-3000:]
    checks = res["checks"]
    assert checks["bitwise_mismatch"]["value"] > 0
    assert all(v["value"] <= v["limit"] for k, v in checks.items()
               if k != "bitwise_mismatch"), checks


def test_linear_run_is_bitwise_equal_to_the_rank_order_fold(root):
    rc, res, err = run_cpu(root, "tiny.zero2-linear", 3_000_000_043)
    assert rc == 0, err[-3000:]
    assert res["checks"]["bitwise_mismatch"] == {"value": 0.0, "limit": 0}


def test_traced_run_reads_the_host_layers(root):
    rc, res, err = run_cpu(root, "tiny.zero2-ring", 3_000_000_029, trace=1)
    assert rc == 0, err[-3000:]
    m = res["metrics"]
    assert {"optimizer_self_ms", "coll_host_ms", "transport_wait_ms",
            "arena_GiB"} <= set(m)
    # device metrics come only from a card's trace
    assert not {"kernel_roofline", "device_idle", "step_mfu"} & set(m)
    # the first fifth ran with no instrument on, the rest with spans
    assert "ms a step by instruments on (rank 0): none " in err
    assert "garbage collection took" in err


def test_no_card_no_result(root):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gpt2-small.zero2-ring", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(os.path.join(REPO, "benchmark"), bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), bare)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gpt2-small.zero2-ring", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--platform", "cpu"], cwd=bare, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_new_cell_driver_and_metric_found_by_name(tmp_path):
    root = tiny_copy(str(tmp_path))
    b = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(b, "drivers", "zero_step.py"),
                os.path.join(b, "drivers", "zero_step_b.py"))
    with open(os.path.join(b, "traffic", "zero2-ring.json")) as f:
        tr = json.load(f)
    tr.update(name="zero2-ring-b", grad_sets=2)
    with open(os.path.join(b, "traffic", "zero2-ring-b.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(b, "workloads", "tiny.zero2-ring.json")) as f:
        cell = json.load(f)
    cell.update(name="tiny.zero2-ring-b", traffic="zero2-ring-b",
                driver="zero_step_b")
    with open(os.path.join(b, "workloads", "tiny.zero2-ring-b.json"),
              "w") as f:
        json.dump(cell, f)
    with open(os.path.join(b, "metrics", "window_steps.py"), "w") as f:
        f.write('"""window_steps: steps in the window."""\n\n\n'
                'def read(run):\n    return float(run.lead["steps"])\n')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["end_to_end"].append(
        {"name": "window_steps", "unit": "steps", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["tiny.zero2-ring-b"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, res, err = run_cpu(root, "tiny.zero2-ring-b", 3_000_000_031)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert res["metrics"]["window_steps"]["value"] == res["attempted"]
    # a cell the new metric does not list does not report it
    rc, res, err = run_cpu(root, "tiny.zero2-ring", 3_000_000_037)
    assert rc == 0 and "window_steps" not in res["metrics"]


def test_job_environment_keeps_writes_in_the_checkout_and_tmpdir(tmp_path):
    from benchmark import run

    env = run.job_env(str(tmp_path), ["0"], cpu=False)
    assert env["OMPI_TPU_SHM_DIR"] == str(tmp_path / "shm")
    assert env["CUDA_VISIBLE_DEVICES"] == "0"
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        assert env[k].startswith(os.path.join(run.ROOT, "build") + os.sep)
