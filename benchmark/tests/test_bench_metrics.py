"""The metric arithmetic on runs made up by hand: a rate over a window
that holds a stall, the idle union across the ranks of a card, the
self time less nested spans, the counters per step."""

import statistics

import pytest

from benchmark.lib import cells, runinfo, stats


def _run(ranks, trace=False, chips=1, launch_mono=0.0):
    files = {"cell": {}, "config": {"deployment": {"ranks": len(ranks)}},
             "traffic": {}}
    return runinfo.Run(files, ranks, launch_mono, chips, trace)


def _rec(rank, step_s, card=0, **kw):
    rec = {"rank": rank, "card": card, "steps": len(step_s),
           "step_s": step_s, "window_s": sum(step_s),
           "window_start_mono": 12.5, "mem_used_bytes": None,
           "launches": 0, "wait_ns": 0, "arena_bytes": 0, "spans": [],
           "dev_trace": None, "prof_span": None, "prof_steps": None,
           "device": "cuda:0", "dtype": "float32"}
    rec.update(kw)
    return rec


def read(name, run):
    return cells.metric_reader(name)(run)


def test_step_ms_is_the_window_over_its_steps_stall_included():
    steps = [0.010] * 299 + [0.510]  # one 500 ms stall
    run = _run([_rec(0, steps)])
    # (299 x 10 + 510) ms over 300 steps: the stall counts in full
    assert read("step_ms", run) == pytest.approx(3500 / 300)
    assert read("step_ms", run) > statistics.median(steps) * 1e3 + 1


def test_setup_is_launch_to_first_timed_step():
    run = _run([_rec(0, [0.01])], launch_mono=2.0)
    assert read("setup_s", run) == pytest.approx(10.5)


def test_device_memory_is_the_fullest_sampled_card():
    recs = [_rec(0, [0.01], mem_used_bytes=3 << 30),
            _rec(1, [0.01], card=1, mem_used_bytes=5 << 30),
            _rec(2, [0.01], card=1)]
    assert read("device_mem_GiB", _run(recs)) == 5.0


def _traced(rank, card, ops, span=(0, 1000)):
    return _rec(rank, [0.01] * 10, card=card, prof_span=list(span),
                prof_steps=[2, 12], dev_trace={"ops": ops})


def test_idle_is_the_union_over_a_cards_ranks():
    # card 0: rank 0 busy [0, 300), rank 1 [200, 500): union 500 of 1000
    # card 1: rank 2 busy [0, 250) and [750, 1000): 500 of 1000
    recs = [_traced(0, 0, [["k", 0, 300]]), _traced(1, 0, [["k", 200, 500]]),
            _traced(2, 1, [["k", 0, 250], ["m", 750, 1000]])]
    run = _run(recs, trace=True, chips=2)
    assert run.busy() == pytest.approx((500e-9, 1000e-9))
    assert read("device_idle", run) == pytest.approx(50.0)


def test_union_helpers():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9)]
    assert stats.merge(iv) == [(0, 3), (5, 9)]
    assert stats.covered(iv, 2, 8) == 1 + 3
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (9, 10)]


def test_self_time_subtracts_the_nested_collective_spans_once():
    spans = [["step", "bench", 0, 100, None],
             ["launch", "coll_cuda", 10, 40, "fused_rs_update"],
             ["Allgather_multi", "api", 50, 90, None],
             ["launch", "coll_device", 60, 70, None]]  # nested in the API
    run = _run([_rec(0, [0.01], spans=spans)], trace=True)
    assert read("coll_host_ms", run) == pytest.approx(70 / 1e6)
    assert read("optimizer_self_ms", run) == pytest.approx(30 / 1e6)


def test_counters_per_step():
    recs = [_rec(0, [0.01] * 4, launches=28, wait_ns=4_000_000,
                 arena_bytes=1 << 30),
            _rec(1, [0.01] * 4, launches=28, wait_ns=8_000_000,
                 arena_bytes=1 << 30)]
    run = _run(recs, trace=True)
    assert read("kernel_launches_per_step", run) == 14.0
    assert read("transport_wait_ms", run) == pytest.approx(1.5)
    assert read("arena_GiB", run) == 2.0
