"""The readers of the program's own host spans on records made up by
hand: ``transport_sync_ms``, ``coll_dispatch_ms`` and ``zero_self_ms``
count nested and overlapping spans once, the three split
``coll_host_ms`` and ``optimizer_self_ms`` as they should, and a record
without the spans (a program that does not record them) reads None. A
traced run of the tiny ring cell on the CPU reads all three."""

import pytest

from benchmark.lib import hostspans
from benchmark.tests.helpers import run_cpu, tiny_copy
from benchmark.tests.test_bench_metrics import _rec, _run, read

NEW = ("transport_sync_ms", "coll_dispatch_ms", "zero_self_ms")

#: one driver step [0, 1000) of a fused ring step: the program's step
#: span, the fused slot (coll_cuda) and its bucket's launch
#: (coll_device), the allgather's API span and its two buckets'
#: launches, and the transport's host steps inside the launches
STEP = [
    ["step", "bench", 0, 1000, None],
    ["step", "zero", 20, 980, None],
    ["sync", "transport", 120, 200, "rs4096"],
    ["wait", "transport", 200, 230, "rs4096"],
    ["sync", "transport", 260, 300, "rs4096"],
    ["wait", "transport", 300, 310, "rs4096"],
    ["launch", "coll_device", 100, 350, "fused_rs_update"],
    ["launch", "coll_cuda", 90, 360, "fused_rs_update"],
    ["sync", "transport", 520, 600, "pull4096"],
    ["wait", "transport", 600, 640, "pull4096"],
    ["launch", "coll_device", 500, 660, "allgather_multi"],
    ["sync", "transport", 700, 720, "pull4096"],
    ["wait", "transport", 720, 800, "pull4096"],
    ["launch", "coll_device", 680, 820, "allgather_multi"],
    ["Allgather_multi", "api", 480, 900, None],
]


def _traced_run(spans, ranks=1):
    return _run([_rec(r, [0.01], spans=spans) for r in range(ranks)],
                trace=True)


def test_union_and_overlap_count_each_instant_once():
    u = hostspans.Union([(0, 10), (5, 15), (20, 30), (22, 25)])
    assert u.iv == [(0, 15), (20, 30)]
    assert u.within(-5, 100) == 25
    assert u.within(12, 22) == 3 + 2
    assert u.within(15, 20) == 0
    both = u & hostspans.Union([(10, 21), (29, 40)])
    assert both.iv == [(10, 15), (20, 21), (29, 30)]
    assert not hostspans.Union([])


def test_sync_reads_the_union_inside_each_step():
    # two overlapping sync spans (a nested one too) count once
    spans = [["step", "bench", 0, 100, None],
             ["sync", "transport", 10, 30, "rs4096"],
             ["sync", "transport", 20, 40, "rs4096"],
             ["sync", "transport", 25, 35, "rs4096"],
             ["launch", "coll_device", 0, 50, None],
             # outside the step: not counted
             ["sync", "transport", 150, 190, "rs4096"]]
    assert read("transport_sync_ms", _traced_run(spans)) \
        == pytest.approx(30 / 1e6)


def test_dispatch_sync_and_wait_add_up_to_coll_host():
    run = _traced_run(STEP, ranks=2)
    coll_host = read("coll_host_ms", run)
    sync = read("transport_sync_ms", run)
    dispatch = read("coll_dispatch_ms", run)
    wait = hostspans.Union(hostspans.named(run.ranks[0], "wait",
                                           "transport")).within(0, 1000)
    # coll: [90, 360) and [480, 900): 270 + 420
    assert coll_host == pytest.approx(690 / 1e6)
    assert sync == pytest.approx((80 + 40 + 80 + 20) / 1e6)
    assert wait == 30 + 10 + 40 + 80
    assert dispatch == pytest.approx((690 - 220 - 160) / 1e6)
    assert dispatch + sync + wait / 1e6 == pytest.approx(coll_host)


def test_dispatch_leaves_out_transport_outside_the_collective_spans():
    spans = [["step", "bench", 0, 100, None],
             ["launch", "coll_device", 10, 50, None],
             ["sync", "transport", 20, 30, "rs4096"],
             ["wait", "transport", 45, 70, "rs4096"]]  # half outside
    assert read("coll_dispatch_ms", _traced_run(spans)) \
        == pytest.approx((40 - 10 - 5) / 1e6)


def test_zero_self_excludes_the_collective_spans():
    run = _traced_run(STEP)
    # the program's step [20, 980) less coll's [90, 360) and [480, 900)
    assert read("zero_self_ms", run) == pytest.approx((960 - 690) / 1e6)
    # the driver's span holds the program's and its trailing synchronise
    assert read("optimizer_self_ms", run) == pytest.approx(
        (1000 - 690) / 1e6)
    assert read("zero_self_ms", run) < read("optimizer_self_ms", run)


def test_means_over_steps_and_ranks():
    def steps(shift, sync_ns):
        return [["step", "bench", shift, shift + 100, None],
                ["step", "zero", shift, shift + 90, None],
                ["launch", "coll_device", shift, shift + 50, None],
                ["sync", "transport", shift, shift + sync_ns, "rs4096"]]
    r0 = steps(0, 10) + steps(100, 30)
    r1 = steps(0, 20) + steps(100, 20)
    run = _run([_rec(0, [0.01] * 2, spans=r0),
                _rec(1, [0.01] * 2, spans=r1)], trace=True)
    assert read("transport_sync_ms", run) == pytest.approx(20 / 1e6)
    assert read("coll_dispatch_ms", run) == pytest.approx(30 / 1e6)
    assert read("zero_self_ms", run) == pytest.approx(40 / 1e6)


def test_last_phase_alone():
    # a step before the last phase's start is not read
    spans = [["step", "bench", 0, 100, None],
             ["sync", "transport", 10, 90, "rs4096"],
             ["step", "bench", 200, 300, None],
             ["sync", "transport", 210, 220, "rs4096"]]
    rec = _rec(0, [0.01] * 2, spans=spans, after={"t0_ns": 150})
    assert read("transport_sync_ms", _run([rec], trace=True)) \
        == pytest.approx(10 / 1e6)


@pytest.mark.parametrize("name", NEW)
def test_without_the_spans_there_is_nothing_to_read(name):
    # the spans a program without this instrumentation records
    old = [s for s in STEP if s[1] not in ("transport", "zero")]
    run = _traced_run(old)
    assert read("coll_host_ms", run) is not None
    assert read(name, run) is None
    # one rank without them: no reading either
    run = _run([_rec(0, [0.01], spans=STEP), _rec(1, [0.01], spans=old)],
               trace=True)
    assert read(name, run) is None


def test_traced_cpu_run_reads_the_new_spans(tmp_path):
    root = tiny_copy(str(tmp_path))
    rc, res, err = run_cpu(root, "tiny.zero2-ring", 3_000_000_047, trace=1)
    assert rc == 0, err[-3000:]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m), m
    assert all(m[k] > 0 for k in NEW), m
    assert m["transport_sync_ms"] + m["coll_dispatch_ms"] \
        <= m["coll_host_ms"] * (1 + 1e-9)
    assert m["zero_self_ms"] <= m["optimizer_self_ms"]
    assert res["correct"] is True
