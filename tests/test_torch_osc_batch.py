"""The host side of the port's grouped one-sided kernels (K8 and K9
batches, ompi_tpu_torch.osc) and of the exchange that feeds them.

On the CPU every wrapper takes its plain version, so what the card runs
is reached here through the plans: :func:`plan_apply` and
:func:`plan_read` turn a descriptor list into the launches and tables the
kernels get (clamped starts, strided rows cut to what lands, disjoint
runs, tables of at most ``TABLE_CAP``), and an emulation of the kernels'
table semantics (every named index lands; descriptors of one table touch
disjoint elements) replays them. Inputs come from numpy seeds; the
reference for a batch is the loop of the single plain versions, which
``tests/test_torch_osc_kernels.py`` holds bitwise against the JAX
package's Pallas kernels. Tolerance: none (bitwise, NaN payloads
compared too). The fence's exchange partition, its region layout and the
first-fit colouring (against ``ompi_tpu.coll.xla_neighbor._color``) are
checked as pure functions.
"""

import numpy as np
import pytest
import torch

from ompi_tpu.coll.xla_neighbor import _color as ref_color
from ompi_tpu_torch import compat
from ompi_tpu_torch.osc import cuda_kernels as O
from ompi_tpu_torch.osc.cuda import exchange_layout, plan_exchanges
from ompi_tpu_torch.osc.device_epoch import _color

SIZE = 64
DTYPES = ("float32", "bfloat16", "int32")
KINDS = ("put", "replace", "sum", "min", "max", "prod")
KIND_OF = {0: "sum", 1: "prod", 2: "min", 3: "max", 4: "put"}
#: (k, disp, stride): clamped, wrapped, dropped, past-the-window, empty
APPLY_DESCS = [(5, 0, 1), (5, SIZE - 2, 1), (5, 100, 1), (5, -3, 1),
               (5, -SIZE, 1), (5, -70, 1), (5, 3, 2), (5, SIZE - 4, 2),
               (5, -5, 2), (5, -70, 2), (5, 100, 2), (5, 7, 8),
               (5, 63, 8), (5, -9, 8), (3, 2, SIZE + 5), (0, 4, 1),
               (0, 4, 3), (5, 1, 0), (5, 1, -2), (5, 10, 1), (5, 12, 1)]
#: (k, disp, stride) reads: the same edges plus strides 0, < 0, fills
READ_DESCS = [(5, 0, 1), (5, SIZE - 2, 1), (5, 100, 1), (5, -3, 1),
              (5, -70, 1), (5, 3, 2), (5, SIZE - 4, 2), (5, -SIZE - 1, 2),
              (5, 0, 8), (5, 63, 8), (4, 11, 0), (4, -3, 0), (4, 10, -3),
              (4, -60, -3), (4, 80, -3), (3, 5, SIZE + 1), (0, 7, 1),
              (0, 7, 2)]


def _np(dtype, seed, n):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
    a = (rng.standard_normal(n) * 10.0).astype(np.float32)
    a[::11] = np.nan
    a[3::13] = 0.0
    a[5::17] = -0.0
    if dtype == "bfloat16":
        import ml_dtypes
        return a.astype(ml_dtypes.bfloat16)
    return a


def _t(dtype, seed, n):
    return compat.tensor_from_numpy(_np(dtype, seed, n))


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _equal(a, b, what):
    assert torch.equal(_bits(a), _bits(b)), what


def emulate_apply(window, bases, plan, cap=O.TABLE_CAP):
    """What the card does with a plan: K7 entries as K7's plain version;
    a K8 table writes window[d + i*s] = C(window[d + i*s], payload[i]) for
    every row, each index inside the window, rows pairwise disjoint."""
    size = window.numel()
    for what, rows in plan:
        if what == "k7":
            b, off, d, k, op = rows
            assert k >= O.K7_MIN and 0 <= d <= size - k
            O.rma_apply_plain(window, bases[b][off:off + k], d, KIND_OF[op])
            continue
        assert 0 < len(rows) <= cap
        touched: set = set()
        for b, off, d, k, s, op in rows:
            assert k > 0 and s >= 1 and (k == 1 or s > 0)
            idx = d + s * np.arange(k)
            assert idx.min() >= 0 and idx.max() < size, (d, k, s)
            assert not touched & set(idx.tolist()), "rows of a table overlap"
            touched |= set(idx.tolist())
            ti = torch.from_numpy(idx)
            window[ti] = O.combine_plain(KIND_OF[op], window[ti],
                                         bases[b][off:off + k])


def emulate_read(window, tables, out, cap=O.TABLE_CAP):
    """What the card does with K9 tables."""
    size = window.numel()
    for rows in tables:
        assert 0 < len(rows) <= cap
        for d, s, o, k in rows:
            assert k > 0
            if s == 1:
                assert 0 <= d <= size - k
                out[o:o + k] = window[d:d + k]
                continue
            j = d + s * np.arange(k)
            j = np.where(j < 0, j + size, j)
            ok = (j >= 0) & (j < size)
            vals = window[torch.from_numpy(np.clip(j, 0, size - 1))]
            out[o:o + k] = torch.where(torch.from_numpy(ok), vals,
                                       O._fill(window.dtype, window.device))


def _apply_descs(dtype, seed, specs=APPLY_DESCS, kinds=KINDS):
    pay = _t(dtype, seed, 5 * len(specs) + 1)[1:]  # unaligned views
    return [(pay[5 * i:5 * i + k], d, s, kinds[i % len(kinds)])
            for i, (k, d, s) in enumerate(specs)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_batch_equals_loop_of_single_plains(dtype):
    """K8's batch (its plain version, the CPU wrapper, Target.apply and
    the emulated plan the card runs) == the loop of rma_apply_plain /
    rma_apply_strided_plain, every kind, at every edge."""
    w0 = _t(dtype, 1, SIZE)
    descs = _apply_descs(dtype, 2)
    want = w0.clone()
    for p, d, s, kind in descs:
        if s == 1:
            O.rma_apply_plain(want, p, d, kind)
        else:
            O.rma_apply_strided_plain(want, p, d, s, kind)
    got = w0.clone()
    O.rma_apply_strided_batch_plain(got, descs)
    _equal(got, want, "batch plain")
    got = w0.clone()
    O.rma_apply_strided_batch(got, descs)
    _equal(got, want, "batch wrapper on the CPU")
    got = w0.clone()
    O.Target(got).apply([p for p, *_ in descs],
                        [(i, 0, p.numel(), d, s, kind)
                         for i, (p, d, s, kind) in enumerate(descs)])
    _equal(got, want, "Target.apply on the CPU")
    got = w0.clone()
    rows = [(i, 0, p.numel(), d, s, kind)
            for i, (p, d, s, kind) in enumerate(descs)]
    emulate_apply(got, [p for p, *_ in descs], O.plan_apply(SIZE, rows))
    _equal(got, want, "the card's plan")


@pytest.mark.parametrize("dtype", DTYPES)
def test_read_batch_equals_loop_of_single_plains(dtype):
    """K9's batch (plain, CPU wrapper, Target.read, emulated tables) == the
    loop of rma_read_plain into one output, clamps, wraps and fills."""
    w = _t(dtype, 3, SIZE)
    descs, at = [], 0
    for k, d, s in READ_DESCS:
        descs.append((d, s, k, at))
        at += k
    tdt = getattr(torch, dtype)
    want = torch.zeros(at, dtype=tdt)
    for d, s, k, off in descs:
        O.rma_read_plain(w, d, s, want[off:off + k])
    for name, run in (
            ("plain", lambda o: O.rma_read_batch_plain(w, descs, o)),
            ("wrapper", lambda o: O.rma_read_batch(w, descs, o)),
            ("Target.read", lambda o: O.Target(w).read(descs, o)),
            ("the card's tables", lambda o: emulate_read(
                w, O.plan_read(SIZE, descs), o))):
        got = torch.zeros(at, dtype=tdt)
        run(got)
        _equal(got, want, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_of_one_is_the_single_kernel(dtype):
    """rma_apply_strided keeps the strided rule at stride 1 (drop, not
    clamp); the batch gives stride 1 K7's rule, as apply() does."""
    w0 = torch.arange(10, dtype=getattr(torch, dtype))
    pay = torch.full((4,), 100, dtype=w0.dtype)
    got = w0.clone()
    O.rma_apply_strided(got, pay, 8, 1, "put")
    assert got.tolist()[6:] == [6, 7, 100, 100]
    got = w0.clone()
    O.rma_apply_strided_batch(got, [(pay, 8, 1, "put")])
    assert got.tolist()[6:] == [100, 100, 100, 100]
    plan = O.plan_apply(10, [(0, 0, 4, 8, 1, "put")])
    assert plan == [("k8", [(0, 0, 6, 4, 1, 4)])]


def test_plan_cuts_strided_rows_to_what_lands():
    """Rows are normalised on the host: the payload offset skips dropped
    elements, a row that lands one element gets stride 1, empty rows go."""
    plan = O.plan_apply(SIZE, [(0, 0, 5, -5, 2, "sum"),  # i = 3, 4 land
                               (1, 3, 3, 2, SIZE + 5, "max"),  # one lands
                               (2, 0, 5, 100, 2, "put"),  # none
                               (3, 0, 5, 1, 0, "put"),  # stride 0
                               (4, 0, 0, 1, 1, "put")])  # k = 0
    # 1 and 3, then 2: two strides, overlapping ranges, so two tables
    assert plan == [("k8", [(0, 3, 1, 2, 2, 0)]), ("k8", [(1, 3, 2, 1, 1, 3)])]
    assert O.strided_span(SIZE, 5, -5, 2) == (1, 2, 3)
    assert O.strided_span(SIZE, 5, 63, 8) == (63, 1, 0)
    assert O.strided_span(SIZE, 5, -70, 8) is None
    assert O.plan_read(SIZE, [(100, 1, 5, 0), (-70, -3, 4, 5),
                              (7, 1, 0, 9)]) == [[(SIZE - 5, 1, 0, 5),
                                                  (-70, -3, 5, 4)]]


def test_k7_keeps_wide_contiguous_rows_in_order():
    """A contiguous row of K7_MIN elements or more is a K7 launch between
    the tables before and after it; narrower and strided rows stay in
    the batch (here each overlaps the one before: a table each)."""
    size = O.K7_MIN + 16
    rows = [(0, 0, 4, 0, 1, "sum"), (1, 0, O.K7_MIN, 3, 1, "put"),
            (0, 0, 4, 1, 1, "max"), (2, 0, O.K7_MIN - 1, 0, 1, "put"),
            (1, 0, O.K7_MIN, 0, 2, "sum")]
    plan = O.plan_apply(size, rows)
    assert [w for w, _ in plan] == ["k8", "k7", "k8", "k8", "k8"]
    assert plan[1][1] == (1, 0, 3, O.K7_MIN, 4)
    rng = np.random.default_rng(7)
    bases = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for n in (4, O.K7_MIN, O.K7_MIN - 1)]
    w0 = torch.from_numpy(rng.standard_normal(size).astype(np.float32))
    want = w0.clone()
    for b, off, k, d, s, kind in rows:
        O.apply_plain(want, bases[b][off:off + k], d, kind, s)
    got = w0.clone()
    emulate_apply(got, bases, plan)
    _equal(got, want, "K7 inside a batch")
    with pytest.raises(ValueError, match="into a window"):
        O.plan_apply(8, [(0, 0, 9, 0, 1, "put")])


@pytest.mark.parametrize("cap", [1, 7, O.TABLE_CAP])
def test_tables_split_past_one_launch(cap):
    """2500 disjoint rows (an embedding update) are one run cut into
    tables of at most cap, in order; the emulated launches == the loop;
    reads split the same way."""
    rows_n, dim = 4096, 4
    rng = np.random.default_rng(11)
    ids = rng.permutation(rows_n)[:2500]
    grads = torch.from_numpy(rng.standard_normal(2500 * dim).astype(
        np.float32))
    rows = [(0, i * dim, dim, int(r) * dim, 1, "sum")
            for i, r in enumerate(ids)]
    plan = O.plan_apply(rows_n * dim, rows, cap)
    assert [len(t) for _w, t in plan] == [
        min(cap, 2500 - c) for c in range(0, 2500, cap)]
    assert [r for _w, t in plan for r in t] == [
        (0, i * dim, int(r) * dim, dim, 1, 0) for i, r in enumerate(ids)]
    w0 = torch.from_numpy(rng.standard_normal(rows_n * dim).astype(
        np.float32))
    want, got = w0.clone(), w0.clone()
    O.Target(want).apply([grads], rows)
    emulate_apply(got, [grads], plan, cap)
    _equal(got, want, "tables past one launch")
    reads = [(int(r) * dim, 1, dim, i * dim) for i, r in enumerate(ids)]
    tables = O.plan_read(rows_n * dim, reads, cap)
    assert [len(t) for t in tables] == [min(cap, 2500 - c)
                                        for c in range(0, 2500, cap)]
    want = torch.empty(2500 * dim)
    got = torch.empty(2500 * dim)
    O.rma_read_batch_plain(w0, reads, want)
    emulate_read(w0, tables, got, cap)
    _equal(got, want, "read tables past one launch")


def test_disjoint_runs_split_overlaps_and_keep_order():
    assert O.disjoint_runs([]) == []
    # a later row overlapping an earlier one starts a new run
    assert O.disjoint_runs([(0, 9, 1), (10, 19, 1), (5, 5, 1),
                            (20, 29, 1), (25, 26, 1)]) == [
        (0, 2), (2, 4), (4, 5)]
    # one stride: residues are exact (the two halo columns share a run)
    assert O.disjoint_runs([(0, 80, 8), (7, 87, 8), (1, 81, 8)]) == [(0, 3)]
    assert O.disjoint_runs([(0, 80, 8), (16, 48, 8)]) == [(0, 1), (1, 2)]
    assert O.disjoint_runs([(0, 80, 8), (88, 96, 8)]) == [(0, 2)]
    # two strides: conservative on the ranges
    assert O.disjoint_runs([(0, 80, 8), (3, 3, 1)]) == [(0, 1), (1, 2)]
    assert O.disjoint_runs([(0, 80, 8), (81, 90, 1)]) == [(0, 2)]
    # rows in any order, all disjoint: one run
    assert O.disjoint_runs([(40, 49, 1), (0, 9, 1), (20, 29, 1)]) == [(0, 3)]


def _clash(a, b):
    """The splitter's rule: exact for one stride, ranges otherwise."""
    (lo1, hi1, s1), (lo2, hi2, s2) = a, b
    if hi1 < lo2 or hi2 < lo1:
        return False
    return s1 != s2 or lo1 % s1 == lo2 % s2


@pytest.mark.parametrize("seed", range(4))
def test_disjoint_runs_random(seed):
    """Runs cover the list in order, hold pairwise disjoint footprints
    (checked element by element), and are maximal: each next run's first
    footprint clashes with one of the run before it."""
    rng = np.random.default_rng(seed)
    spans = []
    for _ in range(120):
        s = int(rng.choice([1, 1, 3, 8]))
        lo = int(rng.integers(0, 200))
        n = int(rng.integers(1, 6))
        spans.append((lo, lo + (n - 1) * s, s))
    runs = O.disjoint_runs(spans)
    assert runs[0][0] == 0 and runs[-1][1] == len(spans)
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    for a, b in runs:
        seen: set = set()
        for lo, hi, s in spans[a:b]:
            el = set(range(lo, hi + 1, s))
            assert not seen & el
            seen |= el
    for (a, b), (c, _d) in zip(runs, runs[1:]):
        assert any(_clash(spans[c], x) for x in spans[a:b])


def test_exchange_partition():
    """Cuts keep whole rounds, respect the budget (every rank stages at
    most max(one payload, budget)), are maximal, depend only on the
    allgathered sizes and the budget given, and are the same for every
    rank that computes them."""
    rng = np.random.default_rng(3)
    rounds = [[(int(p), int(rng.integers(0, 60)))
               for p in rng.permutation(4)[:int(rng.integers(1, 5))]]
              for _ in range(40)]
    rounds[7] = [(1, 500)]  # above any budget below
    for budget in (0, 50, 120, 400, 1 << 30):
        cuts = plan_exchanges(rounds, budget)
        assert cuts == plan_exchanges([list(r) for r in rounds], budget)
        assert cuts[0][0] == 0 and cuts[-1][1] == len(rounds)
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        for a, b in cuts:
            staged: dict = {}
            payloads: dict = {}
            for rnd in rounds[a:b]:
                for p, nb in rnd:
                    staged[p] = staged.get(p, 0) + nb
                    payloads[p] = payloads.get(p, 0) + 1
            assert all(v <= budget or payloads[p] == 1
                       for p, v in staged.items())
            if b < len(rounds):  # the next round would pass the budget
                assert any(staged.get(p, 0) + nb > budget
                           for p, nb in rounds[b])
    assert plan_exchanges(rounds, 1 << 30) == [(0, 40)]
    assert len(plan_exchanges(rounds, 0)) == 40
    assert plan_exchanges([], 10) == []


def test_exchange_layout():
    """A source lays its payloads end to end, grouped by destination in
    rank order, in round order within; each (source, destination) block
    is contiguous."""
    # (src, dst, disp, nelems): two rounds of a 3-rank run
    run = [(0, 1, 0, 4), (1, 2, 0, 3), (2, 0, 0, 2),
           (0, 2, 9, 5), (1, 2, 7, 1), (2, 2, 3, 6), (0, 1, 8, 2)]
    offs, totals, blocks = exchange_layout(run, 3)
    assert totals == [11, 4, 8]
    assert offs == [0, 0, 0, 6, 3, 2, 4]
    assert blocks == {(0, 1): (0, 6), (0, 2): (6, 5), (1, 2): (0, 4),
                      (2, 0): (0, 2), (2, 2): (2, 6)}


@pytest.mark.parametrize("seed", range(5))
def test_colouring_equals_reference(seed):
    """The one-pass first-fit colouring == the reference's passes, round
    for round and edge order within each round."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    edges = [(int(rng.integers(n)), int(rng.integers(n)), i)
             for i in range(int(rng.integers(1, 200)))]
    assert _color(edges) == ref_color(edges)


def test_colouring_one_owner_many_rows():
    """The embedding update at full size: 2048 rows from 4 origins into
    one owner take 2048 rounds, in the reference's order."""
    edges = [(o, 0, i) for o in range(4) for i in range(512)]
    rounds = _color(edges)
    assert rounds == ref_color(edges)
    assert len(rounds) == 2048 and all(len(r) == 1 for r in rounds)
