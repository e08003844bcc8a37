"""The port's serve/ (Zipf traffic, the drop / reroute / dcn_overflow
Dispatcher, the decode loop) against the JAX package's, the counterparts
of ``tests/test_serve.py``.

One 4-rank job per package under ``device_plane on`` and
``monitoring_level 1`` runs the same program (:data:`_PROG`) on the same
seeded numpy inputs and saves every dispatch's output and stats: the flat
policies and the ``ERR_ARG`` cases on the world, then ``coll_hier_split``
set to ``2x2`` and ``dcn_overflow`` on a duplicate of it (a comm's grid is
decided at its first use). Across the packages: the routing (kept,
rerouted, dropped, multi-assigned, the per-expert counts, the DCN tokens
and bytes) is exact; the outputs are within the reference tests' ``rtol
1e-4, atol 1e-5``; the port's ``drop`` is bitwise its own ``moe_ffn``.
The traffic generator, the decode loop and the report run in this
process.
"""

import json
import os
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch import compat, errors
from ompi_tpu_torch.monitoring import matrix as P_matrix
from ompi_tpu_torch.monitoring import merge as P_merge
from ompi_tpu_torch.monitoring import report as P_report
from ompi_tpu_torch.runtime import launcher as port_launcher
from ompi_tpu_torch.serve import ZipfTraffic, run_decode
from ompi_tpu_torch.serve import traffic as P_traffic
from tests.harness import run_ranks

RTOL, ATOL = 1e-4, 1e-5
N = 4
_MCA = {"device_plane": "on", "monitoring_level": "1"}

#: run by both packages: ``Dispatcher``, ``ZipfTraffic``, ``errors``,
#: ``cvar``, ``pvar``, ``TRAFFIC()`` (the live matrix), ``npy(out)``,
#: ``extra(comm, disp, out, x)`` (in-job checks of one package) and
#: ``out_dir`` come from the package's prelude
_PROG = '''
doc = {}


def save(name, out):
    np.save(f"{out_dir}/{name}_r{rank}.npy", npy(out))


def stats(info):
    return {k: (list(v) if k == "counts" else v) for k, v in info.items()}


def err(fn):
    try:
        fn()
    except errors.MPIError as e:
        return [e.error_class, str(e)]
    return None


# drop (test_drop_bitwise_equal_to_moe_ffn)
e_local, d, f = 2, 32, 16
tr = ZipfTraffic(e_local * size, d, hotness=1.2, seed=3)
rng = np.random.default_rng(100 + rank)
w1 = rng.standard_normal((e_local, d, f)).astype(np.float32)
w2 = rng.standard_normal((e_local, f, d)).astype(np.float32)
ids, x = tr.request(32)
disp = Dispatcher(comm, tr.wg, w1, w2)
s = pvar.session()
out, info = disp(x)
save("drop", out)
doc["drop"] = stats(info)
doc["drop_pvars"] = [s.read("serve_tokens"), s.read("serve_dropped_tokens")]
doc["drop_extra"] = extra(comm, disp, out, x)

# reroute (test_reroute_conserves_tokens)
tr = ZipfTraffic(e_local * size, d, hotness=1.5, seed=4)
disp = Dispatcher(comm, tr.wg, w1, w2, policy="reroute")
drop = Dispatcher(comm, tr.wg, w1, w2, policy="drop")
s = pvar.session()
doc["reroute"] = []
for i in range(3):
    ids, x = tr.request(32)
    out, info = disp(x)
    dout, dinfo = drop(x)
    save(f"reroute{i}", out)
    save(f"reroute_drop{i}", dout)
    doc["reroute"].append([stats(info), stats(dinfo)])
doc["reroute_pvar"] = s.read("serve_rerouted_tokens")

# a bad policy raises at every dispatch, then serves once fixed
tr = ZipfTraffic(2 * size, 16, seed=1)
rng = np.random.default_rng(0)
w1b = rng.standard_normal((2, 16, 8)).astype(np.float32)
w2b = rng.standard_normal((2, 8, 16)).astype(np.float32)
disp = Dispatcher(comm, tr.wg, w1b, w2b, policy="drp")
ids, x = tr.request(8)
doc["bad_policy"] = [err(lambda: disp(x)), err(lambda: disp(x))]
disp.policy = "drop"
out, info = disp(x)
doc["bad_policy_fixed"] = stats(info)

# router widths and the grid (test_router_width_mismatch_err_arg,
# test_dcn_overflow_without_grid_err_arg)
tr_small = ZipfTraffic(2, 16, seed=1)
ids, x = tr_small.request(8)
doc["narrow_router"] = err(
    lambda: Dispatcher(comm, tr_small.wg, w1b, w2b, policy="drop")(x))
tr_flat = ZipfTraffic(2 * size, 16, seed=1)
ids, x = tr_flat.request(8)
flat = comm.dup()
doc["no_grid"] = err(
    lambda: Dispatcher(flat, tr_flat.wg, w1b, w2b, policy="dcn_overflow")(x))

# dcn_overflow on a 2x2 grid (test_dcn_overflow_bounded_and_attributed)
cvar.set("coll_hier_split", "2x2")
grid = comm.dup()
doc["flat_router_on_grid"] = err(
    lambda: Dispatcher(grid, tr_flat.wg, w1b, w2b, policy="dcn_overflow")(x))
e_local, d, f, t = 2, 16, 8, 32
n_ici = 2
tr = ZipfTraffic(e_local * n_ici, d, hotness=1.5, seed=6)
rng = np.random.default_rng(200 + rank % n_ici)
w1 = rng.standard_normal((e_local, d, f)).astype(np.float32)
w2 = rng.standard_normal((e_local, f, d)).astype(np.float32)
disp = Dispatcher(grid, tr.wg, w1, w2, policy="dcn_overflow")
ids, x = tr.request(t)
np.save(f"{out_dir}/dcn_x_r{rank}.npy", x)
np.save(f"{out_dir}/dcn_ids_r{rank}.npy", ids)
s = pvar.session()
out, info = disp(x)
save("dcn", out)
doc["dcn"] = stats(info)
doc["dcn_pvars"] = [s.read("serve_dcn_overflow_tokens"),
                    s.read("serve_dcn_overflow_bytes")]
doc["dcn_hier"] = list(TRAFFIC().hier_levels["serve_overflow"])
cost = (d + 2 + d) * 4
budget = max(info["dcn_tokens"] // 2, 1) * cost
cvar.set("serve_dcn_budget_bytes", budget)
try:
    bout, binfo = disp(x)
finally:
    cvar.set("serve_dcn_budget_bytes", 0)
save("dcn_budget", bout)
doc["dcn_budget"] = [budget, stats(binfo)]
doc["hier_levels"] = {k: list(v) for k, v in TRAFFIC().hier_levels.items()}
doc["serve"] = {k: {kk: vv for kk, vv in v.items() if kk != "lat_ns"}
                for k, v in TRAFFIC().serve.items()}
doc["expert"] = {str(k): v for k, v in TRAFFIC().expert.items()}
with open(f"{out_dir}/doc_r{rank}.json", "w") as fh:
    json.dump(doc, fh)
'''

_REF_PRELUDE = '''
import json
from ompi_tpu import errors
from ompi_tpu.core import cvar, pvar
from ompi_tpu.monitoring import matrix as _matrix
from ompi_tpu.serve import Dispatcher, ZipfTraffic
out_dir = {out_dir!r}


def npy(a):
    return np.asarray(a)


def TRAFFIC():
    return _matrix.TRAFFIC


def extra(comm, disp, out, x):
    return None
'''

_PORT_PRELUDE = '''
import json
import numpy as np
import torch
from ompi_tpu_torch import errors, mpi
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.monitoring import matrix as _matrix
from ompi_tpu_torch.ops import moe
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.serve import Dispatcher, ZipfTraffic
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out_dir!r}


def npy(t):
    return t.cpu().numpy()


def TRAFFIC():
    return _matrix.TRAFFIC


def extra(comm, disp, out, x):
    """The port's own bar: drop is bitwise its moe_ffn, on the
    comm's device."""
    wg, w1, w2 = disp._weights()
    ref = moe.moe_ffn(torch.as_tensor(x), wg, w1, w2, comm)
    return [bool(torch.equal(out.view(torch.int32),
                             ref.view(torch.int32))),
            str(out.device), str(device_plane.device())]
'''


def _port_job(out: str) -> None:
    src = textwrap.dedent(_PORT_PRELUDE).format(out_dir=out) + _PROG \
        + "\nmpi.Finalize()\n"
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    mca = dict(compat.mca_from_reference(_MCA), device_plane_platform="cpu")
    try:
        rc = port_launcher.launch([sys.executable, path], N, mca=mca,
                                  timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job on {N} ranks exited {rc}"


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """(reference dir, port dir), each job run once."""
    ref = tmp_path_factory.mktemp("serve_ref")
    port = tmp_path_factory.mktemp("serve_port")
    run_ranks(textwrap.dedent(_REF_PRELUDE).format(out_dir=str(ref))
              + _PROG, N, mca=_MCA, timeout=300, isolate=True)
    _port_job(str(port))
    return ref, port


def _doc(d, r):
    return json.loads((d / f"doc_r{r}.json").read_text())


def _close(d_ref, d_port, name, r):
    a = np.load(d_ref / f"{name}_r{r}.npy")
    b = np.load(d_port / f"{name}_r{r}.npy")
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32, name
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# traffic generator (in process)


@pytest.mark.parametrize("hotness,seed", [(1.3, 11), (2.0, 23), (0.0, 5)])
def test_zipf_streams_bitwise_reference(hotness, seed):
    """The port's numpy copy draws the reference's streams bit for bit:
    the router, the popularity order, the id stream and the batches."""
    from ompi_tpu.serve import ZipfTraffic as RefZipf

    a = ZipfTraffic(8, 32, hotness=hotness, seed=seed)
    b = RefZipf(8, 32, hotness=hotness, seed=seed)
    assert a.wg.tobytes() == b.wg.tobytes()
    np.testing.assert_array_equal(a.perm, b.perm)
    assert a.hot_expert == b.hot_expert
    for _ in range(3):
        ia, xa = a.request(64)
        ib, xb = b.request(64)
        np.testing.assert_array_equal(ia, ib)
        assert xa.view(np.uint32).tobytes() == xb.view(np.uint32).tobytes()


def test_zipf_deterministic_under_seed():
    a = ZipfTraffic(8, 32, hotness=1.3, seed=11)
    b = ZipfTraffic(8, 32, hotness=1.3, seed=11)
    for _ in range(3):
        ia, xa = a.request(64)
        ib, xb = b.request(64)
        np.testing.assert_array_equal(ia, ib)
        assert (xa.view(np.uint32) == xb.view(np.uint32)).all()
    c = ZipfTraffic(8, 32, hotness=1.3, seed=12)
    assert not np.array_equal(c.expert_ids(64), a.expert_ids(64))


def test_zipf_routes_to_drawn_expert_and_hotness_dial():
    tr = ZipfTraffic(8, 32, hotness=1.2, seed=5)
    ids, x = tr.request(256)
    np.testing.assert_array_equal(np.argmax(x @ tr.wg, -1), ids)
    share = []
    for alpha in (0.0, 1.0, 2.0):
        t = ZipfTraffic(8, 32, hotness=alpha, seed=9)
        ids = t.expert_ids(4096)
        share.append(np.mean(ids == t.hot_expert))
    assert share[0] < share[1] < share[2]
    assert share[2] > 0.5


@pytest.mark.parametrize("args,kw", [((16, 8), {}), ((0, 8), {}),
                                     ((4, 8), {"hotness": -1.0})])
def test_zipf_bad_config_err_arg(args, kw):
    """ERR_ARG as the reference raises it, with its message."""
    from ompi_tpu import errors as ref_errors
    from ompi_tpu.serve import ZipfTraffic as RefZipf

    with pytest.raises(errors.MPIError) as ei:
        P_traffic.ZipfTraffic(*args, **kw)
    with pytest.raises(ref_errors.MPIError) as er:
        RefZipf(*args, **kw)
    assert ei.value.error_class == errors.ERR_ARG \
        == er.value.error_class
    assert str(ei.value) == str(er.value)


# ---------------------------------------------------------------------------
# the dispatch policies (one job per package)


def test_drop_bitwise_equal_to_moe_ffn(jobs):
    """drop is bitwise the port's moe_ffn on the comm's device, within
    the reference tests' tolerance of the reference's output, with the
    reference's routing stats exactly."""
    ref, port = jobs
    for r in range(N):
        dr, dp = _doc(ref, r), _doc(port, r)
        bitwise, dev, plane = dp["drop_extra"]
        assert bitwise and dev == plane
        assert dp["drop"] == dr["drop"]
        info = dp["drop"]
        assert info["policy"] == "drop" and info["tokens"] == 32
        assert info["kept"] + info["dropped"] == 32
        assert info["rerouted"] == 0 and info["multi_assigned"] == 0
        assert info["dropped"] > 0
        assert dp["drop_pvars"] == [32, info["dropped"]] \
            == dr["drop_pvars"]
        _close(ref, port, "drop", r)


def test_reroute_conserves_tokens(jobs):
    """Every overflow token lands on one free slot or stays dropped, as
    in the reference: the stats and per-expert counts equal its own, and
    the outputs are within tolerance."""
    ref, port = jobs
    for r in range(N):
        dr, dp = _doc(ref, r), _doc(port, r)
        assert dp["reroute"] == dr["reroute"]
        total = 0
        for i, (info, dinfo) in enumerate(dp["reroute"]):
            assert info["kept"] + info["rerouted"] + info["dropped"] \
                == info["tokens"] == 32
            assert info["multi_assigned"] == 0
            assert info["kept"] == dinfo["kept"]
            total += info["rerouted"]
            _close(ref, port, f"reroute{i}", r)
            _close(ref, port, f"reroute_drop{i}", r)
        assert total > 0 and dp["reroute_pvar"] == total


def test_dcn_overflow_bounded_and_attributed(jobs):
    """dcn_overflow on the 2x2 grid: the overflow ships to the replica,
    metered into the pvars and the hier table's DCN level, every token
    served (the output is its picked expert's FFN within the reference's
    tolerance of a float64 oracle, and of the reference's output); half
    the overflow's bytes as budget bounds the remote leg and drops the
    rest, as in the reference."""
    ref, port = jobs
    e_local, d, f, t = 2, 16, 8, 32
    for r in range(N):
        dr, dp = _doc(ref, r), _doc(port, r)
        info = dp["dcn"]
        assert info == dr["dcn"]
        assert info["kept"] + info["dropped"] + info["dcn_tokens"] == t
        assert info["dcn_tokens"] > 0 and info["dropped"] == 0
        assert dp["dcn_pvars"] == [info["dcn_tokens"], info["dcn_bytes"]]
        assert dp["dcn_hier"][2] == info["dcn_bytes"] \
            and dp["dcn_hier"][1] == 0.0
        assert dp["dcn_hier"] == dr["dcn_hier"]
        x = np.load(port / f"dcn_x_r{r}.npy")
        ids = np.load(port / f"dcn_ids_r{r}.npy")
        wg = ZipfTraffic(e_local * 2, d, hotness=1.5, seed=6).wg
        lg = x @ wg
        gates = np.exp(lg - lg.max(-1, keepdims=True))
        gates = gates / gates.sum(-1, keepdims=True)
        oracle = np.zeros_like(x)
        for i in range(t):
            e = int(ids[i])
            r2 = np.random.default_rng(200 + e // e_local)
            w1e = r2.standard_normal((e_local, d, f)).astype(np.float32)
            w2e = r2.standard_normal((e_local, f, d)).astype(np.float32)
            h = np.maximum(x[i] @ w1e[e % e_local], 0.0)
            oracle[i] = gates[i, e] * (h @ w2e[e % e_local])
        np.testing.assert_allclose(np.load(port / f"dcn_r{r}.npy"), oracle,
                                   rtol=RTOL, atol=ATOL)
        _close(ref, port, "dcn", r)
        budget, binfo = dp["dcn_budget"]
        assert [budget, binfo] == dr["dcn_budget"]
        assert binfo["dcn_bytes"] <= budget
        assert binfo["dcn_tokens"] < info["dcn_tokens"]
        assert binfo["dropped"] > 0
        assert binfo["kept"] + binfo["dropped"] + binfo["dcn_tokens"] == t
        _close(ref, port, "dcn_budget", r)


def test_monitoring_tables_match_reference(jobs):
    """The job's serve, expert-load and per-level tables on the plane
    are the reference's; the port's expert load also holds the routing of
    its in-job ``moe_ffn`` check (the drop dispatch's counts again)."""
    ref, port = jobs
    for r in range(N):
        dr, dp = _doc(ref, r), _doc(port, r)
        assert dp["serve"] == dr["serve"]
        want = dict(dr["expert"])
        for e, c in enumerate(dp["drop"]["counts"]):
            if c:
                want[str(e)] = want.get(str(e), 0) + c
        assert dp["expert"] == want
        assert dp["hier_levels"] == dr["hier_levels"]


def test_bad_policy_err_arg_at_first_dispatch_uncached(jobs):
    ref, port = jobs
    for r in range(N):
        dr, dp = _doc(ref, r), _doc(port, r)
        for e in dp["bad_policy"]:
            assert e[0] == errors.ERR_ARG and "drp" in e[1]
        assert dp["bad_policy"] == dr["bad_policy"]
        assert dp["bad_policy_fixed"]["tokens"] == 8
        assert dp["bad_policy_fixed"] == dr["bad_policy_fixed"]


def test_router_width_mismatch_err_arg(jobs):
    ref, port = jobs
    for r in range(N):
        dr, dp = _doc(ref, r), _doc(port, r)
        e = dp["narrow_router"]
        assert e[0] == errors.ERR_ARG and "router" in e[1] \
            and "comm.size" in e[1]
        e = dp["flat_router_on_grid"]
        assert e[0] == errors.ERR_ARG and "n_ici" in e[1]
        assert dp["narrow_router"] == dr["narrow_router"]
        assert dp["flat_router_on_grid"] == dr["flat_router_on_grid"]


def test_dcn_overflow_without_grid_err_arg(jobs):
    ref, port = jobs
    for r in range(N):
        dr, dp = _doc(ref, r), _doc(port, r)
        assert dp["no_grid"][0] == errors.ERR_ARG
        assert dp["no_grid"] == dr["no_grid"]


# ---------------------------------------------------------------------------
# decode loop + [serve] report section (in process)


class _FakeDispatcher:
    policy = "drop"

    def __call__(self, x):
        t = len(x)
        drop = t // 4
        return np.zeros_like(x), {
            "policy": self.policy, "tokens": t, "kept": t - drop,
            "rerouted": 0, "dropped": drop, "multi_assigned": 0,
            "dcn_tokens": 0, "dcn_bytes": 0,
            "counts": [3 * t // 4, t // 8, t // 8]}


def test_run_decode_tail_latency_summary():
    """The summary's counts equal the reference loop's on the same fake
    dispatcher; the tail is ordered and distinct from throughput."""
    from ompi_tpu.serve import run_decode as ref_run_decode
    from ompi_tpu.serve import ZipfTraffic as RefZipf

    res = run_decode(_FakeDispatcher(), ZipfTraffic(3, 8, hotness=1.1,
                                                    seed=2),
                     n_requests=16, tokens_per_request=8, warmup=1)
    want = ref_run_decode(_FakeDispatcher(), RefZipf(3, 8, hotness=1.1,
                                                     seed=2),
                          n_requests=16, tokens_per_request=8, warmup=1)
    timed = ("p50_ms", "p95_ms", "p99_ms", "tokens_per_s")
    assert {k: v for k, v in res.items() if k not in timed} \
        == {k: v for k, v in want.items() if k not in timed}
    assert res["requests"] == 16 and res["tokens"] == 128
    assert res["dropped"] == 32 and res["drop_rate"] == 0.25
    assert 0 < res["p50_ms"] <= res["p95_ms"] <= res["p99_ms"]
    assert res["tokens_per_s"] > 0
    assert res["hot_expert"] == 0 and res["hot_share"] >= 0.5


def test_serve_report_section_names_hot_expert():
    """The same serve events render the reference's report text."""
    from ompi_tpu.monitoring import matrix as R_matrix
    from ompi_tpu.monitoring import merge as R_merge
    from ompi_tpu.monitoring import report as R_report

    texts = []
    for M, G, R in ((P_matrix, P_merge, P_report),
                    (R_matrix, R_merge, R_report)):
        tm = M.TrafficMatrix(rank=0, level=1, nranks=1)
        tm.serve_event("reroute", tokens=256, kept=200, rerouted=40,
                       dropped=16, dcn_tokens=0, dcn_bytes=0)
        tm.serve_event("reroute", requests=8, lat_ns=2_000_000)
        tm.serve_event("reroute", requests=8, lat_ns=9_000_000)
        tm.expert_tokens([200, 16, 24, 16])
        merged = G.merge([G.snapshot_doc(tm)])
        assert merged["serve"]["reroute"]["tokens"] == 256
        assert merged["serve"]["reroute"]["requests"] == 16
        text = R.render(merged)
        merged2 = G.merge([json.loads(json.dumps(G.snapshot_doc(tm)))])
        assert R.render(merged2) == text
        texts.append(text)
    text = texts[0]
    assert text == texts[1]
    assert "[serve] policy reroute" in text
    assert "rerouted 40" in text
    assert "~p99" in text and "~p50" in text
    assert "hot expert: e0" in text
    assert "78.1% of routed tokens" in text
    assert "HOT" in text
