"""The port's correctness plane (``check/``: the lint rules and CLI, the
runtime sanitizer, the ``check_level`` knob) against the JAX package's:
the counterparts of ``tests/test_check.py``'s 31 cases, plus the port's
own: the sanitizer's buffer fingerprint on tensors and buckets, the API
parameter names level 1 binds, and the request classes it tracks.

In this process: every lint case runs the same source through both
packages' engines, and their findings must be equal as (rule, line,
message); the one difference is the one-sided window producer, which the
port names ``win_create_cuda`` where the reference names
``win_create_pallas`` (:func:`_port_src`). The sanitizer cases drive
both packages' ``Sanitizer`` with the same calls (an injected store
client for level 2, as the reference's cases do) and compare what they
raise; the hang dump is the port's watchdog's.

Launcher jobs, one per package on 2 ranks under ``check_level 2``: a
rank-dependent Allreduce count raises the named ``MPIError`` on both
ranks, with the same text in both packages (numpy buffers, then on the
port CPU tensors under the device plane, the second mismatch of each
job), and matched traffic goes on; the port's job also reports a
``Send_init`` never freed as a leak at Finalize. One more port job, on 4
ranks, runs ``ompi_tpu_torch/examples/correctness.py --device --tiny``,
the card's ``chip_smoke.py`` phase 19, on the CPU platform; and one on 3
ranks under ``--mca ft 1`` holds level 2 to the reference's behaviour
when a peer dies: the wait ends at ``check_match_timeout`` and the
device Allreduce raises ProcFailedError.
"""

import inspect
import json
import os
import subprocess
import sys
import textwrap
import threading
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu.check as R_check
import ompi_tpu_torch.check as P_check
from ompi_tpu import errors as R_errors
from ompi_tpu import mpi as R_mpi
from ompi_tpu.check import lint as R_lint
from ompi_tpu.check import sanitizer as R_san
from ompi_tpu.check.__main__ import main as R_main
from ompi_tpu.core import pvar as R_pvar
from ompi_tpu.runtime import kvstore as R_kv
from ompi_tpu_torch import errors as P_errors
from ompi_tpu_torch import mpi as P_mpi
from ompi_tpu_torch.check import lint as P_lint
from ompi_tpu_torch.check import sanitizer as P_san
from ompi_tpu_torch.check.__main__ import main as P_main
from ompi_tpu_torch.core import pvar as P_pvar
from ompi_tpu_torch.runtime import kvstore as P_kv
from ompi_tpu_torch.telemetry import flight as P_flight
from ompi_tpu_torch.telemetry.watchdog import Watchdog as P_Watchdog
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse
from tests.test_torch_trace import planes_off, port_job  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: side -> (check, lint, sanitizer, errors, pvar, kvstore, CLI main)
SIDES = {"ref": (R_check, R_lint, R_san, R_errors, R_pvar, R_kv, R_main),
         "port": (P_check, P_lint, P_san, P_errors, P_pvar, P_kv, P_main)}


@pytest.fixture(autouse=True)
def sanitizers_off():
    """Both packages' sanitizers down before and after each case."""
    R_san.disable()
    P_san.disable()
    yield
    R_san.disable()
    P_san.disable()


pytestmark = pytest.mark.usefixtures("planes_off")


def _port_src(src: str) -> str:
    """The source as a program of the port: its CudaWindow producer."""
    return src.replace("win_create_pallas", "win_create_cuda")


def _keys(findings):
    return [(f.rule, f.line, f.message, f.suppressed) for f in findings]


def _lint(src, path="prog.py", rule=None):
    """The port's findings on ``src``; the reference's on the same source
    must be the same (rule, line, message, suppressed)."""
    src = textwrap.dedent(src)
    got = {}
    for side, lint, mapped in (("ref", R_lint, src),
                               ("port", P_lint, _port_src(src))):
        fs = lint.lint_source(mapped, path)
        if rule is not None:
            fs = [f for f in fs if f.rule == rule]
        got[side] = fs
    assert _keys(got["port"]) == _keys(got["ref"])
    return got["port"]


# -- lint rules: one positive + one negative each ------------------------

def test_unwaited_request_dropped_and_named():
    fs = _lint("""
        def f(comm, buf):
            comm.isend(buf, dest=1)
    """, rule="unwaited-request")
    assert len(fs) == 1 and "isend" in fs[0].message
    fs = _lint("""
        def f(comm, buf):
            r = comm.irecv(buf, source=0)
    """, rule="unwaited-request")
    assert len(fs) == 1 and "'r'" in fs[0].message


def test_unwaited_request_negative_waited_or_returned():
    assert _lint("""
        def f(comm, buf):
            r = comm.isend(buf, dest=1)
            r.wait()
    """, rule="unwaited-request") == []
    assert _lint("""
        def f(comm, buf):
            return comm.isend(buf, dest=1)
    """, rule="unwaited-request") == []


def test_pready_outside_start_positive():
    fs = _lint("""
        def f(comm, buf):
            req = comm.psend_init(buf, 4, dest=1)
            req.pready(0)
            req.wait()
    """, rule="pready-outside-start")
    assert len(fs) == 1 and "no Start" in fs[0].message


def test_pready_after_start_negative():
    assert _lint("""
        def f(comm, buf):
            req = comm.psend_init(buf, 4, dest=1)
            req.start()
            req.pready(0)
            req.wait()
    """, rule="pready-outside-start") == []


def test_osc_unclosed_epoch_positive():
    """The port's CudaWindow producer (``win_create_cuda``) opens a
    window the rule follows, as ``win_create_pallas`` does in the
    reference."""
    fs = _lint("""
        def f(comm, base, peers):
            win = osc.win_create(comm, base)
            win.Lock(1)
            win.Put(base, 1)
            win.Free()
            w2 = osc.win_create_pallas(comm, base)
            w2.Start(peers)
            w2.Put(base, peers[0])
            w2.Free()
    """, rule="osc-unclosed-epoch")
    assert len(fs) == 2
    assert "no Unlock" in fs[0].message and "'win'" in fs[0].message
    assert "no Complete" in fs[1].message and "'w2'" in fs[1].message
    fs = P_lint.lint_source(textwrap.dedent("""
        def f(comm, base):
            w3 = osc.win_create_device(comm, base)
            w3.Lock_all()
            w3.Free()
    """))
    assert [f.rule for f in fs] == ["osc-unclosed-epoch"]


def test_osc_unclosed_epoch_negative():
    assert _lint("""
        def f(comm, base, peers, foreign):
            win = osc.win_create(comm, base)
            win.Lock(1)
            win.Put(base, 1)
            win.Unlock(1)
            win.Post(peers)
            win.Wait()
            win.Free()
            foreign.Lock(0)          # not created here: cannot see
            self_like = comm
            self_like.obj.Start(peers)  # attribute receiver: skip
    """, rule="osc-unclosed-epoch") == []


def test_rank_divergent_collective_positive():
    fs = _lint("""
        def f(comm, x):
            if comm.rank == 0:
                comm.bcast(x)
    """, rule="collective-order-divergence")
    assert len(fs) == 1 and "comm.rank" in fs[0].message
    assert "bcast" in fs[0].message and "deadlock" in fs[0].message


def test_rank_divergent_negative_other_comms_rank():
    assert _lint("""
        def f(comm, other, x):
            if other.rank == 0:
                comm.bcast(x)
    """, rule="collective-order-divergence") == []


def test_buffer_reuse_before_wait_positive():
    fs = _lint("""
        def f(comm, buf, new):
            req = comm.Isend(buf, dest=1)
            buf = new
            req.wait()
    """, rule="buffer-reuse-before-wait")
    assert len(fs) == 1 and "'buf'" in fs[0].message


def test_buffer_reuse_after_wait_negative():
    assert _lint("""
        def f(comm, buf, new):
            req = comm.Isend(buf, dest=1)
            req.wait()
            buf = new
    """, rule="buffer-reuse-before-wait") == []


def test_handle_leak_positive():
    fs = _lint("""
        def f(comm):
            sub = comm.split(1)
            sub.bcast(0)
    """, rule="handle-leak")
    assert len(fs) == 1 and "split" in fs[0].message


def test_handle_freed_or_escaping_negative():
    assert _lint("""
        def f(comm):
            sub = comm.split(1)
            sub.bcast(0)
            sub.free()
    """, rule="handle-leak") == []
    assert _lint("""
        def f(comm):
            sub = comm.dup()
            return sub
    """, rule="handle-leak") == []


def test_bare_public_raise_is_path_scoped():
    src = """
        def g(n):
            if n < 0:
                raise ValueError("bad")
    """
    for root in ("ompi_tpu", "ompi_tpu_torch"):
        fs = _lint(src, path=f"{root}/coll/x.py", rule="bare-public-raise")
        assert len(fs) == 1 and "MPIError" in fs[0].message
        assert _lint(src, path=f"{root}/util/x.py",
                     rule="bare-public-raise") == []


def test_unregistered_pvar_literal_only():
    fs = _lint("""
        from ompi_tpu.core import pvar

        def f():
            pvar.record("definitely_not_registered_xyz")
    """, rule="unregistered-pvar")
    assert len(fs) == 1 and "WELL_KNOWN" in fs[0].message
    assert _lint("""
        from ompi_tpu.core import pvar

        def f(op):
            pvar.record("allreduce")
            pvar.record(f"trace_hist_{op}")
    """, rule="unregistered-pvar") == []


def test_unregistered_pvar_reads_the_ports_table():
    """The port's rule reads the port's ``core/pvar.py``: its own names
    (and families) are registered, the reference's Pallas names are not;
    the check plane's own pvars are in both tables."""
    src = textwrap.dedent("""
        from ompi_tpu_torch.core import pvar

        def f():
            pvar.record("coll_cuda_launches")
            pvar.record("profile_allreduce_calls")
            pvar.record("check_sig_exchanges")
            pvar.record("memchecker_violations")
            pvar.record("pallas_launches")
    """)
    fs = [f for f in P_lint.lint_source(src)
          if f.rule == "unregistered-pvar"]
    assert [f.message.split("'")[1] for f in fs] == ["pallas_launches"]
    for name in ("check_violations", "check_leaks", "check_sig_exchanges",
                 "memchecker_violations", "check_lint_files",
                 "check_lint_cached_files", "check_lint_cfg_paths"):
        assert name in P_pvar.WELL_KNOWN and name in R_pvar.WELL_KNOWN


def test_unguarded_observability_positive_and_guarded():
    fs = _lint("""
        from ompi_tpu.telemetry import flight

        def f():
            flight.FLIGHT.enter("x")
    """, rule="unguarded-observability")
    assert len(fs) == 1 and "FLIGHT" in fs[0].message
    assert _lint("""
        from ompi_tpu.telemetry import flight

        def f():
            if flight.FLIGHT is not None:
                flight.FLIGHT.enter("x")

        def g():
            fl = flight.FLIGHT
            if fl is not None:
                fl.enter("x")
    """, rule="unguarded-observability") == []


def test_suppression_comment_marks_not_hides():
    fs = _lint("""
        def f(comm, buf):
            comm.isend(buf, dest=1)  # check: disable=unwaited-request
    """)
    assert [f.rule for f in fs] == ["unwaited-request"]
    assert fs[0].suppressed and P_lint.unsuppressed(fs) == []
    fs = _lint("""
        def f(comm, buf):
            comm.isend(buf, dest=1)  # check: disable=all
    """)
    assert fs and all(f.suppressed for f in fs)


def test_parse_error_is_a_finding():
    got = {side: _keys(lint.lint_source("def f(:\n", "bad.py"))
           for side, (_, lint, *_r) in SIDES.items()}
    assert got["port"] == got["ref"]
    assert [k[0] for k in got["port"]] == ["parse-error"]


def test_framework_self_lint_clean():
    """Each package's check/ tree lints itself clean."""
    for root, lint in (("ompi_tpu", R_lint), ("ompi_tpu_torch", P_lint)):
        assert lint.unsuppressed(lint.lint_paths(
            [os.path.join(ROOT, root, "check")])) == []


# -- CLI -----------------------------------------------------------------

def test_cli_lint_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(comm, buf):\n    comm.isend(buf, dest=1)\n")
    good = tmp_path / "good.py"
    good.write_text("def f(comm, buf):\n"
                    "    r = comm.isend(buf, dest=1)\n"
                    "    r.wait()\n")
    got = {}
    for side, (*_m, main) in SIDES.items():
        runs = []
        for path in (bad, good, tmp_path / "missing.py"):
            rc = main(["lint", str(path)])
            out = capsys.readouterr()
            runs.append((rc, out.out, out.err))
        got[side] = runs
    assert got["port"] == got["ref"]
    (rc_bad, out_bad, err_bad), (rc_good, _, _), (rc_miss, _, err_miss) = \
        got["port"]
    assert rc_bad == 1 and "unwaited-request" in out_bad
    assert "1 finding(s)" in err_bad
    assert rc_good == 0
    assert rc_miss == 1 and "no such path" in err_miss


def test_cli_rules_prints_catalog(capsys):
    outs = {}
    for side, (*_m, main) in SIDES.items():
        assert main(["rules"]) == 0
        outs[side] = capsys.readouterr().out
    assert outs["port"] == outs["ref"]
    assert "unwaited-request" in outs["port"] and "disable=" in outs["port"]
    # and as ``python -m``, the port's own entry point
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.check",
                        "rules"], cwd=ROOT, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and r.stdout == outs["port"]


# -- level() knob --------------------------------------------------------

def test_level_env_parsing(monkeypatch):
    for check in (R_check, P_check):
        monkeypatch.delenv("OMPI_TPU_CHECK", raising=False)
        assert check.level() == 0 and not check.requested()
        for raw, want in (("2", 2), ("7", 2), ("yes", 1), ("off", 0)):
            monkeypatch.setenv("OMPI_TPU_CHECK", raw)
            assert check.level() == want, (check.__name__, raw)


# -- sanitizer: param checks ---------------------------------------------

def _comm(size=4, freed=False):
    return types.SimpleNamespace(size=size, _freed=freed, cid=1, rank=0)


#: (name, args, kwargs) the reference's case raises on, in order
_BAD_CALLS = (
    ("Bcast", (np.zeros(2),), {"root": 9}, False),
    ("Send", (np.zeros(2), 4), {}, False),
    ("Send", (np.zeros(2), 1), {"tag": -3}, False),
    ("Scatterv", (np.zeros(4), np.zeros(1), [1, -2, 1, 1]), {}, False),
    ("Bcast", (np.zeros(2),), {}, True),
)


def test_check_call_bounds_and_freed_comm():
    got = {}
    for side, (_c, _l, san_mod, errs, pvar, *_r) in SIDES.items():
        s = san_mod.Sanitizer(rank=0, level=1)
        before = pvar.read("check_violations")
        raised = []
        for name, args, kwargs, freed in _BAD_CALLS:
            with pytest.raises(errs.MPIError) as ei:
                s.check_call(name, _comm(freed=freed), args, kwargs)
            raised.append((ei.value.error_class, str(ei.value)))
        s.check_call("Bcast", _comm(), (np.zeros(2),), {"root": 3})
        s.check_call("Recv", _comm(), (np.zeros(2),),
                     {"source": 1, "tag": -1})
        assert pvar.read("check_violations") - before == len(_BAD_CALLS)
        got[side] = raised
    assert got["port"] == got["ref"]
    assert [c for c, _ in got["port"]] == [
        P_errors.ERR_ROOT, P_errors.ERR_RANK, P_errors.ERR_TAG,
        P_errors.ERR_COUNT, P_errors.ERR_COMM]
    # the port's checks see tensors too: the buffer is not what binds
    s = P_san.Sanitizer(rank=0, level=1)
    with pytest.raises(P_errors.MPIError) as ei:
        s.check_call("Bcast", _comm(), (torch.zeros(2),), {"root": -1})
    assert ei.value.error_class == P_errors.ERR_ROOT


_CHECKED = ("root", "dest", "source", "tag", "count", "counts", "scounts",
            "rcounts", "partitions")


def test_level1_binds_the_same_parameter_names():
    """Level 1 binds each call against its API signature: the names it
    checks (root, dest, source, tag, the counts, partitions) are the same
    in both packages for every API name they share, so a rename cannot
    turn a check off unseen. The port's signatures may add
    ``deterministic=``; the reference's Get_info / Set_info are the only
    names the port's table lacks."""
    assert set(R_mpi._API) - set(P_mpi._API) == {"Get_info", "Set_info"}
    assert set(P_mpi._API) <= set(R_mpi._API)
    checked = 0
    for name in sorted(P_mpi._API):
        a = list(inspect.signature(R_mpi._API[name]).parameters)
        b = list(inspect.signature(P_mpi._API[name]).parameters)
        assert [p for p in b if p in _CHECKED] \
            == [p for p in a if p in _CHECKED], name
        assert set(b) - set(a) <= {"deterministic"}, name
        assert set(a) <= set(b), name
        checked += bool([p for p in b if p in _CHECKED])
    assert checked >= 30


# -- sanitizer: request registry -----------------------------------------

class _Req:
    def __init__(self, id=1, persistent=False):
        self.id = id
        self.persistent = persistent


def test_use_after_free_raises_at_the_call():
    got = {}
    for side, (_c, _l, san_mod, errs, *_r) in SIDES.items():
        s = san_mod.Sanitizer(rank=0, level=1)
        r = _Req(id=7)
        s.track(r)
        s.on_free(r)
        with pytest.raises(errs.MPIError) as ei:
            s.on_wait(r)
        assert ei.value.error_class == errs.ERR_REQUEST
        with pytest.raises(errs.MPIError) as es:
            s.on_start(r)
        got[side] = (str(ei.value), str(es.value))
    assert got["port"] == got["ref"]
    assert "use after free" in got["port"][0]


def test_leak_report_names_persistent_and_incomplete():
    got = {}
    for side, (_c, _l, san_mod, _e, pvar, *_r) in SIDES.items():
        s = san_mod.Sanitizer(rank=0, level=1)
        leaked_p = _Req(id=1, persistent=True)
        leaked_n = _Req(id=2)
        clean = _Req(id=3)
        for r in (leaked_p, leaked_n, clean):
            s.track(r)
        s.on_complete(clean)
        before = pvar.read("check_leaks")
        leaks = s.leak_report()
        assert pvar.read("check_leaks") == before + 2
        s.on_free(leaked_p)
        s.on_free(leaked_n)
        assert s.leak_report() == []
        got[side] = sorted(leaks, key=lambda l: l["id"])
    assert got["port"] == got["ref"]
    whys = {l["id"]: l["why"] for l in got["port"]}
    assert "never freed" in whys[1] and "never completed" in whys[2]


def test_request_tracking_covers_the_references_classes():
    """Both packages patch the subclasses of their pml Request (pml and
    part/ requests); coll/device's device requests are not such
    subclasses in either package and stay untracked."""
    from ompi_tpu_torch.coll import device as P_device
    from ompi_tpu_torch.pml import request as P_rq

    classes = {c.__name__ for c in P_san._all_request_classes()}
    assert "Request" in classes and "DeviceRequest" not in classes
    assert not issubclass(P_device.DeviceRequest, P_rq.Request)
    P_san.enable(rank=0, level=1)
    try:
        assert hasattr(P_rq.Request.wait, "__wrapped__")
        assert not hasattr(P_device.DeviceRequest.wait, "__wrapped__")
    finally:
        P_san.disable()


# -- sanitizer: cross-rank signature matching ----------------------------

def _mismatch(kv, san_mod, errs):
    store = kv.Store().start()
    c0, c1 = kv.Client(store.addr), kv.Client(store.addr)
    try:
        s0 = san_mod.Sanitizer(rank=0, world=[0, 1], jobid="t", client=c0,
                               level=2, match_timeout=20)
        s1 = san_mod.Sanitizer(rank=1, world=[0, 1], jobid="t", client=c1,
                               level=2, match_timeout=20)
        errs_seen = {}

        def go(s, count_hash):
            try:
                s.match_collective("Allreduce", cid=0, dtype="float32",
                                   count_hash=count_hash)
            except errs.MPIError as exc:
                errs_seen[s.rank] = str(exc)

        t = threading.Thread(target=go, args=(s1, 8))
        t.start()
        go(s0, 4)
        t.join()
        t = threading.Thread(target=s1.match_collective,
                             args=("Bcast", 0, "any", 0))
        t.start()
        s0.match_collective("Bcast", 0, "any", 0)
        t.join()
        return (errs_seen, s0.last_mismatch, s1.last_mismatch["peer"],
                s0._seq[0])
    finally:
        c0.close()
        c1.close()
        store.stop()


def test_signature_mismatch_raises_on_both_ranks():
    got = {side: _mismatch(kv, san_mod, errs) for side, (
        _c, _l, san_mod, errs, _p, kv, _m) in SIDES.items()}
    assert got["port"] == got["ref"]
    errs_seen, last0, peer1, seq = got["port"]
    assert set(errs_seen) == {0, 1}
    assert "Allreduce" in errs_seen[0] and "seq 1" in errs_seen[0]
    assert "rank 0" in errs_seen[0] and "rank 1" in errs_seen[0]
    assert last0["peer"] == 1 and last0["seq"] == 1 and peer1 == 0
    assert seq == 2


def test_signature_match_timeout_proceeds():
    for _c, _l, san_mod, _e, _p, kv, _m in SIDES.values():
        store = kv.Store().start()
        c0 = kv.Client(store.addr)
        try:
            s0 = san_mod.Sanitizer(rank=0, world=[0, 1], jobid="solo",
                                   client=c0, level=2, match_timeout=0.05)
            s0.match_collective("Allreduce", cid=0, dtype="float32",
                                count_hash=4)
            assert s0.last_mismatch is None
        finally:
            c0.close()
            store.stop()


def test_buf_signature_shapes():
    for san_mod in (R_san, P_san):
        dt, ch = san_mod._buf_signature((np.ones(8, np.float32),))
        assert dt == "float32" and ch == san_mod._crc(8)
        assert san_mod._buf_signature(({"a": 1},))[0] == "dict"
        assert san_mod._buf_signature(()) == ("none", 0)


def test_buf_signature_tensors_match_the_reference():
    """A tensor fingerprints as the reference's array of the same dtype
    and size (numel, numpy's dtype name); a bucket (a list or dict of
    leaves) by its length, as the reference's does."""
    r, p = R_san._buf_signature, P_san._buf_signature
    assert p((torch.ones(8),)) == r((np.ones(8, np.float32),)) \
        == ("float32", R_san._crc(8))
    assert p((torch.ones(2, 3, dtype=torch.bfloat16),)) \
        == r((np.ones((2, 3), ml_dtypes.bfloat16),)) \
        == ("bfloat16", R_san._crc(6))
    assert p((torch.ones(5, dtype=torch.int32),)) \
        == r((np.ones(5, np.int32),))
    assert p((np.arange(7, dtype=np.float64),)) \
        == r((np.arange(7, dtype=np.float64),))
    leaves = [torch.ones(3), torch.ones(4, 5)]
    arrays = [np.ones(3, np.float32), np.ones((4, 5), np.float32)]
    assert p((leaves,)) == r((arrays,)) == ("list", R_san._crc(2))
    assert p(({"b": leaves[0], "a": leaves[1]},)) \
        == r(({"b": arrays[0], "a": arrays[1]},)) == ("dict", R_san._crc(2))


def test_buf_signature_two_tensor_sizes_two_hashes():
    """A tensor's ``size`` is a method: read as the reference reads an
    array, every tensor would hash as count 0 and a rank-dependent count
    would pass level 2 unseen."""
    a = P_san._buf_signature((torch.ones(1),))
    b = P_san._buf_signature((torch.ones(2),))
    assert a[0] == b[0] == "float32" and a[1] != b[1]
    assert a[1] != P_san._crc(0)


# -- watchdog integration ------------------------------------------------

def test_hang_dump_carries_check_mismatch(tmp_path, monkeypatch):
    s = P_san.Sanitizer(rank=0, level=2)
    s.last_mismatch = {"op": "Allreduce", "seq": 3, "cid": 0,
                       "rank": 0, "peer": 1}
    monkeypatch.setattr(P_san, "SANITIZER", s)
    fl = P_flight.FlightRecorder(rank=0)
    fl.enter("allreduce_dev", comm_cid=0, nbytes=64)
    wd = P_Watchdog(rank=0, world=[0], client=None, flight_rec=fl,
                    dead_fn=lambda: {}, period=10, timeout=0.0,
                    action="dump", dump_dir=str(tmp_path))
    v = wd.sweep()
    assert v is not None and v["seq"] == 1
    doc = json.load(open(wd._dumped[(1, "hang")]))
    assert doc["check_mismatch"] == s.last_mismatch


# -- lifecycle + zero-overhead -------------------------------------------

def test_enable_disable_roundtrip_restores_requests():
    from ompi_tpu_torch.pml import request as rq

    assert P_san.SANITIZER is None
    P_san.enable(rank=0, level=1)
    try:
        assert P_san.SANITIZER is not None
        assert P_san.SANITIZER.level == 1
        assert hasattr(rq.Request.wait, "__wrapped__")
        assert P_san._request_patches
        P_san.enable(rank=0, level=2)  # idempotent: first wins
        assert P_san.SANITIZER.level == 1
        assert P_check.get_sanitizer() is P_san.SANITIZER
    finally:
        P_san.disable()
    assert P_san.SANITIZER is None and P_check.get_sanitizer() is None
    assert not P_san._request_patches
    assert not hasattr(rq.Request.wait, "__wrapped__")
    P_san.disable()  # idempotent


def test_zero_overhead_when_disabled(monkeypatch):
    from ompi_tpu_torch.pml import request as rq

    monkeypatch.delenv("OMPI_TPU_CHECK", raising=False)
    assert not P_check.requested()
    assert P_check.get_sanitizer() is None and P_san.SANITIZER is None
    assert not P_san._request_patches
    assert not hasattr(rq.Request.wait, "__wrapped__")


# -- end to end: 2 ranks, seeded mismatch --------------------------------

_PROG = '''
import json, os
import numpy as np
from {pkg} import check, errors
out_dir = {out!r}
san = check.get_sanitizer()
doc = {{"level": san.level if san is not None else 0, "msgs": []}}
for buf in BUFS:
    try:
        comm.Allreduce(buf)
    except errors.MPIError as exc:
        doc["msgs"].append(str(exc))
    else:
        doc["msgs"].append("missed")
doc["matched"] = comm.allreduce(1)
'''

_REF_TAIL = '''
with open(os.path.join(out_dir, f"doc_r{rank}.json"), "w") as fh:
    json.dump(doc, fh)
'''

_PORT_HEAD = '''
import numpy as np
import torch
from ompi_tpu_torch import mpi
from ompi_tpu_torch.core import pvar
comm = mpi.Init()
rank, size = comm.rank, comm.size
'''

_PORT_TAIL = '''
t = comm.Allreduce(torch.full((4,), float(rank + 1)))
doc["tensor_sum"] = t.tolist()
req = comm.Send_init(np.zeros(4), (rank + 1) % size, tag=3)
mpi.Finalize()
doc["leaks"] = pvar.read("check_leaks")
with open(os.path.join(out_dir, f"doc_r{rank}.json"), "w") as fh:
    json.dump(doc, fh)
'''


@pytest.fixture(scope="module")
def mismatch_jobs(tmp_path_factory):
    ref = tmp_path_factory.mktemp("check_ref")
    port = tmp_path_factory.mktemp("check_port")
    run_ranks("BUFS = [np.ones(rank + 1, np.float32)] * 2\n"
              + _PROG.format(pkg="ompi_tpu", out=str(ref)) + _REF_TAIL, 2,
              mca={"check_level": "2"}, timeout=120, isolate=True)
    port_job(textwrap.dedent(_PORT_HEAD)
             + "BUFS = [np.ones(rank + 1, np.float32), "
               "torch.ones(rank + 1)]\n"
             + _PROG.format(pkg="ompi_tpu_torch", out=str(port))
             + _PORT_TAIL, 2,
             {"check_level": "2", "device_plane": "on",
              "device_plane_platform": "cpu"}, timeout=120)
    return ref, port


def test_seeded_allreduce_mismatch_two_ranks(mismatch_jobs):
    """Under check_level=2 a rank-dependent Allreduce count raises a
    named MPIError on both ranks at the call, with the reference's text
    (numpy, then CPU tensors on the port: seq 1 and 2), and matched
    collectives go on; a persistent request never freed is a leak at
    Finalize."""
    ref, port = mismatch_jobs
    for r in (0, 1):
        a = json.loads((ref / f"doc_r{r}.json").read_text())
        b = json.loads((port / f"doc_r{r}.json").read_text())
        assert a["level"] == b["level"] == 2
        assert b["msgs"] == a["msgs"], (a["msgs"], b["msgs"])
        for seq, msg in enumerate(b["msgs"], 1):
            assert "signature mismatch" in msg and "Allreduce" in msg
            assert f"seq {seq}" in msg and "rank 0" in msg \
                and "rank 1" in msg
        assert a["matched"] == b["matched"] == 2
        assert b["tensor_sum"] == [3.0] * 4
        assert b["leaks"] == 1


# -- the card's phase 19 on the CPU: examples/correctness.py --------------

def test_correctness_example_four_ranks(tmp_path):
    """``examples/correctness.py --device --tiny`` on 4 ranks of the CPU
    platform, as ``chip_smoke.py``'s phase 19 runs it on the card: every
    rank's cases hold (the Allreduces bitwise their folds at levels 0-2,
    the ZeRO step bitwise at levels 0 and 2, the mismatch named on every
    rank, the memchecker's host flag and the tensor's none), its K1-K3
    launches as derived, one leak at Finalize, and no hang dump."""
    out, dumps = tmp_path / "out", tmp_path / "dumps"
    dumps.mkdir()
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
         "4", "--timeout", "200", "--mca", "device_plane", "on", "--mca",
         "coll_cuda", "on", "--mca", "device_plane_platform", "cpu",
         "--mca", "check_level", "2", "--mca", "telemetry_enable", "1",
         "--mca", "telemetry_hang_timeout", "600", "--mca",
         "telemetry_dump_dir", str(dumps),
         os.path.join("ompi_tpu_torch", "examples", "correctness.py"),
         "--device", "--tiny", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    docs = [json.loads((out / f"rank{i}.json").read_text())
            for i in range(4)]
    for i, d in enumerate(docs):
        assert all(c["ok"] for c in d["cases"]), d["cases"]
        assert d["launches"] == d["expected_launches"]
        assert d["report"]["leaks"] == 1
        assert d["report"]["memchecker_violations"] == (1 - i % 2)
    rep = docs[0]["report"]
    assert set(rep["p50_ms"]) == {f"{nb}_{m}_l{lv}" for nb in (1024, 65536)
                                  for m in ("linear", "ring")
                                  for lv in (0, 1, 2)}
    assert "signature mismatch at Allreduce" in rep["mismatch"]
    assert len(rep["zero_step_ms"]["l0"]) == len(rep["zero_step_ms"]["l2"])
    assert list(dumps.iterdir()) == []


_DEAD_PEER = '''
import json, os, signal, sys, time
import numpy as np
import torch
from ompi_tpu_torch import check, errors, mpi
from ompi_tpu_torch.ft import detector
comm = mpi.Init()
rank = comm.rank
out_dir = sys.argv[1]
doc = {"level": check.get_sanitizer().level,
       "hb_s": detector._timeout_var.get()}
dc = comm.dup()
x = torch.from_numpy(np.arange(1000, dtype=np.float32) * (rank + 1) / 7)
dc.Allreduce(x, deterministic="linear")
dc.Barrier()
if rank == 2:
    time.sleep(0.5)
    os.kill(os.getpid(), signal.SIGKILL)
t0 = time.monotonic()
try:
    dc.Allreduce(x, deterministic="linear")
    doc["raised"] = None
except errors.ProcFailedError as exc:
    doc["raised"] = list(exc.failed_ranks)
except errors.MPIError as exc:
    doc["raised"] = str(exc)
doc["raise_s"] = time.monotonic() - t0
dc.free()
new = comm.shrink()
got = new.Allreduce(torch.ones(4), deterministic="linear")
doc["after"] = got.tolist()
with open(os.path.join(out_dir, f"r{rank}.json"), "w") as fh:
    json.dump(doc, fh)
mpi.Finalize()
'''


def test_level2_dead_peer_surfaces_proc_failed(tmp_path):
    """Under ``--mca ft 1`` a peer that dies before its next collective
    publishes no fingerprint: level 2 waits ``check_match_timeout`` (1 s
    here; 10 by default) and lets the device Allreduce go on unverified,
    and the Allreduce raises ProcFailedError naming the dead rank within
    a few heartbeat periods after that, the reference's behaviour: the
    failure is delayed by the timeout, never hidden or named a signature
    mismatch. The shrunken comm's matched Allreduce goes on."""
    prog = tmp_path / "dead_peer.py"
    prog.write_text(_DEAD_PEER)
    from ompi_tpu_torch.runtime import launcher as P_launcher

    rc = P_launcher.launch(
        [sys.executable, str(prog), str(tmp_path)], 3,
        mca={"ft": "1", "check_level": "2", "check_match_timeout": "1.0",
             "device_plane": "on", "coll_cuda": "on",
             "device_plane_platform": "cpu"}, timeout=90)
    assert rc == 0
    for r in (0, 1):
        d = json.loads((tmp_path / f"r{r}.json").read_text())
        assert d["level"] == 2 and d["raised"] == [2], d
        assert 1.0 <= d["raise_s"] < 1.0 + 5 * d["hb_s"], d
        assert d["after"] == [2.0] * 4
    assert not (tmp_path / "r2.json").exists()
