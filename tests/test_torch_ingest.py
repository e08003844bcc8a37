"""The port's streaming ingest plane (``ingest/``, the accelerator's upload
pool and ``put_chunk``, the shared ``part/partial`` mixin) against the JAX
package's: the counterparts of ``tests/test_ingest.py``'s cases.

In this process: the plan (both packages' plans of the same seeded tree
must have the same units, unit for unit), the streamed upload against a
one-shot copy and against the reference's upload, bitwise, for float32,
bfloat16 and int32 leaves (and the reference's mixed tree) at depths 1, 2
and 3, the staging ring under a deliberately slow fake device, the gate,
errors, cancel and teardown (no thread, no staging buffer left),
``Parrived``, the compile lane and the plane's lifecycle. The reference's
two chunked-D2H cases hold the port's device-to-host staging instead
(one copy into one staging buffer, ``io.host_array``, and pml/accel_p2p's
chunk spans): the port has no chunked D2H of its own. Launcher jobs: the
2-rank bring-up through ``--mca ingest_enable 1``, once per package, and
the card example ``ompi_tpu_torch/examples/streaming_ingest.py --tiny``
on the CPU platform, which restores epoch 2 of a ``ckpt_training.py``
crash run through ``restore_to_device`` and must reach the full run's
digest.

Waiting for ROADMAP queue 1 item 10 (the prof ledger and its report):
``test_ledger_cross_thread_overlap``,
``test_ledger_same_phase_threads_do_not_overlap`` and
``test_report_phase_overlap_sweep_and_render``.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.ingest import engine as ie
from ompi_tpu_torch.ingest.plan import IngestPlan
from ompi_tpu_torch.part import partial as part_partial
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_accelerator_state():
    """An upload with no device names it from the selected accelerator,
    which opens the accelerator framework in this process: put the
    selection back as the case found it, so a later case that selects
    anew (``tests/test_torch_errhandler_info.py``) still opens the
    components itself."""
    from ompi_tpu_torch import accelerator

    fw = accelerator.framework
    saved = (accelerator._current, fw._opened, dict(fw.failures))
    yield
    accelerator._current, fw._opened, fw.failures = saved


def _mixed_tree():
    """tests/test_ingest.py's tree: mixed dtypes, a 0-d scalar, an F-order
    leaf, a zero-size leaf."""
    rng = np.random.default_rng(11)
    return {
        "w": rng.standard_normal(50000).astype(np.float32),
        "b": np.float32(3.5),
        "i": rng.integers(0, 1 << 30, 4097).astype(np.int64),
        "h": rng.standard_normal((33, 7)).astype(np.float16),
        "nc": np.asarray(rng.standard_normal((30, 10)).T),
        "z": np.empty((0, 4), np.float32),
    }


def _typed_tree():
    """float32, bfloat16 (a CPU tensor: numpy has none) and int32."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 1 << 16, 30011).astype(np.uint16)
    bits[bits & 0x7F80 == 0x7F80] &= 0xFF7F  # no NaN / inf payloads
    return {
        "f32": rng.standard_normal((101, 77)).astype(np.float32),
        "bf16": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
        "i32": rng.integers(-(1 << 31), 1 << 31, 20003,
                            dtype=np.int64).astype(np.int32),
    }


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return str(x.dtype).encode() + t.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype).encode() + a.tobytes()


class _SlowChunk:
    """A fake device put: ``wait`` sleeps (a copy in flight), then
    snapshots the staging view. A slot packed again too early would show
    another unit's bytes."""

    def __init__(self, view):
        self._view = view
        self.value = None

    def wait(self):
        time.sleep(0.002)
        self.value = np.array(self._view)


# -- plan ------------------------------------------------------------------

def test_plan_deterministic_and_bounded():
    """Both packages cut the same tree into the same units."""
    from ompi_tpu.ingest.plan import IngestPlan as R_Plan

    tree = _mixed_tree()
    p1 = IngestPlan.from_tree(tree, 4096, 3)
    assert p1.signature() == IngestPlan.from_tree(tree, 4096, 3).signature()
    assert p1.signature() != IngestPlan.from_tree(tree, 8192, 3).signature()
    ref = R_Plan.from_tree(tree, 4096, 3)
    assert p1.signature() == ref.signature()
    assert p1.keystrs == ref.keystrs
    for u in p1.units:
        assert u.nbytes <= 4096 and 0 <= u.stream < 3
    assert [u.stream for u in p1.units] == [i % 3
                                            for i in range(p1.n_units)]
    for li, units in enumerate(p1.leaf_units):
        lo = 0
        for u in units:
            assert u.lo == lo
            lo = u.hi
        assert lo == p1.leaves[li].size
    zi = p1.leaf_index("z")
    assert len(p1.leaf_units[zi]) == 1 and p1.leaf_units[zi][0].nbytes == 0
    assert p1.total_bytes == sum(np.asarray(v).nbytes
                                 for v in tree.values())
    # a bfloat16 tensor leaf is planned on its 2-byte bits
    t = _typed_tree()
    pt = IngestPlan.from_tree(t, 4096, 4)
    assert pt.leaf_dtypes[pt.leaf_index("bf16")] == torch.bfloat16
    assert pt.total_bytes == sum(len(_bytes(v)) - len(str(v.dtype))
                                 for v in t.values())


def test_plan_leaf_index_resolution_and_errors():
    p = IngestPlan.from_tree({"w0": np.zeros(4, np.float32)}, 64, 2)
    li = p.leaf_index("w0")
    assert p.leaf_index("['w0']") == li and p.leaf_index(li) == li
    for bad in ("nope", 99):
        with pytest.raises(errors.MPIError) as e:
            p.leaf_index(bad)
        assert e.value.error_class == errors.ERR_ARG
    with pytest.raises(errors.MPIError):
        IngestPlan.from_tree({}, 0, 1)
    with pytest.raises(errors.MPIError):
        IngestPlan.from_tree({}, 64, 0)


# -- bit identity -------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_streamed_upload_bit_identical_to_one_shot(depth):
    """float32, bfloat16 and int32 leaves (and the reference's mixed
    tree) over several stream / chunk geometries equal a one-shot copy,
    and the reference's streamed upload wherever jax keeps the dtype,
    bitwise."""
    from ompi_tpu.ingest import engine as R_ie

    for tree in (_typed_tree(), _mixed_tree()):
        one_shot = {k: torch.from_numpy(np.array(v)) if not isinstance(
            v, torch.Tensor) else v.clone() for k, v in tree.items()}
        rtree = {k: (v.view(torch.int16).numpy() if isinstance(
            v, torch.Tensor) else v) for k, v in tree.items()}
        r_eng = R_ie.IngestEngine(streams=3, chunk_bytes=4096, depth=depth)
        try:
            ref = r_eng.upload(rtree).tree()
        finally:
            r_eng.close()
        for streams, chunk in [(1, 1 << 20), (3, 4096), (4, 8192)]:
            eng = ie.IngestEngine(streams=streams, chunk_bytes=chunk,
                                  depth=depth)
            try:
                got = eng.upload(tree).tree()
                for k in tree:
                    assert got[k].shape == one_shot[k].shape, k
                    assert _bytes(got[k]) == _bytes(one_shot[k]), k
                    want = np.asarray(ref[k])
                    g = got[k].view(torch.int16) \
                        if got[k].dtype == torch.bfloat16 else got[k]
                    if want.dtype == g.numpy().dtype:
                        # (jax without x64 narrows the 8-byte leaves)
                        assert g.numpy().tobytes() == want.tobytes(), k
            finally:
                eng.close()


def test_leaf_assembly_blocks_only_that_leaf():
    gate = threading.Event()

    def put(view, dst, h2d=None):
        if view.nbytes > 4096:
            gate.wait(10)
        return ie.default_put(view, dst, h2d)

    tree = {"fast": np.arange(16, dtype=np.float32),
            "slow": np.arange(100000, dtype=np.float32)}
    eng = ie.IngestEngine(streams=2, chunk_bytes=1 << 20, put=put)
    try:
        req = eng.upload(tree)
        fast = req.leaf("fast")
        assert fast.numpy().tobytes() == tree["fast"].tobytes()
        assert not req.test()
        gate.set()
        got = req.tree()
        assert got["slow"].numpy().tobytes() == tree["slow"].tobytes()
        assert req.leaf("fast") is fast
    finally:
        gate.set()
        eng.close()


# -- the staging ring -----------------------------------------------------------

def test_double_buffer_never_repacks_live_slot():
    a = np.arange(20000, dtype=np.float32)
    eng = ie.IngestEngine(streams=2, chunk_bytes=4096, depth=2,
                          put=lambda v, dst, h2d=None: _SlowChunk(v))
    try:
        req = eng.upload(a).wait()
        for u in req.plan.units:
            assert req._chunks[u.idx].value.tobytes() \
                == a[u.lo:u.hi].tobytes(), u
        assert 1 <= req.inflight_hwm <= eng.depth
    finally:
        eng.close()


def test_depth_one_serializes():
    a = np.arange(8000, dtype=np.float32)
    eng = ie.IngestEngine(streams=1, chunk_bytes=1024, depth=1,
                          put=lambda v, dst, h2d=None: _SlowChunk(v))
    try:
        req = eng.upload(a).wait()
        assert req.inflight_hwm == 1
        for u in req.plan.units:
            assert req._chunks[u.idx].value.tobytes() \
                == a[u.lo:u.hi].tobytes()
    finally:
        eng.close()


def test_put_chunk_copies_off_the_staging_slot():
    """The CPU put is a real copy into the device slice: repacking the
    slot afterwards leaves the landed chunk as it was (the reference's
    alias guard)."""
    from ompi_tpu_torch import accelerator

    view = np.arange(64, dtype=np.float32)
    dst = torch.zeros(64, dtype=torch.float32)
    ev = accelerator.for_device("cpu").put_chunk(view, dst)
    view[:] = -1
    ev.wait()
    assert dst.numpy().tobytes() == np.arange(64, dtype=np.float32).tobytes()
    assert accelerator.for_device("cpu").h2d_streams(3) == [None] * 3


# -- the first step's gate ----------------------------------------------------------

def test_gate_releases_before_tail_and_counts_early_start():
    release = threading.Event()

    def put(view, dst, h2d=None):
        if view.nbytes > 1024:
            release.wait(10)
        return ie.default_put(view, dst, h2d)

    tree = {"w0": np.arange(16, dtype=np.float32),
            "w1": np.arange(50000, dtype=np.float32)}
    s = pvar.session()
    eng = ie.IngestEngine(streams=2, chunk_bytes=1 << 20, put=put)
    try:
        req = eng.upload(tree)
        req.gate(["w0"], timeout=10)
        assert not req.completed
        assert s.read("ingest_early_starts") == 1
        assert s.read("ingest_gate_ns") > 0
        release.set()
        req.wait(10)
        assert req.completed
        req.gate(["w0"])
        assert s.read("ingest_early_starts") == 1
    finally:
        release.set()
        eng.close()


def test_gate_timeout_raises_pending():
    hold = threading.Event()

    def put(view, dst, h2d=None):
        hold.wait(10)
        return ie.default_put(view, dst, h2d)

    eng = ie.IngestEngine(streams=1, chunk_bytes=1 << 20, put=put)
    try:
        req = eng.upload(np.arange(64, dtype=np.float32))
        with pytest.raises(errors.MPIError) as e:
            req.gate(timeout=0.05)
        assert e.value.error_class == errors.ERR_PENDING
    finally:
        hold.set()
        eng.close()


# -- errors, cancel, teardown ---------------------------------------------------------

def test_put_error_surfaces_as_mpierror_and_voids_units():
    def bad_put(view, dst, h2d=None):
        raise RuntimeError("simulated DMA failure")

    s = pvar.session()
    eng = ie.IngestEngine(streams=2, chunk_bytes=1024, put=bad_put)
    try:
        req = eng.upload(np.arange(4096, dtype=np.float32))
        with pytest.raises(errors.MPIError) as e:
            req.wait(10)
        assert e.value.error_class == errors.ERR_INTERN
        assert "simulated DMA failure" in str(e.value)
        assert not req.completed
        assert s.read("ingest_cancelled") > 0
        with pytest.raises(errors.MPIError):
            req.leaf(0)
    finally:
        eng.close()


def test_cancel_then_teardown_leaks_nothing():
    hold = threading.Event()

    def put(view, dst, h2d=None):
        hold.wait(10)
        return ie.default_put(view, dst, h2d)

    s = pvar.session()
    eng = ie.IngestEngine(streams=2, chunk_bytes=1024, put=put)
    req = eng.upload(np.arange(4096, dtype=np.float32))
    eng.overlap_compile(lambda: None).wait(10)
    threads = eng.threads()
    assert len(threads) == 3  # two upload streams and the compile lane
    req.cancel()
    hold.set()
    with pytest.raises(errors.MPIError) as e:
        req.wait(10)
    assert e.value.error_class == errors.ERR_REQUEST
    assert "cancelled" in str(e.value)
    assert s.read("ingest_cancelled") > 0
    eng.close()
    # no staging buffer held, no upload checked out, no thread left
    assert eng._bufs is None and eng._buf_tensors == []
    assert eng.inflight() == 0
    assert eng.threads() == [] and not any(t.is_alive() for t in threads)
    with pytest.raises(errors.MPIError) as e:
        eng.upload(np.zeros(4, np.float32))
    assert e.value.error_class == errors.ERR_OTHER


# -- Parrived (the part/partial mixin) ---------------------------------------------

def test_parrived_semantics_shared_with_part():
    from ompi_tpu_torch.part.host import PartitionedRecvRequest

    assert issubclass(ie.IngestRequest, part_partial.PartialAvailability)
    assert issubclass(PartitionedRecvRequest,
                      part_partial.PartialAvailability)
    eng = ie.IngestEngine(streams=2, chunk_bytes=2048)
    try:
        req = eng.upload(np.arange(4096, dtype=np.float32)).wait()
        assert all(req.Parrived(i) for i in range(req.n_units))
        assert req.Parrived_range(0, req.n_units - 1)
        assert req.Parrived_list([0, req.n_units - 1])
        with pytest.raises(errors.MPIError) as e:
            req.Parrived(req.n_units)
        assert e.value.error_class == errors.ERR_ARG
    finally:
        eng.close()
    plan = IngestPlan.from_tree(np.zeros(4, np.float32), 64, 1)
    fresh = ie.IngestRequest(eng, plan)
    with pytest.raises(errors.MPIError) as e:
        fresh.Parrived(0)
    assert e.value.error_class == errors.ERR_REQUEST


def test_parrived_records_pvar():
    s = pvar.session()
    eng = ie.IngestEngine(streams=1, chunk_bytes=1 << 20)
    try:
        req = eng.upload(np.arange(8, dtype=np.float32)).wait()
        req.Parrived(0)
        assert s.read("ingest_parrived") >= 1
    finally:
        eng.close()


# -- compile overlap -----------------------------------------------------------------

def test_overlap_compile_runs_during_upload():
    s = pvar.session()
    release = threading.Event()

    def put(view, dst, h2d=None):
        release.wait(10)
        return ie.default_put(view, dst, h2d)

    eng = ie.IngestEngine(streams=2, chunk_bytes=1024, put=put)
    try:
        req = eng.upload(np.arange(4096, dtype=np.float32))
        done = {}

        def compile_fn():
            time.sleep(0.03)
            done["thread"] = threading.current_thread().name
            return 42

        job = eng.overlap_compile(compile_fn)
        assert job.wait(10) == 42
        assert done["thread"] != threading.current_thread().name
        assert not req.test()
        assert s.read("ingest_compile_overlaps") == 1
        release.set()
        req.wait(10)
    finally:
        release.set()
        eng.close()


def test_upload_and_compile_pipeline():
    eng = ie.IngestEngine(streams=2, chunk_bytes=4096)
    try:
        tree = {"p": np.arange(10000, dtype=np.float32)}
        req, job = eng.upload_and_compile(tree, lambda: "compiled")
        assert job.wait(10) == "compiled"
        assert req.tree()["p"].numpy().tobytes() == tree["p"].tobytes()
    finally:
        eng.close()


# -- device-to-host staging (the reference's chunked D2H cases) -------------------

def test_chunked_d2h_bit_identical():
    """The port's D2H of a tensor is one copy into one staging buffer
    (``io.host_array`` over the accelerator's ``copy_async``): bitwise at
    the reference case's shapes."""
    from ompi_tpu_torch import io as P_io

    rng = np.random.default_rng(3)
    for shape in [(4096,), (64, 33), (7, 11, 13)]:
        host = rng.standard_normal(shape).astype(np.float32)
        out = P_io.host_array(torch.from_numpy(host.copy()))
        assert out.shape == host.shape and out.dtype == host.dtype
        assert out.tobytes() == host.tobytes()


def test_chunked_d2h_chunk_count_bounded(monkeypatch):
    """The port's chunked device-to-host pipeline is pml/accel_p2p's:
    its chunks tile the message exactly, whole elements each, and their
    count is the ceiling of the size over ``pml_accel_chunk_bytes``."""
    from ompi_tpu_torch.pml import accel_p2p

    for nbytes in [64 << 20, 128 << 20, 1 << 30]:
        step = accel_p2p._chunk_bytes(4)
        spans = accel_p2p._spans(nbytes, step)
        assert spans[0][0] == 0 and spans[-1][1] == nbytes
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all((b - a) % 4 == 0 for a, b in spans)
        assert len(spans) == -(-nbytes // step)


# -- the plane's lifecycle ---------------------------------------------------------------

def test_requested_env_and_cvar(monkeypatch):
    monkeypatch.delenv("OMPI_TPU_INGEST", raising=False)
    monkeypatch.delenv("OMPI_TPU_INGEST_ENABLE", raising=False)
    assert ie.requested() is False
    monkeypatch.setenv("OMPI_TPU_INGEST", "1")
    assert ie.requested() is True
    monkeypatch.setenv("OMPI_TPU_INGEST", "off")
    assert ie.requested() is False


def test_enable_disable_idempotent():
    try:
        eng = ie.enable(rank=3)
        assert ie.INGEST is eng and eng.rank == 3
        assert ie.enable() is eng
        assert ie.enable(rank=5) is eng and eng.rank == 5
    finally:
        assert ie.disable() is eng
    assert ie.INGEST is None
    assert ie.disable() is None


_BRINGUP = '''
import json, os
import numpy as np
from {pkg} import mpi
from {pkg}.ingest import engine as ingest_engine
comm = mpi.Init()
rank = comm.rank
doc = {{"up": ingest_engine.INGEST is not None,
        "rank": ingest_engine.INGEST.rank}}
r = ingest_engine.INGEST.upload(
    {{"w": np.arange(1000, dtype=np.float32) + rank}})
doc["w"] = np.asarray(r.tree()["w"]).tobytes().hex()
with open(os.path.join({out!r}, f"r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''


def test_two_rank_bringup_via_mca(tmp_path):
    """init_instance brings the plane up from the cvar (rank identity
    held) and its uploads match the reference's, bitwise."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    run_ranks(_BRINGUP.format(pkg="ompi_tpu", out=str(ref)), 2,
              mca={"ingest_enable": "1"})
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(_BRINGUP.format(pkg="ompi_tpu_torch",
                                                 out=str(port)))
                 + "mpi.Finalize()\n")
        path = fh.name
    try:
        assert port_launcher.launch(
            [sys.executable, path], 2,
            mca={"device_plane_platform": "cpu", "ingest_enable": "1"},
            timeout=120) == 0
    finally:
        os.unlink(path)
    for r in range(2):
        dp = json.loads((port / f"r{r}.json").read_text())
        dr = json.loads((ref / f"r{r}.json").read_text())
        assert dp == dr and dp["up"] and dp["rank"] == r


# -- the card example on the CPU platform ------------------------------------------

def _launch(example, out, *args, mca=()):
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
           "4", "--timeout", "150", "--mca", "device_plane", "on",
           "--mca", "coll_cuda", "on", "--mca", "device_plane_platform",
           "cpu", "--mca", "coll_device_bucket_bytes", "20000", *mca,
           os.path.join("ompi_tpu_torch", "examples", example), "--tiny",
           "--out", out, *args]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=200)


def test_streaming_ingest_example_restores_to_the_full_digest(tmp_path):
    """ckpt_training.py's full run and crash run at --tiny, then
    streaming_ingest.py restores the crash run's epoch 2 through the
    ingest plane (4 streams x depth 2, 16 KiB units): every leaf on the
    rank's device, ``ingest_bytes`` the plan's, the K2 / K3 launches of
    the steps as derived, and the full run's digest, bitwise."""
    out = str(tmp_path)
    for phase in ("full", "crash"):
        p = _launch("ckpt_training.py", os.path.join(out, phase),
                    "--phase", phase)
        assert (p.returncode == 0) == (phase == "full"), p.stderr[-3000:]
    full = json.load(open(os.path.join(out, "full", "rank0.json")))
    p = _launch("streaming_ingest.py", os.path.join(out, "si"), "--ckpt",
                os.path.join(out, "crash", "ckpt"), "--expect-digest",
                full["report"]["digest"],
                mca=("--mca", "ingest_enable", "1", "--mca",
                     "ingest_chunk_bytes", "16384"))
    assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-3000:])
    for r in range(4):
        d = json.load(open(os.path.join(out, "si", f"rank{r}.json")))
        assert all(c["ok"] for c in d["cases"]), d["cases"]
        assert d["launches"] == d["expected_launches"]
        rep = d["report"]
        assert rep["digest"] == full["report"]["digest"]
        assert rep["resumed_from"] == 2 and rep["upload_units"] > 8
        assert 1 <= rep["inflight_hwm"] <= rep["depth"]
