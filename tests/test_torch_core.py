"""The port's core layer against the JAX package's: the counterparts of
``tests/test_core.py``'s 11 cases that no other port test holds (cvars,
progress, pvars, the kvstore, the launcher; its two registry cases are in
``tests/test_torch_mpit.py``), ``tests/test_native.py``'s 4 (the sm ring's
wraparound, full / cap, torture, and the span gather, which the port's
datatype engine does in numpy) and ``tests/test_memhooks_topology.py``'s
two memhooks cases (its topology half is in
``tests/test_torch_topology.py``, beside the launcher's ``--bind-to``).

Every case runs the same steps on both packages in this process and holds
their answers equal. ``reference_state`` (from ``tests/test_torch_mpit``)
puts both packages' cvars, pvars and release hooks back after each.
"""

import ctypes
import gc
import hashlib
import mmap
import sys
import threading

import numpy as np
import pytest
import torch

from ompi_tpu.core import cvar as R_cvar, native as R_native
from ompi_tpu.core import memhooks as R_memhooks, mpool as R_mpool
from ompi_tpu.core import progress as R_progress, pvar as R_pvar
from ompi_tpu.runtime import kvstore as R_kvstore, launcher as R_launcher
from ompi_tpu_torch.core import cvar as P_cvar, native as P_native
from ompi_tpu_torch.core import memhooks as P_memhooks, mpool as P_mpool
from ompi_tpu_torch.core import progress as P_progress, pvar as P_pvar
from ompi_tpu_torch.datatype import convertor as P_cv
from ompi_tpu_torch.runtime import kvstore as P_kvstore
from ompi_tpu_torch.runtime import launcher as P_launcher
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

CVARS = (P_cvar, R_cvar)


# ---------------------------------------------------------------------------
# cvars (tests/test_core.py)


def test_cvar_default_and_set():
    got = []
    for cvar in CVARS:
        v = cvar.register("t_torch_alpha_limit", 4096, int, help="test var")
        before = v.get()
        cvar.set("t_torch_alpha_limit", 65536)
        got.append((before, cvar.get("t_torch_alpha_limit")))
    assert got[0] == got[1] == (4096, 65536)


@pytest.mark.parametrize("case", ["env_override", "bool_parse"])
def test_cvar_env(case, monkeypatch):
    """test_cvar_env_override and test_cvar_bool_parse: the environment
    layer (``OMPI_TPU_<NAME>``) over the default, coerced to the type."""
    name, default, typ, env, want = {
        "env_override": ("t_torch_beta_limit", 7, int, "123", 123),
        "bool_parse": ("t_torch_flag", False, bool, "yes", True)}[case]
    monkeypatch.setenv("OMPI_TPU_" + name.upper(), env)
    got = [cvar.register(name, default, typ).get() for cvar in CVARS]
    assert got == [want, want] and type(got[0]) is type(got[1])


def test_cvar_choices():
    for cvar in CVARS:
        v = cvar.register("t_torch_mode", "fast", str,
                          choices=["fast", "safe"])
        with pytest.raises(ValueError):
            v.set("bogus")
        assert v.get() == "fast"


# ---------------------------------------------------------------------------
# progress and pvars


def test_progress_callbacks():
    for progress in (P_progress, R_progress):
        hits = []

        def cb():
            hits.append(1)
            return 1
        progress.register(cb)
        try:
            assert progress.progress() >= 1 and hits
        finally:
            progress.unregister(cb)
        n = len(hits)
        progress.progress()
        assert len(hits) == n  # unregistered


def test_progress_wait_until():
    for progress in (P_progress, R_progress):
        state = {"n": 0}

        def cb():
            state["n"] += 1
            return 0
        progress.register(cb)
        try:
            assert progress.wait_until(lambda: state["n"] >= 5, timeout=5)
        finally:
            progress.unregister(cb)


def test_pvar_counters():
    got = []
    for pvar in (P_pvar, R_pvar):
        pvar.record("t_torch_send", 3)
        pvar.record("t_torch_send")
        row = [pvar.read("t_torch_send")]
        sess = pvar.session()
        pvar.record("t_torch_send", 10)
        row.append(sess.read("t_torch_send"))
        pvar.record_hwm("t_torch_depth", 5)
        pvar.record_hwm("t_torch_depth", 3)
        row.append(pvar.read("t_torch_depth"))
        row.append(pvar.snapshot()["t_torch_depth_hwm"])
        got.append(row)
    assert got[0] == got[1] == [4, 10, 5, 5]


# ---------------------------------------------------------------------------
# the kvstore and the launcher


def test_kvstore_roundtrip():
    got = []
    for kv in (P_kvstore, R_kvstore):
        store = kv.Store().start()
        try:
            c = kv.Client(store.addr)
            c.put("k", {"x": 1})
            got.append([c.get("k"), c.get("missing", wait=False),
                        c.inc("ctr"), c.inc("ctr", 5)])
            c.close()
        finally:
            store.stop()
    assert got[0] == got[1] == [{"x": 1}, None, 1, 6]


def test_kvstore_fence_blocks_until_all():
    for kv in (P_kvstore, R_kvstore):
        store = kv.Store().start()
        try:
            done = []

            def worker(i):
                c = kv.Client(store.addr)
                c.fence("f1", 3, i)
                done.append(i)
                c.close()
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
            assert sorted(done) == [0, 1, 2]
        finally:
            store.stop()


_RTE_SCRIPT = """
from {pkg}.runtime import rte
rte.init()
rte.modex_send('t', rte.rank * 10)
vals = sorted(rte.modex_recv('t', p) for p in range(rte.size))
assert vals == [0, 10, 20], vals
rte.fence()
"""


@pytest.mark.parametrize("what", ["runs_ranks", "propagates_failure"])
def test_launcher(what, tmp_path):
    """test_launcher_runs_ranks (3 ranks through the modex and a fence,
    exit 0) and test_launcher_propagates_failure (a rank's exit 3 is the
    job's): each launcher gives the reference's exit code."""
    rcs = []
    for pkg, launcher in (("ompi_tpu_torch", P_launcher),
                          ("ompi_tpu", R_launcher)):
        script = tmp_path / f"job_{pkg}.py"
        script.write_text(_RTE_SCRIPT.format(pkg=pkg)
                          if what == "runs_ranks" else
                          "import sys; sys.exit(3)\n")
        rcs.append(launcher.launch([sys.executable, str(script)],
                                   3 if what == "runs_ranks" else 2,
                                   timeout=60))
    assert rcs == ([0, 0] if what == "runs_ranks" else [3, 3])


# ---------------------------------------------------------------------------
# the sm ring's C code (tests/test_native.py)


@pytest.fixture(scope="module")
def libs():
    """(the port's ring library, the reference's native core)."""
    P, R = P_native.lib(), R_native.lib()
    assert P is not None and R is not None, "no C compiler"
    return P, R


def _ring(size):
    buf = mmap.mmap(-1, 16 + size)
    return buf, ctypes.addressof(ctypes.c_char.from_buffer(buf))


def _push(L, which, addr, size, frame):
    fn = L.otr_ring_push if which == "port" else L.otpu_ring_push
    return fn(addr, size, frame, len(frame))


def _pop(L, which, addr, size, out, cap):
    fn = L.otr_ring_pop if which == "port" else L.otpu_ring_pop
    return fn(addr, size, out, cap)


def test_ring_wraparound_exact(libs):
    """Many wraps with frames that do not divide the ring: the same pops
    from both rings."""
    got = []
    for which, L in zip(("port", "ref"), libs):
        size = 64
        buf, addr = _ring(size)
        out = ctypes.create_string_buffer(size)
        popped = []
        for i in range(200):
            frame = bytes([i % 251]) * (7 + i % 11)
            assert _push(L, which, addr, size, frame) == 1
            n = _pop(L, which, addr, size, out, size)
            assert n == len(frame) and out.raw[:n] == frame, i
            popped.append(out.raw[:n])
        got.append(popped)
        del out, addr
        buf.close()
    assert got[0] == got[1]


def test_ring_full_and_cap(libs):
    got = []
    for which, L in zip(("port", "ref"), libs):
        size = 32
        buf, addr = _ring(size)
        small = ctypes.create_string_buffer(4)
        out = ctypes.create_string_buffer(32)
        got.append([_push(L, which, addr, size, b"x" * 20),
                    _push(L, which, addr, size, b"y" * 10),  # 24 used
                    _pop(L, which, addr, size, small, 4),  # cap too small
                    _pop(L, which, addr, size, out, 32),
                    _pop(L, which, addr, size, out, 32)])  # empty
        del small, out, addr
        buf.close()
    assert got[0] == got[1] == [1, 0, -2, 20, -1]


def test_ring_torture_producer_consumer(libs):
    """One writer thread and one reader thread per ring (the GIL released
    inside the C calls), seeded frame sizes and contents, checksummed end
    to end: both rings deliver the same digest."""
    digests = []
    for which, L in zip(("port", "ref"), libs):
        size = 1 << 14
        buf, addr = _ring(size)
        rng = np.random.RandomState(7)
        n_frames = 5000
        sizes = rng.randint(1, 400, size=n_frames)
        frames = [rng.bytes(int(s)) for s in sizes]
        send, recv = hashlib.sha256(), hashlib.sha256()
        errs = []

        def producer():
            for f in frames:
                send.update(f)
                while _push(L, which, addr, size, f) == 0:
                    pass

        def consumer():
            out = ctypes.create_string_buffer(512)
            got = 0
            while got < n_frames:
                n = _pop(L, which, addr, size, out, 512)
                if n == -1:
                    continue
                if n != sizes[got]:
                    errs.append(f"frame {got}: {n} != {sizes[got]}")
                    return
                recv.update(out.raw[:n])
                got += 1
        t1 = threading.Thread(target=producer)
        t2 = threading.Thread(target=consumer)
        t1.start()
        t2.start()
        t1.join(timeout=60)
        t2.join(timeout=60)
        assert not t1.is_alive() and not t2.is_alive() and not errs, errs
        assert send.hexdigest() == recv.hexdigest()
        digests.append(recv.hexdigest())
        del addr
        buf.close()
    assert digests[0] == digests[1]


def test_span_gather_scatter_matches_reference(libs):
    """Random non-overlapping spans: the port's span movement (the datatype
    engine's numpy gather / scatter over a span table, whole and by range)
    against the reference's native ``otpu_gather_spans`` /
    ``otpu_scatter_spans``."""
    R = libs[1]
    rng = np.random.RandomState(3)
    src = rng.randint(0, 256, size=4096).astype(np.uint8)
    spans, prev_end = [], 0
    for o in np.sort(rng.choice(4000, size=40, replace=False)):
        if o < prev_end:
            continue
        ln = min(int(rng.randint(1, 50)), 4096 - o)
        spans.append((o, ln))
        prev_end = o + ln
    spans_arr = np.array(spans, dtype=np.int64)
    total = int(spans_arr[:, 1].sum())
    cum = np.concatenate([[0], np.cumsum(spans_arr[:, 1])])
    ref = np.zeros(total, dtype=np.uint8)
    assert R.otpu_gather_spans(src.ctypes.data, spans_arr.ctypes.data,
                               len(spans), ref.ctypes.data) == total
    assert np.array_equal(P_cv._gather_range(src, spans_arr, cum, 0, total),
                          ref)
    for lo, hi in ((0, total // 3), (total // 3, total - 5), (7, 8)):
        assert np.array_equal(
            P_cv._gather_range(src, spans_arr, cum, lo, hi), ref[lo:hi])
    back_ref = np.zeros_like(src)
    assert R.otpu_scatter_spans(ref.ctypes.data, spans_arr.ctypes.data,
                                len(spans), back_ref.ctypes.data) == total
    back = np.zeros_like(src)
    P_cv._scatter_range(back, ref, spans_arr, cum, 0, total)
    assert np.array_equal(back, back_ref)


# ---------------------------------------------------------------------------
# the memory release plane (tests/test_memhooks_topology.py)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_release_hooks_fire_on_object_death(kind):
    """A tracked buffer's death fires every release hook with its id (a
    numpy array in both packages; a torch.Tensor, keyed on its identity,
    in the port); tracking is idempotent; the explicit release notice
    fires too; the pvar counts the notices."""
    pkgs = ((P_memhooks, P_pvar),) if kind == "tensor" \
        else ((P_memhooks, P_pvar), (R_memhooks, R_pvar))
    for memhooks, pvar in pkgs:
        fired = []
        memhooks.register_release(fired.append)
        n0 = pvar.read("mem_hooks_released")
        try:
            buf = torch.zeros(64) if kind == "tensor" else np.zeros(64)
            key = id(buf)
            assert memhooks.track(buf) and memhooks.track(buf)
            del buf
            gc.collect()
            assert fired == [key]
            memhooks.release(12345)
            assert fired == [key, 12345]
            assert pvar.read("mem_hooks_released") - n0 == 2
        finally:
            memhooks.unregister_release(fired.append)
        assert fired.append not in memhooks._hooks


def test_rcache_invalidates_through_release_plane():
    """The reference case on both packages, then on tensors in the port:
    a cache's entry goes at its buffer's death; one death hook serves two
    caches; an object with no weak reference gets no key; a tensor whose
    memory the caching allocator hands to the next tensor (same
    ``data_ptr``) never aliases a dead entry."""
    for mpool in (P_mpool, R_mpool):
        cache = mpool.Rcache()
        buf = np.arange(16)
        key = mpool.buffer_key(buf, cache)
        assert key == id(buf)
        cache.insert(key, "derived", 128)
        assert cache.lookup(key) == "derived"
        del buf
        gc.collect()
        assert cache.lookup(key) is None
        c2 = mpool.Rcache()
        b2 = np.arange(4)
        k2 = mpool.buffer_key(b2, c2)
        c2.insert(k2, "x", 8)
        cache.insert(k2, "y", 8)
        del b2
        gc.collect()
        assert c2.lookup(k2) is None and cache.lookup(k2) is None
        assert mpool.buffer_key(42, cache) is None
    cache = P_mpool.Rcache()
    t = torch.arange(1024.0)
    ptr, key = t.data_ptr(), P_mpool.buffer_key(t, cache)
    cache.insert(key, "span table", 64)
    del t
    gc.collect()
    assert cache.lookup(key) is None
    t2 = torch.arange(1024.0)  # may reuse the freed block (data_ptr)
    k2 = P_mpool.buffer_key(t2, cache)
    assert k2 == id(t2) and cache.lookup(k2) is None
    assert ptr  # keys never come from data_ptr()
    n = P_memhooks.nhooks()
    del cache
    gc.collect()
    t3 = torch.zeros(1)
    P_memhooks.track(t3)
    del t3
    gc.collect()  # the dead cache's weak subscription is pruned
    assert P_memhooks.nhooks() < n
