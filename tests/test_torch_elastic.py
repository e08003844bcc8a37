"""The port's elastic plane (``elastic/``: the re-shard arithmetic, the
fault injection, ``ElasticContext`` with its buddy ring, recovery,
checkpoint fallback and hot join) against the JAX package's: the
counterparts of ``tests/test_elastic.py``'s cases.

In this process: the re-shard arithmetic (the port's flats and packed
shards equal the reference's, bitwise), the injection, checkpoint
hardening, the store client's bounded connect retry and the chaos
client, and the pvars. Launcher jobs under ``--mca ft 1`` on the CPU
platform, each kill a job of its own: the kill -> shrink -> in-memory
re-shard case, once per package on the same seeded parameters and
``grad_fn`` ('linear'), whose final parameters and momentum shards must
equal the port's ``from_checkpoint`` replay and the reference's run,
bitwise; the adjacent double failure (the checkpoint fallback); the hot
join (a ``spawn_replacement`` joiner at parameter parity before its first
step); the 2-rank cases without a kill in one job; and the card example
``ompi_tpu_torch/examples/elastic_training.py --tiny`` (a device
Allreduce on the CPU arenas over the comms of 4, 3 and 4 ranks, bitwise,
the broken comm freed, the async checkpoint replay, the joiner through
the ingest plane).

Waiting for ROADMAP queue 1 item 10 (the telemetry watchdog):
``test_watchdog_reports_recovery_instead_of_hang``.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ompi_tpu_torch import errors
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT = {"ft": "1"}


def _tree():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((13, 5)).astype(np.float32),
            "b": rng.standard_normal(11).astype(np.float32),
            "i": np.arange(9, dtype=np.int32)}


def _port(src: str, n: int, mca=None, timeout=120) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch(
            [sys.executable, path], n,
            mca={"device_plane_platform": "cpu", **(mca or {})},
            timeout=timeout)
    finally:
        os.unlink(path)


# -- the re-shard arithmetic (no comm) ----------------------------------------

def test_reshard_roundtrip_is_pure_layout_arithmetic():
    """n changes only the pad tail: full_flats of the old chunks gives the
    bucket flats, and pack onto another n equals slicing the replicated
    tree; the port's flats and packed shards equal the reference's."""
    import jax

    from ompi_tpu.elastic import reshard as R_reshard
    from ompi_tpu.zero import layout as R_zl
    from ompi_tpu_torch.elastic import reshard
    from ompi_tpu_torch.zero import layout as zl

    tree = _tree()
    leaves = zl.tree_leaves(tree)
    p3, p2 = zl.plan_for(leaves, 3), zl.plan_for(leaves, 2)
    assert p3.buckets == p2.buckets and p3.elems == p2.elems
    olds = [zl.ShardedState.from_full(SimpleNamespace(rank=r, size=3), tree)
            for r in range(3)]
    chunks = {r: reshard.host_chunks(olds[r]) for r in range(3)}
    flats = reshard.full_flats(chunks, p3.elems)
    r_olds = [R_zl.ShardedState.from_full(SimpleNamespace(rank=r, size=3),
                                          tree) for r in range(3)]
    r_flats = R_reshard.full_flats(
        {r: R_reshard.host_chunks(r_olds[r]) for r in range(3)},
        R_zl.plan_for(jax.tree.leaves(tree), 3).elems)
    assert [f.tobytes() for f in flats] == [f.tobytes() for f in r_flats]
    for b, idxs in enumerate(p3.buckets):
        ref = np.concatenate([np.reshape(leaves[i], (-1,)) for i in idxs])
        assert flats[b].tobytes() == ref.tobytes()
    r_p2 = R_zl.plan_for(jax.tree.leaves(tree), 2)
    for r in range(2):
        tmpl = zl.ShardedState.from_full(SimpleNamespace(rank=r, size=2),
                                         tree)
        packed = reshard.pack(p2, tmpl, flats, r)
        assert packed.rank == r and packed.n == 2
        for a, b in zip(packed.shards, tmpl.shards):
            assert a.tobytes() == np.asarray(b).tobytes()
        r_tmpl = R_zl.ShardedState.from_full(
            SimpleNamespace(rank=r, size=2), tree)
        r_packed = R_reshard.pack(r_p2, r_tmpl, r_flats, r)
        assert [a.tobytes() for a in packed.shards] \
            == [np.asarray(a).tobytes() for a in r_packed.shards]


def test_reshard_rejects_incomplete_or_mismatched_chunks():
    from ompi_tpu_torch.elastic import reshard
    from ompi_tpu_torch.zero import layout as zl

    tree = _tree()
    leaves = zl.tree_leaves(tree)
    p3 = zl.plan_for(leaves, 3)
    olds = [zl.ShardedState.from_full(SimpleNamespace(rank=r, size=3), tree)
            for r in range(3)]
    chunks = {r: reshard.host_chunks(olds[r]) for r in range(3)}
    with pytest.raises(errors.MPIError) as ei:
        reshard.full_flats({}, p3.elems)
    assert ei.value.error_class == errors.ERR_INTERN
    with pytest.raises(errors.MPIError) as ei:
        reshard.full_flats({0: chunks[0], 2: chunks[2]}, p3.elems)
    assert "ranks [1]" in str(ei.value)
    flats = reshard.full_flats(chunks, p3.elems)
    tmpl = zl.ShardedState.from_full(SimpleNamespace(rank=0, size=2), tree)
    p2 = zl.plan_for(leaves, 2)
    with pytest.raises(errors.MPIError):
        reshard.pack(p2, tmpl, flats[:-1], 0)
    with pytest.raises(errors.MPIError):
        reshard.pack(p2, tmpl, [f[:-1] for f in flats], 0)


def test_elastic_context_refuses_stage3():
    """tests/test_zero3.py's case: ElasticContext(stage=3) raises a named
    MPIError(ERR_NOT_SUPPORTED) at construction (a shrink re-shards only
    the gradient and momentum state), in both packages, before touching
    the comm."""
    from ompi_tpu import errors as R_errors
    from ompi_tpu.elastic import ElasticContext as R_Ctx
    from ompi_tpu_torch.elastic import ElasticContext

    for ctx_cls, errs in ((ElasticContext, errors), (R_Ctx, R_errors)):
        with pytest.raises(errs.MPIError) as ei:
            ctx_cls(None, {"w": np.ones((4,), np.float32)}, stage=3)
        assert ei.value.error_class == errs.ERR_NOT_SUPPORTED
        assert "zero3" in str(ei.value)


def test_inject_armed_is_rank_and_step_exact():
    from ompi_tpu_torch.elastic import inject
    from ompi_tpu_torch.runtime import rte

    ks, kr = inject._kill_step_var.get(), inject._kill_rank_var.get()
    try:
        inject._kill_step_var.set(4)
        inject._kill_rank_var.set(rte.rank)
        assert inject.armed(4)
        assert not inject.armed(3) and not inject.armed(5)
        inject._kill_rank_var.set(rte.rank + 1)
        assert not inject.armed(4)
        inject._kill_step_var.set(-1)
        assert not inject.armed(0)
    finally:
        inject._kill_step_var.set(ks)
        inject._kill_rank_var.set(kr)


# -- kill -> shrink -> in-memory re-shard --------------------------------------

_KILL = '''
import os, tempfile
from {pkg} import elastic
from {pkg}.core import pvar
from {pkg}.elastic import inject
from {pkg}.runtime import rte

d = os.path.join({out!r}, "ck")
params = {{"w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0,
          "b": np.linspace(-1.0, 1.0, 5).astype(np.float32)}}


def grad_fn(p, step, c):
    return {{k: 0.01 * a + np.full_like(a, 0.125 * (step + 1))
            for k, a in p.items()}}


inject._kill_step_var.set(3)
inject._kill_rank_var.set(2)
ctx = elastic.ElasticContext(comm, params, lr=0.125, momentum=0.5,
                             checkpoint_dir=d)
ctx.run(grad_fn, 3)
ctx.save_checkpoint()
out = ctx.run(grad_fn, 6)
snap = pvar.snapshot()
doc = {{"size": ctx.comm.size, "shrinks": ctx.shrinks,
       "step_done": ctx.step_done, "resume": ctx.last_resume,
       "origin": ctx.restored_from,
       "pvars": [snap.get(k, 0) > 0 for k in
                 ("elastic_shrinks", "elastic_recovery_ns",
                  "elastic_reshard_bytes")],
       "kills": snap.get("elastic_injected_kills", 0),
       "params": {{k: np.asarray(v).tobytes().hex() for k, v in out.items()}},
       "momentum": [np.asarray(s).tobytes().hex() for s in
                    ctx.opt.state.slots["momentum"].shards]}}
if {port}:
    ref = elastic.ElasticContext.from_checkpoint(ctx.comm, d, lr=0.125,
                                                 momentum=0.5)
    doc["ref_step"] = [ref.step_done, ref.restored_from]
    ref_out = ref.run(grad_fn, 6)
    doc["ref_params"] = {{k: np.asarray(v).tobytes().hex()
                         for k, v in ref_out.items()}}
    doc["ref_momentum"] = [np.asarray(s).tobytes().hex() for s in
                           ref.opt.state.slots["momentum"].shards]
with open(os.path.join({out!r}, f"r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''


def test_kill_shrink_memory_reshard_bitmatches_checkpoint_restore(tmp_path):
    """Rank 2 SIGKILLs at step 3; the survivors recover in memory (resume
    step 2 by agree, the dead rank's chunk from its buddy) and finish.
    The port's from_checkpoint replay from the step-2 checkpoint and the
    reference's run of the same program give the same parameters and
    momentum shards, bitwise."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    assert _port("import json\nimport numpy as np\nfrom ompi_tpu_torch "
                 "import mpi\ncomm = mpi.Init()\nrank = comm.rank\n"
                 + _KILL.format(pkg="ompi_tpu_torch", out=str(port),
                                port=True)
                 + "mpi.Finalize()\n", 3, mca=FT) == 0
    run_ranks("import json\n" + _KILL.format(pkg="ompi_tpu", out=str(ref),
                                             port=False), 3, mca=FT,
              timeout=90)
    for r in (0, 1):
        dp = json.loads((port / f"r{r}.json").read_text())
        dr = json.loads((ref / f"r{r}.json").read_text())
        assert (dp["size"], dp["shrinks"], dp["step_done"], dp["resume"],
                dp["origin"]) == (2, 1, 5, 2, "memory")
        assert dp["pvars"] == [True] * 3 and dp["kills"] == 0
        assert dp["ref_step"] == [2, "checkpoint"]
        assert dp["params"] == dp["ref_params"]
        assert dp["momentum"] == dp["ref_momentum"]
        for k in ("size", "shrinks", "step_done", "resume", "origin",
                  "params", "momentum"):
            assert dp[k] == dr[k], k


def test_adjacent_double_failure_falls_back_to_checkpoint(tmp_path):
    """Ranks 1 and 2 die in the same step: rank 1's chunk has no live
    owner, so recovery restores the last sharded checkpoint
    (checkpoint_every=1 keeps it at the resume step) and the lone
    survivor finishes."""
    assert _port(f'''
        import json, os, signal
        import numpy as np
        from ompi_tpu_torch import elastic, mpi
        from ompi_tpu_torch.core import pvar
        comm = mpi.Init()
        rank = comm.rank
        d = os.path.join({str(tmp_path)!r}, "ck")
        params = {{"w": np.arange(10, dtype=np.float32) / 3.0}}

        def grad_fn(p, step, c):
            if step == 2 and rank in (1, 2):
                os.kill(os.getpid(), signal.SIGKILL)
            return {{k: np.full_like(a, 0.25 * (step + 1))
                    for k, a in p.items()}}

        ctx = elastic.ElasticContext(comm, params, lr=0.1, momentum=0.9,
                                     checkpoint_dir=d, checkpoint_every=1)
        ctx.run(grad_fn, 4)
        doc = [ctx.comm.size, ctx.shrinks >= 1, ctx.step_done,
               ctx.restored_from,
               pvar.snapshot().get("elastic_fallback_restores", 0) >= 1]
        with open(os.path.join({str(tmp_path)!r}, "r0.json"), "w") as fh:
            json.dump(doc, fh)
        mpi.Finalize()
    ''', 3, mca=FT) == 0
    assert json.loads((tmp_path / "r0.json").read_text()) \
        == [1, True, 3, "checkpoint", True]


def test_hot_join_regrows_with_parameter_parity(tmp_path):
    """Rank 0 spawns a replacement; the 2-rank job regrows to 3 at the
    step-3 boundary. Every member holds the same parameters before the
    joiner's first step and at the end."""
    assert _port(f'''
        import hashlib, json, os
        import numpy as np
        from ompi_tpu_torch import elastic, mpi
        from ompi_tpu_torch.core import pvar
        from ompi_tpu_torch.runtime import rte
        from ompi_tpu_torch.zero import layout as zl
        comm = mpi.Init()

        def digest(tree):
            h = hashlib.sha256()
            for leaf in zl.tree_leaves(tree):
                h.update(np.ascontiguousarray(leaf).tobytes())
            return h.hexdigest()

        params = {{"w": np.arange(10, dtype=np.float32) / 3.0,
                  "b": np.ones(7, dtype=np.float32)}}
        seen = []

        def grad_fn(p, step, c):
            if step == 3:
                seen.append([c.size, len(set(c.allgather(digest(p))))])
            return {{k: np.full_like(a, 0.25 * (step + 1))
                    for k, a in p.items()}}

        proc = None
        if elastic.is_joiner():
            ctx, target = elastic.hot_join()
            doc = {{"joins": ctx.joins, "target": target}}
            out = ctx.run(grad_fn, target)
        else:
            ctx = elastic.ElasticContext(comm, params, lr=0.1,
                                         momentum=0.75)
            if comm.rank == 0:
                proc = elastic.spawn_replacement(mca={{"ft": "1"}})
            out = ctx.run(grad_fn, 6, join_at=3)
            doc = {{"joins": ctx.joins,
                   "pvar": pvar.snapshot().get("elastic_hot_joins", 0)}}
        doc.update(size=ctx.comm.size, seen=seen, step_done=ctx.step_done,
                   digests=len(set(ctx.comm.allgather(digest(out)))))
        if proc is not None:
            doc["joiner_rc"] = proc.wait(timeout=60)
        with open(os.path.join({str(tmp_path)!r}, f"w{{rte.rank}}.json"),
                  "w") as fh:
            json.dump(doc, fh)
        mpi.Finalize()
    ''', 2, mca=FT) == 0
    docs = {int(p.stem[1:]): json.loads(p.read_text())
            for p in tmp_path.glob("w*.json")}
    assert sorted(docs) == [0, 1, 2]  # the joiner's world rank is 2
    for w, d in docs.items():
        assert d["size"] == 3 and d["seen"] == [[3, 1]], d
        assert d["step_done"] == 5 and d["digests"] == 1 and d["joins"] == 1
    assert docs[2]["target"] == 6
    assert docs[0]["pvar"] == 1 and docs[0]["joiner_rc"] == 0


# -- the 2-rank cases without a kill: one job -----------------------------

@pytest.fixture(scope="module")
def two(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic_two")
    assert _port(f'''
        import json, os
        import numpy as np
        from types import SimpleNamespace
        from ompi_tpu_torch import errors, ft, mpi
        from ompi_tpu_torch.io import checkpoint
        comm = mpi.Init()
        rank = comm.rank
        doc = {{}}

        # -- test_comm_free_releases_ft_epochs
        c = comm.dup()
        c.agree(1)
        doc["agree_epoch"] = c.cid in ft._agree_epochs
        ft._shrink_epochs[c.cid] = 1
        cid = c.cid
        c.free()
        doc["released"] = [cid not in ft._agree_epochs,
                           cid not in ft._shrink_epochs]

        # -- test_sharded_restore_guards_rank_count_mismatch
        path = os.path.join({str(out)!r}, "s.ck")
        tree = {{"m:0": np.arange(6, dtype=np.float32) + rank}}
        checkpoint.save_sharded(path, tree, comm, step=4)
        t2, s2 = checkpoint.restore(path, comm=comm)
        doc["own"] = [s2, t2["m:0"].tobytes() == tree["m:0"].tobytes()]
        fake = SimpleNamespace(rank=0, size=3)
        try:
            checkpoint.restore(path, comm=fake)
            doc["guard"] = None
        except errors.MPIError as exc:
            doc["guard"] = [exc.error_class, "reshard=True" in str(exc)]
        t3, _ = checkpoint.restore(path, comm=fake, reshard=True)
        g, _ = checkpoint.restore(path)
        doc["global"] = [int(g["m:0"].size), t3["m:0"].tobytes()
                         == np.array_split(g["m:0"], 3)[0].tobytes()]
        comm.Barrier()
        with open(os.path.join({str(out)!r}, f"r{{rank}}.json"), "w") as fh:
            json.dump(doc, fh)
        mpi.Finalize()
    ''', 2, mca=FT) == 0
    return [json.loads((out / f"r{r}.json").read_text()) for r in (0, 1)]


def test_comm_free_releases_ft_epochs(two):
    for d in two:
        assert d["agree_epoch"] and d["released"] == [True, True]


def test_sharded_restore_guards_rank_count_mismatch(two):
    """A sharded file restored into a comm of another size raises
    ERR_FILE unless reshard=True asks for the re-split; comm=None (the
    global view) is never guarded."""
    for d in two:
        assert d["own"] == [4, True]
        assert d["guard"] == [errors.ERR_FILE, True]
        assert d["global"] == [12, True]


# -- checkpoint hardening and the store client ------------------------------

def test_restore_rejects_malformed_files(tmp_path):
    import struct

    from ompi_tpu_torch.io import checkpoint

    bad = tmp_path / "bad.ck"
    bad.write_bytes(b"not a checkpoint at all" * 4)
    with pytest.raises(errors.MPIError) as ei:
        checkpoint.restore(str(bad))
    assert ei.value.error_class == errors.ERR_FILE
    good = tmp_path / "good.ck"
    checkpoint.save(str(good), {"w": np.arange(64, dtype=np.float32)},
                    step=7)
    blob = good.read_bytes()
    torn = tmp_path / "torn.ck"
    torn.write_bytes(blob[:len(blob) // 2])
    with pytest.raises(errors.MPIError) as ei:
        checkpoint.restore(str(torn))
    assert ei.value.error_class == errors.ERR_FILE
    assert "malformed" in str(ei.value)
    lying = tmp_path / "lying.ck"
    lying.write_bytes(b"OTCKPT\x00\x01" + struct.pack("<Q", 10 ** 6) + b"xx")
    with pytest.raises(errors.MPIError) as ei:
        checkpoint.restore(str(lying))
    assert ei.value.error_class == errors.ERR_FILE


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()
    return addr


def test_kvstore_connect_retries_then_err_intern():
    from ompi_tpu_torch.core import pvar
    from ompi_tpu_torch.runtime import kvstore

    addr = _free_port()
    before = pvar.read("kvstore_connect_retries")
    with pytest.raises(errors.MPIError) as ei:
        kvstore.Client(addr, attempts=3, backoff=0.01)
    assert ei.value.error_class == errors.ERR_INTERN
    assert "3 connect attempts" in str(ei.value)
    assert pvar.read("kvstore_connect_retries") - before == 2


def test_kvstore_connect_survives_late_store_start():
    from ompi_tpu_torch.runtime import kvstore

    addr = _free_port()
    box = {}

    def late_start():
        time.sleep(0.3)
        box["store"] = kvstore.Store(host=addr[0], port=addr[1]).start()

    t = threading.Thread(target=late_start, daemon=True)
    try:
        t.start()
        c = kvstore.Client(addr, attempts=8, backoff=0.05)
        c.put("k", "v")
        assert c.get("k") == "v"
        c.close()
    finally:
        t.join()
        if "store" in box:
            box["store"].stop()


def test_chaos_client_drops_then_recovers():
    from ompi_tpu_torch.elastic import inject
    from ompi_tpu_torch.runtime import kvstore

    store = kvstore.Store().start()
    try:
        c = inject.ChaosClient(store.addr, latency_s=0.02, drop_first=2)
        for _ in range(2):
            with pytest.raises(OSError):
                c.put("x", 1)
        t0 = time.monotonic()
        c.put("x", 2)
        assert time.monotonic() - t0 >= 0.02
        assert c.get("x") == 2
        c.close()
    finally:
        store.stop()


def test_store_ftgather_freezes_one_split():
    """The store's FT rendezvous: a dead rank releases it, and every
    caller of a tag gets the same (contributions, dead) split; a fence
    with a dead member of its world answers ProcFailedError."""
    from ompi_tpu_torch.runtime import kvstore

    store = kvstore.Store().start()
    try:
        store.mark_dead(2, "killed by signal 9")
        got = []

        def call(r, v):
            c = kvstore.Client(store.addr)
            got.append(c.ftgather("t", r, v, (0, 1, 2)))
            c.close()

        ts = [threading.Thread(target=call, args=(r, v))
              for r, v in ((0, 3), (1, 5))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert len(got) == 2 and got[0] == got[1]
        assert got[0] == ({0: 3, 1: 5}, {2: "killed by signal 9"})
        c = kvstore.Client(store.addr)
        other = []

        def fence1():
            try:
                kvstore.Client(store.addr).fence("f", 3, 1, base=0)
            except errors.ProcFailedError as exc:
                other.append(exc.error_class)

        t = threading.Thread(target=fence1)
        t.start()
        with pytest.raises(errors.ProcFailedError):
            c.fence("f", 3, 0, base=0)
        t.join(10)
        assert other == [errors.ERR_PROC_FAILED]
        assert c.faults() == {2: "killed by signal 9"}
        c.close()
    finally:
        store.stop()


def test_elastic_pvars_are_well_known():
    from ompi_tpu_torch.core import pvar

    for name in ("elastic_shrinks", "elastic_hot_joins",
                 "elastic_reshard_bytes", "elastic_recovery_ns",
                 "elastic_fallback_restores", "elastic_checkpoints",
                 "elastic_injected_kills", "ft_heartbeats",
                 "ft_faults_observed", "ft_revokes_applied",
                 "ft_sweep_ns", "kvstore_connect_retries"):
        assert name in pvar.WELL_KNOWN, name


# -- the card example on the CPU platform -------------------------------------

def test_elastic_training_example_kill_shrink_regrow(tmp_path):
    """The card example at --tiny widths: rank 2 killed at step 3, the
    device Allreduces on the comms of 4, 3 and 4 ranks bitwise (one K3
    each), the broken comm freed, the in-memory recovery equal to the
    async checkpoint's replay, the joiner through the ingest plane at
    parity, and the job exits 0 with one signal death."""
    out = str(tmp_path / "el")
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
           "4", "--timeout", "150", "--mca", "ft", "1", "--mca",
           "device_plane", "on", "--mca", "coll_cuda", "on", "--mca",
           "ingest_enable", "1", "--mca", "device_plane_platform", "cpu",
           "--mca", "elastic_inject_kill_step", "3", "--mca",
           "elastic_inject_rank", "2",
           os.path.join("ompi_tpu_torch", "examples", "elastic_training.py"),
           "--tiny", "--out", out]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=200)
    assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-3000:])
    names = sorted(os.listdir(out))
    assert names == ["ckpt", "rank0.json", "rank1.json", "rank3.json",
                     "rank4.json"], names
    for w in (0, 1, 3, 4):
        d = json.load(open(os.path.join(out, f"rank{w}.json")))
        assert all(c["ok"] for c in d["cases"]), d["cases"]
        assert d["report"]["parity_checked"]
        if w != 4:
            assert d["report"]["failures"] == {"2": "killed by signal 9"}
            assert d["launches"]["linear_fold"] == 3
        else:
            assert d["report"]["joiner"] and d["launches"]["linear_fold"] == 1
