"""The port's checkpoint planes (``io/checkpoint.py``, ``io/manifest.py``,
``io/async_ckpt.py``) against the JAX package's: the counterparts of
``tests/test_checkpoint.py``'s 5 cases and of ``tests/test_async_ckpt.py``'s,
the crash matrix's every phase among them.

Parity: the same seeded trees go through both packages (the port's
float leaves as CPU tensors where a case says so) and the data they
write must be equal byte for byte: a checkpoint file's leaf section (all
from its first aligned leaf on), an async epoch's data files, and every
manifest chunk record (key, file, offset, nbytes, sha256) and header
field, the treedef apart (each package pickles its own: the port's
``zero/layout.TreeDef``, the reference's jax treedef, which needs jax to
read). Restores must give back the same leaves, bitwise, and the same
epoch.

In this process: the one-rank cases, ``restore_to_device``'s
ingest-gated upload among them. Launcher jobs, one per package: the
4-rank sharded checkpoint and the 2-rank publish and retry-vote cases
(the reference's as pooled bodies); the port's 2-rank elastic job (an
``ElasticContext(async_checkpoint=True)`` round trip, then a hot join
that must drop the snapshot begun on the old comm); and the port's own
example, ``ompi_tpu_torch/examples/ckpt_training.py --tiny`` on the CPU
platform, through its three phases: a full run, a run killed mid-write
of epoch 3 (no manifest 3, no arena file left), and a resume from epoch
2 that reaches the full run's digest.

Waiting for ROADMAP queue 1 item 10 (prof and telemetry):
``test_overlap_pvar_proves_snapshot_rides_train`` and
``test_hang_dump_names_in_flight_snapshot``.
"""

import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_ingest import (  # noqa: F401 — autouse
    port_accelerator_state)
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("ref", "port")


def _mods(side):
    if side == "ref":
        from ompi_tpu import errors
        from ompi_tpu.core import pvar
        from ompi_tpu.io import async_ckpt, checkpoint, manifest
    else:
        from ompi_tpu_torch import errors
        from ompi_tpu_torch.core import pvar
        from ompi_tpu_torch.io import async_ckpt, checkpoint, manifest
    return errors, pvar, checkpoint, async_ckpt, manifest


def _leaves(side, tree):
    if side == "ref":
        import jax

        return jax.tree_util.tree_flatten(tree)
    from ompi_tpu_torch.zero import layout

    return layout.tree_flatten(tree)


def _bits(x) -> bytes:
    """A leaf's bytes and dtype name, numpy, jax or torch alike."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return str(x.dtype).replace("torch.", "").encode() + b":" \
            + t.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype).encode() + b":" + a.tobytes()


def _same_tree(side, got, want):
    lg, dg = _leaves(side, got)
    lw, dw = _leaves(side, want)
    assert dg == dw
    assert [_bits(x) for x in lg] == [_bits(x) for x in lw]
    return [_bits(x) for x in lg]


def _tensors(tree, keys=None):
    """The port's copy of a numpy dict tree: float leaves (or ``keys``)
    as CPU tensors over the same bytes."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if (keys is None and np.asarray(v).dtype == np.float32
                and np.ndim(v)) or (keys and k in keys) else v
            for k, v in tree.items()}


def _ckpt_data(path) -> bytes:
    """A checkpoint file's leaf section: from the first 64-aligned byte
    after its header (both packages align leaves the same way from
    there)."""
    blob = open(path, "rb").read()
    (hlen,) = struct.unpack_from("<Q", blob, 8)
    base = 16 + hlen
    return blob[(base + 63) // 64 * 64:]


# ---------------------------------------------------------------------------
# io/checkpoint


def _tiny_train(params, steps, lr=0.1, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(steps, 4).astype(np.float32)
    losses = []
    w, b = params["w"].copy(), params["b"].copy()
    for i in range(steps):
        x = xs[i]
        pred = w @ x + b
        losses.append(float(pred ** 2))
        w = w - lr * (2 * pred * x)
        b = b - lr * (2 * pred)
    return {"w": w, "b": b}, losses


def test_restart_reproduces_loss_curve(tmp_path):
    params = {"w": np.ones(4, dtype=np.float32),
              "b": np.zeros((), dtype=np.float32)}
    _, full_losses = _tiny_train(params, 10)
    mid, first = _tiny_train(params, 5)
    sections = []
    for side in SIDES:
        _, _, checkpoint, _, _ = _mods(side)
        path = str(tmp_path / f"{side}.otck")
        checkpoint.save(path, mid if side == "ref" else _tensors(mid, {"w"}),
                        step=5)
        restored, step = checkpoint.restore(path)
        assert step == 5
        for k in params:
            assert np.asarray(restored[k]).tobytes() == mid[k].tobytes(), k
        xs = np.random.RandomState(0).randn(10, 4).astype(np.float32)
        w, b = np.asarray(restored["w"]).copy(), np.asarray(restored["b"])
        resumed = []
        for i in range(5, 10):
            pred = w @ xs[i] + b
            resumed.append(float(pred ** 2))
            w = w - 0.1 * (2 * pred * xs[i])
            b = b - 0.1 * (2 * pred)
        assert np.allclose(first + resumed, full_losses)
        sections.append(_ckpt_data(path))
    assert sections[0] == sections[1]


def test_pytree_roundtrip(tmp_path):
    """``test_jax_pytree_roundtrip``: the reference saves a jax tree, the
    port the same values as tensors (bfloat16 among them, restored as a
    CPU bfloat16 tensor); same leaf bytes, same restored bits."""
    import jax.numpy as jnp

    bf = np.ones(4, dtype=np.float32)
    trees = {
        "ref": {"layer": {"w": jnp.arange(12, dtype=jnp.float32)
                          .reshape(3, 4),
                          "b": jnp.asarray(bf, dtype=jnp.bfloat16)},
                "step_scale": jnp.float32(0.5)},
        "port": {"layer": {"w": torch.arange(12, dtype=torch.float32)
                           .reshape(3, 4),
                           "b": torch.from_numpy(bf).to(torch.bfloat16)},
                 "step_scale": torch.tensor(0.5)}}
    sections, bits = [], []
    for side in SIDES:
        _, _, checkpoint, _, _ = _mods(side)
        path = str(tmp_path / f"{side}.otck")
        checkpoint.save(path, trees[side], step=42)
        back, step = checkpoint.restore(path)
        assert step == 42
        bits.append(_same_tree(side, back, trees[side]))
        sections.append(_ckpt_data(path))
    assert sections[0] == sections[1]
    assert bits[0] == bits[1]


def test_async_save(tmp_path):
    x = np.random.default_rng(7).standard_normal((256, 256)) \
        .astype(np.float32)
    sections = []
    for side in SIDES:
        _, _, checkpoint, _, _ = _mods(side)
        path = str(tmp_path / f"{side}.otck")
        h = checkpoint.save_async(
            path, {"x": x if side == "ref" else torch.from_numpy(x)}, step=7)
        h.wait()
        back, step = checkpoint.restore(path)
        assert step == 7 and np.array_equal(back["x"], x)
        sections.append(_ckpt_data(path))
    assert sections[0] == sections[1]


def test_async_save_failure_surfaces_as_mpierror(tmp_path):
    for side in SIDES:
        errors, _, checkpoint, _, _ = _mods(side)
        path = str(tmp_path / "no" / "such" / "dir" / f"{side}.otck")
        h = checkpoint.save_async(path, {"x": np.arange(16,
                                                        dtype=np.float32)},
                                  step=1)
        with pytest.raises(errors.MPIError) as ei:
            h.wait()
        assert ei.value.error_class == errors.ERR_FILE
        assert h.done() and h.error is not None


_SHARDED = '''
import json, os
from {pkg}.io import checkpoint
path = os.path.join({out!r}, "sharded.otck")
full = np.arange(32 * 6, dtype=np.float32).reshape(32, 6)
shard = np.array_split(full, size, axis=0)[rank]
checkpoint.save_sharded(path, {{"emb": W(shard)}}, comm, step=3)
comm.Barrier()
tree, step = checkpoint.restore(path, comm=comm)
assert step == 3
assert np.asarray(tree["emb"]).tobytes() == shard.tobytes(), rank
tree_g, _ = checkpoint.restore(path)
assert np.asarray(tree_g["emb"]).tobytes() == full.tobytes()
comm.Barrier()
'''


def _port_job(src: str, n: int, timeout=240) -> int:
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        return port_launcher.launch([sys.executable, path], n,
                                    mca={"device_plane_platform": "cpu"},
                                    timeout=timeout)
    finally:
        os.unlink(path)


_PORT_PRELUDE = '''
import numpy as np
import torch
from ompi_tpu_torch import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size


def W(a):
    return torch.from_numpy(np.ascontiguousarray(a))
'''


def test_sharded_collective_checkpoint(tmp_path):
    """4 ranks each write their leading-axis shard (the port's as CPU
    tensors) via Write_at_all; restore re-slices per rank and also reads
    back the global view; the two files' leaf sections are equal."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    run_ranks("def W(a):\n    return a\n"
              + _SHARDED.format(pkg="ompi_tpu", out=str(ref)), 4,
              timeout=180)
    assert _port_job(_PORT_PRELUDE + _SHARDED.format(
        pkg="ompi_tpu_torch", out=str(port)) + "mpi.Finalize()\n", 4) == 0
    assert _ckpt_data(str(ref / "sharded.otck")) \
        == _ckpt_data(str(port / "sharded.otck"))


# ---------------------------------------------------------------------------
# io/async_ckpt, one rank


def _tree(seed=0, nleaves=3, elems=5000):
    rng = np.random.default_rng(seed)
    t = {f"w{i}": rng.standard_normal(elems).astype(np.float32)
         for i in range(nleaves)}
    t["scalar"] = np.float32(seed + 0.5)
    t["ints"] = np.arange(17 + seed, dtype=np.int32)
    return t


@pytest.fixture(autouse=True)
def _clear_injection():
    yield
    for side in SIDES:
        A = _mods(side)[3]
        A._fail_var.set("")
        A._kill_chunk_var.set(-1)
        A._kill_rank_var.set(-1)


class _Pair:
    """The same calls on both packages' AsyncCheckpointer, each over its
    own directory; the port's float leaves go in as CPU tensors."""

    def __init__(self, tmp_path, **kw):
        self.dirs = {s: str(tmp_path / s) for s in SIDES}
        self.ck = {s: _mods(s)[3].AsyncCheckpointer(self.dirs[s], **kw)
                   for s in SIDES}

    def save(self, tree, step, parts=None, fail=None):
        """Both saves; with ``fail``, each must raise MPIError."""
        for s in SIDES:
            t = tree if s == "ref" else _tensors(tree)
            p = parts if s == "ref" or parts is None else {
                k: torch.from_numpy(v) for k, v in parts.items()}
            if fail is None:
                self.ck[s].save(t, step, parts=p)
            else:
                with pytest.raises(_mods(s)[0].MPIError):
                    self.ck[s].save(t, step, parts=p)

    def restore(self, tree=None):
        """(step, parts) of both restores, held equal to each other and,
        with ``tree``, to it."""
        out = {}
        for s in SIDES:
            got, step, parts = self.ck[s].restore()
            bits = _same_tree(s, got, tree) if tree is not None else None
            out[s] = (step, bits, {k: _bits(v) for k, v in parts.items()})
        assert out["ref"] == out["port"]
        return out["ref"][0], out["ref"][2]

    def same_files(self):
        """Every data file equal byte for byte; every manifest's records
        and header fields (the treedef apart) equal."""
        names = {s: sorted(os.listdir(self.dirs[s])) for s in SIDES}
        # a torn publish leaves its tmp manifest, named by the writer's pid
        assert [re.sub(r"\.tmp\.\d+$", ".tmp", x) for x in names["ref"]] \
            == [re.sub(r"\.tmp\.\d+$", ".tmp", x) for x in names["port"]]
        steps = []
        for name in names["ref"]:
            if ".tmp." in name:
                continue
            a, b = (open(os.path.join(self.dirs[s], name), "rb").read()
                    for s in SIDES)
            if name.startswith("MANIFEST-"):
                da, db = json.loads(a), json.loads(b)
                for d in (da, db):
                    d["header"].pop("treedef", None)
                assert da == db, name
                steps.append(da["step"])
            else:
                assert a == b, name
        return steps


def test_roundtrip_with_parts(tmp_path):
    pair = _Pair(tmp_path)
    tree = _tree(1)
    parts = {"m:0": np.linspace(0, 1, 333).astype(np.float32),
             "m:1": np.arange(64, dtype=np.int64)}
    pair.save(tree, 7, parts=parts)
    step, gparts = pair.restore(tree)
    assert step == 7
    assert gparts == {k: _bits(v) for k, v in parts.items()}
    assert pair.same_files() == [7]
    assert all(c.latest_step() == 7 for c in pair.ck.values())


def test_overlapped_begin_commit_and_snapshot_info(tmp_path, monkeypatch):
    """begin() returns with the drain on a background thread; while it
    drains, snapshot_info() names the in-flight snapshot, and it clears
    once the commit lands (observed from inside the drain by a digest
    spy, both packages)."""
    tree = _tree(2, nleaves=4, elems=20000)
    for s in SIDES:
        A = _mods(s)[3]
        seen = []
        orig = A._manifest.digest

        def spy(data, A=A, seen=seen, orig=orig):
            seen.append(A.snapshot_info())
            return orig(data)

        monkeypatch.setattr(A._manifest, "digest", spy)
        ck = A.AsyncCheckpointer(str(tmp_path / s), chunk_bytes=1 << 12)
        snap = ck.begin(tree if s == "ref" else _tensors(tree), 3)
        snap.wait_d2h()
        assert seen and all(i is not None and i["step"] == 3
                            and i["phase"] == "d2h" for i in seen)
        ck.commit(snap)
        assert A.snapshot_info() is None
        monkeypatch.setattr(A._manifest, "digest", orig)
        got, step, _ = ck.restore()
        assert step == 3
        _same_tree(s, got, tree)
    assert _Pair.same_files(type("P", (), {"dirs": {
        s: str(tmp_path / s) for s in SIDES}})()) == [3]


def _flip_first_chunk(directory, manifest, step, how):
    doc = manifest.load(directory, step)
    rec = doc["chunks"][0]
    p = os.path.join(directory, rec["file"])
    if how == "flip":
        with open(p, "r+b") as f:
            f.seek(rec["offset"])
            b = f.read(1)
            f.seek(rec["offset"])
            f.write(bytes([b[0] ^ 0xFF]))
    elif how == "truncate":
        os.truncate(p, rec["offset"] + rec["nbytes"] // 2)
    else:
        os.unlink(p)


@pytest.mark.parametrize("how", ["flip", "truncate", "unlink"])
def test_torn_newest_epoch_falls_back_one(tmp_path, how):
    """``test_corrupt_newest_epoch_falls_back_one`` (a flipped byte:
    ``ckpt_digest_mismatches``), ``test_truncated_data_file_falls_back``
    and ``test_missing_data_file_falls_back``: restore lands on epoch 1."""
    pair = _Pair(tmp_path, **({"retain": 10} if how == "unlink" else {}))
    t1, t2 = _tree(1), _tree(2)
    pair.save(t1, 1)
    pair.save(t2, 2)
    assert pair.same_files() == [1, 2]
    sess = {}
    for s in SIDES:
        _, pvar, _, _, manifest = _mods(s)
        _flip_first_chunk(pair.dirs[s], manifest, 2, how)
        sess[s] = pvar.session()
    step, _ = pair.restore(t1)
    assert step == 1
    for s in SIDES:
        assert sess[s].read("ckpt_restore_fallbacks") >= 1
        if how == "flip":
            assert sess[s].read("ckpt_digest_mismatches") >= 1


@pytest.mark.parametrize("phase,commits,restores_to", [
    ("d2h", False, 1),
    ("pre_manifest", False, 1),
    ("mid_rename", False, 1),
    ("corrupt_chunk", True, 1),
    ("write", True, 2),
])
def test_crash_matrix(tmp_path, phase, commits, restores_to):
    """Every injectable phase, epoch 1 clean: both packages restore to
    the same epoch (1 for real faults, 2 when the fault only degraded
    the write path), with the same files on disk."""
    pair = _Pair(tmp_path)
    t1, t2 = _tree(11), _tree(12)
    pair.save(t1, 1)
    sess = {s: _mods(s)[1].session() for s in SIDES}
    for s in SIDES:
        _mods(s)[3]._fail_var.set(phase)
    try:
        pair.save(t2, 2, fail=None if commits else True)
    finally:
        for s in SIDES:
            _mods(s)[3]._fail_var.set("")
    pair.same_files()
    step, _ = pair.restore(t1 if restores_to == 1 else t2)
    assert step == restores_to, (phase, step)
    for s in SIDES:
        assert sess[s].read("ckpt_injected_failures") >= 1
        if phase == "write":
            assert sess[s].read("ckpt_fallback_sync") >= 1
            assert sess[s].read("ckpt_write_retries") >= 1
        assert _mods(s)[3].snapshot_info() is None


def test_no_restorable_epoch_raises_err_file(tmp_path):
    for s in SIDES:
        errors, _, _, A, _ = _mods(s)
        with pytest.raises(errors.MPIError) as ei:
            A.AsyncCheckpointer(str(tmp_path / s)).restore()
        assert ei.value.error_class == errors.ERR_FILE


def test_incremental_skips_unchanged_chunks(tmp_path):
    pair = _Pair(tmp_path, incremental=True)
    tree = _tree(21, nleaves=4, elems=30000)
    pair.save(tree, 1)
    sess = {s: _mods(s)[1].session() for s in SIDES}
    pair.save(tree, 2)
    skipped = [sess[s].read("ckpt_incremental_skipped") for s in SIDES]
    assert skipped[0] == skipped[1] > 0
    assert pair.restore(tree)[0] == 2
    tree2 = dict(tree)
    tree2["w0"] = tree["w0"] + 1.0
    sess = {s: _mods(s)[1].session() for s in SIDES}
    pair.save(tree2, 3)
    skipped = [sess[s].read("ckpt_incremental_skipped") for s in SIDES]
    assert skipped[0] == skipped[1] > 0
    assert pair.restore(tree2)[0] == 3
    assert pair.same_files() == [1, 2, 3]


def test_incremental_chain_survives_prune(tmp_path):
    pair = _Pair(tmp_path, incremental=True, retain=2)
    tree = _tree(22, elems=10000)
    for s in range(1, 6):
        pair.save(tree, s)
    assert pair.restore(tree)[0] == 5
    assert pair.same_files() == [4, 5]


def test_clean_buckets_skip_d2h(tmp_path):
    tree = _tree(23, elems=8000)
    for s in SIDES:
        ck = _mods(s)[3].AsyncCheckpointer(str(tmp_path / s),
                                           incremental=True)
        t = tree if s == "ref" else _tensors(tree)
        ck.commit(ck.begin(t, 1))
        leaves, _ = _leaves(s, t)
        nb = len(ck._plan(leaves).buckets)
        ck.commit(ck.begin(t, 2, clean_buckets=tuple(range(nb))))
        got, step, _ = ck.restore()
        assert step == 2
        _same_tree(s, got, tree)
    pair = type("P", (), {"dirs": {s: str(tmp_path / s) for s in SIDES}})()
    assert _Pair.same_files(pair) == [1, 2]


def test_restore_feeds_ingest_gated_upload(tmp_path):
    """restore_to_device hands the restored tree to the ingest plane: the
    first step gates on its first leaf while the rest streams; the
    uploaded tree equals the saved one and the reference's upload,
    bitwise."""
    from ompi_tpu.ingest import engine as R_ie
    from ompi_tpu_torch.ingest import engine as P_ie

    tree = _tree(41, nleaves=4)
    got = {}
    for s, ie in (("ref", R_ie), ("port", P_ie)):
        ck = _mods(s)[3].AsyncCheckpointer(str(tmp_path / s))
        ck.save(tree if s == "ref" else _tensors(tree), 9)
        eng = ie.IngestEngine(chunk_bytes=4096)
        try:
            req, step, _ = ck.restore_to_device(engine=eng)
            assert step == 9 and isinstance(req, ie.IngestRequest)
            assert req.Parrived(0)
            got[s] = _same_tree(s, req.wait().tree(), tree)
        finally:
            eng.close()
        # with no engine up the restore is the host tree
        host, step, _ = ck.restore_to_device()
        assert step == 9
        _same_tree(s, host, tree)
    assert got["ref"] == got["port"]


def test_sharded_state_versions_bump_on_map():
    """zero-plane dirty tracking: map() bumps every bucket's version
    counter; a fresh pack starts at zero (both packages)."""
    import jax

    from ompi_tpu.zero import layout as R
    from ompi_tpu_torch.zero import layout as P

    class _One:
        rank, size = 0, 1

    tree = {"a": np.arange(100, dtype=np.float32),
            "b": np.arange(40, dtype=np.int32)}
    for L, leaves in ((R, jax.tree.leaves(tree)),
                      (P, P.tree_leaves(tree))):
        st = L.ShardedState.from_full(_One(), tree,
                                      plan=L.plan_for(leaves, 1))
        assert st.versions == [0] * len(st.shards)
        st2 = st.map(lambda s: s * 2)
        assert st2.versions == [v + 1 for v in st.versions]
        assert st.versions == [0] * len(st.shards)


def test_incremental_no_inherit_across_layout_change(tmp_path):
    pair = _Pair(tmp_path, incremental=True)
    tree = _tree(51, elems=20000)
    pair.save(tree, 1)
    sess = {}
    for s in SIDES:
        manifest = _mods(s)[4]
        doc = manifest.load(pair.dirs[s], 1)
        doc["header"]["n"] = 2  # pretend epoch 1 was written 2-rank
        manifest.write(pair.dirs[s], doc)
        sess[s] = _mods(s)[1].session()
    pair.save(tree, 2)
    for s in SIDES:
        assert sess[s].read("ckpt_incremental_skipped") == 0
        doc2 = _mods(s)[4].load(pair.dirs[s], 2)
        assert all(r["file"] == "epoch_2.data" for r in doc2["chunks"])
        assert doc2.get("parent") is None
    assert pair.restore(tree)[0] == 2
    assert pair.same_files() == [1, 2]


def test_manifest_write_oserror_wraps_err_file(tmp_path):
    target = tmp_path / "not_a_dir"
    target.write_text("file where the checkpoint dir should be")
    for s in SIDES:
        errors, _, _, _, manifest = _mods(s)
        with pytest.raises(errors.MPIError) as ei:
            manifest.write(str(target), {"step": 1, "chunks": []})
        assert ei.value.error_class == errors.ERR_FILE


def test_retention_prunes_old_epochs(tmp_path):
    pair = _Pair(tmp_path, retain=2)
    for s in range(1, 6):
        pair.save(_tree(s), s)
    for s in SIDES:
        assert _mods(s)[4].scan(pair.dirs[s]) == [5, 4]
    assert pair.restore(_tree(5))[0] == 5
    assert pair.same_files() == [4, 5]


# ---------------------------------------------------------------------------
# io/async_ckpt on 2 ranks: the publish outcome and the write vote

_TWO = '''
import json, os
from {pkg} import errors
from {pkg}.core import pvar
from {pkg}.io import async_ckpt as A
doc = {{}}

# -- test_publish_failure_raises_on_every_rank
d = os.path.join({out!r}, "pub")
ck = A.AsyncCheckpointer(d, comm=comm)
tree = {{"w": W(np.arange(256, dtype=np.float32))}}
ck.save(tree, 1)
A._fail_var.set("mid_rename")
try:
    try:
        ck.save(tree, 2)
        doc["pub_raised"] = False
    except errors.MPIError:
        doc["pub_raised"] = True
finally:
    A._fail_var.set("")
doc["pub_step"] = ck.restore()[1]
comm.Barrier()

# -- test_write_retry_agreement_across_ranks
d = os.path.join({out!r}, "vote")
ck = A.AsyncCheckpointer(d, comm=comm)
tree = {{"w": W(np.arange(4096, dtype=np.float32))}}
before = pvar.snapshot().get("ckpt_write_retries", 0)
if rank == 1:
    orig = ck._write_collective
    state = {{"failed": False}}

    def flaky(path, extents, data):
        orig(path, extents, data)
        if not state["failed"]:
            state["failed"] = True
            raise errors.MPIError(errors.ERR_FILE, "injected local EIO")
    ck._write_collective = flaky
ck.save(tree, 1)
doc["vote_retries"] = pvar.snapshot().get("ckpt_write_retries", 0) - before
doc["vote_step"] = ck.restore()[1]
comm.Barrier()
with open(os.path.join({out!r}, f"r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """(port dir, reference dir, [(port doc, reference doc)] per rank) of
    the 2-rank program, once per package."""
    ref = tmp_path_factory.mktemp("ckpt_ref2")
    port = tmp_path_factory.mktemp("ckpt_port2")
    run_ranks("def W(a):\n    return a\n"
              + _TWO.format(pkg="ompi_tpu", out=str(ref)), 2, timeout=180)
    assert _port_job(_PORT_PRELUDE + _TWO.format(
        pkg="ompi_tpu_torch", out=str(port)) + "mpi.Finalize()\n", 2) == 0
    return port, ref, [tuple(json.loads((d / f"r{r}.json").read_text())
                             for d in (port, ref)) for r in range(2)]


def _two_case(two, sub, keys, want):
    port, ref, docs = two
    for dp, dr in docs:
        got = [[d[k] for k in keys] for d in (dp, dr)]
        assert got[0] == got[1] == want, got
    pair = type("P", (), {"dirs": {"ref": str(ref / sub),
                                   "port": str(port / sub)}})()
    assert _Pair.same_files(pair) == [1]


def test_publish_failure_raises_on_every_rank(two):
    """A rank-0-only mid_rename failure raises on every rank (the outcome
    bcast), and epoch 1 restores; same files in both packages."""
    _two_case(two, "pub", ("pub_raised", "pub_step"), [True, 1])


def test_write_retry_agreement_across_ranks(two):
    """One rank's local write failure after the collective exchange makes
    every rank retry together (the success vote)."""
    _two_case(two, "vote", ("vote_retries", "vote_step"), [1, 1])


# ---------------------------------------------------------------------------
# the port's example on the CPU platform: full, crash mid-epoch 3, resume


def _example(phase: str, out: str, extra=()):
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
           "4", "--timeout", "150", "--mca", "device_plane", "on",
           "--mca", "coll_cuda", "on", "--mca", "device_plane_platform",
           "cpu", "--mca", "coll_device_bucket_bytes", "20000",
           os.path.join("ompi_tpu_torch", "examples", "ckpt_training.py"),
           "--tiny", "--phase", phase, "--out", os.path.join(out, phase),
           *extra]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=200)


def test_ckpt_training_example_crash_and_resume(tmp_path, monkeypatch):
    """The card example's three phases at --tiny widths (37 buckets):
    the full run's restore equals its held shards bitwise; the crash run
    dies in epoch 3's write with no manifest 3 and no ``ompi_tpu_torch_*``
    shm file left; the resume from epoch 2 reaches the full run's digest;
    the K2 / K3 launches of every job are the ones the schedule
    implies."""
    out = str(tmp_path)
    shm = tmp_path / "shm"
    shm.mkdir()
    monkeypatch.setenv("OMPI_TPU_SHM_DIR", str(shm))
    full = _example("full", out)
    assert full.returncode == 0, (full.stdout, full.stderr[-3000:])
    crash = _example("crash", out)
    assert crash.returncode != 0, crash.stdout
    assert not os.listdir(shm)
    res = _example("restore", out,
                   ("--ckpt", os.path.join(out, "crash", "ckpt")))
    assert res.returncode == 0, (res.stdout, res.stderr[-3000:])
    names = os.listdir(os.path.join(out, "crash", "ckpt"))
    assert sorted(n for n in names if n.startswith("MANIFEST-")) \
        == ["MANIFEST-1.json", "MANIFEST-2.json"], names
    docs = {p: [json.load(open(os.path.join(out, p, f"rank{r}.json")))
                for r in range(4)] for p in ("full", "crash", "restore")}
    for p, ds in docs.items():
        for d in ds:
            assert d["buckets"] > 1
            assert all(c["ok"] for c in d["cases"]), (p, d["cases"])
            assert d["launches"] == d["expected_launches"], (p, d)
            assert d["coll_accelerator_staged"] == 0
    assert docs["restore"][0]["report"]["resumed_from"] == 2
    assert docs["restore"][0]["report"]["digest"] \
        == docs["full"][0]["report"]["digest"]


# ---------------------------------------------------------------------------
# the elastic plane's checkpoints: one 2-rank job (its joiner re-runs the
# program and takes the joiner branch first)

_ELASTIC = '''
import hashlib, json, os, shutil, sys
import numpy as np
from ompi_tpu_torch import elastic, mpi
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.io import manifest
from ompi_tpu_torch.runtime import rte
from ompi_tpu_torch.zero import layout as zl
OUT = {out!r}
comm = mpi.Init()


def dump(doc):
    with open(os.path.join(OUT, f"w{{rte.rank}}.json"), "w") as fh:
        json.dump(doc, fh)


def grad_join(p, step, c):
    return {{k: np.full_like(a, 0.125 * (step + 1)) for k, a in p.items()}}


if elastic.is_joiner():
    ctx, target = elastic.hot_join()
    ctx.run(grad_join, target)
    ctx.comm.Barrier()
    dump({{"joiner": True, "size": ctx.comm.size}})
    mpi.Finalize()
    sys.exit(0)
rank = comm.rank
doc = {{}}

# -- test_elastic_async_checkpoint_roundtrip
d = os.path.join(OUT, "roundtrip")
params = {{"w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0,
          "b": np.linspace(-1.0, 1.0, 5).astype(np.float32)}}


def grad_fn(p, step, c):
    return {{k: 0.01 * a + np.full_like(a, 0.125 * (step + 1))
            for k, a in p.items()}}


ctx = elastic.ElasticContext(comm, params, lr=0.125, momentum=0.5,
                             checkpoint_dir=d, checkpoint_every=2,
                             async_checkpoint=True)
out = ctx.run(grad_fn, 5)
doc["commits"] = pvar.snapshot().get("ckpt_commits", 0)
ref = elastic.ElasticContext.from_checkpoint(
    comm, d, lr=0.125, momentum=0.5, async_checkpoint=True)
doc["ref"] = [ref.restored_from, ref.step_done]
ref_out = ref.run(grad_fn, 5)
doc["params_equal"] = all(
    a.tobytes() == b.tobytes()
    for a, b in zip(zl.tree_leaves(out), zl.tree_leaves(ref_out)))
doc["momentum_equal"] = all(
    np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for name, st in ctx.opt.state.slots.items()
    for a, b in zip(st.shards, ref.opt.state.slots[name].shards))
comm.Barrier()

# -- test_hot_join_aborts_pending_async_snapshot
d = os.path.join(OUT, "join")
params = {{"w": np.arange(12, dtype=np.float32) / 5.0}}
ctx = elastic.ElasticContext(comm, params, lr=0.125, momentum=0.5,
                             checkpoint_dir=d, checkpoint_every=2,
                             async_checkpoint=True)
proc = None
if rank == 0:
    proc = elastic.spawn_replacement(script=os.path.abspath(__file__),
                                     mca={{"ft": "1"}})
# a snapshot begins at the step-1 boundary (2 ranks), the join lands at
# step 3, and the boundaries at 3 and 5 run on the grown comm
ctx.run(grad_join, 6, join_at=3)
ctx.comm.Barrier()
steps = manifest.scan(d)
doc["join"] = [ctx.comm.size, ctx.joins, bool(steps),
               int(manifest.load(d, steps[0])["nranks"]) if steps else 0]
if proc is not None:
    doc["joiner_rc"] = proc.wait(timeout=60)
dump(doc)
mpi.Finalize()
'''


@pytest.fixture(scope="module")
def elastic_two(tmp_path_factory):
    """The 2-rank elastic job's records, by world rank (2: the joiner)."""
    out = tmp_path_factory.mktemp("ckpt_elastic")
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(_ELASTIC.format(out=str(out)))
        path = fh.name
    try:
        assert port_launcher.launch(
            [sys.executable, path], 2,
            mca={"device_plane_platform": "cpu", "ft": "1"},
            timeout=180) == 0
    finally:
        os.unlink(path)
    return {int(p.stem[1:]): json.loads(p.read_text())
            for p in out.glob("w*.json")}


def test_elastic_async_checkpoint_roundtrip(elastic_two):
    """ElasticContext(async_checkpoint=True): the boundary snapshots ride
    the async plane, and from_checkpoint restores parameters and
    optimizer slot shards that replay to the run's, bitwise."""
    for w in (0, 1):
        d = elastic_two[w]
        assert d["commits"] >= 1
        assert d["ref"][0] == "checkpoint" and d["ref"][1] >= 2
        assert d["params_equal"] and d["momentum_equal"]


def test_hot_join_aborts_pending_async_snapshot(elastic_two):
    """A snapshot begun at a boundary before the join is bound to the old
    comm: the regrow drops it, and the newest committed epoch is one the
    grown comm of 3 wrote."""
    assert sorted(elastic_two) == [0, 1, 2]
    assert elastic_two[2] == {"joiner": True, "size": 3}
    for w in (0, 1):
        assert elastic_two[w]["join"] == [3, 1, True, 3]
    assert elastic_two[0]["joiner_rc"] == 0
