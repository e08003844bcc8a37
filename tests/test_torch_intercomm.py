"""The port's intercommunicators, Idup, dynamic processes and profiling
interposer (``comm/intercomm.py``, ``coll/inter.py``, ``dpm.py``,
``profile.py``, ``Communicator.Idup``) against the JAX package's.

Launcher jobs, one per package and rank count, run the same programs,
each rank writing what it got: on 4 ranks ``tests/test_intercomm.py``'s
cases over two interleaved halves (:data:`_PROG4`), on 3 ranks
Comm_create_group (:data:`_PROG3`), on 2 ranks Idup, the three profile
cases of ``tests/test_monitoring.py:67-128`` and
``tests/test_spawn.py``'s three spawn cases (:data:`_PROG2`; the
children report their results over the intercommunicator). The
reference's 4- and 3-rank programs run as pooled bodies, its 2-rank one
in a job of its own (a spawn). ``test_tpurun_mpmd_colon_and_appfile``
runs ``tests/test_spawn.py``'s MPMD case on the port's launcher (the
colon syntax and an ``--app`` file).

The port's 2-rank job runs under the device plane on the CPU platform,
which the children inherit: before the first spawn each parent runs a
device Allreduce on COMM_WORLD, so the parents' arena files are mapped
while each child world runs its own device Allreduce on its COMM_WORLD
(the same cid, 0). The CPU arenas are shared-memory files too, so a
name collision would show: the children report their files, which must
be theirs alone. In this process: a spawned child's Init raises with the
device plane on the cuda platform and no GPU, as a parent's does.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import uuid

import pytest

from ompi_tpu_torch import errors
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEAD = '''
import json, os
import numpy as np
from {pkg}.pml.request import PROC_NULL
doc = {{}}
half = comm.split(color=rank % 2, key=rank)
peers_lo = [r for r in range(size) if r % 2 == 0]
peers_hi = [r for r in range(size) if r % 2 == 1]
other_side = peers_hi if rank % 2 == 0 else peers_lo
'''

_TAIL = '''
with open(os.path.join({out!r}, f"r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''

#: 4 ranks: tests/test_intercomm.py's six cases over the even / odd halves
_PROG4 = _HEAD + '''
inter = mpi.Intercomm_create(half, 0, comm, (rank % 2) ^ 1, tag=9)
got = inter.sendrecv(("hello", rank), dest=half.rank, source=half.rank)
doc["p2p"] = [inter.is_inter, inter.Is_inter(), inter.size,
              inter.remote_size, list(got), comm.Is_inter()]
inter = mpi.Intercomm_create(half, 0, comm, (rank % 2) ^ 1, tag=1)
if rank % 2 == 0:
    root = mpi.ROOT if half.rank == 1 else PROC_NULL
    out = inter.bcast(("payload", 42) if root == mpi.ROOT else None,
                      root=root)
    buf = np.arange(4, dtype=np.int32) if root == mpi.ROOT \\
        else np.zeros(4, np.int32)
    inter.Bcast(buf, root=root)
else:
    out = inter.bcast(None, root=1)
    buf = np.zeros(4, np.int32)
    inter.Bcast(buf, root=1)
doc["bcast"] = [out if out is None else list(out), buf.tolist()]
inter = mpi.Intercomm_create(half, 0, comm, (rank % 2) ^ 1, tag=2)
out = np.empty(4, np.float32)
inter.Allreduce(np.full(4, float(rank + 1), np.float32), out)
doc["allreduce"] = out.tolist()
inter = mpi.Intercomm_create(half, 0, comm, (rank % 2) ^ 1, tag=3)
inter.Barrier()
out = np.empty((inter.remote_size, 2), np.float32)
inter.Allgather(np.full(2, float(rank), np.float32), out)
objs = inter.allgather(("r", rank))
doc["allgather"] = [out.tolist(), [list(o) for o in objs]]
inter = mpi.Intercomm_create(half, 0, comm, (rank % 2) ^ 1, tag=4)
merged = inter.merge(high=(rank % 2 == 1))
v = np.empty(1, np.float32)
merged.Allreduce(np.array([float(rank)], np.float32), v)
m2 = inter.Intercomm_merge(high=False)
doc["merge"] = [merged.is_inter, merged.size, list(merged.group.ranks),
                v.tolist(), list(m2.group.ranks)]
if rank % 2 == 0:
    inter = mpi.Comm_accept({port!r}, half, root=0)
else:
    inter = mpi.Comm_connect({port!r}, half, root=0)
out = np.empty(2, np.float32)
inter.Allreduce(np.full(2, float(rank + 10), np.float32), out)
doc["connect"] = [inter.remote_size, out.tolist(), mpi.Open_port() !=
                  mpi.Open_port()]
'''

#: 3 ranks: Comm_create_group is collective over the group's members only
_PROG3 = '''
import json, os
import numpy as np
from {pkg}.comm import Group
doc = {{}}
if rank in (0, 2):
    sub = comm.create_group(Group([comm.group.ranks[i] for i in (0, 2)]),
                            tag=7)
    out = np.zeros(1)
    sub.Allreduce(np.array([float(sub.rank + 1)]), out)
    doc["create_group"] = [sub.size, sub.errhandler == comm.errhandler,
                           out.tolist()]
    sub.free()
else:
    doc["create_group"] = None
comm.Barrier()
'''

#: 2 ranks: Idup; the profile cases; the three spawns
_PROG2 = '''
import json, os, time
import numpy as np
from {pkg} import dpm, profile
from {pkg}.core import pvar
doc = {{}}
{device}
log = []
kv = mpi.Comm_create_keyval(
    copy_fn=lambda o, k, e, v: (log.append(v), v * 2)[1])
comm.Set_attr(kv, 21)
req = comm.Idup()
peer = 1 - rank
comm.send(("overlap", rank), dest=peer, tag=3)
ov = comm.recv(source=peer, tag=3)
req.wait(timeout=60)
c2 = req.result["comm"]
out = np.zeros(2)
c2.Allreduce(np.full(2, rank + 1.0), out)
doc["idup"] = [c2.size, c2.cid != comm.cid, c2.Get_attr(kv), log, list(ov),
               out.tolist()]
c2.free()

s = pvar.session()
with profile.timing() as stats:
    comm.Barrier()
    comm.Barrier()
comm.Barrier()
doc["timing"] = [stats["Barrier"][0], s.read("profile_Barrier_calls"),
                 s.read("profile_Barrier_ns") > 0]
calls = []
h = profile.attach_tool(
    pre=lambda name, c, a, k: calls.append(("pre", name)),
    post=lambda name, c, r, e: calls.append(("post", name)))
comm.Barrier()
comm.Allreduce(np.ones(4), np.zeros(4))
profile.detach_tool(h)
comm.Barrier()
with profile.timing(names=["Bcast"]) as stats:
    comm.Bcast(np.zeros(8) if rank else np.arange(8.0), root=0)
doc["hooks"] = [[c for c in calls if c[1] in ("Barrier", "Allreduce")],
                stats["Bcast"][0], stats["Bcast"][1] >= 0]
seen = []
h1 = profile.attach_tool(pre=lambda n, c, a, k: seen.append("outer"),
                         names=["Barrier"])
h2 = profile.attach_tool(pre=lambda n, c, a, k: seen.append("inner"),
                         names=["Barrier"])
comm.Barrier()
profile.detach_tool(h2)
comm.Barrier()
profile.detach_tool(h1)
comm.Barrier()
doc["nested"] = seen

spawns = {{}}
inter = mpi.Comm_spawn({child!r}, maxprocs=3)
out = np.zeros(1, dtype=np.int64)
inter.Allreduce(np.array([rank + 100], dtype=np.int64), out)
spawns["allreduce"] = [inter.remote_size, int(out[0])]
if rank == 0:
    spawns["allreduce"].append(inter.recv(source=0, tag=5))
inter = mpi.Comm_spawn({child!r}, args=("merge",), maxprocs=2)
merged = inter.merge(high=False)
tot = np.zeros(1, dtype=np.int64)
merged.Allreduce(np.array([1], dtype=np.int64), tot)
spawns["merge"] = [merged.size, int(tot[0]), inter.remote_size]
if rank == 0:
    spawns["merge"].append(inter.recv(source=0, tag=5))
inter = mpi.Comm_spawn_multiple([({child!r}, ("appA",), 1),
                                 ({child!r}, ("appB",), 2)])
out = np.zeros(1, dtype=np.int64)
inter.Allreduce(np.array([rank + 100], dtype=np.int64), out)
spawns["multiple"] = [inter.remote_size, int(out[0])]
if rank == 0:
    spawns["multiple"].append(inter.recv(source=0, tag=5))
    spawns["codes"] = dpm.wait_children(timeout=120)
    spawns["spawned_procs"] = pvar.read("spawned_procs")
comm.Barrier()
doc["spawn"] = spawns
doc["parent_arenas"] = arenas() if DEVICE else []
'''

#: the port's parents: a device Allreduce on COMM_WORLD before the first
#: spawn, so their arena files are mapped while the children run theirs
_PARENT_DEVICE = '''
import glob
import torch
from ompi_tpu_torch.runtime import launcher, rte
DEVICE = True


def arenas():
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        launcher.shm_dir(), f"{{launcher.SHM_PREFIX}}{{rte.jobid}}_c*")))


dev = comm.Allreduce(torch.full((4096,), float(rank + 1)))
doc["parent_device"] = [float(dev[0]), len(arenas()) > 0]
'''

#: the child: tests/test_spawn.py's _CHILD and _CHILD_MULTI in one; rank 0
#: sends its results to the parents' rank 0
_CHILD = '''
import os
import sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
from {pkg} import dpm, mpi
from {pkg}.runtime import rte

mode = sys.argv[1] if len(sys.argv) > 1 else "allreduce"
comm = mpi.Init()
parent = mpi.Comm_get_parent()
assert parent is not None and mpi.Comm_get_parent() is parent
doc = {{"world": [comm.rank, comm.size, rte.world_offset,
                  list(comm.group.ranks), dpm.appnum()]}}
if mode == "merge":
    merged = parent.merge(high=True)
    tot = np.zeros(1, dtype=np.int64)
    merged.Allreduce(np.array([1], dtype=np.int64), tot)
    doc["merged"] = [merged.size, int(tot[0]), merged.rank]
else:
    out = np.zeros(1, dtype=np.int64)
    parent.Allreduce(np.array([comm.rank + 1], dtype=np.int64), out)
    doc["bridge"] = int(out[0])
tot = np.zeros(1, dtype=np.int64)
comm.Allreduce(np.array([1], dtype=np.int64), tot)
doc["own"] = int(tot[0])
if mode.startswith("app"):
    doc["apps"] = sorted(comm.allgather((comm.rank, dpm.appnum(),
                                         sys.argv[1])))
{device}
docs = comm.gather(doc, root=0)
if comm.rank == 0:
    parent.send(docs, dest=0, tag=5)
mpi.Finalize()
'''

#: the port's child: its own device Allreduce on its COMM_WORLD (cid 0, as
#: the parents' world), with the files it maps at that moment
_CHILD_DEVICE = '''
import glob
import torch
from ompi_tpu_torch.runtime import device_plane, launcher
t = comm.Allreduce(torch.full((4096,), float(comm.rank + 1)),
                   deterministic="ring")
mine = sorted(os.path.basename(p) for p in glob.glob(os.path.join(
    launcher.shm_dir(), f"{launcher.SHM_PREFIX}{rte.jobid}_c*")))
doc["device"] = [str(device_plane.device()), device_plane.leader(),
                 bool((t == sum(range(1, comm.size + 1))).all()), mine]
'''

_PORT_PRELUDE = '''
import numpy as np
from ompi_tpu_torch import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size
'''

_PORT_EPILOGUE = '''
mpi.Finalize()
'''

_jobs = {}
#: the files of each port job left in its shm dir after the launcher ended
_leftover = {}


def _port_job(src: str, n: int, shm_dir, mca=None, timeout=300) -> int:
    """A port launcher job whose shared-memory files live in ``shm_dir``
    (the ranks and their spawned children inherit it)."""
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    old = os.environ.get("OMPI_TPU_SHM_DIR")
    os.environ["OMPI_TPU_SHM_DIR"] = str(shm_dir)
    try:
        return port_launcher.launch([sys.executable, path], n, mca=mca,
                                    timeout=timeout)
    finally:
        if old is None:
            os.environ.pop("OMPI_TPU_SHM_DIR")
        else:
            os.environ["OMPI_TPU_SHM_DIR"] = old
        os.unlink(path)


def _child_file(tmp, pkg: str) -> str:
    path = tmp / f"spawn_child_{pkg}.py"
    device = _CHILD_DEVICE if pkg == "ompi_tpu_torch" else ""
    path.write_text(_CHILD.format(pkg=pkg, device=device))
    return str(path)


@pytest.fixture(scope="module")
def docs(request, tmp_path_factory):
    """[(port doc, reference doc)] per rank for the rank count."""
    n = request.param
    if n not in _jobs:
        ref = tmp_path_factory.mktemp(f"inter_ref{n}")
        port = tmp_path_factory.mktemp(f"inter_port{n}")
        port_name = f"port:test_torch_intercomm:{uuid.uuid4().hex[:8]}"
        mca = None
        if n == 4:
            ref_src = _PROG4.format(pkg="ompi_tpu", port=port_name + "r")
            src = _PROG4.format(pkg="ompi_tpu_torch", port=port_name + "p")
        elif n == 3:
            ref_src = _PROG3.format(pkg="ompi_tpu")
            src = _PROG3.format(pkg="ompi_tpu_torch")
        else:
            ref_src = _PROG2.format(
                pkg="ompi_tpu", device="DEVICE = False",
                child=_child_file(ref, "ompi_tpu"))
            src = _PROG2.format(
                pkg="ompi_tpu_torch", device=_PARENT_DEVICE.format(),
                child=_child_file(port, "ompi_tpu_torch"))
            mca = {"device_plane": "on", "device_plane_platform": "cpu"}
        run_ranks(ref_src + _TAIL.format(out=str(ref)), n, timeout=300)
        src = _PORT_PRELUDE + src + _TAIL.format(out=str(port)) \
            + _PORT_EPILOGUE
        shm = tmp_path_factory.mktemp(f"inter_shm{n}")
        assert _port_job(src, n, shm, mca) == 0, "port job failed"
        _leftover[n] = sorted(os.listdir(shm))
        _jobs[n] = [(json.loads((port / f"r{r}.json").read_text()),
                     json.loads((ref / f"r{r}.json").read_text()))
                    for r in range(n)]
    return _jobs[n]


def _same(pairs, key):
    for p, r in pairs:
        assert p[key] == r[key], (key, p[key], r[key])
    return [r[key] for _, r in pairs]


# ---------------------------------------------------------------------------
# tests/test_intercomm.py


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_intercomm_create_p2p(docs):
    for r, v in enumerate(_same(docs, "p2p")):
        other = [x for x in range(4) if x % 2 != r % 2]
        assert v[:4] == [True, True, 2, 2] and v[5] is False
        assert v[4] == ["hello", other[r // 2]]


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_intercomm_bcast_root_semantics(docs):
    """ROOT / PROC_NULL roots, object and buffer forms."""
    got = _same(docs, "bcast")
    assert got[0] == [None, [0, 0, 0, 0]]
    assert got[2] == [["payload", 42], [0, 1, 2, 3]]
    assert got[1] == got[3] == [["payload", 42], [0, 1, 2, 3]]


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_intercomm_allreduce_swaps_groups(docs):
    for r, out in enumerate(_same(docs, "allreduce")):
        assert out == [float(sum(x + 1 for x in range(4)
                                 if x % 2 != r % 2))] * 4


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_intercomm_allgather_and_barrier(docs):
    for r, (out, objs) in enumerate(_same(docs, "allgather")):
        other = [x for x in range(4) if x % 2 != r % 2]
        assert [row[0] for row in out] == [float(x) for x in other]
        assert [o[1] for o in objs] == other


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_intercomm_merge(docs):
    for merged_is_inter, n, ranks, v, m2 in _same(docs, "merge"):
        assert (merged_is_inter, n, ranks, v) == (False, 4, [0, 2, 1, 3],
                                                  [6.0])
        assert m2 == [0, 2, 1, 3]  # a tie: the smaller world rank first


@pytest.mark.parametrize("docs", [4], indirect=True)
def test_connect_accept(docs):
    for r, (remote, out, fresh) in enumerate(_same(docs, "connect")):
        assert remote == 2 and fresh
        assert out == [float(sum(x + 10 for x in range(4)
                                 if x % 2 != r % 2))] * 2


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_comm_idup_nonblocking(docs):
    """Idup completes while p2p overlaps, copies the attributes like dup,
    and coll stacks on the new comm."""
    for r, v in enumerate(_same(docs, "idup")):
        assert v == [2, True, 42, [21], ["overlap", 1 - r], [3.0, 3.0]]


@pytest.mark.parametrize("docs", [3], indirect=True)
def test_comm_create_group_subset_only(docs):
    got = _same(docs, "create_group")
    assert got[0] == got[2] == [2, True, [3.0]] and got[1] is None


# ---------------------------------------------------------------------------
# tests/test_monitoring.py:67-128


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_profile_timing_publishes_pvars(docs):
    assert _same(docs, "timing") == [[2, 2, True]] * 2


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_profile_hooks_and_timing(docs):
    for calls, n, ok in _same(docs, "hooks"):
        assert calls == [["pre", "Barrier"], ["post", "Barrier"],
                         ["pre", "Allreduce"], ["post", "Allreduce"]]
        assert n == 1 and ok


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_profile_nested_tools(docs):
    assert _same(docs, "nested") == [["inner", "outer", "outer"]] * 2


# ---------------------------------------------------------------------------
# tests/test_spawn.py


def _children(doc, key):
    return doc["spawn"][key][-1]


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_spawn_and_intercomm_allreduce(docs):
    """2 parents spawn 3 children; both sides allreduce across the
    bridge, the children run their own world's collective, and every
    child exits 0."""
    (p, r), _ = docs
    for d in (p, r):
        assert d["spawn"]["allreduce"][:2] == [3, 6]
        assert d["spawn"]["codes"] == [0] * 8
        assert d["spawn"]["spawned_procs"] == 8
    pk, rk = _children(p, "allreduce"), _children(r, "allreduce")
    strip = [{k: v for k, v in c.items() if k != "device"} for c in pk]
    assert strip == rk
    assert [c["bridge"] for c in rk] == [201] * 3
    assert [c["world"][:4] for c in rk] == [[i, 3, 2, [2, 3, 4]]
                                            for i in range(3)]


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_spawn_merge_forms_single_world(docs):
    for d in (docs[0][0], docs[0][1]):
        assert d["spawn"]["merge"][:3] == [4, 4, 2]
    for d in docs[1]:
        assert d["spawn"]["merge"] == [4, 4, 2]
    pk, rk = _children(docs[0][0], "merge"), _children(docs[0][1], "merge")
    assert [c["merged"] for c in pk] == [c["merged"] for c in rk] \
        == [[4, 4, 2], [4, 4, 3]]


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_spawn_multiple_merged_child_world(docs):
    """Two app contexts, one child world (app 0 first)."""
    pk, rk = (_children(d, "multiple") for d in docs[0])
    want = [[0, 0, "appA"], [1, 1, "appB"], [2, 1, "appB"]]
    for kids in (pk, rk):
        assert kids[0]["apps"] == want
        assert [c["world"][4] for c in kids] == [0, 1, 1]
        assert [c["world"][2] for c in kids] == [7] * 3
    assert docs[0][0]["spawn"]["multiple"][:2] == [3, 6]


@pytest.mark.parametrize("docs", [2], indirect=True)
def test_spawned_world_arenas_do_not_collide(docs):
    """Each child world's device Allreduce on its COMM_WORLD (cid 0, as
    its parents') ran bitwise on its own plane, led by its first world
    rank, while the parents' COMM_WORLD arenas were mapped: at that
    moment the cid-0 files of both worlds stood side by side, each named
    by its owner's world rank. The launcher then swept every file of the
    job (the children's among them)."""
    import re

    def owners(files):
        return {int(re.search(r"_w(\d+)", f).group(1)) for f in files
                if "_c0_" in f}

    p0 = docs[0][0]
    assert p0["parent_device"] == [3.0, True]
    assert owners(p0["parent_arenas"]) == {0, 1}
    for key, offset, n in (("allreduce", 2, 3), ("merge", 5, 2),
                           ("multiple", 7, 3)):
        for c in _children(p0, key):
            dev, leader, ok, files = c["device"]
            assert (dev, leader, ok) == ("cpu", offset, True)
            assert {0, 1} | set(range(offset, offset + n)) \
                <= owners(files), files
    assert _leftover[2] == []


def test_spawned_child_init_raises_without_the_card(tmp_path):
    """A spawned child (a world offset, a parent port) with the device
    plane on the cuda platform and no GPU: Init raises ERR_INTERN, as a
    parent's does; nothing falls back to the CPU."""
    import torch

    from ompi_tpu_torch.runtime import kvstore

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal needs none")
    store = kvstore.Store().start()
    try:
        env = port_launcher.build_env(5, 1, store.addr, "childtest",
                                      {"device_plane": "on"},
                                      local_rank=0, local_size=1)
        env.update(OMPI_TPU_WORLD_OFFSET="5", PYTHONPATH=ROOT,
                   OMPI_TPU_PARENT_PORT="spawn:childtest:5",
                   OMPI_TPU_SHM_DIR=str(tmp_path))
        code = textwrap.dedent('''
            from ompi_tpu_torch import errors, mpi
            from ompi_tpu_torch.runtime import rte
            try:
                mpi.Init()
                print(None)
            except errors.MPIError as e:
                print(e.error_class, rte.world_offset, list(rte.world_ranks()))
        ''')
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=120)
    finally:
        store.stop()
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [str(errors.ERR_INTERN), "5", "[5]"]


_MPMD = textwrap.dedent('''
    import sys
    import numpy as np
    from ompi_tpu_torch import dpm, mpi
    comm = mpi.Init()
    role = sys.argv[1]
    tot = np.zeros(1, np.int64)
    comm.Allreduce(np.array([1], np.int64), tot)
    assert tot[0] == comm.size == 3
    apps = comm.allgather((dpm.appnum(), role))
    assert sorted(set(apps)) == [(0, "one"), (1, "two")], apps
    assert comm.Get_attr(mpi.APPNUM) == dpm.appnum()
    mpi.Finalize()
''')


def test_tpurun_mpmd_colon_and_appfile(tmp_path):
    """tests/test_spawn.py's case on the port's launcher: a two-binary
    MPMD job wires one world across app contexts, through the colon
    syntax and through an ``--app`` file."""
    prog = tmp_path / "mpmd.py"
    prog.write_text(_MPMD)
    appfile = tmp_path / "appfile"
    appfile.write_text(f"# two contexts, one world\n"
                       f"-n 1 {prog} one\n"
                       f"-n 2 {prog} two\n")
    for args in (["-n", "1", str(prog), "one", ":", "-n", "2", str(prog),
                  "two"],
                 ["--app", str(appfile)]):
        r = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
             "--timeout", "120", "--mca", "device_plane_platform", "cpu"]
            + args, cwd=ROOT, capture_output=True, text=True, timeout=150)
        assert r.returncode == 0, (r.stdout, r.stderr)
