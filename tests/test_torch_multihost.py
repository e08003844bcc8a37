"""The port's multi-host launch (``runtime/launcher.py``: ``--host`` /
``--hostfile``, one daemon per host, the ``local`` and ``ssh`` agents,
MPMD app contexts over hosts) against the JAX package's: the
counterparts of ``tests/test_multihost.py``'s 9 cases, plus the
shared-memory names of two fake hosts and the daemon's sweep.

Two fake hosts on this machine (distinct host names and loopback bind
addresses, the reference's own oversubscribed-localhost strategy). In
this process, on the same inputs as the reference: the host-list and
hostfile parsers (equal answers from both packages), the MPMD capacity
error, the ssh agent's command line (no ssh here: the unit case holds
it), and the daemon's sweep of its own ranks' files. Launcher jobs of the
port, each asserting what the reference's cases assert:

- one 2 x 2 job under the device plane on the CPU platform with
  ``coll_device_hier 2``: the host collectives and cross-host
  point-to-point over btl/tcp on the per-host address (btl/sm within a
  host, single copy only within a host), coll/han's hostname split,
  the device Allreduce / Allgatherv / Iallreduce across the hosts on
  coll/device's (2, 2) grid with nothing staged, and the arena files:
  no name shared between the hosts' ranks, none left behind;
- one job under ``--mca ft 1``: rank 3 on host B SIGKILLs itself and
  the survivors on both hosts shrink and go on;
- one MPMD job: app 0 (1 rank) on host A, app 1 (3 ranks) across both,
  ``MPI_APPNUM`` right everywhere, cross-app cross-host messages.
"""

import json
import os
import textwrap

import pytest

from ompi_tpu.runtime import launcher as R_launcher
from ompi_tpu_torch.runtime import launcher as P_launcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TWO_HOSTS = [P_launcher.HostSpec("fakeA", 2, "127.0.0.2"),
             P_launcher.HostSpec("fakeB", 2, "127.0.0.3")]
TIMEOUT = 120


def test_hostfile_parsing(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# cluster\n"
                  "node0 slots=2 addr=10.0.0.1\n"
                  "node1 slots=4\n"
                  "node2\n")
    got = P_launcher.parse_hostfile(str(hf))
    assert [tuple(h) for h in got] == \
        [tuple(h) for h in R_launcher.parse_hostfile(str(hf))]
    assert got == [P_launcher.HostSpec("node0", 2, "10.0.0.1"),
                   P_launcher.HostSpec("node1", 4, None),
                   P_launcher.HostSpec("node2", 1, None)]


@pytest.mark.parametrize("spec", ["a:2,b:2:127.0.0.3,c", "x", "h1:3,,h2:1"])
def test_host_list_parsing(spec):
    assert [tuple(h) for h in P_launcher.parse_host_list(spec)] == \
        [tuple(h) for h in R_launcher.parse_host_list(spec)]


def test_multihost_mpmd_capacity_error():
    for L in (P_launcher, R_launcher):
        with pytest.raises(ValueError, match="slots"):
            L.launch_hosts(None, [L.HostSpec("fakeA", 2, "127.0.0.2"),
                                  L.HostSpec("fakeB", 2, "127.0.0.3")],
                           agent="local",
                           apps=[(["x.py"], 3), (["y.py"], 2)])


def test_ssh_agent_command_line():
    """The ssh agent runs each host's daemon as ``ssh -o BatchMode=yes
    host 'cd <cwd> && env PYTHONPATH=<root> <daemon command>'`` (the
    reference's launch_hosts line); the daemon command carries the
    store, the job, the host's rank block and address, and the job's
    MCA settings."""
    h = P_launcher.HostSpec("node1", 2, "10.0.0.2")
    cmd = P_launcher.daemon_command("10.0.0.1:5000", "job1", h, 2, 2, 4,
                                    {"ft": "1"}, 30.0, "core",
                                    ["prog.py", "--x"], None)
    assert cmd[1:] == [
        "-m", "ompi_tpu_torch.runtime.launcher", "--daemon", "--store",
        "10.0.0.1:5000", "--jobid", "job1", "--host-name", "node1",
        "--rank-base", "2", "--local-n", "2", "--world-size", "4",
        "--bind-addr", "10.0.0.2", "--bind-to", "core", "--timeout",
        "30.0", "--mca", "ft", "1", "--", "prog.py", "--x"]
    ssh = P_launcher.ssh_command("node1", cmd)
    assert ssh[:4] == ["ssh", "-o", "BatchMode=yes", "node1"]
    assert ssh[4].startswith(f"cd {os.getcwd()} && env PYTHONPATH={ROOT} ")
    assert ssh[4].endswith(" -- prog.py --x")
    # the daemon parses its own command back
    seen = {}

    def fake(ns):
        seen.update(vars(ns))
        return 0

    orig = P_launcher.run_daemon
    P_launcher.run_daemon = fake
    try:
        assert P_launcher.main(cmd[3:]) == 0
    finally:
        P_launcher.run_daemon = orig
    assert (seen["rank_base"], seen["local_n"], seen["world_size"],
            seen["host_name"], seen["bind_addr"], seen["bind_to"],
            seen["mca"], seen["command"]) == \
        (2, 2, 4, "node1", "10.0.0.2", "core", [["ft", "1"]],
         ["--", "prog.py", "--x"])


def test_daemon_sweeps_only_its_own_ranks(tmp_path, monkeypatch):
    """A daemon's sweep removes its own ranks' arenas, hop counters,
    rings and heaps and its own processes' IPC files, never another
    host's; the head's sweep removes the rest."""
    monkeypatch.setenv("OMPI_TPU_SHM_DIR", str(tmp_path))
    pre = P_launcher.SHM_PREFIX + "job1_"
    names = ["c0_rs_w0", "c0_rs_w0_flags", "c3_pull_w1", "sm_0to1",
             "sm_1to0", "shmem_1", "ipc_111_ab12cd34",
             "c0_rs_w2", "c0_rs_w2_flags", "sm_2to3", "shmem_3",
             "ipc_222_ef56ab78", "c1_perm_w3"]
    for n in names:
        (tmp_path / (pre + n)).write_text("")
    (tmp_path / (P_launcher.SHM_PREFIX + "job2_c0_rs_w0")).write_text("")
    P_launcher.cleanup_shm("job1", ranks=range(0, 2), pids=[111])
    left = sorted(p.name[len(pre):] for p in tmp_path.iterdir()
                  if p.name.startswith(pre))
    assert left == sorted(["c0_rs_w2", "c0_rs_w2_flags", "sm_2to3",
                           "shmem_3", "ipc_222_ef56ab78", "c1_perm_w3"])
    P_launcher.cleanup_shm("job1")
    assert [p.name for p in tmp_path.iterdir()] == \
        [P_launcher.SHM_PREFIX + "job2_c0_rs_w0"]


# ---------------------------------------------------------------------------
# launcher jobs

_PROG = textwrap.dedent('''
    import glob, json, os
    import numpy as np
    import torch
    from ompi_tpu_torch import mpi, pml as pml_mod, smsc
    from ompi_tpu_torch.coll import device as cd
    from ompi_tpu_torch.core import pvar
    from ompi_tpu_torch.runtime import launcher, rte
    out_dir = {out!r}
    comm = mpi.Init()
    rank, size = comm.rank, comm.size
    doc = {{"size": size, "name": mpi.Get_processor_name(),
            "bind_addr": os.environ.get("OMPI_TPU_BIND_ADDR")}}
    local = comm.split_type("shared")
    doc["local"] = [local.size, local.rank]

    # collectives spanning the host boundary
    out = np.zeros(8, dtype=np.float32)
    comm.Allreduce(np.full(8, rank + 1, np.float32), out)
    doc["allreduce"] = out.tolist()
    buf = (np.arange(64, dtype=np.int32) if rank == 0
           else np.zeros(64, np.int32))
    comm.Bcast(buf, root=0)
    doc["bcast"] = bool((buf == np.arange(64)).all())

    # cross-host p2p (eager and rendezvous sizes)
    peer = (rank + 2) % 4
    small = np.full(16, rank, np.int32)
    big = np.full(1 << 17, rank, np.int32)
    rs, rb = np.zeros_like(small), np.zeros_like(big)
    reqs = [comm.Isend(small, dest=peer, tag=1),
            comm.Isend(big, dest=peer, tag=2),
            comm.Irecv(rs, source=peer, tag=1),
            comm.Irecv(rb, source=peer, tag=2)]
    for r in reqs:
        r.wait()
    doc["p2p"] = bool((rs == peer).all() and (rb == peer).all())
    p = pml_mod.current()
    same = rank + 1 if rank % 2 == 0 else rank - 1
    doc["transports"] = [p.bml.endpoint(peer).NAME,
                         p.bml.endpoint(same).NAME]
    doc["smsc_cross"] = pvar.read("smsc_single_copies")

    # coll/han's hostname split: 2 leaders, low comms of 2
    o64 = np.zeros(32, dtype=np.float64)
    comm.Allreduce(np.full(32, float(rank + 1)), o64)
    lv = comm._han_levels
    doc["han"] = [bool((o64 == 10.0).all()), pvar.read("han_allreduce") >= 1,
                  lv.low.size, (lv.up is None) == (lv.low.rank != 0)]

    # single copy still fires within a host
    doc["smsc"] = None
    if smsc.available():
        big = np.full(1 << 18, rank, np.int64)
        got = np.zeros_like(big)
        if rank % 2 == 0:
            comm.Send(big, dest=same, tag=9)
        else:
            comm.Recv(got, source=same, tag=9)
            doc["smsc"] = [bool((got == same).all()),
                           pvar.read("smsc_single_copies") >= 1]

    # the device plane across the hosts: coll/device's (2, 2) grid
    r = comm.Allreduce(torch.full((8,), float(rank + 1)))
    counts = [1, 2, 1, 2]
    packed = comm.Allgatherv(torch.full((counts[rank],), float(rank)),
                             None, counts)
    req = comm.Iallreduce(torch.ones(4))
    req.wait()
    g = cd.grid_of(comm)
    doc["device"] = [float(r[0]), packed.tolist(),
                     float(req.array[0]),
                     pvar.read("coll_accelerator_staged"),
                     [g.n_dcn, g.n_ici] if g is not None else None]
    # the arena files: each rank names the ones its world rank made
    mine = sorted(os.path.basename(f) for f in glob.glob(os.path.join(
        launcher.shm_dir(), f"{{launcher.SHM_PREFIX}}{{rte.jobid}}_c*"))
        if f.endswith(f"_w{{rank}}") or f.endswith(f"_w{{rank}}_flags"))
    doc["arenas"] = mine
    doc["jobid"] = rte.jobid
    comm.Barrier()
    with open(os.path.join(out_dir, f"doc_r{{rank}}.json"), "w") as fh:
        json.dump(doc, fh)
    mpi.Finalize()
''')


def _hosts_job(tmp_path, src: str, mca: dict, apps=None) -> int:
    prog = tmp_path / "prog.py"
    prog.write_text(src)
    return P_launcher.launch_hosts(None if apps else [str(prog)],
                                   TWO_HOSTS, mca=mca, timeout=TIMEOUT,
                                   agent="local", apps=apps)


@pytest.fixture(scope="module")
def main_job(tmp_path_factory):
    """The 2 x 2 job's per-rank docs and its shm dir."""
    d = tmp_path_factory.mktemp("multihost")
    shm = d / "shm"
    shm.mkdir()
    old = os.environ.get("OMPI_TPU_SHM_DIR")
    os.environ["OMPI_TPU_SHM_DIR"] = str(shm)
    try:
        rc = _hosts_job(d, _PROG.format(out=str(d)),
                        {"device_plane": "on", "device_plane_platform": "cpu",
                         "coll_device_hier": "2", "coll_han_split": "auto"})
    finally:
        if old is None:
            os.environ.pop("OMPI_TPU_SHM_DIR")
        else:
            os.environ["OMPI_TPU_SHM_DIR"] = old
    assert rc == 0, rc
    return [json.loads((d / f"doc_r{r}.json").read_text())
            for r in range(4)], shm


def test_multihost_collectives_and_p2p(main_job):
    """2x2 ranks across two fake hosts: host names and bind addresses,
    the shared split, Allreduce / Bcast / cross-host p2p, tcp across and
    sm within a host, no single copy across hosts."""
    docs, _ = main_job
    for r, d in enumerate(docs):
        assert d["size"] == 4
        assert d["name"] == ("fakeA" if r < 2 else "fakeB"), (r, d)
        assert d["bind_addr"] == ("127.0.0.2" if r < 2 else "127.0.0.3")
        assert d["local"][0] == 2
        assert d["allreduce"] == [10.0] * 8 and d["bcast"] and d["p2p"]
        assert d["transports"] == ["tcp", "sm"], d["transports"]
        assert d["smsc_cross"] == 0, \
            "single-copy must disqualify itself across hosts"


def test_multihost_han_auto_split(main_job):
    for d in main_job[0]:
        assert d["han"] == [True, True, 2, True], d["han"]


def test_multihost_smsc_same_host_still_fires(main_job):
    for r, d in enumerate(main_job[0]):
        if d["smsc"] is not None or r % 2:  # odd ranks receive
            assert d["smsc"] in (None, [True, True]), d["smsc"]


def test_multihost_device_plane_collectives(main_job):
    """The device plane across the fake hosts: coll/device on the (2, 2)
    grid of coll_device_hier 2, nothing staged through the host."""
    exp = [0.0, 1.0, 1.0, 2.0, 3.0, 3.0]
    for d in main_job[0]:
        got, packed, ireduce, staged, grid = d["device"]
        assert got == 10.0 and packed == exp and ireduce == 4.0
        assert staged == 0 and grid == [2, 2]


def test_multihost_arena_names_apart_and_swept(main_job):
    """Arena files are named by world rank and job: the ranks of the two
    hosts made disjoint sets of names, and the daemons (each its own
    ranks') and the head left none behind."""
    docs, shm = main_job
    by_host = {"fakeA": set(), "fakeB": set()}
    for d in docs:
        assert d["arenas"], d
        by_host[d["name"]] |= set(d["arenas"])
    assert by_host["fakeA"] and not by_host["fakeA"] & by_host["fakeB"]
    assert len({d["jobid"] for d in docs}) == 1
    assert list(shm.iterdir()) == []


_FT_PROG = textwrap.dedent('''
    import os, signal, time
    import numpy as np
    from ompi_tpu_torch import mpi
    comm = mpi.Init()
    rank = comm.rank
    comm.Barrier()
    if rank == 3:
        os.kill(os.getpid(), signal.SIGKILL)
    deadline = time.monotonic() + 20
    while 3 not in comm.get_failed():
        time.sleep(0.02)
        assert time.monotonic() < deadline, "failure never detected"
    sub = comm.shrink()
    assert sub.size == 3
    out = np.zeros(4, dtype=np.float32)
    sub.Allreduce(np.full(4, 1.0, np.float32), out)
    assert (out == 3).all()
    mpi.Finalize()
''')


def test_multihost_ft_cross_host_kill(tmp_path):
    """FT across daemons: a SIGKILLed rank on host B is detected and the
    survivors (host A's among them) shrink and go on."""
    assert _hosts_job(tmp_path, _FT_PROG,
                      {"ft": "1", "device_plane_platform": "cpu"}) == 0


_COMMON = '''
local = comm.split_type("shared")
assert local.size == 2, (comm.rank, local.size)
out = np.zeros(4, np.float32)
comm.Allreduce(np.full(4, comm.rank + 1, np.float32), out)
assert (out == 10).all(), out
mpi.Finalize()
'''


def test_multihost_mpmd_app_slicing(tmp_path):
    """Multi-host MPMD: app 0 (1 rank) on host A, app 1 (3 ranks)
    spanning both hosts — one world, MPI_APPNUM right everywhere,
    cross-host cross-app p2p, the per-host shared split intact."""
    a = tmp_path / "app_a.py"
    a.write_text(textwrap.dedent('''
        import numpy as np
        from ompi_tpu_torch import mpi, dpm
        comm = mpi.Init()
        assert comm.rank == 0 and comm.size == 4
        assert dpm.appnum() == 0, dpm.appnum()
        assert comm.Get_attr(mpi.APPNUM) == 0
        assert mpi.Get_processor_name() == "fakeA"
        comm.send(("from-app0", comm.rank), dest=3, tag=9)
        assert comm.recv(source=3, tag=10) == ("from-app1", 3)
    ''') + _COMMON)
    b = tmp_path / "app_b.py"
    b.write_text(textwrap.dedent('''
        import numpy as np
        from ompi_tpu_torch import mpi, dpm
        comm = mpi.Init()
        assert comm.rank in (1, 2, 3) and comm.size == 4
        assert dpm.appnum() == 1, dpm.appnum()
        assert comm.Get_attr(mpi.APPNUM) == 1
        host = mpi.Get_processor_name()
        assert host == ("fakeA" if comm.rank == 1 else "fakeB"), host
        if comm.rank == 3:
            assert comm.recv(source=0, tag=9) == ("from-app0", 0)
            comm.send(("from-app1", comm.rank), dest=0, tag=10)
    ''') + _COMMON)
    rc = P_launcher.launch_hosts(
        None, TWO_HOSTS, mca={"device_plane_platform": "cpu"},
        timeout=TIMEOUT, agent="local", apps=[([str(a)], 1), ([str(b)], 3)])
    assert rc == 0, rc
