"""The port's host topology (``util/topology.py``) and the launcher's
``--bind-to`` against the JAX package's: the counterparts of
``tests/test_memhooks_topology.py``'s topology half
(``test_topology_policies_on_synthetic_sysfs``, ``test_parse_cpulist``,
``test_bind_to_core_end_to_end``).

The reference's topology module imports no jax, so both run in this
process on the same synthetic sysfs trees, and every answer must be equal:
``parse_cpulist`` on the same strings, ``describe``, and each policy's CPU
set for every local rank, over a full and a restricted affinity mask. The
end-to-end case launches two ranks of the port under ``--bind-to core``
and ``--bind-to socket``; each rank checks that the launcher exported a
CPU set and that its affinity is that set.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from ompi_tpu.util import topology as R_topo
from ompi_tpu_torch.util import topology as P_topo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: synthetic trees: (packages, cores a package, SMT threads a core)
TREES = [(2, 2, 2), (1, 4, 1), (3, 2, 2), (2, 3, 4)]

CPULISTS = ["0-3,8,10-11", "", "5", "0,2,4-6", " 1 , 3-4 ,", "12-15,0-1"]


def fake_sysfs(root, n_pkgs, cores_per_pkg, smt):
    """Synthetic sysfs (the reference test's tree): n_pkgs x cores_per_pkg
    cores x smt threads, one NUMA node per package."""
    cpuroot = root / "cpu"
    for pkg in range(n_pkgs):
        for core in range(cores_per_pkg):
            sibs = [pkg * cores_per_pkg * smt + core * smt + t
                    for t in range(smt)]
            for t in sibs:
                d = cpuroot / f"cpu{t}" / "topology"
                d.mkdir(parents=True, exist_ok=True)
                (d / "physical_package_id").write_text(str(pkg))
                (d / "thread_siblings_list").write_text(
                    ",".join(map(str, sibs)))
    for pkg in range(n_pkgs):
        nd = root / "node" / f"node{pkg}"
        nd.mkdir(parents=True, exist_ok=True)
        lo = pkg * cores_per_pkg * smt
        (nd / "cpulist").write_text(f"{lo}-{lo + cores_per_pkg * smt - 1}")
    return str(root)


@pytest.mark.parametrize("text", CPULISTS)
def test_parse_cpulist(text):
    assert P_topo.parse_cpulist(text) == R_topo.parse_cpulist(text)
    assert P_topo.parse_cpulist("0-3,8,10-11") == [0, 1, 2, 3, 8, 10, 11]


def _answers(T, root, allowed):
    topo = T.Topology(root=root, allowed=allowed)
    out = {"describe": T.describe(topo), "cores": topo.cores,
           "packages": topo.packages, "numa": topo.numa_nodes}
    for policy in ("core", "socket", "package", "numa", "none"):
        out[policy] = [topo.cpuset_for(r, policy) for r in range(9)]
    with pytest.raises(ValueError):
        topo.cpuset_for(0, "bogus")
    return out


@pytest.mark.parametrize("tree", TREES, ids=lambda t: "x".join(map(str, t)))
def test_topology_policies_on_synthetic_sysfs(tmp_path, tree):
    root = fake_sysfs(tmp_path, *tree)
    ncpu = tree[0] * tree[1] * tree[2]
    for allowed in (range(ncpu), [c for c in range(ncpu) if c % 3 != 1]):
        got = _answers(P_topo, root, list(allowed))
        assert got == _answers(R_topo, root, list(allowed))
    if tree == (2, 2, 2):  # the reference's own expectations
        topo = P_topo.Topology(root=root, allowed=range(8))
        assert P_topo.describe(topo) == \
            "8 cpus / 4 cores / 2 packages / 2 numa nodes"
        assert topo.cpuset_for(0, "core") == [0, 1]
        assert topo.cpuset_for(4, "core") == [0, 1]
        assert topo.cpuset_for(1, "socket") == [4, 5, 6, 7]
        topo2 = P_topo.Topology(root=root, allowed=[0, 1, 4])
        assert topo2.cpuset_for(0, "socket") == [0, 1]
        assert topo2.cpuset_for(1, "socket") == [4]


def test_topology_without_sysfs(tmp_path):
    """No sysfs under the root: every CPU its own core, one package, one
    NUMA node — in both packages."""
    for T in (P_topo, R_topo):
        topo = T.Topology(root=str(tmp_path), allowed=[0, 1, 2])
        assert topo.cores == [[0], [1], [2]]
        assert topo.packages == [[0, 1, 2]]
        assert topo.numa_nodes == [[0, 1, 2]]


_BIND_PROG = textwrap.dedent("""
    import os
    from ompi_tpu_torch import mpi
    comm = mpi.Init()
    cpus = os.environ.get("OMPI_TPU_BIND_CPUS")
    assert cpus, "launcher must export a cpuset"
    assert os.sched_getaffinity(0) == {int(c) for c in cpus.split(",")}
    mpi.Finalize()
""")


@pytest.mark.parametrize("policy", ["core", "socket"])
def test_bind_to_end_to_end(tmp_path, policy):
    """--bind-to works end to end on this host: every rank binds its
    round-robin object's CPU set (rte.init applies it)."""
    prog = tmp_path / "bind_check.py"
    prog.write_text(_BIND_PROG)
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n", "2",
         "--bind-to", policy, "--timeout", "90",
         "--mca", "device_plane_platform", "cpu", str(prog)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
