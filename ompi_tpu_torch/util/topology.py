"""Host topology — the hwloc-glue analog for mapping/binding.

The port's copy of ``ompi_tpu.util.topology`` (reference:
opal/mca/hwloc feeds PRRTE's ``--map-by``/``--bind-to`` policies; ranks
round-robin over cores/packages/NUMA nodes and each rank's CPU set is
the object it mapped to). The topology reads straight from Linux sysfs
(no external library), with an injectable root so the policies are
testable on any machine against synthetic topologies. The launcher
reads it once per launch (``--bind-to``) and each rank applies its set
in ``runtime/rte.init``.

Objects: *core* = set of SMT sibling CPUs sharing a physical core;
*package* (socket) = CPUs sharing physical_package_id; *numa* = CPUs
of /sys/devices/system/node/node*. Policies return, per rank, the
CPU LIST to bind (sched_setaffinity accepts sets, so a socket-bound
rank floats over the socket's CPUs — PRRTE's bind-to-socket
behavior).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

SYS_CPU = "/sys/devices/system/cpu"
SYS_NODE = "/sys/devices/system/node"


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as fh:
            return fh.read().strip()
    except OSError:
        return None


def parse_cpulist(text: str) -> List[int]:
    """sysfs cpulist format: ``0-3,8,10-11``."""
    out: List[int] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


class Topology:
    """Cores / packages / NUMA nodes of a host (or a synthetic
    sysfs tree via ``root``), restricted to the allowed CPU set."""

    def __init__(self, root: Optional[str] = None,
                 allowed: Optional[Sequence[int]] = None) -> None:
        self._cpu_root = os.path.join(root, "cpu") if root else SYS_CPU
        self._node_root = (os.path.join(root, "node") if root
                           else SYS_NODE)
        if allowed is None:
            try:
                allowed = sorted(os.sched_getaffinity(0))
            except (AttributeError, OSError):
                allowed = list(range(os.cpu_count() or 1))
        self.cpus = sorted(allowed)
        self.cores = self._group_cores()
        self.packages = self._group_by(self._package_of)
        self.numa_nodes = self._group_numa() or [list(self.cpus)]

    # -- sysfs walks -------------------------------------------------------
    def _topo_attr(self, cpu: int, name: str) -> Optional[str]:
        return _read(os.path.join(self._cpu_root, f"cpu{cpu}",
                                  "topology", name))

    def _core_key(self, cpu: int):
        sib = self._topo_attr(cpu, "thread_siblings_list")
        if sib is not None:
            return tuple(c for c in parse_cpulist(sib)
                         if c in set(self.cpus))
        return (cpu,)  # no sysfs: every CPU its own core

    def _package_of(self, cpu: int):
        pkg = self._topo_attr(cpu, "physical_package_id")
        return pkg if pkg is not None else "0"

    def _group_cores(self) -> List[List[int]]:
        seen = {}
        for c in self.cpus:
            key = self._core_key(c)
            if key not in seen:
                seen[key] = [x for x in (key if key else (c,))]
        return [sorted(v) for v in seen.values()]

    def _group_by(self, key_fn) -> List[List[int]]:
        groups: Dict[object, List[int]] = {}
        for c in self.cpus:
            groups.setdefault(key_fn(c), []).append(c)

        def order(kv):  # numeric id order (string sort misorders >=10)
            k = kv[0]
            try:
                return (0, int(k))
            except (TypeError, ValueError):
                return (1, str(k))

        return [sorted(v) for _, v in sorted(groups.items(),
                                             key=order)]

    def _group_numa(self) -> List[List[int]]:
        out = []
        try:  # numeric order: node10 must follow node9, not node1
            nodes = sorted((d for d in os.listdir(self._node_root)
                            if d.startswith("node")
                            and d[4:].isdigit()),
                           key=lambda d: int(d[4:]))
        except OSError:
            return []
        allowed = set(self.cpus)
        for nd in nodes:
            text = _read(os.path.join(self._node_root, nd, "cpulist"))
            if text is None:
                continue
            cpus = [c for c in parse_cpulist(text) if c in allowed]
            if cpus:
                out.append(sorted(cpus))
        return out

    # -- mapping policies (PRRTE --map-by/--bind-to) ----------------------
    def cpuset_for(self, local_rank: int, policy: str) -> List[int]:
        """The CPU list rank ``local_rank`` binds under ``policy``
        (round-robin over the policy's objects — the rmaps
        round-robin mapper)."""
        if policy in ("none", ""):
            return list(self.cpus)
        objs = {"core": self.cores,
                "socket": self.packages,
                "package": self.packages,
                "numa": self.numa_nodes}.get(policy)
        if not objs:
            raise ValueError(f"unknown map/bind policy {policy!r} "
                             "(core|socket|numa|none)")
        return objs[local_rank % len(objs)]


def describe(topo: Topology) -> str:
    """One-line topology summary (hook for hook/comm_method-style
    dumps)."""
    return (f"{len(topo.cpus)} cpus / {len(topo.cores)} cores / "
            f"{len(topo.packages)} packages / "
            f"{len(topo.numa_nodes)} numa nodes")
