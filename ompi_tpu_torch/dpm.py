"""Dynamic process management — MPI_Comm_spawn / MPI_Comm_get_parent.

The port's copy of ``ompi_tpu.dpm`` (reference: ompi/dpm/dpm.c, spawn at
:1639 through PMIx_Spawn, connect at :386: the runtime starts new
processes, wires them into the existing transport universe and hands
back a parent <-> children intercommunicator).

- Starting: the spawn root forks the children itself (the launcher plays
  the daemon; there is no PRRTE to ask).
- Naming: the children join the same store and job id but take a fresh
  block of world ranks from the store's ``ww:<jobid>`` watermark (the
  launcher seeds it with its own world size), so every modex key, sm
  ring, fence and device arena stays apart across worlds
  (``rte.world_offset``).
- Wiring: btl/tcp dials any world rank lazily through the modex, which
  carries the parent <-> child traffic; the children's sm rings come up
  within their own block.
- Rendezvous: the children's COMM_WORLD spans their block; the parents
  accept and the children connect on a store port
  (:mod:`ompi_tpu_torch.comm.intercomm`), which gives the
  intercommunicator.
- The children inherit the parent's environment, its MCA settings
  among them (``mca`` adds to them): a child under ``device_plane on``
  brings up a device plane of its own, led by its world's first rank.

The launcher does not watch spawned children: :func:`spawn_handles`
gives their Popen objects, :func:`wait_children` joins them, and an
exit handler reaps any left running. They share the job id, so the
launcher's sweep removes their shared-memory files with the job's.
"""

from __future__ import annotations

import atexit
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

from ompi_tpu_torch.core import output, pvar
from ompi_tpu_torch.runtime import launcher as launcher_mod, rte

_out = output.stream("dpm")

_children: List[subprocess.Popen] = []
_atexit_installed = False
_parent = None


def _child_env(world_rank: int, i: int, maxprocs: int, offset: int,
               port: str, mca: Optional[Dict[str, str]]) -> Dict[str, str]:
    env = launcher_mod.build_env(world_rank, maxprocs, rte.client().addr,
                                 rte.jobid, mca, local_rank=i,
                                 local_size=maxprocs)
    env["OMPI_TPU_WORLD_OFFSET"] = str(offset)
    env["OMPI_TPU_PARENT_PORT"] = port
    return env


def _info_mca(info, mca: Optional[Dict[str, str]]):
    """``mca`` plus an info's ``mca_<name>`` keys (the reference forwards
    spawn info keys to PRRTE the same way)."""
    if info is None:
        return mca
    from ompi_tpu_torch.info import as_info

    out = dict(mca or {})
    for k, v in as_info(info).items():
        if k.startswith("mca_"):
            out.setdefault(k[4:], v)
    return out


def comm_spawn(command: str, args: Sequence[str] = (), maxprocs: int = 1,
               comm=None, root: int = 0,
               mca: Optional[Dict[str, str]] = None, info=None):
    """MPI_Comm_spawn: start ``maxprocs`` copies of ``command`` (a python
    script, or an executable) with ``args`` and return the parent <->
    children intercommunicator. Collective over ``comm`` (COMM_WORLD by
    default)."""
    return comm_spawn_multiple([(command, args, maxprocs)], comm, root,
                               _info_mca(info, mca))


def comm_spawn_multiple(specs: Sequence, comm=None, root: int = 0,
                        mca: Optional[Dict[str, str]] = None, info=None):
    """MPI_Comm_spawn_multiple (ompi/mpi/c/comm_spawn_multiple.c): several
    app contexts, ``specs`` a list of ``(command, args, maxprocs)``, whose
    processes form one child COMM_WORLD (app k's ranks follow app k-1's);
    a child reads its context's index with :func:`appnum`."""
    from ompi_tpu_torch.comm import Group, alloc_cid
    from ompi_tpu_torch.comm.intercomm import (Intercommunicator,
                                               comm_accept, open_port)
    from ompi_tpu_torch.runtime import state

    global _atexit_installed
    mca = _info_mca(info, mca)
    if comm is None:
        comm = state.world()
    specs = [(c, list(a), int(n)) for c, a, n in specs]
    total = sum(n for _, _, n in specs)
    if total == 0:
        # MPI-4.1 section 11.8.2: an empty remote group, no rendezvous
        cid = comm.bcast(alloc_cid() if comm.rank == root else None,
                         root=root)
        return Intercommunicator(Group(comm.group.ranks), Group([]), cid)
    port = None
    if comm.rank == root:
        end = rte.client().inc(f"ww:{rte.jobid}", total)
        offset = end - total
        port = open_port(f"spawn:{rte.jobid}:{offset}")
        idx = 0
        for app, (command, args, maxprocs) in enumerate(specs):
            argv = [command, *map(str, args)]
            if command.endswith(".py"):
                argv = [sys.executable] + argv
            for _ in range(maxprocs):
                env = _child_env(offset + idx, idx, total, offset, port, mca)
                env["OMPI_TPU_APPNUM"] = str(app)
                _children.append(subprocess.Popen(argv, env=env))
                idx += 1
        if not _atexit_installed:
            atexit.register(_reap_children)
            _atexit_installed = True
        pvar.record("spawned_procs", total)
        _out.verbose(2, "spawned %d procs (%d apps) at world offset %d",
                     total, len(specs), offset)
    port = comm.bcast(port, root=root)
    return comm_accept(port, comm, root=root)


def appnum() -> Optional[int]:
    """MPI_APPNUM: this process's app-context index, or None outside a
    multi-app job."""
    v = os.environ.get("OMPI_TPU_APPNUM")
    return None if v is None else int(v)


def get_parent():
    """MPI_Comm_get_parent: the intercommunicator to the spawning group,
    or None in a process that was not spawned. The same handle on every
    call (the connect rendezvous runs once)."""
    global _parent
    if _parent is not None:
        return _parent
    from ompi_tpu_torch.comm.intercomm import comm_connect
    from ompi_tpu_torch.runtime import state

    port = os.environ.get("OMPI_TPU_PARENT_PORT")
    if not port:
        return None
    _parent = comm_connect(port, state.world(), root=0)
    return _parent


def spawn_handles() -> List[subprocess.Popen]:
    """The Popen handles of every child this process spawned."""
    return list(_children)


def wait_children(timeout: Optional[float] = None) -> List[int]:
    """Join every spawned child; returns their exit codes."""
    return [p.wait(timeout=timeout) for p in _children]


def _reap_children() -> None:
    launcher_mod.reap(_children)
