"""The mpirun equivalent for the PyTorch port.

Reference: ompi/tools/mpirun/main.c:32-180 execs prterun, whose PRRTE
daemons fork/exec the ranks per host (``ompi_tpu/runtime/launcher.py``).
Here:

* single host (the default): the launcher itself plays the daemon — it
  serves the rendezvous store in-process and forks the rank processes
  with the environment contract of :mod:`ompi_tpu_torch.runtime.rte`;
* multi-host (``--host`` / ``--hostfile``): the launcher starts one
  *daemon* per host (the prted analog, ``launcher --daemon``) through a
  launch agent (``ssh`` for real remote hosts; ``local`` forks the
  daemon on this machine — the fake-multi-host lane, where each "host"
  gets its own hostname and loopback address). Each daemon connects
  back to the store, forks its local rank block with its
  ``LOCAL_RANK`` / ``LOCAL_SIZE`` / hostname, supervises it, and sweeps
  its own ranks' shared-memory files at exit.

Usage:
    python -m ompi_tpu_torch.runtime.launcher -n 4 [--mca KEY VALUE]... prog.py ...
    python -m ompi_tpu_torch.runtime.launcher -n 4 --func pkg.mod:fn   # run fn()
    python -m ompi_tpu_torch.runtime.launcher --host a:2,b:2 prog.py   # 2x2 ranks
    python -m ompi_tpu_torch.runtime.launcher --hostfile hosts prog.py
    python -m ompi_tpu_torch.runtime.launcher -n 1 a.py : -n 3 b.py    # MPMD
    python -m ompi_tpu_torch.runtime.launcher --app appfile            # MPMD
    python -m ompi_tpu_torch.runtime.launcher -n 4 --bind-to core prog.py

Host specs: ``name[:slots[:addr]]`` — addr is the IP the host's btl/tcp
binds and publishes (daemons export it as ``OMPI_TPU_BIND_ADDR``).
Hostfile lines: ``name [slots=K] [addr=IP]`` (# comments). MPMD app
contexts (colon syntax or an appfile of ``[-n K] prog args`` lines)
share one world, app k's ranks after app k-1's; each rank reads its
context from ``MPI_APPNUM`` (``OMPI_TPU_APPNUM``). ``--bind-to
core|socket|numa`` gives each local rank a CPU set from
:mod:`ompi_tpu_torch.util.topology` (``OMPI_TPU_BIND_CPUS``), which
the rank applies at ``rte.init``.

Each rank learns its local rank (``OMPI_TPU_LOCAL_RANK``); the device
plane maps it to ``cuda:(local_rank % torch.cuda.device_count())``, so
on a one-card machine every rank shares ``cuda:0`` — the fake hosts'
ranks too, whose arenas then map through CUDA IPC as on one host. On a
real second machine (the ssh agent) an IPC import fails and raises:
nothing stages through the host.

Exit code: 0 if every rank exits 0; otherwise the first nonzero rank code.
On a rank crash the remaining ranks are terminated (mpirun behavior), and
a ``--timeout`` that passes kills every rank and returns 124. ``MPI_Abort``
(``rte.abort``) is such a crash: the aborting rank exits with its code,
ranks blocked in the store exit with the same code, the rest are
terminated, and the job exits with the code. Whatever way the job ends,
the launcher then removes the job's shared-memory files (btl/sm rings,
the device arenas and their hop counters, the shmem heaps, IPC files:
every ``ompi_tpu_torch_<jobid>_*`` under the shm dir); a daemon removes
only those of its own host's ranks.

FT mode (``--mca ft 1``, the ULFM model, reference ``launcher.py:200-210,
:538-590``): a rank killed by a signal is declared failed in the store
and the job goes on (runtime-level detection is the launcher daemon's
job, docs/features/ulfm.rst:260-262); a rank that exits nonzero still
fails the job, and so does a job whose every rank was killed (nothing
survived; across daemons, the head counts the daemons' clean exits).

When the job profiles (``--mca prof_enable 1`` or ``OMPI_TPU_PROF``) the
launcher enables its own phase ledger too (reference ``launcher.py:46-59``)
and attributes its wall to ``spawn`` and ``wait`` (:275-292, :379).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import signal
import subprocess
import sys
import time
import uuid
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

from ompi_tpu_torch.runtime import kvstore

#: prefix of every job-scoped shared-memory file (arenas, hop counters,
#: btl/sm rings)
SHM_PREFIX = "ompi_tpu_torch_"


class HostSpec(NamedTuple):
    name: str
    slots: int = 1
    addr: Optional[str] = None  # btl/tcp bind+publish address


def parse_host_list(spec: str) -> List[HostSpec]:
    """``h1:2,h2:2:127.0.0.3`` -> [HostSpec...]."""
    hosts = []
    for part in spec.split(","):
        if not part:
            continue
        bits = part.split(":")
        hosts.append(HostSpec(bits[0],
                              int(bits[1]) if len(bits) > 1 else 1,
                              bits[2] if len(bits) > 2 else None))
    return hosts


def parse_hostfile(path: str) -> List[HostSpec]:
    """mpirun-hostfile analog: ``name [slots=K] [addr=IP]`` per line."""
    hosts = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            fields = line.split()
            slots, addr = 1, None
            for f in fields[1:]:
                if f.startswith("slots="):
                    slots = int(f[6:])
                elif f.startswith("addr="):
                    addr = f[5:]
            hosts.append(HostSpec(fields[0], slots, addr))
    return hosts


def _topo_for(bind_to: str):
    """ONE topology read per launch (sysfs walks cost O(cpus) file
    opens — never per rank); None when not binding."""
    if bind_to in ("none", ""):
        return None
    try:
        from ompi_tpu_torch.util.topology import Topology

        return Topology()
    except Exception:  # noqa: BLE001 — binding is a hint; never fail
        return None


def _cpuset_for(local_rank: int, bind_to: str, topo) -> Optional[list]:
    """CPU set for a local rank under --bind-to core|socket|numa (the
    PRRTE map/bind analog: ranks round-robin over the policy's topology
    objects). The rank applies the set via sched_setaffinity at
    rte.init."""
    if topo is None:
        return None
    try:
        return topo.cpuset_for(local_rank, bind_to)
    except Exception:  # noqa: BLE001
        return None


def build_env(rank: int, size: int, store_addr, jobid: str,
              mca: Optional[Dict[str, str]] = None,
              base_env: Optional[Dict[str, str]] = None,
              local_rank: Optional[int] = None,
              local_size: Optional[int] = None,
              hostname: Optional[str] = None,
              bind_addr: Optional[str] = None,
              bind_cpus: Optional[list] = None) -> Dict[str, str]:
    env = dict(base_env if base_env is not None else os.environ)
    if bind_cpus:
        env["OMPI_TPU_BIND_CPUS"] = ",".join(map(str, bind_cpus))
    else:
        # never inherit a parent rank's binding (spawned children would
        # otherwise all pin to the parent's cpuset)
        env.pop("OMPI_TPU_BIND_CPUS", None)
    env["OMPI_TPU_RANK"] = str(rank)
    env["OMPI_TPU_SIZE"] = str(size)
    env["OMPI_TPU_LOCAL_RANK"] = str(
        rank if local_rank is None else local_rank)
    env["OMPI_TPU_LOCAL_SIZE"] = str(
        size if local_size is None else local_size)
    env["OMPI_TPU_JOBID"] = jobid
    env["OMPI_TPU_STORE_ADDR"] = f"{store_addr[0]}:{store_addr[1]}"
    if hostname:
        env["OMPI_TPU_HOSTNAME"] = hostname
    if bind_addr:
        env["OMPI_TPU_BIND_ADDR"] = bind_addr
    for k, v in (mca or {}).items():
        env[f"OMPI_TPU_{k.upper()}"] = str(v)
    # make ompi_tpu_torch importable in ranks regardless of install state
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pp = env.get("PYTHONPATH", "")
    if pkg_root not in pp.split(os.pathsep):
        env["PYTHONPATH"] = (pkg_root + os.pathsep + pp) if pp else pkg_root
    return env


def _adaptive_mca(mca: Optional[Dict[str, str]],
                  local_ranks: int) -> Dict[str, str]:
    """Oversubscription-driven defaults, decided ONCE by the launcher
    and forwarded to every rank (the mpirun mpi_yield_when_idle
    pattern, ompi/runtime/ompi_mpi_params.c). ``pml_accel_chunk_bytes``
    must be uniform across ranks (chunk boundaries are derived, not
    negotiated), so per-rank detection is not an option: when the ranks
    oversubscribe this machine's cores, pipelined staging loses (the
    copy worker competes with the ranks for CPU) and the launcher ships
    the monolithic setting instead."""
    out = dict(mca or {})
    if ("pml_accel_chunk_bytes" not in out
            and "OMPI_TPU_PML_ACCEL_CHUNK_BYTES" not in os.environ
            and "OMPI_TPU_pml_accel_chunk_bytes" not in os.environ):
        try:
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            cores = os.cpu_count() or 1
        if local_ranks > cores:
            out["pml_accel_chunk_bytes"] = "0"  # monolithic
    return out


def _prof_ledger(mca: Optional[Dict[str, str]]):
    """The launcher's phase ledger: enabled here when the job profiles,
    so spawn and wait wall are attributed as the ranks attribute theirs.
    Returns the ledger module either way (``phase()`` is the shared
    no-op while it is off)."""
    from ompi_tpu_torch.prof import ledger

    if ledger.PROFILER is None and (
            ledger.requested()
            or str((mca or {}).get("prof_enable", "0")).strip().lower()
            not in ("0", "false", "no", "off", "")):
        ledger.enable()
    return ledger


def _ft(mca: Optional[Dict[str, str]]) -> bool:
    return str((mca or {}).get("ft", "0")).lower() not in ("0", "false", "")


def launch(argv: Sequence[str], nprocs: int,
           mca: Optional[Dict[str, str]] = None,
           timeout: Optional[float] = None,
           bind_to: str = "none") -> int:
    """Spawn nprocs ranks running ``argv``; returns the job exit code
    (the one-context case of :func:`launch_mpmd`)."""
    return launch_mpmd([(list(argv), nprocs)], mca, timeout,
                       bind_to=bind_to)


def parse_app_contexts(tokens: Sequence[str],
                       first_n: Optional[int] = None):
    """mpirun MPMD colon syntax: ``cmd1 args : -n 2 cmd2 args`` ->
    [(argv, nprocs), ...] (reference: PRRTE app contexts behind mpirun,
    ompi/dpm/dpm.c:386 consumes the same structure).

    ``first_n``: a ``-n K`` typed BEFORE the first command is eaten by
    the launcher's own argparse option — :func:`main` forwards it here so
    ``launcher -n 3 a.py : -n 2 b.py`` runs 3 copies of a.py."""
    apps = []
    seg: List[str] = []
    first = True
    for t in list(tokens) + [":"]:
        if t == ":":
            if seg:
                n = (first_n if first and first_n is not None else 1)
                if seg[0] in ("-n", "-np") and len(seg) >= 2:
                    n = int(seg[1])
                    seg = seg[2:]
                if not seg:
                    raise ValueError("empty MPMD app context")
                apps.append((seg, n))
                seg = []
                first = False
        else:
            seg.append(t)
    return apps


def parse_appfile(path: str):
    """mpirun --app file: one ``[-n K] prog args`` context per line
    (# comments)."""
    apps = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            apps.extend(parse_app_contexts(line.split()))
    return apps


def launch_mpmd(apps, mca: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None,
                bind_to: str = "none") -> int:
    """MPMD launch on this machine: several app contexts share ONE world
    — app k's ranks follow app k-1's (the MPI_APPNUM ordering). SPMD
    :func:`launch` is the one-context case, so the store / FT / teardown
    scaffold exists once. Multi-host MPMD goes through
    ``launch_hosts(apps=...)``."""
    apps = [(list(argv), int(n)) for argv, n in apps]
    total = sum(n for _, n in apps)
    store = kvstore.Store().start()
    jobid = uuid.uuid4().hex[:12]
    mca = _adaptive_mca(mca, total)
    # world ranks [0, total) are this job's: MPI_Comm_spawn takes fresh
    # blocks above the watermark (ompi_tpu_torch.dpm)
    store.seed_counter(f"ww:{jobid}", total)
    topo = _topo_for(bind_to)
    ledger = _prof_ledger(mca)
    procs: List[subprocess.Popen] = []
    try:
        with ledger.phase("spawn"):
            r = 0
            for appnum, (argv, n) in enumerate(apps):
                argv = _wrap_py(argv)
                for _ in range(n):
                    env = build_env(r, total, store.addr, jobid, mca,
                                    bind_cpus=_cpuset_for(r, bind_to,
                                                          topo))
                    if len(apps) > 1:  # MPI_APPNUM: MPMD only
                        env["OMPI_TPU_APPNUM"] = str(appnum)
                    else:
                        env.pop("OMPI_TPU_APPNUM", None)
                    procs.append(subprocess.Popen(argv, env=env))
                    r += 1
        with ledger.phase("wait"):
            return _wait_all(procs, timeout,
                             store=store if _ft(mca) else None)
    finally:
        reap(procs)
        cleanup_shm(jobid)
        store.stop()


def _wrap_py(argv: List[str]) -> List[str]:
    """Run *.py commands under THIS interpreter (mpirun ergonomics);
    anything else execs as-is. One policy for the SPMD, MPMD and daemon
    paths."""
    if argv and argv[0].endswith(".py"):
        return [sys.executable] + list(argv)
    return list(argv)


def _app_of_rank(apps, r: int):
    """(appnum, argv) owning global rank r — app k's ranks follow app
    k-1's (the MPI_APPNUM ordering, ompi/dpm/dpm.c:386)."""
    rem = r
    for appnum, (argv, n) in enumerate(apps):
        if rem < n:
            return appnum, argv
        rem -= n
    raise ValueError(f"rank {r} beyond the app contexts")


def _head_addr(agent: str, bind: Optional[str]) -> str:
    """Address the store binds and the daemons dial back to. Local agent
    (fake hosts on this machine): loopback. ssh agent: the best routable
    address by util.net's reachability score."""
    if bind:
        return bind
    if agent == "local":
        return "127.0.0.1"
    from ompi_tpu_torch.util import net

    return net.best_address()


def daemon_command(store_addr: str, jobid: str, host: HostSpec, base: int,
                   local_n: int, total: int, mca, timeout, bind_to: str,
                   argv, apps_json: Optional[str]) -> List[str]:
    """The prted-analog command line one host's daemon runs."""
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
           "--daemon", "--store", store_addr, "--jobid", jobid,
           "--host-name", host.name, "--rank-base", str(base),
           "--local-n", str(local_n), "--world-size", str(total)]
    if host.addr:
        cmd += ["--bind-addr", host.addr]
    if bind_to != "none":
        cmd += ["--bind-to", bind_to]
    if timeout is not None:
        cmd += ["--timeout", str(timeout)]
    for k, v in (mca or {}).items():
        cmd += ["--mca", k, str(v)]
    if apps_json is not None:
        cmd += ["--apps-json", apps_json]
    else:
        cmd += ["--"] + list(argv)
    return cmd


def ssh_command(host: str, cmd: Sequence[str]) -> List[str]:
    """The ssh agent's argv for a daemon command: cd to this directory
    on the host and put this package on its PYTHONPATH."""
    import shlex

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    remote = "cd {} && env PYTHONPATH={} {}".format(
        shlex.quote(os.getcwd()), shlex.quote(pkg_root),
        " ".join(shlex.quote(c) for c in cmd))
    return ["ssh", "-o", "BatchMode=yes", host, remote]


def launch_hosts(argv: Optional[Sequence[str]],
                 hosts: Sequence[HostSpec],
                 mca: Optional[Dict[str, str]] = None,
                 timeout: Optional[float] = None,
                 agent: str = "local",
                 bind: Optional[str] = None,
                 bind_to: str = "none",
                 apps=None) -> int:
    """Multi-host launch: one daemon per host (the prted analog), each
    forking its local rank block. Reference: prterun starting prted
    daemons which fork/exec the ranks per node; btl/tcp endpoints then
    cross hosts via the modex.

    ``apps``: MPMD app contexts [(argv, nprocs), ...] sliced across the
    host set — global ranks go to apps in MPI_APPNUM order and to hosts
    by slot order, so one app may span hosts (PRRTE maps app contexts
    over the node list the same way). With apps, ``argv`` is ignored and
    the total rank count comes from the contexts."""
    if apps is not None:
        apps = [(list(a), int(n)) for a, n in apps]
        total = sum(n for _, n in apps)
        capacity = sum(h.slots for h in hosts)
        if capacity < total:
            raise ValueError(
                f"app contexts need {total} slots; hosts provide "
                f"{capacity}")
    else:
        total = sum(h.slots for h in hosts)
    apps_json = None if apps is None else json.dumps(apps)
    store = kvstore.Store(host=_head_addr(agent, bind)).start()
    jobid = uuid.uuid4().hex[:12]
    if agent == "local":
        # fake hosts: every rank runs on THIS machine, so job-wide
        # oversubscription is knowable here; under ssh remote core
        # counts are not, and the setting must be uniform — keep the
        # pipelined default
        mca = _adaptive_mca(mca, total)
    store.seed_counter(f"ww:{jobid}", total)
    store_addr = f"{store.addr[0]}:{store.addr[1]}"
    daemons: List[subprocess.Popen] = []
    ledger = _prof_ledger(mca)
    try:
        with ledger.phase("spawn"):
            base = 0
            for h in hosts:
                local_n = (h.slots if apps is None
                           else min(h.slots, total - base))
                if local_n <= 0:
                    continue  # app ranks exhausted: surplus hosts idle
                cmd = daemon_command(store_addr, jobid, h, base, local_n,
                                     total, mca, timeout, bind_to, argv,
                                     apps_json)
                if agent == "ssh":
                    cmd = ssh_command(h.name, cmd)
                daemons.append(subprocess.Popen(cmd))
                base += local_n
        # the daemons supervise their ranks, the head the daemons; 30 s
        # of grace over the daemons' own timeout, so they time out first
        # and report 124 themselves
        with ledger.phase("wait"):
            rc = _wait_all(daemons, None if timeout is None
                           else timeout + 30)
        if rc == 0 and _ft(mca):
            # the job-level "did anything survive" check: per daemon it
            # would fail a host whose every rank was faulted while
            # survivors ran elsewhere (ULFM tolerates that). Daemons
            # publish their clean-exit counts; none across the job means
            # nothing survived the faults
            if store.counter_value(f"ftclean:{jobid}") == 0:
                return 137
        return rc
    finally:
        reap(daemons)
        if agent == "local":
            # fake hosts share this machine: what a rank spawned outside
            # its daemon's block (a dpm child) is swept here
            cleanup_shm(jobid)
        store.stop()


def run_daemon(ns) -> int:
    """The prted analog: fork and supervise this host's rank block."""
    # head-initiated teardown (a peer host's failure, or the timeout)
    # arrives as SIGTERM; turn it into SystemExit so the reap below kills
    # this host's ranks instead of orphaning them (prted kills its local
    # procs on daemon exit)
    signal.signal(signal.SIGTERM, lambda s, f: sys.exit(143))
    host, _, port = ns.store.partition(":")
    store_addr = (host, int(port))
    mca = {k: v for k, v in ns.mca}
    client = kvstore.Client(store_addr) if _ft(mca) else None
    apps = None
    if ns.apps_json:
        apps = [(list(a), int(n)) for a, n in json.loads(ns.apps_json)]
    argv = list(ns.command)
    if argv and argv[0] == "--":
        argv = argv[1:]
    # wrapped HERE with the daemon's own interpreter, never the head's
    # (whose sys.executable may not exist on this host)
    argv = _wrap_py(argv)
    topo = _topo_for(ns.bind_to)
    procs: List[subprocess.Popen] = []
    try:
        for i in range(ns.local_n):
            env = build_env(ns.rank_base + i, ns.world_size, store_addr,
                            ns.jobid, mca, local_rank=i,
                            local_size=ns.local_n,
                            hostname=ns.host_name,
                            bind_addr=ns.bind_addr,
                            bind_cpus=_cpuset_for(i, ns.bind_to, topo))
            rank_argv = argv
            # build_env copies os.environ: a stale APPNUM from a nested
            # launch must never leak into the children
            env.pop("OMPI_TPU_APPNUM", None)
            if apps is not None:  # MPMD: this host's block may span app
                # contexts — each rank gets ITS app's command
                appnum, rank_argv = _app_of_rank(apps, ns.rank_base + i)
                rank_argv = _wrap_py(rank_argv)
                if len(apps) > 1:
                    env["OMPI_TPU_APPNUM"] = str(appnum)
            procs.append(subprocess.Popen(rank_argv, env=env))
        rc, clean = _wait_stats(procs, ns.timeout, store=client,
                                rank_base=ns.rank_base,
                                all_killed_fails=False)
        if client is not None:
            client.inc(f"ftclean:{ns.jobid}", clean)
        return rc
    finally:
        reap(procs)
        # this host's rings, arenas and heaps — never another host's
        cleanup_shm(ns.jobid,
                    ranks=range(ns.rank_base, ns.rank_base + ns.local_n),
                    pids=[p.pid for p in procs])
        if client is not None:
            client.close()


def shm_dir() -> str:
    return os.environ.get("OMPI_TPU_SHM_DIR", "/dev/shm")


#: the world rank (or pid) a job file belongs to, from its name after
#: ``<prefix><jobid>_``: an arena or its hop counters
#: (``c<cid>_<tag>_w<world>[_flags]``), a btl/sm ring (``sm_<src>to<dst>``,
#: made by src), a shmem heap (``shmem_<world>``), an IPC file
#: (``ipc_<pid>_<id>``)
_OWNER = re.compile(r"^(?:c\d+_.+_w(?P<w>\d+)(?:_flags)?"
                    r"|sm_(?P<src>\d+)to\d+|shmem_(?P<heap>\d+)"
                    r"|ipc_(?P<pid>\d+)_.*)$")


def job_files(jobid: str, ranks: Optional[Iterable[int]] = None,
              pids: Iterable[int] = ()) -> List[str]:
    """The job's shared-memory files; with ``ranks``, those of these
    world ranks (and of these processes) only."""
    paths = glob.glob(os.path.join(shm_dir(), f"{SHM_PREFIX}{jobid}_*"))
    if ranks is None:
        return paths
    ranks, pids = {int(r) for r in ranks}, {int(p) for p in pids}
    cut = len(f"{SHM_PREFIX}{jobid}_")
    out = []
    for p in paths:
        m = _OWNER.match(os.path.basename(p)[cut:])
        if m is None:
            continue
        if m["pid"] is not None:
            if int(m["pid"]) in pids:
                out.append(p)
        elif int(m["w"] or m["src"] or m["heap"]) in ranks:
            out.append(p)
    return out


def cleanup_shm(jobid: str, ranks: Optional[Iterable[int]] = None,
                pids: Iterable[int] = ()) -> None:
    """Reap the job's shared-memory files that crashed ranks could not
    unlink themselves (tmpfs is RAM: leaks last until reboot); a daemon
    passes its own ranks and processes, so it never removes another
    host's files."""
    for p in job_files(jobid, ranks, pids):
        try:
            os.unlink(p)
        except OSError:
            pass


def reap(procs: Sequence[subprocess.Popen], grace: float = 5.0) -> None:
    """Terminate stragglers, then kill after a grace period."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _wait_all(procs: List[subprocess.Popen],
              timeout: Optional[float], store=None,
              rank_base: int = 0) -> int:
    """The job's exit code. ``store`` (a :class:`kvstore.Store`) turns on
    FT mode: a rank killed by a signal is marked dead there and the
    survivors keep running."""
    rc, _ = _wait_stats(procs, timeout, store, rank_base)
    return rc


def _wait_stats(procs: List[subprocess.Popen],
                timeout: Optional[float],
                store=None, rank_base: int = 0,
                all_killed_fails: bool = True):
    """(rc, clean_exits). ``store`` (a Store in process, or a daemon's
    Client) turns on FT mode: signal deaths are declared to it instead of
    tearing the job down; ``rank_base`` maps a local index to its world
    rank. ``all_killed_fails``: the single-host "nothing survived" check;
    daemons pass False — the head sums the clean exits job-wide, so one
    fully faulted host must not fail the survivors elsewhere."""
    deadline = None if timeout is None else time.monotonic() + timeout
    pending = set(range(len(procs)))
    first_bad = 0
    clean_exits = 0
    last_killed_rc = 0
    while pending:
        for i in list(pending):
            rc = procs[i].poll()
            if rc is None:
                continue
            pending.discard(i)
            killed = rc < 0
            if killed:  # by signal: shell convention 128+signum
                rc = 128 - rc
            if rc == 0:
                clean_exits += 1
            if killed and store is not None:
                store.mark_dead(rank_base + i,
                                f"killed by signal {rc - 128}")
                last_killed_rc = rc
                continue  # ULFM: the survivors keep running
            if rc != 0 and first_bad == 0:
                first_bad = rc
                if killed:
                    from ompi_tpu_torch.util import show_help

                    show_help.show("launcher", "rank-died",
                                   rank=rank_base + i,
                                   cause=f"signal {rc - 128}")
                # a rank died abnormally: bring the job down
                for j in pending:
                    if procs[j].poll() is None:
                        procs[j].send_signal(signal.SIGTERM)
        if pending:
            time.sleep(0.02)
            if deadline is not None and time.monotonic() > deadline:
                for j in pending:
                    procs[j].kill()
                return 124, clean_exits
    if (all_killed_fails and first_bad == 0 and clean_exits == 0
            and last_killed_rc):
        # FT mode with every rank killed: nothing survived the faults
        return last_killed_rc, clean_exits
    return first_bad, clean_exits


#: the program ``--func pkg.mod:fn`` runs per rank (the target comes in
#: through argv: no source splicing)
_FUNC_PROG = ("import importlib, sys; mod, fn = sys.argv[1].split(':', 1); "
              "sys.exit(getattr(importlib.import_module(mod), fn)() or 0)")


def main(args: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.runtime.launcher",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "-np", dest="nprocs", type=int, default=1)
    ap.add_argument("--mca", nargs=2, action="append", default=[],
                    metavar=("KEY", "VALUE"))
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("--func", default=None,
                    help="run a python function 'pkg.mod:fn' per rank")
    ap.add_argument("--host", default=None,
                    help="host list 'name[:slots[:addr]],...'")
    ap.add_argument("--hostfile", default=None,
                    help="hostfile: 'name [slots=K] [addr=IP]' lines")
    ap.add_argument("--app", default=None,
                    help="MPMD appfile: one '[-n K] prog args' context "
                         "per line; the contexts share one world (also: "
                         "'cmd1 : -n 2 cmd2' on the command line)")
    ap.add_argument("--launch-agent", default="ssh",
                    choices=["ssh", "local"],
                    help="how daemons start on hosts ('local' forks them "
                         "on this machine: fake hosts)")
    ap.add_argument("--bind", default=None,
                    help="address the rendezvous store binds")
    ap.add_argument("--bind-to", default="none",
                    choices=["none", "core", "socket", "numa"],
                    help="CPU binding per rank (the PRRTE map/bind "
                         "analog: ranks round-robin over cores incl. SMT "
                         "siblings, packages, or NUMA nodes, read from "
                         "sysfs by util/topology)")
    # daemon (prted-analog) flags — internal, set by launch_hosts
    ap.add_argument("--daemon", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--jobid", help=argparse.SUPPRESS)
    ap.add_argument("--host-name", help=argparse.SUPPRESS)
    ap.add_argument("--rank-base", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--local-n", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--world-size", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--bind-addr", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--apps-json", default=None, help=argparse.SUPPRESS)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    ns = ap.parse_args(args)

    if ns.daemon:
        return run_daemon(ns)

    mca = dict(ns.mca)
    cmd = list(ns.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    hosts = None
    if ns.host or ns.hostfile:
        hosts = (parse_hostfile(ns.hostfile) if ns.hostfile
                 else parse_host_list(ns.host))
    if ns.app or ":" in cmd:
        apps = (parse_appfile(ns.app) if ns.app
                else parse_app_contexts(cmd, first_n=ns.nprocs))
        if hosts is not None:
            # multi-host MPMD: the app contexts slice across the hosts
            return launch_hosts(None, hosts, mca, ns.timeout,
                                agent=ns.launch_agent, bind=ns.bind,
                                bind_to=ns.bind_to, apps=apps)
        return launch_mpmd(apps, mca, ns.timeout, bind_to=ns.bind_to)
    if ns.func:
        if ":" not in ns.func:
            ap.error(f"--func wants 'pkg.mod:fn', got {ns.func!r}")
        argv = [sys.executable, "-c", _FUNC_PROG, ns.func]
    else:
        if not cmd:
            ap.error("no command given")
        # multi-host keeps the bare command: each daemon wraps *.py with
        # its own interpreter
        argv = cmd
    if hosts is not None:
        return launch_hosts(argv, hosts, mca, ns.timeout,
                            agent=ns.launch_agent, bind=ns.bind,
                            bind_to=ns.bind_to)
    return launch(argv, ns.nprocs, mca, ns.timeout, bind_to=ns.bind_to)


if __name__ == "__main__":
    sys.exit(main())
