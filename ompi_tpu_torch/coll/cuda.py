"""coll/cuda — hand-written ring collectives on the device plane.

Port of ``ompi_tpu.coll.pallas`` (priority 60, opt-in with ``--mca
coll_cuda on``, ``off`` by default like ``coll_pallas``): Allreduce,
Reduce_scatter_block and Allgather on ``torch.Tensor`` buffers through
the kernels of :mod:`ompi_tpu_torch.coll.cuda_kernels`, moving data
through peer-mapped arenas (:class:`Arena`, one per communicator and size
class — the reduced counterpart of the reference's per-comm
``coll/xla._Ctx``) on the device the device plane bound; and the two
fused slots coll/pallas exists for (coll/pallas.py:449-690):
``fused_rs_update_dev`` (the ZeRO reduce-scatter whose last ring hop
updates the shard, K5) and ``allgather_matmul_dev`` /
``zero3_gather_matmul_dev`` (the ring allgather whose blocks are
multiplied as they arrive, K6).

Selection (``_select``, as coll/pallas.py:210-247):

- ``deterministic='linear'`` runs the rank-order fold (K3), bitwise
  equal to the host linear fold and to the JAX package's 'linear';
  ``'ring'`` runs the clockwise ring (bitwise equal to its 'ring'). The
  default mode is coll/device's ``coll_device_deterministic``, as
  coll/pallas reads coll/xla's ``coll_xla_deterministic``;
- otherwise a forced ``coll_cuda_*_algorithm`` cvar wins, then a
  ``coll_cuda_switchpoints`` table entry (the reference's JSON format,
  so a table written for coll/pallas loads unchanged; a table that does
  not load counts ``tune_table_errors``, warns once per path and leaves
  the built-in choice, as coll/pallas's does), then the built-in
  threshold: the bidirectional ring at/above
  ``coll_cuda_bidir_min_bytes`` (1 MiB), else the ring.

What the kernels do not take falls through to coll/device (the
coll/xla counterpart, one level down), as coll/pallas falls through to
coll/xla (coll/pallas.py:165-167): a dtype outside float32 / bfloat16 /
int32, an op outside SUM / PROD / MIN / MAX, a forced
``coll_cuda_*_algorithm`` of ``'xla'`` and a switchpoint table's
``'xla'`` entry count ``coll_cuda_fallthrough`` and call coll/device's
slot with the same arguments. ``allgather_matmul_dev``'s other cases
compose coll/device's allgather with a local product (``jnp.dot``'s
contraction, as the reference composes coll/xla's allgather with it).
``fused_rs_update_dev`` and ``zero3_gather_matmul_dev`` return None for
a case they do not take, as the reference's do: their caller then runs
its unfused sequence.

Failures (``--mca ft 1``): a rank that dies inside a schedule never
moves its hop counters again, and the transport has no message to error
out. While a member is late, :meth:`Arena._wait` runs the failure
detector's sweep (no store RPC) and raises ``ProcFailedError`` naming
the failed comm ranks as soon as one of the comm's members is in the
pml's ``failed`` set, well before ``device_plane_timeout``.
:func:`release` of a comm under FT rendezvous through the store's
dead-tolerant ``ftgather`` instead of the comm's barrier, and leaves a
dead exporter's mapping open until the process exits.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch import ft as _ft
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import cvar, pvar, registry
from ompi_tpu_torch.ft import detector as _ft_detector
from ompi_tpu_torch.monitoring import algo as _algo
from ompi_tpu_torch.monitoring import matrix as _mon
from ompi_tpu_torch.monitoring.algo import log2_bucket
from ompi_tpu_torch.runtime import device_plane, launcher, rte
from ompi_tpu_torch.tune import observe as _tobs

_enable_var = cvar.register(
    "coll_cuda", "off", str,
    help="Enable the hand-written CUDA ring collectives (priority 60): "
         "'on' stacks them for every comm the device plane serves; 'off' "
         "[default] leaves no device provider in this slice.",
    choices=["off", "on"], level=4)

_force_allreduce = cvar.register(
    "coll_cuda_allreduce_algorithm", "", str,
    help="Force the allreduce variant: ring|bidir|linear|xla ('xla' "
         "falls through to coll/device). Deterministic modes ignore a "
         "forced ring, bidir or linear.",
    choices=["", "ring", "bidir", "linear", "xla"], level=5)
_force_reduce_scatter = cvar.register(
    "coll_cuda_reduce_scatter_algorithm", "", str,
    help="Force the reduce_scatter_block variant: ring|bidir|linear|xla "
         "(see coll_cuda_allreduce_algorithm).",
    choices=["", "ring", "bidir", "linear", "xla"], level=5)
_force_allgather = cvar.register(
    "coll_cuda_allgather_algorithm", "", str,
    help="Force the allgather variant: ring|bidir|xla (allgather has no "
         "reduction, so no linear fold).",
    choices=["", "ring", "bidir", "xla"], level=5)

_bidir_min_var = cvar.register(
    "coll_cuda_bidir_min_bytes", 1 << 20, int,
    help="Payloads at/above this use the bidirectional ring (half the "
         "payload each way) when no deterministic mode, forced "
         "algorithm or switchpoint entry overrides; below it the "
         "clockwise ring. -1 disables the bidirectional default.",
    level=5)
_switch_var = cvar.register(
    "coll_cuda_switchpoints", "", str,
    help="Path to a switchpoint table (coll/pallas's JSON format): a "
         "list of {op, dtype, mesh, log2, algorithm} rules; for each "
         "(op, dtype, mesh) the rule with the largest log2 <= the "
         "payload's log2 bucket wins. Empty [default] uses the built-in "
         "threshold.", level=5)

#: support matrix (coll/pallas.py:122-125)
_SUPPORTED_DTYPES = frozenset((torch.float32, torch.bfloat16, torch.int32))
_SUPPORTED_OPS = frozenset(K.OP_CODES)

_BYTES_PVAR = {"ring": "coll_cuda_ring_bytes",
               "bidir": "coll_cuda_bidir_bytes",
               "linear": "coll_cuda_linear_bytes"}

_FORCE = {"allreduce": _force_allreduce,
          "reduce_scatter_block": _force_reduce_scatter,
          "allgather": _force_allgather}


def _det_ok(deterministic: Optional[str]) -> Optional[str]:
    """Normalize the deterministic mode (slot arg over coll/device's
    ``coll_device_deterministic``, the one default both components read,
    as coll/pallas reads coll/xla's) and reject unknown values."""
    from ompi_tpu_torch.coll import device

    det = deterministic if deterministic is not None \
        else device._default_det.get()
    det = det or None
    if det not in (None, "ring", "linear"):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"coll_cuda: deterministic={det!r} (expected None, 'ring' or "
            "'linear' — anything else would void the fixed-reduction-"
            "order guarantee)")
    return det


def _fallthrough(slot: str, *args, **kw):
    """Count the case and hand it to coll/device's ``slot`` (a reduction
    passes the mode resolved here, so both components fold alike)."""
    from ompi_tpu_torch.coll import device

    pvar.record("coll_cuda_fallthrough")
    return getattr(device, slot)(*args, **kw)


_sw_cache: dict = {}


def _switchpoint(kind: str, nbytes: int, dtype: str, mesh_shape) -> str:
    path = _switch_var.get().strip()
    if not path:
        return ""
    table = _sw_cache.get(path)
    if table is None:
        try:
            with open(path, encoding="utf-8") as f:
                entries = json.load(f)
        except (OSError, ValueError) as exc:
            # a fat-fingered table path is a silent perf cliff: warn once
            # per path, count every attempt, go on with the built-in
            # thresholds (coll/pallas.py:183-187)
            _tobs.table_error("coll_cuda_switchpoints", path, exc)
            entries = []
        table = {}
        for e in entries if isinstance(entries, list) else []:
            key = (str(e.get("op", "")), str(e.get("dtype", "")),
                   tuple(int(v) for v in e.get("mesh", ())))
            table.setdefault(key, []).append(
                (int(e.get("log2", 0)), str(e.get("algorithm", ""))))
        for rules in table.values():
            rules.sort()
        _sw_cache[path] = table
    best = ""
    bucket = log2_bucket(nbytes)
    for lg, alg in table.get((kind, dtype, tuple(mesh_shape)), ()):
        if bucket < lg:
            break
        best = alg
    return best


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _select(kind: str, comm, sendbuf: torch.Tensor, det: Optional[str],
            chunk_rows: int) -> Optional[str]:
    """The decision layer: algorithm name, or None to fall through to
    coll/device (a forced 'xla', or a switchpoint table's 'xla' entry).
    Deterministic modes pin the matching kernel; otherwise forced cvar >
    switchpoint table > bidir threshold > ring."""
    nbytes = sendbuf.numel() * sendbuf.element_size()
    forced = _FORCE[kind].get()
    if forced == "xla":
        return None
    if det == "linear":
        return "linear" if kind != "allgather" else "ring"
    if det == "ring":
        return "ring"
    if forced:
        return forced if not (forced == "bidir" and chunk_rows < 2) \
            else "ring"
    sw = _switchpoint(kind, nbytes, _dtype_name(sendbuf), (comm.size,))
    if sw == "xla":
        return None
    if sw:
        return sw if not (sw == "bidir" and chunk_rows < 2) else "ring"
    bmin = _bidir_min_var.get()
    if 0 <= bmin <= nbytes and chunk_rows >= 2:
        return "bidir"
    return "ring"


def _account_bytes(kind: str, comm, nbytes: int, dtype: str,
                   algo: str) -> None:
    """The launch's pvars and, with the monitoring plane on, its record
    with the schedule's own per-peer split (coll/pallas.py:273-283)."""
    pvar.record("coll_cuda_launches")
    pvar.record(_BYTES_PVAR[algo], nbytes)
    tm = _mon.TRAFFIC
    if tm is not None:
        tm.coll(kind, comm, nbytes, dtype=dtype,
                per_peer=_algo.pallas_per_peer(kind, algo, comm.rank,
                                               comm.size, nbytes))


def _account(kind: str, comm, sendbuf: torch.Tensor, algo: str) -> None:
    _account_bytes(kind, comm, sendbuf.numel() * sendbuf.element_size(),
                   _dtype_name(sendbuf), algo)


def _check_buf(kind: str, sendbuf) -> bool:
    """A tensor on this rank's device; True when the kernels take its
    dtype."""
    dev = device_plane.device()
    if not isinstance(sendbuf, torch.Tensor):
        raise errors.MPIError(errors.ERR_BUFFER,
                              f"coll_cuda: {kind} needs a torch.Tensor")
    if sendbuf.device.type != dev.type or (
            dev.type == "cuda" and sendbuf.device.index != dev.index):
        raise errors.MPIError(
            errors.ERR_BUFFER,
            f"coll_cuda: {kind} buffer on {sendbuf.device}, but this "
            f"rank's device plane runs on {dev}")
    return sendbuf.dtype in _SUPPORTED_DTYPES


def _opn(op) -> Optional[op_mod.Op]:
    """The op, or None when the kernels do not take it."""
    opn = op if isinstance(op, op_mod.Op) else op_mod.BUILTIN.get(op)
    return opn if opn is not None and opn.name in _SUPPORTED_OPS else None


# ---------------------------------------------------------------------------
# per-comm state: peer-mapped arenas per size class
#
# Each rank allocates its staged input and four carry slots (a one-sided
# window's arena: two exchange regions and no input) with cudaMalloc (outside
# PyTorch's caching allocator, whose blocks cudaIpcGetMemHandle cannot
# export), publishes the IPC handle through
# the kvstore, and opens every peer's handle; a rank never opens its own
# (CUDA refuses that within one process). On the CPU platform the same
# arenas are shared-memory files, with peer views as tensors over each
# peer's file. Ring hops are ordered by hop counters in a host-shared
# file per rank and arena: after each step a rank synchronises its
# stream, publishes its counter, and waits (up to device_plane_timeout)
# for the ranks the step depends on (a one-sided exchange: its partners,
# Arena.exchange). Device-side flags would spin through whole time slices
# when several processes share one card; they are a later change, for one
# rank per card.

_timeout = cvar.register(
    "device_plane_timeout", 60, int,
    help="seconds a rank waits for a peer's hop counter before raising "
         "MPIError(ERR_INTERN) naming the peer, instead of hanging",
    level=6)

#: arena sizes are multiples of this (16-byte vector loads, typed views)
ALIGN = 256
_FLAG_SLOTS = 8  # int64 counters per rank and arena
#: counter index per step kind: ring hops per direction, linear steps, and
#: the one-sided exchanges' staged / landed counts (Arena.exchange)
_FLAG_IDX = {1: 0, -1: 1, K.ALL: 2, "staged": 3, "landed": 4}
_FLAG_WHAT = {1: "direction 1 hop", -1: "direction -1 hop",
              K.ALL: "linear", "staged": "staged exchange",
              "landed": "landed exchange"}


def align(nbytes: int) -> int:
    return -(-max(int(nbytes), 1) // ALIGN) * ALIGN


class _DevPtr:
    """A raw device allocation seen through __cuda_array_interface__."""

    def __init__(self, ptr: int, nbytes: int) -> None:
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


def _map_file(path: str, nbytes: int, create: bool):
    fd = os.open(path, os.O_RDWR | (os.O_CREAT | os.O_EXCL if create
                                    else 0), 0o600)
    try:
        if create:
            os.ftruncate(fd, nbytes)
        return mmap.mmap(fd, nbytes)
    finally:
        os.close(fd)


class Arena(K.Ring):
    """One communicator's symmetric buffers for one size class, mapped
    on every member: this rank's staged input and slots, every peer's
    through its peer mapping, and the hop counters.

    Its files and store keys are named by the members' world ranks
    (``world``, in comm-rank order), not their comm ranks: a spawned world's COMM_WORLD has
    the same cid (0) as its parents', and world ranks are unique across
    the worlds that share a job's store, so the two never meet."""

    def __init__(self, cid: int, tag: str, rank: int, world,
                 in_bytes: int, slot_bytes: int, nslots: int = 4) -> None:
        n = len(world)
        self.world = list(world)
        self._maps: List[mmap.mmap] = []
        self._peer_ptrs: List[int] = []
        self._own_ptr: Optional[int] = None
        self._paths: List[str] = []
        self.exchanges = 0  # one-sided exchanges run (Arena.exchange)
        # per region parity: (reader, exchange) of its last contents' readers
        self._readers: List[List[tuple]] = [[], []]
        dev = device_plane.device()
        total = in_bytes + nslots * slot_bytes
        base = os.path.join(launcher.shm_dir(),
                            f"{launcher.SHM_PREFIX}{rte.jobid}_c{cid}_"
                            f"{tag}_w{world[rank]}")
        flag_path = base + "_flags"
        self._paths.append(flag_path)
        self._maps.append(_map_file(flag_path, 8 * _FLAG_SLOTS, True))
        desc = {"flags": flag_path}
        if dev.type == "cuda":
            # builds the kernels on first use: a failed build raises here,
            # at the same collective call on every rank
            L = K.lib()
            K.check(L.otc_set_device(dev.index), "cudaSetDevice")
            ptr = ctypes.c_void_p()
            K.check(L.otc_malloc(total, ctypes.byref(ptr)), "arena cudaMalloc")
            self._own_ptr = ptr.value
            handle = ctypes.create_string_buffer(L.otc_ipc_handle_size())
            K.check(L.otc_ipc_get_handle(ptr, handle), "cudaIpcGetMemHandle")
            desc["handle"] = handle.raw
            mine = torch.as_tensor(_DevPtr(ptr.value, total))
        else:
            self._paths.append(base)
            self._maps.append(_map_file(base, total, True))
            desc["path"] = base
            mine = torch.frombuffer(self._maps[-1], dtype=torch.uint8)
        key = f"arena:{rte.jobid}:{cid}:{tag}"
        rte.client().put(f"{key}:w{world[rank]}", desc)
        bufs, flags = [], []
        for p in range(n):
            d = desc if p == rank \
                else rte.client().get(f"{key}:w{world[p]}")
            if p == rank:
                buf = mine
                fmap = self._maps[0]
            else:
                fmap = _map_file(d["flags"], 8 * _FLAG_SLOTS, False)
                self._maps.append(fmap)
                if dev.type == "cuda":
                    pptr = ctypes.c_void_p()
                    h = ctypes.create_string_buffer(d["handle"],
                                                    len(d["handle"]))
                    K.check(K.lib().otc_ipc_open(h, ctypes.byref(pptr)),
                            f"cudaIpcOpenMemHandle (rank {p})")
                    self._peer_ptrs.append(pptr.value)
                    # no device= here: torch would copy a peer card's
                    # memory over; the view stays on the card that owns it
                    buf = torch.as_tensor(_DevPtr(pptr.value, total))
                else:
                    m = _map_file(d["path"], total, False)
                    self._maps.append(m)
                    buf = torch.frombuffer(m, dtype=torch.uint8)
            bufs.append(buf)
            flags.append(np.frombuffer(fmap, dtype=np.int64))
        super().__init__(rank, n, [b[:in_bytes] for b in bufs],
                         [b[in_bytes:] for b in bufs], slot_bytes)
        self.flags = flags
        self.device = dev
        self.nbytes = total
        pvar.record("device_plane_arenas")

    # -- the hop-counter protocol -----------------------------------------
    def run(self, steps) -> None:
        """Drive one schedule (a cuda_kernels generator): after every
        step, make it visible to the peers and wait for the ranks the
        next step depends on."""
        mine = self.flags[self.rank]
        for dirs in steps:
            self._sync()
            self.advance(dirs)
            for d in dirs:
                mine[_FLAG_IDX[d]] = self.linear if d == K.ALL \
                    else self.hops[d]
            for d in dirs:
                if d == K.ALL:
                    for p in range(self.n):
                        self._wait(p, d, self.linear)
                else:
                    for p in {(self.rank - d) % self.n,
                              (self.rank + d) % self.n}:
                        self._wait(p, d, self.hops[d])

    def exchange(self, stage, readers, land, sources) -> None:
        """One exchange of a one-sided fence (osc/cuda's transport: a run
        of the reference's edge-coloured rounds in one host step, the
        handshake of its ``dma_permute`` with the run's actual partners
        only). Exchange t uses region t%2 of each rank (direction 1's two
        slots). A rank with ``readers`` (the ranks that read its region in
        this exchange) waits until every rank that read the region's last
        contents has landed that exchange, fills its region
        (``stage(region)``, a uint8 view: every payload it sends in the
        run), synchronises and publishes "staged"; a rank with ``sources``
        waits for each of them to publish, lands (``land(regions)``, a dict
        source -> that rank's region, read through the peer mapping),
        synchronises and publishes "landed". Every member runs every
        exchange in the same order (the exchanges are derived from the same
        allgathered descriptors), so the counters and parities agree."""
        t, par = self.exchanges, self.exchanges % 2
        mine = self.flags[self.rank]
        if readers:
            for reader, when in self._readers[par]:
                self._wait(reader, "landed", when + 1)
            stage(self.slot(self.rank, 1, par))
            self._sync()
            self._readers[par] = [(r, t) for r in readers]
        mine[_FLAG_IDX["staged"]] = t + 1
        if sources:
            for src in sources:
                self._wait(src, "staged", t + 1)
            land({src: self.slot(src, 1, par) for src in sources})
            self._sync()
        mine[_FLAG_IDX["landed"]] = t + 1
        self.exchanges = t + 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _wait(self, p: int, d, target: int) -> None:
        f, i = self.flags[p], _FLAG_IDX[d]
        if f[i] >= target:
            return
        t0 = time.monotonic()
        deadline = t0 + _timeout.get()
        det = _ft_detector.get()
        spins = 0
        while f[i] < target:
            spins += 1
            if spins > 64:
                time.sleep(0 if spins < 4096 else 1e-4)
                if det is not None:
                    self._check_failed(det)
            if time.monotonic() > deadline:
                raise errors.MPIError(
                    errors.ERR_INTERN,
                    f"coll_cuda: comm rank {self.rank} waited "
                    f"{_timeout.get()}s for comm rank {p} to pass "
                    f"{_FLAG_WHAT[d]} step {target} (it is at {int(f[i])})")
        pvar.record("device_plane_wait_ns",
                    int((time.monotonic() - t0) * 1e9))

    def _check_failed(self, det) -> None:
        """Apply the detector's news (its progress sweep, no store RPC)
        and raise ProcFailedError if a member of this comm failed: the
        failure ob1's sweep gives a receive."""
        det._sweep()
        failed = _ft.failed_world_ranks()
        bad = [q for q, w in enumerate(self.world) if w in failed]
        if bad:
            raise errors.ProcFailedError(
                ranks=tuple(bad),
                msg=f"coll_cuda: comm rank {self.rank} waited on a "
                    f"device schedule whose comm ranks {bad} failed")

    # -- teardown (collective: close peers, fence, then free own) --------
    def close_peers(self, dead=()) -> None:
        """Close the peer mappings, but not those of the world ranks in
        ``dead``: a dead exporter's mapping stays open until this process
        exits (closing memory whose owner is gone is left to the driver's
        process teardown, never to a call that could fail here)."""
        self.inputs = self.slotbufs = None
        self.flags = None
        peers = [w for q, w in enumerate(self.world) if q != self.rank]
        for w, ptr in zip(peers, self._peer_ptrs):
            if w in dead:
                continue
            K.check(K.lib().otc_ipc_close(ctypes.c_void_p(ptr)),
                    "cudaIpcCloseMemHandle")
        self._peer_ptrs = []

    def free_own(self) -> None:
        if self._own_ptr is not None:
            K.check(K.lib().otc_free(ctypes.c_void_p(self._own_ptr)),
                    "arena cudaFree")
            self._own_ptr = None
        for m in self._maps:
            try:
                m.close()
            except BufferError:
                pass  # a tensor view still holds it; the OS reclaims it
        self._maps = []
        for path in self._paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._paths = []


def _pow2(nbytes: int) -> int:
    return 1 << max(12, (max(int(nbytes), 1) - 1).bit_length())


def _arena(comm, family: str, nbytes: int) -> Arena:
    """The comm's arena for this payload's size class (created
    collectively on first use: every member makes the same call)."""
    arenas = comm.__dict__.setdefault("_coll_cuda_arenas", {})
    cap = _pow2(nbytes)
    key = (family, cap)
    ep = arenas.get(key)
    if ep is None:
        n, nslots = comm.size, 4
        if family == "ag":  # the whole block travels; nothing is staged
            in_bytes, slot_bytes = ALIGN, cap
        elif family == "pull":  # staged input only (coll/device's pulls)
            in_bytes, slot_bytes, nslots = cap, 0, 0
        elif family in ("osc", "perm"):  # an exchange's payloads per parity
            in_bytes, slot_bytes, nslots = 0, cap, 2
        else:  # staged input + one chunk per slot
            in_bytes = cap
            slot_bytes = align(-(-cap // n))
        ep = arenas[key] = Arena(
            comm.cid, f"{family}{cap}", comm.rank, comm.group.ranks,
            in_bytes, slot_bytes, nslots)
        pvar.record_hwm("device_plane_arena_bytes",
                        sum(a.nbytes for a in arenas.values()))
    return ep


def release(comm) -> None:
    """Unmap a comm's arenas — collective: peers' mappings close before
    any rank frees the memory behind them. Under ``ft`` the rendezvous is
    the store's ``ftgather`` over the comm's world ranks, which releases
    once every member has arrived or failed (the comm's own barrier would
    wait on a dead member forever), and the mappings of the members the
    store knows dead stay open."""
    arenas = comm.__dict__.pop("_coll_cuda_arenas", {})
    if not arenas:
        return
    if _ft_detector.get() is None:
        for ep in arenas.values():
            ep.close_peers()
        comm.coll.barrier(comm)
    else:
        dead = set(_ft.faults()) | _ft.failed_world_ranks()
        for ep in arenas.values():
            ep.close_peers(dead)
        rte.client().ftgather(
            f"ftfree:{rte.jobid}:{comm.cid}:{comm.group.ranks[0]}",
            rte.rank, True, comm.group.ranks,
            hb_timeout=_ft._hb_timeout())
    for ep in arenas.values():
        ep.free_own()


# ---------------------------------------------------------------------------
# slots — the shapes of the reference's coll/pallas slots


def allreduce_dev(comm, sendbuf, op=op_mod.SUM,
                  deterministic: Optional[str] = None):
    det = _det_ok(deterministic)
    opn = _opn(op)
    algo = None
    if _check_buf("allreduce", sendbuf) and opn is not None:
        algo = _select("allreduce", comm, sendbuf, det,
                       K.padded_chunk(sendbuf.numel(), comm.size))
    if algo is None:
        return _fallthrough("allreduce_dev", comm, sendbuf, op,
                            det or "")
    m, n = sendbuf.numel(), comm.size
    if m == 0:
        return sendbuf.clone()
    k = K.padded_chunk(m, n)
    _account("allreduce", comm, sendbuf, algo)
    out = torch.empty(n * k, dtype=sendbuf.dtype, device=sendbuf.device)
    ep = _arena(comm, "rs", n * k * sendbuf.element_size())
    ep.run(K.allreduce(ep, sendbuf.reshape(-1), opn.name, algo, out))
    return out[:m].view(sendbuf.shape)


def reduce_scatter_block_dev(comm, sendbuf, op=op_mod.SUM,
                             deterministic: Optional[str] = None):
    det = _det_ok(deterministic)
    opn = _opn(op)
    n = comm.size
    if not _check_buf("reduce_scatter_block", sendbuf) or opn is None:
        return _fallthrough("reduce_scatter_block_dev", comm, sendbuf, op,
                            det or "")
    if sendbuf.dim() < 1 or sendbuf.shape[0] % n:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"reduce_scatter_block: dim 0 of shape {tuple(sendbuf.shape)} "
            f"is not divisible by the comm size {n}")
    rows = sendbuf.shape[0] // n
    algo = _select("reduce_scatter_block", comm, sendbuf, det, rows)
    if algo is None:
        return _fallthrough("reduce_scatter_block_dev", comm, sendbuf, op,
                            det or "")
    out = torch.empty((rows,) + tuple(sendbuf.shape[1:]),
                      dtype=sendbuf.dtype, device=sendbuf.device)
    if sendbuf.numel() == 0:
        return out
    _account("reduce_scatter_block", comm, sendbuf, algo)
    ep = _arena(comm, "rs", sendbuf.numel() * sendbuf.element_size())
    ep.run(K.reduce_scatter(ep, sendbuf.reshape(-1), opn.name, algo,
                            out.numel() // max(rows, 1), out.view(-1)))
    return out


def allgather_dev(comm, sendbuf):
    n = comm.size
    algo = _select("allgather", comm, sendbuf, None, sendbuf.numel()) \
        if _check_buf("allgather", sendbuf) else None
    if algo is None:
        return _fallthrough("allgather_dev", comm, sendbuf)
    out = torch.empty((n,) + tuple(sendbuf.shape), dtype=sendbuf.dtype,
                      device=sendbuf.device)
    if sendbuf.numel() == 0:
        return out
    _account("allgather", comm, sendbuf, algo)
    ep = _arena(comm, "ag", sendbuf.numel() * sendbuf.element_size())
    ep.run(K.allgather(ep, sendbuf.reshape(-1), algo, out.view(-1)))
    return out


# ---------------------------------------------------------------------------
# fused slots (coll/cuda only: no lower provider has them)


def fused_rs_update_dev(comm, grads, pshards, mshards, *, lr: float,
                        mu: float = 0.0, avg: bool = True,
                        deterministic: Optional[str] = None):
    """ZeRO fused reduce-scatter + shard update over the gradient pytree
    (coll/pallas.py:449-601): per ZeroPlan bucket one clockwise ring whose
    last hop (K5) updates this rank's parameter shard (and momentum) with
    the reduced chunk. Returns ``(new_pshards, new_mshards)``, or None
    (counted in ``coll_cuda_fallthrough``) for a case it does not take,
    after which ZeroOptimizer runs its unfused step.

    Under ``deterministic='linear'`` the bucket is reduce-scattered by
    the rank-order fold (K3) and the update runs eagerly, op for op, as
    the reference does. In the other modes K5 rounds after every op, so
    the fused step is bitwise equal to the unfused 'ring' step (the
    reference's fused ring is only within one rounding of its unfused
    step, since XLA may contract multiply-adds)."""
    from ompi_tpu_torch.zero import layout as zl

    det = _det_ok(deterministic)
    leaves, _ = zl.tree_flatten(grads)
    metas = zl._fuse_metas(leaves)
    plan = pshards.plan
    if comm.size == 1 or not leaves or metas != tuple(pshards.metas) \
            or any(getattr(torch, dt) not in _SUPPORTED_DTYPES
                   for dt in plan.dtypes):
        pvar.record("coll_cuda_fallthrough")
        return None
    for t in leaves:
        _check_buf("fused_rs_update", t)
    with_mom = mshards is not None
    algo = "linear" if det == "linear" else "ring"
    _account_bytes("reduce_scatter_multi", comm, plan.nbytes,
                   plan.dtypes[0] if plan.dtypes else "", algo)
    new_p, new_m = [], []
    for b, idxs in enumerate(plan.buckets):
        flat = zl.pack(leaves, idxs, plan.padded[b] - plan.elems[b])
        dt = flat.dtype
        lr_c, mu_c = K.shard_const(lr, dt), K.shard_const(mu, dt)
        inv = K.shard_const(1.0 / comm.size, dt) if avg else None
        p0 = pshards.shards[b]
        v0 = mshards.shards[b] if with_mom else None
        ep = _arena(comm, "rs", flat.numel() * flat.element_size())
        if det == "linear":
            g = torch.empty_like(p0)
            ep.run(K.reduce_scatter(ep, flat, "MPI_SUM", "linear", 1, g))
            pn, vn = K.shard_update_plain(g, p0, v0, lr_c, mu_c, inv)
        else:
            pn = torch.empty_like(p0)
            vn = torch.empty_like(v0) if with_mom else None
            ep.run(K.reduce_scatter_update(
                ep, flat, p0, v0, lr_c, mu_c if with_mom else None, inv,
                pn, vn))
        pvar.record("coll_cuda_fused_launches")
        new_p.append(pn)
        new_m.append(vn)
    ps = zl.ShardedState(plan, pshards.metas, pshards.treedef, new_p,
                         comm.rank, comm.size)
    ms = zl.ShardedState(plan, pshards.metas, pshards.treedef, new_m,
                         comm.rank, comm.size) if with_mom else None
    return ps, ms


def allgather_matmul_dev(comm, x, w):
    """Tensor-parallel ``allgather(x) @ w`` (coll/pallas.py:604-654): x
    is this rank's (m, d) row block, w the replicated (d, f) weight;
    returns the full (n*m, f) product in ``torch.promote_types(x, w)``,
    each block multiplied (K6) as the clockwise ring (K2) delivers it.
    Every other case (one rank, shapes other than 2-D, dtypes outside
    the kernels') counts ``coll_cuda_fallthrough`` and composes
    coll/device's allgather with a local product (coll/pallas.py:
    630-642)."""
    ok = (comm.size > 1
          and isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)
          and x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0]
          and x.dtype in _SUPPORTED_DTYPES and w.dtype in _SUPPORTED_DTYPES)
    if not ok:
        pvar.record("coll_cuda_fallthrough")
        return _gather_matmul(comm, x, w)
    _check_buf("allgather_matmul", x)
    _check_buf("allgather_matmul", w)
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt).contiguous(), w.to(dt).contiguous()
    m, n = x.shape[0], comm.size
    out = torch.empty((n * m, w.shape[1]), dtype=dt, device=x.device)
    _account("allgather", comm, x, "ring")
    pvar.record("coll_cuda_fused_launches")
    if x.numel() == 0:
        return out.zero_()
    ep = _arena(comm, "ag", x.numel() * x.element_size())
    ep.run(K.allgather_matmul(ep, x, w, out))
    return out


def _gather_matmul(comm, x, w):
    """coll/device's allgather of x, its blocks stacked along dim 0, then
    ``jnp.dot``'s product with w (the last axis of the gathered x against
    w's second to last) in ``torch.promote_types(x, w)``: the plain
    product the JAX package also leaves outside any kernel. On the card,
    torch's products take floating types only."""
    from ompi_tpu_torch.coll import device

    full = device.allgather_dev(comm, x)
    full = full.reshape((comm.size * x.shape[0],) + tuple(x.shape[1:]))
    dt = torch.promote_types(x.dtype, w.dtype)
    if full.device.type == "cuda" and not dt.is_floating_point:
        raise errors.MPIError(
            errors.ERR_NOT_SUPPORTED,
            f"coll_cuda: allgather_matmul of {x.dtype} @ {w.dtype} outside "
            f"the kernels: torch's products take no {dt} on the card")
    return torch.tensordot(full.to(dt), w.to(dt),
                           dims=([full.dim() - 1], [max(w.dim() - 2, 0)]))


def zero3_gather_matmul_dev(comm, state, rhs):
    """ZeRO stage-3 gather-and-use (coll/pallas.py:657-690): a sharded
    2-D weight W (a one-bucket, one-leaf ShardedState without pad) times
    ``rhs``, through :func:`allgather_matmul_dev` on this rank's row
    block, so W is never gathered whole. A contiguous 1/n slice of a
    row-major (d, f) flatten with d % n == 0 is rows [r*d/n, (r+1)*d/n).
    Returns the (d, k) product, or None (counted in
    ``coll_cuda_fallthrough``) for any other layout."""
    plan = getattr(state, "plan", None)
    shards = getattr(state, "shards", None)
    ok = (comm.size > 1
          and plan is not None and shards is not None
          and len(plan.buckets) == 1
          and len(plan.buckets[0]) == 1
          and plan.padded[0] == plan.elems[0]
          and isinstance(rhs, torch.Tensor) and rhs.dim() == 2
          and rhs.dtype in _SUPPORTED_DTYPES
          and getattr(torch, plan.dtypes[0]) in _SUPPORTED_DTYPES)
    if ok:
        shape = state.metas[plan.buckets[0][0]][0]
        ok = (len(shape) == 2
              and int(shape[0]) % comm.size == 0
              and int(shape[1]) == int(rhs.shape[0]))
    if not ok:
        pvar.record("coll_cuda_fallthrough")
        return None
    block = shards[0].reshape(int(shape[0]) // comm.size, int(shape[1]))
    return allgather_matmul_dev(comm, block, rhs)


class CollCuda(registry.Component):
    """The component coll's comm_select ranks."""

    NAME = "cuda"
    PRIORITY = 60  # coll/pallas's level, above coll/device's 50

    def query(self, comm) -> int:
        if _enable_var.get() != "on" or comm.size == 1:
            return -1
        if not device_plane.active():
            return -1
        return self.PRIORITY

    def slots(self, comm):
        return {
            "allreduce_dev": allreduce_dev,
            "allgather_dev": allgather_dev,
            "reduce_scatter_block_dev": reduce_scatter_block_dev,
            # the fused compute + communication slots
            "fused_rs_update_dev": fused_rs_update_dev,
            "allgather_matmul_dev": allgather_matmul_dev,
            "zero3_gather_matmul_dev": zero3_gather_matmul_dev,
        }
