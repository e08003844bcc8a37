"""OpenSHMEM facade — PGAS over the one-sided window plane.

Port of ``ompi_tpu.shmem`` (reference: oshmem/, the shmem API over spml,
sshmem, memheap, scoll and the atomic frameworks), host-only as there:

  - symmetric heap  = one host window (``osc.Window``) of heap_size bytes
    per PE over a numpy mapping of a /dev/shm file, with a passive
    ``Lock_all`` epoch held open for the session (SHMEM's always-legal
    one-sided model); the memheap key exchange is the window's own
    peer_info exchange.
  - allocation      = a deterministic bump allocator: symmetric because
    every PE makes the same allocations in the same order.
  - put/get/atomics = the window's Put / Rput / Get / Put_strided /
    Get_strided / Fetch_and_op / Compare_and_swap / Accumulate at byte
    displacements, over its active-message service.
  - collectives     = the comm's host collectives (scoll/mpi).
  - wait_until      = a progress-engine spin on local heap memory: the
    window's service applies remote puts into the mapped heap itself from
    inside the sweep.

Where the port differs from the reference:

  - a tensor given as a put's value goes to the host at the origin (one
    ``.cpu()``; bfloat16 through float32), as the reference's
    ``np.ascontiguousarray`` does with a jax array;
  - the heap file is ``{SHM_PREFIX}{jobid}_shmem_{rank}`` under the shm
    dir, so the launcher sweeps what a crashed PE leaves behind;
  - ``finalize`` and ``Ctx.destroy`` catch only ``errors.MPIError`` and
    ``OSError`` around the window's teardown (the reference swallows every
    ``Exception``), so a real fault shows.
"""

from __future__ import annotations

import mmap
import operator
import os
from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.core import cvar, progress, pvar

_heap_var = cvar.register(
    "shmem_heap_size", 1 << 22, int,
    help="Symmetric heap bytes per PE (reference: SHMEM_SYMMETRIC_SIZE "
         "/ memheap size).", level=4)

_ALIGN = 16

_state: Optional["_Shmem"] = None

CMP_EQ, CMP_NE, CMP_GT, CMP_GE, CMP_LT, CMP_LE = (
    "eq", "ne", "gt", "ge", "lt", "le")
_CMPS = {CMP_EQ: operator.eq, CMP_NE: operator.ne, CMP_GT: operator.gt,
         CMP_GE: operator.ge, CMP_LT: operator.lt, CMP_LE: operator.le}


class SymArray:
    """A symmetric object: same shape/dtype/heap offset on every PE.
    ``.local`` is this PE's backing storage (a live view into the
    heap); remote access goes through put/get/atomics with the PE
    number."""

    def __init__(self, offset: int, shape, dtype) -> None:
        self.offset = offset
        self.shape = tuple(np.atleast_1d(np.empty(shape, dtype)).shape) \
            if shape != () else ()
        self.dtype = np.dtype(dtype)

    @property
    def local(self) -> np.ndarray:
        st = _require()
        nbytes = int(np.prod(self.shape or (1,))) * self.dtype.itemsize
        flat = st.heap[self.offset:self.offset + nbytes]
        return flat.view(self.dtype).reshape(self.shape)

    def byte_disp(self, index: int = 0) -> int:
        return self.offset + index * self.dtype.itemsize


class _Shmem:
    def __init__(self, heap_size: int) -> None:
        from ompi_tpu_torch import mpi, osc
        from ompi_tpu_torch.runtime import launcher, rte

        self.comm = mpi.Init()
        # /dev/shm-backed heap (reference: sshmem/mmap symmetric
        # segments) so same-host peers can shmem_ptr-map it directly
        self._shm_dir = launcher.shm_dir()
        self._shm_path = None
        self.heap_arr = self._map_heap(rte.rank, heap_size,
                                       create=True)
        if self.heap_arr is None:  # no shm dir: private heap,
            self.heap_arr = np.zeros(heap_size, dtype=np.uint8)
            # shmem_ptr then degrades to None for every remote PE
        self.win = osc.win_create(self.comm, self.heap_arr, disp_unit=1)
        self.heap = self.heap_arr  # flat uint8 view
        self.brk = 0
        # shmem_ptr peer maps: world rank -> np view (or None)
        rte.modex_send("shmem_host", rte.hostname())
        self._peer_maps = {}
        # session-long passive exposure: SHMEM one-sided is always legal
        self.win.Lock_all()

    def _map_heap(self, world_rank: int, heap_size: int,
                  create: bool):
        from ompi_tpu_torch.runtime import launcher, rte

        if not os.path.isdir(self._shm_dir):
            return None
        # the launcher sweeps the job's files that a crashed PE leaves
        path = os.path.join(
            self._shm_dir,
            f"{launcher.SHM_PREFIX}{rte.jobid}_shmem_{world_rank}")
        try:
            fd = os.open(path, os.O_RDWR | (os.O_CREAT if create
                                            else 0), 0o600)
        except OSError:
            return None
        try:
            if create:
                os.ftruncate(fd, heap_size)
                self._shm_path = path
            mm = mmap.mmap(fd, heap_size)
        finally:
            os.close(fd)
        return np.frombuffer(mm, dtype=np.uint8)


def _require() -> _Shmem:
    if _state is None:
        raise errors.MPIError(errors.ERR_OTHER,
                              "shmem.init() has not been called")
    return _state


# -- setup/query (shmem_init/my_pe/n_pes) ----------------------------------

def init(heap_size: Optional[int] = None) -> None:
    global _state
    if _state is None:
        _state = _Shmem(heap_size or _heap_var.get())


def finalize() -> None:
    global _state
    if _state is not None:
        st = _state
        _state = None
        try:
            st.win.Unlock_all()
            st.win.Free()
        except (errors.MPIError, OSError):  # teardown: the heap goes anyway
            pass
        if st._shm_path:
            try:
                os.unlink(st._shm_path)
            except OSError:
                pass


def my_pe() -> int:
    return _require().comm.rank


def n_pes() -> int:
    return _require().comm.size


# -- symmetric allocation (shmem_malloc / memheap) -------------------------

def zeros(shape, dtype=np.float64) -> SymArray:
    """Symmetric allocation (collective by convention: every PE calls
    in the same order with the same arguments — the memheap contract;
    no communication needed)."""
    st = _require()
    sym = SymArray(st.brk, shape, dtype)
    nbytes = int(np.prod(sym.shape or (1,))) * sym.dtype.itemsize
    new_brk = (st.brk + nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
    if new_brk > st.heap.size:
        raise errors.MPIError(
            errors.ERR_NO_MEM,
            f"symmetric heap exhausted ({st.heap.size} bytes; raise "
            f"--mca shmem_heap_size)")
    st.brk = new_brk
    pvar.record("shmem_alloc_bytes", nbytes)
    return sym


def free(sym: SymArray) -> None:
    """shmem_free: the bump allocator reclaims nothing (reference
    memheap/buddy does; acceptable for the facade — document it)."""


# -- RMA (shmem_put/get and friends over spml) -----------------------------

def _host(value, dtype) -> np.ndarray:
    """A put's value as a C-contiguous numpy array of ``dtype``: a tensor
    goes to the host first (bfloat16 through float32, which holds it
    exactly)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        value = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.ascontiguousarray(value, dtype=dtype)


def _one(value, dtype) -> np.ndarray:
    """A single-element operand (``np.asarray([value], dtype)``)."""
    return _host(value, dtype).reshape(1)


def _win_put(win, dest: SymArray, value, pe: int, index: int) -> None:
    data = _host(value, dest.dtype)
    win.Put(data, pe, disp=dest.byte_disp(index))
    pvar.record("shmem_put")


def _win_get(win, src: SymArray, pe: int, count: Optional[int],
             index: int) -> np.ndarray:
    n = count if count is not None else int(np.prod(src.shape or (1,)))
    out = np.empty(n, dtype=src.dtype)
    win.Get(out, pe, disp=src.byte_disp(index))
    pvar.record("shmem_get")
    return out.reshape(src.shape if count is None else (n,))


def _win_fetch_add(win, dest: SymArray, value, pe: int, index: int):
    result = np.empty(1, dtype=dest.dtype)
    win.Fetch_and_op(_one(value, dest.dtype), result,
                     pe, disp=dest.byte_disp(index), op=op_mod.SUM)
    pvar.record("shmem_atomic")
    return result[0]


def put(dest: SymArray, value, pe: int, index: int = 0) -> None:
    """shmem_putmem: blocking-until-buffered put (delivery ordering to
    one PE preserved by the osc AM channel)."""
    _win_put(_require().win, dest, value, pe, index)


def put_nbi(dest: SymArray, value, pe: int, index: int = 0):
    """shmem_put_nbi: returns a request; quiet() also completes it."""
    st = _require()
    data = _host(value, dest.dtype)
    req = st.win.Rput(data, pe, disp=dest.byte_disp(index))
    pvar.record("shmem_put")
    return req


def get(src: SymArray, pe: int, count: Optional[int] = None,
        index: int = 0) -> np.ndarray:
    """shmem_getmem: blocking get; returns a fresh array."""
    return _win_get(_require().win, src, pe, count, index)


def p(dest: SymArray, value, pe: int, index: int = 0) -> None:
    """shmem_p — single element."""
    put(dest, _one(value, dest.dtype), pe, index)


def g(src: SymArray, pe: int, index: int = 0):
    """shmem_g — single element."""
    return get(src, pe, count=1, index=index)[0]


def iput(dest: SymArray, value, pe: int, tst: int = 1, sst: int = 1,
         nelems: Optional[int] = None, index: int = 0) -> None:
    """shmem_iput: strided put — element i of the (sst-strided) source
    lands at target offset index + i*tst. One AM message (an
    osc strided-put), not a per-element loop."""
    st = _require()
    src = _host(value, dest.dtype).reshape(-1)
    if nelems == 0 or src.size == 0:
        return  # SHMEM: zero elements moves nothing
    if nelems is not None:
        src = src[: (nelems - 1) * sst + 1]
    data = np.ascontiguousarray(src[::sst])
    st.win.Put_strided(data, pe, disp=dest.byte_disp(index),
                       stride=tst)
    pvar.record("shmem_put")


def iget(src: SymArray, pe: int, nelems: int, tst: int = 1,
         sst: int = 1, index: int = 0) -> np.ndarray:
    """shmem_iget: strided get — reads nelems elements at target
    stride sst starting at index; returns them packed at stride tst
    in a fresh array (tst > 1 interleaves zeros, matching the
    local-strided-destination semantics)."""
    st = _require()
    if nelems == 0:
        return np.empty(0, dtype=src.dtype)
    packed = np.empty(nelems, dtype=src.dtype)
    st.win.Get_strided(packed, pe, disp=src.byte_disp(index),
                       stride=sst)
    pvar.record("shmem_get")
    if tst == 1:
        return packed
    out = np.zeros((nelems - 1) * tst + 1, dtype=src.dtype)
    out[::tst] = packed
    return out


# -- contexts (shmem_ctx_create — independent completion streams) ----------

class Ctx:
    """A SHMEM context (reference: oshmem/shmem/c/shmem_ctx*.c,
    spml.h ctx entries): an independent ordering/completion stream.
    Redesign: each context owns its own osc window over the SAME
    symmetric heap — a private AM channel, so quiet() on one context
    never waits for another's traffic (the reference's per-ctx UCX
    worker, as an epoch scope).

    DIVERGENCE from the SHMEM spec, documented: ctx_create is
    COLLECTIVE here (window construction dups a communicator — every
    PE must call it, in the same order). Standard SHMEM contexts are
    local; a program creating contexts on a subset of PEs must use
    the default context on the others or restructure."""

    def __init__(self, comm=None) -> None:
        from ompi_tpu_torch import osc

        st = _require()
        # a team-scoped context (shmem_team_create_ctx) windows over
        # the TEAM's comm: its ops address team-relative PE numbers
        self.win = osc.win_create(comm if comm is not None
                                  else st.comm,
                                  st.heap_arr, disp_unit=1)
        self.win.Lock_all()
        self._open = True

    def put(self, dest: SymArray, value, pe: int,
            index: int = 0) -> None:
        _win_put(self.win, dest, value, pe, index)

    def get(self, src: SymArray, pe: int, count: Optional[int] = None,
            index: int = 0) -> np.ndarray:
        return _win_get(self.win, src, pe, count, index)

    def atomic_fetch_add(self, dest: SymArray, value, pe: int,
                         index: int = 0):
        return _win_fetch_add(self.win, dest, value, pe, index)

    def quiet(self) -> None:
        """Completes THIS context's outstanding ops only."""
        self.win.Flush_all()

    def fence(self) -> None:
        progress.progress()

    def destroy(self) -> None:
        if self._open:
            self._open = False
            try:
                self.win.Unlock_all()
                self.win.Free()
            except (errors.MPIError, OSError):  # teardown
                pass


def ctx_create(options: int = 0) -> Ctx:
    """shmem_ctx_create (options accepted for API parity; the private
    window already gives SERIALIZED/PRIVATE semantics). COLLECTIVE —
    every PE must call, in the same order (see Ctx docstring)."""
    return Ctx()


def ctx_destroy(ctx: Ctx) -> None:
    ctx.destroy()


# -- teams (SHMEM 1.5 shmem_team_* — sub-groups of PEs) --------------------

class Team:
    """A SHMEM team: an ordered subset of PEs with its own collectives
    (reference: oshmem teams over scoll; here the team IS a
    communicator, exactly the scoll/mpi delegation)."""

    def __init__(self, comm) -> None:
        self._comm = comm

    def my_pe(self) -> int:
        return self._comm.rank

    def n_pes(self) -> int:
        return self._comm.size

    def translate_pe(self, pe: int, dest: "Team") -> int:
        """shmem_team_translate_pe: -1 when absent (SHMEM convention)."""
        from ompi_tpu_torch.comm import UNDEFINED

        out = self._comm.group.translate(pe, dest._comm.group)
        return -1 if out == UNDEFINED else out

    def world_pe(self, pe: int) -> int:
        """World PE number of team member ``pe`` (for put/get, which
        always address world PEs — SHMEM's TEAM_WORLD ranking)."""
        st = _require()
        return st.comm.group._index[self._comm.group.ranks[pe]]

    def sync(self) -> None:
        """shmem_team_sync = quiet + team barrier."""
        quiet()
        self._comm.Barrier()

    # -- team collectives (OpenSHMEM 1.5 team-based API) -----------------
    # Reference: scoll serves any active set/team
    # (oshmem/mca/scoll/scoll.h:158-159) and the reductions are
    # team-based in the API (oshmem/shmem/c/shmem_reduce.c:384-396,
    # shmem_*_reduce(shmem_team_t team, ...)). Every world collective
    # below delegates here with TEAM_WORLD.
    def broadcast(self, dest: SymArray, source: SymArray,
                  root: int) -> None:
        if self._comm.rank == root:
            dest.local[...] = source.local
        self._comm.Bcast(dest.local, root=root)

    def fcollect(self, dest: SymArray, source: SymArray) -> None:
        """shmem_fcollect: equal-size blocks concatenated in team PE
        order."""
        self._comm.Allgather(np.array(source.local, copy=True),
                             dest.local)

    def collect(self, dest: SymArray, source: SymArray,
                nelems: int) -> None:
        """shmem_collect: variable-size contributions in team PE
        order (Allgatherv over the delegated comm)."""
        cbuf = np.zeros(self._comm.size, np.int64)
        self._comm.Allgather(np.asarray([nelems], np.int64), cbuf)
        self._comm.Allgatherv(
            np.array(source.local.reshape(-1)[:nelems], copy=True),
            dest.local.reshape(-1), [int(c) for c in cbuf])

    def alltoall(self, dest: SymArray, source: SymArray) -> None:
        """shmem_alltoall: team PE i's block j lands in PE j's block
        i (equal block sizes)."""
        n = self._comm.size
        flat = source.local.reshape(-1)
        if flat.size % n:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"alltoall: {flat.size} elements not divisible by "
                f"{n} PEs")
        self._comm.Alltoall(np.array(flat, copy=True),
                            dest.local.reshape(-1))

    def reduce(self, dest: SymArray, source: SymArray, op) -> None:
        """shmem_*_reduce core (shmem_reduce.c:384-396 — reductions
        are team-scoped in the OpenSHMEM 1.5 API)."""
        self._comm.Allreduce(np.array(source.local, copy=True),
                             dest.local, op=op)

    def sum_reduce(self, dest: SymArray, source: SymArray) -> None:
        self.reduce(dest, source, op_mod.SUM)

    def prod_reduce(self, dest: SymArray, source: SymArray) -> None:
        self.reduce(dest, source, op_mod.PROD)

    def min_reduce(self, dest: SymArray, source: SymArray) -> None:
        self.reduce(dest, source, op_mod.MIN)

    def max_reduce(self, dest: SymArray, source: SymArray) -> None:
        self.reduce(dest, source, op_mod.MAX)

    def and_reduce(self, dest: SymArray, source: SymArray) -> None:
        self.reduce(dest, source, op_mod.BAND)

    def or_reduce(self, dest: SymArray, source: SymArray) -> None:
        self.reduce(dest, source, op_mod.BOR)

    def xor_reduce(self, dest: SymArray, source: SymArray) -> None:
        self.reduce(dest, source, op_mod.BXOR)

    # pre-1.5 naming kept for symmetry with the world forms
    def sum_to_all(self, dest: SymArray, source: SymArray) -> None:
        self.reduce(dest, source, op_mod.SUM)

    def create_ctx(self) -> "Ctx":
        """shmem_team_create_ctx (SHMEM 1.5; COLLECTIVE over the
        team, per this module's ctx divergence note): ops on the
        returned context address TEAM-relative PE numbers."""
        return Ctx(self._comm)

    def destroy(self) -> None:
        self._comm.free()


def team_world() -> Team:
    return Team(_require().comm)


def team_split_strided(parent: Team, start: int, stride: int,
                       size: int) -> Optional[Team]:
    """shmem_team_split_strided: members are parent PEs start,
    start+stride, ...; returns None on non-members (SHMEM returns
    SHMEM_TEAM_INVALID)."""
    members = [start + i * stride for i in range(size)]
    me = parent._comm.rank
    color = 0 if me in members else None
    from ompi_tpu_torch.comm import UNDEFINED

    sub = parent._comm.split(
        color if color is not None else UNDEFINED,
        key=members.index(me) if me in members else 0)
    return Team(sub) if sub is not None else None


def team_split_2d(parent: Team, xrange: int):
    """shmem_team_split_2d: factor the parent into a 2-D grid, PE p
    at (x, y) = (p % xrange, p // xrange); returns (x_team, y_team) —
    the calling PE's row (shared y) and column (shared x) teams.
    Reference: oshmem/shmem/c/shmem_team_split_2d role."""
    if xrange < 1:
        raise errors.MPIError(errors.ERR_ARG,
                              f"team_split_2d: xrange {xrange} < 1")
    me = parent._comm.rank
    x, y = me % xrange, me // xrange
    xteam = parent._comm.split(y, key=x)
    yteam = parent._comm.split(x, key=y)
    return Team(xteam), Team(yteam)


# -- shmem_ptr (direct same-host load/store access) ------------------------

def ptr(sym: SymArray, pe: int) -> Optional[np.ndarray]:
    """shmem_ptr: a live numpy view of PE ``pe``'s symmetric object
    for direct load/store, or None when no such mapping exists
    (different host, or no /dev/shm backing) — the reference returns
    NULL exactly the same way. Same-host mapping attaches the peer's
    sshmem segment (reference: oshmem/mca/sshmem/mmap)."""
    st = _require()
    from ompi_tpu_torch.runtime import rte

    world = st.comm.group.ranks[pe]
    if world == rte.rank:
        return sym.local
    if world not in st._peer_maps:
        heap = None
        if (st._shm_path is not None
                and rte.modex_recv("shmem_host", world)
                == rte.hostname()):
            heap = st._map_heap(world, st.heap.size, create=False)
        st._peer_maps[world] = heap
    heap = st._peer_maps[world]
    if heap is None:
        return None
    nbytes = int(np.prod(sym.shape or (1,))) * sym.dtype.itemsize
    flat = heap[sym.offset:sym.offset + nbytes]
    return flat.view(sym.dtype).reshape(sym.shape)


# -- memory ordering (shmem_fence/quiet) -----------------------------------

def quiet() -> None:
    """shmem_quiet: all outstanding puts/atomics from this PE are
    complete at their targets (spml fence+quiet -> osc Flush_all)."""
    _require().win.Flush_all()


def fence() -> None:
    """shmem_fence: ordering only; the osc AM channel already delivers
    per-target in order, so fence is quiet's ordering half — a no-op
    beyond a progress poke."""
    progress.progress()


# -- point synchronization (shmem_wait_until) ------------------------------

def wait_until(sym: SymArray, cmp: str, value, index: int = 0) -> None:
    """Spin the progress engine until the LOCAL symmetric location
    satisfies cmp (remote puts land via the window's progress
    callback)."""
    fn = _CMPS[cmp]
    loc = sym.local.reshape(-1)
    progress.wait_until(lambda: bool(fn(loc[index], value)))


def test(sym: SymArray, cmp: str, value, index: int = 0) -> bool:
    """shmem_test (oshmem/shmem/c/shmem_wait_ivars.c family): one
    progress sweep, then a nonblocking check of the local location."""
    progress.progress()
    fn = _CMPS[cmp]
    return bool(fn(sym.local.reshape(-1)[index], value))


def test_all(sym: SymArray, cmp: str, value,
             indices=None) -> bool:
    """shmem_test_all over a vector of symmetric locations."""
    progress.progress()
    fn = _CMPS[cmp]
    loc = sym.local.reshape(-1)
    idxs = range(loc.size) if indices is None else indices
    return all(bool(fn(loc[i], value)) for i in idxs)


def test_any(sym: SymArray, cmp: str, value, indices=None):
    """shmem_test_any: index of SOME satisfied location, else None."""
    progress.progress()
    fn = _CMPS[cmp]
    loc = sym.local.reshape(-1)
    idxs = range(loc.size) if indices is None else indices
    for i in idxs:
        if fn(loc[i], value):
            return i
    return None


def test_some(sym: SymArray, cmp: str, value, indices=None) -> list:
    """shmem_test_some: every currently-satisfied index."""
    progress.progress()
    fn = _CMPS[cmp]
    loc = sym.local.reshape(-1)
    idxs = range(loc.size) if indices is None else indices
    return [i for i in idxs if fn(loc[i], value)]


def wait_until_any(sym: SymArray, cmp: str, value, indices=None):
    """shmem_wait_until_any."""
    # materialize once: the polls re-iterate, so a one-shot iterable
    # (generator) would be exhausted after the first sweep
    indices = None if indices is None else list(indices)
    out: list = []

    def check() -> bool:
        got = test_any(sym, cmp, value, indices)
        if got is not None:
            out.append(got)
            return True
        return False

    progress.wait_until(check)
    return out[0]


def wait_until_all(sym: SymArray, cmp: str, value,
                   indices=None) -> None:
    """shmem_wait_until_all."""
    indices = None if indices is None else list(indices)
    progress.wait_until(lambda: test_all(sym, cmp, value, indices))


# -- signaled put (spml_put_signal, spml.h:280,1037;
#    oshmem/shmem/c/shmem_put_signal.c) ------------------------------------

SIGNAL_SET = "set"
SIGNAL_ADD = "add"


def _post_signal(st: "_Shmem", sig_addr: SymArray, signal, sig_op: str,
                 pe: int) -> None:
    op = op_mod.SUM if sig_op == SIGNAL_ADD else op_mod.REPLACE
    st.win.Accumulate(_one(signal, sig_addr.dtype), pe,
                      disp=sig_addr.byte_disp(0), op=op)
    pvar.record("shmem_atomic")


def put_signal(dest: SymArray, value, sig_addr: SymArray, signal,
               sig_op: str = SIGNAL_SET, pe: int = 0,
               index: int = 0) -> None:
    """shmem_put_signal: data put + signal update as one ordered pair
    — the osc AM channel to one PE preserves delivery order, so the
    target's signal word updates only AFTER the data is visible (the
    consumer needs no barrier: signal_wait_until then read)."""
    st = _require()
    _win_put(st.win, dest, value, pe, index)
    _post_signal(st, sig_addr, signal, sig_op, pe)


def put_signal_nbi(dest: SymArray, value, sig_addr: SymArray, signal,
                   sig_op: str = SIGNAL_SET, pe: int = 0,
                   index: int = 0):
    """shmem_put_signal_nbi: nonblocking form; quiet() completes it.
    The data/signal pair still posts in order on the AM channel."""
    st = _require()
    data = _host(value, dest.dtype)
    req = st.win.Rput(data, pe, disp=dest.byte_disp(index))
    pvar.record("shmem_put")
    _post_signal(st, sig_addr, signal, sig_op, pe)
    return req


def signal_fetch(sig_addr: SymArray) -> int:
    """shmem_signal_fetch: read the LOCAL signal word."""
    progress.progress()
    return sig_addr.local.reshape(-1)[0]


def signal_wait_until(sig_addr: SymArray, cmp: str, value):
    """shmem_signal_wait_until: returns the satisfying signal value."""
    wait_until(sig_addr, cmp, value, index=0)
    return sig_addr.local.reshape(-1)[0]


# -- atomics (shmem_atomic_* over osc accumulate) --------------------------

def atomic_fetch_add(dest: SymArray, value, pe: int, index: int = 0):
    return _win_fetch_add(_require().win, dest, value, pe, index)


def atomic_add(dest: SymArray, value, pe: int, index: int = 0) -> None:
    atomic_fetch_add(dest, value, pe, index)


def atomic_compare_swap(dest: SymArray, cond, value, pe: int,
                        index: int = 0):
    st = _require()
    result = np.empty(1, dtype=dest.dtype)
    st.win.Compare_and_swap(
        _one(value, dest.dtype), _one(cond, dest.dtype), result, pe,
        disp=dest.byte_disp(index))
    pvar.record("shmem_atomic")
    return result[0]


def atomic_swap(dest: SymArray, value, pe: int, index: int = 0):
    """shmem_atomic_swap: unconditional exchange (REPLACE fetch-op)."""
    st = _require()
    result = np.empty(1, dtype=dest.dtype)
    st.win.Fetch_and_op(_one(value, dest.dtype), result,
                        pe, disp=dest.byte_disp(index),
                        op=op_mod.REPLACE)
    pvar.record("shmem_atomic")
    return result[0]


def atomic_fetch(src: SymArray, pe: int, index: int = 0):
    """shmem_atomic_fetch: atomic read (NO_OP fetch-op — ordered with
    other atomics at the target, unlike a plain g())."""
    st = _require()
    result = np.empty(1, dtype=src.dtype)
    st.win.Fetch_and_op(np.zeros(1, dtype=src.dtype), result, pe,
                        disp=src.byte_disp(index), op=op_mod.NO_OP)
    pvar.record("shmem_atomic")
    return result[0]


def atomic_set(dest: SymArray, value, pe: int, index: int = 0) -> None:
    """shmem_atomic_set: atomic write (REPLACE, result discarded)."""
    atomic_swap(dest, value, pe, index)


# -- distributed locks (shmem_set_lock / test_lock / clear_lock) -----------
# Reference: oshmem/shmem/c/shmem_lock.c — a symmetric long used as a
# lock word. Redesign: the lock word lives on PE 0 (every PE spins the
# same location, the simple-common-case of the reference's MCS-like
# queue) and acquisition is atomic compare-and-swap 0 -> my_pe+1.

def set_lock(lock: SymArray, index: int = 0) -> None:
    me = my_pe() + 1
    while True:
        prev = atomic_compare_swap(lock, 0, me, 0, index)
        if prev == 0:
            return
        progress.progress()


def test_lock(lock: SymArray, index: int = 0) -> bool:
    """True = lock acquired (returns immediately)."""
    return atomic_compare_swap(lock, 0, my_pe() + 1, 0, index) == 0


def clear_lock(lock: SymArray, index: int = 0) -> None:
    quiet()  # releases happen-after the critical section's puts
    atomic_set(lock, 0, 0, index)


# -- collectives (scoll/mpi: delegate to the comm's coll table) ------------

def barrier_all() -> None:
    """shmem_barrier_all = quiet + barrier."""
    st = _require()
    quiet()
    st.comm.Barrier()


def broadcast(dest: SymArray, source: SymArray, root: int) -> None:
    """shmem_broadcast across all PEs (scoll/mpi -> coll bcast)."""
    team_world().broadcast(dest, source, root)


def fcollect(dest: SymArray, source: SymArray) -> None:
    """shmem_fcollect: concatenate equal-size blocks from every PE."""
    team_world().fcollect(dest, source)


def sum_to_all(dest: SymArray, source: SymArray) -> None:
    _to_all(dest, source, op_mod.SUM)


def max_to_all(dest: SymArray, source: SymArray) -> None:
    _to_all(dest, source, op_mod.MAX)


def min_to_all(dest: SymArray, source: SymArray) -> None:
    _to_all(dest, source, op_mod.MIN)


def prod_to_all(dest: SymArray, source: SymArray) -> None:
    _to_all(dest, source, op_mod.PROD)


def and_to_all(dest: SymArray, source: SymArray) -> None:
    _to_all(dest, source, op_mod.BAND)


def or_to_all(dest: SymArray, source: SymArray) -> None:
    _to_all(dest, source, op_mod.BOR)


def xor_to_all(dest: SymArray, source: SymArray) -> None:
    _to_all(dest, source, op_mod.BXOR)


def alltoall(dest: SymArray, source: SymArray) -> None:
    """shmem_alltoall: PE i's block j lands in PE j's block i (equal
    block sizes; scoll/mpi -> coll alltoall)."""
    team_world().alltoall(dest, source)


def collect(dest: SymArray, source: SymArray, nelems: int) -> None:
    """shmem_collect: concatenate variable-size contributions in PE
    order (Allgatherv over the delegated comm)."""
    team_world().collect(dest, source, nelems)


def _to_all(dest: SymArray, source: SymArray, op) -> None:
    team_world().reduce(dest, source, op)
