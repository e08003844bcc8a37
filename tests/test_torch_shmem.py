"""The port's OpenSHMEM facade (``ompi_tpu_torch.shmem``) against the JAX
package's (``ompi_tpu.shmem``).

Every program of ``tests/test_shmem.py`` (16) runs on both packages, with
its own assertions, and saves what it computed (the symmetric objects'
local contents, the gets, the fetched atomics; where the program leaves a
value to arrival order, a sorted or summed form of it); the saved results
are compared bitwise. Each program runs on 2, 3 and 4 ranks where it is
defined there (the first-3-PE team needs 3, the 2 x 2 grid 4). One job per
package and n runs every program in turn, each between its own ``init``
and ``finalize``: the reference's in its rank pool, the port's under
``ompi_tpu_torch.runtime.launcher``. The three programs the reference
runs isolated (signalled puts and the test family, no barrier between
producer and consumer) share one isolated reference job on 2 ranks and
end the port's 2-rank job. In the port, the values of ``put``, ``p``,
``iput`` and ``put_signal`` are CPU tensors (the port takes a tensor
value to the host at the origin); in the reference, numpy.

Also ``tests/test_mpit.py``'s two shmem example cases: the port's
``examples/shmem_hello.py`` (2 ranks) and ``shmem_ring.py`` (3) print
the reference examples' lines.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: program -> the rank counts it runs on (tests/test_shmem.py's own n
#: among them)
PROGRAMS = {
    "put_get_and_barrier": (2, 3, 4),
    "atomics_and_wait_until": (2, 3, 4),
    "collectives": (2, 3, 4),
    "swap_fetch_set_atomics": (2, 3, 4),
    "locks_serialize_critical_sections": (2, 3, 4),
    "alltoall_collect_and_reductions": (2, 3, 4),
    "ctx_independent_streams": (2, 3, 4),
    "strided_iput_iget": (2, 3, 4),
    "shmem_ptr_same_host": (2, 3, 4),
    "teams_split_and_collectives": (2, 3, 4),
    "team_scoped_collective_breadth": (3, 4),
    "team_split_2d_row_col": (4,),
    "team_create_ctx_team_relative_pes": (2, 3, 4),
}
#: the programs the reference runs isolated, on 2 ranks
ISOLATED = ("put_signal_producer_consumer_no_barrier",
            "put_signal_add_and_nbi", "shmem_test_family")
NS = (2, 3, 4)

#: shared verbatim by both packages' rank programs; the prologue binds
#: shmem, np, comm, rank, size, val(x) (the value a put takes: numpy in
#: the reference, a CPU tensor in the port) and out_dir, pkg
_SHARED = """
def prog_put_get_and_barrier():
    shmem.init(heap_size=1 << 16)
    me, n = shmem.my_pe(), shmem.n_pes()
    dst = shmem.zeros(8, dtype=np.int64)
    # ring put: write my id into my right neighbor's heap
    shmem.put(dst, val(np.full(8, me, dtype=np.int64)), (me + 1) % n)
    shmem.barrier_all()
    assert (dst.local == (me - 1) % n).all(), dst.local
    # remote get from the left neighbor
    got = shmem.get(dst, (me - 1) % n)
    assert (got == (me - 2) % n).all(), got
    out = {"dst": dst.local.copy(), "got": got}
    shmem.finalize()
    return out

def prog_atomics_and_wait_until():
    shmem.init(heap_size=1 << 16)
    me, n = shmem.my_pe(), shmem.n_pes()
    counter = shmem.zeros(1, dtype=np.int64)
    flag = shmem.zeros(1, dtype=np.int64)
    shmem.barrier_all()
    # every PE fetch-adds on PE 0's counter
    old = shmem.atomic_fetch_add(counter, 1, 0)
    assert 0 <= old < n
    shmem.barrier_all()
    # every fetch-add is done and no PE can swap before the flags go out
    mid = counter.local.copy()
    if me == 0:
        assert counter.local[0] == n, counter.local
        total = counter.local[0]
        for pe in range(1, n):
            shmem.p(flag, val(int(total)), pe)
        shmem.quiet()
    else:
        shmem.wait_until(flag, shmem.CMP_EQ, n)
    # cswap: only one PE wins
    won = shmem.atomic_compare_swap(counter, n, 999, 0)
    shmem.barrier_all()
    if me == 0:
        assert counter.local[0] == 999
    out = {"olds": np.sort(comm.allgather(int(old))), "mid": mid,
           "flag": flag.local.copy(), "counter": counter.local.copy(),
           "wins": np.array([sum(comm.allgather(int(won == n)))])}
    shmem.finalize()
    return out

def prog_collectives():
    shmem.init(heap_size=1 << 16)
    me, n = shmem.my_pe(), shmem.n_pes()
    src = shmem.zeros(4, dtype=np.float64)
    dst = shmem.zeros(4, dtype=np.float64)
    src.local[:] = me + 1
    shmem.barrier_all()
    shmem.sum_to_all(dst, src)
    assert (dst.local == sum(range(1, n + 1))).all(), dst.local
    # fcollect
    coll = shmem.zeros(4 * n, dtype=np.float64)
    shmem.fcollect(coll, src)
    for pe in range(n):
        assert (coll.local[4 * pe:4 * (pe + 1)] == pe + 1).all()
    # broadcast from PE 1
    b = shmem.zeros(4, dtype=np.float64)
    shmem.broadcast(b, src, root=1)
    assert (b.local == 2.0).all(), b.local
    out = {"dst": dst.local.copy(), "coll": coll.local.copy(),
           "b": b.local.copy()}
    shmem.finalize()
    return out

def prog_swap_fetch_set_atomics():
    shmem.init(heap_size=1 << 16)
    me, n = shmem.my_pe(), shmem.n_pes()
    slot = shmem.zeros(1, dtype=np.int64)
    shmem.barrier_all()
    got = np.zeros(2, np.int64)
    if me == 1:
        shmem.atomic_set(slot, 41, 0)
        prev = shmem.atomic_swap(slot, 42, 0)
        assert prev == 41, prev
        got[:] = prev, shmem.atomic_fetch(slot, 0)
        assert got[1] == 42
    shmem.barrier_all()
    if me == 0:
        assert slot.local[0] == 42, slot.local
    out = {"slot": slot.local.copy(), "got": got}
    shmem.finalize()
    return out

def prog_locks_serialize_critical_sections():
    shmem.init(heap_size=1 << 16)
    me, n = shmem.my_pe(), shmem.n_pes()
    lock = shmem.zeros(1, dtype=np.int64)
    total = shmem.zeros(1, dtype=np.int64)
    shmem.barrier_all()
    for _ in range(5):
        shmem.set_lock(lock)
        # read-modify-write under the lock (racy without it)
        cur = shmem.g(total, 0)
        shmem.p(total, val(cur + 1), 0)
        shmem.quiet()
        shmem.clear_lock(lock)
    shmem.barrier_all()
    if me == 0:
        assert total.local[0] == 5 * n, total.local
    # test_lock on a held lock reports failure
    shmem.set_lock(lock)
    held = shmem.test_lock(lock)
    assert not held or n == 1
    shmem.clear_lock(lock)
    shmem.barrier_all()
    out = {"total": total.local.copy(), "lock": lock.local.copy(),
           "held": np.array([held])}
    shmem.finalize()
    return out

def prog_alltoall_collect_and_reductions():
    shmem.init(heap_size=1 << 18)
    me, n = shmem.my_pe(), shmem.n_pes()
    src = shmem.zeros(n * 2, dtype=np.int64)
    dst = shmem.zeros(n * 2, dtype=np.int64)
    src.local[:] = np.arange(n * 2) + 100 * me
    shmem.barrier_all()
    shmem.alltoall(dst, src)
    for j in range(n):
        want = np.arange(me * 2, me * 2 + 2) + 100 * j
        assert (dst.local[j * 2:(j + 1) * 2] == want).all(), dst.local
    # variable collect: PE i contributes i+1 elements
    csrc = shmem.zeros(n, dtype=np.int64)
    csrc.local[:me + 1] = me
    cdst = shmem.zeros(n * (n + 1) // 2, dtype=np.int64)
    shmem.barrier_all()
    shmem.collect(cdst, csrc, me + 1)
    off = 0
    for j in range(n):
        assert (cdst.local[off:off + j + 1] == j).all(), cdst.local
        off += j + 1
    # bit reductions
    b = shmem.zeros(1, dtype=np.int64)
    o = shmem.zeros(1, dtype=np.int64)
    b.local[0] = 1 << me
    shmem.or_to_all(o, b)
    assert o.local[0] == (1 << n) - 1, o.local
    p = shmem.zeros(1, dtype=np.int64)
    b.local[0] = me + 2
    shmem.prod_to_all(p, b)
    import math
    assert p.local[0] == math.prod(range(2, n + 2)), p.local
    # the rest of the world reductions
    rest = {}
    for name in ("sum", "max", "min", "and", "xor"):
        r = shmem.zeros(1, dtype=np.int64)
        getattr(shmem, name + "_to_all")(r, b)
        rest[name] = r.local.copy()
    out = {"dst": dst.local.copy(), "cdst": cdst.local.copy(),
           "or": o.local.copy(), "prod": p.local.copy(), **rest}
    shmem.finalize()
    return out

def prog_ctx_independent_streams():
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    a = shmem.zeros(n, np.int64)
    b = shmem.zeros(n, np.int64)
    ctx = shmem.ctx_create()
    nxt = (me + 1) % n
    shmem.put(a, val(np.asarray([me + 1], np.int64)), nxt, index=me)
    ctx.put(b, np.asarray([10 * (me + 1)], np.int64), nxt, index=me)
    ctx.quiet()
    shmem.quiet()
    shmem.barrier_all()
    prev = (me - 1) % n
    assert a.local[prev] == prev + 1
    assert b.local[prev] == 10 * (prev + 1)
    # peer nxt's slot me was written by ME (value me+1)
    got = ctx.get(a, nxt)
    assert got[me] == me + 1, got
    # add 5 to peer nxt's (empty) slot nxt; my slot me then holds 5
    x = ctx.atomic_fetch_add(a, 5, nxt, index=nxt)
    assert x == 0
    shmem.barrier_all()
    assert a.local[me] == 5, a.local
    shmem.ctx_destroy(ctx)
    shmem.barrier_all()
    out = {"a": a.local.copy(), "b": b.local.copy(), "got": got,
           "x": np.array([x])}
    shmem.finalize()
    return out

def prog_strided_iput_iget():
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    dst = shmem.zeros(12, np.float64)
    nxt = (me + 1) % n
    # every 3rd slot of the target gets [me, me+1, me+2, me+3]
    shmem.iput(dst, val(np.arange(4, dtype=np.float64) + me), nxt, tst=3)
    shmem.quiet()
    shmem.barrier_all()
    prev = (me - 1) % n
    exp = np.zeros(12)
    exp[::3] = np.arange(4) + prev
    np.testing.assert_array_equal(dst.local, exp)
    first = dst.local.copy()
    # strided read-back: every 3rd element of the peer's dst
    got = shmem.iget(dst, nxt, nelems=4, sst=3)
    np.testing.assert_array_equal(got, np.arange(4) + me)
    spread = shmem.iget(dst, nxt, nelems=3, sst=3, tst=2)
    # source stride: take every 2nd element of an 8-vector
    src8 = np.arange(8, dtype=np.float64) * 10
    shmem.barrier_all()
    shmem.iput(dst, src8, nxt, tst=1, sst=2, nelems=4)
    shmem.quiet()
    shmem.barrier_all()
    np.testing.assert_array_equal(dst.local[:4], src8[::2])
    shmem.barrier_all()
    out = {"first": first, "got": got, "spread": spread,
           "dst": dst.local.copy()}
    shmem.finalize()
    return out

def prog_shmem_ptr_same_host():
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    sym = shmem.zeros(4, np.int32)
    sym.local[:] = 100 + me
    shmem.barrier_all()
    nxt = (me + 1) % n
    view = shmem.ptr(sym, nxt)
    assert view is not None, "same-host peers must be mappable"
    np.testing.assert_array_equal(view, np.full(4, 100 + nxt))
    seen = view.copy()
    # direct store through the pointer, visible at the owner
    view[0] = 7000 + me
    shmem.barrier_all()
    prev = (me - 1) % n
    assert sym.local[0] == 7000 + prev, sym.local
    # self-ptr is the local view
    assert shmem.ptr(sym, me) is not None
    shmem.barrier_all()
    out = {"seen": seen, "sym": sym.local.copy()}
    shmem.finalize()
    return out

def prog_teams_split_and_collectives():
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    world = shmem.team_world()
    assert world.my_pe() == me and world.n_pes() == n
    evens = shmem.team_split_strided(world, 0, 2, (n + 1) // 2)
    out = {"member": np.array([evens is not None])}
    if me % 2 == 0:
        assert evens is not None
        assert evens.my_pe() == me // 2
        assert evens.world_pe(evens.my_pe()) == me
        assert world.translate_pe(me, evens) == me // 2
        s = shmem.zeros(2, np.int64)
        d = shmem.zeros(2, np.int64)
        s.local[:] = me + 1
        evens.sync()
        evens.sum_to_all(d, s)
        exp = sum(r + 1 for r in range(0, n, 2))
        assert (d.local == exp).all(), d.local
        out["d"] = d.local.copy()
        out["pes"] = np.array([evens.my_pe(), evens.n_pes(),
                               world.translate_pe(me, evens)])
        evens.destroy()
    else:
        assert evens is None
        out["d"] = np.zeros(2, np.int64)
        out["pes"] = np.array([world.translate_pe(me, world), n, -1])
    shmem.barrier_all()
    shmem.finalize()
    return out

def prog_team_scoped_collective_breadth():
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    world = shmem.team_world()
    # sub-team of the first 3 PEs
    sub = shmem.team_split_strided(world, 0, 1, 3)
    out = {}
    if me < 3:
        t = sub.my_pe()
        # fcollect: equal blocks in team order
        s = shmem.zeros(2, np.int64); s.local[:] = t + 1
        d = shmem.zeros(6, np.int64)
        sub.sync()
        sub.fcollect(d, s)
        assert (d.local == [1, 1, 2, 2, 3, 3]).all(), d.local
        # collect: variable contributions (t+1 elems each)
        vs = shmem.zeros(3, np.int64); vs.local[:] = 10 * (t + 1)
        vd = shmem.zeros(6, np.int64)
        sub.collect(vd, vs, t + 1)
        assert (vd.local == [10, 20, 20, 30, 30, 30]).all(), vd.local
        # alltoall: 1 elem per peer
        a = shmem.zeros(3, np.int64)
        a.local[:] = [100 * t + j for j in range(3)]
        ad = shmem.zeros(3, np.int64)
        sub.alltoall(ad, a)
        assert (ad.local == [t, 100 + t, 200 + t]).all(), ad.local
        # broadcast from team root 1
        b = shmem.zeros(2, np.int64)
        if t == 1: b.local[:] = 77
        sub.broadcast(b, b, 1)
        assert (b.local == 77).all(), b.local
        # the reduction op family
        r = shmem.zeros(1, np.int64); r.local[:] = t + 2
        o = shmem.zeros(1, np.int64)
        red = []
        sub.sum_reduce(o, r);  assert o.local[0] == 2 + 3 + 4
        red.append(o.local[0])
        sub.prod_reduce(o, r); assert o.local[0] == 2 * 3 * 4
        red.append(o.local[0])
        sub.min_reduce(o, r);  assert o.local[0] == 2
        red.append(o.local[0])
        sub.max_reduce(o, r);  assert o.local[0] == 4
        red.append(o.local[0])
        sub.and_reduce(o, r);  assert o.local[0] == (2 & 3 & 4)
        red.append(o.local[0])
        sub.or_reduce(o, r);   assert o.local[0] == (2 | 3 | 4)
        red.append(o.local[0])
        sub.xor_reduce(o, r);  assert o.local[0] == (2 ^ 3 ^ 4)
        red.append(o.local[0])
        sub.sum_to_all(o, r)
        red.append(o.local[0])
        out = {"d": d.local.copy(), "vd": vd.local.copy(),
               "ad": ad.local.copy(), "b": b.local.copy(),
               "red": np.array(red)}
        sub.destroy()
    else:
        out = {"d": np.zeros(6, np.int64), "vd": np.zeros(6, np.int64),
               "ad": np.zeros(3, np.int64), "b": np.zeros(2, np.int64),
               "red": np.zeros(8, np.int64)}
    shmem.barrier_all()
    shmem.finalize()
    return out

def prog_team_split_2d_row_col():
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    world = shmem.team_world()
    xt, yt = shmem.team_split_2d(world, 2)   # x = me % 2, y = me // 2
    assert xt.n_pes() == 2 and yt.n_pes() == 2
    assert xt.my_pe() == me % 2 and yt.my_pe() == me // 2
    s = shmem.zeros(1, np.int64); s.local[:] = me + 1
    row = shmem.zeros(1, np.int64)
    col = shmem.zeros(1, np.int64)
    xt.sync(); xt.sum_reduce(row, s)
    yt.sync(); yt.sum_reduce(col, s)
    y, x = me // 2, me % 2
    assert row.local[0] == (2 * y + 1) + (2 * y + 2), row.local
    assert col.local[0] == (x + 1) + (x + 3), col.local
    out = {"row": row.local.copy(), "col": col.local.copy(),
           "pes": np.array([xt.my_pe(), yt.my_pe(), xt.world_pe(0),
                            yt.world_pe(1)])}
    xt.destroy(); yt.destroy()
    shmem.barrier_all()
    shmem.finalize()
    return out

def prog_team_create_ctx_team_relative_pes():
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    world = shmem.team_world()
    sub = shmem.team_split_strided(world, 0, 1, 2)  # PEs 0,1
    d = shmem.zeros(4, np.int64)
    got = np.zeros(1, np.int64)
    if me < 2:
        ctx = sub.create_ctx()
        t = sub.my_pe()
        peer = 1 - t                       # TEAM-relative target
        ctx.put(d, 500 + t, peer, index=t)
        ctx.quiet()
        sub.sync()
        # peer (team pe 1-t) wrote slot (1-t) of MY d
        assert d.local[1 - t] == 500 + (1 - t), d.local
        # I wrote peer's slot t: read it back remotely
        got = ctx.get(d, peer, count=1, index=t)
        assert got[0] == 500 + t, got
        ctx.destroy()
        sub.destroy()
    shmem.barrier_all()
    out = {"d": d.local.copy(), "got": got}
    shmem.finalize()
    return out

def prog_put_signal_producer_consumer_no_barrier():
    shmem.init(1 << 16)
    data = shmem.zeros(8, np.float64)
    sig = shmem.zeros(1, np.int64)
    if rank == 0:
        payload = np.arange(8, dtype=np.float64) + 1
        shmem.put_signal(data, val(payload), sig, 7,
                         shmem.SIGNAL_SET, pe=1)
    elif rank == 1:
        got = shmem.signal_wait_until(sig, shmem.CMP_EQ, 7)
        assert got == 7
        np.testing.assert_array_equal(
            data.local, np.arange(8, dtype=np.float64) + 1)
    shmem.barrier_all()  # teardown alignment only
    out = {"data": data.local.copy(), "sig": sig.local.copy()}
    shmem.finalize()
    return out

def prog_put_signal_add_and_nbi():
    shmem.init(1 << 16)
    data = shmem.zeros(4, np.int32)
    sig = shmem.zeros(1, np.int64)
    fetched = np.zeros(1, np.int64)
    if rank == 0:
        r1 = shmem.put_signal_nbi(data, np.full(4, 5, np.int32), sig,
                                  1, shmem.SIGNAL_ADD, pe=1)
        r2 = shmem.put_signal_nbi(data, np.full(4, 9, np.int32), sig,
                                  1, shmem.SIGNAL_ADD, pe=1)
        shmem.quiet()
    elif rank == 1:
        shmem.signal_wait_until(sig, shmem.CMP_EQ, 2)  # both landed
        assert (data.local == 9).all()  # second put ordered after first
        fetched[0] = shmem.signal_fetch(sig)
        assert fetched[0] == 2
    shmem.barrier_all()
    out = {"data": data.local.copy(), "sig": sig.local.copy(),
           "fetched": fetched}
    shmem.finalize()
    return out

def prog_shmem_test_family():
    shmem.init(1 << 16)
    flags = shmem.zeros(4, np.int64)
    seen = np.zeros(4, np.int64)
    if rank == 0:
        assert shmem.test(flags, shmem.CMP_EQ, 1) is False
        # set peer flags one by one; wait_until_any/all observe them
        shmem.p(flags, 1, pe=1, index=2)
        shmem.p(flags, 1, pe=1, index=0)
        shmem.barrier_all()
    else:
        i = shmem.wait_until_any(flags, shmem.CMP_EQ, 1)
        assert i in (0, 2)
        shmem.wait_until_all(flags, shmem.CMP_EQ, 1, indices=[0, 2])
        some = shmem.test_some(flags, shmem.CMP_EQ, 1)
        assert sorted(some) == [0, 2], some
        assert shmem.test_all(flags, shmem.CMP_EQ, 1,
                              indices=[0, 2])
        assert not shmem.test_all(flags, shmem.CMP_EQ, 1)
        seen[:] = (len(some), shmem.test_any(flags, shmem.CMP_EQ, 0),
                   shmem.test_all(flags, shmem.CMP_EQ, 1),
                   shmem.test(flags, shmem.CMP_EQ, 1, index=2))
        assert seen[1] in (1, 3)
        shmem.barrier_all()
    out = {"flags": flags.local.copy(), "seen": seen}
    shmem.finalize()
    return out

def run(progs):
    for prog in progs:
        for k, v in globals()["prog_" + prog]().items():
            np.save(f"{out_dir}/{pkg}_{prog}_{k}_r{rank}.npy",
                    np.asarray(v))
"""

_REF_BODY = """
from ompi_tpu import shmem
pkg, out_dir = "ref", {out_dir!r}

def val(x):
    return x
{shared}
run({progs!r})
"""

_PORT_PROG = """
import numpy as np
import torch
from ompi_tpu_torch import mpi, shmem
comm = mpi.Init()
rank, size = comm.rank, comm.size
pkg, out_dir = "port", {out_dir!r}

def val(x):
    # a tensor value goes to the host at the origin
    return torch.as_tensor(np.asarray(x))
{shared}
run({progs!r})
mpi.Finalize()
"""


def _progs(n: int):
    return [p for p, ns in PROGRAMS.items() if n in ns]


_jobs = {}


def _results(n: int, tmp_path_factory):
    """Run both packages' jobs once per n; returns the output dir."""
    if n not in _jobs:
        out = tmp_path_factory.mktemp(f"shmem_n{n}")
        progs = _progs(n)
        run_ranks(_REF_BODY.format(shared=_SHARED, progs=progs,
                                   out_dir=str(out)), n, timeout=300)
        if n == 2:
            run_ranks(_REF_BODY.format(shared=_SHARED, progs=ISOLATED,
                                       out_dir=str(out)), n, timeout=300,
                      isolate=True)
            progs = progs + list(ISOLATED)
        with tempfile.NamedTemporaryFile("w", suffix=".py",
                                         delete=False) as fh:
            fh.write(textwrap.dedent(_PORT_PROG.format(
                shared=_SHARED, progs=progs, out_dir=str(out))))
            path = fh.name
        try:
            rc = port_launcher.launch(
                [sys.executable, path], n,
                mca={"device_plane_platform": "cpu"}, timeout=300)
        finally:
            os.unlink(path)
        assert rc == 0, f"port job exited {rc}"
        _jobs[n] = out
    return _jobs[n]


CASES = [(n, p) for n in NS for p in _progs(n)] + [(2, p) for p in ISOLATED]


@pytest.mark.parametrize("n,prog", CASES,
                         ids=[f"{p}-n{n}" for n, p in CASES])
def test_shmem_program_equal_to_reference(n, prog, tmp_path_factory):
    """Each program of tests/test_shmem.py passes its own assertions in
    both packages, and every rank's saved results are bitwise equal."""
    out = _results(n, tmp_path_factory)
    names = sorted(p.name[len("ref_"):] for p in out.glob(f"ref_{prog}_*"))
    assert len(names) % n == 0 and names, names
    for name in names:
        ref = np.load(out / f"ref_{name}")
        got = np.load(out / f"port_{name}")
        assert ref.dtype == got.dtype and ref.shape == got.shape, \
            (name, ref.dtype, got.dtype, ref.shape, got.shape)
        assert ref.tobytes() == got.tobytes(), (name, ref, got)


def _lines(pkg: str, example: str, n: int) -> list:
    path = (os.path.join("ompi_tpu_torch", "examples", f"{example}.py")
            if pkg == "ompi_tpu_torch" else f"examples/{example}.py")
    mca = ["--mca", "device_plane_platform", "cpu"] \
        if pkg == "ompi_tpu_torch" else []
    env = dict(os.environ)
    env.pop("PYTHONUNBUFFERED", None)  # each rank writes its lines at exit
    r = subprocess.run(
        [sys.executable, "-m", f"{pkg}.runtime.launcher", "-n", str(n),
         "--timeout", "90", *mca, path], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
    return r.stdout.splitlines()


@pytest.mark.parametrize("example,n", [("shmem_hello", 2),
                                       ("shmem_ring", 3)])
def test_shmem_example_prints_reference_lines(example, n):
    """tests/test_mpit.py's shmem examples: the port's example runs on n
    ranks and prints the reference example's lines (PE 0's in order)."""
    ref = _lines("ompi_tpu", example, n)
    got = _lines("ompi_tpu_torch", example, n)
    assert sorted(got) == sorted(ref), (got, ref)
    pe0 = [ln for ln in ref if ln.startswith("PE 0")]
    assert [ln for ln in got if ln.startswith("PE 0")] == pe0
    assert len(got) == (n if example == "shmem_hello" else 11 + n)
