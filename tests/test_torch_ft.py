"""The port's ULFM plane (``ft/``, the store's fault commands, the
launcher's FT mode, ob1's failure and revocation sweeps, the
collective-entry gate) against the JAX package's: the counterparts of
``tests/test_ft.py``'s cases, and two cases of the port's own device
transport.

Every case runs under the launcher with ``--mca ft 1`` on the CPU
platform; a rank SIGKILLs itself at a known point and the survivors must
detect it (the launcher's waitpid, heartbeat staleness), error their
in-flight requests, agree consistently, shrink and go on. Each kill is a
job of its own; the cases without a kill (revoke, the nonblocking
agreements) share one 2-rank job per package, whose records must be
equal. The agreement under a kill also runs in the reference, and both
packages must decide the same (value, failed) split.
``test_mpi_abort_kills_job`` has its counterpart in
``tests/test_torch_sessions.py`` (the Abort jobs).

The port's own hazard: its device transport is the counter-file arena
protocol, where a dead peer never answers. On the CPU arenas, a survivor
inside a device Allreduce when a peer is killed must raise
ProcFailedError naming that peer within a few heartbeat periods (not
after ``device_plane_timeout``), freeing the broken comm must return,
and the shrunken comm's next device Allreduce must be bitwise the host
linear fold.
"""

import json
import os
import sys
import tempfile
import textwrap

import pytest

from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

FT = {"ft": "1"}

_PRELUDE = '''
import json, os, signal, time
import numpy as np
from ompi_tpu_torch import errors, mpi
comm = mpi.Init()
rank = comm.rank
doc = {}


def dump():
    with open(os.path.join(OUT, f"r{rank}.json"), "w") as fh:
        json.dump(doc, fh)
'''


def _port(body, n: int, out, mca=None, timeout=90) -> int:
    """Run a program (a string, or a tuple of pieces each dedented on its
    own) under the port's launcher with ``ft`` on; returns the job's exit
    code."""
    pieces = (body,) if isinstance(body, str) else body
    src = f"OUT = {str(out)!r}\n" + textwrap.dedent(_PRELUDE) \
        + "".join(textwrap.dedent(p) for p in pieces) \
        + "\ndump()\nmpi.Finalize()\n"
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    try:
        return port_launcher.launch(
            [sys.executable, path], n,
            mca={"device_plane_platform": "cpu", **FT, **(mca or {})},
            timeout=timeout)
    finally:
        os.unlink(path)


def _docs(out, ranks):
    return {r: json.loads((out / f"r{r}.json").read_text()) for r in ranks}


_WAIT_FAILED = '''
deadline = time.monotonic() + 20
while {dead} not in comm.get_failed():
    time.sleep(0.02)
    assert time.monotonic() < deadline, "failure never detected"
'''


def test_detect_kill_and_shrink(tmp_path):
    """Rank 2 dies; the survivors detect it, shrink, and allreduce on
    the new comm; the launcher recorded a signal death and the job
    exits 0."""
    assert _port(('''
        comm.Barrier()
        if rank == 2:
            os.kill(os.getpid(), signal.SIGKILL)
    ''', _WAIT_FAILED.format(dead=2), '''
        new = comm.shrink()
        out = np.zeros(1, dtype=np.int64)
        new.Allreduce(np.array([new.rank + 1], dtype=np.int64), out)
        from ompi_tpu_torch import ft
        doc.update(size=new.size, sum=int(out[0]),
                   faults={str(k): v for k, v in ft.faults().items()})
    '''), 3, tmp_path) == 0
    for d in _docs(tmp_path, (0, 1)).values():
        assert d["size"] == 2 and d["sum"] == 3  # 1 + 2 over two survivors
        assert d["faults"] == {"2": "killed by signal 9"}


def test_pending_recv_errors_on_failure(tmp_path):
    """A receive posted towards a rank that dies completes with
    MPI_ERR_PROC_FAILED instead of hanging."""
    assert _port('''
        comm.Barrier()
        if rank == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        buf = np.zeros(4, dtype=np.float32)
        try:
            comm.Recv(buf, source=1, tag=99)
            doc["raised"] = None
        except errors.ProcFailedError as exc:
            doc["raised"] = exc.error_class
    ''', 2, tmp_path) == 0
    from ompi_tpu_torch import errors

    assert _docs(tmp_path, (0,))[0]["raised"] == errors.ERR_PROC_FAILED


_AGREE = '''
comm.Barrier()
if rank == 2:
    os.kill(os.getpid(), signal.SIGKILL)
''' + _WAIT_FAILED.format(dead=2) + '''
flag = 0b11 if rank == 0 else 0b01
value, failed = comm.agree(flag)
other = 1 - rank
comm.send((value, tuple(failed)), dest=other, tag=5)
doc.update(value=value, failed=list(failed),
           peer=list(comm.recv(source=other, tag=5)))
'''


def test_agree_consistent_with_dead_rank(tmp_path):
    """MPIX_Comm_agree: the survivors contribute different flags; both
    see the same AND and the same failed set, as the reference
    decides."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    assert _port(_AGREE, 3, port) == 0
    run_ranks(f"OUT = {str(ref)!r}\ndoc = {{}}\nimport json, os, signal, "
              "time\n" + _AGREE + "\nwith open(os.path.join(OUT, "
              "f'r{rank}.json'), 'w') as fh:\n    json.dump(doc, fh)\n",
              3, mca=FT, timeout=90)
    for r in (0, 1):
        dp = json.loads((port / f"r{r}.json").read_text())
        dr = json.loads((ref / f"r{r}.json").read_text())
        assert dp == dr
        assert dp["value"] == 0b01 and dp["failed"] == [2]
        assert dp["peer"] == [dp["value"], dp["failed"]]


def test_wildcard_recv_fails_pending(tmp_path):
    """An ANY_SOURCE receive with an unacknowledged failure completes
    with ERR_PROC_FAILED_PENDING; after ack_failed it can be posted again
    and matched from a live sender."""
    assert _port('''
        from ompi_tpu_torch.pml import request as rq
        comm.Barrier()
        if rank == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        if rank == 1:
            comm.recv(source=0, tag=8)
            comm.Send(np.array([7], dtype=np.int32), dest=0, tag=9)
        if rank == 0:
            buf = np.zeros(1, dtype=np.int32)
            try:
                comm.Recv(buf, source=rq.ANY_SOURCE, tag=9)
                doc["raised"] = False
            except errors.ProcFailedError:
                doc["raised"] = True
            doc["acked"] = comm.ack_failed()
            comm.send(None, dest=1, tag=8)
            comm.Recv(buf, source=rq.ANY_SOURCE, tag=9)
            doc["got"] = int(buf[0])
    ''', 3, tmp_path) == 0
    d = _docs(tmp_path, (0,))[0]
    assert d["raised"] and d["acked"] >= 1 and d["got"] == 7


def test_iagree_with_sigkill_mid_agreement(tmp_path):
    """A rank dies after the others post iagree: their requests complete
    with blocking agree's decided value and failed set."""
    assert _port('''
        from ompi_tpu_torch.core import progress
        comm.Barrier()
        if rank == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        reqs = [comm.iagree(0b11 if rank == 0 else 0b01)]
        acc = float(np.arange(2000).sum())
        progress.wait_until(lambda: all(r.completed for r in reqs),
                            timeout=60)
        value, failed = reqs[0].result
        other = 1 - rank
        comm.send((value, tuple(failed)), dest=other, tag=7)
        doc.update(value=value, failed=list(failed), acc=acc,
                   peer=list(comm.recv(source=other, tag=7)))
    ''', 3, tmp_path) == 0
    for d in _docs(tmp_path, (0, 1)).values():
        assert d["value"] == 0b01 and d["failed"] == [2]
        assert d["acc"] == 1999000.0 and d["peer"] == [0b01, [2]]


def test_idup_with_dead_root_errors(tmp_path):
    """Idup's cid receive from a dead rank 0 surfaces as an error at the
    request's wait, never as a comm without a cid."""
    assert _port(('''
        from ompi_tpu_torch.core import progress
        comm.Barrier()
        if rank == 0:
            os.kill(os.getpid(), signal.SIGKILL)
    ''', _WAIT_FAILED.format(dead=0), '''
        progress.progress()
        req = comm.Idup()
        try:
            req.wait(timeout=60)
            doc["raised"] = False
        except errors.MPIError:
            doc["raised"] = True
    '''), 3, tmp_path) == 0
    for d in _docs(tmp_path, (1, 2)).values():
        assert d["raised"]


# -- the cases without a kill: one 2-rank job per package -----------------

_NOKILL = '''
# -- test_revoke_interrupts_pending_recv
comm.Barrier()
if rank == 0:
    time.sleep(0.3)
    comm.revoke()
    doc["revoked"] = comm.is_revoked()
else:
    buf = np.zeros(1, dtype=np.int32)
    try:
        comm.Recv(buf, source=0, tag=42)
        doc["revoked"] = False
    except errors.RevokedError:
        doc["revoked"] = True
new = comm.shrink()
out = np.zeros(1, dtype=np.int64)
new.Allreduce(np.array([1], dtype=np.int64), out)
doc["shrunk_sum"] = int(out[0])

# -- test_iagree_overlaps_p2p_and_matches_blocking
flag = 0b110 if rank == 0 else 0b011
req = new.iagree(flag)
peer = 1 - rank
pings = []
for k in range(3):
    new.send(("ping", k, rank), dest=peer, tag=40 + k)
    pings.append(list(new.recv(source=peer, tag=40 + k)))
req.wait(timeout=60)
doc.update(pings=pings, iagree=list(req.result[:1]) + [req.result[1]],
           agree=new.agree(0b111)[0])

# -- test_concurrent_iagree_different_comms
sub = new.dup()
ra = new.iagree(0b11)
rb = sub.iagree(0b10 if rank == 0 else 0b11)
if rank == 0:
    ra.wait(timeout=60); rb.wait(timeout=60)
else:
    rb.wait(timeout=60); ra.wait(timeout=60)
doc.update(ra=[ra.result[0], ra.result[1]], rb=[rb.result[0], rb.result[1]])
'''


@pytest.fixture(scope="module")
def nokill(tmp_path_factory):
    """[(port doc, reference doc)] per rank of the 2-rank program."""
    port = tmp_path_factory.mktemp("ft_port")
    ref = tmp_path_factory.mktemp("ft_ref")
    assert _port("from ompi_tpu_torch import errors\n" + _NOKILL, 2,
                 port) == 0
    run_ranks(f"OUT = {str(ref)!r}\ndoc = {{}}\nimport json, os, time\n"
              "from ompi_tpu import errors\n" + _NOKILL
              + "\nwith open(os.path.join(OUT, f'r{rank}.json'), 'w') as "
              "fh:\n    json.dump(doc, fh)\n", 2, mca=FT, timeout=90)
    return [(json.loads((port / f"r{r}.json").read_text()),
             json.loads((ref / f"r{r}.json").read_text())) for r in (0, 1)]


def test_revoke_interrupts_pending_recv(nokill):
    """MPIX_Comm_revoke on one rank errors a peer's blocked receive with
    MPI_ERR_REVOKED; shrink works on the revoked comm."""
    for dp, dr in nokill:
        assert (dp["revoked"], dp["shrunk_sum"]) \
            == (dr["revoked"], dr["shrunk_sum"]) == (True, 2)


def test_iagree_overlaps_p2p_and_matches_blocking(nokill):
    for r, (dp, dr) in enumerate(nokill):
        assert dp["pings"] == dr["pings"] \
            == [["ping", k, 1 - r] for k in range(3)]
        assert dp["iagree"] == dr["iagree"] == [0b010, []]
        assert dp["agree"] == dr["agree"] == 0b111


def test_concurrent_iagree_different_comms(nokill):
    for dp, dr in nokill:
        assert dp["ra"] == dr["ra"] == [0b11, []]
        assert dp["rb"] == dr["rb"] == [0b10, []]


# -- the port's device transport under a kill -----------------------------

_DEVICE = '''
import torch
from ompi_tpu_torch import ft
from ompi_tpu_torch.core import cvar
dc = comm.dup()
x = torch.from_numpy(np.arange(1000, dtype=np.float32) * (rank + 1) / 7)
dc.Allreduce(x, deterministic="linear")
dc.Barrier()
if rank == 2:
    time.sleep(0.5)
    os.kill(os.getpid(), signal.SIGKILL)
t0 = time.monotonic()
try:
    dc.Allreduce(x, deterministic="linear")
    doc["raised"] = None
except errors.ProcFailedError as exc:
    doc["raised"] = list(exc.failed_ranks)
    doc["msg"] = str(exc)
doc["raise_s"] = time.monotonic() - t0
doc["timeout_s"] = cvar.get("device_plane_timeout")
doc["hb_s"] = ft.detector._timeout_var.get()
t0 = time.monotonic()
dc.free()
doc["free_s"] = time.monotonic() - t0
new = comm.shrink()
xs = [np.arange(1000, dtype=np.float32) * (w + 1) / 7
      for w in new.group.ranks]
want = xs[0].copy()
for v in xs[1:]:
    want = want + v
got = new.Allreduce(torch.from_numpy(xs[new.rank]), deterministic="linear")
doc["bitwise"] = got.numpy().tobytes() == want.tobytes()
doc["size"] = new.size
'''


@pytest.fixture(scope="module")
def device_kill(tmp_path_factory):
    out = tmp_path_factory.mktemp("ft_device")
    assert _port(_DEVICE, 3, out, mca={"device_plane": "on",
                                       "coll_cuda": "on"}) == 0
    return _docs(out, (0, 1))


def test_dead_peer_inside_device_allreduce_raises(device_kill):
    """A survivor inside a device Allreduce (coll/cuda 'linear', the CPU
    arenas) when rank 2 is killed raises ProcFailedError naming comm
    rank 2 within a few heartbeat periods, not after
    ``device_plane_timeout``."""
    for d in device_kill.values():
        assert d["raised"] == [2], d
        assert d["raise_s"] < 5 * d["hb_s"] < d["timeout_s"], d


def test_free_comm_with_dead_member_returns(device_kill):
    """Freeing the comm whose arenas have a dead member returns (no
    barrier over it), and the shrunken comm's next device Allreduce is
    bitwise the host linear fold."""
    for d in device_kill.values():
        assert d["free_s"] < 10, d
        assert d["size"] == 2 and d["bitwise"], d
