"""ob1's tool attachments in the port — PERUSE (``pml/peruse.py``), the
indexed matching engine (``pml/custommatch.py``) and pml/v message
logging (``pml/vprotocol.py``) — against the JAX package's: the
counterparts of ``tests/test_peruse.py``'s 5 cases,
``tests/test_vprotocol.py``'s 3 and ``tests/test_custommatch.py``'s 4.

In this process: the PERUSE subscription table, both index structures
against the reference's on the reference test's sequences and on seeded
random post / arrival sequences against the linear walk, and pml/v's
refusal of a tensor that is not on the CPU. Launcher jobs, one per
package on 2 ranks under ``--mca pml_v 1 --mca pml_ob1_matching
indexed`` with a determinant directory, run the same program
(:data:`_PROG`), each part on a communicator of its own (``comm.dup()``)
so that the parts' logs and queues do not mix: the late-receiver and
late-sender PERUSE events, the send log and determinants, the replay,
persistence and truncation, indexed matching with wildcards and the
probe family, and seeded mixed ANY_SOURCE / ANY_TAG schedules run under
``list`` and ``indexed`` (a comm's queues take the engine the cvar names
when the comm is made). The port's job also sends float32 and bfloat16
CPU tensors through ``pml/accel_p2p`` under pml/v: the log, reassembled,
holds the tensors' bytes, and ``resend`` into fresh tensors gives the
same bits.
"""

import json
import os
import sys
import tempfile
from collections import deque, namedtuple

import numpy as np
import pytest

from ompi_tpu_torch import errors
from ompi_tpu_torch.pml import custommatch as P_cm
from ompi_tpu_torch.pml import peruse as P_peruse
from ompi_tpu_torch.pml.request import ANY_SOURCE, ANY_TAG
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

#: the accel_p2p chunk of the port job's tensor part (several chunks a
#: tensor)
CHUNK = 1024

_PROG = '''
import json, os, time
import numpy as np
from {pkg} import mpi
from {pkg}.core import cvar
from {pkg}.pml import peruse, vprotocol
from {pkg}.runtime import rte
PORT = {port}
comm = mpi.Init()
rank, size = comm.rank, comm.size
peer_world = comm.group.ranks[1 - rank]
doc = {{"installed": vprotocol.installed() is not None,
        "matching": cvar.get("pml_ob1_matching")}}
v = vprotocol.installed()


def record(c, tags):
    evs = []

    def cb(e):
        if e["ctx"] == c.cid * 2 and e["tag"] in tags:
            evs.append([e["event"], e["tag"], e.get("size")])
    for ev in peruse.EVENTS:
        peruse.subscribe(ev, cb)
    return evs, cb


def stop(cb):
    for ev in peruse.EVENTS:
        peruse.unsubscribe(ev, cb)


# -- test_late_receiver_events: the message parks as unexpected
c = comm.dup()
evs, cb = record(c, (42,))
if rank == 0:
    c.Barrier()
    got = np.zeros(4, np.float32)
    c.Recv(got, 1, tag=42)
else:
    c.Send(np.ones(4, np.float32), 0, tag=42)
    c.Barrier()
stop(cb)
doc["late_receiver"] = evs
c.Barrier()

# -- test_late_sender_events: the receive parks as posted
c = comm.dup()
evs, cb = record(c, (5,))
if rank == 0:
    req = c.Irecv(np.zeros(4, np.float32), 1, tag=5)
    c.Barrier()
    req.wait()
else:
    c.Barrier()
    c.Send(np.ones(4, np.float32), 0, tag=5)
stop(cb)
doc["late_sender"] = evs
doc["peruse_active_after"] = peruse.active
c.Barrier()

# -- test_send_log_and_determinants
c = comm.dup()
d0 = len(v.determinants)
if rank == 0:
    for i in range(3):
        c.Send(np.full(4, i, dtype=np.int64), dest=1, tag=i)
    c.send({{"last": True}}, dest=1, tag=99)
    doc["log_c1"] = [[e[0], e[2]] for e in v.send_log[peer_world]
                     if e[1] == c.cid]
else:
    buf = np.zeros(4, dtype=np.int64)
    vals = []
    for i in range(3):
        c.Recv(buf, source=mpi.ANY_SOURCE, tag=i)
        vals.append(int(buf[0]))
    doc["vals"] = vals
    doc["obj"] = c.recv(source=0, tag=99)
    doc["dets_c1"] = [list(d) for d in v.determinants[d0:]]
c.Barrier()

# -- test_replay_reconstructs_lost_data
c = comm.dup()
rng = np.random.RandomState(42)
payloads = [rng.randint(0, 1000, size=16).astype(np.int64) for _ in range(4)]
if rank == 0:
    for i, p in enumerate(payloads):
        c.Send(p, dest=1, tag=10 + i)
    c.Barrier()
    assert c.recv(source=1, tag=500) == "replay please"
    doc["resent"] = v.resend(peer_world, c)
else:
    d0 = len(v.determinants)
    buf = np.zeros(16, dtype=np.int64)
    for i in range(4):
        c.Recv(buf, source=0, tag=10 + i)
    dets = list(v.determinants[d0:])
    c.Barrier()
    c.send("replay please", dest=0, tag=500)
    replayed = []
    for src, tag, count in dets:
        rb = np.zeros(16, dtype=np.int64)
        c.Recv(rb, source=src, tag=tag)
        replayed.append(rb.copy())
    doc["replay_equal"] = [bool(np.array_equal(p, r))
                           for p, r in zip(payloads, replayed)]
    doc["replay_dets"] = [list(d) for d in dets]
c.Barrier()

# -- test_determinant_persistence_and_truncation
c = comm.dup()
if rank == 0:
    for i in range(5):
        c.Send(np.full(2, i, dtype=np.int32), dest=1, tag=i)
    c.Barrier()
    log = v.send_log[peer_world]
    doc["log_before"] = len(log) >= 5
    v.truncate(peer_world, keep_last=2)
    doc["log_after"] = [[e[1] == c.cid, e[2]] for e in v.send_log[peer_world]]
else:
    buf = np.zeros(2, dtype=np.int32)
    for i in range(5):
        c.Recv(buf, source=0, tag=i)
    c.Barrier()
    dets = vprotocol.load_determinants(rte.jobid, rte.rank)
    doc["persisted"] = [len(dets) == len(v.determinants),
                        [list(d) for d in dets[-5:]]]
c.Barrier()

# -- test_indexed_matching_end_to_end
c = comm.dup()
if rank == 0:
    for tag in (9, 3, 7, 5):
        c.Send(np.full(4, float(tag), np.float32), dest=1, tag=tag)
    c.Send(np.full(2, 99.0, np.float32), dest=1, tag=3)
else:
    bufs = {{t: np.zeros(4, np.float32) for t in (3, 5, 7, 9)}}
    reqs = [c.Irecv(bufs[t], source=0, tag=t) for t in (3, 5, 7, 9)]
    any_buf = np.zeros(2, np.float32)
    r_any = c.Irecv(any_buf, source=mpi.ANY_SOURCE, tag=mpi.ANY_TAG)
    mpi.wait_all(reqs + [r_any], timeout=60)
    doc["indexed"] = [[float(bufs[t][0]) for t in (3, 5, 7, 9)],
                      any_buf.tolist()]
c.Barrier()
if rank == 0:
    c.Send(np.arange(3, dtype=np.int32), dest=1, tag=42)
else:
    st = c.Probe(source=0, tag=42)
    msg, mst = c.Mprobe(source=0, tag=42)
    got = np.zeros(3, np.int32)
    c.Mrecv(msg, got)
    doc["probe"] = [st.tag, st.count, got.tolist()]
c.Barrier()

# -- test_indexed_vs_linear_equivalence_fuzz, and the mixed schedules:
# rank 1 posts the plan's receives (ANY_SOURCE and ANY_TAG mixed in by
# the seed) before the sends start ("posted"), after every message has
# arrived ("unexpected"), or as they come ("racing")
def schedule(c, seed, order):
    rng = np.random.default_rng(seed)
    n_msgs = 40
    plan = [(int(rng.integers(0, 5)), int(rng.integers(1, 50)))
            for _ in range(n_msgs)]
    wild = rng.random((n_msgs, 2)) < (0.15, 0.1)
    if rank == 0:
        if order == "posted":
            c.Recv(np.zeros(1, np.int32), source=1, tag=1000)
        for i, (tag, sz) in enumerate(plan):
            c.Send(np.full(sz, float(i), np.float32), dest=1, tag=tag)
        c.Send(np.zeros(1, np.int32), dest=1, tag=1001)
        return None
    if order == "unexpected":
        c.Recv(np.zeros(1, np.int32), source=0, tag=1001)
    reqs = []
    for i, (tag, sz) in enumerate(plan):
        buf = np.zeros(50, np.float32)
        src = mpi.ANY_SOURCE if wild[i, 0] else 0
        t = mpi.ANY_TAG if wild[i, 1] else tag
        reqs.append((buf, c.Irecv(buf, source=src, tag=t)))
    if order == "posted":
        c.Send(np.zeros(1, np.int32), dest=0, tag=1000)
    mpi.wait_all([r for _, r in reqs], timeout=90)
    if order != "unexpected":
        c.Recv(np.zeros(1, np.int32), source=0, tag=1001)
    return [[float(b[0]), r.status.tag, r.status.count] for b, r in reqs]


doc["fuzz"] = {{}}
for mode in ("list", "indexed"):
    cvar.set("pml_ob1_matching", mode)
    for seed, order in ((7, "racing"), (11, "posted"), (13, "unexpected"),
                        (17, "posted"), (19, "unexpected")):
        c = comm.dup()
        doc["fuzz"][f"{{mode}}_{{seed}}_{{order}}"] = schedule(c, seed, order)
        c.Barrier()
cvar.set("pml_ob1_matching", "indexed")

if PORT:  # device-tensor Sends (CPU tensors) through accel_p2p under pml/v
    import torch
    from ompi_tpu_torch.compat import tensor_to_numpy
    c = comm.dup()
    g = torch.Generator().manual_seed(5)
    ts = [torch.randn(1000, generator=g),
          torch.randn(1500, generator=g).to(torch.bfloat16)]
    if rank == 0:
        for t in ts:
            c.Send(t, dest=1, tag=7)
        entries = [e for e in v.send_log[peer_world] if e[1] == c.cid]
        got, i = [], 0
        for t in ts:
            hdr = np.frombuffer(entries[i][3][0], np.int64)
            nchunks = -(-t.numel() * t.element_size() // {chunk})
            body = b"".join(e[3][0] for e in entries[i + 1:i + 1 + nchunks])
            got.append([int(hdr[0]) == t.numel(),
                        body == tensor_to_numpy(t).tobytes(),
                        [e[3][3].name if e[3][3] is not None else None
                         for e in entries[i:i + 2]]])
            i += 1 + nchunks
        doc["tensor_log"] = [got, len(entries)]
        c.Barrier()
        doc["tensor_resent"] = v.resend(peer_world, c)
    else:
        first = [torch.empty_like(t) for t in ts]
        for t in first:
            c.Recv(t, source=0, tag=7)
        c.Barrier()
        again = [torch.empty_like(t) for t in ts]
        for t in again:
            c.Recv(t, source=0, tag=7)
        doc["tensor_bits"] = [
            bool(np.array_equal(tensor_to_numpy(a), tensor_to_numpy(t)))
            and bool(np.array_equal(tensor_to_numpy(b), tensor_to_numpy(t)))
            for a, b, t in zip(first, again, ts)]
    c.Barrier()
with open(os.path.join({out!r}, f"doc_r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
mpi.Finalize()
'''


def _mca(logdir: str) -> dict:
    return {"pml_v": "1", "pml_ob1_matching": "indexed",
            "vprotocol_log_dir": logdir}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """(reference dir, port dir): the 2-rank program once per package."""
    ref = tmp_path_factory.mktemp("pmlt_ref")
    port = tmp_path_factory.mktemp("pmlt_port")
    run_ranks(_PROG.format(pkg="ompi_tpu", port=False, out=str(ref),
                           chunk=CHUNK), 2, mca=_mca(str(ref / "vlog")),
              prelude=False, timeout=240)
    src = _PROG.format(pkg="ompi_tpu_torch", port=True, out=str(port),
                       chunk=CHUNK)
    with tempfile.NamedTemporaryFile("w", suffix=".py",
                                     delete=False) as fh:
        fh.write(src)
        path = fh.name
    mca = dict(_mca(str(port / "vlog")), device_plane_platform="cpu",
               pml_accel_chunk_bytes=str(CHUNK))
    try:
        rc = port_launcher.launch([sys.executable, path], 2, mca=mca,
                                  timeout=240)
    finally:
        os.unlink(path)
    assert rc == 0, f"port job exited {rc}"
    return ref, port


def _docs(jobs):
    ref, port = jobs
    return [(json.loads((port / f"doc_r{r}.json").read_text()),
             json.loads((ref / f"doc_r{r}.json").read_text()))
            for r in range(2)]


# ---------------------------------------------------------------------------
# in process


@pytest.fixture
def fresh_peruse():
    P_peruse.reset_for_testing()
    yield
    P_peruse.reset_for_testing()


def test_subscribe_validates_event(fresh_peruse):
    with pytest.raises(ValueError):
        P_peruse.subscribe("bogus", lambda ev: None)


def test_active_flag_tracks_subscriptions(fresh_peruse):
    assert not P_peruse.active
    cb = lambda ev: None  # noqa: E731
    P_peruse.subscribe(P_peruse.REQ_COMPLETE, cb)
    assert P_peruse.active
    P_peruse.unsubscribe(P_peruse.REQ_COMPLETE, cb)
    assert not P_peruse.active


def test_fire_without_subscribers_is_noop(fresh_peruse):
    P_peruse.fire(P_peruse.REQ_COMPLETE, ctx=0)  # must not raise
    got = []
    P_peruse.subscribe(P_peruse.REQ_COMPLETE, got.append)
    P_peruse.fire(P_peruse.REQ_COMPLETE, ctx=3, src=1, tag=2, size=8)
    assert got == [{"ctx": 3, "src": 1, "tag": 2, "size": 8,
                    "event": P_peruse.REQ_COMPLETE}]
    from ompi_tpu.pml import peruse as R_peruse

    assert P_peruse.EVENTS == R_peruse.EVENTS


R = namedtuple("R", "want_src want_tag")


class UX:
    def __init__(self, src, tag):
        self.hdr = (0, 0, src, tag, 0, 8, 0, 0)


def test_posted_index_unit():
    """The reference test's sequence on both packages' PostedIndex."""
    from ompi_tpu.pml import custommatch as R_cm

    for cm in (P_cm, R_cm):
        q = cm.PostedIndex()
        a, b, c, d = R(1, 5), R(ANY_SOURCE, 5), R(1, ANY_TAG), \
            R(ANY_SOURCE, ANY_TAG)
        for r in (a, b, c, d):
            q.append(r)
        assert len(q) == 4 and list(q) == [a, b, c, d]
        assert q.match_incoming(1, 5) is a  # the oldest of four buckets
        assert q.match_incoming(1, 5) is b
        assert q.match_incoming(1, 5) is c
        assert q.match_incoming(1, -3) is None  # internal tags: no ANY_TAG
        assert q.match_incoming(2, 9) is d
        assert not q
        e = R(2, 2)
        q.append(e)
        q.remove(e)  # a tombstone
        assert e not in q and q.match_incoming(2, 2) is None
        with pytest.raises(ValueError):
            q.remove(e)


def test_unexpected_index_unit():
    from ompi_tpu.pml import custommatch as R_cm

    for cm in (P_cm, R_cm):
        q = cm.UnexpectedIndex()
        u1, u2, u3 = UX(0, 7), UX(1, 7), UX(0, -4)
        for u in (u1, u2, u3):
            q.append(u)
        assert q.find(0, 7, take=False) is u1  # a peek
        assert q.find(0, 7, take=True) is u1
        assert q.find(ANY_SOURCE, 7, take=True) is u2
        assert q.find(0, ANY_TAG, take=False) is None
        assert q.find(0, -4, take=True) is u3
        assert len(q) == 0


def _hdr_matches(want_src, want_tag, src, tag):
    """ob1's linear-walk predicate (``Ob1._hdr_matches``)."""
    if want_src != ANY_SOURCE and want_src != src:
        return False
    if want_tag != ANY_TAG and want_tag != tag:
        return False
    return not (want_tag == ANY_TAG and tag < 0)


@pytest.mark.parametrize("seed", range(6))
def test_indexed_equals_linear_on_mixed_wildcards(seed):
    """Seeded random interleavings of posts and arrivals, every ANY_SOURCE
    / ANY_TAG mix and internal (negative) tags: each arrival takes the
    posted receive the linear walk takes, and each post the unexpected
    frag it takes, in the port's and the reference's engines alike;
    probes peek the same frag."""
    from ompi_tpu.pml import custommatch as R_cm

    rng = np.random.default_rng(seed)
    engines = [(P_cm.PostedIndex(), P_cm.UnexpectedIndex()),
               (R_cm.PostedIndex(), R_cm.UnexpectedIndex())]
    posted, unexpected = deque(), deque()
    for step in range(400):
        src = int(rng.integers(0, 3))
        tag = int(rng.integers(-2, 4))
        if rng.random() < 0.5:  # a receive is posted (or probes)
            want_src = ANY_SOURCE if rng.random() < 0.3 else src
            want_tag = ANY_TAG if rng.random() < 0.3 else tag
            want = next((u for u in unexpected if _hdr_matches(
                want_src, want_tag, u.hdr[2], u.hdr[3])), None)
            probe = rng.random() < 0.2
            for _, uq in engines:
                assert uq.find(want_src, want_tag, take=not probe) is want
            if probe:
                continue
            if want is not None:
                unexpected.remove(want)
                continue
            req = R(want_src, want_tag)
            posted.append(req)
            for pq, _ in engines:
                pq.append(req)
        else:  # a message arrives
            want = next((r for r in posted if _hdr_matches(
                r.want_src, r.want_tag, src, tag)), None)
            for pq, _ in engines:
                assert pq.match_incoming(src, tag) is want, (step, src, tag)
            if want is not None:
                posted.remove(want)
                continue
            u = UX(src, tag)
            unexpected.append(u)
            for _, uq in engines:
                uq.append(u)
        for pq, uq in engines:
            assert list(pq) == list(posted) and list(uq) == list(unexpected)


def test_log_refuses_a_device_tensor():
    """pml/v logs a CPU tensor that reaches the pml by its bytes and
    refuses one on another device (ERR_BUFFER) rather than copying it
    through the host."""
    import torch

    from ompi_tpu_torch.pml import vprotocol as P_v

    t = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
    raw, name = P_v._bytes_of(t)
    assert name == "bfloat16"
    assert raw == t.view(torch.int16).numpy().tobytes()
    with pytest.raises(errors.MPIError) as ei:
        P_v._bytes_of(torch.empty(4, device="meta"))
    assert ei.value.error_class == errors.ERR_BUFFER


# ---------------------------------------------------------------------------
# launcher jobs


def test_late_receiver_events(jobs):
    """Sender first: the message parks in the unexpected queue, the late
    receive matches it: UNEX insert, remove and match-unex, then the
    completion, as in the reference."""
    dp, dr = _docs(jobs)[0]
    kinds = [e[0] for e in dp["late_receiver"]]
    assert kinds == [P_peruse.MSG_INSERT_IN_UNEX_Q,
                     P_peruse.MSG_REMOVE_FROM_UNEX_Q,
                     P_peruse.REQ_MATCH_UNEX, P_peruse.REQ_COMPLETE], kinds
    assert dp["late_receiver"][0][1:] == [42, 16]
    assert dp["late_receiver"] == dr["late_receiver"]


def test_late_sender_events(jobs):
    """Receiver first: the request parks in the posted queue and the
    arrival removes it; the message never enters the unexpected queue."""
    dp, dr = _docs(jobs)[0]
    kinds = [e[0] for e in dp["late_sender"]]
    assert kinds == [P_peruse.REQ_INSERT_IN_POSTED_Q,
                     P_peruse.REQ_REMOVE_FROM_POSTED_Q,
                     P_peruse.REQ_COMPLETE], kinds
    assert dp["late_sender"] == dr["late_sender"]
    assert dp["peruse_active_after"] is False


def test_send_log_and_determinants(jobs):
    (d0, r0), (d1, r1) = _docs(jobs)
    assert d0["installed"] and d1["installed"]
    assert d0["log_c1"] == [["buf", 0], ["buf", 1], ["buf", 2],
                            ["obj", 99]] == r0["log_c1"]
    assert d1["vals"] == [0, 1, 2] and d1["obj"] == {"last": True}
    assert [d[1] for d in d1["dets_c1"]] == [0, 1, 2, 99]
    assert all(d[0] == 0 for d in d1["dets_c1"])
    assert d1["dets_c1"][:3] == r1["dets_c1"][:3]


def test_replay_reconstructs_lost_data(jobs):
    (d0, r0), (d1, r1) = _docs(jobs)
    assert d0["resent"] == 4 == r0["resent"]
    assert d1["replay_equal"] == [True] * 4 == r1["replay_equal"]
    assert d1["replay_dets"] == r1["replay_dets"]


def test_determinant_persistence_and_truncation(jobs):
    (d0, r0), (d1, r1) = _docs(jobs)
    assert d0["log_before"]
    assert d0["log_after"] == [[True, 3], [True, 4]] == r0["log_after"]
    assert d1["persisted"][0]
    assert [d[1] for d in d1["persisted"][1]] == list(range(5))
    assert d1["persisted"] == r1["persisted"]


def test_indexed_matching_end_to_end(jobs):
    _, (d1, r1) = _docs(jobs)
    assert d1["matching"] == "indexed"
    assert d1["indexed"] == [[3.0, 5.0, 7.0, 9.0], [99.0, 99.0]]
    assert d1["probe"] == [42, 12, [0, 1, 2]]
    assert (d1["indexed"], d1["probe"]) == (r1["indexed"], r1["probe"])


def test_indexed_vs_linear_equivalence_fuzz(jobs):
    """Seeded schedules mixing ANY_SOURCE and ANY_TAG receives, posted
    before the sends, after every arrival, or as they come: each
    receive's payload, tag and count are the same under 'indexed' and
    'list', and the reference's."""
    _, (d1, r1) = _docs(jobs)
    fz, rz = d1["fuzz"], r1["fuzz"]
    keys = [k for k in fz if k.startswith("list_")]
    assert len(keys) == 5
    for k in keys:
        twin = "indexed_" + k[len("list_"):]
        assert fz[k] == fz[twin], k
        assert fz[k] == rz[k] == rz[twin], k
        assert len(fz[k]) == 40


def test_device_tensor_send_logged_and_replayed(jobs):
    """Float32 and bfloat16 CPU tensors through accel_p2p under pml/v:
    the log holds each Send's header and its chunks (``BFLOAT16`` chunks
    by their bits); the chunks, reassembled, are the tensor's bytes; the
    replay into fresh tensors gives the same bits."""
    (d0, _), (d1, _) = _docs(jobs)
    got, n_entries = d0["tensor_log"]
    assert got == [[True, True, [None, "MPI_FLOAT"]],
                   [True, True, [None, "MPI_BFLOAT16"]]], got
    want = (1 + -(-1000 * 4 // CHUNK)) + (1 + -(-1500 * 2 // CHUNK))
    assert n_entries == want == d0["tensor_resent"]
    assert d1["tensor_bits"] == [True, True]
