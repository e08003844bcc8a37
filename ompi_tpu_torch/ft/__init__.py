"""Fault tolerance — ULFM revoke / shrink / agree and the failure detector.

The port's copy of ``ompi_tpu.ft`` (reference: ompi/communicator/ft/ —
the heartbeat detector comm_ft_detector.c:30-74, failure propagation
comm_ft_propagator.c, revoke comm_ft_revoke.c —, ompi/mpiext/ftmpi, the
MPIX_* surface, and coll/ftagree, the early-returning agreement). The
rendezvous store is the reliable daemon (the PRRTE / PMIx-server
analog), so:

- detection is the launcher's waitpid plus star heartbeats
  (:mod:`.detector`);
- revocation propagates through a store key and a job-wide epoch
  counter instead of a flooded reliable broadcast;
- agreement is consistent because the store freezes one result per
  (comm, epoch): every caller sees the same value / failure split, the
  guarantee ERA's resilient tree gives.

A store failure takes the job down, the contract the reference has with
its PMIx server. The port's own hazard, which the reference's transports
do not have: a peer that dies inside a device collective never answers
coll/cuda's hop counters. Under ``ft`` the arenas' spin reads the pml's
``failed`` set (:func:`failed_world_ranks`) and raises ProcFailedError
naming the comm rank, as ob1's sweep does for a receive; freeing a comm
with a failed member skips its barrier (``coll/cuda.release``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ompi_tpu_torch import errors
from ompi_tpu_torch.ft import detector  # noqa: F401 — re-export
from ompi_tpu_torch.pml import request as _rq
from ompi_tpu_torch.runtime import rte

# per-comm operation epochs: ULFM has every member call agree / shrink in
# the same order, so local counters align across ranks
_agree_epochs: Dict[int, int] = {}
_shrink_epochs: Dict[int, int] = {}


def release_comm(cid: int) -> None:
    """Drop a freed comm's agreement / shrink epoch counters (hooked from
    ``Communicator.free``)."""
    _agree_epochs.pop(cid, None)
    _shrink_epochs.pop(cid, None)


def _revoke_key(comm) -> str:
    return f"ft:revoked:{rte.jobid}:{comm.cid}"


def _hb_timeout() -> float:
    return detector._timeout_var.get()


# -- failure observation --------------------------------------------------

def faults() -> Dict[int, str]:
    """World ranks known failed (launcher-declared + heartbeat-stale)."""
    d = detector.get()
    if d is not None:
        # a fresh query on the detector's connection; it also promotes
        # stale ranks, so the answer is current, not one period old
        return d._client.faults(d.hb_timeout)
    return rte.client().faults(None)


def failed_world_ranks() -> frozenset:
    """The failures this rank has applied (the pml's ``failed`` set, fed
    by the detector's sweep): no store RPC. Empty when FT is off."""
    from ompi_tpu_torch import pml

    return frozenset(getattr(pml.instance(), "failed", None) or ())


def get_failed(comm) -> List[int]:
    """MPIX_Comm_get_failed: the failed ranks of this comm's group, as
    comm ranks, sorted."""
    dead = faults()
    return sorted(i for i, world in enumerate(comm.group.ranks)
                  if world in dead)


def ack_failed(comm) -> int:
    """MPIX_Comm_ack_failed: acknowledge the current failures so wildcard
    receives may be posted again; returns the number acknowledged. The
    pml's ``acked`` set is the one source of truth (its wildcard gate
    reads it)."""
    failed = get_failed(comm)
    from ompi_tpu_torch import pml

    inst = pml.instance()
    if inst is not None and hasattr(inst, "acked"):
        inst.acked |= {comm.group.ranks[i] for i in failed}
    return len(failed)


# -- revocation -----------------------------------------------------------

def revoke(comm) -> None:
    """MPIX_Comm_revoke: mark and propagate. The store key is the
    reliable broadcast's payload; the epoch counter is the doorbell the
    observers poll."""
    comm.revoked = True
    client = rte.client()
    client.put(_revoke_key(comm), True)
    client.inc(f"ft:rev_epoch:{rte.jobid}")
    # error this rank's own in-flight requests at once
    from ompi_tpu_torch import pml

    fn = getattr(pml.instance(), "on_revoke", None)
    if fn is not None:
        fn(comm.cid)


# -- agreement and shrink -------------------------------------------------

def agree(comm, flag: int) -> Tuple[int, List[int]]:
    """MPIX_Comm_agree: (AND of the live contributions, failed comm ranks
    at decision time), the same answer on every caller. Works on a
    revoked comm, per ULFM."""
    contribs, dead = rte.client().ftgather(
        _agree_tag(comm), rte.rank, int(flag), comm.group.ranks,
        hb_timeout=_hb_timeout())
    return _decide(contribs, dead, comm.group.ranks)


def _agree_tag(comm) -> str:
    """The next agreement tag of this comm: blocking and nonblocking
    agree share one epoch sequence, so a program mixing them still pairs
    its epochs across ranks."""
    epoch = _agree_epochs.get(comm.cid, 0)
    _agree_epochs[comm.cid] = epoch + 1
    return f"ftagree:{rte.jobid}:{comm.cid}:{epoch}"


def _decide(contribs: Dict[int, int], dead: Dict[int, str],
            group_ranks) -> Tuple[int, List[int]]:
    result = ~0
    for v in contribs.values():
        result &= v
    failed = sorted(i for i, world in enumerate(group_ranks)
                    if world in dead)
    return result, failed


# -- nonblocking agreement (MPIX_Comm_iagree) -----------------------------
# The store rendezvous is a blocking RPC, so the nonblocking form runs it
# on a helper thread over a store connection of its own (the main
# client's socket must stay free, and one shared socket would serialise
# agreements on different comms into a cross-comm deadlock); the request
# completes through the progress engine.

_active_agrees: List["AgreeRequest"] = []
_agree_lock = threading.Lock()
_agree_progress_registered = False


def _agree_progress() -> int:
    n = 0
    for req in list(_active_agrees):
        n += req._harvest()
    return n


class AgreeRequest(_rq.Request):
    """MPIX_Comm_iagree's request: after wait / test succeeds, ``.result``
    is (decided flag, failed comm ranks), blocking agree's answer. A
    store failure during the agreement re-raises at wait() or at
    ``.result``."""

    def __init__(self, comm, flag: int) -> None:
        super().__init__()
        self.comm = comm
        self._result: Optional[Tuple[int, List[int]]] = None
        self._exc: Optional[BaseException] = None
        self._outcome = None
        self._tag = _agree_tag(comm)
        self._thread = threading.Thread(
            target=self._run, args=(int(flag),), daemon=True,
            name=f"iagree-{self._tag}")
        global _agree_progress_registered
        with _agree_lock:
            if not _agree_progress_registered:
                from ompi_tpu_torch.core import progress

                progress.register(_agree_progress)
                _agree_progress_registered = True
            _active_agrees.append(self)
        self._thread.start()

    def _run(self, flag: int) -> None:
        from ompi_tpu_torch.runtime import kvstore

        try:
            client = kvstore.Client(rte.client().addr)
            try:
                contribs, dead = client.ftgather(
                    self._tag, rte.rank, flag, self.comm.group.ranks,
                    hb_timeout=_hb_timeout())
            finally:
                client.close()
            self._outcome = ("ok", _decide(contribs, dead,
                                           self.comm.group.ranks))
        except BaseException as exc:  # the store down, a job abort
            # (SystemExit too: it must not die quietly on this thread; it
            # re-raises at the request's wait)
            self._outcome = ("err", exc)

    def _harvest(self) -> int:
        with _agree_lock:
            if self._outcome is None or self.completed:
                return 0
            _active_agrees.remove(self)
            kind, payload = self._outcome
            if kind == "ok":
                self._result = payload
                self.complete()
            else:
                self._exc = payload  # published before completion
                self.complete(error=errors.ERR_INTERN)
        return 1

    @property
    def result(self) -> Tuple[int, List[int]]:
        if self._exc is not None:
            raise self._exc
        return self._result

    def wait(self, timeout: Optional[float] = None):
        from ompi_tpu_torch.core import progress

        progress.wait_until(lambda: self.completed, timeout=timeout)
        if not self.completed:
            raise TimeoutError(f"iagree {self._tag} did not complete")
        if self._exc is not None:
            raise self._exc
        return super().wait(timeout)


def iagree(comm, flag: int) -> AgreeRequest:
    """MPIX_Comm_iagree: a nonblocking agreement (overlap it with p2p or
    compute, then wait / test, or wait_all with other requests); its
    decided value under failures equals blocking agree's."""
    return AgreeRequest(comm, flag)


def shrink(comm):
    """MPIX_Comm_shrink: agree on the surviving group and build a comm
    over it. The contributor set is the agreed alive set, the same on
    every caller by the ftgather freeze."""
    epoch = _shrink_epochs.get(comm.cid, 0)
    _shrink_epochs[comm.cid] = epoch + 1
    tag = f"ftshrink:{rte.jobid}:{comm.cid}:{epoch}"
    contribs, dead = rte.client().ftgather(
        tag, rte.rank, True, comm.group.ranks, hb_timeout=_hb_timeout())
    from ompi_tpu_torch import comm as comm_mod

    # a rank can contribute and then die before the gather freezes: it is
    # in both sets and must not enter the survivors' group
    alive = sorted(r for r in contribs if r not in dead)
    return comm_mod.comm_create_from_group(
        comm_mod.Group(alive), tag=f"shrink:{comm.cid}:{epoch}")


def check_comm_failed(comm) -> None:
    """The collective-entry FT gate (reference: ompi/mpi/c/allreduce.c:
    101-109): a collective over a group with a failed member raises
    ERR_PROC_FAILED (the app shrinks to go on; acknowledging revives only
    wildcard p2p). Reads the pml's ``failed`` set: no store RPC. Failed
    ranks are comm ranks; on an intercommunicator the remote group is
    checked too and reported by remote-group index."""
    from ompi_tpu_torch import pml

    failed = getattr(pml.instance(), "failed", None)
    if not failed:
        return
    bad = [i for i, w in enumerate(comm.group.ranks) if w in failed]
    where = "local group"
    if not bad and getattr(comm, "is_inter", False):
        bad = [i for i, w in enumerate(comm.remote_group.ranks)
               if w in failed]
        where = "remote group"
    if bad:
        raise errors.ProcFailedError(
            ranks=tuple(bad),
            msg=f"process failure in {where}: comm ranks {bad}")
