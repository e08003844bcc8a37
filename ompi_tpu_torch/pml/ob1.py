"""ob1 — the default matching PML over the BML and its BTLs.

The port's copy of ``ompi_tpu.pml.ob1`` (reference: ompi/mca/pml/ob1/ —
protocols MATCH (eager) and RNDV (ack-driven pipelined fragments),
headers pml_ob1_hdr.h:43-52, protocol choice by size
pml_ob1_sendreq.h:388-440, per-(comm, peer) sequence order and the
posted / unexpected queues pml_ob1_recvfrag.c:863-960), with the same
wire format:

  MATCH/RNDV: <B type><I ctx><i src><i tag><Q seq><Q size><B flags><Q msgid>
              [payload (eager only)] [<Q pid><Q addr> (RNDV_SC only)]
  ACK:        <B type><Q msgid><Q recv_id>
  FRAG:       <B type><Q recv_id><Q offset>[payload]
  FRAG_ACK:   <B type><Q msgid><Q bytes_received>
  SC_FIN:     <B type><Q msgid>

ctx = cid*2 + (0 point-to-point | 1 collective); src is the sender's rank
in the communicator. A convertor over the message's datatype (derived
types included) drives the eager, RNDV and FRAG sends. A same-host
rendezvous offers smsc/cma single copy (``HDR_RNDV_SC``): a contiguous
layout is exposed in place and a non-contiguous one packed once; the
receiver pulls the payload from the sender's address space (unpacking a
non-contiguous layout through its convertor) and answers SC_FIN, or
declines with a plain ACK and the sender streams fragments. RNDV flow
control: at most ``max(pml_ob1_send_pipeline_depth * frag,
pml_ob1_send_window_bytes)`` bytes un-acknowledged per message.

Heterogeneous peers (opal_copy_functions_heterogeneous.c): each rank
publishes ``arch.advertised()`` in the modex. The wire carries the
sender's advertised order, so a sender whose advertisement is not its
native order byteswaps its outgoing bytes, a receiver converts what a
peer of another order sends, and both round windows to whole elements.
Single copy turns itself off between peers of different order (a raw
memory pull would skip the conversion).

The matching queues come from :mod:`.custommatch` (``pml_ob1_matching``
``list``: deques walked in arrival order; ``indexed``: bucketed by
(src, tag) pattern, the same match order). The tools plane's sites are
the reference's (ob1.py:484-506, :652-672, :792-795): the PERUSE queue
events (:mod:`.peruse`) and the MPI_T events ``pml_message_matched`` and
``pml_unexpected_queued``, each under one guard.

The ULFM sweeps (reference :904-969, ompi/request/req_ft.c): the failure
detector hands new deaths to :meth:`Ob1.on_fault` and revocations to
:meth:`Ob1.on_revoke`, which error the requests they strand; the
``failed`` and ``acked`` sets gate new sends and receives
(``_recv_src_failed``, :431-447).

The trace and flight-recorder sites are the reference's (ob1.py:244-245,
:289-294, :326-332, :414-416, :841-849): an ``isend`` span in ``pml``
(pack, protocol choice and the first handoff to the btl), an
``irecv_post`` marker, a ``send`` span in ``btl`` per rendezvous
fragment, and on a collective context the last pml seq that moved,
dump-only detail of the flight recorder. The memchecker's sites are the
reference's too (:260-267, :401-413): a send checks that the bytes it
packs are defined, and a receive's bytes are undefined from its post to
its completion (``check/memchecker``; host buffers only).
"""

from __future__ import annotations

import itertools
import os
import pickle
import struct
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.btl import base as btl_base
from ompi_tpu_torch.check import memchecker
from ompi_tpu_torch.core import (arch, cvar, events, mpool, output,
                                 progress, pvar)
from ompi_tpu_torch.datatype import BYTE, Convertor, dtype_of
from ompi_tpu_torch.pml import custommatch, peruse
from ompi_tpu_torch.pml import request as rq
from ompi_tpu_torch.runtime import rte
from ompi_tpu_torch.telemetry import flight as _flight
from ompi_tpu_torch.trace import recorder as _trace

HDR_MATCH = 1
HDR_RNDV = 2
HDR_ACK = 3
HDR_FRAG = 4
HDR_FRAG_ACK = 5
HDR_RNDV_SC = 6   # rendezvous offering single copy: the match header and
#                   (pid, address) of the sender's buffer
HDR_SC_FIN = 7    # the receiver finished its single-copy pull

FLAG_SYNC = 1  # ssend: the sender wants a match ack
FLAG_OBJ = 2   # the payload is a pickled Python object

_MATCH = struct.Struct("<BIiiQQBQ")
_ACK = struct.Struct("<BQQ")
_FRAG = struct.Struct("<BQQ")
_FRAGACK = struct.Struct("<BQQ")
_SC = struct.Struct("<QQ")     # pid, remote address
_SCFIN = struct.Struct("<BQ")  # type, msgid

_out = output.stream("pml_ob1")
_msg_ids = itertools.count(1)

_pipeline_depth = cvar.register(
    "pml_ob1_send_pipeline_depth", 4, int,
    help="min un-acknowledged RNDV fragments in flight per message "
         "(reference default 3-4); bounds transport queueing and "
         "overlaps the sender's pack with the receiver's unpack", level=4)

_send_window = cvar.register(
    "pml_ob1_send_window_bytes", 1 << 20, int,
    help="RNDV un-acked window floor in bytes: FRAG_ACKs are end to end, "
         "so the window must cover the ack round trip's bandwidth-delay "
         "product; effective window = max(depth * frag_size, this)",
    level=4)

#: "no object" sentinel — None is a valid object to send
NO_OBJ = object()


class SendRequest(rq.Request):
    def __init__(self) -> None:
        super().__init__()
        self.conv: Optional[Convertor] = None
        self.dst_world = -1
        self.ctx = 0
        self.msgid = 0
        self.recv_id = 0       # RNDV: the receiver's stream id
        self.acked_bytes = 0   # RNDV: FRAG_ACK high-water mark
        self.pumping = False   # re-entrancy guard (see _pump)
        self.sc_keep = None    # single copy: pins the exposed buffer
        #                        until the receiver's SC_FIN


class RecvRequest(rq.Request):
    def __init__(self, ctx: int, src: int, tag: int, buf, count, dtype,
                 is_obj: bool) -> None:
        super().__init__()
        self.ctx = ctx
        self.want_src = src
        self.want_tag = tag
        self.buf = buf
        self.count = count
        self.dtype = dtype
        self.conv: Optional[Convertor] = None
        self.total = 0
        self.is_obj = is_obj
        self.recv_id = 0
        self.matched = False
        self.src_world = -1   # RNDV: where FRAG_ACKs go
        self.src_msgid = 0    # RNDV: the sender request they address

    def _cancel(self) -> None:
        if not self.matched and not self.completed:
            self.status.cancelled = True
            self.complete()

    def complete(self, error: int = 0) -> None:
        # pooled object scratch goes back to the pool on every
        # completion path, with the convertor that views it
        if self.is_obj and self.buf is not None:
            mpool.pool.give(self.buf)
            self.buf = None
            self.conv = None
        super().complete(error)


class _Unexpected:
    """A parked arrival that found no posted receive."""

    __slots__ = ("hdr", "payload", "src_world")

    def __init__(self, hdr, payload, src_world) -> None:
        self.hdr = hdr           # (type, ctx, src, tag, seq, size,
        self.payload = payload   # flags, msgid); eager payload bytes
        self.src_world = src_world


class Message:
    """MPI_Message (the mprobe / mrecv handle)."""

    def __init__(self, ctx, unexpected: _Unexpected) -> None:
        self._ctx = ctx
        self._ux = unexpected


def _lookup_comm(cid: int):
    from ompi_tpu_torch import comm as comm_mod

    return comm_mod.lookup_cid(cid)


class Ob1:
    """The PML instance (one per process)."""

    def __init__(self) -> None:
        self.bml = None
        # matching state keyed by ctx: posted and unexpected queues
        # (pml/custommatch.make_posted / make_unexpected)
        self.posted: Dict[int, Union[deque, custommatch.PostedIndex]] = {}
        self.unexpected: Dict[
            int, Union[deque, custommatch.UnexpectedIndex]] = {}
        # ordered delivery: per (ctx, peer) sequence numbers
        self.send_seq: Dict[Tuple[int, int], int] = {}
        self.recv_seq: Dict[Tuple[int, int], int] = {}
        self.reorder: Dict[Tuple[int, int], Dict[int, Tuple]] = {}
        # in-flight protocol state
        self.pending_ack: Dict[int, SendRequest] = {}   # msgid -> req
        self.active_recv: Dict[int, RecvRequest] = {}   # recv_id -> req
        self.streaming: Dict[int, SendRequest] = {}     # msgid -> rndv tx
        self._recv_ids = itertools.count(1)
        # frames for communicators this rank has not built yet (a peer
        # can finish creating a comm and send before we do)
        self.early_frames: Dict[int, list] = {}
        self._arch_cache: Dict[int, str] = {}
        # ULFM: world ranks known failed (fed by ft.detector) and the
        # failures the app acknowledged (MPIX_Comm_ack_failed), which no
        # longer poison wildcard receives
        self.failed: set = set()
        self.acked: set = set()

    # -- lifecycle --------------------------------------------------------
    def enable(self) -> None:
        """Publish the advertised byte order (the arch modex), open the
        btls and take their frames (collective over the world: btl/sm
        fences)."""
        rte.init()
        rte.modex_send("arch", arch.advertised())
        btl_base.set_recv_callback(self._on_frame)
        self.bml = btl_base.Bml()

    def disable(self) -> None:
        btl_base.set_recv_callback(None)
        if self.bml is not None:
            self.bml.finalize()
            self.bml = None

    def _peer_arch(self, world_rank: int) -> str:
        """The byte order a peer advertised in the modex."""
        a = self._arch_cache.get(world_rank)
        if a is None:
            a = self._arch_cache[world_rank] = rte.modex_recv("arch",
                                                               world_rank)
        return a

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _ctx(comm, collective: bool = False) -> int:
        return comm.cid * 2 + (1 if collective else 0)

    def _next_seq(self, ctx: int, dst_commrank: int) -> int:
        key = (ctx, dst_commrank)
        seq = self.send_seq.get(key, 0)
        self.send_seq[key] = seq + 1
        return seq

    # -- send path (reference: pml_ob1_sendreq.h:388-440) -----------------
    def isend(self, comm, buf, count, dtype, dst: int, tag: int,
              sync: bool = False, obj=NO_OBJ,
              collective: bool = False) -> SendRequest:
        rec = _trace.RECORDER
        t_send = _trace.now() if rec is not None else 0
        req = SendRequest()
        if dst == rq.PROC_NULL:
            req.complete()
            return req
        ctx = self._ctx(comm, collective)
        flags = 0
        if obj is not NO_OBJ:
            payload_all = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            conv = Convertor(payload_all, BYTE, len(payload_all))
            flags |= FLAG_OBJ
        else:
            if dtype is None:
                dtype = dtype_of(buf)
            conv = Convertor(buf, dtype, count)
            if memchecker.enabled() and count:
                # the MEMCHECKER annotation of every send entry: flag a
                # send of undefined bytes, bounded to the count x extent
                # span packed (a zero-count send reads nothing, and
                # nbytes 0 would mean the whole buffer)
                memchecker.check_defined(buf, "send", count * dtype.extent)
        if sync:
            flags |= FLAG_SYNC
        dst_world = comm.world_rank(dst)
        if dst_world in self.failed:
            req.complete(errors.ERR_PROC_FAILED)
            return req
        if obj is NO_OBJ:
            # the wire is in my advertised order: swap whenever that is
            # not my native order (even towards a peer forced to the same
            # order, which converts on my advertisement), and round the
            # windows whenever the orders differ (pickles are
            # order-independent)
            mine = arch.advertised()
            if self._peer_arch(dst_world) != mine or mine != arch.native():
                conv.set_hetero(swap=mine != arch.native())
        seq = self._next_seq(ctx, dst)
        fl = _flight.FLIGHT
        if fl is not None and collective:
            # dump-only detail: the last pml seq that moved on each
            # collective context (staged collectives progressing vs
            # wedged)
            fl.mark_pml(ctx, seq)
        size = conv.packed_size
        msgid = next(_msg_ids)
        req.conv = conv
        req.dst_world = dst_world
        req.ctx = ctx
        req.msgid = msgid
        ep = self.bml.endpoint(dst_world)
        pvar.record("isend")
        if size <= ep.eager_limit:
            hdr = _MATCH.pack(HDR_MATCH, ctx, comm.rank, tag, seq, size,
                              flags, msgid)
            pvar.record("eager")
            if sync:
                self.pending_ack[msgid] = req
            self.bml.send(dst_world, hdr + conv.pack())
            if not sync:
                req.complete()
        else:
            self._rndv_start(req, ep, comm.rank, dst_world, ctx, tag, seq,
                             size, flags, msgid)
        if rec is not None:
            # pack, protocol choice and the first handoff to the btl (a
            # rendezvous streams on under progress after this returns)
            rec.record("isend", "pml", t_send, _trace.now(),
                       {"dst": dst_world, "tag": tag, "size": size,
                        "path": "eager" if size <= ep.eager_limit
                        else "rndv"})
        return req

    def _rndv_start(self, req, ep, src_rank: int, dst_world: int, ctx: int,
                    tag: int, seq: int, size: int, flags: int,
                    msgid: int) -> None:
        sc = self._expose_single_copy(req, ep, dst_world)
        if sc is not None:
            hdr = _MATCH.pack(HDR_RNDV_SC, ctx, src_rank, tag, seq, size,
                              flags, msgid) + sc
            pvar.record("rndv_sc")
        else:
            hdr = _MATCH.pack(HDR_RNDV, ctx, src_rank, tag, seq, size,
                              flags, msgid)
            pvar.record("rndv")
        self.pending_ack[msgid] = req
        self.bml.send(dst_world, hdr)

    def _expose_single_copy(self, req: SendRequest, ep,
                            dst_world: int) -> Optional[bytes]:
        """Offer smsc/cma single copy for a same-host RNDV: pin a stable
        contiguous byte image of the message and return the (pid, addr)
        trailer, or None when the peer is not on btl/sm, cma is off or
        the two orders differ (a raw pull would skip the conversion). A
        contiguous layout is exposed in place; a non-contiguous one is
        packed once and the convertor rewound, so a declined offer
        streams."""
        from ompi_tpu_torch import smsc

        if ep.NAME != "sm" or not smsc.available():
            return None
        if (arch.advertised() != arch.native()
                or self._peer_arch(dst_world) != arch.advertised()):
            return None
        conv = req.conv
        flat = conv._flat(False)
        if conv.is_contig_layout and flat.flags["C_CONTIGUOUS"]:
            req.sc_keep = flat
            return _SC.pack(os.getpid(), flat.ctypes.data)
        view = np.frombuffer(conv.pack(), dtype=np.uint8)
        conv.set_position(0)
        req.sc_keep = view
        return _SC.pack(os.getpid(), view.ctypes.data)

    def send(self, comm, buf, count, dtype, dst: int, tag: int,
             sync: bool = False, collective: bool = False) -> None:
        self.isend(comm, buf, count, dtype, dst, tag, sync=sync,
                   collective=collective).wait()

    def send_obj(self, comm, obj, dst: int, tag: int,
                 collective: bool = False) -> None:
        self.isend(comm, None, 0, None, dst, tag, obj=obj,
                   collective=collective).wait()

    def isend_obj(self, comm, obj, dst: int, tag: int,
                  collective: bool = False) -> SendRequest:
        return self.isend(comm, None, 0, None, dst, tag, obj=obj,
                          collective=collective)

    # -- recv path --------------------------------------------------------
    def irecv(self, comm, buf, count, dtype, src: int, tag: int,
              collective: bool = False) -> RecvRequest:
        if src == rq.PROC_NULL:
            req = RecvRequest(0, src, tag, buf, count, dtype, False)
            req.status.source = rq.PROC_NULL
            req.status.tag = rq.ANY_TAG
            req.complete()
            return req
        ctx = self._ctx(comm, collective)
        if dtype is None and buf is not None:
            dtype = dtype_of(buf)
        req = RecvRequest(ctx, src, tag, buf, count, dtype, False)
        pvar.record("irecv")
        if buf is not None and memchecker.enabled() and count:
            # undefined until completion; a second receive racing into the
            # same bytes is flagged. Only the count x extent bytes the
            # receive can write are shadowed (the tail of a larger array
            # is not), and a zero-count receive writes nothing
            span = count * dtype.extent if dtype is not None else 0
            memchecker.mark_undefined(req.id, buf, span)
        err = self._recv_src_failed(comm, src)
        if err:
            req.complete(err)
            return req
        self._post(req)
        rec = _trace.RECORDER
        if rec is not None:
            rec.instant("irecv_post", "pml", {"src": src, "tag": tag})
        return req

    def irecv_obj(self, comm, src: int, tag: int,
                  collective: bool = False) -> RecvRequest:
        req = RecvRequest(self._ctx(comm, collective), src, tag, None, 0,
                          None, True)
        pvar.record("irecv")
        err = self._recv_src_failed(comm, src)
        if err:
            req.complete(err)
            return req
        self._post(req)
        return req

    def _recv_src_failed(self, comm, src: int) -> int:
        """The error class of a receive that cannot be posted: a named
        receive from a failed sender can never match (PROC_FAILED); a
        wildcard while the comm has unacknowledged failures fails PENDING
        (ULFM's ANY_SOURCE rule)."""
        if not self.failed:
            return 0
        g = comm.remote_group if getattr(comm, "is_inter", False) \
            else comm.group
        if src == rq.ANY_SOURCE:
            unacked = self.failed - self.acked
            if any(r in unacked for r in g.ranks):
                return errors.ERR_PROC_FAILED_PENDING
            return 0
        if g.ranks[src] in self.failed:
            return errors.ERR_PROC_FAILED
        return 0

    def recv(self, comm, buf, count, dtype, src: int, tag: int,
             collective: bool = False) -> rq.Status:
        return self.irecv(comm, buf, count, dtype, src, tag,
                          collective=collective).wait()

    def recv_obj(self, comm, src: int, tag: int, collective: bool = False):
        req = self.irecv_obj(comm, src, tag, collective=collective)
        req.wait()
        return req._obj

    def _find_unexpected(self, ctx: int, want_src: int, want_tag: int,
                         take: bool):
        """Oldest unexpected arrival matching the receive pattern, via
        the selected matching engine (post, iprobe and improbe all come
        here, so the engines cannot drift)."""
        q = self.unexpected.get(ctx)
        if q is None:
            return None
        if isinstance(q, custommatch.UnexpectedIndex):
            return q.find(want_src, want_tag, take)
        probe = RecvRequest(ctx, want_src, want_tag, None, 0, None, False)
        for cand in q:
            if self._hdr_matches(probe, cand.hdr):
                if take:
                    q.remove(cand)
                return cand
        return None

    def _post(self, req: RecvRequest) -> None:
        """Try the unexpected queue, else append to the posted one."""
        ux = self._find_unexpected(req.ctx, req.want_src, req.want_tag,
                                   take=True)
        if ux is not None:
            if peruse.active:
                peruse.fire(peruse.MSG_REMOVE_FROM_UNEX_Q,
                            ctx=req.ctx, src=ux.hdr[2], tag=ux.hdr[3],
                            size=ux.hdr[5], msgid=ux.hdr[7])
                peruse.fire(peruse.REQ_MATCH_UNEX, ctx=req.ctx,
                            src=ux.hdr[2], tag=ux.hdr[3], size=ux.hdr[5],
                            msgid=ux.hdr[7])
            if events.active("pml_message_matched"):
                events.emit("pml_message_matched", ctx=req.ctx,
                            src=ux.hdr[2], tag=ux.hdr[3], size=ux.hdr[5],
                            from_unexpected=True)
            self._match(req, ux.hdr, ux.payload, ux.src_world)
            return
        # get-or-create (not setdefault: make_posted() reads a cvar and
        # allocates, too much for every post)
        q = self.posted.get(req.ctx)
        if q is None:
            q = self.posted[req.ctx] = custommatch.make_posted()
        q.append(req)
        if peruse.active:
            peruse.fire(peruse.REQ_INSERT_IN_POSTED_Q, ctx=req.ctx,
                        src=req.want_src, tag=req.want_tag)

    @staticmethod
    def _hdr_matches(req: RecvRequest, hdr) -> bool:
        _, _, src, tag, _, _, _, _ = hdr
        if req.want_src != rq.ANY_SOURCE and req.want_src != src:
            return False
        if req.want_tag != rq.ANY_TAG and req.want_tag != tag:
            return False
        # negative tags are framework-internal: never match ANY_TAG
        if req.want_tag == rq.ANY_TAG and tag < 0:
            return False
        return True

    # -- probe family -----------------------------------------------------
    def iprobe(self, comm, src: int, tag: int) -> Optional[rq.Status]:
        progress.progress()
        ux = self._find_unexpected(self._ctx(comm), src, tag, take=False)
        if ux is None:
            return None
        st = rq.Status()
        _, _, st.source, st.tag, _, st.count, _, _ = ux.hdr
        pvar.record("matched_probes")
        return st

    def probe(self, comm, src: int, tag: int) -> rq.Status:
        result: List[rq.Status] = []

        def check() -> bool:
            st = self.iprobe(comm, src, tag)
            if st is not None:
                result.append(st)
            return bool(result)

        progress.wait_until(check)
        return result[0]

    def improbe(self, comm, src: int,
                tag: int) -> Optional[Tuple[Message, rq.Status]]:
        progress.progress()
        ctx = self._ctx(comm)
        ux = self._find_unexpected(ctx, src, tag, take=True)
        if ux is None:
            return None
        st = rq.Status()
        _, _, st.source, st.tag, _, st.count, _, _ = ux.hdr
        return Message(ctx, ux), st

    def mprobe(self, comm, src: int, tag: int) -> Tuple[Message, rq.Status]:
        out: List = []

        def check() -> bool:
            got = self.improbe(comm, src, tag)
            if got is not None:
                out.append(got)
            return bool(out)

        progress.wait_until(check)
        return out[0]

    def mrecv(self, msg: Message, buf, count, dtype) -> rq.Status:
        ux = msg._ux
        req = RecvRequest(msg._ctx, ux.hdr[2], ux.hdr[3], buf, count,
                          dtype, buf is None)
        self._match(req, ux.hdr, ux.payload, ux.src_world)
        return req.wait()

    # -- matching and protocol (receiver side) -----------------------------
    def _on_frame(self, data: bytes) -> None:
        t = data[0]
        if t in (HDR_MATCH, HDR_RNDV, HDR_RNDV_SC):
            self._on_match_frame(_MATCH.unpack_from(data, 0),
                                 data[_MATCH.size:])
        elif t == HDR_ACK:
            _, msgid, recv_id = _ACK.unpack_from(data, 0)
            self._on_ack(msgid, recv_id)
        elif t == HDR_FRAG:
            _, recv_id, offset = _FRAG.unpack_from(data, 0)
            self._on_frag(recv_id, offset, data[_FRAG.size:])
        elif t == HDR_FRAG_ACK:
            _, msgid, nbytes = _FRAGACK.unpack_from(data, 0)
            self._on_frag_ack(msgid, nbytes)
        elif t == HDR_SC_FIN:
            _, msgid = _SCFIN.unpack_from(data, 0)
            self._on_sc_fin(msgid)
        else:
            _out.error("unknown frame type %d", t)

    def _on_match_frame(self, hdr, payload) -> None:
        """Sequence-ordered delivery per (ctx, src) (reference:
        match_incomming, pml_ob1_recvfrag.c:863-960)."""
        _, ctx, src, _, seq, _, _, _ = hdr
        if _lookup_comm(ctx // 2) is None:
            self.early_frames.setdefault(ctx // 2, []).append(
                (hdr, payload))
            return
        key = (ctx, src)
        expected = self.recv_seq.get(key, 0)
        if seq != expected:
            pvar.record("out_of_sequence")
            self.reorder.setdefault(key, {})[seq] = (hdr, payload)
            return
        self._deliver_match(hdr, payload)
        self.recv_seq[key] = expected + 1
        parked = self.reorder.get(key)
        while parked:
            nxt = self.recv_seq[key]
            item = parked.pop(nxt, None)
            if item is None:
                break
            self._deliver_match(*item)
            self.recv_seq[key] = nxt + 1

    def _deliver_match(self, hdr, payload) -> None:
        _, ctx, src, tag, _, size, _, msgid = hdr
        q = self.posted.get(ctx)
        if q is None:
            q = self.posted[ctx] = custommatch.make_posted()
        if isinstance(q, custommatch.PostedIndex):
            req = q.match_incoming(src, tag)  # four bucket heads
        else:
            req = None
            for cand in q:
                if self._hdr_matches(cand, hdr):
                    q.remove(cand)
                    req = cand
                    break
        if req is not None:
            if peruse.active:
                peruse.fire(peruse.REQ_REMOVE_FROM_POSTED_Q, ctx=ctx,
                            src=src, tag=tag, size=size, msgid=msgid)
            if events.active("pml_message_matched"):
                events.emit("pml_message_matched", ctx=ctx, src=src,
                            tag=tag, size=size, from_unexpected=False)
            self._match(req, hdr, payload, self._src_world(ctx, src))
            return
        pvar.record("unexpected")
        uq = self.unexpected.get(ctx)
        if uq is None:
            uq = self.unexpected[ctx] = custommatch.make_unexpected()
        uq.append(_Unexpected(hdr, payload, self._src_world(ctx, src)))
        if peruse.active:
            peruse.fire(peruse.MSG_INSERT_IN_UNEX_Q, ctx=ctx, src=src,
                        tag=tag, size=size, msgid=msgid)
        if events.active("pml_unexpected_queued"):
            events.emit("pml_unexpected_queued", ctx=ctx, src=src,
                        tag=tag, size=size, depth=len(uq))

    @staticmethod
    def _src_world(ctx: int, src_commrank: int) -> int:
        c = _lookup_comm(ctx // 2)
        if c is None:
            raise errors.MPIError(errors.ERR_COMM,
                                  f"message for unknown cid {ctx // 2}")
        # on an intercommunicator a sender's rank is its local rank, which
        # indexes this side's remote group
        g = c.remote_group if getattr(c, "is_inter", False) else c.group
        return g.ranks[src_commrank]

    def _match(self, req: RecvRequest, hdr, payload, src_world: int) -> None:
        typ, _, src, tag, _, size, flags, msgid = hdr
        req.matched = True
        req.status.source = src
        req.status.tag = tag
        req.total = size
        if req.is_obj or (flags & FLAG_OBJ and req.buf is None):
            # pooled scratch: the pool may hand back a larger bytearray;
            # the convertor touches [0, size) only
            req.buf = mpool.pool.take(size)
            req.is_obj = True
            req.conv = Convertor(req.buf, BYTE, size)
        else:
            req.conv = Convertor(req.buf, req.dtype, req.count)
            if self._peer_arch(src_world) != arch.native():
                # the wire is the sender's advertised order: convert on
                # unpack. A layout with no wire pattern errors the
                # request (raising here would leave the message half
                # processed and hang the (ctx, src) channel)
                try:
                    req.conv.set_hetero(swap=True)
                except ValueError:
                    req.status.error = errors.ERR_TYPE
            if size > req.conv.packed_size:
                req.status.error = errors.ERR_TRUNCATE  # still drains
        if typ == HDR_MATCH:
            take = min(size, req.conv.packed_size)
            req.conv.unpack(payload[:take])
            req.status.count = take
            if flags & FLAG_SYNC:
                self.bml.send(src_world, _ACK.pack(HDR_ACK, msgid, 0))
            self._finish_recv(req)
            return
        if typ == HDR_RNDV_SC and self._try_single_copy(
                req, payload, size, msgid, src_world):
            return
        # RNDV: a receive id, the ACK, then the fragments
        req.recv_id = next(self._recv_ids)
        req.src_world = src_world
        req.src_msgid = msgid
        self.active_recv[req.recv_id] = req
        self.bml.send(src_world, _ACK.pack(HDR_ACK, msgid, req.recv_id))

    def _try_single_copy(self, req: RecvRequest, payload: bytes,
                         size: int, msgid: int, src_world: int) -> bool:
        """Pull the message from the sender's address space (smsc/cma);
        on a denial return False: the plain ACK then starts the sender's
        fragment pump (its convertor was left rewound for this)."""
        from ompi_tpu_torch import smsc

        if not smsc.available() or req.conv.wire_round:
            return False  # a peer of another order streams (converted)
        pid, addr = _SC.unpack_from(payload, 0)
        take = min(size, req.conv.packed_size)
        try:
            flat = req.conv._flat(True)
            if req.conv.is_contig_layout and flat.flags["C_CONTIGUOUS"]:
                # straight into the receive buffer: the single copy
                smsc.read(pid, addr, memoryview(flat)[:take])
                req.conv.set_position(take)
            else:
                wire = bytearray(take)
                smsc.read(pid, addr, memoryview(wire))
                req.conv.unpack(wire)
        except OSError as exc:
            smsc.disqualify(f"runtime read from pid {pid}: {exc}")
            return False
        req.status.count = take
        self.bml.send(src_world, _SCFIN.pack(HDR_SC_FIN, msgid))
        self._finish_recv(req)
        return True

    def _on_sc_fin(self, msgid: int) -> None:
        """The receiver completed its single-copy pull: release the
        pinned image and complete (RGET FIN)."""
        req = self.pending_ack.pop(msgid, None)
        if req is None:
            _out.error("SC_FIN for unknown msgid %d", msgid)
            return
        req.sc_keep = None
        req.complete()

    def _finish_recv(self, req: RecvRequest) -> None:
        if req.is_obj and req.status.error == 0:
            req._obj = pickle.loads(bytes(memoryview(req.buf)[:req.total]))
        req.complete(req.status.error)  # releases pooled object scratch
        if peruse.active:
            peruse.fire(peruse.REQ_COMPLETE, ctx=req.ctx,
                        src=req.status.source, tag=req.status.tag,
                        size=req.status.count)

    # -- sender: ack and fragment streaming (reference:
    #    mca_pml_ob1_send_request_schedule, depth pml_ob1_component.c:207)
    def _on_ack(self, msgid: int, recv_id: int) -> None:
        req = self.pending_ack.pop(msgid, None)
        if req is None:
            _out.error("ACK for unknown msgid %d", msgid)
            return
        if recv_id == 0:  # eager ssend ack
            req.complete()
            return
        req.sc_keep = None  # a declined offer: stream from the buffer
        req.recv_id = recv_id
        self.streaming[msgid] = req
        self._pump(req)

    def _pump(self, req: SendRequest) -> None:
        """Send fragments while the un-acked window has room. Completion
        is every byte handed to the BTL (the buffer is reusable then);
        FRAG_ACKs only pace the stream."""
        # re-entrancy guard: ep.send can spin progress when a transport
        # is full and deliver a FRAG_ACK that re-enters _pump for this
        # request; the nested call only updates acked_bytes, and the
        # outer loop re-reads the window every iteration
        if req.pumping:
            return
        req.pumping = True
        try:
            conv = req.conv
            ep = self.bml.endpoint(req.dst_world)
            window = max(max(1, _pipeline_depth.get()) * ep.max_send,
                         _send_window.get())
            while not conv.done \
                    and conv.position - req.acked_bytes < window:
                offset = conv.position
                data = conv.pack(max_bytes=ep.max_send)
                pvar.record("rndv_frag")
                frame = _FRAG.pack(HDR_FRAG, req.recv_id, offset) + data
                rec = _trace.RECORDER
                if rec is None:
                    ep.send(req.dst_world, frame)
                else:
                    t0 = _trace.now()
                    ep.send(req.dst_world, frame)
                    rec.record("send", "btl", t0, _trace.now(),
                               {"peer": req.dst_world,
                                "nbytes": len(frame), "btl": ep.NAME})
        finally:
            req.pumping = False
        if conv.done and not req.completed:
            self.streaming.pop(req.msgid, None)
            req.complete()

    def _on_frag_ack(self, msgid: int, nbytes: int) -> None:
        req = self.streaming.get(msgid)
        if req is None:
            return  # the stream was fully sent: a stale ack
        if nbytes > req.acked_bytes:
            req.acked_bytes = nbytes
        self._pump(req)

    def _on_frag(self, recv_id: int, offset: int, data: bytes) -> None:
        req = self.active_recv.get(recv_id)
        if req is None:
            _out.error("FRAG for unknown recv_id %d", recv_id)
            return
        if req.status.error != errors.ERR_TRUNCATE \
                and offset != req.conv.position:
            raise errors.MPIError(
                errors.ERR_INTERN,
                f"frag offset {offset} != convertor position "
                f"{req.conv.position}")
        # a truncated receive drains the stream and drops what does not
        # fit (unpack stops at packed_size)
        req.conv.unpack(data)
        end = offset + len(data)
        self.bml.send(req.src_world,
                      _FRAGACK.pack(HDR_FRAG_ACK, req.src_msgid, end))
        if end >= req.total:
            req.status.count = min(req.total, req.conv.packed_size)
            del self.active_recv[recv_id]
            self._finish_recv(req)

    def comm_registered(self, cid: int) -> None:
        """Replay frames that arrived before this comm existed here."""
        for hdr, payload in self.early_frames.pop(cid, ()):
            self._on_match_frame(hdr, payload)

    def cancel_recv(self, req: RecvRequest) -> None:
        q = self.posted.get(req.ctx)
        if q is not None and req in q:
            q.remove(req)
        req._cancel()

    # -- ULFM sweeps (reference: ompi/request/req_ft.c) --------------------
    def on_fault(self, dead_world: set) -> int:
        """Error every in-flight request that involves a failed rank
        (called from the detector's progress sweep)."""
        from ompi_tpu_torch import comm as comm_mod

        self.failed |= dead_world
        n = 0
        # posted receives: named sources among the dead fail; wildcards
        # fail PENDING once a member of the group is gone (the app may
        # acknowledge and post again)
        for ctx, q in list(self.posted.items()):
            c = comm_mod.lookup_cid(ctx // 2)
            if c is None:
                continue
            g = c.remote_group if getattr(c, "is_inter", False) \
                else c.group
            if not any(r in dead_world for r in g.ranks):
                continue
            for req in list(q):
                if req.want_src == rq.ANY_SOURCE:
                    q.remove(req)
                    req.complete(errors.ERR_PROC_FAILED_PENDING)
                    n += 1
                elif g.ranks[req.want_src] in dead_world:
                    q.remove(req)
                    req.complete(errors.ERR_PROC_FAILED)
                    n += 1
        # matched rendezvous receives streaming from a dead sender
        for recv_id, req in list(self.active_recv.items()):
            if req.src_world in dead_world:
                del self.active_recv[recv_id]
                req.complete(errors.ERR_PROC_FAILED)
                n += 1
        # sends waiting for an ACK, or streaming, towards a dead receiver
        for table in (self.pending_ack, self.streaming):
            for msgid, req in list(table.items()):
                if req.dst_world in dead_world:
                    del table[msgid]
                    if not req.completed:
                        req.complete(errors.ERR_PROC_FAILED)
                        n += 1
        return n

    def on_revoke(self, cid: int) -> int:
        """Error every in-flight request on a revoked comm (reference:
        comm_ft_revoke.c drains the match queues)."""
        n = 0
        for ctx in (cid * 2, cid * 2 + 1):
            q = self.posted.get(ctx)
            for req in list(q or ()):
                q.remove(req)
                req.complete(errors.ERR_REVOKED)
                n += 1
            for recv_id, req in list(self.active_recv.items()):
                if req.ctx == ctx:
                    del self.active_recv[recv_id]
                    req.complete(errors.ERR_REVOKED)
                    n += 1
            for table in (self.pending_ack, self.streaming):
                for msgid, req in list(table.items()):
                    if req.ctx == ctx and not req.completed:
                        del table[msgid]
                        req.complete(errors.ERR_REVOKED)
                        n += 1
        return n
