"""Message-queue introspection — the parallel-debugger (MPIR) analog.

The port's copy of ``ompi_tpu/tools/msgq.py``. Reference:
ompi/debuggers/ (5,654 LoC): the MPIR interface plus
TotalView-style DLLs that walk a live rank's match queues
(ompi_msgq_dll.c: posted receives, unexpected messages, pending sends)
and handle tables (ompi_mpihandles_dll.c) from *outside* the process.

TPU-first redesign: the queues live in one Python object (the ob1
instance), so introspection is a first-party API instead of a debugger
plug-in that re-implements struct layouts:

- :func:`snapshot` — structured dump of posted/unexpected/in-flight
  queues plus live communicator handles (the msgq + mpihandles DLL
  payloads in one dict).
- :func:`render` — human-readable lines, what a debugger would show.
- :func:`install_signal_dump` — SIGUSR1 dumps the queues of a live
  (possibly hung) rank to stderr: the practical equivalent of
  attaching TotalView to inspect why a recv never matched. Installed
  at init when the ``mpir_dump_on_signal`` cvar is on; launcher users
  can then ``kill -USR1`` a stuck rank.
"""

from __future__ import annotations

import signal
import sys
from typing import Dict, List

from ompi_tpu_torch.core import cvar

dump_on_signal = cvar.register(
    "mpir_dump_on_signal", "off", str,
    help="Install a SIGUSR1 handler that dumps PML match queues and "
         "communicator handles to stderr — the debugger-attach "
         "(MPIR/ompi_msgq_dll) equivalent for hung-rank triage. "
         "Opt-in: installing it changes the process-wide SIGUSR1 "
         "disposition (default action is terminate) and the dump runs "
         "Python printing inside a signal handler, which a production "
         "job should not do silently.",
    choices=["on", "off"], level=5)


def _tag_str(tag: int) -> str:
    return "ANY_TAG" if tag == -1 else str(tag)


def _src_str(src: int) -> str:
    return "ANY_SOURCE" if src == -1 else str(src)


def snapshot() -> Dict:
    """Queue + handle state of this rank (empty when no PML yet)."""
    from ompi_tpu_torch import comm as comm_mod, pml

    inst = pml.instance()
    out: Dict = {"posted": [], "unexpected": [], "pending_sends": [],
                 "communicators": []}
    # live communicator handles (mpihandles DLL payload); copy under
    # the registry lock — snapshot() may run from a watchdog thread
    # while the main thread creates/frees communicators. Non-blocking:
    # the SIGUSR1 handler runs on the main thread between bytecodes,
    # and blocking on a lock that same (suspended) thread holds would
    # deadlock the rank — fall back to a lockless dict copy (atomic
    # enough under the GIL for a diagnostic).
    got = comm_mod._comms_lock.acquire(blocking=False)
    try:
        comms = sorted(dict(comm_mod._comms).items())
    finally:
        if got:
            comm_mod._comms_lock.release()
    for cid, c in comms:
        if c is None:
            continue
        out["communicators"].append({
            "cid": cid, "size": c.size, "rank": c.rank,
            "name": getattr(c, "name", f"cid{cid}"),
            "revoked": bool(getattr(c, "revoked", False)),
            "inter": bool(getattr(c, "is_inter", False)),
        })
    if inst is None:
        return out
    for ctx, q in inst.posted.items():
        for req in q:
            out["posted"].append({
                "cid": ctx // 2, "collective": bool(ctx & 1),
                "src": req.want_src, "tag": req.want_tag,
                "count": req.count,
            })
    for ctx, q in inst.unexpected.items():
        for ux in q:
            _, _, src, tag, seq, size, _, msgid = ux.hdr
            out["unexpected"].append({
                "cid": ctx // 2, "collective": bool(ctx & 1),
                "src": src, "tag": tag, "seq": seq, "bytes": size,
                "msgid": msgid,
            })
    for msgid, req in list(inst.pending_ack.items()):
        out["pending_sends"].append({
            "msgid": msgid, "dst_world": req.dst_world,
            "state": "awaiting_ack",
        })
    for msgid, req in list(inst.streaming.items()):
        out["pending_sends"].append({
            "msgid": msgid, "dst_world": req.dst_world,
            "state": "streaming", "acked_bytes": req.acked_bytes,
            "total": req.conv.packed_size if req.conv else 0,
        })
    return out


def decode_type(dt) -> Dict:
    """Decode a derived datatype's constructor tree via
    Get_envelope/Get_contents — what a debugger's handle-introspection
    DLL shows for a type handle (reference: ompi_mpihandles_dll.c
    datatype decoding over MPI_Type_get_envelope/_contents)."""
    ni, na, nd, combiner = dt.Get_envelope()
    node: Dict = {"combiner": combiner, "name": dt.name,
                  "size": dt.size, "extent": dt.extent}
    if combiner == "named":
        return node
    ints, addrs, types = dt.Get_contents()
    node["integers"] = ints
    node["addresses"] = addrs
    node["types"] = [decode_type(t) for t in types]
    return node


def render_type(dt, indent: int = 0) -> List[str]:
    """Human-readable lines for a derived-type tree — one
    envelope/contents walk per node."""
    _, _, _, combiner = dt.Get_envelope()
    pad = "  " * indent
    line = (f"{pad}{combiner} '{dt.name}' "
            f"size={dt.size} extent={dt.extent}")
    if combiner == "named":
        return [line]
    ints, addrs, types = dt.Get_contents()
    if ints or addrs:
        line += f" args={ints + addrs}"
    lines = [line]
    for t in types:
        lines.extend(render_type(t, indent + 1))
    return lines


def render(snap: Dict = None) -> List[str]:
    snap = snapshot() if snap is None else snap
    lines = ["MPI message queues:"]
    lines.append(f"  communicators ({len(snap['communicators'])}):")
    for c in snap["communicators"]:
        flags = "".join(f for f, on in (("R", c["revoked"]),
                                        ("I", c["inter"])) if on)
        lines.append(f"    cid {c['cid']:>3} {c['name']}: rank "
                     f"{c['rank']}/{c['size']} {flags}")
    lines.append(f"  posted receives ({len(snap['posted'])}):")
    for p in snap["posted"]:
        coll = " coll" if p["collective"] else ""
        lines.append(f"    cid {p['cid']}{coll}: src "
                     f"{_src_str(p['src'])} tag {_tag_str(p['tag'])} "
                     f"count {p['count']}")
    lines.append(f"  unexpected messages ({len(snap['unexpected'])}):")
    for u in snap["unexpected"]:
        coll = " coll" if u["collective"] else ""
        lines.append(f"    cid {u['cid']}{coll}: src {u['src']} tag "
                     f"{_tag_str(u['tag'])} seq {u['seq']} "
                     f"{u['bytes']}B")
    lines.append(f"  pending sends ({len(snap['pending_sends'])}):")
    for s in snap["pending_sends"]:
        extra = (f" {s['acked_bytes']}/{s['total']}B"
                 if s["state"] == "streaming" else "")
        lines.append(f"    msgid {s['msgid']} -> world "
                     f"{s['dst_world']}: {s['state']}{extra}")
    return lines


def dump(file=None) -> None:
    print("\n".join(render()), file=file or sys.stderr, flush=True)


_installed = False


def install_signal_dump() -> None:
    """Idempotent; main-thread only (signal module restriction). An
    application handler registered before Init is *chained*, not
    clobbered — SIGUSR1 has conventional uses (reload, log rotation)
    that MPI must not silently eat."""
    global _installed
    if _installed or dump_on_signal.get() != "on":
        return
    try:
        prior = signal.getsignal(signal.SIGUSR1)

        def _handler(signum, frame):
            dump()
            if callable(prior):
                prior(signum, frame)

        signal.signal(signal.SIGUSR1, _handler)
        _installed = True
    except ValueError:
        pass  # not the main thread: debugger dump stays manual
