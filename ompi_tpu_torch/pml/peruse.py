"""PERUSE — message-queue event callbacks for MPI tools.

The port's copy of ``ompi_tpu.pml.peruse`` (reference: ompi/peruse/: a
tool registers callbacks on the PML's queue events,
PERUSE_COMM_REQ_INSERT_IN_POSTED_Q and the rest of peruse.h's enum, and
observes matching: the data MPI profilers use to attribute late-sender
and late-receiver time).

A process-wide subscription table fired from ob1's matching engine. The
hot path pays one module-attribute truth test while no tool is attached
(:data:`active` flips on the first subscription), as the reference's
event-handle activation check compiles to one branch. Event payloads are
keyword dicts (``ev["tag"]``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

# -- event ids (reference: peruse.h PERUSE_COMM_* enum) ----------------------
REQ_INSERT_IN_POSTED_Q = "req_insert_in_posted_q"
REQ_REMOVE_FROM_POSTED_Q = "req_remove_from_posted_q"
MSG_INSERT_IN_UNEX_Q = "msg_insert_in_unex_q"
MSG_REMOVE_FROM_UNEX_Q = "msg_remove_from_unex_q"
REQ_MATCH_UNEX = "req_match_unex"
REQ_COMPLETE = "req_complete"

EVENTS = (REQ_INSERT_IN_POSTED_Q, REQ_REMOVE_FROM_POSTED_Q,
          MSG_INSERT_IN_UNEX_Q, MSG_REMOVE_FROM_UNEX_Q,
          REQ_MATCH_UNEX, REQ_COMPLETE)

#: fast-path guard: ob1 tests this before building event payloads
active: bool = False

_lock = threading.Lock()
_subs: Dict[str, List[Callable[[dict], None]]] = {}


def subscribe(event: str, cb: Callable[[dict], None]) -> None:
    """Attach a tool callback; ``cb`` receives one dict per event with
    keys ``event, ctx, src, tag`` (and ``size, msgid`` for message
    events)."""
    global active
    if event not in EVENTS:
        raise ValueError(f"unknown peruse event {event!r}")
    with _lock:
        _subs.setdefault(event, []).append(cb)
        active = True


def unsubscribe(event: str, cb: Callable[[dict], None]) -> None:
    global active
    with _lock:
        try:
            _subs.get(event, []).remove(cb)
        except ValueError:
            pass
        if not any(_subs.values()):
            active = False


def fire(event: str, **info) -> None:
    """Deliver an event (a no-op without subscribers; ob1 also guards on
    :data:`active`, so payload dicts are not even built)."""
    cbs = _subs.get(event)
    if not cbs:
        return
    info["event"] = event
    for cb in tuple(cbs):
        cb(info)


def reset_for_testing() -> None:
    global active
    with _lock:
        _subs.clear()
        active = False
