"""MPI_T events — typed event sources with callback registration.

The port's copy of ``ompi_tpu.core.events`` (reference: the MPI-4 event
interface in ompi/mpi/tool/, event_register_callback.c:22-24,
event_copy.c, event_get_info.c, event_read.c,
event_set_dropped_handler.c). Subsystems register event TYPES; tools
allocate handles bound to a type and either receive synchronous
callbacks or drain a bounded per-handle buffer; overflow drops the
newest instance, counts it, and tells the dropped handler once per
overflow.

The hot path is one branch: emitters guard on ``active(name)``, so no
payload is built while no tool listens. Timestamps come from the
source's clock (``time.monotonic_ns``, the MPI_T_source_get_timestamp
analog), strictly ordered per process by a sequence number.

The types registered here are the reference's less the one whose
emitter waits for its slice (``ft_process_failure``); modules register
theirs at import
(``osc/cuda.py``, ``osc/device_epoch.py``, ``tune/observe.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_lock = threading.Lock()
_seq = itertools.count()

#: source descriptor (MPI_T_source_get_info / source_get_num: one
#: process-local source whose clock is monotonic_ns)
SOURCES = [{
    "name": "ompi_tpu",
    "desc": "process-local event source (monotonic_ns clock)",
    "ordering": "ordered",
    "ticks_per_second": 1_000_000_000,
}]


def source_timestamp() -> int:
    """MPI_T_source_get_timestamp."""
    return time.monotonic_ns()


class EventType:
    """A registered event type (an MPI_T_event_get_info row)."""

    def __init__(self, index: int, name: str, desc: str,
                 fields: Tuple[str, ...]) -> None:
        self.index = index
        self.name = name
        self.desc = desc
        self.fields = fields
        self.handles: List["EventHandle"] = []


#: append-only registry: MPI_T indices stay stable for the process's life
_types: Dict[str, EventType] = {}
_order: List[EventType] = []


def register_type(name: str, desc: str = "",
                  fields: Tuple[str, ...] = ()) -> EventType:
    """Register an event type (subsystems call it at import; idempotent)."""
    with _lock:
        t = _types.get(name)
        if t is None:
            t = EventType(len(_order), name, desc, tuple(fields))
            _types[name] = t
            _order.append(t)
        return t


def active(name: str) -> bool:
    """Hot-path guard: True only when some handle listens on ``name``."""
    t = _types.get(name)
    return bool(t is not None and t.handles)


class EventInstance:
    """MPI_T_event_instance: timestamp and element data. :meth:`copy`
    detaches the payload (event_copy.c: an instance is only valid inside
    the callback; a copy survives it)."""

    __slots__ = ("type_name", "timestamp", "seq", "data")

    def __init__(self, type_name: str, timestamp: int, seq: int,
                 data: Dict[str, Any]) -> None:
        self.type_name = type_name
        self.timestamp = timestamp
        self.seq = seq
        self.data = data

    def read(self, field: str):
        """MPI_T_event_read: one element."""
        return self.data[field]

    def copy(self) -> "EventInstance":
        return EventInstance(self.type_name, self.timestamp, self.seq,
                             dict(self.data))

    def __repr__(self) -> str:
        return (f"EventInstance({self.type_name}, ts={self.timestamp}, "
                f"seq={self.seq}, {self.data})")


class EventHandle:
    """MPI_T_event_handle: binds a tool to an event type. Either a
    synchronous callback (event_register_callback) or a bounded buffer
    drained with :meth:`read`; overflow drops the newest instance and
    counts it (concurrent emitters on one handle count every drop once).
    The dropped handler fires once per not-dropping -> dropping
    transition with the running drop count; draining the buffer with
    :meth:`read` re-arms it (event_set_dropped_handler)."""

    def __init__(self, etype: EventType,
                 callback: Optional[Callable] = None,
                 buffer_size: int = 256) -> None:
        self._type = etype
        self._cb = callback
        self._buf: List[EventInstance] = []
        self._cap = int(buffer_size)
        self._buf_lock = threading.Lock()
        self._dropping = False
        self.dropped = 0
        self._dropped_cb: Optional[Callable[[int], None]] = None
        with _lock:
            etype.handles.append(self)

    def register_callback(self, cb: Callable) -> None:
        self._cb = cb

    def set_dropped_handler(self, cb: Callable[[int], None]) -> None:
        self._dropped_cb = cb

    def _deliver(self, inst: EventInstance) -> None:
        if self._cb is not None:
            self._cb(inst)
            return
        with self._buf_lock:
            if len(self._buf) < self._cap:
                self._buf.append(inst)
                return
            self.dropped += 1
            fire = not self._dropping
            self._dropping = True
            count = self.dropped
            cb = self._dropped_cb
        if fire and cb is not None:
            # outside the lock: the handler may read() or free() the
            # handle without deadlocking
            cb(count)

    def read(self) -> Optional[EventInstance]:
        """Drain the oldest buffered instance (buffered mode); freeing a
        slot re-arms the dropped handler."""
        with self._buf_lock:
            if not self._buf:
                return None
            self._dropping = False
            return self._buf.pop(0)

    def free(self) -> None:
        with _lock:
            if self in self._type.handles:
                self._type.handles.remove(self)
        with self._buf_lock:
            self._buf.clear()
            self._dropping = False


def emit(name: str, **data) -> None:
    """Raise an event instance to every handle on ``name``. Emitters
    guard with ``if events.active(name):`` so the payload is never
    built on the silent path."""
    t = _types.get(name)
    if t is None or not t.handles:
        return
    inst = EventInstance(name, source_timestamp(), next(_seq), data)
    for h in tuple(t.handles):
        h._deliver(inst)


# -- introspection (the mpit face) ------------------------------------------

def get_num() -> int:
    return len(_order)


def get_info(index: int) -> Dict[str, Any]:
    t = _order[index]
    return {"name": t.name, "desc": t.desc, "fields": list(t.fields),
            "index": t.index, "source": 0}


def index_of(name: str) -> int:
    return _types[name].index


def handle_alloc(name_or_index, callback=None,
                 buffer_size: int = 256) -> EventHandle:
    t = (_order[name_or_index] if isinstance(name_or_index, int)
         else _types[name_or_index])
    return EventHandle(t, callback, buffer_size)


def reset_for_testing() -> None:
    with _lock:
        for t in _order:
            t.handles.clear()


# -- built-in event types (registered at import so indices are stable) ------

PML_MATCH = register_type(
    "pml_message_matched",
    "a receive matched an incoming message (ob1 matching engine)",
    ("ctx", "src", "tag", "size", "from_unexpected"))
PML_UNEXPECTED = register_type(
    "pml_unexpected_queued",
    "an incoming message was appended to the unexpected queue "
    "(no posted receive matched)",
    ("ctx", "src", "tag", "size", "depth"))
COLL_COMPLETE = register_type(
    "coll_schedule_complete",
    "a nonblocking collective schedule finished (coll/libnbc)",
    ("kind", "comm_cid", "rounds"))
FT_FAILURE = register_type(
    "ft_process_failure",
    "the failure detector declared a peer dead",
    ("rank", "reason"))
OSC_EPOCH = register_type(
    "osc_epoch_transition",
    "a one-sided synchronization epoch opened or closed "
    "(fence/start/complete/post/wait/lock/unlock)",
    ("kind", "phase", "win", "peer"))
IO_COLL_COMPLETE = register_type(
    "io_collective_complete",
    "a collective file operation finished its two-phase schedule "
    "(fcoll plane)",
    ("kind", "file", "nbytes"))
BTL_CONNECTED = register_type(
    "btl_endpoint_connected",
    "a transport endpoint established its first connection to a peer "
    "(btl wireup)",
    ("btl", "peer", "addr"))
