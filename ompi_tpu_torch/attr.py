"""MPI attribute / keyval caching on communicators and datatypes.

The port's reduction of ``ompi_tpu.attr`` (reference:
ompi/attribute/attribute.c — one keyval space with user copy / delete
callbacks fired on dup / free, comm_create_keyval.c:47-62 — and
attribute_predefined.c:119-195, the predefined attributes) to the
"comm", "win" and "type" kinds: each keyval carries its kind, and a
keyval of one kind used on an object of another raises ``ERR_KEYVAL``.

Callbacks follow the reference's Pythonic convention:
``copy_fn(obj, keyval, extra_state, value) -> new value`` (return
:data:`NO_COPY` to drop the attribute from the dup; ``copy_fn=None`` is
MPI_NULL_COPY_FN) and ``delete_fn(obj, keyval, value, extra_state)``,
fired on Delete_attr, on overwrite and at free. Predefined attributes
are read-only and answered from the runtime.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, Optional

from ompi_tpu_torch import errors

KEYVAL_INVALID = -1

#: copy_fn return sentinel: do not propagate this attribute to the dup
NO_COPY = object()

# predefined ids live below 100; user keyvals above
TAG_UB = 1
HOST = 2
IO = 3
WTIME_IS_GLOBAL = 4
APPNUM = 5
UNIVERSE_SIZE = 6
LASTUSEDCODE = 7
WIN_BASE = 20
WIN_SIZE = 21
WIN_DISP_UNIT = 22
WIN_CREATE_FLAVOR = 23
WIN_MODEL = 24

#: the tag ceiling (tags are Python ints on the wire; advertise 2^31-1)
MAX_TAG = (1 << 31) - 1
#: MPI_ERR_LASTCODE: the port defines no error classes of its own
ERR_LASTCODE = 92
#: window models (MPI-3 §11.4): the active-message windows keep a
#: separate public copy in the model's terms; "unified" would claim more
WIN_SEPARATE = "separate"
WIN_FLAVOR_CREATE = "create"


class Keyval:
    __slots__ = ("id", "kind", "copy_fn", "delete_fn", "extra_state",
                 "freed")

    def __init__(self, kid: int, kind: str, copy_fn: Optional[Callable],
                 delete_fn: Optional[Callable], extra_state: Any) -> None:
        self.id = kid
        self.kind = kind
        self.copy_fn = copy_fn
        self.delete_fn = delete_fn
        self.extra_state = extra_state
        self.freed = False


_next_id = itertools.count(100)
_keyvals: Dict[int, Keyval] = {}
_lock = threading.Lock()


def _predef(kid: int):
    """(value, found) of a predefined communicator attribute."""
    import os

    from ompi_tpu_torch.runtime import rte

    if kid == TAG_UB:
        return MAX_TAG, True
    if kid == WTIME_IS_GLOBAL:
        return False, True  # Wtime is per-process perf_counter
    if kid == APPNUM:
        v = os.environ.get("OMPI_TPU_APPNUM")  # multi-app jobs only
        return (None if v is None else int(v)), True
    if kid == UNIVERSE_SIZE:
        return rte.size, True
    if kid == HOST:
        return rte.hostname(), True
    if kid == IO:
        return True, True  # every rank can do IO
    if kid == LASTUSEDCODE:
        return ERR_LASTCODE, True
    return None, False


def _predef_win(win, kid: int):
    """(value, found) of a predefined window attribute, answered from
    the window's own fields."""
    if kid == WIN_BASE:
        return win.base, True
    if kid == WIN_SIZE:
        return win.peer_info[win.rank][0], True
    if kid == WIN_DISP_UNIT:
        return win.disp_unit, True
    if kid == WIN_CREATE_FLAVOR:
        return getattr(win, "flavor", WIN_FLAVOR_CREATE), True
    if kid == WIN_MODEL:
        return WIN_SEPARATE, True
    return None, False


_PREDEF_WIN_IDS = frozenset((WIN_BASE, WIN_SIZE, WIN_DISP_UNIT,
                             WIN_CREATE_FLAVOR, WIN_MODEL))
_PREDEF_IDS = frozenset((TAG_UB, HOST, IO, WTIME_IS_GLOBAL, APPNUM,
                         UNIVERSE_SIZE, LASTUSEDCODE))


def create_keyval(kind: str, copy_fn: Optional[Callable] = None,
                  delete_fn: Optional[Callable] = None,
                  extra_state: Any = None) -> int:
    """MPI_{Comm,Win,Type}_create_keyval (``kind`` "comm", "win" or
    "type")."""
    if kind not in ("comm", "win", "type"):
        raise errors.MPIError(errors.ERR_ARG, f"bad keyval kind {kind}")
    with _lock:
        kid = next(_next_id)
        _keyvals[kid] = Keyval(kid, kind, copy_fn, delete_fn, extra_state)
    return kid


def free_keyval(kid: int) -> int:
    """MPI_Comm_free_keyval: new set / get raise; attributes already
    cached keep firing their callbacks (MPI-4 §7.7.2). Returns
    KEYVAL_INVALID."""
    kv = _keyvals.get(kid)
    if kv is None or kv.freed:
        raise errors.MPIError(errors.ERR_KEYVAL, f"invalid keyval {kid}")
    kv.freed = True
    return KEYVAL_INVALID


def dup_fn(obj, keyval, extra_state, value):
    """MPI_COMM_DUP_FN: copy the value by reference."""
    return value


def null_copy_fn(obj, keyval, extra_state, value):
    """MPI_NULL_COPY_FN: never propagate."""
    return NO_COPY


def _get_kv(kid: int, kind: str) -> Keyval:
    kv = _keyvals.get(kid)
    if kv is None or kv.freed:
        raise errors.MPIError(errors.ERR_KEYVAL, f"invalid keyval {kid}")
    if kv.kind != kind:
        raise errors.MPIError(
            errors.ERR_KEYVAL,
            f"keyval {kid} is a {kv.kind} keyval, used on a {kind}")
    return kv


def _read_only(kid: int, kind: str) -> None:
    if (kind == "comm" and kid in _PREDEF_IDS) or (
            kind == "win" and kid in _PREDEF_WIN_IDS):
        raise errors.MPIError(errors.ERR_KEYVAL,
                              f"predefined attribute {kid} is read-only")


class AttrHost:
    """Mixin: the MPI attribute API over the host object's ``attrs``
    dict (keyval id -> value). ``_attr_kind`` names the object's keyval
    kind ("comm", "win" or "type")."""

    __slots__ = ()
    _attr_kind = "comm"

    def Set_attr(self, keyval: int, value) -> None:
        """MPI_*_set_attr: overwriting fires the delete callback on the
        old value first (MPI-3.1 §6.7.2)."""
        _read_only(keyval, self._attr_kind)
        kv = _get_kv(keyval, self._attr_kind)
        if keyval in self.attrs and kv.delete_fn is not None:
            kv.delete_fn(self, keyval, self.attrs[keyval], kv.extra_state)
        self.attrs[keyval] = value

    def Get_attr(self, keyval: int):
        """MPI_*_get_attr: the value, or None when not set."""
        if self._attr_kind == "comm" and keyval in _PREDEF_IDS:
            return _predef(keyval)[0]
        if self._attr_kind == "win" and keyval in _PREDEF_WIN_IDS:
            return _predef_win(self, keyval)[0]
        _get_kv(keyval, self._attr_kind)
        return self.attrs.get(keyval)

    def Delete_attr(self, keyval: int) -> None:
        """MPI_*_delete_attr: fires the delete callback."""
        _read_only(keyval, self._attr_kind)
        kv = _get_kv(keyval, self._attr_kind)
        if keyval not in self.attrs:
            raise errors.MPIError(errors.ERR_KEYVAL,
                                  f"attribute {keyval} not set")
        if kv.delete_fn is not None:
            kv.delete_fn(self, keyval, self.attrs[keyval], kv.extra_state)
        del self.attrs[keyval]


def copy_attrs(old, new) -> None:
    """The dup hook (ompi_attr_copy_all): each cached keyval's copy
    callback; None and NO_COPY drop the attribute."""
    for kid in list(old.attrs):
        kv = _keyvals.get(kid)
        if kv is None or kv.kind != old._attr_kind or kv.copy_fn is None:
            continue
        out = kv.copy_fn(old, kid, kv.extra_state, old.attrs[kid])
        if out is not NO_COPY:
            new.attrs[kid] = out


def delete_attrs(obj) -> None:
    """The free hook (ompi_attr_delete_all): delete callbacks in
    insertion order, once each."""
    for kid in list(obj.attrs):
        kv = _keyvals.get(kid)
        if kv is not None and kv.kind != obj._attr_kind:
            continue
        val = obj.attrs.pop(kid)
        if kv is not None and kv.delete_fn is not None:
            kv.delete_fn(obj, kid, val, kv.extra_state)
