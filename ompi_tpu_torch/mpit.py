"""MPI_T — the tools information interface.

The port's copy of ``ompi_tpu.mpit`` (reference: ompi/mpi/tool/ over
mca_base_var / mca_base_pvar, opal/mca/base/mca_base_pvar.h:20-64):
indexed enumeration of control variables with read and write,
performance variables read through sessions and bound handles with
start / stop / read / reset, the MPI-4 event interface
(event_register_callback.c:22-24, event_copy.c, event_read.c,
event_set_dropped_handler.c) over :mod:`ompi_tpu_torch.core.events`, and
categories, one per registered framework
(:mod:`ompi_tpu_torch.core.registry`).

cvars enumerate in sorted-name order frozen at first sight (stable for
the process's life: new names append); pvar handles report deltas from
their start() point; event handles get synchronous callbacks or drain a
bounded buffer with drop accounting.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.core import cvar, events as _events, pvar

VERBOSITY_USER_BASIC, VERBOSITY_USER_DETAIL, VERBOSITY_USER_ALL = 1, 2, 3
VERBOSITY_TUNER_BASIC, VERBOSITY_TUNER_DETAIL, VERBOSITY_TUNER_ALL = 4, 5, 6
VERBOSITY_MPIDEV_BASIC, VERBOSITY_MPIDEV_DETAIL, VERBOSITY_MPIDEV_ALL = \
    7, 8, 9


def init_thread() -> None:
    """MPI_T_init_thread: the tool interface is usable before and after
    MPI init / finalize (nothing to bring up; kept for the API)."""


def finalize() -> None:
    """MPI_T_finalize."""


# -- control variables -------------------------------------------------------

#: enumeration order frozen at first sight: MPI_T indices stay stable for
#: the process's life although modules register cvars lazily (new names
#: append, existing indices never shift)
_cvar_order: List[str] = []
_cvar_seen: set = set()


def _cvar_names() -> List[str]:
    for name in sorted(cvar.all_vars()):
        if name not in _cvar_seen:
            _cvar_seen.add(name)
            _cvar_order.append(name)
    return _cvar_order


def cvar_get_num() -> int:
    return len(_cvar_names())


def cvar_get_info(index: int) -> Dict[str, Any]:
    """MPI_T_cvar_get_info: name, type, default, verbosity, description."""
    name = _cvar_names()[index]
    var = cvar.lookup(name)
    return {
        "name": name,
        "type": var.typ.__name__,
        "default": var.default,
        "verbosity": var.level,
        "desc": var.help,
        "choices": list(var.choices) if var.choices is not None else None,
    }


def cvar_index(name: str) -> int:
    """MPI_T_cvar_get_index."""
    return _cvar_names().index(name)


class CvarHandle:
    """MPI_T_cvar_handle: read and write one control variable."""

    def __init__(self, index: int) -> None:
        self._var = cvar.lookup(_cvar_names()[index])

    def read(self):
        return self._var.get()

    def write(self, value) -> None:
        self._var.set(value)


# -- performance variables ---------------------------------------------------

def pvar_get_num() -> int:
    return len(pvar.snapshot())


def pvar_names() -> List[str]:
    return sorted(pvar.snapshot())


class PvarSession:
    """MPI_T_pvar_session: scopes handle lifetimes so tools do not
    interfere."""

    def __init__(self) -> None:
        self._handles: List["PvarHandle"] = []
        self._freed = False

    def handle_alloc(self, name: str) -> "PvarHandle":
        if self._freed:
            raise RuntimeError("session freed")
        h = PvarHandle(name)
        self._handles.append(h)
        return h

    def free(self) -> None:
        self._freed = True
        self._handles.clear()


class PvarHandle:
    """A counter bound in a session: start() marks the baseline, read()
    returns the delta since start, stop() freezes it."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._base: Optional[int] = None
        self._frozen: Optional[int] = None

    def start(self) -> None:
        self._base = pvar.read(self.name)
        self._frozen = None

    def stop(self) -> None:
        if self._base is not None:
            self._frozen = pvar.read(self.name) - self._base

    def read(self) -> int:
        if self._base is None:
            return pvar.read(self.name)  # unstarted: the absolute value
        if self._frozen is not None:
            return self._frozen
        return pvar.read(self.name) - self._base

    def reset(self) -> None:
        self._base = pvar.read(self.name)
        self._frozen = None


def pvar_session_create() -> PvarSession:
    return PvarSession()


# -- events (MPI-4 MPI_T_event_*) --------------------------------------------

def event_get_num() -> int:
    """MPI_T_event_get_num."""
    return _events.get_num()


def event_get_info(index: int) -> Dict[str, Any]:
    """MPI_T_event_get_info: name, description, element fields, source."""
    return _events.get_info(index)


def event_index(name: str) -> int:
    """MPI_T_event_get_index."""
    return _events.index_of(name)


def event_handle_alloc(name_or_index, callback=None,
                       buffer_size: int = 256) -> "_events.EventHandle":
    """MPI_T_event_handle_alloc (and register_callback when ``callback``
    is given). Without a callback the handle buffers up to
    ``buffer_size`` instances for :meth:`EventHandle.read`; overflow
    counts drops and fires the dropped handler."""
    return _events.handle_alloc(name_or_index, callback, buffer_size)


def source_get_num() -> int:
    """MPI_T_source_get_num."""
    return len(_events.SOURCES)


def source_get_info(index: int) -> Dict[str, Any]:
    """MPI_T_source_get_info."""
    return dict(_events.SOURCES[index])


def source_get_timestamp(index: int = 0) -> int:
    """MPI_T_source_get_timestamp."""
    return _events.source_timestamp()


# -- categories (MPI_T_category_*: one per framework) ------------------------

def category_get_num() -> int:
    return len(categories())


def categories() -> List[Tuple[str, List[str]]]:
    """Frameworks as categories, each listing its cvars by prefix."""
    from ompi_tpu_torch.core import registry

    out = []
    names = _cvar_names()
    for fw in sorted(registry.all_frameworks()):
        out.append((fw, [n for n in names if n.startswith(fw)]))
    return out
