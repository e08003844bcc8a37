"""MPI_Info objects and the memory-allocation-kind negotiation.

The port's copy of ``ompi_tpu.info`` (reference: ompi/info/info.c, an
ordered string -> string map with MPI length limits: set / get / delete
/ dup, nth-key access and MPI_INFO_ENV; and ompi/info/info_memkind.c, the
MPI-4.1 ``mpi_memory_alloc_kinds`` negotiation: the user requests kinds,
the implementation answers with the subset it supports, the accelerator
contributing its device kinds, opal/mca/accelerator/accelerator.h:84).

The device kinds come from the selected accelerator component: ``cuda``
and ``cuda:device`` when the cuda component is live (the names of the
MPI-4.1 memory-allocation-kinds side document and of Open MPI's cuda
component; the reference's ``tpu`` / ``tpu:hbm`` are their analog),
nothing from the null component. Unlike the reference, a failure to
select the accelerator is not swallowed: it raises from
:func:`supported_memkinds`, so no grant hides a missing card.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterator, List, Optional, Tuple

MAX_INFO_KEY = 255
MAX_INFO_VAL = 1024

#: the MPI-4.1 memory allocation kinds key (info_memkind.c)
MEMORY_ALLOC_KINDS = "mpi_memory_alloc_kinds"


class Info:
    """MPI_Info. Keys keep insertion order (the nth key is stable)."""

    def __init__(self, items=None) -> None:
        self._d: Dict[str, str] = {}
        if items:
            pairs = items.items() if hasattr(items, "items") else items
            for k, v in pairs:
                self.set(k, v)

    def set(self, key: str, value) -> None:
        key, value = str(key), str(value)
        if len(key) > MAX_INFO_KEY:
            raise ValueError(f"info key exceeds {MAX_INFO_KEY} chars")
        if len(value) > MAX_INFO_VAL:
            raise ValueError(f"info value exceeds {MAX_INFO_VAL} chars")
        self._d[key] = value

    def get(self, key: str, default: Optional[str] = None):
        return self._d.get(key, default)

    def delete(self, key: str) -> None:
        if key not in self._d:
            raise KeyError(key)
        del self._d[key]

    def get_nkeys(self) -> int:
        return len(self._d)

    def get_nthkey(self, n: int) -> str:
        return list(self._d)[n]

    def dup(self) -> "Info":
        return Info(self._d)

    def free(self) -> None:
        self._d.clear()

    def items(self) -> List[Tuple[str, str]]:
        return list(self._d.items())

    def keys(self) -> List[str]:
        return list(self._d)

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __getitem__(self, key: str) -> str:
        return self._d[key]

    def __setitem__(self, key: str, value) -> None:
        self.set(key, value)

    def __eq__(self, other) -> bool:
        return isinstance(other, Info) and self._d == other._d

    def __repr__(self) -> str:
        return f"Info({self._d})"


def as_info(obj) -> Info:
    """None / dict / Info as a new Info: info is captured when set, so
    later changes to the caller's object do not leak in."""
    if obj is None:
        return Info()
    if isinstance(obj, Info):
        return obj.dup()
    return Info(obj)


def env_info() -> Info:
    """MPI_INFO_ENV (reference: ompi_mpi_info_env, info.c)."""
    import os

    from ompi_tpu_torch.runtime import rte

    inf = Info()
    inf.set("command", sys.argv[0] if sys.argv else "")
    inf.set("argv", " ".join(sys.argv[1:]))
    inf.set("maxprocs", str(rte.size if rte.is_launched() else 1))
    inf.set("soft", "")
    inf.set("host", rte.hostname() if rte.is_launched()
            else os.uname().nodename)
    inf.set("arch", os.uname().machine)
    inf.set("wdir", os.getcwd())
    inf.set("thread_level", "MPI_THREAD_MULTIPLE")
    return inf


# -- memory allocation kinds (info_memkind.c) ----------------------------

def supported_memkinds() -> List[str]:
    """The kinds this build can allocate and operate on: the MPI-4.1
    base kinds, then whatever the selected accelerator contributes."""
    from ompi_tpu_torch import accelerator

    return (["system", "mpi", "mpi:alloc_mem", "mpi:win_allocate"]
            + accelerator.current().memkinds())


def memkind_grant(requested: str) -> str:
    """Negotiate ``mpi_memory_alloc_kinds``: the comma list of the
    requested kinds this build supports, in the request's order. A
    restrictor (``kind:restrictor``) is granted only where the exact pair
    is supported; unknown kinds are dropped (the answer is
    authoritative)."""
    have = set(supported_memkinds())
    granted: List[str] = []
    for k in (s.strip() for s in requested.split(",")):
        if k and k in have and k not in granted:
            granted.append(k)
    return ",".join(granted)


def apply_memkinds(info: Info) -> Info:
    """Rewrite ``info``'s memkind request, if any, to the granted subset:
    called where an object is created or takes info (comm Set_info,
    window creation and Set_info, Session_init)."""
    req = info.get(MEMORY_ALLOC_KINDS)
    if req is not None:
        info.set(MEMORY_ALLOC_KINDS, memkind_grant(req))
    return info
