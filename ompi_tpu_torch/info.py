"""MPI_Info objects.

The port's copy of the Info object of ``ompi_tpu.info`` (reference:
ompi/info/info.c — an ordered string -> string map with MPI length
limits: set / get / delete / dup and nth-key access). The memory
allocation kinds negotiation (info_memkind.c) waits for a caller in the
port.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

MAX_INFO_KEY = 255
MAX_INFO_VAL = 1024


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
