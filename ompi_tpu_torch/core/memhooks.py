"""Memory release hooks — the opal/memoryhooks + mca/patcher analog.

The port's copy of ``ompi_tpu.core.memhooks`` (reference:
opal/memoryhooks/memory.h ``opal_mem_hooks_register_release`` and
mca/patcher/overwrite, which patch munmap / free so registration caches
learn when user memory goes away and drop entries that would otherwise
alias a recycled address).

Python's runtime owns allocation, so the interception point is object
death: one weakref finalizer per tracked buffer fires every registered
release hook with the buffer's ``id()``. A ``torch.Tensor`` carries weak
references like a numpy array does. Keys are object identities, never
``data_ptr()``: CUDA's caching allocator hands a freed block's address to
the next tensor, which is exactly the aliasing this plane exists to
prevent.

Subscribers: every :class:`ompi_tpu_torch.core.mpool.Rcache` registers
(weakly) at construction; :func:`release` is the explicit form for memory
whose lifetime is not its wrapper object's (an unlinked shm segment: the
literal munmap hook).
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, List, Set

from ompi_tpu_torch.core import pvar

_lock = threading.Lock()
_hooks: List[Callable[[int], None]] = []
_tracked: Set[int] = set()


def register_release(cb: Callable[[int], None],
                     weak: bool = False) -> None:
    """``cb(key)`` runs when a tracked buffer with ``id() == key`` is
    released. ``weak=True`` (bound methods only) subscribes through a
    WeakMethod, so the hook never keeps its owner alive: caches subscribe
    weakly, or every cache ever built would live and fan out forever."""
    entry = weakref.WeakMethod(cb) if weak else cb
    with _lock:
        if entry not in _hooks:
            _hooks.append(entry)


def unregister_release(cb: Callable[[int], None]) -> None:
    with _lock:
        for h in list(_hooks):
            target = h() if isinstance(h, weakref.WeakMethod) else h
            if target == cb or h is cb:
                _hooks.remove(h)


def nhooks() -> int:
    return len(_hooks)


def release(key: int) -> None:
    """The release notice: every live hook runs with ``key`` (dead weak
    subscribers are pruned). Also the explicit form, for memory whose
    lifetime is not an object's."""
    with _lock:
        _tracked.discard(key)
        hooks = list(_hooks)
    pvar.record("mem_hooks_released")
    dead = []
    for h in hooks:
        cb = h() if isinstance(h, weakref.WeakMethod) else h
        if cb is None:
            dead.append(h)
            continue
        cb(key)
    if dead:
        with _lock:
            for h in dead:
                if h in _hooks:
                    _hooks.remove(h)


def track(buf) -> bool:
    """Install the death hook on ``buf`` (once per object). False for an
    object that cannot carry a weak reference: callers then skip
    ``id()``-keyed caching, since a recycled id could alias a dead
    object's entries. The finalizer is installed before the key is
    published, so no caller is told "tracked" while that is unresolved;
    two racers may both install one, and a second release of a key is
    harmless."""
    key = id(buf)
    with _lock:
        if key in _tracked:
            return True
    try:
        weakref.finalize(buf, release, key)
    except TypeError:
        return False
    with _lock:
        _tracked.add(key)
    return True
