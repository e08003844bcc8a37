"""Indexed matching engines — the ob1 custom-match analog.

The port's copy of ``ompi_tpu.pml.custommatch`` (reference:
ompi/mca/pml/ob1/custommatch/pml_ob1_custom_match.h — compile-time
matching structures that replace the linear posted / unexpected queue
walks). The wildcard lattice is indexed directly: posted receives bucket
by their (want_src, want_tag) pattern, so an incoming (src, tag) probes
at most four bucket heads ((src, tag), (src, ANY), (ANY, tag), (ANY,
ANY)) and takes the oldest by posting sequence; unexpected frags bucket
by their concrete (src, tag), so a specific receive probes one bucket
and a wildcard receive the bucket heads. The posted-order semantics are
exactly the linear walk's (MPI matching is ordered by post time, not by
bucket).

Selection: cvar ``pml_ob1_matching`` = ``list`` (plain deques, the
default) or ``indexed``. Both containers expose the same deque-like
surface (append / remove / in / iter / len), so every slow-path site
(probes, cancels) works unchanged; only ob1's two matching scans call
the indexed fast paths.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterator, Optional

from ompi_tpu_torch.core import cvar
from ompi_tpu_torch.pml.request import ANY_SOURCE, ANY_TAG

_match_var = cvar.register(
    "pml_ob1_matching", "list", str,
    help="Matching engine for the posted/unexpected queues: 'list' "
         "walks deques linearly (reference ob1 default); 'indexed' "
         "buckets by (src, tag) pattern so matching probes O(1) "
         "bucket heads instead of the whole queue (the custommatch/ "
         "vector-engine analog, pml_ob1_custom_match.h) — wins when "
         "many receives are outstanding.",
    choices=["list", "indexed"], level=6)


def indexed_enabled() -> bool:
    return _match_var.get() == "indexed"


class _Bucketed:
    """Insertion-ordered container with per-key bucket deques.

    ``_order`` (a dict: Python dicts iterate in insertion order, and
    deletion is O(1)) carries the global posted order for the generic
    deque-compatible surface; buckets carry (seq, item) pairs with
    LAZY deletion — a removed item's pair stays in its bucket until
    it surfaces at the head (the tombstone trick every lock-free
    matching structure in the reference uses in some form)."""

    def __init__(self, key_fn: Callable) -> None:
        self._key_fn = key_fn
        self._order: Dict[int, object] = {}
        self._seq = 0
        self._pairs: Dict[int, list] = {}  # id -> [seq, item] cell
        self._buckets: Dict[tuple, deque] = {}

    # -- deque-compatible surface -----------------------------------------
    def append(self, item) -> None:
        self._seq += 1
        cell = [self._seq, item]
        self._order[id(item)] = item
        self._pairs[id(item)] = cell
        self._buckets.setdefault(self._key_fn(item),
                                 deque()).append(cell)

    def remove(self, item) -> None:
        cell = self._pairs.pop(id(item), None)
        if cell is None:
            raise ValueError("item not in queue")
        del self._order[id(item)]
        cell[1] = None  # null the cell NOW: the strong reference to
        # the request/payload drops immediately (the tombstone left
        # in the bucket deque is an empty [seq, None] shell)

    def __contains__(self, item) -> bool:
        return id(item) in self._order

    def __iter__(self) -> Iterator:
        return iter(list(self._order.values()))

    def __len__(self) -> int:
        return len(self._order)

    def __bool__(self) -> bool:
        return bool(self._order)

    # -- bucket plumbing ---------------------------------------------------
    def _head(self, key) -> Optional[list]:
        """[seq, item] at the live head of a bucket, dropping
        tombstone shells."""
        b = self._buckets.get(key)
        if not b:
            return None
        while b:
            if b[0][1] is not None:
                return b[0]
            b.popleft()
        self._buckets.pop(key, None)
        return None

    def _take(self, cell) -> object:
        item = cell[1]
        self.remove(item)
        return item


class PostedIndex(_Bucketed):
    """Posted-receive queue bucketed by (want_src, want_tag)."""

    def __init__(self) -> None:
        super().__init__(lambda req: (req.want_src, req.want_tag))

    def match_incoming(self, src: int, tag: int):
        """Oldest posted receive matching a concrete (src, tag) —
        probes the four wildcard-pattern buckets. Internal (negative)
        tags never match ANY_TAG, as in the linear walk; an incoming
        tag equal to the ANY_TAG sentinel itself (-1) matches nothing
        — its "exact" bucket IS the wildcard bucket, which the linear
        engine's tag<0 rule rejects."""
        if tag == ANY_TAG:
            return None
        cands = [self._head((src, tag)),
                 self._head((ANY_SOURCE, tag))]
        if tag >= 0:
            cands.append(self._head((src, ANY_TAG)))
            cands.append(self._head((ANY_SOURCE, ANY_TAG)))
        best = None
        for c in cands:
            if c is not None and (best is None or c[0] < best[0]):
                best = c
        return None if best is None else self._take(best)


class UnexpectedIndex(_Bucketed):
    """Unexpected-frag queue bucketed by the frag's concrete
    (src, tag) (hdr fields)."""

    def __init__(self) -> None:
        super().__init__(lambda ux: (ux.hdr[2], ux.hdr[3]))

    def _candidate_keys(self, want_src: int, want_tag: int):
        if want_src != ANY_SOURCE and want_tag != ANY_TAG:
            yield (want_src, want_tag)
            return
        for key in list(self._buckets):
            s, t = key
            if want_src != ANY_SOURCE and s != want_src:
                continue
            if want_tag != ANY_TAG and t != want_tag:
                continue
            if want_tag == ANY_TAG and t < 0:
                continue  # internal tags never match wildcards
            yield key

    def find(self, want_src: int, want_tag: int, take: bool):
        """Oldest unexpected frag matching the receive pattern;
        ``take`` removes it (match/mprobe) vs peeks it (iprobe)."""
        best = None
        for key in self._candidate_keys(want_src, want_tag):
            c = self._head(key)
            if c is not None and (best is None or c[0] < best[0]):
                best = c
        if best is None:
            return None
        return self._take(best) if take else best[1]


def make_posted():
    return PostedIndex() if indexed_enabled() else deque()


def make_unexpected():
    return UnexpectedIndex() if indexed_enabled() else deque()
