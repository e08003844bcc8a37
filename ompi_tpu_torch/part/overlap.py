"""Backward-overlap gradient sync over the MPI-4 partitioned collectives.

The port's copy of ``ompi_tpu.part.overlap`` (part/overlap.py:27-161).
PyTorch DDP and Horovod register a hook per parameter that feeds its
gradient into a bucket and launches the bucket's allreduce the moment it
fills. :class:`GradientSync` expresses that pattern through the standard
MPI-4 surface: the gradient pytree is bound once to
``Comm.Pallreduce_init`` (one partition per leaf); each step opens a
cycle with ``start()``, the backward pushes leaves in any order with
``push``, every bucket flushes once its last leaf arrived, and
``finish()`` drains the tail and returns the synced pytree.
:class:`ZeroGradientSync` is the same surface over
``Comm.Preduce_scatter_init``. :class:`LayerPrefetcher` is ZeRO stage 3's
run-ahead scheduler for the per-layer gathers.

Leaves are addressed by flatten index or by the key-path string of the
template in jax's ``keystr`` spelling (``"['layers'][0]['w']"``,
:func:`ompi_tpu_torch.zero.layout.keystr`). coll/device's flushes run
their host steps inside ``push``, so the communication does not yet
overlap the caller's work (ROADMAP queue 2 item 2): the results and the
flush counts are the reference's.
"""

from __future__ import annotations

from ompi_tpu_torch import errors
from ompi_tpu_torch import op as op_mod


def _key_index(template) -> dict:
    from ompi_tpu_torch.zero import layout as zl

    return {zl.keystr(p): i
            for i, (p, _leaf) in enumerate(zl.tree_flatten_with_path(
                template))}


class GradientSync:
    """Bind a gradient-pytree template once; per step ``start()``,
    ``push(key, grad)`` per leaf as the backward produces it, and
    ``finish()`` -> the synced pytree. Push order is free: buckets flush
    themselves (``part_overlap_flushes`` counts flushes that beat the
    final push)."""

    def __init__(self, comm, template, op=op_mod.SUM,
                 deterministic=None) -> None:
        self._index = _key_index(template)
        self.n_leaves = len(self._index)
        self._req = comm.Pallreduce_init(template, op,
                                         deterministic=deterministic)

    def index_of(self, key) -> int:
        """Flatten index of a key-path string (an int passes through)."""
        return key if isinstance(key, int) else self._index[key]

    def start(self) -> None:
        """Open a cycle (once per step, before the backward starts)."""
        self._req.start()

    def push(self, key, grad=None) -> None:
        """Mark leaf ``key`` ready, optionally with this step's gradient
        (same shape, dtype and device as the template leaf)."""
        self._req.Pready(self.index_of(key), grad)

    def finish(self):
        """Drain the remaining buckets; the synced pytree."""
        self._req.wait()
        return self._req.array

    @property
    def request(self):
        """The partitioned request (for a mixed Startall)."""
        return self._req

    def free(self) -> None:
        self._req.free()


class LayerPrefetcher:
    """Run-ahead scheduler for per-layer gathers (ZeRO stage 3's stream).

    Decides only when: ``start(layer)`` (the callback) owns the how. A
    pass opens with :meth:`begin`, which fires the first ``depth``
    gathers; each consumer arrival calls :meth:`advance`, which tops the
    in-flight window back up to ``depth`` layers past the consumer. The
    window is positional, so a reversed order models the backward pass.
    Hits and misses are the caller's to count."""

    def __init__(self, start, depth: int = 1) -> None:
        if depth < 0:
            raise errors.MPIError(
                errors.ERR_ARG, f"LayerPrefetcher: depth {depth} < 0")
        self._start = start
        self._depth = int(depth)
        self._order: list = []
        self._pos: dict = {}
        self._next = 0

    def begin(self, order) -> None:
        """Open a pass over ``order`` (layer ids in consumer order) and
        fire the first ``depth`` gathers."""
        self._order = list(order)
        self._pos = {g: i for i, g in enumerate(self._order)}
        self._next = 0
        self._fill(self._depth - 1)

    def advance(self, layer) -> None:
        """The consumer reached ``layer``: extend the window to ``depth``
        layers past it (a layer outside the pass: nothing)."""
        pos = self._pos.get(layer)
        if pos is not None:
            self._fill(pos + self._depth)

    def _fill(self, upto: int) -> None:
        while self._next <= upto and self._next < len(self._order):
            g = self._order[self._next]
            self._next += 1
            self._start(g)

    @property
    def issued(self) -> int:
        """Gathers fired so far this pass."""
        return self._next

    def reset(self) -> None:
        """Abandon the pass (no further starts until begin())."""
        self._order = []
        self._pos = {}
        self._next = 0


class ZeroGradientSync(GradientSync):
    """:class:`GradientSync` over ``Comm.Preduce_scatter_init``:
    ``finish()`` returns a :class:`~ompi_tpu_torch.zero.layout.
    ShardedState`, this rank's 1/n gradient shards. Buckets that flush
    before the final push count in ``zero_overlap_flushes``."""

    def __init__(self, comm, template, op=op_mod.SUM,
                 deterministic=None) -> None:
        self._index = _key_index(template)
        self.n_leaves = len(self._index)
        self._req = comm.Preduce_scatter_init(template, op,
                                              deterministic=deterministic)
