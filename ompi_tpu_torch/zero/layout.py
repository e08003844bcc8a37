"""zero/layout — pad-and-shard bucket layout for sharded data parallel.

Port of :mod:`ompi_tpu.zero.layout` (ZeroPlan, plan_for, ShardedState,
layer_groups, ErrorFeedback and the host bucket cycle).
The ZeRO cycle (Rajbhandari et al., SC'20) is reduce_scatter(grads) ->
local shard update -> all_gather(params), so every rank holds O(1/n)
optimizer state. The layout is the fused allreduce's dtype-segregated
bucket plan (:class:`_FusePlan`, the port's own copy of
``ompi_tpu.coll.xla._FusePlan``) plus one constraint: each bucket's flat
element count is zero-padded to a multiple of the comm size, so a bucket
is one reduce-scatter and one allgather.

Packing order is the pytree's flatten order, and the port flattens as
jax does (:func:`tree_flatten`): dict keys sorted, lists and tuples in
order. ``torch.utils._pytree`` and plain iteration keep insertion
order, which would pack ``{'w', 'b', 'layers'}`` as ``[w, b, layers…]``
where jax packs ``[b, layers…, w]``: buckets and shards would then not
compare with the JAX package's. Metas carry the reference's dtype names
(``"float32"``, ``"bfloat16"``, ``"int32"``); item sizes come from torch,
since numpy has no bfloat16.

Numpy leaves take the host bucket cycle (:func:`host_reduce_scatter_multi`,
:func:`host_allgather_multi`): the same plan over the host collectives,
with numpy shards. :func:`layer_groups` cuts a pytree into stage 3's
layers, named in jax's ``keystr`` spelling (:func:`keystr`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll.device import bucket_var
from ompi_tpu_torch.core import pvar

# ---------------------------------------------------------------------------
# pytrees of dicts, lists and tuples, flattened in jax's order

_LEAF = "*"


class TreeDef:
    """The structure of a pytree: nested ``(kind, keys, children)``
    tuples with ``"*"`` for a leaf (kind: dict, list, tuple, none)."""

    __slots__ = ("spec", "num_leaves")

    def __init__(self, spec, num_leaves: int) -> None:
        self.spec = spec
        self.num_leaves = num_leaves

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self.spec == other.spec

    def __hash__(self) -> int:
        return hash(self.spec)

    def __repr__(self) -> str:
        return f"TreeDef({self.spec!r})"


def tree_flatten(tree) -> Tuple[list, TreeDef]:
    """(leaves, treedef) in jax's order: dict keys sorted, lists and
    tuples in order, None an empty node; anything else is a leaf."""
    leaves: list = []
    spec = _spec(tree, leaves)
    return leaves, TreeDef(spec, len(leaves))


def _spec(t, leaves: list):
    """The structure of ``t``, its leaves appended to ``leaves``. The
    walkers here recurse through module-level functions, never a nested
    closure that names itself: such a closure is a reference cycle that
    would hold the leaves until Python's cyclic collector runs."""
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_spec(t[k], leaves) for k in keys))
    if type(t) in (list, tuple):
        return (type(t).__name__, None, tuple(_spec(c, leaves) for c in t))
    if t is None:
        return ("none", None, ())
    leaves.append(t)
    return _LEAF


def tree_unflatten(treedef: TreeDef, leaves: Sequence):
    """The inverse of :func:`tree_flatten` (dicts come back with their
    keys in sorted order, as jax returns them)."""
    if len(leaves) != treedef.num_leaves:
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"tree_unflatten: {len(leaves)} leaves for a "
            f"{treedef.num_leaves}-leaf tree")
    return _build(treedef.spec, iter(leaves))


def _build(s, it):
    """The tree of spec ``s`` over the leaves the iterator ``it`` yields
    (see :func:`_spec`)."""
    if s == _LEAF:
        return next(it)
    kind, keys, kids = s
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    if kind == "none":
        return None
    vals = [_build(c, it) for c in kids]
    return vals if kind == "list" else tuple(vals)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_flatten_with_path(tree) -> list:
    """``[(path, leaf), ...]`` in flatten order; a path is a tuple of
    ``("key", k)`` (a dict key) and ``("seq", i)`` (a list or tuple
    index) entries, jax's ``DictKey`` and ``SequenceKey``."""
    out: list = []
    _paths(tree, (), out)
    return out


def _paths(t, path, out: list) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], path + (("key", k),), out)
    elif type(t) in (list, tuple):
        for i, c in enumerate(t):
            _paths(c, path + (("seq", i),), out)
    elif t is not None:
        out.append((path, t))


def keystr(path) -> str:
    """jax's ``keystr`` spelling of a path: ``['h'][3]['mlp']``."""
    return "".join(f"[{k!r}]" if kind == "key" else f"[{k}]"
                   for kind, k in path)


def layer_groups(template) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """Ordered (name, leaf indices) layers of a pytree, the unit of ZeRO
    stage 3's parameter stream (ompi_tpu/zero/layout.py:89-111). Leaves
    group by the top component of their key path; where the second
    component indexes a list or tuple it joins the key, so ``h[0]``,
    ``h[1]``, ... are layers of their own while ``{"wte": ...}`` stays
    one. Groups come in order of first appearance in flatten order (the
    forward pass's). Local and deterministic in the tree's structure."""
    groups: dict = {}
    for i, (path, _leaf) in enumerate(tree_flatten_with_path(template)):
        depth = 2 if len(path) > 1 and path[1][0] == "seq" else 1
        groups.setdefault(keystr(path[:depth]), []).append(i)
    return tuple((k, tuple(v)) for k, v in groups.items())


# ---------------------------------------------------------------------------
# the bucket plan


def dtype_name(dtype) -> str:
    """The reference's name of a torch dtype ("float32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def torch_dtype(name: str):
    return getattr(torch, name)


def itemsize(name: str) -> int:
    return torch_dtype(name).itemsize


def _fuse_metas(leaves) -> tuple:
    """(shape, dtype name, nbytes) per leaf, tensors and numpy arrays
    alike (coll/xla.py:1274-1277)."""
    return tuple((tuple(t.shape), dtype_name(t.dtype), int(t.nbytes))
                 for t in leaves)


def _elems_of(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class _FusePlan:
    """dtype-segregated bucket layout for one leaf signature (the port's
    copy of coll/xla.py:1241-1271): ``buckets`` is a tuple of tuples of
    leaf indices; a bucket closes once its byte total reaches
    ``bucket_bytes`` (overflow allowed), so there are at most
    ceil(total_bytes/bucket_bytes) + n_dtypes buckets."""

    __slots__ = ("buckets", "nbytes")

    def __init__(self, metas, bucket_bytes: int) -> None:
        groups: dict = {}
        order = []
        for i, (_shape, dtype, nb) in enumerate(metas):
            if dtype not in groups:
                groups[dtype] = []
                order.append(dtype)
            groups[dtype].append((i, nb))
        buckets = []
        for dt in order:
            cur, cur_bytes = [], 0
            for i, nb in groups[dt]:
                cur.append(i)
                cur_bytes += nb
                if bucket_bytes > 0 and cur_bytes >= bucket_bytes:
                    buckets.append(tuple(cur))
                    cur, cur_bytes = [], 0
            if cur:
                buckets.append(tuple(cur))
        self.buckets = tuple(buckets)
        self.nbytes = sum(m[2] for m in metas)


class ZeroPlan(_FusePlan):
    """_FusePlan + per-bucket pad-to-comm-size layout: per bucket the
    flat element count, the padded count (next multiple of ``n``), the
    per-rank shard length and the dtype name. Deterministic in (metas,
    bucket_bytes, n), so every rank (and the JAX package, given the same
    metas) derives the same layout without agreement. ``buckets``, when
    given, replaces the bucketing (another package's plan, carried
    across by :mod:`ompi_tpu_torch.compat`)."""

    __slots__ = ("n", "elems", "padded", "shard_elems", "dtypes",
                 "pad_bytes")

    def __init__(self, metas, bucket_bytes: int, n: int,
                 buckets=None) -> None:
        super().__init__(metas, bucket_bytes)
        if buckets is not None:
            self.buckets = tuple(tuple(int(i) for i in b) for b in buckets)
        self.n = int(n)
        elems, padded, shard, dtypes = [], [], [], []
        pad_bytes = 0
        for idxs in self.buckets:
            dt = metas[idxs[0]][1]
            e = sum(_elems_of(metas[i][0]) for i in idxs)
            p = -(-e // self.n) * self.n  # ceil to multiple of n
            elems.append(e)
            padded.append(p)
            shard.append(p // self.n)
            dtypes.append(dt)
            pad_bytes += (p - e) * itemsize(dt)
        self.elems = tuple(elems)
        self.padded = tuple(padded)
        self.shard_elems = tuple(shard)
        self.dtypes = tuple(dtypes)
        self.pad_bytes = pad_bytes


def plan_for(leaves, n: int, bucket_bytes: Optional[int] = None
             ) -> ZeroPlan:
    """The bucket/pad layout the zero collectives use for these leaves
    on a size-``n`` comm (default bucket size: the
    ``coll_device_bucket_bytes`` cvar). Local and deterministic."""
    bb = int(bucket_var.get()) if bucket_bytes is None \
        else int(bucket_bytes)
    return ZeroPlan(_fuse_metas(leaves), bb, n)


def pack(leaves, idxs, pad: int):
    """Bucket ``idxs`` of ``leaves`` as one flat tensor (numpy array for
    numpy leaves), zero-padded by ``pad`` elements (a view of the leaf
    when the bucket is one leaf with no pad)."""
    if isinstance(leaves[idxs[0]], np.ndarray):
        flat = np.concatenate([np.ascontiguousarray(leaves[i]).reshape(-1)
                               for i in idxs])
        return np.pad(flat, (0, pad)) if pad else flat
    flat = torch.cat([leaves[i].reshape(-1) for i in idxs]) \
        if len(idxs) > 1 else leaves[idxs[0]].reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def split(flat: torch.Tensor, metas, idxs) -> List[torch.Tensor]:
    """A bucket's flat concat -> its member leaves (views), pad dropped."""
    outs, off = [], 0
    for i in idxs:
        shape = metas[i][0]
        k = _elems_of(shape)
        outs.append(flat[off:off + k].reshape(shape))
        off += k
    return outs


class ShardedState:
    """This rank's 1/n of a pytree packed by a :class:`ZeroPlan`.

    ``shards[b]`` is a 1-D tensor of ``plan.shard_elems[b]`` elements of
    ``plan.dtypes[b]``: rank r's contiguous chunk of bucket b's padded
    flat concat. Produced by ``Comm.Reduce_scatter_multi`` (the reduced
    gradient shards) or :meth:`from_full`; consumed by
    ``Comm.Allgather_multi``, which rebuilds the full pytree."""

    __slots__ = ("plan", "metas", "treedef", "shards", "rank", "n",
                 "versions")

    def __init__(self, plan: ZeroPlan, metas, treedef, shards,
                 rank: int, n: int, versions=None) -> None:
        self.plan = plan
        self.metas = metas
        self.treedef = treedef
        self.shards = list(shards)
        self.rank = int(rank)
        self.n = int(n)
        #: per-bucket mutation counters: every :meth:`map` bumps the
        #: buckets it updates, so a gather can tell which buckets did
        #: not change (the frozen-leaf skip)
        self.versions = list(versions) if versions is not None \
            else [0] * len(self.shards)

    @property
    def shard_bytes(self) -> int:
        """Bytes this rank holds."""
        return sum(int(k) * itemsize(dt)
                   for k, dt in zip(self.plan.shard_elems, self.plan.dtypes))

    @property
    def total_bytes(self) -> int:
        """Bytes of the full (replicated) pytree this shards."""
        return self.plan.nbytes

    @property
    def nbytes(self) -> int:
        """Alias of :attr:`total_bytes`."""
        return self.plan.nbytes

    def map(self, fn, *others: "ShardedState", where=None
            ) -> "ShardedState":
        """New state with ``fn(self.shards[b], *others.shards[b])`` per
        bucket (the local update; no collective). ``where`` (optional
        per-bucket bool mask) limits the update to selected buckets:
        unselected buckets keep their shard and their version counter."""
        for o in others:
            if o.plan.buckets != self.plan.buckets \
                    or o.plan.n != self.plan.n:
                raise errors.MPIError(
                    errors.ERR_ARG,
                    "ShardedState.map: operand packed by a different "
                    "plan (shard-wise math requires identical bucket "
                    "layouts)")
        if where is not None and len(where) != len(self.shards):
            raise errors.MPIError(
                errors.ERR_COUNT,
                f"ShardedState.map: where mask has {len(where)} "
                f"entries for {len(self.shards)} buckets")
        shards = [fn(s, *(o.shards[b] for o in others))
                  if where is None or where[b] else s
                  for b, s in enumerate(self.shards)]
        return ShardedState(self.plan, self.metas, self.treedef,
                            shards, self.rank, self.n,
                            versions=[v + 1 if where is None or where[b]
                                      else v
                                      for b, v in enumerate(self.versions)])

    def zeros_like(self) -> "ShardedState":
        if self.shards and isinstance(self.shards[0], np.ndarray):
            shards = [np.zeros((k,), dtype=dt) for k, dt in
                      zip(self.plan.shard_elems, self.plan.dtypes)]
            return ShardedState(self.plan, self.metas, self.treedef,
                                shards, self.rank, self.n)
        dev = self.shards[0].device if self.shards else "cpu"
        shards = [torch.zeros((k,), dtype=torch_dtype(dt), device=dev)
                  for k, dt in zip(self.plan.shard_elems, self.plan.dtypes)]
        return ShardedState(self.plan, self.metas, self.treedef,
                            shards, self.rank, self.n)

    @classmethod
    def from_full(cls, comm, tree, plan: Optional[ZeroPlan] = None
                  ) -> "ShardedState":
        """Slice this rank's shard out of a replicated pytree (no
        collective: every rank holds the full values). The layout is the
        one the collectives use, so shards line up with
        ``Reduce_scatter_multi`` gradients element for element. Each
        shard is a copy, so the state holds 1/n of the tree. Numpy
        leaves give numpy shards (the host cycle's)."""
        leaves, treedef = tree_flatten(tree)
        metas = _fuse_metas(leaves)
        if plan is None:
            plan = ZeroPlan(metas, int(bucket_var.get()), comm.size)
        rank = comm.rank
        shards = []
        for b, idxs in enumerate(plan.buckets):
            flat = pack(leaves, idxs, plan.padded[b] - plan.elems[b])
            k = plan.shard_elems[b]
            shards.append(flat[rank * k:(rank + 1) * k].copy()
                          if isinstance(flat, np.ndarray)
                          else flat[rank * k:(rank + 1) * k].clone())
        return cls(plan, metas, treedef, shards, rank, comm.size)

    def unpack(self, fulls) -> object:
        """Full padded flat bucket tensors -> the original pytree (pad
        dropped, leaf shapes restored)."""
        outs: List[object] = [None] * sum(
            len(idxs) for idxs in self.plan.buckets)
        for b, idxs in enumerate(self.plan.buckets):
            for i, leaf in zip(idxs, split(fulls[b], self.metas, idxs)):
                outs[i] = leaf
        return tree_unflatten(self.treedef, outs)


class ErrorFeedback:
    """Per-bucket compression-residual carry for ZeRO gradient cycles
    (Seide et al. 2014 1-bit SGD; Lin et al. 2018 DGC): each step
    transmits Q(g + e) and keeps e' = (g + e) - Q(g + e) locally, so the
    quantisation error is re-injected next step instead of lost.
    Quantisation happens at the source — elementwise, deterministic,
    before the exact reduction — so it holds whichever transport (flat,
    two-level, compressed DCN) carries the payload.

    Layout-matched to the :class:`ZeroPlan` the zero collectives derive,
    so the fp8 scale is per bucket and the residual is one unpadded flat
    tensor (numpy array for numpy leaves) per compressible bucket.
    Buckets whose dtype the wire cannot narrow (integers, dtypes no wider
    than the wire) pass through untouched and carry no residual. The
    quantiser is ``parallel.hierarchical.wire_quantize``: numpy leaves go
    through torch on the CPU and come back as numpy of their dtype. A
    bfloat16 bucket under an fp8 wire is quantised (the reference passes
    it through: ml_dtypes' bfloat16 has numpy kind 'V', not 'f')."""

    __slots__ = ("wire", "plan", "residuals", "_active")

    def __init__(self, wire: str) -> None:
        from ompi_tpu_torch.parallel import hierarchical as H

        if H.wire_dtype(wire) is None:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"error_feedback={wire!r}: expected 'bf16', "
                "'fp8_e4m3' or 'fp8_e5m2'")
        self.wire = H.wire_degrade(wire)
        self.plan: Optional[ZeroPlan] = None
        self.residuals: List[object] = []
        self._active: Tuple[bool, ...] = ()

    def _bind(self, plan: ZeroPlan) -> None:
        """(Re)bind to a bucket layout; a layout change resets the
        carried residuals (they index a different packing)."""
        from ompi_tpu_torch.parallel import hierarchical as H

        self.plan = plan
        wsz = H.wire_itemsize(self.wire)
        active = []
        for dt in plan.dtypes:
            tdt = getattr(torch, dt, None)
            active.append(isinstance(tdt, torch.dtype)
                          and tdt.is_floating_point and wsz < tdt.itemsize)
        self._active = tuple(active)
        self.residuals = [None] * len(plan.buckets)

    def apply(self, tree, n: int):
        """Same-structure pytree with every compressible bucket replaced
        by Q(bucket + residual), the new residual carried to the next
        step. ``n`` is the comm size (the plan's pad modulus), so the
        packing is element for element the one the zero collectives
        move. Counts ``zero_ef_steps`` and the quantised buckets' wire
        bytes in ``zero_ef_bytes``."""
        from ompi_tpu_torch.parallel import hierarchical as H

        leaves, treedef = tree_flatten(tree)
        metas = _fuse_metas(leaves)
        plan = ZeroPlan(metas, int(bucket_var.get()), int(n))
        if self.plan is None or plan.buckets != self.plan.buckets \
                or plan.dtypes != self.plan.dtypes:
            self._bind(plan)
        outs = list(leaves)
        wsz = H.wire_itemsize(self.wire)
        ef_bytes = 0
        for b, idxs in enumerate(plan.buckets):
            if not self._active[b]:
                continue
            flat = pack(leaves, idxs, 0)
            r = self.residuals[b]
            if r is not None:
                flat = flat + r
            q = H.wire_quantize(flat, self.wire)
            self.residuals[b] = flat - q
            for i, leaf in zip(idxs, split(q, metas, idxs)):
                outs[i] = leaf
            ef_bytes += plan.elems[b] * wsz
        pvar.record("zero_ef_steps")
        pvar.record("zero_ef_bytes", ef_bytes)
        return tree_unflatten(treedef, outs)


# ---------------------------------------------------------------------------
# the host bucket cycle (numpy leaves, no device plane needed;
# ompi_tpu/zero/layout.py:367-435): the same ZeroPlan over the host
# collectives, one allreduce or allgather per bucket


def host_reduce_scatter_multi(comm, bufs, op=op_mod.SUM) -> ShardedState:
    """Bucketed reduce-scatter of numpy leaves: per bucket one host
    allreduce of the padded flat concat, then this rank's chunk (a
    copy). Same ZeroPlan layout and leaf order as the device path."""
    from ompi_tpu_torch.datatype import dtype_of

    leaves, treedef = tree_flatten(bufs)
    metas = _fuse_metas(leaves)
    plan = ZeroPlan(metas, int(bucket_var.get()), comm.size)
    rank, shards = comm.rank, []
    for b, idxs in enumerate(plan.buckets):
        flat = pack(leaves, idxs, plan.padded[b] - plan.elems[b])
        out = np.empty_like(flat)
        comm.coll.allreduce(comm, flat, out, out.size, dtype_of(out), op)
        k = plan.shard_elems[b]
        shards.append(out[rank * k:(rank + 1) * k].copy())
        pvar.record("zero_rs_launches")
    pvar.record("zero_fused_bytes", plan.nbytes)
    pvar.record("zero_pad_bytes", plan.pad_bytes)
    return ShardedState(plan, metas, treedef, shards, rank, comm.size)


def host_allgather_bucket(comm, state: ShardedState, b: int) -> list:
    """Gather one bucket of a numpy ShardedState: its member leaves in
    ``plan.buckets[b]`` order, in their shapes (the optimizer's
    frozen-bucket skip gathers bucket by bucket)."""
    plan = state.plan
    if not 0 <= b < len(plan.buckets):
        raise errors.MPIError(
            errors.ERR_COUNT,
            f"host_allgather_bucket: bucket {b} out of range for a "
            f"{len(plan.buckets)}-bucket plan")
    parts = comm.coll.allgather_obj(
        comm, np.ascontiguousarray(state.shards[b]))
    pvar.record("zero_ag_launches")
    return split(np.concatenate(parts), state.metas, plan.buckets[b])


def host_allgather_multi(comm, state: ShardedState):
    """Bucketed allgather of numpy shards back to the full pytree: per
    bucket one host allgather of the shard, concatenated in rank order
    (the pack order), unpacked."""
    fulls = []
    for shard in state.shards:
        parts = comm.coll.allgather_obj(comm, np.ascontiguousarray(shard))
        fulls.append(np.concatenate(parts))
        pvar.record("zero_ag_launches")
    pvar.record("zero_fused_bytes", state.plan.nbytes)
    return state.unpack(fulls)
