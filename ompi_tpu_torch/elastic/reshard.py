"""elastic/reshard — ZeroPlan re-shard arithmetic for shrink and regrow.

The port's copy of ``ompi_tpu.elastic.reshard``. The invariant it rests
on (``zero/layout.ZeroPlan``): a bucket's composition depends only on
(metas, bucket_bytes); the comm size ``n`` changes only the pad tail
(``padded = ceil(elems/n)*n``) and the shard length. So moving sharded
optimizer state between comm sizes is layout arithmetic, no collective
and no disk::

    old chunks (rank order) -> concat -> strip the pad to elems[b]
        -> pad again for the new n -> slice the new rank's chunk

:func:`full_flats` does the first half from whatever per-old-rank chunks
survived (a rank's own snapshot, its buddy replica, or a sharded
checkpoint's global view); :func:`pack` the second half onto the
survivors' plan. Both are deterministic in their inputs, which makes the
in-memory path bitwise equal to restoring the last sharded checkpoint
into the shrunken comm.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.zero import layout as _layout


def host_chunks(state: _layout.ShardedState) -> List[np.ndarray]:
    """Host copies of one rank's shard chunks (what the buddy ring
    replicates and the snapshots keep: never the live arrays the
    optimizer goes on replacing)."""
    return [np.array(_host(s), copy=True) for s in state.shards]


def _host(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    from ompi_tpu_torch import io as _io

    return _io.host_array(x)


def full_flats(chunks_by_rank: Dict[int, Sequence[np.ndarray]],
               elems: Sequence[int]) -> List[np.ndarray]:
    """The old buckets' flats rebuilt from per-old-rank chunks, the pad
    stripped. ``chunks_by_rank`` must cover the whole old comm
    0..n_old-1: the caller decides whether the state is recoverable (and
    falls back to the checkpoint when a dead rank's chunk has no live
    owner)."""
    if not chunks_by_rank:
        raise errors.MPIError(
            errors.ERR_INTERN,
            "elastic reshard: no surviving shard chunks to rebuild from")
    n_old = max(chunks_by_rank) + 1
    missing = [r for r in range(n_old) if r not in chunks_by_rank]
    if missing:
        raise errors.MPIError(
            errors.ERR_INTERN,
            f"elastic reshard: old ranks {missing} have no surviving "
            "shard chunk (recoverability must be checked before "
            "rebuilding)")
    flats = []
    for b, e in enumerate(elems):
        full = np.concatenate([np.asarray(chunks_by_rank[r][b])
                               for r in range(n_old)])
        if full.size < e:
            raise errors.MPIError(
                errors.ERR_INTERN,
                f"elastic reshard: bucket {b} rebuilt {full.size} "
                f"elements for a {e}-element bucket (chunks from a "
                "different plan?)")
        flats.append(full[:e])
    return flats


def pack(plan: _layout.ZeroPlan, template: _layout.ShardedState,
         flats: Sequence[np.ndarray], rank: int) -> _layout.ShardedState:
    """Pad stripped bucket flats for ``plan.n`` and slice ``rank``'s
    chunk: the scatter half of the re-shard. ``template`` gives the metas
    and treedef (the same leaves, so the same buckets)."""
    if len(flats) != len(plan.buckets):
        raise errors.MPIError(
            errors.ERR_INTERN,
            f"elastic reshard: {len(flats)} bucket flats for a "
            f"{len(plan.buckets)}-bucket plan")
    shards = []
    for b, flat in enumerate(flats):
        flat = np.asarray(flat)
        if flat.size != plan.elems[b]:
            raise errors.MPIError(
                errors.ERR_INTERN,
                f"elastic reshard: bucket {b} flat has {flat.size} "
                f"elements, plan expects {plan.elems[b]}")
        pad = plan.padded[b] - plan.elems[b]
        if pad:
            flat = np.pad(flat, (0, pad))
        k = plan.shard_elems[b]
        shards.append(np.array(flat[rank * k:(rank + 1) * k], copy=True))
    return _layout.ShardedState(plan, template.metas, template.treedef,
                                shards, rank, plan.n)
