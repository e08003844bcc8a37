"""Ulysses-style sequence parallelism — all-to-all context parallel, the
port of :mod:`ompi_tpu.ops.ulysses`.

ONE all-to-all re-shards q/k/v from sequence-sharded [B, T/P, H, D] to
head-sharded [B, T, H/P, D] (a stacked [3, B, T/P, H, D] tensor, heads
split at dim 3, the sequence gathered at dim 2 in source-rank order),
every rank runs full (exact, single-pass) attention over the whole
sequence for its head subset, and a second all-to-all restores sequence
sharding. The moved data is bitwise (``coll/device``'s Alltoall, K2).

Trade-off vs ring: 2 all-to-all launches in all and an exact softmax, but
heads % axis_size == 0 is required and the full-T attention of H/P heads
is resident; ring attention takes any head count with O(T/P) memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.ops import attention as att
from ompi_tpu_torch.parallel import collectives as C


def _heads_to_seq(x, axis):
    """Inverse reshard: [B, T, H/P, D] -> [B, T/P, H, D]."""
    return C.alltoall(x, axis, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, axis, causal: bool = True,
                      scale: Optional[float] = None):
    """Context-parallel attention via head resharding. q/k/v: local
    sequence blocks [B, T_local, H, D] in rank order along ``axis``;
    returns the local output block.

    Requires H to be divisible by the axis size (each rank owns a whole
    head subset while attending over the full sequence); otherwise
    ``MPIError(ERR_ARG)``."""
    comm = C.comm_of(axis)
    n = comm.size
    h = q.shape[2]
    if h % n:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"ulysses: {h} heads not divisible by axis size {n}; "
            "use ring_attention for this configuration")
    # one batched collective reshards q/k/v together ([3,B,T/P,H,D]:
    # split heads at dim 3, gather sequence at dim 2)
    qkv = C.alltoall(torch.stack([q, k, v]), comm, split_dim=3,
                     concat_dim=2)
    # exact full-sequence attention on the head subset (global positions
    # are the natural ones after the gather)
    oh = att.mha(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale)
    return _heads_to_seq(oh, comm).to(q.dtype)
