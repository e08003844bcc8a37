"""Ring attention — context/sequence parallelism over a ring of ranks,
the port of :mod:`ompi_tpu.ops.ring_attention`.

The sequence is sharded along a mesh axis; KV blocks rotate around the
ring (one ``permute_dev`` exchange a hop, K2 pulling the (k, v) pair:
:func:`ompi_tpu_torch.parallel.ring.ring_scan`), and each hop's block
feeds flash-style online-softmax accumulation
(:func:`ompi_tpu_torch.ops.attention.online_softmax_block`). The hops
step on the host, so a hop does not yet overlap the previous block's
compute (see :mod:`ompi_tpu_torch.parallel.ring`).

Memory: O(T_local) per rank — sequence length scales linearly with the
ring size (the point of context parallelism).
"""

from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch.ops import attention as att
from ompi_tpu_torch.parallel import collectives as C, ring


def ring_attention(q, k, v, axis, causal: bool = True,
                   scale: Optional[float] = None):
    """Context-parallel attention on this rank's blocks.

    q/k/v: local blocks [B, T_local, H, D]; the global sequence is the
    concatenation over the `axis` ring in rank order. Returns the local
    output block [B, T_local, H, D].
    """
    comm = C.comm_of(axis)
    r = comm.rank
    b, t, h, d = q.shape
    # accumulators in f32 (flash-attention convention) even for bf16
    # activations; cast back at the end
    o0 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l0 = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    m0 = torch.full((b, h, t), -torch.inf, dtype=torch.float32,
                    device=q.device)

    tpos = torch.arange(t, device=q.device)

    def body(s, src, blk, carry):
        o, l, m = carry
        kb, vb = blk
        if causal:
            qpos = r * t + tpos
            kpos = src * t + tpos
            mask = qpos[:, None] >= kpos[None, :]
        else:
            mask = None
        return att.online_softmax_block(q, kb, vb, o, l, m, mask=mask,
                                        scale=scale)

    o, l, m = ring.ring_scan(body, (o0, l0, m0), (k, v), comm)
    return att.finalize_online_softmax(o, l).to(q.dtype)
