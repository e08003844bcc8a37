"""Attention — single-device implementations, the port of
:mod:`ompi_tpu.ops.attention`.

The reference here is the correctness oracle for the distributed ring
attention (:mod:`ompi_tpu_torch.ops.ring_attention`) and Ulysses. Shapes
follow [batch, seq, heads, head_dim] throughout.

Precision: the reference multiplies bfloat16 operands into float32
results (``preferred_element_type=jnp.float32``). ``torch.einsum`` on
bfloat16 would round its result to bfloat16, so the products here upcast
their operands to float32 first, on the CPU and on the card: a product of
two bfloat16 values is exact in float32 (and in TF32, which keeps 10
mantissa bits), and the sums accumulate in float32. The softmax
statistics are float32 throughout. Against the reference, float32
inputs agree within the summation order's rounding (2e-5 on the tests'
shapes, with TF32 off on the card); bfloat16 outputs within one bfloat16
rounding of the float32 result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def default_scale(d: int) -> float:
    """The float32 value of ``1.0 / jnp.sqrt(d)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _scores(q, k):
    """``einsum("bqhd,bkhd->bhqk")`` with float32 results."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def _pv(p, v):
    """``einsum("bhqk,bkhd->bqhd", p.astype(v.dtype), v)`` with float32
    results."""
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def mha(q, k, v, causal: bool = True, scale: Optional[float] = None,
        q_offset: int = 0, k_offset: int = 0):
    """Multi-head attention, full-softmax reference.

    q: [B, Tq, H, D], k/v: [B, Tk, H, D] -> [B, Tq, H, D].
    q_offset/k_offset give the global positions of the local blocks
    (used when blocks are slices of a longer sequence).
    """
    d = q.shape[-1]
    scale = scale if scale is not None else default_scale(d)
    scores = _scores(q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask[None, None], scores, -torch.inf)
    p = torch.exp(scores - scores.amax(-1, keepdim=True).detach())
    p = torch.where(torch.isfinite(scores), p, 0.0)
    denom = p.sum(-1, keepdim=True)
    p = p / denom.clamp_min(1e-30)
    return _pv(p, v).to(q.dtype)


def mha_auto(q, k, v, causal: bool = True,
             scale: Optional[float] = None):
    """mha with the card's fast path: on CUDA tensors with head_dim and
    both sequence lengths multiples of 128, PyTorch's
    ``scaled_dot_product_attention`` (the reference calls jax's library
    flash attention there, not a kernel of its own); :func:`mha`
    everywhere else. The distributed paths (ring attention, Ulysses) use
    :func:`mha` and :func:`online_softmax_block`, never this."""
    d = q.shape[-1]
    if (q.is_cuda and d % 128 == 0 and q.shape[1] % 128 == 0
            and k.shape[1] % 128 == 0):
        sm = scale if scale is not None else 1.0 / float(d) ** 0.5
        out = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, scale=sm)
        return out.transpose(1, 2).to(q.dtype)
    return mha(q, k, v, causal=causal, scale=scale)


def online_softmax_block(q, k, v, o, l, m, mask=None,
                         scale: Optional[float] = None):
    """One flash-attention accumulation step over a KV block.

    Carries (all float32 regardless of activation dtype):
    o [B,Tq,H,D] numerator, l [B,H,Tq] denominator, m [B,H,Tq]
    running max. Returns updated (o, l, m).
    mask: [Tq, Tk] boolean (True = attend) or None.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else default_scale(d)
    s = _scores(q, k) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, -torch.inf)
    m_blk = s.amax(-1)  # [B,H,Tq]
    m_new = torch.maximum(m, m_blk)
    # fully-masked block: keep everything finite
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)  # [B,H,Tq,Tk]
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * corr + p.sum(-1)
    o_new = o * corr.transpose(1, 2)[..., None] + _pv(p, v)
    return o_new, l_new, m_new


def finalize_online_softmax(o, l):
    """o / l with fully-masked rows zeroed."""
    denom = l.transpose(1, 2)[..., None]  # [B,Tq,H,1]
    return torch.where(denom > 0, o / denom.clamp_min(1e-30), 0.0)
