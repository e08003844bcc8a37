"""Expert-parallel MoE dispatch/combine over all-to-all, the port of
:mod:`ompi_tpu.ops.moe`.

Capacity-based top-1 (Switch-Transformer style) routing with static
shapes, overflow tokens dropped. Dispatch is a one-hot product plus an
Alltoall over the expert axis (``coll/device``'s, K2), the local experts
run their FFN on dense [E_local, n*C, D] blocks, and combine is the
inverse Alltoall weighted by the gates.

Precision follows jnp's promotion: the float32 dispatch times a bfloat16
``x`` is float32 (torch needs the cast written out), so the slots, the
exchanged blocks and the expert FFN are float32 with the expert weights
upcast; the output is cast back to ``x``'s dtype.

The drop is metered: :class:`MoEDispatch` carries the drop count and the
per-expert routed histogram. The reference records them only outside
jit; the port is always eager, so :func:`moe_ffn` records them on every
call (a device sync, read after the layer's output is queued) — a stated
difference (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.parallel import collectives as C


class MoEDispatch(NamedTuple):
    combine: torch.Tensor   # [T, E, C] combine weights (gate at slot)
    dispatch: torch.Tensor  # [T, E, C] 0/1 dispatch assignment
    counts: torch.Tensor    # [E] routed tokens per expert (pre-capacity)
    dropped: torch.Tensor   # [] tokens past capacity (drop-metered)


def record_dispatch_stats(route: MoEDispatch) -> None:
    """Meter one routing decision on the pvar plane
    (``serve_dropped_tokens``) and the monitoring plane's expert load."""
    dropped = int(route.dropped)
    counts = [int(c) for c in route.counts.tolist()]
    if dropped:
        pvar.record("serve_dropped_tokens", dropped)
    from ompi_tpu_torch import monitoring

    monitoring.expert_load(counts)


def _route(logits, capacity: int) -> MoEDispatch:
    t, e = logits.shape
    dev = logits.device
    gates = logits.float()
    gates = torch.exp(gates - gates.amax(-1, keepdim=True).detach())
    gates = gates / gates.sum(-1, keepdim=True)           # softmax [T,E]
    expert = gates.argmax(-1)                             # first max [T]
    onehot = torch.eye(e, dtype=torch.float32, device=dev)[expert]
    # position of each token within its expert's queue (arrival order)
    pos = torch.cumsum(onehot, 0) * onehot - 1.0          # [T,E]
    keep = (pos >= 0) & (pos < capacity)                  # [T,E]
    pos = pos.clamp(0, capacity - 1).to(torch.int64)
    posmask = torch.eye(capacity, dtype=torch.float32, device=dev)[pos]
    dispatch = posmask * keep[..., None]                  # [T,E,C]
    gate1 = (gates * onehot).sum(-1)                      # [T]
    combine = dispatch * gate1[:, None, None]
    counts = onehot.sum(0).to(torch.int32)                # [E]
    dropped = (t - dispatch.sum()).to(torch.int32)        # []
    return MoEDispatch(combine=combine, dispatch=dispatch, counts=counts,
                       dropped=dropped)


def top1_routing(logits, capacity: int) -> MoEDispatch:
    """Switch top-1 router. logits: [T, E]; C slots per expert. Computes
    in float32; records its stats (:func:`record_dispatch_stats`)."""
    route = _route(logits, capacity)
    record_dispatch_stats(route)
    return route


def ep_apply(route: MoEDispatch, x, w1, w2, axis):
    """The EP dispatch→FFN→combine leg on an already-decided routing:
    pack tokens into per-expert slots, alltoall over the expert axis, run
    the local experts, inverse-exchange and combine (the reference's
    reshape and transpose order)."""
    comm = C.comm_of(axis)
    n = comm.size
    t, d = x.shape
    e_local = w1.shape[0]
    cap = route.dispatch.shape[-1]
    e_total = e_local * n
    # pack tokens into per-expert slots: [E_total, C, D] (f32: the
    # dispatch is)
    slots = torch.einsum("tec,td->ecd", route.dispatch, x.float())
    # exchange over the expert axis: dim0 split by destination rank,
    # received stacked by source -> [n_src, E_local, C, D]
    slots = slots.reshape(n, e_local, cap, d)
    slots = C.alltoall(slots, comm, 0, 0)
    slots = slots.transpose(0, 1).reshape(e_local, n * cap, d)
    # local experts' FFN on dense blocks
    hidden = torch.relu(torch.einsum("ekd,edf->ekf", slots, w1.float()))
    out = torch.einsum("ekf,efd->ekd", hidden, w2.float())
    # inverse exchange: back to the source ranks
    out = out.reshape(e_local, n, cap, d).transpose(0, 1)
    out = C.alltoall(out, comm, 0, 0)
    # [n_expert_group, E_local, C, D] == [E_total, C, D] for this rank
    out = out.reshape(e_total, cap, d)
    return torch.einsum("tec,ecd->td", route.combine, out).to(x.dtype)


def moe_ffn(x, wg, w1, w2, axis, capacity_factor: float = 1.25):
    """Expert-parallel MoE FFN layer on this rank's tokens.

    x: local tokens [T, D]; wg: router [D, E_total] (replicated);
    w1/w2: this rank's experts [E_local, D, F], [E_local, F, D].
    E_total = E_local * axis_size(axis). Returns [T, D].
    """
    comm = C.comm_of(axis)
    n = comm.size
    t, d = x.shape
    e_local = w1.shape[0]
    e_total = e_local * n
    cap = max(int(capacity_factor * t / e_total), 1)
    dt = torch.promote_types(x.dtype, wg.dtype)
    route = _route(x.to(dt) @ wg.to(dt), cap)
    out = ep_apply(route, x, w1, w2, comm)
    record_dispatch_stats(route)
    return out
