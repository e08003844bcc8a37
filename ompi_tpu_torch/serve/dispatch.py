"""Capacity-factor dispatch policies over the EP Alltoall path — the port
of :mod:`ompi_tpu.serve.dispatch`.

The training router (:func:`ompi_tpu_torch.ops.moe.top1_routing`) is
Switch-Transformer top-1 with static capacity: every token past an
expert's ``C`` slots is zeroed. Under serving skew that is a policy, and
this module makes it explicit:

``drop``
    The training path: the same routing and ``ep_apply`` op sequence as
    ``moe_ffn``, so the output is bitwise ``moe_ffn``'s, with the overflow
    metered (a stats vector read back once a dispatch feeds
    ``serve_dropped_tokens`` and the expert-load view).

``reroute``
    Overflow tokens re-dispatched to the least-loaded experts of the same
    comm (GShard's second-expert idea, restricted to free capacity):
    experts sorted by primary load ascending, the j-th overflow token
    takes the j-th free slot in that order, its combine weight its gate
    for the expert it landed on. Token-conserving by construction.

``dcn_overflow``
    Topology-aware, over coll/hier's grid (``coll_hier._plan``): the
    primary dispatch runs drop over the ICI level only (the slices are
    expert replicas, so ``E_total = E_local * n_ici``); the overflow rows
    then travel to the next slice's replica of their expert over the DCN
    level with two ``coll/device.alltoallv_dev`` legs (rows out,
    activations back), are served from that replica and added back at
    their positions. ``serve_dcn_budget_bytes`` bounds the shipped bytes
    a dispatch; overflow past it drops.

The policies run on torch tensors on the comm's device-plane device: the
Dispatcher stages its weights there once, as float32 (the reference's
staging dtype), and the EP Alltoalls are coll/device's (K2's pull
schedule on the card). An unknown policy raises ``MPIError(ERR_ARG)`` at
every dispatch, never cached.

Where the port differs from the reference (ROADMAP queue 3):

- the reference compiles one program per (policy, mesh, capacity); the
  port runs the same ops eagerly, and reads the stats back with one
  device sync a dispatch, after the output is queued;
- ``dcn_overflow`` serves its visitors on the card, grouped by expert
  (one product pair per expert present); the reference copies the rank's
  experts to the host and gathers ``w1[e]`` per visitor row. The sums run
  in another order, so the remote rows agree within the reference tests'
  ``rtol 1e-4, atol 1e-5``, not bitwise; the visitor rows' expert ids are
  read back with one more sync.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.coll import device as _dev
from ompi_tpu_torch.coll import hier as _hier
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.monitoring import matrix as _mon
from ompi_tpu_torch.ops import moe
from ompi_tpu_torch.parallel import collectives as C
from ompi_tpu_torch.runtime import device_plane

#: dispatch policy names, in documentation order
POLICIES = ("drop", "reroute", "dcn_overflow")

# registered without choices=, as the reference: serve configuration
# errors surface at dispatch time as MPIError(ERR_ARG)
_budget_var = cvar.register(
    "serve_dcn_budget_bytes", 0, int,
    help="Per-dispatch byte budget for the dcn_overflow policy's "
         "remote leg (forward token rows + returned activations, "
         "f32 wire). Overflow tokens past the budget are dropped — "
         "the link-cost-aware drop decision. 0 [default] ships every "
         "overflow token.", level=5)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """The gate formula of ``top1_routing`` (float32, max-shifted)."""
    g = logits.float()
    g = torch.exp(g - g.amax(-1, keepdim=True).detach())
    return g / g.sum(-1, keepdim=True)


def reroute_routing(logits: torch.Tensor, capacity: int):
    """Top-1 routing with the overflow re-dispatched to free capacity.

    Returns ``(MoEDispatch, rerouted)``. Overflow tokens rank by arrival
    (j = their index among the overflow), experts by primary load
    ascending (a stable sort: ties keep expert order), and the j-th
    overflow token takes the j-th free slot in that expert order
    (``searchsorted`` over the cumulative free-slot counts). Tokens past
    the total free capacity stay dropped."""
    t, e = logits.shape
    dev = logits.device
    f32 = torch.float32
    gates = _softmax(logits)
    expert = gates.argmax(-1)                             # [T]
    onehot = torch.eye(e, dtype=f32, device=dev)[expert]  # [T,E]
    pos = torch.cumsum(onehot, 0) * onehot - 1.0          # [T,E]
    keep = (pos >= 0) & (pos < capacity)
    pos_c = pos.clamp(0, capacity - 1).to(torch.int64)
    dispatch = (torch.eye(capacity, dtype=f32, device=dev)[pos_c]
                * keep[..., None])                        # [T,E,C]
    gate1 = (gates * onehot).sum(-1)                      # [T]
    combine = dispatch * gate1[:, None, None]
    counts = onehot.sum(0).to(torch.int32)                # [E]

    # the reroute leg: j-th overflow token -> j-th free slot
    used = counts.clamp(max=capacity).to(torch.int64)     # [E]
    free = capacity - used                                # [E]
    order = torch.argsort(used, stable=True)              # least loaded 1st
    cfree = torch.cumsum(free[order], 0)                  # [E]
    total_free = cfree[-1]
    over = 1 - (dispatch.sum((1, 2)) > 0.5).to(torch.int64)  # [T]
    j = torch.cumsum(over, 0) * over - 1                  # [T], -1 = kept
    valid = (over > 0) & (j >= 0) & (j < total_free)
    k = torch.searchsorted(cfree, j, right=True).clamp(0, e - 1)
    new_e = order[k]                                      # [T]
    offset = torch.where(k > 0, cfree[(k - 1).clamp(min=0)],
                         torch.zeros_like(k))
    slot = (used[new_e] + (j - offset)).clamp(0, capacity - 1)
    oh_new = (torch.eye(e, dtype=f32, device=dev)[new_e]
              * valid.to(f32)[:, None])                   # [T,E]
    disp_new = (torch.eye(capacity, dtype=f32, device=dev)[slot][:, None, :]
                * oh_new[..., None])                      # [T,E,C]
    gate_new = (gates * oh_new).sum(-1)                   # [T]
    dispatch = dispatch + disp_new
    combine = combine + disp_new * gate_new[:, None, None]
    rerouted = valid.sum().to(torch.int32)
    dropped = (over.sum() - rerouted).to(torch.int32)
    return moe.MoEDispatch(combine=combine, dispatch=dispatch,
                           counts=counts, dropped=dropped), rerouted


def routed_ffn(x, wg, w1, w2, axis, capacity_factor: float, policy: str):
    """``moe_ffn`` with explicit overflow handling and a stats tail, on
    this rank's tokens over ``axis`` (a mesh axis or a comm). Returns
    ``(out [T, D], stats)``, stats ``int32 [4 + E]``: kept, rerouted,
    dropped, multi-assigned tokens (the conservation probe, always 0),
    then the per-expert routed histogram (pre-capacity demand)."""
    if policy not in ("drop", "reroute"):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"routed_ffn: policy {policy!r} not traceable here "
            "(expected 'drop' or 'reroute'; 'dcn_overflow' needs the "
            "Dispatcher's host legs)")
    comm = C.comm_of(axis)
    t = x.shape[0]
    e_total = w1.shape[0] * comm.size
    cap = max(int(capacity_factor * t / e_total), 1)
    dt = torch.promote_types(x.dtype, wg.dtype)
    logits = x.to(dt) @ wg.to(dt)
    if policy == "drop":
        route = moe._route(logits, cap)
        rerouted = torch.zeros((), dtype=torch.int32, device=x.device)
    else:
        route, rerouted = reroute_routing(logits, cap)
    out = moe.ep_apply(route, x, w1, w2, comm)
    multi = (route.dispatch.sum((1, 2)) > 1.5).sum().to(torch.int32)
    kept = (t - route.dropped - rerouted).to(torch.int32)
    stats = torch.cat([torch.stack([kept, rerouted, route.dropped, multi]),
                       route.counts])
    return out, stats


class Dispatcher:
    """One serving MoE layer bound to a communicator.

    ``wg`` is the router ``[D, E_total]`` (replicated), ``w1`` / ``w2``
    this rank's experts ``[E_local, D, F]`` / ``[E_local, F, D]``, numpy
    arrays or tensors, staged once on the comm's device as float32 (a
    float32 tensor already there is used as it is). Under the flat
    policies ``E_total = E_local * comm.size``; under ``dcn_overflow``
    ``E_total = E_local * n_ici`` and every slice passes the same logical
    weights. ``dispatch(x)`` returns ``(out, info)``: the output tensor on
    the device and the host stats dict; every dispatch feeds the
    ``serve_*`` pvars and the monitoring plane's ``[serve]`` table.
    ``last_dcn_counts`` holds the last ``dcn_overflow`` dispatch's
    (scounts, rcounts) of its forward leg."""

    def __init__(self, comm, wg, w1, w2, *,
                 capacity_factor: float = 1.25,
                 policy: str = "drop") -> None:
        self.comm = comm
        self.wg, self.w1, self.w2 = wg, w1, w2
        self.capacity_factor = float(capacity_factor)
        self.policy = policy
        self._staged: Optional[tuple] = None
        self.last_dcn_counts: Optional[tuple] = None

    def _device(self) -> torch.device:
        if not device_plane.active():
            raise errors.MPIError(
                errors.ERR_ARG,
                "serve: the Dispatcher runs on the device plane; start "
                "the job with --mca device_plane on")
        return device_plane.device()

    def _weights(self):
        if self._staged is None:
            dev = self._device()
            self._staged = tuple(
                torch.as_tensor(w, dtype=torch.float32, device=dev)
                for w in (self.wg, self.w1, self.w2))
        return self._staged

    def dispatch(self, x):
        # the policy is checked before anything else: a bad name raises
        # at every call
        if self.policy not in POLICIES:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"serve: unknown dispatch policy {self.policy!r} "
                f"(expected one of {POLICIES})")
        x = torch.as_tensor(x, dtype=torch.float32, device=self._device())
        if self.policy == "dcn_overflow":
            return self._dispatch_dcn(x)
        return self._dispatch_flat(x)

    __call__ = dispatch

    def _check_router(self, groups: int, scope: str) -> None:
        e_total = int(self.wg.shape[1])
        e_local = int(self.w1.shape[0])
        if e_total != e_local * groups:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"serve: router wg has {e_total} experts but "
                f"{self.policy!r} dispatch expects e_local * {scope} "
                f"= {e_local} * {groups} = {e_local * groups}")

    # -- drop / reroute over the flat comm ---------------------------------
    def _dispatch_flat(self, x):
        self._check_router(self.comm.size, "comm.size")
        wg, w1, w2 = self._weights()
        out, stats = routed_ffn(x, wg, w1, w2, self.comm,
                                self.capacity_factor, self.policy)
        return out, self._meter(stats.cpu().numpy(), int(x.shape[0]), 0, 0)

    # -- dcn_overflow: ICI drop, then the DCN legs -------------------------
    def _dispatch_dcn(self, x):
        plan = _hier._plan(self.comm)  # ERR_ARG on a bad split, uncached
        if plan is None:
            raise errors.MPIError(
                errors.ERR_ARG,
                "serve: policy 'dcn_overflow' needs a hier grid for "
                "this comm — set coll_hier_split (e.g. '2x2') or run "
                "across slices")
        t, d = (int(s) for s in x.shape)
        n_ici, n_dcn = plan.n_ici, plan.n_dcn
        self._check_router(n_ici, "n_ici (slices are replicas)")
        wg, w1, w2 = self._weights()
        e_local = int(w1.shape[0])
        cap = max(int(self.capacity_factor * t / (e_local * n_ici)), 1)
        logits = x @ wg
        route = moe._route(logits, cap)
        out = moe.ep_apply(route, x, w1, w2, plan.low)
        assigned = route.dispatch.sum((1, 2))
        kept_tok = (assigned > 0.5).to(torch.int32)           # [T]
        picked = logits.argmax(-1).to(torch.int32)            # [T]
        gate1 = _softmax(logits).amax(-1)                     # [T]
        multi = (assigned > 1.5).sum().to(torch.int32)
        stats = torch.cat([
            torch.stack([kept_tok.sum().to(torch.int32),
                         torch.zeros_like(multi), route.dropped, multi]),
            route.counts])
        host = torch.cat([stats, kept_tok, picked]).cpu().numpy()
        stats = host[:stats.numel()].copy()
        kept_h = host[stats.size:stats.size + t]
        picked_h = host[stats.size + t:].astype(np.int64)

        # the DCN leg: overflow rows to the next slice's replica of their
        # expert. Every rank runs the same collective sequence
        # (allgather_obj, then two alltoallv) even with no overflow.
        me, size = self.comm.rank, self.comm.size
        d_me = me // n_ici
        over_idx = np.nonzero(kept_h == 0)[0]
        row_elems = d + 2                      # x row, e_rel, gate
        cost = (row_elems + d) * 4             # forward + return, f32
        budget = int(_budget_var.get())
        n_ship = len(over_idx)
        if budget > 0:
            n_ship = min(n_ship, budget // cost)
        shipped = over_idx[:n_ship]
        e_rel = picked_h[shipped] % e_local
        owner_ici = picked_h[shipped] // e_local
        dst = ((d_me + 1) % n_dcn) * n_ici + owner_ici
        order = np.argsort(dst, kind="stable")
        shipped, dst, e_rel = shipped[order], dst[order], e_rel[order]
        idx = torch.as_tensor(shipped, dtype=torch.int64, device=x.device)
        payload = torch.zeros((len(shipped), row_elems), dtype=torch.float32,
                              device=x.device)
        payload[:, :d] = x[idx]
        payload[:, d] = torch.as_tensor(e_rel, dtype=torch.float32,
                                        device=x.device)
        payload[:, d + 1] = gate1[idx]
        scounts = tuple(int(c) for c in np.bincount(dst, minlength=size))
        mat = self.comm.coll.allgather_obj(self.comm, scounts)
        rcounts = tuple(int(mat[s][me]) for s in range(size))
        self.last_dcn_counts = (scounts, rcounts)
        fwd = _dev.alltoallv_dev(self.comm, payload, scounts, rcounts,
                                 max_count=t, _expert_tokens=False)
        y = self._serve_visitors(fwd, d, w1, w2)
        back = _dev.alltoallv_dev(self.comm, y, rcounts, scounts,
                                  max_count=t, _expert_tokens=False)
        # the returned rows arrive grouped by serving rank ascending:
        # exactly the dst-sorted payload order
        if len(shipped):
            out[idx] += back
        dcn_bytes = int(payload.nbytes) + len(shipped) * d * 4
        stats[2] -= len(shipped)  # DCN-served tokens are not dropped
        info = self._meter(stats, t, len(shipped), dcn_bytes)
        tm = _mon.TRAFFIC
        if tm is not None:
            tm.hier("serve_overflow", 0.0, float(dcn_bytes))
        return out, info

    @staticmethod
    def _serve_visitors(fwd, d: int, w1, w2):
        """This replica's FFN on the visitor rows ``fwd`` (x row, local
        expert id, gate), one product pair per expert present."""
        y = torch.zeros((fwd.shape[0], d), dtype=torch.float32,
                        device=fwd.device)
        if not fwd.shape[0]:
            return y
        er = fwd[:, d].to(torch.int64).cpu().numpy()
        for e in np.unique(er):
            rows = torch.as_tensor(np.nonzero(er == e)[0], dtype=torch.int64,
                                   device=fwd.device)
            xs = fwd[rows, :d]
            h = torch.relu(xs @ w1[int(e)])
            y[rows] = (h @ w2[int(e)]) * fwd[rows, d + 1][:, None]
        return y

    # -- stats -> pvars / monitoring ---------------------------------------
    def _meter(self, stats, tokens: int, dcn_tokens: int,
               dcn_bytes: int) -> dict:
        kept, rerouted, dropped, multi = (int(v) for v in stats[:4])
        counts = [int(c) for c in stats[4:]]
        pvar.record("serve_tokens", tokens)
        if dropped:
            pvar.record("serve_dropped_tokens", dropped)
        if rerouted:
            pvar.record("serve_rerouted_tokens", rerouted)
        if dcn_tokens:
            pvar.record("serve_dcn_overflow_tokens", dcn_tokens)
        if dcn_bytes:
            pvar.record("serve_dcn_overflow_bytes", dcn_bytes)
        from ompi_tpu_torch import monitoring

        monitoring.expert_load(counts)
        tm = _mon.TRAFFIC
        if tm is not None:
            tm.serve_event(self.policy, tokens=tokens, kept=kept,
                           rerouted=rerouted, dropped=dropped,
                           dcn_tokens=dcn_tokens, dcn_bytes=dcn_bytes)
        return {"policy": self.policy, "tokens": tokens, "kept": kept,
                "rerouted": rerouted, "dropped": dropped,
                "multi_assigned": multi, "dcn_tokens": dcn_tokens,
                "dcn_bytes": dcn_bytes, "counts": counts}
