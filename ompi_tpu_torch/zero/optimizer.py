"""zero/optimizer — sharded-state SGD(+momentum) over the zero collectives.

Port of :mod:`ompi_tpu.zero.optimizer` (Rajbhandari et al., SC'20).
Stage 2: gradients are reduce-scattered (``Comm.Reduce_scatter_multi``,
one collective per dtype bucket); stage 1: they are allreduced whole
(``Comm.Allreduce_multi``) and each rank slices its shard. Either way
each rank updates only its parameter shard and its momentum shard, and
``Comm.Allgather_multi`` rebuilds the replicated parameters.
``fused=True`` (stage 2) routes the reduce-scatter and the update
through coll/cuda's ``fused_rs_update_dev`` (K5), bitwise equal to the
unfused step in every mode. ``overlap=True`` (stage 2) binds one
``Comm.Preduce_scatter_init`` and Preadys each gradient leaf, so a
bucket's reduce-scatter runs once its last leaf is handed over
(``zero_overlap_flushes``); the buckets are the unfused step's, so the
result is its bits. Numpy parameters run the host bucket cycle.

Where the port differs from the reference: ``overlap=True`` Preadys the
leaves in reverse flatten order, the order a backward pass produces
them (the reference: flatten order; the results and the flush counts
are the same).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.trace import recorder as _trace
from ompi_tpu_torch.zero import layout as _layout


class ZeroShardedState:
    """The per-rank optimizer state: the parameter shard plus named
    optimizer slots (each a ShardedState over the same plan)."""

    __slots__ = ("params", "slots")

    def __init__(self, params: _layout.ShardedState, slots=None) -> None:
        self.params = params
        self.slots = dict(slots or {})

    @property
    def shard_bytes(self) -> int:
        """Bytes this rank holds (param shard + every slot shard)."""
        return self.params.shard_bytes + sum(
            s.shard_bytes for s in self.slots.values())

    @property
    def replicated_bytes(self) -> int:
        """Bytes a replicated (non-ZeRO) optimizer would hold."""
        return self.params.total_bytes + sum(
            s.total_bytes for s in self.slots.values())


class ZeroOptimizer:
    """SGD(+momentum) with ZeRO stage-1 or stage-2 sharded state over a
    comm.

    ``step(grads)`` runs one gradient reduction (stage 2: reduce-scatter;
    stage 1: allreduce, then the local shard) -> shard update ->
    allgather cycle and returns the new replicated parameter pytree
    (grads must match the template's structure, shapes and dtypes).

    - ``grad_average=True`` divides the reduced gradient shard by the
      comm size; False keeps the MPI SUM.
    - ``fused=True`` runs the reduce-scatter and update through the
      comm's ``fused_rs_update_dev`` slot when a component provides it
      (coll/cuda); a case the slot does not take (it returns None) runs
      the unfused step, as in the reference.
    - ``overlap=True`` (stage 2, not with ``fused``): binds a
      ``Preduce_scatter_init`` request at construction; each step
      Preadys the gradient leaves (last leaf first) with their values
      and waits for the cycle's shards. :meth:`free` frees it.
    - ``error_feedback`` (optional ``'bf16'`` / ``'fp8_e4m3'`` /
      ``'fp8_e5m2'``, not with ``fused``): each step quantises the
      gradients at the source through :class:`~ompi_tpu_torch.zero.
      layout.ErrorFeedback` (per-bucket residual carried to the next
      step) before the reduction.
    - ``frozen`` (optional pytree of bools matching ``params``): True
      marks a leaf that does not train. Its gradients are zeroed before
      the reduce-scatter (so it stays bitwise put inside a mixed bucket),
      buckets whose members are all frozen skip the update, and the
      allgather skips re-gathering them (``zero_ag_skipped``). Not with
      ``fused``.
    """

    def __init__(self, comm, params, lr: float = 1e-3,
                 momentum: float = 0.0, stage: int = 2,
                 deterministic: Optional[str] = None,
                 overlap: bool = False,
                 grad_average: bool = True,
                 fused: bool = False,
                 error_feedback: Optional[str] = None,
                 frozen=None) -> None:
        if stage not in (1, 2):
            raise errors.MPIError(
                errors.ERR_ARG,
                f"ZeroOptimizer: stage={stage} (ZeRO stages 1 and 2 "
                "shard state/gradients; stage 3 is a separate optimizer)")
        if overlap and stage != 2:
            raise errors.MPIError(
                errors.ERR_ARG,
                "ZeroOptimizer: overlap rides the partitioned "
                "reduce_scatter — stage 2 only")
        if fused and (stage != 2 or overlap):
            raise errors.MPIError(
                errors.ERR_ARG,
                "ZeroOptimizer: fused consumes the reduce_scattered "
                "gradient in-kernel — stage 2 only, and mutually "
                "exclusive with overlap")
        if fused and error_feedback is not None:
            raise errors.MPIError(
                errors.ERR_ARG,
                "ZeroOptimizer: error_feedback quantizes gradients before "
                "the collective — the fused in-kernel path has no such "
                "point; pick one")
        if fused and frozen is not None:
            raise errors.MPIError(
                errors.ERR_ARG,
                "ZeroOptimizer: frozen leaves require the unfused step "
                "(the fused kernel updates whole buckets)")
        self._comm = comm
        self._stage = stage
        self._lr = float(lr)
        self._mu = float(momentum)
        self._det = deterministic
        self._avg = bool(grad_average)
        self._fused = bool(fused)
        # checked at construction (ERR_ARG on an unknown wire), bound to
        # the gradients' own ZeroPlan at the first step
        self._ef = _layout.ErrorFeedback(error_feedback) \
            if error_feedback is not None else None
        # every rank holds the full initial params: the shard is a local
        # slice, no collective
        self._pshards = _layout.ShardedState.from_full(comm, params)
        slots = {}
        if self._mu:
            slots["momentum"] = self._pshards.zeros_like()
        self.state = ZeroShardedState(self._pshards, slots)
        self._n_leaves = len(_layout.tree_leaves(params))
        self._req = None
        if overlap:
            self._req = comm.Preduce_scatter_init(
                params, op_mod.SUM, deterministic=deterministic)
        #: per-bucket "has a trainable member" mask (None: all train)
        self._bucket_live = None
        self._frozen_leaves = None
        self._ag_versions = None
        self._ag_leaves: dict = {}
        if frozen is not None:
            fl = _layout.tree_leaves(frozen)
            if len(fl) != self._n_leaves:
                raise errors.MPIError(
                    errors.ERR_COUNT,
                    f"ZeroOptimizer: {len(fl)} frozen flags for a "
                    f"{self._n_leaves}-leaf parameter pytree")
            self._frozen_leaves = [bool(f) for f in fl]
            self._bucket_live = [
                any(not fl[i] for i in idxs)
                for idxs in self._pshards.plan.buckets]

    def step(self, grads):
        """reduce-scatter -> shard update -> allgather; returns the new
        replicated parameter pytree. While the trace recorder is up the
        whole step is a ``step`` span in ``zero`` (host time), fused or
        not."""
        rec = _trace.RECORDER
        if rec is None:
            return self._step(grads)
        t0 = _trace.now()
        out = self._step(grads)
        rec.record("step", "zero", t0, _trace.now())
        return out

    def _step(self, grads):
        mom = self.state.slots.get("momentum")
        if self._fused and "fused_rs_update_dev" in self._comm.coll.fns:
            fused = self._comm.coll.fused_rs_update_dev(
                self._comm, grads, self._pshards, mom,
                lr=self._lr, mu=self._mu, avg=self._avg,
                deterministic=self._det)
            if fused is not None:  # None: a case the slot does not take
                self._pshards, new_mom = fused
                self.state.params = self._pshards
                if new_mom is not None:
                    self.state.slots["momentum"] = new_mom
                return self._comm.Allgather_multi(self._pshards)
        # constants cast to the shard dtype, one rounded op at a time:
        # the op sequence of cuda_kernels.shard_update_plain, which the
        # fused path runs
        g = self._mask_frozen(grads)
        if self._ef is not None:
            # quantise at the source after the frozen mask (a frozen
            # leaf's zeros stay zeros, its residual zero) and before the
            # collective, so any transport reduces what the residual
            # accounts for
            g = self._ef.apply(g, self._comm.size)
        g = self._grad_shards(g)
        if self._avg:
            inv = 1.0 / self._comm.size
            g = g.map(lambda s: s * shard_const(inv, s))
        if mom is not None:
            mom = mom.map(lambda v, gs: shard_const(self._mu, v) * v + gs,
                          g, where=self._bucket_live)
            self.state.slots["momentum"] = mom
            g = mom
        self._pshards = self._pshards.map(
            lambda p, gs: p - shard_const(self._lr, p) * gs,
            g, where=self._bucket_live)
        self.state.params = self._pshards
        return self._gather_params()

    def _grad_shards(self, grads) -> _layout.ShardedState:
        """This rank's reduced gradient shards: stage 1 allreduces the
        whole gradients and slices the shards locally (the parameters'
        plan), stage 2 reduce-scatters them."""
        if self._stage == 1:
            full = self._comm.Allreduce_multi(
                grads, op_mod.SUM, deterministic=self._det)
            return _layout.ShardedState.from_full(
                self._comm, full, plan=self._pshards.plan)
        if self._req is not None:
            leaves = _layout.tree_leaves(grads)
            if len(leaves) != self._n_leaves:
                raise errors.MPIError(
                    errors.ERR_COUNT,
                    f"ZeroOptimizer.step: {len(leaves)} gradient leaves for "
                    f"a {self._n_leaves}-leaf template")
            self._req.start()
            for i in reversed(range(len(leaves))):  # the backward's order
                self._req.Pready(i, leaves[i])
            self._req.wait()
            return self._req.array
        return self._comm.Reduce_scatter_multi(
            grads, op_mod.SUM, deterministic=self._det)

    def _mask_frozen(self, grads):
        """Zero the gradients of frozen leaves (p - lr*0 == p bitwise)."""
        if self._frozen_leaves is None:
            return grads
        leaves, treedef = _layout.tree_flatten(grads)
        leaves = [(np.zeros_like(g) if isinstance(g, np.ndarray)
                   else torch.zeros_like(g)) if fr else g
                  for g, fr in zip(leaves, self._frozen_leaves)]
        return _layout.tree_unflatten(treedef, leaves)

    def _gather_params(self):
        """The allgather tail. With frozen leaves, bucket by bucket:
        buckets whose shard version did not move since the last gather
        reuse the gathered leaves (``zero_ag_skipped`` counts them)."""
        st = self._pshards
        if bool(st.shards) and isinstance(st.shards[0], np.ndarray):
            def bucket_dev(comm, state, b):
                return _layout.host_allgather_bucket(comm, state, b)
        else:
            bucket_dev = self._comm.coll.fns.get(
                "allgather_multi_bucket_dev")
        if self._bucket_live is None or all(self._bucket_live) \
                or bucket_dev is None:
            return self._comm.Allgather_multi(st)
        outs = [None] * self._n_leaves
        skipped = 0
        for b, idxs in enumerate(st.plan.buckets):
            cached = self._ag_leaves.get(b)
            if (cached is not None and self._ag_versions is not None
                    and self._ag_versions[b] == st.versions[b]):
                lb = cached
                skipped += 1
            else:
                lb = bucket_dev(self._comm, st, b)
            if not self._bucket_live[b]:
                # only all-frozen buckets can be clean again
                self._ag_leaves[b] = lb
            for j, i in enumerate(idxs):
                outs[i] = lb[j]
        if skipped:
            pvar.record("zero_ag_skipped", skipped)
        self._ag_versions = list(st.versions)
        return _layout.tree_unflatten(st.treedef, outs)

    def params(self):
        """Replicated parameters rebuilt from the current shards."""
        return self._gather_params()

    def free(self) -> None:
        """Free the overlap mode's partitioned request."""
        if self._req is not None:
            self._req.free()
            self._req = None


def shard_const(value: float, shard):
    """``value`` cast to a shard's dtype, numpy for a numpy shard (the
    reference's ``np.asarray(value, dtype)``) and a 0-d tensor for a
    tensor (:func:`cuda_kernels.shard_const`)."""
    if isinstance(shard, np.ndarray):
        return np.asarray(value, shard.dtype)
    return K.shard_const(value, shard.dtype)
