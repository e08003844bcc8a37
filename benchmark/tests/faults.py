"""Faults planted under the timed path, for the checks of ``correct``.

``run.py --fault NAME`` has every rank call :func:`plant` before it
builds the optimizer; the planted step replaces
``ZeroOptimizer.step`` in that process alone:

- ``unchanged``: the step returns the parameters and leaves the state
  as it was;
- ``half_batch``: half of the ranks' gradients left out, the mean taken
  over the rest (the lower half hands twice its gradients, the upper
  half zeros);
- ``no_exchange``: the reduce-scatter left out, each rank updating its
  shard with its own gradients' chunk alone;
- ``altered``: the step's answer altered where it is produced (the first
  element of every parameter leaf of the gathered result moved by 0.5);
- ``ring_order``: a ``deterministic='linear'`` step reduced in the ring's
  order instead of rank order (a sound sum, no longer the rank-order
  fold that makes it reproducible).
"""

from __future__ import annotations


def _unchanged(orig):
    def step(self, grads):
        return self.params()
    return step


def _half_batch(orig):
    from ompi_tpu_torch.zero import layout as zl

    def step(self, grads):
        n, r = self._comm.size, self._comm.rank
        leaves, treedef = zl.tree_flatten(grads)
        leaves = [g * 2 if r < n // 2 else g * 0 for g in leaves]
        return orig(self, zl.tree_unflatten(treedef, leaves))
    return step


def _no_exchange(orig):
    from ompi_tpu_torch.coll import cuda_kernels as K
    from ompi_tpu_torch.zero import layout as zl

    def step(self, grads):
        r = self._comm.rank
        leaves = zl.tree_leaves(grads)
        st, mom = self._pshards, self.state.slots["momentum"]
        plan = st.plan
        ps, vs = [], []
        for b, idxs in enumerate(plan.buckets):
            flat = zl.pack(leaves, idxs, plan.padded[b] - plan.elems[b])
            k = plan.shard_elems[b]
            dt = flat.dtype
            p, v = K.shard_update_plain(
                flat[r * k:(r + 1) * k], st.shards[b], mom.shards[b],
                K.shard_const(self._lr, dt), K.shard_const(self._mu, dt),
                None)
            ps.append(p)
            vs.append(v)
        self._pshards = zl.ShardedState(plan, st.metas, st.treedef, ps,
                                        st.rank, st.n)
        self.state.params = self._pshards
        self.state.slots["momentum"] = zl.ShardedState(
            plan, st.metas, st.treedef, vs, st.rank, st.n)
        return self._comm.Allgather_multi(self._pshards)
    return step


def _altered(orig):
    from ompi_tpu_torch.zero import layout as zl

    def step(self, grads):
        out = orig(self, grads)
        for leaf in zl.tree_leaves(out):
            leaf.view(-1)[0] += 0.5
        return out
    return step


def _ring_order(orig):
    def step(self, grads):
        det, self._det = self._det, None
        try:
            return orig(self, grads)
        finally:
            self._det = det
    return step


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "altered": _altered,
          "ring_order": _ring_order}
#: the faults a cell whose reduction is 'linear' can have besides these
LINEAR_ONLY = ("ring_order",)


def plant(name: str) -> None:
    from ompi_tpu_torch.zero import optimizer

    cls = optimizer.ZeroOptimizer
    cls.step = FAULTS[name](cls.step)
