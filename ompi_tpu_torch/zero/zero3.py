"""zero/zero3 — ZeRO stage 3: the parameters sharded, streamed a layer at
a time with a layer-ahead prefetch.

The port's copy of ``ompi_tpu.zero.zero3`` (zero3.py:69-456).
Stage 3 (P\\ :sub:`os+g+p`, Rajbhandari et al. SC'20; FSDP is the same
idea) shards the parameters themselves: each rank keeps its 1/n flat
shard and materializes a layer's full weights just in time, freeing them
right after. The stream is built from the zero/ and part/ pieces:

- layout: :func:`~ompi_tpu_torch.zero.layout.layer_groups` cuts the
  parameter pytree into layers; each layer's leaves pack into their own
  :class:`~ompi_tpu_torch.zero.layout.ZeroPlan` buckets.
- persistent collectives: one ``Comm.Allgather_multi_init`` request per
  layer, planned and mapped once (its arenas are coll/cuda's per-comm
  size classes, shared by every request of the comm); after each step's
  update the request's ``rebind`` takes the fresh shards.
- the prefetch: :class:`~ompi_tpu_torch.part.overlap.LayerPrefetcher`
  starts layer k+1's gather when layer k is fetched;
  :meth:`Zero3Optimizer.fetch` waits only where the prefetch lost the
  race (``zero_prefetch_late_ns``).
- free after use: :meth:`Zero3Optimizer.release` drops the gathered
  tensors and the request's ``discard`` drops its result, so residency
  is the shards plus the prefetch window (``zero3_resident_bytes``, a
  high watermark).
- the fused product: :meth:`Zero3Optimizer.matmul` of a one-leaf 2-D
  layer goes through ``zero3_gather_matmul_dev`` where coll/cuda
  provides it (K6 on this rank's row block: the full weight is never
  gathered); other layouts fall through to fetch + ``@``.

The update is the stage-1/2 :class:`~ompi_tpu_torch.zero.optimizer.
ZeroOptimizer`'s, op for op (constants cast to the shard dtype), and a
'linear' reduce-scatter or allgather gives each element the same bits
however the leaves are bucketed, so a stage-3 run under
``deterministic='linear'`` equals stage 1 bitwise, momentum included.
Under 'ring' the buckets' chunking differs from stage 2's, so the two
agree within a few roundings.

``error_feedback`` quantises each layer's gradients at the source with a
per-layer carried residual (:class:`~ompi_tpu_torch.zero.layout.
ErrorFeedback`) before the reduce-scatter, the stage-3 shape of the
stage-1/2 option.

The observability sites are the reference's (zero3.py:248-250,
:296-311): a started gather is a ``prefetch_start`` marker in the
``prefetch`` lane; a blocked wait runs in the prof ledger's
``prefetch`` phase and is a ``prefetch_wait`` span; the telemetry
watchdog's hang dump names the last blocked wait (:func:`prefetch_info`).

Where the port differs from the reference: coll/device's gathers step
on the host inside ``start()``, so a prefetched gather is complete when
the consumer arrives: the prefetch
does not yet hide communication behind the caller's work (ROADMAP queue
2 item 2).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.part.overlap import LayerPrefetcher
from ompi_tpu_torch.prof import ledger as _prof
from ompi_tpu_torch.trace import recorder as _trace
from ompi_tpu_torch.zero import layout as _layout
from ompi_tpu_torch.zero.optimizer import shard_const

#: the last blocked prefetch ({layer, pos, step, late_ns}), or None
_PREFETCH_INFO: Optional[dict] = None


def prefetch_info() -> Optional[dict]:
    """The most recent blocked-prefetch record ({layer, pos, step,
    late_ns}), or None if every fetch so far found its gather complete
    (the reference's watchdog reads it)."""
    return _PREFETCH_INFO


class Zero3Plan:
    """The layer-grouped ZeroPlan layout: :func:`~ompi_tpu_torch.zero.
    layout.layer_groups` fixes the streaming order and each layer's
    leaves get their own plan (the ``coll_device_bucket_bytes`` close
    rule, pad to n). Deterministic in (template structure and shapes,
    bucket_bytes, n): every rank derives it locally."""

    __slots__ = ("groups", "plans", "n", "treedef", "n_leaves")

    def __init__(self, template, n: int,
                 bucket_bytes: Optional[int] = None) -> None:
        leaves, self.treedef = _layout.tree_flatten(template)
        if not leaves:
            raise errors.MPIError(
                errors.ERR_ARG,
                "Zero3Plan: empty parameter pytree (nothing to shard)")
        self.n = int(n)
        self.n_leaves = len(leaves)
        self.groups = _layout.layer_groups(template)
        self.plans = tuple(
            _layout.plan_for([leaves[i] for i in idxs], self.n,
                             bucket_bytes)
            for _name, idxs in self.groups)

    @property
    def n_layers(self) -> int:
        return len(self.groups)

    @property
    def total_bytes(self) -> int:
        """Bytes of the full replicated parameters."""
        return sum(p.nbytes for p in self.plans)

    @property
    def layer_bytes(self):
        """Full (gathered) bytes per layer, in streaming order."""
        return tuple(p.nbytes for p in self.plans)

    def name_of(self, g: int) -> str:
        return self.groups[g][0]


class Zero3Optimizer:
    """SGD(+momentum) with sharded parameters (ZeRO stage 3).

    There is no replicated parameter pytree: the training loop streams
    layers through the optimizer::

        opt.start_pass()                    # forward: prefetch ahead
        for g in range(opt.plan.n_layers):
            with opt.layer(g) as ws:        # fetch -> use -> release
                acts = forward_layer(ws, acts)
        opt.step(grads)                     # reduce-scatter + update

    - :meth:`start_pass` opens a forward (or ``reverse=True`` backward)
      pass: the prefetcher starts the first ``prefetch_depth`` gathers
      and keeps the window topped up as layers are fetched.
    - :meth:`fetch` returns layer g's full leaves (hits, misses and late
      waits counted); :meth:`release` frees them.
    - :meth:`step` reduce-scatters the gradients layer by layer (the
      backward's order), runs the stage-1/2 shard update and rebinds
      each layer's persistent allgather to the fresh shards (a request
      without the hook, on one rank or an empty state, is re-initialized
      instead).
    - :meth:`matmul` is the fused gather-and-use product.

    Numpy parameters run the same cycle over the host bucket cycle: the
    prefetch gathers at once, so every prefetched fetch is a hit.
    """

    def __init__(self, comm, params, lr: float = 1e-3,
                 momentum: float = 0.0,
                 deterministic: Optional[str] = None,
                 grad_average: bool = True,
                 error_feedback: Optional[str] = None,
                 prefetch_depth: int = 1) -> None:
        self._comm = comm
        self._lr = float(lr)
        self._mu = float(momentum)
        self._det = deterministic
        self._avg = bool(grad_average)
        self.plan = Zero3Plan(params, comm.size)
        # one residual carry per layer: stage 3 reduces a layer at a
        # time, and each layer's leaves pack their own ZeroPlan
        self._efs: Optional[List[_layout.ErrorFeedback]] = (
            [_layout.ErrorFeedback(error_feedback)
             for _ in range(self.plan.n_layers)]
            if error_feedback is not None else None)
        leaves = _layout.tree_leaves(params)
        self._dev = isinstance(leaves[0], torch.Tensor)
        # every rank holds the full initial params: each layer's shard is
        # a local slice, packed by the layer's plan
        self._pstates: List[_layout.ShardedState] = [
            _layout.ShardedState.from_full(
                comm, [leaves[i] for i in idxs], plan=lplan)
            for (_n, idxs), lplan in zip(self.plan.groups, self.plan.plans)]
        self._mstates: Optional[List[_layout.ShardedState]] = (
            [s.zeros_like() for s in self._pstates] if self._mu else None)
        # one persistent allgather per layer (tensors), rebound each step
        self._reqs = [comm.Allgather_multi_init(s)
                      for s in self._pstates] if self._dev else None
        self._prefetcher = LayerPrefetcher(self._start_gather,
                                           depth=prefetch_depth)
        self._gathered: Dict[int, list] = {}
        self._started: set = set()
        self._step_no = 0
        pvar.record_hwm("zero3_shard_bytes", self.shard_bytes)
        pvar.record_hwm("zero3_layer_bytes", max(self.plan.layer_bytes))
        pvar.record_hwm("zero3_resident_bytes", self.resident_bytes)

    # -- sizing -----------------------------------------------------------
    @property
    def shard_bytes(self) -> int:
        """Parameter bytes this rank holds permanently (the shards)."""
        return sum(s.shard_bytes for s in self._pstates)

    @property
    def replicated_bytes(self) -> int:
        """Bytes a replicated copy of the parameters needs."""
        return self.plan.total_bytes

    @property
    def resident_bytes(self) -> int:
        """Parameter bytes resident now: the shards plus every gathered
        layer (``zero3_resident_bytes`` is its high watermark)."""
        return self.shard_bytes + sum(
            self._pstates[g].total_bytes for g in self._gathered)

    # -- the prefetch / fetch / release stream ----------------------------
    def _start_gather(self, g: int) -> None:
        if g in self._started or g in self._gathered:
            return
        pvar.record("zero3_gathers")
        if not self._dev:
            # host path: nothing asynchronous to arm, so gather now and a
            # later fetch of a prefetched layer is a hit
            self._gathered[g] = _layout.tree_leaves(
                self._comm.Allgather_multi(self._pstates[g]))
            pvar.record_hwm("zero3_resident_bytes", self.resident_bytes)
            return
        self._reqs[g].start()
        self._started.add(g)
        rec = _trace.RECORDER
        if rec is not None:
            rec.instant("prefetch_start", "prefetch",
                        {"layer": self.plan.name_of(g), "pos": g})

    def start_pass(self, reverse: bool = False) -> None:
        """Open a pass: drop what a previous pass left and start the
        first ``prefetch_depth`` gathers of the (reversed: the
        backward's) streaming order."""
        self._drain()
        order = range(self.plan.n_layers)
        self._prefetcher.begin(reversed(order) if reverse else order)

    def fetch(self, g: int) -> list:
        """Layer g's full parameter leaves (the layer's flatten order). A
        prefetched gather is a hit (its wait, where it had not finished,
        counts in ``zero_prefetch_late_ns``); a layer the prefetcher
        never started is a miss, gathered on the spot."""
        global _PREFETCH_INFO

        if not 0 <= g < self.plan.n_layers:
            raise errors.MPIError(
                errors.ERR_COUNT,
                f"zero3 fetch: layer {g} out of range for a "
                f"{self.plan.n_layers}-layer plan")
        if g in self._gathered:
            if not self._dev:
                pvar.record("zero_prefetch_hits")
            self._prefetcher.advance(g)
            return self._gathered[g]
        if not self._dev:
            pvar.record("zero_prefetch_misses")
            self._gathered[g] = _layout.tree_leaves(
                self._comm.Allgather_multi(self._pstates[g]))
            pvar.record_hwm("zero3_resident_bytes", self.resident_bytes)
            self._prefetcher.advance(g)
            return self._gathered[g]
        if g in self._started:
            pvar.record("zero_prefetch_hits")
        else:
            pvar.record("zero_prefetch_misses")
            self._reqs[g].start()
            self._started.add(g)
        req = self._reqs[g]
        if not req.completed:
            # the prefetch lost the race to the consumer: a long stall
            # reads as a late prefetch of layer g, not as a hang
            t0 = _trace.now()
            with _prof.phase("prefetch"):
                req.wait()
            late = _trace.now() - t0
            pvar.record("zero_prefetch_late_ns", late)
            _PREFETCH_INFO = {"layer": self.plan.name_of(g), "pos": g,
                              "step": self._step_no, "late_ns": late}
            rec = _trace.RECORDER
            if rec is not None:
                rec.record("prefetch_wait", "prefetch", t0, _trace.now(),
                           {"layer": self.plan.name_of(g), "pos": g})
        else:
            req.wait()
        self._gathered[g] = _layout.tree_leaves(req.array)
        # the request's result would pin the gathered tensors past
        # release(): drop it, so this dict is their only owner
        req.discard()
        self._started.discard(g)
        pvar.record_hwm("zero3_resident_bytes", self.resident_bytes)
        self._prefetcher.advance(g)
        return self._gathered[g]

    def release(self, g: int) -> None:
        """Free layer g's gathered parameters (stage 3's residency
        lever); nothing if it is not gathered."""
        if self._gathered.pop(g, None) is not None:
            pvar.record("zero3_releases")

    @contextlib.contextmanager
    def layer(self, g: int):
        """``with opt.layer(g) as ws:``: fetch on entry, release on
        exit."""
        try:
            yield self.fetch(g)
        finally:
            self.release(g)

    def matmul(self, g: int, rhs):
        """Layer g's (single 2-D leaf) weight @ ``rhs``: through
        ``zero3_gather_matmul_dev`` (``zero3_fused_matmuls``) where a
        component provides it and the layout qualifies, else fetch + the
        local product (same result)."""
        fn = self._comm.coll.fns.get("zero3_gather_matmul_dev") \
            if self._dev else None
        if fn is not None:
            out = fn(self._comm, self._pstates[g], rhs)
            if out is not None:
                pvar.record("zero3_fused_matmuls")
                self._prefetcher.advance(g)
                return out
        ws = self.fetch(g)
        if len(ws) != 1:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"zero3 matmul: layer {g} has {len(ws)} leaves — the "
                "gather-and-matmul path consumes single-weight layers")
        return ws[0] @ rhs

    def _drain(self) -> None:
        """Quiesce the stream: wait out started gathers (their results
        dropped) and free everything gathered."""
        for g in list(self._started):
            self._reqs[g].wait()
            self._reqs[g].discard()
        self._started.clear()
        for g in list(self._gathered):
            self.release(g)
        self._prefetcher.reset()

    # -- one training step ------------------------------------------------
    def step(self, grads) -> None:
        """Per layer, in the backward's order: reduce-scatter the
        layer's gradients, run the stage-1/2 shard update (average ->
        momentum -> SGD, constants in the shard dtype) and rebind the
        layer's allgather to the fresh shards. No replicated parameters
        are built."""
        self._drain()
        gleaves = _layout.tree_leaves(grads)
        if len(gleaves) != self.plan.n_leaves:
            raise errors.MPIError(
                errors.ERR_COUNT,
                f"zero3 step: {len(gleaves)} gradient leaves for a "
                f"{self.plan.n_leaves}-leaf template")
        for g in reversed(range(self.plan.n_layers)):
            idxs = self.plan.groups[g][1]
            layer_grads = [gleaves[i] for i in idxs]
            if self._efs is not None:
                layer_grads = self._efs[g].apply(layer_grads,
                                                 self._comm.size)
            gs = self._comm.Reduce_scatter_multi(
                layer_grads, op_mod.SUM, deterministic=self._det)
            if self._avg:
                inv = 1.0 / self._comm.size
                gs = gs.map(lambda s: s * shard_const(inv, s))
            if self._mstates is not None:
                mom = self._mstates[g].map(
                    lambda v, sh: shard_const(self._mu, v) * v + sh, gs)
                self._mstates[g] = mom
                gs = mom
            new = self._pstates[g].map(
                lambda p, sh: p - shard_const(self._lr, p) * sh, gs)
            self._pstates[g] = new
            self._refresh_req(g, new)
        self._step_no += 1

    def _refresh_req(self, g: int, state) -> None:
        if self._reqs is None:
            return
        try:
            self._reqs[g].rebind(state)
        except errors.MPIError as e:
            if e.error_class != errors.ERR_NOT_SUPPORTED:
                raise
            # a request without the hook (one rank, an empty state) reads
            # its state at each start: re-init costs nothing there
            self._reqs[g].free()
            self._reqs[g] = self._comm.Allgather_multi_init(state)

    # -- whole-tree views (tests and export; not the hot path) ------------
    def gathered_params(self):
        """The full parameter pytree, gathered layer by layer (O(P):
        tests and export only)."""
        return self._gather_tree(self._pstates)

    def gathered_momentum(self):
        """The full momentum pytree (None without momentum)."""
        if self._mstates is None:
            return None
        return self._gather_tree(self._mstates)

    def _gather_tree(self, states):
        outs = [None] * self.plan.n_leaves
        for g, (_name, idxs) in enumerate(self.plan.groups):
            fulls = _layout.tree_leaves(self._comm.Allgather_multi(
                states[g]))
            for j, i in enumerate(idxs):
                outs[i] = fulls[j]
        return _layout.tree_unflatten(self.plan.treedef, outs)

    def free(self) -> None:
        """Free the per-layer requests and every gathered layer."""
        self._drain()
        if self._reqs is not None:
            for r in self._reqs:
                r.free()
            self._reqs = None
