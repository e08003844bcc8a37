"""Pipeline parallelism — a microbatched stage pipeline over ``permute_dev``,
the port of :mod:`ompi_tpu.models.pipeline`.

Layers are stacked on a leading dim sharded over the ``pp`` mesh axis
(each stage holds n_layers / pp of them); activations hand off stage to
stage with :func:`ompi_tpu_torch.parallel.collectives.ppermute` (one
``permute_dev`` exchange, K2 landing); the schedule is GPipe's fill /
drain over n_micro + pp - 1 ticks, each ending in one hand-off. Each
stage's layers run under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the scan body): backward recomputes a layer's
activations, collectives included.

Every stage computes every tick and the stage's choices are
``torch.where`` selections, as in the reference: both operands stay in
the autograd graph on every rank, so every rank runs the same backward
graph and makes the same collective calls in the same order (a rank that
skipped a tick would leave its partners waiting in an exchange). The
cost is the reference's: pp - 1 idle ticks of compute per stage.

Constraints: homogeneous layers (all dense or all MoE, so they stack),
n_layers % pp == 0, the local batch divisible by n_micro.

The host-plane face of the same idea is at the bottom:
:func:`stage_handoff_send` / :func:`stage_handoff_recv` wrap the
partitioned plane's ``Psend_init`` / ``Precv_init`` with one partition
per microbatch, for pipelines whose stages run as separate MPI ranks.
They take host numpy buffers, as ``part/host.py`` does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel import collectives as C
from ompi_tpu_torch.parallel.mesh import P


def stack_layers(params: Dict) -> Dict:
    """The layers list -> one stacked tree with a leading layer dim
    (numpy arrays or tensors, as given)."""
    layers = params["layers"]

    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack(xs)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = tfm.tree_map(stack, *layers)
    return out


def stacked_param_specs(cfg: tfm.Config, ax: tfm.Axes):
    """param_specs with the layer dim of every stacked layer param
    sharded over pp."""
    base = tfm.param_specs(cfg, ax)
    out = {k: v for k, v in base.items() if k != "layers"}
    out["layers"] = tfm.tree_map(lambda spec: P(ax.pp, *spec),
                                 base["layers"][0])
    return out


def _stage_apply(stage_layers, h, cfg, ax, is_moe):
    """Run this stage's local layers in order, each under a checkpoint
    (backward recomputes its activations)."""
    n_local = tfm.tree_leaves(stage_layers)[0].shape[0]
    for j in range(n_local):
        lp = tfm.tree_map(lambda x: x[j], stage_layers)
        h = checkpoint(tfm.layer_forward, lp, h, cfg, ax, is_moe,
                       use_reentrant=False)
    return h


def pipeline_forward(params, tokens, cfg: tfm.Config, ax: tfm.Axes,
                     n_micro: int):
    """Microbatched pipelined forward on local shards (with the mesh
    active). tokens: [B_local, T_local] -> float32 logits [B_local,
    T_local, vocab], valid on the last stage (the others' are the head
    of zeros: mask them downstream)."""
    if not ax.pp:
        raise ValueError("pipeline_forward requires a pp axis")
    pp = C.axis_size(ax.pp)
    stage = C.axis_index(ax.pp)
    b, t = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro}")
    mb = b // n_micro
    is_moe = cfg.moe_every == 1  # homogeneous: checked by the step

    # the embedding on every stage (params replicated over pp); only
    # stage 0's is consumed
    t_off = C.axis_index(ax.sp) * t if ax.sp else 0
    h = tfm._embed(params, tokens, cfg, t_off)
    micro = h.reshape(n_micro, mb, t, cfg.d_model)
    dev = h.device
    first = torch.tensor(stage == 0, device=dev)
    fwd = [(i, (i + 1) % pp) for i in range(pp)]  # stage i -> i + 1

    state = torch.zeros((mb, t, cfg.d_model), dtype=cfg.dtype, device=dev)
    out = [torch.zeros_like(state) for _ in range(n_micro)]
    for i in range(n_micro + pp - 1):
        # stage 0 injects microbatch i (draining ticks feed the last one
        # again, which nothing consumes); the others take the hand-off
        x = torch.where(first, micro[min(i, n_micro - 1)], state)
        y = _stage_apply(params["layers"], x, cfg, ax, is_moe)
        # the last stage banks finished microbatch i - (pp - 1)
        done = min(max(i - (pp - 1), 0), n_micro - 1)
        bank = torch.tensor(stage == pp - 1 and i >= pp - 1, device=dev)
        out[done] = torch.where(bank, y, out[done])
        state = C.ppermute(y, ax.pp, perm=fwd)
    hfin = torch.cat(out).reshape(b, t, cfg.d_model)
    hfin = tfm._ln(hfin.float(), params["ln_f"]["g"], params["ln_f"]["b"])
    return tfm._head(hfin, params["embed"], cfg.dtype)


def _pp_extra(cfg: tfm.Config, ax: tfm.Axes):
    """grad_extra_axes for stacked layers (homogeneous layers: the first
    layer's tree stands for the stack), so wg keeps its tp sum."""
    base = tfm.grad_extra_axes(cfg, ax)
    extra = {k: v for k, v in base.items() if k != "layers"}
    extra["layers"] = base["layers"][0]
    return extra


def make_pp_grad_fn(cfg: tfm.Config, ax: tfm.Axes, specs, n_micro: int):
    """(stacked_params, tokens, labels) -> (loss, cnt, grads) with the
    pp axis: the loss terms come from the last stage and sum over pp;
    the replicated params' grads (embed, pos, ln_f: stage 0's embedding,
    the last stage's head) sum over pp too."""
    if cfg.moe_every not in (0, 1):
        raise ValueError(
            "pipeline stages must be homogeneous: moe_every must be 0 "
            "(all dense) or 1 (all MoE) so layers stack")
    if ax.pp is None:
        raise ValueError("make_pp_train_step requires ax.pp")
    extra = _pp_extra(cfg, ax)

    def fn(params, tokens, labels):
        pp = C.axis_size(ax.pp)
        last = float(C.axis_index(ax.pp) == pp - 1)

        def loss_fn(p):
            logits = pipeline_forward(p, tokens, cfg, ax, n_micro)
            return tfm.nll_sum(logits, labels, last)

        (nll, cnt), grads = tfm.value_and_grads(loss_fn, params)
        axes = tuple(a for a in (ax.dp, ax.sp, ax.ep, ax.pp) if a)
        nll, cnt = tfm._psum_pair(nll, cnt, axes)
        grads = tfm.grad_sync(grads, specs, ax, extra)

        def pp_sync(g, spec):
            if ax.pp in tfm._sharded_axes(spec):
                return g
            with torch.no_grad():
                return C.allreduce(g, ax.pp)

        return nll / cnt, cnt, tfm.tree_map(pp_sync, grads, specs)

    return fn


def make_pp_train_step(cfg: tfm.Config, ax: tfm.Axes, specs,
                       n_micro: int, lr: float = 1e-2):
    """(stacked_params, tokens, labels) -> (params, loss) on this rank's
    shards, with the pp axis on the active mesh; the params are updated
    in place."""
    grad_fn = make_pp_grad_fn(cfg, ax, specs, n_micro)

    def step(params, tokens, labels):
        loss, cnt, grads = grad_fn(params, tokens, labels)
        return tfm.sgd_update(params, grads, tfm.sgd_scale(lr, cnt)), loss

    return step


# ---------------------------------------------------------------------------
# host-plane stage handoff via partitioned point-to-point (part/)


def stage_handoff_send(comm, acts, n_micro: int, dest: int, tag: int = 11):
    """Partitioned send of a stacked microbatch activation buffer
    [n_micro, ...] (host numpy) to the next stage, one partition per
    microbatch. Returns the started request: ``req.Pready(i)`` as each
    microbatch's stage compute completes, ``req.wait()`` at the end of
    the tick; re-``start()`` it next tick (persistent, same pairing)."""
    acts = np.ascontiguousarray(acts)
    if acts.shape[0] != n_micro:
        raise ValueError(
            f"stage_handoff_send: leading dim {acts.shape[0]} must "
            f"be n_micro={n_micro} (one partition per microbatch)")
    req = comm.Psend_init(acts, n_micro, dest, tag)
    req.start()
    return req


def stage_handoff_recv(comm, buf, n_micro: int, source: int, tag: int = 11):
    """Receiving side of :func:`stage_handoff_send`: posts every
    microbatch partition's receive into ``buf`` ([n_micro, ...],
    C-contiguous numpy: partitions alias it) and returns the started
    request; poll ``req.Parrived(i)`` to start on microbatch i early."""
    if buf.shape[0] != n_micro:
        raise ValueError(
            f"stage_handoff_recv: leading dim {buf.shape[0]} must "
            f"be n_micro={n_micro} (one partition per microbatch)")
    req = comm.Precv_init(buf, n_micro, source, tag)
    req.start()
    return req
