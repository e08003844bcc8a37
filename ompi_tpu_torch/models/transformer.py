"""Decoder-only transformer trained over the device plane's axes, the port
of :mod:`ompi_tpu.models.transformer`.

Parallelism runs through the port's own device plane
(:mod:`ompi_tpu_torch.parallel`), each strategy optional:

- **dp**: batch sharded; gradients all-reduced over the axis.
- **tp**: Megatron column / row parallel pairs: wq / wk / wv / w1 shard
  the output features, wo / w2 the input features, with
  ``region_enter`` (identity forward, Allreduce backward) before the
  column-parallel products and ``region_exit`` (Allreduce forward) after
  the row-parallel ones.
- **sp**: sequence sharded; attention is ring attention
  (:mod:`ompi_tpu_torch.ops.ring_attention`, ``permute_dev`` hops) or
  Ulysses (:mod:`ompi_tpu_torch.ops.ulysses`, two Alltoalls).
- **ep**: MoE layers dispatch tokens over Alltoall
  (:mod:`ompi_tpu_torch.ops.moe`).

The reference runs the step inside ``shard_map``; here every rank runs it
on its local shards (:func:`ompi_tpu_torch.compat.model_params_from_reference`
or :func:`init_params_device` with ``specs`` make them), axis names
resolve against the active mesh (``with mesh:``), and ``lax.axis_index``
is a Python int. ``jax.value_and_grad`` becomes ``torch.autograd.grad``
over the local leaves; every rank builds the same graph, so the
collectives of the backward pair up as the forward's do.

Where the port differs (ROADMAP queue 3): the weight-tied head upcasts
its operands to float32 (products exact, float32 sums) where the
reference asks the MXU for float32 accumulation of bfloat16 operands;
the gold logit is gathered at ``labels.clamp(min=0)`` under the mask
(``torch.gather`` refuses the -1 that ``jnp.take_along_axis`` wraps).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ompi_tpu_torch.ops import attention as att
from ompi_tpu_torch.ops import moe as moe_mod
from ompi_tpu_torch.ops.ring_attention import ring_attention
from ompi_tpu_torch.parallel import collectives as C
from ompi_tpu_torch.parallel.mesh import P


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_seq: int = 1024
    moe_every: int = 0       # every k-th layer is MoE (0 = dense only)
    n_experts: int = 8
    capacity_factor: float = 1.25
    #: activation dtype
    dtype: Any = torch.bfloat16
    #: parameter storage dtype (the SGD update keeps it)
    param_dtype: Any = torch.float32
    #: the context-parallel schedule under sp: "ring" or "ulysses"
    sp_schedule: str = "ring"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class Axes:
    """Mesh axis names per strategy; None disables the strategy."""
    dp: Optional[str] = None
    tp: Optional[str] = None
    sp: Optional[str] = None
    ep: Optional[str] = None
    pp: Optional[str] = None  # pipeline stages (models/pipeline.py)

    def batch_axes(self):
        """Axes over which the tokens are sharded (dp, sp and ep); grads
        of params replicated over them are summed over them. tp is the
        region_enter / region_exit boundary's, never the grad sync's."""
        return tuple(a for a in (self.dp, self.sp, self.ep) if a)


def _is_moe(cfg: Config, layer: int) -> bool:
    return cfg.moe_every > 0 and (layer + 1) % cfg.moe_every == 0


def _leaf_draws(cfg: Config):
    """``(path, shape, scale)`` of every drawn leaf in the reference's
    draw order (the LayerNorm leaves are constants, not drawn)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    s_emb = 1.0 / math.sqrt(d)
    yield ("embed",), (v, d), s_emb
    yield ("pos",), (cfg.max_seq, d), 0.02
    for i in range(cfg.n_layers):
        layer = ("layers", i)
        yield layer + ("wq",), (d, d), s_emb
        yield layer + ("wk",), (d, d), s_emb
        yield layer + ("wv",), (d, d), s_emb
        yield layer + ("wo",), (d, d), s_emb / math.sqrt(2 * cfg.n_layers)
        if _is_moe(cfg, i):
            e = cfg.n_experts
            yield layer + ("wg",), (d, e), s_emb
            yield layer + ("w1",), (e, d, f), s_emb
            yield layer + ("w2",), (e, f, d), 1.0 / math.sqrt(f)
        else:
            yield layer + ("w1",), (d, f), s_emb
            yield layer + ("w2",), (f, d), 1.0 / math.sqrt(f)


def _skeleton(cfg: Config, ln):
    """The parameter tree with ``ln(path)`` at each LayerNorm leaf and
    the layers' drawn leaves still missing."""
    return {"embed": None, "pos": None,
            "ln_f": {"g": ln(("ln_f", "g")), "b": ln(("ln_f", "b"))},
            "layers": [{"ln1": {"g": ln(("layers", i, "ln1", "g")),
                                "b": ln(("layers", i, "ln1", "b"))},
                        "ln2": {"g": ln(("layers", i, "ln2", "g")),
                                "b": ln(("layers", i, "ln2", "b"))}}
                       for i in range(cfg.n_layers)]}


def _put(tree, path, value) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def init_params(rng: np.random.Generator, cfg: Config) -> Dict:
    """Full (unsharded) parameters on the host, drawn from ``rng`` call
    for call as the reference's ``init_params`` draws them (float64
    normals times the scale, cast to ``param_dtype``): CPU tensors."""
    def ln(path):
        fill = torch.ones if path[-1] == "g" else torch.zeros
        return fill(cfg.d_model, dtype=cfg.param_dtype)

    params = _skeleton(cfg, ln)
    for path, shape, scale in _leaf_draws(cfg):
        a = rng.standard_normal(shape) * scale
        _put(params, path, torch.from_numpy(a).to(cfg.param_dtype))
    return params


def init_params_device(cfg: Config, seed: int, device, ax=None, mesh=None,
                       stacked: bool = False) -> Dict:
    """Parameters drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed``: the reference's shapes, scales and leaf order, float32
    normals cast to ``param_dtype``. With ``ax`` and ``mesh``, each full
    leaf is drawn and only this rank's shard of it kept (by
    :func:`param_specs`), so every rank of a job, and a one-rank run, hold
    slices of the same model; ``stacked`` gives the pipeline's layout
    (``pipeline.stack_layers``: the layers stacked on a leading dim, this
    pp stage keeping its n_layers / pp of them)."""
    from ompi_tpu_torch.parallel.device_comm import local_block

    g = torch.Generator(device=device).manual_seed(seed)
    specs = param_specs(cfg, ax) if ax is not None else None
    mine = range(cfg.n_layers)
    if stacked:
        per = cfg.n_layers // mesh.axis_size(ax.pp)
        stage = mesh.axis_index(ax.pp)
        mine = range(stage * per, (stage + 1) * per)

    def keep(path, t):
        if path[0] == "layers" and path[1] not in mine:
            return None
        if specs is None:
            return t
        spec = specs
        for key in path:
            spec = spec[key]
        return local_block(mesh, t, spec)

    def ln(path):
        fill = torch.ones if path[-1] == "g" else torch.zeros
        return keep(path, fill(cfg.d_model, dtype=cfg.param_dtype,
                               device=device))

    params = _skeleton(cfg, ln)
    for path, shape, scale in _leaf_draws(cfg):
        t = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        _put(params, path, keep(path, (t * scale).to(cfg.param_dtype)))
    if stacked:
        layers = [params["layers"][i] for i in mine]
        params["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers)
    return params


def param_specs(cfg: Config, ax: Axes):
    """The partition spec tree matching init_params' structure: tp
    shards wq / wk / wv on their output dim, wo on its input dim, dense
    w1 / w2 likewise; ep shards the MoE experts on dim 0. Everything
    else is replicated."""
    rep = P()
    specs: Dict = {"embed": rep, "pos": rep, "ln_f": {"g": rep, "b": rep},
                   "layers": []}
    for i in range(cfg.n_layers):
        ls = {"ln1": {"g": rep, "b": rep}, "ln2": {"g": rep, "b": rep},
              "wq": P(None, ax.tp), "wk": P(None, ax.tp),
              "wv": P(None, ax.tp), "wo": P(ax.tp, None)}
        if _is_moe(cfg, i):
            ls["wg"] = rep
            ls["w1"] = P(ax.ep, None, ax.tp)
            ls["w2"] = P(ax.ep, ax.tp, None)
        else:
            ls["w1"] = P(None, ax.tp)
            ls["w2"] = P(ax.tp, None)
        specs["layers"].append(ls)
    return specs


def grad_extra_axes(cfg: Config, ax: Axes):
    """Extra grad-sum axes per param ("" = none), same structure as
    init_params. The MoE router wg is replicated but lives inside the tp
    region (its cotangent arrives partial through the tp-sharded expert
    outputs), so it also sums over tp."""
    none = ""
    extra: Dict = {"embed": none, "pos": none,
                   "ln_f": {"g": none, "b": none}, "layers": []}
    for i in range(cfg.n_layers):
        le = {"ln1": {"g": none, "b": none}, "ln2": {"g": none, "b": none},
              "wq": none, "wk": none, "wv": none, "wo": none,
              "w1": none, "w2": none}
        if _is_moe(cfg, i):
            le["wg"] = ax.tp or none
        extra["layers"].append(le)
    return extra


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` in jax's order (dicts, by sorted
    key, and lists are nodes; the other trees follow its structure, jax's
    ``flatten_up_to``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g + b


def _head(h, embed, dt):
    """The weight-tied head: ``einsum("btd,vd->btv")`` of the operands
    in ``dt``, upcast to float32 (exact products, float32 sums)."""
    return torch.einsum("btd,vd->btv", h.to(dt).float(),
                        embed.to(dt).float())


def _embed(params, tokens, cfg: Config, t_off: int):
    dt = cfg.dtype
    t = tokens.shape[1]
    h = params["embed"].to(dt)[tokens]
    return h + params["pos"][t_off:t_off + t].to(dt)[None]


def layer_forward(lp, h, cfg: Config, ax: Axes, is_moe: bool):
    """One transformer block on local shards: pre-LN attention (tp's
    Megatron f / g pair, sp's ring attention or Ulysses) then the FFN or
    MoE. Shared by :func:`forward_local` and the pipeline's stages."""
    dt = cfg.dtype
    b, t = h.shape[0], h.shape[1]
    x = _ln(h.float(), lp["ln1"]["g"], lp["ln1"]["b"]).to(dt)
    if ax.tp:
        x = C.region_enter(x, ax.tp)
    q = x @ lp["wq"].to(dt)   # [B, T, Hl * Dh] (tp-sharded columns)
    k = x @ lp["wk"].to(dt)
    v = x @ lp["wv"].to(dt)
    hl = q.shape[-1] // cfg.head_dim  # local heads under tp
    q = q.reshape(b, t, hl, cfg.head_dim)
    k = k.reshape(b, t, hl, cfg.head_dim)
    v = v.reshape(b, t, hl, cfg.head_dim)
    if ax.sp:
        if cfg.sp_schedule == "ulysses":
            from ompi_tpu_torch.ops.ulysses import ulysses_attention

            o = ulysses_attention(q, k, v, ax.sp, causal=True)
        elif cfg.sp_schedule == "ring":
            o = ring_attention(q, k, v, ax.sp, causal=True)
        else:
            raise ValueError(
                f"sp_schedule={cfg.sp_schedule!r}: expected 'ring' "
                "or 'ulysses'")
    else:
        o = att.mha(q, k, v, causal=True)
    o = o.reshape(b, t, hl * cfg.head_dim)
    o = o @ lp["wo"].to(dt)   # row parallel: partial sums
    if ax.tp:
        o = C.region_exit(o, ax.tp)
    h = h + o

    x = _ln(h.float(), lp["ln2"]["g"], lp["ln2"]["b"]).to(dt)
    if ax.tp:
        x = C.region_enter(x, ax.tp)
    if is_moe:
        flat = x.reshape(b * t, cfg.d_model)
        if ax.ep:
            y = moe_mod.moe_ffn(flat, lp["wg"].to(dt), lp["w1"].to(dt),
                                lp["w2"].to(dt), ax.ep,
                                capacity_factor=cfg.capacity_factor)
        else:
            y = _moe_dense(flat, lp, cfg)
        if ax.tp:
            y = C.region_exit(y, ax.tp)
        y = y.reshape(b, t, cfg.d_model)
    else:
        u = torch.relu(x @ lp["w1"].to(dt))
        y = u @ lp["w2"].to(dt)
        if ax.tp:
            y = C.region_exit(y, ax.tp)
    return h + y


def forward_local(params, tokens, cfg: Config, ax: Axes):
    """Forward pass on local shards (with the mesh active when any axis
    is set). tokens: [B_local, T_local] integers -> logits [B_local,
    T_local, vocab] float32."""
    t_off = C.axis_index(ax.sp) * tokens.shape[1] if ax.sp else 0
    h = _embed(params, tokens, cfg, t_off)
    for i, lp in enumerate(params["layers"]):
        h = layer_forward(lp, h, cfg, ax, _is_moe(cfg, i))
    h = _ln(h.float(), params["ln_f"]["g"], params["ln_f"]["b"])
    return _head(h, params["embed"], cfg.dtype)


def _moe_dense(flat, lp, cfg: Config):
    """Single-device MoE (no ep axis): dense einsums over all experts,
    float32 (jnp's promotion of the float32 dispatch)."""
    cap = max(int(cfg.capacity_factor * flat.shape[0] / cfg.n_experts), 1)
    route = moe_mod.top1_routing(flat @ lp["wg"].to(flat.dtype), cap)
    slots = torch.einsum("tec,td->ecd", route.dispatch, flat.float())
    hidden = torch.relu(torch.einsum("ecd,edf->ecf", slots,
                                     lp["w1"].float()))
    out = torch.einsum("ecf,efd->ecd", hidden, lp["w2"].float())
    return torch.einsum("tec,ecd->td", route.combine, out).to(flat.dtype)


def nll_sum(logits, labels, weight=None):
    """Summed next-token cross entropy over the labels >= 0 (times
    ``weight``) and their count, both float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    idx = labels.clamp(min=0).long()[..., None]
    gold = torch.gather(logits, -1, idx)[..., 0]
    mask = (labels >= 0).float()
    if weight is not None:
        mask = mask * weight
    return ((logz - gold) * mask).sum(), mask.sum()


def loss_local(params, tokens, labels, cfg: Config, ax: Axes):
    """Summed next-token CE over local tokens and the local count (the
    caller normalises after the cross-shard sum)."""
    return nll_sum(forward_local(params, tokens, cfg, ax), labels)


def _sharded_axes(spec) -> set:
    out = set()
    for entry in (tuple(spec) if spec is not None else ()):
        if isinstance(entry, tuple):
            out.update(entry)
        elif entry is not None:
            out.add(entry)
    return out


def grad_sync(grads, specs, ax: Axes, extra=None):
    """Cross-rank gradient reduction, one Allreduce per param: each grad
    sums over the batch axes (dp / sp / ep) the param is not sharded on,
    plus its ``extra`` axis (see :func:`grad_extra_axes`)."""
    batch = ax.batch_axes()
    if extra is None:
        extra = tree_map(lambda _: "", grads)

    def reduce_one(g, spec, ex):
        sharded = _sharded_axes(spec)
        axes = tuple(a for a in batch if a not in sharded)
        if ex:
            axes = axes + (ex,)
        return C.allreduce(g, axes) if axes else g

    with torch.no_grad():
        return tree_map(reduce_one, grads, specs, extra)


#: elements of a leaf the SGD update computes at a time (its float32
#: temporaries stay at 64 MiB)
_SGD_CHUNK = 1 << 24


def sgd_update(params, grads, scale):
    """The SGD step shared by the flat and pipeline train steps: updates
    each param in place, keeping its storage dtype, and returns the tree.
    ``scale`` is a float32 0-d tensor, so jnp computes ``p - scale * g``
    in float32 for a bfloat16 ``p`` and rounds once to bfloat16; the port
    upcasts to do the same (torch would keep a 0-d float32 times a
    bfloat16 tensor in bfloat16), a chunk at a time."""
    def one(p, g):
        pf, gf = p.view(-1), g.to(p.dtype).reshape(-1)
        for i in range(0, pf.numel(), _SGD_CHUNK):
            sl = slice(i, i + _SGD_CHUNK)
            pf[sl] = pf[sl].float() - scale * gf[sl].float()
        return p

    with torch.no_grad():
        return tree_map(one, params, grads)


def value_and_grads(loss_fn, params):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ``loss_fn(params)``
    returns ``(nll, aux)``; the grads come back in the params' tree."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = tree_leaves(leaves)
    nll, aux = loss_fn(leaves)
    gs = torch.autograd.grad(nll, flat)
    it = iter(gs)
    return (nll.detach(), aux), tree_map(lambda _: next(it), leaves)


def _psum_pair(nll, cnt, axes):
    """nll and cnt summed over ``axes`` in one Allreduce."""
    if not axes:
        return nll, cnt
    with torch.no_grad():
        both = C.allreduce(torch.stack([nll, cnt.detach()]), axes)
    return both[0], both[1]


def make_grad_fn(cfg: Config, ax: Axes, specs):
    """(params, tokens, labels) -> (loss, cnt, grads): the train step's
    loss over every shard, the global count of labelled tokens, and the
    synced grads (what :func:`make_train_step` applies)."""
    extra = grad_extra_axes(cfg, ax)

    def fn(params, tokens, labels):
        (nll, cnt), grads = value_and_grads(
            lambda p: loss_local(p, tokens, labels, cfg, ax), params)
        nll, cnt = _psum_pair(nll, cnt, ax.batch_axes())
        return nll / cnt, cnt, grad_sync(grads, specs, ax, extra)

    return fn


def sgd_scale(lr: float, cnt):
    """``lr / cnt`` as jnp computes it: a float32 division."""
    return torch.tensor(lr, dtype=torch.float32, device=cnt.device) / cnt


def make_train_step(cfg: Config, ax: Axes, specs, lr: float = 1e-2):
    """(params, tokens, labels) -> (params, loss) on this rank's shards
    (with the mesh active when any axis is set); the params are updated
    in place."""
    grad_fn = make_grad_fn(cfg, ax, specs)

    def step(params, tokens, labels):
        loss, cnt, grads = grad_fn(params, tokens, labels)
        return sgd_update(params, grads, sgd_scale(lr, cnt)), loss

    return step
