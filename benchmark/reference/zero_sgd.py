"""The plain reference of a data-parallel SGD step with momentum, the
step that ZeRO shards (Rajbhandari et al., SC'20) and that every
configuration of ``benchmark/configs`` with ``"reference": "zero_sgd"``
runs.

n ranks each hold gradients g_r of the same parameters. One step is::

    G  = (g_0 + ... + g_{n-1}) / n     the mean over ranks
    v' = mu * v + G                    momentum (v = 0 before step 1)
    p' = p - lr * v'

Here the sum is taken in float64 and rounded once to float32, then every
other operation rounds once in float32, in the order written (no fused
multiply-add). Sharding changes where each element is computed, not
what it is; a program that sums in another order differs from this by a
few roundings of the sum. The inputs are made again from the seed by
:mod:`benchmark.lib.inputs`; nothing of the program is read but the
outputs this module judges.

What is compared (:func:`norm_gap`, :func:`sample_error`):

- the first gradient as the optimizer got it, read from its momentum
  after step 1, and the parameters' change after step 3: per leaf, the
  gap between the program's norm and this reference's, over the larger
  of the reference's norm of that leaf and of the median leaf; the
  worst leaf counts;
- the parameters and the momentum after the last step of the window, at
  elements drawn from the seed: the largest error over the root mean
  square of the reference's change there;
- under a bitwise reproducible reduction (``deterministic='linear'``),
  the same elements bit for bit (:func:`bit_mismatch`) against
  :func:`rank_order_means`: the sum folded in rank order, each add
  rounded in float32, as the guarantee fixes it.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from benchmark.lib import inputs


def mean_grads(count: int, n: int, device, seed: int,
               sets: int) -> List[torch.Tensor]:
    """G_s for s < sets: every rank's gradients of set s made again,
    summed in float64 and rounded once to float32."""
    out = []
    for s in range(sets):
        acc = torch.zeros(count, dtype=torch.float64, device=device)
        for r in range(n):
            g = inputs.grads_flat(count, device, seed, r, s)
            acc.add_(g)
            del g
        acc.div_(n)
        out.append(acc.to(torch.float32))
        del acc
    return out


def rank_order_means(count: int, n: int, device, seed: int, sets: int,
                     idx: torch.Tensor) -> List[torch.Tensor]:
    """G_s for s < sets at the elements ``idx``, as a rank-order fold
    rounds it: acc = g_0, then acc = acc + g_r for r = 1 .. n-1, each add
    rounded in float32, then acc * (1/n rounded to float32)."""
    inv = torch.tensor(1.0 / n, dtype=torch.float32)
    out = []
    for s in range(sets):
        acc = inputs.grads_flat(count, device, seed, 0, s)[idx]
        for r in range(1, n):
            acc = torch.add(acc, inputs.grads_flat(count, device, seed, r,
                                                   s)[idx])
        out.append(torch.mul(acc, inv.to(device)))
    return out


def bit_mismatch(prog: torch.Tensor, ref: torch.Tensor) -> int:
    """Elements whose float32 bits differ (a NaN or a signed zero
    counts as its bits)."""
    a = prog.to(torch.float32).contiguous().view(torch.int32)
    b = ref.to(torch.float32).contiguous().view(torch.int32)
    return int((a != b).sum())


def _consts(lr: float, mu: float, like: torch.Tensor):
    return (torch.tensor(lr, dtype=like.dtype, device=like.device),
            torch.tensor(mu, dtype=like.dtype, device=like.device))


def step_(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor, lr_t,
          mu_t) -> None:
    """One step in place, one rounding per operation."""
    v.mul_(mu_t).add_(g)
    p.sub_(torch.mul(v, lr_t))


def leaf_sumsq(flat: torch.Tensor, offsets: Sequence[int]) -> List[float]:
    """Per leaf, the sum of squares in float64."""
    return [float(flat[a:b].double().square().sum())
            for a, b in zip(offsets[:-1], offsets[1:])]


def first_steps(p0: torch.Tensor, grads: Sequence[torch.Tensor],
                offsets: Sequence[int], lr: float, mu: float):
    """The first three steps over the whole flat parameters: per leaf the
    sum of squares of the momentum after step 1 (the first mean
    gradient) and of p_3 - p_0."""
    p, v = p0.clone(), torch.zeros_like(p0)
    lr_t, mu_t = _consts(lr, mu, p)
    v1 = None
    for s in range(3):
        step_(p, v, grads[s % len(grads)], lr_t, mu_t)
        if s == 0:
            v1 = leaf_sumsq(v, offsets)
    p.sub_(p0)
    return v1, leaf_sumsq(p, offsets)


def sampled(p0_s: torch.Tensor, grads_s: Sequence[torch.Tensor],
            steps: int, lr: float, mu: float):
    """Parameters and momentum after ``steps`` steps at the sampled
    elements (elements never mix, so a sample follows its own path);
    step t takes gradient set t mod len(grads_s)."""
    p, v = p0_s.clone(), torch.zeros_like(p0_s)
    lr_t, mu_t = _consts(lr, mu, p)
    for t in range(steps):
        step_(p, v, grads_s[t % len(grads_s)], lr_t, mu_t)
    return p, v


def norm_gap(prog_sumsq: Sequence[float], ref_sumsq: Sequence[float]
             ) -> float:
    """Worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf."""
    ref = [math.sqrt(max(x, 0.0)) for x in ref_sumsq]
    prog = [math.sqrt(max(x, 0.0)) for x in prog_sumsq]
    med = sorted(ref)[len(ref) // 2]
    return max(abs(a - b) / max(b, med) for a, b in zip(prog, ref))


def sample_error(prog: torch.Tensor, ref: torch.Tensor,
                 base: torch.Tensor) -> float:
    """Largest |prog - ref| over the root mean square of ref - base."""
    d = (prog.double() - ref.double()).abs().max()
    scale = (ref.double() - base.double()).square().mean().sqrt()
    return float(d / scale)
