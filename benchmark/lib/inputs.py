"""The inputs of a run, made on the device from ``--seed``.

The driver hands these to the program and the reference makes them
again: the same seed gives the same tensors, bit for bit, on either
side. Each tensor is one ``torch.randn`` call over the whole flat
concatenation of a configuration's leaves (the leaves are views of it),
made in float32 and then cast to the run's dtype, so a run in a lower
precision sees the same values rounded.
"""

from __future__ import annotations

import torch

#: scale of the initial parameters (GPT-2's initializer range) and of the
#: gradients a rank hands to each step
PARAM_SCALE = 0.02
GRAD_SCALE = 0.01
_MIX = 1_000_003
_MOD = 1 << 63


def generator(device, seed: int, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, key...); any whole
    seed, negative or past 64 bits, maps into torch's seed range."""
    s = int(seed) % _MOD
    for k in key:
        s = (s * _MIX + int(k)) % _MOD
    return torch.Generator(device=device).manual_seed(s)


def params_flat(count: int, device, seed: int) -> torch.Tensor:
    """The initial parameters, float32."""
    g = generator(device, seed, 0)
    return torch.randn(count, generator=g, device=device).mul_(PARAM_SCALE)


def grads_flat(count: int, device, seed: int, rank: int,
               gset: int) -> torch.Tensor:
    """Rank ``rank``'s gradients of set ``gset``, float32."""
    g = generator(device, seed, 1, rank, gset)
    return torch.randn(count, generator=g, device=device).mul_(GRAD_SCALE)


def sample_index(offsets, device, seed: int, count: int) -> torch.Tensor:
    """Sorted distinct flat indices drawn from the seed: ``count``
    uniform draws, and the first and last element of every leaf, so no
    leaf goes unsampled."""
    total = int(offsets[-1])
    g = generator(device, seed, 2)
    draw = torch.randint(0, total, (min(count, total),), generator=g,
                         device=device)
    ends = torch.tensor([o for o in offsets[:-1]]
                        + [o - 1 for o in offsets[1:]], device=device)
    return torch.unique(torch.cat([draw, ends]))
