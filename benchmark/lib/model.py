"""The parameter leaves of a configuration, by architecture.

A configuration file names its ``architecture``; :func:`leaves` gives
its leaves as ``(dotted name, shape)`` in the order a pytree of dicts
and lists flattens: dict keys sorted, lists in order (jax's order, which
the port's ``zero/layout`` keeps). Nested trees are rebuilt from the
dotted names by :func:`tree`, and read back by :func:`by_name`.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple


def gpt2(cfg: dict) -> dict:
    """GPT-2's parameters (Radford et al. 2019, the Hugging Face
    ``GPT2Model`` naming): token and position embeddings, ``n_layer``
    blocks of two layer norms, the attention's fused QKV and output
    projections and the MLP's up and down projections (width
    ``4 * n_embd`` where ``n_inner`` is null), and the final layer norm.
    Conv1D weights are (in, out)."""
    e = int(cfg["n_embd"])
    inner = int(cfg.get("n_inner") or 4 * e)

    def ln():
        return {"g": (e,), "b": (e,)}

    def lin(i, o):
        return {"w": (i, o), "b": (o,)}

    return {"wte": (int(cfg["vocab_size"]), e),
            "wpe": (int(cfg["n_positions"]), e),
            "h": [{"ln_1": ln(),
                   "attn": {"c_attn": lin(e, 3 * e), "c_proj": lin(e, e)},
                   "ln_2": ln(),
                   "mlp": {"c_fc": lin(e, inner), "c_proj": lin(inner, e)}}
                  for _ in range(int(cfg["n_layer"]))],
            "ln_f": ln()}


ARCHITECTURES = {"gpt2": gpt2}


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every leaf, in flatten order."""
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}" if path else k)
        elif isinstance(t, list):
            for i, c in enumerate(t):
                walk(c, f"{path}[{i}]")
        else:
            out.append((path, tuple(int(s) for s in t)))

    walk(ARCHITECTURES[cfg["architecture"]](cfg), "")
    return out


def numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def offsets(spec) -> List[int]:
    """Start of each leaf in the flat concatenation, and the total."""
    out, off = [], 0
    for _, shape in spec:
        out.append(off)
        off += numel(shape)
    return out + [off]


_PART = re.compile(r"([A-Za-z_0-9]+)|\[(\d+)\]")


def _path(name: str):
    return [(m.group(1), None) if m.group(1) is not None
            else (None, int(m.group(2)))
            for part in name.split(".") for m in _PART.finditer(part)]


def tree(names: Sequence[str], values: Sequence) -> dict:
    """The nested dicts and lists that the dotted names spell, holding
    ``values``."""
    root: dict = {}
    for name, v in zip(names, values):
        node, steps = root, _path(name)
        for j, (key, idx) in enumerate(steps):
            last = j == len(steps) - 1
            nxt_list = not last and steps[j + 1][1] is not None
            if key is not None:
                if last:
                    node[key] = v
                else:
                    node = node.setdefault(key, [] if nxt_list else {})
            else:
                while len(node) <= idx:
                    node.append(None)
                if last:
                    node[idx] = v
                else:
                    if node[idx] is None:
                        node[idx] = [] if nxt_list else {}
                    node = node[idx]
    return root


def by_name(t, names: Sequence[str]) -> List:
    """The leaves of the nested tree ``t`` at the dotted names."""
    out = []
    for name in names:
        node = t
        for key, idx in _path(name):
            node = node[key] if key is not None else node[idx]
        out.append(node)
    return out


def param_count(cfg: dict) -> int:
    return offsets(leaves(cfg))[-1]
