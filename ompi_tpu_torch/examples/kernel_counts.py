"""K1-K3 launch counts of an example's part, and the counts a schedule
implies.

On a card the counts are the kernels' wrappers' own (``ring_rs_hop``,
``ring_ag_hop``, ``linear_fold``: each adds one where it launches).
On the CPU the wrappers run their plain versions and count nothing, so
:class:`Counts` counts the plain versions' calls instead, in a table of
its own: the same schedule calls a wrapper once per launch on either
device, so an example's derived counts are checked on the CPU too.

:func:`ring_allreduce` and :func:`ring_hops` give what the ring schedules
of ``cuda_kernels`` over n ranks launch on each rank (n - 1 hops per
direction); :func:`add` and :func:`merged` sum such counts.
"""

from __future__ import annotations

from ompi_tpu_torch.coll import cuda_kernels as K

#: the kernels counted: K1, K2 and K3
NAMES = ("ring_rs_hop", "ring_ag_hop", "linear_fold")
_PLAIN = {"ring_rs_hop": "ring_rs_hop_plain",
          "ring_ag_hop": "ring_ag_hop_plain",
          "linear_fold": "linear_fold_plain"}
_plain_calls = dict.fromkeys(NAMES, 0)
_installed = False


def _install() -> None:
    global _installed
    if _installed:
        return
    for name, attr in _PLAIN.items():
        fn = getattr(K, attr)

        def counted(*args, _fn=fn, _name=name, **kw):
            _plain_calls[_name] += 1
            return _fn(*args, **kw)
        setattr(K, attr, counted)
    _installed = True


class Counts:
    """Zero with :meth:`reset`, read with :meth:`read` (a dict over
    :data:`NAMES`): the wrappers' launches on a card, the plain versions'
    calls on the CPU."""

    def __init__(self, device) -> None:
        self.cpu = device.type != "cuda"
        if self.cpu:
            _install()

    def reset(self) -> None:
        if self.cpu:
            for k in NAMES:
                _plain_calls[k] = 0
        else:
            for k in NAMES:
                getattr(K, k).launches = 0

    def read(self) -> dict:
        if self.cpu:
            return dict(_plain_calls)
        return {k: getattr(K, k).launches for k in NAMES}


def add(acc: dict, **kw) -> dict:
    """``acc`` plus the given counts (K1=…, K2=…, K3=…)."""
    for key, name in (("K1", "ring_rs_hop"), ("K2", "ring_ag_hop"),
                      ("K3", "linear_fold")):
        acc[name] = acc.get(name, 0) + kw.get(key, 0)
    return acc


def ring_allreduce(n: int, bidir: bool = False) -> dict:
    """K.allreduce 'ring' / 'bidir' over n ranks."""
    h = (n - 1) * (2 if bidir else 1)
    return add({}, K1=h, K2=h)


def ring_hops(n: int, bidir: bool = False) -> int:
    """K.reduce_scatter's or K.allgather's hops over n ranks ('ring' /
    'bidir'): the reduce-scatter's are K1 launches, the allgather's K2."""
    return (n - 1) * (2 if bidir else 1)


def merged(*parts: dict) -> dict:
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out
