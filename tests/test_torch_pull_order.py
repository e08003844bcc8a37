"""The order of the port's pull schedules (ompi_tpu_torch.coll.cuda_kernels
``gather`` and ``alltoall``): rank r issues its n K2 copies from sources
(r + s) mod n, s = 0 .. n-1, so at every copy position the n ranks read n
distinct ranks' staged inputs and the own block comes first.

n ranks run in one process over ``Ring.local`` in lockstep, on the
kernels' plain versions. ``ring_ag_hop`` is wrapped so that it still
copies and records which rank's staged input each copy reads (by the
storage its source views). Tolerance: none, the outputs are compared bit
for bit.
"""

import numpy as np
import pytest
import torch

from ompi_tpu_torch.coll import cuda_kernels as K

B = 3  # elements of one block


def _tagged(cur, r, g):
    """Schedule ``g`` of rank r, telling ``cur`` whose step runs."""
    while True:
        cur[0] = r
        try:
            d = next(g)
        except StopIteration:
            return
        yield d


def _expected(schedule, xs, r):
    """gather: every rank's input in rank order; alltoall: block r of
    every rank's input in rank order."""
    if schedule == "gather":
        return torch.cat(xs)
    return torch.cat([x[r * B:(r + 1) * B] for x in xs])


@pytest.mark.parametrize("schedule", ["gather", "alltoall"])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_pulls_read_distinct_sources_at_every_position(n, schedule,
                                                       monkeypatch):
    """Twice over the same rings (the second call restages what the first
    read): the outputs bit for bit, n copies a rank with the own block
    first, and at every position a permutation of the sources."""
    rng = np.random.default_rng(90 + n)
    m = n * B  # n blocks a rank: alltoall's layout; gather moves all m
    xs = [torch.from_numpy(rng.standard_normal(m).astype(np.float32))
          for _ in range(n)]
    rings = K.Ring.local(n, 4 * m + 64, 0)
    owner = {buf.untyped_storage().data_ptr(): p
             for p, buf in enumerate(rings[0].inputs)}
    reads = [[] for _ in range(n)]
    cur = [None]
    plain = K.ring_ag_hop

    def recording(src, dst, dst2=None):
        reads[cur[0]].append(owner[src.untyped_storage().data_ptr()])
        plain(src, dst, dst2)

    monkeypatch.setattr(K, "ring_ag_hop", recording)
    fn = getattr(K, schedule)
    size = n * m if schedule == "gather" else m
    for _ in range(2):
        for r in range(n):
            reads[r].clear()
        outs = [torch.full((size,), float("nan")) for _ in range(n)]
        K.run_lockstep(rings, [_tagged(cur, r, fn(rings[r], xs[r], outs[r]))
                               for r in range(n)])
        for r in range(n):
            assert torch.equal(outs[r].view(torch.int32),
                               _expected(schedule, xs, r).view(torch.int32)), r
            assert len(reads[r]) == n and reads[r][0] == r, reads[r]
        for s in range(n):
            assert sorted(reads[r][s] for r in range(n)) == list(range(n)), \
                (s, reads)
    assert [ring.linear for ring in rings] == [4] * n
