"""ompi_tpu_torch.zero — ZeRO-style sharded data parallel (stage 2).

Port of :mod:`ompi_tpu.zero`: a :class:`~ompi_tpu_torch.zero.layout.
ZeroPlan` pads each dtype bucket to a multiple of the comm size so it is
one reduce-scatter and one allgather; ``Comm.Reduce_scatter_multi`` /
``Comm.Allgather_multi`` (coll/device) run the cycle on the device;
:class:`~ompi_tpu_torch.zero.optimizer.ZeroOptimizer` wraps it into the
reduce-scatter -> local update -> allgather training step with O(1/n)
optimizer state per rank. Stage 3 (``zero3.py``) comes later.
"""

from ompi_tpu_torch.zero.layout import (  # noqa: F401
    ShardedState, ZeroPlan, plan_for, tree_flatten, tree_unflatten,
)
from ompi_tpu_torch.zero.optimizer import (  # noqa: F401
    ZeroOptimizer, ZeroShardedState,
)
