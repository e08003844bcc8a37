"""ompi_tpu_torch.zero — ZeRO-style sharded data parallel (stages 1-3).

Port of :mod:`ompi_tpu.zero`: a :class:`~ompi_tpu_torch.zero.layout.
ZeroPlan` pads each dtype bucket to a multiple of the comm size so it is
one reduce-scatter and one allgather; ``Comm.Reduce_scatter_multi`` /
``Comm.Allgather_multi`` (coll/device; numpy leaves: the host bucket
cycle) run the cycle; :class:`~ompi_tpu_torch.zero.optimizer.
ZeroOptimizer` wraps it into the reduce-scatter -> local update ->
allgather training step with O(1/n) optimizer state per rank (stages 1
and 2, ``overlap=True`` over ``Comm.Preduce_scatter_init``).
:class:`~ompi_tpu_torch.zero.zero3.Zero3Optimizer` is stage 3: the
parameters themselves sharded and streamed layer by layer through
per-layer persistent allgathers, prefetched a layer ahead and freed after
use (O(1/n) plus the prefetch window).
"""

from ompi_tpu_torch.zero.layout import (  # noqa: F401
    ShardedState, ZeroPlan, layer_groups, plan_for, tree_flatten,
    tree_unflatten,
)
from ompi_tpu_torch.zero.optimizer import (  # noqa: F401
    ZeroOptimizer, ZeroShardedState,
)
from ompi_tpu_torch.zero.zero3 import (  # noqa: F401
    Zero3Optimizer, Zero3Plan, prefetch_info,
)
