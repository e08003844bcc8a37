"""Elastic training — shrink and regrow over ZeRO state.

The port's copy of ``ompi_tpu.elastic``: the ULFM plane (revoke / shrink
/ agree and the heartbeat detector), ZeRO sharded optimizer state, the
sharded checkpoints and the streaming ingest plane composed into one
driver. A rank's death mid-step becomes a short recovery (an in-memory
re-shard from the survivors' chunks) instead of a lost job, and a
replacement rank joins at a step boundary with its state streamed in.
:mod:`.context` is the driver, :mod:`.reshard` the layout arithmetic the
bitwise guarantee rests on, :mod:`.inject` the deterministic fault
harness.
"""

from ompi_tpu_torch.elastic import inject, reshard  # noqa: F401
from ompi_tpu_torch.elastic.context import (  # noqa: F401
    ElasticContext, ElasticStep, hot_join, is_joiner, recovery_info,
    spawn_replacement)
