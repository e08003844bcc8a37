"""Instance state — the MPI init engine.

Reference: ompi/instance/instance.c (ompi_mpi_instance_init_common:360)
and the JAX package's ``ompi_tpu.runtime.state``. The instance brings
up the rte, the accelerator, the device plane and the pml (ob1 over its
btls; ompi_tpu/runtime/state.py:97-99), and the world model adds
COMM_WORLD/COMM_SELF; finalize tears the pml down after the last fence
(:266-268). The prof, ingest, monitoring, tune, trace, telemetry, skew
and check planes attach in their own slices.
"""

from __future__ import annotations

import atexit
import threading

from ompi_tpu_torch.core import output
from ompi_tpu_torch.runtime import rte

_lock = threading.RLock()
_initialized = False
_finalized = False
_world = None
_self_comm = None
_out = output.stream("runtime")


def init_instance() -> None:
    """rte, then the accelerator, then the device plane (collective
    over the world; raises MPIError(ERR_INTERN) on every rank when any
    rank cannot bring its device up), then the pml (collective: btl/sm
    fences while it maps its rings)."""
    rte.init()
    _out.verbose(2, "rte up: rank %d/%d job %s",
                 rte.rank, rte.size, rte.jobid)
    from ompi_tpu_torch import accelerator

    accelerator.current()
    from ompi_tpu_torch.runtime import device_plane

    if device_plane.requested():
        device_plane.init_plane()
    from ompi_tpu_torch import pml

    pml.select()


def init():
    """Bring up the world model; returns COMM_WORLD."""
    global _initialized, _world, _self_comm
    with _lock:
        if _finalized:
            raise RuntimeError("init after finalize (MPI semantics)")
        if _initialized:
            return _world
        init_instance()
        from ompi_tpu_torch.comm import build_world

        _world, _self_comm = build_world()
        _initialized = True
        atexit.register(_atexit_finalize)
        return _world


def world():
    if not _initialized:
        init()
    return _world


def comm_self():
    if not _initialized:
        init()
    return _self_comm


def finalize() -> None:
    """MPI_Finalize: release the comms' device arenas (collective),
    then a last fence so no rank tears down while a peer still reads,
    then the pml and its transports."""
    global _finalized, _initialized, _world, _self_comm
    with _lock:
        if _finalized or not _initialized:
            _finalized = True
            return
        _finalized = True
        try:
            for c in (_world, _self_comm):
                c.free()
            rte.fence("finalize", timeout=30.0)
        finally:
            from ompi_tpu_torch import pml
            from ompi_tpu_torch.runtime import device_plane

            pml.finalize()
            device_plane.shutdown()
            _initialized = False
            _world = None
            _self_comm = None


def _atexit_finalize() -> None:
    if _initialized and not _finalized:
        try:
            finalize()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
