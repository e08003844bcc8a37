"""Device plane — one device per rank, agreed on by the whole world.

Reference analog: ``ompi_tpu.runtime.device_plane`` brings up
multi-controller jax and agrees on it through the modex, after which XLA
collectives (and the Pallas kernels' remote DMAs) run over ICI. Here the
plane picks this rank's device — ``cuda:(local_rank % device_count)``
(all ranks share ``cuda:0`` on a one-card machine) — and agrees through
the modex that every rank of this world succeeded (as at
ompi_tpu/runtime/device_plane.py:174-182, so no rank hangs), learning
each rank's device (:func:`device_for_world_rank`). A failure raises
``MPIError(ERR_INTERN)`` on every rank: the plane is never disabled
quietly.

A spawned world (:mod:`ompi_tpu_torch.dpm`) brings up a plane of its own
under its own leader, its first world rank (``rte.world_offset``), as the
reference's does (:137-141): the agreement's modex component carries the
world's offset. The port has no coordinator to publish, so the leader
only names the world; each rank still reads every peer's entry.

The device collectives' peer-mapped arenas and their hop counters belong
to the component that uses them (:mod:`ompi_tpu_torch.coll.cuda`), as
the reference's per-comm ``coll/xla._Ctx`` does.

Platforms (cvar ``device_plane_platform``): ``cuda`` [default] as above;
``cpu`` keeps every rank's tensors on the CPU, where the collectives run
their kernels' plain versions over shared-memory arenas — the test
configuration.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import cvar, output
from ompi_tpu_torch.runtime import rte

_out = output.stream("device_plane")

_enabled = cvar.register(
    "device_plane", "off", str,
    help="device plane: 'on' binds every rank to a device at MPI_Init so "
         "device-buffer (torch.Tensor) collectives run on it (coll/device, "
         "and coll/cuda where enabled); 'off' [default] leaves them to "
         "one-rank comms, which need no plane",
    choices=["on", "off"], level=3)

_platform = cvar.register(
    "device_plane_platform", "cuda", str,
    help="rank device platform: 'cuda' [default] = one CUDA device per "
         "rank (local_rank % device_count) with the hand-written kernels; "
         "'cpu' = tensors on the CPU with the kernels' plain versions over "
         "shared-memory arenas (tests). 'cuda' without a usable GPU fails "
         "MPI_Init.",
    choices=["cuda", "cpu"], level=3)

_lock = threading.Lock()
#: {"device": torch.device, "platform": str, "devices": {world rank:
#: torch.device}}
_state: Optional[dict] = None


def requested() -> bool:
    return _enabled.get() == "on"


def active() -> bool:
    return _state is not None


def device() -> torch.device:
    assert _state is not None, "device plane not initialized"
    return _state["device"]


def platform() -> str:
    return _platform.get()


def leader() -> int:
    """The world rank that leads this world's plane: its first rank."""
    return rte.world_offset


def device_for_world_rank(world_rank: int) -> Optional[torch.device]:
    """The device a rank of this world bound (None for a rank of another
    world, or with the plane down)."""
    if _state is None:
        return None
    return _state["devices"].get(world_rank)


def _bring_up_local() -> torch.device:
    if platform() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false (no usable "
                           "CUDA device)")
    dev = torch.device("cuda", rte.local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_plane() -> None:
    """Collective over the world: bind this rank's device and agree that
    every rank did. Raises MPIError(ERR_INTERN) on every rank when any
    rank failed."""
    global _state
    with _lock:
        if _state is not None:
            return
        dev, reason = None, ""
        try:
            dev = _bring_up_local()
        except Exception as exc:  # noqa: BLE001 — must reach agreement
            reason = f"{type(exc).__name__}: {exc}"
        key = f"devplane:{leader()}"
        rte.modex_send(key, {"ok": dev is not None, "reason": reason,
                             "device": None if dev is None else str(dev)})
        peers = {r: rte.modex_recv(key, r) for r in rte.world_ranks()}
        bad = {r: p["reason"] for r, p in peers.items() if not p["ok"]}
        if bad:
            raise errors.MPIError(
                errors.ERR_INTERN,
                f"device plane (platform {platform()!r}) failed on "
                f"rank(s) {sorted(bad)}: "
                + "; ".join(f"rank {r}: {m}" for r, m in sorted(bad.items()))
                + " — pass --mca device_plane_platform cpu to run on the "
                  "CPU")
        _state = {"device": dev, "platform": platform(),
                  "devices": {r: torch.device(p["device"])
                              for r, p in peers.items()}}
        _out.verbose(2, "device plane up: rank %d on %s", rte.rank, dev)


def shutdown() -> None:
    global _state
    _state = None
