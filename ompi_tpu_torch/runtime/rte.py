"""RTE client — the PMIx client equivalent inside each rank.

Reference: ompi/runtime/ompi_rte.c (PMIx_Init at :580, proc naming) and the
modex macros OPAL_MODEX_SEND/RECV (opal/mca/pmix/pmix-internal.h:230-366).
Environment contract with the launcher:
  OMPI_TPU_RANK, OMPI_TPU_SIZE, OMPI_TPU_STORE_ADDR (host:port),
  OMPI_TPU_JOBID, OMPI_TPU_LOCAL_RANK, OMPI_TPU_LOCAL_SIZE,
  OMPI_TPU_WORLD_OFFSET (a spawned world's first world rank; 0 else)
Singleton (no launcher): rank 0 of 1 with an in-process store.

World ranks are unique across every world that shares a store: the
launcher's ranks are ``[0, n)`` and each ``MPI_Comm_spawn`` takes a fresh
block above the store's ``ww:<jobid>`` watermark (:mod:`ompi_tpu_torch.dpm`),
so ``rank`` is a world rank, this world is ``world_ranks()`` and
everything named by world rank (modex keys, sm rings, fences) stays apart.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Optional

from ompi_tpu_torch.runtime import kvstore

_lock = threading.Lock()
_client: Optional[kvstore.Client] = None
_local_store: Optional[kvstore.Store] = None
_fence_epoch = 0

rank: int = 0
size: int = 1
jobid: str = "singleton"
local_rank: int = 0
local_size: int = 1
#: the first world rank of this world (0 for a launcher's ranks)
world_offset: int = 0


def is_launched() -> bool:
    return "OMPI_TPU_STORE_ADDR" in os.environ


def hostname() -> str:
    """This rank's node name: the one source of node identity for every
    locality decision (btl/sm qualification, MPI_Comm_split_type,
    MPI_Get_processor_name). ``OMPI_TPU_HOSTNAME`` overrides it."""
    import socket

    return os.environ.get("OMPI_TPU_HOSTNAME") or socket.gethostname()


def init() -> None:
    """Connect to the store (or start a singleton one)."""
    global _client, _local_store, rank, size, jobid, local_rank, local_size
    global world_offset
    with _lock:
        if _client is not None:
            return
        if is_launched():
            rank = int(os.environ["OMPI_TPU_RANK"])
            size = int(os.environ["OMPI_TPU_SIZE"])
            jobid = os.environ.get("OMPI_TPU_JOBID", "job0")
            local_rank = int(os.environ.get("OMPI_TPU_LOCAL_RANK", rank))
            local_size = int(os.environ.get("OMPI_TPU_LOCAL_SIZE", size))
            world_offset = int(os.environ.get("OMPI_TPU_WORLD_OFFSET", "0"))
            host, _, port = os.environ["OMPI_TPU_STORE_ADDR"].partition(":")
            _client = kvstore.Client((host, int(port)))
        else:
            rank, size, jobid = 0, 1, f"singleton{os.getpid()}"
            local_rank, local_size = 0, 1
            world_offset = 0
            _local_store = kvstore.Store().start()
            _client = kvstore.Client(_local_store.addr)
            # a singleton's spawns take world ranks from 1 up
            _local_store.seed_counter(f"ww:{jobid}", 1)
        atexit.register(_shutdown)


def _shutdown() -> None:
    global _client, _local_store
    if _client is not None:
        _client.close()
        _client = None
    if _local_store is not None:
        _local_store.stop()
        _local_store = None


def client() -> kvstore.Client:
    if _client is None:
        init()
    assert _client is not None
    return _client


def modex_send(component: str, data: Any) -> None:
    """Publish this rank's endpoint data (OPAL_MODEX_SEND)."""
    client().put(f"modex:{jobid}:{component}:{rank}", data)


def modex_recv(component: str, peer: int, wait: bool = True) -> Any:
    """Fetch a peer's endpoint data (OPAL_MODEX_RECV); lazy, blocking."""
    return client().get(f"modex:{jobid}:{component}:{peer}", wait=wait)


def next_id(space: str) -> int:
    """Collectively-unique, monotonically increasing ID (CID
    allocation): a store-side atomic counter per ``space``, as
    ompi/communicator/comm_cid.c:297-463 allocates through PMIx."""
    return client().inc(f"id:{jobid}:{space}")


def world_ranks() -> range:
    """The world ranks of this world (a spawned world's block)."""
    return range(world_offset, world_offset + size)


def fence(tag: str = "", timeout: float | None = None) -> None:
    """This world's rendezvous (PMIx_Fence), its tag namespaced by the
    world's offset so worlds sharing the store never meet in one. A
    timeout (shutdown paths only) raises socket.timeout; a fence that
    failed ranks of this world released raises ProcFailedError."""
    global _fence_epoch
    if size == 1:
        return
    with _lock:
        _fence_epoch += 1
        epoch = _fence_epoch
    client().fence(f"fence:{jobid}:{world_offset}:{tag}:{epoch}", size,
                   rank, base=world_offset, timeout=timeout)


def abort(reason: str, code: int = 1) -> None:
    """Job abort: publish (reason, code) through the store, so peers
    blocked in store calls exit with the code, then exit. A code of 0
    exits with 1: the launcher brings the job down on a nonzero exit, so
    MPI_Abort(comm, 0) must still end it."""
    if _client is not None:
        _client.abort(rank, reason, code or 1)
    os._exit(code or 1)
