"""Device-state checkpoint/resume — the capability the reference lacks.

The port's copy of ``ompi_tpu.io.checkpoint`` (``save``, ``save_sharded``,
``restore``, ``save_async`` / ``SaveHandle``). Reference: legacy BLCR
checkpoint/restart was removed from Open MPI; what remains is message
logging + ULFM as building blocks (SURVEY §5). This module snapshots a
pytree of tensors and numpy arrays (params, optimizer state, step) to
disk through the MPI-IO plane and restores it bit-exactly, with

  - device handling: leaves are flattened by the port's
    ``zero/layout.tree_flatten`` (jax's order) and a CUDA leaf crosses
    with one device-to-host copy into pinned staging
    (:func:`ompi_tpu_torch.io.host_array`),
  - multi-rank collective writes: replicated state is written once by
    rank 0; rank-sharded state goes through Write_at_all so every rank
    lands its slice with the two-phase aggregator (fcoll),
  - async snapshots: save_async() returns a handle; the host copy is
    taken synchronously (consistency point), the file write overlaps
    the next training steps.

Format: [8-byte magic+version][8-byte header length][pickled header]
[raw little-endian leaf bytes, 64-byte aligned]. The header carries the
treedef, leaf specs and the user step, so restore needs no model code.

Where the port differs from the reference: the header pickles the port's
own :class:`~ompi_tpu_torch.zero.layout.TreeDef` (the two packages cannot
read each other's treedef; the leaf bytes and the other header fields
are the same); restored leaves are numpy arrays, and a bfloat16 leaf
(numpy has no bfloat16) comes back as a CPU ``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.zero import layout as _zl

_MAGIC = b"OTCKPT\x00\x01"
_ALIGN = 64


def dtype_name(leaf) -> str:
    """The reference's name of a leaf's dtype ("float32", "bfloat16")."""
    if isinstance(leaf, torch.Tensor):
        return _zl.dtype_name(leaf.dtype)
    return str(np.asarray(leaf).dtype)


def itemsize(name: str) -> int:
    """Bytes per element of a dtype name (bfloat16 included, which
    numpy lacks)."""
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def from_bytes(data, shape, name: str, copy: bool = True):
    """A host leaf from its raw bytes: numpy of the dtype, or a CPU
    ``torch.bfloat16`` tensor for bfloat16; a copy, or with
    ``copy=False`` a view of ``data`` (which must then be writable, as a
    bytearray is)."""
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy() if copy else bits) \
            .view(torch.bfloat16)
    a = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)
    return a.copy() if copy else a


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(host array, dtype name): C-contiguous, shape-preserving; a CUDA
    tensor through one D2H into pinned staging, bfloat16 as uint16."""
    from ompi_tpu_torch.io import host_array

    return host_array(leaf), dtype_name(leaf)


def _elems(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _layout(specs, base: int) -> List[Tuple[int, int]]:
    """(offset, nbytes) per (shape, dtype name), 64-byte aligned after
    `base`."""
    out = []
    off = base
    for shape, name in specs:
        off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
        nbytes = _elems(shape) * itemsize(name)
        out.append((off, nbytes))
        off += nbytes
    return out


def save(path: str, tree, step: int = 0, comm=None) -> None:
    """Snapshot `tree` (+ step) to `path`. With a communicator the
    state is taken as replicated: rank 0 writes, everyone barriers."""
    leaves, treedef = _zl.tree_flatten(tree)
    host = [_to_host(x) for x in leaves]
    if comm is None or comm.rank == 0:
        _write_file(path, host, treedef, step)
    if comm is not None:
        comm.Barrier()


def save_sharded(path: str, tree, comm, step: int = 0,
                 axis: int = 0) -> None:
    """Each rank holds a slice along `axis` of every leaf; slices are
    written collectively (two-phase Write_at_all) into one file that
    restore() can read from any rank count dividing the same way."""
    from ompi_tpu_torch import io as io_mod

    if axis != 0:
        raise NotImplementedError(
            "sharded checkpoints: leading-axis splits only (a non-zero "
            "axis shard is strided in the file; reshard to axis 0 "
            "before saving)")
    leaves, treedef = _zl.tree_flatten(tree)
    host = [_to_host(x) for x in leaves]
    # global shapes: concatenate along axis over ranks
    shard_sizes = comm.allgather([a.shape for a, _ in host])
    specs = []
    for i, (a, name) in enumerate(host):
        shape = list(a.shape)
        shape[axis] = sum(shapes[i][axis] for shapes in shard_sizes)
        specs.append((tuple(shape), name))
    header = pickle.dumps(
        {"treedef": treedef, "specs": specs,
         "step": step, "sharded_axis": axis,
         "sharded_nranks": comm.size},
        protocol=pickle.HIGHEST_PROTOCOL)
    base = len(_MAGIC) + 8 + len(header)
    layout = _layout(specs, base)
    if comm.rank == 0:
        with open(path, "wb") as fh:
            fh.write(_MAGIC + struct.pack("<Q", len(header)) + header)
    comm.Barrier()
    f = io_mod.File_open(comm, path,
                         io_mod.MODE_WRONLY | io_mod.MODE_CREATE)
    try:
        for i, (a, _) in enumerate(host):
            off, _ = layout[i]
            # my slice's byte offset: rows before mine along axis
            before = sum(shapes[i][axis]
                         for shapes in shard_sizes[:comm.rank])
            row_bytes = a.nbytes // a.shape[axis] if a.shape[axis] else 0
            f.Write_at_all(off + before * row_bytes, a)
    finally:
        f.Close()


def restore(path: str, comm=None,
            reshard: bool = False) -> Tuple[Any, int]:
    """Load (tree, step) from `path`. Every rank reads the full
    replicated state (restore of sharded files: pass comm and the
    original axis split is re-applied by rank). Restoring a sharded
    file into a comm whose size differs from the save-time split
    raises ``MPIError(ERR_FILE)`` unless ``reshard=True`` explicitly
    asks for the re-split (np.array_split semantics). Any malformed
    input (truncated header, corrupt pickle, short leaf bytes) raises
    ``MPIError(ERR_FILE)`` naming the path."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:len(_MAGIC)] != _MAGIC:
        raise errors.MPIError(errors.ERR_FILE,
                              f"{path}: not a checkpoint")
    try:
        (hlen,) = struct.unpack_from("<Q", blob, len(_MAGIC))
        header = pickle.loads(
            blob[len(_MAGIC) + 8:len(_MAGIC) + 8 + hlen])
        axis = header.get("sharded_axis")
        nranks = header.get("sharded_nranks")
        if (comm is not None and axis is not None
                and nranks is not None and not reshard
                and int(nranks) != comm.size):
            raise errors.MPIError(
                errors.ERR_FILE,
                f"{path}: sharded for {nranks} ranks, restoring "
                f"into a size-{comm.size} comm — pass reshard=True "
                "to re-split explicitly")
        base = len(_MAGIC) + 8 + hlen
        layout = _layout(header["specs"], base)
        leaves = []
        for (off, nbytes), (shape, name) in zip(layout, header["specs"]):
            data = blob[off:off + nbytes]
            if len(data) != nbytes:
                raise ValueError(f"leaf bytes {len(data)}/{nbytes}")
            if comm is not None and axis is not None:
                rows = np.array_split(np.arange(shape[axis]), comm.size)
                mine = rows[comm.rank]
                row = nbytes // shape[axis] if shape[axis] else 0
                lo = int(mine[0]) if len(mine) else 0
                data = data[lo * row:(lo + len(mine)) * row]
                shape = (len(mine),) + tuple(shape[1:])
            leaves.append(from_bytes(data, tuple(shape), name))
        tree = _zl.tree_unflatten(header["treedef"], leaves)
        step = header["step"]
    except errors.MPIError:
        raise
    except (struct.error, pickle.UnpicklingError, EOFError,
            ValueError, KeyError, TypeError, IndexError,
            AttributeError) as exc:
        raise errors.MPIError(
            errors.ERR_FILE,
            f"{path}: malformed checkpoint ({exc})") from exc
    return tree, step


class SaveHandle:
    """Async snapshot in flight; wait() joins the writer thread.

    Background failures are never silent: ``wait()`` re-raises them
    as ``MPIError(ERR_FILE)``, and after ``done()`` turns True the
    :attr:`error` attribute exposes the failure state without
    raising — a train loop can poll it at step boundaries."""

    def __init__(self, thread: threading.Thread) -> None:
        self._thread = thread
        #: the writer thread's failure (None while running or on
        #: success) — readable once done() is True
        self.error: Optional[BaseException] = None

    def done(self) -> bool:
        """True when the writer thread finished — successfully OR
        not; check :attr:`error` (or call :meth:`wait`) to tell."""
        return not self._thread.is_alive()

    def wait(self) -> None:
        """Join the writer; a failed save surfaces as
        ``MPIError(ERR_FILE)`` naming the underlying cause."""
        self._thread.join()
        if self.error is not None:
            if isinstance(self.error, errors.MPIError):
                raise self.error
            raise errors.MPIError(
                errors.ERR_FILE,
                f"async checkpoint save failed: {self.error!r}"
            ) from self.error


def save_async(path: str, tree, step: int = 0) -> SaveHandle:
    """Consistency point now (host copy), file write in background —
    training continues while bytes land on disk."""
    leaves, treedef = _zl.tree_flatten(tree)
    host = [_to_host(x) for x in leaves]
    handle: SaveHandle

    def run() -> None:
        try:
            _write_file(path, host, treedef, step)
        except BaseException as exc:  # noqa: BLE001
            handle.error = exc

    t = threading.Thread(target=run, daemon=True)
    handle = SaveHandle(t)
    t.start()
    return handle


# -- internals -------------------------------------------------------------

def _write_file(path: str, host, treedef, step: int) -> None:
    specs = [(tuple(a.shape), name) for a, name in host]
    header = pickle.dumps(
        {"treedef": treedef, "specs": specs,
         "step": step, "sharded_axis": None},
        protocol=pickle.HIGHEST_PROTOCOL)
    base = len(_MAGIC) + 8 + len(header)
    layout = _layout(specs, base)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(_MAGIC + struct.pack("<Q", len(header)) + header)
        for (off, _), (a, _) in zip(layout, host):
            fh.seek(off)
            fh.write(a.tobytes())
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)  # atomic publish: restart never sees a torn file
