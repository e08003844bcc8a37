"""io/async_ckpt — crash-consistent overlapped checkpointing.

The port's copy of ``ompi_tpu.io.async_ckpt``: a snapshot must cost
little train time and a ``kill -9`` at ANY instant must leave a provably
restorable state. The CheckFreq (FAST'21) / Gemini (SOSP'23) split
drives the design:

- :meth:`AsyncCheckpointer.begin` is **local and cheap**: it cuts this
  rank's :class:`~ompi_tpu_torch.zero.layout.ZeroPlan` shard of the
  pytree into ``ckpt_chunk_bytes`` chunks, orders the accelerator's
  device-to-host side stream after the caller's current stream (on the
  caller's thread, before it returns), and drains the chunks on a
  background thread: every CUDA piece is one ``copy_async`` on that side
  stream into one pinned staging buffer (allocated at most once per
  snapshot, and reused by the checkpointer's next snapshot once this one
  is committed), then each chunk is sha256-digested in place as its copy
  lands.
- :meth:`AsyncCheckpointer.commit` is **collective at a step
  boundary**: per-rank shard extents are folded into large aligned
  writes by ``fcoll.two_phase_write``, fsync'd, then the epoch is
  published by ONE atomic manifest rename
  (:mod:`ompi_tpu_torch.io.manifest`). Data-plane failures get bounded
  retries with doubling backoff and degrade to a per-rank synchronous
  write (``ckpt_fallback_sync``) — a snapshot is never lost, only
  slower.
- :meth:`AsyncCheckpointer.restore` scans manifests newest-first,
  digest-verifies every chunk, and falls back one epoch on any
  torn/corrupt/missing data (``ckpt_restore_fallbacks``).

Incremental mode diffs chunk digests against the parent manifest and
writes only changed chunks (unchanged records keep pointing at the
parent epoch's data file). Deterministic fault injection
(``ckpt_inject_fail_phase`` / ``ckpt_inject_kill_chunk`` cvars) makes
every crash point reproducible.

A snapshot reads the leaves it was given until its drain ends: the
caller must not write them in place before :meth:`Snapshot.wait_d2h`
(the ZeRO optimizer's steps make new shard tensors, so a training step
may run while a snapshot of the previous one drains).

Where the port differs from the reference: the header pickles the
port's own :class:`~ompi_tpu_torch.zero.layout.TreeDef` (each package
reads only its own; the data files, the chunk records and the other
header fields are the same); restored leaves are numpy arrays, and a
bfloat16 leaf comes back as a CPU ``torch.bfloat16`` tensor; a
:class:`Snapshot` also keeps its copy and drain times (``copy_ms``,
``drain_ns``). :meth:`AsyncCheckpointer.restore_to_device` feeds the
restored tree through the ingest plane, and the elastic plane drops a
snapshot begun on a comm that a shrink or a hot join replaced
(:meth:`Snapshot.abort`). Left for a later slice: the drain's ``prof``
ledger ``snapshot`` phase (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import os
import pickle
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.io import manifest as _manifest
from ompi_tpu_torch.io.checkpoint import dtype_name, from_bytes, itemsize
from ompi_tpu_torch.runtime import rte

_ALIGN = 64

_chunk_var = cvar.register(
    "ckpt_chunk_bytes", 4 << 20, int,
    help="Snapshot d2h/write granularity: shard bytes are cut at this "
         "size, each chunk independently copied, digested and "
         "(incrementally) diffed. Smaller chunks overlap earlier and "
         "diff finer; larger chunks amortize per-chunk cost.", level=6)
_attempts_var = cvar.register(
    "ckpt_write_attempts", 3, int,
    help="Bounded retries of the collective shard write before the "
         "commit degrades to the per-rank synchronous path "
         "(ckpt_fallback_sync pvar — a snapshot is never lost).",
    level=6)
_backoff_var = cvar.register(
    "ckpt_write_backoff", 0.005, float,
    help="Initial write-retry backoff in seconds; doubles per attempt "
         "(transient-ENOSPC/EIO shaped storage hiccups).", level=9)
_retain_var = cvar.register(
    "ckpt_retain", 3, int,
    help="Committed epochs kept on disk; older manifests and data "
         "files no retained manifest references are pruned after "
         "each commit (incremental chains keep parents alive).",
    level=6)
_fail_var = cvar.register(
    "ckpt_inject_fail_phase", "", str,
    help="Deterministic fault injection: raise MPIError at this "
         "snapshot phase (d2h | write | pre_manifest | mid_rename | "
         "corrupt_chunk). 'write' exhausts the collective attempts "
         "so the sync degrade path runs; 'corrupt_chunk' commits a "
         "manifest whose first chunk's on-disk bytes are flipped.",
    level=9)
_kill_chunk_var = cvar.register(
    "ckpt_inject_kill_chunk", -1, int,
    help="SIGKILL this process right after its Nth data chunk lands "
         "on disk (-1 disables) — the mid-write torn-data crash the "
         "kill test replays. Forces the per-rank direct write "
         "path so the kill point is deterministic.", level=9)
_kill_rank_var = cvar.register(
    "ckpt_inject_kill_rank", -1, int,
    help="World rank ckpt_inject_kill_chunk applies to (-1 = every "
         "rank: the whole job's crash).", level=9)

# -- in-flight snapshot visibility (the telemetry watchdog names this
# in hang dumps instead of blaming a busy d2h thread) -----------------

_info_lock = threading.Lock()
_info: Optional[Dict[str, Any]] = None


def snapshot_info() -> Optional[Dict[str, Any]]:
    """The snapshot in flight on this rank (None when idle): step,
    phase (d2h/commit), chunks done/total and the wall time it
    started."""
    with _info_lock:
        return dict(_info) if _info is not None else None


def _set_info(info: Optional[Dict[str, Any]]) -> None:
    global _info
    with _info_lock:
        _info = info


def _info_update(**kw) -> None:
    with _info_lock:
        if _info is not None:
            _info.update(kw)


def _inject(phase: str) -> None:
    if _fail_var.get().strip() == phase:
        pvar.record("ckpt_injected_failures")
        raise errors.MPIError(
            errors.ERR_FILE,
            f"injected checkpoint failure at phase '{phase}' "
            "(ckpt_inject_fail_phase)")


def _maybe_kill(chunk_idx: int) -> None:
    """SIGKILL after this rank's chunk ``chunk_idx`` hit the disk —
    no shutdown path runs, exactly like a real mid-snapshot crash."""
    k = _kill_chunk_var.get()
    if k < 0 or chunk_idx != k:
        return
    kr = _kill_rank_var.get()
    if kr >= 0 and rte.rank != kr:
        return
    os.kill(os.getpid(), signal.SIGKILL)


def _kill_armed() -> bool:
    return _kill_chunk_var.get() >= 0


def _elems(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _align(off: int) -> int:
    return (off + _ALIGN - 1) // _ALIGN * _ALIGN




def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in (leaf.shape if hasattr(leaf, "shape")
                                  else np.shape(leaf)))


def _flat(leaf):
    """A leaf as a 1-D run of its elements (a view where it can be)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().reshape(-1)
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1)


def _bytes_of(piece):
    """A 1-D piece as a uint8 run of its bytes (a view)."""
    if isinstance(piece, torch.Tensor):
        return piece.contiguous().view(torch.uint8)
    return np.ascontiguousarray(piece).view(np.uint8).reshape(-1)


def _is_cuda(piece) -> bool:
    return isinstance(piece, torch.Tensor) and piece.device.type == "cuda"


class _Staging:
    """One host buffer a snapshot's chunks land in: pinned when any
    piece lives on a card. ``view`` is its numpy uint8 view."""

    def __init__(self, nbytes: int, device) -> None:
        from ompi_tpu_torch import accelerator

        self.nbytes = nbytes
        self.device = device
        if device is not None:
            self.tensor = accelerator.for_device(device).host_buffer(
                max(1, nbytes), device)
        else:
            self.tensor = torch.empty(max(1, nbytes), dtype=torch.uint8)
        self.view = self.tensor.numpy()

    def fits(self, nbytes: int, device) -> bool:
        return self.nbytes >= nbytes and self.device == device


class Snapshot:
    """One epoch in flight: chunk records + host bytes accumulating on
    the d2h thread. ``commit()`` on the owning checkpointer makes it
    durable; :meth:`abort` discards it."""

    def __init__(self, step: int, header: Dict[str, Any],
                 chunks: List[Dict[str, Any]],
                 payload: List[Optional[Any]]) -> None:
        self.step = int(step)
        self.header = header
        self.chunks = chunks      # manifest records (sha filled by d2h)
        self.payload = payload    # host bytes per chunk, d2h output
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._staging: Optional[_Staging] = None
        self.committed = False
        #: device time of the snapshot's device-to-host copies on the
        #: side stream (CUDA events; None without a CUDA piece)
        self.copy_ms: Optional[float] = None
        #: the drain's wall, first copy to last digest
        self.drain_ns = 0
        #: bytes the drain staged (chunks copied, pad included)
        self.staged_bytes = 0

    def d2h_done(self) -> bool:
        """True once every chunk's host copy + digest landed (the
        cheap poll a train loop uses to pick the commit boundary)."""
        t = self._thread
        return t is None or not t.is_alive()

    def wait_d2h(self) -> None:
        """Join the d2h thread; a failed copy surfaces as
        ``MPIError(ERR_FILE)`` (never silently)."""
        t = self._thread
        if t is not None:
            t.join()
        if self.error is not None:
            if isinstance(self.error, errors.MPIError):
                raise self.error
            raise errors.MPIError(
                errors.ERR_FILE,
                f"checkpoint d2h failed: {self.error!r}"
            ) from self.error

    def abort(self) -> None:
        """Discard: wait out the d2h thread (its writes go only to
        this handle's buffers) and drop the payload. The elastic plane
        calls it when a shrink or a hot join replaces the comm the
        snapshot would commit over (``elastic/context.py``)."""
        t = self._thread
        if t is not None:
            t.join()
        self.payload = []
        self.chunks = []


class AsyncCheckpointer:
    """Overlapped, crash-consistent checkpoint plane over a directory
    (see module docstring). ``comm=None`` runs single-process;
    ``incremental=True`` digest-diffs against the parent manifest.
    ``begin`` is local; ``commit``/``save`` are collective over
    ``comm``; ``restore`` is local (any rank count may read any
    manifest — the layout is recorded, not assumed)."""

    def __init__(self, directory: str, comm=None,
                 chunk_bytes: Optional[int] = None,
                 incremental: bool = False,
                 retain: Optional[int] = None) -> None:
        self.directory = directory
        self.comm = comm
        self.chunk_bytes = max(1, int(
            _chunk_var.get() if chunk_bytes is None else chunk_bytes))
        self.incremental = bool(incremental)
        self.retain = max(1, int(
            _retain_var.get() if retain is None else retain))
        #: the staging buffer no snapshot holds, kept for the next one
        self._spare: Optional[_Staging] = None
        os.makedirs(directory, exist_ok=True)

    # -- layout ------------------------------------------------------------
    @property
    def _n(self) -> int:
        return 1 if self.comm is None else self.comm.size

    @property
    def _rank(self) -> int:
        return 0 if self.comm is None else self.comm.rank

    def _plan(self, leaves):
        from ompi_tpu_torch.zero import layout as _layout

        return _layout.plan_for(leaves, self._n)

    @staticmethod
    def _bucket_offsets(padded, dtypes, parts_meta) -> Tuple[
            List[int], Dict[str, int]]:
        """Deterministic file layout: buckets then parts, each region
        64-aligned. Pure arithmetic on manifest-recorded sizes, so
        save-time and restore-time builders always agree."""
        off = 0
        boffs: List[int] = []
        for p, dt in zip(padded, dtypes):
            off = _align(off)
            boffs.append(off)
            off += int(p) * itemsize(dt)
        poffs: Dict[str, int] = {}
        for key in sorted(parts_meta or ()):
            off = _align(off)
            poffs[key] = off
            off += (int(parts_meta[key]["nbytes"])
                    * int(parts_meta[key]["nranks"]))
        return boffs, poffs

    @staticmethod
    def _data_file(step: int) -> str:
        return f"epoch_{int(step)}.data"

    # -- begin: local chunked d2h on the dedicated stream ------------------
    def begin(self, tree, step: int,
              parts: Optional[Dict[str, Any]] = None,
              clean_buckets=()) -> Snapshot:
        """Start snapshotting ``tree`` (+ optional per-rank ``parts``
        arrays — e.g. ZeRO slot shards, all ranks contributing
        same-shaped 1-D chunks per key). Returns immediately; the d2h
        chunks drain on a background thread while training continues.
        Local — no collective until :meth:`commit`.

        ``clean_buckets`` (incremental mode only) names ZeroPlan
        bucket indices the caller KNOWS are unchanged since the
        parent manifest — e.g. from
        :attr:`~ompi_tpu_torch.zero.layout.ShardedState.versions` dirty
        tracking — so their chunks skip the d2h copy entirely and
        inherit the parent's records. Claiming a dirty bucket clean
        corrupts the snapshot; the digest-diff only protects buckets
        that were actually copied."""
        from ompi_tpu_torch.zero import layout as _layout

        leaves, treedef = _layout.tree_flatten(tree)
        plan = self._plan(leaves)
        n, rank = self._n, self._rank
        specs = [(_shape(a), dtype_name(a)) for a in leaves]
        parts = dict(parts or {})
        parts_meta: Dict[str, Dict[str, Any]] = {}
        for key in sorted(parts):
            a = parts[key]
            if getattr(a, "ndim", None) != 1:
                raise errors.MPIError(
                    errors.ERR_ARG,
                    f"AsyncCheckpointer.begin: part '{key}' must be "
                    "a 1-D per-rank chunk (got "
                    f"shape {getattr(a, 'shape', None)})")
            name = dtype_name(a)
            parts_meta[key] = {"nbytes": itemsize(name) * int(a.shape[0]),
                               "elems": int(a.shape[0]),
                               "dtype": name,
                               "nranks": n}
        boffs, poffs = self._bucket_offsets(plan.padded, plan.dtypes,
                                            parts_meta)
        header = {
            "treedef": pickle.dumps(
                treedef, protocol=pickle.HIGHEST_PROTOCOL).hex(),
            "specs": specs,
            "buckets": [list(b) for b in plan.buckets],
            "elems": list(plan.elems),
            "padded": list(plan.padded),
            "dtypes": list(plan.dtypes),
            "n": n,
            "parts": parts_meta,
        }
        chunks, jobs = self._cut_chunks(
            leaves, plan, parts, parts_meta, boffs, poffs, rank, step)
        jobs = self._skip_clean(chunks, jobs, clean_buckets, header)
        payload: List[Optional[Any]] = [None] * len(chunks)
        snap = Snapshot(step, header, chunks, payload)
        # staging: one buffer, each copied chunk at its own offset
        offs, total = {}, 0
        for ci, _ in jobs:
            offs[ci] = total
            total += int(chunks[ci]["nbytes"])
        devices = {p.device for _, pieces in jobs for p in pieces
                   if _is_cuda(p)}
        if len(devices) > 1:
            raise errors.MPIError(
                errors.ERR_ARG,
                "AsyncCheckpointer.begin: leaves on more than one card "
                f"({sorted(str(d) for d in devices)})")
        device = next(iter(devices), None)
        staging = self._spare
        if staging is not None and staging.fits(total, device):
            self._spare = None
        else:
            staging = _Staging(total, device)
        snap._staging = staging
        snap.staged_bytes = total
        acc = None
        if device is not None:
            from ompi_tpu_torch import accelerator

            acc = accelerator.for_device(device)
            # the side stream waits for what the caller queued so far
            # (the step that produced the leaves); the drain thread's
            # own current stream is not the caller's
            acc.begin_staging(device)
        _set_info({"step": int(step), "phase": "d2h",
                   "since": time.time(), "chunks_done": 0,
                   "chunks_total": len(chunks)})
        pvar.record("ckpt_snapshots")

        def drain() -> None:
            # the reference runs the drain under prof's ledger phase
            # "snapshot" (its overlap measure): prof comes with ROADMAP
            # queue 1 item 10
            try:
                _inject("d2h")
                t0 = time.perf_counter_ns()
                buf = staging.view
                timing = None
                if acc is not None:
                    torch.cuda.set_device(device)
                    side = acc.d2h_stream(device)
                    timing = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    timing[0].record(side)
                # every copy queued first, then each chunk digested as
                # its last copy lands
                last = []
                for ci, pieces in jobs:
                    pos, ev = offs[ci], None
                    for p in pieces:
                        src = _bytes_of(p)
                        k = int(src.shape[0])
                        if _is_cuda(p):
                            ev = acc.copy_async(
                                src, staging.tensor[pos:pos + k])
                        elif isinstance(src, torch.Tensor):
                            np.copyto(buf[pos:pos + k], src.numpy())
                        else:
                            np.copyto(buf[pos:pos + k], src)
                        pos += k
                    end = offs[ci] + int(chunks[ci]["nbytes"])
                    if pos < end:  # the pad tail of the bucket
                        buf[pos:end] = 0
                    last.append(ev)
                if timing is not None:
                    timing[1].record(acc.d2h_stream(device))
                done = 0
                for (ci, _), ev in zip(jobs, last):
                    if ev is not None:
                        ev.wait()
                    data = buf[offs[ci]:offs[ci] + int(chunks[ci]["nbytes"])]
                    payload[ci] = data
                    chunks[ci]["sha256"] = _manifest.digest(data)
                    done += 1
                    _info_update(chunks_done=done)
                if timing is not None:
                    timing[1].synchronize()
                    snap.copy_ms = timing[0].elapsed_time(timing[1])
                snap.drain_ns = time.perf_counter_ns() - t0
                pvar.record("ckpt_d2h_ns", snap.drain_ns)
                pvar.record("ckpt_bytes",
                            sum(c["nbytes"] for c in chunks))
                pvar.record("ckpt_chunks", len(chunks))
            except BaseException as exc:  # noqa: BLE001 - surfaced by wait_d2h
                snap.error = exc
            finally:
                # the pieces are read: drop the leaves the drain held
                jobs.clear()
                _set_info(None)

        t = threading.Thread(target=drain, daemon=True,
                             name="ckpt-d2h")
        snap._thread = t
        t.start()
        return snap

    def _release(self, snap: Snapshot) -> None:
        """Hand a finished snapshot's staging back for the next one."""
        snap.payload = []
        if snap._staging is not None:
            self._spare, snap._staging = snap._staging, None

    def _cut_chunks(self, leaves, plan, parts, parts_meta, boffs,
                    poffs, rank, step):
        """This rank's chunk records + the slices that fill them.
        Bucket b's padded flat is rank-sliced exactly like
        :meth:`ShardedState.from_full` (offset ``rank*shard_elems``),
        so the file's global view IS the ZeroPlan layout."""
        data_file = self._data_file(step)
        chunks: List[Dict[str, Any]] = []
        jobs: List[Tuple[int, list]] = []
        for b, idxs in enumerate(plan.buckets):
            isz = itemsize(plan.dtypes[b])
            k = plan.shard_elems[b]
            lo_b, hi_b = rank * k, rank * k + k
            # leaf spans inside this bucket's flat concat
            spans = []
            off = 0
            for i in idxs:
                ln = _elems(_shape(leaves[i]))
                spans.append((i, off, off + ln))
                off += ln
            chunk_elems = max(1, self.chunk_bytes // isz)
            ci_local = 0
            pos = lo_b
            while pos < hi_b:
                end = min(pos + chunk_elems, hi_b)
                pieces = []
                for i, a, e in spans:
                    s2, e2 = max(pos, a), min(end, e)
                    if s2 < e2:
                        pieces.append(_flat(leaves[i])[s2 - a:e2 - a])
                # the pad tail (beyond every span) is implicit zeros
                chunks.append({
                    "key": f"b{b}.r{rank}.c{ci_local}",
                    "file": data_file,
                    "offset": boffs[b] + pos * isz,
                    "nbytes": (end - pos) * isz,
                })
                jobs.append((len(chunks) - 1, pieces))
                ci_local += 1
                pos = end
        for key in sorted(parts):
            u8 = _bytes_of(_flat(parts[key]))
            nbytes = int(u8.shape[0])
            base = poffs[key] + rank * parts_meta[key]["nbytes"]
            ci_local = 0
            pos = 0
            while pos < nbytes or (nbytes == 0 and pos == 0):
                ln = min(self.chunk_bytes, nbytes - pos)
                chunks.append({
                    "key": f"p.{key}.r{rank}.c{ci_local}",
                    "file": data_file,
                    "offset": base + pos,
                    "nbytes": ln,
                })
                jobs.append((len(chunks) - 1,
                             [u8[pos:pos + ln]] if ln else []))
                ci_local += 1
                pos += ln
                if nbytes == 0:
                    break
        return chunks, jobs

    def _skip_clean(self, chunks, jobs, clean_buckets, header):
        """Changed-bucket dirty tracking consumer: chunks of buckets
        the caller certifies unchanged inherit the parent manifest's
        records (sha/file/offset) and never ride the d2h stream.
        Chunks without a parent record — or a parent whose file
        layout differs from this snapshot's — keep their copy job: a
        new bucket layout or a pruned parent silently falls back to
        the full path."""
        clean = set(int(b) for b in (clean_buckets or ()))
        if not clean or not self.incremental:
            return jobs
        parent = None
        for step in _manifest.scan(self.directory):
            try:
                parent = _manifest.load(self.directory, step)
                break
            except errors.MPIError:
                continue
        if parent is None or not self._parent_compatible(parent,
                                                         header):
            return jobs
        old = {rec["key"]: rec for rec in parent["chunks"]}
        kept = []
        for ci, pieces in jobs:
            rec = chunks[ci]
            key = rec["key"]
            b = int(key[1:].split(".", 1)[0]) \
                if key.startswith("b") else None
            prev = old.get(key)
            if b is not None and b in clean and prev is not None \
                    and int(prev["nbytes"]) == int(rec["nbytes"]):
                rec["sha256"] = prev["sha256"]
                rec["file"] = prev["file"]
                rec["offset"] = int(prev["offset"])
            else:
                kept.append((ci, pieces))
        return kept

    # -- commit: collective write + atomic manifest ------------------------
    def commit(self, snap: Snapshot) -> str:
        """Make ``snap`` durable (collective over ``comm``): wait out
        the d2h tail, fold shard extents into the epoch's data file,
        fsync, then publish the manifest atomically. Returns the
        manifest path. Raises ``MPIError(ERR_FILE)`` without touching
        the committed history on any failure before the rename."""
        snap.wait_d2h()
        _set_info({"step": snap.step, "phase": "commit",
                   "since": time.time(),
                   "chunks_done": 0,
                   "chunks_total": len(snap.chunks)})
        try:
            to_write = self._diff_incremental(snap)
            self._write_data(snap, to_write)
            _inject("pre_manifest")
            self._corrupt_if_injected(snap)
            self._publish(snap)
            snap.committed = True
            pvar.record("ckpt_commits")
            self._prune()
            if self.comm is not None:
                self.comm.Barrier()
        finally:
            _set_info(None)
        self._release(snap)  # host bytes served their purpose
        return _manifest.path_for(self.directory, snap.step)

    def save(self, tree, step: int,
             parts: Optional[Dict[str, Any]] = None) -> str:
        """begin + commit in one call — the synchronous convenience
        (still chunked, digested, two-phase committed)."""
        return self.commit(self.begin(tree, step, parts=parts))

    @staticmethod
    def _parent_compatible(parent: Dict[str, Any],
                           header: Dict[str, Any]) -> bool:
        """True when the parent manifest's file layout is
        byte-identical to this snapshot's — the precondition for
        inheriting its chunk records. _materialize resolves an
        inherited record's offset against the CURRENT epoch's bucket
        offsets, so after an elastic shrink/regrow shifts n/padded
        (while an early chunk's bytes and sha can be unchanged) an
        inherited offset would silently land restored bytes at the
        wrong position — with the digest still verifying."""
        ph = parent.get("header") or {}
        return (int(ph.get("n", -1)) == int(header["n"])
                and [int(p) for p in ph.get("padded", ())]
                == [int(p) for p in header["padded"]]
                and [str(d) for d in ph.get("dtypes", ())]
                == [str(d) for d in header["dtypes"]]
                and (ph.get("parts") or {})
                == (header.get("parts") or {}))

    def _diff_incremental(self, snap: Snapshot) -> List[int]:
        """Indices of chunks that must hit the disk. In incremental
        mode a chunk whose digest matches the parent manifest's
        same-key record is skipped — its record inherits the parent's
        data file (which may itself be a grandparent's)."""
        idxs = list(range(len(snap.chunks)))
        if not self.incremental:
            return idxs
        parent = None
        for step in _manifest.scan(self.directory):
            try:
                parent = _manifest.load(self.directory, step)
                break
            except errors.MPIError:
                continue
        if parent is None or not self._parent_compatible(parent,
                                                         snap.header):
            return idxs
        old = {rec["key"]: rec for rec in parent["chunks"]}
        snap.header["parent"] = int(parent["step"])
        keep = []
        skipped = 0
        for i, rec in enumerate(snap.chunks):
            prev = old.get(rec["key"])
            if prev is not None and prev["sha256"] == rec["sha256"] \
                    and int(prev["nbytes"]) == int(rec["nbytes"]):
                rec["file"] = prev["file"]
                rec["offset"] = int(prev["offset"])
                skipped += 1
            else:
                keep.append(i)
        if skipped:
            pvar.record("ckpt_incremental_skipped", skipped)
        return keep

    def _write_data(self, snap: Snapshot, to_write: List[int]) -> None:
        """Land this epoch's chunks in the data file: the collective
        two-phase path with bounded retry + doubling backoff, then the
        per-rank synchronous degrade (``ckpt_fallback_sync``) — a
        snapshot is never lost to a flaky write path. The kill-chunk
        injection forces the direct path so its crash point is
        deterministic."""
        if any(snap.payload[i] is None for i in to_write):
            # a clean-bucket chunk (no d2h payload) must always match
            # its parent record in the diff; reaching the write list
            # means the parent vanished between begin and commit
            raise errors.MPIError(
                errors.ERR_FILE,
                "checkpoint commit: clean-bucket chunk lost its "
                "parent manifest record (pruned mid-snapshot?)")
        extents = [(snap.chunks[i]["offset"], snap.chunks[i]["nbytes"])
                   for i in to_write]
        data = b"".join(snap.payload[i] for i in to_write)
        path = os.path.join(self.directory, self._data_file(snap.step))
        attempts = max(1, int(_attempts_var.get()))
        backoff = max(0.0, float(_backoff_var.get()))
        use_coll = (self.comm is not None and self.comm.size > 1
                    and not _kill_armed())
        t0 = time.perf_counter_ns()
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            err: Optional[BaseException] = None
            try:
                _inject("write")
                if use_coll:
                    self._write_collective(path, extents, data)
                else:
                    self._write_direct(path, extents, data)
            except errors.MPIError as exc:
                err = exc
            if self._agree_write(err is None):
                last = None
                break
            last = err or errors.MPIError(
                errors.ERR_FILE,
                f"{path}: checkpoint write failed on a peer rank")
            pvar.record("ckpt_write_retries")
            if attempt + 1 < attempts and backoff:
                time.sleep(backoff * (1 << attempt))
        if last is not None:
            # degrade, never lose: every rank lands its own extents
            # with plain pwrite (the vote above made every rank take
            # this path together, keeping commit collective)
            pvar.record("ckpt_fallback_sync")
            err = None
            try:
                self._write_direct(path, extents, data)
            except errors.MPIError as exc:
                err = exc
            if not self._agree_write(err is None):
                raise err or errors.MPIError(
                    errors.ERR_FILE,
                    f"{path}: synchronous degrade write failed on a "
                    "peer rank")
        pvar.record("ckpt_write_ns", time.perf_counter_ns() - t0)

    def _agree_write(self, ok: bool) -> bool:
        """Success vote after a write attempt: transient storage
        failures (the ENOSPC/EIO shapes the backoff cvar is for) hit
        individual ranks, so retry/degrade decisions must be agreed —
        a lone failing rank re-entering the collective write while its
        peers moved on to _publish's allgather is a deadlock. The vote
        doubles as the everyone-durable barrier ahead of the
        manifest."""
        if self.comm is None or self.comm.size == 1:
            return bool(ok)
        return all(self.comm.allgather(bool(ok)))

    def _write_collective(self, path: str, extents, data) -> None:
        from ompi_tpu_torch import io as io_mod
        from ompi_tpu_torch.io import fcoll

        f = io_mod.File_open(
            self.comm, path,
            io_mod.MODE_WRONLY | io_mod.MODE_CREATE)
        try:
            fcoll.two_phase_write(f, extents, data)
            f.Sync()
        finally:
            f.Close()

    def _write_direct(self, path: str, extents, data) -> None:
        """Per-rank direct writes (single-process path, the post-retry
        degrade, and the deterministic home of the kill-chunk
        injection). O_CREAT is race-free across ranks; fsync before
        return makes the chunks durable ahead of the manifest (the
        cross-rank durability sync is _write_data's success vote — a
        Barrier here would mismatch a failing rank's vote call)."""
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
        except OSError as exc:
            raise errors.MPIError(
                errors.ERR_FILE, f"{path}: {exc}") from exc
        try:
            pos = 0
            for ci, (off, ln) in enumerate(extents):
                chunk = data[pos:pos + ln]
                pos += ln
                written = 0
                while written < ln:
                    try:
                        w = os.pwrite(fd, chunk[written:],
                                      off + written)
                    except OSError as exc:
                        raise errors.MPIError(
                            errors.ERR_FILE,
                            f"{path}: {exc}") from exc
                    if w <= 0:
                        raise errors.MPIError(
                            errors.ERR_FILE,
                            f"{path}: zero-byte pwrite at "
                            f"{off + written}")
                    written += w
                os.fsync(fd)
                _maybe_kill(ci)
        finally:
            os.close(fd)

    def _corrupt_if_injected(self, snap: Snapshot) -> None:
        """corrupt_chunk injection: flip one byte of this rank's first
        written chunk AFTER the digests were recorded — the committed
        manifest then names data that will fail verification, the
        exact bit-rot/torn-page case restore must survive."""
        if _fail_var.get().strip() != "corrupt_chunk":
            return
        mine = [c for c in snap.chunks
                if c["file"] == self._data_file(snap.step)
                and c["nbytes"] > 0]
        if not mine:
            return
        pvar.record("ckpt_injected_failures")
        rec = mine[0]
        path = os.path.join(self.directory, rec["file"])
        with open(path, "r+b") as fh:
            fh.seek(int(rec["offset"]))
            b = fh.read(1)
            fh.seek(int(rec["offset"]))
            fh.write(bytes([b[0] ^ 0xFF]))
            fh.flush()
            os.fsync(fh.fileno())

    def _publish(self, snap: Snapshot) -> None:
        """Gather every rank's chunk records, atomically publish the
        manifest from rank 0, then broadcast rank 0's outcome so every
        rank raises or proceeds to the commit barrier TOGETHER — a
        rank-0-only failure (disk full at the rename, the mid_rename
        injection) must not strand peers believing the epoch
        committed."""
        recs = [dict(c) for c in snap.chunks]
        coll = self.comm is not None and self.comm.size > 1
        if coll:
            gathered = self.comm.allgather(recs)
            recs = [r for per_rank in gathered for r in per_rank]
        failure: Optional[Tuple[int, str]] = None
        if self._rank == 0:
            try:
                self._write_manifest(snap, recs)
            except errors.MPIError as exc:
                # (class, msg), not the exception: MPIError pickles
                # its args positionally and would rebuild with the
                # message in the error_class slot
                failure = (int(exc.error_class), str(exc))
        if coll:
            failure = self.comm.bcast(failure, root=0)
        if failure is not None:
            raise errors.MPIError(failure[0], failure[1])

    def _write_manifest(self, snap: Snapshot, recs) -> None:
        """Rank 0's half of _publish: build the doc and commit it via
        the atomic manifest rename. The mid_rename injection dies
        after the tmp write, before the rename — the torn state
        scan() must never surface."""
        doc = {"version": _manifest.VERSION, "step": snap.step,
               "nranks": self._n, "header": snap.header,
               "parent": snap.header.get("parent"),
               "chunks": sorted(recs, key=lambda r: r["key"])}
        if _fail_var.get().strip() == "mid_rename":
            pvar.record("ckpt_injected_failures")
            final = _manifest.path_for(self.directory, snap.step)
            tmp = f"{final}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                import json

                json.dump(doc, fh)
                fh.flush()
                os.fsync(fh.fileno())
            raise errors.MPIError(
                errors.ERR_FILE,
                "injected checkpoint failure at phase 'mid_rename' "
                "(manifest tmp written, rename never happened)")
        _manifest.write(self.directory, doc)

    def _prune(self) -> None:
        """Drop epochs beyond ``retain`` — but never a data file a
        retained manifest still references (incremental chains)."""
        if self._rank != 0:
            return
        steps = _manifest.scan(self.directory)
        if len(steps) <= self.retain:
            return
        kept_docs = []
        for s in steps[:self.retain]:
            try:
                kept_docs.append(_manifest.load(self.directory, s))
            except errors.MPIError:
                continue
        protected = _manifest.referenced_files(kept_docs)
        for s in steps[self.retain:]:
            try:
                os.unlink(_manifest.path_for(self.directory, s))
            except OSError:
                pass
            df = self._data_file(s)
            if df not in protected:
                try:
                    os.unlink(os.path.join(self.directory, df))
                except OSError:
                    pass

    # -- restore: newest-first, digest-verified, fall back on anything -----
    def restore(self) -> Tuple[Any, int, Dict[str, Any]]:
        """(tree, step, parts) of the newest epoch whose EVERY chunk
        digest-verifies. Any torn/corrupt/missing chunk or malformed
        manifest abandons that epoch (``ckpt_restore_fallbacks``) and
        the scan falls back one step; ``MPIError(ERR_FILE)`` only when
        no epoch survives. ``parts[key]`` is the rank-order concat of
        the per-rank chunks (the ZeRO slot flats). Leaves and parts are
        numpy arrays; a bfloat16 one is a CPU ``torch.bfloat16``
        tensor."""
        last_exc: Optional[BaseException] = None
        for step in _manifest.scan(self.directory):
            try:
                doc = _manifest.load(self.directory, step)
                tree, parts = self._materialize(doc)
            except errors.MPIError as exc:
                last_exc = exc
                pvar.record("ckpt_restore_fallbacks")
                continue
            pvar.record("ckpt_restores")
            return tree, int(doc["step"]), parts
        raise errors.MPIError(
            errors.ERR_FILE,
            f"{self.directory}: no restorable checkpoint epoch "
            f"(last failure: {last_exc})")

    def restore_to_device(self, engine=None
                          ) -> Tuple[Any, int, Dict[str, Any]]:
        """Restore, then feed the tree through the ingest plane: with an
        engine up (``engine``, else the plane's) the returned tree is an
        ``IngestRequest`` already gated on its first leaf, so the first
        step starts before the tail lands; with none it is the host tree
        (reference :823-833)."""
        from ompi_tpu_torch.ingest import engine as _engine

        tree, step, parts = self.restore()
        return _engine.upload_for_restore(tree, engine=engine), step, parts

    def _materialize(self, doc: Dict[str, Any]
                     ) -> Tuple[Any, Dict[str, Any]]:
        """Rebuild (tree, parts) from a manifest doc, verifying every
        chunk digest as it is read (one pass: no verify-then-reread
        window for bit-rot to hide in)."""
        from ompi_tpu_torch.zero import layout as _layout

        hdr = doc["header"]
        padded = [int(p) for p in hdr["padded"]]
        dtypes = list(hdr["dtypes"])
        parts_meta = dict(hdr.get("parts") or {})
        boffs, poffs = self._bucket_offsets(padded, dtypes, parts_meta)
        bufs = [bytearray(p * itemsize(dt))
                for p, dt in zip(padded, dtypes)]
        pbufs = {key: bytearray(int(m["nbytes"]) * int(m["nranks"]))
                 for key, m in parts_meta.items()}
        for rec in doc["chunks"]:
            key = rec["key"]
            if key.startswith("b"):
                b = int(key[1:].split(".", 1)[0])
                buf, rel = bufs[b], int(rec["offset"]) - boffs[b]
            else:  # p.<key>.r<rank>.c<i>
                pkey = key[2:key.rindex(".r")]
                buf, rel = pbufs[pkey], int(rec["offset"]) - poffs[pkey]
            # each chunk read straight into its place in the bucket
            dst = memoryview(buf)[max(0, rel):rel + int(rec["nbytes"])] \
                if rel >= 0 else memoryview(buf)[0:0]
            _manifest.read_chunk_into(self.directory, rec, dst)
            if _manifest.digest(dst) != rec["sha256"]:
                pvar.record("ckpt_digest_mismatches")
                raise errors.MPIError(
                    errors.ERR_FILE,
                    f"checkpoint chunk {rec['key']}: digest mismatch")
        try:
            treedef = pickle.loads(bytes.fromhex(hdr["treedef"]))
        except (ValueError, pickle.UnpicklingError, EOFError,
                AttributeError, ImportError, TypeError) as exc:
            raise errors.MPIError(
                errors.ERR_FILE,
                f"checkpoint manifest step {doc['step']}: corrupt "
                f"treedef ({exc})") from exc
        # the leaves and parts are views of the buffers the chunks were
        # read into (no copy)
        leaves: List[Any] = [None] * len(hdr["specs"])
        for b, idxs in enumerate(hdr["buckets"]):
            flat = memoryview(bufs[b])
            isz = itemsize(dtypes[b])
            off = 0
            for i in idxs:
                shape, dt = hdr["specs"][i]
                k = _elems(shape)
                leaves[i] = from_bytes(flat[off * isz:(off + k) * isz],
                                       tuple(shape), dt, copy=False)
                off += k
        tree = _layout.tree_unflatten(treedef, leaves)
        parts = {key: from_bytes(pbufs[key], (-1,),
                                 parts_meta[key]["dtype"], copy=False)
                 for key in pbufs}
        return tree, parts

    def latest_step(self) -> Optional[int]:
        """Newest committed epoch (no verification — cheap)."""
        steps = _manifest.scan(self.directory)
        return steps[0] if steps else None
