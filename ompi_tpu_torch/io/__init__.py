"""MPI-IO — the ompio equivalent.

The port's copy of ``ompi_tpu.io`` (``io/__init__.py:80-628``): ``File``,
``File_open``, ``File_delete``, the ``MODE_*`` and ``SEEK_*`` constants.
Reference: ompi/mca/io/ompio/io_ompio.h:1 orchestrates four
sub-frameworks: fs (open/close/delete — fs/ufs), fbtl (individual
async I/O — fbtl/posix), fcoll (two-phase collective aggregation —
fcoll/vulcan), sharedfp (shared file pointer — sharedfp/sm), over
common/ompio file views. ~26 KLoC of C.

One package: fs == os.open/posix; fbtl == os.pread/pwrite on a worker
thread, completion via plain requests the progress engine can spin on;
fcoll == two-phase aggregation over the comm's own p2p/collective plane
(:mod:`ompi_tpu_torch.io.fcoll`); sharedfp == an atomic counter in the
rendezvous store (the sharedfp/sm shared-memory counter, relocated to
the job's store daemon); views == datatype span tables
(:mod:`ompi_tpu_torch.io.fileview`). Checkpointing of device state lives
in :mod:`ompi_tpu_torch.io.checkpoint` and
:mod:`ompi_tpu_torch.io.async_ckpt` on top of this.

Buffers. A write takes a numpy array, a CPU tensor (packed from its
memory) or a CUDA tensor, which crosses to the host with one
device-to-host copy into pinned staging ordered after the caller's
current stream (:func:`host_array`); bfloat16 travels as its bytes under
``MPI_BFLOAT16``. Reads fill numpy buffers, as the reference's do: a
tensor given to a read is ``MPIError(ERR_BUFFER)`` (the reference cannot
read into an immutable jax.Array either; it raises ValueError there).
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import pvar
from ompi_tpu_torch.datatype import datatype as dt_mod
from ompi_tpu_torch.datatype.convertor import Convertor
from ompi_tpu_torch.io.fileview import FileView
from ompi_tpu_torch.runtime import rte

# amode flags (MPI-3.1 §13.2.1 values as in mpi.h)
MODE_RDONLY = 2
MODE_RDWR = 8
MODE_WRONLY = 4
MODE_CREATE = 1
MODE_EXCL = 64
MODE_DELETE_ON_CLOSE = 16
MODE_APPEND = 128
MODE_SEQUENTIAL = 256

SEEK_SET, SEEK_CUR, SEEK_END = 600, 602, 604


class _IORequest:
    """fbtl-style async op: runs on a worker thread; wait() spins the
    progress engine like any other request (the reference posts aio and
    polls completion from progress)."""

    def __init__(self, fn) -> None:
        self.completed = False
        self.result = None
        self.error: Optional[BaseException] = None

        def run() -> None:
            try:
                self.result = fn()
            except BaseException as exc:  # noqa: BLE001
                self.error = exc
            self.completed = True

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def test(self) -> bool:
        return self.completed

    def wait(self):
        from ompi_tpu_torch.core import progress

        progress.wait_until(lambda: self.completed)
        if self.error is not None:
            raise self.error
        return self.result


class File:
    """MPI_File: per-comm file handle with views + individual,
    collective, shared and nonblocking I/O."""

    def __init__(self, comm, filename: str, amode: int,
                 info=None) -> None:
        from ompi_tpu_torch.info import apply_memkinds, as_info

        self.comm = comm
        self.filename = filename
        self.amode = amode
        # MPI_File_set/get_info + the reference's default file
        # errhandler ERRORS_RETURN (errhandler.h: files default to
        # return, comms/wins to fatal)
        self.info = apply_memkinds(as_info(info))
        self.errhandler = errors.ERRORS_RETURN
        self.view = FileView()
        self._pos = 0          # individual pointer, visible bytes
        self._atomic = False   # MPI_File_set_atomicity mode
        self._lock = threading.Lock()
        # fileid keys the shared-pointer counter. Derived WITHOUT a
        # bcast: opens are collective and ordered per comm, so a
        # per-comm open sequence number matches across ranks — and
        # non-collective shared-fp calls (Get_position_shared,
        # Write_shared) must never enter a collective to learn it.
        seq = comm.attrs.get("io:open_seq", 0)
        comm.attrs["io:open_seq"] = seq + 1
        # group.ranks[0] disambiguates same-cid comms on different
        # ranks (every rank's COMM_SELF is cid 1)
        self._fileid: Optional[str] = \
            f"{comm.cid}:{comm.group.ranks[0]}:{seq}"
        flags = 0
        if amode & MODE_RDWR:
            flags |= os.O_RDWR
        elif amode & MODE_WRONLY:
            flags |= os.O_WRONLY
        else:
            flags |= os.O_RDONLY
        if amode & MODE_CREATE:
            flags |= os.O_CREAT
        if amode & MODE_EXCL:
            flags |= os.O_EXCL
        if amode & MODE_APPEND:
            flags |= os.O_APPEND
        try:
            self.fd = os.open(filename, flags, 0o644)
        except OSError as exc:
            raise errors.MPIError(errors.ERR_FILE, str(exc)) from exc
        pvar.record("file_open")

    # -- fs ops -----------------------------------------------------------
    def Close(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None
        if self.amode & MODE_DELETE_ON_CLOSE and self.comm.rank == 0:
            try:
                os.unlink(self.filename)
            except OSError:
                pass

    def Get_size(self) -> int:
        return os.fstat(self.fd).st_size

    def Set_size(self, size: int) -> None:
        os.ftruncate(self.fd, size)
        self._pos = min(self._pos, size)

    def Preallocate(self, size: int) -> None:
        if self.Get_size() < size:
            os.ftruncate(self.fd, size)

    def Sync(self) -> None:
        os.fsync(self.fd)

    def Set_atomicity(self, flag: bool) -> None:
        """MPI_File_set_atomicity (collective —
        ompi/mpi/c/file_set_atomicity.c). The local-fs backend writes
        with POSIX pwrite (atomic per call on one host); atomic mode
        additionally fsyncs after every write so conflicting accesses
        through other ranks' handles observe sequentially consistent
        data without an explicit Sync."""
        self._atomic = bool(flag)
        self.comm.Barrier()

    def Get_atomicity(self) -> bool:
        return self._atomic

    def Get_amode(self) -> int:
        return self.amode

    def Get_group(self):
        """MPI_File_get_group: a new group of the open's comm."""
        return self.comm.Get_group()

    # -- views ------------------------------------------------------------
    def Set_view(self, disp: int = 0, etype: dt_mod.Datatype = None,
                 filetype: dt_mod.Datatype = None) -> None:
        """MPI_File_set_view: from here on, offsets count in etypes and
        only the filetype's non-hole bytes are addressable."""
        etype = etype if etype is not None else dt_mod.BYTE
        self.view = FileView(disp, etype, filetype)
        self._pos = 0

    def Get_view(self) -> Tuple[int, dt_mod.Datatype, dt_mod.Datatype]:
        return self.view.disp, self.view.etype, self.view.filetype

    def Get_byte_offset(self, offset: int) -> int:
        """MPI_File_get_byte_offset: absolute file byte of a view
        offset (etype units) — file_get_byte_offset.c."""
        return self.view.map(self._off_bytes(offset), 1)[0][0]

    def Get_type_extent(self, datatype: dt_mod.Datatype) -> int:
        """MPI_File_get_type_extent (native representation: memory
        extent, file_get_type_extent.c)."""
        return datatype.extent

    # -- errhandler plane (MPI_File_set_errhandler) -----------------------
    def Set_errhandler(self, eh) -> None:
        self.errhandler = eh

    def Get_errhandler(self):
        return self.errhandler

    def Set_info(self, info) -> None:
        from ompi_tpu_torch.info import apply_memkinds, as_info

        self.info = apply_memkinds(as_info(info))

    def Get_info(self):
        return self.info.dup()  # MPI: get_info returns a new object

    # -- raw span I/O (fbtl equivalent) -----------------------------------
    # OS failures route through the file's errhandler (the
    # OMPI_ERRHANDLER_INVOKE pattern at every io binding's error
    # exit); a user callback that returns makes the op a recovered
    # no-op (0 bytes / empty read).
    def _pwritev(self, extents: List[Tuple[int, int]],
                 data: bytes) -> int:
        done = 0
        try:
            for off, length in extents:
                # honor pwrite's return: POSIX may land fewer bytes
                # than asked (quota, signals, fs limits) — loop until
                # the extent is fully on disk; a zero-byte write is an
                # error, not progress
                written = 0
                while written < length:
                    w = os.pwrite(self.fd,
                                  data[done + written:done + length],
                                  off + written)
                    if w <= 0:
                        raise OSError(
                            f"zero-byte pwrite at offset "
                            f"{off + written}")
                    written += w
                done += length
            if self._atomic and done:
                os.fsync(self.fd)  # atomic mode: durable/visible
                # before return; fsync failures (ENOSPC/EIO at
                # writeback) route through the errhandler like any
                # other OS failure here
        except (OSError, TypeError) as exc:
            errors.dispatch(self, errors.MPIError(
                errors.ERR_FILE, f"{self.filename}: {exc}"))
            # recovered by a callback: fall through so the bytes that
            # DID land on disk are still counted
        pvar.record("file_write_bytes", done)
        return done

    def _preadv(self, extents: List[Tuple[int, int]]) -> bytes:
        parts = []
        try:
            for off, length in extents:
                chunk = os.pread(self.fd, length, off)
                if len(chunk) < length:  # short read past EOF:
                    chunk += b"\0" * (length - len(chunk))  # zero-fill
                parts.append(chunk)
        except (OSError, TypeError) as exc:
            if errors.dispatch(self, errors.MPIError(
                    errors.ERR_FILE, f"{self.filename}: {exc}")):
                # recovered: zero-fill what the caller expected
                parts = [b"\0" * length for _, length in extents]
        out = b"".join(parts)
        pvar.record("file_read_bytes", len(out))
        return out

    def _off_bytes(self, offset_etypes: int) -> int:
        return offset_etypes * self.view.etype.size

    # -- explicit-offset individual I/O -----------------------------------
    def Write_at(self, offset: int, buf, count: int = None,
                 datatype: dt_mod.Datatype = None) -> int:
        data, nbytes = _pack(buf, count, datatype)
        extents = self.view.map(self._off_bytes(offset), nbytes)
        return self._pwritev(extents, data)

    def Read_at(self, offset: int, buf, count: int = None,
                datatype: dt_mod.Datatype = None) -> int:
        conv, nbytes = _conv(buf, count, datatype)
        extents = self.view.map(self._off_bytes(offset), nbytes)
        data = self._preadv(extents)
        conv.unpack(data)
        return len(data)

    def Iwrite_at(self, offset: int, buf, count: int = None,
                  datatype: dt_mod.Datatype = None) -> _IORequest:
        data, nbytes = _pack(buf, count, datatype)
        extents = self.view.map(self._off_bytes(offset), nbytes)
        return _IORequest(lambda: self._pwritev(extents, data))

    def Iread_at(self, offset: int, buf, count: int = None,
                 datatype: dt_mod.Datatype = None) -> _IORequest:
        conv, nbytes = _conv(buf, count, datatype)
        extents = self.view.map(self._off_bytes(offset), nbytes)

        def run() -> int:
            data = self._preadv(extents)
            conv.unpack(data)
            return len(data)

        return _IORequest(run)

    # -- individual-pointer I/O -------------------------------------------
    def _seek_target(self, cur: int, offset_bytes: int,
                     whence: int) -> int:
        """Seek arithmetic in VISIBLE byte space — both file pointers
        live there, so SEEK_END maps the physical size through the
        view's inverse (a view with disp/holes sees fewer bytes than
        the file holds)."""
        if whence == SEEK_SET:
            return offset_bytes
        if whence == SEEK_CUR:
            return cur + offset_bytes
        return self.view.visible_size(self.Get_size()) + offset_bytes

    def Seek(self, offset: int, whence: int = SEEK_SET) -> None:
        ebytes = self.view.etype.size
        self._pos = self._seek_target(self._pos, offset * ebytes,
                                      whence)
        if self._pos < 0:
            raise errors.MPIError(errors.ERR_ARG, "seek before start")

    def Get_position(self) -> int:
        return self._pos // self.view.etype.size

    def Write(self, buf, count: int = None,
              datatype: dt_mod.Datatype = None) -> int:
        with self._lock:
            data, nbytes = _pack(buf, count, datatype)
            extents = self.view.map(self._pos, nbytes)
            n = self._pwritev(extents, data)
            self._pos += nbytes
            return n

    def Read(self, buf, count: int = None,
             datatype: dt_mod.Datatype = None) -> int:
        with self._lock:
            conv, nbytes = _conv(buf, count, datatype)
            extents = self.view.map(self._pos, nbytes)
            data = self._preadv(extents)
            conv.unpack(data)
            self._pos += nbytes
            return len(data)

    # -- shared file pointer (sharedfp equivalent) ------------------------
    def _sfp_key(self) -> str:
        return f"io:sfp:{rte.jobid}:{self._fileid}"

    def Write_shared(self, buf, count: int = None,
                     datatype: dt_mod.Datatype = None) -> int:
        """Atomic fetch-add on the store counter orders writers
        (reference: sharedfp/sm shared counter)."""
        data, nbytes = _pack(buf, count, datatype)
        end = rte.client().inc(self._sfp_key(), nbytes)
        extents = self.view.map(end - nbytes, nbytes)
        return self._pwritev(extents, data)

    def Read_shared(self, buf, count: int = None,
                    datatype: dt_mod.Datatype = None) -> int:
        conv, nbytes = _conv(buf, count, datatype)
        end = rte.client().inc(self._sfp_key(), nbytes)
        extents = self.view.map(end - nbytes, nbytes)
        data = self._preadv(extents)
        conv.unpack(data)
        return len(data)

    def Seek_shared(self, offset: int, whence: int = SEEK_SET) -> None:
        """MPI_File_seek_shared (collective, identical args on every
        rank — ompi/mpi/c/file_seek_shared.c). Rank 0 moves the shared
        counter via read+adjust (race-free: MPI forbids concurrent
        shared-fp ops during the collective); the resolved target
        broadcasts so a bad seek raises on EVERY rank instead of
        stranding peers in a barrier."""
        key = self._sfp_key()
        # entry barrier: rank 0 must not mutate the counter while a
        # peer is still inside ITS preceding shared-fp call (the exit
        # barrier alone lets the reset overtake a slow reader)
        self.comm.Barrier()
        cur = tgt = None
        if self.comm.rank == 0:
            cur = rte.client().inc(key, 0)
            tgt = self._seek_target(cur, offset * self.view.etype.size,
                                    whence)
        tgt = self.comm.bcast(tgt, root=0)
        if tgt < 0:
            raise errors.MPIError(errors.ERR_ARG,
                                  "shared seek before start")
        if self.comm.rank == 0:
            rte.client().inc(key, tgt - cur)
        self.comm.Barrier()

    def Get_position_shared(self) -> int:
        """MPI_File_get_position_shared (etype units)."""
        return (rte.client().inc(self._sfp_key(), 0)
                // self.view.etype.size)

    # -- ordered shared-fp collectives ------------------------------------
    # Reference: ompi/mpi/c/file_read_ordered.c (+_begin/_end, write
    # forms) over sharedfp's write_ordered: ranks write rank-ordered
    # slices off the shared pointer. Here an allgather of per-rank
    # sizes yields exscan offsets, rank 0 claims the whole range with
    # ONE atomic add on the shared counter, and the data movement
    # rides the existing fcoll two-phase plane.
    def _ordered_setup(self, nbytes: int) -> int:
        key = self._sfp_key()  # lazily COLLECTIVE on first use — must
        # run on every rank here, or rank 0's fileid bcast would pair
        # with the peers' base bcast below
        sizes = self.comm.coll.allgather_obj(self.comm, nbytes)
        total = sum(sizes)
        base = None
        if self.comm.rank == 0:
            base = rte.client().inc(key, total) - total
        base = self.comm.bcast(base, root=0)
        return base + sum(sizes[:self.comm.rank])

    def Write_ordered(self, buf, count: int = None,
                      datatype: dt_mod.Datatype = None) -> int:
        """MPI_File_write_ordered: as-if serialized in rank order off
        the shared pointer."""
        from ompi_tpu_torch.io import fcoll

        data, nbytes = _pack(buf, count, datatype)
        start = self._ordered_setup(nbytes)
        return fcoll.two_phase_write(self, self.view.map(start, nbytes),
                                     data)

    def Read_ordered(self, buf, count: int = None,
                     datatype: dt_mod.Datatype = None) -> int:
        from ompi_tpu_torch.io import fcoll

        conv, nbytes = _conv(buf, count, datatype)
        start = self._ordered_setup(nbytes)
        return fcoll.two_phase_read(self, self.view.map(start, nbytes),
                                    conv)

    def Write_ordered_begin(self, buf, count: int = None,
                            datatype: dt_mod.Datatype = None) -> None:
        """Split form: the shared pointer and this rank's slice are
        claimed NOW (collective metadata round); the data movement
        runs as a progressed schedule so compute overlaps until
        Write_ordered_end."""
        from ompi_tpu_torch.coll import libnbc
        from ompi_tpu_torch.io import fcoll

        self._split_check()
        data, nbytes = _pack(buf, count, datatype)
        start = self._ordered_setup(nbytes)
        out: dict = {}
        req = libnbc.NbcRequest(fcoll.sched_write(
            self, self.view.map(start, nbytes), data,
            self._coll_tags(), out))
        req.result = out
        self._split_req = req

    def Write_ordered_end(self) -> int:
        return self._split_end()

    def Read_ordered_begin(self, buf, count: int = None,
                           datatype: dt_mod.Datatype = None) -> None:
        from ompi_tpu_torch.coll import libnbc
        from ompi_tpu_torch.io import fcoll

        self._split_check()
        conv, nbytes = _conv(buf, count, datatype)
        start = self._ordered_setup(nbytes)
        out: dict = {}
        req = libnbc.NbcRequest(fcoll.sched_read(
            self, self.view.map(start, nbytes), conv,
            self._coll_tags(), out))
        req.result = out
        self._split_req = req

    def Read_ordered_end(self) -> int:
        return self._split_end()

    # -- collective I/O (fcoll equivalent) --------------------------------
    def Write_at_all(self, offset: int, buf, count: int = None,
                     datatype: dt_mod.Datatype = None) -> int:
        from ompi_tpu_torch.io import fcoll

        data, nbytes = _pack(buf, count, datatype)
        extents = self.view.map(self._off_bytes(offset), nbytes)
        return fcoll.two_phase_write(self, extents, data)

    def Read_at_all(self, offset: int, buf, count: int = None,
                    datatype: dt_mod.Datatype = None) -> int:
        from ompi_tpu_torch.io import fcoll

        conv, nbytes = _conv(buf, count, datatype)
        extents = self.view.map(self._off_bytes(offset), nbytes)
        return fcoll.two_phase_read(self, extents, conv)

    def Write_all(self, buf, count: int = None,
                  datatype: dt_mod.Datatype = None) -> int:
        n = self.Write_at_all(self.Get_position(), buf, count, datatype)
        self._pos += n
        return n

    def Read_all(self, buf, count: int = None,
                 datatype: dt_mod.Datatype = None) -> int:
        n = self.Read_at_all(self.Get_position(), buf, count, datatype)
        self._pos += n
        return n

    # -- nonblocking + split collective I/O (r3 VERDICT missing #6) -------
    # Reference: ompi/mpi/c/file_read_all_begin.c (+_end, write
    # variants, iread_all/iwrite_all) over ompio's nonblocking
    # collective path. The two-phase exchange runs as a libnbc-style
    # schedule on the progress engine (io/fcoll.sched_*): compute
    # between begin/end — or before wait — overlaps the collective.

    def _coll_tags(self):
        # three collective-context tags per op (extents round,
        # shuffle/reply round, completion barrier), allocated in call
        # order — identical across ranks because collective calls are
        # ordered (MPI semantics)
        t = self.comm.coll.next_tag
        return (t(), t(), t())

    def Iwrite_at_all(self, offset: int, buf, count: int = None,
                      datatype: dt_mod.Datatype = None):
        """MPI_File_iwrite_at_all: request completes when every
        rank's file domain is on disk."""
        from ompi_tpu_torch.coll import libnbc
        from ompi_tpu_torch.io import fcoll

        data, nbytes = _pack(buf, count, datatype)
        return self._iwrite_packed(offset, data, nbytes)

    def _iwrite_packed(self, offset: int, data: bytes, nbytes: int):
        from ompi_tpu_torch.coll import libnbc
        from ompi_tpu_torch.io import fcoll

        extents = self.view.map(self._off_bytes(offset), nbytes)
        out: dict = {}
        req = libnbc.NbcRequest(fcoll.sched_write(
            self, extents, data, self._coll_tags(), out))
        req.result = out
        return req

    def Iread_at_all(self, offset: int, buf, count: int = None,
                     datatype: dt_mod.Datatype = None):
        """MPI_File_iread_at_all: ``buf`` fills at completion."""
        from ompi_tpu_torch.coll import libnbc
        from ompi_tpu_torch.io import fcoll

        conv, nbytes = _conv(buf, count, datatype)
        extents = self.view.map(self._off_bytes(offset), nbytes)
        out: dict = {}
        req = libnbc.NbcRequest(fcoll.sched_read(
            self, extents, conv, self._coll_tags(), out))
        req.result = out
        return req

    def Iwrite_all(self, buf, count: int = None,
                   datatype: dt_mod.Datatype = None):
        """MPI_File_iwrite_all (individual pointer advances NOW — the
        range is claimed at call time, per the split/nonblocking
        pointer rules)."""
        data, nbytes = _pack(buf, count, datatype)
        req = self._iwrite_packed(self.Get_position(), data, nbytes)
        self._pos += nbytes
        return req

    def Iread_all(self, buf, count: int = None,
                  datatype: dt_mod.Datatype = None):
        """MPI_File_iread_all."""
        _, nbytes = _conv(buf, count, datatype)
        req = self.Iread_at_all(self.Get_position(), buf, count,
                                datatype)
        self._pos += nbytes
        return req

    # split collectives: begin starts the schedule, end completes it;
    # at most ONE split collective may be active per file handle
    # (MPI-3.1 §13.4.5), enforced.
    def _split_check(self) -> None:
        """MUST run before the schedule starts: a second begin that
        had already posted its rounds would corrupt both the file and
        the tag sequence before the error surfaced."""
        if getattr(self, "_split_req", None) is not None:
            raise errors.MPIError(
                errors.ERR_OTHER,
                "a split collective is already active on this file "
                "handle (MPI allows one at a time)")

    def _split_end(self) -> int:
        req = getattr(self, "_split_req", None)
        if req is None:
            raise errors.MPIError(
                errors.ERR_OTHER,
                "no split collective active (call *_begin first)")
        self._split_req = None
        req.wait()
        return req.result.get("n", 0)

    def Write_at_all_begin(self, offset: int, buf, count: int = None,
                           datatype: dt_mod.Datatype = None) -> None:
        self._split_check()
        self._split_req = self.Iwrite_at_all(offset, buf, count,
                                             datatype)

    def Write_at_all_end(self) -> int:
        return self._split_end()

    def Read_at_all_begin(self, offset: int, buf, count: int = None,
                          datatype: dt_mod.Datatype = None) -> None:
        self._split_check()
        self._split_req = self.Iread_at_all(offset, buf, count,
                                            datatype)

    def Read_at_all_end(self) -> int:
        return self._split_end()

    def Write_all_begin(self, buf, count: int = None,
                        datatype: dt_mod.Datatype = None) -> None:
        self._split_check()
        self._split_req = self.Iwrite_all(buf, count, datatype)

    def Write_all_end(self) -> int:
        return self._split_end()

    def Read_all_begin(self, buf, count: int = None,
                       datatype: dt_mod.Datatype = None) -> None:
        self._split_check()
        self._split_req = self.Iread_all(buf, count, datatype)

    def Read_all_end(self) -> int:
        return self._split_end()


# -- module-level API ------------------------------------------------------

def File_open(comm, filename: str,
              amode: int = MODE_RDONLY, info=None) -> File:
    """MPI_File_open (collective over comm)."""
    f = File(comm, filename, amode, info=info)
    comm.Barrier()  # open is collective; surface create races together
    return f


def File_delete(filename: str) -> None:
    try:
        os.unlink(filename)
    except FileNotFoundError as exc:
        raise errors.MPIError(errors.ERR_FILE, str(exc)) from exc


# -- pack/unpack helpers ---------------------------------------------------

def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor's bytes are read as on the host
    (bfloat16, which numpy lacks, as its uint16 bits)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def host_array(buf) -> np.ndarray:
    """``buf`` as a C-contiguous numpy array of its shape: a numpy
    array or a CPU tensor as it is (a CPU tensor's memory, no copy), a
    CUDA tensor through one device-to-host copy into pinned staging,
    ordered after the caller's current stream (the accelerator's
    ``begin_staging`` / ``copy_async``; a pinned allocation that fails
    raises). bfloat16 comes back as its uint16 bits."""
    if not isinstance(buf, torch.Tensor):
        a = np.asarray(buf)
        if not a.flags["C_CONTIGUOUS"]:
            a = np.ascontiguousarray(a).reshape(a.shape)
        return a
    t = buf.detach().contiguous()
    npdt = _np_dtype(t.dtype)
    if t.device.type != "cuda":
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(npdt)
        return t.numpy()
    from ompi_tpu_torch import accelerator

    acc = accelerator.for_device(t.device)
    u8 = t.reshape(-1).view(torch.uint8)
    acc.begin_staging(t.device)
    host = acc.host_buffer(max(1, u8.numel()), t.device)
    raw = acc.copy_async(u8, host).wait()
    return raw.view(npdt).reshape(tuple(t.shape))


def _datatype_of(buf, arr: np.ndarray) -> dt_mod.Datatype:
    if isinstance(buf, torch.Tensor) and buf.dtype == torch.bfloat16:
        return dt_mod.BFLOAT16
    return dt_mod.from_numpy_dtype(arr.dtype)


def _pack(buf, count, datatype) -> Tuple[bytes, int]:
    arr = host_array(buf) if isinstance(buf, torch.Tensor) \
        else np.asarray(buf)
    if datatype is None:
        datatype = _datatype_of(buf, arr)
    if count is None:
        count = arr.size
    conv = Convertor(arr, datatype, count)
    data = conv.pack()
    return data, len(data)


def _conv(buf, count, datatype) -> Tuple[Convertor, int]:
    if isinstance(buf, torch.Tensor):
        raise errors.MPIError(
            errors.ERR_BUFFER,
            f"a file read fills a numpy buffer, not a tensor on "
            f"{buf.device} (read into numpy, then copy it to the device)")
    arr = np.asarray(buf)
    if datatype is None:
        datatype = dt_mod.from_numpy_dtype(arr.dtype)
    if count is None:
        count = arr.size
    conv = Convertor(arr, datatype, count)
    return conv, conv.packed_size
