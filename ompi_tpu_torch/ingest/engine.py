"""Streaming ingest engine — pipelined, partially available H2D upload.

The port's copy of ``ompi_tpu.ingest.engine``. Three mechanisms:

1. **Multi-stream, double-buffered upload.** The
   :class:`~ompi_tpu_torch.ingest.plan.IngestPlan` cuts the pytree into
   units of at most ``ingest_chunk_bytes``, round-robin over
   ``ingest_streams`` upload streams (the accelerator's ``h2d_streams``
   pool), each driven by a thread of its own. A stream packs its units
   into a ring of ``ingest_depth`` staging slots (pinned host memory from
   the accelerator's ``host_buffer``, allocated once per engine, never
   per chunk) and puts each one with the accelerator's ``put_chunk``
   into its slice of the upload's one device buffer (on the card:
   ``copy_(non_blocking=True)`` on the stream, then an event). A slot is
   packed again only after the event of the copy that last read it has
   completed, so at most ``depth`` copies per stream read host memory at
   a time.

2. **Compile / upload overlap.** :meth:`IngestEngine.overlap_compile`
   runs a function on a thread of its own while the uploads stream. The
   port's compile is the first-use build and load of its kernel
   libraries (``coll/cuda_kernels.lib()``, the osc library), which is
   what a caller overlaps; ``ingest_compile_overlaps`` counts the runs
   that began and ended with an upload in flight.

3. **``Pready``-style partial availability.** The returned
   :class:`IngestRequest` is a :class:`~ompi_tpu_torch.part.partial.
   PartialAvailability`: ``Parrived(i)`` probes one unit, ``gate(keys)``
   blocks only on the leaves the first step touches (counting
   ``ingest_early_starts`` when it releases while the tail still
   uploads), and ``leaf()`` / ``tree()`` assemble device tensors bitwise
   equal to a one-shot copy.

On the card the upload's device buffer (every leaf at an aligned offset,
so a leaf is a view of it and assembly copies nothing) is allocated on
the caller's current stream; each upload stream first waits for that
stream (a block the allocator hands out again may still be read by work
queued there) and the buffer is ``record_stream``-ed on each, so it is
not given out again while a copy into it is in flight. Before
``gate()``, ``leaf()`` or ``tree()`` hands a leaf over, the caller's
current stream waits on the events of the leaf's units. Upload threads
set their device explicitly: the current device is thread-local.

The module global ``INGEST`` is the plane's one-branch guard, brought up
by ``runtime.state.init_instance`` when ``ingest_enable`` /
``OMPI_TPU_INGEST`` asks for it and torn down (uploads cancelled, threads
joined, staging dropped) at the instance's release. The prof ledger's
``staging`` and ``compile`` phases and its ``xfer`` spans come with
ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import cvar, output, pvar
from ompi_tpu_torch.ingest.plan import IngestPlan
from ompi_tpu_torch.part import partial as _partial

_out = output.stream("ingest")

_enable_var = cvar.register(
    "ingest_enable", False, bool,
    help="Bring the streaming ingest plane up at instance init: "
         "multi-stream double-buffered H2D upload + compile overlap "
         "+ Parrived-gated first step (equivalently: any truthy "
         "OMPI_TPU_INGEST env value).",
    level=4)
_streams_var = cvar.register(
    "ingest_streams", 4, int,
    help="Concurrent H2D upload streams the ingest engine drives "
         "(the accelerator component's stream pool).", level=5)
_chunk_var = cvar.register(
    "ingest_chunk_bytes", 4 << 20, int,
    help="Upload unit ceiling: each pytree leaf is cut into units of "
         "at most this many bytes (the Parrived granularity).",
    level=5)
_depth_var = cvar.register(
    "ingest_depth", 2, int,
    help="Staging buffers per upload stream (2 = classic double "
         "buffering: pack unit k+1 while unit k's put is in flight).",
    level=7)

#: the plane's one-branch guard: ``if engine.INGEST is not None: ...``
INGEST: Optional["IngestEngine"] = None


def default_device() -> torch.device:
    """Where an upload lands when the caller names no device: the device
    plane's card, else the current CUDA device when the cuda accelerator
    is selected, else the CPU."""
    from ompi_tpu_torch import accelerator
    from ompi_tpu_torch.runtime import device_plane

    if device_plane.active():
        return device_plane.device()
    if accelerator.current().NAME == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def default_put(view: np.ndarray, dst: torch.Tensor, h2d=None):
    """One put of a staged flat view into ``dst`` (its slice of the
    upload's device buffer): the accelerator's ``put_chunk`` for
    ``dst``'s device. Module-level so tests can wrap it with a slow or
    failing device."""
    from ompi_tpu_torch import accelerator

    return accelerator.for_device(dst.device).put_chunk(view, dst, h2d)


_TORCH_DTYPES: Dict[Any, torch.dtype] = {}


def _torch_dtype(npdt) -> torch.dtype:
    """The torch dtype of a numpy dtype (the staged leaf's)."""
    got = _TORCH_DTYPES.get(npdt)
    if got is None:
        got = _TORCH_DTYPES[npdt] = torch.from_numpy(
            np.empty(0, npdt)).dtype
    return got


def _settle(chunk) -> None:
    """Block until a put has landed (its staging slot is reusable)."""
    fn = getattr(chunk, "wait", None) or getattr(
        chunk, "block_until_ready", None)
    if fn is not None:
        fn()


class _Job:
    """A function submitted to a :class:`_Lane`: ``wait`` returns its
    result or raises what it raised."""

    def __init__(self, fn: Callable[[], Any]) -> None:
        self.fn = fn
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._result = self.fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised at wait
            self._exc = exc
        finally:
            self._done.set()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise errors.MPIError(errors.ERR_PENDING,
                                  f"ingest job not done after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Lane:
    """One thread running submitted jobs in order (an upload stream's
    host side, or the compile lane)."""

    def __init__(self, name: str) -> None:
        self._q: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self.thread = threading.Thread(target=self._loop, name=name,
                                       daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            job.run()

    def submit(self, fn: Callable[[], Any]) -> _Job:
        job = _Job(fn)
        self._q.put(job)
        return job

    def destroy(self) -> None:
        self._q.put(None)
        self.thread.join(30)


class IngestRequest(_partial.PartialAvailability):
    """Handle on one streamed upload (the partitioned receive's analog:
    units arrive independently; probe with ``Parrived``, gate the first
    step with :meth:`gate`, assemble with :meth:`leaf` / :meth:`tree`,
    drain with :meth:`wait`)."""

    _PARRIVED_PVAR = "ingest_parrived"

    def __init__(self, engine: "IngestEngine", plan: IngestPlan,
                 device=None) -> None:
        self._engine = engine
        self.plan = plan
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.n_units = plan.n_units
        self._events = [threading.Event() for _ in range(plan.n_units)]
        self._chunks: List[Any] = [None] * plan.n_units
        self._done_ns = [0] * plan.n_units
        self._dev_leaves: Dict[int, Any] = {}
        #: the upload's device buffer (uint8): every leaf at its plan
        #: offset
        self._flat: Optional[torch.Tensor] = None
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._started = False
        self._pending = plan.n_units
        self._all_done = threading.Event()
        self._streams_left = 0
        #: deepest per-stream queue of puts in flight (at most depth)
        self.inflight_hwm = 0
        #: ``monotonic_ns`` time the upload started (0: not started)
        self.started_ns = 0
        if plan.n_units == 0:
            self._all_done.set()

    # -- PartialAvailability hooks ----------------------------------------
    @property
    def completed(self) -> bool:
        """Every unit landed (a cancelled or failed upload never reads
        complete: its error surfaces at the next probe, gate or wait)."""
        return (self._all_done.is_set() and self._error is None
                and not self._cancelled)

    def _partial_started(self) -> bool:
        return self._started

    def _partial_probe(self, idx: int) -> bool:
        if not 0 <= idx < self.n_units:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"Parrived({idx}): unit index out of [0,{self.n_units})")
        if not self._events[idx].is_set():
            return False
        if self._chunks[idx] is None and self.plan.units[idx].nbytes:
            self._raise()
        return True

    # -- completion -------------------------------------------------------
    def test(self) -> bool:
        """Nonblocking: every unit resolved (landed or voided)."""
        return self._all_done.is_set()

    def wait(self, timeout: Optional[float] = None) -> "IngestRequest":
        """Drain the whole upload; raises the recorded MPIError of a
        failed or cancelled upload."""
        if not self._all_done.wait(timeout):
            raise errors.MPIError(
                errors.ERR_PENDING,
                f"ingest wait timed out after {timeout}s with "
                f"{self._pending}/{self.n_units} units outstanding")
        if self._error is not None or self._cancelled:
            self._raise()
        return self

    def gate(self, keys=None,
             timeout: Optional[float] = None) -> "IngestRequest":
        """Block until the leaves the first step touches are resident (all
        of them when ``keys`` is None), and order the caller's current
        stream after their copies. When it releases while the tail still
        uploads, the step starts early: ``ingest_early_starts``."""
        t0 = time.monotonic_ns()
        units = self.plan.units if keys is None \
            else self.plan.units_for(keys)
        for u in units:
            if not self._events[u.idx].wait(timeout):
                raise errors.MPIError(
                    errors.ERR_PENDING,
                    f"ingest gate timed out on unit {u.idx} "
                    f"(leaf {u.leaf})")
            if self._chunks[u.idx] is None and u.nbytes:
                self._raise()
        self._hand_over(units)
        pvar.record("ingest_gate_ns", time.monotonic_ns() - t0)
        if not self._all_done.is_set():
            pvar.record("ingest_early_starts")
        return self

    def unit_done_ns(self, idx: int) -> int:
        """The ``monotonic_ns`` time unit ``idx`` landed (0: not yet)."""
        return self._done_ns[idx]

    def cancel(self) -> None:
        """Abandon the upload: the threads stop at the next unit, the
        units not landed resolve void, and every later probe, gate or
        wait raises MPIError (the staging ring stays with the engine)."""
        self._cancelled = True

    # -- assembly ---------------------------------------------------------
    def leaf(self, key):
        """The device tensor of one leaf (blocks on that leaf's units
        only): a view of the upload's buffer, bitwise the one-shot copy
        of the leaf."""
        li = self.plan.leaf_index(key)
        with self._lock:
            got = self._dev_leaves.get(li)
        if got is not None:
            return got
        units = self.plan.leaf_units[li]
        for u in units:
            self._events[u.idx].wait()
            if self._chunks[u.idx] is None and u.nbytes:
                self._raise()
        if self._cancelled or self._error is not None:
            self._raise()
        self._hand_over(units)
        arr = self.plan.leaves[li]
        tdt = self.plan.leaf_dtypes[li] or _torch_dtype(arr.dtype)
        if arr.nbytes == 0:  # torch cannot re-view an empty tensor
            dev = torch.empty(arr.shape, dtype=tdt, device=self.device)
        else:
            off = self.plan.offsets[li]
            dev = self._flat[off:off + arr.nbytes].view(
                _torch_dtype(arr.dtype)).view(tdt).reshape(arr.shape)
        with self._lock:
            return self._dev_leaves.setdefault(li, dev)

    def tree(self):
        """The whole pytree on the device (blocks until it has landed),
        unflattened with the plan's treedef."""
        self.wait()
        leaves = [self.leaf(i) for i in range(len(self.plan.leaves))]
        td = self.plan.treedef
        if td is None:
            return leaves
        from ompi_tpu_torch.zero import layout as _layout

        return _layout.tree_unflatten(td, leaves)

    # -- internals ----------------------------------------------------------
    def _hand_over(self, units) -> None:
        """Order the caller's current stream after the units' copies, and
        tie the buffer's memory to that stream (CUDA only)."""
        if self.device.type != "cuda":
            return
        cur = torch.cuda.current_stream(self.device)
        for u in units:
            up = self._chunks[u.idx]
            wait_on = getattr(up, "wait_on", None)
            if wait_on is not None:
                wait_on(cur)
        if self._flat is not None:
            self._flat.record_stream(cur)

    def _raise(self):
        err = self._error
        if isinstance(err, errors.MPIError):
            raise err
        if err is not None:
            raise errors.MPIError(
                errors.ERR_INTERN, f"ingest upload failed: {err!r}")
        raise errors.MPIError(errors.ERR_REQUEST,
                              "ingest upload cancelled")

    def _resolve(self, idx: int, chunk=None, t_ns: int = 0) -> None:
        with self._lock:
            if self._events[idx].is_set():
                return
            self._chunks[idx] = chunk
            self._done_ns[idx] = t_ns
            self._events[idx].set()
            self._pending -= 1
            if self._pending == 0:
                self._all_done.set()

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc


class IngestEngine:
    """The process-wide upload pipeline: upload streams and their
    threads, the staging rings, the compile lane. One engine serves many
    uploads; the rings are the engine's and reused (a stream's thread
    runs its drains in order, so sharing its ring is safe)."""

    def __init__(self, rank: int = 0, streams: Optional[int] = None,
                 chunk_bytes: Optional[int] = None,
                 depth: Optional[int] = None,
                 put: Optional[Callable] = None) -> None:
        self.rank = rank
        self.n_streams = max(1, int(
            _streams_var.get() if streams is None else streams))
        self.chunk_bytes = max(1, int(
            _chunk_var.get() if chunk_bytes is None else chunk_bytes))
        self.depth = max(1, int(
            _depth_var.get() if depth is None else depth))
        #: an injectable put (tests wrap default_put); None: default_put
        self._put = put
        self._lock = threading.Lock()
        self._device: Optional[torch.device] = None
        self._streams: Optional[list] = None
        self._lanes: Optional[List[_Lane]] = None
        self._compile_lane: Optional[_Lane] = None
        self._bufs: Optional[list] = None
        self._buf_tensors: List[torch.Tensor] = []
        self._buf_bytes = 0
        self._active: List[IngestRequest] = []
        self._closed = False

    # -- upload -----------------------------------------------------------
    def upload(self, tree, device=None) -> IngestRequest:
        """Start the streamed upload of a pytree of host leaves; returns
        the partially available request at once."""
        if self._closed:
            raise errors.MPIError(
                errors.ERR_OTHER,
                "ingest engine closed — no uploads after teardown")
        dev = default_device() if device is None else torch.device(device)
        plan = IngestPlan.from_tree(tree, self.chunk_bytes,
                                    self.n_streams)
        req = IngestRequest(self, plan, device=dev)
        req._started = True
        req.started_ns = time.monotonic_ns()
        pvar.record("ingest_uploads")
        if plan.n_units == 0:
            return req
        streams, lanes = self._ensure_streams(dev)
        bufs = self._ensure_bufs(plan.max_unit_bytes, dev)
        req._flat = torch.empty(plan.buffer_bytes, dtype=torch.uint8,
                                device=dev)
        if dev.type == "cuda":
            cur = torch.cuda.current_stream(dev)
            for st in streams:
                st.wait_stream(cur)
                req._flat.record_stream(st)
        per_stream = [plan.stream_units(s) for s in range(self.n_streams)]
        req._streams_left = sum(1 for u in per_stream if u)
        with self._lock:
            self._active.append(req)
        for s, units in enumerate(per_stream):
            if units:
                lanes[s].submit(self._make_drain(req, s, units, bufs[s],
                                                 streams[s]))
        return req

    def upload_and_compile(self, tree, compile_fn: Callable, device=None):
        """The pipelined cold start: start the upload, then run
        ``compile_fn`` beside it. Returns ``(request, compile job)``."""
        req = self.upload(tree, device=device)
        return req, self.overlap_compile(compile_fn)

    def overlap_compile(self, fn: Callable, *args, **kwargs) -> _Job:
        """Run ``fn`` on the compile lane, beside any upload in flight;
        returns the job (``wait(timeout)`` gives its result)."""
        if self._closed:
            raise errors.MPIError(errors.ERR_OTHER, "ingest engine closed")
        with self._lock:
            if self._compile_lane is None:
                self._compile_lane = _Lane("ompi-tpu-torch-ingest-compile")
            lane = self._compile_lane

        def job():
            live_before = bool(self._live_uploads())
            out = fn(*args, **kwargs)
            if live_before and self._live_uploads():
                # the compile ran start to end with an upload in flight
                pvar.record("ingest_compile_overlaps")
            return out

        return lane.submit(job)

    def inflight(self) -> int:
        """Uploads with a stream still draining (0 after a clean
        teardown)."""
        with self._lock:
            return len(self._active)

    def close(self) -> None:
        """Teardown: cancel the live uploads, let their threads stop,
        join every engine thread, drop the staging rings."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            active = list(self._active)
        for r in active:
            r.cancel()
        for r in active:
            r._all_done.wait(30)
        for lane in (self._lanes or []) + (
                [self._compile_lane] if self._compile_lane else []):
            lane.destroy()
        with self._lock:
            self._bufs = None
            self._buf_tensors = []
            self._streams = None
            self._lanes = None
            self._compile_lane = None
            self._active = []

    def threads(self) -> List[threading.Thread]:
        """The engine's live threads (none after :meth:`close`)."""
        lanes = (self._lanes or []) + (
            [self._compile_lane] if self._compile_lane else [])
        return [ln.thread for ln in lanes if ln.thread.is_alive()]

    # -- internals ----------------------------------------------------------
    def _ensure_streams(self, dev: torch.device):
        with self._lock:
            if self._streams is None or self._device != dev:
                from ompi_tpu_torch import accelerator

                self._streams = accelerator.for_device(dev).h2d_streams(
                    self.n_streams, dev)
                self._device = dev
            if self._lanes is None:
                self._lanes = [_Lane(f"ompi-tpu-torch-ingest-h2d-{i}")
                               for i in range(self.n_streams)]
            return self._streams, self._lanes

    def _ensure_bufs(self, need_bytes: int, dev: torch.device) -> list:
        from ompi_tpu_torch import accelerator

        with self._lock:
            need = max(int(need_bytes), 1)
            if self._bufs is not None and self._buf_bytes >= need:
                return self._bufs
            # pinned on the card (host_buffer), kept for every later
            # upload whose units fit
            acc = accelerator.for_device(dev)
            self._buf_tensors = [acc.host_buffer(need, dev)
                                 for _ in range(self.n_streams * self.depth)]
            arrs = [t.numpy() for t in self._buf_tensors]
            self._bufs = [arrs[s * self.depth:(s + 1) * self.depth]
                          for s in range(self.n_streams)]
            self._buf_bytes = need
            return self._bufs

    def _live_uploads(self) -> List[IngestRequest]:
        with self._lock:
            return [r for r in self._active if not r._all_done.is_set()]

    def _stream_idle(self, req: IngestRequest) -> None:
        with self._lock:
            req._streams_left -= 1
            if req._streams_left <= 0:
                try:
                    self._active.remove(req)
                except ValueError:
                    pass

    def _make_drain(self, req: IngestRequest, s: int, units: list,
                    ring: list, h2d) -> Callable[[], None]:
        def drain() -> None:
            put = self._put or default_put
            dev = req.device
            flat = req._flat
            #: (unit, put, ring slot), in submission order
            inflight: collections.deque = collections.deque()

            def retire(entry) -> None:
                u, up, _slot = entry
                _settle(up)
                req._resolve(u.idx, chunk=up, t_ns=time.monotonic_ns())
                pvar.record("ingest_units")
                pvar.record("ingest_bytes", u.nbytes)

            def loop() -> None:
                for k, u in enumerate(units):
                    if req._cancelled or req._error is not None:
                        break
                    slot = k % self.depth
                    # a slot is packed again only once the put that last
                    # read it has landed (and never more than depth puts
                    # in flight on this stream)
                    while inflight and (inflight[0][2] == slot
                                        or len(inflight) >= self.depth):
                        retire(inflight.popleft())
                    src = req.plan.leaves[u.leaf].reshape(-1)
                    view = ring[slot][:u.nbytes].view(src.dtype)[
                        :u.hi - u.lo]
                    np.copyto(view, src[u.lo:u.hi])
                    tdt = _torch_dtype(src.dtype)
                    if u.nbytes:
                        a = req.plan.offsets[u.leaf] + u.lo * src.itemsize
                        dst = flat[a:a + u.nbytes].view(tdt)
                    else:
                        dst = torch.empty(0, dtype=tdt, device=dev)
                    inflight.append((u, put(view, dst, h2d), slot))
                    if len(inflight) > req.inflight_hwm:
                        req.inflight_hwm = len(inflight)
                    pvar.record_hwm("ingest_inflight", len(inflight))
                while inflight:
                    retire(inflight.popleft())

            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        loop()
                else:
                    loop()
            except BaseException as exc:  # noqa: BLE001 — raised at wait
                req._fail(exc)
                _out.verbose(1, "ingest stream %d failed: %r", s, exc)
                # the puts still in flight read the ring: let them land
                # before the slots can be packed again
                for _u, up, _slot in inflight:
                    try:
                        _settle(up)
                    except BaseException:  # noqa: BLE001
                        pass
            finally:
                voided = 0
                for u in units:
                    if not req._events[u.idx].is_set():
                        req._resolve(u.idx)
                        voided += 1
                if voided:
                    pvar.record("ingest_cancelled", voided)
                self._stream_idle(req)

        return drain


def upload_for_restore(tree, keys=None, engine=None):
    """Checkpoint-restore gating: stream a restored host pytree up through
    the ingest plane so the first step gates on its own leaves
    (``gate(keys)``, default the first leaf) instead of the whole state.
    Returns the gated :class:`IngestRequest`; with no engine up it is the
    identity (the host tree comes back and the caller goes on
    synchronously)."""
    eng = engine if engine is not None else INGEST
    if eng is None:
        return tree
    req = eng.upload(tree)
    if req.n_units:
        req.gate(keys=[0] if keys is None else keys)
    return req


# -- plane lifecycle (runtime/state) ----------------------------------------

def requested() -> bool:
    """cvar ingest_enable (the OMPI_TPU_INGEST_ENABLE env too) or the
    short OMPI_TPU_INGEST env knob."""
    if _enable_var.get():
        return True
    raw = os.environ.get("OMPI_TPU_INGEST", "").strip().lower()
    return raw not in ("", "0", "false", "no", "off")


def enable(rank: Optional[int] = None) -> IngestEngine:
    """Bring the plane up (idempotent)."""
    global INGEST
    if INGEST is None:
        INGEST = IngestEngine(rank=0 if rank is None else rank)
        _out.verbose(2, "ingest up: %d stream(s), %d B units, depth %d",
                     INGEST.n_streams, INGEST.chunk_bytes, INGEST.depth)
    elif rank is not None:
        INGEST.rank = rank
    return INGEST


def disable() -> Optional[IngestEngine]:
    """Tear the plane down (uploads cancelled, threads joined, staging
    dropped)."""
    global INGEST
    eng, INGEST = INGEST, None
    if eng is not None:
        eng.close()
    return eng
