"""Instance state — the MPI-4 session and init engine.

Reference: ompi/instance/instance.c (ompi_mpi_instance_init_common:360)
and the JAX package's ``ompi_tpu.runtime.state``. The instance brings up
the rte, the accelerator, the device plane and the pml (ob1 over its
btls; ompi_tpu/runtime/state.py:97-99). The message-logging layer
(``pml/v``, ``--mca pml_v 1``) wraps the selected pml, and the monitoring
plane wraps what is there then, before any traffic flows (:101-116).

The instance is reference counted (:179-190, ompi_mpi_instance_retain /
release): :func:`init` (the world model, COMM_WORLD and COMM_SELF) and
each :class:`Session` acquire it; :func:`finalize` and
``Session.finalize`` release it, and the last release tears it down:
a last fence, then the monitoring plane (with its Finalize-time dump),
the pml and its transports, every framework's components
(``core/registry.close_all``) and the device plane. A later
``Session_init`` brings a fresh instance up; a second Init still raises
(MPI's once-only world model). The hooks (``core/hook``) run at the end
of Init and at the start of Finalize (:297-302, :331-333). The streaming
ingest plane (``ingest_enable`` / ``OMPI_TPU_INGEST``) comes up right
after the accelerator (:77-87) and goes down before the pml (:257-263);
the ULFM failure detector (``--mca ft 1``) starts once COMM_WORLD exists
(:293-296) and stops at Finalize after the world's comms are freed
(:334-346). Under ``ft`` the last fence is released by the failed ranks
of the world (the store's dead-release) and a ProcFailedError it raises
is taken as the fence's answer.

The observability planes come up where the reference's do: the prof
ledger (``prof_enable`` / ``OMPI_TPU_PROF``) before the accelerator, so
the first upload is attributed (:60-65); the trace recorder
(``trace_enable`` / ``OMPI_TPU_TRACE``) after the interposition layers,
with its clock synced through the store (:135-140); the telemetry plane
(``telemetry_enable`` / ``OMPI_TPU_TELEMETRY``) after it, so a hang dump
can flush the span ring (:156). The teardown runs in the ledger's
``teardown`` phase and stops telemetry's threads first, before the
monitoring plane and the transports (:200-202, :221). The tune
observatory (``tune_observe`` / ``OMPI_TPU_TUNE``) comes up after the
monitoring plane, with the SIGUSR1 message-queue dump
(``mpir_dump_on_signal``) beside it (:117-129); the skew plane
(``skew_level`` / ``OMPI_TPU_SKEW``) after telemetry (:155-160); at
teardown both stop after telemetry, skew first, while the store is up
(:220-237). None of them may sink init: a failure is logged and init
goes on. The check plane attaches in its own slice (ROADMAP item 10c).
"""

from __future__ import annotations

import atexit
import threading

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import hook, output, registry
from ompi_tpu_torch.runtime import rte

_lock = threading.RLock()
_initialized = False
_finalized = False
_instance_up = False
_instance_users = 0
_atexit_registered = False
_world = None
_self_comm = None
_out = output.stream("runtime")


def is_initialized() -> bool:
    return _initialized


def is_finalized() -> bool:
    return _finalized


def init_instance() -> None:
    """Bring the instance up, once until its last release: rte, then the
    accelerator, then the device plane (collective over the world; raises
    MPIError(ERR_INTERN) on every rank when any rank cannot bring its
    device up), then the pml (collective: btl/sm fences while it maps its
    rings). Init and Session_init both come here, so a session-only
    process binds its card exactly as Init does."""
    global _instance_up, _atexit_registered
    with _lock:
        if _instance_up:
            return
        rte.init()
        _out.verbose(2, "rte up: rank %d/%d job %s",
                     rte.rank, rte.size, rte.jobid)
        # the attribution ledger before the accelerator and the device
        # plane, so their first uploads and kernel loads are attributed
        from ompi_tpu_torch import prof

        if prof.requested():
            prof.enable(rank=rte.rank)
        from ompi_tpu_torch import accelerator

        accelerator.current()
        # the streaming ingest plane: after accelerator selection, so its
        # upload streams and staging ring bind to the selected component
        from ompi_tpu_torch import ingest

        if ingest.requested():
            try:
                ingest.start(rank=rte.rank)
            except Exception as exc:  # noqa: BLE001 — ingest never sinks init
                _out.verbose(0, "ingest enable failed: %r", exc)
        from ompi_tpu_torch.runtime import device_plane

        if device_plane.requested():
            device_plane.init_plane()
        from ompi_tpu_torch import pml

        pml.select()
        # interposition layers stack over the selected pml before any
        # traffic flows: message logging first, then the monitoring plane
        # over it
        from ompi_tpu_torch.pml import vprotocol

        if vprotocol._enable_var.get():
            vprotocol.install()
        # the traffic-monitoring plane (monitoring_level,
        # OMPI_TPU_MONITORING, the deprecated pml_monitoring): matrices and
        # the pml interposition, before any traffic flows
        from ompi_tpu_torch import monitoring

        if monitoring.requested():
            monitoring.start(rank=rte.rank, nranks=rte.size)
        # the collective performance observatory (tune_observe,
        # OMPI_TPU_TUNE): the PerfDB baseline loaded and the OBSERVER
        # guard raised before any collective dispatches
        from ompi_tpu_torch import tune

        if tune.requested():
            try:
                tune.start(rank=rte.rank, nranks=rte.size)
            except Exception as exc:  # noqa: BLE001 — never sinks init
                _out.verbose(0, "tune enable failed: %r", exc)
        # the debugger hook: SIGUSR1 dumps the match queues (MPIR analog,
        # mpir_dump_on_signal)
        from ompi_tpu_torch.tools import msgq

        msgq.install_signal_dump()
        # the span recorder before any traffic flows, its clock synced
        # through the store (collective: the knob is job-uniform) so the
        # ranks' timelines share rank 0's timebase
        from ompi_tpu_torch.trace import recorder as _trace_rec

        if _trace_rec.requested():
            try:
                _trace_rec.enable(rank=rte.rank)
                _trace_rec.sync_clock()
            except Exception as exc:  # noqa: BLE001 — never sinks init
                _out.verbose(0, "trace enable failed: %r", exc)
        # flight recorder, sampler and watchdog, after tracing so a hang
        # dump can flush the span ring
        from ompi_tpu_torch import telemetry

        if telemetry.requested():
            try:
                telemetry.start(rank=rte.rank)
            except Exception as exc:  # noqa: BLE001 — never sinks init
                _out.verbose(0, "telemetry enable failed: %r", exc)
        # the skew plane (skew_level, OMPI_TPU_SKEW): the completed-
        # collective ring and its store clock sync ride the flight
        # recorder's entry / exit, so after telemetry (start() enables
        # the flight recorder itself when telemetry is off)
        from ompi_tpu_torch import skew

        if skew.requested():
            try:
                skew.start(rank=rte.rank, nranks=rte.size)
            except Exception as exc:  # noqa: BLE001 — never sinks init
                _out.verbose(0, "skew enable failed: %r", exc)
        _instance_up = True
        if not _atexit_registered:
            atexit.register(_atexit_finalize)
            _atexit_registered = True


def _acquire() -> None:
    """One more instance user (the world model, or a Session)."""
    global _instance_users
    with _lock:
        init_instance()
        _instance_users += 1


def _release() -> None:
    """One user fewer; the last one tears the instance down: a last fence
    so no rank tears down while a peer still reads, then the monitoring
    plane, the pml and its transports, the frameworks' components and the
    device plane."""
    global _instance_users, _instance_up
    with _lock:
        _instance_users = max(0, _instance_users - 1)
        if _instance_users > 0 or not _instance_up:
            return
        _instance_up = False
        from ompi_tpu_torch.prof import ledger

        with ledger.phase("teardown"):
            _teardown()


def _teardown() -> None:
    """The last release's work: the fence, then telemetry's threads
    (a watchdog sweeping or a sampler publishing against a store the
    teardown is about to close would log spurious failures), the
    monitoring plane (its dump), ingest, the pml, the components and
    the device plane."""
    try:
        rte.fence("finalize", timeout=30.0)
    except errors.ProcFailedError:
        pass  # failed ranks of the world released the fence (ft)
    finally:
        from ompi_tpu_torch import (ingest, monitoring, pml, skew, telemetry,
                                    tune)
        from ompi_tpu_torch.runtime import device_plane

        try:
            telemetry.stop()
        except Exception:  # noqa: BLE001 — a dead store must not stop this
            pass
        # the skew rings merge while the store is up, after telemetry
        # (the flight recorder is down, so the ring has settled); then
        # the observatory's cross-rank merge and rank 0's PerfDB fold
        # (after the watchdog's last sweep, which may read its verdicts)
        for plane in (skew, tune):
            try:
                plane.stop()
            except Exception:  # noqa: BLE001 — teardown goes on
                pass
        try:  # the matrices' dump, before the pml dies
            monitoring.stop()
        finally:
            try:
                # cancels a tail upload, joins the upload threads,
                # drops the pinned staging ring
                ingest.stop()
            finally:
                pml.finalize()
                registry.close_all()
                device_plane.shutdown()


def init(thread_level: int = 0):
    """Bring up the world model; returns COMM_WORLD. A consumer of the
    instance (:func:`init_instance`), as ompi_mpi_init.c:359 is of
    instance.c:822. ``thread_level`` is taken as the reference takes it:
    the library is MPI_THREAD_MULTIPLE whatever is asked (MPI_INFO_ENV's
    ``thread_level``)."""
    global _initialized, _world, _self_comm
    with _lock:
        if _finalized:
            raise RuntimeError("init after finalize (MPI semantics)")
        if _initialized:
            return _world
        _acquire()
        from ompi_tpu_torch.comm import build_world

        _world, _self_comm = build_world()
        # the ULFM detector (--mca ft 1), once comms exist for its
        # progress callback to resolve
        from ompi_tpu_torch.ft import detector as _ft_detector

        if _ft_detector.enabled() and rte.size > 1:
            _ft_detector.start()
        # init hooks last: the comms and transports are up
        hook.run_init(_world)
        _initialized = True
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
    """MPI_Finalize: release COMM_WORLD's and COMM_SELF's device arenas
    (collective), then the world model's instance reference (an open
    Session keeps the instance up)."""
    global _finalized, _initialized, _world, _self_comm
    with _lock:
        if _finalized or not _initialized:
            _finalized = True
            return
        # the world model finalizes once, whatever sessions are open: a
        # later Init raises even while a session keeps the instance up
        _finalized = True
        hook.run_finalize()
        from ompi_tpu_torch.ft import detector as _ft_detector

        try:
            for c in (_world, _self_comm):
                c.free()
        finally:
            _ft_detector.stop()
            _initialized = False
            _world = None
            _self_comm = None
            _release()


def _atexit_finalize() -> None:
    try:
        for s in list(_open_sessions):  # in the order they were opened
            s.finalize()
        if _initialized and not _finalized:
            finalize()
    except Exception:  # noqa: BLE001 — interpreter teardown
        pass


#: the open sessions, in the order they were opened (the same on every
#: rank, so their collective finalizes pair up at exit)
_open_sessions: list = []


class Session:
    """MPI-4 session (reference: ompi/instance/instance.c:360,822 and
    ompi/mpi/c/session_init.c): a handle on the shared instance with no
    world model. Process sets are queried by name and turned into groups,
    and comms are built from groups with the store-brokered
    ``comm_create_from_group``; COMM_WORLD is never built.

    Process sets: ``mpi://WORLD``, ``mpi://SELF`` (mandatory in MPI-4) and
    ``ompi_tpu://HOST`` (this node's ranks, the PMIx host pset analog).
    The comms built from a session's groups are freed (collectively) by
    :meth:`finalize`, before the instance reference goes, so the last
    session's finalize leaves no device arena behind."""

    PSET_WORLD = "mpi://WORLD"
    PSET_SELF = "mpi://SELF"
    PSET_HOST = "ompi_tpu://HOST"

    def __init__(self, info=None) -> None:
        from ompi_tpu_torch.info import apply_memkinds, as_info

        _acquire()
        # MPI_Session_init takes an Info; a mpi_memory_alloc_kinds request
        # is answered with the granted subset (info_memkind.c)
        self.info = apply_memkinds(as_info(info))
        self._open = True
        self._comms: list = []
        _open_sessions.append(self)

    def get_info(self):
        """MPI_Session_get_info (a new Info)."""
        return self.info.dup()

    # -- process sets (MPI_Session_get_num_psets / get_nth_pset) ---------
    def num_psets(self) -> int:
        return len(self.psets())

    def psets(self):
        return [self.PSET_WORLD, self.PSET_SELF, self.PSET_HOST]

    def get_nth_pset(self, n: int) -> str:
        return self.psets()[n]

    def pset_info(self, name: str) -> dict:
        """MPI_Session_get_pset_info: ``mpi_size`` at least."""
        return {"mpi_size": len(self.group_from_pset(name).ranks)}

    def _check_open(self) -> None:
        if not self._open:
            raise RuntimeError("session finalized")

    def group_from_pset(self, name: str):
        """MPI_Group_from_session_pset: the group from the rte's view, no
        communicator needed. The group (and every group derived from it)
        remembers this session."""
        self._check_open()
        from ompi_tpu_torch.comm import Group

        if name == self.PSET_WORLD:
            ranks = rte.world_ranks()
        elif name == self.PSET_SELF:
            ranks = [rte.rank]
        elif name == self.PSET_HOST:
            ranks = _host_ranks()
        else:
            raise KeyError(f"unknown process set {name!r}")
        return Group(ranks, session=self)

    def comm_from_group(self, group, tag: str = "org.ompi_tpu.default"):
        """MPI_Comm_create_from_group through the session."""
        self._check_open()
        from ompi_tpu_torch.comm import comm_create_from_group

        c = comm_create_from_group(group, tag)
        if c is not None:
            self._comms.append(c)
        return c

    def finalize(self) -> None:
        """MPI_Session_finalize: free this session's comms (in cid order,
        collective over each), then drop its instance reference; the last
        reference tears the instance down."""
        if not self._open:
            return
        self._open = False
        _open_sessions.remove(self)
        comms, self._comms = self._comms, []
        try:
            for c in sorted(comms, key=lambda c: c.cid):
                c.free()
        finally:
            _release()


def comm_from_group(group, tag: str = "org.ompi_tpu.default"):
    """MPI_Comm_create_from_group: through the group's session where it
    has one (which then frees the comm at its finalize)."""
    session = getattr(group, "session", None)
    if session is not None:
        return session.comm_from_group(group, tag)
    from ompi_tpu_torch.comm import comm_create_from_group

    return comm_create_from_group(group, tag)


_host_ranks_cache = None


def _host_ranks():
    """The world ranks on this node (the host pset): one hostname exchange
    through the store, kept for the process's life."""
    global _host_ranks_cache
    if _host_ranks_cache is None:
        me = rte.hostname()
        rte.modex_send("pset_host", me)
        _host_ranks_cache = [w for w in rte.world_ranks()
                             if rte.modex_recv("pset_host", w) == me]
    return _host_ranks_cache


def abort(code: int = 1, reason: str = "MPI_Abort") -> None:
    """MPI_Abort through the runtime (``rte.abort``): never returns."""
    rte.abort(reason, code)
