"""Runtime MPI sanitizer — argument validation, request registry,
cross-rank collective signature matching.

The port's copy of ``ompi_tpu/check/sanitizer.py``. Reference: the
``MPI_PARAM_CHECK`` block every ``ompi/mpi/c/*.c`` binding opens with,
plus the MUST tool's transfer of those checks to runtime interposition. Pythonic redesign: one PMPI tool
(:func:`ompi_tpu_torch.profile.attach_tool`) interposes a pre-hook on the
whole API dispatch table, so every call on every communicator is
validated before the PML/coll layer sees it:

- **level 1** — bound checks on root/dest/source/tag/count arguments
  (``inspect.signature`` binding against the real API signatures, so
  the checks track the surface automatically), uncommitted-datatype
  and freed-communicator detection, and a request registry: every
  :class:`~ompi_tpu_torch.pml.request.Request` is tracked from birth;
  ``wait``/``start`` on a freed request raises
  ``MPIError(ERR_REQUEST)`` at the call, and Finalize reports every
  leaked request (persistent never freed, nonblocking never
  completed) through the hook framework.
- **level 2** — cross-rank collective signature matching: each
  collective entry computes a (seq, op, dtype, count-hash, comm-cid)
  fingerprint and publishes it through the kvstore — the same channel
  the telemetry heartbeat rides — then compares against every peer's
  fingerprint for the same (cid, seq). A mismatched Allreduce raises
  a named ``MPIError`` on the offending ranks immediately, instead of
  hanging until the watchdog's timeout; the mismatch is also kept in
  :attr:`Sanitizer.last_mismatch` for the watchdog's hang-dump
  (``check_mismatch`` key).

The registry tracks what the JAX package's does: every subclass of
:class:`~ompi_tpu_torch.pml.request.Request` (pml and part/ requests).
coll/device's ``DeviceRequest`` and its persistent and partitioned
requests are not subclasses in either package, so they are not tracked.
A tensor buffer fingerprints by its ``numel()`` and its dtype under
numpy's name (``float32``, ``bfloat16``), so it matches an array of the
same dtype and size. Level 2 keeps the reference's wait: a peer that
never publishes (a dead rank under ``--mca ft 1`` among them) lets the
collective go on unverified after ``check_match_timeout`` seconds, and
the collective itself then meets the failure.

Disabled (the default), nothing here exists: call sites use the
one-branch guard (``sanitizer.SANITIZER is None``) and the API table
is not interposed. pvars: ``check_violations``, ``check_leaks``,
``check_sig_exchanges``.
"""

from __future__ import annotations

import threading
import time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import cvar, output, pvar

_out = output.stream("check")

_match_timeout_var = cvar.register(
    "check_match_timeout", 10.0, float,
    help="Level-2 signature matching: seconds to wait for every "
         "peer's fingerprint for the same (comm, seq) before letting "
         "the collective proceed unverified. Matching blocks like a "
         "barrier — the documented debug cost of check_level=2.",
    level=6)

#: the one-branch disabled guard (flight.FLIGHT discipline)
SANITIZER: Optional["Sanitizer"] = None

_hook_registered = False
_request_patches: Dict[Tuple[type, str], Any] = {}

#: collective entries that participate in level-2 signature matching
SIG_OPS = (
    "Barrier", "barrier", "Bcast", "bcast", "Reduce", "reduce",
    "Allreduce", "allreduce", "Gather", "gather", "Gatherv",
    "Scatter", "scatter", "Scatterv", "Allgather", "allgather",
    "Allgatherv", "Alltoall", "alltoall", "Alltoallv",
    "Reduce_scatter", "Reduce_scatter_block", "Scan", "Exscan",
    "Allreduce_multi", "Reduce_scatter_multi", "Allgather_multi",
)

#: the subset whose leading send buffer is rank-symmetric, so its
#: dtype/count joins the fingerprint. Everything else matches on op
#: order only: object-mode collectives carry arbitrary per-rank
#: payloads (``bcast(obj if root else None)``), v-collectives carry
#: legitimately different counts per rank, and Scatter's sendbuf is
#: root-only — fingerprinting those would flag correct programs.
SIG_BUF_OPS = frozenset((
    "Bcast", "Reduce", "Allreduce", "Allgather", "Alltoall",
    "Reduce_scatter_block", "Scan", "Exscan", "Allreduce_multi",
))

_COUNT_PARAMS = ("count", "counts", "scounts", "rcounts", "partitions")


def _crc(value: Any) -> int:
    return zlib.crc32(repr(value).encode()) & 0xFFFFFFFF


def _buf_signature(args: tuple) -> Tuple[str, int]:
    """(dtype, count-hash) of a call's leading buffer argument —
    best-effort over ndarray / tensor buffers, buckets, and object
    forms. A tensor's ``size`` is a method: it counts its ``numel()``
    and names its dtype as numpy does."""
    if not args:
        return ("none", 0)
    buf = args[0]
    if isinstance(buf, torch.Tensor):
        return (str(buf.dtype).replace("torch.", ""), _crc(buf.numel()))
    dt = getattr(buf, "dtype", None)
    n = getattr(buf, "size", None)
    if n is None:
        try:
            n = len(buf)  # type: ignore[arg-type]
        except TypeError:
            n = 0
    try:
        n = int(n)
    except (TypeError, ValueError):
        n = 0
    return (str(dt) if dt is not None else type(buf).__name__, _crc(n))


class Sanitizer:
    """One rank's sanitizer. Every collaborator is injectable (store
    client, world ranks, jobid) so tests drive the matching protocol
    in-process without a launcher — the watchdog's test discipline."""

    def __init__(self, rank: int = 0, world=None,
                 jobid: str = "singleton", client=None, level: int = 1,
                 match_timeout: Optional[float] = None) -> None:
        self.rank = rank
        self.world = world
        self.jobid = jobid
        self.client = client
        self.level = level
        self.match_timeout = (_match_timeout_var.get()
                              if match_timeout is None
                              else float(match_timeout))
        #: most recent signature mismatch (the watchdog dump reads it)
        self.last_mismatch: Optional[Dict[str, Any]] = None
        self._seq: Dict[int, int] = {}  # comm cid -> collective seq
        self._lock = threading.Lock()
        # request registry: id -> record; weakrefs so tracking never
        # extends request lifetime
        self._requests: Dict[int, Dict[str, Any]] = {}
        self._sigs: Dict[str, Any] = {}  # API name -> Signature

    # -- level 1: argument validation ------------------------------------

    def _signature(self, name: str):
        sig = self._sigs.get(name)
        if sig is None:
            import inspect

            from ompi_tpu_torch import mpi

            fn = mpi._API.get(name)
            try:
                sig = inspect.signature(fn) if fn is not None else False
            except (TypeError, ValueError):
                sig = False
            self._sigs[name] = sig
        return sig or None

    def check_call(self, name: str, comm, args: tuple,
                   kwargs: dict) -> None:
        """MPI_PARAM_CHECK analog: validate one API entry; raises
        MPIError on a violation (before the PML sees the call)."""
        if getattr(comm, "_freed", False):
            self._violation(errors.ERR_COMM,
                            f"{name}: communicator cid "
                            f"{getattr(comm, 'cid', '?')} used after "
                            "free")
        sig = self._signature(name)
        if sig is None:
            return
        try:
            bound = sig.bind(comm, *args, **kwargs)
        except TypeError:
            return  # arity errors surface from the real call
        size = getattr(comm, "size", None)
        from ompi_tpu_torch.datatype.datatype import Datatype
        from ompi_tpu_torch.pml import request as rq

        for pname, val in bound.arguments.items():
            if pname == "root" and isinstance(val, int) \
                    and size is not None:
                if not 0 <= val < size:
                    self._violation(
                        errors.ERR_ROOT,
                        f"{name}: root {val} outside [0, {size})")
            elif pname == "dest" and isinstance(val, int) \
                    and size is not None:
                if val != rq.PROC_NULL and not 0 <= val < size:
                    self._violation(
                        errors.ERR_RANK,
                        f"{name}: dest {val} outside [0, {size})")
            elif pname == "source" and isinstance(val, int) \
                    and size is not None:
                if val not in (rq.ANY_SOURCE, rq.PROC_NULL) \
                        and not 0 <= val < size:
                    self._violation(
                        errors.ERR_RANK,
                        f"{name}: source {val} outside [0, {size})")
            elif pname == "tag" and isinstance(val, int):
                floor = rq.ANY_TAG if "ecv" in name or "robe" in name \
                    else 0
                if val < floor:
                    self._violation(
                        errors.ERR_TAG, f"{name}: tag {val} < {floor}")
            elif pname in _COUNT_PARAMS:
                counts = val if isinstance(val, (list, tuple)) \
                    else [val]
                for c in counts:
                    if isinstance(c, int) and c < 0:
                        self._violation(
                            errors.ERR_COUNT,
                            f"{name}: negative count {c} in "
                            f"'{pname}'")
            if isinstance(val, Datatype) and not val.committed:
                self._violation(
                    errors.ERR_TYPE,
                    f"{name}: datatype '{pname}' is not committed")

    def _violation(self, code: int, msg: str) -> None:
        pvar.record("check_violations")
        raise errors.MPIError(code, f"sanitizer: {msg}")

    # -- level 1: request registry ---------------------------------------

    def track(self, req, kind: str = "") -> None:
        with self._lock:
            self._requests[id(req)] = {
                "ref": weakref.ref(req),
                "kind": kind or type(req).__name__,
                "freed": False, "done": False, "waited": False,
            }

    def _rec(self, req) -> Optional[Dict[str, Any]]:
        return self._requests.get(id(req))

    def on_complete(self, req) -> None:
        rec = self._rec(req)
        if rec is not None:
            rec["done"] = True

    def on_wait(self, req) -> None:
        rec = self._rec(req)
        if rec is not None:
            if rec["freed"]:
                self._violation(
                    errors.ERR_REQUEST,
                    f"wait/test on freed request "
                    f"{getattr(req, 'id', '?')} ({rec['kind']}) — "
                    "use after free")
            rec["waited"] = True

    def on_start(self, req) -> None:
        rec = self._rec(req)
        if rec is not None and rec["freed"]:
            self._violation(
                errors.ERR_REQUEST,
                f"start on freed request {getattr(req, 'id', '?')} "
                f"({rec['kind']}) — use after free")

    def on_free(self, req) -> None:
        rec = self._rec(req)
        if rec is not None:
            rec["freed"] = True

    def leak_report(self) -> List[Dict[str, Any]]:
        """Leaked requests (called by the Finalize hook): persistent
        requests never freed, nonblocking requests never completed."""
        leaks: List[Dict[str, Any]] = []
        with self._lock:
            for rec in self._requests.values():
                req = rec["ref"]()
                if req is None:
                    continue  # collected: nothing pinned, no leak
                persistent = getattr(req, "persistent", False)
                if persistent and not rec["freed"]:
                    why = "persistent request never freed"
                elif not persistent and not rec["done"] \
                        and not rec["freed"]:
                    why = "request never completed or freed"
                else:
                    continue
                leaks.append({"id": getattr(req, "id", 0),
                              "kind": rec["kind"],
                              "waited": rec["waited"], "why": why})
        if leaks:
            pvar.record("check_leaks", len(leaks))
            _out.verbose(0, "sanitizer: %d leaked request(s) at "
                         "Finalize: %s", len(leaks),
                         ", ".join(f"#{l['id']} {l['kind']} "
                                   f"({l['why']})" for l in leaks[:8]))
        return leaks

    # -- level 2: cross-rank signature matching --------------------------

    def match_collective(self, op: str, cid: int, dtype: str,
                         count_hash: int, peers=None) -> None:
        """Publish this rank's fingerprint for the comm's next
        collective and compare every peer's; a divergent fingerprint
        raises MPIError naming op/seq/ranks on both sides."""
        if self.client is None:
            return
        with self._lock:
            seq = self._seq.get(cid, 0) + 1
            self._seq[cid] = seq
        mine = {"op": op, "seq": seq, "cid": cid, "dtype": dtype,
                "count_hash": count_hash, "rank": self.rank}
        key = f"chk:{self.jobid}:{cid}:{seq}"
        self.client.put(f"{key}:{self.rank}", mine)
        pvar.record("check_sig_exchanges")
        ranks = peers if peers is not None else self.world
        missing = {r for r in (ranks or ()) if r != self.rank}
        deadline = time.monotonic() + self.match_timeout
        while missing:
            for r in sorted(missing):
                theirs = self.client.get(f"{key}:{r}", wait=False)
                if theirs is None:
                    continue
                missing.discard(r)
                if (theirs.get("op"), theirs.get("dtype"),
                        theirs.get("count_hash")) != \
                        (op, dtype, count_hash):
                    mm = {"op": op, "seq": seq, "cid": cid,
                          "rank": self.rank, "peer": r,
                          "mine": mine, "theirs": theirs}
                    self.last_mismatch = mm
                    pvar.record("check_violations")
                    raise errors.MPIError(
                        errors.ERR_ARG,
                        f"sanitizer: collective signature mismatch "
                        f"at {op} seq {seq} (comm cid {cid}): rank "
                        f"{self.rank} calls "
                        f"{mine['op']}/{dtype}/#{count_hash:x} but "
                        f"rank {r} calls {theirs.get('op')}/"
                        f"{theirs.get('dtype')}/"
                        f"#{theirs.get('count_hash', 0):x}")
            if missing:
                if time.monotonic() >= deadline:
                    _out.verbose(1, "signature match timed out at %s "
                                 "seq %d: no fingerprint from %s",
                                 op, seq, sorted(missing))
                    return
                time.sleep(0.005)

    # -- the PMPI pre-hook -----------------------------------------------

    def pre_call(self, name: str, comm, args: tuple,
                 kwargs: dict) -> None:
        self.check_call(name, comm, args, kwargs)
        if self.level >= 2 and name in SIG_OPS:
            dtype, ch = (_buf_signature(args) if name in SIG_BUF_OPS
                         else ("any", 0))
            group = getattr(comm, "group", None)
            peers = getattr(group, "ranks", None)
            self.match_collective(name,
                                  getattr(comm, "cid", 0),
                                  dtype, ch, peers=peers)


# -- plane lifecycle -----------------------------------------------------

def enable(rank: int = 0, level: int = 1) -> None:
    """Bring the sanitizer up: build the instance, interpose the API
    pre-hook, patch request lifecycle methods, arm the Finalize leak
    report. Idempotent."""
    global SANITIZER, _hook_registered
    if SANITIZER is not None or level <= 0:
        return
    client, jobid, world = None, "singleton", None
    try:
        # dedicated store connection (the watchdog's reasoning: never
        # queue fingerprint polls behind the shared rte socket)
        from ompi_tpu_torch.runtime import kvstore, rte

        client = kvstore.Client(rte.client().addr)
        jobid = rte.jobid
        world = rte.world_ranks()
    except Exception:  # noqa: BLE001 — singleton / no store: level-2
        client = None  # matching degrades to a no-op
    san = Sanitizer(rank=rank, world=world, jobid=jobid,
                    client=client, level=level)
    san._api_handle = _install_api_hook(san)
    _install_request_tracking(san)
    if not _hook_registered:
        from ompi_tpu_torch.core import hook

        hook.register(at_finalize=_finalize_report)
        _hook_registered = True
    SANITIZER = san
    _out.verbose(1, "sanitizer up: level %d rank %d", level, rank)


def disable() -> None:
    """Tear the sanitizer down: detach the API hook, restore request
    methods, drop the guard (last, so instrumented sites never see a
    half-stopped plane)."""
    global SANITIZER
    san = SANITIZER
    if san is None:
        return
    from ompi_tpu_torch import profile

    handle = getattr(san, "_api_handle", None)
    if handle is not None:
        profile.detach_tool(handle)
    _remove_request_tracking()
    if san.client is not None:
        try:
            san.client.close()
        except Exception:  # noqa: BLE001
            pass
    SANITIZER = None


def _finalize_report() -> None:
    san = SANITIZER
    if san is not None:
        san.leak_report()


def _install_api_hook(san: Sanitizer) -> int:
    from ompi_tpu_torch import profile

    def pre(name, comm, args, kwargs):
        s = SANITIZER
        if s is not None:
            s.pre_call(name, comm, args, kwargs)

    return profile.attach_tool(pre=pre)


def _all_request_classes() -> list:
    from ompi_tpu_torch.pml import request as rq

    seen, todo = [], [rq.Request]
    while todo:
        cls = todo.pop()
        if cls in seen:
            continue
        seen.append(cls)
        todo.extend(cls.__subclasses__())
    return seen


def _install_request_tracking(san: Sanitizer) -> None:
    """Patch every Request class's lifecycle methods (classes override
    free/start without super-calls, so each defining class is patched
    where the method lives)."""
    if _request_patches:
        return

    def wrap(cls, name, before=None, after=None):
        orig = cls.__dict__.get(name)
        if orig is None:
            return
        _request_patches[(cls, name)] = orig

        def patched(self, *args, **kwargs):
            s = SANITIZER
            if s is not None and before is not None:
                before(s, self)
            result = orig(self, *args, **kwargs)
            if s is not None and after is not None:
                after(s, self)
            return result
        patched.__name__ = name
        patched.__wrapped__ = orig
        setattr(cls, name, patched)

    for cls in _all_request_classes():
        wrap(cls, "__init__",
             after=lambda s, r: s.track(r))
        wrap(cls, "complete",
             after=lambda s, r: s.on_complete(r))
        wrap(cls, "wait",
             before=lambda s, r: s.on_wait(r))
        wrap(cls, "test",
             before=lambda s, r: s.on_wait(r))
        wrap(cls, "retrieve_status",
             after=lambda s, r: s.on_wait(r))
        wrap(cls, "start",
             before=lambda s, r: s.on_start(r))
        wrap(cls, "free",
             after=lambda s, r: s.on_free(r))


def _remove_request_tracking() -> None:
    for (cls, name), orig in _request_patches.items():
        setattr(cls, name, orig)
    _request_patches.clear()
