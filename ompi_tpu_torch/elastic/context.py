"""elastic/context — the shrink / regrow driver over the ZeRO train loop.

The port's copy of ``ompi_tpu.elastic.context``: the ULFM plane,
ZeRO sharded state, the sharded checkpoints and the ingest plane in one
recovery story. :class:`ElasticContext` owns a
:class:`~ompi_tpu_torch.zero.optimizer.ZeroOptimizer` and drives it
through ``run(grad_fn, num_steps)``; when a collective raises
``ProcFailedError`` (the collective-entry gate, ``ft.check_comm_failed``,
or a device schedule's failed peer) the context recovers instead of
dying::

    revoke -> shrink -> allgather step_done, resume = min, certified by
    ``agree`` -> re-shard the optimizer state in memory from the
    survivors' snapshot chunks -> rebuild the optimizer on the survivors'
    comm -> go on at ``resume + 1``

The **buddy ring** makes the in-memory path possible: parameters are
replicated every step (the allgather tail), but a momentum shard lives
only on its owner, so after each step rank r sends its slot chunks to
rank (r+1) % n. One failure always leaves every old chunk a live owner;
only adjacent double failures or a rollback past the snapshot window
fall back to the last sharded checkpoint restored into the shrunken comm
(bitwise the in-memory path by construction, ``elastic/reshard``).

The inverse is the **hot join**: :func:`spawn_replacement` starts a fresh
rank against the same store (a world rank from the ``ww:`` watermark, as
``dpm`` does), the joiner announces itself through :func:`hot_join`, and
the survivors admit it at the next step boundary; its parameters arrive
by p2p and go through the ingest plane when it is up (:func:`_stream_in`).

State snapshots are host numpy (:func:`_host_tree`), as in the reference
(``context.py:97-104``), so the optimizer here runs the host bucket
cycle. A recovery (shrink or regrow) runs in the prof ledger's
``recovery`` phase; the trace marks a failure (``elastic_failure``), a
shrink's recovery (``elastic_recovery`` span) and a hot join
(``elastic_hot_join``) in the ``elastic`` lane (reference
``context.py:329-365``, ``:643-697``); the telemetry watchdog reads
:func:`recovery_info` and reports a collective stuck through a recovery
as a recovery, not a hang.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.elastic import inject, reshard as _reshard
from ompi_tpu_torch.prof import ledger as _ledger
from ompi_tpu_torch.runtime import rte
from ompi_tpu_torch.trace import recorder as _trace
from ompi_tpu_torch.zero import layout as _layout
from ompi_tpu_torch.zero.optimizer import ZeroOptimizer

#: object-channel tags (negative = internal, like the gather/scatter
#: helpers' -7/-8): the buddy replica ring and hot-join state transfer
_BUDDY_TAG = -23
_XFER_TAG = -24

_CKPT_BASE = "elastic_ckpt"

_window_var = cvar.register(
    "elastic_snapshot_window", 2, int,
    help="Completed steps of host state (params + slot chunks + buddy "
         "replicas) an ElasticContext retains for rollback. Survivors "
         "can finish a step their peers did not, so recovery may roll "
         "back one step — below 2 every failure becomes a checkpoint "
         "restore.", level=6)
_join_timeout_var = cvar.register(
    "elastic_join_timeout", 60.0, float,
    help="Seconds run(join_at=...) blocks at the boundary waiting for "
         "a replacement rank to announce before failing the join.",
    level=6)

# -- recovery visibility (the watchdog reads this to tell an
# in-progress recovery from a hang) ----------------------------------

_recovery_lock = threading.Lock()
_recovery: Optional[Dict[str, Any]] = None


def recovery_info() -> Optional[Dict[str, Any]]:
    """The recovery in progress on this rank (None when healthy):
    kind (shrink/regrow), phase, the step being recovered, and the
    wall time it started. The telemetry watchdog names this in its
    dump instead of issuing a false hang verdict."""
    with _recovery_lock:
        return dict(_recovery) if _recovery is not None else None


def _set_recovery(info: Optional[Dict[str, Any]]) -> None:
    global _recovery
    with _recovery_lock:
        _recovery = info


def _recovery_phase(phase: str) -> None:
    with _recovery_lock:
        if _recovery is not None:
            _recovery["phase"] = phase


def _host_tree(tree):
    """A host (numpy, copied) mirror of a pytree: snapshot state must not
    alias the live arrays the optimizer keeps replacing. A device tensor
    crosses with one D2H through pinned staging (``io.host_array``)."""
    from ompi_tpu_torch import io as _io

    leaves, treedef = _layout.tree_flatten(tree)
    return _layout.tree_unflatten(treedef, [
        np.array(_io.host_array(a) if not isinstance(a, np.ndarray) else a,
                 copy=True) for a in leaves])


def _stream_in(params_tree):
    """Joiner-side state arrival through the ingest plane when it is
    up: upload, gate on the first leaf (the step-1 release), then
    collect the full tree back to host. Without an engine this is the
    identity — the p2p payload is already host state."""
    from ompi_tpu_torch.ingest import engine as _engine

    eng = _engine.INGEST
    if eng is None:
        return params_tree
    req = eng.upload(params_tree)
    if req.n_units:
        req.gate(keys=[0])
    dev = req.tree()
    return _host_tree(dev)


class ElasticContext:
    """Failure-surviving ZeRO training driver (see module docstring).

    ``comm`` must be FT-enabled (``--mca ft 1``) for real recovery;
    ``checkpoint_dir`` arms the disk fallback (and
    ``checkpoint_every`` writes one every N completed steps).
    Construction is local; ``run``/``save_checkpoint``/
    ``from_checkpoint`` are collective over the current comm."""

    def __init__(self, comm, params, lr: float = 1e-3,
                 momentum: float = 0.0, stage: int = 2,
                 deterministic: Optional[str] = "linear",
                 grad_average: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 poll_joins: bool = False,
                 async_checkpoint: bool = False) -> None:
        if stage == 3:
            # the shrink/regrow arithmetic (elastic/reshard) re-shards
            # grad/momentum state only — silently accepting a
            # parameter-sharded optimizer would corrupt params at the
            # first shrink. Refuse at construction, loudly.
            raise errors.MPIError(
                errors.ERR_NOT_SUPPORTED,
                "ElasticContext: ZeRO stage-3 (parameter-sharded) "
                "training is not elastic yet — shrink/regrow "
                "re-shards gradient/momentum state only and would "
                "corrupt sharded parameters. Train stage 3 via "
                "ompi_tpu_torch.zero.zero3.Zero3Optimizer without "
                "elasticity, or use stage 1/2 here (elastic param "
                "re-shard is future ROADMAP work).")
        self._init_state(
            dict(lr=lr, momentum=momentum, stage=stage,
                 deterministic=deterministic,
                 grad_average=grad_average),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            poll_joins=poll_joins,
            async_checkpoint=async_checkpoint)
        self._build(comm, _host_tree(params))
        self._snapshot(-1)

    def _init_state(self, opt_kw: Dict[str, Any],
                    checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 0,
                    poll_joins: bool = False,
                    async_checkpoint: bool = False) -> None:
        self._opt_kw = dict(opt_kw)
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = int(checkpoint_every)
        self._poll_joins = bool(poll_joins)
        #: opt-in: snapshots ride io/async_ckpt — d2h begun at the
        #: checkpoint boundary overlaps the NEXT steps and commits at
        #: the following boundary (two-phase manifest, incremental
        #: digest-diff); the disk fallback prefers the newest
        #: digest-verified manifest. The legacy .params/.slots pair
        #: stays the default.
        self._async_ckpt = bool(async_checkpoint)
        self._pending_snap: Optional[tuple] = None
        self._join_timeout = _join_timeout_var.get()
        self._join_seq = 0
        self._owns_comm = False
        self._has_slots = False
        self.opt: Optional[ZeroOptimizer] = None
        self._comm = None
        self._params = None
        #: last step whose update + snapshot fully completed here
        self.step_done = -1
        self.shrinks = 0
        self.joins = 0
        self.last_resume: Optional[int] = None
        #: where the last recovery's state came from
        #: ("memory" | "checkpoint" | None)
        self.restored_from: Optional[str] = None
        self._snapshots: Dict[int, Dict[str, Any]] = {}
        # step -> (old comm rank of the sender, its slot chunks)
        self._buddy: Dict[int, tuple] = {}

    # -- accessors ---------------------------------------------------------
    @property
    def comm(self):
        return self._comm

    @property
    def params(self):
        return self._params

    # -- construction / rebuild --------------------------------------------
    def _build(self, comm, params_full) -> None:
        if self.opt is not None:
            self.opt.free()
        self._comm = comm
        self.opt = ZeroOptimizer(comm, params_full, **self._opt_kw)
        self._params = params_full
        self._has_slots = bool(self.opt.state.slots)

    def _rebuild(self, comm, params_full, slots_full: Dict[str, list],
                 step: int) -> None:
        """Fresh optimizer on ``comm`` with slot state re-sharded from
        full bucket flats (the scatter half of the re-shard; flats may
        carry an old pad tail — stripped by the n-independent
        ``plan.elems``)."""
        self._build(comm, params_full)
        plan = self.opt._pshards.plan
        tmpl = self.opt._pshards
        for name, flats in (slots_full or {}).items():
            stripped = [np.asarray(f)[:plan.elems[b]]
                        for b, f in enumerate(flats)]
            self.opt.state.slots[name] = _reshard.pack(
                plan, tmpl, stripped, comm.rank)
        self.step_done = int(step)
        self._snapshots.clear()
        self._buddy.clear()
        self._snapshot(self.step_done)
        self._buddy_exchange(self.step_done)

    # -- per-step host state ------------------------------------------------
    def _snapshot(self, step: int) -> None:
        slots = {name: _reshard.host_chunks(st)
                 for name, st in self.opt.state.slots.items()}
        self._snapshots[step] = {"params": _host_tree(self._params),
                                 "slots": slots}
        w = max(1, int(_window_var.get()))
        while len(self._snapshots) > w:
            del self._snapshots[min(self._snapshots)]

    def _buddy_exchange(self, step: int) -> None:
        """Replicate this rank's slot chunks to (rank+1) % n so a
        single failure always leaves every chunk a live owner."""
        n = self._comm.size
        if n < 2 or not self._has_slots:
            return
        payload = (step, self._comm.rank,
                   self._snapshots[step]["slots"])
        req = self._comm.isend(
            payload, dest=(self._comm.rank + 1) % n, tag=_BUDDY_TAG)
        got = self._comm.recv(
            source=(self._comm.rank - 1) % n, tag=_BUDDY_TAG)
        req.wait()
        self._buddy[int(got[0])] = (int(got[1]), got[2])
        w = max(1, int(_window_var.get()))
        while len(self._buddy) > w:
            del self._buddy[min(self._buddy)]

    # -- the elastic loop ---------------------------------------------------
    def run(self, grad_fn: Callable, num_steps: int,
            join_at: Optional[int] = None):
        """Drive the loop until ``num_steps`` steps completed,
        recovering from rank failures and admitting joiners along the
        way. ``grad_fn(params, step, comm)`` returns the local
        gradient pytree (it takes the comm because the comm — and its
        size — can change between steps). ``join_at`` blocks at that
        step boundary until a replacement announces (deterministic
        regrow for tests/CI); ``poll_joins=True`` checks every
        boundary instead. Returns the final replicated params."""
        num_steps = int(num_steps)
        while self.step_done < num_steps - 1:
            step = self.step_done + 1
            try:
                inject.maybe_kill(step)
                if join_at == step or self._poll_joins:
                    self._admit_joiners(step, num_steps,
                                        block=join_at == step)
                grads = grad_fn(self._params, step, self._comm)
                self._params = self.opt.step(grads)
                self._snapshot(step)
                self._buddy_exchange(step)
                self.step_done = step
                if (self._ckpt_every and self._ckpt_dir
                        and (step + 1) % self._ckpt_every == 0):
                    self._checkpoint_boundary()
            except (errors.ProcFailedError,
                    errors.RevokedError) as exc:
                self._recover_until_stable(exc)
        self._commit_pending()
        return self._params

    # -- failure recovery ---------------------------------------------------
    def _recover_until_stable(self, exc) -> None:
        """Recovery itself can observe further failures (a second rank
        dies mid-shrink) — keep recovering until one pass completes."""
        while True:
            try:
                self._recover(exc)
                return
            except (errors.ProcFailedError,
                    errors.RevokedError) as again:
                exc = again

    def _recover(self, exc) -> None:
        t0 = time.perf_counter_ns()
        # a snapshot begun on the old comm can never commit (its
        # write would be collective over dead ranks) — drop it; the
        # post-recovery boundary snapshots fresh state anyway
        pend, self._pending_snap = self._pending_snap, None
        if pend is not None:
            pend[1].abort()
        failed = sorted(getattr(exc, "failed_ranks", ()) or ())
        _set_recovery({"kind": "shrink", "since": time.time(),
                       "step": self.step_done + 1,
                       "failed_comm_ranks": failed,
                       "phase": "revoke"})
        rec = _trace.RECORDER
        if rec is not None:
            rec.instant("elastic_failure", "elastic",
                        {"failed_comm_ranks": failed,
                         "step": self.step_done + 1})
        try:
            with _ledger.phase("recovery"):
                old_comm = self._comm
                # revoke wakes peers parked in collectives that would
                # otherwise never see the failure (idempotent)
                old_comm.revoke()
                _recovery_phase("shrink")
                new = old_comm.shrink()
                _recovery_phase("agree")
                resume = self._decide_resume(new)
                _recovery_phase("reshard")
                params_full, slots_full, resume, origin = \
                    self._collect_state(new, resume)
                _recovery_phase("rebuild")
                self._rebuild(new, params_full, slots_full, resume)
                if self._owns_comm:
                    old_comm.free()
                self._owns_comm = True
        finally:
            _set_recovery(None)
        self.shrinks += 1
        self.last_resume = self.step_done
        self.restored_from = origin
        dur = time.perf_counter_ns() - t0
        pvar.record("elastic_shrinks")
        pvar.record("elastic_recovery_ns", dur)
        rec = _trace.RECORDER
        if rec is not None:
            t1 = _trace.now()
            rec.record("elastic_recovery", "elastic", t1 - dur, t1,
                       {"resume": self.step_done,
                        "survivors": self._comm.size, "origin": origin})

    def _decide_resume(self, new) -> int:
        """min of the survivors' completed steps, certified unanimous
        by ``agree`` (AND of identical contributions IS the value —
        any divergence surfaces as a mismatch, not a silent skew)."""
        steps = new.allgather(int(self.step_done))
        resume = min(steps)
        val, _failed = new.agree(resume)
        if val != resume:
            raise errors.MPIError(
                errors.ERR_INTERN,
                f"elastic recovery: agree({resume}) decided {val} — "
                "survivors diverged on the resume step")
        return resume

    def _collect_state(self, new, resume: int):
        """(params_full, slots_full, resume, origin): in memory when
        every old chunk has a live owner (own snapshot or buddy
        replica), else the checkpoint fallback. The decision rides ONE
        allgather, so every survivor takes the same path."""
        snap = self._snapshots.get(resume)
        old_rank = self.opt._pshards.rank
        n_old = self.opt._pshards.n
        contrib: Dict[int, Any] = {}
        if snap is not None:
            contrib[old_rank] = snap["slots"]
            buddy = self._buddy.get(resume)
            if buddy is not None:
                contrib.setdefault(int(buddy[0]), buddy[1])
        got = new.allgather({"has": snap is not None,
                             "chunks": contrib})
        every = all(g["has"] for g in got)
        merged: Dict[int, Any] = {}
        for g in got:
            for r, chunks in g["chunks"].items():
                merged.setdefault(int(r), chunks)
        complete = (not self._has_slots) or resume == -1 or all(
            r in merged for r in range(n_old))
        if every and complete:
            slots_full: Dict[str, list] = {}
            if self._has_slots and resume != -1:
                nbytes = sum(
                    int(np.asarray(c).nbytes)
                    for chunks in merged.values()
                    for cl in chunks.values() for c in cl)
                pvar.record("elastic_reshard_bytes", nbytes)
                elems = self.opt._pshards.plan.elems
                for name in sorted(next(iter(merged.values()))):
                    slots_full[name] = _reshard.full_flats(
                        {r: merged[r][name] for r in merged}, elems)
            # resume == -1: slot state is the initial zeros the
            # rebuilt optimizer already holds — nothing to re-shard
            return snap["params"], slots_full, resume, "memory"
        pvar.record("elastic_fallback_restores")
        params_full, slots_full, ck_step = self._restore_fallback()
        return params_full, slots_full, ck_step, "checkpoint"

    def _restore_fallback(self):
        """Last sharded snapshot from disk: replicated params + the
        GLOBAL (comm=None) view of the slot file — old padded flats
        the rebuild strips and re-packs exactly like memory chunks."""
        if not self._ckpt_dir:
            raise errors.MPIError(
                errors.ERR_INTERN,
                "elastic recovery: a dead rank's shard has no live "
                "owner and no checkpoint_dir is configured — "
                "unrecoverable")
        if self._async_ckpt:
            try:
                # newest digest-verified manifest; parts carry the
                # slot flats under the legacy name:bucket key scheme
                tree, astep, aparts = self._ackpt_for(None).restore()
                return (tree,
                        _parse_slot_tree(aparts) if aparts else {},
                        int(astep))
            except errors.MPIError:
                pass  # no restorable epoch — try the legacy pair
        from ompi_tpu_torch.io import checkpoint as _ckpt

        params_full, pstep = _ckpt.restore(self._params_path())
        slots_full: Dict[str, list] = {}
        spath = self._slots_path()
        if os.path.exists(spath):
            tree, sstep = _ckpt.restore(spath)
            if sstep != pstep:
                raise errors.MPIError(
                    errors.ERR_FILE,
                    "elastic recovery: torn checkpoint pair (params "
                    f"step {pstep}, slots step {sstep}) under "
                    f"{self._ckpt_dir}")
            slots_full = _parse_slot_tree(tree)
        return params_full, slots_full, int(pstep)

    # -- checkpointing ------------------------------------------------------
    def _params_path(self) -> str:
        return os.path.join(self._ckpt_dir, _CKPT_BASE + ".params")

    def _slots_path(self) -> str:
        return os.path.join(self._ckpt_dir, _CKPT_BASE + ".slots")

    def _ackpt_for(self, comm):
        from ompi_tpu_torch.io import async_ckpt as _ackpt_mod

        return _ackpt_mod.AsyncCheckpointer(
            self._ckpt_dir, comm=comm, incremental=True)

    def _slot_parts(self) -> Dict[str, Any]:
        """This rank's slot shards as async-ckpt parts — the same
        ``name:bucket`` key scheme the legacy slot file uses, so
        :func:`_parse_slot_tree` reads both."""
        return {f"{name}:{b}": np.ascontiguousarray(
                    _reshard._host(st.shards[b]))
                for name, st in self.opt.state.slots.items()
                for b in range(len(st.shards))}

    def _checkpoint_boundary(self) -> None:
        """The run-loop checkpoint hook. Async mode: commit the
        snapshot begun at the PREVIOUS boundary (its d2h overlapped
        the steps in between — the snapshot window), then begin the
        next one. Legacy mode: the synchronous pair write."""
        if not self._async_ckpt:
            self.save_checkpoint()
            return
        self._commit_pending()
        ck = self._ackpt_for(self._comm)
        snap = ck.begin(self._params, self.step_done,
                        parts=self._slot_parts())
        self._pending_snap = (ck, snap)

    def _commit_pending(self) -> None:
        pend, self._pending_snap = self._pending_snap, None
        if pend is None:
            return
        ck, snap = pend
        ck.commit(snap)
        pvar.record("elastic_checkpoints")

    def save_checkpoint(self) -> None:
        """Collective snapshot. Async mode (``async_checkpoint=True``):
        one digest-diffed, two-phase-committed epoch through
        ``io/async_ckpt`` (params sharded by ZeroPlan extents + slot
        shards as parts). Legacy: replicated params (rank 0 writes) +
        slot shards through ``save_sharded`` (each rank lands its
        chunk; the file's global view is the old padded flats — the
        fallback's input)."""
        if not self._ckpt_dir:
            raise errors.MPIError(
                errors.ERR_ARG,
                "ElasticContext.save_checkpoint: no checkpoint_dir "
                "configured")
        if self._async_ckpt:
            self._commit_pending()
            self._ackpt_for(self._comm).save(
                self._params, self.step_done,
                parts=self._slot_parts())
            pvar.record("elastic_checkpoints")
            return
        from ompi_tpu_torch.io import checkpoint as _ckpt

        os.makedirs(self._ckpt_dir, exist_ok=True)
        _ckpt.save(self._params_path(), self._params,
                   step=self.step_done, comm=self._comm)
        slots = self.opt.state.slots
        if slots:
            tree = {f"{name}:{b}": np.ascontiguousarray(
                        _reshard._host(st.shards[b]))
                    for name, st in slots.items()
                    for b in range(len(st.shards))}
            _ckpt.save_sharded(self._slots_path(), tree, self._comm,
                               step=self.step_done)
        pvar.record("elastic_checkpoints")

    @classmethod
    def from_checkpoint(cls, comm, checkpoint_dir: str,
                        **kwargs) -> "ElasticContext":
        """Rebuild a context from the last elastic checkpoint —
        collective over ``comm``, which may be a different size than
        the comm that saved (the re-shard arithmetic is the same one
        recovery uses, so this is also the recovery fallback's
        reference semantics)."""
        from ompi_tpu_torch.io import checkpoint as _ckpt

        if kwargs.get("async_checkpoint"):
            from ompi_tpu_torch.io import async_ckpt as _ackpt_mod

            try:
                tree, astep, aparts = _ackpt_mod.AsyncCheckpointer(
                    checkpoint_dir).restore()
            except errors.MPIError:
                tree = None  # no manifest — fall back to the pair
            if tree is not None:
                ctx = cls(comm, tree, checkpoint_dir=checkpoint_dir,
                          **kwargs)
                slots_full = _parse_slot_tree(aparts) \
                    if aparts and ctx._has_slots else {}
                ctx._rebuild(comm, tree, slots_full, int(astep))
                ctx.restored_from = "checkpoint"
                return ctx
        base = os.path.join(checkpoint_dir, _CKPT_BASE)
        params_full, step = _ckpt.restore(base + ".params")
        ctx = cls(comm, params_full, checkpoint_dir=checkpoint_dir,
                  **kwargs)
        slots_full: Dict[str, list] = {}
        spath = base + ".slots"
        if os.path.exists(spath) and ctx._has_slots:
            tree, sstep = _ckpt.restore(spath)
            if sstep != step:
                raise errors.MPIError(
                    errors.ERR_FILE,
                    "elastic restore: torn checkpoint pair (params "
                    f"step {step}, slots step {sstep}) under "
                    f"{checkpoint_dir}")
            slots_full = _parse_slot_tree(tree)
        ctx._rebuild(comm, params_full, slots_full, step)
        ctx.restored_from = "checkpoint"
        return ctx

    # -- hot-join (survivor side) -------------------------------------------
    def _admit_joiners(self, step: int, num_steps: int,
                       block: bool) -> None:
        """Step-boundary admission: rank 0 reads the announce counter
        and the decision is broadcast, so the regrow collective is
        entered by every rank or none."""
        client = rte.client()
        key = f"elastic:join_epoch:{rte.jobid}"
        dec = None
        # when rank 0's join wait times out it raises MPIError while the
        # other ranks sit in the bcast below: fatal by design (the
        # errhandler aborts, or the ft plane revokes), the contract of
        # any collective that errs on one rank
        if self._comm.rank == 0:
            cur = int(client.inc(key, 0))
            if block:
                deadline = time.monotonic() + self._join_timeout
                while cur <= self._join_seq:
                    if time.monotonic() > deadline:
                        raise errors.MPIError(
                            errors.ERR_INTERN,
                            f"elastic: join_at step {step} reached "
                            "but no replacement announced within "
                            f"{self._join_timeout}s")
                    time.sleep(0.05)
                    cur = int(client.inc(key, 0))
            joiners = [int(client.get(
                f"elastic:join:{rte.jobid}:{e}", wait=True))
                for e in range(self._join_seq + 1, cur + 1)]
            dec = {"seq": cur, "joiners": joiners}
        dec = self._comm.bcast(dec, root=0)
        self._join_seq = int(dec["seq"])
        if dec["joiners"]:
            self._regrow(dec, num_steps)

    def _regrow(self, dec: Dict[str, Any], num_steps: int) -> None:
        from ompi_tpu_torch import comm as comm_mod

        t0 = time.perf_counter_ns()
        client = rte.client()
        # a snapshot begun before the join must never commit after it:
        # its checkpointer is bound to the old comm, so the deferred
        # commit's collectives would run over a freed comm the joiners
        # are not part of — drop it exactly as _recover does; the next
        # boundary begins fresh on the grown comm
        pend, self._pending_snap = self._pending_snap, None
        if pend is not None:
            pend[1].abort()
        snap = self._snapshots[self.step_done]
        members = sorted(set(self._comm.group.ranks)
                         | set(dec["joiners"]))
        _set_recovery({"kind": "regrow", "since": time.time(),
                       "step": self.step_done + 1,
                       "joiners": list(dec["joiners"]),
                       "phase": "admit"})
        try:
            with _ledger.phase("recovery"):
                if self._comm.rank == 0:
                    for wr in dec["joiners"]:
                        client.put(
                            f"elastic:admit:{rte.jobid}:{wr}",
                            {"members": members, "seq": dec["seq"],
                             "step": self.step_done,
                             "target": int(num_steps),
                             "opt": dict(self._opt_kw),
                             "checkpoint_dir": self._ckpt_dir,
                             # boundary checkpoints (and join polls) are
                             # collective: the joiner runs them in lockstep
                             # with the survivors
                             "checkpoint_every": self._ckpt_every,
                             "async_checkpoint": self._async_ckpt,
                             "poll_joins": self._poll_joins})
                old_comm = self._comm
                old_rank = old_comm.rank
                _recovery_phase("regrow_comm")
                new = comm_mod.comm_create_from_group(
                    comm_mod.Group(members),
                    tag=f"elastic:regrow:{dec['seq']}")
                _recovery_phase("transfer")
                # members are sorted by world rank and the joiners' come from
                # the ww: watermark (above every original rank), so the new
                # root is always a survivor
                if new.rank == 0:
                    for wr in dec["joiners"]:
                        new.send(snap["params"], dest=members.index(wr),
                                 tag=_XFER_TAG)
                got = new.allgather({"rank": old_rank,
                                     "chunks": snap["slots"]})
                _recovery_phase("reshard")
                slots_full = _regrow_slots(got,
                                           self.opt._pshards.plan.elems)
                self._rebuild(new, snap["params"], slots_full,
                              self.step_done)
                if self._owns_comm:
                    old_comm.free()
                self._owns_comm = True
        finally:
            _set_recovery(None)
        self.joins += len(dec["joiners"])
        pvar.record("elastic_hot_joins", len(dec["joiners"]))
        pvar.record("elastic_recovery_ns", time.perf_counter_ns() - t0)
        rec = _trace.RECORDER
        if rec is not None:
            rec.instant("elastic_hot_join", "elastic",
                        {"joiners": list(dec["joiners"]),
                         "step": self.step_done, "size": self._comm.size})


class ElasticStep:
    """One elastic training step as a callable: recovery (or a poll
    of waiting joiners) happens inside the call, so user-owned loops
    get the same guarantees as :meth:`ElasticContext.run` one step at
    a time."""

    def __init__(self, ctx: ElasticContext,
                 grad_fn: Callable) -> None:
        self.ctx = ctx
        self.grad_fn = grad_fn

    def __call__(self):
        """Complete exactly one more step (however many recoveries
        that takes); returns the new replicated params."""
        return self.ctx.run(self.grad_fn, self.ctx.step_done + 2)


def _regrow_slots(got: List[Dict[str, Any]], elems) -> Dict[str, list]:
    """Full bucket flats from the regrow allgather (joiners
    contribute rank -1 / no chunks; every old chunk has a live owner
    because nobody died)."""
    merged = {int(g["rank"]): g["chunks"] for g in got
              if int(g["rank"]) >= 0}
    slots_full: Dict[str, list] = {}
    if merged:
        for name in sorted(next(iter(merged.values()))):
            slots_full[name] = _reshard.full_flats(
                {r: merged[r][name] for r in merged}, elems)
    return slots_full


# -- hot-join (joiner side) + respawn machinery ---------------------------

def is_joiner() -> bool:
    """True in a process launched by :func:`spawn_replacement` — the
    job script branches on this to call :func:`hot_join` instead of
    building a context from scratch."""
    return os.environ.get("OMPI_TPU_ELASTIC_JOINER", "") \
        not in ("", "0")


def hot_join() -> tuple:
    """Announce this freshly launched rank on the kvstore rendezvous,
    wait for admission, enter the regrow collective, and return
    ``(ctx, target)`` — the joiner then calls
    ``ctx.run(grad_fn, target)`` and steps in lockstep with the
    survivors. Parameter state arrives by p2p from the new root and
    streams through the ingest plane when it's up
    (:func:`_stream_in`); slot state re-shards from the survivors'
    chunks in the same allgather the survivors run."""
    from ompi_tpu_torch import comm as comm_mod

    client = rte.client()
    e = int(client.inc(f"elastic:join_epoch:{rte.jobid}"))
    client.put(f"elastic:join:{rte.jobid}:{e}", int(rte.rank))
    admit = client.get(f"elastic:admit:{rte.jobid}:{rte.rank}",
                       wait=True)
    members = list(admit["members"])
    new = comm_mod.comm_create_from_group(
        comm_mod.Group(members),
        tag=f"elastic:regrow:{admit['seq']}")
    params_full = new.recv(source=0, tag=_XFER_TAG)
    params_full = _stream_in(params_full)
    got = new.allgather({"rank": -1, "chunks": {}})
    elems = _layout.plan_for(_layout.tree_leaves(params_full),
                             len(members)).elems
    slots_full = _regrow_slots(got, elems)
    ctx = ElasticContext.__new__(ElasticContext)
    ctx._init_state(dict(admit["opt"]),
                    checkpoint_dir=admit.get("checkpoint_dir"),
                    checkpoint_every=int(
                        admit.get("checkpoint_every") or 0),
                    poll_joins=bool(admit.get("poll_joins")),
                    async_checkpoint=bool(
                        admit.get("async_checkpoint")))
    ctx._join_seq = int(admit["seq"])
    ctx._rebuild(new, params_full, slots_full, int(admit["step"]))
    ctx._owns_comm = True
    ctx.joins = 1
    return ctx, int(admit["target"])


def spawn_replacement(script: Optional[str] = None,
                      mca: Optional[Dict[str, str]] = None):
    """Launch a replacement rank against this job's store: a fresh
    globally-unique world rank from the ``ww:`` watermark (the dpm
    idiom), world size 1 with its own offset, and the joiner flag set
    so the (re-run) job script lands in :func:`hot_join`. Returns the
    ``subprocess.Popen`` handle — the caller reaps it after the run."""
    import subprocess
    import sys

    from ompi_tpu_torch.runtime import launcher as _launcher

    client = rte.client()
    wr = int(client.inc(f"ww:{rte.jobid}", 1)) - 1
    env = _launcher.build_env(rank=wr, size=1,
                              store_addr=client.addr,
                              jobid=rte.jobid, mca=dict(mca or {}),
                              local_rank=0, local_size=1)
    env["OMPI_TPU_WORLD_OFFSET"] = str(wr)
    env["OMPI_TPU_ELASTIC_JOINER"] = "1"
    pvar.record("spawned_procs")
    return subprocess.Popen([sys.executable, script or sys.argv[0]],
                            env=env)


def _parse_slot_tree(tree: Dict[str, Any]) -> Dict[str, list]:
    """``{"<slot>:<bucket>": flat}`` (the slot-file key scheme) back
    to ``{slot: [flat per bucket]}``."""
    names = sorted({k.rsplit(":", 1)[0] for k in tree})
    out: Dict[str, list] = {}
    for name in names:
        nb = 1 + max(int(k.rsplit(":", 1)[1]) for k in tree
                     if k.rsplit(":", 1)[0] == name)
        out[name] = [np.asarray(tree[f"{name}:{b}"])
                     for b in range(nb)]
    return out
