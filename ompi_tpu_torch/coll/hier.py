"""coll/hier — two-level collectives over a communicator's low and up
splits.

The port of :mod:`ompi_tpu.coll.hier` (priority 70, opt-in with ``--mca
coll_hier on``): coll/han's architecture on the device plane (reference:
ompi/mca/coll/han/coll_han.h:22-33,62-63 — hierarchical subgrouping with
per-level algorithm selection). A communicator whose ranks span slices is
split into an intra-slice (``low``, ICI) x inter-slice (``up``, DCN) grid
(:func:`ompi_tpu_torch.parallel.hierarchical.grid`), and each collective
runs as a composition of per-level phases with the bulk bytes on the
fast level. Allreduce is the canonical case: ICI reduce_scatter -> DCN
allreduce over 1/ici_size of the payload -> ICI allgather, so the slow
level carries ``2*(n_dcn-1)/n_dcn * payload/ici_size`` bytes instead of
the flat ring's ``~2*payload``.

Topology comes from ``parallel.hierarchical.parse_split``: 'auto' groups
the ranks by node, while ``--mca coll_hier_split 2x2`` forces a grid (on
one machine every rank shares a node, so the tests and the card force
one). A malformed or indivisible spec raises ``MPIError(ERR_ARG)`` at
slot-call time, at every call (never inside ``query``, where
comm_select would swallow it).

Selection is two-dimensional, as in the reference:

- two-level vs flat per collective: ``coll_hier_force`` >
  ``coll_hier_switchpoints`` entry (op, dtype, log2 size, grid) >
  two-level; ``deterministic='ring'`` and payloads under
  ``coll_hier_min_bytes`` always take the flat path;
- the ICI phase's algorithm (``coll_hier_inner``): 'ring' / 'bidir' run
  coll/cuda's ring schedules (K1 / K2) on ``low``; 'xla' runs coll/device's
  slots (its ring for the kernels' dtypes and ops), as
  ``coll_cuda_*_algorithm=xla`` does; 'auto' asks coll/cuda's switchpoint
  table, keyed on the inner shape, when coll/cuda is on.

``deterministic='linear'`` stays two-level with the rank-order
compositions: DCN-first gathers (K2), then one rank-order fold of the
rank-major stack (K3), bitwise the flat 'linear' result on any grid.

``coll_hier_dcn_dtype`` (and its per-op overrides) compresses the DCN
phase of SUM reductions of float payloads (bf16, fp8_e4m3, fp8_e5m2:
gather in the wire dtype, local upcast and sum; fp8 agrees a scale by an
Allreduce MAX over ``up``). 'linear', non-SUM ops, non-float payloads and
a wire no narrower than the payload run exact.

A case this component declines falls through one priority level down:
coll/cuda's slot when coll/cuda stacked on the comm and serves it, else
coll/device's, counted by ``hier_fallthrough``. The phases call coll/cuda's
and coll/device's functions on ``low`` and ``up`` directly, never
``low.coll.*``: the splits select coll components like any comm (coll/hier
among them), and a 2-rank split has no 2x2 grid. Every launch records the
per-level pvars from ``monitoring.algo``'s byte models
(``hier_ici_bytes``, ``hier_dcn_bytes``, ``hier_dcn_wire_bytes``) and
reads the flight, trace and tune guards where the reference does.

Where the port differs (stated in ROADMAP queue 3): the reference compiles
one program per (slot, shape, grid, wire) into coll/xla's cache; the port
plans nothing ahead but the persistent requests' arenas, so toggling a
wire format maps no new arena once each has run. 'xla' as an inner
algorithm means coll/device. The slice grouping is by node, not
``slice_index``. A bfloat16 payload under an fp8 wire compresses (a float
dtype wider than the wire); the reference runs it exact, since ml_dtypes'
bfloat16 has numpy kind 'V'.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import torch

from ompi_tpu_torch import errors, op as op_mod
from ompi_tpu_torch.coll import cuda as _cuda
from ompi_tpu_torch.coll import cuda_kernels as K
from ompi_tpu_torch.coll import device as _dev
from ompi_tpu_torch.core import cvar, output, pvar, registry
from ompi_tpu_torch.monitoring import algo as _algo
from ompi_tpu_torch.monitoring import matrix as _mon
from ompi_tpu_torch.parallel import collectives as C
from ompi_tpu_torch.parallel import hierarchical as H
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.telemetry import flight as _flight
from ompi_tpu_torch.trace import recorder as _trace
from ompi_tpu_torch.tune import observe as _tobs

_out = output.stream("coll_hier")

_enable_var = cvar.register(
    "coll_hier", "off", str,
    help="Enable the two-level (low x up) collective component "
         "(priority 70, above coll/cuda's 60): 'on' stacks it for every "
         "comm the device plane serves; 'off' [default] keeps the flat "
         "schedules in charge.",
    choices=["off", "on"], level=4)

_split_var = cvar.register(
    "coll_hier_split", "auto", str,
    help="How the comm's ranks split into DCN groups: 'auto' [default] "
         "groups them by node (flat when ranks are not node-contiguous), "
         "'DxI' forces a DCN x ICI grid (e.g. '2x2'), an integer N "
         "forces N equal slices, 'off' disables the split. A spec that "
         "does not divide the comm raises MPIError(ERR_ARG) at the first "
         "collective.", level=5)

_force_var = cvar.register(
    "coll_hier_force", "", str,
    help="Force the two-level-vs-flat decision: 'hier' always two-level "
         "(when a split exists), 'flat' always falls through (A/B "
         "validation). Empty [default] consults the switchpoint table.",
    choices=["", "hier", "flat"], level=5)

_inner_var = cvar.register(
    "coll_hier_inner", "auto", str,
    help="ICI-phase algorithm of the split-level allreduce: 'xla' "
         "coll/device's slots, 'ring'/'bidir' coll/cuda's ring schedules "
         "on the low comm, 'auto' [default] asks the coll_cuda "
         "switchpoint table (keyed on the inner shape) when coll_cuda is "
         "on, else xla. Dtypes and ops outside the kernels use xla.",
    choices=["auto", "xla", "ring", "bidir"], level=5)

_min_bytes_var = cvar.register(
    "coll_hier_min_bytes", 0, int,
    help="Payloads below this take the flat path. 0 [default] keeps every "
         "supported size two-level.", level=5)

_switch_var = cvar.register(
    "coll_hier_switchpoints", "", str,
    help="Path to a measured two-level-vs-flat switchpoint table: a JSON "
         "list of {op, dtype, mesh, log2, algorithm} rules with algorithm "
         "'hier' or 'flat' and mesh the [n_dcn, n_ici] grid; for each "
         "(op, dtype, mesh) the rule with the largest log2 <= the "
         "payload's log2 bucket wins. Empty [default] = two-level "
         "whenever a split exists.", level=5)

# NOTE: the dcn_dtype cvars register without choices= on purpose: an
# unknown value must surface as MPIError(ERR_ARG) at the first collective
# (uncached, never swallowed by query), the bad-split contract
_dcn_dtype_var = cvar.register(
    "coll_hier_dcn_dtype", "off", str,
    help="Wire dtype of the DCN phase: 'off' [default] moves the "
         "accumulate dtype (bitwise the uncompressed plane); 'bf16', "
         "'fp8_e4m3', 'fp8_e5m2' cast-compress the DCN payload (gather "
         "in the wire dtype + local upcast-sum; fp8 adds a per-launch "
         "scale agreed by an Allreduce MAX). SUM of float payloads only; "
         "'linear' and non-float dtypes always run exact. Unknown values "
         "raise MPIError(ERR_ARG) at the first collective.", level=5)

_dcn_dtype_op_vars = {
    kind: cvar.register(
        f"coll_hier_dcn_dtype_{kind}", "", str,
        help=f"Per-op override of coll_hier_dcn_dtype for {kind} "
             "launches ('off'/'bf16'/'fp8_e4m3'/'fp8_e5m2'; empty "
             "[default] inherits the global setting).", level=5)
    for kind in ("allreduce", "allreduce_multi", "reduce_scatter_block")
}

_WIRE_NAMES = H.WIRE_DTYPES


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _wire_dtype(kind: str, dtype, det: Optional[str],
                opn) -> Optional[str]:
    """The DCN wire format of this launch, or None = exact.

    Per-op override > coll_hier_dcn_dtype > off. An unknown value raises
    MPIError(ERR_ARG) here, at every call. Compression is declined
    (exact, no error) when the result must be bit-stable or the cast
    cannot help: 'linear', a non-SUM op, a non-float payload, or a wire
    no narrower than the payload."""
    v = _dcn_dtype_op_vars.get(kind)
    spec = v.get().strip().lower() if v is not None else ""
    if not spec:
        spec = _dcn_dtype_var.get().strip().lower()
    if not spec or spec == "off":
        return None
    if spec not in _WIRE_NAMES:
        raise errors.MPIError(
            errors.ERR_ARG,
            f"coll_hier_dcn_dtype={spec!r}: expected 'off', 'bf16', "
            "'fp8_e4m3' or 'fp8_e5m2'")
    if det == "linear" or opn.name != "MPI_SUM":
        return None
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        return None
    wire = H.wire_degrade(spec)
    if H.wire_itemsize(wire) >= dtype.itemsize:
        return None  # the "compression" would not shrink the wire
    return wire


#: flat slots coll/cuda serves (one priority level down)
_CUDA_SLOTS = frozenset((
    "allreduce_dev", "allgather_dev", "reduce_scatter_block_dev"))


# ---------------------------------------------------------------------------
# the plan — per comm, cached: the comm's ``parallel.hierarchical.Grid``
# (n_dcn, n_ici, ``low`` and ``up``), shared with coll/device's two-level
# mode


#: cached marker for a valid but trivial split (stay flat for good)
_NO_PLAN = object()


def _plan(comm) -> Optional[H.Grid]:
    """The comm's plan, or None = flat. Built on the first collective
    (collective: it splits ``low`` and ``up``) and cached as
    ``comm._coll_hier_plan``. A malformed or indivisible spec raises
    MPIError(ERR_ARG) and is not cached: every collective surfaces it."""
    cached = comm.__dict__.get("_coll_hier_plan")
    if cached is not None:
        return None if cached is _NO_PLAN else cached
    spec = _split_var.get()
    names = H.node_names(comm) \
        if (spec or "auto").strip().lower() == "auto" else None
    split = H.parse_split(spec, comm.size, devices=names)
    if split is None or split[0] < 2 or split[1] < 2:
        comm._coll_hier_plan = _NO_PLAN
        return None
    plan = comm._coll_hier_plan = H.grid(comm, *split)
    _out.verbose(1, "comm cid=%s: %dx%d DCN x ICI grid",
                 getattr(comm, "cid", -1), plan.n_dcn, plan.n_ici)
    return plan


# ---------------------------------------------------------------------------
# selection


def _det_ok(deterministic: Optional[str]) -> Optional[str]:
    det = deterministic if deterministic is not None \
        else _dev._default_det.get()
    det = det or None
    if det not in (None, "ring", "linear"):
        raise errors.MPIError(
            errors.ERR_ARG,
            f"coll_hier: deterministic={det!r} (expected None, 'ring' or "
            "'linear' — silent fallthrough would void the "
            "fixed-reduction-order guarantee)")
    return det


_sw_cache: dict = {}


def _switchpoint(kind: str, nbytes: int, dtype: str, mesh_shape) -> str:
    """'hier' | 'flat' | '' from the measured table (coll/cuda's rule
    shape: per (op, dtype, mesh) the largest log2 <= the payload's bucket
    wins). A table that does not load counts ``tune_table_errors``, warns
    once per path and leaves the built-in choice."""
    path = _switch_var.get().strip()
    if not path:
        return ""
    table = _sw_cache.get(path)
    if table is None:
        try:
            with open(path, encoding="utf-8") as f:
                entries = json.load(f)
        except (OSError, ValueError) as exc:
            _tobs.table_error("coll_hier_switchpoints", path, exc)
            entries = []
        table = {}
        for e in entries if isinstance(entries, list) else []:
            key = (str(e.get("op", "")), str(e.get("dtype", "")),
                   tuple(int(v) for v in e.get("mesh", ())))
            table.setdefault(key, []).append(
                (int(e.get("log2", 0)), str(e.get("algorithm", ""))))
        for rules in table.values():
            rules.sort()
        _sw_cache[path] = table
    rules = table.get((kind, dtype, tuple(mesh_shape)))
    if not rules:
        return ""
    bucket = _algo.log2_bucket(nbytes)
    best = ""
    for lg, alg in rules:
        if bucket >= lg:
            best = alg
        else:
            break
    return best


def _select(kind: str, comm, nbytes: int, dtype: str,
            det: Optional[str]) -> Optional[H.Grid]:
    """The two-level-vs-flat decision: the plan, or None = fall through.
    'ring' is always flat (the two-level chunk order cannot reproduce the
    flat ring's); 'linear' stays two-level through the rank-order
    compositions."""
    plan = _plan(comm)  # may raise MPIError(ERR_ARG) on a bad spec
    if plan is None:
        return None
    if det == "ring":
        return None
    if nbytes == 0 or nbytes < _min_bytes_var.get():
        return None
    forced = _force_var.get()
    if forced == "flat":
        return None
    if forced == "hier":
        return plan
    if _switchpoint(kind, nbytes, dtype, (plan.n_dcn, plan.n_ici)) == "flat":
        return None
    return plan


def _inner_algo(kind: str, nbytes: int, dtype, opn, plan: H.Grid,
                chunk_rows: int) -> str:
    """The ICI phase's algorithm: 'xla' = coll/device's slots,
    'ring' / 'bidir' = coll/cuda's ring schedules on ``low``. 'auto' asks
    coll/cuda's switchpoint table keyed on the inner shape, only when
    coll/cuda is on."""
    mode = _inner_var.get()
    if mode == "xla":
        return "xla"
    if dtype not in _cuda._SUPPORTED_DTYPES \
            or opn.name not in _cuda._SUPPORTED_OPS:
        return "xla"
    if mode == "auto":
        if _cuda._enable_var.get() != "on":
            return "xla"
        sw = _cuda._switchpoint(kind, nbytes, _dtype_name(dtype),
                                (plan.n_ici,))
        if sw not in ("ring", "bidir"):
            return "xla"
        mode = sw
    if mode == "bidir" and chunk_rows < 2:
        mode = "ring"
    return mode


# ---------------------------------------------------------------------------
# dispatch plumbing


def _cuda_stacked(comm) -> bool:
    try:
        return _cuda.CollCuda().query(comm) >= 0
    except Exception:  # a query error means "not stacked", as in
        return False   # comm_select itself


def _flat_fn(comm, slot: str):
    """The slot one priority level down: coll/cuda's when it stacked on
    this comm and serves the slot, else coll/device's."""
    if slot in _CUDA_SLOTS and _cuda_stacked(comm):
        return getattr(_cuda, slot)
    return getattr(_dev, slot)


def _fallthrough(comm, slot: str, *args, **kw):
    pvar.record("hier_fallthrough")
    return _flat_fn(comm, slot)(comm, *args, **kw)


#: the trace span of a launch (the reference's name)
_SPAN = "launch"


def _launch(launcher, op: str, plan: H.Grid, comm, nbytes: int, dtype: str,
            slot: str):
    """Dispatch under the flight guard, with a coll_hier trace span naming
    the grid and a tune sample under provider 'hier' when those planes
    are up."""
    obs = _tobs.OBSERVER
    if obs is not None:
        launcher = obs.timed("hier", op, "hier", comm, nbytes, dtype,
                             launcher, mesh=(plan.n_dcn, plan.n_ici))
    fl = _flight.FLIGHT
    tok = fl.enter(slot, getattr(comm, "cid", -1), nbytes) \
        if fl is not None else None
    try:
        rec = _trace.RECORDER
        if rec is None:
            return launcher()
        t0 = _trace.now()
        out = launcher()
        rec.record(_SPAN, "coll_hier", t0, _trace.now(),
                   {"op": op, "grid": f"{plan.n_dcn}x{plan.n_ici}"})
        return out
    finally:
        if tok is not None:
            fl.exit(tok)


def _account(kind: str, comm, nbytes: int, dtype: str, plan: H.Grid,
             linear: bool = False, wire: Optional[str] = None,
             parts=None) -> None:
    """Per-level attribution: the launch and per-level byte pvars
    (nominal DCN model and the wire bytes) and, when the monitoring plane
    is up, the link split across the ICI and DCN neighbour edges. ``parts``
    — (nbytes, dtype name, wire) per dtype group — covers the fused multi
    form, whose buckets can mix compressed float and exact int payloads;
    the models are linear in nbytes."""
    if parts is None:
        parts = ((nbytes, dtype, wire),)
    ici_b = dcn_b = wire_b = 0.0
    peers: dict = {}
    for nb, dt, w in parts:
        isz = _itemsize(dt) if w else 0
        i_b, d_b = _algo.hier_level_bytes(kind, plan.n_dcn, plan.n_ici, nb,
                                          linear=linear)
        ici_b += i_b
        dcn_b += d_b
        wire_b += _algo.hier_wire_bytes(kind, plan.n_dcn, plan.n_ici, nb,
                                        wire=w, itemsize=isz, linear=linear)
        tm = _mon.TRAFFIC
        if tm is not None:
            for peer, b in _algo.hier_per_peer(
                    kind, comm.rank, plan.n_dcn, plan.n_ici, nb,
                    linear=linear, wire=w, itemsize=isz).items():
                peers[peer] = peers.get(peer, 0.0) + b
    pvar.record("hier_launches")
    pvar.record("hier_ici_bytes", int(ici_b))
    pvar.record("hier_dcn_bytes", int(dcn_b))
    pvar.record("hier_dcn_wire_bytes", int(wire_b))
    tm = _mon.TRAFFIC
    if tm is not None:
        tm.coll(kind, comm, nbytes, dtype=dtype, per_peer=peers)
        tm.hier(kind, ici_b, dcn_b, wire_b)


def _itemsize(dtype: str) -> int:
    """Element bytes of a dtype name (0 for an unknown one: the wire
    accounting then keeps the nominal model)."""
    dt = getattr(torch, dtype, None)
    return dt.itemsize if isinstance(dt, torch.dtype) else 0


# ---------------------------------------------------------------------------
# the phases


def _ici_rs(low, flat: torch.Tensor, opn, inner: str) -> torch.Tensor:
    """This low rank's chunk of the reduce-scatter of ``flat`` (a multiple
    of low.size elements): coll/cuda's ring or bidir schedule on low's
    arena, or coll/device's slot ('xla')."""
    if inner == "xla":
        return C.reduce_scatter(flat, low, opn, scatter_dim=0, tiled=True)
    out = flat.new_empty(flat.numel() // low.size)
    ep = _cuda._arena(low, "rs", flat.nbytes)
    ep.run(K.reduce_scatter(ep, flat, opn.name, inner, 1, out))
    return out


def _ici_ag(low, part: torch.Tensor, inner: str) -> torch.Tensor:
    """The inverse of :func:`_ici_rs`: every low rank's chunk, in low
    rank order (the same algorithm, so the chunk placement round-trips)."""
    if inner == "xla":
        return C.allgather(part, low, tiled=True, gather_dim=0)
    out = part.new_empty(low.size * part.numel())
    ep = _cuda._arena(low, "ag", part.nbytes)
    ep.run(K.allgather(ep, part, inner, out))
    return out


def _split_level(flat: torch.Tensor, opn, inner: str, plan: H.Grid,
                 wire: Optional[str] = None) -> torch.Tensor:
    """The split-level allreduce of a 1-D tensor of a multiple of n_ici
    elements: ICI reduce_scatter -> DCN allreduce of the 1/n_ici chunk ->
    ICI allgather. ``wire`` swaps the DCN step for the compressed
    transport (``H.dcn_wire_allreduce``)."""
    part = _ici_rs(plan.low, flat, opn, inner)
    if wire is not None:
        part = H.dcn_wire_allreduce(part, wire, plan.up)
    else:
        part = C.allreduce(part, plan.up, opn)
    return _ici_ag(plan.low, part, inner)


def _padded_split_level(x: torch.Tensor, opn, det, plan: H.Grid,
                        wire: Optional[str]) -> torch.Tensor:
    """``x`` reduced over the grid: the rank-order fold under 'linear',
    else the split-level schedule on the flat payload zero-padded to a
    multiple of n_ici."""
    if det == "linear":
        return H.allreduce_rankorder(x, plan.low, plan.up, opn)
    size = x.numel()
    pad = (-size) % plan.n_ici
    inner = _inner_algo("allreduce", x.nbytes, x.dtype, opn, plan,
                        (size + pad) // plan.n_ici)
    flat = x.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    red = _split_level(flat, opn, inner, plan, wire)
    return red[:size].reshape(x.shape)


# ---------------------------------------------------------------------------
# slots


def _allreduce_plan(comm, sendbuf, op, deterministic):
    """(plan, opn, det, wire) of a two-level allreduce, or None when the
    call falls through."""
    det = _det_ok(deterministic)
    if not isinstance(sendbuf, torch.Tensor) or comm.size == 1 \
            or _dev._stages(op, sendbuf):
        return None
    plan = _select("allreduce", comm, sendbuf.nbytes,
                   _dtype_name(sendbuf.dtype), det)
    if plan is None:
        return None
    opn = _dev._opn("allreduce", op, sendbuf.dtype)
    _dev._check_buf("allreduce", comm, sendbuf)
    # resolve the wire before accounting: an unknown coll_hier_dcn_dtype
    # raises here, at every call, with nothing counted
    wire = _wire_dtype("allreduce", sendbuf.dtype, det, opn)
    return plan, opn, det, wire


def allreduce_dev(comm, sendbuf, op=op_mod.SUM,
                  deterministic: Optional[str] = None):
    got = _allreduce_plan(comm, sendbuf, op, deterministic)
    if got is None:
        return _fallthrough(comm, "allreduce_dev", sendbuf, op,
                            deterministic)
    plan, opn, det, wire = got
    nb, dt = sendbuf.nbytes, _dtype_name(sendbuf.dtype)
    _account("allreduce", comm, nb, dt, plan, linear=det == "linear",
             wire=wire)
    return _launch(lambda: _padded_split_level(sendbuf, opn, det, plan,
                                               wire),
                   "allreduce", plan, comm, nb, dt, "allreduce_dev")


def bcast_dev(comm, buf, root: int = 0):
    if comm.size == 1 or not isinstance(buf, torch.Tensor) \
            or _dev._stages(None, buf):
        return _fallthrough(comm, "bcast_dev", buf, root)
    plan = _select("bcast", comm, buf.nbytes, _dtype_name(buf.dtype), None)
    if plan is None:
        return _fallthrough(comm, "bcast_dev", buf, root)
    _dev._check_buf("bcast", comm, buf)
    _dev._check_root("bcast", comm, root)
    nb, dt = buf.nbytes, _dtype_name(buf.dtype)
    _account("bcast", comm, nb, dt, plan)
    ici = plan.n_ici
    return _launch(lambda: H.bcast(buf, root // ici, root % ici, plan.low,
                                   plan.up),
                   "bcast", plan, comm, nb, dt, "bcast_dev")


def allgather_dev(comm, sendbuf):
    if comm.size == 1 or not isinstance(sendbuf, torch.Tensor) \
            or _dev._stages(None, sendbuf):
        return _fallthrough(comm, "allgather_dev", sendbuf)
    plan = _select("allgather", comm, sendbuf.nbytes,
                   _dtype_name(sendbuf.dtype), None)
    if plan is None:
        return _fallthrough(comm, "allgather_dev", sendbuf)
    _dev._check_buf("allgather", comm, sendbuf)
    nb, dt = sendbuf.nbytes, _dtype_name(sendbuf.dtype)
    _account("allgather", comm, nb, dt, plan)
    return _launch(lambda: H.gather_rankorder(sendbuf, plan.low, plan.up),
                   "allgather", plan, comm, nb, dt, "allgather_dev")


def alltoall_dev(comm, sendbuf):
    if comm.size == 1 or not isinstance(sendbuf, torch.Tensor) \
            or sendbuf.dim() < 1 or sendbuf.shape[0] % comm.size \
            or _dev._stages(None, sendbuf):
        # an indivisible dim 0 falls through: coll/device raises the
        # same MPIError(ERR_COUNT) the flat contract specifies
        return _fallthrough(comm, "alltoall_dev", sendbuf)
    plan = _select("alltoall", comm, sendbuf.nbytes,
                   _dtype_name(sendbuf.dtype), None)
    if plan is None:
        return _fallthrough(comm, "alltoall_dev", sendbuf)
    _dev._check_buf("alltoall", comm, sendbuf)
    nb, dt = sendbuf.nbytes, _dtype_name(sendbuf.dtype)
    _account("alltoall", comm, nb, dt, plan)
    return _launch(lambda: H.alltoall(sendbuf, plan.low, plan.up),
                   "alltoall", plan, comm, nb, dt, "alltoall_dev")


def reduce_scatter_block_dev(comm, sendbuf, op=op_mod.SUM,
                             deterministic: Optional[str] = None):
    det = _det_ok(deterministic)
    if not isinstance(sendbuf, torch.Tensor) or comm.size == 1 \
            or sendbuf.dim() < 1 or sendbuf.shape[0] % comm.size \
            or _dev._stages(op, sendbuf):
        return _fallthrough(comm, "reduce_scatter_block_dev", sendbuf, op,
                            deterministic)
    plan = _select("reduce_scatter_block", comm, sendbuf.nbytes,
                   _dtype_name(sendbuf.dtype), det)
    if plan is None:
        return _fallthrough(comm, "reduce_scatter_block_dev", sendbuf, op,
                            deterministic)
    opn = _dev._opn("reduce_scatter_block", op, sendbuf.dtype)
    _dev._check_buf("reduce_scatter_block", comm, sendbuf)
    wire = _wire_dtype("reduce_scatter_block", sendbuf.dtype, det, opn)
    nb, dt = sendbuf.nbytes, _dtype_name(sendbuf.dtype)
    _account("reduce_scatter_block", comm, nb, dt, plan,
             linear=det == "linear", wire=wire)
    if det == "linear":
        def run():
            return H.reduce_scatter_block_rankorder(sendbuf, plan.low,
                                                    plan.up, opn)
    else:
        def run():
            return H.reduce_scatter_rankmajor(sendbuf, plan.low, plan.up,
                                              opn, wire=wire)
    return _launch(run, "reduce_scatter_block", plan, comm, nb, dt,
                   "reduce_scatter_block_dev")


# ---------------------------------------------------------------------------
# the fused bucketed allreduce: coll/device's bucket plan (geometry is
# mode-independent), each bucket one two-level reduction


def _multi_parts(leaves, det, opn):
    """Dtype-grouped (nbytes, dtype name, wire) accounting parts of a
    fused launch; resolving every group's wire here (before
    ``_account``) keeps the unknown-cvar MPIError per call with nothing
    counted."""
    groups: Dict[torch.dtype, int] = {}
    for b in leaves:
        groups[b.dtype] = groups.get(b.dtype, 0) + b.nbytes
    return tuple((nb, _dtype_name(dt),
                  _wire_dtype("allreduce_multi", dt, det, opn))
                  for dt, nb in groups.items())


def _hier_fuse_prep(comm, leaves, treedef, opn, det, plan: H.Grid):
    """Plan the buckets (``zero/layout._FusePlan`` over
    ``coll_device_bucket_bytes``) with each bucket's wire and inner
    algorithm; the launcher packs each bucket's current contents, reduces
    it over the grid and splits it back. Under 'linear' the body is the
    rank-order fold, and concatenation never changes an element's fold
    order, so fused == per-buffer bit for bit."""
    from ompi_tpu_torch.zero import layout as zl

    metas = zl._fuse_metas(leaves)
    fplan = zl._FusePlan(metas, int(_dev.bucket_var.get()))
    buckets = []
    for idxs in fplan.buckets:
        dtype = leaves[idxs[0]].dtype
        wire = _wire_dtype("allreduce_multi", dtype, det, opn)
        buckets.append((idxs, wire))

    def launch():
        outs = [None] * len(leaves)
        for idxs, wire in buckets:
            flat = zl.pack(leaves, idxs, 0)
            red = _padded_split_level(flat, opn, det, plan, wire) \
                if flat.numel() else flat.clone()
            pvar.record("hier_fused_launches")
            for i, leaf in zip(idxs, zl.split(red, metas, idxs)):
                outs[i] = leaf
        pvar.record("coll_device_fused_bytes", fplan.nbytes)
        return zl.tree_unflatten(treedef, outs)
    return launch


def _multi_plan(comm, bufs, op, deterministic):
    """(plan, opn, det, leaves, treedef, nbytes, dtype name), or None when
    the call falls through."""
    from ompi_tpu_torch.zero import layout as zl

    det = _det_ok(deterministic)
    leaves, treedef = zl.tree_flatten(bufs)
    if comm.size == 1 or not leaves \
            or not all(isinstance(t, torch.Tensor) for t in leaves) \
            or _dev._stages(op, *leaves):
        return None
    nb = sum(t.nbytes for t in leaves)
    dt = _dtype_name(leaves[0].dtype)
    plan = _select("allreduce_multi", comm, nb, dt, det)
    if plan is None:
        return None
    opn = None
    for t in leaves:
        _dev._check_buf("allreduce_multi", comm, t)
        opn = _dev._opn("allreduce_multi", op, t.dtype)
    return plan, opn, det, leaves, treedef, nb, dt


def allreduce_multi_dev(comm, bufs, op=op_mod.SUM,
                        deterministic: Optional[str] = None):
    got = _multi_plan(comm, bufs, op, deterministic)
    if got is None:
        return _fallthrough(comm, "allreduce_multi_dev", bufs, op,
                            deterministic)
    plan, opn, det, leaves, treedef, nb, dt = got
    _account("allreduce_multi", comm, nb, dt, plan, linear=det == "linear",
             parts=_multi_parts(leaves, det, opn))
    launcher = _hier_fuse_prep(comm, leaves, treedef, opn, det, plan)
    return _launch(launcher, "allreduce_multi", plan, comm, nb, dt,
                   "allreduce_multi_dev")


# ---------------------------------------------------------------------------
# persistent inits: the prep either wraps the two-level launcher with
# per-start accounting or hands the whole init to coll/device's prep


def _allreduce_pprep(comm, sendbuf, op=op_mod.SUM,
                     deterministic: Optional[str] = None):
    got = _allreduce_plan(comm, sendbuf, op, deterministic)
    if got is None:
        pvar.record("hier_fallthrough")
        return _dev._allreduce_prep(comm, sendbuf, op, deterministic)
    # the wire resolves at init, like the plan: a persistent handle keeps
    # the schedule it was built with across starts
    plan, opn, det, wire = got
    nb, dt = sendbuf.nbytes, _dtype_name(sendbuf.dtype)

    def run():
        _account("allreduce", comm, nb, dt, plan, linear=det == "linear",
                 wire=wire)
        return _launch(lambda: _padded_split_level(sendbuf, opn, det, plan,
                                                   wire),
                       "allreduce", plan, comm, nb, dt, "allreduce_dev")
    return run


def _allreduce_multi_pprep(comm, bufs, op=op_mod.SUM,
                           deterministic: Optional[str] = None):
    got = _multi_plan(comm, bufs, op, deterministic)
    if got is None:
        pvar.record("hier_fallthrough")
        return _dev._allreduce_multi_prep(comm, bufs, op, deterministic)
    plan, opn, det, leaves, treedef, nb, dt = got
    # the per-bucket wires resolve at init; the accounting parts are
    # captured beside them, so every start reports what it moves
    parts = _multi_parts(leaves, det, opn)
    raw = _hier_fuse_prep(comm, leaves, treedef, opn, det, plan)

    def run():
        _account("allreduce_multi", comm, nb, dt, plan,
                 linear=det == "linear", parts=parts)
        return _launch(raw, "allreduce_multi", plan, comm, nb, dt,
                       "allreduce_multi_dev")
    return run


def _pinit(prep, name: str):
    def pslot(comm, buf, *args, **kwargs):
        return _dev.PersistentDeviceRequest(
            prep(comm, buf, *args, **kwargs), _dev._event_device(comm, buf))
    pslot.__name__ = name
    pslot.__doc__ = (f"Persistent two-level {name[:-len('_init_dev')]}: see "
                     ":class:`coll.device.PersistentDeviceRequest`.")
    return pslot


allreduce_init_dev = _pinit(_allreduce_pprep, "allreduce_init_dev")
allreduce_multi_init_dev = _pinit(_allreduce_multi_pprep,
                                  "allreduce_multi_init_dev")


class CollHier(registry.Component):
    """The component comm_select ranks."""

    NAME = "hier"
    PRIORITY = 70  # above coll/cuda's 60: the two-level schedule decides
    # first and falls through the same staged chain for what it declines

    def query(self, comm) -> int:
        if _enable_var.get() != "on" or comm.size == 1:
            return -1
        if not device_plane.active():
            return -1
        # no plan or split validation here: comm_select swallows query
        # errors, so a malformed coll_hier_split surfaces at the first
        # collective instead
        return self.PRIORITY

    def slots(self, comm):
        return {
            "allreduce_dev": allreduce_dev,
            "bcast_dev": bcast_dev,
            "allgather_dev": allgather_dev,
            "alltoall_dev": alltoall_dev,
            "reduce_scatter_block_dev": reduce_scatter_block_dev,
            "allreduce_multi_dev": allreduce_multi_dev,
            "allreduce_init_dev": allreduce_init_dev,
            "allreduce_multi_init_dev": allreduce_multi_init_dev,
        }
