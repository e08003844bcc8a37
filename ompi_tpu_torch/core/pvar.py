"""Performance variables + software performance counters (SPC).

Reference: opal/mca/base/mca_base_pvar.c (MPI_T performance variables) and
ompi/runtime/ompi_spc.h:46-153 (SPC_RECORD() in the API layer). A single
process-wide counter table serves both roles; the MPI_T-style session API
is :func:`session` / ``read``. The port's own copy: ``WELL_KNOWN`` holds
only the pvars this package records.
"""

from __future__ import annotations

import threading
from typing import Dict

_counters: Dict[str, int] = {}
_watermarks: Dict[str, int] = {}
_lock = threading.Lock()

WELL_KNOWN = (
    # coll/cuda (hand-written ring collectives over peer-mapped
    # arenas): collective calls served, calls handed to coll/device (or,
    # from the fused slots, back to their caller's unfused sequence),
    # and payload bytes per algorithm family
    "coll_cuda_launches", "coll_cuda_fallthrough",
    "coll_cuda_ring_bytes", "coll_cuda_bidir_bytes",
    "coll_cuda_linear_bytes",
    # coll/cuda's fused slots: buckets through fused_rs_update_dev plus
    # allgather_matmul_dev calls
    "coll_cuda_fused_launches",
    # coll/device (the coll/xla counterpart, coll_xla_device's twin):
    # calls its slots served (every blocking call, nonblocking call and
    # persistent start, one-rank comms included); Allreduce_multi payload
    # bytes (coll_xla_fused_bytes)
    "coll_device_launches", "coll_device_fused_bytes",
    # zero/ (coll/device bucket collectives + ZeroOptimizer): per-bucket
    # reduce-scatters and allgathers, payload and pad bytes per cycle,
    # allgathers of unchanged (all-frozen) buckets skipped
    "zero_rs_launches", "zero_ag_launches", "zero_fused_bytes",
    "zero_pad_bytes", "zero_ag_skipped",
    # ZeroOptimizer(overlap=True): reduce-scatter buckets flushed before
    # the cycle's final Pready; Zero3Optimizer's stream: fetches that
    # found their gather started (hits) or not (misses), nanoseconds
    # waited on a started gather, gathers started, layers released, fused
    # gather-and-matmul products, and the high watermarks of the shard,
    # largest-layer and resident parameter bytes
    "zero_overlap_flushes", "zero_prefetch_hits", "zero_prefetch_misses",
    "zero_prefetch_late_ns", "zero3_gathers", "zero3_releases",
    "zero3_fused_matmuls", "zero3_shard_bytes", "zero3_layer_bytes",
    "zero3_resident_bytes",
    # part/ (MPI-4 partitioned): Psend / Precv epochs started, partitions
    # marked ready, successful Parrived probes, Pallreduce buckets flushed
    # and those flushed before the cycle's final Pready
    "part_send_start", "part_recv_start", "part_pready", "part_parrived",
    "part_bucket_flushes", "part_overlap_flushes",
    # device plane transport: arenas mapped (one per comm and size
    # class), their device bytes (high watermark), and the wall spent
    # waiting on ring neighbours' hop counters
    "device_plane_arenas", "device_plane_arena_bytes",
    "device_plane_wait_ns",
    # osc/cuda (device-resident one-sided windows, the osc_pallas_*
    # twins): windows created; Put/Put_strided, Get/Get_epoch and
    # Accumulate calls; Fences; edge-coloured rounds (the reference's);
    # exchanges run (the host steps that move them); origin payload bytes
    # queued; windows left to the host window and ops folded on the host
    # (host-assisted); calls that rode the active-message plane (PSCW,
    # passive target, the synchronous gets and atomics)
    "osc_cuda_windows", "osc_cuda_put", "osc_cuda_get", "osc_cuda_acc",
    "osc_cuda_fence", "osc_cuda_rounds", "osc_cuda_exchanges",
    "osc_cuda_bytes", "osc_cuda_fallthrough", "osc_cuda_am_ops",
    # osc (the host window, the reference's names): Put / Put_strided,
    # Get / Get_strided and Accumulate calls, Fences
    "osc_put", "osc_get", "osc_acc", "osc_fence",
    # osc/device_epoch (the compiled-fence device window, the reference's
    # names): Put / Accumulate / Get calls queued; ops sent to the host
    # path (non-elementwise accumulates, passive target, PSCW)
    "osc_device_epoch_op", "osc_device_fallbacks",
    # shmem/ (the reference's names): symmetric bytes allocated; puts
    # (put, put_nbi, iput, the signalled puts' data), gets (get, iget) and
    # atomics (fetch-ops, compare-and-swap, signal updates)
    "shmem_alloc_bytes", "shmem_put", "shmem_get", "shmem_atomic",
    # pml/ob1 (the reference's names): sends and receives posted, eager
    # and rendezvous sends (streamed, or offered for single copy), RNDV
    # fragments, arrivals that found no posted receive or came out of
    # sequence, probes that matched; the linear barrier's calls
    "isend", "irecv", "eager", "rndv", "rndv_sc", "rndv_frag",
    "unexpected", "out_of_sequence", "matched_probes", "barrier",
    # the MPI point-to-point entries (Send / send)
    "send",
    # btl/sm and btl/tcp payload bytes; mpool's receive bounce pool
    "bytes_sent", "bytes_received", "mpool_hits", "mpool_misses",
    # smsc/cma: single-copy pulls and their bytes
    "smsc_single_copies", "smsc_bytes",
    # pml/accel_p2p: device-tensor sends and receives
    "accel_p2p_send", "accel_p2p_recv",
    # the host collectives (coll/basic, base_algos, coll/tuned; the
    # reference's names): calls per collective family
    "bcast", "reduce", "allreduce", "gather", "scatter", "allgather",
    "alltoall", "reduce_scatter", "scan", "exscan",
    # coll/accelerator: device-tensor calls staged through the host
    # collectives; coll/sync: barriers injected; coll/adapt: segmented
    # ibcast / ireduce calls
    "coll_accelerator_staged", "sync_injected_barriers", "adapt_ibcast",
    "adapt_ireduce",
    # ops/moe: routed tokens past the experts' capacity (dropped); the
    # monitoring plane's per-expert token counts
    "serve_dropped_tokens", "monitoring_expert_tokens",
    # core/mpool's registration cache (the datatype engine's span tables
    # and device index vectors): hits and LRU evictions; core/memhooks:
    # release notices fanned out to the caches
    "rcache_hits", "rcache_evictions", "mem_hooks_released",
    # coll/hier (the two-level ICI x DCN schedules): launches, fused
    # bucket launches, calls handed one priority level down; per-level
    # send-side bytes (monitoring/algo's models: ICI, nominal DCN, and
    # what the DCN phase moves under a compressed wire format)
    "hier_launches", "hier_fused_launches", "hier_fallthrough",
    "hier_ici_bytes", "hier_dcn_bytes", "hier_dcn_wire_bytes",
    # coll/han (host two-level compositions): calls per collective
    "han_allreduce", "han_reduce", "han_bcast", "han_barrier",
    "han_allgather",
    # zero/layout.ErrorFeedback: quantise-at-source applications and the
    # wire bytes of the buckets they quantised
    "zero_ef_steps", "zero_ef_bytes",
    # the tune observatory: samples taken, samples past tune_max_keys,
    # switchpoint-table files that did not load, regression verdicts, and
    # the PerfDB's loads, saves and unreadable files (beside them the
    # dynamic family tune_obs_<op>_<provider>)
    "tune_samples", "tune_dropped", "tune_table_errors",
    "tune_regressions", "tune_db_loads", "tune_db_saves", "tune_db_errors",
    # the skew plane: ring records, overwrites and depth watermark; this
    # rank's exposed wait, the worst arrival skew, persistent stragglers
    # named, the live lag watermark (beside them skew_op_wait_ns_<op>)
    "skew_records", "skew_dropped", "skew_ring_depth",
    "skew_exposed_wait_ns", "skew_arrival_skew_ns", "skew_stragglers",
    "skew_live_lag_ns",
    # the monitoring plane (the reference's names): send-side messages and
    # bytes, all contexts and per context, collective launches recorded,
    # the link-imbalance gauge (level 2); beside them the dynamic
    # families monitoring_tx_{msgs,bytes}_s<src>_d<dst>_<ctx>,
    # monitoring_link_bytes_d<dim>_r<a>_r<b> and
    # monitoring_expert_tokens_e<e>
    "monitoring_msgs", "monitoring_bytes", "monitoring_p2p_msgs",
    "monitoring_p2p_bytes", "monitoring_coll_msgs", "monitoring_coll_bytes",
    "monitoring_osc_msgs", "monitoring_osc_bytes", "monitoring_part_msgs",
    "monitoring_part_bytes", "monitoring_coll_launches",
    "monitoring_link_imbalance_permille",
    # serve/: timed requests, tokens dispatched, rerouted, and shipped
    # over the DCN leg (tokens and bytes)
    "serve_requests", "serve_tokens", "serve_rerouted_tokens",
    "serve_dcn_overflow_tokens", "serve_dcn_overflow_bytes",
    # pml/v (message logging, the reference's names): application sends
    # logged by the sender, and messages re-sent from the log
    "vprotocol_logged_sends", "vprotocol_resends",
    # coll/basic's neighbourhood collectives (the reference's names):
    # calls per form, blocking and nonblocking
    "neighbor_allgather", "neighbor_alltoall", "neighbor_allgatherv",
    "neighbor_alltoallv",
    # coll/inter (the reference's names): intercommunicator barriers,
    # bcasts (buffer and object), allreduces and allgathers
    "inter_barrier", "inter_bcast", "inter_allreduce", "inter_allgather",
    # dpm: processes started by Comm_spawn / Comm_spawn_multiple
    "spawned_procs",
    # io/ (the reference's names): files opened, bytes read and written
    # through the fbtl path, fcoll aggregator writes retried after a
    # short result
    "file_open", "file_read_bytes", "file_write_bytes",
    "fcoll_write_retries",
    # io/async_ckpt (the reference's names): snapshots begun and
    # committed, chunks and bytes staged, drain and write wall in ns,
    # write retries and synchronous degrades, incremental chunks
    # skipped, restores and their fallbacks, digest mismatches, injected
    # failures
    "ckpt_snapshots", "ckpt_commits", "ckpt_chunks", "ckpt_bytes",
    "ckpt_d2h_ns", "ckpt_write_ns", "ckpt_write_retries",
    "ckpt_fallback_sync", "ckpt_incremental_skipped",
    "ckpt_restores", "ckpt_restore_fallbacks",
    "ckpt_digest_mismatches", "ckpt_injected_failures",
    # ingest/ (the reference's names): uploads started, units and bytes
    # landed, Parrived probes answered True, first steps released before
    # the tail landed, gate wall in ns, units voided by a cancel or an
    # error, compiles run start to end beside an upload, and the deepest
    # per-stream queue of puts in flight
    "ingest_uploads", "ingest_units", "ingest_bytes", "ingest_parrived",
    "ingest_early_starts", "ingest_gate_ns", "ingest_cancelled",
    "ingest_compile_overlaps", "ingest_inflight",
    # ft/ (the reference's names): heartbeats sent, faults and
    # revocations applied by the progress sweep, the eventful sweeps'
    # wall in ns
    "ft_heartbeats", "ft_faults_observed", "ft_revokes_applied",
    "ft_sweep_ns",
    # elastic/ (the reference's names): shrinks survived, joiners
    # admitted, bytes allgathered for the in-memory re-shard, recovery
    # wall in ns, checkpoint fallbacks taken, checkpoints written, and
    # the injected kills and delays
    "elastic_shrinks", "elastic_hot_joins", "elastic_reshard_bytes",
    "elastic_recovery_ns", "elastic_fallback_restores",
    "elastic_checkpoints", "elastic_injected_kills",
    "elastic_injected_delays",
    # the store client: connect attempts retried
    "kvstore_connect_retries",
    # trace/ (the reference's names): spans lost to ring-buffer
    # overflow; the per-(op, size-bin) log2 latency histograms are the
    # trace_hist_ family below
    "trace_dropped",
    # telemetry/ (the reference's names): flight-recorder entries and
    # their in-flight depth watermark, sampler ticks and their cost,
    # watchdog sweeps and hang verdicts dumped
    "telemetry_flight_ops", "telemetry_inflight", "telemetry_samples",
    "telemetry_sample_ns", "telemetry_watchdog_sweeps", "telemetry_hangs",
    # prof/ (the reference's names): the canonical phases' wall (any
    # other phase is the prof_phase_ family below), cross-thread phase
    # overlap, host<->device bytes, time and peak bandwidth (MB/s
    # watermark) per direction, and the compile counterparts (see
    # prof/__init__.py) and the persistent cache's, which stay 0
    "prof_phase_staging_ns", "prof_phase_compile_ns",
    "prof_phase_train_ns", "prof_phase_teardown_ns",
    "prof_phase_snapshot_ns", "prof_phase_prefetch_ns",
    "prof_phase_overlap_ns",
    "prof_xfer_h2d_bytes", "prof_xfer_h2d_ns",
    "prof_xfer_d2h_bytes", "prof_xfer_d2h_ns",
    "prof_xfer_h2d_bw_mbps", "prof_xfer_d2h_bw_mbps",
    "prof_compile_hits", "prof_compile_misses", "prof_compile_ns",
    "prof_compile_cache_hits", "prof_compile_cache_misses",
)

#: families of pvars named at run time: the monitoring plane's per-link,
#: per-peer and per-expert families (see above), ``profile.timing``'s
#: ``profile_<op>_calls`` and ``profile_<op>_ns``, one pair per MPI call
#: it saw, the trace plane's histogram bins
#: ``trace_hist_<op>_sz<s>_lat<l>`` and the phase ledger's
#: ``prof_phase_<name>_ns`` for every phase name
WELL_KNOWN_PREFIXES = ("monitoring_tx_", "monitoring_link_bytes_",
                       "monitoring_expert_tokens_e", "profile_",
                       "trace_hist_", "prof_phase_", "tune_obs_",
                       "skew_op_wait_ns_")


def is_well_known(name: str) -> bool:
    """A name of :data:`WELL_KNOWN`, or of a family of
    :data:`WELL_KNOWN_PREFIXES`."""
    return name in WELL_KNOWN or name.startswith(WELL_KNOWN_PREFIXES)


def record(name: str, value: int = 1) -> None:
    """SPC_RECORD equivalent — add to a counter."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def record_hwm(name: str, value: int) -> None:
    """High-watermark pvar update."""
    with _lock:
        if value > _watermarks.get(name, 0):
            _watermarks[name] = value


def read(name: str) -> int:
    with _lock:
        if name in _counters:
            return _counters[name]
        return _watermarks.get(name, 0)


def snapshot() -> Dict[str, int]:
    """Every counter, and every watermark as ``<name>_hwm``."""
    with _lock:
        out = dict(_counters)
        out.update({k + "_hwm": v for k, v in _watermarks.items()})
        return out


class session:
    """MPI_T-style pvar session: delta-reads counters from session start.

    Counter pvars read as deltas; watermark pvars read as the increase over
    the watermark at session start.
    """

    def __init__(self) -> None:
        with _lock:
            self._base_counters = dict(_counters)
            self._base_hwm = dict(_watermarks)

    def read(self, name: str) -> int:
        with _lock:
            if name in _counters or name in self._base_counters:
                return _counters.get(name, 0) - \
                    self._base_counters.get(name, 0)
            return max(0, _watermarks.get(name, 0) -
                       self._base_hwm.get(name, 0))

    def snapshot(self) -> Dict[str, int]:
        """Every pvar as :func:`snapshot` names it, less its value at
        session start (the trace plane decodes its histograms from it)."""
        cur = globals()["snapshot"]()
        base = dict(self._base_counters)
        base.update({k + "_hwm": v for k, v in self._base_hwm.items()})
        return {k: v - base.get(k, 0) for k, v in cur.items()}
