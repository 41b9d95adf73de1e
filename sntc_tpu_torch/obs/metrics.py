"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms with labels.

Counterpart of ``sntc_tpu/obs/metrics.py`` (``MetricsRegistry``,
``registry``, ``reset_registry``, ``inc``, ``set_gauge``, ``observe``,
``snapshot``), holding only the series that the serving engine and the
resilience modules count into: batches and rows committed, batch
duration, the event stream (retries among them), the tracer's evicted
spans, the fused segments' roofline ratios, quarantines, fault
injections, breaker and health state, device faults and OOM splits, the
source's prefetch hits and misses, the rows admission rejected, the
offsets load shedding dropped, the ingest graph's parse counts, stage
latencies, staging queue and autotuned knobs, the SLO controller's
windows, decisions, knobs and compliance, the drift monitor's
divergence, the storage plane's disk usage, budget, write errors,
degraded episodes, repairs, dead-letter drops and WAL compactions, the
predictor's shape ledger (new shapes, bucket hits, padded rows), the
fused segments' new signatures and eager serves, and the kernel
wrappers' calls by kernel and implementation.  A write to a name
outside :data:`CATALOG` raises, as in the JAX package.

Writes take one small lock per metric; :meth:`MetricsRegistry.snapshot`
reads without the write locks.  Each metric holds at most
``max_label_sets`` label sets; further sets collapse into one
``overflow="true"`` series, counted by :meth:`label_overflows`.

Exposition, as in the JAX package: :meth:`MetricsRegistry.to_prometheus`
(text format 0.0.4, metrics sorted by name), ``write_prometheus`` (an
atomic publish; the commands' ``--metrics-out``) and ``write_jsonl``
(one snapshot record a line, stamped by the registry's injectable
``clock``/``mono``).  :func:`set_registry` swaps the process default.
The per-segment roofline gauges ``sntc_mfu_ratio`` and
``sntc_mfu_bw_ratio`` are set by ``obs.cost.emit_mfu`` under
``SNTC_OBS_COST_ANALYSIS``; the tracer counts its evictions into
``sntc_spans_dropped_total``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# seconds; covers sub-ms device dispatches through multi-second batches.
# The SLO controller reads its windowed p99 from these buckets, so they
# are the JAX package's, bound for bound
LATENCY_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0,
)

#: every name the port may emit, with its type, labels and help text
#: (the JAX package's entries of the same names)
CATALOG: Dict[str, Dict[str, Any]] = {
    "sntc_events_total": dict(
        type=COUNTER, labels=("event", "site", "tenant"),
        help="Structured resilience/lifecycle events by name, site, "
        "and tenant (the _emit/emit_event stream, consolidated).",
    ),
    "sntc_events_dropped_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Event-ring evictions (legacy view: events_dropped()).",
    ),
    "sntc_shed_offsets_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Source offsets dropped by load shedding (shed journal).",
    ),
    "sntc_batches_quarantined_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Poison batches journaled to the dead-letter sink.",
    ),
    "sntc_faults_injected_total": dict(
        type=COUNTER, labels=("site", "kind"),
        help="Deterministic fault injections fired (SNTC_FAULTS).",
    ),
    "sntc_batches_committed_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Micro-batches committed to the WAL (incl. quarantined).",
    ),
    "sntc_rows_committed_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Input rows across committed micro-batches.",
    ),
    "sntc_batch_duration_seconds": dict(
        type=HISTOGRAM, labels=("tenant",), buckets=LATENCY_BUCKETS,
        help="WAL-intent\u2192commit latency per micro-batch (the "
        "recentProgress durationMs distribution).",
    ),
    "sntc_rows_rejected_total": dict(
        type=COUNTER, labels=("reason", "tenant"),
        help="Rows excised by data-plane admission, by reason code.",
    ),
    "sntc_source_prefetch_hits_total": dict(
        type=COUNTER, labels=(),
        help="get_batch calls served from a staged prefetch read.",
    ),
    "sntc_source_prefetch_misses_total": dict(
        type=COUNTER, labels=(),
        help="get_batch calls that fell through to a synchronous read "
        "while prefetch was armed.",
    ),
    # -- ingest and the source graph (data/ingest, data/pipeline) ----------
    "sntc_ingest_files_parsed_total": dict(
        type=COUNTER, labels=(),
        help="Source files parsed by load_csv.",
    ),
    "sntc_ingest_rows_parsed_total": dict(
        type=COUNTER, labels=(),
        help="Rows parsed out of source files by load_csv.",
    ),
    "sntc_ingest_bytes_read_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Raw source bytes read by ingest (CSV parse, capture "
        "decode).",
    ),
    # -- the socket front door (serve/ingress) ------------------------------
    "sntc_ingress_datagrams_total": dict(
        type=COUNTER, labels=("tenant",),
        help="UDP datagrams accepted at the ingress receive boundary "
        "(pre-spool; the conservation law's 'received' side).",
    ),
    "sntc_ingress_frames_total": dict(
        type=COUNTER, labels=("tenant",),
        help="TCP length-prefixed frames accepted at the ingress "
        "receive boundary.",
    ),
    "sntc_ingress_bytes_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Payload bytes accepted at the ingress receive boundary.",
    ),
    "sntc_ingress_dropped_total": dict(
        type=COUNTER, labels=("reason", "tenant"),
        help="Ingress payloads shed, by reason (ring_overflow / "
        "spool_over_budget / spool_error / torn_frame / oversize_frame "
        "/ recv_error / close_discard) — counted shed, never silent "
        "loss: received == spooled + dropped after a drain.",
    ),
    "sntc_ingress_sealed_files_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Capture files sealed (fsynced atomic rename) into the "
        "ingress spool.",
    ),
    "sntc_ingress_pruned_files_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Committed capture files pruned by spool retention "
        "(keep-N / disk budget).",
    ),
    "sntc_ingress_spool_bytes": dict(
        type=GAUGE, labels=("tenant",),
        help="Live bytes in the ingress spool directory.",
    ),
    "sntc_ingress_ring_depth": dict(
        type=GAUGE, labels=("tenant",),
        help="Payloads waiting in the bounded ingress ring.",
    ),
    "sntc_ingress_backpressure_state": dict(
        type=GAUGE, labels=("tenant",),
        help="1 while TCP ingress is pausing reads (spool over "
        "budget), 0 otherwise.",
    ),
    "sntc_ingress_connections": dict(
        type=GAUGE, labels=("tenant",),
        help="Live TCP ingress connections.",
    ),
    # -- the stateful flow-feature engine (flow/) ----------------------------
    "sntc_flow_records_consumed_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Parser records (packets/datagram rows) accepted into "
        "keyed window state.",
    ),
    "sntc_flow_late_records_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Records dropped behind the watermark (reason code "
        "late_record).",
    ),
    "sntc_flow_out_of_order_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Accepted records that arrived behind the stream head "
        "but inside the lateness bound.",
    ),
    "sntc_flow_windows_emitted_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Completed flow windows emitted as feature rows.",
    ),
    "sntc_flow_evictions_total": dict(
        type=COUNTER, labels=("reason", "tenant"),
        help="Flows evicted from keyed state, by reason (watermark / "
        "state_cap / flush).",
    ),
    "sntc_flow_snapshots_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Operator-state snapshots published at commit.",
    ),
    "sntc_flow_active_flows": dict(
        type=GAUGE, labels=("tenant",),
        help="Open (uncompleted) flow windows held in keyed state.",
    ),
    "sntc_flow_state_packets": dict(
        type=GAUGE, labels=("tenant",),
        help="Buffered parser records across all open windows (the "
        "watermark-bounded state size).",
    ),
    "sntc_flow_state_bytes": dict(
        type=GAUGE, labels=("tenant",),
        help="Size of the last published operator-state snapshot.",
    ),
    "sntc_ingest_stage_seconds": dict(
        type=HISTOGRAM, labels=("stage", "tenant"),
        buckets=LATENCY_BUCKETS,
        help="Per-item latency of each ingest source-graph stage "
        "(read/parse/admit/bucket/stage) — the autotuner's feedback "
        "signal.",
    ),
    "sntc_ingest_queue_depth": dict(
        type=GAUGE, labels=("stage", "tenant"),
        help="Current occupancy of a source-graph stage queue (the "
        "prefetch staging queue).",
    ),
    "sntc_ingest_autotune_decisions_total": dict(
        type=COUNTER, labels=("knob", "direction", "tenant"),
        help="Applied ingest-autotuner knob changes, by knob and "
        "direction.",
    ),
    "sntc_ingest_knob_value": dict(
        type=GAUGE, labels=("knob", "tenant"),
        help="Current value of each autotuned ingest knob "
        "(read_workers / prefetch_batches / pipeline_depth).",
    ),
    # -- the predictor's shape ledger and the fused segments ----------------
    "sntc_predict_compile_events_total": dict(
        type=COUNTER, labels=(),
        help="Distinct dispatched row shapes across BatchPredictors "
        "(legacy view: BatchPredictor.compile_events).",
    ),
    "sntc_predict_bucket_hits_total": dict(
        type=COUNTER, labels=(),
        help="Dispatches that reused an already-seen row shape.",
    ),
    "sntc_predict_padded_rows_total": dict(
        type=COUNTER, labels=(),
        help="Wasted rows shape-bucket padding cost.",
    ),
    "sntc_fuse_compile_events_total": dict(
        type=COUNTER, labels=(),
        help="Distinct input signatures compiled across FusedSegments.",
    ),
    "sntc_fuse_fallbacks_total": dict(
        type=COUNTER, labels=(),
        help="FusedSegment eager fallbacks (empty frame / dtype gate).",
    ),
    # -- the hand-written CUDA kernels (kernels/) ----------------------------
    "sntc_kernel_dispatch_total": dict(
        type=COUNTER, labels=("kernel", "impl"),
        help="Hand-written kernel calls by kernel name and "
        "implementation (cuda: a launch on the card; plain: the "
        "wrapper's plain PyTorch version on CPU tensors).",
    ),
    # -- the closed-loop SLO controller (serve/controller) -------------------
    "sntc_ctl_windows_total": dict(
        type=COUNTER, labels=(),
        help="SLO-controller observation windows closed.",
    ),
    "sntc_ctl_decisions_total": dict(
        type=COUNTER, labels=("action", "knob", "tenant"),
        help="SLO-controller decisions (applied / budget_denied / "
        "frozen / delegated / escalated), by knob and tenant.",
    ),
    "sntc_ctl_knob_value": dict(
        type=GAUGE, labels=("knob", "tenant"),
        help="Current value of each controller-steered serving knob "
        "(pipeline_depth / shape_buckets / weight / quota / shed / "
        "escalate / migrate / scale_out; ladder knobs report their "
        "ladder index).",
    ),
    "sntc_ctl_slo_compliant": dict(
        type=GAUGE, labels=("slo", "tenant"),
        help="Per-window SLO compliance verdict (1 = compliant, 0 = "
        "violating) for each declared SLO axis (p99 / throughput / "
        "shed).",
    ),
    "sntc_ctl_window_p99_seconds": dict(
        type=GAUGE, labels=("tenant",),
        help="Windowed p99 batch latency the controller computed from "
        "the sntc_batch_duration_seconds bucket deltas.",
    ),
    # -- the tracer's own accounting (obs/trace) ------------------------------
    "sntc_spans_dropped_total": dict(
        type=COUNTER, labels=(),
        help="Spans evicted from the trace ring buffer.",
    ),
    # -- the roofline plane (obs/cost), under SNTC_OBS_COST_ANALYSIS ---------
    "sntc_mfu_ratio": dict(
        type=GAUGE, labels=("segment",),
        help="Achieved FLOP/s over probed peak FLOP/s per fused "
        "serving segment (XLA cost_analysis x measured dispatch "
        "time; only under SNTC_OBS_COST_ANALYSIS=1 \u2014 see "
        "obs/cost.py and the peak_source caveat).",
    ),
    "sntc_mfu_bw_ratio": dict(
        type=GAUGE, labels=("segment",),
        help="Achieved memory bandwidth over probed peak bandwidth "
        "per fused serving segment (same hook and caveats as "
        "sntc_mfu_ratio).",
    ),
    # -- host↔device transfers of a tenant's engine (TransferLedger) --------
    "sntc_transfer_dispatches_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Fused-program dispatches (unlabeled series = the "
        "process-global TransferLedger; tenant series = the "
        "per-engine ledgers).",
    ),
    "sntc_transfer_uploads_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Host\u2192device array uploads by fused dispatches.",
    ),
    "sntc_transfer_downloads_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Device\u2192host output materializations by fused finalizes.",
    ),
    "sntc_transfer_upload_bytes_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Bytes uploaded host\u2192device by fused dispatches.",
    ),
    "sntc_transfer_download_bytes_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Bytes materialized device\u2192host by fused finalizes.",
    ),
    # -- the collective layer over the mesh substrate (parallel/) ------------
    "sntc_collective_dispatches_total": dict(
        type=COUNTER, labels=("op", "axis"),
        help="SPMD collective dispatches over a mesh axis, by "
        "aggregate op (tree_aggregate / kmeans.lloyd / lda.e_step / "
        "pic.power / tree.histogram).",
    ),
    "sntc_collective_bytes_moved_total": dict(
        type=COUNTER, labels=("op", "axis"),
        help="Ring-allreduce wire bytes (2\u00b7(n-1)\u00b7payload) moved by "
        "collective dispatches \u2014 the SparCML baseline a compressed "
        "reduction must beat; loop-carried psums count once per "
        "dispatch (documented lower bound).",
    ),
    "sntc_collective_mesh_devices": dict(
        type=GAUGE, labels=("axis",),
        help="Live mesh shape: devices along each declared axis "
        "(shrinks on a journaled mesh_resize).",
    ),
    "sntc_collective_resizes_total": dict(
        type=COUNTER, labels=(),
        help="Elastic mesh resizes \u2014 a device_lost answered by "
        "shrinking the data axis onto the survivors instead of "
        "flipping HOST_DEGRADED.",
    ),
    # -- the multi-tenant scheduler (serve/tenancy) ---------------------------
    "sntc_daemon_ticks_total": dict(
        type=COUNTER, labels=(),
        help="ServeDaemon scheduling rounds.",
    ),
    "sntc_tenant_state": dict(
        type=GAUGE, labels=("tenant",),
        help="Tenant ladder state (0=OK, 1=THROTTLED, 2=QUARANTINED, "
        "3=STOPPED).",
    ),
    "sntc_tenant_deficit": dict(
        type=GAUGE, labels=("tenant",),
        help="DRR scheduler deficit after the last round.",
    ),
    "sntc_tenant_strikes_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Unhealthy strikes counted against the tenant ladder.",
    ),
    "sntc_health_state": dict(
        type=GAUGE, labels=("component",),
        help="Component health (0=OK, 1=DEGRADED, 2=UNHEALTHY).",
    ),
    "sntc_breaker_state": dict(
        type=GAUGE, labels=("site",),
        help="Circuit-breaker state (0=closed, 1=half_open, 2=open).",
    ),
    "sntc_drift_divergence": dict(
        type=GAUGE, labels=("component",),
        help="Latest Jensen-Shannon divergence the drift monitor saw.",
    ),
    "sntc_device_state": dict(
        type=GAUGE, labels=(),
        help="Device serving state of the fault domain (0=DEVICE_OK, "
        "1=DEVICE_FAILED: every dispatch raises until a restart).",
    ),
    "sntc_device_faults_total": dict(
        type=COUNTER, labels=("kind", "site"),
        help="Classified CUDA failures (device_oom / compile_error / "
        "device_lost), by fault site.",
    ),
    "sntc_device_oom_splits_total": dict(
        type=COUNTER, labels=(),
        help="Micro-batch halvings the OOM responder performed.",
    ),
    # -- the durable-storage plane (resilience/storage) -----------------------
    "sntc_disk_bytes": dict(
        type=GAUGE, labels=("artifact", "tenant"),
        help="On-disk bytes per registered durable artifact under a "
        "checkpoint root (artifact=total is the whole tree).",
    ),
    "sntc_disk_files": dict(
        type=GAUGE, labels=("artifact", "tenant"),
        help="On-disk file count per registered durable artifact "
        "(artifact=total is the whole tree).",
    ),
    "sntc_disk_budget_bytes": dict(
        type=GAUGE, labels=("tenant",),
        help="Declared disk byte budget for a checkpoint root "
        "(global when unlabeled, per-tenant when labeled).",
    ),
    "sntc_storage_write_errors_total": dict(
        type=COUNTER, labels=("artifact", "tenant"),
        help="Failed durable writes (ENOSPC/EIO, real or injected), "
        "by artifact.",
    ),
    "sntc_storage_degraded_state": dict(
        type=GAUGE, labels=("artifact", "tenant"),
        help="1 while an artifact is in a storage_degraded episode "
        "(records buffering in memory), 0 after recovery.",
    ),
    "sntc_storage_repairs_total": dict(
        type=COUNTER, labels=("artifact", "tenant"),
        help="Automatic storage repairs (torn-tail truncations, "
        "corrupt-blob quarantines), journaled to "
        "storage_repair.jsonl.",
    ),
    "sntc_dead_letter_dropped_total": dict(
        type=COUNTER, labels=("artifact", "tenant"),
        help="Dead-letter evidence files dropped by the keep-N/"
        "size-cap retention policy.",
    ),
    "sntc_wal_compactions_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Append-WAL compactions (sealed checkpoint written, "
        "offsets/commits logs truncated).",
    ),
    # -- the elastic serve fleet (serve/fleet.py) ---------------------------
    "sntc_fleet_worker_state": dict(
        type=GAUGE, labels=("worker",),
        help="Coordinator's liveness verdict per worker (1 = lease "
        "current, 0 = lease expired / declared dead).",
    ),
    "sntc_fleet_leases_renewed_total": dict(
        type=COUNTER, labels=("worker",),
        help="Worker lease/heartbeat renewals observed by the "
        "coordinator.",
    ),
    "sntc_fleet_leases_expired_total": dict(
        type=COUNTER, labels=("worker",),
        help="Lease expiries — a worker missed its TTL and was "
        "declared dead; its tenants were redistributed.",
    ),
    "sntc_fleet_migrations_total": dict(
        type=COUNTER, labels=("reason", "outcome"),
        help="Tenant migrations by reason (rebalance / worker_dead / "
        "controller / join) and outcome (completed / reverted).",
    ),
    "sntc_fleet_tenants_value": dict(
        type=GAUGE, labels=("worker",),
        help="Tenants currently assigned to each worker (the "
        "coordinator's placement view).",
    ),
    "sntc_fleet_rows_value": dict(
        type=GAUGE, labels=("worker",),
        help="Rows committed as reported by each worker's last "
        "heartbeat (worker=fleet is the aggregate across live "
        "workers).",
    ),
    # -- warm-standby replication (resilience/replicate.py) -------------------
    "sntc_repl_ships_total": dict(
        type=COUNTER, labels=("tenant", "outcome"),
        help="Replication ship passes by outcome (completed / error). "
        "An error pass degraded — it was journaled and retries at the "
        "next commit; the serving engine never notices.",
    ),
    "sntc_repl_ship_files_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Artifact files copied into the standby replica tree "
        "(changed-content files only; unchanged files are skipped by "
        "stamp/sha).",
    ),
    "sntc_repl_ship_bytes_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Bytes shipped into the standby replica tree.",
    ),
    "sntc_repl_barriers_sealed_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Commit-barrier records sealed into the replicated "
        "barrier log — each one is a provably consistent promotion "
        "point (the replica holds everything through its batch_id).",
    ),
    "sntc_repl_lag_batches": dict(
        type=GAUGE, labels=("tenant",),
        help="Committed batches not yet covered by a sealed barrier "
        "(the batch component of RPO; 0 right after each barrier).",
    ),
    "sntc_repl_lag_seconds": dict(
        type=GAUGE, labels=("tenant",),
        help="Seconds since the last sealed barrier (the time "
        "component of RPO).",
    ),
    "sntc_repl_lag_bytes": dict(
        type=GAUGE, labels=("tenant",),
        help="Estimated un-replicated primary bytes (what a primary "
        "loss right now would cost; stat-only estimate, refreshed on "
        "degraded ships and zeroed at each barrier).",
    ),
    "sntc_repl_divergence_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Replica-vs-manifest or replica-vs-primary divergences "
        "found by promotion or anti-entropy fsck (each one also "
        "journals a replica_diverged event).",
    ),
    "sntc_repl_promotions_total": dict(
        type=COUNTER, labels=("outcome",),
        help="Standby promotions by outcome (completed / failed). A "
        "failed promotion never leaves a partially promoted tree.",
    ),
    "sntc_repl_tail_loss_rows_total": dict(
        type=COUNTER, labels=("tenant",),
        help="Rows counted lost beyond the last sealed barrier at "
        "promotion (the counted_tail_loss term of the loss-accounting "
        "law: committed == replicated_through_barrier + "
        "counted_tail_loss).",
    ),
}

_OVERFLOW_KEY: Tuple[Tuple[str, str], ...] = (("overflow", "true"),)


class _Series:
    """One label set of one metric: ``value`` for counters and gauges,
    per-bucket counts plus sum and count for histograms."""

    __slots__ = ("labels", "value", "bucket_counts", "sum", "count")

    def __init__(self, labels: Tuple[Tuple[str, str], ...],
                 n_buckets: int = 0):
        self.labels = labels
        self.value = 0.0
        self.bucket_counts = [0] * n_buckets if n_buckets else None
        self.sum = 0.0
        self.count = 0


class MetricsRegistry:
    """Registry of cataloged metrics (see the module docs)."""

    def __init__(self, *, clock=time.time, mono=time.monotonic,
                 max_label_sets: int = 64):
        # the wall and monotonic sources of write_jsonl's records:
        # inject constants for deterministic output
        self._clock = clock
        self._mono = mono
        self.max_label_sets = int(max_label_sets)
        self._lock = threading.Lock()  # series creation only
        # name -> (spec, {labelkey: _Series}, write lock)
        self._metrics: Dict[str, Tuple[dict, Dict, threading.Lock]] = {}
        self._label_overflows = 0
        self._jsonl_records = 0

    def _series(self, name: str, labels: Dict[str, str]) -> _Series:
        entry = self._metrics.get(name)
        if entry is None:
            spec = CATALOG.get(name)
            if spec is None:
                raise KeyError(
                    f"metric {name!r} is not declared in "
                    "sntc_tpu_torch.obs.metrics.CATALOG"
                )
            with self._lock:
                entry = self._metrics.setdefault(
                    name, (spec, {}, threading.Lock())
                )
        spec, series, lock = entry
        for k in labels:
            if k not in spec["labels"]:
                raise KeyError(
                    f"label {k!r} not declared for metric {name!r} "
                    f"(allowed: {spec['labels']})"
                )
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        s = series.get(key)
        if s is None:
            n_buckets = (len(spec.get("buckets", ())) + 1
                         if spec["type"] == HISTOGRAM else 0)
            with lock:
                s = series.get(key)
                if s is None:
                    if key and len(series) >= self.max_label_sets:
                        # cardinality cap: collapse into the overflow
                        # series, counting the write
                        with self._lock:
                            self._label_overflows += 1
                        key = _OVERFLOW_KEY
                        s = series.get(key)
                    if s is None:
                        s = series[key] = _Series(key, n_buckets)
        return s

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        s = self._series(name, labels)
        with self._metrics[name][2]:
            s.value += value

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        s = self._series(name, labels)
        with self._metrics[name][2]:
            s.value = float(value)

    def observe(self, name: str, value: float, **labels: str) -> None:
        spec = CATALOG.get(name)
        if spec is None or spec["type"] != HISTOGRAM:
            raise KeyError(f"{name!r} is not a cataloged histogram")
        s = self._series(name, labels)
        # first bound >= value (Prometheus le); the last index is +Inf
        i = bisect_left(spec["buckets"], value)
        with self._metrics[name][2]:
            s.bucket_counts[i] += 1
            s.sum += value
            s.count += 1

    def get(self, name: str, **labels: str) -> Optional[float]:
        """Current value of one counter or gauge series (None when the
        series does not exist yet)."""
        entry = self._metrics.get(name)
        if entry is None:
            return None
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        s = entry[1].get(key)
        return s.value if s is not None else None

    def get_histogram(self, name: str, **labels: str) -> Optional[dict]:
        """One histogram series (None when it does not exist yet):
        bucket bounds, per-bucket counts, sum and count, read without
        the write lock.  The SLO controller diffs two of these for a
        windowed latency distribution."""
        entry = self._metrics.get(name)
        if entry is None:
            return None
        spec = entry[0]
        if spec["type"] != HISTOGRAM:
            raise KeyError(f"{name!r} is not a cataloged histogram")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        s = entry[1].get(key)
        if s is None:
            return None
        return {"bounds": list(spec["buckets"]),
                "buckets": list(s.bucket_counts), "sum": s.sum,
                "count": s.count}

    def label_overflows(self) -> int:
        return self._label_overflows

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy of every live series (no write lock
        taken)."""
        out: Dict[str, Any] = {}
        for name, (spec, series, _lock) in list(self._metrics.items()):
            rows = []
            for s in list(series.values()):
                row: Dict[str, Any] = {"labels": dict(s.labels)}
                if spec["type"] == HISTOGRAM:
                    row.update(buckets=list(s.bucket_counts), sum=s.sum,
                               count=s.count)
                else:
                    row["value"] = s.value
                rows.append(row)
            out[name] = {"type": spec["type"], "help": spec["help"],
                         "series": rows}
            if spec["type"] == HISTOGRAM:
                out[name]["bucket_bounds"] = list(spec["buckets"])
        return out


    # -- exposition ----------------------------------------------------------

    @staticmethod
    def _fmt_labels(labels, extra: str = "") -> str:
        parts = [
            '%s="%s"' % (
                k,
                str(v).replace("\\", r"\\").replace('"', r"\"")
                .replace("\n", r"\n"),
            )
            for k, v in labels
        ]
        if extra:
            parts.append(extra)
        return "{%s}" % ",".join(parts) if parts else ""

    @staticmethod
    def _fmt_value(v: float) -> str:
        return repr(int(v)) if float(v).is_integer() else repr(v)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every live
        series, metrics sorted by name."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            spec, series, _lock = self._metrics[name]
            lines.append(f"# HELP {name} {spec['help']}")
            lines.append(f"# TYPE {name} {spec['type']}")
            for s in sorted(list(series.values()), key=lambda s: s.labels):
                if spec["type"] == HISTOGRAM:
                    # the counts once, so the cumulative sums cannot
                    # tear against a concurrent observe
                    counts = list(s.bucket_counts)
                    acc = 0
                    for bound, n in zip(spec["buckets"], counts):
                        acc += n
                        lines.append(
                            f"{name}_bucket"
                            + self._fmt_labels(s.labels, f'le="{bound}"')
                            + f" {acc}")
                    acc += counts[-1]
                    lines.append(
                        f"{name}_bucket"
                        + self._fmt_labels(s.labels, 'le="+Inf"')
                        + f" {acc}")
                    lines.append(f"{name}_sum" + self._fmt_labels(s.labels)
                                 + f" {self._fmt_value(s.sum)}")
                    lines.append(f"{name}_count"
                                 + self._fmt_labels(s.labels) + f" {acc}")
                else:
                    lines.append(name + self._fmt_labels(s.labels)
                                 + f" {self._fmt_value(s.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> str:
        """Publish the Prometheus text atomically (tmp + rename): a
        reader never sees a torn snapshot."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)  # storage: telemetry
        return path

    def write_jsonl(self, path: str) -> Dict[str, Any]:
        """Append one snapshot record (wall and monotonic stamps from the
        registry's clocks, a sequence number) to a JSONL file; returns
        it."""
        record = {
            "ts": self._clock(),
            "mono": self._mono(),
            "seq": self._jsonl_records,
            "metrics": self.snapshot(),
        }
        self._jsonl_records += 1
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:  # storage: unbounded(caller-owned JSONL export path)
            f.write(json.dumps(record) + "\n")
        return record


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _default


def set_registry(r: MetricsRegistry) -> MetricsRegistry:
    """Replace the process default registry; returns the previous one."""
    global _default
    prev, _default = _default, r
    return prev


def reset_registry() -> MetricsRegistry:
    """Fresh default registry (test isolation); returns it."""
    set_registry(MetricsRegistry())
    return _default


def snapshot() -> Dict[str, Any]:
    """The default registry's :meth:`MetricsRegistry.snapshot`."""
    return _default.snapshot()


def inc(name: str, value: float = 1.0, **labels: str) -> None:
    _default.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels: str) -> None:
    _default.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels: str) -> None:
    _default.observe(name, value, **labels)
