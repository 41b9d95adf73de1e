"""Multi-tenant serving: many streams, one card, one scheduling thread.

Counterpart of ``sntc_tpu/serve/tenancy.py``.  :class:`ServeDaemon`
multiplexes N :class:`TenantStream` s (a pipeline, a source, a sink, a
checkpoint dir and a row policy each) on one thread, under four
contracts:

* **Shared program cache**: tenants that hand the daemon the same model
  object (or checkpoint path) share one
  :class:`~sntc_tpu_torch.serve.transform.BatchPredictor`, and with it
  its bucketed row shapes and one
  :class:`~sntc_tpu_torch.resilience.device.DeviceFaultDomain`.  The
  compile ledger (:meth:`ServeDaemon.mark_warm`,
  :meth:`ServeDaemon.recompiles_after_warmup`) counts the predictors'
  distinct dispatched row shapes: a tenant joining a warm shape adds 0.
* **Fair scheduling**: a weighted deficit round-robin.  Each round
  credits every runnable tenant ``weight × quantum`` batches and drains
  the rotation; a tenant that commits nothing this round banks no more
  than one round's credit.  ``max_rows_per_sec`` is a token bucket
  charged at commit (burst: one second of quota); ``max_pending_batches``
  with ``shed_policy`` sheds the tenant's backlog through the engine's
  journaled shed.
* **Per-tenant fault isolation**: every site a tenant's engine touches
  is ``tenant/<id>/...`` (breakers, fault points, events, health
  components) and its tree is ``<root>/tenant/<id>/`` (``ckpt/`` with
  ``dead_letter`` and ``dead_letter_rows`` under it, ``drain_marker.json``
  beside it).  A tenant walks its own ladder, OK → THROTTLED →
  QUARANTINED → STOPPED, on strikes that carry its tag
  (:data:`STRIKE_EVENTS`, or an engine error that reached the
  scheduler); a stopped tenant's breakers are evicted.  An engine error
  strikes the tenant, never the daemon.
* **Drain**: :meth:`ServeDaemon.request_drain` (SIGTERM under
  :meth:`ServeDaemon.run`) settles every tenant (commit, or leave the
  intent in its WAL for a restart), writes one atomic marker a tenant
  and :data:`DAEMON_DRAIN_MARKER` at the root, and returns.

**The shared device.**  A device error never strikes a tenant.  The
port's domain has no host fallback: after ``degrade_after`` faults with
no clean batch between them it fails, and every dispatch raises
``DeviceExecError``.  The daemon then stops scheduling (``device_failed``
event), drains every tenant (each batch in flight keeps its intent in
its WAL, so a restart replays it), and :meth:`ServeDaemon.run` returns
with ``status()["device_failed"]`` true; the ``serve-daemon`` command
exits 1.  Every tenant keeps its ladder state.

The clock is injectable and :meth:`ServeDaemon.tick` steps one round, so
fairness, quotas and the ladder are tested without sleeps.  The JAX
daemon's replication (``standby_root``, ``repl_barrier_every``) and
compile watchdog (``compile_budget_s``) are not ported; the fleet hooks
(``fleet_hook``, :meth:`ServeDaemon.request_fleet`) are inert outside a
fleet, as there.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, fields as dc_fields
from typing import Any, Dict, List, Optional

import numpy as np

from sntc_tpu_torch.obs.metrics import inc, registry, set_gauge
from sntc_tpu_torch.obs.trace import span
from sntc_tpu_torch.resilience import storage as _storage
from sntc_tpu_torch.resilience.circuit import (
    breaker_for,
    breakers_snapshot,
    reset_breakers,
)
from sntc_tpu_torch.resilience.health import HealthMonitor, HealthState
from sntc_tpu_torch.resilience.policy import (
    RetryPolicy,
    add_event_observer,
    emit_event,
    events_dropped,
    remove_event_observer,
)
from sntc_tpu_torch.resilience.supervisor import _atomic_json as _write_json
from sntc_tpu_torch.serve.streaming import (
    CsvDirSink,
    FileStreamSource,
    StreamingQuery,
)
from sntc_tpu_torch.serve.transform import BatchPredictor

#: the tenant ladder, in order: OK ↔ THROTTLED are the quota states;
#: QUARANTINED is entered on ``quarantine_after`` strikes and left after
#: ``quarantine_cooldown_s`` on probation; STOPPED (``stop_after``
#: episodes) lasts the daemon's life
TENANT_STATES = ("OK", "THROTTLED", "QUARANTINED", "STOPPED")

#: events that strike the tenant they carry (by their ``tenant`` field
#: or their ``tenant/<id>/...`` site); retries, rejected rows and sheds
#: are the degraded-but-working vocabulary and do not
STRIKE_EVENTS = frozenset(("quarantine", "retry_exhausted", "breaker_open"))

DAEMON_DRAIN_MARKER = "daemon_drain_marker.json"

#: the keys a TenantSpec ``ingress`` block takes, each a
#: ``serve.ingress.build_ingress`` argument of the same meaning
INGRESS_KEYS = frozenset({
    "listen_udp", "listen_tcp", "spool_mb", "ring", "seal_every",
    "seal_idle_s", "keep_files", "columns",
})


def _atomic_json(path: str, obj: Dict[str, Any]) -> str:
    return _write_json(path, obj, indent=1)


@dataclass
class TenantSpec:
    """One tenant: identity, pipeline, endpoints, quotas and ladder
    thresholds.  ``serve-daemon --tenants`` reads a JSON list of these;
    the daemon's flags fill a field an entry omits.  ``model`` is a
    fitted transformer, a ``BatchPredictor`` or a checkpoint path:
    tenants with the same object or path share one predictor."""

    tenant_id: str
    model: Any = None
    watch: Optional[str] = None  # CSV directory source
    out: Optional[str] = None  # CSV directory sink
    source: Any = None  # an explicit StreamSource (tests, the smoke)
    sink: Any = None  # an explicit StreamSink
    weight: float = 1.0  # fair-share weight (deficit a round)
    max_rows_per_sec: Optional[float] = None  # admission token bucket
    max_pending_batches: Optional[int] = None  # backlog cap before a shed
    shed_policy: str = "oldest"  # 'oldest' | 'sample'
    quarantine_after: int = 3  # strikes → QUARANTINED
    quarantine_cooldown_s: float = 30.0  # quarantine hold before probation
    stop_after: int = 3  # quarantine episodes → STOPPED
    row_policy: Optional[str] = None  # 'strict'|'salvage'|'permissive'
    schema_contract: Any = None
    max_batch_offsets: Optional[int] = 1
    max_batch_failures: Optional[int] = 3
    retry_policy: Optional[RetryPolicy] = None
    out_columns: Optional[List[str]] = None
    # raw captures: 'pcap'|'netflow' serves a FlowCaptureSource over the
    # watch dir, its state under tenant/<id>/ckpt/flow_state;
    # flow_options passes its window knobs
    from_capture: Optional[str] = None
    flow_options: Optional[Dict[str, Any]] = None
    # the SLO controller's setpoints (None or 0: undeclared)
    slo_p99_ms: Optional[float] = None
    slo_min_rows_per_sec: Optional[float] = None
    slo_max_shed_rate: Optional[float] = None
    # a cap on the bytes of tenant/<id>/ (None or 0: unbudgeted)
    disk_budget_mb: Optional[float] = None
    # fleet placement, inert outside a fleet
    placement_cost: Optional[float] = None
    pinned_worker: Optional[str] = None
    # a socket listener in front of the watch dir, which becomes its
    # spool (keys: INGRESS_KEYS)
    ingress: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if not self.tenant_id or "/" in self.tenant_id:
            raise ValueError(
                f"tenant_id must be a non-empty path-safe string, got "
                f"{self.tenant_id!r}"
            )
        if self.weight <= 0:
            raise ValueError("weight must be > 0")
        if self.shed_policy not in ("oldest", "sample"):
            raise ValueError("shed_policy must be 'oldest' or 'sample'")
        if self.quarantine_after < 1 or self.stop_after < 1:
            raise ValueError(
                "quarantine_after and stop_after must be >= 1"
            )
        if self.max_batch_failures == 0:
            # 0 = quarantine unarmed, as the daemon's flag says
            self.max_batch_failures = None
        if (
            self.max_rows_per_sec is not None
            and self.max_rows_per_sec <= 0
        ):
            raise ValueError("max_rows_per_sec must be > 0 (or None)")
        if self.row_policy is not None and self.schema_contract is None:
            raise ValueError(
                "row_policy requires a schema_contract on the spec"
            )
        # 0 = undeclared; a negative value (or a shed rate over 1) is a
        # typo, not a contract
        for f in ("slo_p99_ms", "slo_min_rows_per_sec",
                  "slo_max_shed_rate", "disk_budget_mb",
                  "placement_cost"):
            v = getattr(self, f)
            if v is None:
                continue
            if v == 0:
                setattr(self, f, None)
                continue
            if v < 0:
                raise ValueError(f"{f} must be >= 0 (0/None = unset)")
        if (
            self.slo_max_shed_rate is not None
            and self.slo_max_shed_rate > 1.0
        ):
            raise ValueError(
                "slo_max_shed_rate is a fraction in (0, 1]"
            )
        if self.ingress is not None:
            unknown = sorted(set(self.ingress) - INGRESS_KEYS)
            if unknown:
                raise ValueError(
                    f"unknown ingress key(s) {unknown}; known: "
                    f"{sorted(INGRESS_KEYS)}"
                )
            has_udp = self.ingress.get("listen_udp") is not None
            has_tcp = self.ingress.get("listen_tcp") is not None
            if has_udp == has_tcp:
                raise ValueError(
                    "ingress needs exactly one of listen_udp / "
                    "listen_tcp"
                )
            if self.watch is None:
                raise ValueError(
                    "ingress requires a watch dir (the spool lands "
                    "there)"
                )
            if self.from_capture == "pcap" and has_udp:
                raise ValueError(
                    "listen_udp spools NetFlow v5; from_capture="
                    "'pcap' cannot be socket-fed"
                )

    @classmethod
    def from_dict(
        cls, d: Dict[str, Any], defaults: Optional[Dict[str, Any]] = None
    ) -> "TenantSpec":
        """A spec from one tenant-file entry (``id`` names
        ``tenant_id``); ``defaults`` fill the fields it omits.  An
        unknown key is an error: a mistyped quota must not default."""
        merged = dict(defaults or {})
        merged.update({("tenant_id" if k == "id" else k): v
                       for k, v in d.items()})
        known = {f.name for f in dc_fields(cls)}
        unknown = sorted(set(merged) - known)
        if unknown:
            raise ValueError(
                f"unknown TenantSpec field(s) {unknown} for tenant "
                f"{merged.get('tenant_id')!r}; known: {sorted(known)}"
            )
        return cls(**merged)


class TenantStream:
    """One tenant's engine and the daemon's accounting around it: the
    deficit, the token bucket, the ladder state, strikes and episodes,
    latency samples.  Built by :class:`ServeDaemon`."""

    _LATENCY_KEEP = 10_000

    def __init__(self, spec: TenantSpec, query: StreamingQuery, clock):
        self.spec = spec
        self.query = query
        self.prefix = f"tenant/{spec.tenant_id}/"
        self.state = "OK"
        self._clock = clock
        self.deficit = 0.0
        rate = spec.max_rows_per_sec
        # the burst is one second of quota, however long the tenant idled
        self._burst = None if rate is None else max(rate, 1.0)
        self.allowance = self._burst
        self._last_refill = clock()
        self.strikes = 0
        self.quarantine_episodes = 0
        self.quarantined_at: Optional[float] = None
        self.probation_hold = False
        self.batches_done = 0
        self.rows_done = 0
        self.shed_total_offsets = 0
        self.latencies_ms: List[float] = []
        self.stop_reason: Optional[str] = None

    # -- quota --------------------------------------------------------------

    def refill(self, now: float) -> None:
        if self.allowance is None:
            return
        elapsed = max(0.0, now - self._last_refill)
        self._last_refill = now
        self.allowance = min(
            self._burst,
            self.allowance + elapsed * self.spec.max_rows_per_sec,
        )

    def throttled(self) -> bool:
        return self.allowance is not None and self.allowance <= 0

    def set_rate_quota(self, rate: Optional[float]) -> None:
        """Resize the quota live (the SLO controller's ``quota`` knob):
        None disarms the bucket; otherwise the burst follows the new
        rate and the allowance is clamped into it, so a tighter quota
        binds this round."""
        self.spec.max_rows_per_sec = rate
        if rate is None:
            self._burst = None
            self.allowance = None
            return
        self._burst = max(rate, 1.0)
        self.allowance = (
            self._burst if self.allowance is None
            else min(self.allowance, self._burst)
        )
        self._last_refill = self._clock()

    def charge(self, rows: int) -> None:
        if self.allowance is not None:
            self.allowance -= rows

    # -- work ---------------------------------------------------------------

    def has_work(self, latest: Optional[int] = None) -> bool:
        if self.query.in_flight_count() > 0:
            return True
        if latest is None:
            latest = self.query.source.latest_offset()
        return latest > self.query.planned_offset()

    def record_commit(self, progress: Optional[dict]) -> int:
        """Fold one committed batch's progress into the accounting; the
        rows charged to the quota."""
        self.batches_done += 1
        if not progress:
            return 0
        rows = int(progress.get("numInputRows", 0))
        self.rows_done += rows
        self.latencies_ms.append(float(progress.get("durationMs", 0.0)))
        if len(self.latencies_ms) > self._LATENCY_KEEP:
            del self.latencies_ms[: -self._LATENCY_KEEP]
        self.charge(rows)
        return rows

    # -- evidence -----------------------------------------------------------

    def latency_percentiles(self) -> Dict[str, Optional[float]]:
        if not self.latencies_ms:
            return {"p50_ms": None, "p99_ms": None}
        lat = np.asarray(self.latencies_ms, np.float64)
        return {
            "p50_ms": round(float(np.percentile(lat, 50)), 3),
            "p99_ms": round(float(np.percentile(lat, 99)), 3),
        }

    def snapshot(self) -> Dict[str, Any]:
        return {
            "tenant": self.spec.tenant_id,
            "state": self.state,
            "weight": self.spec.weight,
            "batches_done": self.batches_done,
            "rows_done": self.rows_done,
            "in_flight": self.query.in_flight_count(),
            "last_committed": self.query.last_committed(),
            "strikes": self.strikes,
            "quarantine_episodes": self.quarantine_episodes,
            "shed_total_offsets": self.shed_total_offsets,
            "allowance_rows": (
                None if self.allowance is None
                else round(self.allowance, 1)
            ),
            "stop_reason": self.stop_reason,
            **self.latency_percentiles(),
        }


class ServeDaemon:
    """N tenant streams over one shared program cache (see the module
    docs).  Build it from specs, then :meth:`run` (the command's loop),
    :meth:`process_available` (serve what is there) or :meth:`tick`
    (one scheduling round)."""

    def __init__(
        self,
        specs: List[TenantSpec],
        root_dir: str,
        *,
        shape_buckets: int = 0,
        pipeline_depth: int = 1,
        quantum: float = 1.0,
        health: Optional[HealthMonitor] = None,
        health_json: Optional[str] = None,
        metrics_out: Optional[str] = None,
        clock=time.monotonic,
        breaker_kwargs: Optional[Dict[str, Any]] = None,
        autotune: bool = False,
        tuning_budget=None,
        controller: bool = False,
        controller_policy=None,
        disk_budget_mb: Optional[float] = None,
        dead_letter_keep: int = 200,
        device_faults: bool = True,
        device_policy=None,
        device="cuda",
    ):
        if not specs:
            raise ValueError("ServeDaemon needs at least one TenantSpec")
        ids = [s.tenant_id for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate tenant ids: {sorted(ids)}")
        self.root_dir = root_dir
        self.shape_buckets = int(shape_buckets)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.quantum = float(quantum)
        self.health_json = health_json
        self.dead_letter_keep = max(0, int(dead_letter_keep))
        self.device = device
        # republished after every round when set
        self.metrics_out = metrics_out
        self._clock = clock
        self._breaker_kwargs = dict(breaker_kwargs or {})
        # one IngestAutotuner a tenant, all drawing on one TuningBudget
        self.autotune = bool(autotune)
        self.tuning_budget = tuning_budget
        # the SLO controller, when armed, owns the tuners and journals to
        # <root>/controller.jsonl
        self._controller_armed = bool(controller)
        self.controller = None
        if (self.autotune or self._controller_armed) and (
            self.tuning_budget is None
        ):
            from sntc_tpu_torch.resilience.control import TuningBudget

            self.tuning_budget = TuningBudget.default_for(len(specs))
        # disk accounting: the whole root, and each tenant's subtree
        self.storage = _storage.StoragePlane(
            root_dir,
            budget_bytes=(
                int(disk_budget_mb * (1 << 20)) if disk_budget_mb
                else None
            ),
        )
        self._tenant_storage: Dict[str, _storage.StoragePlane] = {
            s.tenant_id: self._storage_plane(s) for s in specs
        }
        self._owns_health = health is None
        self.health = health or HealthMonitor(clock=clock).attach()
        # one device domain for every tenant's predictor: the tenants
        # share the card
        self.device_domain = None
        self.device_failed = False
        if device_faults:
            from sntc_tpu_torch.resilience.device import (
                DeviceFaultDomain,
                DevicePolicy,
            )

            self.device_domain = DeviceFaultDomain(
                device_policy or DevicePolicy())
        # the shared program cache: one BatchPredictor a distinct model,
        # keyed by checkpoint path or object identity
        self._predictors: Dict[Any, BatchPredictor] = {}
        self._models_by_path: Dict[str, Any] = {}
        self._warm_compiles: Optional[Dict[Any, int]] = None
        self._last_runnable = 0
        self.tenants: List[TenantStream] = []
        try:
            for spec in specs:
                self.tenants.append(self._build_tenant(spec))
        except BaseException:
            # a bad spec must not leak what was set up (close() never
            # runs when __init__ raises)
            if self._owns_health:
                self.health.close()
            for t in self.tenants:
                self._close_source(t)
                reset_breakers(prefix=t.prefix)
            raise
        self._by_id = {t.spec.tenant_id: t for t in self.tenants}
        if self._controller_armed:
            from sntc_tpu_torch.serve.controller import ServeController

            self.controller = ServeController.for_daemon(
                self, policy=controller_policy,
            )
        # strikes ride the event stream (delivery threads emit too,
        # hence the lock)
        self._strike_lock = threading.Lock()
        self._observer = self._on_event
        add_event_observer(self._observer)
        self._drain = threading.Event()
        self._drain_reason: Optional[str] = None
        self.drained = False
        self._closed = False
        # tick() and drain() both hold it: a drain from another thread
        # waits for the round in progress (re-entrant for a drain from
        # the daemon's own thread)
        self._sched_lock = threading.RLock()
        # the fleet worker installs a callable here; None outside a fleet
        self.fleet_hook = None

    # -- construction -------------------------------------------------------

    def _storage_plane(self, spec: TenantSpec) -> _storage.StoragePlane:
        return _storage.StoragePlane(
            self.tenant_dir(spec.tenant_id),
            tenant=spec.tenant_id,
            budget_bytes=(
                int(spec.disk_budget_mb * (1 << 20))
                if spec.disk_budget_mb else None
            ),
        )

    def _resolve_model(self, spec: TenantSpec):
        if isinstance(spec.model, str):
            if spec.model not in self._models_by_path:
                from sntc_tpu_torch.mlio import load_model

                self._models_by_path[spec.model] = load_model(
                    spec.model, device=self.device)
            return spec.model, self._models_by_path[spec.model]
        if spec.model is None:
            raise ValueError(
                f"tenant {spec.tenant_id!r} has no model"
            )
        return id(spec.model), spec.model

    def predictor_for(self, spec: TenantSpec) -> BatchPredictor:
        """The shared predictor of the spec's model (same object or
        path, same predictor).  A ``BatchPredictor`` handed in is shared
        by identity, with its own bucket setting."""
        if isinstance(spec.model, BatchPredictor):
            self._predictors.setdefault(id(spec.model), spec.model)
            return spec.model
        key, model = self._resolve_model(spec)
        pred = self._predictors.get(key)
        if pred is None:
            pred = BatchPredictor(
                model, bucket_rows=self.shape_buckets, device=self.device,
                device_domain=self.device_domain,
            )
            self._predictors[key] = pred
        return pred

    def device_degraded(self) -> bool:
        """True once the shared device domain has failed: the SLO
        controller then climbs no tenant's ladder for it."""
        return self.device_domain is not None and self.device_domain.failed

    def tenant_dir(self, tenant_id: str) -> str:
        return os.path.join(self.root_dir, "tenant", tenant_id)

    def _build_tenant(self, spec: TenantSpec) -> TenantStream:
        tdir = self.tenant_dir(spec.tenant_id)
        source = spec.source
        listeners = []
        if source is None and spec.ingress is not None:
            # the watch dir is the listener's spool; the source's drain
            # and close settle the listener
            from sntc_tpu_torch.serve import ingress as _ingress

            ing = spec.ingress
            source, listeners = _ingress.build_ingress(
                spec.watch,
                listen_udp=ing.get("listen_udp"),
                listen_tcp=ing.get("listen_tcp"),
                spool_mb=ing.get("spool_mb"),
                keep_files=ing.get("keep_files", 64),
                ring=ing.get("ring", 2048),
                seal_every=ing.get("seal_every", 30),
                seal_idle_s=ing.get("seal_idle_s", 0.25),
                columns=ing.get("columns"),
                tenant=spec.tenant_id,
                source_kwargs={
                    "parse_salvage": spec.schema_contract is not None,
                },
            )
        if source is None:
            if spec.watch is None:
                raise ValueError(
                    f"tenant {spec.tenant_id!r} needs a source or a "
                    "watch directory"
                )
            if spec.from_capture:
                from sntc_tpu_torch.flow import FlowCaptureSource

                source = FlowCaptureSource(
                    spec.watch,
                    format=spec.from_capture,
                    state_dir=os.path.join(tdir, "ckpt", "flow_state"),
                    tenant=spec.tenant_id,
                    **(spec.flow_options or {}),
                )
            else:
                source = FileStreamSource(
                    spec.watch,
                    parse_salvage=spec.schema_contract is not None,
                )
        sink = spec.sink
        if sink is None:
            if spec.out is None:
                raise ValueError(
                    f"tenant {spec.tenant_id!r} needs a sink or an out "
                    "directory"
                )
            sink = CsvDirSink(spec.out, columns=spec.out_columns)
        prefix = f"tenant/{spec.tenant_id}/"
        breakers = {
            site: breaker_for(prefix + site, **self._breaker_kwargs)
            for site in ("sink.write", "predict.dispatch")
        }
        autotuner = None
        if self.autotune and not self._controller_armed:
            # with the controller armed it owns the tuners (one owner a
            # knob)
            from sntc_tpu_torch.data.autotune import IngestAutotuner

            autotuner = IngestAutotuner(
                budget=self.tuning_budget, tenant=spec.tenant_id
            )
        query = StreamingQuery(
            self.predictor_for(spec),
            source,
            sink,
            os.path.join(tdir, "ckpt"),
            max_batch_offsets=spec.max_batch_offsets,
            pipeline_depth=self.pipeline_depth,
            overlap_sink=self.pipeline_depth > 1,
            breakers=breakers,
            retry_policy=spec.retry_policy,
            max_batch_failures=spec.max_batch_failures,
            schema_contract=spec.schema_contract,
            row_policy=spec.row_policy,
            tenant=spec.tenant_id,
            autotuner=autotuner,
            dead_letter_keep=self.dead_letter_keep,
            device=self.device,
        )
        if listeners:
            from sntc_tpu_torch.serve import ingress as _ingress

            # retention prunes only below the committed horizon; the
            # listeners go live once the engine that replays them exists
            _ingress.wire_committed_offset(source, query.committed_end)
            for listener in listeners:
                listener.start()
        return TenantStream(spec, query, self._clock)

    def autotune_stats(self) -> Optional[Dict[str, Any]]:
        """Each tenant's tuner and the shared budget (None unarmed)."""
        if not self.autotune:
            return None
        out: Dict[str, Any] = {
            "tenants": {
                t.spec.tenant_id: t.query.autotuner.stats()
                for t in self.tenants
                if t.query.autotuner is not None
            }
        }
        if self.tuning_budget is not None:
            out["budget"] = self.tuning_budget.snapshot()
        return out

    # -- the compile ledger -------------------------------------------------

    def compile_ledger(self) -> Dict[str, Dict[str, int]]:
        return {
            str(key): {
                "compile_events": p.compile_events,
                "bucket_hits": p.bucket_hits,
            }
            for key, p in self._predictors.items()
        }

    def mark_warm(self) -> None:
        """Snapshot every shared predictor's shape count; later
        :meth:`recompiles_after_warmup` is the delta."""
        self._warm_compiles = {
            key: p.compile_events for key, p in self._predictors.items()
        }

    def recompiles_after_warmup(self) -> Optional[int]:
        if self._warm_compiles is None:
            return None
        return sum(
            p.compile_events - self._warm_compiles.get(key, 0)
            for key, p in self._predictors.items()
        )

    # -- the ladder ---------------------------------------------------------

    def _on_event(self, record: Dict[str, Any]) -> None:
        if record.get("event") not in STRIKE_EVENTS:
            return
        tenant = record.get("tenant")
        if tenant is None:
            # breaker and retry events carry the namespaced site only
            site = record.get("site")
            if isinstance(site, str) and site.startswith("tenant/"):
                parts = site.split("/", 2)
                tenant = parts[1] if len(parts) == 3 else None
        if tenant is None:
            return
        t = self._by_id.get(tenant)
        if t is None or t.state == "STOPPED":
            return
        with self._strike_lock:
            t.strikes += 1
        inc("sntc_tenant_strikes_total", tenant=t.spec.tenant_id)

    def _escalate(self, now: float) -> None:
        """The ladder's moves, once a round: a quarantine released after
        its cooldown (probation: health reset, strikes cleared, breakers
        reset), strikes past the threshold → QUARANTINED, episodes past
        theirs → STOPPED."""
        for t in self.tenants:
            if t.state == "STOPPED":
                continue
            if t.state == "QUARANTINED":
                if now - t.quarantined_at >= t.spec.quarantine_cooldown_s:
                    t.state = "OK"
                    t.quarantined_at = None
                    t.probation_hold = True  # the release round serves not
                    with self._strike_lock:
                        t.strikes = 0
                    self.health.reset_under(
                        t.prefix, reason="quarantine released (probation)"
                    )
                    # an open breaker left from the episode would starve
                    # the probation of evidence
                    for br in t.query.breakers.values():
                        br.reset()
                    emit_event(
                        event="tenant_released", tenant=t.spec.tenant_id,
                        episodes=t.quarantine_episodes,
                    )
                continue
            with self._strike_lock:
                strikes = t.strikes
            if strikes >= t.spec.quarantine_after:
                t.quarantine_episodes += 1
                if t.quarantine_episodes >= t.spec.stop_after:
                    self._stop_tenant(
                        t,
                        reason=f"{t.quarantine_episodes} quarantine "
                        "episodes",
                    )
                    continue
                t.state = "QUARANTINED"
                t.quarantined_at = now
                with self._strike_lock:
                    t.strikes = 0
                emit_event(
                    event="tenant_quarantined", tenant=t.spec.tenant_id,
                    strikes=strikes, episode=t.quarantine_episodes,
                    cooldown_s=t.spec.quarantine_cooldown_s,
                )

    @staticmethod
    def _close_source(t: TenantStream) -> None:
        close = getattr(t.query.source, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    def _stop_tenant(self, t: TenantStream, reason: str) -> None:
        """The ladder's end: the engine stops, its breakers leave the
        registry, its WAL keeps what a restart needs.  The other tenants
        go on."""
        t.state = "STOPPED"
        t.stop_reason = reason
        try:
            t.query.stop()
        except Exception as e:  # a wedged engine must not stop the stop
            emit_event(
                event="tenant_error", tenant=t.spec.tenant_id,
                error=repr(e), during="stop",
            )
        self._close_source(t)
        reset_breakers(prefix=t.prefix)
        emit_event(
            event="tenant_stopped", tenant=t.spec.tenant_id,
            reason=reason,
        )

    def tenant_state(self, tenant_id: str) -> str:
        return self._by_id[tenant_id].state

    def tenant_health(self, tenant_id: str) -> HealthState:
        """The worst of the tenant's own namespaced components."""
        return self.health.worst_under(self._by_id[tenant_id].prefix)

    # -- the scheduler ------------------------------------------------------

    def tick(self) -> int:
        """One deficit-round-robin round; the batches committed.  In
        order: the ladder, the quota refills, the sheds, then each
        runnable tenant's credit of ``weight × quantum`` and the drain of
        the rotation (a committed batch costs one credit and charges its
        rows to the bucket).  An engine error strikes its tenant and the
        round goes on; a failed device domain ends the scheduling (see
        the module docs)."""
        now = self._clock()
        inc("sntc_daemon_ticks_total")
        committed_total = 0
        with self._sched_lock, span("daemon.tick"):
            self._escalate(now)
            runnable: List[TenantStream] = []
            for t in self.tenants:
                if self.device_failed:
                    break
                if t.state in ("STOPPED", "QUARANTINED"):
                    continue
                if t.probation_hold:
                    # the release is observable (state OK, health reset)
                    # before a probation batch can change either
                    t.probation_hold = False
                    continue
                t.refill(now)
                try:
                    latest = t.query.source.latest_offset()
                except Exception as e:
                    self._strike(t, e, during="latest_offset")
                    continue
                if t.spec.max_pending_batches is not None:
                    try:
                        shed = t.query.shed_backlog(
                            t.spec.max_pending_batches,
                            policy=t.spec.shed_policy,
                            latest=latest,
                        )
                    except Exception as e:
                        self._strike(t, e, during="shed")
                        shed = None
                    if shed is not None:
                        t.shed_total_offsets += shed.get(
                            "offsets_shed", 0
                        )
                if not t.has_work(latest):
                    t.deficit = 0.0  # an idle queue keeps no credit
                    if t.state == "THROTTLED":
                        t.state = "OK"
                    continue
                if t.throttled():
                    t.state = "THROTTLED"
                    continue
                if t.state == "THROTTLED":
                    t.state = "OK"
                runnable.append(t)
            for t in runnable:
                t.deficit += t.spec.weight * self.quantum
            for t in runnable:
                if self.device_failed:
                    break
                committed_total += self._drain_deficit(t)
            self._last_runnable = 0 if self.device_failed else len(runnable)
            for t in self.tenants:
                set_gauge(
                    "sntc_tenant_deficit", t.deficit,
                    tenant=t.spec.tenant_id,
                )
                set_gauge(
                    "sntc_tenant_state", TENANT_STATES.index(t.state),
                    tenant=t.spec.tenant_id,
                )
            if self.controller is not None:
                # a controller error degrades, never stops serving
                try:
                    self.controller.on_tick()
                except Exception as e:
                    emit_event(
                        event="controller_error", error=repr(e)
                    )
        # disk accounting and budget verdicts (the planes throttle the
        # walks): an over-budget tenant is DEGRADED under its own prefix
        self.storage.check_budget()
        for plane in self._tenant_storage.values():
            plane.check_budget()
        if self.health_json:
            _atomic_json(self.health_json, self.status())
        if self.metrics_out:
            registry().write_prometheus(self.metrics_out)
        return committed_total

    def _drain_deficit(self, t: TenantStream) -> int:
        """Run one tenant's engine while it has credit, work and
        allowance; the batches committed."""
        committed = 0
        while (
            t.deficit >= 1.0
            and t.state not in ("STOPPED", "QUARANTINED")
        ):
            before = t.query.last_committed()
            try:
                t.query._run_one_batch()
            except Exception as e:
                if self.device_degraded():
                    self._device_failed(t, e)  # the card's, not the tenant's
                    break
                self._strike(t, e, during="run_one_batch")
                t.deficit = min(
                    t.deficit, t.spec.weight * self.quantum
                )
                break
            delta = t.query.last_committed() - before
            if delta == 0:
                # deferred or idle: credit a queue could not spend does
                # not bank (classic DRR), or a recovering tenant would
                # drain a backlog of credit ahead of every neighbour
                t.deficit = min(
                    t.deficit, t.spec.weight * self.quantum
                )
                break
            t.deficit -= delta
            committed += delta
            # recentProgress holds the commits newest-last
            for progress in t.query.recentProgress[-delta:]:
                t.record_commit(progress)
            if t.throttled():
                t.state = "THROTTLED"
                break
        return committed

    def _device_failed(self, t: TenantStream, exc: BaseException) -> None:
        """The shared device domain failed: no tenant is struck; the
        scheduling stops and the daemon drains (see the module docs)."""
        if not self.device_failed:
            self.device_failed = True
            emit_event(event="daemon_device_failed", tenant=t.spec.tenant_id,
                       error=repr(exc))
        self.request_drain("device_failed")

    def strike_tenant(self, tenant_id: str, reason: str) -> None:
        """One strike from the SLO controller's escalate rung; it counts
        as an event-stream strike does."""
        t = self._by_id[tenant_id]
        if t.state == "STOPPED":
            return
        with self._strike_lock:
            t.strikes += 1
        inc("sntc_tenant_strikes_total", tenant=t.spec.tenant_id)
        emit_event(
            event="controller_strike", tenant=t.spec.tenant_id,
            reason=reason,
        )

    def _strike(self, t: TenantStream, exc: Exception, during: str) -> None:
        """An engine error that reached the scheduler: evidence against
        the tenant, never the daemon."""
        with self._strike_lock:
            t.strikes += 1
        inc("sntc_tenant_strikes_total", tenant=t.spec.tenant_id)
        emit_event(
            event="tenant_error", tenant=t.spec.tenant_id,
            error=repr(exc), during=during,
        )

    # -- loop / drain -------------------------------------------------------

    def has_work(self) -> bool:
        return any(
            t.state not in ("STOPPED", "QUARANTINED") and t.has_work()
            for t in self.tenants
        )

    def process_available(self, max_rounds: int = 1_000_000) -> int:
        """Serve what every schedulable tenant has (the step API).  A
        round that commits nothing with runnable work is a retry round,
        allowed up to the engine drain's stall budget; a round with
        nothing runnable ends the call (a throttled tenant's backlog
        waits for time, a quarantined one's for its probation)."""
        total = 0
        stalled = 0
        max_stalled = max(
            ((t.spec.max_batch_failures or 1) + 1) for t in self.tenants
        ) * len(self.tenants)
        for _ in range(max_rounds):
            delta = self.tick()
            total += delta
            if delta:
                stalled = 0
                continue
            if self._last_runnable == 0:
                break
            stalled += 1
            if stalled >= max_stalled:
                break
        return total

    def request_drain(self, reason: str = "request_drain") -> None:
        if not self._drain.is_set():
            self._drain_reason = reason
            self._drain.set()

    # -- membership ---------------------------------------------------------

    def add_tenant(self, spec: TenantSpec) -> TenantStream:
        """Admit a tenant into the running daemon: its engine over the
        shared program cache, its storage plane, its controller knobs.
        Serialized against the scheduler."""
        with self._sched_lock:
            if spec.tenant_id in self._by_id:
                raise ValueError(
                    f"tenant {spec.tenant_id!r} already served"
                )
            t = self._build_tenant(spec)
            self.tenants.append(t)
            self._by_id[spec.tenant_id] = t
            self._tenant_storage[spec.tenant_id] = self._storage_plane(spec)
            if self.controller is not None:
                try:
                    self.controller.attach_tenant(t)
                except Exception as e:  # degrade, never kill
                    emit_event(
                        event="controller_error", error=repr(e)
                    )
            emit_event(
                event="tenant_added", tenant=spec.tenant_id,
                tenants=len(self.tenants),
            )
            return t

    def remove_tenant(
        self, tenant_id: str, *, drain: bool = True,
        reason: str = "remove_tenant",
    ) -> Dict[str, Any]:
        """Evict a tenant from the running daemon: settle it as the
        daemon's drain does (``drain=False`` only stops it), evict its
        breakers and forget it.  Its tree stays on disk.  A summary."""
        with self._sched_lock:
            t = self._by_id.get(tenant_id)
            if t is None:
                raise KeyError(f"no tenant {tenant_id!r}")
            committed = 0
            was_mid_batch = (
                t.state != "STOPPED" and t.query.in_flight_count() > 0
            )
            if drain and t.state != "STOPPED":
                committed = self._settle_tenant(t, reason, was_mid_batch)
            else:
                try:
                    t.query.stop()
                except Exception:
                    pass
            self._close_source(t)
            # stopped before the controller lets go of it
            t.state = "STOPPED"
            if self.controller is not None:
                try:
                    self.controller.detach_tenant(tenant_id)
                except Exception as e:  # degrade, never kill
                    emit_event(
                        event="controller_error", error=repr(e)
                    )
            reset_breakers(prefix=t.prefix)
            self.tenants.remove(t)
            del self._by_id[tenant_id]
            self._tenant_storage.pop(tenant_id, None)
            emit_event(
                event="tenant_removed", tenant=tenant_id,
                reason=reason, tenants=len(self.tenants),
            )
            return {
                "tenant": tenant_id,
                "reason": reason,
                "batches_committed_at_remove": committed,
                "last_committed": t.query.last_committed(),
                "was_mid_batch": was_mid_batch,
                "rows_done": t.rows_done,
            }

    def request_fleet(
        self, action: str, tenant_id: str, reason: str = ""
    ) -> bool:
        """Post a fleet request (``migrate`` / ``scale_out``) through the
        fleet hook; False (never an exception) outside a fleet or when
        the hook fails."""
        if self.fleet_hook is None:
            return False
        try:
            self.fleet_hook(action, tenant_id, reason)
        except Exception as e:
            emit_event(
                event="fleet_request_error", tenant=tenant_id,
                action=action, error=repr(e),
            )
            return False
        emit_event(
            event="fleet_request", tenant=tenant_id, action=action,
            reason=reason,
        )
        return True

    @property
    def drain_requested(self) -> bool:
        return self._drain.is_set()

    def install_signal_handlers(self) -> bool:
        try:
            signal.signal(
                signal.SIGTERM,
                lambda signum, frame: self.request_drain("SIGTERM"),
            )
            return True
        except ValueError:  # not the main thread
            return False

    def _settle_tenant(
        self, t: TenantStream, reason: Optional[str],
        was_mid_batch: bool,
    ) -> int:
        """Settle one tenant: the ingress first (its ring tail sealed
        durably), the engine's bounded drain (what still defers stays in
        its WAL), the atomic marker, the stop.  The batches committed."""
        drain_ingress = getattr(t.query.source, "drain_ingress", None)
        if drain_ingress is not None:
            try:
                drain_ingress()
            except Exception as e:
                emit_event(
                    event="tenant_error", tenant=t.spec.tenant_id,
                    error=repr(e), during="drain_ingress",
                )
        try:
            done = t.query.drain()
        except Exception as e:
            emit_event(
                event="tenant_error", tenant=t.spec.tenant_id,
                error=repr(e), during="drain",
            )
            done = 0
        for progress in t.query.recentProgress[-done:] if done else []:
            t.record_commit(progress)
        _atomic_json(
            os.path.join(
                self.tenant_dir(t.spec.tenant_id), "drain_marker.json"
            ),
            {
                "ts": time.time(),
                "tenant": t.spec.tenant_id,
                "reason": reason,
                "last_committed": t.query.last_committed(),
                "end_offset": t.query.committed_end(),
                "in_flight_left": t.query.in_flight_count(),
                # batches in flight when the drain was asked for
                "was_mid_batch": was_mid_batch,
                # the controller's knobs at the end (a restart starts
                # from the cold values)
                "controller_knobs": (
                    self.controller.knob_values_for(
                        t.spec.tenant_id
                    )
                    if self.controller is not None else None
                ),
            },
        )
        try:
            t.query.stop()
        except Exception as e:
            emit_event(
                event="tenant_error", tenant=t.spec.tenant_id,
                error=repr(e), during="stop",
            )
        return done

    def drain(self) -> int:
        """Settle every live tenant (see :meth:`_settle_tenant`), write
        the daemon's marker, and report the batches committed meanwhile.
        Idempotent; holds the scheduler's lock, so a drain from another
        thread waits for the round in progress.  The markers name the
        tenants that had batches in flight."""
        with self._sched_lock:
            if self.drained:
                return 0
            mid_batch = [
                t.spec.tenant_id for t in self.tenants
                if t.state != "STOPPED" and t.query.in_flight_count() > 0
            ]
            committed = 0
            for t in self.tenants:
                if t.state == "STOPPED":
                    continue
                committed += self._settle_tenant(
                    t, self._drain_reason,
                    t.spec.tenant_id in mid_batch,
                )
            self.drained = True
            _atomic_json(
                os.path.join(self.root_dir, DAEMON_DRAIN_MARKER),
                {
                    "ts": time.time(),
                    "reason": self._drain_reason,
                    "pid": os.getpid(),
                    "tenants": {
                        t.spec.tenant_id: t.state for t in self.tenants
                    },
                    "mid_batch_tenants": mid_batch,
                    "batches_committed_at_drain": committed,
                    "controller_knobs": (
                        self.controller.knob_values()
                        if self.controller is not None else None
                    ),
                },
            )
            emit_event(
                event="daemon_drained", reason=self._drain_reason,
                tenants=len(self.tenants), committed=committed,
            )
            return committed

    def run(
        self,
        poll_interval: float = 1.0,
        max_batches: Optional[int] = None,
    ) -> Dict[str, Any]:
        """The foreground loop: tick until ``max_batches`` commits or a
        drain request, waiting ``poll_interval`` after an idle round.
        Drains on the way out; the final :meth:`status`."""
        done = 0
        try:
            while not self._drain.is_set():
                delta = self.tick()
                done += delta
                if max_batches is not None and done >= max_batches:
                    break
                if delta == 0:
                    if self._warm_compiles is None:
                        # the first idle round: the first backlog is
                        # served and every live shape seen
                        self.mark_warm()
                    self._drain.wait(poll_interval)
        finally:
            self.drain()
            if self.health_json:
                _atomic_json(self.health_json, self.status())
        return self.status()

    # -- status / teardown --------------------------------------------------

    def status(self) -> Dict[str, Any]:
        return {
            "tenants": {
                t.spec.tenant_id: t.snapshot() for t in self.tenants
            },
            "aggregate": {
                "batches_done": sum(
                    t.batches_done for t in self.tenants
                ),
                "rows_done": sum(t.rows_done for t in self.tenants),
                "states": {
                    s: sum(1 for t in self.tenants if t.state == s)
                    for s in TENANT_STATES
                },
            },
            "compile_ledger": self.compile_ledger(),
            "recompiles_after_warmup": self.recompiles_after_warmup(),
            # one block: the tenants share the card
            "device": (
                self.device_domain.stats()
                if self.device_domain is not None else None
            ),
            "device_failed": self.device_failed,
            "autotune": self.autotune_stats(),
            "slo": (
                self.controller.slo_status()
                if self.controller is not None else None
            ),
            "controller": (
                self.controller.stats()
                if self.controller is not None else None
            ),
            "health": self.health.snapshot(),
            "breakers": {
                site: snap
                for site, snap in breakers_snapshot().items()
                if site.startswith("tenant/")
            },
            "events_dropped": events_dropped(),
            "events_dropped_by_tenant": events_dropped(by_tenant=True),
            "drain_requested": self.drain_requested,
            "drained": self.drained,
            "storage": {
                "global": self.storage.status(),
                "tenants": {
                    tid: plane.status()
                    for tid, plane in self._tenant_storage.items()
                },
                "engines": {
                    t.spec.tenant_id: t.query.storage_stats()
                    for t in self.tenants
                },
            },
        }

    def close(self) -> None:
        """Teardown: detach the strike observer and the owned health
        monitor, stop the live engines, close the sources, evict every
        tenant's breakers.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        remove_event_observer(self._observer)
        if self._owns_health:
            self.health.close()
        for t in self.tenants:
            if t.state != "STOPPED":
                try:
                    t.query.stop()
                except Exception:
                    pass
                self._close_source(t)
            reset_breakers(prefix=t.prefix)
