"""Closed-loop SLO controller of the serve plane.

Counterpart of ``sntc_tpu/serve/controller.py``: one supervised engine
(:meth:`ServeController.for_supervisor`) or every tenant of a
``serve.tenancy.ServeDaemon`` (:meth:`ServeController.for_daemon`,
:meth:`~ServeController.attach_tenant`,
:meth:`~ServeController.detach_tenant`), whose SLOs are the
``TenantSpec`` fields.  A tenant's knobs are named ``<id>/<knob>`` under
the one shared ``Guardrails``; their budget kind is the bare knob name.

**The loop.**  Ticked once a supervisor or daemon round, the controller
closes an observation window every ``interval_ticks`` ticks.  Each
window it diffs the metrics registry (committed batches and rows, the
``sntc_batch_duration_seconds`` buckets → a windowed p50 / p99 by
:func:`window_percentile`, shed offsets, ladder strikes; a tenant's by
its label) and reads the engine's backlog, the predictor's
``compile_events`` (the distinct dispatched row shapes) and the
breakers, into one :class:`SloSignal` a target; diagnoses the binding
constraint against the declared :class:`SloPolicy`; and moves one knob
one step through the shared ``resilience.control.Guardrails``, so the
no-oscillation bound holds over the union of the serving knobs and the
ingest knobs.

**The ladder.**  A violator that floods (a shed-rate violation, or fresh
strikes) on the daemon is degraded, never its neighbours: its rate
``quota`` tightens (:data:`QUOTA_FACTORS`), then its ``shed`` cap, then
``escalate`` strikes it on the daemon's ladder, then the fleet rungs
(:data:`FLEET_RUNGS`, present only when the daemon has a ``fleet_hook``).
The escalate and fleet rungs are skipped while the device domain has
failed.  A latency violation raises the ``shape_buckets`` floor when the
window saw new row shapes (single stream only: the daemon's predictors
are shared), else lowers ``pipeline_depth`` (queue wait is latency),
else tightens a tenant's own quota.  A throughput violation delegates to
the controller's own ``data.autotune.IngestAutotuner`` (``read_workers``,
``prefetch_batches``; the controller keeps ``pipeline_depth``), then
deepens the pipeline, then, while every other tenant complies, raises
the tenant's DRR ``weight``.  With no violation one moved knob relaxes
a step toward its cold value (``escalate`` and the fleet rungs never
relax).  The ``shed`` knob steps the supervisor's (or the tenant spec's)
cap and policy down :data:`SHED_LADDER`.

**Evidence.**  Every applied, denied, frozen or delegated decision is
journaled to ``controller.jsonl`` (``RotatingJsonlWriter``, artifact
``controller_journal``; one line a decision with its signal and the knob
map after it), emitted as a ``controller_decision`` event and mirrored
into the ``sntc_ctl_*`` metrics.  Built over an existing journal the
controller first writes a ``restart`` record: the journal's last knob
map against this process's cold values (knobs are process-local).  The
owner treats an exception from :meth:`ServeController.on_tick` as
degradation (``controller_error``), never death.

``device_check`` reads the device fault domain's ``failed`` (the JAX
package reads its ``host_degraded``; the port has no host serving
state): ``stats()["platform_degraded"]``.  The journals of both packages
are equal on the same signals.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from sntc_tpu_torch.data.pipeline import Knob
from sntc_tpu_torch.obs.metrics import inc, registry, set_gauge
from sntc_tpu_torch.resilience.control import (
    ControlPolicy,
    Guardrails,
    TuningBudget,
)
from sntc_tpu_torch.resilience.faults import fault_point
from sntc_tpu_torch.resilience.policy import emit_event

#: the controller's serving-knob action space, the JAX package's names
#: (its journals compare with the port's); ``weight``, ``quota``,
#: ``escalate``, ``migrate`` and ``scale_out`` exist on the daemon's
#: tenants only, ``shape_buckets`` on a single stream only
SERVE_KNOB_NAMES = (
    "pipeline_depth",
    "shape_buckets",
    "weight",
    "quota",
    "shed",
    "escalate",
    "migrate",
    "scale_out",
)

#: the declared SLO fields the controller reads as setpoints
SLO_FIELDS = ("slo_p99_ms", "slo_min_rows_per_sec", "slo_max_shed_rate")

#: the shape-bucket floor ladder: the knob's value is the ladder index;
#: raising it trades padding for fewer distinct row shapes
SHAPE_BUCKET_FLOORS = (0, 64, 128, 256, 512)

#: the fleet rungs of the ladder (one-way, like escalate; inert outside
#: a fleet)
FLEET_RUNGS = ("migrate", "scale_out")

#: the daemon's quota ladder (index i > 0 throttles to base × factor),
#: kept equal to the JAX package's
QUOTA_FACTORS = (None, 0.5, 0.25, 0.125)

#: the shed ladder: index 0 = the declared cap and policy; tightening
#: lowers the backlog cap and finally samples
SHED_LADDER = (None, (8, "oldest"), (4, "oldest"), (2, "sample"))

#: bounds of the plain integer knobs (ladder knobs are bounded by their
#: ladders)
SERVE_KNOB_BOUNDS = {
    "pipeline_depth": (1, 4),
    "weight": (1, 8),
}


@dataclass
class SloPolicy:
    """A declared SLO triple; 0 normalizes to None (undeclared)."""

    slo_p99_ms: Optional[float] = None
    slo_min_rows_per_sec: Optional[float] = None
    slo_max_shed_rate: Optional[float] = None

    def __post_init__(self):
        for f in SLO_FIELDS:
            v = getattr(self, f)
            if v == 0:
                setattr(self, f, None)
            elif v is not None and v < 0:
                raise ValueError(f"{f} must be >= 0 (0/None = unset)")
        if self.slo_max_shed_rate is not None \
                and self.slo_max_shed_rate > 1.0:
            # a shed-rate bound over 1.0 can never be violated: a typo
            raise ValueError("slo_max_shed_rate is a fraction in (0, 1]")

    @classmethod
    def from_spec(cls, spec) -> "SloPolicy":
        return cls(**{f: getattr(spec, f, None) for f in SLO_FIELDS})

    def declared(self) -> bool:
        return any(getattr(self, f) is not None for f in SLO_FIELDS)

    def as_dict(self) -> Dict[str, Optional[float]]:
        return {f: getattr(self, f) for f in SLO_FIELDS}


@dataclass
class SloSignal:
    """One observation window, condensed from the registry's deltas and
    the engine's state (plain data: tests drive
    :meth:`ServeController.step` with synthetic ones)."""

    batches: int = 0
    rows: int = 0
    rows_per_s: float = 0.0
    p50_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    shed_offsets: int = 0
    shed_rate: float = 0.0
    strikes: int = 0
    backlog: int = 0
    compile_events: int = 0
    breaker_open: bool = False
    elapsed_s: float = 0.0

    def as_fields(self) -> Dict[str, Any]:
        return {
            "batches": self.batches,
            "rows": self.rows,
            "rows_per_s": round(self.rows_per_s, 1),
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
            "shed_offsets": self.shed_offsets,
            "shed_rate": round(self.shed_rate, 3),
            "strikes": self.strikes,
            "backlog": self.backlog,
            "compile_events": self.compile_events,
            "breaker_open": self.breaker_open,
        }


def window_percentile(bounds, counts, q: float) -> Optional[float]:
    """The q-th percentile of a windowed histogram (bucket-count deltas)
    by the upper-bound rule: the smallest bound whose cumulative count
    reaches ``ceil(q/100 × total)``.  None on an empty window, ``inf``
    when the rank lands in the +Inf bucket."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = math.ceil(q / 100.0 * total)
    cum = 0
    for bound, n in zip(bounds, counts):
        cum += n
        if cum >= rank:
            return float(bound)
    return float("inf")


class _Target:
    """One controlled stream (a daemon's tenant, keyed by its id, or the
    supervised engine, keyed None): its knobs, the previous window's
    sample and the window's verdicts."""

    def __init__(self, key, engine, slo, stream=None, supervisor=None):
        self.key = key
        self.engine = engine
        self.slo = slo
        self.stream = stream  # the daemon's TenantStream
        self.supervisor = supervisor
        self.tuner = None  # the controller's own IngestAutotuner
        self.knobs: Dict[str, Knob] = {}
        self.prev: Optional[dict] = None
        self.prev_ts: Optional[float] = None
        self.prev_compiles: Optional[int] = None
        self.last_signal: Optional[SloSignal] = None
        self.compliance: Dict[str, bool] = {}
        self.hold: Dict[str, Tuple[int, float]] = {}  # sticky violations
        self.idle_delegations = 0  # consecutive no-op tuner windows
        self.quota_base: Optional[float] = None  # rows/s at 1st throttle

    def controllable(self) -> bool:
        return self.stream is None or self.stream.state not in (
            "QUARANTINED", "STOPPED")


class ServeController:
    """The closed loop (see the module docs).  Built by
    :meth:`for_supervisor` or :meth:`for_daemon`; the owner calls :meth:`on_tick` once a round
    and treats an exception as degradation.  Tests call :meth:`step`
    with synthetic :class:`SloSignal` maps."""

    def __init__(
        self,
        *,
        policy: Optional[ControlPolicy] = None,
        journal_path: Optional[str] = None,
        clock=time.monotonic,
        wall=time.time,
        interval_ticks: int = 1,
        budget: Optional[TuningBudget] = None,
        ingest: bool = True,
        knob_bounds: Optional[dict] = None,
        violation_hold: int = 3,
        device_check=None,
    ):
        self.policy = policy or ControlPolicy()
        self.journal_path = journal_path
        self._journal_writer = None
        self.interval_ticks = max(1, int(interval_ticks))
        self.ingest = bool(ingest)
        self.budget = budget
        self.knob_bounds = dict(SERVE_KNOB_BOUNDS, **(knob_bounds or {}))
        # one-shot evidence (a shed burst) lands in one window, but the
        # confirm streak needs several: a fresh violation stays live for
        # this many further windows (status reports the window's own
        # verdict)
        self.violation_hold = max(0, int(violation_hold))
        self._clock = clock
        self._wall = wall
        self._device_check = device_check
        self.platform_deferrals = 0
        self._daemon = None
        self.targets: List[_Target] = []
        self._knobs: Dict[str, Knob] = {}  # full name -> Knob
        self._defaults: Dict[str, int] = {}  # full name -> cold value
        self._ticks = 0
        self.delegated_total = 0
        self.escalations_total = 0
        self.fleet_requests_total = 0
        # a tenant's "<id>/quota" draws the "quota" line of the budget
        self.guard = Guardrails(
            policy=self.policy, budget=budget,
            budget_kind=lambda name: name.rsplit("/", 1)[-1],
            on_journal=self._on_journal)

    # -- construction -------------------------------------------------------

    @classmethod
    def for_daemon(cls, daemon, **kwargs) -> "ServeController":
        """Attach to every tenant of a ``ServeDaemon`` (the SLOs from
        their specs); the journal is ``<root>/controller.jsonl`` unless
        given."""
        kwargs.setdefault("journal_path",
                          os.path.join(daemon.root_dir, "controller.jsonl"))
        kwargs.setdefault("clock", daemon._clock)
        kwargs.setdefault("budget", daemon.tuning_budget)
        kwargs.setdefault("device_check", daemon.device_degraded)
        ctl = cls(**kwargs)
        ctl._daemon = daemon
        for t in daemon.tenants:
            ctl._attach(_Target(t.spec.tenant_id, t.query,
                                SloPolicy.from_spec(t.spec), stream=t))
        ctl._reconcile_journal()
        return ctl

    def attach_tenant(self, stream) -> None:
        """Attach a tenant the daemon admitted while running, as
        :meth:`for_daemon` attaches the first ones."""
        self._attach(_Target(stream.spec.tenant_id, stream.query,
                             SloPolicy.from_spec(stream.spec),
                             stream=stream))

    def detach_tenant(self, tenant_id: str) -> bool:
        """Detach a removed tenant: its target and knobs go, so the loop
        samples it no more."""
        for t in list(self.targets):
            if t.stream is not None and t.key == tenant_id:
                self.targets.remove(t)
                for base in t.knobs:
                    full = self._full(t, base)
                    self._knobs.pop(full, None)
                    self._defaults.pop(full, None)
                return True
        return False

    @staticmethod
    def _full(t: _Target, base: str) -> str:
        return base if t.key is None else f"{t.key}/{base}"

    @staticmethod
    def _split(name: str) -> Tuple[Optional[str], str]:
        if "/" in name:
            tid, base = name.rsplit("/", 1)
            return tid, base
        return None, name

    @classmethod
    def for_supervisor(cls, supervisor, slo: SloPolicy,
                       **kwargs) -> "ServeController":
        """Attach to the engine a ``QuerySupervisor`` owns; the journal is
        ``<checkpoint>/controller.jsonl`` unless given."""
        kwargs.setdefault("journal_path", os.path.join(
            supervisor.query.checkpoint_dir, "controller.jsonl"))
        kwargs.setdefault("clock", supervisor._clock)
        dom = getattr(supervisor.query.predictor, "device_domain", None)
        if dom is not None:
            kwargs.setdefault("device_check", lambda _d=dom: _d.failed)
        ctl = cls(**kwargs)
        ctl._attach(_Target(None, supervisor.query, slo,
                            supervisor=supervisor))
        ctl._reconcile_journal()
        return ctl

    @staticmethod
    def _fault_wrap(setter, tenant=None):
        """Every live knob setter passes the ``ctl.apply`` fault point
        first; the journal record lands only after the setter returns."""

        def _set(v):
            fault_point("ctl.apply", tenant=tenant)
            setter(v)

        return _set

    @staticmethod
    def _shed_knob(holder, wrap) -> Knob:
        """The shed ladder over a holder of ``max_pending_batches`` and
        ``shed_policy``: index 0 restores the declared pair; a rung never
        loosens a declared cap."""
        orig = (holder.max_pending_batches, holder.shed_policy)
        box = {"i": 0}

        def _set_shed(i, _b=box, _h=holder, _o=orig):
            _b["i"] = int(i)
            if _b["i"] == 0:
                _h.max_pending_batches, _h.shed_policy = _o
                return
            cap, pol = SHED_LADDER[_b["i"]]
            if _o[0] is not None:
                cap = min(cap, _o[0])
            _h.max_pending_batches, _h.shed_policy = cap, pol

        return Knob("shed", lambda _b=box: _b["i"], wrap(_set_shed), 0,
                    len(SHED_LADDER) - 1)

    def _attach(self, t: _Target) -> None:
        self.targets.append(t)
        eng = t.engine
        wrap = lambda fn: self._fault_wrap(fn, t.key)  # noqa: E731
        kn: Dict[str, Knob] = {}

        lo, hi = self.knob_bounds["pipeline_depth"]

        def _set_depth(n, _e=eng):
            _e.pipeline_depth = max(1, int(n))

        kn["pipeline_depth"] = Knob(
            "pipeline_depth", lambda _e=eng: _e.pipeline_depth,
            wrap(_set_depth), lo, hi)

        if t.stream is None:
            # the predictor is this engine's alone: its bucket floor is
            # steerable, as an index into the ladder holding the cold
            # floor
            pred = eng.predictor
            ladder = tuple(sorted(set(SHAPE_BUCKET_FLOORS)
                                  | {int(pred.bucket_rows)}))
            box = {"i": ladder.index(int(pred.bucket_rows))}

            def _set_buckets(i, _b=box, _l=ladder, _p=pred, _e=eng):
                _b["i"] = int(i)
                _p.bucket_rows = _l[_b["i"]]
                _e.shape_buckets = _l[_b["i"]]

            kn["shape_buckets"] = Knob(
                "shape_buckets", lambda _b=box: _b["i"],
                wrap(_set_buckets), 0, len(ladder) - 1)
            if t.supervisor is not None:
                kn["shed"] = self._shed_knob(t.supervisor, wrap)
        else:
            self._attach_tenant_knobs(t, kn, wrap)

        if self.ingest:
            from sntc_tpu_torch.data.autotune import (
                AutotunePolicy,
                IngestAutotuner,
            )

            # the controller owns the ingest loop: a tuner ticked at most
            # once a window, without pipeline_depth (one owner a knob)
            t.tuner = IngestAutotuner(
                policy=AutotunePolicy(
                    interval_ticks=1,
                    confirm=self.policy.confirm,
                    cooldown=self.policy.cooldown,
                    max_reversals=self.policy.max_reversals,
                ),
                budget=self.budget,
                tenant=t.key,
                exclude_knobs=("pipeline_depth",),
            )

        t.knobs = kn
        for base, knob in kn.items():
            full = self._full(t, base)
            self._knobs[full] = knob
            self._defaults[full] = knob.get()
        # the first window's baseline now, so the first round's evidence
        # lands in window 1's delta
        t.prev = self._sample(t)
        t.prev_ts = self._clock()
        t.prev_compiles = t.engine.predictor.compile_events

    def _attach_tenant_knobs(self, t: _Target, kn: Dict[str, Knob],
                             wrap) -> None:
        """A daemon tenant's rungs: ``weight``, ``quota``, ``shed``,
        ``escalate`` and, in a fleet, the fleet rungs."""
        spec = t.stream.spec
        wlo, whi = self.knob_bounds["weight"]

        def _set_weight(n, _s=spec):
            _s.weight = float(max(1, int(n)))

        kn["weight"] = Knob("weight", lambda _s=spec: int(round(_s.weight)),
                            wrap(_set_weight), wlo, whi)

        qbox = {"i": 0}
        qorig = spec.max_rows_per_sec

        def _set_quota(i, _b=qbox, _t=t, _orig=qorig):
            _b["i"] = int(i)
            if _b["i"] == 0:
                _t.stream.set_rate_quota(_orig)
                return
            if _t.quota_base is None:
                # the base is fixed at the first throttle, so the rungs
                # are deterministic afterwards
                observed = (_t.last_signal.rows_per_s
                            if _t.last_signal is not None else 0.0)
                _t.quota_base = max(_orig or 0.0, observed, 1.0)
            _t.stream.set_rate_quota(_t.quota_base * QUOTA_FACTORS[_b["i"]])

        kn["quota"] = Knob("quota", lambda _b=qbox: _b["i"],
                           wrap(_set_quota), 0, len(QUOTA_FACTORS) - 1)
        kn["shed"] = self._shed_knob(spec, wrap)

        ebox = {"n": 0}

        def _escalate(n, _b=ebox, _t=t, _c=self):
            while _b["n"] < int(n):
                _b["n"] += 1
                _c.escalations_total += 1
                if _c._daemon is not None:
                    _c._daemon.strike_tenant(
                        _t.key, "controller escalation: degradation "
                        "ladder exhausted throttle and shed")

        kn["escalate"] = Knob("escalate", lambda _b=ebox: _b["n"],
                              wrap(_escalate), 0,
                              max(1, spec.quarantine_after))

        if self._daemon is not None \
                and getattr(self._daemon, "fleet_hook", None) is not None:
            # at most one request a tenant a daemon's life; the
            # coordinator decides and acts
            for action in FLEET_RUNGS:
                fbox = {"n": 0}

                def _fleet(n, _b=fbox, _t=t, _c=self, _a=action):
                    while _b["n"] < int(n):
                        _b["n"] += 1
                        _c.fleet_requests_total += 1
                        _c._daemon.request_fleet(
                            _a, _t.key, reason="controller: local "
                            "degradation ladder exhausted")

                kn[action] = Knob(action, lambda _b=fbox: _b["n"],
                                  wrap(_fleet), 0, 1)

    # -- journal ------------------------------------------------------------

    def knob_values(self) -> Dict[str, int]:
        return {name: k.get() for name, k in sorted(self._knobs.items())}

    def knob_values_for(self, key) -> Dict[str, int]:
        """One target's live knobs by their bare names (the drain
        markers' ``controller_knobs``)."""
        for t in self.targets:
            if t.key == key:
                return {b: k.get() for b, k in sorted(t.knobs.items())}
        return {}

    def _append_journal(self, rec: dict) -> None:
        if self.journal_path is None:
            return
        # one write a record (a kill may lose the tail line, never tear
        # one); a disk failure buffers it behind a storage_degraded
        # episode instead of stopping the loop
        if self._journal_writer is None:
            from sntc_tpu_torch.resilience.storage import RotatingJsonlWriter

            self._journal_writer = RotatingJsonlWriter(
                self.journal_path, artifact="controller_journal")
        self._journal_writer.write(rec)

    def _reconcile_journal(self) -> None:
        """Over an existing journal: log its last knob map against this
        process's cold values (a ``restart`` record)."""
        path = self.journal_path
        if not path or not os.path.exists(path):
            return
        last, torn = None, 0
        # oldest rotated segment first: the last knob map may lie in the
        # current segment's predecessor
        for seg in (f"{path}.2", f"{path}.1", path):
            if not os.path.exists(seg):
                continue
            with open(seg) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        torn += 1
                        continue
                    if rec.get("knobs"):
                        last = rec
        live = self.knob_values()
        journal_knobs = last.get("knobs") if last else None
        rec = {
            "action": "restart",
            "ts": self._wall(),
            "journal_knobs": journal_knobs,
            "live_knobs": live,
            "delta": (
                {k: {"journal": journal_knobs.get(k), "live": v}
                 for k, v in live.items() if journal_knobs.get(k) != v}
                if journal_knobs else None
            ),
            "torn_lines": torn,
        }
        self._append_journal(rec)
        emit_event(event="controller_restart",
                   knobs_changed=len(rec["delta"] or {}), torn_lines=torn)

    def _on_journal(self, rec: dict) -> None:
        """Mirror every decision into the metrics, the event stream and
        the durable journal."""
        tid, knob = self._split(rec["knob"])
        labels = {} if tid is None else {"tenant": tid}
        inc("sntc_ctl_decisions_total", action=rec["action"], knob=knob,
            **labels)
        if rec["action"] == "applied":
            set_gauge("sntc_ctl_knob_value", rec["to"], knob=knob, **labels)
        emit_event(event="controller_decision", action=rec["action"],
                   knob=knob, direction=rec["direction"], value=rec["to"],
                   **labels)
        self._append_journal(dict(rec, tenant=tid, ts=self._wall(),
                                  knobs=self.knob_values()))

    # -- the signal ---------------------------------------------------------

    @staticmethod
    def _sample(t: _Target) -> dict:
        reg = registry()
        labels = {} if t.key is None else {"tenant": t.key}
        return {
            "batches": reg.get("sntc_batches_committed_total",
                               **labels) or 0.0,
            "rows": reg.get("sntc_rows_committed_total", **labels) or 0.0,
            "shed": reg.get("sntc_shed_offsets_total", **labels) or 0.0,
            "strikes": reg.get("sntc_tenant_strikes_total",
                               **labels) or 0.0,
            "hist": reg.get_histogram("sntc_batch_duration_seconds",
                                      **labels),
        }

    def _window_signal(self, t: _Target, now: float) -> Optional[SloSignal]:
        """This window's deltas against the previous sample (None on the
        first window: the controller never acts on a cold sample)."""
        cur = self._sample(t)
        compiles = t.engine.predictor.compile_events
        prev, prev_ts = t.prev, t.prev_ts
        prev_compiles = t.prev_compiles
        t.prev, t.prev_ts, t.prev_compiles = cur, now, compiles
        if prev is None or prev_ts is None:
            return None
        elapsed = max(1e-9, now - prev_ts)
        batches = int(cur["batches"] - prev["batches"])
        rows = int(cur["rows"] - prev["rows"])
        shed = int(cur["shed"] - prev["shed"])
        strikes = int(cur["strikes"] - prev["strikes"])
        p50 = p99 = None
        if cur["hist"] is not None:
            bounds = cur["hist"]["bounds"]
            prev_counts = (prev["hist"]["buckets"] if prev["hist"] is not None
                           else [0] * len(cur["hist"]["buckets"]))
            deltas = [c - p for c, p in zip(cur["hist"]["buckets"],
                                            prev_counts)]
            p50 = window_percentile(bounds, deltas, 50)
            p99 = window_percentile(bounds, deltas, 99)
            if p99 is not None and math.isinf(p99):
                # the rank is in the +Inf bucket: the window's mean
                # instead, never an inf in the journal
                sum_d = cur["hist"]["sum"] - (
                    prev["hist"]["sum"] if prev["hist"] else 0.0)
                count_d = cur["hist"]["count"] - (
                    prev["hist"]["count"] if prev["hist"] else 0)
                p99 = sum_d / count_d if count_d > 0 else bounds[-1]
            if p50 is not None and math.isinf(p50):
                p50 = p99
        try:
            backlog = t.engine.backlog_offsets()
        except Exception:
            backlog = 0
        unit = t.engine.max_batch_offsets or 1
        breakers = getattr(t.engine, "breakers", {})
        sig = SloSignal(
            batches=batches,
            rows=rows,
            rows_per_s=rows / elapsed,
            p50_ms=None if p50 is None else round(p50 * 1e3, 3),
            p99_ms=None if p99 is None else round(p99 * 1e3, 3),
            shed_offsets=shed,
            shed_rate=shed / max(1.0, shed + batches * unit),
            strikes=strikes,
            backlog=backlog,
            compile_events=compiles - (prev_compiles or 0),
            breaker_open=any(br.state == "open" for br in breakers.values()),
            elapsed_s=elapsed,
        )
        t.last_signal = sig
        return sig

    def _violations(self, t: _Target, sig: SloSignal) -> Dict[str, float]:
        """Each declared axis's violation ratio (> 1 violates; empty:
        compliant), with the sticky hold; refreshes the compliance map
        and its gauges."""
        v: Dict[str, float] = {}
        comp: Dict[str, bool] = {}
        slo = t.slo
        if slo.slo_p99_ms is not None:
            bad = sig.p99_ms is not None and sig.p99_ms > slo.slo_p99_ms
            comp["p99"] = not bad
            if bad:
                v["p99"] = sig.p99_ms / slo.slo_p99_ms
        if slo.slo_min_rows_per_sec is not None:
            # a throughput floor binds only while there is a backlog
            bad = (sig.backlog > 0
                   and sig.rows_per_s < slo.slo_min_rows_per_sec)
            comp["throughput"] = not bad
            if bad:
                v["throughput"] = slo.slo_min_rows_per_sec / max(
                    sig.rows_per_s, 1e-9)
        if slo.slo_max_shed_rate is not None:
            bad = (sig.shed_offsets > 0
                   and sig.shed_rate > slo.slo_max_shed_rate)
            comp["shed"] = not bad
            if bad:
                v["shed"] = sig.shed_rate / slo.slo_max_shed_rate
        t.compliance = comp
        labels = {} if t.key is None else {"tenant": t.key}
        for axis, ok in comp.items():
            set_gauge("sntc_ctl_slo_compliant", 1.0 if ok else 0.0,
                      slo=axis, **labels)
        if sig.p99_ms is not None:
            set_gauge("sntc_ctl_window_p99_seconds", sig.p99_ms / 1e3,
                      **labels)
        # an axis violated now arms `violation_hold` further windows at
        # its severity; a quiet axis burns one held window
        held: Dict[str, float] = {}
        for axis in list(t.hold):
            left, ratio = t.hold[axis]
            if axis in v:
                continue
            if left > 0:
                held[axis] = ratio
                t.hold[axis] = (left - 1, ratio)
            else:
                del t.hold[axis]
        for axis, ratio in v.items():
            t.hold[axis] = (self.violation_hold, ratio)
        return dict(held, **v)

    # -- the controller -----------------------------------------------------

    def _platform_degraded(self) -> bool:
        """The device domain's verdict; a failing check reads False."""
        if self._device_check is None:
            return False
        try:
            return bool(self._device_check())
        except Exception:
            return False

    def _usable(self, t: _Target, base: str, direction: int) -> bool:
        k = t.knobs.get(base)
        if k is None:
            return False
        full = self._full(t, base)
        return self.guard.usable({full: k}, full, direction)

    @staticmethod
    def _tuner_has_action_space(t: _Target) -> bool:
        """An unbound tuner gets one window to bind; one that bound no
        knob (a ``MemorySource`` engine) is passed over."""
        if t.tuner is None:
            return False
        if t.tuner._knobs is None:
            return True
        return bool(t.tuner._knobs)

    def _all_others_compliant(self, t: _Target) -> bool:
        for other in self.targets:
            if other is t or not other.controllable():
                continue
            if other.compliance and not all(other.compliance.values()):
                return False
        return True

    def _plan(
        self, by_target: Dict[Any, Tuple[_Target, Dict[str, float]]]
    ) -> Tuple[Optional[Tuple[str, int]], Optional[_Target]]:
        """The ladder (see the module docs): ``(serving-knob proposal or
        None, ingest-delegation target or None)``."""
        violators = [(t, v) for t, v in by_target.values() if v]
        if violators:
            violators.sort(key=lambda tv: (-max(tv[1].values()),
                                           str(tv[0].key)))
            t, v = violators[0]
            sig = t.last_signal
            flooding = "shed" in v or sig.strikes > 0
            if flooding and t.stream is not None:
                # degrade the violator, never its neighbours; a failed
                # device is not the tenant's doing, so the escalate and
                # fleet rungs wait while it lasts
                for base in ("quota", "shed", "escalate") + FLEET_RUNGS:
                    if base in FLEET_RUNGS and base not in t.knobs:
                        continue  # not in a fleet
                    if (base == "escalate" or base in FLEET_RUNGS) \
                            and self._platform_degraded():
                        self.platform_deferrals += 1
                        continue
                    if self._usable(t, base, +1):
                        return (self._full(t, base), +1), None
                return None, None
            if "p99" in v:
                # latency is compile churn (the bucket floor) or queue
                # wait (the depth); last, the tenant admits less
                if sig.compile_events > 0 and self._usable(
                        t, "shape_buckets", +1):
                    return (self._full(t, "shape_buckets"), +1), None
                if self._usable(t, "pipeline_depth", -1):
                    return (self._full(t, "pipeline_depth"), -1), None
                if t.stream is not None and self._usable(t, "quota", +1):
                    return (self._full(t, "quota"), +1), None
                return None, None
            # throughput: feed the engine first (the ingest tuner), then
            # deepen the pipeline, then, while every neighbour complies,
            # take more of the schedule; a tuner idle for `confirm`
            # windows yields, and gets the floor back after
            delegate_ok = sig.backlog > 0 and self._tuner_has_action_space(t)
            if delegate_ok and t.idle_delegations <= self.policy.confirm:
                return None, t
            if self._usable(t, "pipeline_depth", +1):
                return (self._full(t, "pipeline_depth"), +1), None
            if t.stream is not None and self._all_others_compliant(t) \
                    and self._usable(t, "weight", +1):
                return (self._full(t, "weight"), +1), None
            if delegate_ok:
                return None, t
            return None, None
        # no violation: relax one moved knob toward its cold value
        # (escalate never relaxes: its strikes were spent)
        for t in self.targets:
            if not t.controllable():
                continue
            for base in ("quota", "shed", "weight", "pipeline_depth",
                         "shape_buckets"):
                k = t.knobs.get(base)
                if k is None:
                    continue
                full = self._full(t, base)
                if full in self.guard.frozen:
                    continue
                cur, default = k.get(), self._defaults[full]
                if cur != default:
                    return (full, 1 if cur < default else -1), None
        return None, None

    def step(self, signals: Dict[Any, SloSignal]) -> Optional[dict]:
        """One observation window over the targets' signals (computed by
        :meth:`on_tick`, or synthetic).  At most one knob moves: a
        serving knob through the guardrails or, with no serving
        proposal, one delegated ingest-tuner step."""
        if not signals:
            return None
        inc("sntc_ctl_windows_total")
        by_key = {t.key: t for t in self.targets}
        by_target: Dict[Any, Tuple[_Target, Dict[str, float]]] = {}
        for key, sig in signals.items():
            t = by_key.get(key)
            if t is None:
                continue
            t.last_signal = sig
            if not t.controllable():
                continue
            by_target[key] = (t, self._violations(t, sig))
        prop, delegate = self._plan(by_target)

        def _fields():
            if prop is None:
                return {}
            t = by_key.get(self._split(prop[0])[0])
            return (t.last_signal.as_fields()
                    if t is not None and t.last_signal is not None else {})

        rec = self.guard.observe(lambda: prop, self._knobs, _fields,
                                 on_applied=None)
        if rec is None and prop is None and delegate is not None:
            irec = (delegate.tuner.on_tick(delegate.engine)
                    if delegate.tuner is not None else None)
            if irec is None:
                delegate.idle_delegations += 1
                return rec
            delegate.idle_delegations = 0
            self.delegated_total += 1
            labels = ({} if delegate.key is None
                      else {"tenant": delegate.key})
            inc("sntc_ctl_decisions_total", action="delegated",
                knob=irec["knob"], **labels)
            drec = {
                "action": "delegated",
                "tenant": delegate.key,
                "knob": irec["knob"],
                "window": self.guard.windows,
                "ingest": irec,
                "ts": self._wall(),
                "knobs": self.knob_values(),
            }
            emit_event(event="controller_decision", action="delegated",
                       knob=irec["knob"], **labels)
            self._append_journal(drec)
            return drec
        return rec

    def on_tick(self) -> Optional[dict]:
        """The owner's cadence: a counter bump until the window closes,
        then sample and step.  Exceptions propagate to the owner, which
        degrades (``controller_error``) and goes on."""
        self._ticks += 1
        if self._ticks % self.interval_ticks:
            return None
        now = self._clock()
        signals: Dict[Any, SloSignal] = {}
        for t in self.targets:
            sig = self._window_signal(t, now)
            if sig is not None:
                signals[t.key] = sig
        return self.step(signals)

    # -- evidence -----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The ``controller`` status block, under the JAX keys."""
        out = {
            "windows": self.guard.windows,
            "decisions": self.guard.decisions_total,
            "applied": len(self.guard.applied()),
            "delegated": self.delegated_total,
            "escalations": self.escalations_total,
            "fleet_requests": self.fleet_requests_total,
            "platform_deferrals": self.platform_deferrals,
            "platform_degraded": self._platform_degraded(),
            "frozen": sorted(self.guard.frozen),
            "knobs": self.knob_values(),
            "recent": self.guard.decisions[-8:],
            "journal": self.journal_path,
        }
        if self.budget is not None:
            out["budget"] = self.budget.snapshot()
        if self.ingest:
            out["ingest"] = {(t.key or "_"): t.tuner.stats()
                             for t in self.targets if t.tuner is not None}
        return out

    def slo_status(self) -> Dict[str, Any]:
        """The ``slo`` status block: the declared SLOs, each axis's
        compliance and the last window's signal."""
        out: Dict[str, Any] = {}
        for t in self.targets:
            sig = t.last_signal
            out[t.key or "_"] = {
                "declared": t.slo.as_dict(),
                "compliant": (all(t.compliance.values())
                              if t.compliance else None),
                "axes": dict(t.compliance),
                "window": sig.as_fields() if sig is not None else None,
            }
        return out
