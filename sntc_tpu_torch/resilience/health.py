"""Health aggregation and the batch watchdog.

Counterpart of ``sntc_tpu/resilience/health.py``.
:class:`HealthMonitor` keeps one :class:`HealthState` per component
(``engine``, ``sink.write``, ``model``, ...), fed by :meth:`report` and,
once :meth:`~HealthMonitor.attach` ed, by the structured event stream:
``retry`` is DEGRADED, ``retry_exhausted`` / ``quarantine`` /
``breaker_open`` are UNHEALTHY, ``retry_success`` / ``breaker_closed``
are OK, and so on (:data:`_EVENT_STATES`, the JAX table plus the port's
``device_failed``).  A state change emits ``health_changed`` and sets
the ``sntc_health_state`` gauge; :meth:`~HealthMonitor.overall` is the
worst component; :meth:`~HealthMonitor.worst_under` and
:meth:`~HealthMonitor.reset_under` scope both to one daemon tenant's
``tenant/<id>/`` components.

The watchdog: :meth:`~HealthMonitor.batch_started` /
:meth:`~HealthMonitor.batch_finished` bracket each micro-batch and
:meth:`~HealthMonitor.check_watchdog` flags one older than
``max_batch_wall_time`` (a ``watchdog_stall`` event, the engine
UNHEALTHY), once per stalled batch.

The port's device fault domain has no host fallback: a device that keeps
failing stops the query, with a ``device_failed`` event (the model
UNHEALTHY) where the JAX domain emits ``device_degraded``.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from sntc_tpu_torch.resilience.policy import (
    add_event_observer,
    emit_event,
    remove_event_observer,
)


class HealthState(enum.IntEnum):
    """Ordered severity: max() over components is the overall state."""

    OK = 0
    DEGRADED = 1
    UNHEALTHY = 2


# event name -> state it implies for the component that emitted it
_EVENT_STATES: Dict[str, HealthState] = {
    "retry": HealthState.DEGRADED,
    "retry_success": HealthState.OK,
    "retry_exhausted": HealthState.UNHEALTHY,
    "quarantine": HealthState.UNHEALTHY,
    "cv_cell_degraded": HealthState.DEGRADED,
    "breaker_open": HealthState.UNHEALTHY,
    "breaker_half_open": HealthState.DEGRADED,
    "breaker_closed": HealthState.OK,
    "load_shed": HealthState.DEGRADED,
    "watchdog_stall": HealthState.UNHEALTHY,
    "ckpt_fallback": HealthState.DEGRADED,
    # row admission: rejected rows mark the source DEGRADED (the clean
    # rows keep serving)
    "rows_rejected": HealthState.DEGRADED,
    # the storage plane: a journal or marker that cannot write degrades
    # and recovers with the disk; a breached disk budget is DEGRADED
    # until usage falls back under it
    "storage_degraded": HealthState.DEGRADED,
    "storage_recovered": HealthState.OK,
    "disk_budget_exceeded": HealthState.DEGRADED,
    # the model lifecycle: a drift breach degrades the model, a landed
    # swap recovers it, a rollback records that the promoted candidate
    # misbehaved, a failing lifecycle hook degrades (never kills)
    "drift_detected": HealthState.DEGRADED,
    "model_swapped": HealthState.OK,
    "model_rollback": HealthState.DEGRADED,
    "lifecycle_error": HealthState.DEGRADED,
    # the device fault domain: a device that keeps failing stops the
    # query (no host fallback in the port); the model is UNHEALTHY
    "device_failed": HealthState.UNHEALTHY,
}


class HealthMonitor:
    """Per-component health registry + heartbeat watchdog (thread-safe,
    injectable clock)."""

    def __init__(
        self,
        *,
        max_batch_wall_time: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._clock = clock
        self.max_batch_wall_time = max_batch_wall_time
        self._lock = threading.RLock()
        self._components: Dict[str, Dict[str, Any]] = {}
        self._inflight: Dict[int, float] = {}  # batch_id -> started_at
        self._stalled_flagged: set = set()
        self._observer = None

    # -- component states ---------------------------------------------------

    def report(
        self, component: str, state: HealthState, reason: str = ""
    ) -> None:
        """Set ``component``'s state; emits ``health_changed`` on
        change.  Every entry carries BOTH clocks: ``since`` on the
        monitor's (injectable, monotonic) clock for interval math, and
        ``since_wall`` on the wall clock so reports from different
        tenants/processes order on replay analysis."""
        state = HealthState(state)
        with self._lock:
            prev = self._components.get(component)
            changed = prev is None or prev["state"] != state
            self._components[component] = {
                "state": state,
                "reason": reason,
                "since": self._clock() if changed else prev["since"],
                "since_wall": (
                    time.time() if changed else prev["since_wall"]
                ),
            }
        if changed:
            try:  # the metrics plane tracks the live state per component
                from sntc_tpu_torch.obs.metrics import set_gauge

                set_gauge(
                    "sntc_health_state", int(state), component=component
                )
            except Exception:
                pass
            emit_event(
                event="health_changed", component=component,
                state=state.name,
                previous=prev["state"].name if prev else None,
                reason=reason,
            )

    def state_of(self, component: str) -> HealthState:
        with self._lock:
            entry = self._components.get(component)
            return entry["state"] if entry else HealthState.OK

    def overall(self) -> HealthState:
        with self._lock:
            if not self._components:
                return HealthState.OK
            return max(e["state"] for e in self._components.values())

    def worst_under(self, prefix: str) -> HealthState:
        """Worst state of the components named under ``prefix`` (OK when
        none is): a daemon tenant's health, from its own
        ``tenant/<id>/...`` components and none of its neighbours'."""
        with self._lock:
            states = [e["state"] for name, e in self._components.items()
                      if name.startswith(prefix)]
            return max(states) if states else HealthState.OK

    def reset_under(self, prefix: str, reason: str = "") -> None:
        """Set every component under ``prefix`` back to OK (a tenant
        released from quarantine on probation)."""
        with self._lock:
            names = [n for n in self._components if n.startswith(prefix)]
        for name in names:
            self.report(name, HealthState.OK, reason=reason)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "overall": self.overall().name,
                "components": {
                    name: {
                        "state": e["state"].name,
                        "reason": e["reason"],
                        "since": e["since"],
                        "since_wall": e["since_wall"],
                    }
                    for name, e in sorted(self._components.items())
                },
            }

    # -- event-stream aggregation ------------------------------------------

    def observe_event(self, record: Dict[str, Any]) -> None:
        """Fold one structured event into component health (component =
        the event's ``site``, falling back to ``component``)."""
        state = _EVENT_STATES.get(record.get("event"))
        if state is None:
            return
        component = record.get("site") or record.get("component")
        if not component:
            return
        self.report(
            component, state,
            reason=f"event {record['event']}",
        )

    def attach(self) -> "HealthMonitor":
        """Subscribe to the process event stream (idempotent)."""
        if self._observer is None:
            self._observer = self.observe_event
            add_event_observer(self._observer)
        return self

    def detach(self) -> None:
        if self._observer is not None:
            remove_event_observer(self._observer)
            self._observer = None

    def close(self) -> None:
        """Monitor teardown: unsubscribe from the process event stream.
        Every component that ``attach()``es a monitor must call this
        (supervisor/daemon teardown does) — the observer list is
        process-global, so a leaked subscription outlives its monitor
        and keeps folding events into dead state forever.  Idempotent;
        a closed monitor still serves explicit :meth:`report` calls."""
        self.detach()

    # -- heartbeat watchdog -------------------------------------------------

    def batch_started(self, batch_id: int) -> None:
        """Idempotent: re-announcing a batch that is already in flight
        (a retirement round that deferred and retries next tick) keeps
        the ORIGINAL start time, so a batch stuck across many short
        ticks still ages toward ``max_batch_wall_time``."""
        with self._lock:
            self._inflight.setdefault(batch_id, self._clock())

    def batch_finished(self, batch_id: int) -> None:
        with self._lock:
            self._inflight.pop(batch_id, None)
            self._stalled_flagged.discard(batch_id)

    def check_watchdog(self) -> List[int]:
        """Flag in-flight batches older than ``max_batch_wall_time``;
        returns the batch ids NEWLY flagged this call (each stalled
        batch alarms once, not once per poll)."""
        if self.max_batch_wall_time is None:
            return []
        now = self._clock()
        newly = []
        with self._lock:
            for batch_id, started in self._inflight.items():
                age = now - started
                if (
                    age > self.max_batch_wall_time
                    and batch_id not in self._stalled_flagged
                ):
                    self._stalled_flagged.add(batch_id)
                    newly.append((batch_id, age))
        for batch_id, age in newly:
            emit_event(
                event="watchdog_stall", component="engine",
                batch_id=batch_id, age_s=round(age, 3),
                max_batch_wall_time=self.max_batch_wall_time,
            )
            self.report(
                "engine", HealthState.UNHEALTHY,
                reason=(
                    f"batch {batch_id} running {age:.1f}s > "
                    f"max_batch_wall_time={self.max_batch_wall_time}s"
                ),
            )
        return [b for b, _ in newly]
