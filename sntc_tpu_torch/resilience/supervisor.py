"""Query supervision: load shedding, the SLO controller, the health
monitor, the batch watchdog and the preemption-safe drain.

Counterpart of ``sntc_tpu/resilience/supervisor.py``
(``default_breakers`` and :class:`QuerySupervisor`).  The supervisor
owns a ``StreamingQuery``'s loop:

* **Load shedding** (``max_pending_batches``, ``shed_policy``): when the
  backlog exceeds the cap (in micro-batches), :meth:`maybe_shed` sheds
  before the round dispatches: ``oldest`` drops the oldest surplus
  offsets, ``sample`` serves the whole backlog as one row-subsampled
  batch (the engine's ``shed_backlog``: ``<checkpoint>/shed.jsonl`` and
  a ``load_shed`` event).  A round that shed leaves the engine DEGRADED
  even when it committed.
* **SLO control** (``slo``, a ``serve.controller.SloPolicy``;
  ``controller_policy``): a ``ServeController`` over the engine steers
  its depth, bucket floor, the shed knob and (through its own ingest
  tuner) the source's pools, journaling to
  ``<checkpoint>/controller.jsonl``; it ticks after the round, and an
  exception from it emits ``controller_error`` and the loop goes on.

* **Health and watchdog**: a :class:`~sntc_tpu_torch.resilience.health.
  HealthMonitor` attached to the event stream keeps per-site health; a
  daemon thread flags a batch running longer than
  ``max_batch_wall_time`` (``watchdog_stall``, the engine UNHEALTHY)
  even while the engine loop is stuck in it.
* **Drain**: SIGTERM (or :meth:`request_drain`) finishes the in-flight
  batches, commits them, writes ``drain_marker.json`` into the
  checkpoint dir (tmp + rename) and returns; a restart resumes exactly
  once from the offset log.
* **Status**: :meth:`status` (and ``--health-json``, rewritten
  atomically each tick) holds health, breakers, the engine's offsets and
  backlog, ``shed_total_offsets``, the controller's ``slo`` and
  ``controller`` blocks, the device domain's stats, the lifecycle's
  (drift, promotion, ``models_swapped``) and the ``storage`` block (the
  engine's ``storage_stats`` and, under ``disk``, the throttled disk
  measurement of the checkpoint root against ``disk_budget_mb``; a
  breach emits ``disk_budget_exceeded``, DEGRADED), under the JAX keys.
* **Markers**: the drain marker and the status dump are written by the
  storage plane's ``write_marker`` at the ``storage.marker`` fault site,
  policy DEGRADE: a failed write counts a ``storage_degraded`` episode
  and the loop goes on.

The clock is injectable and the loop steps by :meth:`tick`.  The drain
marker records the controller's last knob map (``controller_knobs``).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Dict, Optional

from sntc_tpu_torch.resilience import storage as storage_plane
from sntc_tpu_torch.resilience.circuit import CircuitBreaker, breakers_snapshot
from sntc_tpu_torch.resilience.health import HealthMonitor, HealthState
from sntc_tpu_torch.resilience.policy import emit_event, events_dropped

DRAIN_MARKER = "drain_marker.json"


def _atomic_json(path: str, obj: Dict[str, Any], **dump_kwargs: Any) -> str:
    """Tmp-then-rename publish of a marker or status dump, under the
    DEGRADE policy (see the module docs)."""
    storage_plane.write_marker(path, obj, indent=dump_kwargs.get("indent"),
                               fsync=False)
    return path


def default_breakers(
    clock=time.monotonic, **kwargs: Any
) -> Dict[str, CircuitBreaker]:
    """The serving path's breakers: sink delivery and model dispatch."""
    return {
        site: CircuitBreaker(site, clock=clock, **kwargs)
        for site in ("sink.write", "predict.dispatch")
    }


class QuerySupervisor:
    """Supervises one ``StreamingQuery`` (a single-threaded loop
    owner)."""

    def __init__(
        self,
        query,
        *,
        max_pending_batches: Optional[int] = None,
        shed_policy: str = "oldest",
        max_batch_wall_time: Optional[float] = None,
        health: Optional[HealthMonitor] = None,
        health_json: Optional[str] = None,
        clock=time.monotonic,
        slo=None,
        controller_policy=None,
        disk_budget_mb: Optional[float] = None,
    ):
        if max_pending_batches is not None and max_pending_batches < 1:
            raise ValueError("max_pending_batches must be >= 1 (or None)")
        if shed_policy not in ("oldest", "sample"):
            raise ValueError("shed_policy must be 'oldest' or 'sample'")
        self.query = query
        self.max_pending_batches = max_pending_batches
        self.shed_policy = shed_policy
        self.health_json = health_json
        self._clock = clock
        # a monitor made here is ours to attach and to detach in close()
        self._owns_health = health is None
        self.health = health or HealthMonitor(
            max_batch_wall_time=max_batch_wall_time, clock=clock
        ).attach()
        if max_batch_wall_time is not None and health is not None:
            self.health.max_batch_wall_time = max_batch_wall_time
        self._drain = threading.Event()
        self._drain_reason: Optional[str] = None
        self.shed_total_offsets = 0
        self.batches_done = 0
        self.drained = False
        self.storage = storage_plane.StoragePlane(
            query.checkpoint_dir,
            budget_bytes=(int(disk_budget_mb * (1 << 20))
                          if disk_budget_mb else None),
        )
        # a declared SLO arms the controller over this engine (imported
        # here: the serve package imports this module)
        self.controller = None
        if slo is not None:
            from sntc_tpu_torch.serve.controller import ServeController

            self.controller = ServeController.for_supervisor(
                self, slo, policy=controller_policy, clock=clock)

    def close(self) -> None:
        """Detach the health monitor if this supervisor made it."""
        if self._owns_health:
            self.health.close()

    # -- preemption ---------------------------------------------------------

    def request_drain(self, reason: str = "request_drain") -> None:
        """Ask the loop to finish its in-flight work, commit and stop."""
        if not self._drain.is_set():
            self._drain_reason = reason
            self._drain.set()

    @property
    def drain_requested(self) -> bool:
        return self._drain.is_set()

    def install_signal_handlers(self) -> bool:
        """Route SIGTERM to :meth:`request_drain`.  False off the main
        thread, where Python forbids installing handlers."""
        try:
            signal.signal(
                signal.SIGTERM,
                lambda signum, frame: self.request_drain("SIGTERM"),
            )
            return True
        except ValueError:
            return False

    # -- supervision steps --------------------------------------------------

    def maybe_shed(self, latest: Optional[int] = None) -> Optional[dict]:
        """One admission-control decision; the shed record when load was
        shed.  ``latest`` reuses the tick's source offset read."""
        if self.max_pending_batches is None:
            return None
        record = self.query.shed_backlog(self.max_pending_batches,
                                         policy=self.shed_policy,
                                         latest=latest)
        if record is not None:
            self.shed_total_offsets += record.get("offsets_shed", 0)
            self.health.report(
                "engine", HealthState.DEGRADED,
                reason=f"load shed ({self.shed_policy}): "
                f"backlog > {self.max_pending_batches} batches")
        return record

    def tick(self) -> int:
        """One supervised engine round: shed if needed, advance the
        engine by at most one round, update health, tick the controller;
        the batches committed."""
        q = self.query
        latest = q.source.latest_offset()  # one read per tick
        shed = self.maybe_shed(latest)
        tick_id = q.last_committed() + 1
        # only a tick with work ages a batch toward the watchdog; a batch
        # deferred across ticks keeps its first start time
        if q.in_flight_count() > 0 or latest > q.planned_offset():
            self.health.batch_started(tick_id)
        before = q.last_committed()
        try:
            q._run_one_batch()
        finally:
            if q.last_committed() >= tick_id:
                self.health.batch_finished(tick_id)
        delta = q.last_committed() - before
        self.batches_done += delta
        # a committing engine is healthy, unless this round also shed:
        # sustained overload stays visible in the status
        if delta and shed is None:
            self.health.report("engine", HealthState.OK, reason="committing")
            progress = q.lastProgress
            if progress and not progress.get("quarantined"):
                # a clean commit went through read, predict and sink:
                # those stages have recovered
                for site in ("stream.read", "predict.dispatch", "sink.write"):
                    if self.health.state_of(site) != HealthState.OK:
                        self.health.report(site, HealthState.OK,
                                           reason="batch committed")
        if self.controller is not None:
            try:  # degrade, never kill
                self.controller.on_tick()
            except Exception as e:
                emit_event(event="controller_error", error=repr(e))
        if self.health_json:
            self.write_health_json(latest=latest)
        return delta

    def run(
        self,
        poll_interval: float = 1.0,
        max_batches: Optional[int] = None,
    ) -> Dict[str, Any]:
        """The supervised loop: until ``max_batches`` commits or a drain
        request; an idle tick waits ``poll_interval`` (a drain request
        cuts the wait short).  Returns the final :meth:`status`."""
        watchdog = self._start_watchdog()
        try:
            while not self._drain.is_set():
                delta = self.tick()
                if (max_batches is not None
                        and self.batches_done >= max_batches):
                    break
                if delta == 0:
                    self._drain.wait(poll_interval)
        finally:
            if watchdog is not None:
                watchdog["stop"].set()
                watchdog["thread"].join()
        if self._drain.is_set():
            self._do_drain()
        if self.health_json:
            self.write_health_json()
        return self.status()

    def _start_watchdog(self) -> Optional[dict]:
        if self.health.max_batch_wall_time is None:
            return None
        stop = threading.Event()
        interval = max(0.05, self.health.max_batch_wall_time / 4.0)

        def _poll():
            while not stop.wait(interval):
                self.health.check_watchdog()

        t = threading.Thread(target=_poll, name="sntc-watchdog",
                             daemon=True)
        t.start()
        return {"thread": t, "stop": stop}

    def drain_now(self, reason: str = "drain_now") -> Dict[str, Any]:
        """Drain synchronously (Ctrl-C handlers, tests); the final
        status."""
        self.request_drain(reason)
        self._do_drain()
        if self.health_json:
            self.write_health_json()
        return self.status()

    def _do_drain(self) -> None:
        """Finish the in-flight batches, commit, write the marker."""
        if self.drained:
            return
        q = self.query
        committed = q.drain()
        self.batches_done += committed
        marker = {
            "ts": time.time(),
            "reason": self._drain_reason,
            "last_committed": q.last_committed(),
            "end_offset": q.committed_end(),
            "batches_committed_at_drain": committed,
            "in_flight_left": q.in_flight_count(),
            "pid": os.getpid(),
            # the controller's last knob map: a restart (cold values)
            # logs the difference
            "controller_knobs": (self.controller.knob_values()
                                 if self.controller is not None else None),
        }
        _atomic_json(os.path.join(q.checkpoint_dir, DRAIN_MARKER), marker)
        self.drained = True
        emit_event(
            event="drained", component="engine", reason=self._drain_reason,
            last_committed=marker["last_committed"],
            in_flight_left=marker["in_flight_left"],
        )
        q.stop()

    # -- status -------------------------------------------------------------

    def status(self, latest: Optional[int] = None) -> Dict[str, Any]:
        """Status snapshot; ``latest`` reuses a caller's source offset
        read."""
        q = self.query
        breakers = {
            site: br.snapshot()
            for site, br in getattr(q, "breakers", {}).items()
        }
        for site, snap in breakers_snapshot().items():
            breakers.setdefault(site, snap)
        out = {
            "health": self.health.snapshot(),
            "breakers": breakers,
            "engine": {
                "last_committed": q.last_committed(),
                "end_offset": q.committed_end(),
                "in_flight": q.in_flight_count(),
                "backlog_offsets": q.backlog_offsets(latest),
                "batches_done": self.batches_done,
            },
            "shed_total_offsets": self.shed_total_offsets,
            "events_dropped": events_dropped(),
            "drain_requested": self.drain_requested,
            "drained": self.drained,
        }
        engine_storage = getattr(q, "storage_stats", None)
        out["storage"] = dict(
            engine_storage() if engine_storage is not None else {},
            disk=self.storage.status(),
        )
        dom = getattr(q.predictor, "device_domain", None)
        if dom is not None:
            out["device"] = dom.stats()
        if self.controller is not None:
            out["slo"] = self.controller.slo_status()
            out["controller"] = self.controller.stats()
        # the model lifecycle's drift, promotion and swap state
        lc = getattr(q, "lifecycle", None)
        lc_stats = getattr(lc, "stats", None) if lc is not None else None
        if lc_stats is not None:
            out["lifecycle"] = dict(
                lc_stats(), models_swapped=getattr(q, "models_swapped", 0))
        return out

    def write_health_json(self, latest: Optional[int] = None) -> str:
        """Atomically (re)write the status dump; returns its path."""
        return _atomic_json(self.health_json, self.status(latest), indent=1)
