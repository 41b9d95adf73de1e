"""Per-site circuit breakers: fail fast instead of hammering a dead
dependency.

Counterpart of ``sntc_tpu/resilience/circuit.py`` (it has no device
code).  A :class:`CircuitBreaker` guards one named site (``sink.write``,
``predict.dispatch``, ...) with a sliding window of recent outcomes and
the three-state machine:

``closed``
    Calls flow.  Once the window holds ``min_calls`` outcomes and the
    failure rate reaches ``failure_threshold``, the breaker OPENS.
``open``
    :meth:`allow` is False and :meth:`call` raises
    :class:`CircuitOpenError`.  After ``cooldown_s`` on the breaker's
    clock the next :meth:`allow` moves to half-open.
``half_open``
    Up to ``half_open_max_calls`` probes are admitted; a probe failure
    re-opens (a fresh cooldown), that many successes close the breaker
    and clear the window.

The clock is injectable; transitions emit ``breaker_open`` /
``breaker_half_open`` / ``breaker_closed`` events and set the
``sntc_breaker_state`` gauge.  :func:`breaker_for` hands out one
process-wide breaker per site; the streaming engine takes its own
(``resilience.supervisor.default_breakers``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from sntc_tpu_torch.resilience.policy import emit_event

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitOpenError(RuntimeError):
    """Raised by :meth:`CircuitBreaker.call` while the breaker refuses
    calls; carries the site and seconds until the next probe window."""

    def __init__(self, site: str, retry_after_s: float):
        super().__init__(
            f"circuit breaker for site {site!r} is open; "
            f"next probe in {retry_after_s:.3f}s"
        )
        self.site = site
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Sliding-window failure-rate breaker for one site.

    Thread-safe: the streaming engine records outcomes from its loop
    thread while ``--health-json`` snapshots from the supervisor.
    """

    def __init__(
        self,
        site: str,
        *,
        window: int = 20,
        failure_threshold: float = 0.5,
        min_calls: int = 5,
        cooldown_s: float = 30.0,
        half_open_max_calls: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window < 1:
            raise ValueError("window must be >= 1")
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError("failure_threshold must lie in (0, 1]")
        if min_calls < 1 or min_calls > window:
            raise ValueError("min_calls must lie in [1, window]")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        if half_open_max_calls < 1:
            raise ValueError("half_open_max_calls must be >= 1")
        self.site = site
        self.window = window
        self.failure_threshold = failure_threshold
        self.min_calls = min_calls
        self.cooldown_s = cooldown_s
        self.half_open_max_calls = half_open_max_calls
        self._clock = clock
        self._lock = threading.RLock()
        self._state = CLOSED
        self._outcomes: "deque[bool]" = deque(maxlen=window)  # True = failure
        self._opened_at: Optional[float] = None
        self._probes_in_flight = 0
        self._probe_successes = 0
        self._open_count = 0

    # -- state machine ------------------------------------------------------

    _STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def _transition(self, new_state: str, **fields: Any) -> None:
        old, self._state = self._state, new_state
        try:  # live state on the metrics plane (obs), never fatally
            from sntc_tpu_torch.obs.metrics import set_gauge

            set_gauge(
                "sntc_breaker_state", self._STATE_GAUGE[new_state],
                site=self.site,
            )
        except Exception:
            pass
        emit_event(
            event=f"breaker_{new_state}", site=self.site, from_state=old,
            **fields,
        )

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        """open → half_open once the cooldown elapsed (lock held)."""
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._probes_in_flight = 0
            self._probe_successes = 0
            self._transition(HALF_OPEN)

    def _failure_rate(self) -> float:
        if not self._outcomes:
            return 0.0
        return sum(self._outcomes) / len(self._outcomes)

    def allow(self) -> bool:
        """May a call proceed right now?  A half-open True reserves one
        probe slot; the caller MUST follow with record_success/failure."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return False
            if self._probes_in_flight >= self.half_open_max_calls:
                return False
            self._probes_in_flight += 1
            return True

    def retry_after_s(self) -> float:
        """Seconds until an open breaker next admits a probe (0 when
        calls are currently admissible)."""
        with self._lock:
            self._maybe_half_open()
            if self._state != OPEN:
                return 0.0
            return max(
                0.0, self.cooldown_s - (self._clock() - self._opened_at)
            )

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_max_calls:
                    self._outcomes.clear()
                    self._transition(CLOSED)
                return
            if self._state == OPEN:
                return  # stray outcome from a call admitted pre-open
            self._outcomes.append(False)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the dependency is still down: back to a fresh cooldown
                self._opened_at = self._clock()
                self._open_count += 1
                self._transition(OPEN, probe_failed=True)
                return
            if self._state == OPEN:
                return  # stray outcome from a call admitted pre-open
            self._outcomes.append(True)
            if (
                len(self._outcomes) >= self.min_calls
                and self._failure_rate() >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._open_count += 1
                self._transition(
                    OPEN,
                    failure_rate=round(self._failure_rate(), 4),
                    window=len(self._outcomes),
                )

    def release(self) -> None:
        """Withdraw a reserved half-open probe slot WITHOUT recording
        an outcome — for an allowed call whose result cannot fairly
        score this dependency (a device-classified platform fault
        is the compute plane's evidence, not the guarded site's; the
        slot must not leak, or the breaker wedges half-open forever).
        No-op outside HALF_OPEN."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_in_flight > 0:
                self._probes_in_flight -= 1

    def reset(self) -> None:
        """Back to a fresh CLOSED breaker (window, probes and cooldown
        cleared; ``open_count`` kept): a tenant released from quarantine
        on probation gets a clean window."""
        with self._lock:
            self._outcomes.clear()
            self._opened_at = None
            self._probes_in_flight = 0
            self._probe_successes = 0
            if self._state != CLOSED:
                self._transition(CLOSED, reset=True)

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn()`` through the breaker: refuse when open, record
        the outcome otherwise.  KeyboardInterrupt/SystemExit pass
        through WITHOUT counting as failures — a user interrupt is not
        evidence the dependency is down."""
        if not self.allow():
            raise CircuitOpenError(self.site, self.retry_after_s())
        try:
            out = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out

    def snapshot(self) -> Dict[str, Any]:
        """State dump for health JSON / bench journaling."""
        with self._lock:
            self._maybe_half_open()
            return {
                "site": self.site,
                "state": self._state,
                "failure_rate": round(self._failure_rate(), 4),
                "window_calls": len(self._outcomes),
                "open_count": self._open_count,
                "retry_after_s": round(self.retry_after_s(), 3),
            }


# ---------------------------------------------------------------------------
# process-level registry — for call sites that don't thread instances
# ---------------------------------------------------------------------------

_registry: Dict[str, CircuitBreaker] = {}
_registry_lock = threading.Lock()


def breaker_for(site: str, **kwargs: Any) -> CircuitBreaker:
    """The process-wide breaker for ``site`` (created on first use with
    ``kwargs``; later calls return the existing instance unchanged)."""
    with _registry_lock:
        br = _registry.get(site)
        if br is None:
            br = _registry[site] = CircuitBreaker(site, **kwargs)
        return br


def reset_breakers(prefix: Optional[str] = None) -> None:
    """Drop registered breakers: every one (test isolation), or with
    ``prefix`` only the sites under one namespace (``"tenant/<id>/"``:
    the serve daemon evicts a stopped tenant's breakers so its history
    cannot leak into a later tenant reusing the id)."""
    with _registry_lock:
        if prefix is None:
            _registry.clear()
            return
        for site in [s for s in _registry if s.startswith(prefix)]:
            del _registry[site]


def breakers_snapshot() -> Dict[str, Dict[str, Any]]:
    """Snapshot of every registered breaker, keyed by site."""
    with _registry_lock:
        return {site: br.snapshot() for site, br in _registry.items()}
