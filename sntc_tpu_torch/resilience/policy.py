"""Retry policies and the structured-event stream.

Counterpart of ``sntc_tpu/resilience/policy.py``: :class:`RetryPolicy`
(a frozen value object: max attempts, exponential backoff with
deterministic seeded jitter, an optional overall deadline, a
retryable-exception classifier), :func:`with_retries` (runs a thunk
under a policy, emitting ``retry`` / ``retry_success`` /
``retry_exhausted`` events), :func:`emit_event` (a JSONL line under
``SNTC_RESILIENCE_LOG``, the in-process ring of the last 512 events and
every registered observer: the health monitor and the metrics bridge),
:func:`recent_events`, :func:`events_dropped` (the ring's evictions,
mirrored into ``sntc_events_dropped_total``) and :func:`clear_events`.
The JAX module's ``int_from_env`` serves knobs the port does not have.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import numpy as np

from sntc_tpu_torch.obs.metrics import inc as _metrics_inc


class RetryExhausted(RuntimeError):
    """Every attempt a policy allowed has failed; wraps the last error."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"{site}: {attempts} attempt(s) failed; last error: {last!r}"
        )
        self.site = site
        self.attempts = attempts
        self.last_exception = last


@dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry spec; the backoff schedule is deterministic.

    ``jitter`` is a ± fraction applied to each exponential delay with a
    numpy generator seeded by ``seed``, so the same policy always yields
    the same schedule.  ``deadline_s`` bounds the total elapsed time: a
    backoff that would overshoot it is clamped to the remaining budget
    (the final attempt still runs at the deadline), and once it has
    elapsed no further attempt is made.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    jitter: float = 0.1
    seed: int = 0
    deadline_s: Optional[float] = None
    retryable: Tuple[Type[BaseException], ...] = (Exception,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must lie in [0, 1]")

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable)

    def backoff_schedule(self) -> List[float]:
        """Delay before retry i (i = 1 .. max_attempts-1), exactly."""
        rng = np.random.default_rng(self.seed)
        out = []
        for i in range(max(0, self.max_attempts - 1)):
            base = min(
                self.base_delay_s * self.multiplier**i, self.max_delay_s
            )
            u = float(rng.uniform(-1.0, 1.0))
            out.append(max(0.0, base * (1.0 + self.jitter * u)))
        return out


_RECENT_MAX = 512
_recent: "deque[Dict[str, Any]]" = deque(maxlen=_RECENT_MAX)
_events_lock = threading.Lock()
_step = 0
_t0 = time.perf_counter()
_events_dropped = 0
# evictions of tenant-tagged records, by tenant
_events_dropped_by_tenant: Dict[str, int] = {}
_observers: List[Callable[[Dict[str, Any]], None]] = []


def emit_event(**fields: Any) -> Dict[str, Any]:
    """Append one structured event: a JSONL line when
    ``SNTC_RESILIENCE_LOG`` names a file, and always the in-process ring
    (capped at 512 records; evictions are counted, never silent).  Each
    record carries ``step``, ``elapsed_s``, ``ts`` and ``mono`` besides
    ``fields``, as the JAX package's do.  Then every observer sees the
    record, outside the ring's lock (an observer may emit); an observer
    that raises is removed.  Thread-safe."""
    global _step, _events_dropped
    path = os.environ.get("SNTC_RESILIENCE_LOG")
    with _events_lock:
        record = {
            "step": _step,
            "elapsed_s": round(time.perf_counter() - _t0, 6),
            **fields,
        }
        _step += 1
        record.setdefault("ts", time.time())
        record.setdefault("mono", time.monotonic())
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # an opt-in debug log the operator names and bounds
            with open(path, "a") as f:  # storage: unbounded(debug log)
                f.write(json.dumps(record) + "\n")
        if len(_recent) == _recent.maxlen:
            _events_dropped += 1
            # a tenant-tagged record counts against its tenant too
            evicted = _recent[0].get("tenant")
            if evicted is not None:
                _events_dropped_by_tenant[evicted] = (
                    _events_dropped_by_tenant.get(evicted, 0) + 1)
            try:  # the metrics mirror, never fatally
                _metrics_inc("sntc_events_dropped_total",
                             **({} if evicted is None
                                else {"tenant": evicted}))
            except Exception:
                pass
        _recent.append(record)
        observers = list(_observers)
    for fn in observers:
        try:
            fn(record)
        except Exception as e:
            remove_event_observer(fn)
            print(f"sntc_tpu_torch: event observer {fn!r} raised {e!r}; "
                  "observer removed", file=sys.stderr)
    return record


def recent_events(
    site: Optional[str] = None, event: Optional[str] = None
) -> List[Dict[str, Any]]:
    """The in-process event ring, optionally filtered by site/event."""
    with _events_lock:
        snapshot = list(_recent)
    return [
        r
        for r in snapshot
        if (site is None or r.get("site") == site)
        and (event is None or r.get("event") == event)
    ]


def events_dropped(by_tenant: bool = False):
    """Events evicted from the ring since the last :func:`clear_events`:
    nonzero means :func:`recent_events` is a suffix.  ``by_tenant=True``
    returns the evictions of tenant-tagged records by tenant instead."""
    with _events_lock:
        if by_tenant:
            return dict(_events_dropped_by_tenant)
        return _events_dropped


def add_event_observer(fn: Callable[[Dict[str, Any]], None]) -> None:
    """Run ``fn(record)`` on every later event (the health monitor's
    and the metrics bridge's feed)."""
    with _events_lock:
        if fn not in _observers:
            _observers.append(fn)


def remove_event_observer(fn: Callable[[Dict[str, Any]], None]) -> None:
    with _events_lock:
        if fn in _observers:
            _observers.remove(fn)


def event_observer_count() -> int:
    """Registered observers: a component that attaches one must detach
    it on teardown, so the count stays flat."""
    with _events_lock:
        return len(_observers)


def clear_events() -> None:
    global _events_dropped
    with _events_lock:
        _recent.clear()
        _events_dropped = 0
        _events_dropped_by_tenant.clear()


def with_retries(
    fn: Callable[[], Any],
    policy: Optional[RetryPolicy] = None,
    *,
    site: str = "unspecified",
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Run ``fn()`` under ``policy``, emitting an event per retry.

    Non-retryable exceptions propagate unchanged.  Retryable failures
    sleep the policy's backoff and re-invoke; when the attempts (or the
    deadline) run out, :class:`RetryExhausted` wraps the last error.  A
    backoff that would overshoot ``deadline_s`` is shortened to the
    remaining budget and the final attempt still runs.  ``sleep`` and
    ``clock`` are injectable for tests.
    """
    policy = policy or RetryPolicy()
    schedule = policy.backoff_schedule()
    t0 = clock()
    for attempt in range(1, policy.max_attempts + 1):
        try:
            out = fn()
        except BaseException as e:
            if not policy.is_retryable(e):
                raise
            delay = schedule[attempt - 1] if attempt <= len(schedule) else 0.0
            elapsed = clock() - t0
            remaining = (
                None if policy.deadline_s is None
                else policy.deadline_s - elapsed
            )
            out_of_time = remaining is not None and remaining <= 0
            if attempt >= policy.max_attempts or out_of_time:
                emit_event(
                    event="retry_exhausted", site=site, attempts=attempt,
                    error=repr(e), deadline_hit=bool(out_of_time),
                )
                raise RetryExhausted(site, attempt, e) from e
            if remaining is not None:
                delay = min(delay, remaining)
            emit_event(
                event="retry", site=site, attempt=attempt,
                delay_s=round(delay, 6), error=repr(e),
            )
            sleep(delay)
        else:
            if attempt > 1:
                emit_event(
                    event="retry_success", site=site, attempts=attempt
                )
            return out
    raise AssertionError("unreachable")
