"""Retry policies, deterministic fault injection and the structured-event
stream: the part of ``sntc_tpu/resilience/`` that ``tuning/`` calls
(see each module for what is left for the serving core's port)."""

from sntc_tpu_torch.resilience.faults import (
    InjectedFault,
    arm,
    clear,
    disarm,
    fault_point,
)
from sntc_tpu_torch.resilience.policy import (
    RetryExhausted,
    RetryPolicy,
    clear_events,
    emit_event,
    recent_events,
    with_retries,
)

__all__ = [
    "RetryPolicy",
    "RetryExhausted",
    "with_retries",
    "emit_event",
    "recent_events",
    "clear_events",
    "fault_point",
    "arm",
    "disarm",
    "clear",
    "InjectedFault",
]
