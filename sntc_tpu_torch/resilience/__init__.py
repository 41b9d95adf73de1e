"""Retry policies, fault injection, the event stream, circuit breakers,
health, the device fault domain and query supervision.

Counterpart of ``sntc_tpu/resilience/`` as far as the serve command's
default form and ``tuning/`` use it: ``policy.py``, ``faults.py``,
``circuit.py``, ``health.py``, ``device.py`` (CUDA errors, no host
fallback), ``storage.py`` (the durable-storage plane and ``fsck``),
``control.py`` (the controllers' guardrails) and ``supervisor.py``
(load shedding and the SLO controller's tick included).
``replicate.py`` waits for its slice of ROADMAP queue A.
"""

from sntc_tpu_torch.resilience.circuit import (
    CircuitBreaker,
    CircuitOpenError,
    breaker_for,
    breakers_snapshot,
    reset_breakers,
)
from sntc_tpu_torch.resilience.control import (
    ControlPolicy,
    Guardrails,
    TuningBudget,
)
from sntc_tpu_torch.resilience.device import (
    DeviceExecError,
    DeviceFaultDomain,
    DevicePolicy,
    annotate_batch,
    classify_device_error,
)
from sntc_tpu_torch.resilience.faults import (
    ALL_KINDS,
    DATA_KINDS,
    IO_KINDS,
    SITES,
    InjectedDeviceFault,
    InjectedDiskFault,
    InjectedFault,
    InjectedIOFault,
    InjectedTimeoutFault,
    arm,
    call_count,
    clear,
    data_fault_armed,
    disarm,
    fault_data,
    fault_disk,
    fault_point,
    parse_faults_env,
)
from sntc_tpu_torch.resilience.health import HealthMonitor, HealthState
from sntc_tpu_torch.resilience.policy import (
    RetryExhausted,
    RetryPolicy,
    add_event_observer,
    clear_events,
    emit_event,
    event_observer_count,
    events_dropped,
    recent_events,
    remove_event_observer,
    with_retries,
)
from sntc_tpu_torch.resilience.supervisor import (
    QuerySupervisor,
    default_breakers,
)

__all__ = [
    "ALL_KINDS",
    "DATA_KINDS",
    "IO_KINDS",
    "SITES",
    "CircuitBreaker",
    "CircuitOpenError",
    "ControlPolicy",
    "DeviceExecError",
    "DeviceFaultDomain",
    "DevicePolicy",
    "Guardrails",
    "HealthMonitor",
    "HealthState",
    "InjectedDeviceFault",
    "InjectedDiskFault",
    "InjectedFault",
    "InjectedIOFault",
    "InjectedTimeoutFault",
    "QuerySupervisor",
    "RetryExhausted",
    "RetryPolicy",
    "TuningBudget",
    "add_event_observer",
    "annotate_batch",
    "arm",
    "breaker_for",
    "breakers_snapshot",
    "call_count",
    "classify_device_error",
    "clear",
    "clear_events",
    "data_fault_armed",
    "default_breakers",
    "disarm",
    "emit_event",
    "event_observer_count",
    "events_dropped",
    "fault_data",
    "fault_disk",
    "fault_point",
    "parse_faults_env",
    "recent_events",
    "remove_event_observer",
    "reset_breakers",
    "with_retries",
]
