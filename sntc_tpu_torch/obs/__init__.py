"""Telemetry plane: the metrics registry, the span tracer and the event
bridge.

Counterpart of ``sntc_tpu/obs/``:

* :mod:`~sntc_tpu_torch.obs.metrics`: the process-wide
  :class:`MetricsRegistry` (counters, gauges, fixed-bucket histograms,
  labels) and its Prometheus-text and JSONL exposition;
* :mod:`~sntc_tpu_torch.obs.trace`: the span tracer (``obs.span(
  "stage", **attrs)``) on a ring buffer, exported as Chrome-trace JSON,
  and ``device_trace``, a ``torch.profiler`` capture;
* :mod:`~sntc_tpu_torch.obs.cost`: the fused segments' roofline (FLOPs
  and bytes counted from the bound shapes against the H100's data-sheet
  peaks), under ``SNTC_OBS_COST_ANALYSIS``;
* :mod:`~sntc_tpu_torch.obs.bridge`: the event-stream observer that
  folds every structured resilience event into named metrics.

Imports only the standard library and the port's event stream at import
time, so every layer can depend on it without a cycle.
"""

from sntc_tpu_torch.obs.bridge import install_event_metrics
from sntc_tpu_torch.obs.metrics import (
    CATALOG,
    MetricsRegistry,
    inc,
    observe,
    registry,
    reset_registry,
    set_gauge,
    set_registry,
    snapshot,
)
from sntc_tpu_torch.obs.trace import (
    SpanTracer,
    device_trace,
    disable_tracing,
    enable_tracing,
    span,
    tracer,
    tracing_enabled,
)

__all__ = [
    "CATALOG",
    "MetricsRegistry",
    "registry",
    "set_registry",
    "reset_registry",
    "inc",
    "set_gauge",
    "observe",
    "snapshot",
    "SpanTracer",
    "span",
    "tracer",
    "enable_tracing",
    "disable_tracing",
    "tracing_enabled",
    "device_trace",
    "install_event_metrics",
]
