"""Metrics plane: the registry and the event bridge.

Counterpart of ``sntc_tpu/obs/`` as far as the serving engine's failure
handling counts into it (``metrics.py``, ``bridge.py``).  The span
tracer and the cost hooks (``trace.py``, ``cost.py``) and the metrics
exposition wait for their slice of ROADMAP queue A.  Imports only the
standard library and the port's event stream.
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
    snapshot,
)

__all__ = [
    "CATALOG",
    "MetricsRegistry",
    "inc",
    "install_event_metrics",
    "observe",
    "registry",
    "reset_registry",
    "set_gauge",
    "snapshot",
]
