"""Event stream to metrics: one observer folds every structured event
into the registry.

Counterpart of ``sntc_tpu/obs/bridge.py`` (``install_event_metrics``):
every event counts into ``sntc_events_total{event, site}``, a
``quarantine`` event also counts into
``sntc_batches_quarantined_total``, a ``rows_rejected`` event into
``sntc_rows_rejected_total{reason}`` and a ``load_shed`` event its
offsets into ``sntc_shed_offsets_total`` (which the SLO controller
reads), and a ``drift_detected`` event its divergence into the
``sntc_drift_divergence`` gauge (the drift monitor also sets it on every
full window).  The JAX bridge's tenant label waits for tenancy (ROADMAP
queue A), whose events the port does not emit yet.

The observer never raises (``emit_event`` evicts a raising observer);
records it could not fold are counted by :func:`bridge_errors`.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

from sntc_tpu_torch.obs.metrics import inc, set_gauge

_installed = False
_install_lock = threading.Lock()
_errors = 0


def _observe(record: Dict[str, Any]) -> None:
    global _errors
    try:
        event = record.get("event")
        if not event:
            return
        labels: Dict[str, str] = {"event": str(event)}
        if record.get("site"):
            labels["site"] = str(record["site"])
        inc("sntc_events_total", 1, **labels)
        if event == "rows_rejected":
            reasons = record.get("reasons")
            if isinstance(reasons, dict) and reasons:
                for reason, n in reasons.items():
                    inc("sntc_rows_rejected_total", int(n),
                        reason=str(reason))
            else:
                inc("sntc_rows_rejected_total",
                    int(record.get("count") or 0), reason="unknown")
        elif event == "load_shed":
            inc("sntc_shed_offsets_total",
                int(record.get("offsets_shed") or 0))
        elif event == "quarantine":
            inc("sntc_batches_quarantined_total", 1)
        elif event == "drift_detected" \
                and record.get("divergence") is not None:
            set_gauge("sntc_drift_divergence", float(record["divergence"]),
                      component=str(record.get("component") or "model"))
    except Exception:
        _errors += 1


def bridge_errors() -> int:
    return _errors


def install_event_metrics() -> bool:
    """Subscribe the bridge to the process event stream (idempotent;
    True when this call installed it).  The streaming engine's module
    calls it at import, as the JAX package's does."""
    global _installed
    with _install_lock:
        if _installed:
            return False
        from sntc_tpu_torch.resilience.policy import add_event_observer

        add_event_observer(_observe)
        _installed = True
        return True
