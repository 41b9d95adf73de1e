"""Event stream to metrics: one observer folds every structured event
into the registry.

Counterpart of ``sntc_tpu/obs/bridge.py`` (``install_event_metrics``):
every event counts into ``sntc_events_total{event, site, tenant}`` (a
``tenant/<id>/<site>`` site splits into its bare site and the tenant
label, :func:`split_tenant_site`), a ``quarantine`` event also counts into
``sntc_batches_quarantined_total``, a ``rows_rejected`` event into
``sntc_rows_rejected_total{reason}`` and a ``load_shed`` event its
offsets into ``sntc_shed_offsets_total`` (which the SLO controller
reads), and a ``drift_detected`` event its divergence into the
``sntc_drift_divergence`` gauge (the drift monitor also sets it on every
full window).  The event's tenant labels each of these series.

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


def split_tenant_site(record: Dict[str, Any]):
    """(site, tenant) of one event record: the explicit ``tenant`` field
    wins; a ``tenant/<id>/<site>`` site splits into the bare site and
    the tenant, so both stay aggregable."""
    site = record.get("site") or ""
    tenant = record.get("tenant") or ""
    if isinstance(site, str) and site.startswith("tenant/"):
        parts = site.split("/", 2)
        if len(parts) == 3:
            tenant = tenant or parts[1]
            site = parts[2]
    return site, tenant


def _observe(record: Dict[str, Any]) -> None:
    global _errors
    try:
        event = record.get("event")
        if not event:
            return
        site, tenant = split_tenant_site(record)
        labels: Dict[str, str] = {"event": str(event)}
        if site:
            labels["site"] = str(site)
        if tenant:
            labels["tenant"] = str(tenant)
        inc("sntc_events_total", 1, **labels)
        tlabel = {"tenant": str(tenant)} if tenant else {}
        if event == "rows_rejected":
            reasons = record.get("reasons")
            if isinstance(reasons, dict) and reasons:
                for reason, n in reasons.items():
                    inc("sntc_rows_rejected_total", int(n),
                        reason=str(reason), **tlabel)
            else:
                inc("sntc_rows_rejected_total",
                    int(record.get("count") or 0), reason="unknown",
                    **tlabel)
        elif event == "load_shed":
            inc("sntc_shed_offsets_total",
                int(record.get("offsets_shed") or 0), **tlabel)
        elif event == "quarantine":
            inc("sntc_batches_quarantined_total", 1, **tlabel)
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
