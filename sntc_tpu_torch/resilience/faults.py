"""Deterministic fault injection at named sites, armable by tests.

Counterpart of ``sntc_tpu/resilience/faults.py``, the part that
``tuning/`` calls.  Real code calls ``fault_point("<site>")`` before its
work (the port wires ``cv.fit``: ``CrossValidator``'s per-(fold, grid
point) cell under ``faultTolerant``).  Unarmed, that is a dictionary
miss.  Armed through :func:`arm`, the point raises an
:class:`InjectedFault` on a deterministic schedule (``arm(site,
after=2, times=1)`` raises on exactly the 3rd call) and emits a
``fault_injected`` event.

Left for the serving core's port: the ``SNTC_FAULTS`` environment
grammar and its probabilistic faults, the io/timeout/kill kinds, the
DATA kinds and ``fault_data``, the IO kinds and ``fault_disk``, the
DEVICE kinds, tenant-namespaced sites and the metrics mirror.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from sntc_tpu_torch.resilience.policy import emit_event


class InjectedFault(RuntimeError):
    """Raised by an armed :func:`fault_point` (never by real code)."""


@dataclass
class _Armed:
    after: int = 0  # calls to let through before the faults start
    times: Optional[int] = None  # max faults to raise; None = unlimited
    calls: int = 0
    raised: int = 0

    def decide(self) -> bool:
        """Called under the registry lock, once per fault_point hit."""
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times is not None and self.raised >= self.times:
            return False
        self.raised += 1
        return True


_registry: Dict[str, _Armed] = {}
_lock = threading.Lock()


def arm(site: str, *, after: int = 0, times: Optional[int] = 1) -> None:
    """Arm ``site``; by default it raises on the next call, once."""
    with _lock:
        _registry[site] = _Armed(after=after, times=times)


def disarm(site: str) -> None:
    with _lock:
        _registry.pop(site, None)


def clear() -> None:
    """Drop every armed fault."""
    with _lock:
        _registry.clear()


def fault_point(site: str) -> None:
    """The per-site hook real code calls; raises when armed and
    scheduled."""
    spec = _registry.get(site)
    if spec is None:
        return
    with _lock:
        fire = spec.decide()
        call = spec.calls
    if fire:
        emit_event(event="fault_injected", site=site, kind="exc", call=call)
        raise InjectedFault(
            f"injected exc fault at site {site!r} (call {call})"
        )
