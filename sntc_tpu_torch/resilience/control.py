"""Closed-loop control guardrails: the hysteresis under every
knob-steering controller of the port.

Counterpart of ``sntc_tpu/resilience/control.py`` (``ControlPolicy``,
``TuningBudget``, ``Guardrails``), one implementation under both the
ingest autotuner (``data.autotune.IngestAutotuner``) and the SLO
controller (``serve.controller.ServeController``).

:class:`Guardrails` is the state machine:

* **confirm streak**: a proposal must repeat ``confirm`` consecutive
  observation windows before it applies; a different proposal (or none)
  resets the streak;
* **cooldown**: every applied (or budget-denied) decision freezes the
  controller for ``cooldown`` windows;
* **reversal freeze**: a knob that reverses direction more than
  ``max_reversals`` times is frozen for the controller's lifetime, so
  the applied changes are at most :meth:`Guardrails.change_bound`,
  ``Σ_knobs (max_reversals + 1) × (hi − lo) / step``, whatever the
  signal;
* **bounded journal**: every applied, denied or frozen decision is kept
  in memory (the oldest evicted past ``journal_keep``;
  ``decisions_total`` counts them all) and handed to ``on_journal``.

:class:`TuningBudget` caps the extra capacity (pool threads, staged
ranges, pipeline slots) controllers sharing it may grow beyond their
cold defaults.  It charges only capacity above each knob's cold value:
shrinking below it refunds nothing, and growing back to it is free.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class ControlPolicy:
    """The guardrail constants: two confirming windows, two cooldown
    windows, two reversals."""

    confirm: int = 2          # consecutive agreeing windows to apply
    cooldown: int = 2         # windows frozen after an apply
    max_reversals: int = 2    # direction flips per knob before freezing


class TuningBudget:
    """Shared cap on the extra capacity above the cold defaults, per knob
    kind (a keyword cap names a kind; ``None`` = uncapped; a kind never
    declared is uncapped but tracked).  ``try_acquire`` charges an
    increase (False: exhausted), ``release`` refunds a decrease.
    Thread-safe."""

    def __init__(self, **caps: Optional[int]):
        self._caps: Dict[str, Optional[int]] = dict(caps)
        self._used: Dict[str, int] = {k: 0 for k in self._caps}
        self._lock = threading.Lock()

    @classmethod
    def default_for(cls, n_tenants: int) -> "TuningBudget":
        """The serve daemon's default: at most one host's worth of
        extra parse threads, two staged ranges a tenant and one extra
        pipeline slot a tenant."""
        import os

        return cls(
            read_workers=max(4, (os.cpu_count() or 4)),
            prefetch_batches=max(4, 2 * n_tenants),
            pipeline_depth=max(2, n_tenants),
        )

    def try_acquire(self, knob: str, n: int = 1) -> bool:
        with self._lock:
            cap = self._caps.get(knob)
            if cap is not None and self._used.get(knob, 0) + n > cap:
                return False
            self._used[knob] = self._used.get(knob, 0) + n
            return True

    def release(self, knob: str, n: int = 1) -> None:
        with self._lock:
            self._used[knob] = max(0, self._used.get(knob, 0) - n)

    def snapshot(self) -> Dict[str, Dict[str, Optional[int]]]:
        with self._lock:
            keys = set(self._caps) | set(self._used)
            return {k: {"cap": self._caps.get(k),
                        "used": self._used.get(k, 0)}
                    for k in sorted(keys)}


class Guardrails:
    """The hysteresis state machine (see the module docs).  Owners call
    :meth:`observe` once a window with a pure ``propose`` callable.

    ``policy`` is any object with ``confirm``, ``cooldown`` and
    ``max_reversals``.  ``budget_kind`` maps a knob name to its budget
    kind (the name itself by default; the daemon's controller strips its
    ``<tenant>/`` prefix, so every tenant's ``quota`` draws one line)."""

    def __init__(
        self,
        policy=None,
        budget: Optional[TuningBudget] = None,
        *,
        journal_keep: int = 256,
        budget_kind: Optional[Callable[[str], str]] = None,
        on_journal: Optional[Callable[[dict], None]] = None,
    ):
        self.policy = policy or ControlPolicy()
        self.budget = budget
        self.budget_kind = budget_kind or (lambda name: name)
        self.on_journal = on_journal
        self.decisions: List[dict] = []
        self.decisions_total = 0
        self._journal_keep = int(journal_keep)
        self._baseline: Dict[str, int] = {}  # knobs' cold values
        self._budget_held: Dict[str, int] = {}  # extra units charged
        self.windows = 0
        self._pending: Optional[Tuple[str, int]] = None
        self._streak = 0
        self._cooldown = 0
        self._last_dir: Dict[str, int] = {}
        self._reversals: Dict[str, int] = {}
        self.frozen: set = set()

    def usable(self, knobs: Dict, name: str, direction: int) -> bool:
        """Can ``name`` move one step in ``direction`` (in bounds and not
        frozen)?"""
        k = knobs.get(name)
        if k is None or name in self.frozen:
            return False
        cur = k.get()
        return cur < k.hi if direction > 0 else cur > k.lo

    def observe(
        self,
        propose: Callable[[], Optional[Tuple[str, int]]],
        knobs: Dict,
        signal_fields,
        on_applied: Optional[Callable[[str, int, int], None]] = None,
    ) -> Optional[dict]:
        """One observation window: hysteresis, budget, apply.
        ``signal_fields`` is the journal's ``signal`` (a dict, or a
        callable evaluated only when a record is journaled).  The
        journaled record when a knob moved, froze or was denied; else
        None."""
        self.windows += 1
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        prop = propose()
        if prop != self._pending:
            self._pending = prop
            self._streak = 1 if prop is not None else 0
            return None
        if prop is None:
            return None
        self._streak += 1
        if self._streak < self.policy.confirm:
            return None
        name, direction = prop
        self._pending, self._streak = None, 0
        knob = knobs[name]
        last = self._last_dir.get(name)
        if last is not None and last != direction:
            self._reversals[name] = self._reversals.get(name, 0) + 1
            if self._reversals[name] > self.policy.max_reversals:
                self.frozen.add(name)
                return self._journal(name, direction, knob.get(),
                                     knob.get(), action="frozen",
                                     signal_fields=signal_fields)
        cur = knob.get()
        new = knob.clamp(cur + direction * knob.step)
        if new == cur:
            return None
        if self.budget is not None:
            # only capacity above the knob's cold value is charged
            kind = self.budget_kind(name)
            baseline = self._baseline.setdefault(name, cur)
            held = self._budget_held.get(name, 0)
            want = max(0, new - baseline)
            if want > held:
                if not self.budget.try_acquire(kind, want - held):
                    self._cooldown = self.policy.cooldown
                    return self._journal(name, direction, cur, cur,
                                         action="budget_denied",
                                         signal_fields=signal_fields)
            elif want < held:
                self.budget.release(kind, held - want)
            self._budget_held[name] = want
        knob.set(new)
        self._last_dir[name] = direction
        self._cooldown = self.policy.cooldown
        if on_applied is not None:
            on_applied(name, direction, new)
        return self._journal(name, direction, cur, new, action="applied",
                             signal_fields=signal_fields)

    def _journal(self, name, direction, old, new, *, action,
                 signal_fields) -> dict:
        rec = {
            "action": action,
            "knob": name,
            "direction": "up" if direction > 0 else "down",
            "from": old,
            "to": new,
            "window": self.windows,
            "signal": (signal_fields() if callable(signal_fields)
                       else signal_fields),
        }
        self.decisions.append(rec)
        self.decisions_total += 1
        if len(self.decisions) > self._journal_keep:
            del self.decisions[0]
        if self.on_journal is not None:
            self.on_journal(rec)
        return rec

    def applied(self) -> List[dict]:
        return [d for d in self.decisions if d["action"] == "applied"]

    @staticmethod
    def change_bound(knobs: Dict, max_reversals: int) -> int:
        """The no-oscillation bound over ``knobs``: ``Σ (max_reversals +
        1) × (hi − lo) / step`` applied changes, whatever the signal."""
        return sum((max_reversals + 1) * (k.hi - k.lo) // max(1, k.step)
                   for k in knobs.values())
