"""Feedback autotuner of the ingest source graph (tf.data AUTOTUNE,
arxiv 2101.12127).

Counterpart of ``sntc_tpu/data/autotune.py`` (``AutotunePolicy``,
``Signal``, ``IngestAutotuner``).  Once per observation window
(``interval_ticks`` engine rounds) :class:`IngestAutotuner` condenses
the source's stage meters and prefetch counters into a :class:`Signal`,
diagnoses the bottleneck stage and moves one knob one step:
``prefetch_batches`` while the engine waits on cold reads (staging
first), ``read_workers`` while a multi-file batch's parse dominates and
staging has not absorbed it, ``pipeline_depth`` while staging is full
and the engine still trails, and back down when the graph is idle.

The guardrails (``resilience.control.Guardrails``: confirm streak,
cooldown, reversal freeze) bound the applied changes by
``Σ_knobs (max_reversals + 1) × (hi − lo) / step`` whatever the signal.
Every applied or frozen decision is journaled in memory
(``stats()["recent"]``), emitted as an ``autotune_decision`` event and
mirrored into ``sntc_ingest_autotune_decisions_total`` and
``sntc_ingest_knob_value``.  A :class:`TuningBudget` shared by several
tuners caps the extra capacity they may grow together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from sntc_tpu_torch.data.pipeline import Knob, graph_knobs
from sntc_tpu_torch.obs.metrics import inc, set_gauge
from sntc_tpu_torch.resilience.control import Guardrails, TuningBudget
from sntc_tpu_torch.resilience.policy import emit_event

__all__ = ["AutotunePolicy", "IngestAutotuner", "Signal", "TuningBudget"]


@dataclass
class AutotunePolicy:
    """The tuner's constants: two confirming windows, two cooldown
    windows, two reversals, so a serving engine changes a pool size a
    handful of times and then sits still."""

    interval_ticks: int = 4   # engine rounds per observation window
    confirm: int = 2          # consecutive agreeing windows to apply
    cooldown: int = 2         # windows frozen after an apply
    max_reversals: int = 2    # direction flips per knob before freezing
    miss_rate_hi: float = 0.5     # cold-read fraction → widen staging
    occupancy_hi: float = 0.9     # staging full + backlog → deepen pipe
    idle_occupancy_lo: float = 0.25   # everything idle → shrink
    parse_share_hi: float = 0.5   # parse / read-wait → more workers


@dataclass
class Signal:
    """One observation window, condensed (plain data: tests drive
    :meth:`IngestAutotuner.observe` with synthetic ones)."""

    backlog: int = 0          # source offsets available but unplanned
    miss_rate: float = 0.0    # prefetch misses / (hits + misses)
    queue_occupancy: float = 0.0  # staged ranges / prefetch_batches
    read_wait_s: float = 0.0  # read-stage EWMA (engine-observed wait)
    parse_s: float = 0.0      # parse-stage EWMA (per file)
    files_per_batch: int = 1  # offsets one micro-batch covers


class IngestAutotuner:
    """The feedback loop (see the module docs).  An engine built with
    ``StreamingQuery(autotuner=...)`` calls :meth:`on_tick` once a
    round; tests call :meth:`observe` with synthetic signals."""

    def __init__(
        self,
        policy: Optional[AutotunePolicy] = None,
        budget: Optional[TuningBudget] = None,
        tenant: Optional[str] = None,
        bounds: Optional[dict] = None,
        exclude_knobs: Tuple[str, ...] = (),
    ):
        self.policy = policy or AutotunePolicy()
        self.budget = budget
        self.tenant = tenant  # labels the series and the events
        self.bounds = bounds
        # an SLO controller owning this tuner keeps pipeline_depth (one
        # owner a knob): excluded knobs never bind
        self.exclude_knobs = tuple(exclude_knobs)
        self.guard = Guardrails(policy=self.policy, budget=budget,
                                on_journal=self._on_journal)
        self._ticks = 0
        self._last_hits = 0
        self._last_misses = 0
        self._knobs: Optional[Dict[str, Knob]] = None
        self._engine = None

    @property
    def decisions(self) -> List[dict]:
        return self.guard.decisions

    @property
    def decisions_total(self) -> int:
        return self.guard.decisions_total

    @property
    def frozen(self) -> set:
        return self.guard.frozen

    # -- engine cadence ------------------------------------------------------

    def on_tick(self, engine) -> Optional[dict]:
        """One engine round: a counter bump until the window closes, then
        observe and maybe act.  The applied record, if any."""
        self._ticks += 1
        if self._ticks % max(1, self.policy.interval_ticks):
            return None
        if self._knobs is None or engine is not self._engine:
            # (re)bind to this engine's live knobs
            self._engine = engine
            self._knobs = {
                name: k
                for name, k in graph_knobs(engine, self.bounds).items()
                if name not in self.exclude_knobs
            }
        return self.observe(self._signal(engine), self._knobs)

    def _signal(self, engine) -> Signal:
        source = engine.source
        latest = getattr(engine, "_tick_latest", None)
        backlog = engine.backlog_offsets(latest) if latest is not None else 0
        stats_fn = getattr(source, "prefetch_stats", None)
        miss_rate = occupancy = 0.0
        if stats_fn is not None:
            if getattr(source, "prefetch_batches", 0) <= 0:
                # staging off: every read of a backlog is a cold read
                # (the source counts misses only with prefetch armed)
                miss_rate = 1.0 if backlog > 0 else 0.0
            else:
                stats = stats_fn()
                hits_d = stats["hits"] - self._last_hits
                misses_d = stats["misses"] - self._last_misses
                self._last_hits, self._last_misses = (stats["hits"],
                                                      stats["misses"])
                if hits_d + misses_d > 0:
                    miss_rate = misses_d / (hits_d + misses_d)
                occupancy = stats["staged"] / max(1, source.prefetch_batches)
        meters = getattr(source, "meters", {})
        read_m = meters.get("read")
        parse_m = meters.get("parse")
        unit = getattr(engine, "max_batch_offsets", None)
        return Signal(
            backlog=backlog,
            miss_rate=miss_rate,
            queue_occupancy=occupancy,
            read_wait_s=read_m.ewma_s if read_m is not None else 0.0,
            parse_s=parse_m.ewma_s if parse_m is not None else 0.0,
            files_per_batch=unit if unit is not None else max(1, backlog),
        )

    # -- the controller ------------------------------------------------------

    def propose(self, sig: Signal,
                knobs: Dict[str, Knob]) -> Optional[Tuple[str, int]]:
        """Pure bottleneck diagnosis → ``(knob, direction)`` or None:
        staging first, then the parse pool (while misses persist or
        staging is at its ceiling), then the pipeline depth; shrink only
        when idle."""
        p = self.policy

        def usable(name: str, direction: int) -> bool:
            return self.guard.usable(knobs, name, direction)

        if sig.backlog > 0:
            if sig.miss_rate >= p.miss_rate_hi and usable(
                    "prefetch_batches", +1):
                return ("prefetch_batches", +1)
            parse_share = sig.parse_s / max(sig.read_wait_s, 1e-9)
            if (sig.files_per_batch > 1
                    and parse_share >= p.parse_share_hi
                    and (sig.miss_rate > 0.0
                         or not usable("prefetch_batches", +1))
                    and usable("read_workers", +1)):
                return ("read_workers", +1)
            if sig.queue_occupancy >= p.occupancy_hi and usable(
                    "pipeline_depth", +1):
                return ("pipeline_depth", +1)
            return None
        if sig.miss_rate <= 0.0 and sig.queue_occupancy <= \
                p.idle_occupancy_lo:
            # idle: shrink in a fixed order, reclaiming threads, queue
            # slots and budget
            for name in ("prefetch_batches", "read_workers",
                         "pipeline_depth"):
                if usable(name, -1):
                    return (name, -1)
        return None

    def observe(self, sig: Signal,
                knobs: Dict[str, Knob]) -> Optional[dict]:
        """One observation window through the guardrails; the journaled
        record when a knob moved or froze, else None."""
        return self.guard.observe(
            lambda: self.propose(sig, knobs),
            knobs,
            lambda: {
                "backlog": sig.backlog,
                "miss_rate": round(sig.miss_rate, 3),
                "queue_occupancy": round(sig.queue_occupancy, 3),
                "read_wait_s": round(sig.read_wait_s, 6),
                "parse_s": round(sig.parse_s, 6),
                "files_per_batch": sig.files_per_batch,
            },
            on_applied=self._mirror_applied,
        )

    def _mirror_applied(self, name: str, direction: int, new: int) -> None:
        labels = {} if self.tenant is None else {"tenant": self.tenant}
        inc("sntc_ingest_autotune_decisions_total", knob=name,
            direction="up" if direction > 0 else "down", **labels)
        set_gauge("sntc_ingest_knob_value", new, knob=name, **labels)

    def _on_journal(self, rec: dict) -> None:
        fields = dict(event="autotune_decision", action=rec["action"],
                      knob=rec["knob"], direction=rec["direction"],
                      value=rec["to"])
        if self.tenant is not None:
            fields["tenant"] = self.tenant
        emit_event(**fields)

    # -- evidence ------------------------------------------------------------

    def applied(self) -> List[dict]:
        return self.guard.applied()

    def knob_values(self) -> Dict[str, int]:
        if not self._knobs:
            return {}
        return {name: k.get() for name, k in self._knobs.items()}

    def stats(self) -> dict:
        out = {
            "windows": self.guard.windows,
            "decisions": self.decisions_total,
            "applied": len(self.applied()),
            "frozen": sorted(self.frozen),
            "knobs": self.knob_values(),
            "recent": self.decisions[-8:],
        }
        if self.budget is not None:
            out["budget"] = self.budget.snapshot()
        return out
