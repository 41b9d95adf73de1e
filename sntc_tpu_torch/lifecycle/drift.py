"""Drift detection from the live serving stream.

Counterpart of ``sntc_tpu/lifecycle/drift.py``.  Every clean committed
batch produces a ``batch_scored`` event on the structured stream
(``LifecycleManager.on_batch`` computes it from the predictor's output
frame): the prediction-mix histogram (rows per predicted class) and a
fixed-bin confidence histogram (the largest predicted probability of
each row).  :class:`DriftMonitor` folds those events, attached to the
process event stream as :class:`~sntc_tpu_torch.resilience.health.
HealthMonitor` is or fed directly, into two windows:

* **reference**: the first ``window`` batches observed, frozen as the
  incumbent's healthy baseline;
* **current**: a sliding window of the last ``window`` batches.

The divergence is the larger of the Jensen-Shannon divergences between
the reference and current prediction mixes and score histograms (JS is
symmetric and bounded by ln 2, so one threshold serves both).  A breach
emits ``drift_detected`` (component ``model``, DEGRADED in the health
monitor) once per episode; a model swap resets the monitor, so the
promoted model gets a baseline of its own.  Each divergence is set on
the ``sntc_drift_divergence`` gauge.  Everything is float64 numpy and
deterministic: the detection latency on a fixed stream is a constant
the tests pin, equal to the JAX package's.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sntc_tpu_torch.core.frame import to_host
from sntc_tpu_torch.resilience.policy import (
    add_event_observer,
    emit_event,
    remove_event_observer,
)

SCORE_BINS = 10  # fixed confidence-histogram bins over [0, 1]


def js_divergence(p, q, eps: float = 1e-12) -> float:
    """Jensen-Shannon divergence (natural log; at most ln 2) between two
    count or probability vectors; 0/0-safe, normalizes internally."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    p = p / max(p.sum(), eps)
    q = q / max(q.sum(), eps)
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log(a[mask] / b[mask])))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def batch_score_stats(
    out_frame,
    n_classes: int,
    prediction_col: str = "prediction",
    probability_col: str = "probability",
    bins: int = SCORE_BINS,
) -> Dict[str, Any]:
    """One batch's scoring statistics from a predictor OUTPUT frame: the
    prediction mix ``[n_classes]`` and the max-probability confidence
    histogram ``[bins]`` (all zero when the model has no probability
    column)."""
    pred = to_host(out_frame[prediction_col]).astype(np.int64)
    mix = np.bincount(np.clip(pred, 0, n_classes - 1), minlength=n_classes)
    hist = np.zeros(bins, np.int64)
    if probability_col and probability_col in out_frame:
        prob = to_host(out_frame[probability_col])
        if prob.ndim == 2 and prob.shape[0]:
            hist, _ = np.histogram(prob.max(axis=1), bins=bins,
                                   range=(0.0, 1.0))
    return {
        "n_rows": int(pred.shape[0]),
        "prediction_mix": mix.tolist(),
        "score_hist": hist.tolist(),
    }


class DriftMonitor:
    """Windowed divergence test over per-batch scoring statistics.

    ``window`` batches freeze the reference; then every observed batch
    slides the current window, and once it is full a divergence above
    ``threshold`` sets :attr:`detected` and emits ``drift_detected``
    (once per episode).  ``health`` (optional) is told directly; an
    ATTACHED HealthMonitor also reads the event off the stream."""

    def __init__(self, window: int = 8, threshold: float = 0.25,
                 health=None, component: str = "model"):
        if window < 1:
            raise ValueError("window must be >= 1")
        if threshold <= 0:
            raise ValueError("threshold must be > 0")
        self.window = int(window)
        self.threshold = float(threshold)
        self.health = health
        self.component = component
        self._reference: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._ref_acc: List[Tuple[np.ndarray, np.ndarray]] = []
        self._current: deque = deque(maxlen=self.window)
        self.batches_seen = 0
        self.detected = False
        self.detected_batch: Optional[int] = None
        self.last_divergence = 0.0
        self._observer = None

    # -- event-stream feed --------------------------------------------------

    def observe_event(self, record: Dict[str, Any]) -> None:
        if record.get("event") == "batch_scored":
            self.observe(record)

    def attach(self) -> "DriftMonitor":
        """Subscribe to the process event stream (idempotent)."""
        if self._observer is None:
            self._observer = self.observe_event
            add_event_observer(self._observer)
        return self

    def detach(self) -> None:
        if self._observer is not None:
            remove_event_observer(self._observer)
            self._observer = None

    # -- the divergence test ------------------------------------------------

    @staticmethod
    def _window_dists(acc) -> Tuple[np.ndarray, np.ndarray]:
        mix = np.sum([m for m, _ in acc], axis=0).astype(np.float64)
        hist = np.sum([h for _, h in acc], axis=0).astype(np.float64)
        return mix, hist

    def observe(self, stats: Dict[str, Any]) -> Optional[float]:
        """Fold one batch's statistics; the divergence once the current
        window is full (None while the windows fill)."""
        self.batches_seen += 1
        pair = (np.asarray(stats["prediction_mix"], np.float64),
                np.asarray(stats["score_hist"], np.float64))
        if self._reference is None:
            self._ref_acc.append(pair)
            if len(self._ref_acc) >= self.window:
                self._reference = self._window_dists(self._ref_acc)
                self._ref_acc = []
            return None
        self._current.append(pair)
        if len(self._current) < self.window:
            return None
        cur_mix, cur_hist = self._window_dists(self._current)
        ref_mix, ref_hist = self._reference
        div = max(js_divergence(ref_mix, cur_mix),
                  js_divergence(ref_hist, cur_hist))
        self.last_divergence = div
        try:  # the live divergence on the metrics plane
            from sntc_tpu_torch.obs.metrics import set_gauge

            set_gauge("sntc_drift_divergence", div, component=self.component)
        except Exception:
            pass
        if div > self.threshold and not self.detected:
            self.detected = True
            self.detected_batch = stats.get("batch_id")
            emit_event(
                event="drift_detected", component=self.component,
                batch_id=self.detected_batch, divergence=round(div, 6),
                threshold=self.threshold, window=self.window,
            )
            if self.health is not None:
                from sntc_tpu_torch.resilience.health import HealthState

                self.health.report(
                    self.component, HealthState.DEGRADED,
                    reason=f"drift divergence {div:.4f} > {self.threshold}",
                )
        return div

    def reset(self) -> None:
        """Forget the reference and the episode (after a model swap: the
        promoted model earns a fresh baseline)."""
        self._reference = None
        self._ref_acc = []
        self._current.clear()
        self.detected = False
        self.detected_batch = None
        self.last_divergence = 0.0

    def stats(self) -> Dict[str, Any]:
        return {
            "window": self.window,
            "threshold": self.threshold,
            "batches_seen": self.batches_seen,
            "reference_frozen": self._reference is not None,
            "detected": self.detected,
            "detected_batch": self.detected_batch,
            "last_divergence": round(self.last_divergence, 6),
        }
