"""Live-model lifecycle: incremental fit, drift detection, shadow
promotion and the crash-safe hot swap on the serving stream.

Counterpart of ``sntc_tpu/lifecycle/``, with its exports:

* **Incremental fit** (:mod:`~sntc_tpu_torch.lifecycle.incremental`):
  ``partial_fit`` of LogisticRegression / NaiveBayes as device
  summarizer passes folded into a decayable host-float64 state;
* **Drift monitor** (:mod:`~sntc_tpu_torch.lifecycle.drift`): each
  batch's prediction mix and confidence histogram ride the event stream
  as ``batch_scored``; a windowed Jensen-Shannon divergence against a
  frozen reference window emits ``drift_detected`` (the ``model``
  component DEGRADED);
* **Shadow promotion** (:mod:`~sntc_tpu_torch.lifecycle.promote`): a
  :class:`ModelPromoter` scores a candidate head on the live labelled
  batches through a shape-bucketed ``BatchPredictor`` of its own, gates
  promotion on macro-F1 over a window and journals every verdict;
* **Hot swap**: the candidate is published with ``save_model`` (the
  incumbent kept at ``<path>.prev``) and ``model_marker.json``, swapped
  into the engine's predictor only BETWEEN micro-batches, and rolled
  back on a ``predict.dispatch`` breaker breach during probation.

:class:`~sntc_tpu_torch.lifecycle.manager.LifecycleManager` composes
them behind ``StreamingQuery(lifecycle=...)``.
"""

from sntc_tpu_torch.lifecycle.drift import (
    DriftMonitor,
    batch_score_stats,
    js_divergence,
)
from sntc_tpu_torch.lifecycle.incremental import (
    LRPartialFitState,
    NBPartialFitState,
    incremental_estimator_for,
)
from sntc_tpu_torch.lifecycle.manager import LifecycleManager
from sntc_tpu_torch.lifecycle.promote import (
    MODEL_MARKER,
    ModelPromoter,
    graft_head,
    macro_f1,
    read_model_marker,
    terminal_head,
)

__all__ = [
    "DriftMonitor",
    "batch_score_stats",
    "js_divergence",
    "LRPartialFitState",
    "NBPartialFitState",
    "incremental_estimator_for",
    "LifecycleManager",
    "ModelPromoter",
    "MODEL_MARKER",
    "graft_head",
    "macro_f1",
    "read_model_marker",
    "terminal_head",
]
