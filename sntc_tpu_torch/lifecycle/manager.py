"""LifecycleManager: the one object the engine talks to.

Counterpart of ``sntc_tpu/lifecycle/manager.py``.
``StreamingQuery(lifecycle=LifecycleManager(...))`` wires the model
lifecycle into the serving loop through duck-typed hooks:

* ``on_batch(batch_id, frame, finalize)``: after every CLEAN commit (on
  the engine thread): emit the ``batch_scored`` event (which feeds any
  attached :class:`DriftMonitor`), shadow-score and gate-check through
  the :class:`ModelPromoter`, then, with ``partial_fit``, refit the
  candidate head from the batch's labels;
* ``on_tick(query)``: once per engine round: the probation breach check
  (rollback on an open ``predict.dispatch`` breaker);
* ``take_pending_swap()`` / ``rearm_pending_swap(model)`` /
  ``on_swap_applied(old)``: the deferred hot-swap handshake: the engine
  applies a pending swap only BETWEEN micro-batches, puts it back when
  its safe point fails, and reports a landed one, so the promoter
  advances its state machine and the drift monitor takes a fresh
  baseline for the new model.

A failing hook degrades, never kills, the serving loop: the engine
catches it and emits ``lifecycle_error``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.lifecycle.drift import DriftMonitor, batch_score_stats
from sntc_tpu_torch.lifecycle.promote import ModelPromoter, terminal_head
from sntc_tpu_torch.resilience.policy import emit_event


class LifecycleManager:
    """Compose drift monitoring, incremental refit and promotion.

    ``drift`` and ``promoter`` are each optional: a manager with only a
    DriftMonitor scores batches; one with only a ModelPromoter shadows
    and promotes.  ``partial_fit=True`` arms the online-learning loop:
    every labelled batch refits a candidate head cloned from the
    incumbent (:func:`~sntc_tpu_torch.lifecycle.incremental.
    incremental_estimator_for`, on ``device``, default the head's, or
    over ``mesh``) and keeps it shadowed for the gate."""

    def __init__(
        self,
        *,
        drift: Optional[DriftMonitor] = None,
        promoter: Optional[ModelPromoter] = None,
        partial_fit: bool = False,
        n_classes: Optional[int] = None,
        prediction_col: str = "prediction",
        probability_col: str = "probability",
        device=None,
        mesh=None,
    ):
        self.drift = drift
        self.promoter = promoter
        self.partial_fit = bool(partial_fit)
        if self.partial_fit and promoter is None:
            raise ValueError(
                "partial_fit=True needs a ModelPromoter to shadow the "
                "refit candidate")
        self.prediction_col = prediction_col
        self.probability_col = probability_col
        self._device = device
        self._mesh = mesh
        self._n_classes = n_classes
        self._pf_estimator = None
        self._pf_state = None
        self.batches_scored = 0
        self.partial_fit_batches = 0

    # -- engine hooks --------------------------------------------------------

    def _resolve_classes(self, out_frame) -> int:
        if self._n_classes is None:
            if self.promoter is not None:
                try:
                    self._n_classes = terminal_head(
                        self.promoter.incumbent).num_classes
                except (ValueError, NotImplementedError):
                    pass
            if self._n_classes is None:
                prob = (to_host(out_frame[self.probability_col])
                        if self.probability_col in out_frame else None)
                self._n_classes = (
                    int(prob.shape[1]) if prob is not None and prob.ndim == 2
                    else int(to_host(out_frame[self.prediction_col]).max(
                        initial=0)) + 1)
        return self._n_classes

    def on_batch(self, batch_id: int, frame, finalize) -> None:
        out = finalize()  # once-only in the predictor: a cached read
        stats = batch_score_stats(
            out, self._resolve_classes(out),
            prediction_col=self.prediction_col,
            probability_col=self.probability_col,
        )
        self.batches_scored += 1
        # the drift monitor (and anything else listening) reads this off
        # the structured stream
        emit_event(event="batch_scored", site="model.score",
                   batch_id=batch_id, **stats)
        if self.promoter is None:
            return
        # test-then-train: the gate scores the candidate BEFORE it sees
        # this batch's labels, so both models are judged on unseen data
        self.promoter.on_batch(batch_id, frame, out)
        if self.partial_fit:
            self._partial_fit_candidate(frame, out)

    def _partial_fit_candidate(self, frame, out_frame) -> None:
        """Fold one labelled batch into the incremental candidate head:
        the features from the OUTPUT frame (the prefix keeps the head's
        input column because the head reads it), the labels through the
        promoter's label mapping."""
        from sntc_tpu_torch.lifecycle.incremental import (
            incremental_estimator_for,
        )

        y = self.promoter._labels_from(frame)
        if y is None:
            return
        known = y >= 0
        if not known.any():
            return
        head = terminal_head(self.promoter.incumbent)
        if self._pf_estimator is None:
            self._pf_estimator = incremental_estimator_for(
                head, mesh=self._mesh, device=self._device)
        feats_col = head.getFeaturesCol()
        if feats_col not in out_frame:
            return
        X_all = to_host(out_frame[feats_col])
        if X_all.shape[0] != y.shape[0]:
            # a row-dropping stage broke the row alignment (the
            # promoter's shadow scoring skips such a batch too)
            return
        batch = Frame({
            self._pf_estimator.getFeaturesCol(): X_all[known],
            self._pf_estimator.getLabelCol(): y[known].astype(np.float64),
        })
        # the incumbent's label universe fixes the state's class count: a
        # first mini-batch rarely carries every class
        try:
            k = int(head.num_classes)
        except (NotImplementedError, TypeError):
            k = self._n_classes
        model, self._pf_state = self._pf_estimator.partial_fit(
            batch, self._pf_state, n_classes=k)
        self.partial_fit_batches += 1
        self.promoter.update_candidate(model)

    def on_tick(self, query=None) -> None:
        if self.promoter is not None:
            self.promoter.on_tick(query)

    def take_pending_swap(self):
        if self.promoter is None:
            return None
        return self.promoter.take_pending_swap()

    def rearm_pending_swap(self, model) -> None:
        if self.promoter is not None:
            self.promoter.rearm_pending_swap(model)

    def on_swap_applied(self, old_model) -> None:
        if self.promoter is not None:
            self.promoter.on_swap_applied(old_model)
        if self.drift is not None:
            # the promoted (or restored) model earns a fresh baseline:
            # its healthy prediction mix IS expected to differ
            self.drift.reset()

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "batches_scored": self.batches_scored,
            "partial_fit": self.partial_fit,
            "partial_fit_batches": self.partial_fit_batches,
        }
        if self.drift is not None:
            out["drift"] = self.drift.stats()
        if self.promoter is not None:
            out["promoter"] = self.promoter.stats()
        return out
