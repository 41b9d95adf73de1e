"""Shadow promotion and crash-safe hot swap of the serving model.

Counterpart of ``sntc_tpu/lifecycle/promote.py``.
:class:`ModelPromoter` owns the candidate's whole life:

1. **shadow**: the candidate head is grafted onto the INCUMBENT's
   feature prefix (:func:`graft_head` reuses the same fitted stage and
   ``FusedSegment`` objects) and scored on every live labelled batch
   through a :class:`~sntc_tpu_torch.serve.transform.BatchPredictor` of
   the head alone, with the engine's shape buckets (so its padded
   dispatches go through ``pad_assemble`` at the engine's shapes);
2. **gate**: per-batch macro-F1 verdicts (incumbent against candidate)
   are journaled to ``<checkpoint>/promotion.jsonl``; when the
   candidate's mean beats the incumbent's by more than ``margin`` over
   a full ``window``, the candidate is promoted;
3. **publish**: the candidate is saved OVER the serving model path by
   ``mlio.save_model`` (staged, sealed, renamed; the incumbent is kept
   at ``<path>.prev``), then ``model_marker.json`` records the new
   generation through ``resilience.storage.write_marker``.  Kill points:
   ``model.publish`` (before the publish: nothing changed on disk),
   ``model.swap`` first call (published, not swapped: a restart loads
   and serves the candidate), ``model.swap`` second call (swapped);
4. **swap**: the in-engine swap waits for the engine's next safe point
   (``StreamingQuery`` applies it only between micro-batches, never with
   a delivery in the air);
5. **probation / rollback**: after the swap ``probation_batches`` clean
   commits must land while the ``predict.dispatch`` circuit breaker
   stays closed; a breach restores the previous generation (the retained
   incumbent object, so predictions come back bitwise, or ``<path>.prev``
   when nothing is in memory) and republishes it.

The engine reaches the promoter through ``on_batch`` / ``on_tick`` /
``take_pending_swap``, usually composed by
:class:`~sntc_tpu_torch.lifecycle.manager.LifecycleManager`.  The
journal records and the marker are the JAX package's, so either
package's doctor and promoter read the other's.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from sntc_tpu_torch.core.base import PipelineModel
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.models.base import ClassificationModel
from sntc_tpu_torch.resilience.faults import fault_point
from sntc_tpu_torch.resilience.policy import emit_event
from sntc_tpu_torch.serve.transform import BatchPredictor

MODEL_MARKER = "model_marker.json"
PROMOTION_JOURNAL = "promotion.jsonl"


def macro_f1(y_true, y_pred, n_classes: Optional[int] = None) -> float:
    """Unweighted mean of per-class F1 over every class seen in the
    labels or the predictions, 0/0 → 0: the gating metric, in plain
    numpy."""
    y = np.asarray(y_true, np.int64)
    p = np.asarray(y_pred, np.int64)
    if y.size == 0:
        return 0.0
    classes = np.union1d(np.unique(y), np.unique(p))
    if n_classes is not None:
        classes = classes[classes < n_classes]
    f1s: List[float] = []
    for c in classes:
        tp = float(np.sum((y == c) & (p == c)))
        fp = float(np.sum((y != c) & (p == c)))
        fn = float(np.sum((y == c) & (p != c)))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2.0 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return float(np.mean(f1s)) if f1s else 0.0


def _locate_head(stages: List) -> int:
    """Index of the terminal plain-stage ClassificationModel; raises when
    the head was fused INTO a segment (lifecycle serving compiles with
    ``fuse_heads=False``)."""
    from sntc_tpu_torch.fuse import FusedSegment

    for i in range(len(stages) - 1, -1, -1):
        stage = stages[i]
        if isinstance(stage, ClassificationModel):
            return i
        if isinstance(stage, FusedSegment) and stage._head is not None:
            raise ValueError(
                "classifier head is fused into a FusedSegment; compile "
                "the serving pipeline with fuse_heads=False to make the "
                "head hot-swappable (the feature-prefix segments stay "
                "fused and are reused across swaps)"
            )
    raise ValueError("no ClassificationModel head found in pipeline")


def terminal_head(model) -> ClassificationModel:
    """The serving model's classifier head (the swap unit)."""
    if isinstance(model, ClassificationModel):
        return model
    if isinstance(model, PipelineModel):
        return model.getStages()[_locate_head(model.getStages())]
    raise ValueError(
        f"cannot locate a classifier head in {type(model).__name__}")


def graft_head(serving, head: ClassificationModel):
    """A serving model with ``head`` in place of the terminal classifier,
    REUSING every other fitted stage object (fused segments included),
    so a swap or a shadow adds no feature-prefix work of its own."""
    head = terminal_head(head)
    if isinstance(serving, ClassificationModel):
        return head
    if not isinstance(serving, PipelineModel):
        raise ValueError(
            f"cannot graft a head onto {type(serving).__name__}")
    stages = list(serving.getStages())
    idx = _locate_head(stages)
    old = stages[idx]
    if head.getFeaturesCol() != old.getFeaturesCol():
        raise ValueError(
            f"candidate head reads {head.getFeaturesCol()!r} but the "
            f"incumbent prefix produces {old.getFeaturesCol()!r}"
        )
    stages[idx] = head
    return PipelineModel(stages=stages)


def read_model_marker(checkpoint_dir: str) -> Optional[Dict[str, Any]]:
    """The last published model-generation record, or None."""
    path = os.path.join(checkpoint_dir, MODEL_MARKER)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class ModelPromoter:
    """Candidate lifecycle: shadow-score → gate → publish → swap →
    probation/rollback (see the module docs).

    ``incumbent`` is the live SERVING model (what the engine's predictor
    wraps); ``incumbent_raw`` the persistable form published to
    ``serving_path`` (the raw fitted pipeline: fused segments are a
    serving artifact and are never saved).  ``labels`` maps the stream's
    label strings to class indices (None: the label column already holds
    indices).  ``bucket_rows`` mirrors the engine predictor's shape
    buckets.  ``device`` is where the shadow predictor pads and where a
    loaded candidate or ``.prev`` is placed (default: the incumbent
    head's device)."""

    def __init__(
        self,
        incumbent,
        *,
        incumbent_raw=None,
        serving_path: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        window: int = 8,
        margin: float = 0.0,
        label_col: str = "label",
        labels: Optional[List[str]] = None,
        bucket_rows: int = 0,
        probation_batches: int = 8,
        breaker=None,
        health=None,
        device=None,
    ):
        if window < 1:
            raise ValueError("window must be >= 1")
        if (serving_path is not None and incumbent_raw is None
                and isinstance(incumbent, PipelineModel)):
            # a bare head saved over a PIPELINE checkpoint would leave a
            # restart unable to transform raw flow columns
            raise ValueError(
                "ModelPromoter with a serving_path and a pipeline "
                "incumbent needs incumbent_raw (the persistable fitted "
                "pipeline) so promotions publish a restart-servable "
                "checkpoint"
            )
        self.incumbent = incumbent
        self.incumbent_raw = incumbent_raw
        self.serving_path = serving_path
        self.checkpoint_dir = checkpoint_dir
        self.window = int(window)
        self.margin = float(margin)
        self.label_col = label_col
        self.labels = list(labels) if labels is not None else None
        self._label_index = (
            {str(v): i for i, v in enumerate(self.labels)}
            if self.labels is not None else None)
        self.bucket_rows = int(bucket_rows)
        self.probation_batches = int(probation_batches)
        self.breaker = breaker
        self.health = health
        if device is None:
            device = getattr(terminal_head(incumbent), "device", "cuda")
        self.device = device
        self.candidate = None  # serving form (grafted onto the prefix)
        self.candidate_head: Optional[ClassificationModel] = None
        self.candidate_source: Optional[str] = None
        self._journal_writer = None
        self._shadow: Optional[BatchPredictor] = None
        self._full_shadow: Optional[BatchPredictor] = None
        self._scores: deque = deque(maxlen=self.window)
        self._pending_swap = None
        self._swap_kind: Optional[str] = None
        # the retained previous generation for in-memory rollback: the
        # EXACT incumbent objects, so restored predictions are bitwise
        self._previous = None  # (serving, raw)
        marker = (read_model_marker(checkpoint_dir)
                  if checkpoint_dir is not None else None)
        self.generation = int(marker["generation"]) if marker else 0
        self.state = "idle"
        self._probation_left = 0
        self.promotions = 0
        self.rollbacks = 0

    # -- candidate management ----------------------------------------------

    def _resolve_head(self, model) -> ClassificationModel:
        """The candidate's head, normalized to the incumbent prefix's
        output column: when the serving compile folded the scaler into
        the head (the default serve path), the incumbent head reads the
        PRE-scaler column, and the same fold bakes the candidate
        pipeline's OWN scaler into its head."""
        head = terminal_head(model)
        inc_col = terminal_head(self.incumbent).getFeaturesCol()
        if head.getFeaturesCol() == inc_col or not isinstance(
                model, PipelineModel):
            return head
        from sntc_tpu_torch.fuse import fold_scalers

        folded_head = terminal_head(
            PipelineModel(stages=fold_scalers(list(model.getStages()))))
        if folded_head.getFeaturesCol() == inc_col:
            return folded_head
        return head  # graft_head names the mismatch

    def set_candidate(self, model, source: Optional[str] = None) -> None:
        """Arm shadow scoring for ``model`` (a bare head, or a pipeline
        whose terminal classifier is taken, scaler-fold normalized)."""
        head = self._resolve_head(model)
        self.candidate_head = head
        self.candidate = graft_head(self.incumbent, head)
        # shadow the HEAD alone: scoring reads the incumbent's own
        # prefix output off the served frame (the full graft is the swap
        # target, and the fallback when that column is not kept)
        self._shadow = BatchPredictor(head, bucket_rows=self.bucket_rows,
                                      device=self.device)
        self._full_shadow = None
        self._scores.clear()
        self.candidate_source = source
        self.state = "shadowing"

    def update_candidate(self, model) -> None:
        """Refresh the shadowed head in place (the ``--partial-fit`` loop
        refits the candidate every labelled batch); the scoring history
        is KEPT: the gate judges the candidate line."""
        if self.state in ("probation", "promoting"):
            # probation guards the just-promoted generation, and
            # "promoting" the one whose swap is pending: re-arming a
            # candidate here would disable the breach check.  The first
            # labelled batch after they resolve re-arms the shadow.
            return
        if self.state != "shadowing":
            self.set_candidate(model)
            return
        head = terminal_head(model)
        self.candidate_head = head
        self.candidate = graft_head(self.incumbent, head)
        self._shadow.swap_model(head)
        self._full_shadow = None

    def load_candidate(self, path: str) -> None:
        """Load a candidate checkpoint and arm shadow scoring."""
        from sntc_tpu_torch.mlio import load_model

        self.set_candidate(load_model(path, device=self.device), source=path)

    # -- engine hooks --------------------------------------------------------

    def _labels_from(self, frame) -> Optional[np.ndarray]:
        if self.label_col not in frame:
            return None
        col = to_host(frame[self.label_col])
        if self._label_index is not None:
            return np.asarray(
                [self._label_index.get(str(v), -1) for v in col], np.int64)
        try:
            return np.asarray(col).astype(np.int64)
        except (TypeError, ValueError):
            return None

    def on_batch(self, batch_id: int, frame, out_frame) -> None:
        """One clean committed batch: advance probation, and shadow-score
        the candidate when one is armed and the batch carries labels."""
        if self.state == "probation":
            self._probation_left -= 1
            if self._probation_left <= 0:
                self.state = "idle"
                self._journal({"action": "probation_passed",
                               "generation": self.generation,
                               "batch_id": batch_id})
        if self.state != "shadowing" or self._shadow is None:
            return
        y = self._labels_from(frame)
        if y is None:
            return
        known = y >= 0
        if not known.any():
            return
        head = self.candidate_head
        pred_col = head.getPredictionCol()
        inc_pred = to_host(out_frame[pred_col])
        if inc_pred.shape[0] != y.shape[0]:
            # a row-dropping stage cut rows between the labels and the
            # served output: the mask no longer aligns, skip the batch
            return
        feats_col = head.getFeaturesCol()
        if feats_col in out_frame:
            # the incumbent's OWN prefix output: one head dispatch
            cand_out = self._shadow.predict_frame(
                Frame({feats_col: out_frame[feats_col]}))
        else:
            if self._full_shadow is None:
                self._full_shadow = BatchPredictor(
                    self.candidate, bucket_rows=self.bucket_rows,
                    device=self.device)
            cand_out = self._full_shadow.predict_frame(frame)
        f1_inc = macro_f1(y[known], inc_pred[known])
        f1_cand = macro_f1(y[known], to_host(cand_out[pred_col])[known])
        self._scores.append((f1_inc, f1_cand))
        filled = len(self._scores) == self.window
        mean_inc = float(np.mean([a for a, _ in self._scores]))
        mean_cand = float(np.mean([b for _, b in self._scores]))
        decision = "hold"
        if filled and mean_cand > mean_inc + self.margin:
            decision = "promote"
        self._journal({
            "action": "shadow_score", "batch_id": batch_id,
            "f1_incumbent": round(f1_inc, 6),
            "f1_candidate": round(f1_cand, 6),
            "mean_incumbent": round(mean_inc, 6),
            "mean_candidate": round(mean_cand, 6),
            "window_filled": filled, "decision": decision,
        })
        if decision == "promote":
            self.promote()

    def on_tick(self, query=None) -> None:
        """Per-round probation check: a ``predict.dispatch`` breaker that
        OPENED after the swap is the breach that rolls back (the breaker
        defers the batch itself, so no ``on_batch`` would see it)."""
        if self.state != "probation":
            return
        br = self.breaker
        if br is None and query is not None:
            br = getattr(query, "breakers", {}).get("predict.dispatch")
        if br is not None and br.state == "open":
            self.rollback(
                "predict.dispatch breaker open during post-swap probation")

    def take_pending_swap(self):
        swap, self._pending_swap = self._pending_swap, None
        return swap

    def rearm_pending_swap(self, model) -> None:
        """Put back a taken swap whose safe point failed before the
        predictor flip; ``_swap_kind`` stays, so a re-armed rollback is
        still a rollback on the retry."""
        self._pending_swap = model

    def on_swap_applied(self, old_model) -> None:
        """Called by the engine (through the manager) right after the
        predictor swap landed."""
        # kill point post-swap (the second call of model.swap): a crash
        # here must restart into the same model
        fault_point("model.swap")
        if self._swap_kind is None:
            # a duplicate apply of a resolved swap: nothing is armed
            return
        if self._swap_kind == "rollback":
            emit_event(event="model_swapped", component="model",
                       generation=self.generation, kind="rollback")
            self.state = "rolled_back"
            self._swap_kind = None
            return
        emit_event(event="model_swapped", component="model",
                   generation=self.generation, kind="promote")
        self._previous = (self.incumbent, self.incumbent_raw)
        self.incumbent = self.candidate
        if self.candidate_head is not None \
                and self.incumbent_raw is not None:
            # the form promote() published
            self.incumbent_raw = self._publish_form()
        self.candidate = None
        self.candidate_head = None
        self._shadow = None
        self._full_shadow = None
        self._scores.clear()
        self._swap_kind = None
        self.state = "probation"
        self._probation_left = self.probation_batches

    # -- promote / rollback --------------------------------------------------

    def _write_marker(self, record: Dict[str, Any]) -> None:
        if self.checkpoint_dir is None:
            return
        from sntc_tpu_torch.resilience.storage import write_marker

        # policy DEGRADE: the promotion already published atomically and
        # is not failed retroactively by its marker
        write_marker(os.path.join(self.checkpoint_dir, MODEL_MARKER),
                     record, indent=1)

    def _journal(self, record: Dict[str, Any]) -> None:
        if self.checkpoint_dir is None:
            return
        record = dict(record, ts=time.time())
        if self._journal_writer is None:
            from sntc_tpu_torch.resilience.storage import RotatingJsonlWriter

            self._journal_writer = RotatingJsonlWriter(
                os.path.join(self.checkpoint_dir, PROMOTION_JOURNAL),
                artifact="promotion_journal")
        self._journal_writer.write(record)

    def _publish_form(self):
        """The restart-servable pipeline naming the candidate: the raw
        incumbent's stages with the candidate head grafted in, the raw
        prefix scaler-folded first when the candidate head reads the
        pre-scaler column."""
        if not isinstance(self.incumbent_raw, PipelineModel):
            return self.candidate_head
        target = self.incumbent_raw
        if terminal_head(target).getFeaturesCol() \
                != self.candidate_head.getFeaturesCol():
            from sntc_tpu_torch.fuse import fold_scalers

            target = PipelineModel(
                stages=fold_scalers(list(target.getStages())))
        return graft_head(target, self.candidate_head)

    def promote(self) -> None:
        """Publish the candidate durably, then leave the in-engine swap
        to the engine's next between-batches safe point."""
        if self.candidate is None:
            raise RuntimeError("promote() with no candidate armed")
        from sntc_tpu_torch.mlio import save_model

        # kill point pre-publish: nothing on disk has changed
        fault_point("model.publish")
        published = None
        if self.serving_path is not None:
            # atomic; the incumbent is kept at <serving_path>.prev
            save_model(self._publish_form(), self.serving_path)
            published = self.serving_path
        self.generation += 1
        self._write_marker({
            "generation": self.generation,
            "action": "promoted",
            "path": published,
            "source": self.candidate_source,
            "ts": time.time(),
        })
        # kill point post-publish / pre-swap: the serving path and the
        # marker name the candidate; a restart serves it and the WAL
        # replays the in-flight batches under it
        fault_point("model.swap")
        self._pending_swap = self.candidate
        self._swap_kind = "promote"
        # the gate stays shut until the swap lands: a labelled batch
        # settled in between must not promote again
        self.state = "promoting"
        self.promotions += 1
        self._journal({"action": "promote", "generation": self.generation,
                       "path": published, "source": self.candidate_source})

    def rollback(self, reason: str) -> None:
        """Restore the previous generation: the retained incumbent when
        this process promoted it (bitwise predictions), else
        ``<serving_path>.prev``; the restored model is republished so a
        restart serves it too."""
        restored = restored_raw = None
        if self._previous is not None:
            restored, restored_raw = self._previous
        elif self.serving_path is not None:
            from sntc_tpu_torch.mlio import load_model, prev_checkpoint_path

            raw = load_model(prev_checkpoint_path(self.serving_path),
                             device=self.device, fallback=False)
            restored_raw = raw
            # folded like the incumbent when the serving compile folded
            restored = graft_head(self.incumbent, self._resolve_head(raw))
        if restored is None:
            raise RuntimeError(
                "rollback with no previous generation retained and no "
                "serving_path to recover .prev from")
        publish = restored_raw
        if publish is None and not isinstance(restored, PipelineModel):
            # a bare head incumbent IS its persistable form
            publish = restored
        if self.serving_path is not None and publish is not None:
            from sntc_tpu_torch.mlio import save_model

            save_model(publish, self.serving_path)
        self.generation += 1
        self._write_marker({
            "generation": self.generation,
            "action": "rolled_back",
            "reason": reason,
            "path": self.serving_path,
            "ts": time.time(),
        })
        emit_event(event="model_rollback", component="model", reason=reason,
                   generation=self.generation)
        self.incumbent = restored
        self.incumbent_raw = restored_raw
        self._previous = None
        self._pending_swap = restored
        self._swap_kind = "rollback"
        self.rollbacks += 1
        self.state = "rolling_back"
        self._journal({"action": "rollback", "generation": self.generation,
                       "reason": reason})

    def stats(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "generation": self.generation,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "shadow_window": self.window,
            "scores_buffered": len(self._scores),
            "probation_left": self._probation_left,
            "candidate_source": self.candidate_source,
        }
