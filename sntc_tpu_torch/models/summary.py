"""Training summaries of the LBFGS-fitted classifiers.

Counterpart of ``sntc_tpu/models/summary.py``: Spark's
``LogisticRegressionTrainingSummary`` family.  A summary carries
``objectiveHistory`` and ``totalIterations`` and, lazily, the training
set's predictions (one ``model.transform`` over the training frame on
first access) with the per-class metrics of one confusion matrix;
binomial models add the threshold curves (``roc``, ``areaUnderROC``,
``pr``, ``...ByThreshold``) of one sweep, cached.  LinearSVC, the
random forest and binary GBT fits carry them too (the trees with an
empty objective history).  A summary given the fit's ``mesh=`` hands it
to the confusion matrix (summed per shard).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sntc_tpu_torch.core.frame import Frame, to_host


class TrainingSummary:
    def __init__(self, objective_history, total_iterations: int):
        self.objectiveHistory = [float(v) for v in objective_history]
        self.totalIterations = int(total_iterations)


class ClassificationSummary:
    """Per-class metrics over a predictions frame (Spark's
    ``ClassificationSummary`` trait).  Lazy: ``model.transform(frame)``
    runs on first access of :attr:`predictions`/any metric."""

    def __init__(self, model, frame, labelCol: str = "label",
                 weightCol: Optional[str] = None, mesh=None):
        self._model = model
        self._frame = frame
        self.labelCol = labelCol
        self.predictionCol = model.getPredictionCol()
        self.probabilityCol = (
            model.getProbabilityCol()
            if model.hasParam("probabilityCol")
            else None
        )
        self.weightCol = weightCol
        self._mesh = mesh
        self._predictions = None
        self._metrics = None

    @property
    def predictions(self):
        if self._predictions is None:
            self._predictions = self._model.transform(self._frame)
        return self._predictions

    def _m(self):
        if self._metrics is None:
            from sntc_tpu_torch.evaluation.multiclass import MulticlassMetrics

            out = self.predictions
            self._metrics = MulticlassMetrics(
                to_host(out[self.labelCol]),
                to_host(out[self.predictionCol]),
                weights=to_host(out[self.weightCol]) if self.weightCol else None,
                mesh=self._mesh,
            )
        return self._metrics

    @property
    def labels(self) -> np.ndarray:
        """Class indices in ascending order (Spark ``labels``)."""
        return np.arange(self._m().num_classes, dtype=np.float64)

    @property
    def accuracy(self) -> float:
        return self._m().accuracy

    @property
    def precisionByLabel(self) -> np.ndarray:
        return self._m().precision_by_label()

    @property
    def recallByLabel(self) -> np.ndarray:
        return self._m().recall_by_label()

    @property
    def truePositiveRateByLabel(self) -> np.ndarray:
        return self._m().recall_by_label()

    @property
    def falsePositiveRateByLabel(self) -> np.ndarray:
        return self._m().false_positive_rate_by_label()

    def fMeasureByLabel(self, beta: float = 1.0) -> np.ndarray:
        return self._m().f_measure_by_label(beta)

    @property
    def weightedPrecision(self) -> float:
        return self._m().weighted_precision()

    @property
    def weightedRecall(self) -> float:
        return self._m().weighted_recall()

    @property
    def weightedTruePositiveRate(self) -> float:
        return self._m().weighted_true_positive_rate()

    @property
    def weightedFalsePositiveRate(self) -> float:
        return self._m().weighted_false_positive_rate()

    def weightedFMeasure(self, beta: float = 1.0) -> float:
        return self._m().weighted_f_measure(beta)


class BinaryClassificationSummary(ClassificationSummary):
    """Adds the threshold curves (Spark
    ``BinaryLogisticRegressionSummary``): they sweep the positive-class
    score with ties grouped, the evaluator's semantics
    (``evaluation/binary.py``)."""

    def _curve_inputs(self):
        out = self.predictions
        raw = to_host(out[self._model.getRawPredictionCol()])
        scores = raw[:, 1] if raw.ndim == 2 else raw
        w = to_host(out[self.weightCol]) if self.weightCol else None
        return to_host(out[self.labelCol]).astype(np.float64), scores, w

    def _sweep(self):
        """(thresholds, tp, fp, total_p, total_n) at distinct-score
        boundaries, cached."""
        if not hasattr(self, "_sweep_cache"):
            from sntc_tpu_torch.evaluation.binary import _curves

            y, s, w = self._curve_inputs()
            order = np.argsort(-np.asarray(s, np.float64), kind="stable")
            s_sorted = np.asarray(s, np.float64)[order]
            boundary = (
                np.flatnonzero(np.diff(s_sorted))
                if len(s_sorted)
                else np.array([], np.int64)
            )
            ends = (
                np.concatenate([boundary, [len(s_sorted) - 1]])
                if len(s_sorted)
                else boundary
            )
            tp, fp, p, n = _curves(y, s, w)
            self._sweep_cache = (s_sorted[ends], tp, fp, p, n)
        return self._sweep_cache

    @property
    def roc(self) -> Frame:
        """Frame with ``FPR``/``TPR`` columns, anchored at (0,0), (1,1)."""
        _, tp, fp, p, n = self._sweep()
        tpr = np.concatenate([[0.0], tp / max(p, 1e-300), [1.0]])
        fpr = np.concatenate([[0.0], fp / max(n, 1e-300), [1.0]])
        return Frame({"FPR": fpr, "TPR": tpr})

    @property
    def areaUnderROC(self) -> float:
        from sntc_tpu_torch.evaluation.binary import area_under_roc

        return area_under_roc(*self._curve_inputs())

    @property
    def pr(self) -> Frame:
        """Frame with ``recall``/``precision`` columns (Spark ``pr``)."""
        _, tp, fp, p, _ = self._sweep()
        recall = tp / max(p, 1e-300)
        precision = tp / np.maximum(tp + fp, 1e-300)
        return Frame({
            "recall": np.concatenate([[0.0], recall]),
            "precision": np.concatenate(
                [[precision[0] if len(precision) else 1.0], precision]),
        })

    def _by_threshold(self, values) -> Frame:
        thr, *_ = self._sweep()
        return Frame({"threshold": thr, "metric": values})

    @property
    def precisionByThreshold(self) -> Frame:
        _, tp, fp, _, _ = self._sweep()
        return self._by_threshold(tp / np.maximum(tp + fp, 1e-300))

    @property
    def recallByThreshold(self) -> Frame:
        _, tp, _, p, _ = self._sweep()
        return self._by_threshold(tp / max(p, 1e-300))

    def fMeasureByThreshold(self, beta: float = 1.0) -> Frame:
        _, tp, fp, p, _ = self._sweep()
        prec = tp / np.maximum(tp + fp, 1e-300)
        rec = tp / max(p, 1e-300)
        b2 = beta * beta
        denom = np.maximum(b2 * prec + rec, 1e-300)
        return self._by_threshold((1 + b2) * prec * rec / denom)


class ClassificationTrainingSummary(ClassificationSummary, TrainingSummary):
    def __init__(self, objective_history, total_iterations, model, frame,
                 labelCol="label", weightCol=None, mesh=None):
        TrainingSummary.__init__(self, objective_history, total_iterations)
        ClassificationSummary.__init__(
            self, model, frame, labelCol=labelCol, weightCol=weightCol,
            mesh=mesh,
        )


class BinaryClassificationTrainingSummary(
    BinaryClassificationSummary, ClassificationTrainingSummary
):
    pass
