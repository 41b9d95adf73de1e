"""Multiclass metrics with Spark's ``MulticlassMetrics`` semantics.

Counterpart of ``sntc_tpu/evaluation/multiclass.py``:

* ``metricName="f1"`` is Spark's **weighted** F-measure;
* ``macroF1`` is the unweighted mean of per-class F1 over the classes
  present in the true labels;
* every ratio uses the 0/0 -> 0 convention, and weights are by
  true-label frequency.

The confusion matrix is a weighted ``bincount`` on the host (the
predictions are already there).  Of the JAX evaluator's metric names
this one computes ``f1``, ``accuracy``, ``weightedPrecision``,
``weightedRecall`` and ``macroF1``.
"""

from __future__ import annotations

import numpy as np

from sntc_tpu_torch.core.base import Evaluator
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators


class MulticlassMetrics:
    """Confusion-matrix metrics for (prediction, label) pairs;
    ``confusion[i, j]`` counts rows with true label ``i`` predicted
    ``j``."""

    def __init__(self, labels, predictions, weights=None):
        y = np.asarray(labels).astype(np.int64)
        p = np.asarray(predictions).astype(np.int64)
        k = int(max(y.max(initial=0), p.max(initial=0))) + 1
        w = (
            np.ones(len(y), np.float32)
            if weights is None
            else np.asarray(weights, np.float32)
        )
        self.confusion = np.bincount(
            y * k + p, weights=w, minlength=k * k
        ).astype(np.float64).reshape(k, k)
        self.num_classes = k

    @property
    def true_positives(self) -> np.ndarray:
        return np.diag(self.confusion)

    @property
    def label_counts(self) -> np.ndarray:
        return self.confusion.sum(axis=1)

    @property
    def prediction_counts(self) -> np.ndarray:
        return self.confusion.sum(axis=0)

    @staticmethod
    def _safe_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return np.divide(a, b, out=np.zeros_like(a, dtype=np.float64), where=b != 0)

    def precision_by_label(self) -> np.ndarray:
        return self._safe_div(self.true_positives, self.prediction_counts)

    def recall_by_label(self) -> np.ndarray:
        return self._safe_div(self.true_positives, self.label_counts)

    def false_positive_rate_by_label(self) -> np.ndarray:
        """FP / negatives per class (Spark ``falsePositiveRateByLabel``)."""
        fp = self.prediction_counts - self.true_positives
        negatives = self.confusion.sum() - self.label_counts
        return self._safe_div(fp, negatives)

    def f_measure_by_label(self, beta: float = 1.0) -> np.ndarray:
        p, r = self.precision_by_label(), self.recall_by_label()
        b2 = beta * beta
        return self._safe_div((1 + b2) * p * r, b2 * p + r)

    @property
    def accuracy(self) -> float:
        total = self.confusion.sum()
        return float(self.true_positives.sum() / total) if total else 0.0

    def _weights(self) -> np.ndarray:
        counts = self.label_counts
        total = counts.sum()
        return counts / total if total else counts

    def weighted_precision(self) -> float:
        return float((self._weights() * self.precision_by_label()).sum())

    def weighted_recall(self) -> float:
        return float((self._weights() * self.recall_by_label()).sum())

    def weighted_f_measure(self, beta: float = 1.0) -> float:
        return float((self._weights() * self.f_measure_by_label(beta)).sum())

    def weighted_true_positive_rate(self) -> float:
        return self.weighted_recall()

    def weighted_false_positive_rate(self) -> float:
        return float(
            (self._weights() * self.false_positive_rate_by_label()).sum()
        )

    def macro_f1(self) -> float:
        present = self.label_counts > 0
        f1 = self.f_measure_by_label()
        return float(f1[present].mean()) if present.any() else 0.0


class MulticlassClassificationEvaluator(Evaluator):
    """Spark-parity evaluator over :class:`MulticlassMetrics`."""

    _METRICS = ("f1", "accuracy", "weightedPrecision", "weightedRecall",
                "macroF1")

    metricName = Param("metric to compute", default="f1",
                       validator=validators.one_of(*_METRICS))
    labelCol = Param("true-label column", default="label")
    predictionCol = Param("prediction column", default="prediction")
    weightCol = Param("optional row-weight column", default=None)

    def metrics(self, frame: Frame) -> MulticlassMetrics:
        weight_col = self.getWeightCol()
        return MulticlassMetrics(
            to_host(frame[self.getLabelCol()]),
            to_host(frame[self.getPredictionCol()]),
            weights=to_host(frame[weight_col]) if weight_col else None,
        )

    def evaluate(self, frame: Frame) -> float:
        m = self.metrics(frame)
        name = self.getMetricName()
        if name == "f1":
            return m.weighted_f_measure()
        if name == "accuracy":
            return m.accuracy
        if name == "weightedPrecision":
            return m.weighted_precision()
        if name == "weightedRecall":
            return m.weighted_recall()
        return m.macro_f1()
