"""Multiclass metrics with Spark's ``MulticlassMetrics`` semantics.

Counterpart of ``sntc_tpu/evaluation/multiclass.py``:

* ``metricName="f1"`` is Spark's **weighted** F-measure;
* ``macroF1`` is the unweighted mean of per-class F1 over the classes
  present in the true labels;
* every ratio uses the 0/0 -> 0 convention, and weights are by
  true-label frequency.

The confusion matrix is a weighted ``bincount`` on the host (the
predictions are already there); with a ``mesh=`` of more than one shard
it is summed per shard instead, each shard's ``[K·K]`` counts one
``bincount`` on its device, reduced in shard order
(``make_tree_aggregate``; whole counts with unit weights, so equal at
every mesh size).  The evaluator takes every metric name
of the JAX one: the weighted metrics, the ``...ByLabel`` metrics of
class ``metricLabel`` (the matrix is sized to cover it, so an absent
class reads 0), the F-measures at ``beta``, ``logLoss`` over
``probabilityCol`` clamped by ``eps``, ``hammingLoss`` and ``macroF1``.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Evaluator
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.parallel.collectives import (
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
    shard_weights,
)


def _confusion_agg(mesh, k: int):
    """The confusion matrix's aggregate over ``mesh``: each shard's
    weighted ``[K·K]`` counts of ``y·K + p``."""

    def conf(ys, ps, ws):
        return torch.bincount(ys * k + ps, weights=ws, minlength=k * k)

    return make_tree_aggregate(conf, mesh, op="multiclass.confusion")


class MulticlassMetrics:
    """Confusion-matrix metrics for (prediction, label) pairs;
    ``confusion[i, j]`` counts rows with true label ``i`` predicted
    ``j``.  ``mesh`` (of more than one shard) sums it per shard."""

    def __init__(self, labels, predictions, weights=None, num_classes=None,
                 mesh=None):
        y = np.asarray(labels).astype(np.int64)
        p = np.asarray(predictions).astype(np.int64)
        k = (int(max(y.max(initial=0), p.max(initial=0))) + 1
             if num_classes is None else int(num_classes))
        w = (
            np.ones(len(y), np.float32)
            if weights is None
            else np.asarray(weights, np.float32)
        )
        mesh = fit_mesh(mesh)
        if mesh is None:
            flat = np.bincount(y * k + p, weights=w, minlength=k * k)
        else:
            ys, ps, _ = shard_batch(mesh, y, p)
            ws = shard_weights(mesh, w, ys.shape[0])
            flat = _confusion_agg(mesh, k)(ys, ps, ws).cpu().numpy()
        self.confusion = flat.astype(np.float64).reshape(k, k)
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

    def hamming_loss(self) -> float:
        """Misclassified share (single-label: 1 − accuracy)."""
        total = self.confusion.sum()
        if not total:
            return 0.0
        return float((total - self.true_positives.sum()) / total)

    def macro_f1(self) -> float:
        present = self.label_counts > 0
        f1 = self.f_measure_by_label()
        return float(f1[present].mean()) if present.any() else 0.0


#: the metric names of the JAX package's evaluator
METRIC_NAMES = (
    "f1",
    "accuracy",
    "weightedPrecision",
    "weightedRecall",
    "weightedTruePositiveRate",
    "weightedFalsePositiveRate",
    "weightedFMeasure",
    "truePositiveRateByLabel",
    "falsePositiveRateByLabel",
    "precisionByLabel",
    "recallByLabel",
    "fMeasureByLabel",
    "logLoss",
    "hammingLoss",
    "macroF1",
)


class MulticlassClassificationEvaluator(Evaluator):
    """Spark-parity evaluator over :class:`MulticlassMetrics`; with
    ``mesh`` the confusion matrix is summed per shard."""

    _METRICS = METRIC_NAMES
    _SMALLER_IS_BETTER = ("logLoss", "hammingLoss", "weightedFalsePositiveRate",
                          "falsePositiveRateByLabel")

    metricName = Param("metric to compute", default="f1",
                       validator=validators.one_of(*_METRICS))
    labelCol = Param("true-label column", default="label")
    predictionCol = Param("prediction column", default="prediction")
    probabilityCol = Param("class-probability column (logLoss)",
                           default="probability")
    metricLabel = Param("class index for the ...ByLabel metrics",
                        default=0.0, validator=validators.gteq(0))
    beta = Param("F-measure beta", default=1.0, validator=validators.gt(0))
    eps = Param("logLoss probability clamp", default=1e-15,
                validator=validators.in_range(0, 0.5))
    weightCol = Param("optional row-weight column", default=None)

    def __init__(self, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh

    def metrics(self, frame: Frame) -> MulticlassMetrics:
        labels = to_host(frame[self.getLabelCol()])
        preds = to_host(frame[self.getPredictionCol()])
        num_classes = None
        if self.getMetricName().endswith("ByLabel"):
            # cover metricLabel, so that a class absent from this frame
            # reads 0 (the 0/0 -> 0 convention), not an IndexError
            observed = int(max(np.max(labels, initial=-1.0),
                               np.max(preds, initial=-1.0))) + 1
            num_classes = max(observed, int(self.getMetricLabel()) + 1)
        weight_col = self.getWeightCol()
        return MulticlassMetrics(
            labels, preds,
            weights=to_host(frame[weight_col]) if weight_col else None,
            num_classes=num_classes, mesh=self.mesh,
        )

    def _log_loss(self, frame: Frame) -> float:
        prob = np.asarray(to_host(frame[self.getProbabilityCol()]), np.float64)
        y = np.asarray(to_host(frame[self.getLabelCol()])).astype(np.int64)
        p_true = prob[np.arange(len(y)), y]
        eps = self.getEps()
        # clamped to [eps, 1 - eps] on both sides (Spark)
        losses = -np.log(np.clip(p_true, eps, 1.0 - eps))
        weight_col = self.getWeightCol()
        if weight_col:
            w = np.asarray(to_host(frame[weight_col]), np.float64)
            return float(np.sum(w * losses) / np.sum(w))
        return float(np.mean(losses))

    def evaluate(self, frame: Frame) -> float:
        name = self.getMetricName()
        if name == "logLoss":
            return self._log_loss(frame)
        m = self.metrics(frame)
        lbl = int(self.getMetricLabel())
        beta = self.getBeta()
        if name == "f1":
            return m.weighted_f_measure()
        if name == "accuracy":
            return m.accuracy
        if name == "weightedPrecision":
            return m.weighted_precision()
        if name in ("weightedRecall", "weightedTruePositiveRate"):
            return m.weighted_recall()
        if name == "weightedFalsePositiveRate":
            return m.weighted_false_positive_rate()
        if name == "weightedFMeasure":
            return m.weighted_f_measure(beta)
        if name in ("truePositiveRateByLabel", "recallByLabel"):
            return float(m.recall_by_label()[lbl])
        if name == "falsePositiveRateByLabel":
            return float(m.false_positive_rate_by_label()[lbl])
        if name == "precisionByLabel":
            return float(m.precision_by_label()[lbl])
        if name == "fMeasureByLabel":
            return float(m.f_measure_by_label(beta)[lbl])
        if name == "hammingLoss":
            return m.hamming_loss()
        return m.macro_f1()

    def isLargerBetter(self) -> bool:
        return self.getMetricName() not in self._SMALLER_IS_BETTER
