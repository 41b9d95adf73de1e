"""BinaryClassificationEvaluator — areaUnderROC / areaUnderPR.

Counterpart of ``sntc_tpu/evaluation/binary.py`` (Spark's
``BinaryClassificationMetrics``): score each row by
``rawPrediction[:, 1]``, sweep thresholds over distinct scores (ties
grouped), trapezoidal areas.  The ROC curve is anchored at (0,0) and
(1,1); the PR curve prepends ``(0, precision_of_first_point)``.  Host
numpy in float64, as in the JAX package, so the two agree exactly.
"""

from __future__ import annotations

import numpy as np

from sntc_tpu_torch.core.base import Evaluator
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators

# numpy 2 renamed trapz to trapezoid; the same trapezoidal rule either way
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _curves(labels: np.ndarray, scores: np.ndarray, weights: np.ndarray = None):
    y = np.asarray(labels, np.float64)
    s = np.asarray(scores, np.float64)
    w = np.ones_like(y) if weights is None else np.asarray(weights, np.float64)
    order = np.argsort(-s, kind="stable")
    y, s, w = y[order], s[order], w[order]
    # group ties: cumulative counts at the end of each distinct-score run
    boundary = np.flatnonzero(np.diff(s)) if len(s) else np.array([], np.int64)
    ends = np.concatenate([boundary, [len(s) - 1]]) if len(s) else boundary
    cum_tp = np.cumsum(w * y)[ends]
    cum_fp = np.cumsum(w * (1.0 - y))[ends]
    total_p = cum_tp[-1] if len(cum_tp) else 0.0
    total_n = cum_fp[-1] if len(cum_fp) else 0.0
    return cum_tp, cum_fp, total_p, total_n


def area_under_roc(labels, scores, weights=None) -> float:
    tp, fp, p, n = _curves(labels, scores, weights)
    if p == 0 or n == 0:
        return 0.0
    tpr = np.concatenate([[0.0], tp / p, [1.0]])
    fpr = np.concatenate([[0.0], fp / n, [1.0]])
    return float(_trapezoid(tpr, fpr))


def area_under_pr(labels, scores, weights=None) -> float:
    tp, fp, p, _ = _curves(labels, scores, weights)
    if p == 0:
        return 0.0
    recall = tp / p
    precision = tp / np.maximum(tp + fp, 1e-300)
    # Spark prepends (0, precision of the first point)
    recall = np.concatenate([[0.0], recall])
    precision = np.concatenate([[precision[0]], precision])
    return float(_trapezoid(precision, recall))


class BinaryClassificationEvaluator(Evaluator):
    _METRICS = ("areaUnderROC", "areaUnderPR")

    metricName = Param("metric to compute", default="areaUnderROC",
                       validator=validators.one_of(*_METRICS))
    labelCol = Param("true-label column", default="label")
    rawPredictionCol = Param("margins / score column",
                             default="rawPrediction")
    weightCol = Param("optional row-weight column", default=None)

    def evaluate(self, frame: Frame) -> float:
        raw = to_host(frame[self.getRawPredictionCol()])
        scores = raw[:, 1] if raw.ndim == 2 else raw
        labels = to_host(frame[self.getLabelCol()])
        weight_col = self.getWeightCol()
        w = to_host(frame[weight_col]) if weight_col else None
        fn = (
            area_under_roc
            if self.getMetricName() == "areaUnderROC"
            else area_under_pr
        )
        return fn(labels, scores, w)
