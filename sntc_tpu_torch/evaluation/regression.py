"""RegressionEvaluator — rmse / mse / r2 / mae / var.

Counterpart of ``sntc_tpu/evaluation/regression.py`` (Spark's
``RegressionMetrics``): weighted residual moments over (prediction,
label) pairs; ``r2`` uses the weighted total sum of squares about the
weighted label mean (about 0 with ``throughOrigin``); ``var`` is Spark's
``explainedVariance``, the predictions' weighted mean squared deviation
about the weighted label mean.  ``isLargerBetter`` is True only for
``r2`` and ``var``.  Host numpy in float64, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from sntc_tpu_torch.core.base import Evaluator
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators


class RegressionEvaluator(Evaluator):
    _METRICS = ("rmse", "mse", "r2", "mae", "var")

    metricName = Param("metric to compute", default="rmse",
                       validator=validators.one_of(*_METRICS))
    labelCol = Param("true-label column", default="label")
    predictionCol = Param("prediction column", default="prediction")
    weightCol = Param("optional row-weight column", default=None)
    throughOrigin = Param("r2 about 0 instead of the label mean",
                          default=False, validator=validators.is_bool())

    def evaluate(self, frame: Frame) -> float:
        metric = self.getMetricName()
        y = np.asarray(to_host(frame[self.getLabelCol()]), np.float64)
        pred = np.asarray(to_host(frame[self.getPredictionCol()]), np.float64)
        weight_col = self.getWeightCol()
        w = (np.asarray(to_host(frame[weight_col]), np.float64)
             if weight_col else np.ones_like(y))
        wsum = w.sum()
        if wsum == 0:
            return 0.0
        resid = y - pred
        mse = float((w * resid**2).sum() / wsum)
        if metric == "mse":
            return mse
        if metric == "rmse":
            return float(np.sqrt(mse))
        if metric == "mae":
            return float((w * np.abs(resid)).sum() / wsum)
        if metric == "var":
            ybar = (w * y).sum() / wsum
            return float((w * (pred - ybar) ** 2).sum() / wsum)
        ybar = 0.0 if self.getThroughOrigin() else (w * y).sum() / wsum
        ss_tot = float((w * (y - ybar) ** 2).sum())
        ss_res = float((w * resid**2).sum())
        if ss_tot == 0:
            return 0.0
        return 1.0 - ss_res / ss_tot

    def isLargerBetter(self) -> bool:
        return self.getMetricName() in ("r2", "var")
