"""IsotonicRegression — weighted PAVA.

Counterpart of ``sntc_tpu/models/isotonic.py`` (Spark's
``IsotonicRegression``): pool-adjacent-violators on ``(feature, label,
weight)`` rows sorted by feature, ``isotonic=True`` (increasing,
default) or False (antitonic); exact feature ties are pooled first to
their weighted mean; the model keeps the pooled ``boundaries`` /
``predictions`` and predicts by linear interpolation between them,
clamped outside.  ``featureIndex`` picks the column of a vector
feature.

Host work, as in the JAX package: PAVA is a sequential pooling scan
(:func:`_pava`, a copy of the JAX package's), and a tensor column is
read back first.  The estimator takes ``device=`` and ``mesh=`` as the
port's other estimators do (a ``device`` that is not the mesh's first
local device is refused); nothing of the fit runs there.
"""

from __future__ import annotations

import numpy as np

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.parallel.collectives import fit_device


def _pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted pool-adjacent-violators; returns the isotonic fit.

    Python-list block stacks (not numpy scalar indexing, ~10x cheaper
    per element)."""
    ys = y.tolist()
    ws_ = w.tolist()
    vals: list = []
    wts: list = []
    cnts: list = []
    for yi, wi in zip(ys, ws_):
        vals.append(yi)
        wts.append(wi)
        cnts.append(1)
        while len(vals) > 1 and vals[-2] > vals[-1]:
            v1, v0 = vals.pop(), vals[-1]
            w1, w0 = wts.pop(), wts[-1]
            tw = w0 + w1
            vals[-1] = (v0 * w0 + v1 * w1) / tw
            wts[-1] = tw
            c1 = cnts.pop()
            cnts[-1] += c1
    return np.repeat(np.asarray(vals), np.asarray(cnts, np.int64))


class _IsoParams:
    featuresCol = Param("feature column (scalar or vector)",
                        default="features")
    labelCol = Param("target column", default="label")
    predictionCol = Param("output prediction column", default="prediction")
    weightCol = Param("optional row weight column", default=None)
    isotonic = Param("True = increasing, False = decreasing", default=True,
                     validator=validators.is_bool())
    featureIndex = Param("vector column index to regress on", default=0,
                         validator=validators.gteq(0))

    def _feature_values(self, frame: Frame) -> np.ndarray:
        X = to_host(frame[self.getFeaturesCol()])
        if X.ndim == 2:
            return np.asarray(X[:, int(self.getFeatureIndex())], np.float64)
        return np.asarray(X, np.float64)


class IsotonicRegression(_IsoParams, Estimator):
    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh  # the JAX estimator's API: the fit is host work
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "IsotonicRegressionModel":
        x = self._feature_values(frame)
        y = to_host(frame[self.getLabelCol()]).astype(np.float64)
        wcol = self.getWeightCol()
        w = (to_host(frame[wcol]).astype(np.float64) if wcol
             else np.ones_like(y))
        if (w < 0).any():
            raise ValueError("weights must be non-negative")
        keep = w > 0
        x, y, w = x[keep], y[keep], w[keep]
        if not len(x):
            raise ValueError(
                "isotonic fit needs at least one positively-weighted row"
            )
        order = np.argsort(x, kind="stable")
        x, y, w = x[order], y[order], w[order]
        # pre-pool exact feature ties to their weighted mean (Spark)
        ux, first = np.unique(x, return_index=True)
        if len(ux) < len(x):
            wsum = np.add.reduceat(w, first)
            ysum = np.add.reduceat(y * w, first)
            x, y, w = ux, ysum / wsum, wsum
        sign = 1.0 if self.getIsotonic() else -1.0
        fit = sign * _pava(sign * y, w)
        # keep only block boundaries: first/last point of each constant run
        if len(fit):
            change = np.flatnonzero(np.diff(fit) != 0)
            idx = np.unique(np.concatenate(
                [[0], change, change + 1, [len(fit) - 1]]
            ))
        else:
            idx = np.array([], np.int64)
        model = IsotonicRegressionModel(
            boundaries=x[idx], predictions=fit[idx]
        )
        model.setParams(**{
            k: v for k, v in self.paramValues().items()
            if model.hasParam(k)
        })
        return model


class IsotonicRegressionModel(_IsoParams, Model):
    def __init__(self, boundaries=None, predictions=None, **kwargs):
        super().__init__(**kwargs)
        self.boundaries = np.asarray(
            boundaries if boundaries is not None else [], np.float64
        )
        self.predictions = np.asarray(
            predictions if predictions is not None else [], np.float64
        )

    def _save_extra(self):
        return {}, {
            "boundaries": self.boundaries, "predictions": self.predictions,
        }

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(boundaries=arrays["boundaries"],
                predictions=arrays["predictions"])
        m.setParams(**params)
        return m

    def predict(self, x) -> np.ndarray:
        """Linear interpolation between boundaries, clamped outside
        (Spark ``IsotonicRegressionModel.predict``)."""
        return np.interp(
            to_host(x).astype(np.float64), self.boundaries, self.predictions
        )

    def transform(self, frame: Frame) -> Frame:
        return frame.with_column(
            self.getPredictionCol(),
            self.predict(self._feature_values(frame)),
        )
