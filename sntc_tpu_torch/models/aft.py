"""AFTSurvivalRegression — Weibull accelerated-failure-time survival model.

Counterpart of ``sntc_tpu/models/aft.py`` (Spark's
``AFTSurvivalRegression``): ``log T = x·β + b + σ·ε`` with ε standard
(minimum) extreme-value, a censor column (1.0 = event observed, 0.0 =
right-censored), no regularization, internal std-only feature scaling,
``predict = exp(x·β + b)`` and the Weibull quantiles ``predict ·
(−log(1−p))^σ`` in ``quantilesCol``.  Survival times must be > 0.

Negative log-likelihood per weighted row (δ the censor indicator):
``−[δ·(ε − log σ) − e^ε]`` with ``ε = (log t − x·β − b)/σ``; ``log σ``
is an extra coordinate, so the optimizer stays unconstrained.

The fit runs on the estimator's device (default ``cuda``): the feature
moments (``standardization_moments``, the variance only), then the
port's LBFGS over θ = [β (scaled space), intercept, log σ] in full
float32.  ``log t`` is taken in float64 on the host and cast to
float32, as in the JAX package.  With a ``mesh=`` of more than one
shard the rows, ``log t``, the censor flags and the weights are laid
out by ``shard_batch`` (weight 0 on the padding): the moments are one
aggregate and each LBFGS evaluation sums the shards' ``(Σ w·nll,
gradient, Σw)`` in shard order (``mlp.sharded_value_and_grad``).  The model predicts in float64 numpy on
the host, as the JAX model does (a tensor column is read back first).
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.feature.standard_scaler import standardization_moments
from sntc_tpu_torch.models.mlp import (
    local_blocks,
    sharded_value_and_grad,
    value_and_grad_fn,
)
from sntc_tpu_torch.models.summary import TrainingSummary
from sntc_tpu_torch.ops.lbfgs import full_f32, minimize_lbfgs
from sntc_tpu_torch.parallel.collectives import (
    ShardedArray,
    fit_columns,
    fit_device,
    fit_mesh,
)

_DEFAULT_QPS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99)


def aft_optimize(xs, logt, delta, ws, inv_std, theta0, *,
                 fit_intercept: bool, max_iter: int, tol: float):
    """The AFT fit on ``xs``'s device, or over ``shard_batch``'s rows:
    θ = [β (scaled space), intercept, log σ]; the intercept slot is inert
    when ``fit_intercept`` is off.  Call under :func:`full_f32`."""
    d = xs.shape[1]

    def weighted_ll(theta, x, lt, dl, w):
        coef = theta[:d] * inv_std.to(x.device)
        b = theta[d] if fit_intercept else torch.zeros(
            (), dtype=x.dtype, device=x.device)
        log_sigma = theta[d + 1]
        eps = (lt - x @ coef - b) * torch.exp(-log_sigma)
        return torch.sum(w * (dl * (eps - log_sigma) - torch.exp(eps)))

    if isinstance(xs, ShardedArray):
        value_and_grad = sharded_value_and_grad(
            xs.mesh, lambda t, *blk: -weighted_ll(t, *blk),
            local_blocks(xs, logt, delta, ws))
    else:
        w_sum = torch.sum(ws)

        def nll(theta):
            return -weighted_ll(theta, xs, logt, delta, ws) / w_sum

        value_and_grad = value_and_grad_fn(nll)
    return minimize_lbfgs(value_and_grad, theta0, max_iter=max_iter,
                          tol=tol)


class _AftParams:
    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("survival time column (> 0)", default="label")
    censorCol = Param(
        "censor column: 1.0 = event observed, 0.0 = right-censored",
        default="censor",
    )
    predictionCol = Param("output prediction column", default="prediction")
    quantilesCol = Param(
        "optional output column of Weibull quantiles", default=None
    )
    quantileProbabilities = Param(
        "probabilities for quantilesCol",
        default=_DEFAULT_QPS,
        validator=lambda v: len(v) > 0 and all(0.0 < p < 1.0 for p in v),
    )
    maxIter = Param("max LBFGS iterations", default=100,
                    validator=validators.gt(0))
    tol = Param("convergence tolerance", default=1e-6,
                validator=validators.gt(0))
    fitIntercept = Param("fit an intercept", default=True,
                         validator=validators.is_bool())
    weightCol = Param("optional row weight column", default=None)


class AFTSurvivalRegression(_AftParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "AFTSurvivalRegressionModel":
        X = to_host(frame[self.getFeaturesCol()])
        if X.ndim != 2:
            raise ValueError(
                f"featuresCol {self.getFeaturesCol()!r} must be a vector "
                "column (use VectorAssembler)"
            )
        X = X.astype(np.float32, copy=False)
        t = to_host(frame[self.getLabelCol()]).astype(np.float64)
        if np.any(t <= 0):
            raise ValueError(
                "survival times must be > 0 (Spark requires log t)"
            )
        delta = to_host(frame[self.getCensorCol()]).astype(np.float32)
        if not np.isin(delta, (0.0, 1.0)).all():
            raise ValueError("censorCol values must be 0.0 or 1.0")
        wcol = self.getWeightCol()
        w = (to_host(frame[wcol]).astype(np.float32) if wcol
             else np.ones(len(t), np.float32))
        d = X.shape[1]
        dev = self.device
        mesh = fit_mesh(self.mesh)
        xs, lt, dl, ws = fit_columns(
            (X, np.log(t).astype(np.float32), delta), w, dev, mesh)
        # std-only internal scaling (Spark AFT standardizes without
        # centering); the scaler's one-pass moments
        _, _, var = standardization_moments(
            xs, ws, X[0] if len(t) else np.zeros(d), mesh)
        std = np.sqrt(np.maximum(var, 0.0))
        inv_std = np.divide(1.0, std, out=np.ones_like(std), where=std > 0)
        with full_f32():
            res = aft_optimize(
                xs, lt, dl, ws,
                torch.from_numpy(inv_std.astype(np.float32)).to(dev),
                torch.zeros(d + 2, dtype=torch.float32, device=dev),
                fit_intercept=bool(self.getFitIntercept()),
                max_iter=int(self.getMaxIter()), tol=float(self.getTol()),
            )
        theta = res.x.cpu().numpy().astype(np.float64)
        model = AFTSurvivalRegressionModel(
            coefficients=theta[:d] * inv_std,
            intercept=float(theta[d]),
            scale=float(np.exp(theta[d + 1])),
        )
        model.setParams(**self.paramValues())
        n_it = int(res.n_iters)
        model.summary = TrainingSummary(
            res.history.cpu().numpy()[: n_it + 1], n_it)
        model.optimizer_stats = {"iterations": n_it,
                                 "evaluations": res.n_evals,
                                 "host_syncs": res.n_syncs}
        return model


class AFTSurvivalRegressionModel(_AftParams, Model):
    def __init__(self, coefficients, intercept: float, scale: float, **kwargs):
        super().__init__(**kwargs)
        self.coefficients = np.asarray(coefficients, np.float64)
        self.intercept = float(intercept)
        self.scale = float(scale)  # σ, Spark's `scale`
        self.summary = None
        self.optimizer_stats = None

    def _save_extra(self):
        return (
            {"intercept": self.intercept, "scale": self.scale},
            {"coefficients": self.coefficients},
        )

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(
            coefficients=arrays["coefficients"],
            intercept=float(extra["intercept"]),
            scale=float(extra["scale"]),
        )
        m.setParams(**params)
        return m

    def predict(self, X) -> np.ndarray:
        return np.exp(
            to_host(X).astype(np.float64) @ self.coefficients + self.intercept
        )

    def predictQuantiles(self, X) -> np.ndarray:
        """``[N, len(qps)]`` Weibull quantiles ``predict · (−log(1−p))^σ``."""
        qps = np.asarray(self.getQuantileProbabilities(), np.float64)
        lam = self.predict(X)[:, None]
        return lam * np.power(-np.log1p(-qps)[None, :], self.scale)

    def transform(self, frame: Frame) -> Frame:
        X = to_host(frame[self.getFeaturesCol()])
        out = frame.with_column(self.getPredictionCol(), self.predict(X))
        if self.getQuantilesCol():
            out = out.with_column(
                self.getQuantilesCol(), self.predictQuantiles(X)
            )
        return out
