"""LinearRegression — least squares with elastic-net.

Counterpart of ``sntc_tpu/models/linear_regression.py`` (Spark's
``LinearRegression``): minimize ``1/(2n) Σ wᵢ(yᵢ − ŷᵢ)² + λ(α‖coef‖₁ +
(1−α)/2‖coef‖²)``; ``solver`` auto | normal | l-bfgs, where "normal"
solves the regularized normal equations (α = 0 only, as in Spark) and
"auto" picks it whenever it is legal; internal standardization with the
penalty in the space the ``standardization`` flag asks for; the
intercept is never penalized.

The fit runs on the estimator's device (default ``cuda``), in full
float32:

* the normal solver takes every moment it needs in one pass about pilot
  points (the first row and target; :func:`normal_moments`): the
  weighted count, ``Σ(x−p)``, the Gram ``Σ(x−p)(x−p)ᵀ`` (one product),
  ``Σ(y−q)`` and ``Σ(x−p)(y−q)``, summed once over every row (the JAX
  package sums per shard, then across them) and read back once; the
  centered moments and the ``[D, D]`` solve are float64 on the host,
  with the minimum-norm least-squares solution on a singular Gram;
* the elastic-net path takes ``standardization_moments`` and runs the
  port's LBFGS (OWLQN with an L1 term) over rows centered once before
  any product, scaled inside it, the shift folded back into the
  intercept.

The model predicts ``X·coef + intercept`` in float64: numpy on the host
for a numpy column, as in the JAX package, on the model's device for a
tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.feature.standard_scaler import standardization_moments
from sntc_tpu_torch.models.mlp import value_and_grad_fn
from sntc_tpu_torch.models.summary import TrainingSummary
from sntc_tpu_torch.ops.lbfgs import full_f32, minimize_lbfgs


def normal_moments(xs, ys, w, px: np.ndarray, qy: np.float32) -> dict:
    """The normal solver's one pass over ``xs [N, D]``, ``ys``, ``w`` on
    their device, about the pilot row ``px`` and target ``qy``: float64
    host values of ``count``, ``sum`` Σw(x−p), ``xxt`` Σw(x−p)(x−p)ᵀ,
    ``sy`` Σw(y−q) and ``xy`` Σw(x−p)(y−q), read back in one copy."""
    d = xs.shape[1]
    with full_f32():
        xc = xs - torch.from_numpy(np.asarray(px, np.float32)).to(
            xs.device)[None, :]
        yc = (ys - torch.tensor(np.float32(qy), device=ys.device)) * w
        wx = xc * w[:, None]
        flat = torch.cat([
            w.sum().reshape(1), wx.sum(dim=0), (xc.t() @ wx).reshape(-1),
            yc.sum().reshape(1), (xc * yc[:, None]).sum(dim=0),
        ]).cpu().numpy().astype(np.float64)
    return {"count": flat[0], "sum": flat[1:1 + d],
            "xxt": flat[1 + d:1 + d + d * d].reshape(d, d),
            "sy": flat[1 + d + d * d], "xy": flat[2 + d + d * d:]}


def linreg_optimize(xs, ys, ws, inv_std, mu, y_mean, reg_l2, pen_l2, l1,
                    theta0, *, fit_intercept: bool, max_iter: int,
                    tol: float):
    """The elastic-net least-squares fit on ``xs``'s device (the JAX
    package's ``_linreg_optimize``): the rows centered by ``mu`` once,
    scaled by ``inv_std`` inside the objective; ``l1=None`` is plain
    LBFGS.  Call under :func:`full_f32`."""
    d = xs.shape[1]
    dev = xs.device
    xc = xs - mu[None, :]
    yc = ys - torch.tensor(np.float32(y_mean), device=dev)
    w_sum = torch.sum(ws)
    zero = torch.zeros((), dtype=xs.dtype, device=dev)

    def loss_fn(theta):
        coef = theta[:d]
        b = theta[d] if fit_intercept else zero
        resid = xc @ (coef * inv_std) + b - yc
        data = 0.5 * torch.sum(ws * resid * resid) / w_sum
        return data + 0.5 * reg_l2 * torch.sum(pen_l2 * coef * coef)

    return minimize_lbfgs(value_and_grad_fn(loss_fn), theta0,
                          max_iter=max_iter, tol=tol, l1=l1)


class _LinRegParams:
    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("target column", default="label")
    predictionCol = Param("output prediction column", default="prediction")
    maxIter = Param("max iterations (l-bfgs)", default=100, validator=validators.gt(0))
    regParam = Param("regularization λ", default=0.0, validator=validators.gteq(0))
    elasticNetParam = Param(
        "α: 0 = ridge (L2), 1 = lasso (L1)", default=0.0,
        validator=validators.in_range(0, 1),
    )
    tol = Param("convergence tolerance", default=1e-6, validator=validators.gt(0))
    fitIntercept = Param("fit an intercept", default=True,
                         validator=validators.is_bool())
    standardization = Param(
        "standardize internally; penalty follows the flag (Spark)",
        default=True, validator=validators.is_bool())
    solver = Param(
        "auto | normal | l-bfgs", default="auto",
        validator=validators.one_of("auto", "normal", "l-bfgs"))
    weightCol = Param("optional row weight column", default=None)


def regression_inputs(est, frame: Frame):
    """``(X, y, w)`` of a regression fit as float32 host arrays: the
    features must be a vector column."""
    X = to_host(frame[est.getFeaturesCol()])
    if X.ndim != 2:
        raise ValueError(
            f"featuresCol {est.getFeaturesCol()!r} must be a vector "
            "column (use VectorAssembler)"
        )
    X = X.astype(np.float32, copy=False)
    y = to_host(frame[est.getLabelCol()]).astype(np.float32)
    wcol = est.getWeightCol()
    w = (to_host(frame[wcol]).astype(np.float32) if wcol
         else np.ones(len(y), np.float32))
    return X, y, w


def to_device(a: np.ndarray, dev) -> torch.Tensor:
    """A host array copied to ``dev`` as it is (C-contiguous)."""
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev)


class LinearRegression(_LinRegParams, Estimator):
    """Fits on ``device`` (default ``cuda``)."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _fit(self, frame: Frame) -> "LinearRegressionModel":
        X, y, w = regression_inputs(self, frame)
        d = X.shape[1]
        lam = float(self.getRegParam())
        alpha = float(self.getElasticNetParam())
        solver = self.getSolver()
        if solver == "normal" and lam > 0 and alpha > 0:
            raise ValueError(
                "the normal solver supports no L1 term (Spark parity); "
                "use solver='l-bfgs' for elasticNetParam > 0"
            )
        use_normal = solver == "normal" or (
            solver == "auto" and (lam == 0 or alpha == 0)
        )
        dev = self.device
        xs, ys, ws = to_device(X, dev), to_device(y, dev), to_device(w, dev)
        fit_b = self.getFitIntercept()
        if not use_normal:
            _, mean, var = standardization_moments(
                xs, ws, X[0] if X.shape[0] else np.zeros(d))
            std = np.sqrt(np.maximum(var, 0.0))
            inv_std = np.divide(1.0, std, out=np.ones_like(std),
                                where=std > 0)
            y_mean = float(np.average(y, weights=w)) if len(y) else 0.0
            pen = np.ones(d) if self.getStandardization() else inv_std**2
            return self._fit_lbfgs(xs, ys, ws, inv_std, mean, y_mean, lam,
                                   alpha, pen, d, fit_b)
        px = X[0] if X.shape[0] else np.zeros(d, np.float32)
        qy = np.float32(y[0]) if len(y) else np.float32(0.0)
        m = normal_moments(xs, ys, ws, px, qy)
        n = max(float(m["count"]), 1e-300)
        sum_p, gram_p = m["sum"], m["xxt"]  # Σw(x-p), Σw(x-p)(x-p)ᵀ
        sy_p, xy_p = float(m["sy"]), m["xy"]  # Σw(y-q), Σw(x-p)(y-q)
        mean = px.astype(np.float64) + sum_p / n
        y_mean = float(qy) + sy_p / n
        # centered second moments, exactly reconstructed (shift-invariant)
        gram_c = gram_p - np.outer(sum_p, sum_p) / n  # Σw(x-μ)(x-μ)ᵀ
        xy_c = xy_p - sum_p * (sy_p / n)  # Σw(x-μ)(y-ȳ)
        var = np.maximum(np.diag(gram_c) / n, 0.0)
        std = np.sqrt(var)
        # the penalty in ORIGINAL coefficient space: λ·std²
        # (standardization=True penalizes θ = w·std) or λ·I
        pen_orig = std**2 if self.getStandardization() else np.ones(d)
        if fit_b:
            A = gram_c / n
            b_vec = xy_c / n
        else:
            # uncentered moments from the centered ones, exactly
            A = gram_c / n + np.outer(mean, mean)
            b_vec = xy_c / n + y_mean * mean
        A_reg = A + lam * np.diag(pen_orig)
        try:
            coef = np.linalg.solve(A_reg, b_vec)
        except np.linalg.LinAlgError:
            # a singular Gram (duplicated/constant features): the
            # minimum-norm least-squares solution, Spark's auto fallback
            coef = np.linalg.lstsq(A_reg, b_vec, rcond=None)[0]
        intercept = y_mean - float(mean @ coef) if fit_b else 0.0
        model = self._model(coef, intercept)
        model.summary = TrainingSummary([0.0], 0)
        return model

    def _model(self, coef, intercept) -> "LinearRegressionModel":
        model = LinearRegressionModel(coefficients=coef, intercept=intercept,
                                      device=self.device)
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items()
               if model.hasParam(k2)}
        )
        return model

    def _fit_lbfgs(self, xs, ys, ws, inv_std, mean, y_mean, lam, alpha,
                   pen, d, fit_b):
        dev = self.device
        n_theta = d + 1 if fit_b else d
        l1 = np.zeros(n_theta, np.float32)
        l1[:d] = lam * alpha * np.sqrt(pen)
        mu_opt = mean.astype(np.float32) if fit_b else np.zeros(d, np.float32)
        ym = y_mean if fit_b else 0.0

        def t32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        with full_f32():
            res = linreg_optimize(
                xs, ys, ws, t32(inv_std), t32(mu_opt), ym,
                float(np.float32(lam * (1.0 - alpha))), t32(pen),
                t32(l1) if alpha > 0 and lam > 0 else None,
                torch.zeros(n_theta, dtype=torch.float32, device=dev),
                fit_intercept=fit_b, max_iter=int(self.getMaxIter()),
                tol=float(self.getTol()),
            )
        theta = res.x.cpu().numpy().astype(np.float64)
        coef = theta[:d] * inv_std
        intercept = (
            float(theta[d]) + y_mean - float(mu_opt.astype(np.float64) @ coef)
            if fit_b else 0.0
        )
        model = self._model(coef, intercept)
        n_it = int(res.n_iters)
        model.summary = TrainingSummary(
            res.history.cpu().numpy()[: n_it + 1], n_it)
        model.optimizer_stats = {"iterations": n_it,
                                 "evaluations": res.n_evals,
                                 "host_syncs": res.n_syncs}
        return model


class LinearRegressionModel(_LinRegParams, Model):
    def __init__(self, coefficients: np.ndarray, intercept: float,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.coefficients = np.array(coefficients, np.float64)
        self.coefficients.flags.writeable = False
        self.intercept = float(intercept)
        self.summary = None
        self.optimizer_stats = None
        self.device = resolve_device(device)
        self._on = {}

    def _save_extra(self):
        return {"intercept": self.intercept}, {"coefficients": self.coefficients}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(
            coefficients=arrays["coefficients"],
            intercept=float(extra["intercept"]), device=device,
        )
        m.setParams(**params)
        return m

    def predict(self, X):
        """``X·coef + intercept`` in float64: numpy for a host matrix, on
        the tensor's device for a tensor."""
        if isinstance(X, torch.Tensor):
            coef = self._on.get(X.device)
            if coef is None:
                coef = self._on[X.device] = torch.from_numpy(
                    self.coefficients.copy()).to(X.device)
            return X.to(torch.float64) @ coef + self.intercept
        return np.asarray(X, np.float64) @ self.coefficients + self.intercept

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getFeaturesCol()]
        return frame.with_column(self.getPredictionCol(), self.predict(X))
