"""LinearSVC — a linear SVM with the hinge loss, fit and serve.

Counterpart of ``sntc_tpu/models/linear_svc.py`` (Spark's
``LinearSVC``): binary only; minimize ``Σ wᵢ·max(0, 1 − (2yᵢ−1)·margin)
/ Σw + regParam·½‖coef‖²`` by LBFGS with the hinge's subgradient;
features standardized inside the fit with the penalty in the space the
``standardization`` flag asks for; ``rawPrediction = [−m, m]`` and
``prediction = m > threshold`` on the RAW margin.  There is no
probability column.

The fit runs on the estimator's device: one pass for the feature moments
(pilot-shifted, as the scaler takes them), then the LBFGS loop of
:mod:`sntc_tpu_torch.ops.lbfgs` in full float32 on CENTERED, scaled
features — a reparametrization of the same objective when an intercept
absorbs the shift, folded back into the intercept afterwards.  The
centering is applied to the rows once, before any product: ``x·w −
μ·w`` as two large f32 dot products cancels.  The hinge is
``torch.maximum(0, ·)``, whose gradient at a margin of exactly 1 is ½,
as ``jnp.maximum``'s is (``clamp`` would give 1 and ``relu`` 0).

Serving computes the margin as a float64 product on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.feature.standard_scaler import standardization_moments
from sntc_tpu_torch.models.base import ClassificationModel, ClassifierEstimator
from sntc_tpu_torch.models.mlp import value_and_grad_fn
from sntc_tpu_torch.models.summary import BinaryClassificationTrainingSummary
from sntc_tpu_torch.ops.lbfgs import full_f32, minimize_lbfgs
from sntc_tpu_torch.utils.profiling import active_ledgers, record_movement


def svc_loss(theta, xc, y_signed, ws, w_sum, inv_std, reg, pen_l2, *,
             fit_intercept: bool):
    """The smooth-almost-everywhere objective: the weighted mean hinge
    over the (centered) rows ``xc`` plus the L2 term."""
    d = xc.shape[1]
    zero = torch.zeros((), dtype=xc.dtype, device=xc.device)
    coef = theta[:d]
    b = theta[d] if fit_intercept else zero
    margins = xc @ (coef * inv_std) + b
    hinge = torch.maximum(zero, 1.0 - y_signed * margins)
    data = torch.sum(ws * hinge) / w_sum
    return data + 0.5 * reg * torch.sum(pen_l2 * coef * coef)


def _svc_optimize(xc, ys, ws, inv_std, reg, pen_l2, theta0, *,
                  fit_intercept: bool, max_iter: int, tol: float):
    """The hinge-LBFGS fit over the (centered) rows ``xc`` on their
    device."""
    w_sum = torch.sum(ws)
    y_signed = 2.0 * ys.to(xc.dtype) - 1.0

    def loss_fn(theta):
        return svc_loss(theta, xc, y_signed, ws, w_sum, inv_std, reg,
                        pen_l2, fit_intercept=fit_intercept)

    return minimize_lbfgs(value_and_grad_fn(loss_fn), theta0,
                          max_iter=max_iter, tol=tol)


class _SvcParams:
    regParam = Param("L2 regularization", default=0.0, validator=validators.gteq(0))
    maxIter = Param("max LBFGS iterations", default=100, validator=validators.gt(0))
    tol = Param("convergence tolerance", default=1e-6, validator=validators.gt(0))
    fitIntercept = Param("fit an intercept term", default=True,
                         validator=validators.is_bool())
    standardization = Param(
        "standardize features internally (penalty follows the flag, as in "
        "Spark)", default=True, validator=validators.is_bool())
    threshold = Param(
        "decision threshold applied to the RAW margin (Spark LinearSVC "
        "semantics)", default=0.0)


class LinearSVC(_SvcParams, ClassifierEstimator):
    """Fits on ``device`` (default ``cuda``) and returns a model whose
    coefficients live on the same device."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _fit(self, frame: Frame) -> "LinearSVCModel":
        X, y, w = self._extract(frame)
        if len(y) and int(y.max()) > 1:
            raise ValueError(
                "LinearSVC is binary-only (Spark parity); use OneVsRest "
                "for multiclass"
            )
        d = X.shape[1]
        dev = self.device
        xs = torch.from_numpy(np.require(X, requirements=["C", "W"])).to(dev)
        ws = torch.from_numpy(w).to(dev)
        _, mean, var = standardization_moments(
            xs, ws, X[0] if X.shape[0] else np.zeros(d))
        std = np.sqrt(np.maximum(var, 0.0))
        inv_std = np.divide(1.0, std, out=np.ones_like(std),
                            where=std > 0).astype(np.float32)
        # Spark's penalty space: standardization=True penalizes the
        # standardized coefficients (theta itself), False the original
        # ones (theta * inv_std), weighted by inv_std²
        pen = (np.ones(d, np.float32) if self.getStandardization()
               else inv_std ** 2)
        fit_b = self.getFitIntercept()
        # centering is a reparametrization only when an intercept
        # absorbs the shift
        mu_opt = (mean.astype(np.float32) if fit_b
                  else np.zeros(d, np.float32))

        def on_dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        with full_f32():
            xc = xs - on_dev(mu_opt)[None, :]
            res = _svc_optimize(
                xc, torch.from_numpy(y.astype(np.int64)).to(dev), ws,
                on_dev(inv_std), float(np.float32(self.getRegParam())),
                on_dev(pen),
                torch.zeros(d + 1 if fit_b else d, dtype=torch.float32,
                            device=dev),
                fit_intercept=fit_b, max_iter=int(self.getMaxIter()),
                tol=float(self.getTol()),
            )
        del xc
        theta = res.x.cpu().numpy().astype(np.float64)
        coef = theta[:d] * inv_std  # original space
        # fold the centering back: margin = (x - mu)·coef + b
        intercept = (float(theta[d]) - float(mu_opt.astype(np.float64) @ coef)
                     if fit_b else 0.0)
        model = LinearSVCModel(coefficients=coef, intercept=intercept,
                               device=dev)
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items()
               if model.hasParam(k2)}
        )
        n_it = int(res.n_iters)
        model.summary = BinaryClassificationTrainingSummary(
            res.history.cpu().numpy()[: n_it + 1], n_it, model, frame,
            labelCol=self.getLabelCol(),
        )
        model.optimizer_stats = {"iterations": n_it,
                                 "evaluations": res.n_evals,
                                 "host_syncs": res.n_syncs}
        return model


class LinearSVCModel(_SvcParams, ClassificationModel):
    def __init__(self, coefficients: np.ndarray, intercept: float,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.coefficients = np.array(coefficients, np.float64)
        # read-only: the device copy is made once
        self.coefficients.flags.writeable = False
        self.intercept = float(intercept)
        self.summary = None
        self.optimizer_stats = None
        self.device = resolve_device(device)
        self._dev_coef = torch.from_numpy(self.coefficients.copy()).to(
            self.device)

    @property
    def num_classes(self) -> int:
        return 2

    def _save_extra(self):
        return {"intercept": self.intercept}, {"coefficients": self.coefficients}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(coefficients=arrays["coefficients"],
                intercept=float(extra["intercept"]), device=device)
        m.setParams(**params)
        return m

    def margin(self, X) -> torch.Tensor:
        """``X·coef + intercept`` ``[N]``, a float64 product on the
        model's device (the features as given, widened to float64)."""
        if isinstance(X, torch.Tensor):
            Xd = X.to(device=self.device, dtype=torch.float64)
        else:
            Xd = torch.from_numpy(
                np.ascontiguousarray(X, dtype=np.float64)).to(self.device)
        return Xd @ self._dev_coef + self.intercept

    def predict(self, X) -> np.ndarray:
        """Margin-thresholded labels (LinearSVC defines no probability)."""
        m = self.margin(X)
        return (m > float(self.getThreshold())).cpu().numpy().astype(
            np.float64)

    def _raw_predict(self, X) -> torch.Tensor:
        m = self.margin(X)
        return torch.stack([-m, m], dim=1)

    def transform_async(self, frame: Frame):
        """rawPrediction and prediction as one packed ``[N, 3]`` float64
        tensor; finalize copies it to the host once."""
        m = self.margin(frame[self.getFeaturesCol()])
        packed = torch.stack(
            [-m, m, (m > float(self.getThreshold())).to(m.dtype)], dim=1)
        ledgers = active_ledgers()

        def finalize():
            host = packed.cpu().numpy()
            record_movement(ledgers, downloads=1, download_bytes=host.nbytes)
            out = frame
            if self.getRawPredictionCol():
                out = out.with_column(self.getRawPredictionCol(),
                                      host[:, :2])
            if self.getPredictionCol():
                out = out.with_column(self.getPredictionCol(), host[:, 2])
            return out

        return finalize
