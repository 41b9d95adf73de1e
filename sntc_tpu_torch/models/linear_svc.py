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
With a ``mesh=`` of more than one shard the rows are laid out by
``shard_batch``: the moments are one aggregate, each shard's rows are
centered on its device, and each objective evaluation sums the shards'
``(Σ w·hinge, gradient, Σw)`` in shard order
(``mlp.sharded_value_and_grad``), the penalty added once; the training
summary's confusion matrix is summed over the same mesh.

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
from sntc_tpu_torch.models.mlp import (
    local_blocks,
    sharded_value_and_grad,
    value_and_grad_fn,
)
from sntc_tpu_torch.models.summary import BinaryClassificationTrainingSummary
from sntc_tpu_torch.ops.lbfgs import full_f32, minimize_lbfgs
from sntc_tpu_torch.parallel.collectives import (
    ShardedArray,
    fit_device,
    fit_mesh,
    fit_rows,
)
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
    device, or over a list of ``(xc, ys, ws)`` shard blocks of
    ``ys.mesh``'s shards (``ys`` then the sharded labels)."""
    if isinstance(ys, ShardedArray):
        def data_fn(theta, x, y, w):
            # a shard's Σ w·hinge: the loss without its penalty and its
            # division by Σw
            return svc_loss(theta, x, 2.0 * y.to(x.dtype) - 1.0, w, 1.0,
                            inv_std.to(x.device), 0.0, pen_l2.to(x.device),
                            fit_intercept=fit_intercept)

        def penalty(theta):
            d = inv_std.shape[0]
            return 0.5 * reg * torch.sum(pen_l2 * theta[:d] * theta[:d])

        value_and_grad = sharded_value_and_grad(ys.mesh, data_fn, xc,
                                                penalty)
    else:
        w_sum = torch.sum(ws)
        y_signed = 2.0 * ys.to(xc.dtype) - 1.0

        def loss_fn(theta):
            return svc_loss(theta, xc, y_signed, ws, w_sum, inv_std, reg,
                            pen_l2, fit_intercept=fit_intercept)

        value_and_grad = value_and_grad_fn(loss_fn)
    return minimize_lbfgs(value_and_grad, theta0, max_iter=max_iter,
                          tol=tol)


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
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    coefficients live on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "LinearSVCModel":
        X, y, w = self._extract(frame)
        if len(y) and int(y.max()) > 1:
            raise ValueError(
                "LinearSVC is binary-only (Spark parity); use OneVsRest "
                "for multiclass"
            )
        d = X.shape[1]
        dev = self.device
        mesh = fit_mesh(self.mesh)
        xs, ys, ws = fit_rows(X, y, w, dev, mesh)
        _, mean, var = standardization_moments(
            xs, ws, X[0] if X.shape[0] else np.zeros(d), mesh)
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
            if mesh is None:
                xc = xs - on_dev(mu_opt)[None, :]
            else:  # each shard's rows centered on its device
                xc = [(x - on_dev(mu_opt).to(x.device)[None, :], y_, w_)
                      for x, y_, w_ in local_blocks(xs, ys, ws)]
            res = _svc_optimize(
                xc, ys, ws,
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
            labelCol=self.getLabelCol(), mesh=mesh,
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
