"""Factorization machines — FMClassifier / FMRegressor.

Counterpart of ``sntc_tpu/models/fm.py`` (Spark's ``FMClassifier`` /
``FMRegressor``): the second-order FM score

    s(x) = b + w·x + ½ Σ_f [ (x·V_f)² − (x² · V_f²) ]

with the logistic loss (binary classification) or the squared loss
(regression), ``factorSize`` latent dims, ``fitIntercept`` /
``fitLinear``, L2 ``regParam`` on (w, V), an N(0, ``initStd``) factor
init drawn with numpy from ``seed`` (the JAX package's draw), and the
``adamW`` (default) or ``gd`` solver on the full batch.

The fit runs on the estimator's device (default ``cuda``) in full
float32: the score is three products (:func:`fm_score`), the gradient
is autograd's, and the optimizer is optax's update written out on
tensors (:func:`adam_update`, :func:`sgd_update`): ``adamw(step,
weight_decay=0)`` is Adam with b1 0.9, b2 0.999, eps 1e-8 outside the
square root and both moments bias-corrected before the division, then
``-step`` times the update.  The loop stops on the relative change of
the pre-update loss below ``tol`` (``prev`` seeded at float32's
maximum), one read back a step; the history holds each step's loss and
the final parameters' loss.  With a ``mesh=`` of more than one shard
the rows and targets are laid out by ``shard_batch``, whose pad mask is
the row weights (as in the JAX package): each full-batch gradient is
the shards' autograd gradients of ``Σ w·loss`` summed in shard order and
divided by the summed weights, the L2 term added once; the update stays
on the model's device.

The models score on their device in float32; FMClassificationModel's
probability and prediction are then taken on the host in float64, as
the JAX model takes them.  It has no packed device program, so the
fusion planner does not fuse it as a head (nor does the JAX planner).
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.models.base import ClassificationModel, ClassifierParams
from sntc_tpu_torch.models.linear_regression import to_device
from sntc_tpu_torch.models.summary import (
    BinaryClassificationTrainingSummary,
    TrainingSummary,
)
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.parallel.collectives import (
    ShardedArray,
    fit_device,
    fit_mesh,
    shard_batch,
)
from sntc_tpu_torch.parallel.mesh import reduce_at
from sntc_tpu_torch.utils.profiling import record_movement

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def fm_score(params: dict, X: torch.Tensor) -> torch.Tensor:
    """[N] FM scores: three products."""
    V = params["V"]  # [D, k]
    xv = X @ V
    x2v2 = (X * X) @ (V * V)
    s = 0.5 * torch.sum(xv * xv - x2v2, dim=1)
    if "w" in params:
        s = s + X @ params["w"]
    if "b" in params:
        s = s + params["b"]
    return s


def _softplus(s):
    """``logaddexp(s, 0)``, ``jax.nn.softplus``'s form."""
    return torch.clamp_min(s, 0.0) + torch.log1p(torch.exp(-torch.abs(s)))


def _weighted_loss(params: dict, X, y, w, classification: bool):
    """``Σ w·loss`` over the rows."""
    s = fm_score(params, X)
    if classification:
        per_row = _softplus(s) - y * s  # logistic loss on {0, 1}
    else:
        per_row = 0.5 * (s - y) ** 2
    return torch.sum(w * per_row)


def _l2(params: dict):
    pen = torch.sum(params["V"] ** 2)
    if "w" in params:
        pen = pen + torch.sum(params["w"] ** 2)
    return pen


def fm_loss(params: dict, X, y, w, *, classification: bool, reg):
    wsum = torch.clamp_min(torch.sum(w), 1e-12)
    loss = _weighted_loss(params, X, y, w, classification) / wsum
    return loss + 0.5 * reg * _l2(params)


def _f32(v, dev) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=dev)


def adam_update(grads: dict, state: dict, params: dict, step) -> dict:
    """One ``optax.adamw(step, weight_decay=0)`` step on ``params`` in
    place of optax, op for op: ``mu = (1-b1)·g + b1·mu``, ``nu =
    (1-b2)·g² + b2·nu``, the count incremented, ``mu / (1 - b1^count)``
    and ``nu / (1 - b2^count)`` in float32, ``m̂ / (sqrt(v̂) + eps)``,
    times ``-step``, added to the parameters."""
    dev = step.device
    state["count"] = state["count"] + 1
    count = state["count"].to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(_B1, dev), count)
    bc2 = 1.0 - torch.pow(_f32(_B2, dev), count)
    c1, b1 = _f32(1.0 - _B1, dev), _f32(_B1, dev)
    c2, b2 = _f32(1.0 - _B2, dev), _f32(_B2, dev)
    eps = _f32(_ADAM_EPS, dev)
    out = {}
    for k, g in grads.items():
        mu = c1 * g + b1 * state["mu"][k]
        nu = c2 * (g * g) + b2 * state["nu"][k]
        state["mu"][k], state["nu"][k] = mu, nu
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        out[k] = params[k] + (-step) * upd
    return out


def sgd_update(grads: dict, state: dict, params: dict, step) -> dict:
    """One ``optax.sgd(step)`` step: ``p + (-step)·g``."""
    return {k: params[k] + (-step) * g for k, g in grads.items()}


def _sharded_fm_value_and_grad(xs, ys, ws, names: list, *,
                               classification: bool, reg):
    """``params -> (loss, grads)`` over ``shard_batch``'s rows: each
    shard's ``Σ w·loss`` and its autograd gradient on the shard's device,
    the ``[value, grads, Σw]`` rows summed in shard order, divided by the
    clamped ``Σw``; the L2 term and its gradient added once."""

    def value_and_grad(p):
        parts = []
        for x, y, w in zip(xs.blocks, ys.blocks, ws.blocks):
            leaves = {k: p[k].detach().to(x.device).requires_grad_(True)
                      for k in names}
            with torch.enable_grad():
                v = _weighted_loss(leaves, x, y, w, classification)
                gs = torch.autograd.grad(v, [leaves[k] for k in names])
            parts.append(torch.cat([v.detach().reshape(1)]
                                   + [g.reshape(-1) for g in gs]
                                   + [w.sum().reshape(1)]))
        home = p[names[0]].device
        tot = reduce_at(parts, mesh=xs.mesh).to(home)
        wsum = torch.clamp_min(tot[-1], 1e-12)
        leaves = {k: p[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            pen = 0.5 * reg * _l2(leaves)
            gps = torch.autograd.grad(pen, [leaves[k] for k in names],
                                      allow_unused=True)  # b: unpenalized
        grads, off = {}, 1
        for k, gp in zip(names, gps):
            n = p[k].numel()
            grads[k] = tot[off:off + n].reshape(p[k].shape) / wsum
            if gp is not None:
                grads[k] = grads[k] + gp
            off += n
        return tot[0] / wsum + pen.detach(), grads

    return value_and_grad


def fm_optimize(xs, ys, ws, params0: dict, *, classification: bool,
                solver: str, max_iter: int, step_size: float, tol: float,
                reg: float):
    """The full-batch adamW / GD fit on the parameters' device, over the
    rows ``xs`` there or ``shard_batch``'s rows: ``(params, n_iters,
    history [n_iters + 1], host reads)``.  Call under
    :func:`full_f32`."""
    dev = params0["V"].device
    reg_t, step, tol_t = (_f32(v, dev) for v in (reg, step_size, tol))
    names = list(params0)
    params = dict(params0)
    state = {"count": torch.zeros((), dtype=torch.int32, device=dev),
             "mu": {k: torch.zeros_like(v) for k, v in params.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    update = adam_update if solver == "adamW" else sgd_update

    if isinstance(xs, ShardedArray):
        value_and_grad = _sharded_fm_value_and_grad(
            xs, ys, ws, names, classification=classification, reg=reg_t)
    else:
        def value_and_grad(p):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            with torch.enable_grad():
                loss = fm_loss(leaves, xs, ys, ws,
                               classification=classification, reg=reg_t)
                grads = torch.autograd.grad(loss,
                                            [leaves[k] for k in names])
            return loss.detach(), dict(zip(names, grads))

    # the prev seed must be FINITE: |inf − loss| / inf is NaN, which
    # would stop the loop after one step
    prev = _f32(np.finfo(np.float32).max, dev)
    tiny = _f32(1e-12, dev)
    losses, it, reads = [], 0, 0
    while it < max_iter:
        # ONE forward and backward a step: hist[it] = f(params_it), and
        # the stop rule compares successive pre-update losses
        loss, grads = value_and_grad(params)
        losses.append(loss)
        delta = torch.abs(prev - loss) / torch.maximum(torch.abs(prev), tiny)
        params = update(grads, state, params, step)
        prev, it = loss, it + 1
        go_on = bool(delta > tol_t)  # the loop's one read a step
        reads += 1
        if not go_on:
            break
    losses.append(value_and_grad(params)[0])  # the final parameters'
    hist = torch.stack(losses).cpu().numpy()
    reads += 1
    return params, it, hist, reads


class _FmParams:
    factorSize = Param("latent factor dimension", default=8,
                       validator=validators.gt(0))
    fitIntercept = Param("fit the global bias", default=True,
                         validator=validators.is_bool())
    fitLinear = Param("fit the 1-way (linear) term", default=True,
                      validator=validators.is_bool())
    regParam = Param("L2 on linear + factor weights", default=0.0,
                     validator=validators.gteq(0))
    initStd = Param("stddev of the factor init", default=0.01,
                    validator=validators.gt(0))
    maxIter = Param("max optimizer steps", default=100,
                    validator=validators.gt(0))
    stepSize = Param("optimizer step size", default=1.0,
                     validator=validators.gt(0))
    tol = Param("relative loss-change tolerance", default=1e-6,
                validator=validators.gteq(0))
    solver = Param("adamW | gd", default="adamW",
                   validator=validators.one_of("adamW", "gd"))
    seed = Param("factor init seed", default=0)


def _fit_fm(est, frame, *, classification):
    X = to_host(frame[est.getFeaturesCol()])
    if X.ndim != 2:
        raise ValueError(
            f"featuresCol {est.getFeaturesCol()!r} must be a vector "
            "column (use VectorAssembler)"
        )
    X = X.astype(np.float32, copy=False)
    y = to_host(frame[est.getLabelCol()]).astype(np.float32)
    if classification and not np.all((y == 0) | (y == 1)):
        raise ValueError(
            "FMClassifier is binary-only (labels in {0, 1}); wrap in "
            "OneVsRest for multiclass (Spark parity)"
        )
    n, d = X.shape
    dev = est.device
    rng = np.random.default_rng(est.getSeed())
    k = int(est.getFactorSize())
    params0 = {"V": torch.from_numpy(rng.normal(
        0.0, est.getInitStd(), size=(d, k)).astype(np.float32)).to(dev)}
    if est.getFitLinear():
        params0["w"] = torch.zeros(d, dtype=torch.float32, device=dev)
    if est.getFitIntercept():
        params0["b"] = torch.zeros((), dtype=torch.float32, device=dev)
    mesh = fit_mesh(est.mesh)
    if mesh is None:
        rows = (to_device(X, dev), to_device(y, dev),
                torch.ones(n, dtype=torch.float32, device=dev))
    else:
        # shard_batch's pad mask is the row weights, as in the JAX package
        rows = shard_batch(mesh, X, y)
    with full_f32():
        params, n_iter, hist, reads = fm_optimize(
            *rows, params0,
            classification=classification, solver=est.getSolver(),
            max_iter=int(est.getMaxIter()), step_size=est.getStepSize(),
            tol=est.getTol(), reg=est.getRegParam(),
        )
    record_movement(syncs=reads)
    out = {
        "factors": params["V"].cpu().numpy(),
        "linear": (params["w"].cpu().numpy() if "w" in params
                   else np.zeros(d, np.float32)),
        "intercept": float(params["b"]) if "b" in params else 0.0,
        "device": dev,
    }
    return out, n_iter, hist[: n_iter + 1], reads


class _FmModelMixin:
    """The fitted factors, on the host and, once, on the model's
    device; :meth:`margin` scores a matrix there."""

    def _init_fm(self, factors, linear, intercept, device):
        self.factors = np.asarray(
            factors if factors is not None else [], np.float32)
        self.linear = np.asarray(
            linear if linear is not None else [], np.float32)
        self.intercept = float(intercept)
        self.device = resolve_device(device)
        self._dev_params = None
        self.summary = None
        self.fit_stats = None

    def _save_extra(self):
        return ({"intercept": self.intercept},
                {"factors": self.factors, "linear": self.linear})

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(factors=arrays["factors"], linear=arrays["linear"],
                intercept=float(extra.get("intercept", 0.0)), device=device)
        m.setParams(**params)
        return m

    def margin(self, X) -> np.ndarray:
        """The float32 FM score of ``X`` on the model's device, as a
        float64 host array (the JAX model's ``_fm_margin``)."""
        dev = self.device
        if self._dev_params is None:
            self._dev_params = {
                "V": torch.from_numpy(self.factors).to(dev),
                "w": torch.from_numpy(self.linear).to(dev),
                "b": _f32(self.intercept, dev)}
        x = (X.to(device=dev, dtype=torch.float32)
             if isinstance(X, torch.Tensor)
             else to_device(np.asarray(X).astype(np.float32, copy=False),
                            dev))
        with full_f32():
            s = fm_score(self._dev_params, x).cpu().numpy()
        record_movement(downloads=1, download_bytes=s.nbytes)
        return s.astype(np.float64)


class FMRegressor(_FmParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("target column", default="label")
    predictionCol = Param("output prediction column", default="prediction")

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "FMRegressionModel":
        out, n_iter, history, reads = _fit_fm(self, frame,
                                              classification=False)
        model = FMRegressionModel(**out)
        model.setParams(
            **{k: v for k, v in self.paramValues().items()
               if model.hasParam(k)}
        )
        model.summary = TrainingSummary(history, n_iter)
        model.fit_stats = {"iterations": n_iter, "host_reads": reads}
        return model


class FMRegressionModel(_FmModelMixin, _FmParams, Model):
    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("target column", default="label")
    predictionCol = Param("output prediction column", default="prediction")

    def __init__(self, factors=None, linear=None, intercept: float = 0.0,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self._init_fm(factors, linear, intercept, device)

    def predict(self, X) -> np.ndarray:
        return self.margin(X)

    def transform(self, frame: Frame) -> Frame:
        return frame.with_column(self.getPredictionCol(),
                                 self.predict(frame[self.getFeaturesCol()]))


class FMClassifier(_FmParams, ClassifierParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "FMClassificationModel":
        out, n_iter, history, reads = _fit_fm(self, frame,
                                              classification=True)
        model = FMClassificationModel(**out)
        model.setParams(
            **{k: v for k, v in self.paramValues().items()
               if model.hasParam(k)}
        )
        model.summary = BinaryClassificationTrainingSummary(
            history, n_iter, model, frame, labelCol=self.getLabelCol(),
            mesh=fit_mesh(self.mesh))
        model.fit_stats = {"iterations": n_iter, "host_reads": reads}
        return model


class FMClassificationModel(_FmModelMixin, _FmParams, ClassificationModel):
    def __init__(self, factors=None, linear=None, intercept: float = 0.0,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self._init_fm(factors, linear, intercept, device)

    @property
    def num_classes(self) -> int:
        return 2

    def _raw_prob(self, X):
        """(raw [-s, s], probability) as float64 host arrays."""
        from scipy.special import expit  # overflow-free sigmoid

        s = self.margin(X)
        p1 = expit(s)
        return (np.stack([-s, s], axis=1),
                np.stack([1.0 - p1, p1], axis=1))

    def transform_async(self, frame: Frame):
        out = self._build_output(
            frame, *self._raw_prob(frame[self.getFeaturesCol()]))
        return lambda: out
