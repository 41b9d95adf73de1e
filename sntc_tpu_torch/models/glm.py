"""GeneralizedLinearRegression — GLMs fit by IRLS.

Counterpart of ``sntc_tpu/models/glm.py`` (Spark's
``GeneralizedLinearRegression``): family × link GLMs fit by iteratively
reweighted least squares: each iteration forms the working response
``z = η + (y − μ)·g′(μ)`` and weights ``W = w / (Var(μ)·g′(μ)²)`` and
solves one weighted normal equation.  Families gaussian, binomial,
poisson, gamma (Spark's link grid for each) and tweedie (a power link,
``linkPower`` defaulting to 1 − ``variancePower``); ``regParam`` is L2
on the weight-averaged Gram, the intercept unpenalized.

The fit runs on the estimator's device (default ``cuda``) in full
float32, as the JAX package's jitted loop does: each iteration is two
products (``Xᵀ(WX)`` and ``Xᵀ(Wz)``, the intercept a ones column) and a
Cholesky solve (``torch.linalg.cholesky_ex`` and ``cholesky_solve``,
where the JAX package calls ``solve(assume_a="pos")``); the stop test
(the relative coefficient change against ``tol``) is read back once an
iteration.  The deviance, the null deviance and Pearson's χ² are taken
on the device after the loop and read back with the coefficients.
With a ``mesh=`` of more than one shard the augmented rows, targets and
weights are laid out by ``shard_batch`` (weight 0 on the padding): each
iteration sums the shards' ``[D+1, D+1]`` ``Xᵀ(WX)`` and ``[D+1]``
``Xᵀ(Wz)`` in shard order (one ``make_tree_aggregate``), the diagonal
penalty is added once and the solve runs on the model's device; the
deviances and χ² are summed per shard the same way.

``model.summary`` carries the deviances, the residual degrees of
freedom, the dispersion (1 for binomial and poisson, Pearson χ² / dof
otherwise), ``totalIterations`` and a lazy ``aic`` (Spark's lazy val),
computed on the host in float64 end to end (:func:`_aic`, the JAX
package's: the inverse link in numpy, the binomial counts rounded half
up as Scala's ``math.round``); tweedie has no AIC and raises.

The model predicts on its device in float32 (``η = X·β + b``, ``μ =
g⁻¹(η)``) and returns float64 columns, as the JAX model does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.models.linear_regression import to_device
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.parallel.collectives import (
    ShardedArray,
    fit_columns,
    fit_device,
    fit_mesh,
    make_tree_aggregate,
)
from sntc_tpu_torch.utils.profiling import record_movement

_EPS = 1e-10
# the probability clip must survive f32: 1 − 1e-10 rounds to exactly 1.0
# in f32 (log(1−μ) → −inf); 1e-6 is the tightest safe gap
_MU_EPS = 1e-6

_FAMILIES = ("gaussian", "binomial", "poisson", "gamma", "tweedie")
_LINKS = ("identity", "log", "logit", "inverse", "sqrt", "cloglog", "probit")
_DEFAULT_LINK = {
    "gaussian": "identity",
    "binomial": "logit",
    "poisson": "log",
    "gamma": "inverse",
}
# Spark's supported (family, link) grid
_SUPPORTED = {
    "gaussian": ("identity", "log", "inverse"),
    "binomial": ("logit", "probit", "cloglog", "log"),
    "poisson": ("log", "identity", "sqrt"),
    "gamma": ("inverse", "identity", "log"),
}
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _norm_pdf(x):
    return torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def _link_fns(link: str):
    """(g, g_inv, g_prime) on tensors, for η = g(μ).  ``power:<lp>`` is
    the tweedie power link μ^lp (lp = 0 means log)."""
    if link.startswith("power:"):
        lp = float(link.split(":", 1)[1])
        if lp == 0.0:
            return (torch.log, torch.exp, lambda m: 1.0 / m)
        if lp == 1.0:
            return (lambda m: m, lambda e: e, torch.ones_like)
        # μ > 0 for every non-identity power link, so η = μ^lp is
        # positive too: clamp (a fractional 1/lp of a transiently
        # negative η would NaN the loop)
        return (
            lambda m: m**lp,
            lambda e: torch.clamp_min(e, _EPS) ** (1.0 / lp),
            lambda m: lp * m ** (lp - 1.0),
        )
    if link == "identity":
        return (lambda m: m, lambda e: e, torch.ones_like)
    if link == "log":
        return (torch.log, torch.exp, lambda m: 1.0 / m)
    if link == "logit":
        return (
            lambda m: torch.log(m / (1.0 - m)),
            torch.sigmoid,
            lambda m: 1.0 / (m * (1.0 - m)),
        )
    if link == "inverse":
        return (lambda m: 1.0 / m, lambda e: 1.0 / e, lambda m: -1.0 / m**2)
    if link == "sqrt":
        return (torch.sqrt, lambda e: e**2, lambda m: 0.5 / torch.sqrt(m))
    if link == "cloglog":
        return (
            lambda m: torch.log(-torch.log1p(-m)),
            lambda e: -torch.expm1(-torch.exp(e)),
            lambda m: -1.0 / ((1.0 - m) * torch.log1p(-m)),
        )
    if link == "probit":
        return (
            torch.special.ndtri,
            torch.special.ndtr,
            lambda m: 1.0 / torch.clamp_min(
                _norm_pdf(torch.special.ndtri(m)), _EPS),
        )
    raise ValueError(f"unknown link {link!r}")


def _link_inv_np(link: str):
    """The float64 numpy inverse link, for the lazy AIC pass."""
    from scipy.special import expit, ndtr

    if link.startswith("power:"):
        lp = float(link.split(":", 1)[1])
        if lp == 0.0:
            return np.exp
        if lp == 1.0:
            return lambda e: e
        return lambda e: np.maximum(e, _EPS) ** (1.0 / lp)
    try:
        return {
            "identity": lambda e: e,
            "log": np.exp,
            "logit": expit,
            "inverse": lambda e: 1.0 / e,
            "sqrt": lambda e: e**2,
            "cloglog": lambda e: -np.expm1(-np.exp(e)),
            "probit": ndtr,
        }[link]
    except KeyError:
        raise ValueError(f"unknown link {link!r}") from None


def _clip_mu_np(family: str, mu, var_power: float = 0.0):
    """Float64 numpy twin of :func:`_clip_mu` (same bounds)."""
    if family == "binomial":
        return np.clip(mu, _MU_EPS, 1.0 - _MU_EPS)
    if family in ("poisson", "gamma"):
        return np.maximum(mu, _EPS)
    if family == "tweedie" and var_power != 0.0:
        return np.maximum(mu, _EPS)
    return mu


def _tweedie_link(stage) -> str:
    """A tweedie stage's power link: an explicit ``power:<lp>`` (as
    persisted on fitted models) passes through; otherwise linkPower,
    defaulting to 1 − variancePower."""
    link = stage.getLink()
    if link is not None:
        if not link.startswith("power:"):
            raise ValueError(
                "family='tweedie' uses linkPower, not link (Spark)"
            )
        try:
            return f"power:{float(link[6:])}"  # validate + normalize
        except ValueError:
            raise ValueError(
                f"malformed tweedie power link {link!r} (expected "
                "'power:<float>')"
            ) from None
    lp = stage.getLinkPower()
    if lp is None:
        lp = 1.0 - float(stage.getVariancePower())
    return f"power:{float(lp)}"


def _variance(family: str, mu, var_power: float = 0.0):
    if family == "gaussian":
        return torch.ones_like(mu)
    if family == "binomial":
        return mu * (1.0 - mu)
    if family == "poisson":
        return mu
    if family == "tweedie":
        if var_power == 0.0:
            return torch.ones_like(mu)
        return torch.clamp_min(mu, _EPS) ** var_power
    return mu * mu  # gamma


def _clip_mu(family: str, mu, var_power: float = 0.0):
    if family == "binomial":
        return torch.clamp(mu, _MU_EPS, 1.0 - _MU_EPS)
    if family in ("poisson", "gamma"):
        return torch.clamp_min(mu, _EPS)
    if family == "tweedie" and var_power != 0.0:
        return torch.clamp_min(mu, _EPS)  # μ > 0 whenever Var(μ) = μ^p
    return mu


def _where(cond, a, b):
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def _deviance(family: str, y, mu, w, var_power: float = 0.0):
    """The unit deviance summed with weights (Spark/R semantics)."""
    if family == "tweedie":
        p = var_power
        if p == 0.0:
            return torch.sum(w * (y - mu) ** 2)
        if p == 1.0:
            ylog = _where(
                y > 0, y * torch.log(torch.clamp_min(y, _EPS) / mu), 0.0)
            return 2.0 * torch.sum(w * (ylog - (y - mu)))
        if p == 2.0:
            return 2.0 * torch.sum(
                w * (-torch.log(torch.clamp_min(y, _EPS) / mu)
                     + (y - mu) / mu))
        # the general unit deviance (y = 0 contributes only the μ term
        # for 1 < p < 2; labels are validated > 0 for p > 2)
        yp = torch.clamp_min(y, 0.0)
        t1 = _where(yp > 0, yp ** (2.0 - p) / ((1.0 - p) * (2.0 - p)), 0.0)
        t2 = y * mu ** (1.0 - p) / (1.0 - p)
        t3 = mu ** (2.0 - p) / (2.0 - p)
        return 2.0 * torch.sum(w * (t1 - t2 + t3))
    if family == "gaussian":
        return torch.sum(w * (y - mu) ** 2)
    if family == "binomial":
        yc = torch.clamp(y, _MU_EPS, 1.0 - _MU_EPS)
        # zero-coefficient terms guarded: 0 · log(·) must not see an inf
        t1 = _where(y > 0, y * torch.log(yc / mu), 0.0)
        t0 = _where(y < 1, (1.0 - y) * torch.log((1.0 - yc) / (1.0 - mu)),
                    0.0)
        return 2.0 * torch.sum(w * (t1 + t0))
    if family == "poisson":
        ylog = _where(y > 0, y * torch.log(torch.clamp_min(y, _EPS) / mu),
                      0.0)
        return 2.0 * torch.sum(w * (ylog - (y - mu)))
    # gamma
    return 2.0 * torch.sum(
        w * (-torch.log(torch.clamp_min(y, _EPS) / mu) + (y - mu) / mu))


def irls(xs, ys, ws, beta0, *, family: str, link: str, fit_intercept: bool,
         max_iter: int, tol: float, reg: float, var_power: float = 0.0):
    """The IRLS fit on ``xs``'s device (``xs`` AUGMENTED with a ones
    column when ``fit_intercept``), or over ``shard_batch``'s rows, each
    pass over the rows then one aggregate (β given whole to every shard)
    and the penalty and the solve on β's device: ``(beta, iterations,
    deviance, null deviance, Pearson χ², host reads)``, the first four
    float64 host values, read back in one copy.  Call under
    :func:`full_f32`."""
    g, g_inv, g_prime = _link_fns(link)
    dev = beta0.device
    d_aug = xs.shape[1]

    def eta_mu(x, beta):
        eta = x @ beta
        return eta, _clip_mu(family, g_inv(eta), var_power)

    def weight_sums(y, w):
        return torch.stack([torch.sum(w), torch.sum(w * y)])

    def normal_eq(x, y, w, beta):
        """``Xᵀ(WX)`` and ``Xᵀ(Wz)`` at β, flattened into one tensor."""
        eta, mu = eta_mu(x, beta)
        gp = g_prime(mu)
        z = eta + (y - mu) * gp
        wls = w / torch.clamp_min(_variance(family, mu, var_power) * gp**2,
                                  _EPS)
        xw = x * wls[:, None]
        return torch.cat([(x.t() @ xw).reshape(-1), xw.t() @ z])

    def deviances(x, y, w, beta, ybar):
        """The deviance, the null deviance (the intercept-only model, μ =
        the weighted mean response) and Pearson's χ²."""
        _, mu = eta_mu(x, beta)
        mu0 = _clip_mu(family, ybar.expand(y.shape), var_power)
        return torch.stack([
            _deviance(family, y, mu, w, var_power),
            _deviance(family, y, mu0, w, var_power),
            torch.sum(w * (y - mu) ** 2 / torch.clamp_min(
                _variance(family, mu, var_power), _EPS))])

    if isinstance(xs, ShardedArray):
        def over_rows(fn, op, replicated=()):
            agg = make_tree_aggregate(fn, xs.mesh, replicated_args=replicated,
                                      op=op)
            return lambda *a: agg(*a).to(dev)
    else:
        def over_rows(fn, op, replicated=()):
            return fn
    sums = over_rows(weight_sums, "glm.weights")(ys, ws)
    normal = over_rows(normal_eq, "glm.irls", (3,))
    # λ applies to the weight-AVERAGED Gram (Spark WeightedLeastSquares):
    # the raw weighted Gram's diagonal gets λ·Σw
    reg_t = torch.tensor(np.float32(reg), device=dev)
    pen = (reg_t * sums[0]) * torch.ones(d_aug, device=dev)
    if fit_intercept:
        pen[-1] = 0.0
    tol_t = torch.tensor(np.float32(tol), device=dev)
    one = torch.ones((), device=dev)
    beta, it, reads = beta0, 0, 0
    while it < max_iter:
        ab = normal(xs, ys, ws, beta)
        A = ab[:d_aug * d_aug].reshape(d_aug, d_aug) + torch.diag(pen)
        chol, _ = torch.linalg.cholesky_ex(A)
        beta_new = torch.cholesky_solve(ab[d_aug * d_aug:, None], chol)[:, 0]
        delta = torch.max(torch.abs(beta_new - beta)) / torch.maximum(
            torch.max(torch.abs(beta)), one)
        beta, it = beta_new, it + 1
        go_on = bool(delta > tol_t)  # the loop's one read an iteration
        reads += 1
        if not go_on:
            break
    ybar = sums[1] / torch.clamp_min(sums[0], _EPS)
    devs = over_rows(deviances, "glm.deviance", (3, 4))(xs, ys, ws, beta,
                                                        ybar)
    flat = torch.cat([beta, devs]).cpu()
    reads += 1
    flat = flat.numpy().astype(np.float64)
    return flat[:d_aug], it, flat[d_aug], flat[d_aug + 1], \
        flat[d_aug + 2], reads


def _aic(family: str, y, mu, w, n: int, dev: float, rank: int) -> float:
    """Spark's ``Family.aic`` + 2·rank (the R family $aic forms), in
    float64 on the host; ``mu`` is the converged mean from the fitted
    linear predictor."""
    from scipy.special import gammaln

    y = np.asarray(y, np.float64)
    mu = np.asarray(mu, np.float64)
    w = np.asarray(w, np.float64)
    if family == "gaussian":
        # closed form from the deviance; R gaussian()$aic incl. −Σ log w
        ll2 = (
            n * (np.log(dev / n * 2.0 * np.pi) + 1.0)
            + 2.0
            - float(np.sum(np.log(w)))
        )
        return float(ll2 + 2.0 * rank)
    if family == "binomial":
        # weights are trial counts: Binomial(round(w), μ) log-pmf of
        # round(y·w) successes; weight-0 rows contribute 0 (Spark).
        # Scala's math.round is half UP, floor(x + 0.5), not numpy's
        # half-to-even (np.round(2.5) == 2, math.round(2.5) == 3)
        wt = np.floor(w + 0.5)
        r = np.floor(y * w + 0.5)
        mu_c = np.clip(mu, _MU_EPS, 1.0 - _MU_EPS)
        logpmf = (
            gammaln(wt + 1.0)
            - gammaln(r + 1.0)
            - gammaln(wt - r + 1.0)
            + r * np.log(mu_c)
            + (wt - r) * np.log1p(-mu_c)
        )
        ll = float(np.sum(np.where(wt == 0, 0.0, logpmf)))
        return float(-2.0 * ll + 2.0 * rank)
    if family == "poisson":
        yi = np.floor(y)  # the Poisson pmf is over integers (Spark y.toInt)
        logpmf = yi * np.log(np.maximum(mu, _EPS)) - mu - gammaln(yi + 1.0)
        return float(-2.0 * np.sum(w * logpmf) + 2.0 * rank)
    if family == "gamma":
        # dispersion from the deviance (Spark/R plug-in), shape 1/φ,
        # scale μ·φ
        disp = dev / float(np.sum(w))
        shape = 1.0 / disp
        scale = mu * disp
        logpdf = (
            (shape - 1.0) * np.log(y)
            - y / scale
            - gammaln(shape)
            - shape * np.log(scale)
        )
        return float(-2.0 * np.sum(w * logpdf) + 2.0 + 2.0 * rank)
    raise AssertionError(f"_aic called for unsupported family {family!r}")


class _GlrParams:
    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("target column", default="label")
    predictionCol = Param("output prediction column", default="prediction")
    linkPredictionCol = Param(
        "optional output column for the link-scale prediction η",
        default=None,
    )
    family = Param(
        "gaussian | binomial | poisson | gamma | tweedie", default="gaussian",
        validator=validators.one_of(*_FAMILIES),
    )
    link = Param(
        "identity | log | logit | inverse | sqrt | cloglog | probit "
        "(default: the family's canonical link)",
        default=None,
    )
    maxIter = Param("max IRLS iterations", default=25,
                    validator=validators.gt(0))
    tol = Param("relative coefficient-change tolerance", default=1e-6,
                validator=validators.gt(0))
    regParam = Param("L2 regularization (Spark GLR is L2-only)",
                     default=0.0, validator=validators.gteq(0))
    variancePower = Param(
        "tweedie variance power p (Var = mu^p): 0 or >= 1 (Spark)",
        default=0.0,
        validator=lambda v: v == 0.0 or v >= 1.0,
    )
    linkPower = Param(
        "tweedie link power (None -> 1 - variancePower; 0 means log)",
        default=None,
        validator=lambda v: v is None or isinstance(v, (int, float)),
    )
    fitIntercept = Param("fit an intercept", default=True,
                         validator=validators.is_bool())
    weightCol = Param("optional row weight column", default=None)


class GeneralizedLinearRegressionTrainingSummary:
    def __init__(self, *, deviance, null_deviance, pearson, n, rank,
                 family, total_iterations, aic=None):
        self.deviance = float(deviance)
        self.nullDeviance = float(null_deviance)
        self.residualDegreeOfFreedom = int(n - rank)
        self.residualDegreeOfFreedomNull = int(n - 1)
        self.totalIterations = int(total_iterations)
        # Spark: dispersion is 1 for binomial/poisson, Pearson χ² / dof
        # otherwise
        self.dispersion = (
            1.0
            if family in ("binomial", "poisson")
            else float(pearson) / max(n - rank, 1)
        )
        # a value, a zero-arg thunk (Spark's lazy val) or None (tweedie)
        self._aic = aic

    @property
    def aic(self) -> float:
        if self._aic is None:
            raise ValueError(
                "No AIC available for the tweedie family (Spark parity)"
            )
        if callable(self._aic):
            self._aic = float(self._aic())
        return self._aic

    @property
    def objectiveHistory(self):  # API shim (IRLS keeps no trace)
        return []


def _seed_mean(link: str, ybar: float) -> float:
    """The weighted mean response clamped into the LINK's domain (a
    gaussian+log fit on a ≤ 0 mean must not seed a NaN intercept)."""
    if link in ("logit", "cloglog", "probit"):
        return min(max(ybar, 1e-6), 1.0 - 1e-6)
    if link in ("log", "inverse", "sqrt"):
        return max(ybar, 1e-6)
    if link.startswith("power:") and link != "power:1.0":
        return max(ybar, 1e-6)
    return ybar


class GeneralizedLinearRegression(_GlrParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _resolved_link(self) -> str:
        family = self.getFamily()
        if family == "tweedie":
            # tweedie ignores named links and uses linkPower (Spark); a
            # persisted "power:<lp>" passes through
            return _tweedie_link(self)
        link = self.getLink() or _DEFAULT_LINK[family]
        if link not in _LINKS:
            raise ValueError(f"unknown link {link!r}; one of {_LINKS}")
        if link not in _SUPPORTED[family]:
            raise ValueError(
                f"link {link!r} is not supported for family {family!r} "
                f"(Spark grid: {_SUPPORTED[family]})"
            )
        return link

    def _fit(self, frame: Frame) -> "GeneralizedLinearRegressionModel":
        family = self.getFamily()
        link = self._resolved_link()
        X = to_host(frame[self.getFeaturesCol()])
        if X.ndim != 2:
            raise ValueError(
                f"featuresCol {self.getFeaturesCol()!r} must be a vector "
                "column (use VectorAssembler)"
            )
        X = X.astype(np.float32, copy=False)
        y = to_host(frame[self.getLabelCol()]).astype(np.float32)
        if family == "binomial" and not np.all((y >= 0) & (y <= 1)):
            # Spark Binomial takes the whole [0, 1] range: fractional
            # labels are success PROPORTIONS with weightCol trial counts
            raise ValueError("binomial family needs labels in [0, 1]")
        if family in ("poisson", "gamma") and (y < 0).any():
            raise ValueError(f"{family} family needs non-negative labels")
        if family == "gamma" and (y == 0).any():
            raise ValueError("gamma family needs strictly positive labels")
        vp = float(self.getVariancePower()) if family == "tweedie" else 0.0
        if family == "tweedie":
            if vp >= 1.0 and (y < 0).any():
                raise ValueError(
                    "tweedie with variancePower >= 1 needs non-negative "
                    "labels"
                )
            if vp >= 2.0 and (y == 0).any():
                raise ValueError(
                    "tweedie with variancePower >= 2 needs strictly "
                    "positive labels"
                )
        wcol = self.getWeightCol()
        w = (to_host(frame[wcol]).astype(np.float32) if wcol
             else np.ones(len(y), np.float32))
        n, d = X.shape
        fit_b = self.getFitIntercept()
        Xa = (np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
              if fit_b else X)
        # init: zero coefficients, the intercept at g(weighted mean
        # response), taken in float32 as the JAX package takes it
        beta0 = np.zeros(Xa.shape[1], np.float32)
        ybar = float(np.average(y, weights=w)) if n else 0.0
        if fit_b:
            g = _link_fns(link)[0]
            beta0[-1] = float(g(torch.tensor(
                _seed_mean(link, ybar), dtype=torch.float32)))
        dev = self.device
        xs, ys, ws = fit_columns((Xa, y), w, dev, fit_mesh(self.mesh))
        with full_f32():
            beta, n_iter, dev_, dev0, pearson, reads = irls(
                xs, ys, ws, torch.from_numpy(beta0).to(dev),
                family=family, link=link, fit_intercept=fit_b,
                max_iter=int(self.getMaxIter()), tol=float(self.getTol()),
                reg=float(self.getRegParam()), var_power=vp,
            )
        record_movement(syncs=reads)
        coef = beta[:d] if fit_b else beta
        intercept = float(beta[-1]) if fit_b else 0.0
        model = GeneralizedLinearRegressionModel(
            coefficients=coef, intercept=intercept, device=dev)
        model.setParams(
            **{k: v for k, v in self.paramValues().items()
               if model.hasParam(k)}
        )
        model.set("link", link)  # persist the RESOLVED link
        rank = d + (1 if fit_b else 0)
        if family == "tweedie":
            aic = None  # Spark: no AIC for tweedie; the property raises
        else:
            # lazy (Spark's lazy val): the O(n·d) host product and the
            # gammaln pass run only if summary.aic is read

            def aic(_Xa=Xa, _y=y, _w=w, _fam=family, _link=link, _vp=vp,
                    _beta=beta, _dev=float(dev_), _n=n, _rank=rank):
                eta = _Xa.astype(np.float64) @ _beta
                mu_fit = _clip_mu_np(
                    _fam, np.asarray(_link_inv_np(_link)(eta), np.float64),
                    _vp)
                return _aic(_fam, _y, mu_fit, _w, _n, _dev, _rank)
        model.summary = GeneralizedLinearRegressionTrainingSummary(
            deviance=dev_, null_deviance=dev0, pearson=pearson, n=n,
            rank=rank, family=family, total_iterations=n_iter, aic=aic,
        )
        model.fit_stats = {"iterations": n_iter, "host_reads": reads}
        return model


def _model_link(stage) -> str:
    """A fitted or hand-built model's link: the persisted value if set,
    else the family default (tweedie: the power link)."""
    link = stage.getLink()
    if link is not None:
        return link
    fam = stage.getFamily()
    if fam == "tweedie":
        return _tweedie_link(stage)
    return _DEFAULT_LINK[fam]


class GeneralizedLinearRegressionModel(_GlrParams, Model):
    def __init__(self, coefficients=None, intercept: float = 0.0,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.coefficients = np.asarray(
            coefficients if coefficients is not None else [], np.float64
        )
        self.intercept = float(intercept)
        self.device = resolve_device(device)
        self.summary: Optional[
            GeneralizedLinearRegressionTrainingSummary
        ] = None
        self.fit_stats = None

    def _save_extra(self):
        return (
            {"intercept": self.intercept},
            {"coefficients": self.coefficients},
        )

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(
            coefficients=arrays["coefficients"],
            intercept=float(extra.get("intercept", 0.0)), device=device,
        )
        m.setParams(**params)
        return m

    def _predict_eta_mu(self, X):
        """(η, μ) as float64 host arrays: float32 on the model's device,
        the JAX model's ``_glm_predict``."""
        dev = self.device
        x = (X.to(device=dev, dtype=torch.float32)
             if isinstance(X, torch.Tensor)
             else to_device(np.asarray(X).astype(np.float32, copy=False),
                            dev))
        _, g_inv, _ = _link_fns(_model_link(self))
        coef = torch.from_numpy(self.coefficients.astype(np.float32)).to(dev)
        with full_f32():
            eta = x @ coef + torch.tensor(np.float32(self.intercept),
                                          device=dev)
            both = torch.stack([eta, g_inv(eta)]).cpu().numpy()
        return both[0].astype(np.float64), both[1].astype(np.float64)

    def transform(self, frame: Frame) -> Frame:
        eta, mu = self._predict_eta_mu(frame[self.getFeaturesCol()])
        out = frame.with_column(self.getPredictionCol(), mu)
        link_col = self.getLinkPredictionCol()
        if link_col:
            out = out.with_column(link_col, eta)
        return out

    def predict(self, X) -> np.ndarray:
        return self._predict_eta_mu(X)[1]
