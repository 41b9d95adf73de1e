"""The port's LinearRegression, AFTSurvivalRegression,
IsotonicRegression, GeneralizedLinearRegression and the factorization
machines against the JAX package's, on the CPU.

Inputs are numpy-seeded rows of a few well-scaled features (a linear
signal and noise; counts, positive and binary targets from it), the JAX
side on tier-1's ``mesh8`` (8 virtual CPU devices: its sums are per
shard, the port's once).

Tolerances, each with what it measured here when set:

* LinearRegression, normal solver: coefficients and intercept within
  1e-5 of the largest coefficient (the float32 moments in two orders,
  the solve in float64; 3.4e-7 measured); l-bfgs (elastic net, with and
  without standardization): the objective history within 1e-5 of its
  start and the coefficients within 1e-4 (2.1e-7 and 1.4e-7), the same
  iteration count;
* AFT: the objective history within 1e-5 of its start (4.2e-7), the
  coefficients within 1e-4 of the largest and the scale within 1e-5
  relative (4.2e-7 and 8.9e-8), the same iteration count; predictions
  and quantiles of one model bitwise (the same float64 numpy);
* IsotonicRegression: bitwise (the same host code);
* GLM, every family × link pair the JAX package accepts and tweedie:
  coefficients within 1e-4 of the largest (1.1e-5 at most), the deviance
  and the null deviance within 1e-5 relative (1.0e-6, 1.5e-7), the
  dispersion within 1e-4 (2.0e-6), the AIC within 1e-5 relative
  (1.7e-6), and the prediction of one model within 1e-6 absolute plus
  1e-6 relative (the float32 inverse link in two libraries); the
  iteration counts may part once the fit has converged (the stop test
  meets float32 noise: 11 of the 22 cases parted, tweedie 1.5 by 5
  against 12); ``_aic`` bitwise on the same inputs, half-integer weights
  included;
* FM, adamW and gd: the loss history within 1e-5 of its start (1.7e-7
  at most), the fitted factors and linear term within 1e-4 of the
  largest (5.8e-6), the same step count; the classifier's predictions on
  99.9 % of rows (100 % measured) and its probabilities within 1e-5
  (3.1e-7); the optimizer's update (:func:`adam_update`) bitwise optax's
  on the same gradients;
* a model saved by the JAX package loads in the port with every array
  bitwise.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import AFTSurvivalRegression as JAFT
from sntc_tpu.models import FMClassifier as JFMClassifier
from sntc_tpu.models import FMRegressor as JFMRegressor
from sntc_tpu.models import GeneralizedLinearRegression as JGLM
from sntc_tpu.models import IsotonicRegression as JIsotonic
from sntc_tpu.models import LinearRegression as JLR
from sntc_tpu.models.glm import _SUPPORTED
from sntc_tpu.models.glm import _aic as jax_aic
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import (
    AFTSurvivalRegression,
    FMClassificationModel,
    FMClassifier,
    FMRegressor,
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
    IsotonicRegression,
    LinearRegression,
)
from sntc_tpu_torch.models.fm import adam_update
from sntc_tpu_torch.models.glm import _aic
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _hist_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(abs(b[0]), 1e-30))


def _data(seed=0, n=1500, d=5):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * np.linspace(0.5, 2.0, d)
         + np.linspace(-1.0, 3.0, d)).astype(np.float32)
    beta = rng.normal(size=d) * 0.4
    eta = (X - X.mean(axis=0)) @ beta
    return X, eta, rng


def _frames(cols):
    return JFrame(cols), Frame(cols)


@pytest.mark.parametrize("kw", [
    {}, {"regParam": 0.1}, {"regParam": 0.1, "standardization": False},
    {"fitIntercept": False}, {"weightCol": "w"},
])
def test_linear_regression_normal_matches_the_jax_fit(mesh8, kw):
    X, eta, rng = _data()
    cols = {"features": X, "label": (eta + 2.0 + rng.normal(
        size=len(X)) * 0.3).astype(np.float32),
        "w": rng.uniform(0.5, 2.0, len(X)).astype(np.float32)}
    jf, pf = _frames(cols)
    a = JLR(mesh=mesh8, solver="normal", **kw).fit(jf)
    b = LinearRegression(device="cpu", solver="normal", **kw).fit(pf)
    scale = np.abs(a.coefficients).max()
    assert np.abs(b.coefficients - a.coefficients).max() <= 1e-5 * scale
    assert abs(b.intercept - a.intercept) <= 1e-5 * scale
    assert b.summary.totalIterations == 0
    np.testing.assert_allclose(b.predict(X), a.predict(X), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("standardization", [True, False])
def test_linear_regression_elastic_net_matches_the_jax_fit(
        mesh8, standardization):
    X, eta, rng = _data(seed=1)
    cols = {"features": X, "label": (eta + rng.normal(
        size=len(X)) * 0.3).astype(np.float32)}
    jf, pf = _frames(cols)
    kw = dict(regParam=0.05, elasticNetParam=0.5,
              standardization=standardization)
    a = JLR(mesh=mesh8, **kw).fit(jf)
    b = LinearRegression(device="cpu", **kw).fit(pf)
    assert b.summary.totalIterations == a.summary.totalIterations > 1
    assert _hist_gap(b.summary.objectiveHistory,
                     a.summary.objectiveHistory) <= 1e-5
    assert _rel(b.coefficients, a.coefficients) <= 1e-4
    assert b.optimizer_stats["iterations"] == b.summary.totalIterations


def test_linear_regression_singular_gram_and_refusals():
    X, eta, _ = _data(seed=2, d=3)
    X = np.concatenate([X, X[:, :1]], axis=1)  # a duplicated column
    y = eta.astype(np.float32)
    jm = JLR(solver="normal").fit(JFrame({"features": X, "label": y}))
    pm = LinearRegression(device="cpu", solver="normal").fit(
        Frame({"features": X, "label": y}))
    assert _rel(pm.predict(X), jm.predict(X)) <= 1e-5
    with pytest.raises(ValueError, match="no L1 term"):
        LinearRegression(device="cpu", solver="normal", regParam=0.1,
                         elasticNetParam=0.5).fit(
            Frame({"features": X, "label": y}))
    with pytest.raises(ValueError, match="vector column"):
        LinearRegression(device="cpu").fit(
            Frame({"features": y, "label": y}))


def _aft_frame(seed=3, n=1500):
    X, eta, rng = _data(seed=seed, n=n)
    t = np.exp(1.0 + eta + rng.gumbel(size=n) * 0.5)
    cut = np.quantile(t, 0.8)
    return {"features": X, "label": np.minimum(t, cut),
            "censor": (t < cut).astype(np.float64)}


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_aft_matches_the_jax_fit(mesh8, fit_intercept):
    cols = _aft_frame()
    jf, pf = _frames(cols)
    kw = dict(fitIntercept=fit_intercept, quantilesCol="q")
    a = JAFT(mesh=mesh8, **kw).fit(jf)
    b = AFTSurvivalRegression(device="cpu", **kw).fit(pf)
    assert b.summary.totalIterations == a.summary.totalIterations
    assert _hist_gap(b.summary.objectiveHistory,
                     a.summary.objectiveHistory) <= 1e-5
    assert _rel(b.coefficients, a.coefficients) <= 1e-4
    assert abs(b.scale / a.scale - 1.0) <= 1e-5
    # one model's predictions: the same float64 numpy
    b.coefficients, b.intercept, b.scale = (
        a.coefficients, a.intercept, a.scale)
    pa, pb = a.transform(jf), b.transform(pf)
    for c in ("prediction", "q"):
        np.testing.assert_array_equal(pa[c], pb[c])


def test_aft_refuses_what_the_jax_fit_refuses():
    cols = _aft_frame(n=50)
    bad_t = dict(cols, label=np.where(np.arange(50) == 3, 0.0,
                                      cols["label"]))
    bad_c = dict(cols, censor=np.full(50, 0.5))
    for est, F in ((JAFT(), JFrame), (AFTSurvivalRegression(device="cpu"),
                                      Frame)):
        with pytest.raises(ValueError, match="> 0"):
            est.fit(F(bad_t))
        with pytest.raises(ValueError, match="0.0 or 1.0"):
            est.fit(F(bad_c))


@pytest.mark.parametrize("kw", [
    {}, {"isotonic": False}, {"weightCol": "w"}, {"featureIndex": 1},
])
def test_isotonic_matches_the_jax_fit_bitwise(kw):
    rng = np.random.default_rng(4)
    x = np.round(rng.normal(size=(400, 2)), 1)  # ties, pooled first
    cols = {"features": x if "featureIndex" in kw else x[:, 0],
            "label": x[:, 0] + rng.normal(size=400),
            "w": np.where(rng.random(400) < 0.1, 0.0,
                          rng.uniform(0.5, 2.0, 400))}
    jf, pf = _frames(cols)
    a = JIsotonic(**kw).fit(jf)
    b = IsotonicRegression(device="cpu", **kw).fit(pf)
    np.testing.assert_array_equal(b.boundaries, a.boundaries)
    np.testing.assert_array_equal(b.predictions, a.predictions)
    np.testing.assert_array_equal(b.transform(pf)["prediction"],
                                  a.transform(jf)["prediction"])


def _glm_cases():
    out = [(fam, link, {}) for fam, links in _SUPPORTED.items()
           for link in links]
    out += [("tweedie", None, {"variancePower": 1.5}),
            ("tweedie", None, {"variancePower": 1.5, "linkPower": 0.0}),
            ("tweedie", None, {"variancePower": 0.0}),
            ("tweedie", None, {"variancePower": 1.0}),
            ("tweedie", None, {"variancePower": 2.0, "linkPower": 0.0}),
            ("gaussian", "identity", {"regParam": 0.1}),
            ("poisson", "log", {"fitIntercept": False})]
    return out


def _glm_target(family, link, eta, rng):
    """A target whose fit keeps μ inside the link's domain (the JAX fit
    NaNs out, and ``jax_debug_nans`` raises, where it leaves it)."""
    if family == "binomial":
        mu = {"logit": 1 / (1 + np.exp(-eta)),
              "probit": 0.5 * (1 + np.tanh(eta)),
              "cloglog": 1 - np.exp(-np.exp(eta - 0.5)),
              "log": np.exp(0.2 * np.tanh(eta) - 1.5)}[link]
        return (rng.random(len(eta)) < mu).astype(np.float32)
    if link in ("identity", "sqrt") and family in ("poisson", "gamma"):
        mu = 8.0 + np.tanh(eta)
    else:
        mu = np.exp(0.3 * eta + 1.0)
    if family in ("poisson", "tweedie"):
        return rng.poisson(mu).astype(np.float32)
    if family == "gamma":
        return (mu * rng.gamma(3.0, 1 / 3.0, len(eta))).astype(np.float32)
    base = 4.0 if link in ("log", "inverse") else 0.0
    return (eta + base + rng.normal(size=len(eta)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("family,link,kw", _glm_cases())
def test_glm_matches_the_jax_fit(mesh8, family, link, kw):
    X, eta, rng = _data(seed=5, n=1200, d=4)
    y = _glm_target(family, link, eta, rng)
    if family == "tweedie" and kw.get("variancePower") == 2.0:
        y = y + 1.0  # p >= 2 needs positive labels
    cols = {"features": X, "label": y}
    jf, pf = _frames(cols)
    params = dict(family=family, **kw)
    if link:
        params["link"] = link
    a = JGLM(mesh=mesh8, **params).fit(jf)
    b = GeneralizedLinearRegression(device="cpu", **params).fit(pf)
    assert b.getLink() == a.getLink()
    sa, sb = a.summary, b.summary
    # the stop test meets float32 noise once the fit has converged, so
    # the counts may part (binomial/probit: 10 against 7); both stop
    assert 0 < sb.totalIterations and 0 < sa.totalIterations
    coef_a = np.append(a.coefficients, a.intercept)
    coef_b = np.append(b.coefficients, b.intercept)
    assert _rel(coef_b, coef_a) <= 1e-4
    assert abs(sb.deviance / sa.deviance - 1) <= 1e-5
    assert abs(sb.nullDeviance / sa.nullDeviance - 1) <= 1e-5
    assert abs(sb.dispersion / sa.dispersion - 1) <= 1e-4
    assert sb.residualDegreeOfFreedom == sa.residualDegreeOfFreedom
    if family == "tweedie":
        for s in (sa, sb):
            with pytest.raises(ValueError, match="tweedie"):
                s.aic
    else:
        assert abs(sb.aic / sa.aic - 1) <= 1e-5
    # one model's predictions: the float32 link in two libraries
    m = GeneralizedLinearRegressionModel(
        coefficients=a.coefficients, intercept=a.intercept, device="cpu")
    m.setParams(**{k: v for k, v in a.paramValues().items()})
    m.setLinkPredictionCol("eta")
    a.setLinkPredictionCol("eta")
    pa, pb = a.transform(jf), m.transform(pf)
    for c in ("prediction", "eta"):
        np.testing.assert_allclose(pb[c], pa[c], rtol=1e-6, atol=1e-6)


def test_glm_aic_rounds_half_up_as_the_jax_package_does():
    """Binomial trial counts of half-integer weights: ``_aic`` is the JAX
    package's bitwise, counts rounded half up (floor(x + 0.5), Scala's
    ``math.round``), not numpy's half-to-even."""
    rng = np.random.default_rng(6)
    n = 400
    w = rng.integers(1, 6, n) + 0.5  # every weight a half-integer
    y = np.round(rng.random(n) * 2) / 2  # 0, 0.5 or 1
    mu = rng.uniform(0.05, 0.95, n)
    for fam, yy in (("binomial", y), ("poisson", np.floor(y * 7)),
                    ("gaussian", y), ("gamma", y + 1.0)):
        assert _aic(fam, yy, mu, w, n, 123.4, 3) == jax_aic(
            fam, yy, mu, w, n, 123.4, 3)
    # 2.5 trials count as 3, as Scala rounds them
    one = _aic("binomial", np.array([1.0]), np.array([0.5]),
               np.array([2.5]), 1, 1.0, 0)
    assert np.isclose(one, -2.0 * 3 * np.log(0.5))
    # and a whole binomial fit with half-integer weights
    X, eta, rng = _data(seed=7, n=800, d=3)
    cols = {"features": X, "label": (rng.random(800) < 1 / (1 + np.exp(
        -eta))).astype(np.float32),
        "w": (rng.integers(1, 4, 800) + 0.5).astype(np.float32)}
    jf, pf = _frames(cols)
    a = JGLM(family="binomial", weightCol="w").fit(jf)
    b = GeneralizedLinearRegression(device="cpu", family="binomial",
                                    weightCol="w").fit(pf)
    assert abs(b.summary.aic / a.summary.aic - 1) <= 1e-5


def test_glm_refuses_what_the_jax_fit_refuses():
    X, _, _ = _data(n=20, d=2)
    bad = [({"family": "gaussian", "link": "logit"}, np.ones(20)),
           ({"family": "tweedie", "link": "log"}, np.ones(20)),
           ({"family": "poisson"}, -np.ones(20)),
           ({"family": "gamma"}, np.zeros(20)),
           ({"family": "binomial"}, np.full(20, 2.0))]
    for params, y in bad:
        cols = {"features": X, "label": y.astype(np.float32)}
        for est, F in ((JGLM, JFrame), (GeneralizedLinearRegression, Frame)):
            kw = {} if est is JGLM else {"device": "cpu"}
            with pytest.raises(ValueError):
                est(**kw, **params).fit(F(cols))


@pytest.mark.parametrize("cls,solver,kw", [
    ("reg", "adamW", {}), ("clf", "adamW", {}), ("reg", "gd",
                                                 {"stepSize": 0.05}),
    ("clf", "adamW", {"fitLinear": False, "fitIntercept": False,
                      "regParam": 0.01}),
])
def test_fm_matches_the_optax_fit(mesh8, cls, solver, kw):
    X, eta, rng = _data(seed=8, n=1000, d=6)
    X = (X - X.mean(axis=0)) / X.std(axis=0)
    if cls == "clf":
        y = (rng.random(1000) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    else:
        y = (eta + X[:, 0] * X[:, 1] * 0.3).astype(np.float32)
    cols = {"features": X, "label": y}
    jf, pf = _frames(cols)
    params = dict(factorSize=4, maxIter=60, solver=solver, **kw)
    params.setdefault("stepSize", 0.05)
    J, P = (JFMClassifier, FMClassifier) if cls == "clf" else (
        JFMRegressor, FMRegressor)
    a = J(mesh=mesh8, **params).fit(jf)
    b = P(device="cpu", **params).fit(pf)
    assert b.summary.totalIterations == a.summary.totalIterations
    assert len(b.summary.objectiveHistory) == len(a.summary.objectiveHistory)
    assert _hist_gap(b.summary.objectiveHistory,
                     a.summary.objectiveHistory) <= 1e-5
    assert _rel(b.factors, a.factors) <= 1e-4
    if params.get("fitLinear", True):
        assert _rel(b.linear, a.linear) <= 1e-4
    pa, pb = a.transform(jf), b.transform(pf)
    if cls == "clf":
        agree = np.mean(pb["prediction"] == pa["prediction"])
        assert agree >= 0.999
        np.testing.assert_allclose(pb["probability"], pa["probability"],
                                   atol=1e-5)


def test_fm_stops_on_the_relative_loss_change(mesh8):
    X, eta, rng = _data(seed=9, n=500, d=4)
    X = (X - X.mean(axis=0)) / X.std(axis=0)
    cols = {"features": X, "label": eta.astype(np.float32)}
    jf, pf = _frames(cols)
    kw = dict(factorSize=2, maxIter=200, stepSize=0.05, tol=1e-3)
    a = JFMRegressor(mesh=mesh8, **kw).fit(jf)
    b = FMRegressor(device="cpu", **kw).fit(pf)
    assert 1 < b.summary.totalIterations == a.summary.totalIterations < 200
    assert len(b.summary.objectiveHistory) == b.summary.totalIterations + 1


def test_adam_update_is_optax_adamw_without_decay():
    rng = np.random.default_rng(10)
    p = {"V": rng.normal(size=(5, 3)).astype(np.float32),
         "b": np.float32(0.3)}
    opt = optax.adamw(jnp.float32(0.05), weight_decay=0.0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tstate = {"count": torch.zeros((), dtype=torch.int32),
              "mu": {k: torch.zeros_like(v) for k, v in tp.items()},
              "nu": {k: torch.zeros_like(v) for k, v in tp.items()}}
    for _ in range(25):
        g = {k: rng.normal(size=np.shape(v)).astype(np.float32)
             for k, v in p.items()}
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        tp = adam_update({k: torch.tensor(v) for k, v in g.items()},
                         tstate, tp, torch.tensor(np.float32(0.05)))
        for k in p:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_jax_saved_models_load_in_the_port(mesh8, tmp_path):
    X, eta, rng = _data(seed=11, n=600, d=3)
    y = (rng.random(600) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    jf = JFrame({"features": X, "label": y,
                 "censor": np.ones(600), "t": np.exp(eta) + 0.1})
    models = {
        "lr": JLR(mesh=mesh8).fit(jf),
        "glm": JGLM(mesh=mesh8, family="binomial").fit(jf),
        "aft": JAFT(mesh=mesh8, labelCol="t").fit(jf),
        "iso": JIsotonic(featureIndex=0).fit(jf),
        "fm": JFMClassifier(mesh=mesh8, maxIter=5).fit(jf),
    }
    pf = Frame({"features": X})
    for name, m in models.items():
        jax_save_model(m, str(tmp_path / name))
        back = load_model(str(tmp_path / name), device="cpu")
        for attr in ("coefficients", "boundaries", "predictions",
                     "factors", "linear"):
            if hasattr(m, attr):
                np.testing.assert_array_equal(getattr(back, attr),
                                              getattr(m, attr))
        out = back.transform(pf)
        assert np.isfinite(to_host(out["prediction"])).all()
    fm = load_model(str(tmp_path / "fm"), device="cpu")
    assert isinstance(fm, FMClassificationModel)
    assert not fm.has_device_serve()  # not a fused head, as in the JAX one
    glm = load_model(str(tmp_path / "glm"), device="cpu")
    assert glm.getLink() == "logit"
    # and the port's own save loads back
    save_model(glm, str(tmp_path / "p"))
    again = load_model(str(tmp_path / "p"), device="cpu")
    np.testing.assert_array_equal(again.coefficients, glm.coefficients)
