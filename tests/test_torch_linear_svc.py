"""The port's LinearSVC and the fused one-vs-rest LinearSVC and
LogisticRegression heads against the JAX package's, on the CPU.

Inputs: 2 997 clean CICIDS2017-schema rows from the JAX package's
synthetic generator (seed 3), label-indexed, assembled and scaled by the
JAX package, relabeled benign-vs-attack for the binary fits; the rows
of the four most frequent classes for the one-vs-rest heads.  Both
packages fit up to 100 LBFGS iterations at tol 1e-6.

The hinge is not smooth, and LBFGS on it stops where its line search or
its relative-improvement test says: two runs whose f32 sums differ part
once a kink is crossed at another iterate.  Tolerances, each with what
it measured here when set:

* where the optimum is well determined (regParam 1.0: the penalty
  dominates): iterations equal, the objective history within 1e-6 of
  the start at every iteration (6.0e-8; 1.8e-7 without an intercept),
  coefficients and intercept within 1e-4 (2.6e-7 and 7.5e-7; 5.8e-7
  without an intercept), predictions and the training summary's
  accuracy and areaUnderROC equal;
* regParam 1.0 with ``standardization=False`` (the penalty in the
  original space): 18 against 21 iterations, the history within 1e-6
  of the start for the first 10 iterations (1.2e-7), the end objectives
  within 1e-5 of it (1.4e-6), coefficients within 1e-3 (1.9e-4),
  predictions equal;
* the train command's regParam 1e-4: the history within 1e-6 of the
  start for the first 10 iterations (7.3e-7), then the paths part (6.0e-4
  at most); end objectives within 1e-4 of the start (8.2e-6),
  predictions equal on at least 99 % of rows (99.9 %), areaUnderROC
  within 1e-4 (4.0e-5);
* raw margins from the SAME parameters (the shared save format): within
  1e-12 of the sum of ``|x_j·coef_j|`` per row, both float64 products
  (relative to a margin near 0 the two sums' last bits part: 1.3e-11);
* the fused one-vs-rest heads (one f32 product in each package): within
  1e-5 relative of the JAX package's, and of the port's own per-model
  loop (float64 margins for LinearSVC).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import CICIDS2017_FEATURES
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import StandardScaler as JStandardScaler
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import LinearSVC as JLinearSVC
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu.models import OneVsRest as JOneVsRest
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import (
    LinearSVC,
    LinearSVCModel,
    LogisticRegressionModel,
    OneVsRest,
    OneVsRestModel,
)
from sntc_tpu_torch.models.linear_svc import svc_loss
from sntc_tpu_torch.models.one_vs_rest import _build_fused_ovr
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

HEAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    raw = jax_clean_flows(jax_generate_frame(3000, seed=3))
    jf = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="rawFeatures"),
    ]).fit(raw).transform(raw)
    X = np.asarray(jf["rawFeatures"])
    y = np.asarray(jf["label"])
    Xs = np.asarray(JStandardScaler(
        inputCol="rawFeatures", outputCol="f", withMean=True,
    ).fit(JFrame({"rawFeatures": X})).transform(
        JFrame({"rawFeatures": X}))["f"]).astype(np.float32)
    keep = y < 4
    return {"binary": (Xs, (y > 0).astype(np.float64)),
            "ovr": (Xs[keep], y[keep].astype(np.float64))}


def _fit_both(X, y, **params):
    jm = JLinearSVC(maxIter=100, **params).fit(
        JFrame({"features": X, "label": y}))
    pm = LinearSVC(device="cpu", maxIter=100, **params).fit(
        Frame({"features": X, "label": y}))
    return jm, pm


def _history_gap(jm, pm) -> np.ndarray:
    hj = np.asarray(jm.summary.objectiveHistory)
    hp = np.asarray(pm.summary.objectiveHistory)
    n = min(len(hj), len(hp))
    return np.abs(hj[:n] - hp[:n]) / hj[0]


@pytest.mark.parametrize("params", [
    {"regParam": 1.0},
    {"regParam": 1.0, "fitIntercept": False},
], ids=["reg1", "reg1-no-intercept"])
def test_fit_matches_where_the_optimum_is_well_determined(data, params):
    X, y = data["binary"]
    jm, pm = _fit_both(X, y, **params)
    assert pm.summary.totalIterations == jm.summary.totalIterations
    assert _history_gap(jm, pm).max() <= 1e-6
    np.testing.assert_allclose(pm.coefficients, jm.coefficients, atol=1e-4)
    assert abs(pm.intercept - jm.intercept) <= 1e-4
    np.testing.assert_array_equal(pm.predict(X), jm.predict(X))
    assert pm.summary.accuracy == jm.summary.accuracy
    assert pm.summary.areaUnderROC == jm.summary.areaUnderROC
    assert pm.optimizer_stats["iterations"] == pm.summary.totalIterations


def test_fit_with_the_penalty_in_the_original_space(data):
    X, y = data["binary"]
    jm, pm = _fit_both(X, y, regParam=1.0, standardization=False)
    gap = _history_gap(jm, pm)
    assert gap[:11].max() <= 1e-6
    end = abs(jm.summary.objectiveHistory[-1]
              - pm.summary.objectiveHistory[-1])
    assert end <= 1e-5 * jm.summary.objectiveHistory[0]
    np.testing.assert_allclose(pm.coefficients, jm.coefficients, atol=1e-3)
    np.testing.assert_array_equal(pm.predict(X), jm.predict(X))


def test_fit_at_the_train_commands_reg_param(data):
    X, y = data["binary"]
    jm, pm = _fit_both(X, y, regParam=1e-4)
    assert _history_gap(jm, pm)[:11].max() <= 1e-6
    end = abs(jm.summary.objectiveHistory[-1]
              - pm.summary.objectiveHistory[-1])
    assert end <= 1e-4 * jm.summary.objectiveHistory[0]
    assert np.mean(pm.predict(X) == jm.predict(X)) >= 0.99
    assert abs(pm.summary.areaUnderROC - jm.summary.areaUnderROC) <= 1e-4


def _jax_svc_loss(theta, xc, y_signed, ws, inv_std, reg, pen_l2):
    """The JAX package's hinge objective (``_svc_optimize``'s loss, with
    an intercept), written out here: the reference keeps it inside its
    jitted fit."""
    d = xc.shape[1]
    margins = xc @ (theta[:d] * inv_std) + theta[d]
    hinge = jnp.maximum(0.0, 1.0 - y_signed * margins)
    return (jnp.sum(ws * hinge) / jnp.sum(ws)
            + 0.5 * reg * jnp.sum(pen_l2 * theta[:d] ** 2))


def test_hinge_gradient_at_the_kink_is_the_jax_packages():
    """Rows whose margin is exactly 1 on their side: the hinge's kink.
    ``jnp.maximum`` and ``torch.maximum`` split the gradient there (½);
    ``clamp`` and ``relu`` would not, and the LBFGS paths would part."""
    rng = np.random.default_rng(0)
    xc = rng.integers(-3, 4, (64, 5)).astype(np.float32)
    theta = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    y_signed = np.where(xc[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    xc[:8, 0] = y_signed[:8]  # margin y·m == 1 on eight rows
    ws = np.ones(64, np.float32)
    inv_std = np.ones(5, np.float32)
    pen = np.ones(5, np.float32)
    jv, jg = jax.value_and_grad(_jax_svc_loss)(
        jnp.asarray(theta), jnp.asarray(xc), jnp.asarray(y_signed),
        jnp.asarray(ws), jnp.asarray(inv_std), 0.5, jnp.asarray(pen))
    t = torch.from_numpy(theta).requires_grad_(True)
    pv = svc_loss(t, torch.from_numpy(xc), torch.from_numpy(y_signed),
                  torch.from_numpy(ws), torch.tensor(64.0),
                  torch.from_numpy(inv_std), 0.5, torch.from_numpy(pen),
                  fit_intercept=True)
    (pg,) = torch.autograd.grad(pv, t)
    assert float(pv) == float(jv)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    # relu's gradient at the kink is 0, not the ½ both packages take
    m = torch.tensor([0.0], requires_grad=True)
    (g_max,) = torch.autograd.grad(torch.maximum(torch.zeros(1), m), m)
    (g_relu,) = torch.autograd.grad(torch.relu(m), m)
    assert float(g_max) == 0.5 and float(g_relu) == 0.0


def test_raw_margins_from_the_same_parameters(data, tmp_path):
    X, y = data["binary"]
    jm = JLinearSVC(maxIter=20, regParam=1e-2).fit(
        JFrame({"features": X, "label": y}))
    jax_save_model(jm, str(tmp_path / "jax"))
    pm = load_model(str(tmp_path / "jax"), device="cpu")
    assert isinstance(pm, LinearSVCModel)
    # a float64 product's bound: 1e-12 of the sum of |x_j · coef_j|
    scale = (np.abs(X.astype(np.float64)) @ np.abs(jm.coefficients)
             + abs(jm.intercept))
    for Xin in (X, X.astype(np.float64), torch.from_numpy(X)):
        jo = jm.transform(JFrame({"features": np.asarray(Xin)}))
        po = pm.transform(Frame({"features": Xin}))
        assert "probability" not in po.columns
        assert po["rawPrediction"].dtype == np.float64
        gap = np.abs(po["rawPrediction"] - np.asarray(jo["rawPrediction"]))
        assert (gap <= 1e-12 * scale[:, None]).all()
        np.testing.assert_array_equal(po["prediction"],
                                      np.asarray(jo["prediction"]))
    pm.setParams(threshold=0.25)
    jm.setParams(threshold=0.25)
    np.testing.assert_array_equal(pm.predict(X), jm.predict(X))
    save_model(pm, str(tmp_path / "port"))
    back = jax_load_model(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.coefficients, jm.coefficients)
    assert back.intercept == jm.intercept and back.getThreshold() == 0.25


@pytest.fixture(scope="module")
def ovr_models(data, tmp_path_factory):
    """JAX one-vs-rest fits over LinearSVC and binomial LR, saved and
    loaded into the port."""
    X, y = data["ovr"]
    root = tmp_path_factory.mktemp("ovr")
    out = {}
    for name, clf in (("svc", JLinearSVC(maxIter=30, regParam=1e-3)),
                      ("lr", JLR(maxIter=30, regParam=1e-3,
                                 family="binomial"))):
        jm = JOneVsRest(classifier=clf).fit(
            JFrame({"features": X, "label": y}))
        jax_save_model(jm, str(root / name))
        out[name] = (jm, load_model(str(root / name), device="cpu"))
    return out


@pytest.mark.parametrize("name,sub", [("svc", LinearSVCModel),
                                      ("lr", LogisticRegressionModel)])
def test_fused_ovr_heads_match_the_jax_package(data, ovr_models, name, sub):
    X, _ = data["ovr"]
    jm, pm = ovr_models[name]
    assert isinstance(pm, OneVsRestModel)
    assert all(isinstance(m, sub) for m in pm.models)
    fused = pm._fused_raw()
    assert fused is not None
    want = np.asarray(jm._raw_predict(X))
    got = fused(X).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=HEAD_RTOL,
                               atol=HEAD_RTOL * np.abs(want).max())
    # the port's per-model loop (float64 margins for LinearSVC)
    loop = np.stack([m._raw_predict(X)[:, 1].numpy() for m in pm.models], 1)
    np.testing.assert_allclose(got, loop, rtol=HEAD_RTOL,
                               atol=HEAD_RTOL * np.abs(loop).max())
    # transform casts the features to f32 first, as the JAX package does
    jo = jm.transform(JFrame({"features": X.astype(np.float64)}))
    po = pm.transform(Frame({"features": X.astype(np.float64)}))
    np.testing.assert_array_equal(
        po["rawPrediction"], pm.transform(Frame({"features": X}))[
            "rawPrediction"])
    clear = np.sort(want, 1)[:, -1] - np.sort(want, 1)[:, -2] > 1e-4
    np.testing.assert_array_equal(po["prediction"][clear],
                                  np.asarray(jo["prediction"])[clear])
    assert _build_fused_ovr([]) is None


def test_ovr_linear_svc_fit_matches_the_jax_package(data):
    """One LinearSVC fit per class, one after another, in both
    packages, at regParam 1.0.  Three classes stop at the same iteration
    in both, their coefficients and intercepts within 1e-4 (3.2e-6 at
    most); class 2 stops at 19 against 22, within 1e-3 (8.9e-4).
    Predictions equal."""
    X, y = data["ovr"]
    jm = JOneVsRest(classifier=JLinearSVC(maxIter=100, regParam=1.0)).fit(
        JFrame({"features": X, "label": y}))
    pm = OneVsRest(classifier=LinearSVC(device="cpu", maxIter=100,
                                        regParam=1.0)).fit(
        Frame({"features": X, "label": y}))
    assert len(pm.models) == len(jm.models) == 4
    same_path = 0
    for a, b in zip(pm.models, jm.models):
        tol = 1e-3
        if a.summary.totalIterations == b.summary.totalIterations:
            tol = 1e-4
            same_path += 1
        np.testing.assert_allclose(a.coefficients, b.coefficients, atol=tol)
        assert abs(a.intercept - b.intercept) <= tol
    assert same_path >= 3
    np.testing.assert_array_equal(
        pm.transform(Frame({"features": X}))["prediction"],
        np.asarray(jm.transform(JFrame({"features": X}))["prediction"]))


def test_binary_only_and_defaults_to_cuda(data, monkeypatch):
    X, y = data["ovr"]
    with pytest.raises(ValueError, match="binary-only"):
        LinearSVC(device="cpu").fit(Frame({"features": X, "label": y}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearSVC()
