"""The port's NaiveBayes against the JAX package's, on the CPU.

Inputs: 2 997 clean CICIDS2017-schema rows from the JAX package's
synthetic generator (seed 3), label-indexed and assembled by the JAX
package (78 features, 14 classes), for the gaussian type; the same rows
with five features scaled to maxima of 1e8 (flow-duration scale) for
the flow-scale case; and numpy-seeded counts (Poisson) and 0/1 flags for
the discrete types.

Tolerances, each with what it measured here when set:

* class weights and priors: exact (unit-weight counts are exact in any
  f32 order);
* gaussian means and variances: within 2e-5 relative (the JAX package
  sums per shard of an 8-device mesh, the port once: 1.4e-6 on the
  means, 3.6e-7 on the variances, 1.9e-7 at flow scale);
* gaussian raw scores from the SAME parameters (carried across by the
  shared save format): within 1e-12 relative, both sides float64
  (1.8e-15, 8.1e-16 at flow scale); predictions equal wherever the top two raw scores differ
  by more than that (everywhere);
* discrete types: θ and bias bitwise (integer sums), served raw scores
  within 1e-5 of the largest (one f32 product in two libraries: 4.6e-5
  absolute on raw scores of magnitude ~100), probabilities within 1e-4
  relative (5.2e-5).
"""

import numpy as np
import pytest
import torch

from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import CICIDS2017_FEATURES
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import NaiveBayes as JNaiveBayes
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import NaiveBayes, NaiveBayesModel
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

MOMENT_RTOL = 2e-5
RAW_RTOL = 1e-12
F32_RTOL = 1e-5


@pytest.fixture(scope="module")
def flows():
    raw = jax_clean_flows(jax_generate_frame(3000, seed=3))
    jf = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="features"),
    ]).fit(raw).transform(raw)
    X = np.asarray(jf["features"]).astype(np.float32)
    y = np.asarray(jf["label"]).astype(np.float64)
    scaled = X.copy()
    # five features brought to flow-duration scale: maxima of 1e8
    scaled[:, :5] *= (1e8 / np.abs(X[:, :5]).max(axis=0)).astype(np.float32)
    return {"cicids": (X, y), "flow-scale": (scaled, y)}


def _fit_both(X, y, **params):
    jm = JNaiveBayes(**params).fit(JFrame({"features": X, "label": y}))
    pm = NaiveBayes(device="cpu", **params).fit(
        Frame({"features": X, "label": y}))
    return jm, pm


def _discrete_data(model_type: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.poisson(3.0, size=(2000, 20)).astype(np.float32)
    if model_type == "bernoulli":
        X = (X > 3).astype(np.float32)
    y = rng.integers(0, 4, 2000).astype(np.float64)
    return X, y


def _clear_rows(raw: np.ndarray, rtol: float) -> np.ndarray:
    s = np.sort(raw, axis=1)
    return s[:, -1] - s[:, -2] > rtol * np.abs(s[:, -1])


@pytest.mark.parametrize("case", ["cicids", "flow-scale"])
def test_gaussian_fit_matches_the_jax_package(flows, case):
    X, y = flows[case]
    jm, pm = _fit_both(X, y, modelType="gaussian")
    assert pm.num_classes == jm.num_classes == len(np.unique(y))
    np.testing.assert_array_equal(pm.pi, jm.pi)
    assert pm.theta is None and pm.bias is None
    np.testing.assert_allclose(pm.gaussian_mu, jm.gaussian_mu,
                               rtol=MOMENT_RTOL, atol=1e-30)
    np.testing.assert_allclose(pm.gaussian_var, jm.gaussian_var,
                               rtol=MOMENT_RTOL)
    if case == "flow-scale":
        assert float(np.abs(X).max()) >= 1e8 * (1 - 1e-6)


@pytest.mark.parametrize("case", ["cicids", "flow-scale"])
def test_gaussian_raw_scores_from_the_same_parameters(flows, case, tmp_path):
    X, y = flows[case]
    jm = JNaiveBayes(modelType="gaussian").fit(
        JFrame({"features": X, "label": y}))
    jax_save_model(jm, str(tmp_path / "jax"))
    pm = load_model(str(tmp_path / "jax"), device="cpu")
    assert isinstance(pm, NaiveBayesModel)
    jo = jm.transform(JFrame({"features": X}))
    po = pm.transform(Frame({"features": X}))
    a = np.asarray(jo["rawPrediction"])
    b = po["rawPrediction"]
    assert b.dtype == np.float64 and b.shape == (len(X), jm.num_classes)
    np.testing.assert_allclose(b, a, rtol=RAW_RTOL)
    np.testing.assert_allclose(po["probability"],
                               np.asarray(jo["probability"]),
                               rtol=0, atol=1e-12)
    clear = _clear_rows(a, RAW_RTOL)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(po["prediction"][clear],
                                  np.asarray(jo["prediction"])[clear])
    # and back: the port's save loads into the JAX package
    save_model(pm, str(tmp_path / "port"))
    back = jax_load_model(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.gaussian_var, jm.gaussian_var)
    np.testing.assert_array_equal(
        np.asarray(back.transform(JFrame({"features": X}))["prediction"]),
        np.asarray(jo["prediction"]))


@pytest.mark.parametrize("model_type",
                         ["multinomial", "complement", "bernoulli"])
def test_discrete_fit_and_serve_match_the_jax_package(model_type):
    X, y = _discrete_data(model_type)
    jm, pm = _fit_both(X, y, modelType=model_type, smoothing=0.5)
    np.testing.assert_array_equal(pm.theta, jm.theta)
    np.testing.assert_array_equal(pm.bias, jm.bias)
    np.testing.assert_array_equal(pm.pi, jm.pi)
    jo = jm.transform(JFrame({"features": X}))
    po = pm.transform(Frame({"features": X}))
    a = np.asarray(jo["rawPrediction"])
    assert po["rawPrediction"].dtype == np.float32
    np.testing.assert_allclose(po["rawPrediction"], a, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(a).max())
    np.testing.assert_allclose(po["probability"],
                               np.asarray(jo["probability"]), rtol=1e-4)
    clear = _clear_rows(a, 1e-4)
    np.testing.assert_array_equal(po["prediction"][clear],
                                  np.asarray(jo["prediction"])[clear])


def test_binary_threshold_and_class_thresholds_as_the_jax_package(flows):
    X, y = flows["cicids"]
    yb = (y > 0).astype(np.float64)
    jm, pm = _fit_both(X, yb, modelType="gaussian")
    for params in ({"threshold": 0.3}, {"thresholds": [0.7, 0.3]},
                   {"thresholds": [0.0, 1.0]}):
        jm.setParams(**params)
        pm.setParams(**params)
        np.testing.assert_array_equal(
            pm.transform(Frame({"features": X}))["prediction"],
            np.asarray(jm.transform(JFrame({"features": X}))["prediction"]))


def test_features_are_validated_and_gaussian_has_no_fusible_program():
    X, y = _discrete_data("multinomial")
    with pytest.raises(ValueError, match="non-negative"):
        NaiveBayes(device="cpu", modelType="complement").fit(
            Frame({"features": X - 5, "label": y}))
    with pytest.raises(ValueError, match="0/1"):
        NaiveBayes(device="cpu", modelType="bernoulli").fit(
            Frame({"features": X, "label": y}))
    disc = NaiveBayes(device="cpu").fit(Frame({"features": X, "label": y}))
    gauss = NaiveBayes(device="cpu", modelType="gaussian").fit(
        Frame({"features": X, "label": y}))
    jgauss = JNaiveBayes(modelType="gaussian").fit(
        JFrame({"features": X, "label": y}))
    assert disc.has_device_serve()
    assert not gauss.has_device_serve() and not jgauss.has_device_serve()
    # the gaussian head still serves a tensor column on its device
    out = gauss.transform(Frame({"features": torch.from_numpy(X)}))
    np.testing.assert_array_equal(
        out["prediction"], gauss.transform(Frame({"features": X}))["prediction"])


def test_estimator_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NaiveBayes()
