"""The host-serve crossover of the port's MLP and LR heads against the
JAX package's, on the CPU.

A head with a host path serves host features of at most
``SNTC_SERVE_HOST_ROWS`` rows in numpy, from ``transform`` and
``transform_async`` (unset: the head's ``HOST_SERVE_ROWS``, set from the
H100 readings: 65 536 for the LR, 64 for the MLP); a larger batch
dispatches its device program; a fused segment never consults the rule.

* The host paths on the same weights equal the JAX package's host paths
  bitwise (the same numpy operations: the LR's float32 product and
  sigmoid/softmax, the MLP's float64 forward pass);
* the threshold, both sides of it: at the threshold no device program
  runs (``_predict_all_dev`` is not called, nothing is copied), one row
  above it the device program runs, at a set value and at the head's
  default alike; 0 serves every batch on the device;
* the host and device placements agree: predictions equal on every row
  of these inputs, probabilities within 1e-6 (the LR: float32 numpy
  against float32 torch, 1.2e-7 measured; the MLP: float64 against
  float32, 4.2e-7 measured);
* a fused segment at a small batch still dispatches its device program;
* features already in a tensor (a batch ``pad_assemble`` padded, a
  stage's device output) dispatch the device program at any size: the
  one copy is the packed output's (recorded in the transfer ledger), no
  round trip of the features; through a ``BatchPredictor`` a padded
  batch dispatches, a host batch that fills its bucket does not.
"""

import numpy as np
import pytest
import torch

from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu.models import MultilayerPerceptronClassifier as JMLP
from sntc_tpu_torch.core.base import Pipeline
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.feature import MinMaxScaler
from sntc_tpu_torch.fuse import compile_pipeline, fused_segments
from sntc_tpu_torch.models import MultilayerPerceptronClassifier
from sntc_tpu_torch.models.logistic_regression import LogisticRegressionModel
from sntc_tpu_torch.models.mlp import MultilayerPerceptronClassificationModel
from sntc_tpu_torch.models.naive_bayes import NaiveBayes
from sntc_tpu_torch.serve import BatchPredictor
from sntc_tpu_torch.utils.profiling import TransferLedger, ledger_scope
from jax_metrics_guard import own_jax_registry  # noqa: F401

D = 7
# each head's HOST_SERVE_ROWS, set from the H100 readings
DEFAULT_ROWS = {"lr": 65536, "mlp": 64}
COLS = ("rawPrediction", "probability", "prediction")


def _data(n=400, k=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 2.0, size=(n, D)).astype(np.float32)
    w = rng.normal(size=(D, k))
    y = np.argmax(X @ w + rng.normal(0, 0.5, size=(n, k)), axis=1)
    return X, y.astype(np.float64)


def _fitted(kind, k):
    X, y = _data(k=k)
    cols = {"features": X, "label": y}
    if kind == "lr":
        jm = JLR(maxIter=30, regParam=1e-3).fit(JFrame(cols))
        pm = LogisticRegressionModel(
            np.asarray(jm.coefficientMatrix), np.asarray(jm.interceptVector),
            jm.is_binomial, device="cpu")
    else:
        jm = JMLP(layers=[D, 6, k], maxIter=30, seed=1).fit(JFrame(cols))
        pm = MultilayerPerceptronClassificationModel(
            np.asarray(jm.weights), [D, 6, k], device="cpu")
    pm.setParams(**{p: v for p, v in jm.paramValues().items()
                    if pm.hasParam(p)})
    return X, jm, pm


class _Count:
    """Counts the device program's calls on one model instance."""

    def __init__(self, model):
        self.n = 0
        fn = model._predict_all_dev

        def counting(X):
            self.n += 1
            return fn(X)

        model._predict_all_dev = counting


@pytest.mark.parametrize("kind,k", [("lr", 2), ("lr", 4), ("mlp", 3)])
def test_host_path_equals_the_jax_host_path(kind, k, monkeypatch):
    # the JAX package's default crossover, so that both serve on the host
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "16384")
    X, jm, pm = _fitted(kind, k)
    raw, prob = pm._predict_raw_prob_host(X)
    jraw, jprob = jm._predict_raw_prob_host(X)
    for got, want in ((raw, jraw), (prob, jprob)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    out = pm.transform(Frame({"features": X}))
    jout = jm.transform(JFrame({"features": X}))
    for c in COLS:
        np.testing.assert_array_equal(to_host(out[c]), np.asarray(jout[c]),
                                      err_msg=c)


@pytest.mark.parametrize("kind,k", [("lr", 2), ("mlp", 3)])
def test_crossover_threshold_both_sides(kind, k, monkeypatch):
    X, _jm, pm = _fitted(kind, k)
    count = _Count(pm)
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "100")
    led = TransferLedger()
    with ledger_scope(led):
        at = pm.transform(Frame({"features": X[:100]}))
        pm.transform_async(Frame({"features": X[:100]}))()
    assert count.n == 0
    assert led.snapshot()["uploads"] == led.snapshot()["downloads"] == 0
    above = pm.transform(Frame({"features": X[:101]}))
    assert count.n == 1
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    dev = pm.transform(Frame({"features": X[:100]}))
    assert count.n == 2
    # unset, the head's own default, both sides of it
    monkeypatch.delenv("SNTC_SERVE_HOST_ROWS")
    rows = type(pm).HOST_SERVE_ROWS
    assert pm._host_serve_rows() == rows == DEFAULT_ROWS[kind]
    tiled = np.tile(X, (rows // len(X) + 2, 1))
    pm.transform(Frame({"features": tiled[:rows]}))
    assert count.n == 2
    pm.transform(Frame({"features": tiled[: rows + 1]}))
    assert count.n == 3
    # the two placements agree
    np.testing.assert_array_equal(to_host(at["prediction"]),
                                  to_host(dev["prediction"]))
    np.testing.assert_allclose(to_host(at["probability"]),
                               to_host(dev["probability"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(to_host(above["prediction"])[:100],
                                  to_host(dev["prediction"]))


def test_heads_without_a_host_path_keep_the_device_program(monkeypatch):
    monkeypatch.delenv("SNTC_SERVE_HOST_ROWS", raising=False)
    X, y = _data(k=3)
    nb = NaiveBayes(device="cpu", modelType="gaussian").fit(
        Frame({"features": np.abs(X), "label": y}))
    assert not nb.has_host_serve()
    count = _Count(nb)
    nb.transform(Frame({"features": np.abs(X[:10])}))
    assert count.n == 1
    _X, _jm, lr = _fitted("lr", 2)
    assert lr.has_host_serve()


def test_fused_segment_does_not_consult_the_crossover(monkeypatch):
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "16384")
    X, y = _data(k=2)
    pm = Pipeline(stages=[
        MinMaxScaler(device="cpu", inputCol="raw", outputCol="mm"),
        MultilayerPerceptronClassifier(device="cpu", layers=[D, 5, 2],
                                       maxIter=10, featuresCol="mm"),
    ]).fit(Frame({"raw": X, "label": y}))
    fused = compile_pipeline(pm)
    (seg,) = fused_segments(fused)
    assert seg.fused_stages[-1].has_host_serve()
    count = _Count(seg._head)
    fused.transform(Frame({"raw": X[:50]}))
    assert count.n == 1
    staged = _Count(pm.getStages()[-1])
    pm.transform(Frame({"raw": X[:50]}))
    assert staged.n == 0


def test_device_features_are_copied_once(monkeypatch):
    monkeypatch.delenv("SNTC_SERVE_HOST_ROWS", raising=False)
    X, _jm, pm = _fitted("lr", 2)
    count = _Count(pm)
    led = TransferLedger()
    with ledger_scope(led):
        out = pm.transform(Frame({"features": torch.from_numpy(X)}))
    assert count.n == 1
    snap = led.snapshot()
    assert (snap["uploads"], snap["downloads"]) == (0, 1)
    assert snap["download_bytes"] == X.shape[0] * (2 * 2 + 1) * 4
    np.testing.assert_array_equal(
        to_host(out["prediction"]),
        to_host(pm.transform(Frame({"features": X}))["prediction"]))


def test_padded_batches_stay_on_the_device(monkeypatch):
    monkeypatch.delenv("SNTC_SERVE_HOST_ROWS", raising=False)
    X, _jm, pm = _fitted("lr", 2)
    count = _Count(pm)
    pred = BatchPredictor(pm, bucket_rows=256, device="cpu")
    padded = pred.predict_frame(Frame({"features": X[:100]}))
    assert count.n == 1 and padded.num_rows == 100
    full = pred.predict_frame(Frame({"features": X[:256]}))
    assert count.n == 1 and full.num_rows == 256
    np.testing.assert_array_equal(to_host(padded["prediction"]),
                                  to_host(full["prediction"])[:100])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k", [("lr", 2), ("mlp", 3)])
def test_crossover_on_the_card(kind, k, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, jm, _ = _fitted(kind, k)
    pm = (LogisticRegressionModel(np.asarray(jm.coefficientMatrix),
                                  np.asarray(jm.interceptVector),
                                  jm.is_binomial, device="cuda")
          if kind == "lr" else
          MultilayerPerceptronClassificationModel(
              np.asarray(jm.weights), [D, 6, k], device="cuda"))
    count = _Count(pm)
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "16384")
    host = pm.transform(Frame({"features": X}))
    assert count.n == 0
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    card = pm.transform(Frame({"features": X}))
    assert count.n == 1
    np.testing.assert_array_equal(to_host(host["prediction"]),
                                  to_host(card["prediction"]))
    np.testing.assert_allclose(to_host(host["probability"]),
                               to_host(card["probability"]), rtol=0,
                               atol=1e-5)
