"""The fusible feature stages, VectorIndexer and the supervised
estimators of ``test_torch_feature_extra.py`` and
``test_torch_regression.py`` on the card against the port on the CPU.

Every test here needs a CUDA device (``-m cuda``) and skips without one;
the file imports no JAX.  Inputs are numpy-seeded.  Tolerances:

* VectorSlicer, ElementwiseProduct, PolynomialExpansion (40 columns,
  degree 2), Interaction, Bucketizer, VectorIndexer (fit and transform)
  and their fused segment, bucket-padded by ``pad_assemble``: bitwise
  (gathers, ``searchsorted`` lookups, exact float64 and float32
  products);
* the fits, card against CPU, at the CPU tests' tolerances: the normal
  solver's coefficients within 1e-5 of the largest; the LBFGS fits'
  (elastic-net LR, AFT) and the FM's objective histories within 1e-5 of
  their start; the GLMs' coefficients within 1e-4 of the largest and
  their deviances within 1e-5.
"""

import numpy as np
import pytest
import torch

from sntc_tpu_torch.core.base import PipelineModel
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.feature import (
    Bucketizer,
    ElementwiseProduct,
    Interaction,
    PolynomialExpansion,
    VectorAssembler,
    VectorIndexer,
    VectorSlicer,
)
from sntc_tpu_torch.fuse import compile_pipeline, fused_segments
from sntc_tpu_torch.kernels import LAUNCHES, reset_launches
from sntc_tpu_torch.models import (
    AFTSurvivalRegression,
    FMClassifier,
    FMRegressor,
    GeneralizedLinearRegression,
    LinearRegression,
    LogisticRegression,
)
from sntc_tpu_torch.serve import BatchPredictor

_SPLITS = [-np.inf, -1.0, 0.0, 0.5, np.inf]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    a, b = to_host(a), to_host(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = max(len(a), len(b))
    a = np.concatenate([a, np.repeat(a[-1:], n - len(a))])
    b = np.concatenate([b, np.repeat(b[-1:], n - len(b))])
    return float(np.abs(a - b).max() / abs(b[0]))


@pytest.mark.cuda
def test_feature_stages_on_the_card_equal_the_cpu(card):
    rng = np.random.default_rng(0)
    X = (rng.lognormal(size=(4097, 40)) * 1e3).astype(np.float32)
    v = rng.normal(size=4097)
    v[[5, 70]] = np.nan
    cols = {"x": X, "v": v}
    on_card = {"x": torch.from_numpy(X).to(card),
               "v": torch.from_numpy(v).to(card)}
    stages = [
        VectorSlicer(inputCol="x", outputCol="s", indices=[39, 0, 7, 7]),
        ElementwiseProduct(inputCol="x", outputCol="e",
                           scalingVec=list(rng.normal(size=40))),
        PolynomialExpansion(inputCol="x", outputCol="p", degree=2),
        Interaction(inputCols=["v", "x"], outputCol="i"),
        Bucketizer(inputCol="v", outputCol="b", splits=_SPLITS,
                   handleInvalid="keep"),
    ]
    for stage in stages:
        out = stage.getOutputCol()
        _same(stage.transform(Frame(cols))[out],
              stage.transform(Frame(on_card))[out])
    skip = Bucketizer(inputCol="v", outputCol="b", splits=_SPLITS,
                      handleInvalid="skip")
    a, b = skip.transform(Frame(cols)), skip.transform(Frame(on_card))
    assert a.num_rows == b.num_rows == 4095
    _same(a["b"], b["b"])
    with pytest.raises(ValueError, match="NaN"):
        Bucketizer(inputCol="v", outputCol="b",
                   splits=_SPLITS).transform(Frame(on_card))


@pytest.mark.cuda
def test_vector_indexer_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(1)
    X = np.round(rng.normal(size=(50_000, 12)) * np.arange(1, 13)).astype(
        np.float32)
    X[7, 0] = np.nan
    a = VectorIndexer(device="cpu", maxCategories=16).fit(
        Frame({"features": X}))
    b = VectorIndexer(device=card, maxCategories=16).fit(
        Frame({"features": X}))
    assert sorted(a.categoryMaps) == sorted(b.categoryMaps)
    for j in a.categoryMaps:
        np.testing.assert_array_equal(a.categoryMaps[j], b.categoryMaps[j])
    for mode in ("keep", "skip"):
        a.setHandleInvalid(mode)
        host = a.transform(Frame({"features": X}))
        dev = a.transform(Frame({"features": torch.from_numpy(X).to(card)}))
        _same(host["indexed"], dev["indexed"])


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_rows", [0, 256])
def test_fused_segment_on_the_card_equals_the_staged_cpu(card, bucket_rows,
                                                       monkeypatch):
    # the staged head on the card too (not the host-serve crossover)
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    rng = np.random.default_rng(2)
    n = 1000
    cols = {f"c{i}": rng.lognormal(size=n) * (i + 1) for i in range(12)}
    cols["dur"] = rng.lognormal(size=n) * 1e4
    y = (cols["c0"] > np.median(cols["c0"])).astype(np.float64)
    frame = Frame(dict(cols, label=y))
    stages = [
        VectorAssembler(inputCols=[f"c{i}" for i in range(12)],
                        outputCol="raw", handleInvalid="keep"),
        VectorSlicer(inputCol="raw", outputCol="sl", indices=[0, 3, 7]),
        PolynomialExpansion(inputCol="sl", outputCol="poly", degree=2),
        Bucketizer(inputCol="dur", outputCol="db", splits=[
            -np.inf, 5e3, 1e4, 2e4, np.inf], handleInvalid="keep"),
        Interaction(inputCols=["db", "poly"], outputCol="features"),
    ]
    feats = PipelineModel(stages=stages)
    head = LogisticRegression(device=card, maxIter=10).fit(
        feats.transform(frame))
    pm = PipelineModel(stages=stages + [head])
    fused = compile_pipeline(pm)
    (seg,) = fused_segments(fused)
    assert len(seg.fused_stages) == 5
    serve = Frame(cols)
    cpu_feats = feats.transform(serve)["features"]
    reset_launches()
    out = BatchPredictor(fused, bucket_rows=bucket_rows,
                         device=card).predict_frame(serve)
    staged = BatchPredictor(pm, bucket_rows=bucket_rows,
                            device=card).predict_frame(serve)
    assert LAUNCHES["pad_assemble"] == (2 if bucket_rows else 0)
    for c in ("rawPrediction", "probability", "prediction"):
        _same(out[c], staged[c])
    with_feats = compile_pipeline(pm, keep=["features"])
    got = BatchPredictor(with_feats, bucket_rows=bucket_rows,
                         device=card).predict_frame(serve)["features"]
    _same(cpu_feats, got)


def _data(seed=3, n=20_000, d=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    eta = X @ (rng.normal(size=d) * 0.4)
    return X, eta, rng


@pytest.mark.cuda
def test_linear_regression_and_aft_on_the_card_track_the_cpu(card):
    X, eta, rng = _data()
    f = Frame({"features": X, "label": (eta + 1.0 + rng.normal(
        size=len(X)) * 0.3).astype(np.float32)})
    a = LinearRegression(device="cpu", solver="normal").fit(f)
    b = LinearRegression(device=card, solver="normal").fit(f)
    assert _rel(b.coefficients, a.coefficients) <= 1e-5
    kw = dict(regParam=0.05, elasticNetParam=0.5)
    a = LinearRegression(device="cpu", **kw).fit(f)
    b = LinearRegression(device=card, **kw).fit(f)
    assert _gap(b.summary.objectiveHistory, a.summary.objectiveHistory) \
        <= 1e-5
    t = np.exp(1.0 + eta + rng.gumbel(size=len(X)) * 0.5)
    cut = np.quantile(t, 0.9)
    g = Frame({"features": X, "label": np.minimum(t, cut),
               "censor": (t < cut).astype(np.float64)})
    a = AFTSurvivalRegression(device="cpu").fit(g)
    b = AFTSurvivalRegression(device=card).fit(g)
    assert _gap(b.summary.objectiveHistory, a.summary.objectiveHistory) \
        <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("family,link,kw", [
    ("gaussian", "identity", {}), ("poisson", "log", {}),
    ("gamma", "log", {}), ("binomial", "logit", {}),
    ("binomial", "probit", {}), ("tweedie", None, {"variancePower": 1.5}),
])
def test_glm_on_the_card_tracks_the_cpu(card, family, link, kw):
    X, eta, rng = _data(seed=4)
    mu = np.exp(0.3 * eta + 1.0)
    y = {"gaussian": eta + rng.normal(size=len(X)) * 0.3,
         "poisson": rng.poisson(mu), "tweedie": rng.poisson(mu),
         "gamma": mu * rng.gamma(3.0, 1 / 3.0, len(X)),
         "binomial": rng.random(len(X)) < 1 / (1 + np.exp(-eta))}[family]
    f = Frame({"features": X, "label": np.asarray(y, np.float32)})
    params = dict(family=family, **kw)
    if link:
        params["link"] = link
    a = GeneralizedLinearRegression(device="cpu", **params).fit(f)
    b = GeneralizedLinearRegression(device=card, **params).fit(f)
    assert _rel(np.append(b.coefficients, b.intercept),
                np.append(a.coefficients, a.intercept)) <= 1e-4
    assert abs(b.summary.deviance / a.summary.deviance - 1) <= 1e-5
    assert b.fit_stats["host_reads"] == b.summary.totalIterations + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [FMClassifier, FMRegressor])
def test_fm_on_the_card_tracks_the_cpu(card, cls):
    X, eta, rng = _data(seed=5)
    y = ((rng.random(len(X)) < 1 / (1 + np.exp(-eta))) if cls is
         FMClassifier else eta + X[:, 0] * X[:, 1] * 0.3)
    f = Frame({"features": X, "label": np.asarray(y, np.float32)})
    kw = dict(factorSize=8, maxIter=50, stepSize=0.1)
    a = cls(device="cpu", **kw).fit(f)
    b = cls(device=card, **kw).fit(f)
    assert b.summary.totalIterations == a.summary.totalIterations
    assert _gap(b.summary.objectiveHistory, a.summary.objectiveHistory) \
        <= 1e-5
