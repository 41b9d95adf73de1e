"""The port's ``stat`` and the univariate and variance selectors against
the JAX package's, on the CPU.

Inputs: the JAX tests' lognormal rows (4 003 × 6, numpy seed 7, one
categorical-ish column, a label-shifted column) and their selector
blobs (seeds 6-10, 4); the JAX side runs on tier-1's ``mesh8``.

Tolerances, each with what it measured here when set:

* ``ChiSquareTest`` (integer counts), ``KolmogorovSmirnovTest`` (host
  float64): statistics, p-values and degrees of freedom bitwise;
* ANOVA and F-regression statistics, the correlations and the
  Summarizer's moments within 1e-5 relative (ANOVA 5.2e-7, F 7.6e-6,
  pearson 3.9e-8, spearman 2.9e-7, moments 2.6e-7), p-values within
  1e-5 of the largest, the Summarizer's count, min and max bitwise, and
  its weight sum and non-zeros too where the weights are integers;
* the selectors' chosen features equal; their models saved by either
  package load in the other; fused in a segment, bitwise equal to
  staged.
"""

import numpy as np
import pytest
import torch

from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.feature import ChiSqSelector as JChiSqSelector
from sntc_tpu.feature import UnivariateFeatureSelector as JUFS
from sntc_tpu.feature import VarianceThresholdSelector as JVTS
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.stat import ANOVATest as JANOVATest
from sntc_tpu.stat import ChiSquareTest as JChiSquareTest
from sntc_tpu.stat import Correlation as JCorrelation
from sntc_tpu.stat import FValueTest as JFValueTest
from sntc_tpu.stat import KolmogorovSmirnovTest as JKSTest
from sntc_tpu.stat import Summarizer as JSummarizer
from sntc_tpu_torch.core.base import Pipeline
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.feature import (
    ChiSqSelector,
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
)
from sntc_tpu_torch.fuse import compile_pipeline, fused_segments
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import LogisticRegression
from sntc_tpu_torch.stat import (
    ANOVATest,
    ChiSquareTest,
    Correlation,
    FValueTest,
    KolmogorovSmirnovTest,
    Summarizer,
    contingency,
    factorize,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

MOMENT_RTOL = 1e-5
P_ATOL = 1e-5
METRICS = ("mean", "variance", "count", "min", "max", "normL1", "normL2",
           "numNonZeros", "std", "sum", "weightSum")
EXACT_METRICS = ("count", "min", "max", "numNonZeros", "weightSum")


@pytest.fixture(scope="module")
def xy():
    rng = np.random.default_rng(7)
    n, f = 4_003, 6
    X = rng.lognormal(1.0, 1.5, size=(n, f)).astype(np.float32)
    X[:, 2] = rng.integers(0, 4, size=n)
    y = rng.integers(0, 3, size=n)
    X[:, 0] += 3.0 * y
    return X, y


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.nanmax(np.abs(a - b)) / max(np.nanmax(np.abs(b)), 1e-30))


# -- Correlation ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["pearson", "spearman"])
def test_correlation_matches_jax(mesh8, xy, method):
    X, _ = xy
    ours = Correlation.corr(Frame({"features": X}), "features", method,
                            device="cpu")[method]
    theirs = JCorrelation.corr(JFrame({"features": X}), "features", method,
                               mesh=mesh8)[method]
    assert ours.shape == (6, 6)
    assert _rel(ours, theirs) <= MOMENT_RTOL


def test_correlation_constant_feature_is_nan():
    X = np.ones((64, 2), dtype=np.float32)
    X[:, 1] = np.arange(64)
    m = Correlation.corr(Frame({"features": X}), "features",
                         device="cpu")["pearson"]
    assert np.isnan(m[0, 1]) and np.isnan(m[1, 0])
    np.testing.assert_allclose(np.diag(m), 1.0)
    with pytest.raises(ValueError, match="pearson"):
        Correlation.corr(Frame({"features": X}), "features", "kendall",
                         device="cpu")


# -- ChiSquareTest -------------------------------------------------------------


def _categorical(xy):
    X, y = xy
    return np.stack(
        [X[:, 2], (X[:, 0] > np.median(X[:, 0])).astype(np.float32)], axis=1)


@pytest.mark.parametrize("flatten", [False, True])
def test_chisquare_bitwise_with_jax(mesh8, xy, flatten):
    cats, y = _categorical(xy), xy[1]
    out = ChiSquareTest.test(Frame({"f": cats, "label": y}), "f", "label",
                             flatten=flatten, device="cpu")
    ref = JChiSquareTest.test(JFrame({"f": cats, "label": y}), "f", "label",
                              flatten=flatten, mesh=mesh8)
    assert out.columns == ref.columns
    for c in ref.columns:
        assert out[c].dtype == ref[c].dtype
        np.testing.assert_array_equal(out[c], ref[c], err_msg=c)


def test_chisquare_wide_feature_bitwise_with_jax(mesh8):
    """A feature of a few thousand distinct values: the contingency's
    widest shape (bins up to ``MAX_CATEGORIES``)."""
    rng = np.random.default_rng(12)
    n = 20_000
    y = rng.integers(0, 4, size=n)
    X = np.stack([rng.integers(0, 3_000, size=n) + 5 * y,
                  rng.integers(0, 7, size=n)], axis=1).astype(np.float32)
    out = ChiSquareTest.test(Frame({"f": X, "label": y}), "f", "label",
                             device="cpu")
    ref = JChiSquareTest.test(JFrame({"f": X, "label": y}), "f", "label",
                              mesh=mesh8)
    for c in ref.columns:
        np.testing.assert_array_equal(out[c], ref[c], err_msg=c)
    binned, n_bins, y_idx, n_classes = factorize(X, y, 10_000)
    assert n_bins > 2_000
    table = contingency(binned, y_idx, n_bins, n_classes, "cpu")
    assert table.shape == (2, n_bins, n_classes)
    assert float(table.sum()) == 2 * n


def test_chisquare_rejects_continuous():
    rng = np.random.default_rng(0)
    X = rng.normal(size=20_000).astype(np.float32)
    y = rng.integers(0, 2, size=20_000)
    with pytest.raises(ValueError, match="distinct"):
        ChiSquareTest.test(Frame({"f": X, "label": y}), "f", "label",
                           device="cpu")


# -- ANOVA, F-value, KS --------------------------------------------------------


def test_anova_and_fvalue_match_jax(mesh8, xy):
    X, y = xy
    target = (X[:, 0] * 0.5 + np.random.default_rng(1).normal(size=len(y))
              ).astype(np.float32)
    for test, jtest, frame in (
        (ANOVATest, JANOVATest, {"features": X, "label": y}),
        (FValueTest, JFValueTest, {"features": X, "label": target}),
    ):
        out = test.test(Frame(frame), "features", "label", device="cpu")
        ref = jtest.test(JFrame(frame), "features", "label", mesh=mesh8)
        assert _rel(out["statistics"], ref["statistics"]) <= MOMENT_RTOL
        np.testing.assert_allclose(out["pValues"], ref["pValues"],
                                   atol=P_ATOL)
        np.testing.assert_array_equal(out["degreesOfFreedom"],
                                      ref["degreesOfFreedom"])


def test_ks_bitwise_with_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, size=10_001)
    for params in ((2.0, 3.0), ()):
        out = KolmogorovSmirnovTest.test(Frame({"s": x}), "s", "norm",
                                         *params)
        ref = JKSTest.test(JFrame({"s": x}), "s", "norm", *params)
        assert out["statistic"][0] == ref["statistic"][0]
        assert out["pValue"][0] == ref["pValue"][0]
    with pytest.raises(ValueError, match="norm"):
        KolmogorovSmirnovTest.test(Frame({"s": x}), "s", "exp")


# -- Summarizer ----------------------------------------------------------------


def _summaries(mesh8, X, w=None, **kw):
    cols = {"features": X} if w is None else {"features": X, "w": w}
    wc = None if w is None else "w"
    ours = Summarizer.metrics(*METRICS).summary(Frame(cols), "features", wc,
                                                device="cpu", **kw)
    theirs = JSummarizer.metrics(*METRICS).summary(JFrame(cols), "features",
                                                   wc, mesh=mesh8, **kw)
    return ours, theirs


@pytest.mark.parametrize("weights", ["none", "integer-frequency",
                                     "fractional", "zero-rows"])
def test_summarizer_matches_jax(mesh8, xy, weights):
    X, _ = xy
    rng = np.random.default_rng(5)
    w, kw = None, {}
    if weights == "integer-frequency":
        w = rng.integers(1, 4, size=len(X)).astype(np.float32)
        kw = {"weightNorm": "frequency"}
    elif weights == "fractional":
        w = rng.uniform(0.25, 2.75, size=len(X)).astype(np.float32)
    elif weights == "zero-rows":
        w = (rng.random(len(X)) > 0.3).astype(np.float32)
    ours, theirs = _summaries(mesh8, X, w, **kw)
    # weighted sums of fractional weights are f32 sums, exact only for
    # integer weights
    exact = (("count", "min", "max") if weights == "fractional"
             else EXACT_METRICS)
    for name in METRICS:
        if name in exact:
            np.testing.assert_array_equal(ours[name], theirs[name], name)
        else:
            assert _rel(ours[name], theirs[name]) <= MOMENT_RTOL, name


def test_summarizer_edges():
    X = np.array([[100.0], [1.0], [2.0]], dtype=np.float32)
    w = np.array([0.0, 1.0, 1.0], dtype=np.float32)
    out = Summarizer.metrics("min", "max", "count", "mean").summary(
        Frame({"features": X, "w": w}), "features", weightCol="w",
        device="cpu")
    assert (out["max"][0, 0], out["min"][0, 0], out["count"][0]) == (
        2.0, 1.0, 2)
    assert Summarizer.mean(Frame({"features": X}), "features",
                           device="cpu").columns == ["mean"]
    with pytest.raises(ValueError, match="weightNorm"):
        Summarizer.metrics("variance").summary(
            Frame({"features": X, "w": w}), "features", weightCol="w",
            device="cpu", weightNorm="bogus")
    with pytest.raises(ValueError, match="unknown summary metrics"):
        Summarizer.metrics("median")


# -- UnivariateFeatureSelector / VarianceThresholdSelector ---------------------


def _ufs_data(kind: str):
    if kind == "anova":
        rng = np.random.default_rng(6)
        y = rng.integers(0, 3, size=4000)
        X = rng.normal(size=(4000, 10)).astype(np.float32)
        X[:, 3] += y * 1.5
        X[:, 8] -= y * 2.0
        return X, y.astype(np.float64)
    if kind == "regression":
        rng = np.random.default_rng(7)
        X = rng.normal(size=(3000, 8)).astype(np.float32)
        return X, 2.0 * X[:, 1] - 1.0 * X[:, 6] + 0.5 * rng.normal(size=3000)
    rng = np.random.default_rng(8)
    y = rng.integers(0, 2, size=2500)
    X = rng.normal(size=(2500, 6)).astype(np.float32)
    X[:, 2] += y * 3.0
    return X, y.astype(np.float64)


UFS_CASES = {
    "anova-top2": ("anova", dict(featureType="continuous",
                                 labelType="categorical",
                                 selectionThreshold=2)),
    "anova-fdr": ("anova", dict(featureType="continuous",
                                labelType="categorical",
                                selectionMode="fdr", selectionThreshold=0.01)),
    "regression-top2": ("regression", dict(featureType="continuous",
                                           labelType="continuous",
                                           selectionThreshold=2)),
    "regression-percentile": ("regression", dict(
        featureType="continuous", labelType="continuous",
        selectionMode="percentile", selectionThreshold=0.25)),
    "chi2-top1": ("chi2", dict(featureType="categorical",
                               labelType="categorical",
                               selectionThreshold=1)),
    "chi2-fwe": ("chi2", dict(featureType="categorical",
                              labelType="categorical", selectionMode="fwe")),
}


@pytest.mark.parametrize("name", list(UFS_CASES))
def test_univariate_selector_matches_jax(mesh8, name):
    kind, params = UFS_CASES[name]
    X, y = _ufs_data(kind)
    cols = {"features": X, "label": y}
    jm = JUFS(mesh=mesh8, **params).fit(JFrame(cols))
    pm = UnivariateFeatureSelector(device="cpu", **params).fit(Frame(cols))
    assert pm.selected_features == jm.selected_features
    np.testing.assert_array_equal(
        pm.transform(Frame(cols))["selectedFeatures"],
        jm.transform(JFrame(cols))["selectedFeatures"])
    if kind == "chi2":
        chi = ChiSqSelector(device="cpu", numTopFeatures=1).fit(Frame(cols))
        jchi = JChiSqSelector(mesh=mesh8, numTopFeatures=1).fit(JFrame(cols))
        assert chi.selected_features == jchi.selected_features
        if name == "chi2-top1":
            assert pm.selected_features == chi.selected_features == [2]


def test_univariate_selector_scores_match_jax(mesh8):
    """The statistics behind the selection, against the JAX package's
    aggregates on the same rows."""
    import jax.numpy as jnp
    from sntc_tpu.feature.univariate_selector import (
        _anova_moments_agg,
        _regression_moments_agg,
    )
    from sntc_tpu.feature.univariate_selector import f_classif as j_f_classif
    from sntc_tpu.feature.univariate_selector import (
        f_regression as j_f_regression,
    )
    from sntc_tpu.parallel.collectives import shard_batch
    from sntc_tpu_torch.feature.univariate_selector import (
        anova_moments,
        f_classif,
        f_regression,
        regression_moments,
    )

    X, y = _ufs_data("anova")
    xs, ys, w = shard_batch(mesh8, X, y.astype(np.int32))
    jF, jp = j_f_classif(_anova_moments_agg(mesh8, 3)(
        xs, ys, w, jnp.asarray(X[0])))
    F, p = f_classif(anova_moments(X, y.astype(np.int32), 3, "cpu"))
    assert _rel(F, jF) <= MOMENT_RTOL
    np.testing.assert_allclose(p, jp, atol=P_ATOL)
    X, y = _ufs_data("regression")
    y32 = y.astype(np.float32)
    xs, ys, w = shard_batch(mesh8, X, y32)
    jF, jp = j_f_regression(_regression_moments_agg(mesh8)(
        xs, ys, w, jnp.asarray(X[0]), jnp.float32(y32[0])))
    F, p = f_regression(regression_moments(X, y32, "cpu"))
    assert _rel(F, jF) <= MOMENT_RTOL
    np.testing.assert_allclose(p, jp, atol=P_ATOL)


def test_univariate_selector_validation():
    rng = np.random.default_rng(10)
    f = Frame({"features": rng.normal(size=(200, 4)).astype(np.float32),
               "label": rng.integers(0, 2, 200).astype(np.float64)})
    base = dict(device="cpu", featureType="continuous",
                labelType="categorical")
    with pytest.raises(ValueError, match="positive\\s+feature count"):
        UnivariateFeatureSelector(selectionThreshold=-3, **base).fit(f)
    with pytest.raises(ValueError, match="integer\\s+feature count"):
        UnivariateFeatureSelector(selectionThreshold=2.7, **base).fit(f)
    with pytest.raises(ValueError, match="in \\[0, 1\\]"):
        UnivariateFeatureSelector(selectionMode="fpr", selectionThreshold=3.0,
                                  **base).fit(f)
    with pytest.raises(ValueError, match="featureType and labelType"):
        UnivariateFeatureSelector(device="cpu").fit(f)
    with pytest.raises(ValueError, match="no\\s+Spark score function"):
        UnivariateFeatureSelector(device="cpu", featureType="categorical",
                                  labelType="continuous").fit(f)


def _vts_data():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(500, 5)).astype(np.float32)
    X[:, 1] = 3.0  # constant
    X[:, 3] *= 0.01  # tiny variance
    return X


@pytest.mark.parametrize("threshold", [0.0, 0.001, 0.5])
def test_variance_selector_matches_jax(threshold):
    X = _vts_data()
    jm = JVTS(varianceThreshold=threshold).fit(JFrame({"features": X}))
    pm = VarianceThresholdSelector(device="cpu",
                                   varianceThreshold=threshold).fit(
        Frame({"features": X}))
    assert pm.selectedFeatures == jm.selectedFeatures
    np.testing.assert_array_equal(
        pm.transform(Frame({"features": X}))["selectedFeatures"],
        jm.transform(JFrame({"features": X}))["selectedFeatures"])
    sel = pm.transform(Frame({"features": torch.from_numpy(X)}))
    np.testing.assert_array_equal(to_host(sel["selectedFeatures"]),
                                  X[:, pm.selectedFeatures])


def test_selectors_saved_by_either_package_load_in_the_other(mesh8,
                                                            tmp_path):
    X, y = _ufs_data("anova")
    cols = {"features": X, "label": y}
    params = UFS_CASES["anova-top2"][1]
    pairs = [
        (JUFS(mesh=mesh8, **params).fit(JFrame(cols)),
         UnivariateFeatureSelector(device="cpu", **params).fit(Frame(cols)),
         UnivariateFeatureSelectorModel),
        (JVTS(varianceThreshold=0.5).fit(JFrame(cols)),
         VarianceThresholdSelector(device="cpu", varianceThreshold=0.5).fit(
             Frame(cols)), VarianceThresholdSelectorModel),
    ]
    for i, (jm, pm, cls) in enumerate(pairs):
        jax_save_model(jm, str(tmp_path / f"j{i}"))
        save_model(pm, str(tmp_path / f"p{i}"))
        loaded = load_model(str(tmp_path / f"j{i}"), device="cpu")
        back = jax_load_model(str(tmp_path / f"p{i}"))
        assert isinstance(loaded, cls) and type(back) is type(jm)
        np.testing.assert_array_equal(
            loaded.transform(Frame(cols))["selectedFeatures"],
            jm.transform(JFrame(cols))["selectedFeatures"])
        np.testing.assert_array_equal(
            back.transform(JFrame(cols))["selectedFeatures"],
            pm.transform(Frame(cols))["selectedFeatures"])


def test_selectors_fused_bitwise_equal_to_staged(monkeypatch):
    # the staged LR head on the device program, as the fused one is
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    X, y = _ufs_data("anova")
    f = Frame({"features": X, "label": y})
    pm = Pipeline(stages=[
        UnivariateFeatureSelector(
            device="cpu", featureType="continuous", labelType="categorical",
            selectionThreshold=6, outputCol="ufs"),
        VarianceThresholdSelector(device="cpu", featuresCol="ufs",
                                  outputCol="vts", varianceThreshold=0.9),
        LogisticRegression(device="cpu", featuresCol="vts", maxIter=10),
    ]).fit(f)
    fused = compile_pipeline(pm)
    (seg,) = fused_segments(fused)
    kinds = [type(s).__name__ for s in seg._stages]
    assert kinds[:2] == ["UnivariateFeatureSelectorModel",
                         "VarianceThresholdSelectorModel"]
    serve = f.drop("label")
    a, b = fused.transform(serve), pm.transform(serve)
    for c in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_array_equal(to_host(a[c]), to_host(b[c]), c)
    assert seg.invocations == 1 and seg.fallbacks == 0
