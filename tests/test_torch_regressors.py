"""The port's tree regressors, RegressionEvaluator and the tree
classifiers' training summaries against the JAX package's, on the CPU.

Inputs: 2 048 rows of 12 standard-normal features (numpy seed 0) and a
nonlinear target of them plus noise, twice: rounded to multiples of 1/4
with its mean made an exact multiple of 1/4 ("quarter"), and as it is
("fractional").  Quarter targets have exact f32 sums in any order, and
so do GBT's later residuals under the absolute loss (signs); the
constant init (the mean) is exact, so the first round's residuals are
quarters too.

Tolerances, each with what it measured here when set:

* without random draws (``bootstrap=False``, ``subsamplingRate=1.0``,
  ``featureSubsetStrategy="all"``) on quarter targets: the decision
  tree's and the forest's heaps bitwise equal to the JAX package's, and
  GBT's under the absolute loss; predictions within 1e-6 relative (the
  forest's mean and GBT's weighted sum over trees are taken in other
  orders: 4.8e-7 absolute on predictions of magnitude ~5);
* on fractional targets (and GBT's squared loss): the near-tie rule — a
  differing split only where the two weighted gains lie within
  ``TIE_RTOL`` (1e-5) of ``W·R²`` (the root's weight times the squared
  target range, a bound of any cell's sum of ``w·r²``), leaf stats
  within ``TIE_RTOL`` of ``w·max(R, R²)`` — and training RMSE within
  1e-5 relative (no near-tie seen at these widths; RMSE 5e-10 apart);
* with random draws (Poisson bagging, feature subsets, GBT's row
  subsample): quality only, held-out RMSE within 10 % of the JAX
  package's for the forest (2.8 %) and 15 % for boosting (10.8 %);
* RegressionEvaluator: every metric name within 1e-12 of the JAX one;
* training summaries: the forest's and the binary GBT's accuracy and
  weighted metrics equal to the JAX package's where the trees are equal
  (no draws; integer class counts), the GBT summary's areaUnderROC
  within 1e-6.
"""

import numpy as np
import pytest
import torch

from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.evaluation.regression import (
    RegressionEvaluator as JRegressionEvaluator,
)
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import GBTClassifier as JGBTClassifier
from sntc_tpu.models import RandomForestClassifier as JRFClassifier
from sntc_tpu.models.tree.decision_tree import (
    DecisionTreeRegressor as JDTRegressor,
)
from sntc_tpu.models.tree.gbt_regressor import GBTRegressor as JGBTRegressor
from sntc_tpu.models.tree.random_forest_regressor import (
    RandomForestRegressor as JRFRegressor,
)
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.evaluation import RegressionEvaluator
from sntc_tpu_torch.mlio import load_model, optimizer_checkpoint, save_model
from sntc_tpu_torch.models import (
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
    GBTClassifier,
    GBTRegressionModel,
    GBTRegressor,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from sntc_tpu_torch.models.summary import (
    BinaryClassificationTrainingSummary,
    ClassificationTrainingSummary,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

TIE_RTOL = 1e-5
NO_DRAWS = dict(bootstrap=False, featureSubsetStrategy="all",
                subsamplingRate=1.0)
PORT = {"dt": DecisionTreeRegressor, "rf": RandomForestRegressor,
        "gbt": GBTRegressor}
JAX = {"dt": JDTRegressor, "rf": JRFRegressor, "gbt": JGBTRegressor}
PARAMS = {
    "dt": dict(maxDepth=5, maxBins=32),
    "rf": dict(numTrees=3, maxDepth=5, maxBins=32, **NO_DRAWS),
    "gbt": dict(maxIter=4, maxDepth=3, maxBins=32, stepSize=0.3),
}
HEAP_FIELDS = ("feature", "threshold", "leaf_stats", "gain", "count")


def _exact_mean(y: np.ndarray) -> np.ndarray:
    """Quarter targets whose sum is a multiple of n/4, so that their
    mean is an exact quarter: quarter steps spread over the first rows."""
    n = len(y)
    q = np.round(y * 4).astype(np.int64)
    want = int(np.round(q.sum() / n)) * n
    d = want - int(q.sum())
    q[:abs(d)] += np.sign(d)
    return (q / 4).astype(np.float32)


def _targets(X, rng):
    return (2 * X[:, 0] + 3 * np.sin(X[:, 1]) + 2 * (X[:, 2] > 0.5)
            + 0.3 * rng.normal(size=len(X)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 12)).astype(np.float32)
    y = _targets(X, rng)
    return {"X": X, "quarter": _exact_mean(y), "fractional":
            y.astype(np.float32)}


def _fit(kind: str, X, y, jax: bool, **extra):
    params = dict(PARAMS[kind], **extra)
    if jax:
        return JAX[kind](**params).fit(JFrame({"features": X, "label": y}))
    return PORT[kind](device="cpu", **params).fit(
        Frame({"features": X, "label": y}))


def _rmse(pred, y) -> float:
    return float(np.sqrt(np.mean((np.asarray(pred, np.float64) - y) ** 2)))


def assert_same_regression_trees(a, b, y) -> int:
    """Heaps equal under the near-tie rule (see the module docstring);
    returns the near-ties seen."""
    R = float(y.max() - y.min())
    ties = 0
    for t in range(a.feature.shape[0]):
        scale = float(max(a.count[t, 0], a.leaf_stats[t, 0, 0])) * R * R
        stack = [0]
        while stack:
            h = stack.pop()
            fa, fb = int(a.feature[t, h]), int(b.feature[t, h])
            wa = float(a.gain[t, h]) * float(a.count[t, h])
            wb = float(b.gain[t, h]) * float(b.count[t, h])
            if fa != fb or (fa >= 0 and a.threshold[t, h] != b.threshold[t, h]):
                assert min(fa, fb) >= -1 and abs(wa - wb) <= TIE_RTOL * scale, (
                    f"tree {t} slot {h}: split {fa} vs {fb}, weighted gain "
                    f"{wa} vs {wb}")
                ties += 1
                continue
            if fa >= 0:
                assert a.count[t, h] == b.count[t, h]
                assert abs(wa - wb) <= TIE_RTOL * scale
                if 2 * h + 2 < a.feature.shape[1]:
                    stack += [2 * h + 1, 2 * h + 2]
            elif fa == -1:
                la = a.leaf_stats[t, h].astype(np.float64)
                lb = b.leaf_stats[t, h].astype(np.float64)
                assert la[0] == lb[0]
                assert (np.abs(la - lb) <= TIE_RTOL * la[0] * max(R, R * R)
                        ).all(), (t, h, la, lb)
    return ties


@pytest.mark.parametrize("kind,loss", [("dt", None), ("rf", None),
                                       ("gbt", "absolute")])
def test_quarter_targets_grow_the_jax_packages_trees(data, kind, loss):
    X, y = data["X"], data["quarter"]
    extra = {} if loss is None else {"lossType": loss}
    jm = _fit(kind, X, y, jax=True, **extra)
    pm = _fit(kind, X, y, jax=False, **extra)
    for name in HEAP_FIELDS:
        np.testing.assert_array_equal(getattr(pm.forest, name),
                                      getattr(jm.forest, name), err_msg=name)
    if kind == "gbt":
        assert pm.treeWeights == jm.treeWeights
        assert pm.init_prediction == jm.init_prediction == float(y.mean())
    jp = jm.predict(X)
    pp = pm.predict(X)
    assert pp.dtype == np.float64
    np.testing.assert_allclose(pp, jp, rtol=1e-6, atol=1e-6)
    if kind == "dt":
        np.testing.assert_array_equal(pp, jp)
        assert pm.depth == jm.depth


@pytest.mark.parametrize("kind,loss", [("dt", None), ("rf", None),
                                       ("gbt", "squared"),
                                       ("gbt", "absolute")])
def test_fractional_targets_under_the_near_tie_rule(data, kind, loss):
    X, y = data["X"], data["fractional"]
    extra = {} if loss is None else {"lossType": loss}
    jm = _fit(kind, X, y, jax=True, **extra)
    pm = _fit(kind, X, y, jax=False, **extra)
    assert assert_same_regression_trees(pm.forest, jm.forest, y) == 0
    rj, rp = _rmse(jm.predict(X), y), _rmse(pm.predict(X), y)
    assert abs(rp - rj) <= 1e-5 * rj


def test_squared_loss_gbt_on_quarter_targets(data):
    X, y = data["X"], data["quarter"]
    jm = _fit("gbt", X, y, jax=True)
    pm = _fit("gbt", X, y, jax=False)
    # the first round's residuals are quarters: that tree is bitwise
    for name in HEAP_FIELDS:
        np.testing.assert_array_equal(getattr(pm.forest, name)[0],
                                      getattr(jm.forest, name)[0])
    assert assert_same_regression_trees(pm.forest, jm.forest, y) == 0
    np.testing.assert_allclose(pm.predict(X), jm.predict(X), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["rf", "gbt"])
def test_random_draws_compare_by_quality(data, kind):
    """Bagging and feature subsets are drawn from other generators in
    the two packages; held-out RMSE within 10 % for the forest (2.8 %),
    within 15 % for boosting, whose per-node subsets of 4 of 12 features
    over 15 rounds vary more (10.8 %); both well below the targets'
    spread."""
    X, y = data["X"], data["fractional"]
    tr, te = slice(0, 1536), slice(1536, None)
    extra = (dict(bootstrap=True, featureSubsetStrategy="auto", numTrees=10)
             if kind == "rf" else dict(maxIter=15, subsamplingRate=0.7,
                                       featureSubsetStrategy="sqrt"))
    jm = _fit(kind, X[tr], y[tr], jax=True, **extra)
    pm = _fit(kind, X[tr], y[tr], jax=False, **extra)
    rj = _rmse(jm.predict(X[te]), y[te])
    rp = _rmse(pm.predict(X[te]), y[te])
    assert abs(rp - rj) <= (0.1 if kind == "rf" else 0.15) * rj
    assert max(rp, rj) < 0.5 * float(np.std(y[te]))


def _validation_split(y):
    is_val = np.zeros(len(y), bool)
    is_val[1536:] = True
    y = y.copy()
    y[:1536] = _exact_mean(y[:1536])
    return is_val, y


def test_gbt_validated_stop_keeps_the_jax_packages_trees(data):
    X = data["X"]
    is_val, y = _validation_split(data["quarter"])
    kw = dict(maxIter=30, maxDepth=3, maxBins=32, stepSize=0.5,
              lossType="absolute", validationIndicatorCol="isVal",
              validationTol=0.01)
    jm = JGBTRegressor(**kw).fit(
        JFrame({"features": X, "label": y, "isVal": is_val}))
    pm = GBTRegressor(device="cpu", **kw).fit(
        Frame({"features": X, "label": y, "isVal": is_val}))
    assert pm.numTrees == jm.numTrees < 30
    assert pm.treeWeights == jm.treeWeights
    for name in HEAP_FIELDS:
        np.testing.assert_array_equal(getattr(pm.forest, name),
                                      getattr(jm.forest, name))
    with pytest.raises(ValueError, match="proper subset"):
        GBTRegressor(device="cpu", **kw).fit(Frame({
            "features": X, "label": y, "isVal": np.ones(len(y), bool)}))


def test_gbt_resume_equals_an_uninterrupted_fit(data, tmp_path, monkeypatch):
    X, y = data["X"], data["fractional"]
    frame = Frame({"features": X, "label": y})
    kw = dict(device="cpu", maxIter=6, maxDepth=3, maxBins=32,
              stepSize=0.3, seed=1, lossType="absolute")
    full = GBTRegressor(**kw).fit(frame)
    ckpt = str(tmp_path / "gbt")
    save = optimizer_checkpoint.save_state
    calls = []

    class Stop(RuntimeError):
        pass

    def stopping_save(ckpt_dir, state, fingerprint):
        save(ckpt_dir, state, fingerprint)
        calls.append(int(state["round"]))
        if len(calls) == 2:
            raise Stop()

    monkeypatch.setattr(optimizer_checkpoint, "save_state", stopping_save)
    with pytest.raises(Stop):
        GBTRegressor(checkpointInterval=2, checkpointDir=ckpt, **kw).fit(frame)
    monkeypatch.setattr(optimizer_checkpoint, "save_state", save)
    resumed = GBTRegressor(checkpointInterval=2, checkpointDir=ckpt,
                           **kw).fit(frame)
    assert calls == [2, 4]
    for name in HEAP_FIELDS:
        np.testing.assert_array_equal(getattr(resumed.forest, name),
                                      getattr(full.forest, name))
    assert resumed.treeWeights == full.treeWeights
    np.testing.assert_array_equal(resumed.predict(X), full.predict(X))
    assert optimizer_checkpoint.load_state(ckpt, {}) is None


@pytest.mark.parametrize("kind,cls", [("dt", DecisionTreeRegressionModel),
                                      ("rf", RandomForestRegressionModel),
                                      ("gbt", GBTRegressionModel)])
def test_models_cross_between_the_packages(data, tmp_path, kind, cls):
    X, y = data["X"], data["quarter"]
    jm = _fit(kind, X, y, jax=True)
    jax_save_model(jm, str(tmp_path / "jax"))
    pm = load_model(str(tmp_path / "jax"), device="cpu")
    assert isinstance(pm, cls)
    out = pm.transform(Frame({"features": X}))
    np.testing.assert_allclose(out["prediction"], jm.predict(X), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pm.featureImportances, jm.featureImportances,
                               rtol=1e-12)
    save_model(pm, str(tmp_path / "port"))
    back = jax_load_model(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.predict(X), jm.predict(X))
    # a tensor column serves on the model's device too
    np.testing.assert_array_equal(
        pm.transform(Frame({"features": torch.from_numpy(X)}))["prediction"],
        out["prediction"])


@pytest.mark.parametrize("name", ["rmse", "mse", "r2", "mae", "var",
                                  "r2-through-origin", "rmse-weighted"])
def test_regression_evaluator_matches_the_jax_package(name):
    rng = np.random.default_rng(1)
    y = rng.normal(size=500) * 3
    cols = {"label": y, "prediction": y + rng.normal(size=500),
            "w": rng.integers(1, 8, 500) / 4.0}
    params = {"metricName": name.split("-")[0]}
    if name.endswith("origin"):
        params["throughOrigin"] = True
    if name.endswith("weighted"):
        params["weightCol"] = "w"
    port = RegressionEvaluator(**params)
    ref = JRegressionEvaluator(**params)
    a, b = port.evaluate(Frame(cols)), ref.evaluate(JFrame(cols))
    assert abs(a - b) <= 1e-12 * max(1.0, abs(b))
    assert port.isLargerBetter() == ref.isLargerBetter()


def _classes(n=1500, k=3, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.argmax(X[:, :k] + 0.8 * rng.normal(size=(n, k)), axis=1)
    return X, y.astype(np.float64)


@pytest.mark.parametrize("k", [3, 2])
def test_random_forest_summary_matches_the_jax_package(k):
    X, y = _classes(k=k)
    kw = dict(numTrees=3, maxDepth=4, maxBins=16, **NO_DRAWS)
    jm = JRFClassifier(**kw).fit(JFrame({"features": X, "label": y}))
    pm = RandomForestClassifier(device="cpu", **kw).fit(
        Frame({"features": X, "label": y}))
    want = (BinaryClassificationTrainingSummary if k == 2
            else ClassificationTrainingSummary)
    assert type(pm.summary) is want
    js, ps = jm.summary, pm.summary
    assert ps.objectiveHistory == [] and ps.totalIterations == 0
    for attr in ("accuracy", "weightedPrecision", "weightedRecall",
                 "weightedFalsePositiveRate"):
        assert getattr(ps, attr) == getattr(js, attr), attr
    np.testing.assert_array_equal(ps.fMeasureByLabel(), js.fMeasureByLabel())
    if k == 2:
        assert abs(ps.areaUnderROC - js.areaUnderROC) <= 1e-6


def test_gbt_classifier_summary_matches_the_jax_package():
    X, y = _classes(k=2)
    kw = dict(maxIter=3, maxDepth=3, maxBins=16)
    jm = JGBTClassifier(**kw).fit(JFrame({"features": X, "label": y}))
    pm = GBTClassifier(device="cpu", **kw).fit(
        Frame({"features": X, "label": y}))
    assert isinstance(pm.summary, BinaryClassificationTrainingSummary)
    assert pm.summary.totalIterations == jm.summary.totalIterations == 3
    assert pm.summary.objectiveHistory == []
    assert pm.summary.accuracy == jm.summary.accuracy
    assert pm.summary.weightedRecall == jm.summary.weightedRecall
    assert abs(pm.summary.areaUnderROC - jm.summary.areaUnderROC) <= 1e-6
