"""``mesh=`` on the port's classification path and on the selectors,
MaxAbsScaler, IDF and ``stat``, against the JAX package.

The port's meshes are virtual CPU shards (``default_mesh(n,
device="cpu")``); the JAX side runs on tier-1's 8 virtual CPU devices
(``mesh8``).  The inputs are a few hundred seeded rows of 6 features
and 3 classes.  What each test holds:

* ``mesh=None`` and a one-shard mesh take the single-device path: equal,
  bitwise, for every module of the slice;
* counts are whole numbers, so they are bitwise across mesh sizes 1, 2,
  4, 8 and against the JAX package at 8: the evaluator's confusion
  matrix and metrics, the summaries' metrics, IDF's ``docFreq``, the χ²
  statistics and selections (UnivariateFeatureSelector, ChiSquareTest),
  VarianceThresholdSelector's selection; MaxAbsScaler's maxima are a
  max, bitwise too;
* moments within ``MOMENT_TOL`` = 1e-5 relative (``tests/test_mesh.py``'s
  aggregate tolerance): NaiveBayes' fit and ``partial_fit``, the ANOVA
  and F-regression statistics, Correlation, the Summarizer (measured at
  most 1.7e-6 across sizes, 3.4e-6 against the JAX package: the
  F-regression statistic, a ratio of differences of sums);
* the LBFGS fits, coefficients relative to the largest: LR's
  one-vs-rest, grid and fold lanes within ``LANE_TOL`` = 5e-4 across
  mesh sizes (measured 1.6e-4: the one-vs-rest lanes stop at ``tol``
  with the same iteration counts, the single device's one reduction
  against per-shard sums) and within ``LANE_JAX_TOL`` = 1e-4 of the JAX
  lanes at mesh 8 (measured 3.3e-5; both sum per shard), the objective
  histories within ``HIST_TOL`` = 1e-5 of the start (measured 4.6e-6);
  ``partial_fit`` over three 200-row blocks within ``PARTIAL_TOL`` =
  5e-3 across sizes (measured 2.0e-3: each call's LBFGS stops at ``tol``
  on a 200-row objective, flat along the softmax's near-null direction)
  and within 2e-4 of the JAX package at 8 (measured 5.8e-5); LinearSVC's
  hinge within ``SVC_TOL`` = 1e-5 (measured 1.3e-6 across sizes, 2.0e-7
  against the JAX package) and predictions equal on at least 99.9 % of
  rows;
* the plumbing: OneVsRest's own mesh reaches LR's lanes, GBT's boosting
  loop and the sequential sub-fits, else the classifier's; a copied
  classifier keeps its mesh; ``incremental_estimator_for`` and
  ``LifecycleManager`` hand the mesh to the refit; ``train --estimator
  nb|svc`` and ``evaluate`` give the estimator and the evaluator the
  default mesh; CrossValidator over ``LogisticRegression(mesh=)`` runs
  the fold lanes on it.
"""

import inspect
import json

import numpy as np
import pytest
import torch

import sntc_tpu_torch.resilience as R
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.parallel import default_mesh, set_collective_domain
from jax_metrics_guard import own_jax_registry  # noqa: F401

SIZES = (1, 2, 4, 8)
MOMENT_TOL = 1e-5
LANE_TOL = 5e-4
LANE_JAX_TOL = 1e-4
PARTIAL_TOL = 5e-3
PARTIAL_JAX_TOL = 2e-4
HIST_TOL = 1e-5
SVC_TOL = 1e-5
SVC_AGREE = 0.999
MAX_ITER = 50


def _mesh(n):
    return None if n is None else default_mesh(n, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(autouse=True)
def _clean():
    R.clear()
    set_collective_domain(None)
    yield
    R.clear()
    set_collective_domain(None)


def _data(seed=0, n=600, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(3.0, 2.0, size=(n, d)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=n) > 3.0).astype(np.float64)
    y3 = (((X[:, 0] + rng.normal(size=n)) > 3).astype(int)
          + (X[:, 1] > 3).astype(int)).astype(np.float64)
    yr = (X[:, 0] * 2.0 + rng.normal(size=n)).astype(np.float64)
    Xi = np.round(X).astype(np.float32)  # categorical: whole values
    counts = rng.poisson(0.7, size=(n, 12)).astype(np.float32)
    return X, y, y3, yr, Xi, counts


X, Y, Y3, YR, XI, COUNTS = _data()
COLS = {
    "bin": {"features": X, "label": Y},
    "multi": {"features": X, "label": Y3},
    "nonneg": {"features": np.abs(X), "label": Y3},
    "reg": {"features": X, "label": YR},
    "cat": {"features": XI, "label": Y3},
    "counts": {"features": COUNTS},
}
FOLD_OF = np.arange(len(Y3)) % 3
GRID = [{"regParam": 1e-2}, {"regParam": 0.1}]


def _f(key):
    return Frame(COLS[key])


def _jf(key):
    return JFrame(COLS[key])


def _port(pkg, name):
    import importlib

    return getattr(importlib.import_module(f"sntc_tpu_torch.{pkg}"), name)


def _jax(pkg, name):
    import importlib

    return getattr(importlib.import_module(f"sntc_tpu.{pkg}"), name)


# -- each module's result, by mesh (None = no mesh) ---------------------------


def _lr_arrays(models):
    return np.concatenate([np.concatenate([np.ravel(m.coefficientMatrix),
                                           np.ravel(m.interceptVector)])
                           for m in models])


def _nb(mesh, model_type="gaussian", key="multi"):
    m = _port("models", "NaiveBayes")(device="cpu", mesh=mesh,
                                      modelType=model_type).fit(_f(key))
    if model_type == "gaussian":
        return np.concatenate([m.gaussian_mu.ravel(), m.gaussian_var.ravel(),
                               m.pi])
    return np.concatenate([m.theta.ravel(), m.bias])


def _nb_partial(mesh):
    est, state = _port("models", "NaiveBayes")(
        device="cpu", mesh=mesh, modelType="gaussian"), None
    f = _f("multi")
    for i in range(3):
        m, state = est.partial_fit(f.slice(i * 200, (i + 1) * 200), state,
                                   n_classes=3)
    return np.concatenate([m.gaussian_mu.ravel(), m.gaussian_var.ravel()])


def _lr_partial(mesh):
    est, state = _port("models", "LogisticRegression")(
        device="cpu", mesh=mesh, maxIter=MAX_ITER, regParam=1e-2), None
    f = _f("multi")
    for i in range(3):
        m, state = est.partial_fit(f.slice(i * 200, (i + 1) * 200), state,
                                   n_classes=3)
    return _lr_arrays([m])


def _ovr_lanes(mesh):
    LR = _port("models", "LogisticRegression")
    return _lr_arrays(LR(device="cpu", maxIter=MAX_ITER, regParam=1e-2)
                      ._fit_ovr_lanes(X, Y3.astype(np.int32),
                                      np.ones(len(Y3), np.float32), 3, mesh))


def _grid(mesh):
    LR = _port("models", "LogisticRegression")
    return _lr_arrays(LR(device="cpu", mesh=mesh, maxIter=MAX_ITER)
                      ._fit_grid(_f("multi"), GRID))


def _folds(mesh):
    LR = _port("models", "LogisticRegression")
    rows = LR(device="cpu", mesh=mesh, maxIter=MAX_ITER)._fit_grid_folds(
        _f("multi"), GRID, FOLD_OF, 3)
    return _lr_arrays([m for row in rows for m in row])


def _svc(mesh):
    m = _port("models", "LinearSVC")(device="cpu", mesh=mesh,
                                     maxIter=MAX_ITER).fit(_f("bin"))
    return np.concatenate([m.coefficients, [m.intercept]])


def _confusion(mesh):
    from sntc_tpu_torch.evaluation.multiclass import MulticlassMetrics

    rng = np.random.default_rng(5)
    y, p = rng.integers(0, 4, 1001), rng.integers(0, 4, 1001)
    return MulticlassMetrics(y, p, mesh=mesh).confusion


def _ufs(mesh, ftype, ltype, key):
    m = _port("feature", "UnivariateFeatureSelector")(
        device="cpu", mesh=mesh, featureType=ftype, labelType=ltype,
        selectionThreshold=3).fit(_f(key))
    return np.asarray(m.selected_features, np.float64)


def _stat(mesh, name, key):
    stat = _port("stat", name)
    r = stat.test(_f(key), "features", "label", device="cpu", mesh=mesh)
    return r["statistics"]


def _summarizer(mesh):
    from sntc_tpu_torch.stat import Summarizer

    names = ("mean", "variance", "min", "max", "count", "numNonZeros",
             "normL1", "normL2", "weightSum")
    r = Summarizer.metrics(*names).summary(_f("bin"), "features",
                                           device="cpu", mesh=mesh)
    return np.concatenate([np.ravel(r[c]).astype(np.float64) for c in names])


# (name, result at a mesh, tolerance across mesh sizes: 0 = bitwise)
CASES = [
    ("evaluator_confusion", _confusion, 0.0),
    ("naive_bayes_gaussian", _nb, MOMENT_TOL),
    ("naive_bayes_multinomial",
     lambda m: _nb(m, "multinomial", "nonneg"), MOMENT_TOL),
    ("naive_bayes_partial_fit", _nb_partial, MOMENT_TOL),
    ("linear_svc", _svc, SVC_TOL),
    ("lr_ovr_lanes", _ovr_lanes, LANE_TOL),
    ("lr_grid_lanes", _grid, LANE_TOL),
    ("lr_fold_lanes", _folds, LANE_TOL),
    ("lr_partial_fit", _lr_partial, PARTIAL_TOL),
    ("ufs_chi2", lambda m: _ufs(m, "categorical", "categorical", "cat"),
     0.0),
    ("ufs_anova", lambda m: _ufs(m, "continuous", "categorical", "multi"),
     0.0),
    ("ufs_fregression", lambda m: _ufs(m, "continuous", "continuous", "reg"),
     0.0),
    ("variance_selector", lambda m: np.asarray(
        _port("feature", "VarianceThresholdSelector")(
            device="cpu", mesh=m, varianceThreshold=3.9).fit(
                _f("bin")).selectedFeatures, np.float64), 0.0),
    ("max_abs_scaler", lambda m: _port("feature", "MaxAbsScaler")(
        device="cpu", mesh=m, inputCol="features").fit(_f("bin")).maxAbs,
     0.0),
    ("idf_doc_freq", lambda m: _port("feature", "IDF")(
        device="cpu", mesh=m, inputCol="features").fit(
            _f("counts")).docFreq, 0.0),
    ("correlation", lambda m: _port("stat", "Correlation").corr(
        _f("bin"), "features", device="cpu", mesh=m)["pearson"],
     MOMENT_TOL),
    ("chi_square_test", lambda m: _stat(m, "ChiSquareTest", "cat"), 0.0),
    ("anova_test", lambda m: _stat(m, "ANOVATest", "multi"), MOMENT_TOL),
    ("fvalue_test", lambda m: _stat(m, "FValueTest", "reg"), MOMENT_TOL),
    ("summarizer", _summarizer, MOMENT_TOL),
]
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_no_mesh_and_one_shard_are_the_single_device_path_bitwise(case):
    _name, fn, _tol = case
    np.testing.assert_array_equal(np.asarray(fn(None), np.float64),
                                  np.asarray(fn(_mesh(1)), np.float64))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_sizes_agree(case):
    name, fn, tol = case
    outs = {s: np.asarray(fn(_mesh(s)), np.float64) for s in SIZES}
    for s in SIZES[1:]:
        if tol == 0.0:
            np.testing.assert_array_equal(outs[s], outs[1], err_msg=f"{s}")
        else:
            assert _rel(outs[s], outs[1]) <= tol, (name, s,
                                                   _rel(outs[s], outs[1]))


def test_every_slice_entry_point_takes_mesh_as_the_jax_one_does():
    for pkg, name in [
        ("models", "NaiveBayes"), ("models", "LinearSVC"),
        ("models", "OneVsRest"), ("models", "LogisticRegression"),
        ("feature", "UnivariateFeatureSelector"),
        ("feature", "VarianceThresholdSelector"),
        ("feature", "MaxAbsScaler"), ("feature", "IDF"),
        ("evaluation", "MulticlassClassificationEvaluator"),
    ]:
        for cls in (_port(pkg, name), _jax(pkg, name)):
            assert "mesh" in inspect.signature(cls.__init__).parameters, name
        if name != "OneVsRest":
            est = _port(pkg, name)(mesh=_mesh(2))
            assert est.mesh.shape == {"data": 2}
            if hasattr(est, "device"):
                assert est.device == torch.device("cpu")
    from sntc_tpu.evaluation.multiclass import MulticlassMetrics as JMM
    from sntc_tpu.lifecycle.incremental import \
        incremental_estimator_for as jinc
    from sntc_tpu.lifecycle.manager import LifecycleManager as JLM
    from sntc_tpu.models import summary as jsummary
    from sntc_tpu_torch.evaluation.multiclass import MulticlassMetrics
    from sntc_tpu_torch.lifecycle.incremental import incremental_estimator_for
    from sntc_tpu_torch.lifecycle.manager import LifecycleManager
    from sntc_tpu_torch.models import summary
    from sntc_tpu_torch.stat import (ANOVATest, ChiSquareTest, Correlation,
                                     FValueTest, Summarizer, SummaryBuilder)

    fns = [MulticlassMetrics.__init__, JMM.__init__,
           incremental_estimator_for, jinc, LifecycleManager.__init__,
           JLM.__init__, Correlation.corr, ChiSquareTest.test,
           ANOVATest.test, FValueTest.test, SummaryBuilder.summary,
           Summarizer.mean, Summarizer.variance]
    for mod in (summary, jsummary):
        fns += [mod.ClassificationSummary.__init__,
                mod.ClassificationTrainingSummary.__init__]
    for fn in fns:
        assert "mesh" in inspect.signature(fn).parameters, fn


# -- mesh 8 against the JAX package on mesh8 -----------------------------------


def _jax_lr_arrays(models):
    return np.concatenate([np.concatenate([
        np.ravel(np.asarray(m.coefficientMatrix)),
        np.ravel(np.asarray(m.interceptVector))]) for m in models])


def test_counts_at_mesh8_equal_the_jax_ones_bitwise(mesh8):
    """The evaluator, the summary's confusion, IDF's docFreq, the χ²
    statistics and every selection: whole counts, bitwise."""
    from sntc_tpu.evaluation import MulticlassClassificationEvaluator as JEv
    from sntc_tpu.evaluation.multiclass import MulticlassMetrics as JMM
    from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator

    m8 = _mesh(8)
    rng = np.random.default_rng(5)
    y, p = rng.integers(0, 4, 1001), rng.integers(0, 4, 1001)
    np.testing.assert_array_equal(_confusion(m8),
                                  JMM(y, p, mesh=mesh8).confusion)
    cols = {"label": y.astype(np.float64), "prediction": p.astype(np.float64)}
    for name in ("f1", "macroF1", "accuracy", "weightedPrecision",
                 "recallByLabel", "hammingLoss"):
        a = MulticlassClassificationEvaluator(
            metricName=name, metricLabel=2, mesh=m8).evaluate(Frame(cols))
        b = JEv(metricName=name, metricLabel=2, mesh=mesh8).evaluate(
            JFrame(cols))
        assert a == b, name
    # the training summary's confusion over the mesh, on the port's model
    LR = _port("models", "LogisticRegression")
    model = LR(device="cpu", mesh=m8, maxIter=10).fit(_f("multi"))
    out = model.summary.predictions
    np.testing.assert_array_equal(
        model.summary._m().confusion,
        JMM(np.asarray(out["label"]), np.asarray(out["prediction"]),
            mesh=mesh8).confusion)
    assert model.summary._mesh is m8
    j_idf = _jax("feature", "IDF")(mesh=mesh8, inputCol="features").fit(
        _jf("counts"))
    np.testing.assert_array_equal(
        _port("feature", "IDF")(device="cpu", mesh=m8,
                                inputCol="features").fit(
            _f("counts")).docFreq, j_idf.docFreq)
    j_chi = _jax("stat", "ChiSquareTest").test(_jf("cat"), "features",
                                              "label", mesh=mesh8)
    np.testing.assert_array_equal(_stat(m8, "ChiSquareTest", "cat"),
                                  j_chi["statistics"])
    for ftype, ltype, key in [("categorical", "categorical", "cat"),
                              ("continuous", "categorical", "multi"),
                              ("continuous", "continuous", "reg")]:
        j = _jax("feature", "UnivariateFeatureSelector")(
            mesh=mesh8, featureType=ftype, labelType=ltype,
            selectionThreshold=3).fit(_jf(key))
        assert list(_ufs(m8, ftype, ltype, key)) == list(
            j.selected_features), (ftype, ltype)
    j_vts = _jax("feature", "VarianceThresholdSelector")(
        mesh=mesh8, varianceThreshold=3.9).fit(_jf("bin"))
    p_vts = _port("feature", "VarianceThresholdSelector")(
        device="cpu", mesh=m8, varianceThreshold=3.9).fit(_f("bin"))
    assert p_vts.selectedFeatures == list(j_vts.selectedFeatures)
    j_max = _jax("feature", "MaxAbsScaler")(mesh=mesh8,
                                            inputCol="features").fit(
        _jf("bin"))
    np.testing.assert_array_equal(
        _port("feature", "MaxAbsScaler")(device="cpu", mesh=m8,
                                         inputCol="features").fit(
            _f("bin")).maxAbs, j_max.maxAbs)


def _jax_nb(mesh8, model_type, key):
    m = _jax("models", "NaiveBayes")(mesh=mesh8, modelType=model_type).fit(
        _jf(key))
    if model_type == "gaussian":
        return np.concatenate([np.ravel(m.gaussian_mu),
                               np.ravel(m.gaussian_var), np.ravel(m.pi)])
    return np.concatenate([np.ravel(m.theta), np.ravel(m.bias)])


def _jax_stat(mesh8, name, key):
    return _jax("stat", name).test(_jf(key), "features", "label",
                                   mesh=mesh8)["statistics"]


def _jax_summarizer(mesh8):
    from sntc_tpu.stat import Summarizer as JS

    names = ("mean", "variance", "min", "max", "count", "numNonZeros",
             "normL1", "normL2", "weightSum")
    r = JS.metrics(*names).summary(_jf("bin"), "features", mesh=mesh8)
    return np.concatenate([np.ravel(r[c]).astype(np.float64) for c in names])


@pytest.mark.parametrize("name,port,ref,tol,measured", [
    # measured: the gap (relative to the largest value) when written
    ("naive_bayes_gaussian", lambda: _nb(_mesh(8)),
     lambda j: _jax_nb(j, "gaussian", "multi"), MOMENT_TOL, 0.0),
    ("naive_bayes_multinomial", lambda: _nb(_mesh(8), "multinomial",
                                            "nonneg"),
     lambda j: _jax_nb(j, "multinomial", "nonneg"), MOMENT_TOL, 0.0),
    ("correlation", lambda: _port("stat", "Correlation").corr(
        _f("bin"), "features", device="cpu", mesh=_mesh(8))["pearson"],
     lambda j: _jax("stat", "Correlation").corr(
         _jf("bin"), "features", mesh=j)["pearson"], MOMENT_TOL, 1.9e-8),
    ("anova_test", lambda: _stat(_mesh(8), "ANOVATest", "multi"),
     lambda j: _jax_stat(j, "ANOVATest", "multi"), MOMENT_TOL, 0.0),
    ("fvalue_test", lambda: _stat(_mesh(8), "FValueTest", "reg"),
     lambda j: _jax_stat(j, "FValueTest", "reg"), MOMENT_TOL, 3.4e-6),
    ("summarizer", lambda: _summarizer(_mesh(8)), _jax_summarizer,
     MOMENT_TOL, 6.5e-8),
], ids=lambda v: v if isinstance(v, str) else "")
def test_moments_at_mesh8_against_the_jax_package(mesh8, name, port, ref,
                                                  tol, measured):
    gap = _rel(port(), ref(mesh8))
    assert gap <= tol, (name, gap, measured)


def test_nb_partial_fit_at_mesh8_against_the_jax_package(mesh8):
    est, state = _jax("models", "NaiveBayes")(mesh=mesh8,
                                              modelType="gaussian"), None
    f = _jf("multi")
    for i in range(3):
        m, state = est.partial_fit(f.slice(i * 200, (i + 1) * 200), state,
                                   n_classes=3)
    j = np.concatenate([np.ravel(m.gaussian_mu), np.ravel(m.gaussian_var)])
    gap = _rel(_nb_partial(_mesh(8)), j)
    assert gap <= MOMENT_TOL, gap  # measured 0.0


def _hist_gap(port_models, jax_models):
    gaps = []
    for p, j in zip(port_models, jax_models):
        a = np.asarray(p.summary.objectiveHistory)
        b = np.asarray(j.summary.objectiveHistory)
        n = min(len(a), len(b))
        gaps.append(float(np.abs(a[:n] - b[:n]).max() / abs(b[0])))
    return max(gaps)


def test_lr_lanes_at_mesh8_against_the_jax_package(mesh8):
    """The one-vs-rest, grid and fold lanes, each lane's evaluation summed
    over 8 shards, against the JAX lane programs on mesh8."""
    JLR = _jax("models", "LogisticRegression")
    LR = _port("models", "LogisticRegression")
    m8 = _mesh(8)
    yi, w = Y3.astype(np.int32), np.ones(len(Y3), np.float32)
    pairs = [
        (LR(device="cpu", maxIter=MAX_ITER, regParam=1e-2)._fit_ovr_lanes(
            X, yi, w, 3, m8),
         JLR(mesh=mesh8, maxIter=MAX_ITER, regParam=1e-2)._fit_ovr_lanes(
             X, yi, w, 3, mesh8)),
        (LR(device="cpu", mesh=m8, maxIter=MAX_ITER)._fit_grid(
            _f("multi"), GRID),
         JLR(mesh=mesh8, maxIter=MAX_ITER)._fit_grid(_jf("multi"), GRID)),
        ([m for r in LR(device="cpu", mesh=m8, maxIter=MAX_ITER)
          ._fit_grid_folds(_f("multi"), GRID, FOLD_OF, 3) for m in r],
         [m for r in JLR(mesh=mesh8, maxIter=MAX_ITER)._fit_grid_folds(
             _jf("multi"), GRID, FOLD_OF, 3) for m in r]),
    ]
    for port, ref in pairs:
        assert _rel(_lr_arrays(port), _jax_lr_arrays(ref)) <= LANE_JAX_TOL
        assert _hist_gap(port, ref) <= HIST_TOL
    # the host reads do not grow with the shards: one Armijo verdict a
    # line-search round and one read an iteration, as on one device
    one = LR(device="cpu", maxIter=MAX_ITER, regParam=1e-2)._fit_ovr_lanes(
        X, yi, w, 3, None)
    for models in (one, pairs[0][0]):
        st = models[0].optimizer_stats
        iters = max(m.optimizer_stats["iterations"] for m in models)
        assert st["host_syncs"] <= st["evaluations"] + iters, st


def test_lr_partial_fit_at_mesh8_against_the_jax_package(mesh8):
    est, state = _jax("models", "LogisticRegression")(
        mesh=mesh8, maxIter=MAX_ITER, regParam=1e-2), None
    f = _jf("multi")
    for i in range(3):
        m, state = est.partial_fit(f.slice(i * 200, (i + 1) * 200), state,
                                   n_classes=3)
    assert _rel(_lr_partial(_mesh(8)), _jax_lr_arrays([m])) <= \
        PARTIAL_JAX_TOL


def test_linear_svc_at_mesh8_against_the_jax_package(mesh8):
    j = _jax("models", "LinearSVC")(mesh=mesh8, maxIter=MAX_ITER).fit(
        _jf("bin"))
    p = _port("models", "LinearSVC")(device="cpu", mesh=_mesh(8),
                                     maxIter=MAX_ITER).fit(_f("bin"))
    assert _rel(np.concatenate([p.coefficients, [p.intercept]]),
                np.concatenate([j.coefficients, [j.intercept]])) <= SVC_TOL
    agree = np.mean(np.asarray(p.transform(_f("bin"))["prediction"])
                    == np.asarray(j.transform(_jf("bin"))["prediction"]))
    assert agree >= SVC_AGREE
    assert p.summary._mesh.shape == {"data": 8}
    assert p.summary.accuracy == j.summary.accuracy


def test_linear_svc_predictions_across_mesh_sizes():
    f = _f("bin")
    preds = {s: np.asarray(_port("models", "LinearSVC")(
        device="cpu", mesh=_mesh(s), maxIter=MAX_ITER).fit(f).transform(f)[
            "prediction"]) for s in SIZES}
    for s in SIZES[1:]:
        assert np.mean(preds[s] == preds[1]) >= SVC_AGREE, s


# -- the plumbing --------------------------------------------------------------


def test_one_vs_rest_mesh_reaches_lanes_boosting_and_sub_fits(monkeypatch):
    from sntc_tpu_torch.models import (GBTClassifier, LinearSVC,
                                       LogisticRegression, OneVsRest)
    from sntc_tpu_torch.models import logistic_regression as lr_mod
    from sntc_tpu_torch.models.tree import gbt as gbt_mod

    m4 = _mesh(4)
    f = _f("multi")
    seen = {"lanes": [], "layout": 0, "svc": []}
    lanes = LogisticRegression._fit_ovr_lanes

    def spy_lanes(self, X_, y_, w_, k, mesh=None):
        seen["lanes"].append(mesh)
        return lanes(self, X_, y_, w_, k, mesh)

    monkeypatch.setattr(LogisticRegression, "_fit_ovr_lanes", spy_lanes)
    layout = gbt_mod.layout_rows

    def spy_layout(*a, **kw):
        seen["layout"] += 1
        return layout(*a, **kw)

    monkeypatch.setattr(gbt_mod, "layout_rows", spy_layout)
    svc_fit = LinearSVC._fit

    def spy_svc(self, frame):
        seen["svc"].append(self.mesh)
        return svc_fit(self, frame)

    monkeypatch.setattr(LinearSVC, "_fit", spy_svc)
    reduces = []
    reduce_at = lr_mod.reduce_at
    monkeypatch.setattr(lr_mod, "reduce_at",
                        lambda parts, **kw: reduces.append(len(parts))
                        or reduce_at(parts, **kw))

    lr = LogisticRegression(device="cpu", maxIter=MAX_ITER, regParam=1e-2)
    own = OneVsRest(classifier=lr, mesh=m4).fit(f)
    assert seen["lanes"] == [m4] and set(reduces) == {4}
    assert lr.mesh is None  # the OneVsRest's own mesh, on a copy
    # else the classifier's
    reduces.clear()
    OneVsRest(classifier=LogisticRegression(
        device="cpu", mesh=m4, maxIter=MAX_ITER, regParam=1e-2)).fit(f)
    assert seen["lanes"][-1] is m4 and set(reduces) == {4}
    # neither: the single-device lanes, bitwise the one-shard mesh's
    plain = OneVsRest(classifier=lr).fit(f)
    one = OneVsRest(classifier=lr, mesh=_mesh(1)).fit(f)
    np.testing.assert_array_equal(_lr_arrays(plain.models),
                                  _lr_arrays(one.models))
    assert _rel(_lr_arrays(own.models), _lr_arrays(plain.models)) <= LANE_TOL
    gbt = GBTClassifier(device="cpu", maxIter=2, maxDepth=2)
    g4 = OneVsRest(classifier=gbt, mesh=m4).fit(f)
    g1 = OneVsRest(classifier=gbt).fit(f)
    assert seen["layout"] == 1
    raw4 = np.asarray(g4.transform(f)["rawPrediction"])
    raw1 = np.asarray(g1.transform(f)["rawPrediction"])
    assert _rel(raw4, raw1) <= MOMENT_TOL
    OneVsRest(classifier=LinearSVC(device="cpu", maxIter=10), mesh=m4).fit(f)
    assert seen["svc"] == [m4] * 3
    # a copied classifier keeps its mesh
    assert LinearSVC(device="cpu", mesh=m4).copy({"maxIter": 3}).mesh is m4
    assert OneVsRest(classifier=lr, mesh=m4).copy().mesh is m4


def test_cross_validator_over_a_mesh_lr_runs_the_fold_lanes_on_it(
        monkeypatch):
    from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator
    from sntc_tpu_torch.models import LogisticRegression
    from sntc_tpu_torch.tuning import CrossValidator

    seen = []
    folds = LogisticRegression._fit_grid_folds

    def spy(self, *a, **kw):
        seen.append(self.mesh)
        return folds(self, *a, **kw)

    monkeypatch.setattr(LogisticRegression, "_fit_grid_folds", spy)

    def cv(mesh):
        return CrossValidator(
            estimator=LogisticRegression(device="cpu", mesh=mesh,
                                         maxIter=MAX_ITER),
            estimatorParamMaps=GRID,
            evaluator=MulticlassClassificationEvaluator(metricName="f1"),
            numFolds=3, seed=0).fit(_f("multi"))

    a, b = cv(None), cv(_mesh(4))
    assert seen[-1].shape == {"data": 4}
    assert np.abs(np.subtract(a.avgMetrics, b.avgMetrics)).max() <= 1e-3
    assert _rel(b.bestModel.coefficientMatrix,
                a.bestModel.coefficientMatrix) <= LANE_TOL


def test_lifecycle_refits_over_the_mesh(tmp_path):
    from sntc_tpu_torch.lifecycle import LifecycleManager, ModelPromoter
    from sntc_tpu_torch.lifecycle.incremental import incremental_estimator_for
    from sntc_tpu_torch.mlio import save_model
    from sntc_tpu_torch.models import NaiveBayes
    from sntc_tpu_torch.serve import MemorySink, MemorySource, StreamingQuery

    def shifted(n, seed, shift=False, k=3, d=4):
        r = np.random.default_rng(seed)
        y = r.integers(0, k, n)
        centers = ((y[:, None] + 1) % k if shift else y[:, None]) * 2.0
        Xs = (centers + r.normal(size=(n, d))).astype(np.float32)
        return {"features": Xs, "label": y.astype(np.float64)}

    m4 = _mesh(4)
    incumbent = NaiveBayes(device="cpu", modelType="gaussian").fit(
        Frame(shifted(900, 0)))
    est = incremental_estimator_for(incumbent, mesh=m4)
    assert est.mesh is m4 and est.getModelType() == "gaussian"
    assert incremental_estimator_for(incumbent).mesh is None
    models = {}
    for tag, mesh in (("none", None), ("mesh4", m4)):
        path, ckpt = str(tmp_path / f"m_{tag}"), str(tmp_path / f"c_{tag}")
        save_model(incumbent, path)
        promoter = ModelPromoter(incumbent, incumbent_raw=incumbent,
                                 serving_path=path, checkpoint_dir=ckpt,
                                 window=3, probation_batches=2, device="cpu")
        mgr = LifecycleManager(promoter=promoter, partial_fit=True,
                               mesh=mesh)
        q = StreamingQuery(
            incumbent, MemorySource([Frame(shifted(128, 100 + i, shift=True))
                                     for i in range(6)]),
            MemorySink(), ckpt, max_batch_offsets=1, device="cpu",
            lifecycle=mgr)
        assert q.process_available() == 6
        assert mgr.partial_fit_batches == 6
        assert mgr._pf_estimator.mesh is mesh
        models[tag] = mgr._pf_state
        q.stop()
    a, b = models["none"], models["mesh4"]
    assert _rel(b.s_sh, a.s_sh) <= MOMENT_TOL
    np.testing.assert_array_equal(a.cw, b.cw)


def _csvs(tmp_path):
    from sntc_tpu_torch.data import generate_frame, write_raw_csv

    d = tmp_path / "data"
    d.mkdir()
    write_raw_csv(generate_frame(1500, seed=0, min_class_fraction=0.02),
                  str(d / "part_0000.csv"))
    return str(d)


def test_train_nb_svc_and_evaluate_use_the_default_mesh(tmp_path,
                                                        monkeypatch, capsys):
    from sntc_tpu_torch import app
    from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator
    from sntc_tpu_torch.models import LinearSVC, NaiveBayes
    from sntc_tpu_torch.parallel.context import set_default_mesh

    data = _csvs(tmp_path)
    m2 = _mesh(2)
    seen = {"nb": [], "svc": [], "evaluator": []}
    for cls, key in ((NaiveBayes, "nb"), (LinearSVC, "svc")):
        fit = cls._fit

        def spy(self, frame, _fit=fit, _key=key):
            seen[_key].append(self.mesh)
            return _fit(self, frame)

        monkeypatch.setattr(cls, "_fit", spy)
    evaluate = MulticlassClassificationEvaluator.evaluate

    def spy_ev(self, frame):
        seen["evaluator"].append(self.mesh)
        return evaluate(self, frame)

    monkeypatch.setattr(MulticlassClassificationEvaluator, "evaluate",
                        spy_ev)
    set_default_mesh(m2)
    try:
        lines = {}
        for est in ("nb", "svc"):
            out = str(tmp_path / f"model_{est}")
            assert app.main(["train", "--data", data, "--estimator", est,
                             "--max-iter", "5", "--model-out", out,
                             "--device", "cpu"]) == 0
            lines[est] = json.loads(capsys.readouterr().out.strip()
                                    .splitlines()[-1])
        assert app.main(["evaluate", "--data", data, "--model",
                         str(tmp_path / "model_nb"), "--metric", "macroF1",
                         "--device", "cpu"]) == 0
        evaluated = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    finally:
        set_default_mesh(None)
    assert seen["nb"] == [m2] and len(seen["svc"]) >= 2
    assert all(m is m2 for m in seen["svc"])
    assert seen["evaluator"] == [m2] * 3
    assert evaluated["macroF1"] == pytest.approx(lines["nb"]["macroF1"],
                                                 abs=0.2)
