"""The port's ``tuning/`` (ParamGridBuilder, CrossValidator,
TrainValidationSplit) and the ``resilience/`` part it calls, against the
JAX package's, on the CPU.

The cases mirror ``tests/test_tuning.py``: the same seeded frames go
through both packages' tuners (the JAX package's LogisticRegression on
the 8-device CPU mesh).  Folds come from the host's
``np.random.default_rng(seed)`` in both, and the split from
``Frame.random_split``: the port's folds are the JAX package's, and the
tests check that the fold masks handed to ``_fit_grid_folds`` are equal.
Metrics agree within 1e-3, the JAX package's own batched-against-
sequential tolerance (measured: at most 1.4e-6), and the best index is
equal.  Which path a fit took is read off spies on the lane
fits (``_fit_grid_folds``, ``_fit_grid``, ``_fit_ovr_lanes``), a count
of the prefix's fits, and the ``cv_cell_degraded`` event.  Saved tuning
results and specs load across the packages both ways.
"""

import logging

import numpy as np
import pytest
import torch

from sntc_tpu import resilience as jres
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.evaluation import BinaryClassificationEvaluator as JBinaryEval
from sntc_tpu.evaluation import MulticlassClassificationEvaluator as JMultiEval
from sntc_tpu.feature import StandardScaler as JStandardScaler
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu.models import OneVsRest as JOneVsRest
from sntc_tpu.tuning import CrossValidator as JCrossValidator
from sntc_tpu.tuning import CrossValidatorModel as JCrossValidatorModel
from sntc_tpu.tuning import ParamGridBuilder as JParamGridBuilder
from sntc_tpu.tuning import TrainValidationSplit as JTrainValidationSplit
from sntc_tpu.tuning import (
    TrainValidationSplitModel as JTrainValidationSplitModel,
)
from sntc_tpu_torch import resilience
from sntc_tpu_torch.core.base import Pipeline
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.evaluation import (
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
)
from sntc_tpu_torch.feature import StandardScaler, VectorAssembler
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import LogisticRegression, OneVsRest
from sntc_tpu_torch.tuning import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

METRIC_ATOL = 1e-3


def _data(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    return {"features": X, "label": y}


def _data4(n=900, seed=6, k=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    W = rng.normal(size=(5, k))
    y = np.argmax(X @ W + 0.3 * rng.normal(size=(n, k)), axis=1)
    return {"features": X, "label": y.astype(np.float64)}


def _acc(mesh=None):
    if mesh is not None:
        return JMultiEval(metricName="accuracy", mesh=mesh)
    return MulticlassClassificationEvaluator(metricName="accuracy")


class _Spy:
    """Records the calls of a method (and the fold masks handed to
    ``_fit_grid_folds``) and runs it."""

    def __init__(self, monkeypatch, cls, name):
        self.calls = []
        orig = getattr(cls, name)

        def spy(obj, *a, **kw):
            self.calls.append(a)
            return orig(obj, *a, **kw)

        monkeypatch.setattr(cls, name, spy)


def test_param_grid_builder_matches_jax():
    def build(builder):
        return (builder.addGrid("regParam", [0.0, 0.1])
                .addGrid("maxIter", [10, 20, 30]).baseOn(tol=1e-4).build())

    grid = build(ParamGridBuilder())
    assert grid == build(JParamGridBuilder())
    assert len(grid) == 6 and all(g["tol"] == 1e-4 for g in grid)
    assert ParamGridBuilder().build() == JParamGridBuilder().build() == [{}]


GRID2 = [{"regParam": 1e-4}, {"regParam": 10.0}]


@pytest.fixture(scope="module")
def cv_pair(mesh8):
    """The same CrossValidator over a bare LR, in both packages; the fold
    masks each handed to ``_fit_grid_folds``."""
    cols = _data()
    mp = pytest.MonkeyPatch()
    port_spy = _Spy(mp, LogisticRegression, "_fit_grid_folds")
    jax_spy = _Spy(mp, JLR, "_fit_grid_folds")
    try:
        jm = JCrossValidator(
            estimator=JLR(mesh=mesh8, maxIter=30), estimatorParamMaps=GRID2,
            evaluator=_acc(mesh8), numFolds=3, seed=1,
        ).fit(JFrame(dict(cols)))
        pm = CrossValidator(
            estimator=LogisticRegression(device="cpu", maxIter=30),
            estimatorParamMaps=GRID2, evaluator=_acc(), numFolds=3, seed=1,
        ).fit(Frame(dict(cols)))
    finally:
        mp.undo()
    return cols, jm, pm, jax_spy.calls, port_spy.calls


def test_cross_validator_matches_jax(cv_pair):
    cols, jm, pm, jax_calls, port_calls = cv_pair
    # the whole k-fold × grid sweep took the lane path, on the same folds
    assert len(port_calls) == len(jax_calls) == 1
    np.testing.assert_array_equal(port_calls[0][2], jax_calls[0][2])
    assert pm.bestIndex == jm.bestIndex == 0
    np.testing.assert_allclose(pm.avgMetrics, jm.avgMetrics, atol=METRIC_ATOL)
    assert pm.avgMetrics[0] > pm.avgMetrics[1]
    out = pm.transform(Frame(dict(cols)))
    assert (out["prediction"] == cols["label"]).mean() > 0.85


def test_cross_validator_collect_sub_models(mesh8):
    cols = _data(400)
    kw = dict(estimatorParamMaps=GRID2, numFolds=2, collectSubModels=True)
    jm = JCrossValidator(estimator=JLR(mesh=mesh8, maxIter=10),
                         evaluator=_acc(mesh8), **kw).fit(JFrame(dict(cols)))
    pm = CrossValidator(estimator=LogisticRegression(device="cpu",
                                                     maxIter=10),
                        evaluator=_acc(), **kw).fit(Frame(dict(cols)))
    assert [len(r) for r in pm.subModels] == [len(r) for r in jm.subModels] \
        == [2, 2]
    for prow, jrow in zip(pm.subModels, jm.subModels):
        for p, j in zip(prow, jrow):
            np.testing.assert_allclose(p.coefficientMatrix,
                                       j.coefficientMatrix, atol=1e-3)


@pytest.fixture(scope="module")
def tvs_pair(mesh8):
    cols = _data(seed=2)
    kw = dict(estimatorParamMaps=GRID2, trainRatio=0.7, seed=3,
              collectSubModels=True)
    jm = JTrainValidationSplit(estimator=JLR(mesh=mesh8, maxIter=30),
                               evaluator=_acc(mesh8), **kw).fit(
        JFrame(dict(cols)))
    pm = TrainValidationSplit(
        estimator=LogisticRegression(device="cpu", maxIter=30),
        evaluator=_acc(), **kw).fit(Frame(dict(cols)))
    return cols, jm, pm


def test_train_validation_split_matches_jax(tvs_pair, tmp_path):
    cols, jm, pm = tvs_pair
    assert pm.bestIndex == jm.bestIndex == 0
    np.testing.assert_allclose(pm.validationMetrics, jm.validationMetrics,
                               atol=METRIC_ATOL)
    loaded = load_model(save_model(pm, str(tmp_path / "tvs")), device="cpu")
    f = Frame(dict(cols))
    np.testing.assert_array_equal(loaded.transform(f)["prediction"],
                                  pm.transform(f)["prediction"])


def test_tvs_collect_sub_models(tvs_pair):
    _, jm, pm = tvs_pair
    assert len(pm.subModels) == len(jm.subModels) == 2


def test_cross_validator_fold_col_matches_jax(mesh8):
    cols = _data(n=400, seed=3)
    cols["myfold"] = (np.arange(400) % 3).astype(np.float64)
    grid = [{"regParam": 0.0}, {"regParam": 0.1}]
    jm = JCrossValidator(estimator=JLR(mesh=mesh8, maxIter=20),
                         estimatorParamMaps=grid, evaluator=_acc(mesh8),
                         numFolds=3, foldCol="myfold").fit(JFrame(dict(cols)))
    pm = CrossValidator(estimator=LogisticRegression(device="cpu",
                                                     maxIter=20),
                        estimatorParamMaps=grid, evaluator=_acc(),
                        numFolds=3, foldCol="myfold").fit(Frame(dict(cols)))
    np.testing.assert_allclose(pm.avgMetrics, jm.avgMetrics, atol=METRIC_ATOL)
    with pytest.raises(ValueError, match="foldCol"):
        CrossValidator(estimator=LogisticRegression(device="cpu"),
                       evaluator=_acc(), numFolds=2,
                       foldCol="myfold").fit(Frame(dict(cols)))


@pytest.mark.parametrize("folds,num_folds,match", [
    (np.zeros(90), 3, "empty"),
    (np.full(90, 0.5), 2, "integers"),
])
def test_fold_col_rejects_empty_and_fractional(folds, num_folds, match):
    cols = _data(n=90, seed=5)
    cols["z"] = folds
    cv = CrossValidator(estimator=LogisticRegression(device="cpu",
                                                     maxIter=10),
                        evaluator=_acc(), numFolds=num_folds, foldCol="z")
    jcv = JCrossValidator(estimator=JLR(maxIter=10), evaluator=JMultiEval(),
                          numFolds=num_folds, foldCol="z")
    with pytest.raises(ValueError, match=match):
        jcv.fit(JFrame(dict(cols)))
    with pytest.raises(ValueError, match=match):
        cv.fit(Frame(dict(cols)))


_LB = np.full((1, 5), -1.0)
_BATCH_CASES = [
    ({}, [{"regParam": 0.0}, {"regParam": 0.1, "elasticNetParam": 0.5}]),
    ({}, [{"regParam": 0.1}]),
    ({}, [{"maxIter": 5}, {"maxIter": 20}]),
    ({}, [{"maxIter": 5, "regParam": 0.0}, {"maxIter": 5, "regParam": 0.1}]),
    ({}, [{"regParam": 0.0}, {"featuresCol": "other"}]),
    ({}, [{"regParam": 0.0}, {"standardization": False}]),
    ({}, [{"family": "binomial", "regParam": 0.0},
          {"family": "multinomial", "regParam": 0.1}]),
    ({"lowerBoundsOnCoefficients": _LB},
     [{"regParam": 0.0}, {"regParam": 0.1}]),
    ({"checkpointInterval": 5, "checkpointDir": "ckpt"},
     [{"regParam": 0.0}, {"regParam": 0.1}]),
    ({"checkpointInterval": 5}, [{"regParam": 0.0}, {"regParam": 0.1}]),
]


@pytest.mark.parametrize("params,grid", _BATCH_CASES)
def test_supports_batched_grid_matches_jax(params, grid):
    want = JLR(**params).supports_batched_grid(grid)
    assert LogisticRegression(device="cpu", **params)\
        .supports_batched_grid(grid) == want


@pytest.mark.parametrize("params", [
    {}, {"family": "binomial"}, {"family": "multinomial"},
    {"lowerBoundsOnCoefficients": _LB},
    {"checkpointInterval": 5, "checkpointDir": "ckpt"},
    {"checkpointInterval": 5},
])
def test_supports_vectorized_ovr_matches_jax(params):
    assert LogisticRegression(device="cpu", **params)\
        .supports_vectorized_ovr() == JLR(**params).supports_vectorized_ovr()


def test_batched_matches_sequential(monkeypatch):
    """``SNTC_TUNING_BATCH=0`` fits every cell on its own; the metrics
    match the lane sweep's and only the batched run took the lanes."""
    cols = _data(800)
    grid = [{"regParam": 1e-4}, {"regParam": 0.05}, {"regParam": 5.0}]
    spy = _Spy(monkeypatch, LogisticRegression, "_fit_grid_folds")

    def run():
        return CrossValidator(
            estimator=LogisticRegression(device="cpu", maxIter=20),
            estimatorParamMaps=grid, evaluator=_acc(), numFolds=2, seed=5,
        ).fit(Frame(dict(cols)))

    monkeypatch.setenv("SNTC_TUNING_BATCH", "0")
    seq = run()
    assert not spy.calls
    monkeypatch.setenv("SNTC_TUNING_BATCH", "1")
    bat = run()
    assert len(spy.calls) == 1
    assert bat.bestIndex == seq.bestIndex
    np.testing.assert_allclose(bat.avgMetrics, seq.avgMetrics,
                               atol=METRIC_ATOL)


def test_parallelism_noop_warns(caplog):
    cols = _data(300)
    cv = CrossValidator(
        estimator=LogisticRegression(device="cpu"),
        estimatorParamMaps=[{"maxIter": 5}, {"maxIter": 10}],
        evaluator=_acc(), numFolds=2, parallelism=4,
    )
    with caplog.at_level(logging.WARNING,
                         logger="sntc_tpu_torch.tuning.cross_validator"):
        cv.fit(Frame(dict(cols)))
    assert any("parallelism" in r.message for r in caplog.records)


def _scalar_cols(cols):
    out = {f"c{i}": cols["features"][:, i].copy() for i in range(5)}
    out["label"] = cols["label"]
    return out


def test_pipeline_grid_hoists_the_prefix(mesh8, monkeypatch):
    """A head-only grid over assembler → scaler → LR: per fold the prefix
    fits once (and once more for the refit), the head's grid runs through
    ``_fit_grid``, and the metrics are the JAX package's."""
    cols = _scalar_cols(_data4(600, seed=7))
    names = [f"c{i}" for i in range(5)]
    grid = [{"regParam": 1e-3}, {"regParam": 1.0}]
    scaler_fits = _Spy(monkeypatch, StandardScaler, "_fit")
    grid_fits = _Spy(monkeypatch, LogisticRegression, "_fit_grid")
    pm = CrossValidator(
        estimator=Pipeline(stages=[
            VectorAssembler(inputCols=names, outputCol="raw"),
            StandardScaler(device="cpu", inputCol="raw", outputCol="features",
                           withMean=True),
            LogisticRegression(device="cpu", maxIter=25),
        ]),
        estimatorParamMaps=grid, evaluator=_acc(), numFolds=2, seed=4,
    ).fit(Frame(dict(cols)))
    assert len(scaler_fits.calls) == 2 + 1
    assert len(grid_fits.calls) == 2
    jm = JCrossValidator(
        estimator=JPipeline(stages=[
            JVectorAssembler(inputCols=names, outputCol="raw"),
            JStandardScaler(inputCol="raw", outputCol="features",
                            withMean=True),
            JLR(mesh=mesh8, maxIter=25),
        ]),
        estimatorParamMaps=grid, evaluator=_acc(mesh8), numFolds=2, seed=4,
    ).fit(JFrame(dict(cols)))
    assert pm.bestIndex == jm.bestIndex
    np.testing.assert_allclose(pm.avgMetrics, jm.avgMetrics, atol=METRIC_ATOL)
    assert [type(s).__name__ for s in pm.bestModel.getStages()] == [
        "VectorAssembler", "StandardScalerModel", "LogisticRegressionModel"]


def test_fault_tolerant_cell_degrades(mesh8):
    """An armed ``cv.fit`` failing a cell's two attempts leaves that cell
    NaN with a ``cv_cell_degraded`` event, as in the JAX package; the
    per-cell path ran (the lanes did not) and the rest of the grid
    survives."""
    cols = _data(400, seed=9)
    grid = [{"regParam": 1e-3}, {"regParam": 0.1}]
    kw = dict(estimatorParamMaps=grid, numFolds=2, seed=2,
              faultTolerant=True)
    resilience.clear_events()
    resilience.arm("cv.fit", times=2)
    jres.arm("cv.fit", times=2)
    try:
        pm = CrossValidator(estimator=LogisticRegression(device="cpu",
                                                         maxIter=20),
                            evaluator=_acc(), **kw).fit(Frame(dict(cols)))
        jm = JCrossValidator(estimator=JLR(mesh=mesh8, maxIter=20),
                             evaluator=_acc(mesh8), **kw).fit(
            JFrame(dict(cols)))
    finally:
        resilience.clear()
        jres.clear()
    degraded = resilience.recent_events(event="cv_cell_degraded")
    assert [(e["fold"], e["grid_index"]) for e in degraded] == [(0, 0)]
    assert len(resilience.recent_events(event="fault_injected")) == 2
    assert len(resilience.recent_events(event="retry")) == 1
    # grid point 0 averages its surviving fold only
    np.testing.assert_allclose(pm.avgMetrics, jm.avgMetrics, atol=METRIC_ATOL)


def test_ovr_lr_takes_the_lanes(mesh8, monkeypatch):
    cols = _data4()
    spy = _Spy(monkeypatch, LogisticRegression, "_fit_ovr_lanes")
    base = LogisticRegression(device="cpu", maxIter=25, regParam=1e-3)
    vec = OneVsRest(classifier=base).fit(Frame(dict(cols)))
    assert len(spy.calls) == 1 and len(vec.models) == 4
    jvec = JOneVsRest(classifier=JLR(mesh=mesh8, maxIter=25, regParam=1e-3),
                      mesh=mesh8).fit(JFrame(dict(cols)))
    for p, j in zip(vec.models, jvec.models):
        np.testing.assert_allclose(p.coefficientMatrix, j.coefficientMatrix,
                                   atol=5e-3)
    y = cols["label"]
    out = vec.transform(Frame(dict(cols)))
    assert (out["prediction"] == y).mean() > 0.8
    # sub-models carry the sequential path's column overrides
    assert all(m.getLabelCol().startswith("ovr_label_") for m in vec.models)


# -- persistence across the packages -----------------------------------------


def _binary_cols(n=500, seed=11):
    return _data(n, seed)


@pytest.fixture(scope="module")
def saved_results(mesh8, tmp_path_factory):
    """A CV model, a TVS model and both estimators, fitted and saved by
    each package."""
    root = tmp_path_factory.mktemp("tuning_persist")
    cols = _binary_cols()
    grid = [{"regParam": 0.0}, {"regParam": 0.1}]
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            lr, ev, fr = JLR(mesh=mesh8, maxIter=15), JBinaryEval(), JFrame
            cv_cls, tvs_cls, save = JCrossValidator, JTrainValidationSplit, \
                jax_save_model
        else:
            lr = LogisticRegression(device="cpu", maxIter=15)
            ev, fr = BinaryClassificationEvaluator(), Frame
            cv_cls, tvs_cls, save = CrossValidator, TrainValidationSplit, \
                save_model
        cv = cv_cls(estimator=lr, estimatorParamMaps=grid, evaluator=ev,
                    numFolds=2, seed=0)
        tvs = tvs_cls(estimator=lr, estimatorParamMaps=grid, evaluator=ev,
                      trainRatio=0.7, seed=0)
        objs = {"cv_model": cv.fit(fr(dict(cols))),
                "tvs_model": tvs.fit(fr(dict(cols))),
                "cv": cv, "tvs": tvs}
        out[pkg] = {k: (o, save(o, str(root / f"{pkg}_{k}")))
                    for k, o in objs.items()}
    return cols, grid, out


_LOADED_AS = {
    "port": {"cv_model": CrossValidatorModel,
             "tvs_model": TrainValidationSplitModel,
             "cv": CrossValidator, "tvs": TrainValidationSplit},
    "jax": {"cv_model": JCrossValidatorModel,
            "tvs_model": JTrainValidationSplitModel,
            "cv": JCrossValidator, "tvs": JTrainValidationSplit},
}


@pytest.mark.parametrize("kind", ["cv_model", "tvs_model", "cv", "tvs"])
@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_tuning_persistence_across_packages(saved_results, saved_by, kind):
    cols, grid, out = saved_results
    obj, path = out[saved_by][kind]
    loader = "port" if saved_by == "jax" else "jax"
    loaded = (load_model(path, device="cpu") if loader == "port"
              else jax_load_model(path))
    assert type(loaded) is _LOADED_AS[loader][kind]
    assert loaded.estimatorParamMaps == grid
    assert type(loaded.estimator).__name__ == "LogisticRegression"
    assert type(loaded.evaluator).__name__ == "BinaryClassificationEvaluator"
    assert loaded.estimator.getMaxIter() == 15
    if kind in ("cv", "tvs"):
        assert loaded.paramValues() == obj.paramValues()
        return
    metrics = "avgMetrics" if kind == "cv_model" else "validationMetrics"
    assert getattr(loaded, metrics) == pytest.approx(getattr(obj, metrics))
    assert loaded.bestIndex == obj.bestIndex
    fr = Frame if loader == "port" else JFrame
    pred = np.asarray(loaded.transform(fr(dict(cols)))["prediction"])
    want = np.asarray(obj.transform(
        (JFrame if saved_by == "jax" else Frame)(dict(cols)))["prediction"])
    assert np.mean(pred == want) >= 0.995
    if loader == "port":
        # the restored spec runs: the loaded estimator refits the best point
        refit = loaded.estimator.copy(
            loaded.estimatorParamMaps[loaded.bestIndex]).fit(Frame(dict(cols)))
        assert np.mean(refit.transform(Frame(dict(cols)))["prediction"]
                       == pred) > 0.99


# -- the resilience part tuning calls ----------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"max_attempts": 5, "base_delay_s": 0.1, "jitter": 0.5, "seed": 7},
    {"max_attempts": 4, "multiplier": 3.0, "max_delay_s": 0.2},
])
def test_retry_schedule_matches_jax(kw):
    assert resilience.RetryPolicy(**kw).backoff_schedule() == \
        jres.RetryPolicy(**kw).backoff_schedule()


def test_with_retries_events_and_exhaustion():
    resilience.clear_events()
    policy = resilience.RetryPolicy(max_attempts=3, jitter=0.0)
    slept = []
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    assert resilience.with_retries(flaky, policy, site="t.site",
                                   sleep=slept.append) == "done"
    assert slept == policy.backoff_schedule()
    assert [e["event"] for e in resilience.recent_events(site="t.site")] == [
        "retry", "retry", "retry_success"]
    with pytest.raises(resilience.RetryExhausted):
        resilience.with_retries(lambda: 1 / 0, policy, site="t.dead",
                                sleep=slept.append)
    with pytest.raises(KeyError):  # not retryable: propagates unchanged
        resilience.with_retries(
            lambda: {}["x"],
            resilience.RetryPolicy(retryable=(OSError,)), site="t.key")


@pytest.mark.parametrize("after,times", [
    (0, 1), (1, 1), (2, 3), (0, None),
])
def test_fault_point_schedule_matches_jax(after, times):
    """Which of six calls an armed site raises on, in both packages, with
    one ``fault_injected`` event a raise."""
    def schedule(pkg):
        pkg.clear()
        pkg.arm("t.point", after=after, times=times)
        fired = []
        for _ in range(6):
            try:
                pkg.fault_point("t.point")
                fired.append(False)
            except pkg.InjectedFault:
                fired.append(True)
        pkg.clear()
        pkg.fault_point("t.point")  # disarmed: a dictionary miss
        return fired

    resilience.clear_events()
    fired = schedule(resilience)
    assert fired == schedule(jres)
    assert any(fired)
    events = resilience.recent_events(event="fault_injected")
    assert [e["call"] for e in events] == [
        i + 1 for i, f in enumerate(fired) if f]
    resilience.arm("t.other")
    resilience.disarm("t.other")
    resilience.fault_point("t.other")


def _spec_stages(pkg, mesh):
    """The estimators and evaluators a tuning spec holds, built by one
    package."""
    names = [f"c{i}" for i in range(3)]
    if pkg == "jax":
        from sntc_tpu.evaluation import RegressionEvaluator as JRegEval
        from sntc_tpu.feature import StringIndexer as JStringIndexer

        return {
            "pipeline": JPipeline(stages=[
                JVectorAssembler(inputCols=names, outputCol="raw"),
                JStandardScaler(inputCol="raw", outputCol="features"),
                JLR(maxIter=7, regParam=0.1)]),
            "ovr": JOneVsRest(classifier=JLR(maxIter=9), mesh=mesh),
            "indexer": JStringIndexer(inputCol="Label", outputCol="label",
                                      handleInvalid="skip"),
            "regression_evaluator": JRegEval(metricName="mae"),
        }
    from sntc_tpu_torch.evaluation import RegressionEvaluator
    from sntc_tpu_torch.feature import StringIndexer

    return {
        "pipeline": Pipeline(stages=[
            VectorAssembler(inputCols=names, outputCol="raw"),
            StandardScaler(device="cpu", inputCol="raw",
                           outputCol="features"),
            LogisticRegression(device="cpu", maxIter=7, regParam=0.1)]),
        "ovr": OneVsRest(classifier=LogisticRegression(device="cpu",
                                                       maxIter=9)),
        "indexer": StringIndexer(inputCol="Label", outputCol="label",
                                 handleInvalid="skip"),
        "regression_evaluator": RegressionEvaluator(metricName="mae"),
    }


def _stage_tree(stage):
    """(class name, params) of a stage and its sub-stages, in order."""
    subs = (stage.getStages() if hasattr(stage, "getStages")
            else [stage.classifier] if hasattr(stage, "classifier") else [])
    params = {k: v for k, v in stage.paramValues().items() if k != "stages"}
    return [(type(stage).__name__, params)] + [
        t for sub in subs for t in _stage_tree(sub)]


@pytest.mark.parametrize("kind", ["pipeline", "ovr", "indexer",
                                  "regression_evaluator"])
@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_spec_stages_load_across_packages(mesh8, tmp_path, saved_by, kind):
    """Each estimator and evaluator a tuning spec can hold saves in one
    package and loads in the other with its class and params."""
    stage = _spec_stages(saved_by, mesh8)[kind]
    path = str(tmp_path / kind)
    if saved_by == "jax":
        loaded = load_model(jax_save_model(stage, path), device="cpu")
    else:
        loaded = jax_load_model(save_model(stage, path))
    assert _stage_tree(loaded) == _stage_tree(stage)
