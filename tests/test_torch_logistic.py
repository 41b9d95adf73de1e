"""The port's LogisticRegression (bench config 1's head, and the
multinomial fit) and BinaryClassificationEvaluator against the JAX
package's, on the CPU.

Inputs: 2 997 clean CICIDS2017-schema rows from the JAX package's
synthetic generator (seed 3), label-indexed, assembled and scaled by the
JAX package: every row benign-vs-attack for the binomial fits, the rows
of the five most frequent classes for the multinomial ones.  Both
packages fit with regParam 1e-4 unless a case says otherwise, up to 100
iterations at tol 1e-6.

Tolerances, each with what it measured here when set:

* iterations equal (equal in every case);
* objective history within 1e-5 of the starting objective at every
  iteration (at most 2.4e-7: the JAX package sums per shard of an
  8-device mesh, the port once);
* coefficients and intercepts: within 1e-4 where the optimum is well
  determined — elastic net, bounds, standardization off, binomial L2
  (at most 1.3e-4 on the binomial L2 fit's coefficients of magnitude up
  to 3.5, so that case is held to 1e-3) — and within 2e-2 on the
  multinomial fits, whose near-flat directions the two sums leave at
  different points (6.6e-3 coefficients, 1.3e-2 intercepts);
* training predictions equal on at least 99.9 % of rows (100 %);
* on the raw, unscaled CICIDS2017 features the summarizer's raw f32 Σx²
  (not pilot-shifted, as in the JAX package) loses the variance of
  features whose mean dwarfs their spread, differently in the two
  packages' sums: the histories there part by 1.3e-3 of the start and
  the predictions agree on 99.8 %.  That case is held to 5e-3 and 99 %.
"""

import json

import numpy as np
import pytest
import torch

from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import CICIDS2017_FEATURES
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.evaluation import BinaryClassificationEvaluator as JBinaryEval
from sntc_tpu.feature import StandardScaler as JStandardScaler
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu_torch.app import main
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data import write_raw_csv
from sntc_tpu_torch.evaluation import BinaryClassificationEvaluator
from sntc_tpu_torch.evaluation.binary import area_under_pr, area_under_roc
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import LogisticRegression, LogisticRegressionModel
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

D = len(CICIDS2017_FEATURES)
HIST_TOL = 1e-5


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
        JFrame({"rawFeatures": X}))["f"])
    keep = y < 5
    return {
        "binomial": (Xs, (y > 0).astype(np.float64)),
        "multinomial": (Xs[keep], y[keep]),
        "raw": (X, (y > 0).astype(np.float64)),
    }


CASES = {
    # name: (data, params, coefficient tol, history tol, agreement)
    "binomial": ("binomial", dict(regParam=1e-4), 1e-3, HIST_TOL, 0.999),
    "multinomial": ("multinomial", dict(regParam=1e-4), 2e-2, HIST_TOL,
                    0.999),
    "elastic-net binomial": (
        "binomial", dict(regParam=0.01, elasticNetParam=0.5), 1e-4,
        HIST_TOL, 0.999),
    "lasso multinomial": (
        "multinomial", dict(regParam=0.01, elasticNetParam=1.0), 1e-4,
        HIST_TOL, 0.999),
    "bounds binomial": (
        "binomial", dict(
            regParam=1e-3,
            lowerBoundsOnCoefficients=np.full((1, D), -0.5),
            upperBoundsOnCoefficients=np.full((1, D), 0.5),
            lowerBoundsOnIntercepts=[-1.0], upperBoundsOnIntercepts=[1.0]),
        1e-4, HIST_TOL, 0.999),
    "bounds multinomial": (
        "multinomial", dict(
            regParam=1e-3,
            lowerBoundsOnCoefficients=np.full((5, D), -0.3),
            upperBoundsOnCoefficients=np.full((5, D), 0.3)),
        2e-2, HIST_TOL, 0.999),
    "standardization off": (
        "binomial", dict(regParam=0.01, standardization=False), 1e-4,
        HIST_TOL, 0.999),
    "raw features": ("raw", dict(regParam=1e-4, maxIter=50), None, 5e-3,
                     0.99),
}


@pytest.fixture(scope="module")
def fits(data):
    out = {}
    for name, (which, params, *_rest) in CASES.items():
        X, y = data[which]
        frame = {"features": X, "label": y}
        out[name] = (JLR(**params).fit(JFrame(frame)),
                     LogisticRegression(device="cpu", **params)
                     .fit(Frame(frame)))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_lr_fit_matches_the_jax_package(data, fits, name):
    which, params, coef_tol, hist_tol, agree = CASES[name]
    ref, got = fits[name]
    assert got.is_binomial == ref.is_binomial == (which != "multinomial")
    assert got.summary.totalIterations == ref.summary.totalIterations
    h_ref = np.asarray(ref.summary.objectiveHistory)
    h_got = np.asarray(got.summary.objectiveHistory)
    assert h_got.shape == h_ref.shape
    assert (np.abs(h_got - h_ref) / h_ref[0]).max() <= hist_tol
    if coef_tol is not None:
        np.testing.assert_allclose(got.coefficientMatrix,
                                   ref.coefficientMatrix, atol=coef_tol)
        np.testing.assert_allclose(got.interceptVector,
                                   ref.interceptVector, atol=coef_tol)
        # OWLQN's exact zeros and the bounds' clipped values
        np.testing.assert_array_equal(got.coefficientMatrix == 0,
                                      ref.coefficientMatrix == 0)
    if "bounds" in name:
        lo = params["lowerBoundsOnCoefficients"][0, 0]
        hi = params["upperBoundsOnCoefficients"][0, 0]
        assert (got.coefficientMatrix >= lo - 1e-6).all()
        assert (got.coefficientMatrix <= hi + 1e-6).all()
    X, _ = data[which]
    pred_ref = np.asarray(ref.transform(JFrame({"features": X}))["prediction"])
    pred_got = got.transform(Frame({"features": X}))["prediction"]
    assert (pred_got == pred_ref).mean() >= agree
    assert got.optimizer_stats["iterations"] == got.summary.totalIterations


@pytest.mark.parametrize("name", ["binomial", "multinomial"])
def test_training_summaries_match_the_jax_package(fits, name):
    ref, got = fits[name]
    assert type(got.summary).__name__ == type(ref.summary).__name__
    assert got.summary.accuracy == pytest.approx(ref.summary.accuracy,
                                                 abs=1e-3)
    np.testing.assert_allclose(got.summary.weightedFMeasure(),
                               ref.summary.weightedFMeasure(), atol=1e-3)
    for metric in ("falsePositiveRateByLabel", "precisionByLabel",
                   "recallByLabel", "weightedTruePositiveRate",
                   "weightedFalsePositiveRate", "weightedPrecision"):
        np.testing.assert_allclose(getattr(got.summary, metric),
                                   getattr(ref.summary, metric), atol=1e-3)
    if name == "binomial":
        assert got.summary.areaUnderROC == pytest.approx(
            ref.summary.areaUnderROC, abs=1e-4)
        roc_got, roc_ref = got.summary.roc, ref.summary.roc
        assert roc_got["FPR"][0] == 0.0 and roc_got["TPR"][-1] == 1.0
        assert abs(roc_got.num_rows - roc_ref.num_rows) <= 0.01 * \
            roc_ref.num_rows
        f_got = got.summary.fMeasureByThreshold()["metric"].max()
        f_ref = ref.summary.fMeasureByThreshold()["metric"].max()
        assert f_got == pytest.approx(f_ref, abs=1e-3)
        pr = got.summary.pr
        assert pr["recall"][0] == 0.0 and pr["recall"][-1] == 1.0
        assert got.summary.recallByThreshold["metric"][-1] == 1.0
        assert got.summary.precisionByThreshold.num_rows == \
            roc_got.num_rows - 2


def _scores(seed, n=4000):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.3).astype(np.float64)
    s = np.round(rng.normal(size=n) + 1.5 * y, 1)  # many tied scores
    w = rng.random(n) + 0.5
    return y, s, w


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
def test_binary_evaluator_equals_the_jax_packages(seed, weighted, metric):
    y, s, w = _scores(seed)
    raw = np.stack([-s, s], 1)
    cols = {"label": y, "rawPrediction": raw}
    kw = {"metricName": metric}
    if weighted:
        cols["w"] = w
        kw["weightCol"] = "w"
    got = BinaryClassificationEvaluator(**kw).evaluate(Frame(cols))
    want = JBinaryEval(**kw).evaluate(JFrame(cols))
    assert got == want
    # a tensor column reads the same
    cols["rawPrediction"] = torch.from_numpy(raw)
    assert BinaryClassificationEvaluator(**kw).evaluate(Frame(cols)) == want


def test_binary_areas_on_degenerate_inputs():
    assert area_under_roc(np.ones(4), np.arange(4.0)) == 0.0
    assert area_under_pr(np.zeros(4), np.arange(4.0)) == 0.0
    y = np.array([0.0, 0.0, 1.0, 1.0])
    assert area_under_roc(y, np.array([0.1, 0.2, 0.8, 0.9])) == 1.0


@pytest.mark.parametrize("name", ["binomial", "multinomial"])
def test_lr_models_save_and_load_both_ways(data, fits, tmp_path, name):
    ref, got = fits[name]
    X, _ = data[name]
    jax_save_model(ref, str(tmp_path / "j"))
    port = load_model(str(tmp_path / "j"), device="cpu")
    assert isinstance(port, LogisticRegressionModel)
    assert port.is_binomial == ref.is_binomial
    want = ref.transform(JFrame({"features": X}))
    out = port.transform(Frame({"features": X}))
    for col in ("rawPrediction", "probability"):
        np.testing.assert_allclose(out[col], np.asarray(want[col]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out["prediction"],
                                  np.asarray(want["prediction"]))
    save_model(got, str(tmp_path / "p"))
    back = jax_load_model(str(tmp_path / "p"))
    np.testing.assert_array_equal(back.coefficientMatrix,
                                  got.coefficientMatrix)
    np.testing.assert_array_equal(back.interceptVector, got.interceptVector)
    if name == "binomial":
        assert back.intercept == got.intercept
        np.testing.assert_array_equal(back.coefficients, got.coefficients)
        # Spark's binary raw is [-m, m] and the probability sigmoid(m)
        raw = out["rawPrediction"]
        np.testing.assert_array_equal(raw[:, 0], -raw[:, 1])
        m = raw[:, 1].astype(np.float64)
        np.testing.assert_allclose(out["probability"][:, 1],
                                   1 / (1 + np.exp(-m)), atol=1e-6)


def test_lr_refuses_what_the_jax_package_refuses(data):
    X, y = data["binomial"]
    frame = Frame({"features": X, "label": y})
    with pytest.raises(ValueError, match="only supports none/L2"):
        LogisticRegression(
            device="cpu", elasticNetParam=0.5, regParam=0.1,
            lowerBoundsOnCoefficients=np.zeros((1, D))).fit(frame)
    with pytest.raises(ValueError, match="must have shape"):
        LogisticRegression(
            device="cpu", lowerBoundsOnCoefficients=np.zeros((2, D))).fit(
                frame)
    with pytest.raises(ValueError, match="binomial family with 5"):
        Xm, ym = data["multinomial"]
        LogisticRegression(device="cpu", family="binomial").fit(
            Frame({"features": Xm, "label": ym}))
    # the lane fits give the JAX package's verdicts
    grid = [{"regParam": 0.1}, {"regParam": 0.2}]
    assert LogisticRegression(device="cpu").supports_vectorized_ovr() == \
        JLR().supports_vectorized_ovr()
    assert LogisticRegression(device="cpu").supports_batched_grid(grid) == \
        JLR().supports_batched_grid(grid)


def test_lr_segmented_fit_with_checkpoints_is_bitwise(data, tmp_path):
    X, y = data["multinomial"]
    frame = Frame({"features": X, "label": y})
    plain = LogisticRegression(device="cpu", maxIter=40).fit(frame)
    seg = LogisticRegression(device="cpu", maxIter=40, checkpointInterval=9,
                             checkpointDir=str(tmp_path / "c")).fit(frame)
    np.testing.assert_array_equal(seg.coefficientMatrix,
                                  plain.coefficientMatrix)
    assert seg.summary.objectiveHistory == plain.summary.objectiveHistory


def test_train_command_fits_binary_lr_and_serves(tmp_path, capsys):
    raw = jax_generate_frame(3000, seed=6, min_class_fraction=0.005)
    data = tmp_path / "data"
    data.mkdir()
    write_raw_csv(Frame({c: np.asarray(raw[c]) for c in raw.columns}),
                  str(data / "day.csv"))
    model_dir = str(tmp_path / "model")
    assert main(["train", "--data", str(data), "--estimator", "lr",
                 "--binary", "--reg-param", "1e-4", "--model-out",
                 model_dir, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["estimator"] == "lr" and 0.5 < line["macroF1"] <= 1.0
    assert 0 < line["lbfgs"]["iterations"] <= 100
    model = load_model(model_dir, device="cpu")
    head = model.getStages()[-1]
    assert head.is_binomial and head.getRegParam() == 1e-4
    assert type(model.getStages()[2]).__name__ == "StandardScalerModel"
    assert jax_load_model(model_dir).getStages()[-1].is_binomial

    inp = tmp_path / "in"
    inp.mkdir()
    live = jax_clean_flows(jax_generate_frame(
        300, seed=5, dirty=False)).drop("Label")
    write_raw_csv(Frame({c: np.asarray(live[c]) for c in live.columns}),
                  str(inp / "part_0000.csv"))
    assert main(["serve", "--model", model_dir, "--watch", str(inp),
                 "--out", str(tmp_path / "out"), "--checkpoint",
                 str(tmp_path / "ckpt"), "--once", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["batches"] == 1 and summary["rows"] == 300


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["binomial", "multinomial"])
def test_lr_fit_on_the_card_tracks_the_cpu(data, which):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, y = data[which]
    frame = Frame({"features": X, "label": y})
    cpu = LogisticRegression(device="cpu", regParam=1e-4).fit(frame)
    card = LogisticRegression(device="cuda", regParam=1e-4).fit(frame)
    again = LogisticRegression(device="cuda", regParam=1e-4).fit(frame)
    h_cpu = np.asarray(cpu.summary.objectiveHistory)
    h_card = np.asarray(card.summary.objectiveHistory)
    n = min(len(h_cpu), len(h_card))
    assert (np.abs(h_card[:n] - h_cpu[:n]) / h_cpu[0]).max() <= HIST_TOL
    np.testing.assert_array_equal(card.coefficientMatrix,
                                  again.coefficientMatrix)
    pred_cpu = cpu.transform(frame)["prediction"]
    pred_card = card.transform(frame)["prediction"]
    assert (pred_card == pred_cpu).mean() >= 0.999
