"""The port's StandardScaler and MLP (bench config 2's pipeline) against
the JAX package's, on the CPU.

Inputs: 2 973 clean CICIDS2017-schema rows from the JAX package's
synthetic generator (seed 3) in its five most frequent classes, label-
indexed and assembled by the JAX package, then scaled; 2 000 rows fit,
the rest are held out.  Layers ``[78, 16, 5]``, 30 iterations, seed 0.

Tolerances, each with what it measured here when set:

* scaler: mean within 1e-4 absolute and std within 1e-4 relative
  (2.1e-5 / 2.1e-5: the JAX package sums per shard of an 8-device mesh,
  the port once); the scaled features within 1e-3 absolute (3.1e-4);
* Glorot init: bitwise (both draw from numpy ``default_rng(seed)``);
* float32 fits (``l-bfgs`` and ``gd``): the objective history within
  1e-5 of the starting objective at every one of the 30 iterations
  (5.2e-7 and 1.9e-7), held-out predictions agreeing on at least 99 %
  of rows (100 %).  Two f32 LBFGS runs of a non-convex loss drift apart
  once their rounding differs, so weights are not compared, and a
  longer run is held by quality, not by its history;
* ``computeDtype="bfloat16"``: both packages round the products' inputs
  to bf16 and accumulate in f32, but round the gradients' bf16 cotangents
  in other orders, so the history is held within 1e-5 of the start over
  the first 10 iterations (0 to 3.5e-7) and 2e-3 over all 30 (7.0e-4 at
  iteration 16), predictions on at least 99 % of rows (99.79 %);
* serving the same weights: raw and probability within 1e-5, predictions
  equal wherever the top two probabilities are more than 1e-5 apart.
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
from sntc_tpu.feature import StandardScaler as JStandardScaler
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import MultilayerPerceptronClassifier as JMLP
from sntc_tpu_torch.app import main
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import write_raw_csv
from sntc_tpu_torch.feature import StandardScaler
from sntc_tpu_torch.kernels import LAUNCHES
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import (
    MultilayerPerceptronClassificationModel,
    MultilayerPerceptronClassifier,
)
from sntc_tpu_torch.models.mlp import glorot_init
from sntc_tpu_torch.serve import BatchPredictor
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

LAYERS = [78, 16, 5]
ITERS = 30
N_TRAIN = 2000
SERVE_TOL = 1e-5


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
    keep = y < LAYERS[-1]
    X, y = X[keep], y[keep]
    scaler = JStandardScaler(inputCol="rawFeatures", outputCol="features",
                             withMean=True).fit(JFrame({"rawFeatures": X}))
    Xs = np.asarray(scaler.transform(JFrame({"rawFeatures": X}))["features"])
    return {"X": X, "Xs": Xs, "y": y, "scaler": scaler}


def _train(data):
    return {"features": data["Xs"][:N_TRAIN], "label": data["y"][:N_TRAIN]}


def _held_out(data):
    return data["Xs"][N_TRAIN:]


@pytest.fixture(scope="module")
def fits(data):
    """(JAX model, port model) for each solver/dtype."""
    out = {}
    for name, extra in (("l-bfgs", {}), ("gd", {"solver": "gd",
                                                "stepSize": 0.5}),
                        ("bf16", {"computeDtype": "bfloat16"})):
        kw = dict(layers=LAYERS, maxIter=ITERS, seed=0, **extra)
        out[name] = (JMLP(**kw).fit(JFrame(_train(data))),
                     MultilayerPerceptronClassifier(device="cpu", **kw)
                     .fit(Frame(_train(data))))
    return out


@pytest.mark.parametrize("with_mean", [True, False])
def test_standard_scaler_matches_the_jax_package(data, with_mean):
    X = data["X"]
    kw = dict(inputCol="rawFeatures", outputCol="features",
              withMean=with_mean)
    ref = JStandardScaler(**kw).fit(JFrame({"rawFeatures": X}))
    got = StandardScaler(device="cpu", **kw).fit(Frame({"rawFeatures": X}))
    assert got.paramValues() == ref.paramValues()
    np.testing.assert_allclose(got.mean, ref.mean, atol=1e-4)
    np.testing.assert_allclose(got.std, ref.std, rtol=1e-4)
    assert ((got.std == 0) == (ref.std == 0)).all()
    scaled = got.transform(Frame({"rawFeatures": X}))["features"]
    want = np.asarray(ref.transform(JFrame({"rawFeatures": X}))["features"])
    assert scaled.dtype == np.float32
    np.testing.assert_allclose(scaled, want, atol=1e-3)
    # a tensor column scales on its own device, to the host path's values
    on_dev = got.transform(Frame({"rawFeatures": torch.from_numpy(X)}))
    assert torch.equal(on_dev["features"], torch.from_numpy(scaled))


def test_scaler_moments_are_pilot_shifted():
    """A feature whose mean dwarfs its spread keeps its variance (raw
    f32 Σx² would cancel it to 0)."""
    rng = np.random.default_rng(0)
    X = np.stack([1e4 + rng.normal(size=5000),
                  rng.normal(size=5000)], 1).astype(np.float32)
    got = StandardScaler(device="cpu", inputCol="x").fit(Frame({"x": X}))
    ref = JStandardScaler(inputCol="x").fit(JFrame({"x": X}))
    np.testing.assert_allclose(got.std, X.astype(np.float64).std(0, ddof=1),
                               rtol=1e-3)
    np.testing.assert_allclose(got.std, ref.std, rtol=1e-4)


def test_glorot_init_is_the_jax_packages(data):
    ref = JMLP(layers=LAYERS, maxIter=0, seed=7).fit(JFrame(_train(data)))
    got = MultilayerPerceptronClassifier(
        device="cpu", layers=LAYERS, maxIter=0, seed=7).fit(
            Frame(_train(data)))
    np.testing.assert_array_equal(got.weights, ref.weights)
    np.testing.assert_array_equal(glorot_init(tuple(LAYERS), 7), ref.weights)


@pytest.mark.parametrize("name,prefix,prefix_tol,all_tol", [
    ("l-bfgs", ITERS, 1e-5, 1e-5),
    ("gd", ITERS, 1e-5, 1e-5),
    ("bf16", 10, 1e-5, 2e-3),
])
def test_mlp_fit_tracks_the_jax_packages_history(data, fits, name, prefix,
                                                 prefix_tol, all_tol):
    ref, got = fits[name]
    assert got.summary.totalIterations == ref.summary.totalIterations == ITERS
    h_ref = np.asarray(ref.summary.objectiveHistory)
    h_got = np.asarray(got.summary.objectiveHistory)
    assert h_got.shape == h_ref.shape == (ITERS + 1,)
    gap = np.abs(h_got - h_ref) / h_ref[0]
    assert gap[: prefix + 1].max() <= prefix_tol, gap
    assert gap.max() <= all_tol, gap
    pred_ref = np.asarray(
        ref.transform(JFrame({"features": _held_out(data)}))["prediction"])
    pred_got = got.transform(Frame({"features": _held_out(data)}))[
        "prediction"]
    assert (pred_got == pred_ref).mean() >= 0.99
    assert got.getComputeDtype() == ref.getComputeDtype()
    assert got.optimizer_stats["iterations"] == ITERS


def test_mlp_training_summary_matches_the_jax_package(fits):
    ref, got = fits["l-bfgs"]
    assert got.summary.accuracy == pytest.approx(ref.summary.accuracy,
                                                 abs=1e-3)
    np.testing.assert_allclose(got.summary.fMeasureByLabel(),
                               ref.summary.fMeasureByLabel(), atol=1e-2)
    np.testing.assert_allclose(got.summary.labels, ref.summary.labels)


def test_initial_weights_start_the_fit_and_are_checked(data):
    theta = np.random.default_rng(1).normal(
        scale=0.1, size=78 * 16 + 16 + 16 * 5 + 5).astype(np.float32)
    ref = JMLP(layers=LAYERS, maxIter=5, initialWeights=theta).fit(
        JFrame(_train(data)))
    got = MultilayerPerceptronClassifier(
        device="cpu", layers=LAYERS, maxIter=5, initialWeights=theta).fit(
            Frame(_train(data)))
    h_ref = np.asarray(ref.summary.objectiveHistory)
    h_got = np.asarray(got.summary.objectiveHistory)
    assert abs(h_got[0] - h_ref[0]) <= 1e-6 * h_ref[0]
    np.testing.assert_allclose(h_got, h_ref, rtol=1e-5)
    with pytest.raises(ValueError, match="initialWeights must have"):
        MultilayerPerceptronClassifier(
            device="cpu", layers=LAYERS, initialWeights=theta[:-1]).fit(
                Frame(_train(data)))
    with pytest.raises(ValueError, match="layers\\[0\\]=77"):
        MultilayerPerceptronClassifier(device="cpu", layers=[77, 5]).fit(
            Frame(_train(data)))
    with pytest.raises(ValueError, match="output layer size 3"):
        MultilayerPerceptronClassifier(device="cpu", layers=[78, 3]).fit(
            Frame(_train(data)))


def _top_two_gap(prob):
    s = np.sort(prob, axis=1)
    return s[:, -1] - s[:, -2]


def test_serving_the_same_weights_matches_the_jax_package(data, fits):
    ref, _ = fits["l-bfgs"]
    port = MultilayerPerceptronClassificationModel(
        weights=ref.weights, layers=LAYERS, device="cpu")
    X = _held_out(data)
    want = ref.transform(JFrame({"features": X}))
    got = port.transform(Frame({"features": X}))
    for col in ("rawPrediction", "probability"):
        np.testing.assert_allclose(got[col], np.asarray(want[col]),
                                   atol=SERVE_TOL)
    clear = _top_two_gap(np.asarray(want["probability"])) > SERVE_TOL
    np.testing.assert_array_equal(got["prediction"][clear],
                                  np.asarray(want["prediction"])[clear])
    # per-class thresholds take the shared packed rule
    ts = [0.5, 1.0, 1.0, 1.0, 0.2]
    port.set("thresholds", ts)
    ref.set("thresholds", ts)
    np.testing.assert_array_equal(
        port.transform(Frame({"features": X}))["prediction"],
        np.asarray(ref.transform(JFrame({"features": X}))["prediction"]))
    ref.set("thresholds", None)


def _jax_pipeline(data):
    """A scaler -> MLP pipeline fitted by the JAX package."""
    X, y = data["X"][:N_TRAIN], data["y"][:N_TRAIN]
    return JPipeline(stages=[
        JStandardScaler(inputCol="rawFeatures", outputCol="features",
                        withMean=True),
        JMLP(layers=LAYERS, maxIter=10, seed=0),
    ]).fit(JFrame({"rawFeatures": X, "label": y}))


def test_jax_saved_pipeline_serves_in_the_port_and_back(data, tmp_path):
    jmodel = _jax_pipeline(data)
    jax_save_model(jmodel, str(tmp_path / "j"))
    port = load_model(str(tmp_path / "j"), device="cpu")
    assert [type(s).__name__ for s in port.getStages()] == [
        "StandardScalerModel", "MultilayerPerceptronClassificationModel"]
    X = data["X"][N_TRAIN:]
    want = jmodel.transform(JFrame({"rawFeatures": X}))
    got = port.transform(Frame({"rawFeatures": X}))
    np.testing.assert_allclose(got["probability"],
                               np.asarray(want["probability"]), atol=1e-4)
    clear = _top_two_gap(np.asarray(want["probability"])) > 1e-4
    np.testing.assert_array_equal(got["prediction"][clear],
                                  np.asarray(want["prediction"])[clear])
    # bucket-padded serving (pad_assemble's plain version on the CPU)
    # gives the unpadded predictions
    before = dict(LAUNCHES)
    padded = BatchPredictor(port, bucket_rows=1024, device="cpu") \
        .predict_frame(Frame({"rawFeatures": X}))
    assert LAUNCHES == before
    np.testing.assert_allclose(to_host(padded["probability"]),
                               got["probability"], atol=SERVE_TOL)
    # the port saves it again and the JAX package serves that
    save_model(port, str(tmp_path / "p"))
    back = jax_load_model(str(tmp_path / "p"))
    again = back.transform(JFrame({"rawFeatures": X}))
    np.testing.assert_array_equal(np.asarray(again["probability"]),
                                  np.asarray(want["probability"]))
    assert back.getStages()[1].getLayers() == LAYERS


def test_segmented_fit_with_checkpoints_is_bitwise(data, tmp_path):
    kw = dict(layers=LAYERS, maxIter=ITERS, seed=0)
    plain = MultilayerPerceptronClassifier(device="cpu", **kw).fit(
        Frame(_train(data)))
    seg = MultilayerPerceptronClassifier(
        device="cpu", checkpointInterval=7,
        checkpointDir=str(tmp_path / "ckpt"), **kw).fit(Frame(_train(data)))
    np.testing.assert_array_equal(seg.weights, plain.weights)
    assert seg.summary.objectiveHistory == plain.summary.objectiveHistory
    assert not (tmp_path / "ckpt" / "lbfgs_state.npz").exists()


def test_train_command_fits_the_default_mlp_and_serves(tmp_path, capsys):
    raw = jax_generate_frame(3000, seed=4, min_class_fraction=0.005)
    data = tmp_path / "data"
    data.mkdir()
    write_raw_csv(Frame({c: np.asarray(raw[c]) for c in raw.columns}),
                  str(data / "day.csv"))
    model_dir = str(tmp_path / "model")
    assert main(["train", "--data", str(data), "--max-iter", "15",
                 "--model-out", model_dir, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["estimator"] == "mlp" and 0.0 < line["macroF1"] <= 1.0
    assert line["lbfgs"]["iterations"] == 15
    assert line["lbfgs"]["evaluations"] >= 16
    stages = jax_load_model(model_dir).getStages()
    assert [type(s).__name__ for s in stages] == [
        "StringIndexerModel", "VectorAssembler", "StandardScalerModel",
        "MultilayerPerceptronClassificationModel"]
    # the default layers tracked the data's 78 features and its classes
    n_classes = len(stages[0].labels)
    assert stages[3].getLayers() == [78, 64, n_classes]
    assert stages[2].getWithMean()

    inp = tmp_path / "in"
    inp.mkdir()
    live = jax_clean_flows(jax_generate_frame(
        700, seed=5, dirty=False)).drop("Label")
    write_raw_csv(Frame({c: np.asarray(live[c]) for c in live.columns}),
                  str(inp / "part_0000.csv"))
    assert main(["serve", "--model", model_dir, "--watch", str(inp),
                 "--out", str(tmp_path / "out"), "--checkpoint",
                 str(tmp_path / "ckpt"), "--shape-buckets", "256",
                 "--once", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["batches"] == 1 and summary["rows"] == 700
    with pytest.raises(SystemExit, match="--layers output width"):
        main(["train", "--data", str(data), "--layers", "78,8,3",
              "--device", "cpu"])


@pytest.mark.cuda
def test_mlp_fit_on_the_card_tracks_the_cpu(data):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(layers=LAYERS, maxIter=ITERS, seed=0)
    cpu = MultilayerPerceptronClassifier(device="cpu", **kw).fit(
        Frame(_train(data)))
    card = MultilayerPerceptronClassifier(device="cuda", **kw).fit(
        Frame(_train(data)))
    again = MultilayerPerceptronClassifier(device="cuda", **kw).fit(
        Frame(_train(data)))
    h_cpu = np.asarray(cpu.summary.objectiveHistory)
    h_card = np.asarray(card.summary.objectiveHistory)
    assert (np.abs(h_card - h_cpu) / h_cpu[0]).max() <= 1e-5
    np.testing.assert_array_equal(card.weights, again.weights)
    pred_cpu = cpu.transform(Frame({"features": _held_out(data)}))
    pred_card = card.transform(Frame({"features": _held_out(data)}))
    assert (pred_card["prediction"] == pred_cpu["prediction"]).mean() >= 0.99
