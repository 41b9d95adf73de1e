"""The port's fit path against the JAX package's, on the CPU.

The fit side of bench config 3 — StringIndexer → VectorAssembler →
ChiSqSelector → RandomForestClassifier — at small widths, with the same
numpy inputs through both packages:

* binning, label indexing, chi-square selection and the train/test split
  are equal (bitwise where the arithmetic is the same);
* a random forest fitted without random draws (no bootstrap, every
  feature at every node) has the same trees.  The port draws its bagging
  weights and feature subsets with numpy, the JAX package with
  ``jax.random`` over mesh-padded rows, so with draws the two forests
  differ and only their quality is compared;
* a port-fitted pipeline saved by the port loads in the JAX package and
  predicts the same, and the ``train`` command's model serves.

Split gains are float32 in both packages, so two gains within f32
rounding of each other can pick different splits: a comparison of trees
accepts a differing split only where the two packages' best gains are
within 1e-6 relative, and then skips the subtrees below it.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from sntc_tpu.app import _load_data as jax_load_data
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import CICIDS2017_FEATURES
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.ingest import load_csv_dir as jax_load_csv_dir
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.evaluation import (
    MulticlassClassificationEvaluator as JEvaluator,
)
from sntc_tpu.feature import ChiSqSelector as JChiSqSelector
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.models import RandomForestClassifier as JRandomForest
from sntc_tpu.ops.binning import bin_features as jax_bin_features
from sntc_tpu.ops.binning import quantile_bin_edges as jax_edges
from sntc_tpu_torch.app import _load_data, main
from sntc_tpu_torch.core.base import Estimator, Model, Pipeline, Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import load_csv_dir, write_raw_csv
from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator
from sntc_tpu_torch.feature import (
    ChiSqSelector,
    StringIndexer,
    VectorAssembler,
)
from sntc_tpu_torch.kernels import LAUNCHES
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import RandomForestClassifier
from sntc_tpu_torch.models.tree import grower
from sntc_tpu_torch.ops.binning import bin_features, quantile_bin_edges
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

GAIN_TIE_RTOL = 1e-6


def assert_same_trees(a, b, rtol=GAIN_TIE_RTOL):
    """Heaps equal under the near-tie rule; returns the near-ties seen.
    Where both packages split a node the same way, gain and count agree
    to ``rtol`` (f32 split arithmetic in two libraries) and the rest
    exactly."""
    fa, fb = np.asarray(a.feature), np.asarray(b.feature)
    assert fa.shape == fb.shape and a.max_depth == b.max_depth
    ties = 0
    for t in range(fa.shape[0]):
        stack = [0]
        while stack:
            h = stack.pop()
            ga, gb = float(a.gain[t, h]), float(b.gain[t, h])
            same = fa[t, h] == fb[t, h] and (
                fa[t, h] < 0 or a.threshold[t, h] == b.threshold[t, h]
            )
            if not same:
                assert fa[t, h] >= 0 and fb[t, h] >= 0 and abs(ga - gb) <= \
                    rtol * max(abs(ga), abs(gb)), (
                        f"tree {t} slot {h}: feature {fa[t, h]} vs {fb[t, h]},"
                        f" gain {ga} vs {gb}")
                ties += 1
                continue
            if fa[t, h] >= 0:
                np.testing.assert_allclose(ga, gb, rtol=rtol)
                assert a.count[t, h] == b.count[t, h], (t, h)
                if 2 * h + 2 < fa.shape[1]:
                    stack += [2 * h + 1, 2 * h + 2]
            elif fa[t, h] == -1:
                np.testing.assert_array_equal(a.leaf_stats[t, h],
                                              b.leaf_stats[t, h])
    return ties


def _port_frame(jframe):
    return Frame({c: np.asarray(jframe[c]) for c in jframe.columns})


# -- binning, indexing, selection, split ---------------------------------------


@pytest.mark.parametrize("n,f,max_bins", [(500, 4, 32), (12000, 3, 16),
                                          (300, 5, 128)])
def test_binning_matches_the_jax_package(n, f, max_bins):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[:, 0] = np.round(X[:, 0])  # a low-cardinality feature: duplicate edges
    edges = quantile_bin_edges(X, max_bins=max_bins, seed=3)
    ref = jax_edges(X, max_bins=max_bins, seed=3)  # 12000 rows: sampled
    assert edges.dtype == np.float32 and edges.shape == (f, max_bins - 1)
    np.testing.assert_array_equal(edges, ref)
    got = bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    assert got.dtype == torch.int32 and got.t().is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_bin_features(X, ref)))


@pytest.mark.parametrize("order", ["frequencyDesc", "frequencyAsc",
                                   "alphabetDesc", "alphabetAsc"])
def test_string_indexer_fit_orders_labels_like_the_jax_package(order):
    # "b" and "c" tie on frequency: the string breaks the tie
    values = np.array(list("abcbcaddcbe") + [None, 1.5], dtype=object)
    kw = dict(inputCol="Label", outputCol="label", stringOrderType=order)
    port = StringIndexer(**kw).fit(Frame({"Label": values}))
    ref = JStringIndexer(**kw).fit(JFrame({"Label": values}))
    assert port.labels == ref.labels
    assert port.paramValues() == ref.paramValues()


@pytest.fixture(scope="module")
def flows():
    """2 000 clean CICIDS2017-schema rows, label-indexed and assembled."""
    raw = jax_clean_flows(jax_generate_frame(2000, seed=0))
    jframe = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="rawFeatures"),
    ]).fit(raw).transform(raw)
    return raw, jframe


@pytest.mark.parametrize("top", [10, 40])
def test_chisq_selector_picks_the_jax_packages_features(flows, top):
    _raw, jframe = flows
    kw = dict(numTopFeatures=top, featuresCol="rawFeatures",
              labelCol="label", outputCol="features")
    ref = JChiSqSelector(**kw).fit(jframe)
    before = dict(LAUNCHES)
    port = ChiSqSelector(device="cpu", **kw).fit(_port_frame(jframe))
    assert LAUNCHES == before  # the plain version on the CPU
    assert port.selected_features == ref.selected_features
    assert port.paramValues() == ref.paramValues()


def test_random_split_takes_the_jax_packages_rows(flows):
    raw, _ = flows
    idx = np.arange(raw.num_rows, dtype=np.float64)
    for weights, seed in (([0.8, 0.2], 0), ([0.5, 0.3, 0.2], 7)):
        ref = JFrame({"i": idx}).random_split(weights, seed=seed)
        got = Frame({"i": idx}).random_split(weights, seed=seed)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g["i"], np.asarray(r["i"]))


def test_load_csv_dir_matches_the_jax_package(tmp_path):
    raw = jax_generate_frame(300, seed=9)
    port = Frame({c: np.asarray(raw[c]) for c in raw.columns})
    write_raw_csv(port.slice(0, 120), str(tmp_path / "b_day.csv"))
    write_raw_csv(port.slice(120, 300), str(tmp_path / "a_day.csv"))
    got, ref = load_csv_dir(str(tmp_path)), jax_load_csv_dir(str(tmp_path))
    assert got.columns == ref.columns and got.num_rows == 300
    for c in ref.columns:
        np.testing.assert_array_equal(got[c], np.asarray(ref[c]))
    with pytest.raises(FileNotFoundError):
        load_csv_dir(str(tmp_path / "none"))


@pytest.mark.parametrize("binary", [False, True])
def test_train_data_loading_matches_the_jax_package(tmp_path, binary):
    raw = jax_generate_frame(400, seed=10)
    write_raw_csv(_port_frame(raw), str(tmp_path / "day.csv"))
    args = argparse.Namespace(data=str(tmp_path), binary=binary,
                              label_col="Label")
    got, ref = _load_data(args), jax_load_data(args)
    assert got.columns == ref.columns and got.num_rows == ref.num_rows
    for c in ref.columns:
        np.testing.assert_array_equal(got[c], np.asarray(ref[c]))
    assert set(got["Label"]) <= ({"benign", "attack"} if binary
                                 else set(np.asarray(ref["Label"])))


def test_evaluator_matches_the_jax_package():
    rng = np.random.default_rng(2)
    label = rng.integers(0, 6, 400).astype(np.float64)
    pred = np.where(rng.random(400) < 0.7, label,
                    rng.integers(0, 7, 400)).astype(np.float64)
    w = rng.random(400)
    for name in ("f1", "accuracy", "weightedPrecision", "weightedRecall",
                 "macroF1"):
        for wcol in (None, "w"):
            cols = {"label": label, "prediction": pred, "w": w}
            got = MulticlassClassificationEvaluator(
                metricName=name, weightCol=wcol).evaluate(Frame(cols))
            ref = JEvaluator(metricName=name, weightCol=wcol).evaluate(
                JFrame(cols))
            # the JAX package sums the weights in float32, the port in
            # float64: unit weights agree exactly, fractional ones to f32
            np.testing.assert_allclose(got, ref, rtol=0 if wcol is None
                                       else 1e-6)


def test_pipeline_fit_transforms_nothing_after_the_last_estimator():
    calls = []

    class Add(Transformer):
        def transform(self, frame):
            calls.append("transform")
            return frame.with_column("y", to_host(frame["x"]) + 1)

    class Fitted(Model):
        def transform(self, frame):
            calls.append("model.transform")
            return frame

    class Est(Estimator):
        def _fit(self, frame):
            calls.append(("fit", sorted(frame.columns)))
            return Fitted()

    pm = Pipeline(stages=[Add(), Est(), Add()]).fit(
        Frame({"x": np.zeros(3)}))
    assert calls == ["transform", ("fit", ["x", "y"])]
    assert [type(s).__name__ for s in pm.getStages()] == ["Add", "Fitted", "Add"]


# -- the forest ------------------------------------------------------------------


def _rng_free_data():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(1200, 8)).astype(np.float32)
    y = ((X[:, 0] > 0) * 2 + (X[:, 3] > 0.2) + (X[:, 5] > 1)).astype(np.float64)
    return X, y


RNG_FREE = dict(numTrees=3, maxDepth=5, seed=0, bootstrap=False,
                featureSubsetStrategy="all")


@pytest.fixture(scope="module")
def rng_free_fits():
    X, y = _rng_free_data()
    ref = JRandomForest(**RNG_FREE).fit(JFrame({"features": X, "label": y}))
    port = RandomForestClassifier(device="cpu", **RNG_FREE).fit(
        Frame({"features": X, "label": y}))
    return X, y, ref, port


def test_rf_fit_without_draws_grows_the_jax_packages_trees(rng_free_fits):
    X, _y, ref, port = rng_free_fits
    assert port.num_classes == ref.num_classes == 5
    assert port.device == torch.device("cpu")
    assert_same_trees(port.forest, ref.forest)
    np.testing.assert_allclose(port.featureImportances,
                               ref.featureImportances, rtol=1e-6)
    got = port.transform(Frame({"features": X}))
    want = ref.transform(JFrame({"features": X}))
    np.testing.assert_array_equal(to_host(got["prediction"]),
                                  np.asarray(want["prediction"]))


@pytest.mark.parametrize("params", [
    {"impurity": "entropy"},  # log from two libraries: gains to f32 rounding
    {"minInstancesPerNode": 20, "minInfoGain": 0.01},
    {"maxBins": 16, "maxDepth": 7},
])
def test_rf_fit_without_draws_matches_under_other_params(params):
    X, y = _rng_free_data()
    kw = dict(RNG_FREE, **params)
    ref = JRandomForest(**kw).fit(JFrame({"features": X, "label": y}))
    port = RandomForestClassifier(device="cpu", **kw).fit(
        Frame({"features": X, "label": y}))
    assert (port.forest.feature >= 0).sum() > 20
    assert_same_trees(port.forest, ref.forest)


def _grow_inputs(X, y, device="cpu"):
    """What ``RandomForestClassifier._fit`` hands the grower, without
    bagging: bins ``[F, N]``, one-hot stats, unit weights."""
    edges = quantile_bin_edges(X, max_bins=32, seed=0)
    binned_t = bin_features(torch.from_numpy(X), torch.from_numpy(edges)).t()
    stats = torch.nn.functional.one_hot(
        torch.from_numpy(y.astype(np.int64)), 5).to(torch.float32)
    w = torch.ones((3, len(y)), dtype=torch.float32)
    return binned_t, stats, w, edges


@pytest.mark.parametrize("budget", [None, 5 * 3 * 8 * 32 * 5 * 4 * 2])
def test_rf_grower_with_sibling_subtraction_and_node_groups(
    rng_free_fits, monkeypatch, budget
):
    # sibling subtraction (on by default only on the card) through
    # grow_forest's own argument; a small node-group budget makes the
    # deeper levels take several passes of 2 nodes
    X, y, ref, _port = rng_free_fits
    if budget is not None:
        monkeypatch.setattr(grower, "NODE_GROUP_BUDGET_BYTES", budget)
        assert grower.node_group_size(3, 8, 32, 5) == 2
    binned_t, stats, w, edges = _grow_inputs(X, y)
    kw = dict(n_bins=32, max_depth=5, min_instances_per_node=1.0,
              min_info_gain=0.0, subset_k=8, impurity="gini")
    with_sib = grower.grow_forest(binned_t, stats, w, edges, sibling=True, **kw)
    without = grower.grow_forest(binned_t, stats, w, edges, sibling=False, **kw)
    assert_same_trees(with_sib, ref.forest)
    for name in ("feature", "threshold", "leaf_stats", "gain", "count"):
        np.testing.assert_array_equal(getattr(with_sib, name),
                                      getattr(without, name))


def test_rf_depth_zero_is_one_leaf_of_weighted_class_counts(rng_free_fits):
    X, y, _ref, _port = rng_free_fits
    m = RandomForestClassifier(device="cpu", numTrees=2, maxDepth=0).fit(
        Frame({"features": X, "label": y}))
    f = m.forest
    assert (f.feature[:, 0] == -1).all() and f.feature.shape == (2, 1)
    jm = JRandomForest(numTrees=2, maxDepth=0).fit(
        JFrame({"features": X, "label": y}))
    # bagging draws differ, but each tree's root holds its bagged counts
    assert f.leaf_stats.shape == np.asarray(jm.forest.leaf_stats).shape
    assert np.isclose(f.leaf_stats[:, 0].sum(axis=1), len(y), rtol=0.1).all()


@pytest.fixture(scope="module")
def pipelines():
    """A config-3-shaped pipeline at small widths (ChiSq top 20, 10
    trees of depth 8, the forest's default draws), fitted by both
    packages on the same train split."""
    raw = jax_clean_flows(jax_generate_frame(12000, seed=2,
                                             min_class_fraction=0.005))
    jtrain, jtest = raw.random_split([0.8, 0.2], seed=0)
    train, test = _port_frame(raw).random_split([0.8, 0.2], seed=0)

    def stages(pkg, seed):
        si, va, cs, rf = (
            (JStringIndexer, JVectorAssembler, JChiSqSelector, JRandomForest)
            if pkg == "jax" else
            (StringIndexer, VectorAssembler, ChiSqSelector, RandomForestClassifier)
        )
        dev = {} if pkg == "jax" else {"device": "cpu"}
        return [
            si(inputCol="Label", outputCol="label", handleInvalid="skip"),
            va(inputCols=CICIDS2017_FEATURES, outputCol="rawFeatures"),
            cs(numTopFeatures=20, featuresCol="rawFeatures",
               labelCol="label", outputCol="features", **dev),
            rf(numTrees=10, maxDepth=8, seed=seed, **dev),
        ]

    ref = JPipeline(stages=stages("jax", 0)).fit(jtrain)
    port = Pipeline(stages=stages("port", 0)).fit(train)
    again = Pipeline(stages=stages("port", 0)).fit(train)
    return ref, port, again, jtest, test


# A single fit's held-out macro-F1 on this data moves by up to 0.09 from
# one seed to another in either package (measured over seeds 0-5: JAX
# 0.577-0.668, the port 0.599-0.723), and the two packages' draws are
# unrelated, so their F1s can differ by about that much: the band is 0.1.
F1_BAND = 0.1


def test_rf_fit_with_draws_is_repeatable_and_as_good_as_the_jax_packages(
    pipelines
):
    ref, port, again, jtest, test = pipelines
    a, b = port.getStages()[-1].forest, again.getStages()[-1].forest
    for name in ("feature", "threshold", "leaf_stats", "gain", "count"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert port.getStages()[2].selected_features == \
        ref.getStages()[2].selected_features
    f1 = MulticlassClassificationEvaluator(metricName="macroF1").evaluate(
        port.transform(test))
    f1_ref = JEvaluator(metricName="macroF1").evaluate(ref.transform(jtest))
    assert abs(f1 - f1_ref) <= F1_BAND, (f1, f1_ref)
    assert f1 > 0.5


def test_port_fitted_pipeline_loads_in_the_jax_package(pipelines, tmp_path):
    _ref, port, _again, jtest, test = pipelines
    save_model(port, str(tmp_path / "m"))
    back = jax_load_model(str(tmp_path / "m"))
    assert [type(s).__name__ for s in back.getStages()] == [
        "StringIndexerModel", "VectorAssembler", "ChiSqSelectorModel",
        "RandomForestClassificationModel",
    ]
    got = port.transform(test)
    want = back.transform(jtest)
    np.testing.assert_array_equal(to_host(got["prediction"]),
                                  np.asarray(want["prediction"]))
    np.testing.assert_allclose(to_host(got["probability"]),
                               np.asarray(want["probability"]), rtol=1e-5)
    reloaded = load_model(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(
        to_host(reloaded.transform(test)["prediction"]),
        to_host(got["prediction"]))


def test_train_command_fits_saves_and_serves(tmp_path, capsys):
    raw = jax_generate_frame(2500, seed=4, min_class_fraction=0.005)
    data = tmp_path / "data"
    data.mkdir()
    write_raw_csv(_port_frame(raw), str(data / "day.csv"))
    model_dir = str(tmp_path / "model")
    assert main(["train", "--data", str(data), "--estimator", "rf",
                 "--chisq-top", "10", "--num-trees", "4", "--max-depth", "5",
                 "--model-out", model_dir, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["estimator"] == "rf" and line["model_out"] == model_dir
    assert 0.0 < line["macroF1"] <= 1.0 and line["fit_wall_clock_s"] > 0
    assert line["kernel_launches"] == {"forest_traversal": 0,
                                       "pad_assemble": 0, "tree_hist": 0}
    n_clean = jax_clean_flows(raw).num_rows
    assert line["train_rows"] == len(
        JFrame({"i": np.arange(n_clean)}).random_split([0.8, 0.2])[0])

    inp = tmp_path / "in"
    inp.mkdir()
    live = _port_frame(jax_clean_flows(jax_generate_frame(
        300, seed=5, dirty=False)).drop("Label"))
    write_raw_csv(live, str(inp / "part_0000.csv"))
    assert main(["serve", "--model", model_dir, "--watch", str(inp),
                 "--out", str(tmp_path / "out"), "--checkpoint",
                 str(tmp_path / "ckpt"), "--once", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["batches"] == 1 and summary["rows"] == 300


def test_train_command_refuses_unported_estimators_and_missing_cuda(
    tmp_path, monkeypatch, capsys
):
    # every estimator of the JAX command is ported; a name it does not
    # offer is refused by the parser
    with pytest.raises(SystemExit):
        main(["train", "--data", str(tmp_path), "--estimator", "kmeans",
              "--device", "cpu"])
    assert "invalid choice: 'kmeans'" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for estimator in ("rf", "nb", "svc"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["train", "--data", str(tmp_path), "--estimator",
                  estimator])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["evaluate", "--data", str(tmp_path), "--model",
              str(tmp_path)])