"""The port's decision tree, boosting and one-vs-rest against the JAX
package's, on the CPU.

Bench config 4 is OneVsRest over gradient-boosted trees; the single
decision tree shares its grower.  At small widths (3 000 rows, 12
features, 4 classes, 3 rounds of depth 3, 32 bins), the same numpy
inputs go through both packages:

* the decision tree's stats are integer class counts, exact in any
  order, so its heaps are bitwise equal to the JAX package's;
* boosting's stats ``[w, wr, wr²]`` are signed and fractional: the two
  packages take their sums and their ``exp`` in other orders and
  libraries, so trees are compared under the near-tie rule (a differing
  split only where the two best gains are within ``GAIN_TIE_RTOL``),
  leaf stats to ``LEAF_RTOL`` and margins to ``MARGIN_ATOL``;
* the port's own paths (vectorized and sequential one-vs-rest, fused
  and per-model serving, checkpointed and straight fits) run the same
  PyTorch arithmetic and are held bitwise, or to f32 rounding where the
  sums differ in order;
* models cross between the packages through the shared directory
  format, and the ``train`` command fits, saves and serves both.
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
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import DecisionTreeClassifier as JDecisionTree
from sntc_tpu.models import GBTClassifier as JGBT
from sntc_tpu.models import OneVsRest as JOneVsRest
from sntc_tpu_torch.app import main
from sntc_tpu_torch.core.base import Pipeline
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import write_raw_csv
from sntc_tpu_torch.feature import StringIndexer, VectorAssembler
from sntc_tpu_torch.kernels import LAUNCHES
from sntc_tpu_torch.kernels.forest import forest_leaf_stats_reference
from sntc_tpu_torch.mlio import load_model, optimizer_checkpoint, save_model
from sntc_tpu_torch.models import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    GBTClassificationModel,
    GBTClassifier,
    OneVsRest,
    OneVsRestModel,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

GAIN_TIE_RTOL = 1e-5  # f32 gains of fractional stats in two libraries
# A leaf's stats are sums of w, w·r and w·r² over its rows with |r| <= 2,
# so no sum of absolute contributions exceeds 4·w: each leaf stat agrees
# to LEAF_RTOL of that.
LEAF_RTOL = 1e-5
MARGIN_ATOL = 1e-4  # a row's boosted margin after each round
GBT = dict(maxIter=3, maxDepth=3, maxBins=32, seed=0)


def _blobs(n=3000, f=12, k=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = np.argmax(X[:, :k] + 0.7 * rng.normal(size=(n, k)), axis=1)
    return X, y.astype(np.float64)


def assert_same_boosted_trees(a, b):
    """Heaps equal under the near-tie rule; returns the near-ties seen.
    Where both split a node the same way, gain and count agree to
    GAIN_TIE_RTOL; leaf stats to LEAF_RTOL of 4·w."""
    fa, fb = np.asarray(a.feature), np.asarray(b.feature)
    assert fa.shape == fb.shape and a.max_depth == b.max_depth
    ties = 0
    for t in range(fa.shape[0]):
        stack = [0]
        while stack:
            h = stack.pop()
            ga, gb = float(a.gain[t, h]), float(b.gain[t, h])
            same = fa[t, h] == fb[t, h] and (
                fa[t, h] < 0 or a.threshold[t, h] == b.threshold[t, h])
            if not same:
                assert fa[t, h] >= 0 and fb[t, h] >= 0 and abs(ga - gb) <= \
                    GAIN_TIE_RTOL * max(abs(ga), abs(gb)), (
                        f"tree {t} slot {h}: feature {fa[t, h]} vs "
                        f"{fb[t, h]}, gain {ga} vs {gb}")
                ties += 1
                continue
            if fa[t, h] >= 0:
                np.testing.assert_allclose(ga, gb, rtol=GAIN_TIE_RTOL)
                np.testing.assert_allclose(a.count[t, h], b.count[t, h],
                                           rtol=GAIN_TIE_RTOL)
                if 2 * h + 2 < fa.shape[1]:
                    stack += [2 * h + 1, 2 * h + 2]
            elif fa[t, h] == -1:
                la = np.asarray(a.leaf_stats[t, h], np.float64)
                lb = np.asarray(b.leaf_stats[t, h], np.float64)
                assert (np.abs(la - lb) <= LEAF_RTOL * 4 * max(la[0], lb[0])
                        ).all(), (t, h, la, lb)
    return ties


def staged_margins(forest, tree_weights, X) -> np.ndarray:
    """A model's margin ``[M, N]`` after each of its M rounds, by the
    port's plain walk in float64 sums, whichever package grew it."""
    stats = forest_leaf_stats_reference(
        torch.from_numpy(X), *(torch.from_numpy(np.asarray(a)) for a in (
            forest.feature, forest.threshold, forest.leaf_stats)),
        max_depth=forest.max_depth,
    ).double().numpy()
    values = stats[..., 1] / np.maximum(stats[..., 0], 1e-12)
    return np.cumsum(np.asarray(tree_weights, np.float64)[:, None] * values,
                     axis=0)


@pytest.fixture(scope="module")
def ovr_fits():
    X, y = _blobs()
    ref = JOneVsRest(classifier=JGBT(**GBT)).fit(
        JFrame({"features": X, "label": y}))
    port = OneVsRest(classifier=GBTClassifier(device="cpu", **GBT)).fit(
        Frame({"features": X, "label": y}))
    return X, y, ref, port


# -- the decision tree -----------------------------------------------------


@pytest.fixture(scope="module")
def dt_pipelines(tmp_path_factory):
    """A config-4-shaped decision-tree pipeline (label indexer, the 78
    raw features, a depth-5 tree of 32 bins) fitted by both packages on
    one split of synthetic flows, and the JAX one saved."""
    raw = jax_clean_flows(jax_generate_frame(3000, seed=1,
                                             min_class_fraction=0.005))
    jtrain, jtest = raw.random_split([0.8, 0.2], seed=0)

    def port(jframe):
        return Frame({c: np.asarray(jframe[c]) for c in jframe.columns})

    def stages(si, va, dt, **dev):
        return [si(inputCol="Label", outputCol="label", handleInvalid="skip"),
                va(inputCols=CICIDS2017_FEATURES, outputCol="rawFeatures"),
                dt(maxDepth=5, maxBins=32, featuresCol="rawFeatures", **dev)]

    ref = JPipeline(stages=stages(JStringIndexer, JVectorAssembler,
                                  JDecisionTree)).fit(jtrain)
    got = Pipeline(stages=stages(StringIndexer, VectorAssembler,
                                 DecisionTreeClassifier, device="cpu")
                   ).fit(port(jtrain))
    path = str(tmp_path_factory.mktemp("jax_dt") / "model")
    jax_save_model(ref, path)
    return ref, got, jtest, port(jtest), path


def test_dt_fit_grows_the_jax_packages_tree(dt_pipelines):
    """Integer class counts: the heaps, ``rawPrediction`` (the leaf's
    counts) and the predictions are bitwise equal."""
    ref, got, jtest, test, _path = dt_pipelines
    a, b = got.getStages()[-1], ref.getStages()[-1]
    assert isinstance(a, DecisionTreeClassificationModel)
    assert a.num_classes == b.num_classes and a.depth == b.depth
    assert (a.forest.feature >= 0).sum() > 10
    for name in ("feature", "threshold", "leaf_stats", "gain", "count"):
        np.testing.assert_array_equal(getattr(a.forest, name),
                                      np.asarray(getattr(b.forest, name)))
    out, want = got.transform(test), ref.transform(jtest)
    for col in ("rawPrediction", "prediction"):
        np.testing.assert_array_equal(to_host(out[col]), np.asarray(want[col]))
    np.testing.assert_allclose(to_host(out["probability"]),
                               np.asarray(want["probability"]), rtol=1e-6)


def test_jax_saved_dt_pipeline_serves_in_the_port(dt_pipelines, tmp_path):
    """Exact: the loaded tree is the saved one, and the walk compares
    and copies."""
    ref, _got, jtest, test, path = dt_pipelines
    loaded = load_model(path, device="cpu")
    np.testing.assert_array_equal(
        to_host(loaded.transform(test)["prediction"]),
        np.asarray(ref.transform(jtest)["prediction"]))
    save_model(loaded, str(tmp_path / "again"))
    back = jax_load_model(str(tmp_path / "again"))
    np.testing.assert_array_equal(
        np.asarray(back.transform(jtest)["rawPrediction"]),
        np.asarray(ref.transform(jtest)["rawPrediction"]))


# -- boosting and one-vs-rest ----------------------------------------------


def test_ovr_gbt_vectorized_fit_matches_the_jax_package(ovr_fits):
    """Trees equal under the near-tie rule; leaf stats to LEAF_RTOL;
    each round's margins to MARGIN_ATOL; predictions equal wherever the
    top two raw scores are more than MARGIN_ATOL apart."""
    X, _y, ref, port = ovr_fits
    assert isinstance(port, OneVsRestModel) and port.num_classes == 4
    for mp, mr in zip(port.models, ref.models):
        assert isinstance(mp, GBTClassificationModel)
        assert mp.numTrees == mr.numTrees == GBT["maxIter"]
        np.testing.assert_array_equal(mp.treeWeights, mr.treeWeights)
        assert_same_boosted_trees(mp.forest, mr.forest)
        # gain × count, summed without per-tree normalization (Spark's
        # GBT): the gains' rounding only
        np.testing.assert_allclose(mp.featureImportances,
                                   mr.featureImportances,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            staged_margins(mp.forest, mp.treeWeights, X),
            staged_margins(mr.forest, mr.treeWeights, X),
            rtol=0, atol=MARGIN_ATOL)
    raw_ref = np.asarray(ref._raw_predict(X))
    raw = port._raw_predict(X).numpy()
    np.testing.assert_allclose(raw, raw_ref, rtol=0, atol=2 * MARGIN_ATOL)
    top2 = np.sort(raw_ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN_ATOL
    assert clear.mean() > 0.99
    pred = to_host(port.transform(Frame({"features": X}))["prediction"])
    want = np.asarray(ref.transform(JFrame({"features": X}))["prediction"])
    np.testing.assert_array_equal(pred[clear], want[clear])


def test_ovr_gbt_vectorized_equals_sequential(ovr_fits):
    """The class axis on the grower's tree axis grows the per-class fits'
    trees bitwise: the same sums of the same stats in the same order."""
    X, y, _ref, port = ovr_fits
    clf = GBTClassifier(device="cpu", **GBT)
    for c, mv in enumerate(port.models):
        ms = clf.copy({"labelCol": "b"}).fit(
            Frame({"features": X, "b": (y == c).astype(np.float64)}))
        for name in ("feature", "threshold", "leaf_stats", "gain", "count"):
            np.testing.assert_array_equal(getattr(mv.forest, name),
                                          getattr(ms.forest, name))
        np.testing.assert_array_equal(mv.treeWeights, ms.treeWeights)


def test_ovr_fused_raw_equals_per_model_loop(ovr_fits):
    """One walk of all classes' trees and the [K, M] selection product
    against each sub-model's own margin: f32 sums in another order."""
    X, _y, _ref, port = ovr_fits
    assert port._fused_raw() is not None
    fused = port._raw_predict(X)
    loop = torch.stack([m._raw_predict(X)[:, 1] for m in port.models], dim=1)
    assert fused.shape == (len(X), 4)
    torch.testing.assert_close(fused, loop, rtol=1e-5, atol=1e-5)
    # raw class-1 score = 2F
    torch.testing.assert_close(2 * port.models[0].margin(X), loop[:, 0])
    # a mixed model list takes the per-model loop
    mixed = OneVsRestModel(models=port.models[:3] + [port.models[3]])
    mixed.models[3] = DecisionTreeClassifier(device="cpu", maxDepth=2).fit(
        Frame({"features": X, "label": (_y == 3).astype(np.float64)}))
    assert mixed._fused_raw() is None
    assert mixed._raw_predict(X).shape == (len(X), 4)


def _validation_frame(n=3000, k=3, seed=1, n_val=800):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.argmax(X[:, :k] + 0.3 * rng.normal(size=(n, k)), axis=1)
    is_val = np.zeros(n, bool)
    is_val[rng.choice(n, size=n_val, replace=False)] = True
    return {"features": X, "label": y.astype(np.float64), "isVal": is_val}


def test_ovr_validated_early_stop_keeps_the_jax_packages_tree_counts():
    """Spark's validated boosting: each class stops on its own plateau
    and keeps its best round's trees — the same count per class as the
    JAX package's, and as the port's sequential sub-fits'."""
    cols = _validation_frame()
    kw = dict(maxIter=12, maxDepth=3, maxBins=16,
              validationIndicatorCol="isVal", validationTol=0.02, seed=3)
    ref = JOneVsRest(classifier=JGBT(**kw)).fit(JFrame(cols))
    port = OneVsRest(classifier=GBTClassifier(device="cpu", **kw)).fit(
        Frame(cols))
    kept = [m.numTrees for m in port.models]
    assert kept == [m.numTrees for m in ref.models]
    assert min(kept) < 12
    for c, m in enumerate(port.models):
        assert m.forest.feature.shape[0] == len(m.treeWeights) == kept[c]
        seq = GBTClassifier(device="cpu", **kw).copy({"labelCol": "b"}).fit(
            Frame(dict(cols, b=(cols["label"] == c).astype(np.float64))))
        assert seq.numTrees == kept[c]
        np.testing.assert_array_equal(seq.forest.feature, m.forest.feature)


def test_gbt_resume_equals_an_uninterrupted_fit(tmp_path, monkeypatch):
    """A fit that stops after its second round checkpoint and is run
    again resumes at round 4 and ends bitwise where an uninterrupted fit
    does; a finished fit leaves no state behind."""
    X, y = _blobs(n=1500, f=6, k=2, seed=3)
    frame = Frame({"features": X, "label": y})
    kw = dict(device="cpu", maxIter=6, maxDepth=3, maxBins=32,
              stepSize=0.3, seed=1)
    full = GBTClassifier(**kw).fit(frame)
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
        GBTClassifier(checkpointInterval=2, checkpointDir=ckpt, **kw).fit(frame)
    grown = []
    monkeypatch.setattr(optimizer_checkpoint, "save_state", save)
    import sntc_tpu_torch.models.tree.gbt as gbt_mod

    grow = gbt_mod.grow_forest
    monkeypatch.setattr(gbt_mod, "grow_forest",
                        lambda *a, **k: grown.append(1) or grow(*a, **k))
    resumed = GBTClassifier(checkpointInterval=2, checkpointDir=ckpt,
                            **kw).fit(frame)
    assert calls == [2, 4] and len(grown) == 2  # rounds 5 and 6 only
    for name in ("feature", "threshold", "leaf_stats", "gain", "count"):
        np.testing.assert_array_equal(getattr(resumed.forest, name),
                                      getattr(full.forest, name))
    np.testing.assert_array_equal(resumed.treeWeights, full.treeWeights)
    assert optimizer_checkpoint.load_state(ckpt, {}) is None
    assert not (tmp_path / "gbt" / "lbfgs_state.npz").exists()


def test_gbt_is_binary_only_and_validation_needs_a_proper_subset():
    X, y = _blobs(n=200, f=4, k=3)
    with pytest.raises(ValueError, match="binary-only"):
        GBTClassifier(device="cpu", maxIter=2).fit(
            Frame({"features": X, "label": y}))
    yb = (y == 0).astype(np.float64)
    with pytest.raises(ValueError, match="proper"):
        GBTClassifier(device="cpu", maxIter=2,
                      validationIndicatorCol="v").fit(Frame(
                          {"features": X, "label": yb,
                           "v": np.zeros(200, bool)}))


# -- models across packages ------------------------------------------------


def test_models_cross_between_the_packages(ovr_fits, tmp_path):
    """A JAX-saved OvR-GBT serves in the port with the JAX package's
    predictions, and the port's own OvR-GBT, saved by the port, serves
    in the JAX package with the port's: the loaded trees are the saved
    ones; the margins' sums differ only in order (MARGIN_ATOL)."""
    X, _y, ref, port = ovr_fits
    jax_save_model(ref, str(tmp_path / "jax"))
    loaded = load_model(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, OneVsRestModel)
    assert all(isinstance(m, GBTClassificationModel) for m in loaded.models)
    np.testing.assert_allclose(loaded._raw_predict(X).numpy(),
                               np.asarray(ref._raw_predict(X)),
                               rtol=0, atol=MARGIN_ATOL)
    save_model(port, str(tmp_path / "port"))
    back = jax_load_model(str(tmp_path / "port"))
    assert type(back).__name__ == "OneVsRestModel"
    raw = port._raw_predict(X).numpy()
    np.testing.assert_allclose(np.asarray(back._raw_predict(X)), raw,
                               rtol=0, atol=MARGIN_ATOL)
    for mb, mp in zip(back.models, port.models):
        np.testing.assert_array_equal(np.asarray(mb.forest.feature),
                                      mp.forest.feature)
        assert mb.getLabelCol() == mp.getLabelCol()
    again = load_model(str(tmp_path / "port"), device="cpu")
    torch.testing.assert_close(again._raw_predict(X), port._raw_predict(X),
                               rtol=0, atol=0)


# -- the train command -------------------------------------------------------


@pytest.mark.parametrize("estimator", ["gbt", "dt"])
def test_train_command_fits_gbt_and_dt_saves_and_serves(tmp_path, capsys,
                                                        estimator):
    raw = jax_generate_frame(2500, seed=4, min_class_fraction=0.005)
    data = tmp_path / "data"
    data.mkdir()
    write_raw_csv(Frame({c: np.asarray(raw[c]) for c in raw.columns}),
                  str(data / "day.csv"))
    model_dir = str(tmp_path / "model")
    assert main(["train", "--data", str(data), "--estimator", estimator,
                 "--chisq-top", "0", "--max-iter", "2", "--max-depth", "3",
                 "--max-bins", "32", "--model-out", model_dir,
                 "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["estimator"] == estimator and 0.0 < line["macroF1"] <= 1.0
    assert line["kernel_launches"] == {"forest_traversal": 0,
                                       "pad_assemble": 0, "tree_hist": 0}
    head = jax_load_model(model_dir).getStages()[-1]
    assert type(head).__name__ == {
        "gbt": "OneVsRestModel", "dt": "DecisionTreeClassificationModel",
    }[estimator]
    assert head.getFeaturesCol() == "rawFeatures"
    if estimator == "gbt":
        assert [m.numTrees for m in head.models] == [2] * len(head.models)
        assert head.models[0].getStepSize() == 0.1
    else:
        assert head.getMaxBins() == 32 and head.getMaxDepth() == 3

    inp = tmp_path / "in"
    inp.mkdir()
    live = jax_clean_flows(jax_generate_frame(300, seed=5, dirty=False))
    write_raw_csv(Frame({c: np.asarray(live[c]) for c in live.columns
                         if c != "Label"}), str(inp / "part_0000.csv"))
    before = dict(LAUNCHES)
    assert main(["serve", "--model", model_dir, "--watch", str(inp),
                 "--out", str(tmp_path / "out"), "--checkpoint",
                 str(tmp_path / "ckpt"), "--shape-buckets", "256", "--once",
                 "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["batches"] == 1 and summary["rows"] == 300
    assert LAUNCHES == before
