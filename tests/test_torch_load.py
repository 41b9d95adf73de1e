"""A pipeline the JAX package fitted and saved, served by the port.

The RF pipeline of bench config 3 at a small size (StringIndexer →
VectorAssembler → ChiSqSelector top 10 → RandomForest, 3 trees of depth
4) is fitted with ``sntc_tpu`` on synthetic CICIDS2017 traffic, saved
with ``sntc_tpu.mlio.save_model`` and loaded with
``sntc_tpu_torch.mlio.load_model`` on the CPU.  Predictions must agree;
probabilities within rtol 1e-5, because the port sums the per-tree votes
in another order than XLA.
"""

import json
import os

import numpy as np
import pytest
import torch

from sntc_tpu.core.base import Pipeline
from sntc_tpu.data import CICIDS2017_FEATURES, clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import ChiSqSelector, StringIndexer
from sntc_tpu.feature import VectorAssembler as JaxVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import RandomForestClassifier
from sntc_tpu_torch.core.base import PipelineModel
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import generate_frame
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import (
    RandomForestClassificationModel,
    from_numpy_forest,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

RTOL = 1e-5  # per-tree vote sums run in another order than XLA's


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    train = clean_flows(jax_generate_frame(2000, seed=0))
    pm = Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        JaxVectorAssembler(inputCols=CICIDS2017_FEATURES,
                           outputCol="rawFeatures"),
        ChiSqSelector(numTopFeatures=10, featuresCol="rawFeatures",
                      labelCol="label", outputCol="features"),
        RandomForestClassifier(numTrees=3, maxDepth=4, seed=0),
    ]).fit(train)
    path = str(tmp_path_factory.mktemp("jax_rf") / "model")
    jax_save_model(pm, path)
    test = clean_flows(jax_generate_frame(700, seed=5))
    return pm, path, test


def _port_frame(jframe):
    return Frame({c: jframe[c] for c in jframe.columns})


def _assert_same_predictions(ref, out):
    for c in ("rawPrediction", "probability"):
        np.testing.assert_allclose(
            to_host(out[c]), np.asarray(ref[c]), rtol=RTOL, atol=0
        )
    np.testing.assert_array_equal(
        to_host(out["prediction"]), np.asarray(ref["prediction"])
    )


def test_jax_saved_pipeline_loads_and_predicts_alike(fitted):
    pm, path, test = fitted
    model = load_model(path, device="cpu")
    assert isinstance(model, PipelineModel)
    assert [type(s).__name__ for s in model.getStages()] == [
        "StringIndexerModel", "VectorAssembler", "ChiSqSelectorModel",
        "RandomForestClassificationModel",
    ]
    rf = model.getStages()[-1]
    assert rf.num_classes == pm.getStages()[-1].num_classes
    assert rf.device == torch.device("cpu")
    out = model.transform(_port_frame(test))
    ref = pm.transform(test)
    _assert_same_predictions(ref, out)
    np.testing.assert_array_equal(to_host(out["label"]), np.asarray(ref["label"]))


def test_port_saved_pipeline_loads_in_the_jax_package(fitted, tmp_path):
    pm, path, test = fitted
    model = load_model(path, device="cpu")
    save_model(model, str(tmp_path / "again"))
    back = jax_load_model(str(tmp_path / "again"))
    ref = pm.transform(test)
    got = back.transform(test)
    for c in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(ref[c]))
    # and the port reloads its own save to the same forest
    again = load_model(str(tmp_path / "again"), device="cpu")
    for a, b in zip(again.getStages()[-1]._device_forest(),
                    model.getStages()[-1]._device_forest()):
        assert torch.equal(a, b)


def test_from_numpy_forest_serves_like_the_loaded_model(fitted):
    pm, path, test = fitted
    loaded = load_model(path, device="cpu").getStages()[-1]
    f = loaded.forest
    built = from_numpy_forest(
        f.feature, f.threshold, f.leaf_stats, f.max_depth,
        loaded.num_classes, device="cpu",
    )
    X = np.random.default_rng(0).normal(size=(50, 10)).astype(np.float32)
    frame = Frame({"features": X})
    a, b = built.transform(frame), loaded.transform(frame)
    for c in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_array_equal(to_host(a[c]), to_host(b[c]))


def test_unported_class_and_orbax_payload_raise(tmp_path):
    # a JAX class the port's loader does not register (FPGrowthModel
    # stood here until the port took it)
    meta = {"format_version": 1, "uid": "x", "params": {}, "extra": {},
            "class": "sntc_tpu.models.kmeans.KMeans"}
    d = tmp_path / "kmeans"
    d.mkdir()
    (d / "metadata.json").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="not ported"):
        load_model(str(d), device="cpu")
    meta["class"] = "sntc_tpu.feature.chisq_selector.ChiSqSelectorModel"
    meta["payload"] = "orbax"
    (d / "metadata.json").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="orbax"):
        load_model(str(d), device="cpu")


def test_load_model_defaults_to_cuda_and_refuses_without_it(
    fitted, monkeypatch
):
    _pm, path, _test = fitted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(path)


def test_forest_with_out_of_range_feature_is_refused():
    feat = np.array([[3, -1, -1]], np.int32)
    thr = np.zeros((1, 3), np.float32)
    leaf = np.ones((1, 3, 2), np.float32)
    with pytest.raises(ValueError, match="splits on feature 3"):
        from_numpy_forest(feat, thr, leaf, 1, 2, device="cpu", n_features=3)
    m = from_numpy_forest(feat, thr, leaf, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        m.transform(Frame({"features": np.zeros((2, 3), np.float32)}))


def test_synthetic_traffic_matches_the_jax_generator():
    ref = jax_generate_frame(300, seed=3)
    got = generate_frame(300, seed=3)
    assert got.columns == ref.columns
    for c in ref.columns:
        np.testing.assert_array_equal(got[c], np.asarray(ref[c]))


def test_rf_model_params_round_trip(fitted):
    _pm, path, _test = fitted
    rf = load_model(path, device="cpu").getStages()[-1]
    assert isinstance(rf, RandomForestClassificationModel)
    assert rf.getNumTrees() == 3 and rf.getMaxDepth() == 4
    assert rf.getFeaturesCol() == "features"
    with open(os.path.join(path, "stage_003", "metadata.json")) as f:
        saved = json.load(f)["params"]
    assert rf.paramValues() == saved
