"""The port's OneHotEncoder, VectorSlicer, ElementwiseProduct,
PolynomialExpansion, Interaction, Bucketizer, QuantileDiscretizer,
Imputer, VectorIndexer and VectorSizeHint against the JAX package's
stages, on the CPU; their fused segment against the JAX host transform
and the JAX fused segment; and pipelines saved by the JAX package that
load and serve in the port.

Inputs are seeded numpy matrices (signed, of several scales, with NaN
and ±inf where a stage has a rule for them) and the JAX package's
synthetic CICIDS2017 flows for the saved pipeline.

Tolerances, each with what it measured here when set:

* every stage, on a numpy column and on a tensor column, against the
  JAX stage: bitwise (the same numpy arithmetic on the host; float64
  products, ``searchsorted`` lookups, gathers and one float32 product on
  the tensor, each exact IEEE);
* the fused segment of VectorSlicer, ElementwiseProduct,
  PolynomialExpansion, Bucketizer and Interaction against the JAX host
  transform and against the JAX fused segment under
  ``jax.enable_x64(True)``: bitwise; the JAX package builds those three
  float64 plans only under x64, the port always;
* a JAX-saved pipeline with those stages and an LR head, served by the
  port: every feature column bitwise, the predictions equal and the
  probabilities within 1e-6 of the JAX package's (the LR's float32
  product in two libraries; 1.5e-7 measured).
"""

import numpy as np
import pytest
import torch

import jax
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.base import PipelineModel as JPipelineModel
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.feature import (
    Bucketizer as JBucketizer,
    ElementwiseProduct as JElementwiseProduct,
    Imputer as JImputer,
    Interaction as JInteraction,
    OneHotEncoder as JOneHotEncoder,
    PolynomialExpansion as JPolynomialExpansion,
    QuantileDiscretizer as JQuantileDiscretizer,
    StringIndexer as JStringIndexer,
    VectorAssembler as JVectorAssembler,
    VectorIndexer as JVectorIndexer,
    VectorSizeHint as JVectorSizeHint,
    VectorSlicer as JVectorSlicer,
)
from sntc_tpu.feature.expansion import _expansion_plan as jax_plan
from sntc_tpu.fuse import compile_pipeline as jax_compile
from sntc_tpu.fuse import fused_segments as jax_segments
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu_torch.core.base import Pipeline, PipelineModel
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.feature import (
    Bucketizer,
    ElementwiseProduct,
    Imputer,
    Interaction,
    OneHotEncoder,
    PolynomialExpansion,
    QuantileDiscretizer,
    VectorIndexer,
    VectorSizeHint,
    VectorSlicer,
)
from sntc_tpu_torch.feature.expansion import _expansion_plan
from sntc_tpu_torch.fuse import compile_pipeline, fused_segments
from sntc_tpu_torch.fuse.registry import F32_ONLY, F64, device_plan_for
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.serve import BatchPredictor
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)


def _same(a, b):
    a, b = to_host(a), to_host(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _matrix(seed=0, n=257, d=6, dtype=np.float32):
    rng = np.random.default_rng(seed)
    scale = np.array([1.0, 10.0, 0.01, 1e4, 3.0, 1.0][:d])
    return (rng.normal(size=(n, d)) * scale).astype(dtype)


def _both(X):
    """The matrix as a numpy column and as a tensor column."""
    return [X, torch.from_numpy(np.ascontiguousarray(X))]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("invalid", ["error", "keep"])
def test_one_hot_encoder_matches_the_jax_stage_bitwise(drop_last, invalid):
    rng = np.random.default_rng(1)
    cols = {"a": rng.integers(0, 5, 300).astype(np.float64),
            "b": rng.integers(0, 3, 300).astype(np.float64)}
    kw = dict(inputCols=["a", "b"], outputCols=["ao", "bo"],
              dropLast=drop_last, handleInvalid=invalid)
    jm = JOneHotEncoder(**kw).fit(JFrame(cols))
    pm = OneHotEncoder(**kw).fit(Frame(cols))
    assert pm.categorySizes == jm.categorySizes == [5, 3]
    serve = dict(cols, a=np.where(np.arange(300) == 7, 9.0, cols["a"]))
    if invalid == "error":
        for m, F in ((jm, JFrame), (pm, Frame)):
            with pytest.raises(ValueError, match="outside"):
                m.transform(F(serve))
        serve = cols
    a, b = jm.transform(JFrame(serve)), pm.transform(Frame(serve))
    for c in ("ao", "bo"):
        _same(a[c], b[c])


def test_one_hot_encoder_refuses_fractional_indices():
    for est, F in ((JOneHotEncoder, JFrame), (OneHotEncoder, Frame)):
        with pytest.raises(ValueError, match="non-negative integer"):
            est(inputCols=["a"]).fit(F({"a": np.array([0.0, 1.5])}))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vector_slicer_matches_the_jax_stage_bitwise(dtype):
    X = _matrix(dtype=dtype)
    idx = [4, 0, 5, 2]
    want = JVectorSlicer(inputCol="x", outputCol="s", indices=idx).transform(
        JFrame({"x": X}))["s"]
    for col in _both(X):
        got = VectorSlicer(inputCol="x", outputCol="s",
                           indices=idx).transform(Frame({"x": col}))["s"]
        _same(want, got)
    with pytest.raises(ValueError, match="out of range"):
        VectorSlicer(inputCol="x", outputCol="s", indices=[6]).transform(
            Frame({"x": X}))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_elementwise_product_matches_the_jax_stage_bitwise(dtype):
    X = _matrix(seed=2, dtype=dtype)
    w = list(np.random.default_rng(3).normal(size=6) * 7)
    want = JElementwiseProduct(inputCol="x", outputCol="e",
                               scalingVec=w).transform(JFrame({"x": X}))["e"]
    stage = ElementwiseProduct(inputCol="x", outputCol="e", scalingVec=w)
    for col in _both(X):
        _same(want, stage.transform(Frame({"x": col}))["e"])
    # a new scaling vector reaches the tensor path
    stage.setScalingVec([1.0] * 6)
    _same(X.astype(np.float32), stage.transform(
        Frame({"x": torch.from_numpy(X)}))["e"])


@pytest.mark.parametrize("n,degree", [(1, 3), (4, 1), (5, 2), (6, 3),
                                      (40, 2)])
def test_expansion_plan_equals_the_jax_plan(n, degree):
    assert _expansion_plan(n, degree) == jax_plan(n, degree)
    if (n, degree) == (40, 2):
        assert len(_expansion_plan(n, degree)) == 860


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_polynomial_expansion_matches_the_jax_stage_bitwise(degree, dtype):
    X = _matrix(seed=4, dtype=dtype)
    X[3, 1] = np.nan
    want = JPolynomialExpansion(inputCol="x", outputCol="p",
                                degree=degree).transform(JFrame({"x": X}))["p"]
    for col in _both(X):
        got = PolynomialExpansion(inputCol="x", outputCol="p",
                                  degree=degree).transform(
            Frame({"x": col}))["p"]
        _same(want, got)
    with pytest.raises(ValueError, match="vector column"):
        PolynomialExpansion(inputCol="x").transform(
            Frame({"x": torch.zeros(3, dtype=torch.float64)}))


def test_interaction_matches_the_jax_stage_bitwise():
    rng = np.random.default_rng(5)
    cols = {"s": rng.normal(size=100), "v": _matrix(seed=6, n=100, d=3),
            "w": rng.normal(size=(100, 2)).astype(np.float32)}
    names = ["s", "v", "w"]
    want = JInteraction(inputCols=names, outputCol="i").transform(
        JFrame(cols))["i"]
    assert want.shape == (100, 6)
    got = Interaction(inputCols=names, outputCol="i").transform(
        Frame(cols))["i"]
    _same(want, got)
    # a tensor among host columns: the host ones are copied to its device
    dev = dict(cols, v=torch.from_numpy(cols["v"]))
    _same(want, Interaction(inputCols=names, outputCol="i").transform(
        Frame(dev))["i"])
    with pytest.raises(ValueError, match="at least two"):
        Interaction(inputCols=["s"], outputCol="i").transform(Frame(cols))


_SPLITS = [-np.inf, -1.0, 0.0, 0.5, np.inf]


def _bucket_values(seed=7, n=300):
    v = np.random.default_rng(seed).normal(size=n)
    v[[4, 90]] = np.nan
    v[[5, 6, 7]] = [-np.inf, np.inf, 0.5]
    return v


@pytest.mark.parametrize("invalid", ["keep", "skip", "error"])
def test_bucketizer_matches_the_jax_stage_bitwise(invalid):
    v = _bucket_values()
    kw = dict(inputCol="v", outputCol="b", splits=_SPLITS,
              handleInvalid=invalid)
    if invalid == "error":
        with pytest.raises(ValueError, match="NaN"):
            JBucketizer(**kw).transform(JFrame({"v": v}))
        for col in (v, torch.from_numpy(v)):
            with pytest.raises(ValueError, match="NaN"):
                Bucketizer(**kw).transform(Frame({"v": col}))
        v = np.nan_to_num(v, nan=0.25)
    want = JBucketizer(**kw).transform(JFrame({"v": v, "r": np.arange(
        len(v))}))
    for col in (v, torch.from_numpy(v)):
        got = Bucketizer(**kw).transform(Frame({"v": col, "r": np.arange(
            len(v))}))
        assert got.columns == want.columns
        for c in want.columns:
            _same(want[c], got[c])


def test_bucketizer_closed_ends_and_multi_column():
    v = _bucket_values()
    closed = [-2.0, 0.0, 1.0, 2.0]
    for col in (v, torch.from_numpy(v)):
        with pytest.raises(ValueError, match="outside the splits"):
            Bucketizer(inputCol="v", outputCol="b", splits=closed,
                       handleInvalid="keep").transform(Frame({"v": col}))
    inside = np.clip(np.nan_to_num(v), -2.0, 2.0)
    cols = {"a": inside, "b": v}
    kw = dict(inputCols=["a", "b"], outputCols=["ab", "bb"],
              splitsArray=[closed, _SPLITS], handleInvalid="skip")
    want = JBucketizer(**kw).transform(JFrame(cols))
    for c in (cols, {"a": torch.from_numpy(inside), "b": v}):
        got = Bucketizer(**kw).transform(Frame(c))
        for name in ("ab", "bb", "a"):
            _same(want[name], got[name])


@pytest.mark.parametrize("buckets", [2, 7, 16])
def test_quantile_discretizer_splits_equal_the_jax_fit(buckets):
    rng = np.random.default_rng(8)
    v = np.round(rng.lognormal(size=500), 1)
    v[3] = np.nan
    cols = {"v": v, "w": rng.normal(size=500)}
    kw = dict(inputCol="v", outputCol="b", numBuckets=buckets,
              handleInvalid="keep")
    jb = JQuantileDiscretizer(**kw).fit(JFrame(cols))
    pb = QuantileDiscretizer(**kw).fit(Frame(cols))
    assert pb.getSplits() == jb.getSplits()
    _same(jb.transform(JFrame(cols))["b"], pb.transform(Frame(cols))["b"])
    multi = dict(inputCols=["v", "w"], outputCols=["vb", "wb"],
                 numBuckets=buckets, handleInvalid="keep")
    assert (QuantileDiscretizer(**multi).fit(Frame(cols)).getSplitsArray()
            == JQuantileDiscretizer(**multi).fit(
                JFrame(cols)).getSplitsArray())


@pytest.mark.parametrize("strategy", ["mean", "median", "mode"])
@pytest.mark.parametrize("missing", [float("nan"), -1.0])
def test_imputer_matches_the_jax_stage_bitwise(strategy, missing):
    rng = np.random.default_rng(9)
    a = np.round(rng.normal(size=200), 1)
    a[[3, 8, 40]] = missing
    a[50] = np.nan
    cols = {"a": a, "b": rng.integers(0, 4, 200).astype(np.float64)}
    kw = dict(inputCols=["a", "b"], outputCols=["ai", "bi"],
              strategy=strategy, missingValue=missing)
    jm = JImputer(**kw).fit(JFrame(cols))
    pm = Imputer(**kw).fit(Frame(cols))
    assert pm.surrogates == jm.surrogates
    a2, b2 = jm.transform(JFrame(cols)), pm.transform(Frame(cols))
    for c in ("ai", "bi"):
        _same(a2[c], b2[c])


def _indexer_matrix(seed=10, n=600):
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 5)) * np.array([0.5, 3, 10, 0.2, 100]))
    X = X.astype(np.float32)
    X[3, 0] = np.nan
    X[:, 3] = np.where(X[:, 3] == 0, -0.0, X[:, 3])
    return X


@pytest.mark.parametrize("invalid", ["keep", "skip", "error"])
def test_vector_indexer_matches_the_jax_stage_bitwise(invalid):
    X = _indexer_matrix()
    kw = dict(inputCol="x", outputCol="o", maxCategories=8,
              handleInvalid=invalid)
    jm = JVectorIndexer(**kw).fit(JFrame({"x": X}))
    pm = VectorIndexer(device="cpu", **kw).fit(Frame({"x": X}))
    assert sorted(pm.categoryMaps) == sorted(jm.categoryMaps) == [0, 3]
    for j, vals in jm.categoryMaps.items():
        np.testing.assert_array_equal(pm.categoryMaps[j], vals)
    Xt = X.copy()
    Xt[0, 0] = 77.0  # unseen
    if invalid == "error":
        with pytest.raises(ValueError, match="unseen"):
            jm.transform(JFrame({"x": Xt}))
        for col in _both(Xt):
            with pytest.raises(ValueError, match="unseen"):
                pm.transform(Frame({"x": col}))
        # a NaN is never a seen value either: serve rows without one
        Xt = np.nan_to_num(X)
    want = jm.transform(JFrame({"x": Xt, "r": np.arange(len(Xt))}))
    for col in _both(Xt):
        got = pm.transform(Frame({"x": col, "r": np.arange(len(Xt))}))
        for c in ("o", "r"):
            _same(want[c], got[c])


def test_vector_indexer_fit_takes_a_tensor_and_refuses_scalars():
    X = _indexer_matrix(seed=11)
    a = VectorIndexer(device="cpu", maxCategories=8).fit(
        Frame({"features": X}))
    b = VectorIndexer(device="cpu", maxCategories=8).fit(
        Frame({"features": torch.from_numpy(X)}))
    assert sorted(a.categoryMaps) == sorted(b.categoryMaps)
    with pytest.raises(ValueError, match="vector column"):
        VectorIndexer(device="cpu").fit(Frame({"features": X[:, 0]}))


@pytest.mark.parametrize("mode", ["error", "skip", "optimistic"])
def test_vector_size_hint_matches_the_jax_stage(mode):
    X = _matrix(n=20)
    for size in (6, 5):
        kw = dict(inputCol="x", size=size, handleInvalid=mode)
        if mode == "error" and size == 5:
            for stage, F in ((JVectorSizeHint, JFrame),
                             (VectorSizeHint, Frame)):
                with pytest.raises(ValueError, match="width"):
                    stage(**kw).transform(F({"x": X}))
            continue
        assert (VectorSizeHint(**kw).transform(Frame({"x": X})).num_rows
                == JVectorSizeHint(**kw).transform(JFrame({"x": X})).num_rows)


def _segment_stages(F):
    return [
        F.VectorAssembler(inputCols=[f"c{i}" for i in range(10)],
                          outputCol="raw", handleInvalid="keep"),
        F.VectorSlicer(inputCol="raw", outputCol="sl", indices=[7, 2, 5, 0]),
        F.ElementwiseProduct(inputCol="sl", outputCol="ep",
                             scalingVec=[0.5, 2.0, -1.5, 3.0]),
        F.PolynomialExpansion(inputCol="ep", outputCol="poly", degree=3),
        F.QuantileDiscretizer(inputCol="dur", outputCol="db", numBuckets=8,
                              handleInvalid="keep"),
        F.Interaction(inputCols=["db", "sl"], outputCol="inter"),
    ]


def _segment_frame(seed=3, n=300):
    rng = np.random.default_rng(seed)
    cols = {f"c{i}": rng.normal(size=n) * (i + 1) for i in range(10)}
    cols["dur"] = np.abs(rng.normal(size=n)) * 1e5
    cols["dur"][[3, 9]] = np.nan
    return cols


@pytest.fixture(scope="module")
def segment_models():
    import sntc_tpu.feature as jf
    import sntc_tpu_torch.feature as pf

    cols = _segment_frame()
    jpm = JPipeline(stages=_segment_stages(jf)).fit(JFrame(cols))
    ppm = Pipeline(stages=_segment_stages(pf)).fit(Frame(cols))
    return cols, jpm, ppm


def test_fused_segment_equals_the_jax_host_transform_bitwise(
        segment_models):
    cols, jpm, ppm = segment_models
    fused = compile_pipeline(ppm)
    (seg,) = fused_segments(fused)
    assert [type(s).__name__ for s in seg.fused_stages] == [
        "VectorSlicer", "ElementwiseProduct", "PolynomialExpansion",
        "Bucketizer", "Interaction"]
    want = jpm.transform(JFrame(cols))
    staged = ppm.transform(Frame(cols))
    got = fused.transform(Frame(cols))
    for c in ("poly", "inter"):
        _same(want[c], staged[c])
        _same(want[c], got[c])
    # the same on a bucket-padded batch (the segment binds tensors)
    padded = BatchPredictor(fused, bucket_rows=512,
                            device="cpu").predict_frame(Frame(cols))
    for c in ("poly", "inter"):
        _same(want[c], padded[c])


def test_fused_segment_equals_the_jax_fused_segment_under_x64(
        segment_models):
    cols, jpm, ppm = segment_models
    with jax.enable_x64(True):
        jfused = jax_compile(jpm)
        (jseg,) = jax_segments(jfused)
        assert len(jseg.fused_stages) == 5
        want = jfused.transform(JFrame(cols))
        want = {c: np.asarray(want[c]) for c in ("poly", "inter")}
    # without x64 the JAX package keeps the three float64 stages eager
    assert len(jax_segments(jax_compile(jpm))) == 1
    got = compile_pipeline(ppm).transform(Frame(cols))
    for c in ("poly", "inter"):
        _same(want[c], got[c])


def test_plans_follow_the_jax_registry_rules():
    pf = [ElementwiseProduct(scalingVec=[1.0]), VectorSlicer(indices=[0]),
          PolynomialExpansion(inputCol="x"), Interaction(inputCols=["a", "b"]),
          Bucketizer(splits=_SPLITS, handleInvalid="keep")]
    assert [device_plan_for(s).read_policy for s in pf] == [
        F32_ONLY, F32_ONLY, F64, F64, F64]
    # eager: unset params, one input, closed ends, error / skip, multi mode
    for s in (ElementwiseProduct(), VectorSlicer(),
              Interaction(inputCols=["a"]),
              Bucketizer(splits=[-1.0, 0.0, 1.0], handleInvalid="keep"),
              Bucketizer(splits=_SPLITS),
              Bucketizer(splits=_SPLITS, handleInvalid="skip"),
              Bucketizer(splits=[0.0, 0.0, 1.0], handleInvalid="keep"),
              Bucketizer(inputCols=["a"], outputCols=["b"],
                         splitsArray=[_SPLITS], handleInvalid="keep")):
        assert device_plan_for(s) is None


def test_elementwise_product_over_float64_runs_eagerly_alike():
    """An ``F32_ONLY`` plan over a float64 column: the segment serves the
    eager stage (one fallback) with the host transform's bits."""
    X = _matrix(seed=12, dtype=np.float64)
    pm = PipelineModel(stages=[
        ElementwiseProduct(inputCol="x", outputCol="e",
                           scalingVec=[2.0] * 6),
        PolynomialExpansion(inputCol="e", outputCol="p", degree=2)])
    fused = compile_pipeline(pm)
    (seg,) = fused_segments(fused)
    got = fused.transform(Frame({"x": X}))
    assert seg.fallbacks == 1
    want = JPipelineModel(stages=[
        JElementwiseProduct(inputCol="x", outputCol="e",
                            scalingVec=[2.0] * 6),
        JPolynomialExpansion(inputCol="e", outputCol="p", degree=2),
    ]).transform(JFrame({"x": X}))
    _same(want["p"], got["p"])


def _flows(n=3000, seed=0):
    from sntc_tpu.data import CICIDS2017_FEATURES, clean_flows
    from sntc_tpu.data.synth import generate_frame

    f = clean_flows(generate_frame(n, seed=seed, min_class_fraction=0.005))
    f = f.with_column("Label", np.where(
        f["Label"].astype(str) == "BENIGN", "benign", "attack").astype(
        object))
    return f, list(CICIDS2017_FEATURES)


def _jax_serving_pipeline(features, mesh):
    others = [c for c in features if c != "Flow Duration"]
    return JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label"),
        JVectorAssembler(inputCols=others, outputCol="raw",
                         handleInvalid="keep"),
        JVectorSlicer(inputCol="raw", outputCol="sl",
                      indices=[0, 5, 9, 30]),
        JPolynomialExpansion(inputCol="sl", outputCol="poly", degree=2),
        JQuantileDiscretizer(inputCol="Flow Duration", outputCol="db",
                             numBuckets=16, handleInvalid="keep"),
        JInteraction(inputCols=["db", "poly"], outputCol="features"),
        JLR(mesh=mesh, maxIter=15),
    ])


def test_jax_saved_pipeline_loads_and_serves_in_the_port(mesh8, tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    flows, features = _flows()
    jpm = _jax_serving_pipeline(features, mesh8).fit(flows)
    path = str(tmp_path / "m")
    jax_save_model(jpm, path)
    loaded = load_model(path, device="cpu")
    serve = flows.drop("Label")
    want = jpm.transform(flows)
    from sntc_tpu_torch.app import serving_form

    staged, _, _ = serving_form(loaded, "label", False)
    fused, _, _ = serving_form(loaded, "label", True)
    (seg,) = fused_segments(fused)
    assert len(seg.fused_stages) == 5  # slicer, poly, bucketizer, inter, LR
    pframe = Frame({c: serve[c] for c in serve.columns})
    for model in (staged, fused):
        got = BatchPredictor(model, bucket_rows=256,
                             device="cpu").predict_frame(pframe)
        np.testing.assert_array_equal(to_host(got["prediction"]),
                                      want["prediction"])
        np.testing.assert_allclose(to_host(got["probability"]),
                                   want["probability"], atol=1e-6)
    full = Frame({c: flows[c] for c in flows.columns})
    got = loaded.transform(full)
    for c in ("sl", "poly", "db", "features"):
        _same(want[c], got[c])
    # and the port's own save of the loaded pipeline loads back the same
    save_model(loaded, str(tmp_path / "p"))
    again = load_model(str(tmp_path / "p"), device="cpu")
    _same(got["features"], again.transform(full)["features"])


def test_port_saved_stages_load_in_the_port(tmp_path):
    X = _indexer_matrix(seed=13)
    vi = VectorIndexer(device="cpu", inputCol="x", maxCategories=8).fit(
        Frame({"x": X}))
    ohe = OneHotEncoder(inputCols=["a"]).fit(Frame({"a": np.arange(4.0)}))
    imp = Imputer(inputCols=["a"]).fit(Frame({"a": np.array([1.0, np.nan])}))
    for i, m in enumerate((vi, ohe, imp)):
        save_model(m, str(tmp_path / str(i)))
        back = load_model(str(tmp_path / str(i)), device="cpu")
        assert type(back) is type(m)
    back = load_model(str(tmp_path / "0"), device="cpu")
    for j in vi.categoryMaps:
        np.testing.assert_array_equal(back.categoryMaps[j],
                                      vi.categoryMaps[j])
