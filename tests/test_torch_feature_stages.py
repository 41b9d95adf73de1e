"""The port's MinMaxScaler, MaxAbsScaler, RobustScaler, Normalizer,
Binarizer, DCT and PCA against the JAX package's stages, on the CPU, and
bench config 6's pipeline (MinMaxScaler -> DCT -> PCA -> LR) fused and
staged in the port, end to end against the JAX package's, and saved by
each package and loaded by the other.

Inputs: seeded numpy matrices with a constant column (the scalers'
span-0 / range-0 / maxAbs-0 rules), a column of flow-counter scale
(mean ~1e7, spread ~1e3: the PCA pilot shift) and signed columns; and
the JAX package's synthetic CICIDS2017 flows for the config-6 pipeline.

Tolerances, each with what it measured here when set:

* MinMax / MaxAbs fits and transforms, Binarizer, and Normalizer on a
  host column: bitwise (the same float32 reductions and the same numpy
  arithmetic);
* RobustScaler's quantiles: bitwise where the quantile's position
  ``q * (n - 1)`` is a whole row (the fits below: one sort, the same
  rows); at a fractional position the float32 blend of two rows may part
  by an ulp (XLA may fuse its multiply-add): within 1e-6 relative there
  (one element of 60 parted, by 2.4e-7, in the quantile test); the
  transforms bitwise;
* Normalizer on a tensor column: within 1e-6 of the host column's (the
  float64 norms summed by another library; bitwise here);
* DCT, both directions: within 5e-6 absolute of the JAX stage's
  (``Precision.HIGHEST`` XLA product against torch's float32 product,
  on outputs up to ~16; 2.9e-6 measured), and the inverse of the
  transform within 5e-6 of the input (1.9e-6 measured);
* PCA, on columns of distinct scales (distinct eigenvalues: equal ones
  would leave a degenerate subspace's basis arbitrary): the components
  up to each column's sign within 1e-5 (the moments' float32 sums in two
  libraries; 5.4e-7 measured; a component's sign is arbitrary, as in
  Spark and sklearn), ``explainedVariance`` within 1e-7 (7.4e-12
  measured), the projection of the JAX model's components within 1e-6
  of the largest output of the JAX stage's (4.9e-11 measured: outputs
  near 1e7, from the counter-scale column); on the card, 50 000 rows,
  the components within 1e-4 of the CPU fit's and the variance within
  1e-6;
* fused against staged in the port: bitwise, with and without shape
  buckets;
* config 6's pipeline against the JAX package's (each fitted by its
  package): predictions equal on at least 99.9 % of rows (100 %
  measured), probabilities within 2e-4 (9.0e-6 measured);
* a pipeline saved by one package and loaded by the other: every
  fitted array bitwise, transforms within the tolerances above.
"""

import numpy as np
import pytest
import torch

from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import CICIDS2017_FEATURES
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import DCT as JDCT
from sntc_tpu.feature import PCA as JPCA
from sntc_tpu.feature import Binarizer as JBinarizer
from sntc_tpu.feature import MaxAbsScaler as JMaxAbsScaler
from sntc_tpu.feature import MinMaxScaler as JMinMaxScaler
from sntc_tpu.feature import Normalizer as JNormalizer
from sntc_tpu.feature import RobustScaler as JRobustScaler
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu_torch.core.base import Pipeline, PipelineModel
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.feature import (
    DCT,
    PCA,
    Binarizer,
    MaxAbsScaler,
    MinMaxScaler,
    Normalizer,
    RobustScaler,
    StringIndexer,
    VectorAssembler,
)
from sntc_tpu_torch.feature.scalers import column_quantiles
from sntc_tpu_torch.fuse import compile_pipeline, fused_segments
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import LogisticRegression
from sntc_tpu_torch.serve import BatchPredictor
from jax_metrics_guard import own_jax_registry  # noqa: F401

F = 12
CUDA = torch.cuda.is_available()


def _matrix(n=600, seed=0):
    """Signed columns, a constant one (col 3), a counter-scale one
    (col 5) and a column of small integers (col 7, many ties)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 3.0, size=(n, F)).astype(np.float32)
    X[:, 3] = 7.0
    X[:, 5] = rng.normal(1e7, 1e3, size=n).astype(np.float32)
    X[:, 7] = rng.integers(0, 5, size=n).astype(np.float32)
    return X


def _fit_both(jest, pest, X):
    jm = jest.fit(JFrame({"features": X}))
    pm = pest.fit(Frame({"features": X}))
    return jm, pm


def _out(model, X, col, frame=Frame):
    return np.asarray(to_host(model.transform(frame({"features": X}))[col]))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 2.0)])
def test_minmax_matches_the_jax_stage_bitwise(lo, hi):
    X = _matrix()
    jm, pm = _fit_both(JMinMaxScaler(min=lo, max=hi, outputCol="o"),
                       MinMaxScaler(device="cpu", min=lo, max=hi,
                                    outputCol="o"), X)
    np.testing.assert_array_equal(pm.originalMin, np.asarray(jm.originalMin))
    np.testing.assert_array_equal(pm.originalMax, np.asarray(jm.originalMax))
    want = _out(jm, X, "o", JFrame)
    np.testing.assert_array_equal(_out(pm, X, "o"), want)
    # the constant column maps to the midpoint
    np.testing.assert_array_equal(want[:, 3], np.float32(0.5 * (lo + hi)))
    # a tensor column runs the same float32 operations
    t = pm.transform(Frame({"features": torch.from_numpy(X)}))["o"]
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), want)


def test_maxabs_matches_the_jax_stage_bitwise():
    X = _matrix(seed=1)
    X[:, 2] = 0.0  # maxAbs 0 -> 0
    jm, pm = _fit_both(JMaxAbsScaler(outputCol="o"),
                       MaxAbsScaler(device="cpu", outputCol="o"), X)
    np.testing.assert_array_equal(pm.maxAbs, np.asarray(jm.maxAbs))
    want = _out(jm, X, "o", JFrame)
    np.testing.assert_array_equal(_out(pm, X, "o"), want)
    t = pm.transform(Frame({"features": torch.from_numpy(X)}))["o"]
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("lower,upper,centering", [
    (0.25, 0.75, False), (0.1, 0.9, True), (0.0, 1.0, True)])
def test_robust_quantiles_match_the_jax_stage(lower, upper, centering):
    X = _matrix(n=601, seed=2)
    kw = dict(lower=lower, upper=upper, withCentering=centering,
              outputCol="o")
    jm, pm = _fit_both(JRobustScaler(**kw),
                       RobustScaler(device="cpu", **kw), X)
    np.testing.assert_array_equal(pm.median, np.asarray(jm.median))
    np.testing.assert_array_equal(pm.range, np.asarray(jm.range))
    assert pm.range[3] == 0.0  # the constant column: range 0 -> 0
    want = _out(jm, X, "o", JFrame)
    np.testing.assert_array_equal(_out(pm, X, "o"), want)
    t = pm.transform(Frame({"features": torch.from_numpy(X)}))["o"]
    np.testing.assert_array_equal(t.numpy(), want)


def test_column_quantiles_nan_column_and_positions():
    """``jnp.quantile``'s NaN rule (a column holding a NaN gives NaN)
    and interpolation at the ends and between rows."""
    import jax
    import jax.numpy as jnp

    X = _matrix(n=37, seed=3)
    X[5, 1] = np.nan
    qs = [0.0, 0.3, 0.5, 0.999, 1.0]
    got = column_quantiles(torch.from_numpy(X), qs).numpy()
    with jax.debug_nans(False):  # the NaN column is the point here
        want = np.asarray(jnp.quantile(jnp.asarray(X),
                                       jnp.asarray(qs, jnp.float32), axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    whole = [0, 2, 4]  # q * 36 a whole row: bitwise
    np.testing.assert_array_equal(got[whole], want[whole])
    assert np.isnan(got[:, 1]).all()


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
def test_normalizer_matches_the_jax_stage(p):
    X = _matrix(seed=4)
    X[9] = 0.0  # a zero-norm row passes unchanged
    want = _out(JNormalizer(p=p, outputCol="o"), X, "o", JFrame)
    np.testing.assert_array_equal(_out(Normalizer(p=p, outputCol="o"), X,
                                       "o"), want)
    t = Normalizer(p=p, outputCol="o").transform(
        Frame({"features": torch.from_numpy(X)}))["o"]
    np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.numpy()[9], 0.0)


@pytest.mark.parametrize("vector", [True, False])
def test_binarizer_matches_the_jax_stage(vector):
    X = _matrix(seed=5)
    col = X if vector else X[:, 0].astype(np.float64)
    want = np.asarray(JBinarizer(threshold=0.5, outputCol="o").transform(
        JFrame({"features": col}))["o"])
    got = to_host(Binarizer(threshold=0.5, outputCol="o").transform(
        Frame({"features": col}))["o"])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    t = to_host(Binarizer(threshold=0.5, outputCol="o").transform(
        Frame({"features": torch.from_numpy(col)}))["o"])
    np.testing.assert_array_equal(t, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_dct_matches_the_jax_stage(inverse):
    X = _matrix(seed=6)
    X[:, 5] = X[:, 5] / 1e6  # keep the values small: absolute tolerance
    want = _out(JDCT(inverse=inverse, outputCol="o"), X, "o", JFrame)
    stage = DCT(device="cpu", inverse=inverse, outputCol="o")
    got = _out(stage, X, "o")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    back = DCT(device="cpu", inverse=not inverse, inputCol="o",
               outputCol="x").transform(Frame({"o": got}))["x"]
    np.testing.assert_allclose(back, X, rtol=0, atol=5e-6)
    with pytest.raises(ValueError):
        stage.transform(Frame({"features": X[:, 0]}))


def _spread(X):
    """``X`` with a distinct scale a column: distinct eigenvalues, so
    each component is determined up to its sign (equal variances would
    leave a degenerate subspace's basis arbitrary)."""
    return (X * np.arange(1, F + 1, dtype=np.float32)).astype(np.float32)


def test_pca_matches_the_jax_stage_up_to_sign():
    X = _spread(_matrix(n=2000, seed=7))
    jm, pm = _fit_both(JPCA(k=4, outputCol="o"),
                       PCA(device="cpu", k=4, outputCol="o"), X)
    jpc = np.asarray(jm.pc)
    sign = np.sign(np.sum(pm.pc * jpc, axis=0))
    assert (sign != 0).all()
    np.testing.assert_allclose(pm.pc * sign, jpc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pm.explainedVariance,
                               np.asarray(jm.explainedVariance), rtol=0,
                               atol=1e-7)
    # the raw, uncentered projection of the same components
    same = type(pm)(pc=jpc, explainedVariance=pm.explainedVariance,
                    device="cpu", outputCol="o")
    want = _out(jm, X, "o", JFrame)
    np.testing.assert_allclose(_out(same, X, "o"), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError):
        PCA(device="cpu", k=F + 1).fit(Frame({"features": X}))


def _flows(n=3000, seed=3):
    jf = jax_clean_flows(jax_generate_frame(n, seed=seed))
    label = np.where(np.asarray(jf["Label"]).astype(str) == "BENIGN",
                     "benign", "attack").astype(object)
    cols = {c: np.asarray(jf[c]) for c in jf.columns if c != "Label"}
    cols["Label"] = label
    return cols


def _c6_stages(pkg, k=8, device="cpu"):
    if pkg == "jax":
        return [JStringIndexer(inputCol="Label", outputCol="label",
                               handleInvalid="skip"),
                JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                                 outputCol="rawFeatures"),
                JMinMaxScaler(inputCol="rawFeatures", outputCol="mm"),
                JDCT(inputCol="mm", outputCol="dct"),
                JPCA(inputCol="dct", outputCol="features", k=k),
                JLR(maxIter=20)]
    return [StringIndexer(inputCol="Label", outputCol="label",
                          handleInvalid="skip"),
            VectorAssembler(inputCols=CICIDS2017_FEATURES,
                            outputCol="rawFeatures"),
            MinMaxScaler(device=device, inputCol="rawFeatures",
                         outputCol="mm"),
            DCT(device=device, inputCol="mm", outputCol="dct"),
            PCA(device=device, inputCol="dct", outputCol="features", k=k),
            LogisticRegression(device=device, maxIter=20)]


@pytest.fixture(scope="module")
def c6():
    cols = _flows()
    pm = Pipeline(stages=_c6_stages("port")).fit(Frame(cols))
    return cols, pm


@pytest.mark.parametrize("bucket_rows", [0, 256])
def test_config6_fused_bitwise_equal_to_staged(c6, bucket_rows,
                                               monkeypatch):
    """Bench config 6's serve forms: the leading assembler eager, then
    one segment of MinMax, DCT, PCA and the LR head; the staged head on
    its device program (the bench pins the crossover off)."""
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    cols, pm = c6
    staged = PipelineModel(stages=pm.getStages()[1:])
    fused = compile_pipeline(staged)
    assert [type(s).__name__ for s in fused.getStages()] == [
        "VectorAssembler", "FusedSegment"]
    seg = fused_segments(fused)[0]
    assert [type(s).__name__ for s in seg.fused_stages] == [
        "MinMaxScalerModel", "DCT", "PCAModel", "LogisticRegressionModel"]
    frame = Frame(cols).drop("Label")
    for n in (512, 700, 1000):
        b = frame.slice(0, n)
        a = BatchPredictor(staged, bucket_rows=bucket_rows,
                           device="cpu").predict_frame(b)
        f = BatchPredictor(fused, bucket_rows=bucket_rows,
                           device="cpu").predict_frame(b)
        for c in ("rawPrediction", "probability", "prediction"):
            np.testing.assert_array_equal(to_host(f[c]), to_host(a[c]),
                                          err_msg=f"{c} at {n} rows")
    assert seg.fallbacks == 0


def test_config6_pipeline_matches_the_jax_package(c6, monkeypatch):
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    cols, pm = c6
    jpm = JPipeline(stages=_c6_stages("jax")).fit(JFrame(cols))
    jout = jpm.transform(JFrame(cols))
    out = pm.transform(Frame(cols))
    pred, jpred = to_host(out["prediction"]), np.asarray(jout["prediction"])
    assert (pred == jpred).mean() >= 0.999
    np.testing.assert_allclose(to_host(out["probability"]),
                               np.asarray(jout["probability"]), rtol=0,
                               atol=2e-4)
    jmm, mm = jpm.getStages()[2], pm.getStages()[2]
    np.testing.assert_array_equal(mm.originalMin, np.asarray(jmm.originalMin))
    np.testing.assert_array_equal(mm.originalMax, np.asarray(jmm.originalMax))


def test_jax_saved_pipeline_loads_in_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    cols = _flows(n=1500, seed=4)
    jpm = JPipeline(stages=_c6_stages("jax", k=5)[:5] + [
        JMaxAbsScaler(inputCol="features", outputCol="ma"),
        JRobustScaler(inputCol="ma", outputCol="rb", withCentering=True),
        JNormalizer(inputCol="rb", outputCol="nm"),
        JBinarizer(inputCol="nm", outputCol="bin"),
        JDCT(inputCol="bin", outputCol="back", inverse=True),
    ]).fit(JFrame(cols))
    path = str(tmp_path / "m")
    jax_save_model(jpm, path)
    pm = load_model(path, device="cpu")
    assert [type(s).__name__ for s in pm.getStages()] == [
        type(s).__name__ for s in jpm.getStages()]
    for js, ps in zip(jpm.getStages(), pm.getStages()):
        for attr in ("originalMin", "originalMax", "maxAbs", "median",
                     "range", "pc", "explainedVariance"):
            if hasattr(js, attr):
                np.testing.assert_array_equal(getattr(ps, attr),
                                              np.asarray(getattr(js, attr)))
        assert ps.paramValues() == js.paramValues()
    jout = jpm.transform(JFrame(cols))
    out = pm.transform(Frame(cols))
    for c in ("mm", "ma", "rb"):
        np.testing.assert_allclose(to_host(out[c]), np.asarray(jout[c]),
                                   rtol=1e-4, atol=1e-5, err_msg=c)


def test_port_saved_pipeline_loads_in_the_jax_package(c6, tmp_path):
    cols, pm = c6
    path = str(tmp_path / "m")
    save_model(pm, path)
    jpm = jax_load_model(path)
    assert [type(s).__name__ for s in jpm.getStages()] == [
        type(s).__name__ for s in pm.getStages()]
    jmm, mm = jpm.getStages()[2], pm.getStages()[2]
    np.testing.assert_array_equal(np.asarray(jmm.originalMin), mm.originalMin)
    jpca, pca = jpm.getStages()[4], pm.getStages()[4]
    np.testing.assert_array_equal(np.asarray(jpca.pc), pca.pc)
    np.testing.assert_array_equal(np.asarray(jpca.explainedVariance),
                                  pca.explainedVariance)
    again = load_model(path, device="cpu")
    np.testing.assert_array_equal(again.getStages()[4].pc, pca.pc)
    assert again.getStages()[3].getInverse() is False


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["minmax", "maxabs", "robust", "pca"])
def test_fits_on_the_card_track_the_cpu(stage):
    if not CUDA:
        pytest.skip("needs a CUDA device")
    X = _spread(_matrix(n=50_000, seed=8))
    make = {"minmax": lambda d: MinMaxScaler(device=d, outputCol="o"),
            "maxabs": lambda d: MaxAbsScaler(device=d, outputCol="o"),
            "robust": lambda d: RobustScaler(device=d, outputCol="o",
                                             withCentering=True),
            "pca": lambda d: PCA(device=d, k=5, outputCol="o")}[stage]
    card = make("cuda").fit(Frame({"features": X}))
    cpu = make("cpu").fit(Frame({"features": X}))
    if stage == "pca":
        sign = np.sign(np.sum(card.pc * cpu.pc, axis=0))
        np.testing.assert_allclose(card.pc * sign, cpu.pc, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(card.explainedVariance,
                                   cpu.explainedVariance, rtol=0, atol=1e-6)
    else:
        for attr in ("originalMin", "originalMax", "maxAbs", "median",
                     "range"):
            if hasattr(card, attr):
                np.testing.assert_array_equal(getattr(card, attr),
                                              getattr(cpu, attr))
    host = _out(cpu, X, "o")
    dev = card.transform(Frame({"features": torch.from_numpy(X).cuda()}))
    tol = 1e-4 if stage == "pca" else 0.0
    np.testing.assert_allclose(to_host(dev["o"]),
                               _out(card, X, "o") if stage == "pca" else host,
                               rtol=tol, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_rows", [0, 256])
def test_config6_fused_bitwise_equal_to_staged_on_the_card(bucket_rows,
                                                            monkeypatch):
    if not CUDA:
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    cols = _flows(n=6000, seed=9)
    pm = Pipeline(stages=_c6_stages("port", k=32, device="cuda")).fit(
        Frame(cols))
    staged = PipelineModel(stages=pm.getStages()[1:])
    fused = compile_pipeline(staged)
    frame = Frame(cols).drop("Label")
    for n in (2048, 1024, 512, 286, 1000):
        b = frame.slice(0, n)
        a = BatchPredictor(staged, bucket_rows=bucket_rows,
                           device="cuda").predict_frame(b)
        f = BatchPredictor(fused, bucket_rows=bucket_rows,
                           device="cuda").predict_frame(b)
        for c in ("rawPrediction", "probability", "prediction"):
            np.testing.assert_array_equal(to_host(f[c]), to_host(a[c]),
                                          err_msg=f"{c} at {n} rows")


def test_minmax_output_range_change_reaches_the_tensor_path():
    """The tensor path's cached constants follow the output range."""
    X = _matrix(seed=10)
    pm = MinMaxScaler(device="cpu", outputCol="o").fit(Frame({"features": X}))
    t = torch.from_numpy(X)
    pm.transform(Frame({"features": t}))
    pm.setMin(-3.0).setMax(5.0)
    np.testing.assert_array_equal(
        pm.transform(Frame({"features": t}))["o"].numpy(), _out(pm, X, "o"))
