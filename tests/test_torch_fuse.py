"""The port's whole-pipeline fusion compiler against the JAX package's,
on the CPU.

* Rule 1 (scaler folding): a JAX-fitted StandardScaler → LR and
  StandardScaler → MLP pipeline, saved and loaded by the port, folds
  into the SAME float32 weights (bitwise: both fold in float64 numpy).
  The fused outputs of the two packages agree within the JAX package's
  own fold tolerances (``tests/test_fuse.py``): probability 1e-5 (LR)
  and 1e-4 (MLP), predictions equal.
* Fused against staged in the port: bitwise, for every head the port
  can fuse, with and without shape buckets, through a ``skip``
  assembler over rows with NaN (``tests/test_fuse_pipeline.py``).
* The transfer ledger: one upload and one download per micro-batch on
  the config-3 form, and the intermediate column never leaves the
  device; rows the ``skip`` assembler drops add the recorded copies of
  their mask and kept-row indices, and no other.
* The partition of each bench config's CLI pipeline (``train`` at test
  widths) is the JAX ``compile_pipeline``'s, by stage class names per
  segment.
* ``compile_pipeline(keep=, fuse_heads=)`` (the tuning prefix's plan):
  the same partition and the same columns copied out of each segment as
  the JAX package's, the kept columns equal within 1e-5.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from sntc_tpu.app import _serving_form as jax_serving_form
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.base import PipelineModel as JPipelineModel
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import StandardScaler as JStandardScaler
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.fuse import FusedSegment as JFusedSegment
from sntc_tpu.fuse import compile_pipeline as jax_compile_pipeline
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu.models import MultilayerPerceptronClassifier as JMLP
from sntc_tpu_torch.app import main, serving_form
from sntc_tpu_torch.core.base import Pipeline, PipelineModel
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import write_raw_csv
from sntc_tpu_torch.feature import ChiSqSelector, VectorAssembler
from sntc_tpu_torch.fuse import (
    FusedSegment,
    compile_pipeline,
    fold_scalers,
    fused_segments,
    fusion_stats,
)
from sntc_tpu_torch.mlio import load_model
from sntc_tpu_torch.models import (
    DecisionTreeClassifier,
    LogisticRegression,
    MultilayerPerceptronClassifier,
    RandomForestClassifier,
)
from sntc_tpu_torch.serve import BatchPredictor
from sntc_tpu_torch.utils.profiling import (
    TransferLedger,
    ledger_scope,
    transfer_ledger,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

D = 6
PRED_COLS = ("rawPrediction", "probability", "prediction")


@pytest.fixture(autouse=True)
def _device_staged_path(monkeypatch):
    """The JAX package's small-batch host predict (float64 numpy) is
    another numerical path; both packages are compared on their device
    programs."""
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")


def _vector_frame(n=800, seed=0):
    """``tests/test_fuse.py``'s frame: a constant last feature exercises
    the zero-std fold."""
    rng = np.random.default_rng(seed)
    X = rng.normal(3.0, 2.0, size=(n, D)).astype(np.float32)
    X[:, D - 1] = 5.0
    y = (X[:, 0] > 3.0).astype(np.float64)
    return {"features": X, "label": y}


def _scalar_frame(n=300, seed=0, nan_rows=0):
    """``tests/test_fuse_pipeline.py``'s frame: scalar columns c0..c5 and
    a label; ``nan_rows`` poisons the first rows of c1."""
    rng = np.random.default_rng(seed)
    X = np.abs(rng.normal(3.0, 2.0, size=(n, D))).astype(np.float32)
    X[:, D - 1] = 5.0
    cols = {f"c{i}": X[:, i].copy() for i in range(D)}
    cols["c1"][:nan_rows] = np.nan
    cols["label"] = (X[:, 0] > 3.0).astype(np.float64)
    return Frame(cols)


# -- rule 1: scaler folding --------------------------------------------------


@pytest.mark.parametrize("head,tol", [("lr", 1e-5), ("mlp", 1e-4)])
def test_fold_scalers_matches_the_jax_package(head, tol, tmp_path):
    cols = _vector_frame(seed={"lr": 0, "mlp": 1}[head])
    est = (JLR(featuresCol="scaled", maxIter=40) if head == "lr" else
           JMLP(featuresCol="scaled", layers=[D, 8, 2], maxIter=40))
    jpm = JPipeline(stages=[
        JStandardScaler(inputCol="features", outputCol="scaled",
                        withMean=True),
        est,
    ]).fit(JFrame(cols))
    jax_save_model(jpm, str(tmp_path / "m"))
    pm = load_model(str(tmp_path / "m"), device="cpu")

    jfused = jax_compile_pipeline(jpm)
    fused = compile_pipeline(pm)
    assert len(fused.getStages()) == len(jfused.getStages()) == 1
    jhead, phead = jfused.getStages()[0], fused.getStages()[0]
    assert [type(s) for s in fold_scalers(pm.getStages())] == [type(phead)]
    if head == "lr":
        for attr in ("coefficientMatrix", "interceptVector"):
            np.testing.assert_array_equal(getattr(phead, attr),
                                          np.asarray(getattr(jhead, attr)))
    else:
        np.testing.assert_array_equal(phead.weights, np.asarray(jhead.weights))
    assert phead.getFeaturesCol() == "features"

    ref = jfused.transform(JFrame(cols))
    got = fused.transform(Frame(cols))
    np.testing.assert_allclose(to_host(got["probability"]),
                               np.asarray(ref["probability"]), atol=tol)
    np.testing.assert_array_equal(to_host(got["prediction"]),
                                  np.asarray(ref["prediction"]))


# -- fused against staged ----------------------------------------------------


def _heads():
    kw = dict(device="cpu", featuresCol="features")
    return {
        "lr": LogisticRegression(maxIter=30, **kw),
        "mlp": MultilayerPerceptronClassifier(layers=[4, 8, 2], maxIter=30,
                                              **kw),
        "rf": RandomForestClassifier(numTrees=5, maxDepth=4, seed=0, **kw),
        "dt": DecisionTreeClassifier(maxDepth=4, **kw),
    }


def _assert_bitwise(a: Frame, b: Frame):
    assert a.num_rows == b.num_rows
    for c in PRED_COLS:
        got, want = to_host(a[c]), to_host(b[c])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=c)


@pytest.mark.parametrize("bucket_rows", [0, 64])
@pytest.mark.parametrize("head_name", ["lr", "mlp", "rf", "dt"])
def test_fused_bitwise_equal_to_staged(head_name, bucket_rows):
    f = _scalar_frame(n=300, nan_rows=7)
    pm = Pipeline(stages=[
        VectorAssembler(inputCols=[f"c{i}" for i in range(D)],
                        outputCol="raw", handleInvalid="skip"),
        ChiSqSelector(device="cpu", numTopFeatures=4, featuresCol="raw",
                      outputCol="features"),
        _heads()[head_name],
    ]).fit(f)
    serve = f.drop("label")
    fused = compile_pipeline(pm)
    kinds = [type(s).__name__ for s in fused.getStages()]
    assert kinds == ["VectorAssembler", "FusedSegment"]
    staged_out = BatchPredictor(pm, bucket_rows=bucket_rows,
                                device="cpu").predict_frame(serve)
    predictor = BatchPredictor(fused, bucket_rows=bucket_rows, device="cpu")
    fused_out = predictor.predict_frame(serve)
    assert staged_out.num_rows == 300 - 7  # NaN rows dropped, pad stripped
    _assert_bitwise(fused_out, staged_out)
    stats = predictor.fusion_stats()
    assert stats["segments"] == 1 and stats["invocations"] == 1
    assert stats["fallbacks"] == 0 and stats["downloads"] == 1
    # padded columns are bound where pad_assemble left them; the host
    # features of an unbucketed batch are uploaded by the segment
    assert (stats["uploads"], stats["device_binds"]) == (
        (0, 1) if bucket_rows else (1, 0))


def test_float64_column_serves_the_eager_stages():
    """An ``F32_ONLY`` gather bound to a float64 column is a plan
    decision, not a failure: the segment serves its eager stages, counts
    a fallback, and the output is the staged path's."""
    f = _scalar_frame(n=200, seed=2)
    X = np.stack([f[f"c{i}"] for i in range(D)], axis=1).astype(np.float64)
    pm = Pipeline(stages=[
        ChiSqSelector(device="cpu", numTopFeatures=4, featuresCol="raw",
                      outputCol="features"),
        _heads()["rf"],
    ]).fit(Frame({"raw": X, "label": f["label"]}))
    fused = compile_pipeline(pm)
    (seg,) = fused_segments(fused)
    serve = Frame({"raw": X})
    _assert_bitwise(fused.transform(serve), pm.transform(serve))
    assert (seg.fallbacks, seg.invocations) == (1, 0)


# -- transfer ledger ---------------------------------------------------------


def _config3_rows(n, seed):
    live = jax_clean_flows(jax_generate_frame(n, seed=seed, dirty=False))
    return Frame({c: np.asarray(live[c]) for c in live.columns
                  if c != "Label"})


@pytest.fixture(scope="module")
def cli_models(tmp_path_factory):
    """Bench configs 1-4 as the port's ``train`` command builds them, at
    test widths, on one day file; ``{config: model_dir}``."""
    root = tmp_path_factory.mktemp("cli_models")
    raw = jax_generate_frame(1500, seed=4, min_class_fraction=0.005)
    (root / "data").mkdir()
    write_raw_csv(Frame({c: np.asarray(raw[c]) for c in raw.columns}),
                  str(root / "data" / "day.csv"))
    args = {
        1: ["--estimator", "lr", "--binary", "--reg-param", "1e-4",
            "--max-iter", "5"],
        2: ["--max-iter", "3"],
        3: ["--estimator", "rf", "--chisq-top", "10", "--num-trees", "2",
            "--max-depth", "3"],
        4: ["--estimator", "gbt", "--chisq-top", "0", "--max-iter", "1",
            "--max-depth", "2", "--max-bins", "16"],
    }
    out = {}
    for config, extra in args.items():
        out[config] = str(root / f"config{config}")
        with redirect_stdout(io.StringIO()):
            assert main(["train", "--data", str(root / "data"),
                         "--model-out", out[config], "--device", "cpu",
                         *extra]) == 0
    return out


def test_one_upload_one_download_per_micro_batch(cli_models):
    served, _, _ = serving_form(load_model(cli_models[3], device="cpu"),
                                fuse=True)
    (seg,) = fused_segments(served)
    rows = _config3_rows(700, seed=5)
    batches = [rows.slice(0, 300), rows.slice(300, 555), rows.slice(555, 700)]
    for bucket_rows in (0, 256):
        predictor = BatchPredictor(served, bucket_rows=bucket_rows,
                                   device="cpu")
        ledger = TransferLedger()
        before = (seg.invocations, seg.downloads)
        process_before = transfer_ledger().snapshot()
        with ledger_scope(ledger):
            outs = [predictor.predict_frame(b) for b in batches]
        snap = ledger.snapshot()
        # one upload: the segment's bind of the host features, or the
        # padded block of pad_assemble that the segment binds in place
        assert snap["uploads"] == snap["downloads"] == len(batches)
        assert snap["dispatches"] == len(batches)  # one fused dispatch each
        # the process-wide view saw the same copies
        process = transfer_ledger().snapshot()
        assert {k: process[k] - process_before[k] for k in snap} == snap
        assert (seg.invocations, seg.downloads) == tuple(
            v + len(batches) for v in before)
        for b, out in zip(batches, outs):
            assert out.num_rows == b.num_rows
            assert "features" not in out  # the selection stays on device
    stats = fusion_stats(served)
    assert stats["segments"] == 1 and stats["fallbacks"] == 0


def test_skip_path_records_every_upload(cli_models, monkeypatch):
    """Rows the ``skip`` assembler drops cost the device path one read of
    the row mask and, unless the kept rows are a leading run, one upload
    of their indices (gathered from every device column at once); the
    ledger records each.  Every tensor the path makes from host memory
    is a recorded upload."""
    served, _, _ = serving_form(load_model(cli_models[3], device="cpu"),
                                fuse=True)
    rows = _config3_rows(700, seed=5)
    rate = rows["Flow Bytes/s"].copy()
    rate[[10, 200, 554]] = np.nan  # mid-batch rows, then a last row
    rows = rows.with_column("Flow Bytes/s", rate)
    batches = [rows.slice(0, 300), rows.slice(300, 555), rows.slice(555, 700)]
    # per bucket floor: (uploads, syncs); 0 assembles and skips on the
    # host, 256 on the device (padded to 512, 256, 256 rows: the second
    # batch's bad last row is repeated by its pad row, a tail to cut)
    want = {0: (3, 0), 256: (4, 5)}
    made = []
    from_numpy = torch.from_numpy

    def counting(a):
        made.append(a.shape)
        return from_numpy(a)

    for bucket_rows, (uploads, syncs) in want.items():
        predictor = BatchPredictor(served, bucket_rows=bucket_rows,
                                   device="cpu")
        predictor.predict_frame(batches[2])  # the plans' constants
        ledger = TransferLedger()
        made.clear()
        monkeypatch.setattr(torch, "from_numpy", counting)
        with ledger_scope(ledger):
            outs = [predictor.predict_frame(b) for b in batches]
        monkeypatch.setattr(torch, "from_numpy", from_numpy)
        snap = ledger.snapshot()
        assert (snap["uploads"], snap["downloads"], snap["syncs"]) == (
            uploads, len(batches), syncs)
        assert len(made) == uploads
        assert [o.num_rows for o in outs] == [298, 254, 145]


# -- the partition of the CLI pipelines --------------------------------------


def _partition(model, segment_type):
    return [
        [type(s).__name__ for s in stage.fused_stages]
        if isinstance(stage, segment_type) else type(stage).__name__
        for stage in model.getStages()
    ]


@pytest.mark.parametrize("config,want", [
    (1, ["VectorAssembler", "LogisticRegressionModel", "IndexToString"]),
    (2, ["VectorAssembler", "MultilayerPerceptronClassificationModel",
         "IndexToString"]),
    (3, ["VectorAssembler",
         ["ChiSqSelectorModel", "RandomForestClassificationModel"],
         "IndexToString"]),
    (4, ["VectorAssembler", "OneVsRestModel", "IndexToString"]),
])
def test_cli_pipelines_partition_as_the_jax_package(cli_models, config, want):
    path = cli_models[config]
    jserved, _, _ = jax_serving_form(jax_load_model(path), "label", True)
    served, _, _ = serving_form(load_model(path, device="cpu"), "label", True)
    assert _partition(served, FusedSegment) == want
    assert _partition(jserved, JFusedSegment) == want
    if config in (1, 2):  # the scaler folded into the same weights
        jhead, head = jserved.getStages()[1], served.getStages()[1]
        for attr in ("coefficientMatrix", "interceptVector", "weights"):
            if hasattr(head, attr):
                np.testing.assert_array_equal(
                    getattr(head, attr), np.asarray(getattr(jhead, attr)))


# -- keep and fuse_heads: the tuning prefix's plan ---------------------------


@pytest.mark.parametrize("keep,fuse_heads,prefix_only,want", [
    (("features", "label"), False, True,
     ["VectorAssembler", ["StandardScalerModel"]]),
    # the rewrite rules run first: the scaler folds into the head
    (("features", "label"), False, False,
     ["VectorAssembler", "LogisticRegressionModel"]),
    ((), False, False,
     ["VectorAssembler", "LogisticRegressionModel"]),
    (("raw",), True, False,
     ["VectorAssembler", "LogisticRegressionModel"]),
])
def test_keep_and_fuse_heads_plan_as_the_jax_package(
        keep, fuse_heads, prefix_only, want, tmp_path):
    """``compile_pipeline(keep=, fuse_heads=)`` keeps and fuses the same
    columns and stages as the JAX package's (the tuning hoist compiles a
    fitted prefix with its head's inputs kept and no head fused); the
    kept columns come out equal within float32 rounding."""
    frame = _scalar_frame(seed=4)
    cols = {c: to_host(frame[c]) for c in frame.columns}
    names = [f"c{i}" for i in range(D)]
    jpm = JPipeline(stages=[
        JVectorAssembler(inputCols=names, outputCol="raw"),
        JStandardScaler(inputCol="raw", outputCol="features", withMean=True),
        JLR(maxIter=10),
    ]).fit(JFrame(dict(cols)))
    jax_save_model(jpm, str(tmp_path / "m"))
    pm = load_model(str(tmp_path / "m"), device="cpu")
    if prefix_only:
        jpm = JPipelineModel(stages=jpm.getStages()[:-1])
        pm = PipelineModel(stages=pm.getStages()[:-1])
    jc = jax_compile_pipeline(jpm, keep=keep, fuse_heads=fuse_heads)
    pc = compile_pipeline(pm, keep=keep, fuse_heads=fuse_heads)
    assert _partition(pc, FusedSegment) == _partition(jc, JFusedSegment)
    jsegs = [s for s in jc.getStages() if isinstance(s, JFusedSegment)]
    psegs = [s for s in pc.getStages() if isinstance(s, FusedSegment)]
    assert [s._live_writes for s in psegs] == [s._live_writes for s in jsegs]
    assert _partition(pc, FusedSegment) == want
    jout = jc.transform(JFrame(dict(cols)))
    pout = pc.transform(Frame(dict(cols)))
    for name in keep:
        if name in jout.columns:
            np.testing.assert_allclose(to_host(pout[name]),
                                       np.asarray(jout[name]), atol=1e-5)
