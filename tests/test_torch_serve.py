"""The port's serve path against the JAX package's, on the CPU.

A small config-3 RF pipeline is fitted and saved with ``sntc_tpu``; the
port serves it through ``BatchPredictor`` with shape buckets and through
``python -m sntc_tpu_torch serve`` (called in-process as ``main``), and
its outputs are held against the JAX package's staged serving form on
the same rows.  The exactly-once offset log is exercised by re-running
and by replaying a batch whose commit was lost.
"""

import json
import os

import numpy as np
import pyarrow.csv as pacsv
import pytest
import torch

from sntc_tpu.app import _serving_form as jax_serving_form
from sntc_tpu.core.base import Pipeline
from sntc_tpu.data import CICIDS2017_FEATURES, clean_flows
from sntc_tpu.data.ingest import load_csv as jax_load_csv
from sntc_tpu.data.synth import _write_raw_csv as jax_write_raw_csv
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import ChiSqSelector, StringIndexer
from sntc_tpu.feature import VectorAssembler as JaxVectorAssembler
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import RandomForestClassifier
from sntc_tpu.serve.transform import BatchPredictor as JaxBatchPredictor
from sntc_tpu_torch.app import main, serving_form
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import clean_flows as port_clean_flows
from sntc_tpu_torch.data import generate_frame, load_csv, write_raw_csv
from sntc_tpu_torch.kernels import LAUNCHES
from sntc_tpu_torch.mlio import load_model
from sntc_tpu_torch.serve import BatchPredictor, bucket_rows_for
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

RTOL = 1e-5  # per-tree vote sums run in another order than XLA's


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    train = clean_flows(jax_generate_frame(2000, seed=1))
    pm = Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        JaxVectorAssembler(inputCols=CICIDS2017_FEATURES,
                           outputCol="rawFeatures"),
        ChiSqSelector(numTopFeatures=10, featuresCol="rawFeatures",
                      labelCol="label", outputCol="features"),
        RandomForestClassifier(numTrees=3, maxDepth=4, seed=0),
    ]).fit(train)
    path = str(tmp_path_factory.mktemp("jax_rf_serve") / "model")
    jax_save_model(pm, path)
    return pm, path


def _traffic(n, seed):
    """Clean serving rows (no label: live flows carry none)."""
    f = clean_flows(jax_generate_frame(n, seed=seed, dirty=False))
    assert f.num_rows == n
    return f.drop("Label")


@pytest.mark.parametrize("n_rows", [1, 7, 255, 300])
def test_bucketed_predictions_equal_unbucketed(fitted, n_rows):
    pm, path = fitted
    served, _, _ = serving_form(load_model(path, device="cpu"))
    rows = _traffic(400, seed=9).slice(0, n_rows)
    frame = Frame({c: rows[c] for c in rows.columns})
    bucketed = BatchPredictor(served, bucket_rows=256, device="cpu")
    plain = BatchPredictor(served, bucket_rows=0, device="cpu")
    a, b = bucketed.predict_frame(frame), plain.predict_frame(frame)
    assert a.num_rows == b.num_rows == n_rows
    assert a.columns == b.columns
    for c in ("rawPrediction", "probability", "prediction", "predictedLabel"):
        np.testing.assert_array_equal(to_host(a[c]), to_host(b[c]))
    # and both agree with the JAX package's staged serving form
    jserved, _, _ = jax_serving_form(pm, "label", fuse=False)
    ref = jserved.transform(rows)
    np.testing.assert_allclose(
        to_host(a["probability"]), np.asarray(ref["probability"]),
        rtol=RTOL, atol=0,
    )
    np.testing.assert_array_equal(
        to_host(a["predictedLabel"]), np.asarray(ref["predictedLabel"])
    )


def test_chunked_predictions_equal_one_dispatch(fitted):
    _pm, path = fitted
    served, _, _ = serving_form(load_model(path, device="cpu"))
    rows = _traffic(530, seed=15)
    frame = Frame({c: rows[c] for c in rows.columns})
    whole = BatchPredictor(served, bucket_rows=64, device="cpu")
    chunked = BatchPredictor(served, chunk_rows=100, bucket_rows=64,
                             device="cpu")
    a, b = whole.predict_frame(frame), chunked.predict_frame(frame)
    assert b.num_rows == 530
    for c in ("probability", "prediction", "predictedLabel"):
        np.testing.assert_array_equal(to_host(b[c]), to_host(a[c]))
    # five 100-row chunks pad to 128, the 30-row tail to 64
    assert chunked.compile_events == 2 and chunked.padded_rows_total == 5 * 28 + 34


def test_shape_ledger_matches_the_jax_predictor(fitted):
    pm, path = fitted
    served, _, _ = serving_form(load_model(path, device="cpu"))
    jserved, _, _ = jax_serving_form(pm, "label", fuse=False)
    port = BatchPredictor(served, bucket_rows=256, device="cpu")
    jax_pred = JaxBatchPredictor(jserved, bucket_rows=256)
    rows = _traffic(1200, seed=10)
    for n in (1, 7, 255, 300, 256, 1000, 7):
        part = rows.slice(0, n)
        port.predict_frame(Frame({c: part[c] for c in part.columns}))
        jax_pred.predict_frame(part)
        assert port.compile_events == jax_pred.compile_events
        assert port.bucket_hits == jax_pred.bucket_hits
        assert port.padded_rows_total == jax_pred.padded_rows_total
    assert port.compile_events == 3  # buckets 256, 512, 1024


@pytest.mark.parametrize("n,floor,want", [
    (0, 256, 0), (1, 256, 256), (256, 256, 256), (257, 256, 512),
    (300, 0, 300), (5, 100, 128), (65536, 256, 65536),
])
def test_bucket_rows_for(n, floor, want):
    assert bucket_rows_for(n, floor) == want


def _serve(tmp_path, model_path, *extra):
    args = [
        "serve", "--model", model_path,
        "--watch", str(tmp_path / "in"), "--out", str(tmp_path / "out"),
        "--checkpoint", str(tmp_path / "ckpt"), "--once",
        "--max-files-per-batch", "1", "--shape-buckets", "256",
        "--device", "cpu", *extra,
    ]
    return main(args)


# the serial, staged form with the append-mode WAL these tests pin
SERIAL_FORM = ("--no-fuse", "--pipeline-depth", "1", "--wal-mode", "append")


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _read_sink(path):
    t = pacsv.read_csv(path)
    return t.column("prediction").to_numpy(), \
        np.asarray(t.column("predictedLabel").to_pylist(), dtype=object)


def test_serve_end_to_end_exactly_once(fitted, tmp_path, capsys):
    pm, path = fitted
    inp = tmp_path / "in"
    inp.mkdir()
    rows = _traffic(700, seed=12)
    sizes = [100, 300, 256]
    starts = np.cumsum([0] + sizes)
    for i, (s, n) in enumerate(zip(starts, sizes)):
        write_raw_csv(
            Frame({c: rows[c] for c in rows.columns}).slice(s, s + n),
            str(inp / f"part_{i:04d}.csv"),
        )
    assert _serve(tmp_path, path, *SERIAL_FORM) == 0
    summary = _summary(capsys)
    assert summary["batches"] == 3 and summary["rows"] == sum(sizes)
    assert summary["device"] == "cpu"
    assert summary["kernel_launches"] == {"forest_traversal": 0,
                                          "pad_assemble": 0, "tree_hist": 0}
    assert summary["compile_events"] == 2  # buckets 256 and 512 (300 rows)
    out_files = sorted(os.listdir(tmp_path / "out"))
    assert out_files == [f"batch_{i:06d}.csv" for i in range(3)]

    jserved, _, _ = jax_serving_form(pm, "label", fuse=False)
    for i, n in enumerate(sizes):
        pred, label = _read_sink(tmp_path / "out" / out_files[i])
        assert len(pred) == n
        ref = jserved.transform(jax_load_csv(str(inp / f"part_{i:04d}.csv")))
        np.testing.assert_array_equal(pred, np.asarray(ref["prediction"]))
        np.testing.assert_array_equal(label, np.asarray(ref["predictedLabel"]))

    # a second run finds everything committed: nothing is re-emitted
    before = {f: (tmp_path / "out" / f).read_bytes() for f in out_files}
    mtimes = {f: os.stat(tmp_path / "out" / f).st_mtime_ns for f in out_files}
    assert _serve(tmp_path, path, *SERIAL_FORM) == 0
    assert _summary(capsys)["batches"] == 0
    assert {f: os.stat(tmp_path / "out" / f).st_mtime_ns
            for f in out_files} == mtimes

    # lose the last commit: exactly that batch replays, identically
    commits = tmp_path / "ckpt" / "commits.log"
    lines = commits.read_text().splitlines(keepends=True)
    commits.write_text("".join(lines[:-1]))
    os.remove(tmp_path / "out" / out_files[-1])
    assert _serve(tmp_path, path, *SERIAL_FORM) == 0
    assert _summary(capsys)["batches"] == 1
    after = {f: (tmp_path / "out" / f).read_bytes() for f in out_files}
    assert after == before
    assert {f: os.stat(tmp_path / "out" / f).st_mtime_ns
            for f in out_files[:-1]} == {f: mtimes[f] for f in out_files[:-1]}


def test_serve_recovers_from_a_torn_log_tail(fitted, tmp_path, capsys):
    _pm, path = fitted
    inp = tmp_path / "in"
    inp.mkdir()
    rows = _traffic(200, seed=13)
    frame = Frame({c: rows[c] for c in rows.columns})
    write_raw_csv(frame.slice(0, 90), str(inp / "part_0000.csv"))
    assert _serve(tmp_path, path, *SERIAL_FORM) == 0
    assert _summary(capsys)["batches"] == 1
    with open(tmp_path / "ckpt" / "offsets.log", "a") as f:
        f.write('{"batch_id": 1, "sta')  # a crash mid-append
    write_raw_csv(frame.slice(90, 200), str(inp / "part_0001.csv"))
    assert _serve(tmp_path, path, *SERIAL_FORM) == 0
    assert _summary(capsys)["batches"] == 1
    intents = [json.loads(l) for l in
               (tmp_path / "ckpt" / "offsets.log").read_text().splitlines()]
    assert [r["batch_id"] for r in intents] == [0, 1]
    pred, _ = _read_sink(tmp_path / "out" / "batch_000001.csv")
    assert len(pred) == 110


def test_serve_refuses_cuda_when_missing(fitted, tmp_path, monkeypatch):
    _pm, path = fitted
    (tmp_path / "in").mkdir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["serve", "--model", path, "--watch", str(tmp_path / "in"),
              "--out", str(tmp_path / "out"), "--checkpoint",
              str(tmp_path / "ckpt"), "--once"])


def test_csv_ingest_matches_the_jax_package(tmp_path):
    raw = jax_generate_frame(120, seed=4)
    jax_write_raw_csv(raw, str(tmp_path / "jax.csv"))
    ref = jax_load_csv(str(tmp_path / "jax.csv"))
    got = load_csv(str(tmp_path / "jax.csv"))
    assert got.columns == ref.columns
    for c in ref.columns:
        np.testing.assert_array_equal(got[c], np.asarray(ref[c]))
    # the port's writer round-trips the same values through either reader
    write_raw_csv(generate_frame(120, seed=4), str(tmp_path / "port.csv"))
    back = jax_load_csv(str(tmp_path / "port.csv"))
    for c in ref.columns:
        np.testing.assert_array_equal(np.asarray(back[c]), np.asarray(ref[c]))


@pytest.mark.parametrize("mode", ["drop", "zero"])
def test_clean_flows_matches_the_jax_package(mode):
    raw = jax_generate_frame(3000, seed=6)
    ref = clean_flows(raw, handle_invalid=mode)
    got = port_clean_flows(Frame({c: raw[c] for c in raw.columns}),
                           handle_invalid=mode)
    assert got.num_rows == ref.num_rows and got.columns == ref.columns
    for c in ref.columns:
        np.testing.assert_array_equal(got[c], np.asarray(ref[c]))


def test_launch_counters_stay_zero_on_the_cpu_path(fitted):
    _pm, path = fitted
    served, _, _ = serving_form(load_model(path, device="cpu"))
    before = dict(LAUNCHES)
    rows = _traffic(50, seed=14)
    BatchPredictor(served, bucket_rows=64, device="cpu").predict_frame(
        Frame({c: rows[c] for c in rows.columns})
    )
    assert LAUNCHES == before
