"""The port's ingest source graph and columnar plane against the JAX
package's, on the CPU.

* ``read_flows_columnar`` is bitwise the JAX package's, and equal to the
  port's ``load_csv`` → ``clean_flows``, for ``drop``, ``zero`` and
  ``None`` (``None``: every row kept, the float32 cast of ``load_csv``'s
  columns, NaN and Inf in place); its columns are float32 views over
  Arrow's buffers;
* ``describe_graph`` has the JAX package's keys, and the meters count
  what the JAX engine's count on the same stream;
* ``set_read_workers`` / ``set_prefetch_batches`` resize a running
  engine's pools without changing its committed files, and a shrunk
  pool's idle threads exit;
* the columnar source serves config 3's pipeline into batch files
  byte-identical to the float64 source's, through row admission too;
* the engine's autotuner ticks (``tests/test_ingest_pipeline.py::
  test_engine_autotune_end_to_end``) and degrades, never kills.
"""

import os
import time

import numpy as np
import pyarrow.csv as pacsv
import pytest

import sntc_tpu.data.pipeline as JP
import sntc_tpu.resilience as J
import sntc_tpu_torch.data.pipeline as PP
import sntc_tpu_torch.resilience as R
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.data import CICIDS2017_FEATURES
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import ChiSqSelector as JChiSqSelector
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import RandomForestClassifier as JRandomForest
from sntc_tpu.serve import FileStreamSource as JFileStreamSource
from sntc_tpu.serve import MemorySink as JMemorySink
from sntc_tpu.serve import StreamingQuery as JStreamingQuery
from sntc_tpu_torch.app import serving_form
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data import (
    CICIDS2017_CONTRACT,
    LABEL_COLUMN,
    clean_flows,
    generate_frame,
    load_csv,
    load_csv_dir,
    write_raw_csv,
)
from sntc_tpu_torch.data.autotune import AutotunePolicy, IngestAutotuner
from sntc_tpu_torch.mlio import load_model
from sntc_tpu_torch.serve import (
    CsvDirSink,
    FileStreamSource,
    MemorySink,
    MemorySource,
    StreamingQuery,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("SNTC_FAULTS", raising=False)
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    for pkg in (J, R):
        pkg.clear()
        pkg.clear_events()
    yield


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.uint32 if a.itemsize == 4 else np.uint64)
    return a


def _frames_bitwise(a, b):
    assert list(a.columns) == list(b.columns)
    assert a.num_rows == b.num_rows
    for c in a.columns:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype, c
        assert np.array_equal(_bits(x), _bits(y)), c


@pytest.fixture(scope="module")
def day_csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("days")
    paths = []
    for i, seed in enumerate((3, 4)):
        path = str(d / f"day_{i}.csv")
        # dirty rows: Inf/NaN in the rate columns, for the policies
        write_raw_csv(generate_frame(1500, seed=seed), path)
        paths.append(path)
    return str(d), paths


@pytest.mark.parametrize("mode", ["drop", "zero", None])
def test_columnar_reader_bitwise_against_jax_and_clean_flows(day_csvs,
                                                             mode):
    _dir, paths = day_csvs
    port = PP.read_flows_columnar(paths[0], handle_invalid=mode)
    jax = JP.read_flows_columnar(paths[0], handle_invalid=mode)
    _frames_bitwise(port, Frame({c: np.asarray(jax[c])
                                 for c in jax.columns}))
    legacy = load_csv(paths[0])
    if mode is None:
        # every row kept; each feature the float32 cast of load_csv's
        want = Frame({c: (np.asarray(legacy[c]).astype(np.float32)
                          if c != LABEL_COLUMN else port[c])
                      for c in legacy.columns})
        assert any(not np.isfinite(np.asarray(port[c])).all()
                   for c in port.columns if c != LABEL_COLUMN)
    else:
        want = clean_flows(legacy, handle_invalid=mode)
    _frames_bitwise(port, want)


def test_columnar_dir_loader_bitwise(day_csvs):
    d, _paths = day_csvs
    _frames_bitwise(PP.load_flows_columnar(d), clean_flows(load_csv_dir(d)))


def test_columnar_columns_are_float32_views(day_csvs):
    _dir, paths = day_csvs
    frame = PP.read_flows_columnar(paths[0], handle_invalid="drop")
    feats = [c for c in frame.columns if c != LABEL_COLUMN]
    assert len(feats) == len(CICIDS2017_FEATURES)
    for c in feats:
        assert frame[c].dtype == np.float32
        assert not frame[c].flags.owndata
    with pytest.raises(ValueError, match="handle_invalid"):
        PP.read_flows_columnar(paths[0], handle_invalid="impute")


class _PortCols:
    """A duck-typed served model over the 4-column stream frames."""

    def transform(self, f):
        return f.with_column("prediction", np.asarray(f["a"])
                             + np.asarray(f["b"]))

    def transform_async(self, f):
        out = self.transform(f)
        return lambda: out


def _stream_dir(path, n_files=8, rows=40, seed=0, first=0):
    rng = np.random.default_rng(seed + first)
    os.makedirs(path, exist_ok=True)
    for i in range(first, first + n_files):
        chunk = Frame({k: rng.normal(size=rows) for k in "abcd"})
        pacsv.write_csv(chunk.to_arrow(), os.path.join(path, f"p_{i:03d}.csv"))
    return path


def test_meters_and_graph_description_match_jax(tmp_path):
    """``tests/test_ingest_pipeline.py::test_source_meters_and_graph_
    description`` on both packages: the same stages, counts and graph
    keys."""
    in_dir = _stream_dir(str(tmp_path / "in"))
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "port":
            src = FileStreamSource(in_dir, prefetch_batches=2, read_workers=2)
            q = StreamingQuery(_PortCols(), src, MemorySink(),
                               str(tmp_path / "ckpt_p"), max_batch_offsets=2,
                               device="cpu", overlap_sink=False)
            describe = PP.describe_graph
        else:
            src = JFileStreamSource(in_dir, prefetch_batches=2,
                                    read_workers=2)
            q = JStreamingQuery(_PortCols(), src, JMemorySink(),
                                str(tmp_path / "ckpt_j"), max_batch_offsets=2)
            describe = JP.describe_graph
        assert q.process_available() == 4
        stats = q.pipeline_stats()
        desc = describe(q)
        out[pkg] = (
            {s: stats["ingest"][s]["count"] for s in stats["ingest"]},
            {s: sorted(row) for s, row in desc.items()},
            desc["parse"]["workers"], desc["stage"]["queue_bound"])
        assert stats["ingest"]["parse"]["ewma_s"] > 0
        src.close()
    assert out["port"] == out["jax"]
    assert list(out["port"][1]) == list(PP.STAGES)
    assert out["port"][0]["parse"] == 8 and out["port"][0]["read"] == 4


def _sink_bytes(out):
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out)) if f.endswith(".csv")}


def _port_stream(in_dir, out, ckpt, **kw):
    src = FileStreamSource(in_dir, prefetch_batches=kw.pop("prefetch", 1),
                           read_workers=kw.pop("workers", 1))
    q = StreamingQuery(_PortCols(), src, CsvDirSink(out, durable=False), ckpt,
                       device="cpu", **kw)
    return q, src


def test_live_resize_keeps_committed_files(tmp_path):
    in_dir = _stream_dir(str(tmp_path / "in"), n_files=10)
    ref_q, ref_src = _port_stream(in_dir, str(tmp_path / "ref"),
                                  str(tmp_path / "ck_ref"),
                                  max_batch_offsets=2)
    ref_q.process_available()
    ref_src.close()
    q, src = _port_stream(in_dir, str(tmp_path / "out"),
                          str(tmp_path / "ck"), max_batch_offsets=2)
    knobs = PP.graph_knobs(q)
    assert set(knobs) == set(PP.KNOB_NAMES)
    q._run_one_batch()  # staged ranges in flight
    staged_before = dict(src._staged)
    knobs["read_workers"].set(3)
    knobs["prefetch_batches"].set(4)
    assert src.read_workers == 3 and src.prefetch_batches == 4
    assert src._retired_pools  # the resized-out pools were retired
    for fut in staged_before.values():  # nothing staged was cancelled
        assert not fut.cancelled()
    pool = src._read_pool
    src.set_read_workers(3)  # the same size: no churn
    assert src._read_pool is pool
    q._run_one_batch()
    knobs["prefetch_batches"].set(1)
    knobs["read_workers"].set(1)
    knobs["pipeline_depth"].set(1)
    q.process_available()
    _stream_dir(in_dir, n_files=4, first=10)  # more files arrive
    q.process_available()
    # the shrunk pools' idle threads exit
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.is_alive() for p in src._retired_pools for t in p._threads):
        time.sleep(0.05)
    assert not any(t.is_alive() for p in src._retired_pools
                   for t in p._threads)
    got = _sink_bytes(str(tmp_path / "out"))
    ref = _sink_bytes(str(tmp_path / "ref"))
    assert {f: got[f] for f in ref} == ref
    assert len(got) == 7  # 10 files, then 4 more, 2 a batch
    src.close()
    assert not src._retired_pools


def test_engine_autotune_ticks_and_degrades(tmp_path):
    """An aggressive tuner on a CSV stream: the files equal an untuned
    run's, decisions ride the stats; a tuner that raises emits
    autotune_error and the stream keeps serving."""
    in_dir = _stream_dir(str(tmp_path / "in"), n_files=14)
    ref_q, ref_src = _port_stream(in_dir, str(tmp_path / "ref"),
                                  str(tmp_path / "ck_ref"),
                                  max_batch_offsets=1)
    ref_q.process_available()
    ref_src.close()
    tuner = IngestAutotuner(policy=AutotunePolicy(interval_ticks=1,
                                                  confirm=1, cooldown=0))
    q, src = _port_stream(in_dir, str(tmp_path / "out"), str(tmp_path / "ck"),
                          max_batch_offsets=1, autotuner=tuner)
    assert q.process_available() == 14
    stats = q.pipeline_stats()
    assert stats["autotune"]["windows"] > 0
    assert set(stats["autotune"]["knobs"]) == set(PP.KNOB_NAMES)
    assert _sink_bytes(str(tmp_path / "out")) == \
        _sink_bytes(str(tmp_path / "ref"))
    src.close()

    class Exploding:
        def on_tick(self, engine):
            raise RuntimeError("controller bug")

    sink = MemorySink()
    q = StreamingQuery(_PortCols(), MemorySource(
        [Frame({k: np.ones(5) for k in "abcd"})]), sink,
        str(tmp_path / "ck2"), device="cpu", autotuner=Exploding())
    assert q.process_available() == 1 and len(sink.frames) == 1
    ev = R.recent_events(event="autotune_error")
    assert ev and "controller bug" in ev[0]["error"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    train = jax_clean_flows(jax_generate_frame(2000, seed=1))
    pm = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label",
                       handleInvalid="skip"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="rawFeatures", handleInvalid="skip"),
        JChiSqSelector(numTopFeatures=10, featuresCol="rawFeatures",
                       labelCol="label", outputCol="features"),
        JRandomForest(numTrees=3, maxDepth=4, seed=0),
    ]).fit(train)
    path = str(tmp_path_factory.mktemp("ingest_model") / "model")
    jax_save_model(pm, path)
    return path


@pytest.mark.parametrize("policy", [None, "salvage"])
def test_columnar_source_serves_the_float64_sources_files(model_dir,
                                                          tmp_path, policy):
    """Config 3's pipeline (fused, bucketed, pipelined) over float32
    columns from the columnar source writes the float64 source's batch
    files byte for byte, and through row admission (the columns are
    read-only views) too."""
    in_dir = str(tmp_path / "in")
    os.makedirs(in_dir)
    rows = generate_frame(900, seed=5 if policy else 6).drop("Label")
    if policy is None:
        rows = clean_flows(rows)
    for i, (a, b) in enumerate(((0, 300), (300, 650), (650, rows.num_rows))):
        write_raw_csv(rows.slice(a, b), os.path.join(in_dir, f"p_{i}.csv"))
    files = {}
    for columnar in (False, True):
        model, _, out_cols = serving_form(load_model(model_dir, device="cpu"),
                                          "label", True)
        src = FileStreamSource(in_dir, prefetch_batches=2, read_workers=2,
                               columnar=columnar,
                               parse_salvage=policy is not None)
        out = str(tmp_path / f"out_{columnar}")
        q = StreamingQuery(
            model, src, CsvDirSink(out, out_cols), str(tmp_path / f"ck_{columnar}"),
            max_batch_offsets=1, shape_buckets=64, device="cpu",
            schema_contract=(CICIDS2017_CONTRACT.with_mode(policy)
                             if policy else None))
        assert q.process_available() == 3
        src.close()
        files[columnar] = _sink_bytes(out)
        if policy:
            assert q.admission_stats()["rows_rejected"] > 0
    assert files[True] == files[False] and len(files[True]) == 3
