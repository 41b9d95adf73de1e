"""The port's streaming engine against its serial form and against the
JAX package's engine, on the CPU.

A config-3 pipeline (label indexer, a ``skip`` assembler of the 78
CICIDS2017 features, ChiSq top 10, a 3-tree random forest) is fitted and
saved by the JAX package and served from one directory of CSV files
(with the generator's Inf/NaN rows, which the assembler drops):

* the pipelined engine (depth 2, overlapped sink, prefetch 2, a 4-wide
  read pool, shape buckets 64) over the fused form writes sink files
  byte-identical to the serial engine's over the staged form, in both
  WAL formats (``tests/test_streaming.py::
  test_overlap_sink_query_matches_serial``);
* against the JAX engine in the same configuration: the same batch ids,
  offset ranges and row counts, and predictions equal except where the
  top two probabilities lie within 1e-5 of each other (the forest's
  per-tree votes are summed in another order than XLA's);
* a sink or segment error raises out of ``process_available``; the
  batches in flight stay uncommitted and the next start replays them
  with their logged ranges, each exactly once (``::
  test_pipelined_crash_replays_inflight_intents``);
* a files-mode checkpoint of either package, with two batches committed
  and one intent pending, is resumed by the other;
* files-mode pruning leaves the JAX engine's file names;
* the ``serve`` parser's defaults are the JAX command's.
"""

import json
import os

import numpy as np
import pyarrow.csv as pacsv
import pytest
import torch

import sntc_tpu.app as jax_app
from sntc_tpu.app import _serving_form as jax_serving_form
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.data import CICIDS2017_FEATURES, clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import ChiSqSelector as JChiSqSelector
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import RandomForestClassifier as JRandomForest
from sntc_tpu.serve.streaming import CsvDirSink as JCsvDirSink
from sntc_tpu.serve.streaming import FileStreamSource as JFileStreamSource
from sntc_tpu.serve.streaming import StreamingQuery as JStreamingQuery
from sntc_tpu_torch.app import build_parser, serving_form
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import load_csv, write_raw_csv
from sntc_tpu_torch.fuse import FusedSegment
from sntc_tpu_torch.mlio import load_model
from sntc_tpu_torch.serve import (
    BatchPredictor,
    CsvDirSink,
    FileStreamSource,
    StreamingQuery,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

TIE_TOL = 1e-5  # the random forest's stated tolerance (ROADMAP queue C)
SIZES = [37, 120, 64, 90, 200, 51, 128, 75, 33]  # rows per CSV file
OUT_COLS = ["prediction", "predictedLabel"]


@pytest.fixture(autouse=True)
def _device_staged_path(monkeypatch):
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    train = clean_flows(jax_generate_frame(2000, seed=1))
    pm = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label",
                       handleInvalid="skip"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="rawFeatures", handleInvalid="skip"),
        JChiSqSelector(numTopFeatures=10, featuresCol="rawFeatures",
                       labelCol="label", outputCol="features"),
        JRandomForest(numTrees=3, maxDepth=4, seed=0),
    ]).fit(train)
    path = str(tmp_path_factory.mktemp("stream_model") / "model")
    jax_save_model(pm, path)
    return path


def _write_stream(watch, sizes, first=0, seed=21):
    """CSV files ``part_<i>.csv`` of ``sizes`` rows, Inf/NaN rows in."""
    os.makedirs(watch, exist_ok=True)
    rows = jax_generate_frame(sum(sizes), seed=seed + first).drop("Label")
    frame = Frame({c: np.asarray(rows[c]) for c in rows.columns})
    start = 0
    for i, n in enumerate(sizes, start=first):
        write_raw_csv(frame.slice(start, start + n),
                      os.path.join(watch, f"part_{i:04d}.csv"))
        start += n


def _port_query(path, watch, out, ckpt, form="pipelined", sink=None,
                max_files=2, **kw):
    fuse = form == "pipelined"
    model, _, out_cols = serving_form(load_model(path, device="cpu"),
                                      "label", fuse)
    pipelined = dict(pipeline_depth=2, shape_buckets=64)
    serial = dict(pipeline_depth=1, shape_buckets=0)
    source = FileStreamSource(watch, prefetch_batches=2 if fuse else 0,
                              read_workers=4 if fuse else 1)
    q = StreamingQuery(model, source, sink or CsvDirSink(out, out_cols),
                       ckpt, max_batch_offsets=max_files, device="cpu",
                       **(pipelined if fuse else serial), **kw)
    return q, source


def _jax_query(path, watch, out, ckpt, sink=None, max_files=2, **kw):
    from sntc_tpu.mlio import load_model as jax_load_model

    model, _, out_cols = jax_serving_form(jax_load_model(path), "label", True)
    source = JFileStreamSource(watch, prefetch_batches=2, read_workers=4)
    return JStreamingQuery(
        model, source, sink or JCsvDirSink(out, columns=out_cols), ckpt,
        max_batch_offsets=max_files, pipeline_depth=2, shape_buckets=64,
        overlap_sink=True, **kw,
    ), source


def _run(q, source):
    try:
        return q.process_available()
    finally:
        q.stop()
        source.close()


def _sink_bytes(out):
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out))}


def _wal(ckpt, side):
    d = os.path.join(ckpt, side)
    return {f: json.load(open(os.path.join(d, f)))
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("wal_mode", ["files", "append"])
def test_pipelined_engine_writes_the_serial_engines_files(
    model_dir, tmp_path, wal_mode
):
    watch = str(tmp_path / "in")
    _write_stream(watch, SIZES)
    outs = {}
    for form in ("serial", "pipelined"):
        out = str(tmp_path / f"out_{form}")
        q, src = _port_query(model_dir, watch, out, str(tmp_path / form),
                             form=form, wal_mode=wal_mode)
        assert _run(q, src) == 5
        assert q.in_flight_count() == 0 and q._delivery is None
        outs[form] = _sink_bytes(out)
        stats = q.pipeline_stats()
        if form == "pipelined":
            assert stats["prefetch"]["hits"] >= 1
            assert stats["delivered_batches"] == 5
            assert q.predictor.fusion_stats()["invocations"] == 5
        assert [p["batchId"] for p in q.recentProgress] == list(range(5))
    assert list(outs["serial"]) == [f"batch_{i:06d}.csv" for i in range(5)]
    assert outs["pipelined"] == outs["serial"]


def test_engine_matches_the_jax_engine(model_dir, tmp_path):
    watch = str(tmp_path / "in")
    _write_stream(watch, SIZES)
    runs = {}
    for pkg, make in (("port", _port_query), ("jax", _jax_query)):
        out, ckpt = str(tmp_path / f"out_{pkg}"), str(tmp_path / f"c_{pkg}")
        assert _run(*make(model_dir, watch, out, ckpt)) == 5
        runs[pkg] = (out, ckpt)
    (pout, pckpt), (jout, jckpt) = runs["port"], runs["jax"]
    for side in ("offsets", "commits"):
        assert _wal(pckpt, side) == _wal(jckpt, side)
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    staged, _, _ = serving_form(load_model(model_dir, device="cpu"))
    files = sorted(os.listdir(os.path.join(watch)))
    for rec in _wal(pckpt, "commits").values():
        name = f"batch_{rec['batch_id']:06d}.csv"
        got = pacsv.read_csv(os.path.join(pout, name))
        ref = pacsv.read_csv(os.path.join(jout, name))
        assert got.num_rows == ref.num_rows
        # the near-tie rule on the port's own probabilities of the rows
        rows = Frame.concat_all([
            load_csv(os.path.join(watch, f))
            for f in files[rec["start"]:rec["end"]]
        ])
        prob = to_host(staged.transform(rows)["probability"])
        top2 = np.sort(prob, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > TIE_TOL
        assert len(prob) == got.num_rows
        for col in OUT_COLS:
            a = np.asarray(got.column(col).to_pylist(), dtype=object)
            b = np.asarray(ref.column(col).to_pylist(), dtype=object)
            np.testing.assert_array_equal(a[clear], b[clear])


@pytest.mark.parametrize("where", ["sink", "segment"])
def test_failure_raises_and_the_next_start_replays(
    model_dir, tmp_path, where, monkeypatch
):
    watch, ckpt = str(tmp_path / "in"), str(tmp_path / "ckpt")
    _write_stream(watch, SIZES)
    ref_out = str(tmp_path / "ref")
    assert _run(*_port_query(model_dir, watch, ref_out,
                             str(tmp_path / "ref_ckpt"))) == 5

    out = str(tmp_path / "out")

    class FlakySink(CsvDirSink):
        def add_batch(self, batch_id, frame):
            if where == "sink" and batch_id == 2:
                raise IOError("sink outage")
            super().add_batch(batch_id, frame)

    calls = []
    original = FusedSegment.transform_async

    def flaky_segment(self, frame):
        calls.append(1)
        if where == "segment" and len(calls) == 3:  # batch 2's dispatch
            raise RuntimeError("device error")
        return original(self, frame)

    monkeypatch.setattr(FusedSegment, "transform_async", flaky_segment)
    q, src = _port_query(model_dir, watch, out, ckpt,
                         sink=FlakySink(out, OUT_COLS))
    with pytest.raises((IOError, RuntimeError), match="outage|device error"):
        _run(q, src)
    monkeypatch.setattr(FusedSegment, "transform_async", original)
    # the failed batch and those behind it stay uncommitted, their
    # intents logged; how many commits landed first depends on timing
    n_done = len(_wal(ckpt, "commits"))
    assert sorted(_wal(ckpt, "commits")) == [f"{i}.json"
                                            for i in range(n_done)]
    assert n_done <= 2
    pending = {k: v for k, v in _wal(ckpt, "offsets").items()
               if v["batch_id"] >= n_done}
    assert "2.json" in pending

    written = []

    class RecordingSink(CsvDirSink):
        def add_batch(self, batch_id, frame):
            written.append(batch_id)
            super().add_batch(batch_id, frame)

    q, src = _port_query(model_dir, watch, out, ckpt,
                         sink=RecordingSink(out, OUT_COLS))
    assert q.last_committed() == n_done - 1
    assert _run(q, src) == 5 - n_done
    assert written == list(range(n_done, 5))  # no batch repeats
    commits = _wal(ckpt, "commits")
    for name, intent in pending.items():
        assert commits[name] == intent  # replayed with its logged range
    assert _sink_bytes(out) == _sink_bytes(ref_out)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_wal_resumes_across_packages(model_dir, tmp_path, writer):
    """Two batches committed and one intent pending, written by one
    package's engine; the other's resumes: the pending batch replays with
    its logged range and no batch repeats."""
    watch, ckpt = str(tmp_path / "in"), str(tmp_path / "ckpt")
    _write_stream(watch, SIZES[:3])
    out = str(tmp_path / "out")
    first, second = ((_jax_query, _port_query) if writer == "jax"
                     else (_port_query, _jax_query))
    sink_type = JCsvDirSink if writer == "jax" else CsvDirSink

    class FlakySink(sink_type):
        def add_batch(self, batch_id, frame):
            if batch_id == 2:
                raise IOError("sink outage")
            super().add_batch(batch_id, frame)

    q, src = first(model_dir, watch, out, ckpt, max_files=1,
                   sink=FlakySink(out, OUT_COLS))
    with pytest.raises(IOError, match="outage"):
        _run(q, src)
    assert sorted(_wal(ckpt, "commits")) == ["0.json", "1.json"]
    assert _wal(ckpt, "offsets")["2.json"] == {"batch_id": 2, "start": 2,
                                              "end": 3}
    _write_stream(watch, SIZES[3:5], first=3)  # two more files arrive

    written = []
    resume_sink = JCsvDirSink if writer == "port" else CsvDirSink

    class RecordingSink(resume_sink):
        def add_batch(self, batch_id, frame):
            written.append(batch_id)
            super().add_batch(batch_id, frame)

    q, src = second(model_dir, watch, out, ckpt, max_files=None,
                    sink=RecordingSink(out, OUT_COLS))
    assert q.last_committed() == 1
    assert _run(q, src) == 2
    assert written == [2, 3]
    commits = _wal(ckpt, "commits")
    assert commits["2.json"] == {"batch_id": 2, "start": 2, "end": 3}
    assert commits["3.json"] == {"batch_id": 3, "start": 3, "end": 5}
    rows = [pacsv.read_csv(os.path.join(out, f"batch_{i:06d}.csv")).num_rows
            for i in range(4)]
    assert sum(rows) <= sum(SIZES[:5])


def test_files_wal_prunes_as_the_jax_engine(model_dir, tmp_path):
    watch = str(tmp_path / "in")
    _write_stream(watch, SIZES)
    listings = {}
    for pkg, make in (("port", _port_query), ("jax", _jax_query)):
        ckpt = str(tmp_path / f"c_{pkg}")
        q, src = make(model_dir, watch, str(tmp_path / f"o_{pkg}"), ckpt,
                      max_files=1, wal_keep_commits=4)
        assert _run(q, src) == len(SIZES)
        listings[pkg] = {side: sorted(os.listdir(os.path.join(ckpt, side)))
                         for side in ("offsets", "commits")}
    assert listings["port"] == listings["jax"]
    assert listings["port"]["commits"] == [f"{i}.json" for i in range(5, 9)]


def test_append_wal_rejects_a_files_mode_dir(model_dir, tmp_path):
    watch, ckpt = str(tmp_path / "in"), str(tmp_path / "ckpt")
    _write_stream(watch, SIZES[:2])
    assert _run(*_port_query(model_dir, watch, str(tmp_path / "o"),
                             ckpt)) == 1
    with pytest.raises(ValueError, match="files"):
        _port_query(model_dir, watch, str(tmp_path / "o"), ckpt,
                    wal_mode="append")


def test_append_wal_compacts_and_resumes(model_dir, tmp_path):
    """``wal_compact_every=2``: the logs are sealed into
    ``wal_checkpoint.json`` and truncated; a restart resumes from the
    checkpoint plus the tails, and the JAX engine reads the same state."""
    watch, ckpt = str(tmp_path / "in"), str(tmp_path / "ckpt")
    _write_stream(watch, SIZES[:5])
    out = str(tmp_path / "out")
    q, src = _port_query(model_dir, watch, out, ckpt, max_files=1,
                         wal_mode="append", wal_compact_every=2)
    assert _run(q, src) == 5
    assert q.wal_compactions == 2
    assert len(open(os.path.join(ckpt, "commits.log")).readlines()) == 1
    _write_stream(watch, SIZES[5:7], first=5)
    jq, jsrc = _jax_query(model_dir, watch, out, ckpt, max_files=1,
                          wal_mode="append")
    assert jq.last_committed() == 4 and jq.committed_end() == 5
    jq.stop()
    jsrc.close()
    q, src = _port_query(model_dir, watch, out, ckpt, max_files=1,
                         wal_mode="append", wal_compact_every=2)
    assert q.last_committed() == 4 and q.committed_end() == 5
    assert _run(q, src) == 2


def _parsed_serve(parse):
    return parse(["serve", "--model", "m", "--watch", "w", "--out", "o",
                  "--checkpoint", "c"])


def test_serve_parser_defaults_are_the_jax_commands(monkeypatch):
    class Parsed(Exception):
        pass

    def capture(self, argv=None, namespace=None):
        raise Parsed(original(self, argv, namespace))

    import argparse

    original = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as caught:
        _parsed_serve(jax_app.main)
    jax_args = caught.value.args[0]
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", original)
    args = _parsed_serve(build_parser().parse_args)
    for flag in ("pipeline_depth", "prefetch_batches", "read_workers",
                 "fuse", "wal_mode", "wal_compact_every",
                 "wal_keep_commits", "shape_buckets", "max_files_per_batch",
                 "label_index_col", "poll_interval", "once",
                 "batch_retry_attempts", "max_batch_failures",
                 "dead_letter_keep", "device_faults", "health_json",
                 "max_batch_wall_time"):
        assert getattr(args, flag) == getattr(jax_args, flag), flag
    assert (args.pipeline_depth, args.prefetch_batches, args.read_workers,
            args.fuse, args.wal_mode) == (2, 2, 4, True, "files")
    assert (args.batch_retry_attempts, args.max_batch_failures,
            args.dead_letter_keep, args.device_faults) == (2, 3, 200, True)


def test_predictor_dispatches_every_chunk_on_the_calling_thread(model_dir):
    """An oversized frame dispatches its chunks through a window of
    ``CHUNK_WINDOW`` (2): two at dispatch, each later one from finalize
    once the chunk two before it is copied back, all on the thread that
    calls ``predict_frame_async`` and its finalize."""
    served, _, _ = serving_form(load_model(model_dir, device="cpu"),
                                "label", True)
    rows = jax_generate_frame(530, seed=15, dirty=False).drop("Label")
    frame = Frame({c: np.asarray(rows[c]) for c in rows.columns})
    chunked = BatchPredictor(served, chunk_rows=100, bucket_rows=64,
                             device="cpu")
    (seg,) = [s for s in served.getStages() if isinstance(s, FusedSegment)]
    in_flight, peak = [0], [0]
    original = chunked._dispatch_one

    def tracked(chunk, *mask):
        fin = original(chunk, *mask)
        in_flight[0] += 1
        peak[0] = max(peak[0], in_flight[0])

        def done():
            out = fin()
            in_flight[0] -= 1
            return out

        return done

    chunked._dispatch_one = tracked
    fin = chunked.predict_frame_async(frame)
    assert (seg.invocations, seg.downloads) == (2, 0)
    out = fin()
    assert (seg.invocations, seg.downloads) == (6, 6)
    assert peak[0] == BatchPredictor.CHUNK_WINDOW == 2
    assert in_flight[0] == 0 and out.num_rows == 530
    whole = BatchPredictor(served, bucket_rows=64, device="cpu")
    np.testing.assert_array_equal(to_host(out["prediction"]),
                                  to_host(whole.predict_frame(frame)
                                          ["prediction"]))


def test_oversized_batch_retires_on_the_engine_thread(model_dir, tmp_path):
    """The pipelined engine hands a batch larger than ``chunk_rows`` to
    no delivery thread: its finalize dispatches chunks, and every
    dispatch is made on the engine thread with at most two chunks of a
    batch in flight.  Its files equal the serial engine's."""
    import threading

    watch = str(tmp_path / "in")
    _write_stream(watch, SIZES)
    ref_out = str(tmp_path / "ref")
    assert _run(*_port_query(model_dir, watch, ref_out,
                             str(tmp_path / "ref_ckpt"), form="staged")) == 5
    out = str(tmp_path / "out")
    q, src = _port_query(model_dir, watch, out, str(tmp_path / "ckpt"))
    q.predictor.chunk_rows = 64  # batches of 87-251 rows: 2-4 chunks
    threads, in_flight, peak = set(), [0], [0]
    original = q.predictor._dispatch_one

    def tracked(chunk, *mask):
        threads.add(threading.get_ident())
        fin = original(chunk, *mask)
        in_flight[0] += 1
        peak[0] = max(peak[0], in_flight[0])

        def done():
            result = fin()
            in_flight[0] -= 1
            return result

        return done

    q.predictor._dispatch_one = tracked
    assert _run(q, src) == 5
    assert threads == {threading.get_ident()}
    # depth 2: the window of the batch retiring and the next batch's
    # first two chunks
    assert peak[0] <= q.pipeline_depth * BatchPredictor.CHUNK_WINDOW
    assert q.pipeline_stats()["delivered_batches"] == 5
    assert _sink_bytes(out) == _sink_bytes(ref_out)


def test_transfer_ledger_counts_every_copy_across_threads():
    """The engine thread records uploads while the delivery thread
    records downloads into the same ledgers: no count may be lost."""
    import sys
    import threading

    from sntc_tpu_torch.utils.profiling import (
        TransferLedger,
        ledger_scope,
        record_movement,
    )

    ledger = TransferLedger()
    n_threads, n_calls = 16, 2000

    def work():
        with ledger_scope(ledger):
            for _ in range(n_calls):
                record_movement(uploads=1, upload_bytes=3, downloads=2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    snap = ledger.snapshot()
    total = n_threads * n_calls
    assert (snap["uploads"], snap["upload_bytes"], snap["downloads"]) == (
        total, 3 * total, 2 * total)
