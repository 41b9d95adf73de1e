"""The port's serving failure handling against the JAX package's, on the
CPU: the engine's retries, poison-batch quarantine and breakers, the
predictor's OOM split, the device fault domain in the engine, and the
``serve`` command at its defaults.

Engine parity: both engines serve the same frames (``MemorySource``)
under the same armed schedule, in the serial form (depth 1) and the
pipelined one (depth 2, the overlapped sink).  They must commit the same
batch ids, deliver bitwise the same frames to the sink, quarantine the
same batches, write dead-letter records equal apart from ``ts`` and
``error`` (the error text names each package's own classes) and
byte-identical dead-letter CSVs, and emit the same multiset of
resilience events.  The scenarios are the counterparts of
``tests/test_resilience.py`` (:213, :223, :232, :275, :321, :351, :380,
:423) and ``tests/test_supervision.py`` (:153, :193).

Device faults: an injected ``device_oom`` splits a batch, and the split
output is bitwise the unsplit one with the JAX predictor's split count
and bucket-floor step (``tests/test_device.py`` :158, :180); a served
stream under ``device.dispatch:device_oom:0.3:7`` writes batch files
byte-identical to a clean run's and to the JAX engine's under the same
schedule.  The port's documented difference from ``tests/test_device.
py:468``: no host fallback, so a transient ``device_lost`` (``times=2``
under ``degrade_after`` 3) commits every batch on the device, and a
persistent one stops the query after 3 rounds with the batch's intent
in the WAL, which a restart commits.  A device error at finalize, on
the delivery thread, is re-dispatched from the engine thread.

The command: ``serve`` at its defaults (``--device cpu``; the JAX
command with ``--platform cpu``) over a directory holding one ragged
CSV, each in its supervised loop, SIGTERMed once every batch committed:
exit 0, ``drained`` true, ``drain_marker.json``, the same batch
quarantined and batch files byte-identical between the packages (a
one-tree forest: no summation order to differ).
"""

import collections
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import sntc_tpu.resilience as J
import sntc_tpu_torch.resilience as R
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.base import Transformer as JTransformer
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import CICIDS2017_FEATURES, clean_flows
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import ChiSqSelector as JChiSqSelector
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import RandomForestClassifier as JRandomForest
from sntc_tpu.serve import BatchPredictor as JBatchPredictor
from sntc_tpu.serve import MemorySink as JMemorySink
from sntc_tpu.serve import MemorySource as JMemorySource
from sntc_tpu.serve import StreamingQuery as JStreamingQuery
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data import write_raw_csv
from sntc_tpu_torch.serve import (
    BatchPredictor,
    MemorySink,
    MemorySource,
    StreamingQuery,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DELAY = dict(base_delay_s=0.0, jitter=0.0)
RESILIENCE_EVENTS = {
    "retry", "retry_success", "retry_exhausted", "quarantine",
    "breaker_open", "breaker_half_open", "breaker_closed", "fault_injected",
}


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("SNTC_FAULTS", raising=False)
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    for pkg in (J, R):
        pkg.clear()
        pkg.clear_events()
        pkg.reset_breakers()
    yield
    for pkg in (J, R):
        pkg.clear()
        pkg.clear_events()
        pkg.reset_breakers()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# one scenario, written once, run on either package
# ---------------------------------------------------------------------------


class _PortIdentity(Transformer):
    def transform(self, frame):
        return frame


class _JaxIdentity(JTransformer):
    def transform(self, frame):
        return frame


class Pkg:
    """What a scenario needs of one package."""

    def __init__(self, name):
        self.name = name
        self.port = name == "port"
        self.R = R if self.port else J
        self.Frame = Frame if self.port else JFrame
        self.Transformer = Transformer if self.port else JTransformer
        self.MemorySource = MemorySource if self.port else JMemorySource
        self.MemorySink = MemorySink if self.port else JMemorySink

    def identity(self):
        return _PortIdentity() if self.port else _JaxIdentity()

    def frames(self, n, rows=8):
        return [self.Frame({"x": np.arange(rows, dtype=np.float64)
                            + 100 * b}) for b in range(n)]

    def query(self, model, src, sink, ckpt, form, **kw):
        if self.port:
            return StreamingQuery(model, src, sink, ckpt,
                                  max_batch_offsets=1, device="cpu",
                                  pipeline_depth=2 if form == "pipelined"
                                  else 1, **kw)
        return JStreamingQuery(model, src, sink, ckpt, max_batch_offsets=1,
                               pipeline_depth=2 if form == "pipelined"
                               else 1, overlap_sink=form == "pipelined",
                               **kw)


def _outcome(q, sink, ckpt, returns):
    dl = os.path.join(ckpt, "dead_letter")
    records, rows_files = [], {}
    if os.path.isdir(dl):
        path = os.path.join(dl, "dead_letter.jsonl")
        if os.path.exists(path):
            for line in open(path):
                rec = json.loads(line)
                assert set(rec) >= {"ts", "error"}
                records.append({k: v for k, v in rec.items()
                                if k not in ("ts", "error")})
        for name in sorted(os.listdir(dl)):
            if name.endswith(".csv"):
                rows_files[name] = open(os.path.join(dl, name), "rb").read()
    events = collections.Counter(
        (e["event"], e.get("site")) for e in q_events()
        if e["event"] in RESILIENCE_EVENTS
    )
    return {
        "returns": returns,
        "last": q.last_committed(),
        "sink": [(bid, np.asarray(f["x"]).tobytes())
                 for bid, f in sink.batches],
        "quarantined": [p["batchId"] for p in q.recentProgress
                        if p.get("quarantined")],
        "progress": [(p["batchId"], p["numInputRows"])
                     for p in q.recentProgress],
        "dead_letter": records,
        "rows_files": rows_files,
        "events": events,
    }


_current_pkg = []


def q_events():
    return _current_pkg[0].R.recent_events()


def sc_sink_retry(pkg, ckpt, form):
    pkg.R.arm("sink.write", after=1, times=2)  # batch 1 fails twice
    sink = pkg.MemorySink()
    q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(3)), sink,
                  ckpt, form,
                  retry_policy=pkg.R.RetryPolicy(max_attempts=3, **NO_DELAY))
    return q, sink, [q.process_available()]


def sc_read_retry(pkg, ckpt, form):
    pkg.R.arm("stream.read", times=1)
    sink = pkg.MemorySink()
    q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(2)), sink,
                  ckpt, form,
                  retry_policy=pkg.R.RetryPolicy(max_attempts=2, **NO_DELAY))
    return q, sink, [q.process_available()]


def _poison_sink(pkg, bad, exc=ValueError("poison batch")):
    class PoisonSink(pkg.MemorySink):
        def add_batch(self, batch_id, frame):
            if batch_id in bad:
                raise exc
            super().add_batch(batch_id, frame)

    return PoisonSink()


def sc_sink_poison(pkg, ckpt, form):
    sink = _poison_sink(pkg, {1})
    q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(4)), sink,
                  ckpt, form, max_batch_failures=1,
                  retry_policy=pkg.R.RetryPolicy(max_attempts=2, **NO_DELAY))
    returns = [q.process_available()]
    # a restarted query does not replay the quarantined batch
    q2 = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(4)),
                   pkg.MemorySink(), ckpt, form, max_batch_failures=1)
    returns.append(q2.process_available())
    q2.stop()
    return q, sink, returns


def sc_threshold_rounds(pkg, ckpt, form):
    sink = _poison_sink(pkg, {0}, IOError("down"))
    q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(2)), sink,
                  ckpt, form, max_batch_failures=2)
    return q, sink, [q.process_available() for _ in range(3)]


def sc_read_poison(pkg, ckpt, form):
    class PoisonSource(pkg.MemorySource):
        def get_batch(self, start, end):
            if start == 1:
                raise IOError("torn input file")
            return super().get_batch(start, end)

    sink = pkg.MemorySink()
    q = pkg.query(pkg.identity(), PoisonSource(pkg.frames(3)), sink, ckpt,
                  form, max_batch_failures=1,
                  retry_policy=pkg.R.RetryPolicy(max_attempts=2, **NO_DELAY))
    return q, sink, [q.process_available() for _ in range(2)]


def sc_predict_poison(pkg, ckpt, form):
    class PickyModel(pkg.Transformer):
        def transform(self, frame):
            if 100.0 <= float(np.asarray(frame["x"])[0]) < 200.0:
                raise ValueError("malformed features")
            return frame

    sink = pkg.MemorySink()
    q = pkg.query(PickyModel(), pkg.MemorySource(pkg.frames(3)), sink,
                  ckpt, form, max_batch_failures=1)
    return q, sink, [q.process_available() for _ in range(2)]


def sc_stages_separate(pkg, ckpt, form):
    class FlakyBoth(pkg.MemorySource):
        read_fails = 1

        def get_batch(self, start, end):
            if start == 0 and self.read_fails:
                self.read_fails -= 1
                raise IOError("read flake")
            return super().get_batch(start, end)

    class FlakySink(pkg.MemorySink):
        sink_fails = 1

        def add_batch(self, batch_id, frame):
            if batch_id == 0 and self.sink_fails:
                self.sink_fails -= 1
                raise IOError("sink flake")
            super().add_batch(batch_id, frame)

    sink = FlakySink()
    q = pkg.query(pkg.identity(), FlakyBoth(pkg.frames(1)), sink, ckpt,
                  form, max_batch_failures=2)
    return q, sink, [q.process_available() for _ in range(3)]


def sc_wal_poison(pkg, ckpt, form):
    pkg.R.arm("stream.wal", after=1, times=3)  # batch 1's intent
    sink = pkg.MemorySink()
    q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(3)), sink,
                  ckpt, form, max_batch_failures=3)
    return q, sink, [q.process_available() for _ in range(4)]


def sc_commit_flake(pkg, ckpt, form):
    pkg.R.arm("stream.commit", after=1, times=1)
    sink = pkg.MemorySink()
    q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(3)), sink,
                  ckpt, form, max_batch_failures=2)
    return q, sink, [q.process_available() for _ in range(3)]


def sc_single_shot(pkg, ckpt, form):
    pkg.R.arm("sink.write", times=1)
    sink = pkg.MemorySink()
    q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(2)), sink,
                  ckpt, form)
    with pytest.raises(pkg.R.InjectedFault):
        q.process_available()
    return q, sink, [q.process_available()]


def sc_env_schedule(pkg, ckpt, form):
    os.environ["SNTC_FAULTS"] = ("sink.write:io:0.3:7,"
                                 "stream.read:exc:0.2:3")
    try:
        sink = pkg.MemorySink()
        q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(12)),
                      sink, ckpt, form, max_batch_failures=3,
                      retry_policy=pkg.R.RetryPolicy(max_attempts=2,
                                                     **NO_DELAY))
        returns = []
        while q.last_committed() < 11 and len(returns) < 40:
            returns.append(q.process_available())
    finally:
        del os.environ["SNTC_FAULTS"]
    return q, sink, returns


def sc_sink_breaker(pkg, ckpt, form):
    class DownSink(pkg.MemorySink):
        down = True

        def add_batch(self, batch_id, frame):
            if self.down:
                raise IOError("sink down")
            super().add_batch(batch_id, frame)

    clk = FakeClock()
    br = pkg.R.CircuitBreaker("sink.write", window=4, failure_threshold=1.0,
                              min_calls=2, cooldown_s=60.0, clock=clk)
    sink = DownSink()
    q = pkg.query(pkg.identity(), pkg.MemorySource(pkg.frames(3)), sink,
                  ckpt, form, max_batch_failures=100,
                  breakers={"sink.write": br})
    returns = [q.process_available() for _ in range(3)]
    returns.append(br.state)
    sink.down = False
    clk.t = 60.0
    returns.append(q.process_available())
    returns.append(br.state)
    return q, sink, returns


def sc_predict_breaker(pkg, ckpt, form):
    class BoomModel(pkg.Transformer):
        down = True

        def transform(self, frame):
            if self.down:
                raise RuntimeError("model down")
            return frame

    class CountingSource(pkg.MemorySource):
        reads = 0

        def get_batch(self, start, end):
            self.reads += 1
            return super().get_batch(start, end)

    clk = FakeClock()
    br = pkg.R.CircuitBreaker("predict.dispatch", window=4,
                              failure_threshold=1.0, min_calls=2,
                              cooldown_s=60.0, clock=clk)
    model, src, sink = BoomModel(), CountingSource(pkg.frames(2)), \
        pkg.MemorySink()
    q = pkg.query(model, src, sink, ckpt, form, max_batch_failures=100,
                  breakers={"predict.dispatch": br})
    returns = [q.process_available(), q.process_available(), br.state]
    model.down = False
    reads = src.reads
    returns += [q.process_available(), src.reads - reads]
    clk.t = 60.0
    returns += [q.process_available(), br.state]
    return q, sink, returns


SCENARIOS = {
    "sink_retry": sc_sink_retry,
    "read_retry": sc_read_retry,
    "sink_poison": sc_sink_poison,
    "threshold_rounds": sc_threshold_rounds,
    "read_poison": sc_read_poison,
    "predict_poison": sc_predict_poison,
    "stages_separate": sc_stages_separate,
    "wal_poison": sc_wal_poison,
    "commit_flake": sc_commit_flake,
    "single_shot": sc_single_shot,
    "env_schedule": sc_env_schedule,
    "sink_breaker": sc_sink_breaker,
    "predict_breaker": sc_predict_breaker,
}


def _run_scenario(name, pkg_name, tmp_path, form):
    pkg = Pkg(pkg_name)
    _current_pkg[:] = [pkg]
    ckpt = str(tmp_path / f"{pkg_name}_ckpt")
    q, sink, returns = SCENARIOS[name](pkg, ckpt, form)
    try:
        return _outcome(q, sink, ckpt, returns)
    finally:
        q.stop()


@pytest.mark.parametrize("form", ["serial", "pipelined"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_failure_handling_matches_jax(tmp_path, name, form):
    jax = _run_scenario(name, "jax", tmp_path, form)
    port = _run_scenario(name, "port", tmp_path, form)
    assert port == jax
    assert port["last"] >= 0


def test_quarantine_records_and_metrics(tmp_path):
    from sntc_tpu_torch.obs import metrics

    reg = metrics.reset_registry()
    out = _run_scenario("sink_poison", "port", tmp_path, "serial")
    assert out["quarantined"] == [1]
    assert out["sink"][0][0] == 0 and [b for b, _ in out["sink"]] == [0, 2, 3]
    rec = out["dead_letter"][0]
    assert rec["batch_id"] == 1 and rec["rows_file"] == "batch_000001.csv"
    assert rec["intent"] == {"batch_id": 1, "start": 1, "end": 2}
    assert rec["num_rows"] == 8 and rec["failures"] == 1
    assert reg.get("sntc_batches_committed_total") == 4.0
    # a batch quarantined at its sink commits its rows, as in the JAX engine
    assert reg.get("sntc_rows_committed_total") == 32.0
    assert reg.get("sntc_batches_quarantined_total") == 1.0
    assert reg.get("sntc_events_total", event="quarantine",
                   site="sink.write") == 1.0


def test_dead_letter_keep_prunes_oldest(tmp_path):
    sink = _poison_sink(Pkg("port"), {0, 1, 2, 3})
    q = StreamingQuery(_PortIdentity(),
                       MemorySource(Pkg("port").frames(5)), sink,
                       str(tmp_path / "ckpt"), max_batch_offsets=1,
                       device="cpu", pipeline_depth=1,
                       max_batch_failures=1, dead_letter_keep=2)
    assert q.process_available() == 5
    dl = tmp_path / "ckpt" / "dead_letter"
    assert sorted(os.listdir(dl)) == [
        "batch_000002.csv", "batch_000003.csv", "dead_letter.jsonl"]
    assert len(open(dl / "dead_letter.jsonl").readlines()) == 4
    assert q.quarantined_batches == [0, 1, 2, 3]
    q.stop()


# ---------------------------------------------------------------------------
# the predictor's OOM split
# ---------------------------------------------------------------------------


def _jdomain(**kw):
    return J.DeviceFaultDomain(J.DevicePolicy(probe_interval_s=0.0, **kw),
                               probe_fn=lambda: True, probe_async=False)


def _pframe(n=16):
    return Frame({"a": np.arange(float(n)), "b": np.arange(float(n)) * 2})


def _jframe(n=16):
    return JFrame({"a": np.arange(float(n)), "b": np.arange(float(n)) * 2})


def test_oom_split_bitwise_and_floor_step_as_jax():
    ref = BatchPredictor(_PortIdentity(), bucket_rows=4,
                         device="cpu").predict_frame(_pframe())
    dom = R.DeviceFaultDomain()
    p = BatchPredictor(_PortIdentity(), bucket_rows=4, device="cpu",
                       device_domain=dom)
    R.arm("device.dispatch", "device_oom", times=1)
    out = p.predict_frame(_pframe())
    for c in ref.columns:  # bitwise: the split output is the unsplit one
        np.testing.assert_array_equal(np.asarray(out[c]), np.asarray(ref[c]))
    jdom = _jdomain()
    jp = JBatchPredictor(_JaxIdentity(), bucket_rows=4, device_domain=jdom)
    J.arm("device.dispatch", "device_oom", times=1)
    jp.predict_frame(_jframe())
    s, js = dom.stats(), jdom.stats()
    assert s["oom_splits"] == js["oom_splits"] == 1
    assert s["bucket_floor_steps"] == js["bucket_floor_steps"] == 1
    assert p.bucket_rows == jp.bucket_rows == 2
    assert s["state"] == "DEVICE_OK"
    assert [{k: d[k] for k in d if k != "ts"} for d in dom.journal] == [
        {k: d[k] for k in d if k != "ts"} for d in jdom.journal]
    ev = R.recent_events(event="device_oom_split")
    assert ev and ev[0]["rows"] == 16 and "CUDA out of memory" in ev[0][
        "error"]


def test_persistent_oom_splits_as_jax_then_stops():
    """The JAX predictor ends a persistent OOM on its host fallback; the
    port has none: after the same splits it raises DeviceExecError."""
    dom = R.DeviceFaultDomain(R.DevicePolicy(degrade_after=1))
    p = BatchPredictor(_PortIdentity(), bucket_rows=4, device="cpu",
                       device_domain=dom)
    R.arm("device.dispatch", "device_oom", times=None)
    with pytest.raises(R.DeviceExecError) as ei:
        p.predict_frame(_pframe())
    assert R.classify_device_error(ei.value) == "device_lost"
    jdom = _jdomain(degrade_after=1)
    jp = JBatchPredictor(_JaxIdentity(), bucket_rows=4, device_domain=jdom)
    J.arm("device.dispatch", "device_oom", times=None)
    jp.predict_frame(_jframe())
    assert dom.stats()["oom_splits"] == jdom.stats()["oom_splits"] == 3
    assert p.bucket_rows == jp.bucket_rows == 2
    assert dom.failed and dom.stats()["faults"] == {"device_oom": 1}
    with pytest.raises(R.DeviceExecError):  # every later dispatch
        p.predict_frame(_pframe(8))


def test_floor_restored_after_clean_dispatches():
    dom = R.DeviceFaultDomain(R.DevicePolicy(floor_restore_after=3))
    p = BatchPredictor(_PortIdentity(), bucket_rows=8, device="cpu",
                       device_domain=dom)
    R.arm("device.dispatch", "device_oom", times=1)
    p.predict_frame(_pframe(32))
    assert p.bucket_rows == 4
    for _ in range(3):
        p.predict_frame(_pframe(5))
    assert p.bucket_rows == 8
    assert [d["decision"] for d in dom.journal] == [
        "device_oom_split", "bucket_floor_down", "bucket_floor_restored"]


def test_predict_compile_site_fires_on_fresh_shapes_only():
    dom = R.DeviceFaultDomain()
    p = BatchPredictor(_PortIdentity(), bucket_rows=4, device="cpu",
                       device_domain=dom)
    R.arm("predict.compile", "compile_error", times=None, prob=0.0)
    for n in (16, 16, 5, 16, 7):
        p.predict_frame(_pframe(n))
    # fresh padded shapes: 16 and 8 (5 and 7 pad to 8)
    assert R.call_count("predict.compile") == 2
    R.arm("predict.compile", "compile_error", times=1)
    with pytest.raises(R.InjectedDeviceFault):
        p.predict_frame(_pframe(40))
    assert dom.stats()["faults"] == {"compile_error": 1}


# ---------------------------------------------------------------------------
# device faults in the engine (config-3's fused forest, one tree)
# ---------------------------------------------------------------------------


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
        JRandomForest(numTrees=1, maxDepth=4, seed=0),
    ]).fit(train)
    path = str(tmp_path_factory.mktemp("faults_model") / "model")
    jax_save_model(pm, path)
    return path


SIZES = [37, 120, 64, 90, 200, 51, 128, 75]


@pytest.fixture(scope="module")
def flow_frames():
    rows = clean_flows(jax_generate_frame(sum(SIZES), seed=21)).drop(
        "Label")
    cols = {c: np.asarray(rows[c]) for c in rows.columns}
    out, start = [], 0
    for n in SIZES:
        out.append({c: a[start:start + n] for c, a in cols.items()})
        start += n
    return out


def _port_stream(model_dir, frames, ckpt, form="pipelined", **kw):
    from sntc_tpu_torch.app import serving_form
    from sntc_tpu_torch.mlio import load_model

    model, _, _ = serving_form(load_model(model_dir, device="cpu"),
                               "label", True)
    pred = BatchPredictor(model, bucket_rows=64, device="cpu",
                          device_domain=kw.pop("domain", None))
    sink = MemorySink()
    q = StreamingQuery(pred, MemorySource([Frame(f) for f in frames]), sink,
                       ckpt, max_batch_offsets=1, device="cpu",
                       pipeline_depth=2 if form == "pipelined" else 1, **kw)
    return q, sink


def _jax_stream(model_dir, frames, ckpt, domain):
    from sntc_tpu.app import _serving_form
    from sntc_tpu.mlio import load_model as jax_load_model

    model, _, _ = _serving_form(jax_load_model(model_dir), "label", True)
    pred = JBatchPredictor(model, bucket_rows=64, device_domain=domain)
    sink = JMemorySink()
    q = JStreamingQuery(pred, JMemorySource([JFrame(f) for f in frames]),
                        sink, ckpt, max_batch_offsets=1, pipeline_depth=2,
                        overlap_sink=True)
    return q, sink


def _batch_bytes(sink):
    """Each committed batch as CSV bytes of its served columns."""
    import pyarrow as pa
    import pyarrow.csv as pacsv

    out = {}
    for bid, f in sink.batches:
        buf = pa.BufferOutputStream()
        cols = ["prediction", "predictedLabel"]
        pacsv.write_csv(pa.table({c: np.asarray(f[c]) if c == "prediction"
                                  else list(np.asarray(f[c]))
                                  for c in cols}), buf)
        out[bid] = buf.getvalue().to_pybytes()
    return out


def _drive(q, limit=30):
    done = 0
    for _ in range(limit):
        done += q.process_available()
        if q.last_committed() == len(SIZES) - 1:
            break
    return done


def test_injected_oom_schedule_matches_clean_run_and_jax(
        tmp_path, model_dir, flow_frames, monkeypatch):
    clean_q, clean_sink = _port_stream(model_dir, flow_frames,
                                       str(tmp_path / "clean"))
    _drive(clean_q)
    clean_q.stop()
    monkeypatch.setenv("SNTC_FAULTS", "device.dispatch:device_oom:0.3:7")
    dom = R.DeviceFaultDomain()
    q, sink = _port_stream(model_dir, flow_frames, str(tmp_path / "oom"),
                           domain=dom, max_batch_failures=3)
    assert _drive(q) == len(SIZES)
    q.stop()
    jdom = _jdomain()
    jq, jsink = _jax_stream(model_dir, flow_frames, str(tmp_path / "j"),
                            jdom)
    _drive(jq)
    jq.stop()
    port_bytes = _batch_bytes(sink)
    assert port_bytes == _batch_bytes(clean_sink)  # bitwise
    assert port_bytes == _batch_bytes(jsink)
    assert dom.stats()["oom_splits"] == jdom.stats()["oom_splits"] > 0
    assert dom.stats()["faults"] == jdom.stats()["faults"]
    assert jdom.stats()["state"] == "DEVICE_OK"
    assert not R.recent_events(event="quarantine")


@pytest.mark.parametrize("form", ["serial", "pipelined"])
def test_transient_device_lost_commits_every_batch(
        tmp_path, model_dir, flow_frames, form):
    clean_q, clean_sink = _port_stream(model_dir, flow_frames,
                                       str(tmp_path / "clean"), form)
    _drive(clean_q)
    clean_q.stop()
    dom = R.DeviceFaultDomain()
    q, sink = _port_stream(model_dir, flow_frames, str(tmp_path / "ckpt"),
                           form, domain=dom, max_batch_failures=3,
                           breakers=R.default_breakers())
    R.arm("device.dispatch", "device_lost", times=2)
    assert _drive(q) == len(SIZES)
    q.stop()
    assert _batch_bytes(sink) == _batch_bytes(clean_sink)
    names = [e["event"] for e in R.recent_events()]
    for absent in ("quarantine", "breaker_open", "retry_exhausted",
                   "device_failed"):
        assert absent not in names
    assert dom.stats()["faults"] == {"device_lost": 2}
    assert dom.stats()["consecutive_faults"] == 0 and not dom.failed


@pytest.mark.parametrize("form", ["serial", "pipelined"])
def test_persistent_device_lost_stops_then_restart_commits(
        tmp_path, model_dir, flow_frames, form):
    ckpt = str(tmp_path / "ckpt")
    dom = R.DeviceFaultDomain()
    q, sink = _port_stream(model_dir, flow_frames, ckpt, form, domain=dom,
                           max_batch_failures=3)
    R.arm("device.dispatch", "device_lost", after=2, times=None)
    returns = []
    with pytest.raises(R.DeviceExecError) as ei:
        for _ in range(10):
            returns.append(q.process_available())
    q.stop()
    # 3 faults with no clean batch between them; in the pipelined form a
    # batch in flight may come back clean between earlier faults
    stats = dom.stats()
    assert dom.failed and stats["consecutive_faults"] == 3
    assert set(stats["faults"]) == {"device_lost"}
    if form == "serial":
        assert stats["faults"]["device_lost"] == 3
    assert R.classify_device_error(ei.value) == "device_lost"
    committed = q.last_committed()
    assert committed < len(SIZES) - 1
    # the stopped batch's intent is in the WAL, its commit is not
    first_open = committed + 1
    assert os.path.exists(os.path.join(ckpt, "offsets",
                                       f"{first_open}.json"))
    assert not os.path.exists(os.path.join(ckpt, "commits",
                                           f"{first_open}.json"))
    assert not os.path.isdir(os.path.join(ckpt, "dead_letter"))
    R.clear()
    q2, sink2 = _port_stream(model_dir, flow_frames, ckpt, form,
                             domain=R.DeviceFaultDomain(),
                             max_batch_failures=3)
    _drive(q2)
    q2.stop()
    assert q2.last_committed() == len(SIZES) - 1
    clean_q, clean_sink = _port_stream(model_dir, flow_frames,
                                       str(tmp_path / "clean"), form)
    _drive(clean_q)
    clean_q.stop()
    both = dict(_batch_bytes(sink))
    both.update(_batch_bytes(sink2))
    assert both == _batch_bytes(clean_sink)


def test_finalize_device_error_redispatches_on_the_engine_thread(tmp_path):
    """A device error at finalize surfaces on the delivery thread; the
    batch is re-dispatched from the engine thread and commits, with no
    quarantine and no breaker scored."""
    engine = threading.current_thread()
    launches = []
    armed = {"n": 1}

    class Late(Transformer):
        def transform(self, frame):
            return frame

        def transform_async(self, frame):
            launches.append(threading.current_thread())

            def fin():
                if armed["n"] and threading.current_thread() is not engine:
                    armed["n"] -= 1
                    raise RuntimeError("CUDA error: an illegal memory "
                                       "access was encountered")
                return frame

            return fin

    dom = R.DeviceFaultDomain()
    br = R.default_breakers()
    sink = MemorySink()
    q = StreamingQuery(BatchPredictor(Late(), device="cpu",
                                      device_domain=dom),
                       MemorySource(Pkg("port").frames(3)), sink,
                       str(tmp_path / "ckpt"), max_batch_offsets=1,
                       device="cpu", pipeline_depth=2, max_batch_failures=3,
                       breakers=br)
    assert _drive_n(q, 3) == 3
    q.stop()
    assert [b for b, _ in sink.batches] == [0, 1, 2]
    assert armed["n"] == 0 and len(launches) == 4  # one re-dispatch
    assert all(t is engine for t in launches)
    faults = R.recent_events(event="device_fault")
    assert len(faults) == 1 and faults[0]["batch_id"] == 0
    assert not R.recent_events(event="quarantine")
    assert br["sink.write"].snapshot()["window_calls"] == 3
    assert br["sink.write"].snapshot()["failure_rate"] == 0.0


def _drive_n(q, n, limit=20):
    done = 0
    for _ in range(limit):
        done += q.process_available()
        if done >= n:
            break
    return done


def test_supervised_loop_stops_on_a_failed_device(tmp_path):
    """Through the supervisor: three faulted rounds, then the query stops
    with the model UNHEALTHY and the batch's intent in the WAL."""
    R.arm("device.dispatch", "device_lost", times=None)
    q = StreamingQuery(BatchPredictor(_PortIdentity(), device="cpu",
                                      device_domain=R.DeviceFaultDomain()),
                       MemorySource(Pkg("port").frames(2)), MemorySink(),
                       str(tmp_path / "ckpt"), max_batch_offsets=1,
                       device="cpu", max_batch_failures=3)
    sup = R.QuerySupervisor(q, health_json=str(tmp_path / "h.json"))
    try:
        assert sup.tick() == 0 and sup.tick() == 0
        with pytest.raises(R.DeviceExecError):
            sup.tick()
        assert sup.health.state_of("model") == R.HealthState.UNHEALTHY
        assert sup.status()["device"]["state"] == "DEVICE_FAILED"
    finally:
        sup.close()
        q.stop()
    assert os.path.exists(tmp_path / "ckpt" / "offsets" / "0.json")
    assert not os.path.exists(tmp_path / "ckpt" / "commits" / "0.json")


# ---------------------------------------------------------------------------
# the serve command at its defaults
# ---------------------------------------------------------------------------


def _write_watch(watch, corrupt_at):
    os.makedirs(watch)
    rows = jax_generate_frame(400, seed=33).drop("Label")
    frame = Frame({c: np.asarray(rows[c]) for c in rows.columns})
    for i in range(5):
        path = os.path.join(watch, f"part_{i:04d}.csv")
        write_raw_csv(frame.slice(80 * i, 80 * (i + 1)), path)
        if i == corrupt_at:  # a ragged line: one field too many
            with open(path, "a") as f:
                f.write("1," * len(rows.columns) + "1\n")


def _serve_until_committed(cmd, env, ckpt, n_batches, limit=60.0):
    """Start a supervised serve, wait for ``n_batches`` commit records,
    SIGTERM it, return (rc, stdout, stderr)."""
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + limit
        commits = os.path.join(ckpt, "commits")
        while time.time() < deadline and proc.poll() is None:
            if os.path.isdir(commits) and len(
                    [n for n in os.listdir(commits)
                     if n.endswith(".json")]) >= n_batches:
                break
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=max(5.0,
                                                deadline - time.time()))
    except Exception:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, out, err


def test_serve_command_defaults_quarantine_and_drain_as_jax(
        tmp_path, model_dir):
    watch = str(tmp_path / "in")
    _write_watch(watch, corrupt_at=2)
    runs = {}
    for pkg in ("jax", "port"):
        out, ckpt = str(tmp_path / f"out_{pkg}"), str(tmp_path / f"ck_{pkg}")
        health = str(tmp_path / f"health_{pkg}.json")
        module = "sntc_tpu" if pkg == "jax" else "sntc_tpu_torch"
        cmd = [sys.executable, "-m", module, "serve", "--model", model_dir,
               "--watch", watch, "--out", out, "--checkpoint", ckpt,
               "--max-files-per-batch", "1", "--poll-interval", "0.1",
               "--health-json", health]
        cmd += ["--platform", "cpu"] if pkg == "jax" else ["--device",
                                                            "cpu"]
        env = dict(os.environ, JAX_PLATFORMS="cpu", SNTC_FAULTS="",
                   SNTC_SERVE_HOST_ROWS="0")
        rc, stdout, stderr = _serve_until_committed(cmd, env, ckpt, 5)
        assert rc == 0, stderr[-3000:]
        last = json.loads(stdout.strip().splitlines()[-1])
        marker = json.load(open(os.path.join(ckpt, "drain_marker.json")))
        records = [json.loads(line) for line in open(
            os.path.join(ckpt, "dead_letter", "dead_letter.jsonl"))]
        runs[pkg] = {
            "last": last, "marker_reason": marker["reason"],
            "marker_last": marker["last_committed"],
            "files": {f: open(os.path.join(out, f), "rb").read()
                      for f in sorted(os.listdir(out))},
            "dead_letter": [{k: v for k, v in r.items()
                             if k not in ("ts", "error")} for r in records],
            "errors": [r["error"] for r in records],
            "health": json.load(open(health))["health"]["overall"],
        }
    port, jax = runs["port"], runs["jax"]
    assert port["last"]["drained"] is True and port["last"]["batches"] == 5
    assert port["marker_reason"] == "SIGTERM" and port["marker_last"] == 4
    assert {k: port["last"][k] for k in ("batches", "drained")} == {
        k: jax["last"][k] for k in ("batches", "drained")}
    assert sorted(port["files"]) == [f"batch_{i:06d}.csv"
                                     for i in (0, 1, 3, 4)]
    assert port["files"] == jax["files"]  # bitwise
    assert port["dead_letter"] == jax["dead_letter"]
    assert port["dead_letter"][0]["batch_id"] == 2
    assert port["dead_letter"][0]["rows_file"] is None  # a read failure
    assert "ragged" in port["errors"][0] or "unparsable" in port[
        "errors"][0]
    assert port["health"] == jax["health"]
