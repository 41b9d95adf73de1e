"""The port's stateful flow-feature engine against the JAX package's, on
the CPU.

Both packages meter with numpy over the same C++ parsers, so every
comparison is bitwise (``tests/test_flow.py`` is the JAX side's own):

* the emission sequence of both engines on the same stream, pcap and
  NetFlow, and bench config 9's full width (61 files of 256 flows x 6
  packets, seed 7, a 30 s file gap, a tenth of each file deferred, the
  flush file) with the counts ``bench_runs.jsonl`` records for it:
  23 296 rows, 8 503 out of order, 616 late, 15 617 watermark evictions;
* the snapshot bytes after every batch, and each package restoring the
  other's snapshot (and the other's snapshot file) and going on bitwise;
* the state store's retention and corruption checks, the memoized
  retry, the quarantine rollback, serial against pipelined engine;
* ``serve --from-capture`` of both CLIs with the same predictions;
* a process killed at each of ``flow.emit``, ``flow.evict`` and
  ``flow.state_snapshot`` mid-window, then restarted: commits and sink
  bytes equal an unkilled run's.
"""

import glob
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pyarrow.csv as pacsv
import pytest

import sntc_tpu.app as jax_app
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.base import Transformer as JTransformer
from sntc_tpu.data import CICIDS2017_FEATURES
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import StandardScaler as JStandardScaler
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.flow import FlowCaptureSource as JFlowCaptureSource
from sntc_tpu.flow import FlowStateStore as JFlowStateStore
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import LogisticRegression as JLogisticRegression
from sntc_tpu.serve.streaming import CsvDirSink as JCsvDirSink
from sntc_tpu.serve.streaming import StreamingQuery as JStreamingQuery
from sntc_tpu_torch import app as port_app
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.data import write_capture_stream
from sntc_tpu_torch.flow import (
    FORMATS,
    FlowCaptureSource,
    FlowFeatureEngine,
    FlowStateCorruptError,
    FlowStateError,
    FlowStateStore,
    NetFlowMeter,
    PcapFlowMeter,
)
from sntc_tpu_torch.resilience import RetryPolicy, arm, clear
from sntc_tpu_torch.serve import CsvDirSink, StreamingQuery
from jax_metrics_guard import own_jax_registry  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINK_COLS = ["Destination Port", "Flow Duration", "Total Fwd Packets",
             "Total Backward Packets", "Fwd Packet Length Mean",
             "Bwd Packet Length Std", "Flow IAT Mean", "Flow Bytes/s"]


class Identity(Transformer):
    def transform(self, frame):
        return frame


class JIdentity(JTransformer):
    def transform(self, frame):
        return frame


@pytest.fixture(autouse=True)
def _clean_faults():
    clear()
    yield
    clear()


@pytest.fixture(scope="module", autouse=True)
def _jax_parsers_built():
    """The JAX loader links its libraries in place at first use: another
    test process may be linking one this moment, so a load that fails
    on a half-written file is retried."""
    import time

    import sntc_tpu.native.netflow as jnf
    import sntc_tpu.native.pcap as jpc

    for _ in range(100):
        try:
            jpc._get_lib()
            jnf._get_lib()
            return
        except OSError:
            time.sleep(0.1)


@pytest.fixture
def frozen_zip_clock(monkeypatch):
    """``np.savez`` stamps each member with the wall clock: pin it so two
    snapshots of equal state are equal bytes."""
    monkeypatch.setattr(zipfile.time, "time", lambda: 1_700_000_000.0)


def _frames_equal(a, b):
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype and np.array_equal(x, y), c


def _sources(cap, fmt="pcap", state=None, **kw):
    kw = dict(dict(flow_timeout=0.5, activity_timeout=0.2,
                   allowed_lateness=1.2), **kw)
    if fmt == "netflow":
        kw.pop("activity_timeout")
    p = FlowCaptureSource(cap, format=fmt, **kw, state_dir=(
        None if state is None else os.path.join(state, "p")))
    j = JFlowCaptureSource(cap, format=fmt, **kw, state_dir=(
        None if state is None else os.path.join(state, "j")))
    return p, j


def _sink_bytes(d):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "batch_*.csv")))}


# ---------------------------------------------------------------------------
# the engines' emissions and snapshots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["pcap", "netflow"])
def test_emissions_and_snapshots_bitwise(tmp_path, fmt, frozen_zip_clock):
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=6, flows_per_file=4,
                         packets_per_flow=6, seed=13, format=fmt,
                         defer_fraction=0.25)
    p, j = _sources(cap, fmt)
    rows = 0
    for i in range(p.latest_offset()):
        fp, fj = p.get_batch(i, i + 1), j.get_batch(i, i + 1)
        _frames_equal(fp, fj)
        rows += fp.num_rows
        assert p.engine.snapshot() == j.engine.snapshot(), i
        assert p.engine.stats() == j.engine.stats()
    assert rows > 0
    _frames_equal(p.flush_windows(), j.flush_windows())
    assert FORMATS == {"pcap": "*.pcap", "netflow": "*.nf5"}


def test_config9_full_width_bitwise(tmp_path):
    """Bench config 9's stream (``bench.py:1356-1540``, seed 7) written
    by the port's writer, through both packages' sources."""
    cap = str(tmp_path / "cap")
    info = write_capture_stream(cap, n_files=61, flows_per_file=256,
                                packets_per_flow=6, seed=7,
                                file_gap_s=30.0, defer_fraction=0.1,
                                flush=True)
    p, j = _sources(cap, flow_timeout=5.0, activity_timeout=5.0,
                    allowed_lateness=35.0)
    rows = batches = 0
    for i in range(p.latest_offset()):
        fp, fj = p.get_batch(i, i + 1), j.get_batch(i, i + 1)
        _frames_equal(fp, fj)
        rows += fp.num_rows
        batches += fp.num_rows > 0
    st = p.flow_stats()
    assert info["packets"].shape[0] == 93_696 and info["n_flows"] == 15_616
    assert (rows, batches) == (23_296, 61)
    assert (st["out_of_order"], st["late_records"]) == (8_503, 616)
    assert st["evictions"] == {"watermark": 15_617}
    assert st["packets"] == 1 and st["parser"] == "native"
    jst = j.flow_stats()
    assert {k: st[k] for k in jst} == jst


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("fmt", ["pcap", "netflow"])
def test_each_package_restores_the_others_snapshot(tmp_path, direction,
                                                   fmt):
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=6, flows_per_file=3,
                         packets_per_flow=6, seed=7, format=fmt,
                         defer_fraction=0.2)
    p, j = _sources(cap, fmt)
    first, second = (j, p) if direction == "jax_to_port" else (p, j)
    ref = [first.get_batch(i, i + 1) for i in range(first.latest_offset())]
    a, _ = _sources(cap, fmt)
    if direction == "jax_to_port":
        a = JFlowCaptureSource(cap, format=fmt, flow_timeout=0.5,
                               allowed_lateness=1.2,
                               **({} if fmt == "netflow" else
                                  {"activity_timeout": 0.2}))
    for i in range(3):
        a.get_batch(i, i + 1)
    second.engine.restore(a.engine.snapshot())
    second._consumed_end = 3
    for i in range(3, second.latest_offset()):
        _frames_equal(second.get_batch(i, i + 1), ref[i])


def test_snapshot_files_cross_packages(tmp_path):
    """A snapshot file published by one package's store loads in the
    other's (the ``SNTCFLOW1`` layout), keep=2 on both."""
    ps, js = FlowStateStore(str(tmp_path / "s")), JFlowStateStore(
        str(tmp_path / "s"))
    ps.publish(4, b"four")
    js.publish(7, b"seven")
    assert js.load(4) == b"four" and ps.load(7) == b"seven"
    assert ps.ends() == js.ends() == [4, 7]
    with open(ps._file(7), "rb") as a, open(str(tmp_path / "x.bin"),
                                             "wb") as b:
        b.write(a.read())
    JFlowStateStore(str(tmp_path / "t")).publish(7, b"seven")
    with open(ps._file(7), "rb") as a, open(
            os.path.join(str(tmp_path / "t"), "state-000000000007.bin"),
            "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# the store and the source protocol
# ---------------------------------------------------------------------------


def test_state_store_retention_and_corruption(tmp_path):
    store = FlowStateStore(str(tmp_path / "st"))
    for end, payload in ((1, b"one"), (2, b"two"), (3, b"three")):
        store.publish(end, payload)
    assert store.ends() == [2, 3]
    assert store.load(3) == b"three" and store.load(1) is None
    path = store._file(2)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-1])
    with pytest.raises(FlowStateCorruptError, match="torn write"):
        store.load(2)
    open(path, "wb").write(b"XXXX" + blob[4:])
    with pytest.raises(FlowStateCorruptError, match="bad magic"):
        store.load(2)
    open(path, "wb").write(blob[:-1] + bytes([blob[-1] ^ 1]))
    with pytest.raises(FlowStateCorruptError, match="sha256"):
        store.load(2)
    with pytest.raises(ValueError, match=">= 2"):
        FlowStateStore(str(tmp_path / "k"), keep=1)
    # the JAX store calls the same damage corrupt
    with pytest.raises(Exception, match="sha256"):
        JFlowStateStore(str(tmp_path / "st")).load(2)


def test_source_ordered_consumption_and_memoized_retry(tmp_path):
    d = str(tmp_path / "cap")
    write_capture_stream(d, n_files=3, flows_per_file=2,
                         packets_per_flow=4, seed=2)
    src = FlowCaptureSource(d, format="pcap", flow_timeout=0.5,
                            allowed_lateness=0.2)
    f0 = src.get_batch(0, 1)
    consumed = src.engine.records_consumed
    assert src.get_batch(0, 1) is f0
    assert src.engine.records_consumed == consumed
    src.get_batch(1, 2)
    with pytest.raises(ValueError, match="snapshot-at-commit"):
        src.get_batch(0, 1)


def test_on_restore_requires_matching_snapshot(tmp_path):
    d = str(tmp_path / "cap")
    write_capture_stream(d, n_files=3, flows_per_file=2,
                         packets_per_flow=4, seed=2)
    src = FlowCaptureSource(d, format="pcap",
                            state_dir=str(tmp_path / "st"))
    src.on_restore(0)
    with pytest.raises(FlowStateError, match="diverged"):
        src.on_restore(2)
    with pytest.raises(FlowStateError, match="state_dir"):
        FlowCaptureSource(d, format="pcap").on_restore(1)


def test_engine_golden_rules():
    """Late records drop, the state cap force-evicts, and a window
    equals the batch meter's features (``tests/test_flow.py``)."""
    from sntc_tpu_torch.native import make_packet, make_pcap, parse_pcap

    def pkts(spec):
        return parse_pcap(make_pcap([
            (ts, make_packet(s, d, sp, dp, proto=6, payload=pay))
            for ts, s, d, sp, dp, pay in spec]))

    A, B = 0x0A000001, 0x0A000002
    eng = FlowFeatureEngine(PcapFlowMeter(2.0, 1.0), allowed_lateness=0.5)
    eng.consume(pkts([(50.0, A, B, 1024, 80, 100)]))
    eng.consume(pkts([(40.0, A, B, 1024, 80, 999)]))
    assert eng.late_records == 1
    eng.consume(pkts([(100.0, 0x01010101, 0x02020202, 9, 9, 8)]))
    out = eng.poll()
    assert out.num_rows == 1 and float(out["Total Fwd Packets"][0]) == 1.0
    cap = FlowFeatureEngine(PcapFlowMeter(1000.0, 1.0),
                            allowed_lateness=0.5, max_state_packets=8)
    for i in range(6):
        cap.consume(pkts([(10.0 + i, 0x0B000000 + i, B, 2000 + i, 80, 10),
                          (10.5 + i, 0x0B000000 + i, B, 2000 + i, 80, 10)]))
        cap.poll()
        assert cap.state_size()["packets"] <= 8
    assert cap.evictions.get("state_cap", 0) >= 1
    nf = NetFlowMeter(flow_timeout=10.0)
    assert nf.emit(np.zeros((0, 16))).num_rows == 0
    with pytest.raises(ValueError):
        FlowFeatureEngine(nf, allowed_lateness=-1)


# ---------------------------------------------------------------------------
# the source under the port's engine
# ---------------------------------------------------------------------------


def _port_query(cap, d, *, pipelined=False, retry=None, failures=None,
                **src_kw):
    src = FlowCaptureSource(
        cap, format="pcap", flow_timeout=0.5, activity_timeout=0.2,
        allowed_lateness=1.2,
        state_dir=os.path.join(d, "ckpt", "flow_state"),
        prefetch_batches=2 if pipelined else 0, **src_kw)
    q = StreamingQuery(
        Identity(), src, CsvDirSink(os.path.join(d, "out"),
                                    columns=SINK_COLS),
        os.path.join(d, "ckpt"), max_batch_offsets=1,
        pipeline_depth=3 if pipelined else 1, overlap_sink=pipelined,
        retry_policy=retry, max_batch_failures=failures, device="cpu")
    return src, q


def test_port_engine_sink_equals_the_jax_engines(tmp_path):
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=5, flows_per_file=3,
                         packets_per_flow=6, seed=11, defer_fraction=0.2)
    src, q = _port_query(cap, str(tmp_path / "p"))
    assert q.process_available() == 6
    jsrc = JFlowCaptureSource(
        cap, format="pcap", flow_timeout=0.5, activity_timeout=0.2,
        allowed_lateness=1.2,
        state_dir=str(tmp_path / "j" / "ckpt" / "flow_state"))
    jq = JStreamingQuery(JIdentity(), jsrc, JCsvDirSink(
        str(tmp_path / "j" / "out"), columns=SINK_COLS),
        str(tmp_path / "j" / "ckpt"), max_batch_offsets=1)
    assert jq.process_available() == 6
    a, b = _sink_bytes(str(tmp_path / "p" / "out")), _sink_bytes(
        str(tmp_path / "j" / "out"))
    assert list(a) == list(b)
    for k in a:
        ta, tb = (pacsv.read_csv(os.path.join(str(tmp_path / d / "out"), k))
                  for d in ("p", "j"))
        assert ta.num_rows == tb.num_rows
        for c in SINK_COLS:
            if ta.num_rows:
                assert np.array_equal(
                    ta.column(c).to_numpy().astype(np.float32),
                    tb.column(c).to_numpy().astype(np.float32)), c
    assert src.snapshots_published == jsrc.snapshots_published == 6
    assert sorted(os.listdir(tmp_path / "p" / "ckpt" / "flow_state")) == \
        sorted(os.listdir(tmp_path / "j" / "ckpt" / "flow_state"))


def test_restart_replays_to_the_same_sink(tmp_path):
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=5, flows_per_file=3,
                         packets_per_flow=6, seed=4, defer_fraction=0.2)
    _, q = _port_query(cap, str(tmp_path / "ref"))
    assert q.process_available() == 6
    crash = str(tmp_path / "crash")
    src, q = _port_query(cap, crash)
    q._run_one_batch()
    q._run_one_batch()
    arm("sink.write", kind="io", times=100)
    with pytest.raises(Exception):
        q._run_one_batch()
    clear()
    assert q.in_flight_count() > 0
    del q, src
    _, q2 = _port_query(cap, crash)
    q2.process_available()
    assert _sink_bytes(os.path.join(crash, "out")) == _sink_bytes(
        str(tmp_path / "ref" / "out"))


@pytest.mark.parametrize("site,after", [("flow.emit", 2), ("flow.evict", 1)])
def test_raising_flow_fault_retries_without_double_consume(tmp_path, site,
                                                           after):
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=4, flows_per_file=3,
                         packets_per_flow=6, seed=17)
    retry = RetryPolicy(max_attempts=3, base_delay_s=0.0)
    ref_src, q = _port_query(cap, str(tmp_path / "ref"), retry=retry)
    q.process_available()
    src, q = _port_query(cap, str(tmp_path / "f"), retry=retry)
    arm(site, kind="exc", after=after, times=1)
    q.process_available()
    clear()
    assert src.engine.records_consumed == ref_src.engine.records_consumed
    assert _sink_bytes(str(tmp_path / "f" / "out")) == _sink_bytes(
        str(tmp_path / "ref" / "out"))


def test_persistent_poll_failure_quarantines_and_rolls_back(tmp_path):
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=5, flows_per_file=3,
                         packets_per_flow=6, seed=21)
    src, q = _port_query(cap, str(tmp_path / "q"),
                         retry=RetryPolicy(max_attempts=2,
                                           base_delay_s=0.0),
                         failures=2)
    arm("flow.evict", kind="exc", after=1, times=4)
    for _ in range(10):
        q.process_available()
    clear()
    quarantined = [p for p in q.recentProgress if p.get("quarantined")]
    assert len(quarantined) == 1, q.recentProgress
    assert q.last_committed() == 5
    after = [p for p in q.recentProgress
             if p["batchId"] > quarantined[0]["batchId"]]
    assert sum(p["numInputRows"] for p in after) > 0
    assert src.engine.state_size()["packets"] < 18


def test_pipelined_engine_matches_serial_bitwise(tmp_path):
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=6, flows_per_file=3,
                         packets_per_flow=6, seed=13, defer_fraction=0.2)
    out = {}
    for name, pipelined in (("serial", False), ("pipe", True)):
        src, q = _port_query(cap, str(tmp_path / name),
                             pipelined=pipelined)
        q.process_available()
        q.stop()
        src.close()
        out[name] = _sink_bytes(str(tmp_path / name / "out"))
    assert out["serial"] == out["pipe"] and len(out["serial"]) == 7


# ---------------------------------------------------------------------------
# the serve command
# ---------------------------------------------------------------------------


def _jax_lr_model(path):
    frame = jax_generate_frame(3000, seed=1)
    from sntc_tpu.data import clean_flows

    frame = clean_flows(frame)
    pipe = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label",
                       handleInvalid="skip"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="rawFeatures"),
        JStandardScaler(inputCol="rawFeatures", outputCol="features",
                        withMean=True),
        JLogisticRegression(maxIter=10),
    ]).fit(frame)
    jax_save_model(pipe, path)
    return path


def test_serve_from_capture_both_clis(tmp_path, capsys):
    model = _jax_lr_model(str(tmp_path / "model"))
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=4, flows_per_file=6,
                         packets_per_flow=6, seed=6, defer_fraction=0.1)
    common = ["--model", model, "--watch", cap, "--from-capture", "pcap",
              "--flow-timeout", "0.5", "--flow-activity-timeout", "0.2",
              "--flow-lateness", "1.2", "--max-files-per-batch", "1",
              "--shape-buckets", "64", "--once"]
    pd, jd = str(tmp_path / "p"), str(tmp_path / "j")
    assert port_app.main(["serve", *common, "--out", pd + "/out",
                          "--checkpoint", pd + "/ck", "--device",
                          "cpu"]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["batches"] == 5
    assert served["flow"]["parser"] == "native"
    assert served["flow"]["snapshots_published"] == 5
    assert jax_app.main(["serve", *common, "--out", jd + "/out",
                         "--checkpoint", jd + "/ck", "--platform",
                         "cpu"]) == 0
    capsys.readouterr()
    names = sorted(os.listdir(pd + "/out"))
    assert names == sorted(os.listdir(jd + "/out")) and len(names) == 5
    rows = 0
    for n in names:
        a = pacsv.read_csv(os.path.join(pd, "out", n))
        b = pacsv.read_csv(os.path.join(jd, "out", n))
        assert a.num_rows == b.num_rows
        rows += a.num_rows
        if a.num_rows:
            assert a.column("prediction").to_pylist() == \
                b.column("prediction").to_pylist()
    assert rows > 0
    assert os.listdir(pd + "/ck/flow_state") == os.listdir(
        jd + "/ck/flow_state")
    # a resume with nothing new serves nothing
    assert port_app.main(["serve", *common, "--out", pd + "/out",
                          "--checkpoint", pd + "/ck", "--device",
                          "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "batches"] == 0


def test_serve_refuses_from_capture_with_a_listener(tmp_path):
    with pytest.raises(SystemExit, match="drop --from-capture"):
        port_app.main(["serve", "--model", "m", "--watch", str(tmp_path),
                       "--out", "o", "--checkpoint", str(tmp_path / "c"),
                       "--from-capture", "netflow", "--listen-udp", "0",
                       "--device", "cpu"])


def test_capture_flag_defaults_match_the_jax_command():
    import argparse

    argv = ["serve", "--model", "m", "--watch", "w", "--out", "o",
            "--checkpoint", "c"]
    p = port_app.build_parser().parse_args(argv)
    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        captured["ns"] = orig(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jax_app.main(argv)
    finally:
        argparse.ArgumentParser.parse_args = orig
    j = captured["ns"]
    for k in ("from_capture", "flow_timeout", "flow_activity_timeout",
              "flow_lateness", "flow_max_packets", "listen_udp",
              "listen_tcp", "ingress_spool_mb"):
        assert getattr(p, k) == getattr(j, k), k


# ---------------------------------------------------------------------------
# process kills at the three flow sites
# ---------------------------------------------------------------------------

KILL_AFTER = {"flow.emit": 2, "flow.evict": 1, "flow.state_snapshot": 2}

_WORKER = """
import json, os, sys
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.flow import FlowCaptureSource
from sntc_tpu_torch.resilience import arm
from sntc_tpu_torch.serve import CsvDirSink, StreamingQuery

class Identity(Transformer):
    def transform(self, frame):
        return frame

d, site, after = sys.argv[1], sys.argv[2], int(sys.argv[3])
if site:
    arm(site, kind="kill", after=after, times=1)
src = FlowCaptureSource(os.path.join(d, "..", "in"), format="pcap",
                        flow_timeout=0.5, activity_timeout=0.2,
                        allowed_lateness=1.2,
                        state_dir=os.path.join(d, "ckpt", "flow_state"))
q = StreamingQuery(Identity(), src,
                   CsvDirSink(os.path.join(d, "out"), columns=%r),
                   os.path.join(d, "ckpt"), max_batch_offsets=1,
                   device="cpu")
print(json.dumps({"batches": q.process_available()}))
""" % (SINK_COLS,)


def _committed(ckpt):
    out = {}
    for p in sorted(glob.glob(os.path.join(ckpt, "commits", "*.json"))):
        rec = json.load(open(p))
        out[int(os.path.basename(p)[:-5])] = (rec["start"], rec["end"])
    return out


def _spawn(d, site=""):
    env = dict(os.environ, PYTHONPATH=REPO, SNTC_FAULTS="")
    env.pop("SNTC_RESILIENCE_LOG", None)
    return subprocess.Popen(
        [sys.executable, "-c", _WORKER, d, site,
         str(KILL_AFTER.get(site, 0))],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_kills_at_the_flow_sites_converge_bitwise(tmp_path):
    """The JAX harness's flow kill matrix (``scripts/chaos_crash_matrix
    .py`` ``run_flow_kill_scenario``) on the port: each killed process
    dies with 137 mid-window, and its restart's commits and sink bytes
    equal the unkilled run's."""
    write_capture_stream(str(tmp_path / "in"), n_files=5, flows_per_file=3,
                         packets_per_flow=6, seed=11, defer_fraction=0.2,
                         flush=True)
    sites = sorted(KILL_AFTER)
    dirs = {s: str(tmp_path / (s.replace(".", "_") or "ref"))
            for s in [""] + sites}
    procs = {s: _spawn(dirs[s], s) for s in dirs}
    outs = {s: p.communicate(timeout=240) for s, p in procs.items()}
    assert procs[""].returncode == 0, outs[""]
    for s in sites:
        assert procs[s].returncode == 137, (s, outs[s])
    restarts = {s: _spawn(dirs[s]) for s in sites}
    for s, p in restarts.items():
        out = p.communicate(timeout=240)
        assert p.returncode == 0, (s, out)
    ref_commits = _committed(os.path.join(dirs[""], "ckpt"))
    ref_sink = _sink_bytes(os.path.join(dirs[""], "out"))
    assert len(ref_sink) == 6 and len(ref_commits) == 6
    for s in sites:
        assert _committed(os.path.join(dirs[s], "ckpt")) == ref_commits, s
        assert _sink_bytes(os.path.join(dirs[s], "out")) == ref_sink, s


@pytest.mark.cuda
def test_capture_serve_on_the_card_equals_the_cpu(tmp_path, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _jax_lr_model(str(tmp_path / "model"))
    cap = str(tmp_path / "cap")
    write_capture_stream(cap, n_files=5, flows_per_file=24,
                         packets_per_flow=6, seed=8, defer_fraction=0.1)
    common = ["serve", "--model", model, "--watch", cap, "--from-capture",
              "pcap", "--flow-timeout", "0.5", "--flow-lateness", "1.2",
              "--max-files-per-batch", "1", "--shape-buckets", "64",
              "--once"]
    summaries = {}
    for dev in ("cpu", "cuda"):
        d = str(tmp_path / dev)
        assert port_app.main(common + ["--out", d + "/out", "--checkpoint",
                                       d + "/ck", "--device", dev]) == 0
        summaries[dev] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    assert summaries["cuda"]["kernel_launches"]["pad_assemble"] >= 1
    assert summaries["cuda"]["rows"] == summaries["cpu"]["rows"] > 0
    for n in sorted(os.listdir(tmp_path / "cpu" / "out")):
        a = pacsv.read_csv(str(tmp_path / "cpu" / "out" / n))
        b = pacsv.read_csv(str(tmp_path / "cuda" / "out" / n))
        assert a.num_rows == b.num_rows
        if a.num_rows:
            assert a.column("prediction").to_pylist() == \
                b.column("prediction").to_pylist()


# ---------------------------------------------------------------------------
# capture tenants on the serve daemon (tests/test_flow.py:585)
# ---------------------------------------------------------------------------


def _capture_daemon(pkg, tmp_path):
    """Two raw-capture tenants on one daemon of ``pkg``: the rows each
    served, the flow-state files under its namespace, its sink's bytes,
    and the tenant-tagged flow events."""
    if pkg == "jax":
        import sntc_tpu.resilience as res
        from sntc_tpu.serve import ServeDaemon, TenantSpec

        model, dev = JIdentity(), {}
    else:
        import sntc_tpu_torch.resilience as res
        from sntc_tpu_torch.serve import ServeDaemon, TenantSpec

        model, dev = Identity(), {"device": "cpu"}
    res.clear_events()
    root = tmp_path / pkg
    specs = []
    for k, tid in enumerate(("t0", "t1")):
        cap = str(tmp_path / "in" / tid)
        if not os.path.isdir(cap):
            write_capture_stream(cap, n_files=3, flows_per_file=2,
                                 packets_per_flow=4, seed=20 + k)
        specs.append(TenantSpec(
            tenant_id=tid, model=model, watch=cap,
            out=str(root / "out" / tid), out_columns=SINK_COLS,
            from_capture="pcap",
            flow_options={"flow_timeout": 0.5, "allowed_lateness": 0.2}))
    daemon = ServeDaemon(specs, str(root / "root"), **dev)
    try:
        daemon.process_available()
        rows = {t.spec.tenant_id: t.rows_done for t in daemon.tenants}
        states = {t.spec.tenant_id: t.state for t in daemon.tenants}
    finally:
        daemon.close()
    out = {}
    for tid in ("t0", "t1"):
        state_dir = root / "root" / "tenant" / tid / "ckpt" / "flow_state"
        out[tid] = (
            sorted(os.listdir(state_dir)),
            {os.path.basename(p): open(p, "rb").read() for p in sorted(
                glob.glob(str(root / "out" / tid / "batch_*.csv")))})
    events = [(r["event"], r.get("tenant"), r.get("windows"))
              for r in res.recent_events(event="flow_windows_emitted")]
    return rows, states, out, events


def test_serve_daemon_capture_tenants(tmp_path):
    """Each capture tenant runs its own flow operator, its state under
    ``tenant/<id>/ckpt/flow_state``, and emits its own capture's
    windows, tagged with its id; both packages write the same files."""
    jax = _capture_daemon("jax", tmp_path)
    port = _capture_daemon("port", tmp_path)
    assert port == jax
    rows, states, out, events = port
    assert all(v > 0 for v in rows.values())
    assert states == {"t0": "OK", "t1": "OK"}
    for tid in ("t0", "t1"):
        ref = FlowCaptureSource(str(tmp_path / "in" / tid), format="pcap",
                                flow_timeout=0.5, allowed_lateness=0.2)
        assert rows[tid] == sum(ref.get_batch(i, i + 1).num_rows
                                for i in range(ref.latest_offset()))
        ref.close()
        assert out[tid][0] and out[tid][1]
    assert {t for _e, t, _w in events} == {"t0", "t1"}


def test_flow_state_store_tenant_fault_namespaced(tmp_path):
    """``tenant/<id>/flow.state_snapshot`` fires for that tenant's store
    only, in both packages."""
    from sntc_tpu.flow import FlowStateStore as JStore
    import sntc_tpu.resilience as JRes

    got = {}
    for pkg, store_cls, res in (("jax", JStore, JRes),
                                ("port", FlowStateStore, None)):
        res = res or __import__("sntc_tpu_torch.resilience",
                                fromlist=["arm"])
        res.clear()
        res.arm("tenant/a/flow.state_snapshot", times=None)
        a = store_cls(str(tmp_path / pkg / "a"), tenant="a")
        b = store_cls(str(tmp_path / pkg / "b"), tenant="b")
        with pytest.raises(res.InjectedFault) as exc:
            a.publish(3, b"abc")
        b.publish(3, b"abc")
        got[pkg] = (str(exc.value), sorted(os.listdir(tmp_path / pkg / "b")))
        res.clear()
    assert got["port"] == got["jax"]
