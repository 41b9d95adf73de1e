"""Load shedding and the serve command's self-tuning flags, the port
against the JAX package, on the CPU.

* Both engines under their supervisors (``max_pending_batches=2``) over
  the same backlog, with injected clocks: equal ``shed.jsonl`` records
  (minus ``ts``), equal WAL intents and commits, byte-identical batch
  files, under ``oldest`` and ``sample``; no shed offset is named by an
  intent or served.
* A shed past ranges the pipelined source already staged: the staged
  reads are dropped unread and nothing shed is served.
* ``serve`` accepts the JAX command's self-tuning flags with its
  defaults; ``serve --once --autotune`` reports the tuner, and the
  supervised loop with ``--slo-p99-ms`` and ``--max-pending-batches``
  sheds, steers and dumps ``slo``, ``controller`` and
  ``shed_total_offsets`` in ``--health-json``.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pyarrow.csv as pacsv
import pytest

import sntc_tpu.app as jax_app
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
from sntc_tpu.serve import CsvDirSink as JCsvDirSink
from sntc_tpu.serve import MemorySource as JMemorySource
from sntc_tpu.serve import StreamingQuery as JStreamingQuery
from sntc_tpu_torch.app import build_parser
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data import write_raw_csv
from sntc_tpu_torch.serve import (
    CsvDirSink,
    FileStreamSource,
    MemorySource,
    StreamingQuery,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("SNTC_FAULTS", raising=False)
    for pkg in (J, R):
        pkg.clear()
        pkg.clear_events()
        pkg.reset_breakers()
    yield


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _PortIdentity(Transformer):
    def transform(self, frame):
        return frame


class _JaxIdentity(JTransformer):
    def transform(self, frame):
        return frame


def _frame(F, b, rows=6):
    return F({"x": np.arange(rows, dtype=np.float64) + 100 * b,
              "y": np.arange(rows, dtype=np.int64) * b})


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".csv")}


def _wal(ckpt, side):
    d = os.path.join(ckpt, side)
    return {int(f[:-5]): json.load(open(os.path.join(d, f)))
            for f in os.listdir(d) if f.endswith(".json")}


def _shed_run(pkg, tmp_path, policy):
    """12 frames at once, 5 more after three ticks, 3 more after six:
    the supervisor sheds to 2 pending batches at each burst."""
    port = pkg == "port"
    F = Frame if port else JFrame
    ckpt, out = str(tmp_path / f"ck_{pkg}"), str(tmp_path / f"out_{pkg}")
    src = (MemorySource if port else JMemorySource)(
        [_frame(F, b) for b in range(12)])
    if port:
        q = StreamingQuery(_PortIdentity(), src, CsvDirSink(out), ckpt,
                           max_batch_offsets=1, device="cpu",
                           pipeline_depth=2, overlap_sink=False)
    else:
        q = JStreamingQuery(_JaxIdentity(), src, JCsvDirSink(out), ckpt,
                            max_batch_offsets=1, pipeline_depth=2)
    clock = FakeClock()
    sup = (R if port else J).QuerySupervisor(
        q, max_pending_batches=2, shed_policy=policy, clock=clock)
    healths = []
    try:
        for tick in range(14):
            if tick == 3:
                for b in range(12, 17):
                    src.add(_frame(F, b))
            if tick == 6:
                for b in range(17, 20):
                    src.add(_frame(F, b))
            clock.t += 1.0
            sup.tick()
            healths.append(sup.health.state_of("engine").name)
        status = sup.status()
    finally:
        q.stop()
        sup.close()
    shed = [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(os.path.join(ckpt, "shed.jsonl"))]
    return {"shed": shed, "intents": _wal(ckpt, "offsets"),
            "commits": _wal(ckpt, "commits"), "files": _files(out),
            "shed_total": status["shed_total_offsets"],
            "committed": q.last_committed(), "healths": healths}


@pytest.mark.parametrize("policy", ["oldest", "sample"])
def test_shed_equal_across_packages(tmp_path, policy):
    jax = _shed_run("jax", tmp_path, policy)
    port = _shed_run("port", tmp_path, policy)
    assert port == jax
    assert len(port["shed"]) >= 2
    assert port["shed_total"] == sum(r["offsets_shed"] for r in port["shed"])
    assert "DEGRADED" in port["healths"]
    if policy == "oldest":
        # no intent names a shed offset, so no batch file holds one
        shed = set()
        for r in port["shed"]:
            shed |= set(range(r["start"], r["end"]))
        for rec in port["intents"].values():
            assert not shed & set(range(rec["start"], rec["end"]))
        assert port["shed_total"] > 0
    else:
        strided = [rec for rec in port["intents"].values()
                   if "sample_stride" in rec]
        assert strided and all(r["sample_stride"] > 1 for r in strided)
        assert port["shed_total"] == 0


def test_shed_drops_staged_ranges_and_serves_none_of_them(tmp_path):
    """The pipelined source stages the next ranges; an ``oldest`` shed
    moves the cursor past them: they are dropped unread, and every batch
    file holds only offsets past the shed."""
    watch = str(tmp_path / "in")
    os.makedirs(watch)
    for i in range(12):
        pacsv.write_csv(Frame({"x": np.full(4, float(i))}).to_arrow(),
                        os.path.join(watch, f"p_{i:03d}.csv"))
    src = FileStreamSource(watch, prefetch_batches=4, read_workers=2)
    out = str(tmp_path / "out")
    q = StreamingQuery(_PortIdentity(), src, CsvDirSink(out),
                       str(tmp_path / "ck"), max_batch_offsets=1,
                       device="cpu", pipeline_depth=2)
    sup = R.QuerySupervisor(q, clock=FakeClock())
    try:
        sup.tick()  # batches 0-1 dispatched, ranges staged ahead
        staged = set(src._staged)
        assert staged
        rec = q.shed_backlog(2)
        assert rec is not None and rec["offsets_shed"] > 0
        # the shed skipped ranges the source had already staged
        assert any(end <= rec["end"] for _start, end in staged)
        sup.max_pending_batches = 2
        for _ in range(10):
            sup.tick()
        q.process_available()
    finally:
        q.stop()
        src.close()
        sup.close()
    shed = set(range(rec["start"], rec["end"]))
    served = set()
    for name, data in _files(out).items():
        served |= {int(float(v)) for v in data.decode().split()[1:]}
    assert served and not served & shed
    assert served == set(range(12)) - shed
    assert src.prefetch_stats()["hits"] + src.prefetch_stats()["misses"] \
        == q.last_committed() + 1


def _parse_serve(parse):
    return parse(["serve", "--model", "m", "--watch", "w", "--out", "o",
                  "--checkpoint", "c"])


FLAGS = ("autotune", "max_pending_batches", "shed_policy", "slo_p99_ms",
         "slo_min_rows_per_sec", "slo_max_shed_rate", "controller")


def test_serve_parser_self_tuning_defaults_are_the_jax_commands(
        monkeypatch):
    class Parsed(Exception):
        pass

    original = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        raise Parsed(original(self, argv, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as caught:
        _parse_serve(jax_app.main)
    jax_args = caught.value.args[0]
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", original)
    args = _parse_serve(build_parser().parse_args)
    for flag in FLAGS:
        assert getattr(args, flag) == getattr(jax_args, flag), flag
    assert (args.autotune, args.controller, args.shed_policy) == (
        False, True, "oldest")
    for argv, dest, value in (
            (["--autotune"], "autotune", True),
            (["--no-controller"], "controller", False),
            (["--shed-policy", "sample"], "shed_policy", "sample"),
            (["--slo-p99-ms", "250"], "slo_p99_ms", 250.0)):
        parsed = build_parser().parse_args(
            ["serve", "--model", "m", "--watch", "w", "--out", "o",
             "--checkpoint", "c", *argv])
        assert getattr(parsed, dest) == value


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    train = clean_flows(jax_generate_frame(1500, seed=1))
    pm = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label",
                       handleInvalid="skip"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="rawFeatures", handleInvalid="skip"),
        JChiSqSelector(numTopFeatures=10, featuresCol="rawFeatures",
                       labelCol="label", outputCol="features"),
        JRandomForest(numTrees=2, maxDepth=4, seed=0),
    ]).fit(train)
    path = str(tmp_path_factory.mktemp("shed_model") / "model")
    jax_save_model(pm, path)
    return path


def _watch(path, sizes, seed=31):
    os.makedirs(path, exist_ok=True)
    rows = jax_generate_frame(sum(sizes), seed=seed).drop("Label")
    frame = Frame({c: np.asarray(rows[c]) for c in rows.columns})
    start = 0
    for i, n in enumerate(sizes):
        write_raw_csv(frame.slice(start, start + n),
                      os.path.join(path, f"part_{i:04d}.csv"))
        start += n


def _serve(model_dir, watch, out, ckpt, *extra):
    return [sys.executable, "-m", "sntc_tpu_torch", "serve", "--model",
            model_dir, "--watch", watch, "--out", out, "--checkpoint", ckpt,
            "--max-files-per-batch", "1", "--shape-buckets", "64",
            "--device", "cpu", *extra]


ENV = dict(os.environ, JAX_PLATFORMS="cpu", SNTC_FAULTS="",
           SNTC_SERVE_HOST_ROWS="0")


def test_serve_command_self_tuning(tmp_path, model_dir):
    watch = str(tmp_path / "in")
    _watch(watch, [40, 90, 33, 70, 120, 64, 51, 80, 25, 99])
    # --once --autotune: the engine's tuner, reported in pipeline_stats
    once = subprocess.run(
        _serve(model_dir, watch, str(tmp_path / "out_once"),
               str(tmp_path / "ck_once"), "--once", "--autotune"),
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
    assert once.returncode == 0, once.stderr[-3000:]
    summary = json.loads(once.stdout.strip().splitlines()[-1])
    assert summary["batches"] == 10
    # a --once drain commits in a few engine rounds; the tuner's block
    # is there under the JAX keys
    assert set(summary["pipeline_stats"]["autotune"]) == {
        "windows", "decisions", "applied", "frozen", "knobs", "recent"}
    assert set(summary["pipeline_stats"]["ingest"]) == {
        "read", "parse", "stage", "admit", "bucket"}
    # the supervised loop: 10 files pending at start, capped to 2 batches,
    # a p99 target no batch meets
    out, ckpt = str(tmp_path / "out"), str(tmp_path / "ck")
    health = str(tmp_path / "health.json")
    proc = subprocess.Popen(
        _serve(model_dir, watch, out, ckpt, "--poll-interval", "0.05",
               "--max-pending-batches", "2", "--slo-p99-ms", "0.001",
               "--autotune", "--health-json", health),
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 90
        status = {}
        while time.time() < deadline and proc.poll() is None:
            try:
                status = json.load(open(health))
            except (OSError, ValueError):
                status = {}
            if status.get("controller", {}).get("windows", 0) >= 3:
                break
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    except Exception:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, stderr[-3000:]
    assert json.loads(stdout.strip().splitlines()[-1])["drained"] is True
    status = json.load(open(health))
    assert {"slo", "controller", "shed_total_offsets"} <= set(status)
    assert status["slo"]["_"]["declared"]["slo_p99_ms"] == 0.001
    assert status["controller"]["windows"] >= 3
    # the controller owns the ingest tuner: no engine-side one was built
    assert "_" in status["controller"]["ingest"]
    shed = [json.loads(line) for line in open(os.path.join(ckpt,
                                                           "shed.jsonl"))]
    assert status["shed_total_offsets"] == sum(r["offsets_shed"]
                                               for r in shed) == 8
    assert os.path.exists(os.path.join(ckpt, "controller.jsonl"))
    marker = json.load(open(os.path.join(ckpt, "drain_marker.json")))
    assert set(marker["controller_knobs"]) == {"pipeline_depth",
                                               "shape_buckets", "shed"}
    for name in os.listdir(os.path.join(ckpt, "offsets")):
        rec = json.load(open(os.path.join(ckpt, "offsets", name)))
        assert rec["start"] >= 8  # no intent names a shed offset
