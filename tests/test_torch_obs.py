"""The port's telemetry plane against the JAX package's ``obs/``, on the
CPU: the metrics exposition, the span tracer and its Chrome-trace
export, the roofline plane, ``MetricsLogger``, the spans and the cost
count on the serve path, the commands' obs flags, and the package
exports.

* ``to_prometheus`` and ``write_jsonl`` (injected clocks) are
  byte-equal to the JAX registry's for the same sequence of writes;
* the Chrome-trace export has the JAX tracer's keys and events for the
  same spans under the same clocks (only ``otherData.tool`` names the
  package);
* ``roofline`` on a given count: the H100 data sheet's peaks on a
  ``gpu`` named as the H100, no peak and no MFU on another card or on
  the CPU (``peak_source: "none"``);
* ``MetricsLogger`` writes the JAX logger's records (the elapsed
  seconds aside);
* a fused segment under ``SNTC_OBS_COST_ANALYSIS`` counts its products'
  FLOPs and its bytes from the bound shapes, exactly;
* ``serve --once --metrics-out --trace-out --device-trace`` writes the
  three files with every batch's spans; ``train`` writes the metrics and
  the trace when the run fails too;
* the obs flags carry the JAX flags' names, destinations, defaults and
  metavars; ``--trace-out``'s help is the JAX text, ``--metrics-out``
  and ``--device-trace`` name what the port does (no serve-daemon; a
  ``torch.profiler`` capture);
* the JAX package's ``__all__`` is a subset of the port's, at the top,
  in ``ops`` and in ``obs``.
"""

import json
import os

import numpy as np
import pytest
import torch

import sntc_tpu
import sntc_tpu.evaluation as jax_evaluation
import sntc_tpu.feature as jax_feature
import sntc_tpu.models as jax_models
import sntc_tpu.obs as jax_obs
import sntc_tpu.ops as jax_ops
import sntc_tpu.stat as jax_stat
from sntc_tpu.obs.metrics import MetricsRegistry as JRegistry
from sntc_tpu.obs.trace import SpanTracer as JTracer
from sntc_tpu.utils.logging import MetricsLogger as JLogger
import sntc_tpu_torch
import sntc_tpu_torch.evaluation as evaluation
import sntc_tpu_torch.feature as feature
import sntc_tpu_torch.models as models
import sntc_tpu_torch.obs as obs
import sntc_tpu_torch.ops as ops
import sntc_tpu_torch.stat as stat
from sntc_tpu_torch.core.base import Pipeline, PipelineModel
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.feature import DCT, PCA, MinMaxScaler, VectorAssembler
from sntc_tpu_torch.fuse import compile_pipeline, fusion_stats
from sntc_tpu_torch.models import LogisticRegression
from sntc_tpu_torch.obs import cost
from sntc_tpu_torch.obs.metrics import MetricsRegistry
from sntc_tpu_torch.obs.trace import SpanTracer
from sntc_tpu_torch.serve import BatchPredictor
from sntc_tpu_torch.utils.logging import MetricsLogger
from jax_metrics_guard import own_jax_registry  # noqa: F401

H100 = "NVIDIA H100 80GB HBM3"  # torch.cuda.get_device_name of the H100


def _writes(reg):
    """One sequence of registry writes over names both catalogs declare
    with the same help text."""
    reg.inc("sntc_events_total", event="retry", site='sink "a"\n')
    reg.inc("sntc_events_total", 2, event="quarantine", site="stream.read")
    reg.inc("sntc_rows_committed_total", 2048)
    reg.inc("sntc_batches_committed_total")
    for v in (0.0004, 0.03, 0.03, 7.0, 100.0):
        reg.observe("sntc_batch_duration_seconds", v)
    reg.set_gauge("sntc_mfu_ratio", 0.125, segment="0")
    reg.set_gauge("sntc_mfu_bw_ratio", 3.5e-5, segment="0")
    reg.set_gauge("sntc_health_state", 1, component="engine")
    reg.inc("sntc_spans_dropped_total", 3)


def test_prometheus_and_jsonl_byte_equal_to_the_jax_registry(tmp_path):
    outs = []
    for cls in (JRegistry, MetricsRegistry):
        reg = cls(clock=lambda: 1700000000.25, mono=lambda: 12.5)
        _writes(reg)
        path = str(tmp_path / f"{cls.__module__}.jsonl")
        reg.write_jsonl(path)
        reg.inc("sntc_batches_committed_total")
        reg.write_jsonl(path)
        prom = str(tmp_path / f"{cls.__module__}.prom")
        reg.write_prometheus(prom)
        with open(path, "rb") as f, open(prom, "rb") as g:
            outs.append((reg.to_prometheus(), f.read(), g.read()))
    assert outs[0] == outs[1]
    assert 'sntc_mfu_ratio{segment="0"} 0.125' in outs[1][0]


def test_set_registry_swaps_the_process_default():
    mine = MetricsRegistry()
    prev = obs.set_registry(mine)
    try:
        obs.inc("sntc_rows_committed_total", 5)
        assert obs.registry() is mine
        assert mine.get("sntc_rows_committed_total") == 5.0
    finally:
        assert obs.set_registry(prev) is mine


def test_catalog_entries_shared_with_the_jax_package():
    """Every name the port declares is a JAX name with the same type,
    labels and buckets; the help is the JAX text but where the port's
    device fault domain differs (no host fallback), and where the JAX
    text names XLA or Pallas (the predictor's shape ledger, the kernel
    calls)."""
    from sntc_tpu.obs.metrics import CATALOG as JCATALOG

    differs = {"sntc_device_state", "sntc_device_faults_total",
               "sntc_device_oom_splits_total",
               "sntc_predict_compile_events_total",
               "sntc_kernel_dispatch_total"}
    for name, spec in obs.CATALOG.items():
        j = JCATALOG[name]
        for key in ("type", "labels", "buckets"):
            assert spec.get(key) == j.get(key), (name, key)
        if name not in differs:
            assert spec["help"] == j["help"], name
    for name in ("sntc_mfu_ratio", "sntc_mfu_bw_ratio",
                 "sntc_spans_dropped_total"):
        assert name in obs.CATALOG


class _Clock:
    def __init__(self, start, step):
        self.t, self.step = start, step

    def __call__(self):
        self.t += self.step
        return self.t


def _trace(cls, path):
    tr = cls(capacity=3, clock=_Clock(10.0, 0.25), wall=_Clock(1e9, 1.0))
    with tr.span("stream.read", batch=0):
        pass
    with tr.span("fuse.dispatch", args=1):
        pass
    with pytest.raises(RuntimeError):
        with tr.span("sink.deliver", batch=0):
            raise RuntimeError("recorded all the same")
    with tr.span("stream.commit", batch=0):
        pass
    tr.export_chrome_trace(path)
    with open(path) as f:
        return tr, json.load(f)


def test_chrome_trace_keys_equal_to_the_jax_tracer(tmp_path):
    jt, jdoc = _trace(JTracer, str(tmp_path / "j.json"))
    pt, pdoc = _trace(SpanTracer, str(tmp_path / "p.json"))
    assert pt.stats() == jt.stats() == {"spans": 3, "capacity": 3,
                                         "dropped": 1}
    assert set(pdoc) == set(jdoc)
    assert pdoc["displayTimeUnit"] == jdoc["displayTimeUnit"]
    assert pdoc["otherData"]["dropped_spans"] == 1
    assert pdoc["otherData"]["tool"] == "sntc_tpu_torch.obs"
    xs = [[e for e in d["traceEvents"] if e["ph"] == "X"]
          for d in (jdoc, pdoc)]
    assert [sorted(e) for e in xs[1]] == [sorted(e) for e in xs[0]]
    assert xs[1] == xs[0]  # same clocks, same process and thread
    assert [e["name"] for e in xs[1]] == [
        "fuse.dispatch", "sink.deliver", "stream.commit"]
    meta = [[sorted(e) for e in d["traceEvents"] if e["ph"] == "M"]
            for d in (jdoc, pdoc)]
    assert meta[1] == meta[0]
    assert [s["name"] for s in pt.spans()] == [s["name"] for s in jt.spans()]


def test_span_is_a_shared_null_context_while_tracing_is_off():
    obs.disable_tracing()
    assert not obs.tracing_enabled()
    assert obs.span("a") is obs.span("b", batch=1)
    t = obs.enable_tracing(capacity=8)
    try:
        assert obs.enable_tracing(capacity=8) is t
        with obs.span("stream.wal", batch=4):
            pass
        assert obs.tracer().spans()[0]["attrs"] == {"batch": 4}
    finally:
        assert obs.disable_tracing() is t
    assert obs.tracer() is None


def test_ring_overflow_counts_into_the_catalog():
    reg = obs.reset_registry()
    tr = SpanTracer(capacity=2)
    for i in range(5):
        with tr.span("s", i=i):
            pass
    assert tr.dropped == 3
    assert reg.get("sntc_spans_dropped_total") == 3.0
    assert [s["attrs"]["i"] for s in tr.spans()] == [3, 4]
    tr.clear()
    assert tr.stats()["spans"] == 0 and tr.dropped == 0


def test_roofline_on_a_given_count():
    count = {"flops": 2.0e9, "bytes accessed": 4.0e8}
    r = cost.roofline(count, seconds=0.5, invocations=10, platform="gpu",
                      device_name=H100)
    assert r["peak_source"] == "datasheet"
    assert (r["peak_flops"], r["peak_flops_f32"], r["peak_bw"]) == (
        989e12, 67e12, 3.35e12)
    assert r["arithmetic_intensity"] == 5.0
    assert r["achieved_flops"] == 4.0e10 and r["achieved_bw"] == 8.0e9
    assert r["mfu"] == 4.0e10 / 989e12
    assert r["mfu_f32"] == 4.0e10 / 67e12
    assert r["bw_util"] == 8.0e9 / 3.35e12
    static = cost.roofline(count, platform="gpu", device_name=H100)
    assert "mfu" not in static and static["invocations"] == 0
    # another card is not read against the H100's peaks
    other = cost.roofline(count, seconds=0.5, invocations=10,
                          platform="gpu", device_name="NVIDIA A100-SXM4-80GB")
    assert other["peak_source"] == "none" and other["peak_flops"] is None
    assert other["peak_device"] == "NVIDIA A100-SXM4-80GB"
    assert "mfu" not in other and "bw_util" not in other
    unnamed = cost.roofline(count, seconds=0.5, invocations=10,
                            platform="gpu")
    assert unnamed["peak_source"] == "none" and "mfu" not in unnamed
    cpu = cost.roofline(count, seconds=0.5, invocations=10, platform="cpu")
    assert cpu["peak_source"] == "none" and cpu["peak_flops"] is None
    assert "mfu" not in cpu and "bw_util" not in cpu
    assert cpu["achieved_flops"] == 4.0e10
    assert cost.roofline(None) is None and cost.roofline({}) is None
    assert cost.matmul_flops(3, 4, 5) == 120.0


def test_emit_mfu_sets_the_segment_gauges():
    reg = obs.reset_registry()
    roof = cost.roofline({"flops": 1e9, "bytes accessed": 1e6}, 1.0, 1,
                         "gpu", H100)
    cost.emit_mfu(2, roof)
    assert reg.get("sntc_mfu_ratio", segment="2") == roof["mfu"]
    assert reg.get("sntc_mfu_bw_ratio", segment="2") == roof["bw_util"]
    cost.emit_mfu(3, cost.roofline({"flops": 1e9}, 1.0, 1, "cpu"))
    assert reg.get("sntc_mfu_ratio", segment="3") is None


def test_cost_plane_is_opt_in(monkeypatch):
    monkeypatch.delenv("SNTC_OBS_COST_ANALYSIS", raising=False)
    assert not cost.enabled()
    monkeypatch.setenv("SNTC_OBS_COST_ANALYSIS", "1")
    assert cost.enabled()


def test_metrics_logger_writes_the_jax_loggers_records(tmp_path):
    recs = []
    for cls in (JLogger, MetricsLogger):
        path = str(tmp_path / cls.__module__ / "log.jsonl")
        lg = cls(path)
        lg.log(event="fit", loss=0.5)
        lg.log(event="eval", f1=0.9, rows=12)
        recs.append([{k: v for k, v in r.items() if k != "elapsed_s"}
                     for r in lg.read_all()])
        assert all(r["elapsed_s"] >= 0 for r in lg.read_all())
        cls(path)  # a new run truncates
        assert cls(path).read_all() == []
    assert recs[0] == recs[1]
    assert recs[1][1] == {"step": 1, "event": "eval", "f1": 0.9, "rows": 12}
    assert MetricsLogger().log(a=1)["step"] == 0
    assert MetricsLogger().read_all() == []


def _c6(n=600, d=10, k=4, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    X = rng.gamma(2.0, 3.0, size=(n, d)).astype(np.float32)
    cols = {f"c{i}": X[:, i] for i in range(d)}
    cols["label"] = (X[:, 0] > X[:, 1]).astype(np.float64)
    pm = Pipeline(stages=[
        VectorAssembler(inputCols=[f"c{i}" for i in range(d)],
                        outputCol="raw"),
        MinMaxScaler(device=device, inputCol="raw", outputCol="mm"),
        DCT(device=device, inputCol="mm", outputCol="dct"),
        PCA(device=device, inputCol="dct", outputCol="features", k=k),
        LogisticRegression(device=device, maxIter=10),
    ]).fit(Frame(cols))
    return Frame(cols).drop("label"), pm


def test_segment_counts_its_cost_from_the_bound_shapes(monkeypatch):
    monkeypatch.setenv("SNTC_OBS_COST_ANALYSIS", "1")
    reg = obs.reset_registry()
    frame, pm = _c6()
    fused = compile_pipeline(pm)
    pred = BatchPredictor(fused, bucket_rows=256, device="cpu")
    for _ in range(2):
        pred.predict_frame(frame.slice(0, 500))  # pads to 512
    stats = fusion_stats(fused)
    (sig, c), = stats["cost_analysis"].items()
    n, d, k = 512, 10, 4
    assert sig.startswith("segment0:")
    assert c["flops"] == 2.0 * n * (d * d + d * k + k * 2)
    # the bound [n, d] f32 input read once, the packed [n, 2K+1] f32
    # output written once
    assert c["bytes accessed"] == 4.0 * n * d + 4.0 * n * 5
    roof = stats["roofline"][sig]
    assert roof["invocations"] == 2 and roof["seconds"] > 0
    assert roof["peak_source"] == "none" and "mfu" not in roof
    assert reg.get("sntc_mfu_ratio", segment="0") is None  # no CPU peak


def test_no_cost_block_without_the_variable(monkeypatch):
    monkeypatch.delenv("SNTC_OBS_COST_ANALYSIS", raising=False)
    frame, pm = _c6(seed=1)
    fused = compile_pipeline(pm)
    BatchPredictor(fused, device="cpu").predict_frame(frame)
    stats = fusion_stats(fused)
    assert "cost_analysis" not in stats and "roofline" not in stats


def test_serve_command_writes_metrics_trace_and_device_trace(tmp_path,
                                                             capsys):
    from sntc_tpu_torch.app import main
    from sntc_tpu_torch.mlio import save_model

    frame, pm = _c6(seed=2)
    save_model(pm, str(tmp_path / "m"))
    watch = tmp_path / "in"
    watch.mkdir()
    import pyarrow.csv as pacsv

    for i, (a, b) in enumerate([(0, 256), (256, 400), (400, 600)]):
        pacsv.write_csv(frame.slice(a, b).to_arrow(),
                        str(watch / f"part_{i:04d}.csv"))
    paths = [str(tmp_path / "m.prom"), str(tmp_path / "t.json"),
             str(tmp_path / "dev")]
    # the command counts into the process registry: a fresh one, so the
    # series read below are this run's alone
    prev = obs.set_registry(MetricsRegistry())
    try:
        rc = main(["serve", "--model", str(tmp_path / "m"), "--watch",
                   str(watch), "--out", str(tmp_path / "out"),
                   "--checkpoint", str(tmp_path / "ckpt"),
                   "--shape-buckets", "256", "--max-files-per-batch", "1",
                   "--once", "--device", "cpu", "--metrics-out", paths[0],
                   "--trace-out", paths[1], "--device-trace", paths[2]])
    finally:
        obs.disable_tracing()
        obs.set_registry(prev)
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["batches"] == 3
    text = open(paths[0]).read()
    assert "# TYPE sntc_batches_committed_total counter" in text
    for line in text.splitlines():
        if line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    doc = json.load(open(paths[1]))
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    for span in ("stream.wal", "stream.read", "predict.dispatch",
                 "fuse.dispatch", "fuse.finalize", "sink.deliver",
                 "stream.commit"):
        assert names.count(span) == 3, span
    assert names.count("predict.bucket") == 2  # 144 and 200 rows pad
    assert names.count("ingest.parse") == 3  # one a file read
    samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if line and not line.startswith("#"))
    stats = summary["pipeline_stats"]
    assert (stats["compile_events"], stats["bucket_hits"],
            stats["padded_rows_total"]) == (1, 2, 112 + 56)
    for counter, name in (("compile_events", "compile_events_total"),
                          ("bucket_hits", "bucket_hits_total"),
                          ("padded_rows_total", "padded_rows_total")):
        assert float(samples[f"sntc_predict_{name}"]) == stats[counter]
    assert float(samples["sntc_fuse_compile_events_total"]) \
        == summary["fusion"]["compile_events"]
    assert float(samples['sntc_kernel_dispatch_total{impl="plain",'
                         'kernel="pad_assemble"}']) == 2
    dev = json.load(open(os.path.join(paths[2], "device_trace.json")))
    assert dev["traceEvents"]


def _counting(monkeypatch, module, name, counts, key):
    """Wrap ``module.name`` (a plain version) to count its calls."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        counts[key] = counts.get(key, 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


def test_serve_series_mirror_the_predictor_and_the_segment(monkeypatch):
    """A fused serve through a bucketed predictor counts the three
    ``sntc_predict_*`` series as the predictor's own ``compile_events``,
    ``bucket_hits`` and ``padded_rows_total``, the two ``sntc_fuse_*``
    series as the segments' ``compile_events`` and ``fallbacks`` (an
    empty batch serves eagerly), and one
    ``sntc_kernel_dispatch_total{kernel="pad_assemble", impl="plain"}``
    a plain pad on CPU tensors."""
    from sntc_tpu_torch.kernels import assemble

    frame, pm = _c6(seed=3)
    fused = compile_pipeline(pm)
    calls = {}
    _counting(monkeypatch, assemble, "pad_rows_reference", calls, "pad")
    prev = obs.set_registry(MetricsRegistry())
    try:
        pred = BatchPredictor(fused, bucket_rows=256, device="cpu")
        for a, b in [(0, 144), (144, 400), (400, 600), (0, 256), (0, 0)]:
            pred.predict_frame(frame.slice(a, b))
        reg = obs.registry()
    finally:
        obs.set_registry(prev)
    assert (pred.compile_events, pred.bucket_hits,
            pred.padded_rows_total) == (2, 3, 112 + 56)
    assert reg.get("sntc_predict_compile_events_total") \
        == pred.compile_events
    assert reg.get("sntc_predict_bucket_hits_total") == pred.bucket_hits
    assert reg.get("sntc_predict_padded_rows_total") \
        == pred.padded_rows_total
    stats = fusion_stats(fused)
    assert stats["compile_events"] >= 1 and stats["fallbacks"] == 1
    assert reg.get("sntc_fuse_compile_events_total") \
        == stats["compile_events"]
    assert reg.get("sntc_fuse_fallbacks_total") == stats["fallbacks"]
    assert calls["pad"] == 2
    assert reg.get("sntc_kernel_dispatch_total", kernel="pad_assemble",
                   impl="plain") == calls["pad"]
    assert reg.get("sntc_kernel_dispatch_total", kernel="pad_assemble",
                   impl="cuda") is None


def test_forest_fit_and_serve_count_plain_kernel_calls(monkeypatch):
    """A forest fit and a bucketed serve on CPU tensors count each plain
    version's calls into ``sntc_kernel_dispatch_total{impl="plain"}``
    under the kernel's ``LAUNCHES`` name, and no ``impl="cuda"``."""
    from sntc_tpu_torch.kernels import LAUNCHES, assemble, forest, histogram
    from sntc_tpu_torch.models import RandomForestClassifier

    rng = np.random.default_rng(7)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    y = ((X[:, 0] > 0) * 2 + (X[:, 3] > 0.2)).astype(np.float64)
    calls = {}
    _counting(monkeypatch, histogram, "tree_hist_reference", calls,
              "tree_hist")
    _counting(monkeypatch, forest, "forest_leaf_stats_reference", calls,
              "forest_traversal")
    _counting(monkeypatch, assemble, "pad_rows_reference", calls,
              "pad_assemble")
    prev = obs.set_registry(MetricsRegistry())
    try:
        model = RandomForestClassifier(device="cpu", numTrees=3,
                                       maxDepth=3, seed=0).fit(
            Frame({"features": X, "label": y}))
        pred = BatchPredictor(model, bucket_rows=256, device="cpu")
        pred.predict_frame(Frame({"features": X[:300]}))  # pads to 512
        reg = obs.registry()
    finally:
        obs.set_registry(prev)
    assert set(calls) == set(LAUNCHES)
    for kernel, n in calls.items():
        assert n >= 1, kernel
        assert reg.get("sntc_kernel_dispatch_total", kernel=kernel,
                       impl="plain") == n, kernel
        assert reg.get("sntc_kernel_dispatch_total", kernel=kernel,
                       impl="cuda") is None, kernel


def test_train_trace_spans_the_load_and_each_parse(tmp_path):
    """``train --trace-out`` writes one ``train.load_data`` span around
    the load and one ``ingest.parse`` span per CSV, named by its file,
    inside it, as the JAX command does."""
    from sntc_tpu_torch.app import main
    from sntc_tpu_torch.data import generate_frame, write_raw_csv

    data = tmp_path / "data"
    data.mkdir()
    for i in range(3):
        write_raw_csv(generate_frame(400, seed=20 + i, dirty=False),
                      str(data / f"day_{i}.csv"))
    trace = str(tmp_path / "t.json")
    try:
        rc = main(["train", "--data", str(data), "--estimator", "nb",
                   "--device", "cpu", "--trace-out", trace])
    finally:
        obs.disable_tracing()
    assert rc == 0
    spans = [e for e in json.load(open(trace))["traceEvents"]
             if e["ph"] == "X"]
    load = [e for e in spans if e["name"] == "train.load_data"]
    parses = [e for e in spans if e["name"] == "ingest.parse"]
    assert len(load) == 1
    assert sorted(e["args"]["file"] for e in parses) == [
        f"day_{i}.csv" for i in range(3)]
    start, end = load[0]["ts"], load[0]["ts"] + load[0]["dur"]
    for e in parses:
        assert start <= e["ts"] and e["ts"] + e["dur"] <= end


def test_train_writes_metrics_and_trace_when_it_fails(tmp_path):
    from sntc_tpu_torch.app import main

    prom, trace = str(tmp_path / "m.prom"), str(tmp_path / "t.json")
    (tmp_path / "empty").mkdir()
    try:
        with pytest.raises(Exception):
            main(["train", "--data", str(tmp_path / "empty"), "--device",
                  "cpu", "--metrics-out", prom, "--trace-out", trace])
    finally:
        obs.disable_tracing()
    assert os.path.exists(prom)
    assert json.load(open(trace))["traceEvents"] is not None


def _actions(parser, cmd):
    import argparse

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {opt: a for a in sub.choices[cmd]._actions
            for opt in a.option_strings}


@pytest.mark.parametrize("cmd", ["train", "serve"])
def test_obs_flags_are_the_jax_commands(cmd, monkeypatch):
    import argparse

    import sntc_tpu.app as jax_app
    from sntc_tpu_torch.app import build_parser

    class Parsed(Exception):
        pass

    def capture(self, argv=None, namespace=None):
        raise Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as caught:
        jax_app.main([cmd])
    monkeypatch.undo()
    jax_actions = _actions(caught.value.args[0], cmd)
    port_actions = _actions(build_parser(), cmd)
    for flag in ("--metrics-out", "--trace-out", "--device-trace"):
        p, j = port_actions[flag], jax_actions[flag]
        for attr in ("dest", "default", "type", "nargs", "metavar"):
            assert getattr(p, attr) == getattr(j, attr), (flag, attr)
        assert type(p) is type(j)
    assert port_actions["--trace-out"].help == jax_actions["--trace-out"].help
    assert "torch.profiler" in port_actions["--device-trace"].help


def test_port_cli_has_66_distinct_flags():
    # 66 after the obs flags; 76 since the capture, socket-ingress and
    # synth flags; 84 since serve-daemon's; 98 since replication's and
    # the fleet's, every JAX flag but the four never ported (the name is
    # kept from when the count was 66)
    import re

    import sntc_tpu.app as jax_app
    from sntc_tpu_torch import app

    pattern = r'add_argument\("(--[a-z0-9-]*)'
    port = set(re.findall(pattern, open(app.__file__).read()))
    jax = set(re.findall(pattern, open(jax_app.__file__).read()))
    assert len(port) == 98
    assert jax - port == {"--compile-budget-s", "--compile-cache",
                          "--compile-cache-dir", "--serve-kernels"}


def test_exports_cover_the_jax_package():
    assert set(sntc_tpu.__all__) <= set(sntc_tpu_torch.__all__)
    assert set(jax_ops.__all__) <= set(ops.__all__)
    assert set(jax_obs.__all__) <= set(obs.__all__)
    # the models, evaluators, selectors and ``stat`` ported so far
    ported = {
        (jax_models, models): {
            "ALS", "ALSModel", "BisectingKMeans", "BisectingKMeansModel",
            "GaussianMixture", "GaussianMixtureModel", "KMeans",
            "KMeansModel", "LDA", "LDAModel", "PowerIterationClustering",
            "LinearRegression", "LinearRegressionModel",
            "AFTSurvivalRegression", "AFTSurvivalRegressionModel",
            "IsotonicRegression", "IsotonicRegressionModel",
            "GeneralizedLinearRegression",
            "GeneralizedLinearRegressionModel", "FMClassifier",
            "FMClassificationModel", "FMRegressor", "FMRegressionModel",
        },
        (jax_evaluation, evaluation): {"ClusteringEvaluator"},
        (jax_feature, feature): {
            "UnivariateFeatureSelector", "UnivariateFeatureSelectorModel",
            "VarianceThresholdSelector", "VarianceThresholdSelectorModel",
            "OneHotEncoder", "OneHotEncoderModel", "VectorSlicer",
            "ElementwiseProduct", "PolynomialExpansion", "Interaction",
            "Bucketizer", "QuantileDiscretizer", "Imputer", "ImputerModel",
            "VectorIndexer", "VectorIndexerModel", "VectorSizeHint",
        },
    }
    for (jax_mod, mod), names in ported.items():
        assert names <= set(jax_mod.__all__) & set(mod.__all__)
        assert (set(jax_mod.__all__) & set(mod.__all__)) == (
            set(jax_mod.__all__) & set(dir(mod)))
    assert set(jax_stat.__all__) == set(stat.__all__)
    from sntc_tpu_torch import (  # noqa: F401
        Estimator, Frame, Model, Param, Params, Pipeline, PipelineModel,
        Transformer,
    )
    from sntc_tpu_torch.ops import (  # noqa: F401
        bin_features, binned_contingency, chi_square, quantile_bin_edges,
    )
    assert sntc_tpu_torch.Pipeline is Pipeline
    assert sntc_tpu_torch.PipelineModel is PipelineModel


@pytest.mark.cuda
def test_segment_roofline_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("SNTC_OBS_COST_ANALYSIS", "1")
    reg = obs.reset_registry()
    frame, pm = _c6(seed=3, device="cuda")
    fused = compile_pipeline(pm)
    pred = BatchPredictor(fused, bucket_rows=256, device="cuda")
    for _ in range(3):
        pred.predict_frame(frame.slice(0, 512))
    (roof,) = fusion_stats(fused)["roofline"].values()
    assert roof["peak_source"] == "datasheet" and roof["invocations"] == 3
    assert 0 < roof["mfu"] < 1 and 0 < roof["bw_util"] < 1
    assert reg.get("sntc_mfu_ratio", segment="0") == roof["mfu"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_65th_event_label_set_counts_into_overflow(pkg):
    """Both registries keep 64 label sets a metric: once a process has
    counted events under 64 (event, site, tenant) sets, a new set counts
    into ``overflow="true"`` and reads as absent.  The process's default
    registry outlives a test, so the reference test
    ``test_obs.py::test_bridge_counts_events_and_splits_tenant_sites``,
    which reads a new set from it, fails in a pytest worker whose earlier
    files counted 64 sets (ROADMAP queue C)."""
    if pkg == "jax":
        import sntc_tpu.obs.metrics as m
        from sntc_tpu.obs import install_event_metrics
        from sntc_tpu.resilience import emit_event
    else:
        import sntc_tpu_torch.obs.metrics as m
        from sntc_tpu_torch.obs import install_event_metrics
        from sntc_tpu_torch.resilience import emit_event
    install_event_metrics()  # as every entry point that emits does
    prev = m.set_registry(m.MetricsRegistry())
    try:
        for i in range(64):
            emit_event(event="retry", site=f"tenant/t{i}/sink.write",
                       attempt=1)
        reg = m.registry()
        assert reg.get("sntc_events_total", event="retry", site="sink.write",
                       tenant="t63") == 1
        assert reg.label_overflows() == 0
        emit_event(event="retry", site="tenant/z/sink.write", attempt=1)
        assert reg.get("sntc_events_total", event="retry", site="sink.write",
                       tenant="z") is None
        assert reg.get("sntc_events_total", overflow="true") == 1
        assert reg.label_overflows() == 1
    finally:
        m.set_registry(prev)


def test_the_jax_registry_guard_leaves_the_registry_it_found():
    """A JAX event emitted under ``jax_registry_of_its_own`` (what
    ``own_jax_registry`` runs around a module) counts into the guard's
    registry; the registry in place before is put back unchanged."""
    import sntc_tpu.obs.metrics as jm
    from jax_metrics_guard import jax_registry_of_its_own
    from sntc_tpu.obs import install_event_metrics
    from sntc_tpu.resilience import emit_event

    install_event_metrics()
    outer = jm.registry()
    before = outer.to_prometheus()
    with jax_registry_of_its_own() as mine:
        assert jm.registry() is mine and mine is not outer
        emit_event(event="retry", site="tenant/guard/sink.write", attempt=1)
        assert mine.get("sntc_events_total", event="retry",
                        site="sink.write", tenant="guard") == 1
    assert jm.registry() is outer
    assert outer.to_prometheus() == before
