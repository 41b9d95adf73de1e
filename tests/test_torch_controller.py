"""The port's SLO controller against the JAX package's, on the CPU.

* ``ServeController.step`` over the same seeded ``SloSignal`` sequences
  (and the same seeded ingest-tuner signals behind its delegation), with
  an injected wall clock, writes the same decisions and the same
  ``controller.jsonl`` in both packages;
* ``window_percentile`` is equal on random histograms, and
  ``LATENCY_BUCKETS`` (the p99's source) and the ladders are equal;
* a ``restart`` record over a journal the other package wrote is the one
  that package writes over it;
* the supervisor's single-stream wiring and ``controller_error``
  (``tests/test_controller.py:330``, ``:368``, the latter on the
  supervisor: the port has no daemon);
* the OOM responder and the controller moving one predictor's bucket
  floor behave as in the JAX package.
"""

import json
import os
import shutil

import numpy as np
import pytest

import sntc_tpu.obs.metrics as JM
import sntc_tpu.resilience as J
import sntc_tpu.serve.controller as JCtl
import sntc_tpu_torch.obs.metrics as PM
import sntc_tpu_torch.resilience as R
import sntc_tpu_torch.serve.controller as PCtl
from sntc_tpu.core.base import Transformer as JTransformer
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data.autotune import Signal as JSignal
from sntc_tpu.resilience.control import ControlPolicy as JControlPolicy
from sntc_tpu.serve import BatchPredictor as JBatchPredictor
from sntc_tpu.serve import MemorySink as JMemorySink
from sntc_tpu.serve import MemorySource as JMemorySource
from sntc_tpu.serve import StreamingQuery as JStreamingQuery
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data.autotune import Signal as PSignal
from sntc_tpu_torch.resilience.control import ControlPolicy
from sntc_tpu_torch.serve import (
    BatchPredictor,
    MemorySink,
    MemorySource,
    StreamingQuery,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("SNTC_FAULTS", raising=False)
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


class _PortIdentity(Transformer):
    def transform(self, frame):
        return frame


class _JaxIdentity(JTransformer):
    def transform(self, frame):
        return frame


def _engine(pkg, ckpt, n_frames=4, rows=8, predictor=None, depth=2):
    """A MemorySource engine of either package (identity model)."""
    port = pkg == "port"
    F = Frame if port else JFrame
    frames = [F({"x": np.arange(rows, dtype=np.float64) + 100 * b})
              for b in range(n_frames)]
    if port:
        model = predictor or _PortIdentity()
        return StreamingQuery(model, MemorySource(frames), MemorySink(),
                              ckpt, max_batch_offsets=1, device="cpu",
                              pipeline_depth=depth, overlap_sink=depth > 1)
    model = predictor or _JaxIdentity()
    return JStreamingQuery(model, JMemorySource(frames), JMemorySink(),
                           ckpt, max_batch_offsets=1, pipeline_depth=depth,
                           overlap_sink=depth > 1)


def _controller(pkg, ckpt, slo_kw, policy_kw=None, **kw):
    """A supervisor (no SLO of its own) and a controller built over it
    with an injected clock and wall."""
    port = pkg == "port"
    q = _engine(pkg, ckpt, **kw)
    clock = FakeClock()
    sup = (R if port else J).QuerySupervisor(q, clock=clock,
                                             max_pending_batches=6)
    mod = PCtl if port else JCtl
    policy = (ControlPolicy if port else JControlPolicy)(**(policy_kw or {}))
    ctl = mod.ServeController.for_supervisor(
        sup, mod.SloPolicy(**slo_kw), policy=policy, clock=clock,
        wall=lambda: 1234.5)
    return sup, ctl


def _slo_signals(mod, seed, n):
    """Seeded windows: latency violations with and without new shapes,
    throughput shortfalls under a backlog, shed bursts, compliant
    windows, in random runs."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        kind = int(rng.integers(5))
        for _ in range(int(rng.integers(1, 6))):
            j = float(rng.uniform(0.8, 1.2))
            base = dict(batches=4, rows=4000, rows_per_s=4000.0 * j,
                        p50_ms=20.0, p99_ms=40.0, backlog=0,
                        elapsed_s=1.0)
            if kind == 0:
                base.update(p99_ms=round(300.0 * j, 3), compile_events=2)
            elif kind == 1:
                base.update(p99_ms=round(250.0 * j, 3), compile_events=0)
            elif kind == 2:
                base.update(rows_per_s=500.0 * j, backlog=12)
            elif kind == 3:
                base.update(shed_offsets=8, shed_rate=0.6, backlog=20)
            out.append(mod.SloSignal(**base))
    return out[:n]


def _ingest_signals(cls, seed, n):
    rng = np.random.default_rng(seed + 100)
    return [cls(backlog=int(rng.integers(0, 10)),
                miss_rate=float(rng.choice([0.0, 0.3, 0.9])),
                queue_occupancy=float(rng.choice([0.0, 0.5, 1.0])),
                read_wait_s=0.4, parse_s=float(rng.choice([0.01, 0.45])),
                files_per_batch=int(rng.integers(1, 4)))
            for _ in range(n)]


def _journal(ckpt):
    path = os.path.join(ckpt, "controller.jsonl")
    if not os.path.exists(path):
        return []
    return [json.loads(line) for line in open(path)]


def _drive_step(pkg, tmp_path, seed, slo_kw, policy_kw):
    port = pkg == "port"
    mod = PCtl if port else JCtl
    ckpt = str(tmp_path / f"{pkg}_{seed}")
    sup, ctl = _controller(pkg, ckpt, slo_kw, policy_kw)
    try:
        t = ctl.targets[0]
        # bind the delegated tuner to the live knobs (the engine's
        # MemorySource has none: give it equal synthetic ones) and feed
        # it a seeded signal sequence
        pipeline = __import__(("sntc_tpu_torch" if port else "sntc_tpu")
                              + ".data.pipeline", fromlist=["Knob"])
        boxes = {"read_workers": {"v": 4}, "prefetch_batches": {"v": 2}}
        t.tuner._engine = t.engine
        t.tuner._knobs = {
            name: pipeline.Knob(name, (lambda b=b: b["v"]),
                                (lambda v, b=b: b.__setitem__("v", int(v))),
                                1, 8)
            for name, b in boxes.items()}
        ingest = iter(_ingest_signals(PSignal if port else JSignal, seed,
                                      400))
        t.tuner._signal = lambda engine: next(ingest)
        recs = [ctl.step({None: sig})
                for sig in _slo_signals(mod, seed, 120)]
        return ([r for r in recs if r is not None], ctl.guard.decisions,
                ctl.knob_values(), {k: b["v"] for k, b in boxes.items()},
                sorted(ctl.guard.frozen), ctl.slo_status(),
                {k: v for k, v in ctl.stats().items() if k != "journal"},
                _journal(ckpt), (sup.max_pending_batches, sup.shed_policy))
    finally:
        sup.close()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("slo_kw,policy_kw", [
    ({"slo_p99_ms": 100.0, "slo_min_rows_per_sec": 1000.0,
      "slo_max_shed_rate": 0.2}, {}),
    ({"slo_p99_ms": 100.0, "slo_min_rows_per_sec": 1000.0},
     {"confirm": 1, "cooldown": 0}),
    ({"slo_min_rows_per_sec": 1000.0, "slo_max_shed_rate": 0.2},
     {"confirm": 1, "cooldown": 0, "max_reversals": 1}),
])
def test_step_journals_equal_across_packages(tmp_path, seed, slo_kw,
                                              policy_kw):
    jax = _drive_step("jax", tmp_path, seed, slo_kw, policy_kw)
    port = _drive_step("port", tmp_path, seed, slo_kw, policy_kw)
    assert port == jax
    assert jax[0] and jax[7]  # decisions were taken and journaled


def test_constants_equal():
    for name in ("SERVE_KNOB_NAMES", "SLO_FIELDS", "SHAPE_BUCKET_FLOORS",
                 "QUOTA_FACTORS", "SHED_LADDER", "SERVE_KNOB_BOUNDS"):
        assert getattr(PCtl, name) == getattr(JCtl, name), name
    assert PM.LATENCY_BUCKETS == JM.LATENCY_BUCKETS
    for name in [n for n in JM.CATALOG
                 if n.startswith(("sntc_ctl_", "sntc_ingest_"))
                 or n in ("sntc_shed_offsets_total",
                          "sntc_batch_duration_seconds")]:
        if name.startswith("sntc_ingest_") and name not in PM.CATALOG:
            continue
        spec, jspec = PM.CATALOG[name], JM.CATALOG[name]
        assert (spec["type"], spec["labels"], spec.get("buckets")) == (
            jspec["type"], jspec["labels"], jspec.get("buckets")), name
    ingest = {n for n in JM.CATALOG if n.startswith("sntc_ingest_")
              and "ingress" not in n}
    assert ingest <= set(PM.CATALOG)


@pytest.mark.parametrize("seed", range(20))
def test_window_percentile_equal(seed):
    rng = np.random.default_rng(seed)
    bounds = list(PM.LATENCY_BUCKETS)
    counts = [int(c) for c in rng.integers(0, 5, len(bounds) + 1)
              * (rng.random(len(bounds) + 1) < 0.5)]
    for q in (1, 50, 90, 99, 99.9, 100):
        assert PCtl.window_percentile(bounds, counts, q) == \
            JCtl.window_percentile(bounds, counts, q)


def test_slo_policy_validation_equal():
    for kw in ({"slo_p99_ms": 0}, {"slo_max_shed_rate": 0.5},
               {"slo_min_rows_per_sec": 10.0}):
        assert PCtl.SloPolicy(**kw).as_dict() == JCtl.SloPolicy(
            **kw).as_dict()
    for bad in ({"slo_p99_ms": -1.0}, {"slo_max_shed_rate": 1.5}):
        for mod in (PCtl, JCtl):
            with pytest.raises(ValueError):
                mod.SloPolicy(**bad)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restart_record_over_the_other_packages_journal(tmp_path, writer):
    """A journal one package wrote (decisions that moved knobs, a torn
    record) reconciled by each: the same ``restart`` record."""
    slo = {"slo_p99_ms": 100.0}
    src = str(tmp_path / "written")
    sup, ctl = _controller(writer, src, slo, {"confirm": 1, "cooldown": 0})
    mod = PCtl if writer == "port" else JCtl
    for _ in range(6):
        ctl.step({None: mod.SloSignal(p99_ms=400.0, compile_events=1,
                                      batches=2, rows=10, elapsed_s=1.0)})
    sup.close()
    with open(os.path.join(src, "controller.jsonl"), "a") as f:
        f.write('{"action": "appl\n')  # a torn record
    records = {}
    for reader in ("jax", "port"):
        ckpt = str(tmp_path / f"read_by_{reader}")
        shutil.copytree(src, ckpt)
        sup, _ctl = _controller(reader, ckpt, slo)
        sup.close()
        records[reader] = _journal_tail(ckpt)
    assert records["port"] == records["jax"]
    rec = records["jax"]
    # the engine's construction-time scan repaired the torn record
    # first, in both packages
    assert rec["action"] == "restart" and rec["torn_lines"] == 0
    for reader in ("jax", "port"):
        assert os.path.exists(tmp_path / f"read_by_{reader}"
                              / "storage_repair.jsonl")
    assert rec["journal_knobs"]["shape_buckets"] > 0
    assert rec["delta"]["shape_buckets"]["live"] == 0


def _journal_tail(ckpt):
    lines = open(os.path.join(ckpt, "controller.jsonl")).read().splitlines()
    return json.loads(lines[-1])


def test_supervisor_single_stream_slo_wiring(tmp_path):
    """``tests/test_controller.py:330`` on the port: any declared SLO
    arms the controller over the one engine; status and --health-json
    gain the slo and controller blocks, the single-stream knob set
    resolves, the drain marker holds the final knobs."""
    q = StreamingQuery(_PortIdentity(), MemorySource(
        [Frame({"x": np.arange(8.0) + 100 * b}) for b in range(4)]),
        MemorySink(), str(tmp_path / "ckpt"), max_batch_offsets=1,
        device="cpu", overlap_sink=False)  # the JAX engine's default
    clock = FakeClock()
    sup = R.QuerySupervisor(q, health_json=str(tmp_path / "health.json"),
                            clock=clock,
                            slo=PCtl.SloPolicy(slo_min_rows_per_sec=1e9))
    try:
        assert sup.controller is not None
        knobs = sup.controller.knob_values()
        assert set(knobs) == {"pipeline_depth", "shape_buckets", "shed"}
        for _ in range(6):
            clock.t += 1.0
            sup.tick()
        status = sup.status()
        assert status["slo"]["_"]["declared"]["slo_min_rows_per_sec"] \
            == 1e9
        assert status["controller"]["windows"] >= 4
        assert q.pipeline_depth > 2 or status["controller"]["applied"] >= 1
        dumped = json.load(open(tmp_path / "health.json"))
        assert "slo" in dumped and "controller" in dumped
        assert dumped["shed_total_offsets"] == 0
        final = sup.drain_now("test")
        assert final["drained"]
        marker = json.load(open(tmp_path / "ckpt" / "drain_marker.json"))
        assert marker["controller_knobs"] is not None
    finally:
        sup.close()


def test_health_json_keys_equal_across_packages(tmp_path):
    """The status dump of a controlled, shedding supervisor has the JAX
    package's keys, block by block (the port adds none)."""
    keys = {}
    for pkg in ("jax", "port"):
        q = _engine(pkg, str(tmp_path / f"ckpt_{pkg}"), n_frames=12)
        mod = PCtl if pkg == "port" else JCtl
        sup = (R if pkg == "port" else J).QuerySupervisor(
            q, max_pending_batches=2, slo=mod.SloPolicy(slo_p99_ms=50.0),
            clock=FakeClock())
        try:
            for _ in range(4):
                sup.tick()
            st = sup.status()
        finally:
            sup.close()
        keys[pkg] = {"top": set(st) - {"device", "lifecycle"},
                     "slo": set(st["slo"]["_"]),
                     "controller": set(st["controller"]),
                     "engine": set(st["engine"])}
        assert st["shed_total_offsets"] > 0
    assert keys["port"] == keys["jax"]


def test_controller_error_degrades_never_kills(tmp_path):
    """``tests/test_controller.py:368`` on the supervisor: a controller
    that raises emits controller_error and the round still commits."""
    q = StreamingQuery(_PortIdentity(), MemorySource(
        [Frame({"x": np.arange(8.0)}) for _ in range(3)]), MemorySink(),
        str(tmp_path / "ckpt"), max_batch_offsets=1, device="cpu",
        pipeline_depth=1)
    sup = R.QuerySupervisor(q, clock=FakeClock(),
                            slo=PCtl.SloPolicy(slo_p99_ms=10.0))

    def _boom():
        raise RuntimeError("controller bug")

    sup.controller.on_tick = _boom
    try:
        assert sup.tick() >= 1
        assert sup.tick() >= 1
        events = R.recent_events(event="controller_error")
        assert events and "controller bug" in events[-1]["error"]
        assert sup.batches_done >= 2
    finally:
        sup.close()


def _pframe(n):
    return Frame({"a": np.arange(float(n)), "b": np.arange(float(n)) * 2})


def _jframe(n):
    return JFrame({"a": np.arange(float(n)), "b": np.arange(float(n)) * 2})


def _floor_run(pkg, tmp_path):
    """The controller raises the bucket floor, an OOM steps it down, and
    clean dispatches restore the predictor's cold floor; the journal of
    every move."""
    port = pkg == "port"
    if port:
        dom = R.DeviceFaultDomain(R.DevicePolicy(floor_restore_after=3))
        pred = BatchPredictor(_PortIdentity(), bucket_rows=0, device="cpu",
                              device_domain=dom)
    else:
        dom = J.DeviceFaultDomain(
            J.DevicePolicy(probe_interval_s=0.0, floor_restore_after=3),
            probe_fn=lambda: True, probe_async=False)
        pred = JBatchPredictor(_JaxIdentity(), bucket_rows=0,
                               device_domain=dom)
    frame = _pframe if port else _jframe
    sup, ctl = _controller(pkg, str(tmp_path / pkg), {"slo_p99_ms": 10.0},
                           {"confirm": 1, "cooldown": 0}, predictor=pred)
    mod = PCtl if port else JCtl
    floors = []
    try:
        for _ in range(6):  # three raises: 0 -> 64 -> 128 -> 256
            ctl.step({None: mod.SloSignal(p99_ms=90.0, compile_events=1,
                                          batches=1, rows=8, elapsed_s=1.0)})
        floors.append(pred.bucket_rows)
        (R if port else J).arm("device.dispatch", "device_oom", times=1)
        out = pred.predict_frame(frame(300))
        assert out.num_rows == 300
        floors.append(pred.bucket_rows)  # stepped down once
        for n in (5, 7, 9):
            pred.predict_frame(frame(n))
        floors.append(pred.bucket_rows)  # the cold floor, restored
        return (floors, ctl.knob_values(),
                [{k: d[k] for k in d if k != "ts"} for d in dom.journal],
                pred.compile_events)
    finally:
        sup.close()


def test_oom_responder_and_controller_move_one_floor_as_jax(tmp_path):
    """Both owners of the bucket floor act on one predictor, as in the
    JAX package: the controller's raises set it, the OOM responder halves
    it and, after ``floor_restore_after`` clean dispatches, restores the
    predictor's cold floor while the controller's knob keeps its ladder
    index (the two packages agree move for move)."""
    jax = _floor_run("jax", tmp_path)
    port = _floor_run("port", tmp_path)
    assert port == jax
    floors, knobs, journal, _compiles = port
    assert floors == [256, 128, 0]
    assert knobs["shape_buckets"] == 3
    assert [d["decision"] for d in journal] == [
        "device_oom_split", "bucket_floor_down", "bucket_floor_restored"]


# ---------------------------------------------------------------------------
# the daemon half: for_daemon, attach/detach, the weight, quota and
# escalate rungs (tests/test_controller.py:144, :184, :223, :284, :399)
# ---------------------------------------------------------------------------


def _daemon(pkg, root, specs_kw, clock, policy_kw=None, wall=1234.5,
            **ctl_kw):
    """A daemon of either package over identity MemorySource tenants
    (``specs_kw``: tenant id -> (frames, spec keywords)) and a controller
    built over it with the injected clock and wall."""
    import sntc_tpu.serve.tenancy as JT
    import sntc_tpu_torch.serve.tenancy as PT

    port = pkg == "port"
    T, F = (PT, Frame) if port else (JT, JFrame)
    specs = [T.TenantSpec(
        tenant_id=tid, model=_PortIdentity() if port else _JaxIdentity(),
        source=(MemorySource if port else JMemorySource)(
            [F({"x": np.arange(8, dtype=np.float64) + 100 * b})
             for b in range(n)]),
        sink=(MemorySink if port else JMemorySink)(), max_batch_offsets=1,
        **kw) for tid, (n, kw) in specs_kw.items()]
    d = T.ServeDaemon(specs, root, clock=clock,
                      **({"device": "cpu"} if port else {}))
    mod = PCtl if port else JCtl
    policy = (ControlPolicy if port else JControlPolicy)(
        **(policy_kw or {"confirm": 1, "cooldown": 0}))
    d.controller = mod.ServeController.for_daemon(
        d, policy=policy, wall=lambda: wall, **ctl_kw)
    return d, mod


def _strip_latency(records):
    """Journal records without the measured latencies (wall-clock batch
    durations, not equal across two runs)."""
    out = []
    for r in records:
        r = dict(r)
        if isinstance(r.get("signal"), dict):
            r["signal"] = {k: v for k, v in r["signal"].items()
                           if k not in ("p50_ms", "p99_ms")}
        out.append(r)
    return out


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_daemon_windowed_p99_from_registry_deltas(tmp_path, pkg):
    """A tenant's window p50/p99 come from its own labelled bucket deltas
    (``tests/test_controller.py:144``)."""
    clock = FakeClock()
    d, _mod = _daemon(pkg, str(tmp_path / "root"),
                      {"a": (0, {"slo_p99_ms": 100.0})}, clock,
                      ingest=False)
    observe = (PM if pkg == "port" else JM).observe
    try:
        for v in [0.004] * 6 + [0.2] * 4:
            observe("sntc_batch_duration_seconds", v, tenant="a")
        clock.t += 2.0
        t = d.controller.targets[0]
        sig = d.controller._window_signal(t, clock.t)
        assert (sig.p50_ms, sig.p99_ms) == (5.0, 250.0)
        clock.t += 2.0
        sig2 = d.controller._window_signal(t, clock.t)
        assert sig2.p50_ms is None and sig2.p99_ms is None
    finally:
        d.close()


def test_remove_tenant_detaches_controller_target(tmp_path):
    """``tests/test_controller.py:184``: ``remove_tenant`` detaches its
    target and knobs; the loop goes on over the survivor."""
    got = {}
    for pkg in ("jax", "port"):
        clock = FakeClock()
        d, _mod = _daemon(pkg, str(tmp_path / pkg),
                          {"a": (2, {}), "b": (2, {})}, clock, ingest=False)
        try:
            clock.t += 1.0
            d.tick()
            before = sorted(t.key for t in d.controller.targets)
            summary = d.remove_tenant("a", drain=True, reason="moved")
            clock.t += 2.0
            d.controller.on_tick()
            d.tick()
            got[pkg] = (before, summary,
                        [t.key for t in d.controller.targets],
                        d.controller.knob_values())
        finally:
            d.close()
    assert got["port"] == got["jax"]
    assert got["port"][2] == ["b"]
    assert not any(n.startswith("a/") for n in got["port"][3])


def test_controller_e2e_three_tenants_one_violator_equal(tmp_path):
    """``tests/test_controller.py:223``: a throughput violator gets its
    own pipeline deepened, its neighbours' knobs never move, and the
    decisions, the journal, the status blocks and the drain markers'
    knobs are equal across the packages."""
    got = {}
    for pkg in ("jax", "port"):
        clock = FakeClock()
        root = str(tmp_path / pkg)
        d, _mod = _daemon(pkg, root, {
            "v": (8, {"slo_min_rows_per_sec": 1e9}),
            "n1": (2, {"slo_p99_ms": 60_000.0}),
            "n2": (2, {}),
        }, clock, ingest=False)
        try:
            for _ in range(8):
                clock.t += 1.0
                d.tick()
            st = d.status()
            d.drain()
            with open(os.path.join(root, "tenant", "v",
                                   "drain_marker.json")) as f:
                marker = json.load(f)["controller_knobs"]
            with open(os.path.join(root, "daemon_drain_marker.json")) as f:
                dm = json.load(f)["controller_knobs"]
            got[pkg] = (_strip_latency(d.controller.guard.decisions),
                        {k: v for k, v in st["controller"].items()
                         if k not in ("journal", "recent")},
                        {t: {k: v for k, v in s.items() if k != "window"}
                         for t, s in st["slo"].items()},
                        marker, dm, _strip_latency(_journal(root)))
        finally:
            d.close()
    assert got["port"] == got["jax"]
    knobs = got["port"][1]["knobs"]
    assert knobs["v/pipeline_depth"] > 1
    assert got["port"][3]["pipeline_depth"] > 1
    applied = [r for r in got["port"][0] if r["action"] == "applied"]
    assert applied and all(r["knob"].startswith("v/") for r in applied)


def test_flooding_violator_walks_degradation_ladder_equal(tmp_path):
    """``tests/test_controller.py:284``: a shed-rate violator is degraded
    on its own knobs, quota, then shed, then escalate (real ladder
    strikes); the quiet tenant's knobs never move; equal across the
    packages."""
    got = {}
    for pkg in ("jax", "port"):
        clock = FakeClock()
        d, mod = _daemon(pkg, str(tmp_path / pkg), {
            "noisy": (0, {"slo_max_shed_rate": 0.05,
                          "quarantine_after": 2}),
            "quiet": (0, {"slo_p99_ms": 60_000.0}),
        }, clock, ingest=False)
        flooding = mod.SloSignal(batches=2, rows=16, rows_per_s=16.0,
                                 shed_offsets=20, shed_rate=0.9, backlog=30,
                                 elapsed_s=1.0)
        quiet = mod.SloSignal(batches=2, rows=16, rows_per_s=16.0,
                              p99_ms=5.0, elapsed_s=1.0)
        try:
            recs = [d.controller.step({"noisy": flooding, "quiet": quiet})
                    for _ in range(24)]
            noisy = d._by_id["noisy"]
            got[pkg] = ([r for r in recs if r is not None],
                        d.controller.escalations_total, noisy.strikes,
                        noisy.state, noisy.spec.max_rows_per_sec,
                        (noisy.spec.max_pending_batches,
                         noisy.spec.shed_policy),
                        d.controller.knob_values(),
                        _journal(str(tmp_path / pkg)))
        finally:
            d.close()
    assert got["port"] == got["jax"]
    seen = [r["knob"] for r in got["port"][0] if r["action"] == "applied"]
    assert seen[0] == "noisy/quota"
    first = {k: seen.index(k) for k in dict.fromkeys(seen)}
    assert first["noisy/quota"] < first["noisy/shed"] < \
        first["noisy/escalate"]
    assert got["port"][1] >= 1
    assert all(k.startswith("noisy/") for k in seen)


def _daemon_signals(mod, seed, n):
    """Seeded windows for three tenants: floods, latency and throughput
    violations, compliant windows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        win = {}
        for tid in ("a", "b", "c"):
            kind = int(rng.integers(4))
            j = float(rng.uniform(0.8, 1.2))
            base = dict(batches=4, rows=4000, rows_per_s=4000.0 * j,
                        p50_ms=20.0, p99_ms=40.0, backlog=0, elapsed_s=1.0)
            if kind == 0:
                base.update(shed_offsets=8, shed_rate=0.6, backlog=20)
            elif kind == 1:
                base.update(p99_ms=round(300.0 * j, 3))
            elif kind == 2:
                base.update(rows_per_s=500.0 * j, backlog=12)
            win[tid] = mod.SloSignal(**base)
        out.append(win)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_daemon_step_journals_equal_across_packages(tmp_path, seed):
    """Seeded multi-tenant windows through ``step``: the same decisions
    (weight, quota, shed, escalate, depth), strikes and journal in both
    packages."""
    got = {}
    for pkg in ("jax", "port"):
        clock = FakeClock()
        slo = {"slo_p99_ms": 100.0, "slo_min_rows_per_sec": 1000.0,
               "slo_max_shed_rate": 0.2, "quarantine_after": 50}
        d, mod = _daemon(pkg, str(tmp_path / pkg),
                         {t: (0, dict(slo)) for t in ("a", "b", "c")},
                         clock, ingest=False)
        try:
            recs = [d.controller.step(w)
                    for w in _daemon_signals(mod, seed, 80)]
            got[pkg] = ([r for r in recs if r is not None],
                        d.controller.knob_values(),
                        {t.spec.tenant_id: (t.strikes, t.spec.weight,
                                            t.spec.max_rows_per_sec)
                         for t in d.tenants},
                        d.controller.slo_status(),
                        _journal(str(tmp_path / pkg)))
        finally:
            d.close()
    assert got["port"] == got["jax"]
    assert got["port"][0]


def test_daemon_restart_reconciles_the_journal(tmp_path):
    """A second daemon over the same root writes the ``restart`` record
    against its cold knobs, as the JAX package does."""
    got = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        for _ in range(2):
            clock = FakeClock()
            d, mod = _daemon(pkg, root, {
                "noisy": (0, {"slo_max_shed_rate": 0.05}),
                "quiet": (0, {})}, clock, ingest=False)
            sig = mod.SloSignal(batches=2, rows=16, rows_per_s=16.0,
                                shed_offsets=20, shed_rate=0.9,
                                backlog=30, elapsed_s=1.0)
            try:
                for _ in range(3):
                    d.controller.step({"noisy": sig})
            finally:
                d.close()
        got[pkg] = _journal(root)
    assert got["port"] == got["jax"]
    restarts = [r for r in got["port"] if r["action"] == "restart"]
    assert len(restarts) == 1 and restarts[0]["delta"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_daemon_controller_error_degrades_never_kills(tmp_path, pkg):
    """``tests/test_controller.py:399``: a controller raising inside the
    daemon's round emits controller_error; the round still commits."""
    clock = FakeClock()
    d, _mod = _daemon(pkg, str(tmp_path / "root"), {"a": (3, {})}, clock,
                      ingest=False)

    def _boom():
        raise RuntimeError("controller bug")

    d.controller.on_tick = _boom
    try:
        clock.t += 1.0
        assert d.tick() >= 1
        events = (R if pkg == "port" else J).recent_events(
            event="controller_error")
        assert events and "controller bug" in events[-1]["error"]
    finally:
        d.close()
