"""The port's ``resilience/`` and ``obs/`` against the JAX package's, on
the CPU.

Every comparison drives both packages with the same inputs and checks
the outcomes equal, exactly (these modules hold no floating-point
arithmetic):

* ``SNTC_FAULTS``: the same strings parse to the same specs, arm the
  same sites, and the seeded ``prob`` draws fire on the same call
  indices (``tests/test_resilience.py::test_env_knob_arms_
  deterministically``); an injected DEVICE fault's message is PyTorch's
  error line and classifies through the same pattern as the real error;
* ``CircuitBreaker`` under a fake clock walks the same states and
  snapshots over one recorded sequence of allows, outcomes, releases
  and clock steps; ``HealthMonitor`` over one recorded event stream
  reaches the same component states, and its watchdog flags the same
  batches;
* ``classify_device_error`` on CUDA-shaped errors (the mapping table of
  ``resilience/device.py``), and None on user errors;
* the event ring's eviction counts, its observers, the metrics registry
  and the event bridge;
* ``DeviceFaultDomain``: DEVICE_FAILED after ``degrade_after`` faults in
  a row, a success ending the run;
* the supervisor's status keys are the JAX supervisor's.

The ``cuda`` cases run on the card: a real ``torch.cuda.
OutOfMemoryError`` classifies as ``device_oom``.
"""

import numpy as np
import pytest
import torch

import sntc_tpu.resilience as J
import sntc_tpu_torch.resilience as R
from sntc_tpu.obs import metrics as jmetrics
from sntc_tpu_torch.kernels._build import KernelBuildError, KernelLaunchError
from sntc_tpu_torch.obs import metrics as pmetrics
from sntc_tpu_torch.resilience import device as pdevice
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


# ---------------------------------------------------------------------------
# SNTC_FAULTS
# ---------------------------------------------------------------------------

FAULT_STRINGS = [
    "sink.write",
    "stream.read:timeout:0.5:11",
    "sink.write:io:0.3:7,stream.wal:exc:0.25:3",
    "device.dispatch:device_oom:0.3:7",
    " predict.compile:compile_error , device.dispatch:device_lost:1:0 ",
]


@pytest.mark.parametrize("raw", FAULT_STRINGS)
def test_faults_env_parses_as_the_jax_grammar(raw):
    assert R.parse_faults_env(raw) == J.parse_faults_env(raw)


@pytest.mark.parametrize("raw", [
    "a:b:c:d:e",
    ":exc",
    "s:nope",
    "s:exc:x",
    "s:exc:1.5",
    "s:exc:0.5:q",
])
def test_faults_env_rejects_as_the_jax_grammar(raw):
    with pytest.raises(ValueError) as jerr:
        J.parse_faults_env(raw)
    with pytest.raises(ValueError) as perr:
        R.parse_faults_env(raw)
    # same offending spec named; the kind lists differ where the port
    # has no DATA/IO kinds yet
    assert str(perr.value).split(":")[0] == str(jerr.value).split(":")[0]


def _fired_calls(pkg, site, n):
    """``(call index, builtin base of the raised error)`` per fault."""
    fired = []
    for i in range(n):
        try:
            pkg.fault_point(site)
        except Exception as e:
            base = next(k for k in (OSError, TimeoutError, RuntimeError)
                        if isinstance(e, k))
            fired.append((i, base.__name__))
    return fired


@pytest.mark.parametrize("raw,site", [
    ("stream.read:timeout:0.5:11", "stream.read"),
    ("sink.write:io:0.3:7", "sink.write"),
    ("device.dispatch:device_oom:0.3:7", "device.dispatch"),
    ("device.dispatch:device_lost:0.1:123", "device.dispatch"),
    ("stream.wal:exc:0.9:0", "stream.wal"),
])
def test_seeded_prob_draws_fire_on_the_same_calls(monkeypatch, raw, site):
    monkeypatch.setenv("SNTC_FAULTS", raw)
    jax_calls = _fired_calls(J, site, 200)
    port_calls = _fired_calls(R, site, 200)
    assert port_calls == jax_calls
    assert 0 < len(port_calls) < 200
    assert R.call_count(site) == J.call_count(site) == 200
    # the env string re-installs after clear(), restarting the sequence
    R.clear()
    assert _fired_calls(R, site, 200) == port_calls


def test_env_arms_every_site_of_a_multi_spec_string(monkeypatch):
    monkeypatch.setenv("SNTC_FAULTS",
                       "sink.write:io:1:0,stream.wal:exc:1:0")
    for site, err in (("sink.write", OSError), ("stream.wal", RuntimeError)):
        with pytest.raises(err):
            R.fault_point(site)
    R.fault_point("stream.read")  # not armed
    monkeypatch.setenv("SNTC_FAULTS", "s:bogus")
    R.fault_point("sink.write")  # malformed: warns, arms nothing


def test_arm_nth_call_and_times_as_jax():
    for pkg in (J, R):
        pkg.arm("sink.write", kind="io", after=1, times=1)
    assert _fired_calls(R, "sink.write", 5) == [(1, "OSError")]
    assert [i for i, _ in _fired_calls(J, "sink.write", 5)] == [1]
    events = R.recent_events(site="sink.write", event="fault_injected")
    assert [(e["kind"], e["call"]) for e in events] == [("io", 2)]


def test_kill_kind_parses(monkeypatch):
    assert R.parse_faults_env("stream.commit:kill") == [
        {"site": "stream.commit", "kind": "kill"}]


@pytest.mark.parametrize("kind", ["device_oom", "compile_error",
                                  "device_lost"])
def test_injected_device_fault_copies_the_pytorch_line(kind):
    R.arm("device.dispatch", kind)
    with pytest.raises(R.InjectedDeviceFault) as ei:
        R.fault_point("device.dispatch")
    err = ei.value
    assert err.device_kind == kind
    assert R.classify_device_error(err) == kind
    # without its tag, the message alone classifies through the pattern
    # a real error of that kind meets
    msg = str(err)
    if kind == "device_oom":
        assert msg.startswith("CUDA out of memory. Tried to allocate")
        real = torch.cuda.OutOfMemoryError(msg)
    else:
        assert msg.startswith("CUDA error: ")
        real = RuntimeError(msg)
    assert R.classify_device_error(real) == kind
    # the JAX package classifies its own injected fault to the same kind
    J.arm("device.dispatch", kind)
    with pytest.raises(J.InjectedDeviceFault) as jei:
        J.fault_point("device.dispatch")
    assert J.classify_device_error(jei.value) == kind


# ---------------------------------------------------------------------------
# classify_device_error
# ---------------------------------------------------------------------------

CLASSIFY_CASES = [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 40.00 MiB. GPU 0 has a "
        "total capacity of 79.19 GiB of which 12.00 MiB is free."),
     "device_oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered\n"
                  "CUDA kernel errors might be asynchronously reported"),
     "device_lost"),
    (RuntimeError("CUDA error: device-side assert triggered"),
     "device_lost"),
    (RuntimeError("CUDA error: unspecified launch failure"), "device_lost"),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                  "unavailable"), "device_lost"),
    (RuntimeError("CUDA error: no kernel image is available for execution "
                  "on the device"), "compile_error"),
    (RuntimeError("CUDA error: out of memory"), "device_oom"),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                  "`cublasCreate(handle)`"), "device_oom"),
    (KernelLaunchError("pad_assemble", 2, "out of memory"), "device_oom"),
    (KernelLaunchError("forest_traversal", 209,
                       "no kernel image is available"), "compile_error"),
    (KernelLaunchError("forest_traversal", 200,
                       "device kernel image is invalid"), "compile_error"),
    (KernelLaunchError("tree_hist", 218, "a PTX JIT compilation failed"),
     "compile_error"),
    (KernelLaunchError("pad_assemble", 700,
                       "an illegal memory access was encountered"),
     "device_lost"),
    (KernelLaunchError("pad_assemble", 710, "device-side assert"),
     "device_lost"),
    (KernelLaunchError("pad_assemble", 719, "unspecified launch failure"),
     "device_lost"),
    (KernelLaunchError("pad_assemble", 999, "unknown error"),
     "device_lost"),
    (KernelLaunchError("pad_assemble", 46, "busy or unavailable"),
     "device_lost"),
    (KernelLaunchError("pad_assemble", 1, "invalid argument"), None),
    (KernelBuildError("nvcc failed"), "compile_error"),
    (ValueError("cannot compile regex"), None),
    (ValueError("compilation failed: out of memory"), None),
    (RuntimeError("out of memory in my own code"), None),
    (OSError("illegal memory access"), None),
]


@pytest.mark.parametrize("exc,kind", CLASSIFY_CASES,
                         ids=[f"{type(e).__name__}-{i}"
                              for i, (e, _) in enumerate(CLASSIFY_CASES)])
def test_classify_device_error(exc, kind):
    assert R.classify_device_error(exc) == kind
    # wrapped, as the fused segment and the retry layer wrap it
    try:
        try:
            raise exc
        except Exception as e:
            raise R.RetryExhausted("sink.write", 2, e) from e
    except R.RetryExhausted as outer:
        assert R.classify_device_error(outer) == kind
    assert R.classify_device_error(None) is None


def test_kernel_launch_error_keeps_its_code_and_kernel():
    e = KernelLaunchError("pad_assemble", 700, "an illegal memory access")
    assert isinstance(e, RuntimeError)
    assert (e.kernel, e.cuda_error) == ("pad_assemble", 700)
    assert "CUDA error 700" in str(e)
    assert isinstance(KernelBuildError("x"), RuntimeError)


def test_device_exec_error_and_annotate_batch_as_jax():
    from sntc_tpu.resilience.device import annotate_batch as jannotate

    for pkg, annotate in ((J, jannotate), (R, R.annotate_batch)):
        err = pkg.DeviceExecError("boom", kind="device_lost", segment=0,
                                  signature="[(64, 78)]")
        assert pkg.classify_device_error(err) == "device_lost"
        e = ValueError("x")
        assert annotate(e, 7) is e and e.batch_id == 7
        assert any("batch 7" in n for n in e.__notes__)


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------


def _breaker_trace(mod, ops, **kw):
    clk = FakeClock()
    br = mod.CircuitBreaker("sink.write", clock=clk, **kw)
    trace = []
    for op, arg in ops:
        if op == "tick":
            clk.t += arg
            out = None
        elif op == "allow":
            out = br.allow()
        elif op == "ok":
            out = br.record_success()
        elif op == "fail":
            out = br.record_failure()
        elif op == "release":
            out = br.release()
        else:  # call
            try:
                br.call(arg)
                out = "called"
            except Exception as e:
                out = type(e).__name__
        trace.append((op, out, br.snapshot()))
    return trace


def _recorded_ops(seed, n=300):
    rng = np.random.default_rng(seed)
    names = ["allow", "ok", "fail", "fail", "tick", "release", "call_ok",
             "call_fail"]
    ops = []
    for i in range(n):
        name = names[int(rng.integers(len(names)))]
        if name == "tick":
            ops.append(("tick", float(rng.choice([0.5, 5.0, 31.0]))))
        elif name == "call_ok":
            ops.append(("call", lambda: 1))
        elif name == "call_fail":
            ops.append(("call", lambda: 1 / 0))
        else:
            ops.append((name, None))
    return ops


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {"window": 4, "failure_threshold": 1.0, "min_calls": 2,
         "cooldown_s": 60.0}),
    (2, {"window": 6, "failure_threshold": 0.3, "min_calls": 3,
         "cooldown_s": 5.0, "half_open_max_calls": 2}),
])
def test_breaker_walks_the_jax_states(seed, kw):
    ops = _recorded_ops(seed)
    port = _breaker_trace(R, ops, **kw)
    jax = _breaker_trace(J, ops, **kw)
    assert port == jax
    states = {snap["state"] for _, _, snap in port}
    assert states >= {"closed", "open"}


def test_breaker_registry_as_jax():
    for pkg in (J, R):
        a = pkg.breaker_for("reg.site", cooldown_s=1.0)
        assert pkg.breaker_for("reg.site") is a
        a.record_failure()
        assert "reg.site" in pkg.breakers_snapshot()
        pkg.reset_breakers()
        assert pkg.breakers_snapshot() == {}
    with pytest.raises(ValueError):
        R.CircuitBreaker("x", window=0)


def test_breaker_state_gauge():
    reg = pmetrics.reset_registry()
    br = R.CircuitBreaker("sink.write", window=1, min_calls=1)
    br.record_failure()
    assert reg.get("sntc_breaker_state", site="sink.write") == 2.0


# ---------------------------------------------------------------------------
# HealthMonitor
# ---------------------------------------------------------------------------

EVENT_NAMES = ["retry", "retry_success", "retry_exhausted", "quarantine",
               "breaker_open", "breaker_half_open", "breaker_closed",
               "watchdog_stall", "cv_cell_degraded", "fault_injected",
               "device_fault", "drained"]
SITES = ["sink.write", "stream.read", "predict.dispatch", None]


def _health_trace(mod, events):
    clk = FakeClock()
    h = mod.HealthMonitor(max_batch_wall_time=10.0, clock=clk)
    trace = []
    for i, rec in enumerate(events):
        clk.t += 1.5
        h.observe_event(rec)
        if i % 7 == 0:
            h.batch_started(i // 7)
        if i % 11 == 0:
            h.batch_finished(i // 11)
        flagged = h.check_watchdog()
        snap = h.snapshot()
        trace.append((flagged, snap["overall"], {
            k: (v["state"], v["reason"], v["since"])
            for k, v in snap["components"].items()
        }))
    return trace


def test_health_monitor_folds_the_jax_way():
    rng = np.random.default_rng(5)
    events = []
    for _ in range(120):
        rec = {"event": EVENT_NAMES[int(rng.integers(len(EVENT_NAMES)))]}
        site = SITES[int(rng.integers(len(SITES)))]
        if site is not None:
            rec["site"] = site
        else:
            rec["component"] = "engine"
        events.append(rec)
    assert _health_trace(R, events) == _health_trace(J, events)


def test_health_monitor_attach_detach_and_device_failed():
    before = R.event_observer_count()
    h = R.HealthMonitor().attach()
    assert R.event_observer_count() == before + 1
    R.emit_event(event="device_failed", component="model", reason="x")
    assert h.state_of("model") == R.HealthState.UNHEALTHY
    assert h.overall() == R.HealthState.UNHEALTHY
    h.close()
    h.close()
    assert R.event_observer_count() == before
    changed = R.recent_events(event="health_changed")
    assert [(e["component"], e["state"]) for e in changed] == [
        ("model", "UNHEALTHY")]


# ---------------------------------------------------------------------------
# the event ring, observers and the metrics plane
# ---------------------------------------------------------------------------


def test_event_ring_evictions_and_observers_as_jax():
    seen = []
    reg = pmetrics.reset_registry()
    for pkg in (J, R):
        pkg.add_event_observer(seen.append)
        for _ in range(600):
            pkg.emit_event(event="retry", site="s")
        pkg.remove_event_observer(seen.append)
    assert R.events_dropped() == J.events_dropped() == 600 - 512
    assert reg.get("sntc_events_dropped_total") == 600 - 512
    assert len(seen) == 1200
    assert len(R.recent_events()) == 512

    def bad(_rec):
        raise RuntimeError("observer bug")

    n = R.event_observer_count()
    R.add_event_observer(bad)
    R.emit_event(event="x")  # the raising observer is removed
    assert R.event_observer_count() == n
    R.clear_events()
    assert R.events_dropped() == 0


def test_metrics_registry_as_jax():
    preg = pmetrics.MetricsRegistry()
    jreg = jmetrics.MetricsRegistry()
    rng = np.random.default_rng(3)
    for reg in (preg, jreg):
        r = np.random.default_rng(3)
        for _ in range(50):
            reg.inc("sntc_batches_committed_total")
            reg.inc("sntc_rows_committed_total", float(r.integers(100)))
            reg.observe("sntc_batch_duration_seconds", float(r.uniform()))
            reg.set_gauge("sntc_breaker_state", int(r.integers(3)),
                          site="sink.write")
            reg.inc("sntc_device_faults_total", kind="device_oom",
                    site="device.dispatch")
    del rng
    psnap, jsnap = preg.snapshot(), jreg.snapshot()
    for name in psnap:
        assert psnap[name]["series"] == jsnap[name]["series"], name
        assert psnap[name]["type"] == jsnap[name]["type"]
    for name, spec in pmetrics.CATALOG.items():
        jspec = jmetrics.CATALOG[name]
        assert (spec["type"], spec["labels"]) == (jspec["type"],
                                                  jspec["labels"]), name
    with pytest.raises(KeyError):
        preg.inc("sntc_not_a_metric")
    with pytest.raises(KeyError):
        preg.inc("sntc_batches_committed_total", bogus="x")
    small = pmetrics.MetricsRegistry(max_label_sets=2)
    for s in ("a", "b", "c", "d"):
        small.inc("sntc_breaker_state", site=s)
    assert small.label_overflows() == 2
    assert small.get("sntc_breaker_state", overflow="true") == 2.0


def test_event_bridge_counts_events():
    from sntc_tpu_torch.obs import install_event_metrics

    install_event_metrics()
    reg = pmetrics.reset_registry()
    R.emit_event(event="retry", site="sink.write")
    R.emit_event(event="quarantine", site="stream.read")
    R.emit_event(event="drained", component="engine")
    assert reg.get("sntc_events_total", event="retry",
                   site="sink.write") == 1.0
    assert reg.get("sntc_events_total", event="quarantine",
                   site="stream.read") == 1.0
    assert reg.get("sntc_events_total", event="drained") == 1.0
    assert reg.get("sntc_batches_quarantined_total") == 1.0
    assert pmetrics.snapshot()["sntc_events_total"]["type"] == "counter"


# ---------------------------------------------------------------------------
# the device fault domain and the supervisor
# ---------------------------------------------------------------------------


def test_device_domain_fails_after_degrade_after_faults_in_a_row():
    reg = pmetrics.reset_registry()
    dom = R.DeviceFaultDomain(R.DevicePolicy(degrade_after=3))
    dom.note_fault("device_lost", site="device.dispatch")
    dom.note_fault("device_oom", site="device.dispatch")
    dom.note_success()  # a clean batch ends the run
    dom.note_fault("device_lost", site="device.dispatch")
    dom.note_fault("compile_error", site="predict.compile")
    assert not dom.failed
    dom.check()
    dom.note_fault("device_lost", site="device.dispatch")
    assert dom.failed and dom.state == "DEVICE_FAILED"
    with pytest.raises(R.DeviceExecError) as ei:
        dom.check()
    assert R.classify_device_error(ei.value) == "device_lost"
    s = dom.stats()
    assert s["faults"] == {"device_lost": 3, "device_oom": 1,
                           "compile_error": 1}
    assert s["consecutive_faults"] == 3
    assert reg.get("sntc_device_state") == 1.0
    assert reg.get("sntc_device_faults_total", kind="device_lost",
                   site="device.dispatch") == 3.0
    failed = R.recent_events(event="device_failed")
    assert len(failed) == 1 and failed[0]["component"] == "model"
    assert "site" not in failed[0]  # the model component, not a site
    # JAX's policy fields the port keeps, with the JAX defaults
    jp, pp = J.DevicePolicy(), R.DevicePolicy()
    for f in ("oom_split_depth", "bucket_floor_min", "floor_restore_after",
              "degrade_after"):
        assert getattr(pp, f) == getattr(jp, f), f


def test_release_frames_drops_a_failed_calls_locals():
    import weakref

    class Block:
        pass

    ref = []

    def dispatch():
        block = Block()
        ref.append(weakref.ref(block))
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    try:
        dispatch()
    except Exception as e:
        exc = e
    assert ref[0]() is not None  # the traceback holds the block
    pdevice.release_frames(exc)
    assert ref[0]() is None
    assert R.classify_device_error(exc) == "device_oom"


def test_supervisor_status_keys_are_the_jax_keys(tmp_path):
    from sntc_tpu.core.base import Transformer as JTransformer
    from sntc_tpu.core.frame import Frame as JFrame
    from sntc_tpu.serve import MemorySink as JMemorySink
    from sntc_tpu.serve import MemorySource as JMemorySource
    from sntc_tpu.serve import StreamingQuery as JStreamingQuery
    from sntc_tpu_torch.core.base import Transformer
    from sntc_tpu_torch.core.frame import Frame
    from sntc_tpu_torch.serve import MemorySink, MemorySource, StreamingQuery

    class PIdent(Transformer):
        def transform(self, f):
            return f

    class JIdent(JTransformer):
        def transform(self, f):
            return f

    x = np.arange(8.0)
    pq = StreamingQuery(PIdent(), MemorySource([Frame({"x": x})]),
                        MemorySink(), str(tmp_path / "p"), device="cpu",
                        breakers=R.default_breakers())
    jq = JStreamingQuery(JIdent(), JMemorySource([JFrame({"x": x})]),
                         JMemorySink(), str(tmp_path / "j"),
                         breakers=J.default_breakers())
    psup = R.QuerySupervisor(pq, health_json=str(tmp_path / "p.json"))
    jsup = J.QuerySupervisor(jq)
    try:
        assert psup.tick() == jsup.tick() == 1
        ps, js = psup.status(), jsup.status()
        assert set(ps) == set(js)
        assert set(ps["storage"]) == set(js["storage"])
        assert set(ps["storage"]["disk"]) == set(js["storage"]["disk"])
        assert set(ps["engine"]) == set(js["engine"])
        assert ps["engine"] == js["engine"]
        assert set(ps["breakers"]) == set(js["breakers"]) == {
            "sink.write", "predict.dispatch"}
        assert ps["health"]["overall"] == js["health"]["overall"] == "OK"
        assert (tmp_path / "p.json").exists()
    finally:
        psup.close()
        jsup.close()
    assert set(R.default_breakers()) == set(J.default_breakers())


@pytest.mark.cuda
def test_real_cuda_oom_classifies_as_device_oom():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a real CUDA OOM)")
    total = torch.cuda.get_device_properties(0).total_memory
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(4 * total, dtype=torch.uint8, device="cuda")
    assert R.classify_device_error(ei.value) == "device_oom"
    # and through a fused segment's wrapping
    wrapped = R.DeviceExecError("while dispatching", kind=None)
    wrapped.__cause__ = ei.value
    assert R.classify_device_error(wrapped) == "device_oom"
