"""The port's multi-tenant serve daemon against the JAX package's, on the
CPU: the counterparts of ``tests/test_tenancy.py``.

Every case runs both packages on the same inputs and holds the results
equal, bitwise (both sides are numpy on the host here):

* the scheduling sequence of ``tick()`` under an injected clock (weights,
  rate quotas and their refill, the deferring tenant that banks no
  deficit), the backlog shed journal, the ladder walk of a noisy tenant,
  strikes attributed by tag and by namespaced site, and an engine error
  that strikes its tenant and never the daemon;
* the drain markers' bytes (time stamps and the pid pinned);
* ``TenantSpec``'s validation messages and duplicate ids;
* ``reset_breakers(prefix=)``, ``events_dropped(by_tenant=True)`` and
  the namespaced ``fault_point``;
* the shared predictor's ledger, from the daemon and from three threads;
* event-observer counts across 50 monitor lifecycles and daemon
  teardowns (a failed ``__init__`` too);
* the two chaos scenarios of ``scripts/chaos_crash_matrix.py`` (a kill at
  ``tenant/t1/stream.wal`` and a restart; ``tenant/t1/sink.write``
  failing for good) run against port worker processes, their commits and
  sink rows held to the JAX worker's unkilled run;
* the ``serve-daemon`` parsers' defaults, and each package's ``fsck
  --tenant-tree`` over the other's daemon root;
* the port's answer to a failed device domain (no host fallback): the
  daemon drains, strikes no tenant, and the command exits 1.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sntc_tpu.resilience as J
import sntc_tpu.serve.tenancy as JT
import sntc_tpu_torch.resilience as R
import sntc_tpu_torch.serve.tenancy as PT
from sntc_tpu.core.base import Transformer as JTransformer
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.serve import BatchPredictor as JBatchPredictor
from sntc_tpu.serve import MemorySink as JMemorySink
from sntc_tpu.serve import MemorySource as JMemorySource
from sntc_tpu.serve import StreamingQuery as JStreamingQuery
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.resilience.faults import KILL_EXIT_CODE
from sntc_tpu_torch.serve import (
    BatchPredictor,
    MemorySink,
    MemorySource,
    StreamingQuery,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


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


def _pkg(name):
    """One package's classes, and the keyword its engines take."""
    if name == "jax":
        return SimpleNamespace(
            name="jax", R=J, T=JT, Frame=JFrame, Identity=_JaxIdentity,
            MemorySink=JMemorySink, MemorySource=JMemorySource,
            StreamingQuery=JStreamingQuery, BatchPredictor=JBatchPredictor,
            dev={})
    return SimpleNamespace(
        name="torch", R=R, T=PT, Frame=Frame, Identity=_PortIdentity,
        MemorySink=MemorySink, MemorySource=MemorySource,
        StreamingQuery=StreamingQuery, BatchPredictor=BatchPredictor,
        dev={"device": "cpu"})


PKGS = ("jax", "torch")


def _frames(P, n_batches, rows=8, base=0):
    return [
        P.Frame({"x": np.arange(rows, dtype=np.float64) + 100 * b + base})
        for b in range(n_batches)
    ]


def _sink_class(P, failing=False):
    class _FailingSink(P.MemorySink):
        def add_batch(self, batch_id, frame):
            raise IOError("sink volume down")

    return _FailingSink if failing else P.MemorySink


def _spec(P, tid, frames, sink=None, model=None, **kw):
    return P.T.TenantSpec(
        tenant_id=tid,
        model=model if model is not None else P.Identity(),
        source=P.MemorySource(frames),
        sink=sink if sink is not None else P.MemorySink(),
        **kw,
    )


def _daemon(P, root, specs, **kw):
    return P.T.ServeDaemon(specs, str(root), **P.dev, **kw)


def _xs(sink):
    return [np.asarray(f["x"]).tolist() for f in sink.frames]


# ---------------------------------------------------------------------------
# observers and breakers across lifecycles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_observer_count_flat_across_50_monitor_lifecycles(pkg):
    P = _pkg(pkg)
    base = P.R.event_observer_count()
    for _ in range(50):
        P.R.HealthMonitor().attach().close()
    assert P.R.event_observer_count() == base
    m = P.R.HealthMonitor().attach().attach()
    assert P.R.event_observer_count() == base + 1
    m.close()
    m.close()
    assert P.R.event_observer_count() == base


@pytest.mark.parametrize("pkg", PKGS)
def test_daemon_close_detaches_monitor_and_strike_observer(tmp_path, pkg):
    P = _pkg(pkg)
    base = P.R.event_observer_count()
    for _ in range(5):
        d = _daemon(P, tmp_path / "root", [_spec(P, "a", _frames(P, 1))])
        assert P.R.event_observer_count() == base + 2  # health + strikes
        d.close()
    assert P.R.event_observer_count() == base


def test_daemon_init_failure_detaches_observer_and_evicts(tmp_path):
    """A spec that raises out of ``__init__`` leaks neither the
    monitor's observer nor an earlier good tenant's breakers, in both
    packages, with the same message."""
    msgs = {}
    for pkg in PKGS:
        P = _pkg(pkg)
        base = P.R.event_observer_count()
        good = _spec(P, "good", _frames(P, 1))
        bad = P.T.TenantSpec(tenant_id="bad", model=P.Identity())
        with pytest.raises(ValueError, match="source") as exc:
            _daemon(P, tmp_path / pkg, [good, bad])
        msgs[pkg] = str(exc.value)
        assert P.R.event_observer_count() == base
        assert not any(site.startswith("tenant/good/")
                       for site in P.R.breakers_snapshot())
    assert msgs["jax"] == msgs["torch"]


def test_reset_breakers_prefix_evicts_only_namespace():
    for P in map(_pkg, PKGS):
        P.R.breaker_for("tenant/a/sink.write")
        P.R.breaker_for("tenant/a/predict.dispatch")
        keep_b = P.R.breaker_for("tenant/b/sink.write")
        keep_g = P.R.breaker_for("collective.dispatch")
        P.R.reset_breakers(prefix="tenant/a/")
        assert set(P.R.breakers_snapshot()) == {"tenant/b/sink.write",
                                                "collective.dispatch"}
        assert P.R.breaker_for("tenant/b/sink.write") is keep_b
        assert P.R.breaker_for("collective.dispatch") is keep_g
        fresh = P.R.breaker_for("tenant/a/sink.write")
        assert fresh.snapshot()["window_calls"] == 0


# ---------------------------------------------------------------------------
# the engine's namespacing
# ---------------------------------------------------------------------------


def _ev(records, keys=("event", "site", "tenant", "batch_id")):
    return [{k: r.get(k) for k in keys if k in r} for r in records]


def test_engine_events_tenant_tagged_and_site_namespaced(tmp_path):
    got = {}
    for pkg in PKGS:
        P = _pkg(pkg)
        q = P.StreamingQuery(
            P.Identity(), P.MemorySource(_frames(P, 1)),
            _sink_class(P, failing=True)(), str(tmp_path / pkg / "ckpt"),
            max_batch_offsets=1, max_batch_failures=1, tenant="acme",
            pipeline_depth=1, **P.dev)
        assert q.process_available() == 1  # quarantined, committed
        q2 = P.StreamingQuery(
            P.Identity(), P.MemorySource(_frames(P, 1)),
            _sink_class(P, failing=True)(), str(tmp_path / pkg / "ckpt2"),
            max_batch_offsets=1, max_batch_failures=1, pipeline_depth=1,
            **P.dev)
        q2.process_available()
        got[pkg] = _ev(P.R.recent_events(event="quarantine"))
        q.stop()
        q2.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["site"] == "tenant/acme/sink.write"
    assert got["torch"][0]["tenant"] == "acme"
    # a tenant-less engine stays untagged
    assert got["torch"][1]["site"] == "sink.write"
    assert "tenant" not in got["torch"][1]


def test_shed_journal_records_tenant(tmp_path):
    got = {}
    for pkg in PKGS:
        P = _pkg(pkg)
        ckpt = tmp_path / pkg / "ckpt"
        q = P.StreamingQuery(
            P.Identity(), P.MemorySource(_frames(P, 10)), P.MemorySink(),
            str(ckpt), max_batch_offsets=1, tenant="acme", **P.dev)
        record = q.shed_backlog(2)
        with open(ckpt / "shed.jsonl") as f:
            line = json.loads(f.readline())
        shed = P.R.recent_events(event="load_shed")
        got[pkg] = ({k: v for k, v in record.items() if k != "ts"},
                    {k: v for k, v in line.items() if k != "ts"},
                    _ev(shed, ("event", "site", "tenant", "policy",
                               "start", "end", "offsets_shed")))
        q.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["tenant"] == "acme"
    assert got["torch"][2][0]["site"] == "tenant/acme/stream.read"


def test_events_dropped_per_tenant_breakdown():
    got = {}
    for P in map(_pkg, PKGS):
        for _ in range(600):
            P.R.emit_event(event="retry", site="x", tenant="noisy")
        for _ in range(30):
            P.R.emit_event(event="retry", site="x")
        got[P.name] = (P.R.events_dropped(),
                       P.R.events_dropped(by_tenant=True))
        P.R.clear_events()
        assert P.R.events_dropped(by_tenant=True) == {}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 600 + 30 - 512
    assert set(got["torch"][1]) == {"noisy"}


@pytest.mark.parametrize("pkg", PKGS)
def test_fault_point_tenant_namespacing(tmp_path, pkg):
    P = _pkg(pkg)
    P.R.arm("tenant/a/stream.read", times=None)

    def query(name, tenant):
        return P.StreamingQuery(
            P.Identity(), P.MemorySource(_frames(P, 1)), P.MemorySink(),
            str(tmp_path / name), tenant=tenant, **P.dev)

    qa, qb = query("a", "a"), query("b", "b")
    with pytest.raises(P.R.InjectedFault, match="tenant/a/stream.read"):
        qa.process_available()
    assert qb.process_available() == 1  # b never sees a's fault
    # a bare-site fault hits every tenant
    P.R.clear()
    P.R.arm("stream.read")
    qb2 = query("b2", "b")
    with pytest.raises(P.R.InjectedFault):
        qb2.process_available()
    for q in (qa, qb, qb2):
        q.stop()


# ---------------------------------------------------------------------------
# the shared program cache
# ---------------------------------------------------------------------------


def test_shared_predictor_and_flat_ledger_across_tenants(tmp_path):
    got = {}
    for P in map(_pkg, PKGS):
        model = P.Identity()
        sinks = {t: P.MemorySink() for t in ("a", "b", "c")}
        frames = {"a": _frames(P, 2, rows=3), "b": _frames(P, 2, rows=5),
                  "c": _frames(P, 2, rows=7)}
        specs = [_spec(P, t, frames[t], sink=sinks[t], model=model,
                       max_batch_offsets=1) for t in ("a", "b", "c")]
        d = _daemon(P, tmp_path / P.name, specs, shape_buckets=4)
        try:
            assert len({id(d.predictor_for(s.spec))
                        for s in d.tenants}) == 1
            d.process_available()
            d.mark_warm()
            for t in ("a", "b", "c"):
                for f in frames[t]:
                    d._by_id[t].query.source.add(f)
            d.process_available()
            ledger = list(d.compile_ledger().values())
            got[P.name] = (d.recompiles_after_warmup(), ledger,
                           {t: _xs(sinks[t]) for t in sinks})
        finally:
            d.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0
    assert got["torch"][1] == [{"compile_events": 2, "bucket_hits": 10}]


@pytest.mark.parametrize("pkg", PKGS)
def test_shared_predictor_ledger_thread_safe(tmp_path, pkg):
    """Three engines on three threads share one predictor: its counters
    stay exact (one shape, every other dispatch a hit)."""
    P = _pkg(pkg)
    pred = P.BatchPredictor(P.Identity(), bucket_rows=4, **P.dev)
    frames = _frames(P, 40, rows=5)
    errs = []

    def worker(tid):
        try:
            q = P.StreamingQuery(
                pred, P.MemorySource(frames), P.MemorySink(),
                str(tmp_path / tid), max_batch_offsets=1, tenant=tid)
            q.process_available()
            q.stop()
        except Exception as e:  # the failure is the evidence
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(f"t{i}",))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert pred.compile_events == 1
    assert pred.bucket_hits == 3 * 40 - 1


# ---------------------------------------------------------------------------
# fair scheduling and quotas, step by step
# ---------------------------------------------------------------------------


def _row(d):
    return {t.spec.tenant_id: (t.state, t.batches_done, t.rows_done,
                               t.deficit, t.allowance, t.strikes,
                               t.quarantine_episodes, t.shed_total_offsets)
            for t in d.tenants}


def _trace(P, root, make_specs, steps):
    """Run ``steps(d, clock)`` (a generator of tick results) and record
    every tenant's accounting after each step."""
    clock = FakeClock()
    d = _daemon(P, root, make_specs(P), clock=clock)
    try:
        out = []
        for delta in steps(d, clock):
            out.append((delta, _row(d)))
        return out, d.status()["aggregate"]
    finally:
        d.close()


def _both(tmp_path, make_specs, steps):
    jax = _trace(_pkg("jax"), tmp_path / "jax", make_specs, steps)
    port = _trace(_pkg("torch"), tmp_path / "torch", make_specs, steps)
    assert port == jax
    return port


def test_deficit_round_robin_honors_weights(tmp_path):
    def specs(P):
        return [_spec(P, "heavy", _frames(P, 12), weight=3.0,
                      max_batch_offsets=1),
                _spec(P, "light", _frames(P, 12), weight=1.0,
                      max_batch_offsets=1)]

    def steps(d, clock):
        for _ in range(5):
            yield d.tick()

    trace, _agg = _both(tmp_path, specs, steps)
    after4 = trace[3][1]
    assert after4["heavy"][1] == 12 and after4["light"][1] == 4


def test_rate_quota_throttles_then_time_refills(tmp_path):
    def specs(P):
        return [_spec(P, "metered", _frames(P, 6, rows=8),
                      max_rows_per_sec=8.0, max_batch_offsets=1)]

    def steps(d, clock):
        yield d.tick()
        yield d.tick()
        yield d.process_available()
        for t in (1.0, 1.5, 2.0, 4.0):
            clock.t = t
            yield d.tick()

    trace, _agg = _both(tmp_path, specs, steps)
    assert [delta for delta, _ in trace[:3]] == [1, 0, 0]
    assert trace[1][1]["metered"][0] == "THROTTLED"
    assert trace[3][0] == 1


def test_deferring_tenant_banks_no_deficit(tmp_path):
    heal = {}

    def specs(P):
        class _HealableSink(P.MemorySink):
            broken = True

            def add_batch(self, batch_id, frame):
                if self.broken:
                    raise IOError("sink volume down")
                super().add_batch(batch_id, frame)

        heal[P.name] = _HealableSink()
        return [_spec(P, "flaky", _frames(P, 30), sink=heal[P.name],
                      max_batch_offsets=1, max_batch_failures=None,
                      quarantine_after=10_000),
                _spec(P, "ok", _frames(P, 30), max_batch_offsets=1)]

    def steps(d, clock):
        for _ in range(20):
            yield d.tick()
        for sink in heal.values():
            sink.broken = False
        yield d.tick()
        yield d.tick()

    trace, _agg = _both(tmp_path, specs, steps)
    assert trace[19][1]["flaky"][1] == 0
    assert trace[19][1]["flaky"][3] <= 1.0
    assert trace[20][1]["flaky"][1] <= 2


def test_backlog_shed_is_journaled_per_tenant(tmp_path):
    def specs(P):
        return [_spec(P, "flood", _frames(P, 10), max_pending_batches=2,
                      max_batch_offsets=1)]

    def steps(d, clock):
        yield d.process_available()

    _both(tmp_path, specs, steps)
    records = {}
    for pkg in PKGS:
        path = tmp_path / pkg / "tenant" / "flood" / "ckpt" / "shed.jsonl"
        with open(path) as f:
            records[pkg] = [{k: v for k, v in json.loads(line).items()
                             if k != "ts"} for line in f]
    assert records["torch"] == records["jax"]
    assert records["torch"][0]["tenant"] == "flood"


# ---------------------------------------------------------------------------
# the ladder and isolation
# ---------------------------------------------------------------------------

LADDER_EVENTS = ("tenant_quarantined", "tenant_released", "tenant_stopped",
                 "quarantine", "tenant_error")


def test_noisy_tenant_walks_the_ladder_good_tenant_unaffected(tmp_path):
    def specs(P):
        return [
            _spec(P, "good", _frames(P, 6), max_batch_offsets=1,
                  max_batch_failures=2),
            _spec(P, "bad", _frames(P, 8), sink=_sink_class(P, True)(),
                  max_batch_offsets=1, max_batch_failures=2,
                  quarantine_after=2, quarantine_cooldown_s=10.0,
                  stop_after=2),
        ]

    health = {}

    def steps(d, clock):
        yield d.process_available()
        health[d.__module__, "q"] = (d.tenant_health("good").name,
                                     d.tenant_health("bad").name)
        clock.t = 10.0
        yield d.tick()
        health[d.__module__, "r"] = d.tenant_health("bad").name
        yield d.process_available()
        d._by_id["good"].query.source.add(d._by_id["good"].query.source
                                          .get_batch(0, 1))
        yield d.process_available()
        health[d.__module__, "b"] = sorted(
            s for s in _breaker_sites(d) if s.startswith("tenant/"))

    trace, _agg = _both(tmp_path, specs, steps)
    assert trace[0][1]["bad"][0] == "QUARANTINED"
    assert trace[0][1]["bad"][6] == 1
    assert trace[0][1]["good"][:2] == ("OK", 6)
    assert trace[2][1]["bad"][0] == "STOPPED"
    assert trace[3][0] == 1  # the survivor still serves
    assert health["sntc_tpu_torch.serve.tenancy", "q"] == \
        health["sntc_tpu.serve.tenancy", "q"] == ("OK", "UNHEALTHY")
    assert health["sntc_tpu_torch.serve.tenancy", "r"] == "OK"
    assert health["sntc_tpu_torch.serve.tenancy", "b"] == \
        health["sntc_tpu.serve.tenancy", "b"]
    assert not any(s.startswith("tenant/bad/")
                   for s in health["sntc_tpu_torch.serve.tenancy", "b"])
    for pkg in PKGS:
        assert os.path.exists(tmp_path / pkg / "tenant" / "bad" / "ckpt" /
                              "dead_letter" / "dead_letter.jsonl")


def _breaker_sites(d):
    mod = J if d.__module__.startswith("sntc_tpu.") else R
    return mod.breakers_snapshot()


def test_ladder_event_sequences_equal(tmp_path):
    """The noisy tenant's ladder events, in order, are the same in both
    packages."""
    seqs = {}
    for P in map(_pkg, PKGS):
        clock = FakeClock()
        d = _daemon(P, tmp_path / P.name, [
            _spec(P, "good", _frames(P, 6), max_batch_offsets=1),
            _spec(P, "bad", _frames(P, 8), sink=_sink_class(P, True)(),
                  max_batch_offsets=1, max_batch_failures=2,
                  quarantine_after=2, quarantine_cooldown_s=10.0,
                  stop_after=2),
        ], clock=clock)
        try:
            d.process_available()
            clock.t = 10.0
            d.process_available()
            d.process_available()
        finally:
            d.close()
        seqs[P.name] = [
            (r["event"], r.get("tenant"), r.get("site"), r.get("batch_id"))
            for r in P.R.recent_events() if r["event"] in LADDER_EVENTS]
    assert seqs["torch"] == seqs["jax"]
    assert ("tenant_stopped", "bad", None, None) in seqs["torch"]


def test_strikes_attributed_by_namespaced_site_too(tmp_path):
    got = {}
    for P in map(_pkg, PKGS):
        d = _daemon(P, tmp_path / P.name,
                    [_spec(P, "a", _frames(P, 1)), _spec(P, "b", [])],
                    clock=FakeClock())
        try:
            P.R.emit_event(event="breaker_open", site="tenant/a/sink.write")
            P.R.emit_event(event="retry_exhausted",
                           site="tenant/a/sink.write", attempts=3)
            first = (d._by_id["a"].strikes, d._by_id["b"].strikes)
            P.R.emit_event(event="breaker_open", site="sink.write")
            P.R.emit_event(event="breaker_open", site="tenant/unknown")
            got[P.name] = (first, d._by_id["a"].strikes)
        finally:
            d.close()
    assert got["torch"] == got["jax"] == ((2, 0), 2)


def test_engine_error_strikes_tenant_never_kills_daemon(tmp_path):
    def specs(P):
        class _ExplodingSource(P.MemorySource):
            def latest_offset(self):
                raise RuntimeError("source backend down")

        return [P.T.TenantSpec(tenant_id="boom", model=P.Identity(),
                               source=_ExplodingSource(_frames(P, 1)),
                               sink=P.MemorySink(), quarantine_after=99),
                _spec(P, "ok", _frames(P, 2), max_batch_offsets=1)]

    def steps(d, clock):
        yield d.process_available()

    trace, _agg = _both(tmp_path, specs, steps)
    assert trace[0][0] == 2
    assert trace[0][1]["boom"][5] > 0
    assert trace[0][1]["ok"][1] == 2


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------


def test_daemon_drain_markers_equal_bytes(tmp_path, monkeypatch):
    """The tenant and daemon drain markers are byte-equal across the
    packages, their time stamps and pid pinned."""
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.25)
    monkeypatch.setattr("os.getpid", lambda: 4242)
    for P in map(_pkg, PKGS):
        d = _daemon(P, tmp_path / P.name,
                    [_spec(P, t, _frames(P, 3), max_batch_offsets=1)
                     for t in ("a", "b")], clock=FakeClock())
        try:
            d.request_drain("test")
            status = d.run(poll_interval=0.0)
            assert status["drained"] is True
        finally:
            d.close()
    for rel in ("daemon_drain_marker.json",
                "tenant/a/drain_marker.json", "tenant/b/drain_marker.json"):
        with open(tmp_path / "jax" / rel, "rb") as f:
            want = f.read()
        with open(tmp_path / "torch" / rel, "rb") as f:
            assert f.read() == want, rel
    marker = json.loads(want)
    assert marker["tenant"] == "b" and marker["in_flight_left"] == 0


# ---------------------------------------------------------------------------
# spec hygiene
# ---------------------------------------------------------------------------


def _spec_errors(P):
    out = []
    for kw in (dict(tenant_id="a/b"), dict(tenant_id=""),
               dict(tenant_id="a", weight=0),
               dict(tenant_id="a", shed_policy="newest"),
               dict(tenant_id="a", quarantine_after=0),
               dict(tenant_id="a", max_rows_per_sec=-1.0),
               dict(tenant_id="a", row_policy="salvage"),
               dict(tenant_id="a", slo_p99_ms=-1.0),
               dict(tenant_id="a", slo_max_shed_rate=1.5),
               dict(tenant_id="a", ingress={"listen_udp": 0, "bogus": 1}),
               dict(tenant_id="a", ingress={"listen_udp": 0,
                                            "listen_tcp": 0}),
               dict(tenant_id="a", ingress={"listen_tcp": 0}),
               dict(tenant_id="a", watch="w", from_capture="pcap",
                    ingress={"listen_udp": 0})):
        try:
            P.T.TenantSpec(model=P.Identity(), **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    for entry in ({"id": "a", "max_rows_per_second": 5},
                  {"id": "a", "slo_p99": 1.0}):
        try:
            P.T.TenantSpec.from_dict(entry)
        except ValueError as e:
            out.append(str(e))
    return out


def test_tenant_spec_validation():
    msgs = {pkg: _spec_errors(_pkg(pkg)) for pkg in PKGS}
    assert msgs["torch"] == msgs["jax"]
    assert None not in msgs["torch"]
    for P in map(_pkg, PKGS):
        spec = P.T.TenantSpec.from_dict(
            {"id": "a", "weight": 2.0},
            defaults={"weight": 1.0, "max_rows_per_sec": 10.0,
                      "model": P.Identity()})
        assert spec.weight == 2.0 and spec.max_rows_per_sec == 10.0
        zero = P.T.TenantSpec(tenant_id="z", model=P.Identity(),
                              max_batch_failures=0, slo_p99_ms=0)
        assert zero.max_batch_failures is None and zero.slo_p99_ms is None


def test_daemon_rejects_duplicate_tenants(tmp_path):
    msgs = {}
    for P in map(_pkg, PKGS):
        with pytest.raises(ValueError, match="duplicate") as exc:
            _daemon(P, tmp_path / P.name, [_spec(P, "a", _frames(P, 1)),
                                           _spec(P, "a", _frames(P, 1))])
        msgs[P.name] = str(exc.value)
    assert msgs["torch"] == msgs["jax"]


def test_module_constants_equal():
    for name in ("TENANT_STATES", "STRIKE_EVENTS", "DAEMON_DRAIN_MARKER",
                 "INGRESS_KEYS"):
        assert getattr(PT, name) == getattr(JT, name), name
    import dataclasses

    port_fields = [(f.name, f.default) for f in dataclasses.fields(
        PT.TenantSpec)]
    jax_fields = [(f.name, f.default) for f in dataclasses.fields(
        JT.TenantSpec)]
    assert port_fields == jax_fields


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------


def test_add_and_remove_tenant_equal(tmp_path):
    def specs(P):
        return [_spec(P, "a", _frames(P, 3), max_batch_offsets=1)]

    summaries = {}

    def steps(d, clock):
        P = _pkg("jax" if d.__module__.startswith("sntc_tpu.") else "torch")
        yield d.tick()
        d.add_tenant(_spec(P, "b", _frames(P, 2), max_batch_offsets=1))
        yield d.process_available()
        summaries[P.name] = d.remove_tenant("a", reason="moved")
        yield d.tick()

    _both(tmp_path, specs, steps)
    assert summaries["torch"] == summaries["jax"]
    for pkg in PKGS:
        assert os.path.exists(tmp_path / pkg / "tenant" / "a" /
                              "drain_marker.json")


def test_request_fleet_inert_outside_a_fleet(tmp_path):
    P = _pkg("torch")
    d = _daemon(P, tmp_path, [_spec(P, "a", [])])
    try:
        assert d.request_fleet("migrate", "a") is False
        seen = []
        d.fleet_hook = lambda *a: seen.append(a)
        assert d.request_fleet("migrate", "a", "why") is True
        assert seen == [("migrate", "a", "why")]
    finally:
        d.close()


# ---------------------------------------------------------------------------
# the shared device domain
# ---------------------------------------------------------------------------


def test_failed_device_domain_drains_and_strikes_no_tenant(tmp_path):
    """``device.dispatch`` failing for good (an injected ``device_lost``)
    fails the shared domain after 3 faults: the daemon stops scheduling,
    strikes no tenant, drains every tenant with the batch's intent left
    in its WAL, and reports ``device_failed``."""
    P = _pkg("torch")
    R.arm("device.dispatch", kind="device_lost", times=None)
    clock = FakeClock()
    d = _daemon(P, tmp_path / "root",
                [_spec(P, t, _frames(P, 2), max_batch_offsets=1)
                 for t in ("a", "b")], clock=clock)
    try:
        d.process_available()
        assert d.device_failed and d.drain_requested
        assert d.device_domain.failed
        status = d.run(poll_interval=0.0)
    finally:
        d.close()
    assert status["device_failed"] is True and status["drained"] is True
    assert {t: row["state"] for t, row in status["tenants"].items()} == {
        "a": "OK", "b": "OK"}
    assert all(row["strikes"] == 0 for row in status["tenants"].values())
    assert all(row["batches_done"] == 0
               for row in status["tenants"].values())
    assert R.recent_events(event="daemon_device_failed")
    with open(tmp_path / "root" / "daemon_drain_marker.json") as f:
        assert json.load(f)["reason"] == "device_failed"
    # the planned batch's intent stays for a restart
    assert os.path.exists(tmp_path / "root" / "tenant" / "a" / "ckpt" /
                          "offsets" / "0.json")
    assert not os.listdir(tmp_path / "root" / "tenant" / "a" / "ckpt" /
                          "commits")


def test_transient_device_fault_strikes_no_tenant(tmp_path):
    """A device fault the domain absorbs (one ``device_lost``) is
    re-dispatched; every batch commits and no tenant is struck."""
    P = _pkg("torch")
    R.arm("device.dispatch", kind="device_lost", times=1)
    sinks = {t: P.MemorySink() for t in ("a", "b")}
    d = _daemon(P, tmp_path / "root",
                [_spec(P, t, _frames(P, 3), sink=sinks[t],
                       max_batch_offsets=1) for t in ("a", "b")],
                clock=FakeClock())
    try:
        assert d.process_available() == 6
        assert not d.device_failed
        assert all(t.strikes == 0 and t.state == "OK" for t in d.tenants)
        assert d.status()["device"]["faults"] == {"device_lost": 1}
    finally:
        d.close()
    assert _xs(sinks["a"]) == [list(range(100 * b, 100 * b + 8))
                               for b in range(3)]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _daemon_defaults(app, monkeypatch, extra=()):
    """The Namespace each package's ``serve-daemon`` parser gives for the
    required flags alone (the command replaced by a recorder)."""
    seen = {}
    monkeypatch.setattr(app, "cmd_serve_daemon",
                        lambda args: seen.update(vars(args)) or 0)
    rc = app.main(["serve-daemon", "--tenants", "t.json", "--root", "r"]
                  + list(extra))
    assert rc == 0
    seen.pop("fn", None)
    return seen


def test_serve_daemon_parser_defaults_equal(monkeypatch):
    import sntc_tpu.app as jax_app
    import sntc_tpu_torch.app as port_app

    jax = _daemon_defaults(jax_app, monkeypatch)
    port = _daemon_defaults(port_app, monkeypatch)
    not_ported = {"compile_budget_s", "platform"}
    assert set(jax) - set(port) == not_ported
    assert set(port) - set(jax) == {"device"}
    for dest in set(jax) & set(port):
        assert port[dest] == jax[dest], dest
    assert port["device"] == "cuda"


# ---------------------------------------------------------------------------
# the chaos scenarios (scripts/chaos_crash_matrix.py) in port processes
# ---------------------------------------------------------------------------

PORT_DAEMON_WORKER = """
import json, os, sys
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.serve import ServeDaemon, TenantSpec

class Identity(Transformer):
    def transform(self, frame):
        return frame

watch, out, ckpt = sys.argv[1:4]
model = Identity()
specs = [TenantSpec(tenant_id=tid, model=model,
                    watch=os.path.join(watch, tid),
                    out=os.path.join(out, tid), out_columns=["x"],
                    max_batch_offsets=1, max_batch_failures=2,
                    quarantine_after=2, stop_after=99)
         for tid in ("t0", "t1", "t2")]
daemon = ServeDaemon(specs, ckpt, device="cpu")
try:
    n = daemon.process_available()
    daemon.drain()
    status = daemon.status()
finally:
    daemon.close()
print(json.dumps({"batches": n, "tenants": {
    tid: row["state"] for tid, row in status["tenants"].items()}}))
"""


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chaos():
    return _load_script("chaos_crash_matrix")


@pytest.fixture(scope="module")
def mt_reference(chaos, tmp_path_factory):
    """The JAX worker's unkilled 3-tenant run."""
    workdir = str(tmp_path_factory.mktemp("mt_chaos"))
    return workdir, chaos.run_multi_tenant_reference(workdir)


def _port_worker(d, faults=""):
    env = dict(os.environ, SNTC_FAULTS=faults, PYTHONPATH=REPO)
    env.pop("SNTC_RESILIENCE_LOG", None)
    return subprocess.run(
        [sys.executable, "-c", PORT_DAEMON_WORKER, os.path.join(d, "in"),
         os.path.join(d, "out"), os.path.join(d, "ckpt")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)


def test_chaos_multi_tenant_kill_converges_every_tenant(chaos,
                                                        mt_reference):
    workdir, reference = mt_reference
    for tid in chaos.TENANT_IDS:
        assert sorted(reference[tid]["commits"]) == [0, 1, 2, 3]
    d = os.path.join(workdir, "port_mt_kill")
    chaos._write_daemon_inputs(d)
    killed = _port_worker(d, faults="tenant/t1/stream.wal:kill")
    assert killed.returncode == KILL_EXIT_CODE, killed.stderr
    restarted = _port_worker(d)
    assert restarted.returncode == 0, restarted.stderr
    assert chaos._daemon_state(d) == reference


def test_chaos_tenant_fault_isolated_to_its_namespace(chaos, mt_reference):
    workdir, reference = mt_reference
    d = os.path.join(workdir, "port_mt_isolation")
    chaos._write_daemon_inputs(d)
    proc = _port_worker(d, faults="tenant/t1/sink.write:io:1.0:0")
    assert proc.returncode == 0, proc.stderr
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    got = chaos._daemon_state(d)
    for tid in ("t0", "t2"):
        assert got[tid] == reference[tid]
        assert verdict["tenants"][tid] == "OK"
    assert got["t1"]["rows"] == {}
    assert verdict["tenants"]["t1"] in ("QUARANTINED", "STOPPED")
    assert os.path.exists(os.path.join(d, "ckpt", "tenant", "t1", "ckpt",
                                       "dead_letter", "dead_letter.jsonl"))
    # the JAX worker's verdict on the same fault
    jax = chaos.run_tenant_isolation_scenario(workdir, reference)
    assert jax["ok"] and jax["tenant_states"] == verdict["tenants"]


# ---------------------------------------------------------------------------
# the command, and fsck across the packages
# ---------------------------------------------------------------------------


def _lr_checkpoint(tmp_path, pkg="jax"):
    """A small binary LR pipeline saved by ``pkg`` (either package loads
    it), and CSV streams of its features for three tenants."""
    from sntc_tpu_torch.data import (
        CICIDS2017_FEATURES,
        clean_flows,
        generate_frame,
        write_raw_csv,
    )

    train = clean_flows(generate_frame(1500, seed=3))
    train = train.with_column("Label", np.where(
        train["Label"].astype(str) == "BENIGN", "benign",
        "attack").astype(object))
    if pkg == "jax":
        from sntc_tpu.core.base import Pipeline
        from sntc_tpu.core.frame import Frame as F
        from sntc_tpu.feature import StandardScaler, StringIndexer
        from sntc_tpu.feature import VectorAssembler
        from sntc_tpu.mlio import save_model
        from sntc_tpu.models import LogisticRegression

        train = F({c: np.asarray(train[c]) for c in train.columns})
        dev = {}
    else:
        from sntc_tpu_torch.core.base import Pipeline
        from sntc_tpu_torch.feature import StandardScaler, StringIndexer
        from sntc_tpu_torch.feature import VectorAssembler
        from sntc_tpu_torch.mlio import save_model
        from sntc_tpu_torch.models import LogisticRegression

        dev = {"device": "cpu"}
    fitted = Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures"),
        StandardScaler(inputCol="rawFeatures", outputCol="features",
                       withMean=True, **dev),
        LogisticRegression(maxIter=5, **dev),
    ]).fit(train)
    model = str(tmp_path / "model")
    save_model(fitted, model)
    rows = clean_flows(generate_frame(600, seed=11)).drop("Label")
    frame = Frame({c: np.asarray(rows[c]) for c in rows.columns})
    for k, tid in enumerate(("a", "b", "c")):
        d = tmp_path / "in" / tid
        os.makedirs(d)
        for i in range(3):
            lo = 60 * (3 * k + i)
            write_raw_csv(frame.slice(lo, lo + 37 + 7 * i),
                          str(d / f"part_{i:03d}.csv"))
    return model


def _tenants_json(tmp_path, model, tag):
    doc = {"tenants": [
        {"id": tid, "model": model, "watch": str(tmp_path / "in" / tid),
         "out": str(tmp_path / f"out_{tag}" / tid)}
        for tid in ("a", "b", "c")]}
    path = tmp_path / f"tenants_{tag}.json"
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


def _run_cli(args, tag, whole=False):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               SNTC_SERVE_HOST_ROWS="16384")
    env.pop("SNTC_FAULTS", None)
    proc = subprocess.run([sys.executable, "-m"] + args, env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (tag, proc.stderr[-3000:])
    text = proc.stdout.strip()
    return json.loads(text if whole else text.splitlines()[-1])


def test_serve_daemon_command_both_packages_and_cross_fsck(tmp_path):
    """``serve-daemon --once`` of both packages over one saved LR
    pipeline and three tenants: the same summary, the same batch files
    byte for byte, and each package's ``fsck --tenant-tree`` clean on
    the other's root."""
    model = _lr_checkpoint(tmp_path)
    common = ["--shape-buckets", "64", "--once"]
    port = _run_cli(["sntc_tpu_torch", "serve-daemon", "--tenants",
                     _tenants_json(tmp_path, model, "torch"), "--root",
                     str(tmp_path / "root_torch"), "--device", "cpu"]
                    + common, "port")
    jax = _run_cli(["sntc_tpu", "serve-daemon", "--tenants",
                    _tenants_json(tmp_path, model, "jax"), "--root",
                    str(tmp_path / "root_jax"), "--platform", "cpu"]
                   + common, "jax")
    for key in ("batches", "tenants", "recompiles_after_warmup",
                "drained", "health"):
        assert port[key] == jax[key], key
    assert port["tenants"] == {"a": "OK", "b": "OK", "c": "OK"}
    assert port["recompiles_after_warmup"] == 0 and port["drained"]
    for tid in ("a", "b", "c"):
        names = sorted(os.listdir(tmp_path / "out_jax" / tid))
        assert names == sorted(os.listdir(tmp_path / "out_torch" / tid))
        for n in names:
            with open(tmp_path / "out_jax" / tid / n, "rb") as f:
                want = f.read()
            with open(tmp_path / "out_torch" / tid / n, "rb") as f:
                assert f.read() == want, (tid, n)
    for pkg, root in (("sntc_tpu_torch", "root_jax"),
                      ("sntc_tpu", "root_torch")):
        report = _run_cli([pkg, "fsck", str(tmp_path / root),
                           "--tenant-tree", "--no-repair"], pkg + " fsck",
                          whole=True)
        assert report["ok"], report
        assert sorted(r["tenant"] for r in report["roots"][1:]) == \
            ["a", "b", "c"]
        assert not any(r["errors"] for r in report["roots"]), report


@pytest.mark.cuda
def test_three_tenant_daemon_on_card_equals_cpu(tmp_path):
    """A 3-tenant daemon on the card (two tenants sharing the LR
    checkpoint, every batch on the device) writes the CPU daemon's
    predictions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _lr_checkpoint(tmp_path, "torch")
    from sntc_tpu_torch.app import main

    outs = {}
    for dev in ("cpu", "cuda"):
        os.environ["SNTC_SERVE_HOST_ROWS"] = "0"
        try:
            rc = main(["serve-daemon", "--tenants",
                       _tenants_json(tmp_path, model, dev), "--root",
                       str(tmp_path / f"root_{dev}"), "--shape-buckets",
                       "64", "--once", "--device", dev])
        finally:
            os.environ.pop("SNTC_SERVE_HOST_ROWS", None)
        assert rc == 0
        outs[dev] = {
            tid: [open(tmp_path / f"out_{dev}" / tid / n).read()
                  for n in sorted(os.listdir(tmp_path / f"out_{dev}" / tid))]
            for tid in ("a", "b", "c")}
    for tid in ("a", "b", "c"):
        for cpu_text, card_text in zip(outs["cpu"][tid], outs["cuda"][tid]):
            cpu_pred = [ln.split(",")[0] for ln in cpu_text.splitlines()]
            card_pred = [ln.split(",")[0] for ln in card_text.splitlines()]
            assert cpu_pred == card_pred
