"""The port's durable-storage plane against the JAX package's, on the CPU.

Counterpart of ``tests/test_storage.py``: the same trees, frames and
fault schedules go through both packages.

* The WAL: a torn append-log tail is truncated with a repair record and
  the whole records replay; a torn files-mode commit record is
  quarantined to ``.corrupt/`` and its batch replays; damage mid-log is
  loud; compaction and pruning restart exactly as the unbounded WAL.
* The physical writes: ``append_line`` rolls a torn write or an ENOSPC
  back; ``RotatingJsonlWriter`` bounds its footprint, degrades and
  recovers; dead-letter retention keeps the newest N and counts the
  rest; the ENOSPC / EIO sweep over the engine's write sites commits the
  same batches with the same sink frames in both packages.
* The doctor: ``fsck`` reports on the same damaged trees are equal
  (paths relative to the root, ``ts`` dropped), with and without repair,
  on a tenant tree and through both commands; each package's ``fsck``
  and ``load_model`` on the other's trees and checkpoints; the
  ``.prev`` fallback; ``quick_scan`` at engine construction.
* Disk accounting: ``StoragePlane`` usage and budget, and the
  supervisor's ``storage`` block, against the JAX package's.
* The registry: every durable write site of the port names a registered
  artifact, every artifact the port writes has a write site (the JAX
  package pins the same with ``scripts/check_durable_artifacts.py``).
* The ``serve`` command: a serve killed at ``stream.commit`` leaves a
  WAL whose torn tail ``fsck`` repairs (exit 0, the JAX command's report),
  the restart resumes exactly once into the clean run's files, and a
  forged compaction seal makes ``fsck`` exit 1.
"""

import errno
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import sntc_tpu.resilience as J
import sntc_tpu_torch.resilience as R
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.base import Transformer as JTransformer
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.schema import ColumnSpec as JColumnSpec
from sntc_tpu.data.schema import SchemaContract as JSchemaContract
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import RandomForestClassifier as JRandomForest
from sntc_tpu.obs import metrics as jax_metrics
from sntc_tpu.resilience import storage as JS
from sntc_tpu.serve import CsvDirSink as JCsvDirSink
from sntc_tpu.serve import MemorySink as JMemorySink
from sntc_tpu.serve import MemorySource as JMemorySource
from sntc_tpu.serve import StreamingQuery as JStreamingQuery
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import (
    CICIDS2017_FEATURES,
    ColumnSpec,
    SchemaContract,
    write_raw_csv,
)
from sntc_tpu_torch.mlio import (
    CheckpointCorruptError,
    load_model,
    save_model,
    verify_checkpoint,
)
from sntc_tpu_torch.obs import metrics as port_metrics
from sntc_tpu_torch.resilience import storage as PS
from sntc_tpu_torch.serve import (
    CsvDirSink,
    MemorySink,
    MemorySource,
    StreamingQuery,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sntc_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("SNTC_FAULTS", raising=False)
    for pkg in (J, R):
        pkg.clear()
        pkg.clear_events()
        pkg.reset_breakers()
    PS.reset_degradation()
    JS.reset_degradation()
    port_metrics.reset_registry()
    jax_metrics.reset_registry()
    yield
    for pkg in (J, R):
        pkg.clear()
        pkg.clear_events()
        pkg.reset_breakers()
    PS.reset_degradation()
    JS.reset_degradation()


def _get(name, **labels):
    return port_metrics.registry().get(name, **labels) or 0


def _jget(name, **labels):
    return jax_metrics.registry().get(name, **labels) or 0


class _Identity(Transformer):
    def transform(self, frame):
        return frame


class _JIdentity(JTransformer):
    def transform(self, frame):
        return frame


def _frames(n, rows=6):
    return [{"x": np.arange(rows, dtype=np.float64) + 100 * b}
            for b in range(n)]


def _engine(pkg, root, frames, sink=None, **kw):
    """A one-frame-a-batch engine of ``pkg`` over ``frames``."""
    if pkg == "port":
        sink = sink or MemorySink()
        return StreamingQuery(_Identity(),
                              MemorySource([Frame(f) for f in frames]), sink,
                              str(root), max_batch_offsets=1, device="cpu",
                              **kw), sink
    sink = sink or JMemorySink()
    return JStreamingQuery(_JIdentity(),
                           JMemorySource([JFrame(f) for f in frames]), sink,
                           str(root), max_batch_offsets=1, **kw), sink


def _sink_values(sink):
    return [(bid, {c: np.asarray(to_host(f[c])).tolist() for c in f.columns})
            for bid, f in sink.batches]


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _rel(obj, root):
    """A report or record with ``root`` cut out of every path and the
    clock dropped, so two roots compare."""
    root = str(root)
    if isinstance(obj, dict):
        return {k: _rel(v, root) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_rel(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(root, "<root>")
    return obj


def _copy_tree(src, names):
    """Copies of ``src`` beside it, one per name."""
    out = {}
    for name in names:
        dst = os.path.join(os.path.dirname(str(src)), name)
        shutil.copytree(str(src), dst)
        out[name] = dst
    return out


# ---------------------------------------------------------------------------
# the WAL
# ---------------------------------------------------------------------------


def test_append_wal_torn_tail_repaired_on_recovery(tmp_path):
    intent0 = {"batch_id": 0, "start": 0, "end": 1}
    got = {}
    for pkg in ("port", "jax"):
        ckpt = tmp_path / pkg
        ckpt.mkdir()
        with open(ckpt / "offsets.log", "w") as f:
            f.write(json.dumps(intent0) + "\n")
            f.write('{"batch_id": 1, "sta')  # torn mid-append
        q, sink = _engine(pkg, ckpt, _frames(2), wal_mode="append")
        assert q._pending_intents == {0: intent0}
        assert (ckpt / "offsets.log").read_text() == json.dumps(intent0) + "\n"
        assert q.process_available() == 2
        q.stop()
        got[pkg] = (_rel(_records(ckpt / "storage_repair.jsonl"), ckpt),
                    _sink_values(sink))
    assert got["port"] == got["jax"]
    assert got["port"][0][0]["action"] == "truncate_torn_tail"
    assert _get("sntc_storage_repairs_total", artifact="wal_append") >= 1


def test_append_wal_torn_commit_tail_replays_batch(tmp_path):
    intent = {"batch_id": 0, "start": 0, "end": 1}
    for pkg in ("port", "jax"):
        ckpt = tmp_path / pkg
        ckpt.mkdir()
        (ckpt / "offsets.log").write_text(json.dumps(intent) + "\n")
        (ckpt / "commits.log").write_text('{"batch_id": 0, "end"')
        q, _ = _engine(pkg, ckpt, _frames(1), wal_mode="append")
        assert q.last_committed() == -1
        assert q.process_available() == 1 and q.last_committed() == 0
        q.stop()
    assert (tmp_path / "port" / "commits.log").read_text() == (
        tmp_path / "jax" / "commits.log").read_text()


def test_mid_file_wal_corruption_is_loud(tmp_path):
    path = tmp_path / "commits.log"
    path.write_text('{"batch_id": 0, "end": 1}\nGARBAGE\n'
                    '{"batch_id": 2, "end": 3}\n')
    with pytest.raises(PS.JsonlCorruptError, match="line 2") as pe:
        PS.read_jsonl_tolerant(str(path), repair=True)
    with pytest.raises(JS.JsonlCorruptError) as je:
        JS.read_jsonl_tolerant(str(path), repair=True)
    assert str(pe.value) == str(je.value)


def test_files_wal_torn_records_tolerated(tmp_path):
    for pkg in ("port", "jax"):
        q, _ = _engine(pkg, tmp_path / pkg, _frames(3))
        assert q.process_available() == 3
        q.stop()
        ckpt = tmp_path / pkg
        (ckpt / "commits" / "2.json").write_text('{"batch_id": 2, "e')
        q2, _ = _engine(pkg, ckpt, _frames(3))
        assert q2.last_committed() == 1
        assert os.path.exists(ckpt / "commits" / ".corrupt" / "2.json")
        assert q2.process_available() == 1 and q2.last_committed() == 2
        q2.stop()
    assert _rel(_records(tmp_path / "port" / "storage_repair.jsonl"),
                tmp_path / "port") == _rel(
        _records(tmp_path / "jax" / "storage_repair.jsonl"), tmp_path / "jax")


@pytest.mark.parametrize("wal_mode,bounded_kwargs,unbounded_kwargs", [
    ("append", dict(wal_compact_every=3), dict(wal_compact_every=0)),
    ("files", dict(wal_keep_commits=4), dict(wal_keep_commits=0)),
])
def test_restart_equivalence_bounded_vs_unbounded_wal(
        tmp_path, wal_mode, bounded_kwargs, unbounded_kwargs):
    frames = _frames(11)
    more = frames + _frames(5, rows=4)
    results = {}
    for pkg in ("port", "jax"):
        for name, kw in (("bounded", bounded_kwargs),
                         ("unbounded", unbounded_kwargs)):
            root = tmp_path / pkg / name
            q, _ = _engine(pkg, root, frames, wal_mode=wal_mode, **kw)
            assert q.process_available() == 11
            q.stop()
            q2, sink2 = _engine(pkg, root, more, wal_mode=wal_mode, **kw)
            recovered = (q2.last_committed(), q2.committed_end())
            assert q2.process_available() == 5
            q2.stop()
            results[pkg, name] = (recovered, _sink_values(sink2))
    assert len(set(json.dumps(v) for v in results.values())) == 1
    for pkg in ("port", "jax"):
        root = tmp_path / pkg / "bounded"
        if wal_mode == "append":
            core = PS.load_sealed_json(str(root / "wal_checkpoint.json"))
            assert core["last_committed"] >= 11
            assert sum(1 for x in open(root / "commits.log")
                       if x.strip()) < 4
        else:
            assert len(os.listdir(root / "commits")) <= 5
    assert sorted(os.listdir(tmp_path / "port" / "bounded")) == sorted(
        os.listdir(tmp_path / "jax" / "bounded"))


# ---------------------------------------------------------------------------
# physical writes
# ---------------------------------------------------------------------------


def test_rotating_writer_bounds_footprint(tmp_path):
    sizes = {}
    for pkg, mod in (("port", PS), ("jax", JS)):
        d = tmp_path / pkg
        d.mkdir()
        w = mod.RotatingJsonlWriter(str(d / "j.jsonl"), max_bytes=400,
                                    keep=2, artifact="repair_journal")
        for i in range(200):
            assert w.write({"i": i, "pad": "x" * 20})
        sizes[pkg] = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}
        stats = w.stats()
        stats.pop("path")
        sizes[pkg + "_stats"] = stats
    assert sizes["port"] == sizes["jax"]
    assert sizes["port_stats"] == sizes["jax_stats"]
    assert list(sizes["port"]) == ["j.jsonl", "j.jsonl.1", "j.jsonl.2"]
    assert all(len(b) <= 400 + 64 for b in sizes["port"].values())


@pytest.mark.parametrize("kind", ["enospc", "io_error"])
def test_rotating_writer_degrades_and_recovers(tmp_path, kind):
    h = R.HealthMonitor().attach()
    try:
        w = PS.RotatingJsonlWriter(str(tmp_path / "j.jsonl"),
                                   artifact="repair_journal")
        jw = JS.RotatingJsonlWriter(str(tmp_path / "jj.jsonl"),
                                    artifact="repair_journal")
        R.arm("storage.journal", kind=kind, times=2)
        J.arm("storage.journal", kind=kind, times=2)
        for i in range(2):
            assert w.write({"i": i}) is jw.write({"i": i}) is False
        assert h.state_of("storage.repair_journal") == R.HealthState.DEGRADED
        assert _get("sntc_storage_write_errors_total",
                    artifact="repair_journal") == 2
        assert _get("sntc_storage_degraded_state",
                    artifact="repair_journal") == 1
        assert w.write({"i": 2}) is jw.write({"i": 2}) is True
        assert [r["i"] for r in _records(tmp_path / "j.jsonl")] == [0, 1, 2]
        assert (tmp_path / "j.jsonl").read_bytes() == (
            tmp_path / "jj.jsonl").read_bytes()
        assert h.state_of("storage.repair_journal") == R.HealthState.OK
        names = [e["event"] for e in R.recent_events()
                 if e["event"].startswith("storage_")]
        jnames = [e["event"] for e in J.recent_events()
                  if e["event"].startswith("storage_")]
        assert names == jnames == ["storage_degraded", "storage_recovered"]
    finally:
        h.close()


def test_rotating_writer_torn_write_rolls_back(tmp_path):
    for pkg, mod, faults in (("port", PS, R), ("jax", JS, J)):
        w = mod.RotatingJsonlWriter(str(tmp_path / f"{pkg}.jsonl"),
                                    artifact="repair_journal")
        faults.arm("storage.journal", kind="torn_write", times=1)
        assert w.write({"x": "y" * 200}) is False
        assert w.write({"z": 1}) is True
        assert _records(tmp_path / f"{pkg}.jsonl") == [
            {"x": "y" * 200}, {"z": 1}]


@pytest.mark.parametrize("kind", ["torn_write", "enospc", "io_error"])
def test_append_line_rolls_back_a_failed_write(tmp_path, kind):
    texts = {}
    for pkg, mod, faults in (("port", PS, R), ("jax", JS, J)):
        path = tmp_path / f"{pkg}.log"
        with open(path, "a") as f:
            mod.append_line(f, '{"a": 1}\n', site="storage.wal")
            faults.arm("storage.wal", kind=kind, seed=5, times=1)
            with pytest.raises(OSError) as ei:
                mod.append_line(f, '{"b": 2, "pad": "' + "p" * 90 + '"}\n',
                                site="storage.wal")
            assert ei.value.errno == (errno.ENOSPC if kind == "enospc"
                                      else errno.EIO)
            mod.append_line(f, '{"c": 3}\n', site="storage.wal")
        texts[pkg] = (path.read_text(), str(ei.value).replace(
            str(tmp_path / pkg), "<p>"))
    assert texts["port"] == texts["jax"]
    assert texts["port"][0] == '{"a": 1}\n{"c": 3}\n'


def test_enospc_is_a_real_oserror():
    R.arm("stream.wal", kind="enospc", times=1)
    with pytest.raises(OSError) as ei:
        R.fault_point("stream.wal")
    assert ei.value.errno == errno.ENOSPC
    assert isinstance(ei.value, R.InjectedDiskFault)
    R.arm("stream.wal", kind="torn_write", times=1)
    R.fault_point("stream.wal")  # inert at a plain site


def test_wal_append_error_names_file_and_offset(tmp_path):
    class Dead:
        name = str(tmp_path / "ckpt" / "offsets.log")

        def tell(self):
            return 123

        def write(self, text):
            raise OSError(5, "Input/output error")

        def truncate(self, pos):
            pass

        def seek(self, pos):
            pass

    for mod in (PS, JS):
        with pytest.raises(OSError) as ei:
            mod.append_line(Dead(), '{"x": 1}\n', site="storage.wal")
        assert "offsets.log" in str(ei.value)
        assert "offset 123" in str(ei.value) and ei.value.errno == 5


def test_dead_letter_retention_bounds_and_counts(tmp_path):
    class FailSink:
        def add_batch(self, batch_id, frame):
            raise IOError(f"sink down for {batch_id}")

    for pkg in ("port", "jax"):
        q, _ = _engine(pkg, tmp_path / pkg, _frames(6), sink=FailSink(),
                       max_batch_failures=1, dead_letter_keep=3)
        assert q.process_available() == 6
        q.stop()
    dl = {pkg: tmp_path / pkg / "dead_letter" for pkg in ("port", "jax")}
    assert sorted(os.listdir(dl["port"])) == sorted(os.listdir(dl["jax"]))
    csvs = sorted(n for n in os.listdir(dl["port"]) if n.endswith(".csv"))
    assert csvs == [f"batch_00000{i}.csv" for i in (3, 4, 5)]
    for name in csvs:
        assert (dl["port"] / name).read_bytes() == (
            dl["jax"] / name).read_bytes()
    drop = {k: v for k, v in zip(("port", "jax"), (
        _records(dl["port"] / "dead_letter.jsonl"),
        _records(dl["jax"] / "dead_letter.jsonl")))}
    assert len(drop["port"]) == len(drop["jax"]) == 6
    assert _get("sntc_dead_letter_dropped_total",
                artifact="dead_letter") == _jget(
        "sntc_dead_letter_dropped_total", artifact="dead_letter") == 3
    assert [e["keep"] for e in R.recent_events(
        event="dead_letter_dropped")][-1] == 3


ENGINE_SWEEP_SITES = ("stream.wal", "stream.commit", "sink.write",
                      "storage.wal", "storage.dead_letter")


@pytest.mark.parametrize("kind", ["enospc", "io_error"])
@pytest.mark.parametrize("site", ENGINE_SWEEP_SITES)
def test_disk_fault_sweep_engine_survives(tmp_path, site, kind):
    """A transient disk failure (2 faults) at each engine write site:
    both engines keep serving, commit every batch and hand the sink the
    same frames; the row dead letters' write sheds and recovers."""
    frames = _frames(6)
    frames[2]["x"][1] = np.nan  # a row dead letter to write
    out = {}
    for pkg, faults in (("port", R), ("jax", J)):
        if pkg == "port":
            contract = SchemaContract(
                {"x": ColumnSpec(dtype="float64")}, mode="salvage")
            sink = CsvDirSink(str(tmp_path / f"out_{pkg}"), durable=False)
            policy = R.RetryPolicy(max_attempts=2, base_delay_s=0.0,
                                   jitter=0.0)
        else:
            contract = JSchemaContract(
                {"x": JColumnSpec(dtype="float64")}, mode="salvage")
            sink = JCsvDirSink(str(tmp_path / f"out_{pkg}"), durable=False)
            policy = J.RetryPolicy(max_attempts=2, base_delay_s=0.0,
                                   jitter=0.0)
        q, _ = _engine(pkg, tmp_path / pkg, frames, sink=sink,
                       wal_mode="append", wal_compact_every=2,
                       retry_policy=policy, max_batch_failures=3,
                       schema_contract=contract)
        faults.arm(site, kind=kind, times=2)
        for _ in range(12):
            q.process_available()
            if q.last_committed() == 5:
                break
        assert q.last_committed() == 5 and q.in_flight_count() == 0
        q.stop()
        assert faults.call_count(site) > 0
        files = sorted(os.listdir(tmp_path / f"out_{pkg}"))
        out[pkg] = {n: (tmp_path / f"out_{pkg}" / n).read_bytes()
                    for n in files}
    assert out["port"] == out["jax"] and len(out["port"]) == 6
    if site == "storage.dead_letter":
        assert _get("sntc_storage_write_errors_total",
                    artifact="dead_letter_rows") >= 1


def test_disk_fault_marker_degrades_supervisor(tmp_path):
    q, _ = _engine("port", tmp_path / "ckpt", _frames(3))
    sup = R.QuerySupervisor(q, health_json=str(tmp_path / "ckpt" /
                                               "health.json"))
    try:
        R.arm("storage.marker", kind="enospc", times=10)
        sup.tick()
        assert not os.path.exists(tmp_path / "ckpt" / "health.json")
        assert _get("sntc_storage_write_errors_total", artifact="markers") \
            >= 1
        assert sup.health.state_of("storage.markers") == \
            R.HealthState.DEGRADED
        R.clear()
        status = sup.drain_now("test")
        assert status["drained"] is True
        assert os.path.exists(tmp_path / "ckpt" / "drain_marker.json")
        assert sup.health.state_of("storage.markers") == R.HealthState.OK
    finally:
        sup.close()


# ---------------------------------------------------------------------------
# the doctor
# ---------------------------------------------------------------------------


def _journal(root):
    """The batch dead letters' journal under a checkpoint root (a JSONL
    journal both packages write), its directory made."""
    os.makedirs(os.path.join(root, "dead_letter"), exist_ok=True)
    return root / "dead_letter" / "dead_letter.jsonl"


def _make_dirty_root(tmp_path, pkg="jax"):
    """A checkpoint root with one of every kind of damage, served by
    ``pkg``'s engine."""
    from sntc_tpu.flow.state import FlowStateStore

    root = tmp_path / "ckpt"
    q, _ = _engine(pkg, root, _frames(4), wal_mode="append")
    assert q.process_available() == 4
    q.stop()
    _journal(root).write_text('{"ok": 1}\n{"torn')
    store = FlowStateStore(str(root / "flow_state"), keep=2)
    store.publish(2, b"good-state")
    store.publish(4, b"good-state-4")
    snap = store._file(2)
    with open(snap, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"XXX")
    (root / "drain_marker.json").write_text('{"half": ')
    (root / "whatever.json.tmp-123").write_text("orphan")
    rows = root / "dead_letter_rows"
    rows.mkdir()
    (rows / "batch_000001.jsonl").write_text('{"row": 1}\nnot json\n{}\n')
    return root, snap


@pytest.mark.parametrize("served_by", ["port", "jax"])
@pytest.mark.parametrize("repair", [True, False])
def test_fsck_reports_match_jax(tmp_path, served_by, repair):
    root, _snap = _make_dirty_root(tmp_path, served_by)
    trees = _copy_tree(root, ("p", "j"))
    report = PS.fsck(trees["p"], repair=repair)
    jreport = JS.fsck(trees["j"], repair=repair)
    assert _rel(report, trees["p"]) == _rel(jreport, trees["j"])
    assert report["ok"] is repair
    if repair:
        assert _rel(_records(os.path.join(trees["p"],
                                          "storage_repair.jsonl")),
                    trees["p"]) == _rel(_records(os.path.join(
                        trees["j"], "storage_repair.jsonl")), trees["j"])
        # the trees the two doctors leave are the same
        def listing(top):
            return {os.path.relpath(d, top): sorted(files)
                    for d, _dirs, files in os.walk(top)}

        assert listing(trees["p"]) == listing(trees["j"])
        again = PS.fsck(trees["p"], repair=True)
        assert again["ok"] and not again["repaired"] \
            and not again["quarantined"]


def test_fsck_repairs_quarantines_and_reports(tmp_path):
    root, snap = _make_dirty_root(tmp_path, "port")
    report = PS.fsck(str(root), repair=True)
    assert report["ok"] is True
    assert str(_journal(root)) in {r["path"] for r in
                                        report["repaired"]}
    quarantined = {(r["artifact"], os.path.basename(r["path"]))
                   for r in report["quarantined"]}
    assert quarantined == {("flow_state", os.path.basename(snap)),
                           ("markers", "drain_marker.json"),
                           ("dead_letter_rows", "batch_000001.jsonl")}
    assert not os.path.exists(root / "whatever.json.tmp-123")
    actions = {r["action"] for r in _records(root / "storage_repair.jsonl")}
    assert {"truncate_torn_tail", "quarantine_corrupt"} <= actions


def test_fsck_leaves_jax_only_journals(tmp_path):
    """No journal under a serve root is the JAX package's alone any more:
    the model lifecycle's promotion journal is the port's artifact too,
    so both doctors repair the shed, controller and promotion journals
    alike and their reports agree on every artifact."""
    root, _ = _make_dirty_root(tmp_path, "jax")
    for name in ("shed.jsonl", "controller.jsonl", "promotion.jsonl"):
        (root / name).write_text('{"ok": 1}\n{"torn')
    trees = _copy_tree(root, ("p", "j"))
    report = PS.fsck(trees["p"], repair=True)
    jreport = JS.fsck(trees["j"], repair=True)
    for name in ("shed.jsonl", "controller.jsonl", "promotion.jsonl"):
        for tree in trees.values():
            assert open(os.path.join(tree, name)).read() == '{"ok": 1}\n'
    assert {"shed_journal", "controller_journal", "promotion_journal"} \
        <= set(report["checked"])
    assert _rel(report, trees["p"]) == _rel(jreport, trees["j"])
    assert report["ok"] and jreport["ok"]


@pytest.mark.parametrize("marker", ["sealed", "torn"])
@pytest.mark.parametrize("doctor", ["fsck", "quick_scan"])
def test_promotion_journal_and_model_marker_across_packages(
        tmp_path, marker, doctor):
    """A serve root after a promotion (``promotion.jsonl`` with a torn
    tail, ``model_marker.json``), written by either package: each
    package's ``fsck`` and construction-time scan repairs the journal's
    tail, and leaves the marker (or quarantines a torn one) as the other
    package's doctor does."""
    from sntc_tpu_torch.lifecycle import read_model_marker

    for writer in ("port", "jax"):
        root = tmp_path / writer / "root"
        q, _ = _engine(writer, root, _frames(2))
        assert q.process_available() == 2
        q.stop()
        records = [{"action": "shadow_score", "batch_id": 0,
                    "decision": "hold", "ts": 1.0},
                   {"action": "promote", "generation": 1, "ts": 2.0}]
        (root / "promotion.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in records)
            + '{"action": "probation_pa')
        text = (json.dumps({"generation": 1, "action": "promoted",
                            "path": None, "source": None, "ts": 2.0},
                           indent=1) if marker == "sealed"
                else '{"generation": 1, "act')
        (root / "model_marker.json").write_text(text)
        trees = _copy_tree(root, ("p", "j"))
        if doctor == "fsck":
            report = PS.fsck(trees["p"], repair=True)
            jreport = JS.fsck(trees["j"], repair=True)
        else:
            report = PS.quick_scan(trees["p"])
            jreport = JS.quick_scan(trees["j"])
        assert _rel(report, trees["p"]) == _rel(jreport, trees["j"])
        for tree in trees.values():
            with open(os.path.join(tree, "promotion.jsonl")) as f:
                assert [json.loads(line) for line in f] == records
            path = os.path.join(tree, "model_marker.json")
            if marker == "sealed" or doctor == "quick_scan":
                # the light scan reads no marker; fsck keeps a sound one
                assert open(path).read() == text
                if marker == "sealed":
                    assert read_model_marker(tree)["generation"] == 1
            else:
                assert not os.path.exists(path)
        assert sorted(os.listdir(trees["p"])) == sorted(
            os.listdir(trees["j"]))


def test_fsck_corrupt_wal_checkpoint_is_unrepairable(tmp_path):
    q, _ = _engine("port", tmp_path / "ckpt", _frames(7), wal_mode="append",
                   wal_compact_every=2)
    assert q.process_available() == 7
    q.stop()
    path = tmp_path / "ckpt" / "wal_checkpoint.json"
    core = json.loads(path.read_text())
    core["last_committed"] = 999  # forged without resealing
    path.write_text(json.dumps(core))
    trees = _copy_tree(tmp_path / "ckpt", ("p", "j"))
    report = PS.fsck(trees["p"], repair=True)
    assert report["ok"] is False
    assert any("sha256 mismatch" in e["detail"] for e in report["errors"])
    assert _rel(report, trees["p"]) == _rel(JS.fsck(trees["j"], repair=True),
                                            trees["j"])
    with pytest.raises(PS.StorageCorruptError):
        _engine("port", trees["p"], _frames(7), wal_mode="append")


def test_fsck_tenant_tree_and_cli(tmp_path):
    from sntc_tpu.app import main as jax_main
    from sntc_tpu_torch.app import main

    root = tmp_path / "droot"
    for tid in ("a", "b"):
        q, _ = _engine("port", root / "tenant" / tid / "ckpt", _frames(2))
        assert q.process_available() == 2
        q.stop()
    _journal(root / "tenant" / "a" / "ckpt").write_text('{"torn')
    trees = _copy_tree(root, ("p", "j"))
    rc = main(["fsck", trees["p"], "--tenant-tree", "--report",
               str(tmp_path / "p.json")])
    jrc = jax_main(["fsck", trees["j"], "--tenant-tree", "--report",
                    str(tmp_path / "j.json"), "--platform", "cpu"])
    assert rc == jrc == 0
    report = json.loads((tmp_path / "p.json").read_text())
    jreport = json.loads((tmp_path / "j.json").read_text())
    assert _rel(report, trees["p"]) == _rel(jreport, trees["j"])
    assert report["tenant_tree"] is True and report["ok"] is True
    assert {r["tenant"] for r in report["roots"]} == {None, "a", "b"}
    # report only: the damage stays and the exit is 1
    _journal(root / "tenant" / "b" / "ckpt").write_text('{"torn')
    assert main(["fsck", str(root), "--tenant-tree", "--no-repair"]) == 1
    assert _journal(root / "tenant" / "b" / "ckpt").read_text() \
        == '{"torn'


def test_engine_quick_scan_heals_journals(tmp_path):
    for pkg in ("port", "jax"):
        ckpt = tmp_path / pkg
        ckpt.mkdir()
        _journal(ckpt).write_text('{"ok": 1}\n{"torn')
        (ckpt / "x.json.tmp-77").write_text("orphan")
        q, _ = _engine(pkg, ckpt, _frames(1))
        assert q.storage_scan["repaired"] and q.storage_scan["cleaned"]
        assert _journal(ckpt).read_text() == '{"ok": 1}\n'
        assert not (ckpt / "x.json.tmp-77").exists()
        assert "startup_scan" in q.storage_stats()
        q.stop()
    assert _rel(PS.quick_scan(str(tmp_path / "port")), tmp_path / "port") \
        == _rel(JS.quick_scan(str(tmp_path / "jax")), tmp_path / "jax")
    assert PS.quick_scan(str(tmp_path / "absent")) is None


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    train = jax_clean_flows(jax_generate_frame(1500, seed=1))
    pm = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label",
                       handleInvalid="skip"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="features", handleInvalid="skip"),
        JRandomForest(numTrees=2, maxDepth=3, seed=0),
    ]).fit(train)
    return pm, train


def _predict(model, train, jax):
    f = train.slice(0, 300)
    if jax:
        return np.asarray(model.transform(f)["prediction"])
    port = Frame({c: np.asarray(f[c]) for c in f.columns})
    return to_host(model.transform(port)["prediction"])


def _flip_byte(ckpt):
    npz = [os.path.join(d, n) for d, _, ns in os.walk(ckpt) for n in ns
           if n == "data.npz"][0]
    with open(npz, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))


def test_checkpoints_load_across_packages(tmp_path, fitted):
    pm, train = fitted
    want = _predict(pm, train, jax=True)
    jpath = jax_save_model(pm, str(tmp_path / "j"))
    port = load_model(jpath, device="cpu")
    assert verify_checkpoint(jpath) is True
    np.testing.assert_array_equal(_predict(port, train, jax=False), want)
    ppath = save_model(port, str(tmp_path / "p"))
    assert sorted(json.load(open(os.path.join(ppath, "_manifest.json")))
                  ["files"]) == sorted(json.load(open(os.path.join(
                      jpath, "_manifest.json")))["files"])
    assert JS.fsck(ppath)["ok"] and PS.fsck(jpath)["ok"]
    from sntc_tpu.mlio.save_load import verify_checkpoint as jax_verify

    assert jax_verify(ppath) is True
    np.testing.assert_array_equal(
        _predict(jax_load_model(ppath), train, jax=True), want)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_load_model_falls_back_to_prev(tmp_path, fitted, saver):
    pm, train = fitted
    want = _predict(pm, train, jax=True)
    path = str(tmp_path / "model")
    for _ in range(2):  # the second publish keeps the first at .prev
        if saver == "jax":
            jax_save_model(pm, path)
        else:
            save_model(load_model(jax_save_model(pm, str(tmp_path / "src")),
                                  device="cpu"), path)
    assert os.path.isdir(path + ".prev")
    _flip_byte(path)
    with pytest.raises(CheckpointCorruptError, match="sha256 mismatch"):
        verify_checkpoint(path)
    report = PS.fsck(str(tmp_path))
    assert not report["ok"] and report["errors"][0]["artifact"] \
        == "checkpoint"
    with pytest.raises(CheckpointCorruptError):
        load_model(path, device="cpu", fallback=False)
    got = load_model(path, device="cpu")
    np.testing.assert_array_equal(_predict(got, train, jax=False), want)
    ev = R.recent_events(event="ckpt_fallback")
    assert len(ev) == 1 and ev[0]["fallback_path"] == path + ".prev"
    # the JAX package falls back on the same tree the same way
    np.testing.assert_array_equal(
        _predict(jax_load_model(path), train, jax=True), want)
    assert len(J.recent_events(event="ckpt_fallback")) == 1


def test_save_model_failure_keeps_the_previous_checkpoint(tmp_path, fitted):
    pm, _ = fitted
    port = load_model(jax_save_model(pm, str(tmp_path / "src")),
                      device="cpu")
    path = save_model(port, str(tmp_path / "model"))
    before = json.load(open(os.path.join(path, "_manifest.json")))
    R.arm("ckpt.save", kind="io")
    with pytest.raises(OSError):
        save_model(port, path)
    assert json.load(open(os.path.join(path, "_manifest.json"))) == before
    assert not os.path.exists(path + ".prev")
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    R.arm("ckpt.load", kind="exc")
    with pytest.raises(R.InjectedFault):
        load_model(path, device="cpu")


# ---------------------------------------------------------------------------
# disk accounting and the supervisor
# ---------------------------------------------------------------------------


def test_storage_plane_usage_and_budget(tmp_path):
    q, _ = _engine("port", tmp_path / "ckpt", _frames(5), wal_mode="append")
    assert q.process_available() == 5
    q.stop()
    plane = PS.StoragePlane(str(tmp_path / "ckpt"), budget_bytes=10,
                            min_interval_s=0.0)
    jplane = JS.StoragePlane(str(tmp_path / "ckpt"), budget_bytes=10,
                             min_interval_s=0.0)
    status, jstatus = plane.status(), jplane.status()
    assert status == jstatus
    assert status["over_budget"] is True and "wal_append" in \
        status["artifacts"]
    assert _get("sntc_disk_bytes", artifact="total") == \
        status["total_bytes"] > 10
    assert _get("sntc_disk_budget_bytes") == 10
    plane.status()
    assert len(R.recent_events(event="disk_budget_exceeded")) == 1
    plane.budget_bytes = 10 ** 9
    assert plane.status()["over_budget"] is False
    assert R.recent_events(event="storage_recovered")[-1]["artifact"] \
        == "budget"


def test_supervisor_status_carries_storage_block(tmp_path):
    blocks = {}
    for pkg, mod in (("port", R), ("jax", J)):
        # both engines in the JAX engine's default, serial form: three
        # ticks commit the same batches whatever the threads' timing
        serial = {"overlap_sink": False} if pkg == "port" else {}
        q, _ = _engine(pkg, tmp_path / pkg, _frames(3), wal_mode="append",
                       wal_compact_every=2, **serial)
        sup = mod.QuerySupervisor(q, disk_budget_mb=1.0)
        try:
            for _ in range(3):
                sup.tick()
            st = sup.status()["storage"]
        finally:
            sup.close()
            q.stop()
        assert st["disk"]["budget_bytes"] == 1 << 20
        assert st["disk"]["total_bytes"] > 0
        st["disk"] = {k: v for k, v in st["disk"].items()
                      if k not in ("total_bytes", "artifacts")}
        blocks[pkg] = st
    assert blocks["port"] == blocks["jax"]
    assert blocks["port"]["wal_mode"] == "append"
    assert blocks["port"]["wal_compactions"] >= 1


def test_disk_budget_degrades_health(tmp_path):
    q, _ = _engine("port", tmp_path / "ckpt", _frames(2))
    sup = R.QuerySupervisor(q, disk_budget_mb=0.00001,
                            health_json=str(tmp_path / "h.json"))
    try:
        # the first dump measures the breach, the second shows its health
        sup.tick()
        sup.tick()
        status = json.load(open(tmp_path / "h.json"))
    finally:
        sup.close()
        q.stop()
    assert status["storage"]["disk"]["over_budget"] is True
    assert status["health"]["components"]["storage.budget"]["state"] \
        == "DEGRADED"
    assert status["health"]["overall"] == "DEGRADED"


# ---------------------------------------------------------------------------
# the registry against the write sites
# ---------------------------------------------------------------------------

_WRITE_RE = re.compile(r"""open\([^)\n]*["']a["']|os\.replace\(""")
_ANNOTATION_RE = re.compile(r"#\s*storage:\s*([A-Za-z0-9_-]+(?:\([^)]*\))?)")


ARTIFACT_KEYS = ("name", "kind", "site", "patterns", "failure_policy")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                yield os.path.relpath(path, REPO), open(path).read()


def test_artifacts_pinned_against_write_sites():
    """Every append-mode open and atomic rename of the port outside the
    storage plane names a registered artifact (or declares itself
    ``unbounded(<reason>)``); every artifact the port writes has a write
    site; every artifact's fault site is declared; and the registry is
    the JAX package's, the fleet's and the replication plane's
    artifacts included."""
    problems, named = [], set()
    for rel, text in _port_sources():
        for i, line in enumerate(text.splitlines(), 1):
            for m in _ANNOTATION_RE.finditer(line):
                named.add(m.group(1))
            if rel.endswith(os.path.join("resilience", "storage.py")):
                continue
            if not _WRITE_RE.search(line):
                continue
            m = _ANNOTATION_RE.search(line)
            ann = m.group(1) if m else None
            if ann is None:
                problems.append(f"{rel}:{i}: unannotated durable write")
            elif not (ann.startswith("unbounded(")
                      or ann == "registered-artifact"
                      or ann in PS.ARTIFACTS):
                problems.append(f"{rel}:{i}: unknown artifact {ann!r}")
    assert problems == []
    sources = "\n".join(text for _, text in _port_sources())
    for name, spec in PS.ARTIFACTS.items():
        jspec = JS.ARTIFACTS[name]
        assert [getattr(spec, k) for k in ARTIFACT_KEYS] == [
            getattr(jspec, k) for k in ARTIFACT_KEYS], name
        assert spec.site in R.SITES, name
        assert name in named or f'"{name}"' in sources.replace(
            'ArtifactSpec(\n            "' + name, ""), name
    assert set(JS.ARTIFACTS) - set(PS.ARTIFACTS) == set()
    for kind in R.IO_KINDS:
        assert kind in R.ALL_KINDS


# ---------------------------------------------------------------------------
# the commands: kill at commit, fsck, restart
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, fitted):
    pm, _ = fitted
    return jax_save_model(pm, str(tmp_path_factory.mktemp("st") / "model"))


def _run(args, env_extra=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu", SNTC_FAULTS="")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _serve_args(model_dir, watch, out, ckpt):
    return ["sntc_tpu_torch", "serve", "--model", model_dir, "--watch",
            watch, "--out", out, "--checkpoint", ckpt, "--shape-buckets",
            "64", "--max-files-per-batch", "1", "--wal-mode", "append",
            "--once", "--device", "cpu"]


def test_serve_killed_at_commit_then_fsck_and_restart(tmp_path, model_dir):
    rows = jax_clean_flows(jax_generate_frame(800, seed=9)).drop("Label")
    watch = tmp_path / "in"
    watch.mkdir()
    for i in range(5):
        part = rows.slice(150 * i, 150 * (i + 1))
        write_raw_csv(Frame({c: np.asarray(part[c]) for c in part.columns}),
                      str(watch / f"part_{i:04d}.csv"))
    clean = _run(_serve_args(model_dir, str(watch), str(tmp_path / "oc"),
                             str(tmp_path / "cc")))
    assert clean.returncode == 0, clean.stderr[-2000:]
    want = {n: (tmp_path / "oc" / n).read_bytes()
            for n in sorted(os.listdir(tmp_path / "oc"))}

    out, ckpt = str(tmp_path / "o"), str(tmp_path / "c")
    killed = _run(_serve_args(model_dir, str(watch), out, ckpt),
                  {"SNTC_FAULTS": "stream.commit:kill:0.5:2"})
    assert killed.returncode == 137
    commits = _records(os.path.join(ckpt, "commits.log"))
    assert len(commits) < 5
    # what a crash in the middle of the next commit's append leaves
    with open(os.path.join(ckpt, "commits.log"), "a") as f:
        f.write('{"batch_id": %d, "start"' % len(commits))
    shutil.copytree(ckpt, str(tmp_path / "cj"))
    doctor = _run(["sntc_tpu_torch", "fsck", ckpt])
    jdoctor = _run(["sntc_tpu", "fsck", str(tmp_path / "cj"), "--platform",
                    "cpu"])
    assert doctor.returncode == jdoctor.returncode == 0, doctor.stdout
    report = json.loads(doctor.stdout)
    assert [r["action"] for r in report["repaired"]] == [
        "truncate_torn_tail"]
    assert _rel(report, ckpt) == _rel(json.loads(jdoctor.stdout),
                                      str(tmp_path / "cj"))
    restart = _run(_serve_args(model_dir, str(watch), out, ckpt))
    assert restart.returncode == 0, restart.stderr[-2000:]
    assert json.loads(restart.stdout.strip().splitlines()[-1])["batches"] \
        == 5 - len(commits)
    assert {n: open(os.path.join(out, n), "rb").read()
            for n in sorted(os.listdir(out))} == want
    assert [r["batch_id"] for r in _records(
        os.path.join(ckpt, "commits.log"))] == list(range(5))

    path = os.path.join(ckpt, "wal_checkpoint.json")
    with open(path, "w") as f:
        json.dump(PS.seal_record({"version": 1, "last_committed": 4,
                                  "end": 5, "pending": {}}) | {"end": 6}, f)
    forged = _run(["sntc_tpu_torch", "fsck", ckpt, "--report",
                   str(tmp_path / "r.json")])
    assert forged.returncode == 1
    assert not json.load(open(tmp_path / "r.json"))["ok"]
