"""The port's warm-standby replication against the JAX package's, on the
CPU: the counterparts of ``tests/test_replicate.py``.

Every case runs the same inputs through both packages, each in a
directory of its own, with the replication plane's wall clock pinned,
and holds the two records equal: plane statuses, barrier records,
replica trees byte for byte (the manifest's ``primary_root`` taken
relative to the run's directory), promotion reports and sink bytes:

* the ship/barrier protocol: a barrier a commit, a ``repl.ship`` fault
  that degrades and catches up, a plane restart reconciling the gap's
  rows from the sink;
* promotion: a torn-ship stray quarantined, a diverged replica refused
  (no tree left behind), a missing manifest refused, a torn barrier tail
  skipped, and the mid-arc drill over WAL mode x lifecycle (the restart
  on the promoted tree finishes bitwise with the unfailed reference);
* ``fsck_standby``'s detection and repair;
* a replica written by either package promotes with the other's
  ``promote_standby`` to the same tree, also from a lost primary with a
  shipped but unsealed tail (the same truncation, tail loss and law);
* the flags across the layers, and the parsers' defaults against the
  JAX parser's;
* the kills inside ``repl.ship`` / ``repl.apply`` / ``repl.barrier`` in
  port worker processes, held to the JAX harness's unkilled run
  (``scripts/chaos_crash_matrix.py``);
* on the card, a replicated ``serve`` promotes to the CPU's sink bytes.
"""

import glob
import importlib.util
import inspect
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sntc_tpu.resilience as JR
import sntc_tpu.resilience.replicate as JRep
import sntc_tpu.resilience.storage as JStorage
import sntc_tpu.serve as JS
import sntc_tpu_torch.resilience as R
import sntc_tpu_torch.resilience.replicate as PRep
import sntc_tpu_torch.resilience.storage as PStorage
import sntc_tpu_torch.serve as PS
from sntc_tpu.core.base import Transformer as JTransformer
from sntc_tpu.obs import metrics as JM
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.obs import metrics as PM
from sntc_tpu_torch.resilience.faults import KILL_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED_WALL = 1_700_000_000.0

torch.set_num_threads(1)


class _JaxIdentity(JTransformer):
    def transform(self, frame):
        return frame


class _PortIdentity(Transformer):
    def transform(self, frame):
        return frame


def _pkg(name):
    if name == "jax":
        return SimpleNamespace(
            name="jax", R=JR, rep=JRep, storage=JStorage, S=JS, M=JM,
            Identity=_JaxIdentity, qkw={"pipeline_depth": 1})
    return SimpleNamespace(
        name="port", R=R, rep=PRep, storage=PStorage, S=PS, M=PM,
        Identity=_PortIdentity,
        qkw={"pipeline_depth": 1, "overlap_sink": False, "device": "cpu"})


PKGS = ("jax", "port")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("SNTC_FAULTS", raising=False)
    for name in PKGS:
        P = _pkg(name)
        # the planes' and promotions' wall clock (barrier and manifest
        # "wall", rpo_seconds) pinned, so both packages' bytes compare
        monkeypatch.setattr(P.rep, "time", SimpleNamespace(
            time=lambda: PINNED_WALL, monotonic=time.monotonic))
        P.R.clear()
        P.R.clear_events()
        P.R.reset_breakers()
        P.storage.reset_degradation()
        P.M.reset_registry()
    yield
    for name in PKGS:
        P = _pkg(name)
        P.R.clear()
        P.R.clear_events()
        P.R.reset_breakers()
        P.storage.reset_degradation()
        P.M.reset_registry()


def _both(run, tmp_path):
    """``run(P, dir)`` for the JAX package and the port, each in a
    directory of its own; the two records must be equal.  The port's."""
    got = {name: run(_pkg(name), str(tmp_path / name)) for name in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


def _get(P, name, **labels):
    return P.M.registry().get(name, **labels) or 0


def _norm(obj, d):
    """Paths under ``d`` made relative, the promotion's wall time out."""
    if isinstance(obj, dict):
        return {k: _norm(v, d) for k, v in obj.items()
                if k != "rto_seconds"}
    if isinstance(obj, (list, tuple)):
        return [_norm(v, d) for v in obj]
    if isinstance(obj, str) and d in obj:
        return obj.replace(os.path.abspath(d), "<d>").replace(d, "<d>")
    return obj


def _tree(root, d):
    """Every file under ``root`` by relative path: the bytes, and a
    replica manifest parsed with its paths relative to ``d`` (its seal
    hashes the absolute ``primary_root``, so it goes too)."""
    out = {}
    for p in sorted(glob.glob(os.path.join(root, "**", "*"),
                              recursive=True)):
        if not os.path.isfile(p):
            continue
        rel = os.path.relpath(p, root)
        with open(p, "rb") as f:
            data = f.read()
        if os.path.basename(p) == "replica_manifest.json":
            doc = json.loads(data)
            doc.pop("sha256", None)
            data = _norm(doc, d)
        out[rel] = data
    return out


def _write_inputs(watch, n=4, rows=6):
    os.makedirs(watch, exist_ok=True)
    for i in range(n):
        with open(os.path.join(watch, f"in_{i:03d}.csv"), "w") as f:
            f.write("x\n")
            for r in range(rows):
                f.write(f"{i * 1000 + r}\n")


def _sink_bytes(out):
    state = {}
    for p in sorted(glob.glob(os.path.join(out, "batch_*.csv"))):
        with open(p, "rb") as f:
            state[os.path.basename(p)] = f.read()
    return state


def _dirs(d):
    return tuple(os.path.join(d, x) for x in ("in", "out", "ckpt", "standby"))


def _engine(P, watch, out, ckpt, plane, **kw):
    return P.S.StreamingQuery(
        P.Identity(), P.S.FileStreamSource(watch),
        P.S.CsvDirSink(out, columns=["x"]), ckpt, max_batch_offsets=1,
        commit_listener=plane.on_commit if plane else None,
        **dict(P.qkw, **kw))


def _run(P, q, max_batches):
    """The JAX engine's ``run(max_batches=)``; the port's engine steps
    rounds until that many batches committed."""
    if P.name == "jax":
        return q.run(max_batches=max_batches, poll_interval=0.01)
    done = 0
    while done < max_batches:
        before = q.last_committed()
        if not q._run_one_batch():
            break
        done += q.last_committed() - before
    return done


def _replicate(P, d, n=2):
    """n committed batches shipped to the standby; the dirs."""
    watch, out, ckpt, standby = _dirs(d)
    _write_inputs(watch, n=n)
    plane = P.rep.ReplicationPlane(ckpt, standby, sink_dir=out)
    q = _engine(P, watch, out, ckpt, plane)
    assert q.process_available() == n
    q.stop()
    plane.close()
    return watch, out, ckpt, standby


def _promote(P, standby, dest, ckpt=None, out=None, **kw):
    return P.rep.promote_standby(
        standby, "default", os.path.join(dest, "ckpt"),
        dest_sink=os.path.join(dest, "out"), primary_root=ckpt,
        primary_sink=out, **kw)


# ---------------------------------------------------------------------------
# the ship/barrier protocol
# ---------------------------------------------------------------------------


def test_every_commit_ships_and_seals_a_barrier(tmp_path):
    def run(P, d):
        watch, out, ckpt, standby = _dirs(d)
        _write_inputs(watch, n=3)
        plane = P.rep.ReplicationPlane(ckpt, standby, sink_dir=out)
        q = _engine(P, watch, out, ckpt, plane)
        assert q.process_available() == 3
        q.stop()
        st = plane.status()
        assert st["ships"] == 3 and st["barriers_sealed"] == 3
        assert st["ship_errors"] == 0 and st["pending_batches"] == 0
        bar = P.rep.last_barrier(standby, "default")
        assert bar["batch_id"] == 2 and bar["batches_through"] == 3
        assert bar["rows_through"] == 18 and bar["rows_exact"] is True
        rep = P.rep.replica_dir(standby, "default")
        man = P.storage.load_sealed_json(
            os.path.join(rep, P.rep.MANIFEST_NAME))
        assert "commits/2.json" in man["files"]
        assert "batch_000002.csv" in man["sink"]
        assert _sink_bytes(os.path.join(rep, "sink")) == _sink_bytes(out)
        return {
            "status": st, "standby": _tree(standby, d),
            "sealed": _get(P, "sntc_repl_barriers_sealed_total",
                           tenant="default"),
            "lag": _get(P, "sntc_repl_lag_batches", tenant="default"),
            "ships": _get(P, "sntc_repl_ships_total", tenant="default",
                          outcome="completed"),
        }

    got = _both(run, tmp_path)
    assert (got["sealed"], got["lag"], got["ships"]) == (3, 0, 3)


def test_ship_failure_degrades_and_catches_up(tmp_path):
    def run(P, d):
        watch, out, ckpt, standby = _dirs(d)
        _write_inputs(watch, n=2)
        plane = P.rep.ReplicationPlane(ckpt, standby, sink_dir=out)
        q = _engine(P, watch, out, ckpt, plane)
        P.R.arm("repl.ship", kind="io", times=1)
        assert q.process_available() == 2  # the engine never sees it
        q.stop()
        return {
            "status": plane.status(),
            "barrier": P.rep.last_barrier(standby, "default"),
            "errors": _get(P, "sntc_repl_ships_total", tenant="default",
                           outcome="error"),
            "events": len(P.R.recent_events(event="replication_error")),
            "standby": _tree(standby, d),
        }

    got = _both(run, tmp_path)
    st, bar = got["status"], got["barrier"]
    assert st["ship_errors"] == 1 and st["barriers_sealed"] == 1
    assert bar["batches_through"] == 2 and bar["rows_through"] == 12
    assert bar["rows_exact"] is True
    assert got["errors"] == 1 and got["events"] == 1


def test_plane_restart_reconciles_gap_rows_from_sink(tmp_path):
    def run(P, d):
        watch, out, ckpt, standby = _dirs(d)
        _write_inputs(watch, n=4)
        plane = P.rep.ReplicationPlane(ckpt, standby, sink_dir=out)
        q1 = _engine(P, watch, out, ckpt, plane)
        assert _run(P, q1, 2) == 2
        q1.stop()
        plane.close()
        # batch 2 commits while the plane is down
        q2 = _engine(P, watch, out, ckpt, None)
        assert _run(P, q2, 1) == 1
        q2.stop()
        plane2 = P.rep.ReplicationPlane(ckpt, standby, sink_dir=out)
        q3 = _engine(P, watch, out, ckpt, plane2)
        assert q3.process_available() == 1
        q3.stop()
        return {"barrier": P.rep.last_barrier(standby, "default"),
                "standby": _tree(standby, d)}

    bar = _both(run, tmp_path)["barrier"]
    assert bar["batch_id"] == 3 and bar["batches_through"] == 4
    assert bar["rows_through"] == 24 and bar["rows_exact"] is True


# ---------------------------------------------------------------------------
# promotion drills
# ---------------------------------------------------------------------------


def test_torn_ship_stray_quarantines_and_never_promotes(tmp_path):
    def run(P, d):
        _watch, out, ckpt, standby = _replicate(P, d)
        tree = os.path.join(P.rep.replica_dir(standby, "default"), "tree")
        with open(os.path.join(tree, "commits", "99.json"), "w") as f:
            json.dump({"batch_id": 99, "start": 0, "end": 0}, f)
        dest = os.path.join(d, "promoted")
        rep = _promote(P, standby, dest, ckpt, out)
        assert rep["ok"] is True, rep
        for q_rec in rep["quarantined"]:
            assert ".corrupt" in q_rec["to"] and os.path.exists(q_rec["to"])
        return {"report": _norm(rep, d), "promoted": _tree(dest, d)}

    got = _both(run, tmp_path)
    rep = got["report"]
    assert any(q["rel"].endswith("99.json") for q in rep["quarantined"])
    assert os.path.join("ckpt", "commits", "99.json") not in got["promoted"]
    assert rep["law_exact"] is True and rep["tail_loss_batches"] == 0


def test_diverged_replica_refuses_promotion_and_leaves_no_tree(tmp_path):
    def run(P, d):
        _watch, out, ckpt, standby = _replicate(P, d)
        tree = os.path.join(P.rep.replica_dir(standby, "default"), "tree")
        with open(os.path.join(tree, "commits", "1.json"), "w") as f:
            json.dump({"batch_id": 1, "start": 0, "end": 999999}, f)
        dest = os.path.join(d, "promoted")
        rep = _promote(P, standby, dest, ckpt, out)
        return {
            "report": _norm(rep, d),
            "left": glob.glob(os.path.join(dest, "**", "*"), recursive=True),
            "failed": _get(P, "sntc_repl_promotions_total",
                           outcome="failed"),
            "divergence": _get(P, "sntc_repl_divergence_total",
                               tenant="default"),
            "events": len(P.R.recent_events(event="replica_diverged")),
        }

    got = _both(run, tmp_path)
    assert got["report"]["ok"] is False
    assert "diverges" in got["report"]["reason"]
    assert got["left"] == [] and got["failed"] == 1
    assert got["divergence"] >= 1 and got["events"] >= 1


def test_promotion_refuses_without_sealed_manifest(tmp_path):
    def run(P, d):
        _watch, _out, _ckpt, standby = _replicate(P, d)
        os.unlink(os.path.join(P.rep.replica_dir(standby, "default"),
                               P.rep.MANIFEST_NAME))
        dest = os.path.join(d, "promoted")
        rep = P.rep.promote_standby(standby, "default",
                                    os.path.join(dest, "ckpt"))
        left = glob.glob(os.path.join(dest, "**", "*"), recursive=True)
        rep["divergences"] = [e["kind"] for e in rep["divergences"]]
        return {"report": _norm(rep, d), "left": left}

    got = _both(run, tmp_path)
    assert got["report"]["ok"] is False
    assert "manifest" in got["report"]["reason"] and got["left"] == []


def test_torn_barrier_tail_is_skipped_not_trusted(tmp_path):
    def run(P, d):
        _watch, out, ckpt, standby = _replicate(P, d)
        log = os.path.join(P.rep.replica_dir(standby, "default"),
                           "barriers.jsonl")
        with open(log, "a") as f:
            f.write('{"batch_id": 7, "batches_through": 8, "rows_t')
        bar = P.rep.last_barrier(standby, "default")
        dest = os.path.join(d, "promoted")
        rep = _promote(P, standby, dest, ckpt)
        return {"barrier": bar, "report": _norm(rep, d),
                "promoted": _tree(dest, d)}

    got = _both(run, tmp_path)
    assert got["barrier"]["batch_id"] == 1
    assert got["barrier"]["batches_through"] == 2
    assert got["report"]["ok"] is True
    assert got["report"]["batches_through"] == 2


# ---------------------------------------------------------------------------
# the mid-arc drill, restart-equivalent across WAL modes x lifecycle
# ---------------------------------------------------------------------------


def _const_class_pipeline(P, positive):
    """A servable pipeline predicting one class everywhere."""
    if P.name == "jax":
        from sntc_tpu.core.base import PipelineModel
        from sntc_tpu.feature import VectorAssembler
        from sntc_tpu.models.logistic_regression import (
            LogisticRegressionModel,
        )
        dev = {}
    else:
        from sntc_tpu_torch.core.base import PipelineModel
        from sntc_tpu_torch.feature import VectorAssembler
        from sntc_tpu_torch.models.logistic_regression import (
            LogisticRegressionModel,
        )
        dev = {"device": "cpu"}
    head = LogisticRegressionModel(
        coefficient_matrix=np.zeros((2, 1), np.float32),
        intercepts=np.asarray([0.0, 50.0 if positive else -50.0],
                              np.float32),
        is_binomial=True, **dev)
    return PipelineModel(stages=[
        VectorAssembler(inputCols=["x"], outputCol="features"), head])


def _lifecycle_pkg(P):
    if P.name == "jax":
        from sntc_tpu.lifecycle import LifecycleManager, ModelPromoter
        from sntc_tpu.mlio import load_model, save_model
        return LifecycleManager, ModelPromoter, load_model, save_model, {}
    from sntc_tpu_torch.lifecycle import LifecycleManager, ModelPromoter
    from sntc_tpu_torch.mlio import load_model, save_model
    return (LifecycleManager, ModelPromoter, load_model, save_model,
            {"device": "cpu"})


def _lifecycle_arc(P, watch, out, ckpt, serving_path, *, plane=None,
                   stop_after=None, wal_kwargs=None):
    """The arc with a real promotion after batch 1: class 0 through
    batch 1, class 1 after; ``stop_after`` stops the engine once that
    many batches committed."""
    LM, MP, load_model, save_model, dev = _lifecycle_pkg(P)
    candidate_path = serving_path + ".candidate"
    if not os.path.isdir(serving_path):
        save_model(_const_class_pipeline(P, False), serving_path)
        save_model(_const_class_pipeline(P, True), candidate_path)
    model = load_model(serving_path, **dev)
    promoter = MP(model, incumbent_raw=model, serving_path=serving_path,
                  checkpoint_dir=ckpt, probation_batches=1, **dev)
    q = P.S.StreamingQuery(
        model, P.S.FileStreamSource(watch),
        P.S.CsvDirSink(out, columns=["x", "prediction"]), ckpt,
        max_batch_offsets=1, lifecycle=LM(promoter=promoter),
        commit_listener=plane.on_commit if plane else None,
        **dict(P.qkw, **(wal_kwargs or {})))
    done = _run(P, q, 2)
    promoter.load_candidate(candidate_path)
    promoter.promote()
    if stop_after is not None:
        done += _run(P, q, stop_after - done)
    else:
        done += q.process_available()
    q.stop()
    return done


LIFECYCLE_FILES = ("model_marker.json", "promotion.jsonl")


def _without(tree, basenames):
    """A ``_tree`` record without the named files, in the manifest too."""
    out = {}
    for rel, data in tree.items():
        if os.path.basename(rel) in basenames:
            continue
        if isinstance(data, dict):
            data = dict(data, files={
                k: v for k, v in data["files"].items()
                if os.path.basename(k) not in basenames})
        out[rel] = data
    return out


def _plain_arc(P, watch, out, ckpt, *, plane=None, stop_after=None,
               wal_kwargs=None):
    q = _engine(P, watch, out, ckpt, plane, **(wal_kwargs or {}))
    done = (_run(P, q, stop_after) if stop_after is not None
            else q.process_available())
    q.stop()
    return done


@pytest.mark.parametrize("wal_mode,lifecycle", [
    ("files", False),
    ("files", True),
    ("append", False),
    ("append", True),
], ids=["files", "files-lifecycle", "append", "append-lifecycle"])
def test_promote_standby_mid_arc_restart_equivalent(
    tmp_path, wal_mode, lifecycle,
):
    """The primary dies after batch 3 of 6; the standby promotes to the
    last sealed barrier (the law exact, the promoted sink the
    reference's first four files) and an engine restarted on the
    promoted tree finishes the arc bitwise with the unfailed
    reference."""
    wal_kwargs = ({"wal_mode": "append", "wal_compact_every": 2}
                  if wal_mode == "append" else {})

    def run(P, d):
        arc = ((lambda *a, **k: _lifecycle_arc(P, *a, **k)) if lifecycle
               else (lambda *a, **k: _plain_arc(P, *a, **k)))
        watch = os.path.join(d, "in")
        _write_inputs(watch, n=6)
        ref = os.path.join(d, "ref")
        ref_args = [os.path.join(ref, "model")] if lifecycle else []
        assert arc(watch, os.path.join(ref, "out"),
                   os.path.join(ref, "ckpt"), *ref_args,
                   wal_kwargs=wal_kwargs) == 6
        ref_sink = _sink_bytes(os.path.join(ref, "out"))
        pri = os.path.join(d, "pri")
        out, ckpt = os.path.join(pri, "out"), os.path.join(pri, "ckpt")
        standby = os.path.join(d, "standby")
        plane = P.rep.ReplicationPlane(ckpt, standby, sink_dir=out)
        pri_args = [os.path.join(pri, "model")] if lifecycle else []
        assert arc(watch, out, ckpt, *pri_args, plane=plane, stop_after=4,
                   wal_kwargs=wal_kwargs) == 4
        plane.close()
        dest = os.path.join(d, "promoted")
        dest_out, dest_ckpt = (os.path.join(dest, "out"),
                               os.path.join(dest, "ckpt"))
        rep = _promote(P, standby, dest, ckpt, out)
        assert rep["ok"] is True, rep
        promoted_sink = _sink_bytes(dest_out)
        has_marker = os.path.exists(
            os.path.join(dest_ckpt, "model_marker.json"))
        if lifecycle:
            _LM, _MP, load_model, _save, dev = _lifecycle_pkg(P)
            q = P.S.StreamingQuery(
                load_model(os.path.join(pri, "model"), **dev),
                P.S.FileStreamSource(watch),
                P.S.CsvDirSink(dest_out, columns=["x", "prediction"]),
                dest_ckpt, max_batch_offsets=1,
                **dict(P.qkw, **wal_kwargs))
        else:
            q = _engine(P, watch, dest_out, dest_ckpt, None, **wal_kwargs)
        assert q.process_available() == 2
        q.stop()
        report, tree = _norm(rep, d), _tree(standby, d)
        if lifecycle:
            # the lifecycle's own records hold its wall clock and the
            # model's absolute path: the plane ships them as they are
            report.pop("promoted_bytes")
            tree = _without(tree, LIFECYCLE_FILES)
        return {"report": report, "ref_sink": ref_sink,
                "promoted_sink": promoted_sink, "marker": has_marker,
                "final_sink": _sink_bytes(dest_out), "standby": tree}

    got = _both(run, tmp_path)
    rep = got["report"]
    assert rep["batches_through"] == 4 and rep["rows_through"] == 24
    assert rep["law_exact"] is True and rep["tail_loss_batches"] == 0
    assert rep["rows_exact"] is True
    assert got["promoted_sink"] == {
        k: v for k, v in got["ref_sink"].items() if k <= "batch_000003.csv"}
    assert got["marker"] is lifecycle
    assert got["final_sink"] == got["ref_sink"]


# ---------------------------------------------------------------------------
# anti-entropy, and promotion across the packages
# ---------------------------------------------------------------------------


def test_fsck_standby_detects_and_repairs_divergence(tmp_path):
    def run(P, d):
        _watch, out, ckpt, standby = _replicate(P, d)
        tree = os.path.join(P.rep.replica_dir(standby, "default"), "tree")
        victim = os.path.join(tree, "commits", "0.json")
        with open(victim, "w") as f:
            f.write('{"rot": true}')
        rep = P.rep.fsck_standby(standby, primary_root=ckpt)
        counted = _get(P, "sntc_repl_divergence_total", tenant="default")
        events = len(P.R.recent_events(event="replica_diverged"))
        P.rep.fsck_standby(standby, primary_root=ckpt, repair=True)
        gone = not os.path.exists(victim)
        plane = P.rep.ReplicationPlane(ckpt, standby, sink_dir=out)
        plane.sync()
        rep2 = P.rep.fsck_standby(standby, primary_root=ckpt)
        return {"report": _norm(rep, d), "counted": counted,
                "events": events, "gone": gone,
                "healed": _norm(rep2, d)}

    got = _both(run, tmp_path)
    assert got["report"]["ok"] is False
    div = got["report"]["tenants"]["default"]["divergences"]
    assert any(x["kind"] == "hash" for x in div)
    assert got["counted"] >= 1 and got["events"] >= 1 and got["gone"]
    assert got["healed"]["ok"] is True


def test_replica_of_either_package_promotes_with_the_other(tmp_path):
    """The same inputs replicated by each package at the same paths give
    byte-identical standby trees; each package's ``promote_standby`` of
    the other's replica gives the same promoted tree and report."""
    work = str(tmp_path / "w")
    standbys, trees = {}, {}
    for name in PKGS:
        P = _pkg(name)
        shutil.rmtree(work, ignore_errors=True)
        _watch, out, ckpt, standby = _replicate(P, work, n=3)
        trees[name] = _tree(work, work)
        standbys[name] = str(tmp_path / f"standby_{name}")
        shutil.copytree(standby, standbys[name])
    assert trees["port"] == trees["jax"]
    reports, promoted = {}, {}
    for writer, promoter in (("port", "jax"), ("jax", "port")):
        P = _pkg(promoter)
        dest = str(tmp_path / f"{writer}_by_{promoter}")
        rep = P.rep.promote_standby(
            standbys[writer], "default", os.path.join(dest, "ckpt"),
            dest_sink=os.path.join(dest, "out"))
        assert rep["ok"] is True, rep
        reports[writer] = _norm(_norm(rep, dest), standbys[writer])
        promoted[writer] = _tree(dest, dest)
    assert reports["port"] == reports["jax"]
    assert promoted["port"] == promoted["jax"]
    assert sorted(promoted["port"]) == [
        "ckpt/commits/0.json", "ckpt/commits/1.json", "ckpt/commits/2.json",
        "ckpt/offsets/0.json", "ckpt/offsets/1.json", "ckpt/offsets/2.json",
        "out/batch_000000.csv", "out/batch_000001.csv",
        "out/batch_000002.csv"]


def test_lost_primary_with_a_shipped_tail_promotes_alike(tmp_path):
    """A primary lost with its last batch shipped but not sealed
    (``barrier_every=2``, 3 commits, one unsealed ship): each package's
    ``promote_standby`` of the other's replica, given the lost primary,
    truncates to the barrier, counts the same tail loss under the exact
    law and publishes the same tree."""
    work = str(tmp_path / "w")
    kept = {}
    for name in PKGS:
        P = _pkg(name)
        shutil.rmtree(work, ignore_errors=True)
        watch, out, ckpt, standby = _dirs(work)
        _write_inputs(watch, n=3)
        plane = P.rep.ReplicationPlane(ckpt, standby, sink_dir=out,
                                       barrier_every=2)
        q = _engine(P, watch, out, ckpt, plane)
        assert q.process_available() == 3
        q.stop()
        plane.sync()  # the tail ships; the primary dies before its barrier
        kept[name] = str(tmp_path / f"kept_{name}")
        shutil.copytree(work, kept[name])
    reports, promoted = {}, {}
    for writer, promoter in (("port", "jax"), ("jax", "port")):
        P = _pkg(promoter)
        _watch, out, ckpt, standby = _dirs(kept[writer])
        dest = str(tmp_path / f"{writer}_by_{promoter}")
        rep = _promote(P, standby, dest, ckpt=ckpt, out=out)
        assert rep["ok"] is True and rep["law_exact"] is True, rep
        reports[writer] = _norm(_norm(rep, dest), kept[writer])
        promoted[writer] = _tree(dest, dest)
    assert reports["port"] == reports["jax"]
    assert promoted["port"] == promoted["jax"]
    rep = reports["port"]
    assert (rep["batches_through"], rep["committed_primary"],
            rep["tail_loss_batches"]) == (2, 3, 1)
    # batch 2's offset and commit records and its sink file go
    assert rep["truncated"] == {"wal_records": 2, "sink_files": 1}
    assert sorted(p for p in promoted["port"] if p.startswith("out/")) == [
        "out/batch_000000.csv", "out/batch_000001.csv"]


# ---------------------------------------------------------------------------
# the flags across the layers, and the parsers
# ---------------------------------------------------------------------------


REPL_FLAGS = {"standby_root": "--standby-root",
              "barrier_every": "--repl-barrier-every"}


def test_repl_flags_consistent_across_layers():
    """Each replication flag is on ``serve`` and on the daemon's shared
    flags (``serve-daemon``, ``fleet-serve``), each knob is a
    ``ReplicationPlane`` parameter, the ``sntc_repl_*`` family is the
    JAX catalog's, and the README documents both flags."""
    from sntc_tpu_torch.app import build_parser

    sub = next(a for a in build_parser()._actions
               if a.__class__.__name__ == "_SubParsersAction")
    for cmd in ("serve", "serve-daemon", "fleet-serve"):
        opts = {o for a in sub.choices[cmd]._actions
                for o in a.option_strings}
        for flag in REPL_FLAGS.values():
            assert flag in opts, (cmd, flag)
    params = set(inspect.signature(PRep.ReplicationPlane).parameters)
    assert set(REPL_FLAGS) <= params
    family = {n for n in PM.CATALOG if n.startswith("sntc_repl_")}
    assert family == {n for n in JM.CATALOG if n.startswith("sntc_repl_")}
    assert len(family) == 10
    with open(os.path.join(REPO, "README.md")) as f:
        readme = f.read()
    for flag in REPL_FLAGS.values():
        assert flag in readme, flag


def _defaults(app, cmd, fn, required, monkeypatch):
    seen = {}
    monkeypatch.setattr(app, fn, lambda args: seen.update(vars(args)) or 0)
    assert app.main([cmd] + required) == 0
    return seen


@pytest.mark.parametrize("cmd,fn,required", [
    ("serve", "cmd_serve", ["--model", "m", "--watch", "w", "--out", "o",
                            "--checkpoint", "c"]),
    ("serve-daemon", "cmd_serve_daemon", ["--tenants", "t", "--root", "r"]),
], ids=["serve", "serve-daemon"])
def test_repl_parser_defaults_equal_jax(cmd, fn, required, monkeypatch):
    import sntc_tpu.app as jax_app
    import sntc_tpu_torch.app as port_app

    jax = _defaults(jax_app, cmd, fn, required, monkeypatch)
    port = _defaults(port_app, cmd, fn, required, monkeypatch)
    for dest in ("standby_root", "repl_barrier_every"):
        assert dest in port and port[dest] == jax[dest], dest
    assert (port["standby_root"], port["repl_barrier_every"]) == (None, 1)
    got = _defaults(port_app, cmd, fn, required + [
        "--standby-root", "s", "--repl-barrier-every", "3"], monkeypatch)
    assert (got["standby_root"], got["repl_barrier_every"]) == ("s", 3)


# ---------------------------------------------------------------------------
# kills inside the replication protocol, in port worker processes
# ---------------------------------------------------------------------------

PORT_REPL_WORKER = """
import json, sys
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.resilience import arm
from sntc_tpu_torch.resilience.replicate import ReplicationPlane
from sntc_tpu_torch.serve import CsvDirSink, FileStreamSource, StreamingQuery

class Identity(Transformer):
    def transform(self, frame):
        return frame

watch, out, ckpt, standby, site, after = sys.argv[1:7]
if site:
    arm(site, kind="kill", after=int(after), times=1)
plane = ReplicationPlane(ckpt, standby, sink_dir=out)
q = StreamingQuery(Identity(), FileStreamSource(watch),
                   CsvDirSink(out, columns=["x"]), ckpt,
                   max_batch_offsets=1, commit_listener=plane.on_commit,
                   device="cpu")
n = q.process_available()
plane.close()
print(json.dumps({"batches": n, "repl": plane.status()}))
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
def repl_reference(chaos, tmp_path_factory):
    """The JAX harness's unkilled replicated run and its promotion."""
    return chaos.run_repl_reference(str(tmp_path_factory.mktemp("repl")))


def _port_repl_worker(d, site="", after=0):
    env = dict(os.environ, SNTC_FAULTS="", PYTHONPATH=REPO)
    env.pop("SNTC_RESILIENCE_LOG", None)
    return subprocess.run(
        [sys.executable, "-c", PORT_REPL_WORKER, os.path.join(d, "in"),
         os.path.join(d, "out"), os.path.join(d, "ckpt"),
         os.path.join(d, "standby"), site, str(after)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)


def _port_promote(d, tag):
    return PRep.promote_standby(
        os.path.join(d, "standby"), "default",
        os.path.join(d, tag, "ckpt"), dest_sink=os.path.join(d, tag, "out"),
        primary_root=os.path.join(d, "ckpt"),
        primary_sink=os.path.join(d, "out"))


def _repl_kill(chaos, reference, tmp_path, site):
    """The harness's scenario with port processes: kill inside ``site``;
    the torn standby promotes to its last sealed barrier (strays
    quarantined, never promoted) or refuses and leaves no tree; the
    clean restart converges bitwise to the JAX reference; the converged
    standby promotes with zero tail loss to the reference's promoted
    sink."""
    d = str(tmp_path / site.replace(".", "_"))
    chaos.write_inputs(os.path.join(d, "in"))
    killed = _port_repl_worker(d, site, chaos.REPL_KILL_AFTER[site])
    assert killed.returncode == KILL_EXIT_CODE, killed.stderr[-2000:]
    torn = _port_promote(d, "promoted_torn")
    if torn["ok"]:
        assert torn["law_exact"] is True, torn
        for q in torn["quarantined"]:
            assert not os.path.exists(
                os.path.join(d, "promoted_torn", "ckpt", q["rel"]))
    else:
        assert not glob.glob(os.path.join(d, "promoted_torn", "ckpt", "**",
                                          "*"), recursive=True)
    restarted = _port_repl_worker(d)
    assert restarted.returncode == 0, restarted.stderr[-2000:]
    assert chaos.committed_state(os.path.join(d, "ckpt")) \
        == reference["commits"]
    assert chaos.sink_contents(os.path.join(d, "out")) == reference["sink"]
    final = _port_promote(d, "promoted_final")
    assert final["ok"] is True and final["law_exact"] is True
    assert final["tail_loss_batches"] == 0
    assert final["batches_through"] == len(reference["commits"])
    assert chaos.sink_contents(os.path.join(d, "promoted_final", "out")) \
        == reference["promoted_sink"]
    return torn


def test_chaos_repl_apply_kill_torn_ship_quarantined(chaos, repl_reference,
                                                     tmp_path):
    torn = _repl_kill(chaos, repl_reference, tmp_path, "repl.apply")
    assert torn["ok"] is True and len(torn["quarantined"]) >= 1


@pytest.mark.slow
def test_chaos_repl_ship_kill_bitwise(chaos, repl_reference, tmp_path):
    _repl_kill(chaos, repl_reference, tmp_path, "repl.ship")


@pytest.mark.slow
def test_chaos_repl_barrier_kill_bitwise(chaos, repl_reference, tmp_path):
    _repl_kill(chaos, repl_reference, tmp_path, "repl.barrier")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_replicated_serve_on_card_promotes_to_cpu_sink(tmp_path):
    """``serve --standby-root`` of a binary LR pipeline on the card and
    on the CPU: each standby promotes (law exact) to the sink bytes of
    its own primary, and the card's promoted sink is the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sntc_tpu_torch.app import main
    from test_torch_tenancy import _lr_checkpoint

    model = _lr_checkpoint(tmp_path, "torch")
    watch = str(tmp_path / "in" / "a")
    promoted = {}
    for dev in ("cpu", "cuda"):
        base = tmp_path / dev
        os.environ["SNTC_SERVE_HOST_ROWS"] = "0"
        try:
            rc = main(["serve", "--model", model, "--watch", watch,
                       "--out", str(base / "out"), "--checkpoint",
                       str(base / "ckpt"), "--standby-root",
                       str(base / "standby"), "--shape-buckets", "64",
                       "--max-files-per-batch", "1", "--once",
                       "--device", dev])
        finally:
            os.environ.pop("SNTC_SERVE_HOST_ROWS", None)
        assert rc == 0
        rep = PRep.promote_standby(
            str(base / "standby"), "default", str(base / "p" / "ckpt"),
            dest_sink=str(base / "p" / "out"),
            primary_root=str(base / "ckpt"),
            primary_sink=str(base / "out"))
        assert rep["ok"] and rep["law_exact"], rep
        assert rep["batches_through"] == 3
        promoted[dev] = _sink_bytes(str(base / "p" / "out"))
        assert promoted[dev] == _sink_bytes(str(base / "out"))
    assert promoted["cuda"] == promoted["cpu"]
