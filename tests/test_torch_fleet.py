"""The port's elastic serve fleet against the JAX package's, on the CPU:
the counterparts of ``tests/test_fleet.py``.

The coordinator and the workers are plain objects stepped on one
injected wall clock (``FakeWall``), so every case runs both packages on
the same specs and steps and holds the records equal: the coordinator's
status and assignments, the published epochs (``assignments.jsonl``
without its time stamps), each tenant's sink rows and home:

* the sha1 ring: deterministic bounded-load placement, a join or a leave
  moving a bounded share, pinned tenants (and the same placement in both
  packages);
* bootstrap, lease expiry and dead-worker recovery, a dead worker's
  rejoin, migration bitwise against an unmigrated fleet, the ghost
  release of a tenant re-migrated before its new owner applied it, the
  torn ship reverting to its source, a poisoned spec, reserved ids, the
  heartbeat thread, the dead-source ship fence, retirement instead of
  deletion, retired trees verified and restored, a failed ship restored
  from the warm replica, a torn request tail, a draining tenant reverting
  when its destination dies, ``fsck_fleet``;
* the daemon's drain racing a round, the mid-batch markers;
* the fleet flags across the layers and the parsers' defaults against
  the JAX parser's;
* a worker process whose device domain fails: it exits 1 and its
  tenants migrate to the surviving worker (the JAX worker serves on the
  host instead);
* ``fleet-serve`` as a user starts it, the coordinator spawning its
  workers, drained by SIGTERM;
* on the card, a 2-worker in-process fleet.
"""

import glob
import inspect
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sntc_tpu.resilience as JR
import sntc_tpu.serve.fleet as JF
import sntc_tpu_torch.resilience as R
import sntc_tpu_torch.serve.fleet as PF
from sntc_tpu.core.base import Transformer as JTransformer
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.obs import metrics as JM
from sntc_tpu.serve import MemorySink as JMemorySink
from sntc_tpu.serve import MemorySource as JMemorySource
from sntc_tpu.serve import ServeDaemon as JServeDaemon
from sntc_tpu.serve import TenantSpec as JTenantSpec
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.obs import metrics as PM
from sntc_tpu_torch.serve import MemorySink, MemorySource, ServeDaemon
from sntc_tpu_torch.serve import TenantSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


class _JaxIdentity(JTransformer):
    def transform(self, frame):
        return frame


class _PortIdentity(Transformer):
    def transform(self, frame):
        return frame


def _pkg(name):
    if name == "jax":
        import sntc_tpu.resilience.replicate as rep
        import sntc_tpu.resilience.storage as storage

        return SimpleNamespace(
            name="jax", F=JF, R=JR, M=JM, Frame=JFrame,
            Identity=_JaxIdentity, MemorySink=JMemorySink,
            MemorySource=JMemorySource, ServeDaemon=JServeDaemon,
            TenantSpec=JTenantSpec, rep=rep, storage=storage, dev={})
    import sntc_tpu_torch.resilience.replicate as rep
    import sntc_tpu_torch.resilience.storage as storage

    return SimpleNamespace(
        name="port", F=PF, R=R, M=PM, Frame=Frame, Identity=_PortIdentity,
        MemorySink=MemorySink, MemorySource=MemorySource,
        ServeDaemon=ServeDaemon, TenantSpec=TenantSpec, rep=rep,
        storage=storage, dev={"device": "cpu"})


PKGS = ("jax", "port")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("SNTC_FAULTS", raising=False)
    for res in (JR, R):
        res.clear()
        res.clear_events()
        res.reset_breakers()
    yield
    for res in (JR, R):
        res.clear()
        res.clear_events()
        res.reset_breakers()
    # fleet runs emit many (event, tenant) series: left behind, they
    # exhaust the registries' label-set caps for later test files
    JM.reset_registry()
    PM.reset_registry()


def _both(run, tmp_path):
    """``run(P, dir)`` for the JAX package and the port, each in a
    directory of its own; the two records must be equal.  The port's."""
    got = {name: run(_pkg(name), str(tmp_path / name)) for name in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


class FakeWall:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _frames(P, n_batches, rows=4, base=0):
    return [P.Frame({"x": np.arange(rows, dtype=np.float64) + 100 * b + base})
            for b in range(n_batches)]


def _specs(P, n_tenants, batches=3):
    specs, sinks = {}, {}
    for i in range(n_tenants):
        tid = f"t{i}"
        sinks[tid] = P.MemorySink()
        specs[tid] = P.TenantSpec(
            tenant_id=tid, model=P.Identity(),
            source=P.MemorySource(_frames(P, batches, base=1000 * i)),
            sink=sinks[tid])
    return specs, sinks


def _fleet(P, d, worker_ids, specs, wall, **kw):
    root = os.path.join(d, "fleet")
    coord = P.F.FleetCoordinator(root, worker_ids, specs, wall=wall, **kw)
    workers = {w: P.F.FleetWorker(w, root, specs, wall=wall,
                                  daemon_kwargs=dict(P.dev))
               for w in worker_ids}
    return root, coord, workers


def _step(coord, workers, wall, rounds, dt=0.5):
    for _ in range(rounds):
        wall.t += dt
        for w in workers.values():
            w.tick()
        coord.tick()


def _close(coord, workers):
    for w in workers.values():
        w.close()
    coord.close()


def _sink_rows(sink):
    return sorted((bid, tuple(np.asarray(f["x"]).tolist()))
                  for bid, f in sink.batches)


def _tenant_homes(root, tid):
    """Workers whose tree holds the tenant (shipping partials count)."""
    return sorted(
        p.split(os.sep)[-3] for p in glob.glob(
            os.path.join(root, "worker", "*", "tenant", tid)
        ) + glob.glob(
            os.path.join(root, "worker", "*", "tenant", tid + ".shipping")))


def _epochs(root):
    """The published epochs, without their time stamps."""
    out = []
    for p in sorted(glob.glob(os.path.join(root, "fleet",
                                           "assignments.jsonl*")),
                    reverse=True):
        with open(p) as f:
            for line in f:
                if line.strip():
                    doc = json.loads(line)
                    doc.pop("ts", None)
                    out.append(doc)
    return out


def _record(root, coord, sinks):
    """What both packages must agree on after a run."""
    return {
        "status": coord.status(),
        "assignments": {t: dict(e) for t, e in coord.assignments.items()},
        "sinks": {t: _sink_rows(s) for t, s in sinks.items()},
        "homes": {t: _tenant_homes(root, t) for t in sinks},
        "epochs": _epochs(root),
    }


# ---------------------------------------------------------------------------
# placement: the consistent-hash ring
# ---------------------------------------------------------------------------


def test_ring_assignment_deterministic_and_bounded_load(tmp_path):
    def run(P, d):
        costs = {f"t{i}": 1.0 + (i % 3) for i in range(60)}
        ring = P.F.ConsistentHashRing(["w0", "w1", "w2", "w3"])
        a = ring.assign(costs)
        assert a == ring.assign(costs)
        assert set(a) == set(costs)
        cap = ring.capacity(costs)
        load = {}
        for tid, w in a.items():
            load[w] = load.get(w, 0.0) + costs[tid]
        assert all(v <= cap + 1e-9 for v in load.values())
        assert set(load) == {"w0", "w1", "w2", "w3"}
        return {"assign": a, "cap": cap,
                "preference": ring.preference("t7")}

    _both(run, tmp_path)


def test_ring_join_leave_moves_a_bounded_share(tmp_path):
    def run(P, d):
        costs = {f"t{i}": 1.0 for i in range(100)}
        before = P.F.ConsistentHashRing(["w0", "w1", "w2", "w3"]).assign(
            costs)
        after_join = P.F.ConsistentHashRing(
            ["w0", "w1", "w2", "w3", "w4"]).assign(costs)
        moved = sum(1 for t in costs if before[t] != after_join[t])
        after_leave = P.F.ConsistentHashRing(["w0", "w1", "w2"]).assign(
            costs)
        relocated = sum(1 for t in costs
                        if before[t] != "w3" and before[t] != after_leave[t])
        return {"moved": moved, "relocated": relocated,
                "placements": (before, after_join, after_leave)}

    got = _both(run, tmp_path)
    assert 0 < got["moved"] <= 50 and got["relocated"] <= 40


def test_ring_pinned_tenant_stays_put(tmp_path):
    def run(P, d):
        costs = {f"t{i}": 1.0 for i in range(20)}
        return P.F.ConsistentHashRing(["w0", "w1", "w2"]).assign(
            costs, pinned={"t7": "w2", "t11": "w0"})

    a = _both(run, tmp_path)
    assert a["t7"] == "w2" and a["t11"] == "w0"


# ---------------------------------------------------------------------------
# the fleet loop: bootstrap, lease expiry, recovery, rejoin
# ---------------------------------------------------------------------------


def test_fleet_bootstrap_serves_every_tenant(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall,
                                      lease_ttl_s=5.0)
        assert set(coord.assignments) == set(specs)
        _step(coord, workers, wall, 30)
        rep = P.F.fsck_fleet(root)
        assert rep["ok"], rep["errors"]
        for w in workers.values():
            w.drain()
        _close(coord, workers)
        return _record(root, coord, sinks)

    got = _both(run, tmp_path)
    assert all(w["state"] == "live"
               for w in got["status"]["workers"].values())
    for tid, rows in got["sinks"].items():
        assert len(rows) == 3, tid
        assert got["homes"][tid] == [got["assignments"][tid]["worker"]]


def test_lease_expiry_migrates_tenants_to_survivor(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall,
                                      lease_ttl_s=5.0)
        _step(coord, workers, wall, 4)
        dead = sorted(t for t, e in coord.assignments.items()
                      if e["worker"] == "w1")
        assert dead
        for _ in range(20):
            wall.t += 1.0
            workers["w0"].tick()
            coord.tick()
        mid = _record(root, coord, sinks)
        _step(coord, workers, wall, 10)
        _close(coord, workers)
        return {"dead": dead, "mid": mid,
                "end": _record(root, coord, sinks),
                "completed": coord.migrations["completed"]}

    got = _both(run, tmp_path)
    assert got["mid"]["status"]["workers"]["w1"]["state"] == "dead"
    for tid in got["dead"]:
        assert got["mid"]["assignments"][tid] == {"worker": "w0",
                                                  "phase": "serving"}
        assert got["mid"]["homes"][tid] == ["w0"]
    for tid, rows in got["end"]["sinks"].items():
        assert len(rows) == 3, tid
    assert got["completed"] >= len(got["dead"])


def test_dead_worker_rejoin_goes_live_again(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall,
                                      lease_ttl_s=5.0)
        _step(coord, workers, wall, 4)
        for _ in range(15):
            wall.t += 1.0
            workers["w0"].tick()
            coord.tick()
        assert coord.status()["workers"]["w1"]["state"] == "dead"
        _step(coord, workers, wall, 20)
        _close(coord, workers)
        return _record(root, coord, sinks)

    got = _both(run, tmp_path)
    assert got["status"]["workers"]["w1"]["state"] == "live"
    for tid, e in got["assignments"].items():
        assert e["phase"] == "serving", (tid, e)
        assert got["homes"][tid] == [e["worker"]]


# ---------------------------------------------------------------------------
# migration: first-class, bitwise, and safe to tear
# ---------------------------------------------------------------------------


def test_migration_bitwise_vs_unmigrated_reference(tmp_path):
    def run(P, d):
        wall = FakeWall()
        ref_specs, ref_sinks = _specs(P, 4, batches=4)
        _, ref_coord, ref_workers = _fleet(
            P, os.path.join(d, "ref"), ["w0", "w1"], ref_specs, wall)
        _step(ref_coord, ref_workers, wall, 30)
        specs, sinks = _specs(P, 4, batches=4)
        root, coord, workers = _fleet(
            P, os.path.join(d, "mig"), ["w0", "w1"], specs, wall)
        _step(coord, workers, wall, 3)
        tid = next(t for t, e in sorted(coord.assignments.items())
                   if e["worker"] == "w0")
        assert coord.migrate_tenant(tid, reason="rebalance")
        _step(coord, workers, wall, 30)
        with open(os.path.join(root, "fleet", "migrations",
                               f"{tid}.json")) as f:
            manifest = json.load(f)
        _close(coord, workers)
        _close(ref_coord, ref_workers)
        return {"tid": tid, "rec": _record(root, coord, sinks),
                "ref": {t: _sink_rows(s) for t, s in ref_sinks.items()},
                # the drain marker holds its wall time: the names only
                "manifest": (manifest["tenant"], manifest["dst"],
                             sorted(rel for rel, _n, _h in manifest["files"]))}

    got = _both(run, tmp_path)
    tid, rec = got["tid"], got["rec"]
    assert rec["assignments"][tid] == {"worker": "w1", "phase": "serving"}
    assert rec["status"]["migrations"]["completed"] == 1
    assert rec["homes"][tid] == ["w1"]
    assert got["manifest"][:2] == (tid, "w1")
    assert rec["sinks"] == got["ref"]


def test_remigration_before_new_owner_applied_releases_ghost(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall)
        _step(coord, workers, wall, 2)
        tid = next(t for t, e in sorted(coord.assignments.items())
                   if e["worker"] == "w0")
        assert coord.migrate_tenant(tid, "w1", reason="rebalance")
        for _ in range(20):
            wall.t += 0.5
            workers["w0"].tick()
            coord.tick()
            if coord.assignments[tid] == {"worker": "w1",
                                          "phase": "serving"}:
                break
        assert coord.assignments[tid] == {"worker": "w1",
                                          "phase": "serving"}
        assert coord.migrate_tenant(tid, "w0", reason="rebalance")
        _step(coord, workers, wall, 30)
        _close(coord, workers)
        return {"tid": tid, "rec": _record(root, coord, sinks)}

    got = _both(run, tmp_path)
    tid, rec = got["tid"], got["rec"]
    assert rec["assignments"][tid] == {"worker": "w0", "phase": "serving"}
    assert rec["status"]["migrations"]["completed"] == 2
    assert rec["homes"][tid] == ["w0"]
    assert all(len(rows) == 3 for rows in rec["sinks"].values())


def test_torn_ship_reverts_to_source_and_loses_nothing(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4, batches=4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall)
        _step(coord, workers, wall, 3)
        tid = next(t for t, e in sorted(coord.assignments.items())
                   if e["worker"] == "w0")
        assert coord.migrate_tenant(tid, reason="rebalance")
        P.R.arm("fleet.migrate", "io", times=1)
        _step(coord, workers, wall, 30)
        _close(coord, workers)
        return {"tid": tid, "rec": _record(root, coord, sinks)}

    got = _both(run, tmp_path)
    tid, rec = got["tid"], got["rec"]
    assert rec["status"]["migrations"]["reverted"] == 1
    assert rec["assignments"][tid] == {"worker": "w0", "phase": "serving"}
    assert rec["homes"][tid] == ["w0"]
    assert all(len(rows) == 4 for rows in rec["sinks"].values())


def test_poisoned_spec_degrades_tenant_never_kills_worker(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 3)
        specs["bad"] = P.TenantSpec(tenant_id="bad", model=P.Identity(),
                                    sink=P.MemorySink())
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall)
        _step(coord, workers, wall, 25)
        mid = coord.assignments["bad"]["phase"]
        _step(coord, workers, wall, 5)
        _close(coord, workers)
        rec = _record(root, coord, sinks)
        rec["assignments"]["bad"].pop("error")  # the repr names the package
        for ep in rec["epochs"]:
            ep["tenants"].get("bad", {}).pop("error", None)
        return {"mid": mid, "rec": rec}

    got = _both(run, tmp_path)
    rec = got["rec"]
    assert all(w["state"] == "live" for w in rec["status"]["workers"].values())
    assert got["mid"] == "failed"
    assert rec["assignments"]["bad"]["phase"] == "failed"
    assert all(len(rows) == 3 for rows in rec["sinks"].values())


# ---------------------------------------------------------------------------
# fencing, torn request tails, stranded drains, reserved ids
# ---------------------------------------------------------------------------


def test_worker_id_fleet_is_reserved(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, _ = _specs(P, 1)
        with pytest.raises(ValueError, match="reserved"):
            P.F.FleetWorker("fleet", os.path.join(d, "r"), specs, wall=wall)
        with pytest.raises(ValueError, match="reserved"):
            P.F.FleetCoordinator(os.path.join(d, "r"), ["w0", "fleet"],
                                 specs, wall=wall)
        root, coord, workers = _fleet(P, d, ["w0"], specs, wall)
        coord.add_worker("w1")
        with pytest.raises(ValueError, match="reserved"):
            coord.add_worker("fleet")
        _close(coord, workers)
        return sorted(coord.workers)

    assert _both(run, tmp_path) == ["w0", "w1"]


def test_heartbeat_thread_renews_lease_without_ticks(tmp_path):
    def run(P, d):
        specs, _ = _specs(P, 1)
        w = P.F.FleetWorker("w0", os.path.join(d, "fleet"), specs,
                            heartbeat_interval_s=0.02,
                            daemon_kwargs=dict(P.dev))
        started = (w.start_heartbeat(), w.start_heartbeat())
        try:
            lease_file = P.F.lease_path(os.path.join(d, "fleet"), "w0")
            deadline, seq = time.time() + 5.0, -1
            while time.time() < deadline and seq < 3:
                time.sleep(0.01)
                try:
                    with open(lease_file) as f:
                        seq = json.load(f)["seq"]
                except (OSError, ValueError):
                    pass
        finally:
            w.stop_heartbeat()
            w.close()
        return {"started": started, "renewed": seq >= 3}

    assert _both(run, tmp_path) == {"started": (True, False),
                                    "renewed": True}


def test_dead_source_ship_fenced_by_grace_and_lease_recheck(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall,
                                      lease_ttl_s=5.0, dead_grace_s=10.0)
        _step(coord, workers, wall, 4)
        w1 = sorted(t for t, e in coord.assignments.items()
                    if e["worker"] == "w1")
        for _ in range(8):
            wall.t += 1.0
            workers["w0"].tick()
            coord.tick()
        fenced = _record(root, coord, sinks)
        _step(coord, workers, wall, 30)
        _close(coord, workers)
        return {"w1": w1, "fenced": fenced,
                "end": _record(root, coord, sinks)}

    got = _both(run, tmp_path)
    fenced, end = got["fenced"], got["end"]
    assert got["w1"]
    assert fenced["status"]["workers"]["w1"]["state"] == "dead"
    for tid in got["w1"]:
        assert fenced["assignments"][tid]["phase"] == "draining"
        assert "w1" in fenced["homes"][tid]
    assert fenced["status"]["migrations"]["completed"] == 0
    assert end["status"]["workers"]["w1"]["state"] == "live"
    for tid, e in end["assignments"].items():
        assert e["phase"] == "serving", (tid, e)
        assert end["homes"][tid] == [e["worker"]]
    assert all(len(rows) == 3 for rows in end["sinks"].values())


def _kill_w1(coord, workers, wall, rounds=20):
    for _ in range(rounds):
        wall.t += 1.0
        workers["w0"].tick()
        coord.tick()


def test_dead_source_tree_retires_instead_of_rmtree(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall,
                                      lease_ttl_s=5.0, dead_grace_s=4.0)
        _step(coord, workers, wall, 4)
        dead = sorted(t for t, e in coord.assignments.items()
                      if e["worker"] == "w1")
        _kill_w1(coord, workers, wall)
        mid = _record(root, coord, sinks)
        retired = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(root, "fleet", "retired", "*")))
        _step(coord, workers, wall, 10)
        _close(coord, workers)
        return {"dead": dead, "mid": mid, "retired": retired,
                "end": _record(root, coord, sinks)}

    got = _both(run, tmp_path)
    for tid in got["dead"]:
        assert got["mid"]["assignments"][tid] == {"worker": "w0",
                                                  "phase": "serving"}
        assert got["mid"]["homes"][tid] == ["w0"]
        assert any(r.startswith(f"{tid}.w1.") for r in got["retired"]), tid
    assert all(len(rows) == 3 for rows in got["end"]["sinks"].values())


def test_retired_trees_fsck_verified_and_restorable(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, _sinks = _specs(P, 4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall,
                                      lease_ttl_s=5.0, dead_grace_s=4.0)
        _step(coord, workers, wall, 4)
        _kill_w1(coord, workers, wall)
        retired = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(root, "fleet", "retired", "*")))
        assert retired
        rep = P.F.fsck_fleet(root)
        assert rep["ok"], rep
        assert sorted(rep["retired"]) == retired
        dest = os.path.join(d, "restored")
        rr = P.F.restore_retired(root, retired[0], dest)
        assert rr["ok"] is True and rr["files"] > 0
        man = P.storage.load_sealed_json(
            os.path.join(dest, "restore_manifest.json"))
        for rel, size, _sha in man["files"]:
            assert os.path.getsize(os.path.join(dest, rel)) == size
        events = len(P.R.recent_events(event="fleet_retired_restored"))
        miss = P.F.restore_retired(root, "nope.w9.0",
                                   os.path.join(d, "x"))
        victim_dir = os.path.join(root, "fleet", "retired", retired[0])
        victims = sorted(glob.glob(os.path.join(
            victim_dir, "**", "commits", "*.json"), recursive=True)) or \
            sorted(glob.glob(os.path.join(victim_dir, "**", "*.json"),
                             recursive=True))
        with open(victims[0], "w") as f:
            f.write('{"torn": ')
        rep2 = P.F.fsck_fleet(root, repair=False)
        rr2 = P.F.restore_retired(root, retired[0], os.path.join(d, "y"),
                                  repair=False)
        _close(coord, workers)
        return {"retired": retired, "files": man["files"],
                "events": events, "miss": (miss["ok"], miss["error"]),
                "rep2": (rep2["ok"], rep2["retired"][retired[0]]["ok"]),
                "rr2": (rr2["ok"], rr2["error"])}

    got = _both(run, tmp_path)
    assert got["events"] == 1
    assert got["miss"] == (False, "no such retired tree")
    assert got["rep2"] == (False, False)
    assert got["rr2"] == (False, "retired tree fails fsck")


def test_dead_source_failed_ship_restores_from_warm_replica(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4, batches=6)
        standby = os.path.join(d, "standby")
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall,
                                      lease_ttl_s=5.0, dead_grace_s=4.0,
                                      standby_root=standby)
        _step(coord, workers, wall, 4)
        tid = next(t for t, e in sorted(coord.assignments.items())
                   if e["worker"] == "w1")
        workers["w1"].close()
        tree = P.F.tenant_tree(root, "w1", tid)
        commits = sorted(glob.glob(os.path.join(tree, "ckpt", "commits",
                                                "*.json")))
        assert commits
        with open(commits[-1]) as f:
            last = json.load(f)
        bid = int(os.path.splitext(os.path.basename(commits[-1]))[0])
        plane = P.rep.ReplicationPlane(tree, standby, tenant=tid)
        plane.on_commit(bid, last, 0)
        plane.close()
        P.R.arm(f"tenant/{tid}/fleet.migrate", "io", times=None)
        _kill_w1(coord, workers, wall)
        P.R.disarm(f"tenant/{tid}/fleet.migrate")
        restored = coord.assignments[tid]
        ckpt = os.path.isdir(os.path.join(P.F.tenant_tree(root, "w0", tid),
                                          "ckpt"))
        evs = P.R.recent_events(event="tenant_restored_from_replica")
        counted = P.M.registry().get(
            "sntc_fleet_migrations_total", reason="replica_restore",
            outcome="completed") or 0
        _step(coord, workers, wall, 15)
        _close(coord, workers)
        return {"tid": tid, "restored": restored, "ckpt": ckpt,
                "event": evs[-1]["tenant"] if evs else None,
                "counted": counted,
                "sinks": {t: len(s.batches) for t, s in sinks.items()}}

    got = _both(run, tmp_path)
    assert got["restored"] == {"worker": "w0", "phase": "serving"}
    assert got["ckpt"] and got["event"] == got["tid"]
    assert got["counted"] == 1
    assert set(got["sinks"].values()) == {6}


def test_torn_request_tail_is_not_dropped(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall)
        _step(coord, workers, wall, 3)
        tid = next(t for t, e in sorted(coord.assignments.items())
                   if e["worker"] == "w0")
        line = json.dumps({"action": "migrate", "tenant": tid,
                           "reason": "café-überload", "worker": "w0"},
                          ensure_ascii=False).encode()
        path = os.path.join(root, "fleet", "workers", "w0",
                            "requests.jsonl")
        with open(path, "ab") as f:
            f.write(line[:len(line) // 2])
        coord.tick()
        before = coord.assignments[tid]["phase"]
        with open(path, "ab") as f:
            f.write(line[len(line) // 2:] + b"\n")
        coord.tick()
        after = coord.assignments[tid]["phase"]
        _step(coord, workers, wall, 20)
        _close(coord, workers)
        return {"phases": (before, after),
                "rec": _record(root, coord, sinks), "tid": tid}

    got = _both(run, tmp_path)
    assert got["phases"] == ("serving", "draining")
    assert got["rec"]["assignments"][got["tid"]]["phase"] == "serving"
    assert got["rec"]["status"]["migrations"]["completed"] == 1


def test_draining_tenant_reverts_to_source_when_dst_dies(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 4, batches=4)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall,
                                      lease_ttl_s=5.0)
        _step(coord, workers, wall, 3)
        tid = next(t for t, e in sorted(coord.assignments.items())
                   if e["worker"] == "w0")
        assert coord.migrate_tenant(tid, "w1", reason="rebalance")
        for _ in range(25):
            wall.t += 1.0
            workers["w0"].renew_lease()
            coord.tick()
        mid = _record(root, coord, sinks)
        _step(coord, {"w0": workers["w0"]}, wall, 30)
        _close(coord, workers)
        return {"tid": tid, "mid": mid,
                "end": _record(root, coord, sinks)}

    got = _both(run, tmp_path)
    mid = got["mid"]
    assert mid["status"]["workers"]["w1"]["state"] == "dead"
    assert mid["assignments"][got["tid"]] == {"worker": "w0",
                                              "phase": "serving"}
    assert mid["status"]["migrations"]["reverted"] >= 1
    assert all(len(rows) == 4 for rows in got["end"]["sinks"].values())


# ---------------------------------------------------------------------------
# the fleet doctor
# ---------------------------------------------------------------------------


def test_fsck_fleet_repairs_torn_journal_flags_broken_seal(tmp_path):
    def run(P, d):
        wall = FakeWall()
        specs, _ = _specs(P, 2)
        root, coord, workers = _fleet(P, d, ["w0", "w1"], specs, wall)
        _step(coord, workers, wall, 10)
        tid = next(t for t, e in sorted(coord.assignments.items())
                   if e["worker"] == "w0")
        assert coord.migrate_tenant(tid, reason="rebalance")
        _step(coord, workers, wall, 15)
        journal = os.path.join(root, "fleet", "assignments.jsonl")
        with open(journal, "a") as f:
            f.write('{"epoch": 99, "torn')
        rep = P.F.fsck_fleet(root)
        with open(journal) as f:
            clean = all("torn" not in line for line in f)
        mpath = os.path.join(root, "fleet", "migrations", f"{tid}.json")
        with open(mpath) as f:
            doc = json.load(f)
        doc["dst"] = "attacker"
        with open(mpath, "w") as f:
            json.dump(doc, f)
        rep2 = P.F.fsck_fleet(root)
        _close(coord, workers)
        return {"ok": (rep["ok"], rep2["ok"]),
                "repaired": len(rep["repaired"]), "clean": clean,
                "checked": rep["checked"],
                "seal_error": any(
                    e.get("artifact") == "fleet_migration_manifest"
                    for e in rep2["errors"])}

    got = _both(run, tmp_path)
    assert got["ok"] == (True, False)
    assert got["repaired"] >= 1 and got["clean"] and got["seal_error"]


# ---------------------------------------------------------------------------
# the daemon's drain against a round in progress, the mid-batch markers
# ---------------------------------------------------------------------------


def test_request_drain_mid_tick_waits_for_round(tmp_path):
    def run(P, d):
        entered, release = threading.Event(), threading.Event()

        class GateSink(P.MemorySink):
            def add_batch(self, batch_id, frame):
                entered.set()
                release.wait(10)
                return super().add_batch(batch_id, frame)

        spec = P.TenantSpec(tenant_id="t0", model=P.Identity(),
                            source=P.MemorySource(_frames(P, 2)),
                            sink=GateSink())
        daemon = P.ServeDaemon([spec], os.path.join(d, "root"), **P.dev)
        ticker = threading.Thread(target=daemon.tick)
        ticker.start()
        assert entered.wait(10)
        daemon.request_drain("race")
        drainer = threading.Thread(target=daemon.drain)
        drainer.start()
        drainer.join(0.3)
        waited = drainer.is_alive()
        release.set()
        ticker.join(10)
        drainer.join(10)
        with open(os.path.join(d, "root", "daemon_drain_marker.json")) as f:
            reason = json.load(f)["reason"]
        daemon.close()
        return {"waited": waited, "finished": not drainer.is_alive(),
                "reason": reason}

    assert _both(run, tmp_path) == {"waited": True, "finished": True,
                                    "reason": "race"}


def test_drain_marker_records_mid_batch_tenants(tmp_path):
    def run(P, d):
        class DownSink(P.MemorySink):
            def add_batch(self, batch_id, frame):
                raise IOError("sink volume down")

        spec = P.TenantSpec(tenant_id="t0", model=P.Identity(),
                            source=P.MemorySource(_frames(P, 1)),
                            sink=DownSink())
        daemon = P.ServeDaemon([spec], os.path.join(d, "root"), **P.dev)
        daemon.tick()
        daemon.request_drain("evidence")
        daemon.drain()
        with open(os.path.join(d, "root", "daemon_drain_marker.json")) as f:
            mid = json.load(f)["mid_batch_tenants"]
        with open(os.path.join(daemon.tenant_dir("t0"),
                               "drain_marker.json")) as f:
            was = json.load(f)["was_mid_batch"]
        daemon.close()
        return {"mid": mid, "was": was}

    assert _both(run, tmp_path) == {"mid": ["t0"], "was": True}


# ---------------------------------------------------------------------------
# the epochs both packages publish
# ---------------------------------------------------------------------------


def test_coordinators_publish_the_same_epochs(tmp_path):
    """Bootstrap, a lease expiry and the dead worker's migrations, a
    scale-out join and its rebalance: both packages' coordinators
    publish the same epochs (``assignments.jsonl`` without its time
    stamps) and the same final status."""
    def run(P, d):
        wall = FakeWall()
        specs, sinks = _specs(P, 6, batches=5)
        specs["t5"].placement_cost = 2.0
        root, coord, workers = _fleet(P, d, ["w0", "w1", "w2"], specs,
                                      wall, lease_ttl_s=2.0,
                                      dead_grace_s=1.0)
        _step(coord, workers, wall, 3)
        dead = max(workers, key=lambda w: sum(
            1 for e in coord.assignments.values() if e["worker"] == w))
        gone = workers.pop(dead)
        _step(coord, workers, wall, 12)
        coord.add_worker("w3")
        workers["w3"] = P.F.FleetWorker("w3", root, specs, wall=wall,
                                        daemon_kwargs=dict(P.dev))
        _step(coord, workers, wall, 25)
        gone.close()
        _close(coord, workers)
        return dict(_record(root, coord, sinks), dead=dead)

    got = _both(run, tmp_path)
    reasons = {(e["tenants"][t].get("reason"))
               for e in got["epochs"] for t in e["tenants"]}
    assert {"worker_dead", "join"} <= reasons
    assert got["status"]["migrations"]["reverted"] == 0
    assert got["status"]["workers"][got["dead"]]["state"] == "dead"
    assert got["status"]["workers"]["w3"]["state"] == "live"
    assert all(len(rows) == 5 for rows in got["sinks"].values())
    for tid, e in got["assignments"].items():
        assert got["homes"][tid] == [e["worker"]]


# ---------------------------------------------------------------------------
# the flags across the layers, and the parsers
# ---------------------------------------------------------------------------


FLEET_FLAGS = (
    ("--workers", None), ("--worker-ids", None),
    ("--lease-ttl", "lease_ttl_s"), ("--boot-grace", "boot_grace_s"),
    ("--dead-grace", "dead_grace_s"), ("--vnodes", "vnodes"),
    ("--slack", "slack"), ("--drain-timeout", None),
    ("--fleet-worker-id", None))


def test_fleet_flags_consistent_cli_coordinator_docs():
    """Every ``fleet-serve`` flag exists, fills a ``FleetCoordinator``
    keyword where it names one, every coordinator tunable is reachable
    from the command line, and the README documents ``fleet-serve``."""
    from sntc_tpu_torch.app import build_parser

    sub = next(a for a in build_parser()._actions
               if a.__class__.__name__ == "_SubParsersAction")
    opts = {o for a in sub.choices["fleet-serve"]._actions
            for o in a.option_strings}
    params = set(inspect.signature(PF.FleetCoordinator).parameters)
    for flag, kwarg in FLEET_FLAGS:
        assert flag in opts, flag
        if kwarg is not None:
            assert kwarg in params, kwarg
    internal = {"root", "worker_ids", "specs_by_id", "wall",
                "scale_out_hook", "standby_root"}
    assert params - internal == {k for _f, k in FLEET_FLAGS if k}
    assert "--standby-root" in opts
    with open(os.path.join(REPO, "README.md")) as f:
        readme = f.read()
    for needle in ("fleet-serve", "fleet-restore-retired", "--fleet-root"):
        assert needle in readme, needle


def _defaults(app, cmd, required, monkeypatch):
    seen = {}
    for fn in ("cmd_fleet_serve", "cmd_fsck", "cmd_fleet_restore_retired"):
        monkeypatch.setattr(app, fn,
                            lambda args: seen.update(vars(args)) or 0)
    assert app.main([cmd] + required) == 0
    seen.pop("fn", None)
    return seen


@pytest.mark.parametrize("cmd,required,not_ported", [
    ("fleet-serve", ["--tenants", "t", "--root", "r"],
     {"compile_budget_s", "platform"}),
    ("fsck", ["r"], {"compile_cache", "compile_cache_dir", "platform"}),
    ("fleet-restore-retired", ["r"], {"platform"}),
], ids=["fleet-serve", "fsck", "fleet-restore-retired"])
def test_fleet_parser_defaults_equal_jax(cmd, required, not_ported,
                                         monkeypatch):
    import sntc_tpu.app as jax_app
    import sntc_tpu_torch.app as port_app

    jax = _defaults(jax_app, cmd, required, monkeypatch)
    port = _defaults(port_app, cmd, required, monkeypatch)
    assert set(jax) - set(port) == not_ported
    extra = set(port) - set(jax)
    assert extra == ({"device"} if cmd == "fleet-serve" else set())
    for dest in set(jax) & set(port):
        assert port[dest] == jax[dest], dest


# ---------------------------------------------------------------------------
# a failed device domain in a worker process
# ---------------------------------------------------------------------------


def _write_tenant_streams(base, tids, files=2):
    """Raw CSV streams of the CICIDS2017 features, one dir a tenant."""
    from sntc_tpu_torch.data import clean_flows, generate_frame, write_raw_csv

    rows = clean_flows(generate_frame(400, seed=11)).drop("Label")
    frame = Frame({c: np.asarray(rows[c]) for c in rows.columns})
    for k, tid in enumerate(tids):
        d = os.path.join(base, "in", tid)
        os.makedirs(d)
        for i in range(files):
            lo = 40 * (files * k + i)
            write_raw_csv(frame.slice(lo, lo + 23 + 5 * i),
                          os.path.join(d, f"part_{i:03d}.csv"))


def test_failed_device_domain_worker_exits_and_tenants_migrate(tmp_path):
    """Two ``fleet-serve --fleet-worker-id`` processes under an
    in-process coordinator; one serves with ``device.dispatch`` failing
    for good.  Its device domain fails, it drains and exits 1 (no host
    fallback), its lease lapses, and its tenants migrate through the
    dead-source path to the other worker, which serves every file."""
    from test_torch_tenancy import _lr_checkpoint

    model = _lr_checkpoint(tmp_path, "torch")
    tids = ("a", "b", "c", "d")
    _write_tenant_streams(str(tmp_path / "s"), tids)
    doc = {"tenants": [
        {"id": t, "model": model, "watch": str(tmp_path / "s" / "in" / t),
         "out": str(tmp_path / "out" / t)} for t in tids]}
    tenants = str(tmp_path / "tenants.json")
    with open(tenants, "w") as f:
        json.dump(doc, f)
    root = str(tmp_path / "fleet")
    specs = {t: SimpleNamespace(placement_cost=None, weight=1.0,
                                pinned_worker=None) for t in tids}
    coord = PF.FleetCoordinator(root, ["w0", "w1"], specs, lease_ttl_s=1.5,
                                dead_grace_s=0.5, boot_grace_s=60.0)
    bad = next(e["worker"] for t, e in sorted(coord.assignments.items()))
    good = "w1" if bad == "w0" else "w0"
    procs = {}
    for wid in ("w0", "w1"):
        env = dict(os.environ, PYTHONPATH=REPO, SNTC_SERVE_HOST_ROWS="0",
                   SNTC_FAULTS=("device.dispatch:device_lost"
                                if wid == bad else ""))
        env.pop("SNTC_RESILIENCE_LOG", None)
        procs[wid] = subprocess.Popen(
            [sys.executable, "-m", "sntc_tpu_torch", "fleet-serve",
             "--tenants", tenants, "--root", root, "--poll-interval", "0.05",
             "--device", "cpu", "--fleet-worker-id", wid],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    try:
        deadline = time.time() + 120
        served = False
        while time.time() < deadline:
            coord.tick()
            served = all(
                len(glob.glob(str(tmp_path / "out" / t / "batch_*.csv"))) == 2
                for t in tids)
            if served and procs[bad].poll() is not None:
                break
            time.sleep(0.05)
        coord.drain_fleet("test")
        outs = {wid: p.communicate(timeout=60) for wid, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert served, {w: o[1][-2000:] for w, o in outs.items()}
    assert procs[bad].returncode == 1, outs[bad][1][-2000:]
    assert procs[good].returncode == 0, outs[good][1][-2000:]
    line = json.loads(outs[bad][0].strip().splitlines()[-1])
    assert line["device_failed"] is True and line["device"] == "cpu"
    for key in ("kernel_launches", "pad_launch_shapes", "tenants"):
        assert key in line
    st = coord.status()
    assert st["workers"][bad]["state"] == "dead"
    assert st["migrations"]["reverted"] == 0
    for t, e in coord.assignments.items():
        assert e == {"worker": good, "phase": "serving"}, (t, e)
        assert _tenant_homes(root, t) == [good]
    assert PF.fsck_fleet(root)["ok"]
    coord.close()


def test_fleet_serve_command_drains_on_sigterm(tmp_path):
    """``fleet-serve`` as users start it: the coordinator spawns its
    workers from its own command line, every tenant is served, and
    SIGTERM raises the fleet drain, drains every worker and ends with
    the coordinator's status line and rc 0; every tenant then lives on
    one worker's tree and ``fsck --fleet-root`` is clean."""
    import signal

    from test_torch_tenancy import _lr_checkpoint

    model = _lr_checkpoint(tmp_path, "torch")
    tids = ("a", "b", "c")
    _write_tenant_streams(str(tmp_path / "s"), tids)
    doc = {"tenants": [
        {"id": t, "model": model, "watch": str(tmp_path / "s" / "in" / t),
         "out": str(tmp_path / "out" / t)} for t in tids]}
    tenants = str(tmp_path / "tenants.json")
    with open(tenants, "w") as f:
        json.dump(doc, f)
    root = str(tmp_path / "fleet")
    env = dict(os.environ, PYTHONPATH=REPO, SNTC_SERVE_HOST_ROWS="0")
    for var in ("SNTC_RESILIENCE_LOG", "SNTC_FAULTS"):
        env.pop(var, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sntc_tpu_torch", "fleet-serve",
         "--tenants", tenants, "--root", root, "--workers", "2",
         "--poll-interval", "0.05", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 120
        served = False
        while time.time() < deadline and proc.poll() is None:
            served = all(
                len(glob.glob(str(tmp_path / "out" / t / "batch_*.csv"))) == 2
                for t in tids)
            if served:
                break
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert served, err[-3000:]
    assert proc.returncode == 0, err[-3000:]
    status = json.loads(out.strip().splitlines()[-1])
    assert sorted(status["workers"]) == ["w0", "w1"]
    assert status["migrations"]["reverted"] == 0
    assert status["tenants"] == 3 and status["phases"] == {"serving": 3}
    assert sum(w["tenants"] for w in status["workers"].values()) == 3
    assert os.path.exists(os.path.join(PF.fleet_meta_dir(root),
                                       PF.FLEET_DRAIN_MARKER))
    for t in tids:
        assert len(_tenant_homes(root, t)) == 1, t
    fsck = subprocess.run(
        [sys.executable, "-m", "sntc_tpu_torch", "fsck", root,
         "--fleet-root"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=60)
    assert fsck.returncode == 0 and json.loads(fsck.stdout)["ok"], fsck.stdout


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_two_worker_fleet_on_card(tmp_path):
    """A 2-worker in-process fleet serving an LR checkpoint on the card:
    every tenant's files served once, on the worker the ring placed it,
    with the CPU fleet's predictions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sntc_tpu_torch.app import serving_form
    from sntc_tpu_torch.mlio import load_model
    from test_torch_tenancy import _lr_checkpoint

    model_path = _lr_checkpoint(tmp_path, "torch")
    preds = {}
    for dev in ("cpu", "cuda"):
        served, _labels, out_cols = serving_form(
            load_model(model_path, device=dev), "label", True)
        specs = {t: TenantSpec(tenant_id=t, model=served,
                               watch=str(tmp_path / "in" / t),
                               out=str(tmp_path / f"out_{dev}" / t),
                               out_columns=out_cols)
                 for t in ("a", "b", "c")}
        wall = FakeWall()
        root = str(tmp_path / f"fleet_{dev}")
        coord = PF.FleetCoordinator(root, ["w0", "w1"], specs, wall=wall)
        workers = {w: PF.FleetWorker(w, root, specs, wall=wall,
                                     daemon_kwargs={"device": dev,
                                                    "shape_buckets": 64})
                   for w in ("w0", "w1")}
        os.environ["SNTC_SERVE_HOST_ROWS"] = "0"
        try:
            _step(coord, workers, wall, 20)
        finally:
            os.environ.pop("SNTC_SERVE_HOST_ROWS", None)
        for w in workers.values():
            w.drain()
        _close(coord, workers)
        preds[dev] = {
            t: [open(p).read() for p in sorted(glob.glob(
                str(tmp_path / f"out_{dev}" / t / "batch_*.csv")))]
            for t in specs}
        for t, e in coord.assignments.items():
            assert _tenant_homes(root, t) == [e["worker"]]
    for t in ("a", "b", "c"):
        assert len(preds["cuda"][t]) == 3
        assert preds["cuda"][t] == preds["cpu"][t]
