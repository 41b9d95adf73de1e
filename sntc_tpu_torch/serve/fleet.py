"""The elastic serve fleet: one coordinator over N worker processes.

Counterpart of ``sntc_tpu/serve/fleet.py``, with the same filesystem
protocol under one fleet root, so either package's coordinator reads the
other's leases, markers and journals.  Each worker runs a plain
:class:`~sntc_tpu_torch.serve.tenancy.ServeDaemon` over its slice of the
tenants; everything is coordinated through files (no sockets):

* **Placement**: a sha1 consistent-hash ring over tenant ids
  (:class:`ConsistentHashRing`) with bounded load, each worker's
  capacity ``slack × total_cost / n_workers``; a tenant's cost is its
  ``placement_cost`` or its DRR weight, and ``pinned_worker`` nails it
  to one worker.  The same workers, tenants, vnodes and slack place
  every tenant on the same worker in both packages.
* **Liveness**: each worker renews ``fleet/workers/<id>/lease.json``
  (the ``fleet.lease`` fault site) from a heartbeat thread that starts
  before the worker builds its daemon, so the first batch (CUDA's lazy
  init and the first kernel load on the card) never reads as a dead
  worker.  A lease older than ``lease_ttl_s`` declares the worker dead;
  its trees ship only after the lease stayed expired ``dead_grace_s``
  longer and a last re-read shows no renewal, and the dead source's tree
  is retired into ``fleet/retired/``, never deleted.
* **Migration**: rebalancing, the controller's ``migrate`` rung and
  dead-worker recovery share one path: the source settles the tenant and
  writes a release marker (a dead source is skipped: its tree is
  crash-consistent by the WAL contract), the coordinator ships the tree
  into ``<dst>/tenant/<id>.shipping`` with a sealed sha256 manifest
  (``fleet.migrate`` fires before each file), verifies manifest and
  fsck, renames it into place and flips the assignment epoch.  A torn
  ship quarantines the copy and the tenant resumes at its source; a dead
  source whose tree cannot ship is restored from its warm-standby
  replica (``resilience.replicate.promote_standby``) when the
  coordinator has a ``standby_root``.
* **Assignment**: epochs publish atomically to ``fleet/assignments.json``
  (``fleet.assign``) and are journaled to ``fleet/assignments.jsonl``;
  workers apply the delta (``ServeDaemon.add_tenant`` / a settling
  ``remove_tenant`` plus a release marker).
* **The controller's fleet rungs**: a worker installs
  ``daemon.fleet_hook``; the ``migrate`` and ``scale_out`` rungs post to
  ``fleet/workers/<id>/requests.jsonl``, consumed by the coordinator
  each tick.

**A failed device domain.**  The port's daemon has no host fallback: a
worker whose shared device domain fails drains, stops renewing its lease
and leaves its loop (the ``fleet-serve`` worker exits 1).  The
coordinator then sees the lease expire and migrates the worker's tenants
through the dead-source path to a surviving worker, which serves them on
its own device.  The JAX worker serves on the host instead.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import threading
import time
from bisect import bisect_right
from typing import Any, Callable, Dict, List, Optional, Tuple

from sntc_tpu_torch.obs.metrics import inc, set_gauge
from sntc_tpu_torch.resilience import emit_event, fault_point
from sntc_tpu_torch.resilience import storage as _storage
from sntc_tpu_torch.serve.tenancy import ServeDaemon, TenantSpec

FLEET_DIR = "fleet"
WORKERS_DIR = "workers"
WORKER_TREES = "worker"
LEASE_MARKER = "lease.json"
ASSIGN_MARKER = "assignments.json"
ASSIGN_JOURNAL = "assignments.jsonl"
REQUESTS_JOURNAL = "requests.jsonl"
RELEASE_DIR = "release"
MIGRATIONS_DIR = "migrations"
RETIRED_DIR = "retired"
FLEET_DRAIN_MARKER = "fleet_drain_marker.json"
COORDINATOR_MARKER = "coordinator.json"

DEFAULT_VNODES = 64
DEFAULT_SLACK = 1.25
DEFAULT_LEASE_TTL_S = 5.0
#: a configured worker that has never heartbeat gets this long to boot
#: (subprocess spawn + backend import dwarf the steady-state TTL)
DEFAULT_BOOT_GRACE_S = 30.0
#: the worker's dedicated heartbeat-thread cadence: leases renew even
#: while the serving thread sits in a long first batch, so a SLOW worker
#: is never declared dead — only a silent one.  A quarter of the
#: shortest lease TTL a fleet runs with (1 s); the JAX worker beats
#: every second
DEFAULT_HEARTBEAT_S = 0.25
#: a migration that keeps failing verification is abandoned (phase
#: ``failed``) after this many ship attempts
MAX_SHIP_ATTEMPTS = 3
#: worker ids the metric plane reserves (the fleet-wide aggregate row
#: is published as ``worker="fleet"``; a real worker under that name
#: would silently collide with it)
RESERVED_WORKER_IDS = frozenset({"fleet"})


def validate_worker_id(worker_id: str) -> str:
    if not worker_id or "/" in worker_id or os.sep in worker_id:
        raise ValueError(
            f"worker_id must be a non-empty path-safe string, got "
            f"{worker_id!r}"
        )
    if worker_id in RESERVED_WORKER_IDS:
        raise ValueError(
            f"worker_id {worker_id!r} is reserved for the fleet-wide "
            "metric aggregate"
        )
    return worker_id


def fleet_meta_dir(root: str) -> str:
    return os.path.join(root, FLEET_DIR)


def worker_root(root: str, worker_id: str) -> str:
    """One worker's ServeDaemon root (its tenant trees live under it)."""
    return os.path.join(root, WORKER_TREES, worker_id)


def worker_meta_dir(root: str, worker_id: str) -> str:
    return os.path.join(root, FLEET_DIR, WORKERS_DIR, worker_id)


def lease_path(root: str, worker_id: str) -> str:
    return os.path.join(worker_meta_dir(root, worker_id), LEASE_MARKER)


def tenant_tree(root: str, worker_id: str, tenant_id: str) -> str:
    return os.path.join(worker_root(root, worker_id), "tenant", tenant_id)


def placement_cost(spec: TenantSpec) -> float:
    """The tenant's bounded-load capacity cost: its declared
    ``placement_cost``, defaulting to its DRR weight."""
    c = spec.placement_cost
    return float(c if c is not None else spec.weight)


class ConsistentHashRing:
    """A sha1 vnode ring with bounded-load assignment.

    ``assign`` places tenants (descending cost, ties by id — fully
    deterministic) at the first ring-order worker whose load stays
    within ``slack × total_cost / n_workers``; the classic
    consistent-hashing property bounds the reshuffle when a worker
    joins or leaves to roughly its own share."""

    def __init__(self, workers: List[str], *, vnodes: int = DEFAULT_VNODES):
        self.workers = sorted(set(workers))
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = sorted(
            (self._hash(f"{w}#{i}"), w)
            for w in self.workers for i in range(self.vnodes)
        )
        self._keys = [p[0] for p in self._points]

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.sha1(s.encode()).digest()[:8], "big"
        )

    def preference(self, tenant_id: str) -> List[str]:
        """Every worker, in ring order from the tenant's hash point."""
        if not self._points:
            return []
        i = bisect_right(self._keys, self._hash(tenant_id))
        n = len(self._points)
        seen: set = set()
        out: List[str] = []
        for k in range(n):
            w = self._points[(i + k) % n][1]
            if w not in seen:
                seen.add(w)
                out.append(w)
                if len(out) == len(self.workers):
                    break
        return out

    def capacity(
        self, costs: Dict[str, float], *, slack: float = DEFAULT_SLACK
    ) -> float:
        if not self.workers:
            return 0.0
        total = sum(costs.values()) or 1.0
        cap = slack * total / len(self.workers)
        # one tenant must always fit SOMEWHERE, however heavy
        return max(cap, max(costs.values(), default=1.0))

    def assign(
        self,
        costs: Dict[str, float],
        *,
        pinned: Optional[Dict[str, str]] = None,
        slack: float = DEFAULT_SLACK,
    ) -> Dict[str, str]:
        """Bounded-load placement: ``{tenant_id: worker_id}``."""
        if not self.workers:
            return {}
        pinned = pinned or {}
        cap = self.capacity(costs, slack=slack)
        load = {w: 0.0 for w in self.workers}
        out: Dict[str, str] = {}
        order = sorted(
            costs, key=lambda t: (t not in pinned, -costs[t], t)
        )
        for tid in order:
            c = costs[tid]
            if tid in pinned and pinned[tid] in load:
                w = pinned[tid]
            else:
                w = None
                for cand in self.preference(tid):
                    if load[cand] + c <= cap:
                        w = cand
                        break
                if w is None:  # every worker "full": least-loaded
                    w = min(load, key=lambda x: (load[x], x))
            load[w] += c
            out[tid] = w
        return out


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------


class FleetWorker:
    """One worker process's runtime: a lazily-built ``ServeDaemon``
    (the daemon needs ≥1 tenant) plus the fleet protocol around it —
    lease renewal, assignment application, release markers, and the
    fleet-request journal the controller's fleet rungs write through.

    ``specs_by_id`` is the full tenant CATALOG; the assignment marker
    says which slice this worker serves.  Clocks are injectable; the
    whole worker is steppable via :meth:`tick` for in-process tests."""

    def __init__(
        self,
        worker_id: str,
        root: str,
        specs_by_id: Dict[str, TenantSpec],
        *,
        daemon_kwargs: Optional[Dict[str, Any]] = None,
        controller: bool = False,
        controller_policy=None,
        heartbeat_interval_s: float = DEFAULT_HEARTBEAT_S,
        clock=time.monotonic,
        wall=time.time,
    ):
        self.worker_id = validate_worker_id(worker_id)
        self.root = root
        self.specs = dict(specs_by_id)
        self.daemon_kwargs = dict(daemon_kwargs or {})
        self.daemon_kwargs.pop("controller", None)
        self.daemon_kwargs.pop("controller_policy", None)
        self._controller_armed = bool(controller)
        self._controller_policy = controller_policy
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._clock = clock
        self._wall = wall
        self.daemon: Optional[ServeDaemon] = None
        self._seq = 0
        self._epoch = -1
        self._failed: Dict[str, str] = {}  # tid -> error (poisoned spec)
        self._lease_lock = threading.Lock()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        os.makedirs(self.meta_dir, exist_ok=True)
        os.makedirs(os.path.join(self.meta_dir, RELEASE_DIR),
                    exist_ok=True)

    @property
    def meta_dir(self) -> str:
        return worker_meta_dir(self.root, self.worker_id)

    @property
    def daemon_root(self) -> str:
        return worker_root(self.root, self.worker_id)

    def serving(self) -> List[str]:
        if self.daemon is None:
            return []
        return sorted(t.spec.tenant_id for t in self.daemon.tenants)

    # -- lease --------------------------------------------------------------

    def lease_payload(self) -> Dict[str, Any]:
        d = self.daemon
        tenants = list(d.tenants) if d is not None else []
        return {
            "worker": self.worker_id,
            "pid": os.getpid(),
            "ts": self._wall(),
            "seq": self._seq,
            "epoch": self._epoch,
            "tenants": sorted(t.spec.tenant_id for t in tenants),
            "rows_done": sum(t.rows_done for t in tenants),
            "batches_done": sum(t.batches_done for t in tenants),
            "failed": dict(self._failed),
        }

    def renew_lease(self) -> bool:
        """One heartbeat: the ``fleet.lease`` fault boundary, then the
        atomic lease-marker publish (DEGRADE — a full disk must not
        kill the worker; the coordinator sees the stale lease).
        Serialized, because the dedicated heartbeat thread and the
        tick loop both renew."""
        fault_point("fleet.lease")
        with self._lease_lock:
            self._seq += 1
            return _storage.write_marker(
                lease_path(self.root, self.worker_id),
                self.lease_payload(),
            )

    def start_heartbeat(self) -> bool:
        """Renew the lease from a dedicated daemon thread.  The tick
        loop shares its thread with ``daemon.tick()`` and the
        ``add_tenant`` model loads and the first batch's CUDA init and
        kernel load — long against a seconds-TTL
        lease — so without this a merely SLOW worker reads as dead and
        the coordinator ships a tree the live daemon still writes to.
        The foreground :meth:`run` loop arms it; the steppable test
        path may call it explicitly."""
        if self._hb_thread is not None or self.heartbeat_interval_s <= 0:
            return False
        self._hb_stop.clear()

        def _beat() -> None:
            while not self._hb_stop.wait(self.heartbeat_interval_s):
                try:
                    self.renew_lease()
                except Exception as e:
                    emit_event(
                        event="fleet_lease_error",
                        worker=self.worker_id, error=repr(e),
                    )

        self._hb_thread = threading.Thread(
            target=_beat, name=f"fleet-heartbeat-{self.worker_id}",
            daemon=True,
        )
        self._hb_thread.start()
        return True

    def stop_heartbeat(self) -> None:
        if self._hb_thread is None:
            return
        self._hb_stop.set()
        self._hb_thread.join(timeout=5.0)
        self._hb_thread = None

    # -- fleet requests (the controller's migrate/scale_out rungs) ----------

    def _fleet_request(self, action: str, tenant_id: str,
                       reason: str) -> None:
        rec = {
            "ts": self._wall(),
            "worker": self.worker_id,
            "action": action,
            "tenant": tenant_id,
            "reason": reason,
        }
        path = os.path.join(self.meta_dir, REQUESTS_JOURNAL)
        with open(path, "a") as f:  # storage: fleet_request_journal
            _storage.append_line(
                f, json.dumps(rec) + "\n", site="storage.journal",
                tenant=tenant_id,
            )

    # -- assignment ---------------------------------------------------------

    def read_assignment(self) -> Optional[Dict[str, Any]]:
        path = os.path.join(fleet_meta_dir(self.root), ASSIGN_MARKER)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (ValueError, OSError):
            # a torn/unreadable marker (the publish is atomic, so this
            # is a dying disk): keep serving the last applied epoch
            return None

    def _start_daemon(self, specs: List[TenantSpec]) -> None:
        self.daemon = ServeDaemon(
            specs, self.daemon_root, **self.daemon_kwargs
        )
        self.daemon.fleet_hook = self._fleet_request
        if self._controller_armed:
            from sntc_tpu_torch.serve.controller import ServeController

            # built AFTER the hook is installed so the fleet rungs
            # attach (the ctor-armed path would see fleet_hook=None)
            self.daemon.controller = ServeController.for_daemon(
                self.daemon, policy=self._controller_policy
            )

    def apply_assignment(
        self, doc: Optional[Dict[str, Any]] = None
    ) -> int:
        """Apply the published assignment delta; returns tenants
        added + removed.  A spec that fails to build marks the tenant
        FAILED in the lease payload (degrade-never-kill) — the
        coordinator stops reassigning it."""
        if doc is None:
            doc = self.read_assignment()
        if doc is None:
            return 0
        epoch = int(doc.get("epoch", -1))
        if epoch <= self._epoch:
            return 0
        mine = {
            tid: e for tid, e in doc.get("tenants", {}).items()
            if e.get("worker") == self.worker_id
            and e.get("phase", "serving") == "serving"
        }
        changed = 0
        # a draining tenant naming THIS worker as source that this
        # worker never held (the previous flip was re-migrated before
        # this worker ever applied it): there is nothing to settle —
        # release immediately, or the coordinator waits on a ghost
        for tid, e in doc.get("tenants", {}).items():
            if (
                e.get("phase") == "draining"
                and e.get("src") == self.worker_id
                and (self.daemon is None
                     or tid not in self.daemon._by_id)
            ):
                _storage.write_marker(
                    os.path.join(
                        self.meta_dir, RELEASE_DIR, f"{tid}.json"
                    ),
                    {"epoch": epoch, "ts": self._wall(), "tenant": tid,
                     "never_held": True},
                    tenant=tid,
                )
        if self.daemon is not None:
            for t in list(self.daemon.tenants):
                tid = t.spec.tenant_id
                if tid in mine:
                    continue
                try:
                    summary = self.daemon.remove_tenant(
                        tid, drain=True, reason=f"reassigned@{epoch}"
                    )
                except Exception as e:
                    emit_event(
                        event="fleet_release_error", tenant=tid,
                        worker=self.worker_id, error=repr(e),
                    )
                    summary = {"tenant": tid, "error": repr(e)}
                _storage.write_marker(
                    os.path.join(
                        self.meta_dir, RELEASE_DIR, f"{tid}.json"
                    ),
                    {"epoch": epoch, "ts": self._wall(), **summary},
                    tenant=tid,
                )
                changed += 1
        for tid in sorted(mine):
            if tid in self._failed or (
                self.daemon is not None
                and tid in self.daemon._by_id
            ):
                continue
            spec = self.specs.get(tid)
            if spec is None:
                self._failed[tid] = "tenant not in this worker's catalog"
                emit_event(
                    event="fleet_spec_missing", tenant=tid,
                    worker=self.worker_id,
                )
                continue
            try:
                if self.daemon is None:
                    self._start_daemon([spec])
                else:
                    self.daemon.add_tenant(spec)
                changed += 1
            except Exception as e:
                # a poisoned spec must not kill the worker — nor leak a
                # half-built daemon (the ctor cleans up after itself)
                if self.daemon is not None and not self.daemon.tenants:
                    self.daemon = None
                self._failed[tid] = repr(e)
                emit_event(
                    event="fleet_spec_failed", tenant=tid,
                    worker=self.worker_id, error=repr(e),
                )
        self._epoch = epoch
        return changed

    # -- the loop -----------------------------------------------------------

    def tick(self) -> int:
        """One worker round: renew the lease, apply any new assignment
        epoch, run one daemon scheduling round.  Every fleet-protocol
        failure degrades (the coordinator's TTL machinery owns the
        consequence); only the daemon's own contracts can raise."""
        try:
            self.renew_lease()
        except Exception as e:
            emit_event(
                event="fleet_lease_error", worker=self.worker_id,
                error=repr(e),
            )
        try:
            self.apply_assignment()
        except Exception as e:
            emit_event(
                event="fleet_assign_error", worker=self.worker_id,
                error=repr(e),
            )
        if self.daemon is None or self.daemon.drained:
            return 0
        return self.daemon.tick()

    def drain_requested(self) -> bool:
        return os.path.exists(
            os.path.join(fleet_meta_dir(self.root), FLEET_DRAIN_MARKER)
        )

    def drain(self, reason: str = "fleet_drain") -> int:
        if self.daemon is None:
            return 0
        self.daemon.request_drain(reason)
        return self.daemon.drain()

    def close(self) -> None:
        if self.daemon is not None:
            self.daemon.close()

    @property
    def device_failed(self) -> bool:
        """True once the daemon's shared device domain has failed (see
        the module docs): the worker leaves its loop and its lease
        lapses."""
        return self.daemon is not None and self.daemon.device_failed

    def run(self, poll_interval: float = 0.2) -> Dict[str, Any]:
        """The worker-process foreground loop: tick until SIGTERM, the
        fleet drain marker or a failed device domain, then drain and
        exit."""
        import signal as _signal

        stop = threading.Event()
        try:
            _signal.signal(
                _signal.SIGTERM, lambda signum, frame: stop.set()
            )
        except ValueError:  # not the main thread
            pass
        self.start_heartbeat()
        try:
            while not stop.is_set():
                delta = self.tick()
                if self.drain_requested() or self.device_failed:
                    break
                if delta == 0:
                    stop.wait(poll_interval)
        finally:
            self.drain("fleet_shutdown")
            self.stop_heartbeat()
            status = (
                self.daemon.status() if self.daemon is not None
                else {"tenants": {}}
            )
            self.close()
        return status


# ---------------------------------------------------------------------------
# the coordinator side
# ---------------------------------------------------------------------------


class FleetCoordinator:
    """The fleet's brain: liveness from lease markers, placement from
    the ring, migration (rebalance and dead-worker recovery through ONE
    path), assignment publication, and the fleet metric surface.  Pure
    filesystem + injectable clock — process-agnostic, so tests run it
    in-process against in-process workers while the CLI/bench run it
    against real subprocesses."""

    def __init__(
        self,
        root: str,
        worker_ids: List[str],
        specs_by_id: Dict[str, TenantSpec],
        *,
        lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
        boot_grace_s: float = DEFAULT_BOOT_GRACE_S,
        dead_grace_s: Optional[float] = None,
        vnodes: int = DEFAULT_VNODES,
        slack: float = DEFAULT_SLACK,
        wall=time.time,
        scale_out_hook: Optional[Callable[[str], Optional[str]]] = None,
        standby_root: Optional[str] = None,
    ):
        if not worker_ids:
            raise ValueError("a fleet needs at least one worker id")
        for w in worker_ids:
            validate_worker_id(w)
        self.root = root
        self.specs = dict(specs_by_id)
        self.lease_ttl_s = float(lease_ttl_s)
        self.boot_grace_s = float(boot_grace_s)
        # the ship fence: a DEAD source's tree may only ship after its
        # lease stayed expired this much longer — a slow-but-alive
        # worker gets the window to renew before its tree is taken
        self.dead_grace_s = (
            float(dead_grace_s) if dead_grace_s is not None
            else 2.0 * self.lease_ttl_s
        )
        self.vnodes = int(vnodes)
        self.slack = float(slack)
        self._wall = wall
        self.scale_out_hook = scale_out_hook
        # warm-standby replication: when a dead worker's
        # primary tree cannot ship (fails fsck / torn), the tenant's
        # replica under <standby_root>/<tid> promotes into the
        # destination instead of the tenant going ``failed``
        self.standby_root = standby_root
        self.epoch = 0
        now = self._wall()
        self.workers: Dict[str, Dict[str, Any]] = {
            w: self._worker_row(now) for w in worker_ids
        }
        #: tid -> {"worker", "phase", and for migrations "src"/"dst"/
        #: "reason"/"attempts"} — phase ∈ serving | draining | failed
        self.assignments: Dict[str, Dict[str, Any]] = {}
        self.migrations = {"completed": 0, "reverted": 0}
        self._dirty = False
        self._draining = False
        self._request_offsets: Dict[str, int] = {}
        self._journal = _storage.RotatingJsonlWriter(
            os.path.join(fleet_meta_dir(self.root), ASSIGN_JOURNAL),
            artifact="fleet_assignment_journal",
        )
        os.makedirs(fleet_meta_dir(self.root), exist_ok=True)
        self._recover()
        # fleet requests are advisory and one-shot: a restarted
        # coordinator must not replay pre-crash migrate/scale_out
        # lines, so start consuming each request journal at its tail
        for wid in self.workers:
            path = os.path.join(
                worker_meta_dir(self.root, wid), REQUESTS_JOURNAL
            )
            try:
                self._request_offsets[wid] = os.path.getsize(path)
            except OSError:
                pass
        if not self.assignments:
            self._bootstrap()
        _storage.write_marker(
            os.path.join(fleet_meta_dir(self.root), COORDINATOR_MARKER),
            {
                "ts": now, "pid": os.getpid(),
                "workers": sorted(self.workers),
                "lease_ttl_s": self.lease_ttl_s,
                "tenants": len(self.specs),
            },
        )

    @staticmethod
    def _worker_row(now: float) -> Dict[str, Any]:
        return {
            "state": "pending", "seq": -1, "ts": None,
            "registered": now, "rows_done": 0, "tenants": 0,
            "epoch": -1, "died_at": None,
        }

    # -- placement ----------------------------------------------------------

    def _live_workers(self) -> List[str]:
        return sorted(
            w for w, row in self.workers.items()
            if row["state"] in ("live", "pending")
        )

    def _costs(self, tenant_ids) -> Dict[str, float]:
        return {
            tid: placement_cost(self.specs[tid])
            for tid in tenant_ids if tid in self.specs
        }

    def _pinned(self) -> Dict[str, str]:
        return {
            tid: s.pinned_worker for tid, s in self.specs.items()
            if s.pinned_worker
        }

    def _ring(self, workers: List[str]) -> ConsistentHashRing:
        return ConsistentHashRing(workers, vnodes=self.vnodes)

    def _bootstrap(self) -> None:
        target = self._ring(self._live_workers()).assign(
            self._costs(self.specs), pinned=self._pinned(),
            slack=self.slack,
        )
        for tid, wid in sorted(target.items()):
            self.assignments[tid] = {"worker": wid, "phase": "serving"}
        self._dirty = True
        self.publish()

    def _choose_dst(self, tenant_id: str,
                    exclude: Tuple[str, ...] = ()) -> Optional[str]:
        """The migration destination: first live worker in the
        tenant's ring preference whose current assigned cost stays
        within capacity; least-loaded live worker otherwise."""
        live = [
            w for w in self._live_workers() if w not in exclude
        ]
        if not live:
            return None
        costs = self._costs(
            tid for tid, e in self.assignments.items()
            if e["phase"] != "failed"
        )
        cost = self._costs([tenant_id]).get(tenant_id, 1.0)
        ring = self._ring(live)
        cap = ring.capacity(costs, slack=self.slack)
        load = {w: 0.0 for w in live}
        for tid, e in self.assignments.items():
            w = e.get("worker")
            if w in load and tid != tenant_id:
                load[w] += costs.get(tid, 0.0)
        for cand in ring.preference(tenant_id):
            if load[cand] + cost <= cap:
                return cand
        return min(load, key=lambda w: (load[w], w))

    # -- liveness -----------------------------------------------------------

    def _read_lease(self, worker_id: str) -> Optional[Dict[str, Any]]:
        path = lease_path(self.root, worker_id)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (ValueError, OSError):
            return None  # torn lease reads as absent; TTL owns it

    def _check_liveness(self, now: float) -> None:
        for wid, row in sorted(self.workers.items()):
            lease = self._read_lease(wid)
            if lease is not None and int(lease.get("seq", -1)) > row["seq"]:
                renewed = int(lease["seq"]) - max(row["seq"], 0)
                inc(
                    "sntc_fleet_leases_renewed_total",
                    value=renewed, worker=wid,
                )
                row.update(
                    seq=int(lease["seq"]),
                    ts=float(lease.get("ts", now)),
                    rows_done=int(lease.get("rows_done", 0)),
                    tenants=len(lease.get("tenants", ())),
                    epoch=int(lease.get("epoch", -1)),
                )
                for tid, err in (lease.get("failed") or {}).items():
                    self._mark_failed(tid, wid, err)
                if row["state"] != "live":
                    row["state"] = "live"
                    row["died_at"] = None
                    self._dirty = True  # the doc carries worker states
                    emit_event(
                        event="fleet_worker_live", worker=wid,
                        pid=lease.get("pid"),
                    )
                    # a worker that went live holding NOTHING — a
                    # dead-worker rejoin or a scale-out join — earns
                    # its consistent-hash share through migrations
                    if not any(
                        e["phase"] == "serving" and e["worker"] == wid
                        for e in self.assignments.values()
                    ):
                        self.rebalance(reason="join")
            age = now - (
                row["ts"] if row["ts"] is not None else row["registered"]
            )
            ttl = (
                self.lease_ttl_s if row["ts"] is not None
                else max(self.lease_ttl_s, self.boot_grace_s)
            )
            if row["state"] in ("live", "pending") and age > ttl:
                row["state"] = "dead"
                row["died_at"] = now
                inc("sntc_fleet_leases_expired_total", worker=wid)
                emit_event(
                    event="fleet_worker_dead", worker=wid,
                    lease_age_s=round(age, 3), ttl_s=ttl,
                )
                self._recover_worker(wid)

    def _mark_failed(self, tenant_id: str, worker_id: str,
                     error: str) -> None:
        e = self.assignments.get(tenant_id)
        if e is None or e["phase"] == "failed":
            return
        self.assignments[tenant_id] = {
            "worker": None, "phase": "failed", "error": error,
            "last_worker": worker_id,
        }
        emit_event(
            event="fleet_tenant_failed", tenant=tenant_id,
            worker=worker_id, error=error,
        )
        self._dirty = True

    def _recover_worker(self, worker_id: str) -> None:
        """Dead-worker recovery = the migration path with the drain
        skipped (the source cannot drain; its tree is crash-consistent
        by the WAL contract and the restart replays its in-flight
        intent)."""
        for tid in sorted(self.assignments):
            e = self.assignments[tid]
            if e["phase"] == "serving" and e["worker"] == worker_id:
                self.migrate_tenant(tid, reason="worker_dead")
            elif e["phase"] == "draining" and e.get("dst") == worker_id:
                # the destination died mid-migration: re-route
                e["dst"] = None

    # -- migration ----------------------------------------------------------

    def migrate_tenant(
        self, tenant_id: str, dst: Optional[str] = None,
        *, reason: str = "rebalance",
    ) -> bool:
        """Start moving one tenant (the ONE path for rebalancing, the
        controller's migrate rung, and dead-worker recovery).  The
        actual ship happens on a later :meth:`tick`, once the source
        released the tenant (immediately, when the source is dead)."""
        e = self.assignments.get(tenant_id)
        if e is None or e["phase"] != "serving":
            return False
        src = e["worker"]
        if dst is None:
            dst = self._choose_dst(tenant_id, exclude=(src,))
        if dst is None or dst == src:
            emit_event(
                event="fleet_migrate_skipped", tenant=tenant_id,
                src=src, reason="no eligible destination",
            )
            return False
        self.assignments[tenant_id] = {
            "worker": None, "phase": "draining", "src": src,
            "dst": dst, "reason": reason, "attempts": 0,
            "epoch": self.epoch + 1,
        }
        emit_event(
            event="fleet_migrate_start", tenant=tenant_id, src=src,
            dst=dst, reason=reason,
        )
        self._dirty = True
        return True

    def _release_marker(self, worker_id: str, tenant_id: str) -> str:
        return os.path.join(
            worker_meta_dir(self.root, worker_id), RELEASE_DIR,
            f"{tenant_id}.json",
        )

    def _source_released(self, e: Dict[str, Any], tenant_id: str,
                         now: float) -> bool:
        src = e["src"]
        row = self.workers.get(src)
        if row is not None and row.get("state") == "dead":
            # a dead source cannot drain — but "dead" is a TTL verdict,
            # not proof.  Fence before shipping its tree out from under
            # a possibly-still-writing daemon: (1) the lease must stay
            # expired an extra dead_grace_s past the declaration, and
            # (2) a final lease re-read must show no renewal since (a
            # renewal here revives the worker on the next liveness
            # pass, which then drains the tenant properly).
            died_at = row.get("died_at")
            if died_at is None:
                row["died_at"] = now  # adopt: fence from first sight
                return False
            if now - died_at < self.dead_grace_s:
                return False
            lease = self._read_lease(src)
            if lease is not None and int(lease.get("seq", -1)) > row["seq"]:
                return False
            return True
        path = self._release_marker(src, tenant_id)
        if not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                rec = json.load(f)
        except (ValueError, OSError):
            return False
        return int(rec.get("epoch", -1)) >= int(e.get("epoch", 0))

    def _continue_migrations(self, now: float) -> None:
        for tid in sorted(self.assignments):
            e = self.assignments[tid]
            if e["phase"] != "draining":
                continue
            if e.get("dst") is None:
                e["dst"] = self._choose_dst(tid, exclude=(e["src"],))
                if e["dst"] is None:
                    # nowhere to go.  If the SOURCE is back, revert to
                    # it (the torn-ship discipline) instead of leaving
                    # the tenant stranded in draining forever — its
                    # tree at the source is intact until a flip.
                    src = e["src"]
                    if self.workers.get(src, {}).get("state") == "live":
                        self.assignments[tid] = {
                            "worker": src, "phase": "serving",
                        }
                        self._remove_release(src, tid)
                        inc(
                            "sntc_fleet_migrations_total",
                            reason=e.get("reason", "?"),
                            outcome="reverted",
                        )
                        self.migrations["reverted"] += 1
                        emit_event(
                            event="fleet_migrate_reverted", tenant=tid,
                            src=src, dst=None,
                            reason=e.get("reason"),
                            error="no eligible destination",
                            resumed_at=src,
                        )
                        self._dirty = True
                    continue  # retry next tick
                self._dirty = True  # the doc carries the new dst
            if self._source_released(e, tid, now):
                self._ship_and_flip(tid, e)

    def _manifest_path(self, tenant_id: str) -> str:
        return os.path.join(
            fleet_meta_dir(self.root), MIGRATIONS_DIR,
            f"{tenant_id}.json",
        )

    def _ship_tree(self, tenant_id: str, src_tree: str,
                   shipping: str) -> List[List[Any]]:
        """Copy the tenant's state tree file-by-file into the shipping
        dir, hashing as it goes; ``fleet.migrate`` fires before every
        file so a kill/fault anywhere mid-ship leaves a torn copy the
        verifier rejects.  Returns the manifest file rows."""
        if os.path.isdir(shipping):
            shutil.rmtree(shipping)  # a previous attempt's leftovers
        files: List[List[Any]] = []
        for dirpath, dirs, names in os.walk(src_tree):
            dirs[:] = [d for d in dirs if d != ".corrupt"]
            rel_dir = os.path.relpath(dirpath, src_tree)
            os.makedirs(
                os.path.join(shipping, rel_dir)
                if rel_dir != "." else shipping,
                exist_ok=True,
            )
            for name in sorted(names):
                src_f = os.path.join(dirpath, name)
                rel = os.path.normpath(os.path.join(rel_dir, name))
                fault_point("fleet.migrate", tenant=tenant_id)
                with open(src_f, "rb") as f:
                    data = f.read()
                with open(os.path.join(shipping, rel), "wb") as f:
                    f.write(data)
                files.append([
                    rel, len(data), hashlib.sha256(data).hexdigest()
                ])
        return files

    def _verify_shipment(self, manifest: Dict[str, Any],
                         shipping: str) -> None:
        """Re-hash every shipped file against the sealed manifest and
        fsck the shipped checkpoint tree; raises on any mismatch."""
        for rel, size, digest in manifest["files"]:
            path = os.path.join(shipping, rel)
            with open(path, "rb") as f:
                data = f.read()
            if len(data) != size or (
                hashlib.sha256(data).hexdigest() != digest
            ):
                raise _storage.StorageCorruptError(
                    f"shipped file {rel!r} does not match its manifest "
                    "entry"
                )
        ckpt = os.path.join(shipping, "ckpt")
        if os.path.isdir(ckpt):
            report = _storage.fsck_root(
                ckpt, repair=True, tenant=manifest["tenant"]
            )
            if not report["ok"]:
                raise _storage.StorageCorruptError(
                    f"shipped tree failed fsck: {report['errors']}"
                )

    def _quarantine_shipping(self, shipping: str, tenant_id: str,
                             detail: str) -> None:
        if not os.path.isdir(shipping):
            return
        dest_root = os.path.join(self.root, ".corrupt")
        os.makedirs(dest_root, exist_ok=True)
        dest = os.path.join(
            dest_root,
            f"fleet_migration_{tenant_id}_{self.epoch}_{os.getpid()}",
        )
        try:
            if os.path.isdir(dest):
                shutil.rmtree(dest)
            shutil.move(shipping, dest)
        except OSError:
            shutil.rmtree(shipping, ignore_errors=True)
            dest = None
        emit_event(
            event="fleet_ship_quarantined", tenant=tenant_id,
            detail=detail, quarantined_to=dest,
        )

    def _ship_and_flip(self, tenant_id: str, e: Dict[str, Any]) -> None:
        src, dst, reason = e["src"], e["dst"], e.get("reason", "?")
        src_tree = tenant_tree(self.root, src, tenant_id)
        dst_tree = tenant_tree(self.root, dst, tenant_id)
        shipping = dst_tree + ".shipping"
        e["attempts"] = int(e.get("attempts", 0)) + 1
        try:
            if os.path.isdir(src_tree):
                files = self._ship_tree(tenant_id, src_tree, shipping)
                manifest = _storage.seal_record({
                    "tenant": tenant_id, "src": src, "dst": dst,
                    "reason": reason, "epoch": self.epoch + 1,
                    "files": files,
                })
                _storage.atomic_write_json(
                    self._manifest_path(tenant_id), manifest,
                    site="storage.marker", tenant=tenant_id,
                )
                self._verify_shipment(manifest, shipping)
                if os.path.isdir(dst_tree):
                    shutil.rmtree(dst_tree)
                os.rename(shipping, dst_tree)
            # (no src tree = the tenant never reached disk: a fresh
            # start at the destination IS its converged state)
        except Exception as exc:
            self._quarantine_shipping(shipping, tenant_id, repr(exc))
            inc(
                "sntc_fleet_migrations_total", reason=reason,
                outcome="reverted",
            )
            self.migrations["reverted"] += 1
            src_live = (
                self.workers.get(src, {}).get("state") != "dead"
            )
            if src_live:
                # the source still holds the intact tree: the tenant
                # re-resumes THERE — a torn ship must never lose rows
                self.assignments[tenant_id] = {
                    "worker": src, "phase": "serving",
                }
                self._remove_release(src, tenant_id)
            elif self._restore_from_replica(
                tenant_id, dst, dst_tree, error=repr(exc)
            ):
                self._dirty = True
                return
            elif e["attempts"] >= MAX_SHIP_ATTEMPTS:
                self._mark_failed(tenant_id, src, repr(exc))
            emit_event(
                event="fleet_migrate_reverted", tenant=tenant_id,
                src=src, dst=dst, reason=reason, error=repr(exc),
                resumed_at=src if src_live else None,
            )
            self._dirty = True
            return
        # flipped: the destination owns the tenant from this epoch on
        self.assignments[tenant_id] = {"worker": dst, "phase": "serving"}
        self._remove_release(src, tenant_id)
        self._retire_src_tree(tenant_id, src, src_tree)
        inc(
            "sntc_fleet_migrations_total", reason=reason,
            outcome="completed",
        )
        self.migrations["completed"] += 1
        emit_event(
            event="fleet_migrate_done", tenant=tenant_id, src=src,
            dst=dst, reason=reason,
        )
        self._dirty = True

    def _restore_from_replica(
        self, tenant_id: str, dst: str, dst_tree: str, *, error: str,
    ) -> bool:
        """Dead-source recovery of last resort: the primary tree
        could not ship (fsck failure, torn files, unreadable disk) and
        the source is dead — promote the tenant's warm-standby replica
        into the destination tree instead of marking the tenant
        ``failed``.  Returns True when the tenant is serving again."""
        if not self.standby_root:
            return False
        from sntc_tpu_torch.resilience.replicate import (
            promote_standby,
            replica_dir,
        )

        if not os.path.isdir(replica_dir(self.standby_root, tenant_id)):
            return False
        staging = dst_tree + ".restoring"
        shutil.rmtree(staging, ignore_errors=True)
        try:
            rep = promote_standby(self.standby_root, tenant_id, staging)
        except Exception as exc:
            shutil.rmtree(staging, ignore_errors=True)
            emit_event(
                event="fleet_replica_restore_failed", tenant=tenant_id,
                error=repr(exc), ship_error=error,
            )
            return False
        if not rep.get("ok"):
            shutil.rmtree(staging, ignore_errors=True)
            emit_event(
                event="fleet_replica_restore_failed", tenant=tenant_id,
                reason=rep.get("reason"), ship_error=error,
            )
            return False
        if os.path.isdir(dst_tree):
            shutil.rmtree(dst_tree)
        os.rename(staging, dst_tree)
        self.assignments[tenant_id] = {"worker": dst, "phase": "serving"}
        inc(
            "sntc_fleet_migrations_total", reason="replica_restore",
            outcome="completed",
        )
        self.migrations["completed"] += 1
        emit_event(
            event="tenant_restored_from_replica", tenant=tenant_id,
            worker=dst, ship_error=error,
            batches_through=rep.get("batches_through"),
            rto_seconds=rep.get("rto_seconds"),
        )
        return True

    def _remove_release(self, worker_id: str, tenant_id: str) -> None:
        try:
            os.unlink(self._release_marker(worker_id, tenant_id))
        except OSError:
            pass

    def _retire_src_tree(
        self, tenant_id: str, src: str, src_tree: str,
        *, assume_dead: bool = False,
    ) -> None:
        """Dispose of the source copy after a completed flip.  A LIVE
        source acked the move (its release marker carries the epoch) —
        its daemon no longer touches the tree, so deletion is safe.  A
        DEAD source may be a zombie still writing: never destroy its
        bytes — rename the tree aside into ``fleet/retired/`` (out of
        the serving namespace, preserved as evidence; a rename keeps
        the single-home invariant under ``worker/*/tenant/``)."""
        if not os.path.isdir(src_tree):
            return
        if not assume_dead and (
            self.workers.get(src, {}).get("state") != "dead"
        ):
            shutil.rmtree(src_tree, ignore_errors=True)
            return
        dest_root = os.path.join(fleet_meta_dir(self.root), RETIRED_DIR)
        dest = os.path.join(
            dest_root, f"{tenant_id}.{src}.{self.epoch + 1}"
        )
        try:
            os.makedirs(dest_root, exist_ok=True)
            if os.path.isdir(dest):
                shutil.rmtree(dest)
            shutil.move(src_tree, dest)
        except OSError:
            dest = None  # left in place; recovery retries the retire
        emit_event(
            event="fleet_src_tree_retired", tenant=tenant_id,
            worker=src, retired_to=dest,
        )

    # -- fleet requests ------------------------------------------------------

    def _consume_requests(self) -> None:
        for wid in sorted(self.workers):
            path = os.path.join(
                worker_meta_dir(self.root, wid), REQUESTS_JOURNAL
            )
            if not os.path.exists(path):
                continue
            offset = self._request_offsets.get(wid, 0)
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    tail = f.read()
            except OSError:
                continue
            # binary read + newline-bounded cut: the offset is a BYTE
            # position, and a torn (partial) last line stays unconsumed
            # for the next tick rather than being silently dropped —
            # these requests fire at most once per tenant per daemon
            # lifetime, so a lost line is never re-posted
            cut = tail.rfind(b"\n") + 1
            if cut == 0:
                continue
            for line in tail[:cut].splitlines():
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a genuinely corrupt (mid-file) line
                self._handle_request(rec)
            self._request_offsets[wid] = offset + cut

    def _handle_request(self, rec: Dict[str, Any]) -> None:
        action = rec.get("action")
        tid = rec.get("tenant")
        if action == "migrate":
            self.migrate_tenant(tid, reason="controller")
        elif action == "scale_out":
            emit_event(
                event="fleet_scale_out_requested", tenant=tid,
                worker=rec.get("worker"), reason=rec.get("reason"),
            )
            if self.scale_out_hook is not None:
                try:
                    new_wid = self.scale_out_hook(rec.get("reason", ""))
                except Exception as e:
                    emit_event(
                        event="fleet_scale_out_error", error=repr(e)
                    )
                    return
                if new_wid:
                    try:
                        self.add_worker(new_wid)
                    except ValueError as e:
                        emit_event(
                            event="fleet_scale_out_error", error=repr(e)
                        )

    # -- membership ----------------------------------------------------------

    def add_worker(self, worker_id: str) -> None:
        if worker_id in self.workers:
            return
        validate_worker_id(worker_id)
        self.workers[worker_id] = self._worker_row(self._wall())
        emit_event(event="fleet_worker_added", worker=worker_id)
        self.rebalance(reason="join")

    def rebalance(self, *, reason: str = "rebalance") -> int:
        """Recompute bounded-load placement over the live workers and
        migrate every serving tenant whose target moved (consistent
        hashing bounds how many do)."""
        live = self._live_workers()
        if not live:
            return 0
        serving = [
            tid for tid, e in self.assignments.items()
            if e["phase"] == "serving"
        ]
        target = self._ring(live).assign(
            self._costs(serving), pinned=self._pinned(),
            slack=self.slack,
        )
        moved = 0
        for tid in sorted(target):
            if self.assignments[tid]["worker"] != target[tid]:
                if self.migrate_tenant(
                    tid, target[tid], reason=reason
                ):
                    moved += 1
        return moved

    # -- publish / recover ---------------------------------------------------

    def assignment_doc(self) -> Dict[str, Any]:
        return {
            "epoch": self.epoch,
            "ts": self._wall(),
            "workers": {
                w: row["state"] for w, row in sorted(self.workers.items())
            },
            "tenants": {
                tid: dict(e)
                for tid, e in sorted(self.assignments.items())
            },
        }

    def publish(self) -> bool:
        """Publish the current assignment epoch: the ``fleet.assign``
        fault boundary, one atomic marker write, one journal line."""
        if not self._dirty:
            return False
        self.epoch += 1
        fault_point("fleet.assign")
        doc = self.assignment_doc()
        _storage.atomic_write_json(
            os.path.join(fleet_meta_dir(self.root), ASSIGN_MARKER),
            doc, site="storage.marker",
        )
        self._journal.write(doc)
        self._dirty = False
        return True

    def _recover(self) -> None:
        """Restart convergence: re-adopt the published assignment,
        quarantine any torn mid-ship copies, and put every in-flight
        migration back on the path (the tenant is live on exactly one
        worker after the next few ticks — the kill-mid-migrate
        contract)."""
        path = os.path.join(fleet_meta_dir(self.root), ASSIGN_MARKER)
        if not os.path.exists(path):
            return
        try:
            doc = json.load(open(path))
        except (ValueError, OSError) as e:
            emit_event(
                event="fleet_recover_error", error=repr(e), path=path
            )
            return
        self.epoch = int(doc.get("epoch", 0))
        for tid, e in sorted(doc.get("tenants", {}).items()):
            self.assignments[tid] = dict(e)
        # torn mid-ship copies: the flip is a dir rename AFTER manifest
        # verification, so any *.shipping dir is by construction an
        # unverified partial — quarantine it; its migration entry is
        # still "draining" and will re-ship from the intact source
        for shipping in sorted(glob.glob(
            os.path.join(self.root, WORKER_TREES, "*", "tenant",
                         "*.shipping")
        )):
            tid = os.path.basename(shipping)[: -len(".shipping")]
            self._quarantine_shipping(
                shipping, tid, "torn mid-ship copy found at recovery"
            )
        # a crash between flip and source-tree retirement leaves a
        # stale source copy: the assignment is the truth — retire trees
        # at workers that no longer own the tenant IF a verified
        # manifest records the completed move.  Retire (rename aside),
        # never rmtree: a restarted coordinator has no liveness
        # verdict yet, and the worker could be a zombie mid-write.
        for tid, e in sorted(self.assignments.items()):
            if e.get("phase") != "serving":
                continue
            mpath = self._manifest_path(tid)
            if not os.path.exists(mpath):
                continue
            try:
                manifest = _storage.load_sealed_json(mpath)
            except _storage.StorageCorruptError:
                continue
            if manifest.get("dst") != e.get("worker"):
                continue
            if manifest.get("src"):
                self._retire_src_tree(
                    tid, manifest["src"],
                    tenant_tree(self.root, manifest["src"], tid),
                    assume_dead=True,
                )
        emit_event(
            event="fleet_recovered", epoch=self.epoch,
            tenants=len(self.assignments),
        )

    # -- the loop ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One coordinator round: liveness, fleet requests, in-flight
        migrations, publish-if-changed, gauges.  Returns a compact
        status row."""
        if now is None:
            now = self._wall()
        if self.draining:
            # the fleet is shutting down: workers exiting on purpose
            # must not read as lease expiries and trigger a final
            # storm of pointless migrations
            self.publish()
            self._publish_gauges()
            return self.status()
        self._check_liveness(now)
        self._consume_requests()
        self._continue_migrations(now)
        self.publish()
        self._publish_gauges()
        return self.status()

    @property
    def draining(self) -> bool:
        if not self._draining and os.path.exists(
            os.path.join(fleet_meta_dir(self.root), FLEET_DRAIN_MARKER)
        ):
            self._draining = True
        return self._draining

    def _publish_gauges(self) -> None:
        total_rows = 0
        for wid, row in sorted(self.workers.items()):
            set_gauge(
                "sntc_fleet_worker_state",
                1 if row["state"] == "live" else 0, worker=wid,
            )
            set_gauge(
                "sntc_fleet_tenants_value",
                sum(
                    1 for e in self.assignments.values()
                    if e.get("worker") == wid and e["phase"] == "serving"
                ),
                worker=wid,
            )
            set_gauge(
                "sntc_fleet_rows_value", row["rows_done"], worker=wid
            )
            if row["state"] == "live":
                total_rows += row["rows_done"]
        set_gauge("sntc_fleet_rows_value", total_rows, worker="fleet")

    def drain_fleet(self, reason: str = "drain") -> None:
        """Raise the fleet drain marker every worker's loop watches."""
        self._draining = True
        _storage.write_marker(
            os.path.join(fleet_meta_dir(self.root), FLEET_DRAIN_MARKER),
            {"ts": self._wall(), "reason": reason, "epoch": self.epoch},
        )
        emit_event(event="fleet_drain", reason=reason)

    def status(self) -> Dict[str, Any]:
        phases: Dict[str, int] = {}
        for e in self.assignments.values():
            phases[e["phase"]] = phases.get(e["phase"], 0) + 1
        return {
            "epoch": self.epoch,
            "workers": {
                w: {
                    "state": row["state"], "rows_done": row["rows_done"],
                    "tenants": sum(
                        1 for e in self.assignments.values()
                        if e.get("worker") == w
                        and e["phase"] == "serving"
                    ),
                }
                for w, row in sorted(self.workers.items())
            },
            "tenants": len(self.assignments),
            "phases": phases,
            "migrations": dict(self.migrations),
        }

    def close(self) -> None:
        # no handles held (the journal opens per append); flush the
        # final state so a restarted coordinator adopts it verbatim
        self._dirty = True
        self.publish()


# ---------------------------------------------------------------------------
# fleet-root fsck (the `sntc fsck --fleet-root` walker)
# ---------------------------------------------------------------------------


def fsck_fleet(root: str, *, repair: bool = True) -> Dict[str, Any]:
    """Doctor a coordinator root: the fleet metadata (assignment
    marker + journal, leases, request journals, migration manifests)
    plus every worker's daemon tree through the standard per-root
    :func:`~sntc_tpu_torch.resilience.storage.fsck`.  Torn journals repair
    through the tolerant-reader discipline; an unrepairable (corrupt
    sealed) migration manifest is an ERROR — ``ok`` goes False and the
    CLI exits 1."""
    fdir = fleet_meta_dir(root)
    report: Dict[str, Any] = {
        "root": root, "fleet": True, "repair": bool(repair),
        "checked": {}, "repaired": [], "quarantined": [], "cleaned": [],
        "errors": [], "workers": {},
    }

    def _checked(kind: str) -> None:
        report["checked"][kind] = report["checked"].get(kind, 0) + 1

    # 1. assignment journal: torn tails repair; mid-file damage
    # quarantines (the atomic marker is the authoritative epoch)
    jpath = os.path.join(fdir, ASSIGN_JOURNAL)
    if os.path.exists(jpath):
        _checked("fleet_assignment_journal")
        try:
            _records, rec = _storage.read_jsonl_tolerant(
                jpath, repair=repair,
                artifact="fleet_assignment_journal", repair_dir=fdir,
            )
            if rec is not None:
                (report["repaired"] if repair
                 else report["errors"]).append(
                    {"path": jpath,
                     "artifact": "fleet_assignment_journal", **rec}
                )
        except _storage.JsonlCorruptError as e:
            q = _storage.quarantine_blob(
                jpath, artifact="fleet_assignment_journal",
                detail=str(e), root=fdir,
            ) if repair else None
            (report["quarantined"] if repair
             else report["errors"]).append(
                {"path": jpath, "detail": str(e),
                 "quarantined_to": q}
            )

    # 2. the assignment marker + coordinator marker + leases + release
    # markers: atomic JSON — unparseable means a dying disk; the lease
    # refreshes on the next heartbeat and the marker on the next
    # publish, so quarantining preserves evidence without data loss
    markers = [
        (os.path.join(fdir, ASSIGN_MARKER), "fleet_assignments"),
        (os.path.join(fdir, COORDINATOR_MARKER), "fleet_markers"),
        (os.path.join(fdir, FLEET_DRAIN_MARKER), "fleet_markers"),
    ]
    markers += [
        (p, "fleet_lease") for p in sorted(glob.glob(
            os.path.join(fdir, WORKERS_DIR, "*", LEASE_MARKER)
        ))
    ]
    markers += [
        (p, "fleet_markers") for p in sorted(glob.glob(
            os.path.join(fdir, WORKERS_DIR, "*", RELEASE_DIR, "*.json")
        ))
    ]
    for path, artifact in markers:
        if not os.path.exists(path):
            continue
        _checked(artifact)
        try:
            with open(path) as f:
                json.load(f)
        except ValueError as e:
            detail = f"unparseable fleet marker: {e}"
            if repair:
                q = _storage.quarantine_blob(
                    path, artifact=artifact, detail=detail, root=fdir,
                )
                report["quarantined"].append(
                    {"path": path, "detail": detail,
                     "quarantined_to": q}
                )
            else:
                report["errors"].append(
                    {"path": path, "detail": detail}
                )

    # 3. request journals: same tolerant-reader discipline
    for path in sorted(glob.glob(
        os.path.join(fdir, WORKERS_DIR, "*", REQUESTS_JOURNAL)
    )):
        _checked("fleet_request_journal")
        try:
            _records, rec = _storage.read_jsonl_tolerant(
                path, repair=repair, artifact="fleet_request_journal",
                repair_dir=fdir,
            )
            if rec is not None:
                (report["repaired"] if repair
                 else report["errors"]).append(
                    {"path": path,
                     "artifact": "fleet_request_journal", **rec}
                )
        except _storage.JsonlCorruptError as e:
            q = _storage.quarantine_blob(
                path, artifact="fleet_request_journal", detail=str(e),
                root=fdir,
            ) if repair else None
            (report["quarantined"] if repair
             else report["errors"]).append(
                {"path": path, "detail": str(e), "quarantined_to": q}
            )

    # 4. migration manifests: SEALED records — a broken seal is not
    # repairable (the history of what moved where is gone); loud error
    for path in sorted(glob.glob(
        os.path.join(fdir, MIGRATIONS_DIR, "*.json")
    )):
        _checked("fleet_migration_manifest")
        try:
            _storage.load_sealed_json(path)
        except _storage.StorageCorruptError as e:
            report["errors"].append(
                {"path": path, "artifact": "fleet_migration_manifest",
                 "detail": str(e)}
            )

    # 5. torn mid-ship copies are by construction unverified partials
    for shipping in sorted(glob.glob(
        os.path.join(root, WORKER_TREES, "*", "tenant", "*.shipping")
    )):
        _checked("shipping_orphans")
        if repair:
            shutil.rmtree(shipping, ignore_errors=True)
            report["cleaned"].append({"path": shipping})
        else:
            report["errors"].append(
                {"path": shipping, "detail": "torn mid-ship copy"}
            )

    # 6. every worker's daemon root, tenant trees included
    for wdir in sorted(glob.glob(
        os.path.join(root, WORKER_TREES, "*")
    )):
        wid = os.path.basename(wdir)
        report["workers"][wid] = _storage.fsck(
            wdir, repair=repair, tenant_tree=True
        )

    # 7. retired dead-source trees: until now these were
    # write-only evidence — verify each one like any tenant tree so a
    # ``fleet-restore-retired`` has a known-good source to copy from
    report["retired"] = {}
    for rdir in sorted(glob.glob(
        os.path.join(fdir, RETIRED_DIR, "*")
    )):
        name = os.path.basename(rdir)
        if not os.path.isdir(rdir) or name.startswith("."):
            continue
        _checked("fleet_retired_tree")
        ckpt = os.path.join(rdir, "ckpt")
        report["retired"][name] = _storage.fsck_root(
            ckpt if os.path.isdir(ckpt) else rdir, repair=repair
        )

    report["ok"] = (
        not report["errors"]
        and all(r["ok"] for r in report["workers"].values())
        and all(r["ok"] for r in report["retired"].values())
    )
    return report


def restore_retired(
    root: str, name: str, dest: str, *, repair: bool = True,
) -> Dict[str, Any]:
    """Recover a retired dead-source tree
    ``fleet/retired/<tid>.<wid>.<epoch>`` into an EXPLICIT destination
    directory (never back into the serving namespace — the operator
    inspects, then re-registers the tenant or merges by hand):
    fsck-verify the tree, copy it file-by-file, publish a sealed
    restore manifest beside the copy, and journal the restore.  This
    is how a wrongly-declared-dead worker's rows come back."""
    src = os.path.join(fleet_meta_dir(root), RETIRED_DIR, name)
    report: Dict[str, Any] = {
        "name": name, "src": src, "dest": dest, "ok": False,
    }
    if not os.path.isdir(src):
        report["error"] = "no such retired tree"
        return report
    ckpt = os.path.join(src, "ckpt")
    fs = _storage.fsck_root(
        ckpt if os.path.isdir(ckpt) else src, repair=repair
    )
    report["fsck"] = fs
    if not fs["ok"]:
        report["error"] = "retired tree fails fsck"
        return report
    files = []
    for dirpath, dirnames, filenames in os.walk(src):
        dirnames[:] = [d for d in dirnames if d != ".corrupt"]
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, src)
            with open(p, "rb") as f:
                data = f.read()
            _storage.atomic_write_bytes(
                os.path.join(dest, rel), data, site="storage.marker",
            )
            files.append(
                [rel, len(data), hashlib.sha256(data).hexdigest()]
            )
    manifest = _storage.seal_record({
        "retired": name, "dest": os.path.abspath(dest), "files": files,
    })
    _storage.atomic_write_json(
        os.path.join(dest, "restore_manifest.json"), manifest,
        site="storage.marker",
    )
    emit_event(
        event="fleet_retired_restored", name=name, dest=dest,
        files=len(files),
    )
    report.update(ok=True, files=len(files))
    return report
