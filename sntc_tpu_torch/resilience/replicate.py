"""Warm-standby replication: a tenant's durable artifact tree shipped to
a standby root at each engine commit, with commit barriers, promotion
and RPO/RTO evidence.

Counterpart of ``sntc_tpu/resilience/replicate.py``; both packages write
and read the same bytes, so a replica either package wrote promotes with
either package's :func:`promote_standby`.

**Shipping.**  A :class:`ReplicationPlane` copies every file that the
``resilience.storage.ARTIFACTS`` registry declares under a primary root
(WAL records and compaction checkpoints, flow-state snapshots, model
checkpoints, markers, rotating journals; new artifact classes replicate
by construction), plus the sink's ``batch_*.csv`` files, into
``<standby_root>/<tenant>/tree`` and ``.../sink``.  A primary root is a
bare checkpoint dir (``serve``) or a tenant tree with ``ckpt/`` inside
(the daemon, a fleet worker).

**Commit barriers.**  At each engine commit (the engine's
``commit_listener``) the plane ships the changed files, publishes a
sealed ``replica_manifest.json`` and appends a sealed barrier record
keyed to the committed batch and offset to ``barriers.jsonl``.  The
barrier says "the replica holds everything through batch B".  Batch ids
are engine-sequential, so ``batches_through == batch_id + 1`` stays
exact across plane restarts.

**Promotion.**  :func:`promote_standby` doctors the replica, re-hashes
every immutable manifest entry against its sealed sha256 (a mismatch
quarantines to ``.corrupt/`` and the promotion refuses), sets aside
un-manifested strays of a torn ship, copies the verified tree to the
destination and truncates it to the last sealed barrier (later commits
and sink files are dropped; the promoted engine serves them again from
the source).  RPO is the barrier lag in batches, rows, bytes and
seconds, RTO the promotion's wall time, and the loss-accounting law

    committed == replicated_through_barrier + counted_tail_loss

holds exactly in batches when the dead primary's tree is readable.

**Anti-entropy.**  :func:`fsck_standby` (``fsck --standby``) checks
every replica against its sealed manifest and against the primary and
journals a ``replica_diverged`` event for each mismatch.

Fault sites: ``repl.ship`` (each shipped file), ``repl.apply`` (the
manifest publish), ``repl.barrier`` (the barrier append).  A replication
failure degrades (counted, journaled, retried at the next commit); it
never fails the serving engine.  This is host file shipping: no device
work is involved.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from sntc_tpu_torch.obs.metrics import inc, set_gauge
from sntc_tpu_torch.resilience import storage as _storage
from sntc_tpu_torch.resilience.faults import fault_point
from sntc_tpu_torch.resilience.policy import emit_event
from sntc_tpu_torch.resilience.storage import (
    ARTIFACTS,
    RotatingJsonlWriter,
    StorageCorruptError,
    atomic_write_bytes,
    atomic_write_json,
    load_sealed_json,
    read_jsonl_tolerant,
    seal_record,
    verify_sealed,
)

MANIFEST_NAME = "replica_manifest.json"
BARRIER_LOG = "barriers.jsonl"
TREE_DIR = "tree"
SINK_DIR = "sink"
DEFAULT_TENANT = "default"
DEFAULT_SINK_PATTERNS = ("batch_*.csv",)

#: artifacts whose files are rewritten/appended in place — verified by
#: their own formats (sealed records, tolerant JSONL readers, fsck),
#: not by a point-in-time manifest hash.  Everything else is immutable
#: once published and MUST re-hash to its manifest sha256 at promotion.
_MUTABLE_BASENAMES = frozenset(
    (
        "offsets.log",
        "commits.log",
        "wal_checkpoint.json",
        "ingress_stats.json",
        "drain_marker.json",
        "model_marker.json",
        "daemon_drain_marker.json",
        "health.json",
    )
)

_SINK_IDX_RE = re.compile(r"batch_(\d+)")


def _labels(tenant: Optional[str]) -> Dict[str, str]:
    return {"tenant": tenant} if tenant else {}


def _is_mutable(rel: str) -> bool:
    base = os.path.basename(rel)
    return base in _MUTABLE_BASENAMES or ".jsonl" in base


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def replica_dir(standby_root: str, tenant: str) -> str:
    return os.path.join(standby_root, tenant)


def _ckpt_root(root: str) -> str:
    """A replicated root is either a bare checkpoint dir (``serve``)
    or a tenant tree with ``ckpt/`` inside (daemon / fleet worker)."""
    ckpt = os.path.join(root, "ckpt")
    return ckpt if os.path.isdir(ckpt) else root


def artifact_files(root: str) -> Dict[str, str]:
    """``rel -> artifact name`` for every live file under ``root``
    matched by a registered ``ARTIFACTS`` pattern — applied at the
    root AND at ``root/ckpt`` so bare-engine and tenant-tree layouts
    both enumerate.  New artifact classes added to the registry
    replicate by construction; ``.corrupt/`` quarantine and ``*.tmp-``
    orphans never ship."""
    out: Dict[str, str] = {}
    for spec in ARTIFACTS.values():
        for pat in spec.patterns:
            for base in ("", "ckpt"):
                for p in glob.glob(os.path.join(root, base, pat)):
                    if not os.path.isfile(p):
                        continue
                    rel = os.path.relpath(p, root)
                    if ".corrupt" in rel.split(os.sep) or ".tmp-" in rel:
                        continue
                    out.setdefault(rel, spec.name)
    return out


def committed_batches(ckpt_root: str) -> Dict[str, Any]:
    """Post-mortem committed-batch census of a checkpoint root, both
    WAL modes.  Batch ids are engine-sequential from 0, so ``count``
    is ``last committed id + 1`` even where retention/compaction has
    pruned the individual records."""
    last, end = -1, 0
    cdir = os.path.join(ckpt_root, "commits")
    if os.path.isdir(cdir):
        for p in glob.glob(os.path.join(cdir, "*.json")):
            try:
                with open(p) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue  # a torn commit never landed
            bid = int(rec["batch_id"])
            if bid > last:
                last, end = bid, int(rec["end"])
        return {"count": last + 1, "last_id": last, "last_end": end}
    ck = os.path.join(ckpt_root, "wal_checkpoint.json")
    if os.path.exists(ck):
        try:
            core = load_sealed_json(ck)
            last = int(core["last_committed"])
            end = int(core["end"])
        except (OSError, StorageCorruptError):
            pass
    clog = os.path.join(ckpt_root, "commits.log")
    if os.path.exists(clog):
        try:
            recs, _ = read_jsonl_tolerant(clog, repair=False)
        except _storage.JsonlCorruptError:
            recs = []
        for rec in recs:
            bid = int(rec.get("batch_id", -1))
            if bid > last:
                last, end = bid, int(rec["end"])
    return {"count": last + 1, "last_id": last, "last_end": end}


def last_barrier(standby_root: str, tenant: str) -> Optional[Dict[str, Any]]:
    """The newest VALID sealed barrier record, or None.  Walks the
    active barrier log then its rotated segments, newest line first;
    torn/corrupt lines (a crash mid-append, a broken seal) are simply
    skipped — the last *sealed* barrier is the promotion point."""
    base = os.path.join(replica_dir(standby_root, tenant), BARRIER_LOG)
    for path in (base, base + ".1", base + ".2"):
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in reversed(lines):
            line = line.strip()
            if not line:
                continue
            try:
                return verify_sealed(json.loads(line), path)
            except (ValueError, StorageCorruptError):
                continue
    return None


class ReplicationPlane:
    """Continuously replicate one primary root's durable artifact tree
    to ``<standby_root>/<tenant>/`` with sealed manifests and commit
    barriers.  Wire :meth:`on_commit` as the engine's
    ``commit_listener``; every ``barrier_every`` commits the plane
    ships changed files (``repl.ship`` per file), publishes the sealed
    manifest (``repl.apply``), and seals a barrier record
    (``repl.barrier``).  Failures degrade and retry at the next
    commit — replication never fails the serving engine."""

    def __init__(
        self,
        primary_root: str,
        standby_root: str,
        *,
        tenant: str = DEFAULT_TENANT,
        barrier_every: int = 1,
        sink_dir: Optional[str] = None,
        sink_patterns: Tuple[str, ...] = DEFAULT_SINK_PATTERNS,
    ) -> None:
        self.primary_root = primary_root
        self.standby_root = standby_root
        self.tenant = tenant or DEFAULT_TENANT
        self.barrier_every = max(1, int(barrier_every))
        self.sink_dir = sink_dir
        self.sink_patterns = tuple(sink_patterns)
        self.rep_dir = replica_dir(standby_root, self.tenant)
        self.tree_dir = os.path.join(self.rep_dir, TREE_DIR)
        self.sink_rep_dir = os.path.join(self.rep_dir, SINK_DIR)
        self.manifest_path = os.path.join(self.rep_dir, MANIFEST_NAME)
        self._barriers = RotatingJsonlWriter(
            os.path.join(self.rep_dir, BARRIER_LOG),
            artifact="repl_barrier", tenant=self.tenant,
            site="repl.barrier",
        )
        self._lock = threading.RLock()
        self._labels = _labels(self.tenant)
        # stamp cache: rel -> {"size", "sha256", "stamp"} per section
        self._entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._seq = 0
        self._pending: List[Tuple[int, int, int]] = []  # (bid, end, rows)
        self.ships = 0
        self.ship_errors = 0
        self.barriers_sealed = 0
        self._load_replica_state()

    # -- resume ------------------------------------------------------------

    def _load_replica_state(self) -> None:
        """Adopt the on-disk replica: manifest entries become the skip
        cache (files re-hash, not re-ship, on the first sync) and the
        last sealed barrier anchors the cumulative counters — a plane
        restart never forgets what the standby already holds."""
        try:
            man = load_sealed_json(self.manifest_path)
        except (OSError, StorageCorruptError):
            man = None
        if man:
            self._seq = int(man.get("seq", 0)) + 1
            for section, key, base in (
                ("files", "tree", self.tree_dir),
                ("sink", "sink", self.sink_rep_dir),
            ):
                for rel, (size, sha) in man.get(section, {}).items():
                    # a manifested file missing from the replica (e.g.
                    # quarantined by anti-entropy fsck) must NOT enter
                    # the skip cache — the next pass re-seeds it
                    if not os.path.exists(os.path.join(base, rel)):
                        continue
                    self._entries[(key, rel)] = {
                        "size": int(size), "sha256": sha, "stamp": None,
                    }
        bar = last_barrier(self.standby_root, self.tenant)
        self._rows_through = int(bar["rows_through"]) if bar else 0
        self._rows_exact = bool(bar.get("rows_exact", True)) if bar else True
        self._rows_anchor_batch = int(bar["batch_id"]) if bar else -1
        self._last_barrier = bar
        self._last_barrier_wall = float(bar["wall"]) if bar else 0.0

    # -- the commit listener ----------------------------------------------

    def on_commit(self, batch_id: int, intent: Dict[str, Any],
                  n_rows: int = 0) -> bool:
        """Record one durable engine commit; ship + seal a barrier
        every ``barrier_every`` commits.  Returns True when a barrier
        sealed.  Never raises: a replication failure is counted,
        journaled, and retried at the next commit."""
        with self._lock:
            self._pending.append(
                (int(batch_id), int(intent.get("end", 0)), int(n_rows))
            )
            self._set_lag_gauges()
            if len(self._pending) < self.barrier_every:
                return False
            try:
                self.sync()
                return self._seal_barrier()
            except Exception as e:
                self.ship_errors += 1
                inc("sntc_repl_ships_total", 1, outcome="error",
                    **self._labels)
                emit_event(
                    event="replication_error", tenant=self.tenant,
                    batch_id=int(batch_id), error=repr(e),
                )
                set_gauge("sntc_repl_lag_bytes",
                          self._lag_bytes_estimate(), **self._labels)
                return False

    def _set_lag_gauges(self) -> None:
        set_gauge("sntc_repl_lag_batches", len(self._pending),
                  **self._labels)
        lag_s = (
            max(0.0, time.time() - self._last_barrier_wall)
            if self._last_barrier_wall else 0.0
        )
        set_gauge("sntc_repl_lag_seconds", lag_s, **self._labels)

    def _lag_bytes_estimate(self) -> int:
        """Stat-only estimate of un-replicated primary bytes (what a
        primary loss right now would cost)."""
        total = 0
        for rel in artifact_files(self.primary_root):
            try:
                size = os.path.getsize(
                    os.path.join(self.primary_root, rel)
                )
            except OSError:
                continue
            prev = self._entries.get(("tree", rel))
            total += size if prev is None else max(0, size - prev["size"])
        return total

    # -- shipping ----------------------------------------------------------

    def _discover(self) -> List[Tuple[str, str, str]]:
        """[(section, rel, abspath)] for everything that replicates."""
        out = [
            ("tree", rel, os.path.join(self.primary_root, rel))
            for rel in sorted(artifact_files(self.primary_root))
        ]
        if self.sink_dir:
            for pat in self.sink_patterns:
                for p in sorted(glob.glob(os.path.join(self.sink_dir, pat))):
                    if os.path.isfile(p):
                        out.append(
                            ("sink", os.path.relpath(p, self.sink_dir), p)
                        )
        return out

    def _ship_one(self, section: str, rel: str, src: str) -> Optional[
            Tuple[Dict[str, Any], int]]:
        """Ship one file if its content changed; returns (entry,
        shipped_bytes) or None when the file vanished mid-walk (racing
        retention — the next manifest simply drops it)."""
        try:
            st = os.stat(src)
        except OSError:
            return None
        stamp = f"{st.st_size}:{st.st_mtime_ns}"
        prev = self._entries.get((section, rel))
        if prev is not None and prev["stamp"] == stamp:
            return prev, 0
        try:
            with open(src, "rb") as f:
                data = f.read()
        except OSError:
            return None
        sha = _sha256(data)
        if prev is not None and prev["sha256"] == sha:
            return dict(prev, stamp=stamp), 0
        dest_base = self.tree_dir if section == "tree" else self.sink_rep_dir
        fault_point("repl.ship", tenant=self.tenant)
        atomic_write_bytes(
            os.path.join(dest_base, rel), data,
            site="repl.ship", tenant=self.tenant,
        )
        return (
            {"size": len(data), "sha256": sha, "stamp": stamp},
            len(data),
        )

    def sync(self) -> Dict[str, int]:
        """One ship pass: copy every new/changed artifact file to the
        replica tree, mirror retention deletions, then atomically
        publish the sealed manifest (``repl.apply``).  Raises on
        failure — the caller owns the degrade policy."""
        with self._lock:
            shipped_files = shipped_bytes = 0
            new_entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
            for section, rel, src in self._discover():
                res = self._ship_one(section, rel, src)
                if res is None:
                    continue
                entry, nbytes = res
                new_entries[(section, rel)] = entry
                if nbytes:
                    shipped_files += 1
                    shipped_bytes += nbytes
            # mirror primary retention: a file the primary pruned or
            # compacted away leaves the replica too (the manifest is
            # the single source of replica truth)
            for section, rel in set(self._entries) - set(new_entries):
                base = (
                    self.tree_dir if section == "tree"
                    else self.sink_rep_dir
                )
                try:
                    os.unlink(os.path.join(base, rel))
                except OSError:
                    pass
            fault_point("repl.apply", tenant=self.tenant)
            core = {
                "tenant": self.tenant,
                "seq": self._seq,
                "wall": time.time(),
                "primary_root": os.path.abspath(self.primary_root),
                "files": {
                    rel: [e["size"], e["sha256"]]
                    for (sec, rel), e in sorted(new_entries.items())
                    if sec == "tree"
                },
                "sink": {
                    rel: [e["size"], e["sha256"]]
                    for (sec, rel), e in sorted(new_entries.items())
                    if sec == "sink"
                },
            }
            atomic_write_json(
                self.manifest_path, seal_record(core),
                site="repl.apply", tenant=self.tenant,
            )
            self._entries = new_entries
            self._seq += 1
            self.ships += 1
            inc("sntc_repl_ships_total", 1, outcome="completed",
                **self._labels)
            if shipped_files:
                inc("sntc_repl_ship_files_total", shipped_files,
                    **self._labels)
                inc("sntc_repl_ship_bytes_total", shipped_bytes,
                    **self._labels)
            return {"files": shipped_files, "bytes": shipped_bytes}

    # -- barriers ----------------------------------------------------------

    def _sink_rows(self, ids: List[int]) -> Optional[int]:
        """Data rows of the given sink batch files (for reconciling a
        barrier gap after a crash-between-commit-and-barrier); None
        when any file is unreadable (rows go inexact, never wrong)."""
        if not self.sink_dir:
            return None
        total = 0
        for bid in ids:
            path = os.path.join(self.sink_dir, f"batch_{bid:06d}.csv")
            try:
                with open(path) as f:
                    total += max(0, sum(1 for _ in f) - 1)
            except OSError:
                return None
        return total

    def _seal_barrier(self) -> bool:
        bid, end, _ = self._pending[-1]
        rows = sum(r for _b, _e, r in self._pending)
        seen = {b for b, _e, _r in self._pending}
        missing = [
            i for i in range(self._rows_anchor_batch + 1, bid + 1)
            if i not in seen
        ]
        rows_exact = self._rows_exact
        if missing:
            # commits landed while the plane was down (a crash between
            # commit and barrier): batches stay exact by sequential id;
            # rows reconcile from the replicated sink when possible
            got = self._sink_rows(missing)
            if got is None:
                rows_exact = False
            else:
                rows += got
        core = {
            "tenant": self.tenant,
            "seq": self._seq,
            "batch_id": bid,
            "end": end,
            "batches_through": bid + 1,
            "rows_through": self._rows_through + rows,
            "rows_exact": rows_exact,
            "wall": time.time(),
        }
        fault_point("repl.barrier", tenant=self.tenant)
        if not self._barriers.write(seal_record(core)):
            return False
        self._rows_through = core["rows_through"]
        self._rows_exact = rows_exact
        self._rows_anchor_batch = bid
        self._last_barrier = core
        self._last_barrier_wall = core["wall"]
        self._pending = []
        self.barriers_sealed += 1
        inc("sntc_repl_barriers_sealed_total", 1, **self._labels)
        set_gauge("sntc_repl_lag_batches", 0, **self._labels)
        set_gauge("sntc_repl_lag_seconds", 0.0, **self._labels)
        set_gauge("sntc_repl_lag_bytes", 0, **self._labels)
        return True

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Final ship + barrier for any pending commits (a drain with
        ``barrier_every > 1`` must not strand a replicated-but-unacked
        tail).  Degrades on failure like any other pass."""
        with self._lock:
            if not self._pending:
                return
            try:
                self.sync()
                self._seal_barrier()
            except Exception as e:
                self.ship_errors += 1
                emit_event(
                    event="replication_error", tenant=self.tenant,
                    error=repr(e), phase="close",
                )

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tenant": self.tenant,
                "ships": self.ships,
                "ship_errors": self.ship_errors,
                "barriers_sealed": self.barriers_sealed,
                "pending_batches": len(self._pending),
                "last_barrier": self._last_barrier,
            }


# ---------------------------------------------------------------------------
# promotion
# ---------------------------------------------------------------------------


def _truncate_wal_to_barrier(ckpt: str, bid: int, end: int) -> int:
    """Drop every WAL record beyond barrier batch ``bid`` from a
    PROMOTED checkpoint root (both modes).  Post-barrier intents are
    dropped too — the crash-before-intent shape; the promoted engine
    replans them deterministically from the barrier offset."""
    dropped = 0
    cdir = os.path.join(ckpt, "commits")
    odir = os.path.join(ckpt, "offsets")
    if os.path.isdir(cdir) or os.path.isdir(odir):
        for d in (cdir, odir):
            for p in glob.glob(os.path.join(d, "*.json")):
                try:
                    rec_id = int(os.path.splitext(os.path.basename(p))[0])
                except ValueError:
                    continue
                if rec_id > bid:
                    try:
                        os.unlink(p)
                        dropped += 1
                    except OSError:
                        pass
        return dropped
    ck = os.path.join(ckpt, "wal_checkpoint.json")
    if os.path.exists(ck):
        try:
            core = load_sealed_json(ck)
        except (OSError, StorageCorruptError):
            core = None
        if core and int(core["last_committed"]) > bid:
            atomic_write_json(
                ck,
                seal_record({
                    "version": core.get("version", 1),
                    "last_committed": bid,
                    "end": end,
                    "pending": {},
                }),
                site="repl.apply",
            )
            dropped += 1
    for name in ("commits.log", "offsets.log"):
        path = os.path.join(ckpt, name)
        if not os.path.exists(path):
            continue
        try:
            recs, _ = read_jsonl_tolerant(path, repair=False)
        except _storage.JsonlCorruptError:
            recs = []
        keep = [r for r in recs if int(r.get("batch_id", -1)) <= bid]
        if len(keep) != len(recs):
            dropped += len(recs) - len(keep)
            atomic_write_bytes(
                path,
                "".join(json.dumps(r) + "\n" for r in keep).encode(),
                site="repl.apply",
            )
    return dropped


def _sink_idx(rel: str) -> Optional[int]:
    m = _SINK_IDX_RE.search(os.path.basename(rel))
    return int(m.group(1)) if m else None


def promote_standby(
    standby_root: str,
    tenant: str,
    dest_root: str,
    *,
    dest_sink: Optional[str] = None,
    primary_root: Optional[str] = None,
    primary_sink: Optional[str] = None,
    repair: bool = True,
) -> Dict[str, Any]:
    """Promote ``<standby_root>/<tenant>`` into ``dest_root``: fsck
    the replica, verify every manifest entry, quarantine torn-ship
    strays, copy the verified tree, truncate to the last sealed
    barrier, and measure RPO/RTO + the loss-accounting law (exact when
    the dead primary's tree is still readable).  ``ok=False`` NEVER
    leaves a promoted tree behind."""
    t0 = time.monotonic()
    rep = replica_dir(standby_root, tenant)
    tree = os.path.join(rep, TREE_DIR)
    labels = _labels(tenant)
    report: Dict[str, Any] = {
        "ok": False, "tenant": tenant, "dest_root": dest_root,
        "divergences": [], "quarantined": [], "reason": None,
    }

    def _fail(reason: str) -> Dict[str, Any]:
        report["reason"] = reason
        report["rto_seconds"] = time.monotonic() - t0
        inc("sntc_repl_promotions_total", 1, outcome="failed")
        emit_event(
            event="replica_diverged", tenant=tenant, reason=reason,
            divergences=report["divergences"][:8],
        )
        if report["divergences"]:
            inc("sntc_repl_divergence_total",
                len(report["divergences"]), **labels)
        return report

    try:
        man = load_sealed_json(os.path.join(rep, MANIFEST_NAME))
    except (OSError, StorageCorruptError) as e:
        report["divergences"].append(
            {"kind": "manifest", "detail": repr(e)}
        )
        return _fail("replica manifest missing or seal broken")
    bar = last_barrier(standby_root, tenant)
    report["barrier"] = bar
    if bar is None:
        return _fail("no sealed barrier — nothing provably consistent")

    # doctor the replica (torn journal tails etc.) before verifying
    for root in {tree, _ckpt_root(tree)}:
        if os.path.isdir(root):
            fs = _storage.fsck_root(root, repair=repair, tenant=tenant)
            if not fs["ok"]:
                report["divergences"].extend(
                    {"kind": "fsck", "detail": err}
                    for err in fs["errors"][:8]
                )
    if any(d["kind"] == "fsck" for d in report["divergences"]):
        return _fail("replica tree fails fsck")

    # verify the manifest: immutable artifacts re-hash to their sealed
    # sha256; a mismatch or a missing file is a torn/diverged replica
    # and the promotion refuses
    for section, base in (("files", tree), ("sink", os.path.join(rep, SINK_DIR))):
        for rel, (size, sha) in man.get(section, {}).items():
            p = os.path.join(base, rel)
            if not os.path.exists(p):
                report["divergences"].append(
                    {"kind": "missing", "rel": rel}
                )
                continue
            if _is_mutable(rel) and section == "files":
                continue
            try:
                with open(p, "rb") as f:
                    got = _sha256(f.read())
            except OSError as e:
                report["divergences"].append(
                    {"kind": "unreadable", "rel": rel, "detail": repr(e)}
                )
                continue
            if got != sha:
                dest_q = _storage.quarantine_blob(
                    p, artifact="repl_manifest",
                    detail="replica sha256 diverges from sealed manifest",
                    root=rep, tenant=tenant,
                )
                report["quarantined"].append(
                    {"rel": rel, "to": dest_q}
                )
                report["divergences"].append(
                    {"kind": "hash", "rel": rel}
                )
    if report["divergences"]:
        return _fail("replica diverges from its sealed manifest")

    # sweep torn-ship strays: an immutable file present in the tree
    # but absent from the sealed manifest was mid-ship when the
    # primary (or the plane) died — quarantine it, never promote it
    manifested = set(man.get("files", {}))
    for rel in sorted(artifact_files(tree)):
        if rel in manifested or _is_mutable(rel):
            continue
        dest_q = _storage.quarantine_blob(
            os.path.join(tree, rel), artifact="repl_manifest",
            detail="un-manifested replica file (torn ship)",
            root=rep, tenant=tenant,
        )
        report["quarantined"].append({"rel": rel, "to": dest_q})

    # copy the verified tree, then truncate to the barrier
    bid, end = int(bar["batch_id"]), int(bar["end"])
    promoted_files = promoted_bytes = 0
    for rel in sorted(man.get("files", {})):
        src = os.path.join(tree, rel)
        try:
            with open(src, "rb") as f:
                data = f.read()
        except OSError:
            continue  # quarantined above
        atomic_write_bytes(
            os.path.join(dest_root, rel), data,
            site="repl.apply", tenant=tenant,
        )
        promoted_files += 1
        promoted_bytes += len(data)
    truncated_sink = 0
    if dest_sink is not None:
        for rel in sorted(man.get("sink", {})):
            idx = _sink_idx(rel)
            if idx is not None and idx > bid:
                truncated_sink += 1
                continue
            try:
                with open(os.path.join(rep, SINK_DIR, rel), "rb") as f:
                    data = f.read()
            except OSError:
                continue
            atomic_write_bytes(
                os.path.join(dest_sink, rel), data,
                site="repl.apply", tenant=tenant,
            )
            promoted_files += 1
            promoted_bytes += len(data)
    truncated_wal = _truncate_wal_to_barrier(
        _ckpt_root(dest_root), bid, end
    )
    report.update(
        promoted_files=promoted_files,
        promoted_bytes=promoted_bytes,
        truncated={"wal_records": truncated_wal,
                   "sink_files": truncated_sink},
        batches_through=int(bar["batches_through"]),
        rows_through=int(bar["rows_through"]),
        rows_exact=bool(bar.get("rows_exact", True)),
    )

    # the loss-accounting law + RPO, exact when the primary's corpse
    # is still readable (committed == through_barrier + tail_loss)
    report["rpo_seconds"] = max(0.0, time.time() - float(bar["wall"]))
    if primary_root is not None and os.path.isdir(primary_root):
        census = committed_batches(_ckpt_root(primary_root))
        tail = census["count"] - int(bar["batches_through"])
        report["committed_primary"] = census["count"]
        report["tail_loss_batches"] = tail
        report["law_exact"] = (
            tail >= 0
            and census["count"]
            == int(bar["batches_through"]) + tail
        )
        rpo_bytes = 0
        for rel in artifact_files(primary_root):
            try:
                size = os.path.getsize(os.path.join(primary_root, rel))
            except OSError:
                continue
            prev = man.get("files", {}).get(rel)
            rpo_bytes += size if prev is None else max(0, size - prev[0])
        report["rpo_bytes"] = rpo_bytes
        if primary_sink is not None and tail > 0:
            tail_rows = 0
            for p in glob.glob(os.path.join(primary_sink, "batch_*.csv")):
                idx = _sink_idx(p)
                if idx is not None and idx > bid:
                    try:
                        with open(p) as f:
                            tail_rows += max(0, sum(1 for _ in f) - 1)
                    except OSError:
                        pass
            report["tail_loss_rows"] = tail_rows
            inc("sntc_repl_tail_loss_rows_total", tail_rows, **labels)
        if not report["law_exact"]:
            return _fail(
                "loss-accounting law violated: replica claims more "
                "than the primary ever committed"
            )
    report["ok"] = True
    report["rto_seconds"] = time.monotonic() - t0
    inc("sntc_repl_promotions_total", 1, outcome="completed")
    emit_event(
        event="standby_promoted", tenant=tenant, dest_root=dest_root,
        batches_through=report["batches_through"],
        rpo_seconds=report["rpo_seconds"],
        rto_seconds=report["rto_seconds"],
    )
    return report


# ---------------------------------------------------------------------------
# anti-entropy: sntc fsck --standby
# ---------------------------------------------------------------------------


def _resolve_primary(primary_root: str, tenant: str) -> Optional[str]:
    """Where tenant ``tenant``'s live tree sits under a primary root:
    a daemon root (``tenant/<tid>``), a fleet root
    (``worker/*/tenant/<tid>``), or the root itself (bare engine)."""
    cands = [os.path.join(primary_root, "tenant", tenant)]
    cands.extend(
        sorted(glob.glob(
            os.path.join(primary_root, "worker", "*", "tenant", tenant)
        ))
    )
    if tenant == DEFAULT_TENANT:
        cands.append(primary_root)
    for c in cands:
        if os.path.isdir(c):
            return c
    return None


def fsck_standby(
    standby_root: str,
    *,
    primary_root: Optional[str] = None,
    tenant: Optional[str] = None,
    repair: bool = False,
) -> Dict[str, Any]:
    """Cross-verify every tenant replica under ``standby_root``:
    manifest seal, replica content vs manifest (immutables re-hashed),
    barrier-log sanity, and — when the primary is reachable —
    primary-vs-replica content for files both sides hold.  Every
    mismatch is a journaled ``replica_diverged`` + counted
    ``sntc_repl_divergence_total``; ``repair=True`` quarantines the
    diverged replica copy so the next ship re-seeds it."""
    tenants = (
        [tenant] if tenant else sorted(
            os.path.basename(d) for d in glob.glob(
                os.path.join(standby_root, "*")
            )
            if os.path.isfile(os.path.join(d, MANIFEST_NAME))
        )
    )
    report: Dict[str, Any] = {
        "standby_root": standby_root, "ok": True, "tenants": {},
    }
    for tid in tenants:
        rep = replica_dir(standby_root, tid)
        tree = os.path.join(rep, TREE_DIR)
        tr: Dict[str, Any] = {
            "files": 0, "divergences": [], "barrier": None,
        }
        report["tenants"][tid] = tr
        try:
            man = load_sealed_json(os.path.join(rep, MANIFEST_NAME))
        except (OSError, StorageCorruptError) as e:
            tr["divergences"].append(
                {"kind": "manifest", "detail": repr(e)}
            )
            man = None
        bar = last_barrier(standby_root, tid)
        tr["barrier"] = (
            {"batch_id": bar["batch_id"], "end": bar["end"]}
            if bar else None
        )
        prim = (
            _resolve_primary(primary_root, tid)
            if primary_root else None
        )
        for rel, (size, sha) in (man or {}).get("files", {}).items():
            tr["files"] += 1
            p = os.path.join(tree, rel)
            mutable = _is_mutable(rel)
            try:
                with open(p, "rb") as f:
                    rep_sha = _sha256(f.read())
            except OSError:
                tr["divergences"].append({"kind": "missing", "rel": rel})
                continue
            if not mutable and rep_sha != sha:
                tr["divergences"].append({"kind": "hash", "rel": rel})
                if repair:
                    _storage.quarantine_blob(
                        p, artifact="repl_manifest",
                        detail="anti-entropy: replica diverges from "
                        "sealed manifest", root=rep, tenant=tid,
                    )
                continue
            if prim is not None and not mutable:
                pp = os.path.join(prim, rel)
                if os.path.exists(pp):
                    try:
                        with open(pp, "rb") as f:
                            if _sha256(f.read()) != rep_sha:
                                tr["divergences"].append(
                                    {"kind": "primary_mismatch",
                                     "rel": rel}
                                )
                    except OSError:
                        pass
        if tr["divergences"]:
            report["ok"] = False
            inc("sntc_repl_divergence_total",
                len(tr["divergences"]), **_labels(tid))
            emit_event(
                event="replica_diverged", tenant=tid,
                standby_root=standby_root,
                divergences=tr["divergences"][:8],
            )
    return report
