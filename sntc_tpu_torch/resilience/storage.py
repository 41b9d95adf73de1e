"""The durable-storage plane: bounded artifacts, disk-fault-proof writes
and the ``fsck`` doctor.

Counterpart of ``sntc_tpu/resilience/storage.py``: a serve checkpoint
root's artifacts, plus those of the fleet root (``serve/fleet.py``) and
of the standby root (``resilience/replicate.py``):

* **Artifact registry**: :data:`ARTIFACTS` declares every durable
  artifact class the port writes under a checkpoint root, with the
  ``storage.*`` fault site guarding its writes, its retention bound and
  its failure policy.
  ``tests/test_torch_storage.py`` pins it against the port's write
  sites (``# storage: <artifact>`` annotations).
* **Physical writes**: :func:`append_line` (rolled back on failure),
  :func:`atomic_write_bytes` / :func:`atomic_write_json` (tmp then
  rename) and :func:`write_marker` call
  :func:`~sntc_tpu_torch.resilience.faults.fault_disk` (``enospc``,
  ``io_error``, ``torn_write``) and follow the artifact's policy: the
  WAL FAILs (the engine's retries and quarantine own the consequence),
  journals and markers DEGRADE (records buffer behind a counted
  ``storage_degraded`` episode and flush when the disk recovers),
  dead-letter dirs SHED (the oldest evidence goes, counted).
* **Bounded journals**: :class:`RotatingJsonlWriter` rotates a JSONL
  journal at a size cap, so its footprint is ``(keep + 1) × max_bytes``.
* **Disk accounting**: :class:`StoragePlane` measures every registered
  artifact under a root into the ``sntc_disk_*`` gauges, checks a byte
  budget and feeds the supervisor's ``storage`` status block.
* **The doctor**: :func:`fsck` verifies every artifact of a root (or a
  serve-daemon tenant tree), repairs what is safe (a torn JSONL tail is
  truncated, with a journaled repair record), quarantines corrupt blobs
  to ``.corrupt/`` and returns a machine-readable report;
  :func:`quick_scan` is the light subset every engine runs at
  construction.

The report, the repair journal and the quarantine layout are the JAX
package's, so either package's ``fsck`` doctors the other's trees as far
as the artifacts both write (the shed, controller and promotion journals
and ``model_marker.json`` among them); a flow-state snapshot's seal is
still checked, since that reads the blob and nothing of the flow plane.
"""

from __future__ import annotations

import errno
import fnmatch
import glob
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from sntc_tpu_torch.obs.metrics import inc, set_gauge
from sntc_tpu_torch.resilience.faults import InjectedDiskFault, fault_disk
from sntc_tpu_torch.resilience.policy import emit_event

REPAIR_JOURNAL = "storage_repair.jsonl"


class StorageCorruptError(RuntimeError):
    """A sealed storage record fails its integrity check (bad seal,
    torn payload); names the file."""


# ---------------------------------------------------------------------------
# artifact registry
# ---------------------------------------------------------------------------

#: failure policies: ``fail`` propagates the write error to the caller
#: (the WAL cannot degrade: losing it loses exactly-once); ``degrade``
#: buffers the record behind a counted ``storage_degraded`` episode;
#: ``shed`` drops the write or the oldest evidence, counted.
FAIL, DEGRADE, SHED = "fail", "degrade", "shed"


@dataclass(frozen=True)
class ArtifactSpec:
    """One durable artifact class: where it lives under a checkpoint
    root, which fault site guards its writes, how it is bounded and what
    a failed write does."""

    name: str
    kind: str  # wal | journal | dead_letter | snapshot | marker | checkpoint
    site: str  # the fault_disk site guarding its physical writes
    patterns: Tuple[str, ...]  # globs relative to a checkpoint root
    retention: str
    failure_policy: str  # FAIL | DEGRADE | SHED


ARTIFACTS: Dict[str, ArtifactSpec] = {
    spec.name: spec
    for spec in (
        ArtifactSpec(
            "wal_append", "wal", "storage.wal",
            ("offsets.log", "commits.log", "wal_checkpoint.json"),
            "compacted every wal_compact_every commits: sealed "
            "checkpoint + truncated logs (replay = checkpoint + tail)",
            FAIL,
        ),
        ArtifactSpec(
            "wal_files", "wal", "storage.wal",
            ("offsets/*.json", "commits/*.json"),
            "committed intent/commit pairs pruned beyond "
            "wal_keep_commits (uncommitted intents never pruned)",
            FAIL,
        ),
        ArtifactSpec(
            "repair_journal", "journal", "storage.journal",
            (REPAIR_JOURNAL + "*",),
            "RotatingJsonlWriter: size-capped segments, keep 2 rotated",
            DEGRADE,
        ),
        ArtifactSpec(
            "shed_journal", "journal", "storage.journal",
            ("shed.jsonl*",),
            "RotatingJsonlWriter: size-capped segments, keep 2 rotated",
            DEGRADE,
        ),
        ArtifactSpec(
            "controller_journal", "journal", "storage.journal",
            ("controller.jsonl*",),
            "RotatingJsonlWriter: size-capped segments, keep 2 rotated",
            DEGRADE,
        ),
        ArtifactSpec(
            "promotion_journal", "journal", "storage.journal",
            ("promotion.jsonl*",),
            "RotatingJsonlWriter: size-capped segments, keep 2 rotated",
            DEGRADE,
        ),
        ArtifactSpec(
            "dead_letter", "dead_letter", "storage.dead_letter",
            ("dead_letter/*",),
            "keep-N newest batch dumps (dead_letter_keep), oldest "
            "dropped with a counted dead_letter_dropped",
            SHED,
        ),
        ArtifactSpec(
            "dead_letter_rows", "dead_letter", "storage.dead_letter",
            ("dead_letter_rows/*",),
            "keep-N newest batch journals (dead_letter_keep), oldest "
            "dropped with a counted dead_letter_dropped",
            SHED,
        ),
        ArtifactSpec(
            "flow_state", "snapshot", "storage.state",
            ("flow_state/state-*.bin",),
            "FlowStateStore keep-2 bracketing snapshots",
            FAIL,
        ),
        ArtifactSpec(
            "markers", "marker", "storage.marker",
            ("drain_marker.json", "model_marker.json",
             "daemon_drain_marker.json", "health.json"),
            "atomic overwrite in place (bounded by construction)",
            DEGRADE,
        ),
        ArtifactSpec(
            "telemetry", "marker", "storage.marker",
            (),  # --metrics-out/--trace-out paths live outside the root
            "atomic snapshot overwrite / bounded span ring (bounded "
            "by construction)",
            DEGRADE,
        ),
        ArtifactSpec(
            "checkpoint", "checkpoint", "storage.marker",
            ("model/*", "model.prev/*"),
            "atomic publish, exactly one .prev retained",
            FAIL,
        ),
        # the socket front door (serve/ingress.py): patterns are
        # relative to the listener's spool (the --watch dir)
        ArtifactSpec(
            "ingress_spool", "wal", "ingress.spool",
            ("capture_*.nf5", "rows_*.csv", "ingress_stats.json",
             "quarantine/*"),
            "keep-N newest COMMITTED capture files (committed_end "
            "horizon; uncommitted never pruned); over-budget payloads "
            "shed at ingress (counted)",
            SHED,
        ),
        # the elastic serve fleet (serve/fleet.py): patterns are
        # relative to a coordinator's fleet root, not a daemon root
        ArtifactSpec(
            "fleet_lease", "marker", "storage.marker",
            ("fleet/workers/*/lease.json",),
            "atomic overwrite per heartbeat (one lease per worker)",
            DEGRADE,
        ),
        ArtifactSpec(
            "fleet_assignments", "marker", "storage.marker",
            ("fleet/assignments.json",),
            "atomic epoch overwrite in place (one marker per fleet)",
            FAIL,
        ),
        ArtifactSpec(
            "fleet_assignment_journal", "journal", "storage.journal",
            ("fleet/assignments.jsonl*",),
            "RotatingJsonlWriter: size-capped segments, keep 2 rotated",
            DEGRADE,
        ),
        ArtifactSpec(
            "fleet_migration_manifest", "marker", "storage.marker",
            ("fleet/migrations/*.json",),
            "sealed, one per tenant, overwritten by the next migration",
            FAIL,
        ),
        ArtifactSpec(
            "fleet_markers", "marker", "storage.marker",
            ("fleet/coordinator.json", "fleet/fleet_drain_marker.json",
             "fleet/workers/*/release/*.json"),
            "atomic overwrite in place; release markers removed once "
            "the coordinator consumes them",
            DEGRADE,
        ),
        ArtifactSpec(
            "fleet_request_journal", "journal", "storage.journal",
            ("fleet/workers/*/requests.jsonl*",),
            "append-only, offset-consumed by the coordinator, bounded "
            "by the one-shot fleet knobs (at most 2 lines a tenant)",
            DEGRADE,
        ),
        # warm-standby replication (resilience/replicate.py): these live
        # under the standby root (<standby>/<tenant>/), never under a
        # replicated primary root, so their patterns are empty; fsck
        # --standby and promote_standby verify them
        ArtifactSpec(
            "repl_barrier", "journal", "repl.barrier",
            (),  # <standby>/<tenant>/barriers.jsonl*
            "RotatingJsonlWriter: size-capped segments, keep 2 rotated; "
            "promotion walks newest-first to the last sealed record",
            DEGRADE,
        ),
        ArtifactSpec(
            "repl_manifest", "marker", "repl.apply",
            (),  # <standby>/<tenant>/replica_manifest.json
            "sealed atomic overwrite per ship pass (one per replica); "
            "a failed publish degrades and the next commit re-ships",
            DEGRADE,
        ),
    )
}

# ---------------------------------------------------------------------------
# degradation bookkeeping (one episode flag per artifact)
# ---------------------------------------------------------------------------

_deg_lock = threading.Lock()
_degraded: set = set()  # {(artifact, tenant)} currently degraded


def _labels(artifact: str, tenant: Optional[str]) -> Dict[str, str]:
    out = {"artifact": artifact}
    if tenant is not None:
        out["tenant"] = tenant
    return out


def _component(artifact: str, tenant: Optional[str]) -> str:
    base = f"storage.{artifact}"
    return base if tenant is None else f"tenant/{tenant}/{base}"


def _emit(tenant: Optional[str], **fields: Any) -> None:
    if tenant is not None:
        fields["tenant"] = tenant
    emit_event(**fields)


def note_write_error(
    artifact: str, path: str, exc: BaseException,
    tenant: Optional[str] = None, **detail: Any,
) -> None:
    """Count one failed durable write and open a ``storage_degraded``
    episode for the artifact: the event (naming the path and the error)
    once per episode, the counter every time."""
    inc("sntc_storage_write_errors_total", **_labels(artifact, tenant))
    key = (artifact, tenant)
    with _deg_lock:
        fresh = key not in _degraded
        _degraded.add(key)
    set_gauge("sntc_storage_degraded_state", 1, **_labels(artifact, tenant))
    if fresh:
        _emit(tenant, event="storage_degraded",
              component=_component(artifact, tenant), artifact=artifact,
              path=path, error=repr(exc), **detail)


def note_write_ok(artifact: str, tenant: Optional[str] = None) -> None:
    """Close the artifact's degradation episode, if one is open: the
    gauge back to 0 and one ``storage_recovered`` event."""
    key = (artifact, tenant)
    with _deg_lock:
        was = key in _degraded
        _degraded.discard(key)
    if was:
        set_gauge("sntc_storage_degraded_state", 0,
                  **_labels(artifact, tenant))
        _emit(tenant, event="storage_recovered",
              component=_component(artifact, tenant), artifact=artifact)


def degraded_artifacts() -> List[Tuple[str, Optional[str]]]:
    """The currently degraded (artifact, tenant) pairs."""
    with _deg_lock:
        return sorted(_degraded, key=lambda k: (k[0], k[1] or ""))


def reset_degradation() -> None:
    """Drop every open degradation episode and cached repair writer
    (test isolation)."""
    with _deg_lock:
        _degraded.clear()
    with _repair_writers_lock:
        _repair_writers.clear()


def _torn_error(site: str, path: str, cut: int, total: int) -> OSError:
    return InjectedDiskFault(
        errno.EIO,
        f"injected torn_write at site {site!r}: {cut}/{total} bytes of "
        f"{path} reached disk",
    )


def _oserror_with_path(exc: OSError, path: str, offset: int) -> OSError:
    """A real write failure with its errno, naming the file and offset."""
    return OSError(
        exc.errno or errno.EIO,
        f"durable write to {path} failed at offset {offset}: "
        f"{exc.strerror or exc}",
        path,
    )


# ---------------------------------------------------------------------------
# physical write helpers (every durable byte flows through one of these)
# ---------------------------------------------------------------------------


def append_line(
    f, text: str, *, site: str, tenant: Optional[str] = None,
) -> None:
    """One flushed append of ``text`` to the open file ``f`` under IO
    fault injection.  A failed append (an injected torn write, or a real
    flush that persisted a prefix) is rolled back to the pre-write
    offset before the error propagates, so the caller may keep
    appending: only a process death leaves a torn tail, which the
    tolerant readers repair.  A closed handle raises an OSError."""
    if getattr(f, "closed", False):
        raise OSError(
            errno.EIO,
            f"WAL/journal handle for {getattr(f, 'name', '?')} is "
            "closed (a failed compaction reopen); caller must reopen",
            getattr(f, "name", None),
        )
    pos = None

    def _rollback():
        if pos is None:
            return
        try:
            f.truncate(pos)
            f.seek(pos)
        except OSError:
            pass

    try:
        pos = f.tell()
        frac = fault_disk(site, tenant=tenant)
        if frac is not None:  # torn_write armed and fired
            cut = max(1, int(len(text) * frac))
            f.write(text[:cut])
            f.flush()
            _rollback()
            raise _torn_error(site, getattr(f, "name", "?"), cut, len(text))
        f.write(text)
        f.flush()
    except InjectedDiskFault:
        raise
    except OSError as e:
        _rollback()
        raise _oserror_with_path(
            e, getattr(f, "name", "?"), pos if pos is not None else -1
        ) from e


def atomic_write_bytes(
    path: str, data: bytes, *, site: str, tenant: Optional[str] = None,
    fsync: bool = True,
) -> None:
    """Tmp-then-rename publish of ``data`` at ``path`` under IO fault
    injection: readers never see a torn file, and a failure leaves at
    most a ``.tmp-<pid>`` orphan for :func:`fsck` / :func:`quick_scan`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        frac = fault_disk(site, tenant=tenant)
        with open(tmp, "wb") as f:
            if frac is not None:
                cut = max(1, int(len(data) * frac))
                f.write(data[:cut])
                f.flush()
                raise _torn_error(site, tmp, cut, len(data))
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
    except InjectedDiskFault:
        raise
    except OSError as e:
        raise _oserror_with_path(e, path, -1) from e


def atomic_write_json(
    path: str, obj: Any, *, site: str, tenant: Optional[str] = None,
    fsync: bool = True, indent: Optional[int] = None,
) -> None:
    atomic_write_bytes(
        path, json.dumps(obj, indent=indent).encode(),
        site=site, tenant=tenant, fsync=fsync,
    )


def write_marker(
    path: str, obj: Any, *, tenant: Optional[str] = None,
    indent: Optional[int] = None, fsync: bool = True,
) -> bool:
    """A marker or status write under the DEGRADE policy: on disk
    failure it counts a ``storage_degraded`` episode and returns False
    instead of raising (a status dump never kills the loop it reports
    on)."""
    try:
        atomic_write_json(path, obj, site="storage.marker", tenant=tenant,
                          fsync=fsync, indent=indent)
    except OSError as e:
        note_write_error("markers", path, e, tenant=tenant)
        return False
    note_write_ok("markers", tenant=tenant)
    return True


# -- sealed records (the WAL-compaction checkpoint format) ----------------


def _digest(core: Dict[str, Any]) -> str:
    return hashlib.sha256(json.dumps(core, sort_keys=True).encode()) \
        .hexdigest()


def seal_record(core: Dict[str, Any]) -> Dict[str, Any]:
    """``core`` with a sha256 seal over its canonical JSON."""
    return dict(core, sha256=_digest(core))


def verify_sealed(obj: Dict[str, Any], path: str = "?") -> Dict[str, Any]:
    """The core of a sealed record (seal stripped), or
    :class:`StorageCorruptError` naming the file."""
    if not isinstance(obj, dict) or "sha256" not in obj:
        raise StorageCorruptError(f"sealed record {path}: missing seal")
    core = {k: v for k, v in obj.items() if k != "sha256"}
    want = obj["sha256"]
    got = _digest(core)
    if got != want:
        raise StorageCorruptError(
            f"sealed record {path}: sha256 mismatch (expected "
            f"{str(want)[:12]}…, got {got[:12]}…)"
        )
    return core


def load_sealed_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        try:
            obj = json.load(f)
        except ValueError as e:
            raise StorageCorruptError(
                f"sealed record {path}: unparseable JSON ({e})"
            ) from e
    return verify_sealed(obj, path)


# ---------------------------------------------------------------------------
# tolerant JSONL reading + torn-tail repair
# ---------------------------------------------------------------------------


class JsonlCorruptError(StorageCorruptError):
    """A JSONL file has an unparseable line that is not its tail: a torn
    tail is the crash shape and repairable, damage mid-file is not."""


def read_jsonl_tolerant(
    path: str,
    *,
    repair: bool = False,
    artifact: str = "journal",
    tenant: Optional[str] = None,
    repair_dir: Optional[str] = None,
) -> Tuple[List[dict], Optional[dict]]:
    """Parse a JSONL file, tolerating exactly the damage a crash
    mid-append leaves: an unparseable (or unterminated) final line.

    Returns ``(records, repair_record)``.  With ``repair=True`` a torn
    tail is truncated out of the file and the action journaled to
    ``<repair_dir>/storage_repair.jsonl`` (default: the file's own
    directory) with a ``storage_repair`` event; with ``repair=False`` it
    is only reported.  An unparseable line anywhere else raises
    :class:`JsonlCorruptError` naming the file and line."""
    if not os.path.exists(path):
        return [], None
    with open(path, "rb") as f:
        raw = f.read()
    records: List[dict] = []
    torn_at: Optional[int] = None
    lines = raw.split(b"\n")
    offset = 0
    for i, line in enumerate(lines):
        text = line.strip()
        nxt = offset + len(line) + 1
        if text:
            try:
                records.append(json.loads(text.decode()))
            except (ValueError, UnicodeDecodeError) as e:
                if not all(not rest.strip() for rest in lines[i + 1:]):
                    # a torn line followed by later appends: eliding it
                    # could silently rewrite history
                    raise JsonlCorruptError(
                        f"{path}: unparseable JSONL at line {i + 1} "
                        f"(byte {offset}): {e}"
                    ) from e
                torn_at = offset
                break
        offset = nxt
    if torn_at is None:
        return records, None
    rec = {
        "action": "truncate_torn_tail",
        "path": path,
        "artifact": artifact,
        "torn_at_byte": torn_at,
        "torn_bytes": len(raw) - torn_at,
        "repaired": bool(repair),
        "ts": time.time(),
    }
    if repair:
        with open(path, "r+b") as f:
            f.truncate(torn_at)
        journal_repair(rec, root=repair_dir or (os.path.dirname(path) or "."),
                       tenant=tenant)
    return records, rec


_repair_writers_lock = threading.Lock()
_repair_writers: Dict[Tuple[str, Optional[str]], "RotatingJsonlWriter"] = {}


def _repair_writer(root: str, tenant: Optional[str]):
    """One persistent writer per (root, tenant): a repair record that
    could only buffer (the disk full during the repair) flushes when the
    disk recovers."""
    key = (os.path.abspath(root), tenant)
    with _repair_writers_lock:
        w = _repair_writers.get(key)
        if w is None:
            w = RotatingJsonlWriter(os.path.join(root, REPAIR_JOURNAL),
                                    artifact="repair_journal", tenant=tenant)
            _repair_writers[key] = w
        return w


def journal_repair(
    record: dict, *, root: str, tenant: Optional[str] = None
) -> None:
    """Append one repair record to ``<root>/storage_repair.jsonl``
    (rotating, DEGRADE policy), count it and emit ``storage_repair``."""
    inc("sntc_storage_repairs_total",
        **_labels(record.get("artifact", "journal"), tenant))
    _emit(tenant, event="storage_repair",
          component=_component("repair", tenant),
          **{k: v for k, v in record.items() if k != "ts"})
    _repair_writer(root, tenant).write(record)


# ---------------------------------------------------------------------------
# the rotating journal writer (size-capped JSONL under every journal)
# ---------------------------------------------------------------------------


class RotatingJsonlWriter:
    """Size-capped JSONL appender with the DEGRADE failure policy.

    ``write(record)`` appends one JSON line to ``path``; when the segment
    would exceed ``max_bytes`` it first rotates ``path -> path.1 -> … ->
    path.keep`` (the oldest deleted).  A failed write (real ENOSPC/EIO
    or an armed fault at ``site``) buffers the record in a bounded ring
    (``BUFFER_KEEP``), opens a counted ``storage_degraded`` episode and
    returns False; the next successful write flushes the backlog first
    and closes the episode.  A torn partial line is rolled back.
    Thread-safe; holds no handle between writes."""

    BUFFER_KEEP = 256

    def __init__(
        self,
        path: str,
        *,
        artifact: str,
        max_bytes: int = 8 << 20,
        keep: int = 2,
        tenant: Optional[str] = None,
        site: str = "storage.journal",
    ):
        self.path = path
        self.artifact = artifact
        self.max_bytes = int(max_bytes)
        self.keep = max(0, int(keep))
        self.tenant = tenant
        self.site = site
        self._lock = threading.Lock()
        self._buffer: List[str] = []
        self.records_written = 0
        self.records_dropped = 0
        self.write_errors = 0
        self.rotations = 0

    def _rotate_locked(self) -> None:
        if self.keep == 0:
            os.unlink(self.path)
            self.rotations += 1
            return
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self.rotations += 1

    def _append_locked(self, lines: List[str]) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        payload = "".join(lines)
        if size and size + len(payload) > self.max_bytes:
            self._rotate_locked()
        with open(self.path, "a") as f:  # storage: registered-artifact
            append_line(f, payload, site=self.site, tenant=self.tenant)

    def write(self, record: dict) -> bool:
        """Append ``record``; False when it (only) buffered."""
        line = json.dumps(record) + "\n"
        with self._lock:
            pending = self._buffer + [line]
            try:
                self._append_locked(pending)
            except OSError as e:
                self.write_errors += 1
                self._buffer = pending[-self.BUFFER_KEEP:]
                self.records_dropped += len(pending) - len(self._buffer)
                note_write_error(self.artifact, self.path, e,
                                 tenant=self.tenant,
                                 buffered=len(self._buffer))
                return False
            self._buffer = []
            self.records_written += len(pending)
            note_write_ok(self.artifact, tenant=self.tenant)
            return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "records_written": self.records_written,
                "buffered": len(self._buffer),
                "records_dropped": self.records_dropped,
                "write_errors": self.write_errors,
                "rotations": self.rotations,
            }


# ---------------------------------------------------------------------------
# dead-letter retention (keep-N newest, drop oldest, counted)
# ---------------------------------------------------------------------------


def prune_dir_keep_newest(
    path: str,
    keep: int,
    *,
    artifact: str,
    tenant: Optional[str] = None,
    max_bytes: Optional[int] = None,
    protect: Tuple[str, ...] = (),
) -> int:
    """Keep at most ``keep`` files (and ``max_bytes`` bytes) of a flat
    evidence directory, deleting the oldest (name order: batch ids sort
    in time); ``protect`` names stay.  Each deletion counts into
    ``sntc_dead_letter_dropped_total`` and one ``dead_letter_dropped``
    event sums up the pass.  Returns the files dropped."""
    if not os.path.isdir(path):
        return 0
    names = sorted(
        n for n in os.listdir(path)
        if n not in protect and not n.startswith(".")
        and os.path.isfile(os.path.join(path, n))
    )
    drop = names[:-keep] if keep > 0 and len(names) > keep else []
    kept = [n for n in names if n not in set(drop)]
    if max_bytes is not None:
        total = 0
        sizes = {}
        for n in kept:
            try:
                sizes[n] = os.path.getsize(os.path.join(path, n))
            except OSError:
                sizes[n] = 0
            total += sizes[n]
        i = 0
        while total > max_bytes and i < len(kept) - 1:
            drop.append(kept[i])
            total -= sizes[kept[i]]
            i += 1
    dropped = 0
    for n in drop:
        try:
            os.unlink(os.path.join(path, n))
            dropped += 1
        except OSError:
            pass
    if dropped:
        inc("sntc_dead_letter_dropped_total", dropped,
            **_labels(artifact, tenant))
        _emit(tenant, event="dead_letter_dropped",
              component=_component(artifact, tenant), artifact=artifact,
              path=path, dropped=dropped, keep=keep, reason="retention")
    return dropped


# ---------------------------------------------------------------------------
# disk accounting & budgets
# ---------------------------------------------------------------------------


class StoragePlane:
    """Disk accounting for one checkpoint root: per-artifact bytes and
    file counts into the ``sntc_disk_*`` gauges, an optional byte budget
    with a counted breach event, and the ``storage`` status block.  The
    tree walk is throttled to one every ``min_interval_s`` (the status
    rides every supervisor tick); :meth:`usage` forces one."""

    def __init__(
        self,
        root: str,
        *,
        tenant: Optional[str] = None,
        budget_bytes: Optional[int] = None,
        min_interval_s: float = 5.0,
        clock=time.monotonic,
    ):
        self.root = root
        self.tenant = tenant
        self.budget_bytes = budget_bytes
        self._over_budget = False
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._cached_usage: Optional[Dict[str, Any]] = None
        self._measured_at: Optional[float] = None
        self._published_artifacts: set = set()

    def usage(self) -> Dict[str, Any]:
        """Measure every registered artifact under the root, and the
        whole tree, and publish the gauges."""
        per: Dict[str, Dict[str, int]] = {}
        for spec in ARTIFACTS.values():
            b = n = 0
            for pattern in spec.patterns:
                for p in glob.glob(os.path.join(self.root, pattern)):
                    if os.path.isfile(p):
                        try:
                            b += os.path.getsize(p)
                            n += 1
                        except OSError:
                            pass
            if n:
                per[spec.name] = {"bytes": b, "files": n}
        total_b = total_n = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                try:
                    total_b += os.path.getsize(os.path.join(dirpath, name))
                    total_n += 1
                except OSError:
                    pass
        # an artifact that had files last pass and has none now reads 0,
        # not its last bytes
        for name in self._published_artifacts - set(per):
            set_gauge("sntc_disk_bytes", 0, **_labels(name, self.tenant))
            set_gauge("sntc_disk_files", 0, **_labels(name, self.tenant))
        self._published_artifacts = set(per)
        for name, row in per.items():
            set_gauge("sntc_disk_bytes", row["bytes"],
                      **_labels(name, self.tenant))
            set_gauge("sntc_disk_files", row["files"],
                      **_labels(name, self.tenant))
        set_gauge("sntc_disk_bytes", total_b, **_labels("total", self.tenant))
        set_gauge("sntc_disk_files", total_n, **_labels("total", self.tenant))
        if self.budget_bytes is not None:
            labels = {} if self.tenant is None else {"tenant": self.tenant}
            set_gauge("sntc_disk_budget_bytes", self.budget_bytes, **labels)
        out = {"artifacts": per, "total_bytes": total_b,
               "total_files": total_n}
        self._cached_usage = out
        self._measured_at = self._clock()
        return out

    def _usage_throttled(self) -> Dict[str, Any]:
        if (self._cached_usage is not None
                and self._measured_at is not None
                and self._clock() - self._measured_at < self.min_interval_s):
            return self._cached_usage
        return self.usage()

    def check_budget(
        self, usage: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """One accounting pass: measure, compare with the budget, emit
        ``disk_budget_exceeded`` once per breach episode (closed by a
        ``storage_recovered`` once usage falls back under it)."""
        usage = usage or self._usage_throttled()
        over = (self.budget_bytes is not None
                and usage["total_bytes"] > self.budget_bytes)
        if over and not self._over_budget:
            with _deg_lock:
                _degraded.add(("budget", self.tenant))
            set_gauge("sntc_storage_degraded_state", 1,
                      **_labels("budget", self.tenant))
            _emit(self.tenant, event="disk_budget_exceeded",
                  component=_component("budget", self.tenant),
                  root=self.root, total_bytes=usage["total_bytes"],
                  budget_bytes=self.budget_bytes)
        elif not over and self._over_budget:
            note_write_ok("budget", tenant=self.tenant)
        self._over_budget = over
        return dict(
            usage,
            budget_bytes=self.budget_bytes,
            over_budget=over,
            degraded=[{"artifact": a, "tenant": t}
                      for a, t in degraded_artifacts()
                      if t == self.tenant or t is None],
        )

    def status(self) -> Dict[str, Any]:
        return self.check_budget()


# ---------------------------------------------------------------------------
# fsck: the doctor
# ---------------------------------------------------------------------------


def quarantine_blob(
    path: str, *, artifact: str, detail: str, root: str,
    tenant: Optional[str] = None,
) -> Optional[str]:
    """Move a corrupt blob to ``.corrupt/`` beside it and journal the
    move to ``<root>/storage_repair.jsonl``; the destination, or None
    when the move failed.  The doctor and the engine's own recovery (a
    torn files-mode commit record) share it."""
    corrupt_dir = os.path.join(os.path.dirname(path), ".corrupt")
    os.makedirs(corrupt_dir, exist_ok=True)
    dest = os.path.join(corrupt_dir, os.path.basename(path))
    try:
        os.replace(path, dest)  # storage: registered-artifact
    except OSError:
        return None
    journal_repair(
        {"action": "quarantine_corrupt", "path": path, "artifact": artifact,
         "quarantined_to": dest, "detail": detail, "ts": time.time()},
        root=root, tenant=tenant,
    )
    return dest


def _quarantine_file(
    path: str, report: dict, *, artifact: str, detail: str,
    repair: bool, root: str, tenant: Optional[str] = None,
) -> None:
    """Quarantine a corrupt blob (repair mode) or report it."""
    entry = {"path": path, "artifact": artifact, "detail": detail}
    if not repair:
        report["errors"].append(entry)
        return
    dest = quarantine_blob(path, artifact=artifact, detail=detail, root=root,
                           tenant=tenant)
    if dest is None:
        report["errors"].append(
            dict(entry, detail=f"{detail}; quarantine failed"))
        return
    entry["quarantined_to"] = dest
    report["quarantined"].append(entry)


def _check(report: dict, artifact: str, n: int = 1) -> None:
    report["checked"][artifact] = report["checked"].get(artifact, 0) + n


def _artifact_for(rel: str) -> str:
    """The registered artifact a root-relative path belongs to."""
    for spec in ARTIFACTS.values():
        for pattern in spec.patterns:
            if fnmatch.fnmatch(rel, pattern):
                return spec.name
    return "journal"


def _fsck_journals(root: str, report: dict, repair: bool,
                   tenant: Optional[str]) -> None:
    patterns = [
        "shed.jsonl*", "controller.jsonl*", "promotion.jsonl*",
        REPAIR_JOURNAL + "*",
        os.path.join("dead_letter", "dead_letter.jsonl*"),
        os.path.join("dead_letter_rows", "*.jsonl"),
    ]
    for pattern in patterns:
        for path in sorted(glob.glob(os.path.join(root, pattern))):
            artifact = _artifact_for(os.path.relpath(path, root))
            _check(report, artifact)
            try:
                _records, rec = read_jsonl_tolerant(
                    path, repair=repair, artifact=artifact, tenant=tenant,
                    repair_dir=root)
            except JsonlCorruptError as e:
                _quarantine_file(path, report, artifact=artifact,
                                 detail=str(e), repair=repair, root=root,
                                 tenant=tenant)
                continue
            if rec is not None:
                (report["repaired"] if repair else report["errors"]).append(
                    {"path": path, "artifact": artifact, **rec})


def _fsck_append_wal(root: str, report: dict, repair: bool,
                     tenant: Optional[str]) -> None:
    for name in ("offsets.log", "commits.log"):
        path = os.path.join(root, name)
        if not os.path.exists(path):
            continue
        _check(report, "wal_append")
        try:
            _records, rec = read_jsonl_tolerant(
                path, repair=repair, artifact="wal_append", tenant=tenant,
                repair_dir=root)
        except JsonlCorruptError as e:
            # eliding a commit record mid-log would replay (and sink
            # twice) a committed batch: not auto-repairable
            report["errors"].append(
                {"path": path, "artifact": "wal_append", "detail": str(e)})
            continue
        if rec is not None:
            (report["repaired"] if repair else report["errors"]).append(
                {"path": path, "artifact": "wal_append", **rec})
    ckpt = os.path.join(root, "wal_checkpoint.json")
    if os.path.exists(ckpt):
        _check(report, "wal_append")
        try:
            load_sealed_json(ckpt)
        except StorageCorruptError as e:
            # the truncated history cannot be rebuilt: a loud error
            report["errors"].append(
                {"path": ckpt, "artifact": "wal_append", "detail": str(e)})


def _fsck_files_wal(root: str, report: dict, repair: bool,
                    tenant: Optional[str]) -> None:
    for sub in ("offsets", "commits"):
        for path in sorted(glob.glob(os.path.join(root, sub, "*.json"))):
            _check(report, "wal_files")
            try:
                with open(path) as f:
                    json.load(f)
            except ValueError as e:
                # a torn intent/commit reads as absent (the batch
                # replays): quarantining it is safe and keeps evidence
                _quarantine_file(path, report, artifact="wal_files",
                                 detail=f"unparseable WAL record: {e}",
                                 repair=repair, root=root, tenant=tenant)


_FLOW_MAGIC = b"SNTCFLOW1\n"


def _verify_flow_snapshot(path: str) -> None:
    """The seal check of a flow-state snapshot blob (magic, header,
    payload length, sha256), as the JAX package's ``flow.state.
    verify_snapshot`` makes it; raises :class:`StorageCorruptError`."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_FLOW_MAGIC):
        raise StorageCorruptError(f"flow-state snapshot {path}: bad magic")
    head, _, payload = blob[len(_FLOW_MAGIC):].partition(b"\n")
    try:
        header = json.loads(head.decode())
    except ValueError as e:
        raise StorageCorruptError(
            f"flow-state snapshot {path}: unreadable header ({e})") from e
    if len(payload) != header.get("bytes"):
        raise StorageCorruptError(
            f"flow-state snapshot {path}: {len(payload)} payload bytes, "
            f"header says {header.get('bytes')} (torn write)")
    got = hashlib.sha256(payload).hexdigest()
    if got != header.get("sha256"):
        raise StorageCorruptError(
            f"flow-state snapshot {path}: sha256 mismatch (expected "
            f"{str(header.get('sha256'))[:12]}…, got {got[:12]}…)")


def _fsck_flow_state(root: str, report: dict, repair: bool,
                     tenant: Optional[str]) -> None:
    """The seals of a root's flow-state snapshots (either package's): a
    broken one is quarantined, as the JAX doctor does."""
    state_dir = os.path.join(root, "flow_state")
    if not os.path.isdir(state_dir):
        return
    for path in sorted(glob.glob(os.path.join(state_dir, "state-*.bin"))):
        _check(report, "flow_state")
        try:
            _verify_flow_snapshot(path)
        except StorageCorruptError as e:
            _quarantine_file(path, report, artifact="flow_state",
                             detail=str(e), repair=repair, root=root,
                             tenant=tenant)


def _fsck_markers(root: str, report: dict, repair: bool,
                  tenant: Optional[str]) -> None:
    for name in ARTIFACTS["markers"].patterns:
        path = os.path.join(root, name)
        if not os.path.exists(path):
            continue
        _check(report, "markers")
        try:
            with open(path) as f:
                json.load(f)
        except ValueError as e:
            _quarantine_file(path, report, artifact="markers",
                             detail=f"unparseable marker: {e}",
                             repair=repair, root=root, tenant=tenant)


def _fsck_checkpoints(root: str, report: dict) -> None:
    """Verify every model checkpoint (a dir with ``_manifest.json``)
    under the root against its manifest; read-only: a failed model dir
    has its own ``.prev`` fallback."""
    from sntc_tpu_torch.mlio.save_load import verify_checkpoint

    for manifest in glob.glob(os.path.join(root, "**", "_manifest.json"),
                              recursive=True):
        ckpt_dir = os.path.dirname(manifest)
        if os.sep + ".corrupt" + os.sep in ckpt_dir + os.sep:
            continue
        _check(report, "checkpoint")
        try:
            verify_checkpoint(ckpt_dir)
        except Exception as e:
            report["errors"].append(
                {"path": ckpt_dir, "artifact": "checkpoint",
                 "detail": f"manifest verification failed: {e}"})


def _fsck_tmp_orphans(root: str, report: dict, repair: bool) -> None:
    """Sweep the ``*.tmp`` / ``*.tmp-<pid>`` orphans an atomic publish
    leaves when it dies mid-write."""
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != ".corrupt"]
        for name in files:
            stem, _, suffix = name.rpartition(".tmp")
            if not stem or (suffix and not suffix.lstrip("-").isdigit()):
                continue
            path = os.path.join(dirpath, name)
            _check(report, "tmp_orphans")
            if repair:
                try:
                    os.unlink(path)
                    report["cleaned"].append({"path": path})
                except OSError as e:
                    report["errors"].append(
                        {"path": path, "detail": f"unlink failed: {e}"})
            else:
                report["errors"].append(
                    {"path": path, "detail": "orphaned tmp file"})


def _empty_report(root: str, tenant: Optional[str], repair: bool) -> dict:
    return {"root": root, "tenant": tenant, "repair": bool(repair),
            "checked": {}, "repaired": [], "quarantined": [], "cleaned": [],
            "errors": []}


def fsck_root(
    root: str, *, repair: bool = True, tenant: Optional[str] = None,
) -> Dict[str, Any]:
    """Doctor one checkpoint root: verify every registered artifact,
    repair what is safe, quarantine what is not, report everything."""
    report = _empty_report(root, tenant, repair)
    if not os.path.isdir(root):
        report["errors"].append(
            {"path": root, "detail": "checkpoint root does not exist"})
        report["ok"] = False
        return report
    _fsck_append_wal(root, report, repair, tenant)
    _fsck_files_wal(root, report, repair, tenant)
    _fsck_journals(root, report, repair, tenant)
    _fsck_flow_state(root, report, repair, tenant)
    _fsck_markers(root, report, repair, tenant)
    _fsck_checkpoints(root, report)
    _fsck_tmp_orphans(root, report, repair)
    report["ok"] = not report["errors"]
    return report


def fsck(
    root: str, *, repair: bool = True, tenant_tree: bool = False,
) -> Dict[str, Any]:
    """The ``fsck`` command's entry: one checkpoint root, or with
    ``tenant_tree`` a serve-daemon root and every ``<root>/tenant/<id>/
    ckpt`` under it (one report, ``ok`` the AND over the roots)."""
    roots: List[Tuple[str, Optional[str]]] = [(root, None)]
    if tenant_tree:
        for p in sorted(glob.glob(os.path.join(root, "tenant", "*"))):
            ckpt = os.path.join(p, "ckpt")
            if os.path.isdir(ckpt):
                roots.append((ckpt, os.path.basename(p)))
    reports = [fsck_root(r, repair=repair, tenant=t) for r, t in roots]
    if not tenant_tree:
        return reports[0]
    return {"root": root, "tenant_tree": True, "repair": bool(repair),
            "ok": all(r["ok"] for r in reports), "roots": reports}


def quick_scan(
    root: str, tenant: Optional[str] = None
) -> Optional[Dict[str, Any]]:
    """The light doctor every engine runs over its checkpoint dir at
    construction: repair torn journal tails and sweep tmp orphans (no
    hashing).  Never fatal: a failing scan emits ``storage_degraded``
    and returns None."""
    try:
        if not os.path.isdir(root):
            return None
        report = _empty_report(root, tenant, True)
        _fsck_journals(root, report, True, tenant)
        _fsck_tmp_orphans(root, report, True)
        report["ok"] = not report["errors"]
        return report
    except Exception as e:  # a scan bug must not stop serving
        try:
            _emit(tenant, event="storage_degraded",
                  component=_component("scan", tenant), artifact="scan",
                  path=root, error=repr(e))
        except Exception:
            pass
        return None
