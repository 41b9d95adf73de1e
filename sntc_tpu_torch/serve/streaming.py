"""Micro-batch streaming inference with an exactly-once offset log.

Counterpart of ``sntc_tpu/serve/streaming.py`` (``DirStreamSource``,
``FileStreamSource``, ``CsvDirSink`` and ``StreamingQuery``): the engine
resolves the source's latest offset, write-ahead-logs the intended batch
range, reads the batch, dispatches it through the predictor, hands the
result to the sink, then logs the commit.  On restart with the same
checkpoint dir an uncommitted intent is REPLAYED with its logged range
and the sink rewrites that batch's file: exactly-once batches with
respect to the offset log.

A source's offset is its count of files in sorted order (new files are
new data).

**WAL formats** (``wal_mode``, exclusive per checkpoint dir, the JAX
package's on-disk layouts, so either package resumes the other's):

* ``files`` — one JSON per intent (``offsets/<id>.json``) and per commit
  (``commits/<id>.json``); committed pairs older than the last
  ``wal_keep_commits`` are pruned;
* ``append`` — one JSONL log per side (``offsets.log``, ``commits.log``,
  one fsynced line per batch), sealed into ``wal_checkpoint.json`` and
  truncated every ``wal_compact_every`` commits.

**Storage plane** (``resilience.storage``): the engine runs
``quick_scan`` over its checkpoint dir at construction (torn journal
tails repaired, tmp orphans swept); every WAL write goes through the
storage helpers at the ``storage.wal`` fault site (policy FAIL: a failed
write fails the batch's round, the retries and quarantine own it); the
append logs are read tolerantly (a torn tail is truncated with a
repair record in ``storage_repair.jsonl``); a torn files-mode commit
record is quarantined to ``commits/.corrupt/`` and its batch replays;
a compaction that cannot write degrades and the logs grow until the
disk recovers.  :meth:`StreamingQuery.storage_stats` reports it.

**Row admission** (``schema_contract``, a ``data.schema.
SchemaContract``; ``row_policy`` overrides its mode): every read batch
is admitted at ``stream.admit``.  ``strict`` fails the batch on any
violation (the poison-batch machinery owns it); ``salvage`` and
``permissive`` excise only the poison rows through the predictor's
row-validity mask, inside the bucketed dispatch.  A source with
``parse_salvage`` excises ragged CSV lines at parse time.  Excised rows
and lines go to the row dead letters, ``<checkpoint>/dead_letter_rows/
batch_NNNNNN.jsonl`` (or ``row_dead_letter_dir``): batch id, file, line
or row, raw text and reason, published atomically at
``storage.dead_letter`` (policy SHED), merged and never shrunk on a
replay, with a ``rows_rejected`` event.
:meth:`StreamingQuery.admission_stats` reports it.

**Pipelined engine** (``overlap_sink``, by default on when the
construction's ``pipeline_depth`` is above 1, and a source with
``prefetch_batches``): up to ``pipeline_depth`` batches are in flight,
so batch N+1's read and dispatch overlap batch N's device work; the
retire stage (finalize + sink write) runs on ONE delivery thread; the source parses the next ranges on its prefetch
threads and each multi-file batch on its read pool.  The protocol order is the
serial engine's: WAL intent → read → dispatch → sink → commit; commits
land on the engine thread in batch order, at most one delivery is in the
air, and the head batch leaves ``_in_flight`` only after its commit.

Threads and the card: every kernel launch and device op of a batch is
made on the engine thread, on PyTorch's default stream (the current
stream of every thread unless a caller changes it); the delivery thread
only copies the batch's outputs to the host, on the same stream, so the
copy is ordered after the batch's kernels.  A batch of more rows than the
predictor's ``chunk_rows`` dispatches its later chunks from its finalize
(a window of two chunks bounds its device memory), so it retires on the
engine thread, as in the serial engine.  The read and prefetch
threads only parse on the host.

**Failure handling** (the JAX engine's, ``sntc_tpu/serve/streaming.py``
``StreamingQuery``): ``retry_policy`` retries a batch's read
(``stream.read``) and its finalize + sink (``sink.write``) in place.
``max_batch_failures=N`` arms the poison-batch quarantine: a batch whose
WAL intent, read, dispatch or delivery fails stays queued and is tried
again next round (rounds count per stage); at the N-th failed round of a
stage it is journaled to ``<checkpoint>/dead_letter/`` (one record in
``dead_letter.jsonl``, its raw rows in ``batch_NNNNNN.csv`` when it was
read) and COMMITTED, marked ``quarantined``, so the stream moves past
it.  Unarmed (``None``), the first failure raises out of
``process_available`` and the batch's intent stays in the WAL.
``breakers`` (``sink.write``, ``predict.dispatch``) defer a stage while
open.  A predictor with a device fault domain answers CUDA errors on the
card: they never strike, quarantine or score a breaker; a batch whose
device error shows at finalize (on the delivery thread) is re-dispatched
from the engine thread; once the domain has failed, the error raises out
of ``process_available`` with the batch's intent in the WAL.  The fault
sites are ``stream.wal``, ``stream.read``, ``stream.commit`` and
``sink.write``.  The dead-letter journal (``dead_letter.jsonl``) rotates
at 8 MiB and degrades on a failed write (``storage.dead_letter``); the
newest ``dead_letter_keep`` evidence files are kept, the older dropped
and counted (``sntc_dead_letter_dropped_total``).

**Self-tuning** (the JAX engine's, ``sntc_tpu/serve/streaming.py``):
``pipeline_depth`` only bounds the batches in flight and may change
while the engine runs (the overlap was fixed at construction, as the
JAX engine's ``overlap_sink`` is).  ``autotuner`` (a
``data.autotune.IngestAutotuner``) is ticked once a round and resizes
the source's read pool, its staging queue and the depth live; a tuner
that raises emits ``autotune_error`` and the engine goes on.  The source
meters its read, parse and stage steps and the engine its admit and
bucket steps (``data.pipeline.StageMeter``; ``pipeline_stats()
["ingest"]``).  :meth:`StreamingQuery.shed_backlog` is load shedding:
``oldest`` moves the planning cursor past the surplus offsets, which
are never read, logged or committed (staged reads of them are
dropped), and ``sample`` makes the next intent cover the whole backlog
at a row stride logged in the intent, so a replay reads the same
sample; each decision is journaled to ``<checkpoint>/shed.jsonl``
(rotating, policy DEGRADE) with a ``load_shed`` event.

**Model lifecycle** (``lifecycle``, usually a ``lifecycle.
LifecycleManager``; the JAX engine's hook): every clean committed batch
is handed to ``lifecycle.on_batch(batch_id, frame, finalize)`` on the
engine thread (the frame filtered to the admitted rows, so its labels
align with the output); each round starts with ``_lifecycle_tick``,
which runs ``on_tick`` and applies a pending swap through
:meth:`StreamingQuery.swap_model` between micro-batches, after settling
any delivery in the air.  A swap whose safe point fails is put back for
the next round; a hook that raises emits ``lifecycle_error`` and the
engine goes on.  ``pipeline_stats()["lifecycle"]`` reports it.

**Tenancy** (``tenant="<id>"``, set by ``serve.tenancy.ServeDaemon``):
every site the engine touches becomes ``tenant/<id>/<site>`` (retry,
quarantine, shed and reject events, which also carry a ``tenant``
field; fault points look up the namespaced site before the bare one),
its storage writes and journals carry the tenant, ``shed.jsonl`` records
name it, and its metrics and transfer ledger are labelled with it.  The
names are computed once at construction; ``tenant=None`` keeps the bare
names and labels.

**Commit listener** (``commit_listener``, the JAX engine's hook; the
warm-standby ``resilience.replicate.ReplicationPlane.on_commit`` rides
here): called after each commit record is durable and
``_last_committed`` is set, with ``(batch_id, intent, n_rows)``, on the
thread that commits.  That is the engine thread in both forms: the
pipelined engine's delivery thread only writes the sink, and its
settle, which commits, runs on the engine thread, the WAL's single
writer.  A listener that raises is
journaled as ``commit_listener_error`` with the tenant; the batch stays
committed.

**Spans** (``obs.trace``, free while tracing is off), at the JAX
engine's sites and names, each with the batch id: ``stream.wal`` (the
intent), ``stream.read`` (the source's read), ``stream.admit`` (the
contract), ``predict.dispatch``, ``sink.deliver`` (finalize and sink,
retries included) and ``stream.commit``.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data.ingest import load_csv
from sntc_tpu_torch.data.pipeline import (
    engine_meters,
    source_meters,
    timed,
)
from sntc_tpu_torch.obs import install_event_metrics
from sntc_tpu_torch.obs.metrics import inc, observe, set_gauge
from sntc_tpu_torch.obs.trace import span
from sntc_tpu_torch.resilience import storage as storage_plane
from sntc_tpu_torch.resilience.device import (
    annotate_batch,
    classify_device_error,
)
from sntc_tpu_torch.resilience.faults import fault_point
from sntc_tpu_torch.resilience.policy import (
    RetryPolicy,
    emit_event,
    with_retries,
)
from sntc_tpu_torch.serve.transform import BatchPredictor
from sntc_tpu_torch.utils.profiling import TransferLedger, ledger_scope

# every engine's events count into the metrics plane
install_event_metrics()

# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


class DirStreamSource:
    """A watched directory: offset = count of files in sorted order.
    Subclasses implement ``_load_file(path) -> Frame``.

    **One listing per poll tick**: ``latest_offset()`` globs and sorts
    once; ``get_batch`` reuses the listing whenever it covers the range
    (files are append-only in the offset model).

    **Parallel per-file reads**: a multi-file batch parses its files on a
    pool of ``read_workers`` threads (pyarrow's CSV reader releases the
    GIL) and concatenates them in sorted-filename order.

    **Prefetch** (``prefetch_batches=N``): :meth:`prefetch` stages a
    background read of a future ``[start, end)`` range (at most N staged
    at once, parsed concurrently), so the engine's ``get_batch`` of that
    range returns an already-parsed Frame.  A range with no staged read
    is read synchronously; a staged read that failed raises in
    ``get_batch``, on the engine thread.  ``N <= 0`` stages nothing.

    **Parse salvage** (``parse_salvage=True``): loaders that support it
    excise unparsable lines and collect one reject record each, which
    the engine drains with :meth:`take_rejects` into the row dead
    letters.

    **Live resizing**: :meth:`set_read_workers` and
    :meth:`set_prefetch_batches` resize the pools while the engine runs
    (the autotuner's actions).  Submissions to a pool are made under the
    pool lock, so a resized-out pool is shut down at once without
    waiting: its reads in flight and staged ranges finish, its idle
    threads exit.  ``meters`` time the read (the engine's wait), parse
    (one file) and stage (one background range) steps.
    """

    def __init__(self, path: str, pattern: str, prefetch_batches: int = 0,
                 read_workers: int = 4, parse_salvage: bool = False,
                 tenant: Optional[str] = None):
        self.path = path
        self.pattern = pattern
        # a metric label only (the capture sources' byte counter), as in
        # the JAX source
        self.tenant = tenant
        self.prefetch_batches = int(prefetch_batches)
        self.read_workers = max(1, int(read_workers))
        self.parse_salvage = bool(parse_salvage)
        # loaders run on read and prefetch threads
        self._rejects_lock = threading.Lock()
        self._parse_rejects: List[dict] = []
        self._listing: Optional[List[str]] = None
        self._read_pool: Optional[ThreadPoolExecutor] = None
        self._prefetch_pool: Optional[ThreadPoolExecutor] = None
        # _pool() is reached from the engine thread and from prefetch
        # threads: the lazy create must not race two pools into being
        self._pool_lock = threading.Lock()
        self._retired_pools: List[ThreadPoolExecutor] = []  # joined at close
        self.meters = source_meters(tenant)
        self._staged: dict = {}  # (start, end) -> Future[Frame]
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.prefetch_hwm = 0  # staged-queue high-water mark

    def _files(self) -> List[str]:
        self._listing = sorted(
            glob.glob(os.path.join(self.path, self.pattern))
        )
        return self._listing

    def latest_offset(self) -> int:
        return len(self._files())

    def _load_file(self, path: str) -> Frame:
        raise NotImplementedError

    def _note_rejects(self, records: List[dict]) -> None:
        with self._rejects_lock:
            self._parse_rejects.extend(records)

    def take_rejects(self, files: Optional[List[str]] = None) -> List[dict]:
        """Drain the parse-time reject records collected so far.
        ``files`` restricts the drain to those files' records: a prefetch
        thread may already have parsed a later batch's file, whose
        rejects wait for the batch that covers it."""
        with self._rejects_lock:
            if files is None:
                out, self._parse_rejects = self._parse_rejects, []
                return out
            allowed = set(files)
            out, kept = [], []
            for r in self._parse_rejects:
                take = r.get("file") in allowed or r.get("file") is None
                (out if take else kept).append(r)
            self._parse_rejects = kept
            return out

    def files_for_range(self, start: int, end: int) -> List[str]:
        """The files a ``[start, end)`` batch covers (re-listed when the
        cached listing is stale)."""
        listing = self._listing
        if listing is None or len(listing) < end:
            listing = sorted(glob.glob(os.path.join(self.path,
                                                    self.pattern)))
        return listing[start:end]

    def _retire(self, pool: Optional[ThreadPoolExecutor]) -> None:
        """A resized-out pool (under the pool lock): no submission can
        reach it after this, so it shuts down at once; its queued and
        running reads finish."""
        if pool is not None:
            pool.shutdown(wait=False)
            self._retired_pools.append(pool)

    def set_read_workers(self, n: int) -> None:
        """Resize the per-file read pool live (see the class docs)."""
        n = max(1, int(n))
        with self._pool_lock:
            if n == self.read_workers:
                return
            self.read_workers = n
            self._retire(self._read_pool)
            self._read_pool = None

    def set_prefetch_batches(self, n: int) -> None:
        """Resize the staging queue's bound and with it the staging pool
        live; staged ranges stay staged, the bound applies to new
        prefetches."""
        n = max(0, int(n))
        with self._pool_lock:
            if n == self.prefetch_batches:
                return
            self.prefetch_batches = n
            self._retire(self._prefetch_pool)
            self._prefetch_pool = None

    def _timed_load(self, path: str) -> Frame:
        return timed(self.meters["parse"], self._load_file, path)

    def _read_files(self, files: List[str]) -> Frame:
        if len(files) == 1:  # the common micro-batch: no concat copy
            return self._timed_load(files[0])
        with self._pool_lock:
            if self._read_pool is None:
                self._read_pool = ThreadPoolExecutor(
                    max_workers=self.read_workers,
                    thread_name_prefix="sntc-src-read",
                )
            futs = [self._read_pool.submit(self._timed_load, f)
                    for f in files]
        return Frame.concat_all([f.result() for f in futs])

    def _read_range(self, start: int, end: int,
                    listing: Optional[List[str]]) -> Frame:
        # a listing that does not cover `end` is re-scanned LOCALLY: a
        # prefetch thread never mutates the engine thread's listing
        if listing is None or len(listing) < end:
            listing = sorted(glob.glob(os.path.join(self.path, self.pattern)))
        files = listing[start:end]
        if not files:
            raise ValueError(f"empty batch range [{start}, {end})")
        return self._read_files(files)

    def prefetch(self, start: int, end: int,
                 cursor: Optional[int] = None) -> bool:
        """Stage a background read of ``[start, end)``; True when one was
        scheduled.  Staged ranges wholly behind ``cursor`` (the engine's
        planning cursor; default ``start``) are stale and evicted."""
        if self.prefetch_batches <= 0 or end <= start:
            return False
        horizon = start if cursor is None else cursor
        for key in [k for k in self._staged if k[1] <= horizon]:
            self._staged.pop(key).cancel()
        if (start, end) in self._staged:
            return False
        if len(self._staged) >= self.prefetch_batches:
            return False
        listing = (
            list(self._listing)
            if self._listing is not None and len(self._listing) >= end
            else None
        )
        with self._pool_lock:
            if self._prefetch_pool is None:
                self._prefetch_pool = ThreadPoolExecutor(
                    max_workers=max(1, min(self.prefetch_batches, 4)),
                    thread_name_prefix="sntc-src-prefetch",
                )
            self._staged[(start, end)] = self._prefetch_pool.submit(
                self._staged_read, start, end, listing
            )
        self.prefetch_hwm = max(self.prefetch_hwm, len(self._staged))
        self._queue_gauge()
        return True

    def _staged_read(self, start: int, end: int,
                     listing: Optional[List[str]]) -> Frame:
        # the stage step: one background range (its files' parses are
        # metered by the parse step too)
        return timed(self.meters["stage"], self._read_range, start, end,
                     listing)

    def _queue_gauge(self) -> None:
        labels = {} if self.tenant is None else {"tenant": self.tenant}
        set_gauge("sntc_ingest_queue_depth", len(self._staged),
                  stage="stage", **labels)

    def prefetch_stats(self) -> dict:
        return {
            "hits": self.prefetch_hits,
            "misses": self.prefetch_misses,
            "hwm": self.prefetch_hwm,
            "staged": len(self._staged),
        }

    def get_batch(self, start: int, end: int) -> Frame:
        """The Frame of ``[start, end)``: a staged read's, or read now.
        The engine asks for ranges in order, so staged ranges wholly
        behind ``start`` are stale (a load shed skipped them) and are
        dropped unread."""
        t0 = time.perf_counter()
        try:
            for key in [k for k in self._staged if k[1] <= start]:
                self._staged.pop(key).cancel()
            fut = self._staged.pop((start, end), None)
            if fut is not None:
                self.prefetch_hits += 1
                inc("sntc_source_prefetch_hits_total")
                self._queue_gauge()
                return fut.result()  # a failed staged read raises here
            if self.prefetch_batches > 0:
                self.prefetch_misses += 1
                inc("sntc_source_prefetch_misses_total")
            listing = self._listing
            if listing is not None and len(listing) < end:
                listing = None  # stale: _read_range re-scans once
            return self._read_range(start, end, listing)
        finally:
            # the read step: what the engine waited for (near 0 on a
            # staged hit, the whole parse on a miss)
            self.meters["read"].record(time.perf_counter() - t0)

    def close(self) -> None:
        """Cancel staged reads and shut the pools down (idempotent; a
        closed source still serves synchronous reads)."""
        for fut in self._staged.values():
            fut.cancel()
        self._staged.clear()
        with self._pool_lock:
            pools = [self._read_pool, self._prefetch_pool,
                     *self._retired_pools]
            self._read_pool = self._prefetch_pool = None
            self._retired_pools = []
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=True)


class FileStreamSource(DirStreamSource):
    """Directory of flow CSVs, parsed by :func:`data.ingest.load_csv`.

    ``columnar=True`` parses through the columnar plane
    (``data.pipeline.read_flows_columnar``, ``handle_invalid=None``):
    every feature column is cast to float32 once in Arrow and handed over
    as a numpy view, the block ``pad_assemble`` packs; non-finite values
    survive as float32 NaN/Inf for the admission step."""

    def __init__(self, path: str, pattern: str = "*.csv",
                 columnar: bool = False, **kwargs):
        super().__init__(path, pattern, **kwargs)
        self.columnar = bool(columnar)

    def _load_file(self, path: str) -> Frame:
        if self.columnar:
            from sntc_tpu_torch.data.pipeline import read_flows_columnar

            recs: List[dict] = []
            frame = read_flows_columnar(
                path, handle_invalid=None, salvage=self.parse_salvage,
                rejects=recs if self.parse_salvage else None)
            if recs:
                self._note_rejects(recs)
            return frame
        if not self.parse_salvage:
            return load_csv(path)
        recs: List[dict] = []
        frame = load_csv(path, salvage=True, rejects=recs)
        if recs:
            self._note_rejects(recs)
        return frame


# ---------------------------------------------------------------------------
# in-memory source and sinks
# ---------------------------------------------------------------------------


class MemorySource:
    """An in-memory list of Frames (the tests' source): offset = frame
    count."""

    def __init__(self, frames: Optional[List[Frame]] = None):
        self._frames: List[Frame] = list(frames or [])

    def add(self, frame: Frame) -> None:
        self._frames.append(frame)

    def latest_offset(self) -> int:
        return len(self._frames)

    def get_batch(self, start: int, end: int) -> Frame:
        if end - start == 1:
            return self._frames[start]
        return Frame.concat_all(self._frames[start:end])


class MemorySink:
    """Keeps every ``(batch_id, frame)`` it was handed."""

    def __init__(self):
        self.batches: List[tuple] = []

    def add_batch(self, batch_id: int, frame: Frame) -> None:
        self.batches.append((batch_id, frame))

    @property
    def frames(self) -> List[Frame]:
        return [f for _, f in self.batches]


class ConsoleSink:
    def add_batch(self, batch_id: int, frame: Frame) -> None:
        print(f"[batch {batch_id}] {frame}")


class CsvDirSink:
    """One CSV per batch, published by rename: a crash never leaves a
    torn ``batch_*.csv``, and a replayed batch overwrites its file with
    the same rows.  ``durable`` (the default) fsyncs the file and the
    directory; the dead-letter dumps skip it."""

    def __init__(self, path: str, columns: Optional[List[str]] = None,
                 durable: bool = True):
        self.path = path
        self.columns = columns
        self.durable = bool(durable)
        os.makedirs(path, exist_ok=True)

    def add_batch(self, batch_id: int, frame: Frame) -> None:
        import pyarrow.csv as pacsv

        cols = self.columns or [
            c for c in frame.columns if frame[c].ndim == 1
        ]
        final = os.path.join(self.path, f"batch_{batch_id:06d}.csv")
        tmp = final + ".tmp"
        pacsv.write_csv(frame.select(cols).to_arrow(), tmp)
        if self.durable:
            _fsync(tmp)
        os.replace(tmp, final)  # storage: unbounded(sink output)
        if self.durable:
            _fsync(self.path)  # the rename is durable once the dirent is


# ---------------------------------------------------------------------------
# WAL storage
# ---------------------------------------------------------------------------


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# the micro-batch engine
# ---------------------------------------------------------------------------


class StreamingQuery:
    """Micro-batch engine (see the module docs).

    One live query owns a checkpoint dir: the WAL is read once at
    construction and tracked in memory afterwards."""

    _PROGRESS_KEEP = 100

    def __init__(
        self,
        model,
        source,
        sink,
        checkpoint_dir: str,
        max_batch_offsets: Optional[int] = None,
        pipeline_depth: int = 2,
        shape_buckets: int = 0,
        wal_mode: str = "files",
        wal_compact_every: int = 256,
        wal_keep_commits: int = 64,
        device="cuda",
        retry_policy: Optional[RetryPolicy] = None,
        max_batch_failures: Optional[int] = None,
        dead_letter_dir: Optional[str] = None,
        breakers: Optional[dict] = None,
        dead_letter_keep: int = 200,
        schema_contract=None,
        row_policy: Optional[str] = None,
        row_dead_letter_dir: Optional[str] = None,
        overlap_sink: Optional[bool] = None,
        autotuner=None,
        lifecycle=None,
        tenant: Optional[str] = None,
        commit_listener=None,
    ):
        self.predictor = (
            model
            if isinstance(model, BatchPredictor)
            else BatchPredictor(model, bucket_rows=shape_buckets, device=device)
        )
        self.shape_buckets = int(self.predictor.bucket_rows)
        self.source = source
        self.sink = sink
        self.checkpoint_dir = checkpoint_dir
        # called once a commit record is durable, with (batch_id,
        # intent, n_rows), on the thread that commits (see the module
        # docs); a listener that raises never fails the batch
        self.commit_listener = commit_listener
        self.max_batch_offsets = max_batch_offsets
        # the batches in flight; a controller may change it live
        self.pipeline_depth = max(1, int(pipeline_depth))
        # the retire stage on the delivery thread, fixed for the engine's
        # life (None: on when the construction's depth is above 1)
        self.overlap_sink = (self.pipeline_depth > 1 if overlap_sink is None
                             else bool(overlap_sink))
        # a tenant id prefixes every site this engine touches (events,
        # breakers' health components, fault points): ``tenant/<id>/<site>``,
        # precomputed once; a tenant-less engine keeps the bare names
        self.tenant = tenant
        self._sites = {
            s: (s if tenant is None else f"tenant/{tenant}/{s}")
            for s in ("stream.wal", "stream.read", "stream.commit",
                      "sink.write", "predict.dispatch", "source.parse")
        }
        self._mlabels = {} if tenant is None else {"tenant": tenant}
        # the ingest graph's engine-side steps, and the optional tuner
        # ticked once a round (a failing tuner degrades, never kills);
        # a tenant-less source inherits the engine's tenant label
        self.ingest_meters = engine_meters(tenant)
        src_meters = getattr(source, "meters", None)
        if tenant is not None and src_meters is not None \
                and getattr(source, "tenant", None) is None:
            source.tenant = tenant
            for m in src_meters.values():
                m.tenant = tenant
        self.autotuner = autotuner
        # the model lifecycle's hooks (see the module docs)
        self.lifecycle = lifecycle
        self.models_swapped = 0
        self._sample_next: Optional[int] = None  # stride of the next intent
        self._shed_writer = None
        self._delivery = None  # (batch_id, Future) while one is in the air
        self._delivery_pool: Optional[ThreadPoolExecutor] = None
        self._delivery_busy_s = 0.0
        self._delivered_batches = 0
        self._tick_latest: Optional[int] = None
        # (batch_id, intent, finalize, t0, n_rows, timing, frame) per batch
        self._in_flight: List[tuple] = []
        self._stopped = False
        self._t_start = time.perf_counter()
        self.recentProgress: List[dict] = []
        self.rows_served = 0
        # this engine's copies, beside the process-wide ledger
        self.transfer = TransferLedger(tenant=tenant)
        self.retry_policy = retry_policy
        if max_batch_failures is not None and max_batch_failures < 1:
            raise ValueError("max_batch_failures must be >= 1 (or None)")
        self.max_batch_failures = max_batch_failures
        self.dead_letter_dir = dead_letter_dir or os.path.join(
            checkpoint_dir, "dead_letter"
        )
        self.dead_letter_keep = max(0, int(dead_letter_keep))
        self._dead_letter_writer = None
        # row admission: poison rows of a batch are excised through the
        # predictor's validity mask and journaled row by row
        if row_policy is not None and schema_contract is None:
            raise ValueError(
                "row_policy requires a schema_contract to enforce")
        self.schema_contract = schema_contract
        self.row_policy = row_policy or (
            schema_contract.mode if schema_contract is not None else None)
        self.row_dead_letter_dir = row_dead_letter_dir or os.path.join(
            checkpoint_dir, "dead_letter_rows")
        self._rows_rejected_total = 0
        self._rows_coerced_total = 0
        self._batches_salvaged = 0
        self._rows_journaled: set = set()  # batch ids journaled once
        self._admission_counted: set = set()  # batch ids counted once
        self.breakers: dict = dict(breakers or {})
        # failed rounds by (batch_id, stage)
        self._batch_failures: dict = {}
        # batches whose dead letter is written but whose commit deferred:
        # a later round must not journal them again
        self._quarantined_ids: set = set()
        self.quarantined_batches: List[int] = []  # committed quarantined
        if wal_mode not in ("files", "append"):
            raise ValueError("wal_mode must be 'files' or 'append'")
        self.wal_mode = wal_mode
        self.wal_compact_every = max(0, int(wal_compact_every))
        self.wal_keep_commits = max(0, int(wal_keep_commits))
        self._commits_since_compact = 0
        self.wal_compactions = 0
        self.wal_prunes = 0
        # the light doctor: torn journal tails and tmp orphans a crash
        # left (never fatal; the append WAL repairs its own tails)
        self.storage_scan = storage_plane.quick_scan(checkpoint_dir,
                                                     tenant=tenant)
        self._offsets_dir = os.path.join(checkpoint_dir, "offsets")
        self._commits_dir = os.path.join(checkpoint_dir, "commits")
        if wal_mode == "append":
            self._init_append_wal(checkpoint_dir)
        else:
            os.makedirs(self._offsets_dir, exist_ok=True)
            os.makedirs(self._commits_dir, exist_ok=True)
            self._pending_intents = None
            self._last_committed = self._scan_last_committed()
            self._end_offset = self._read_committed_end(self._last_committed)
            ids = self._log_ids(self._commits_dir)
            self._prune_cursor = ids[0] if ids else 0
        self._next_start = self._end_offset
        # stateful sources (flow/): rewind operator state to the snapshot
        # of the recovered committed offset before any WAL replay, which
        # then reconverges bitwise
        restore = getattr(source, "on_restore", None)
        if restore is not None:
            restore(self._end_offset)

    def _init_append_wal(self, checkpoint_dir: str) -> None:
        """``append`` mode: recovery is ``wal_checkpoint.json`` (the
        sealed state at the last compaction) plus the log tails written
        since; records the checkpoint covers replay idempotently.  A torn
        final line (a crash mid-append) is truncated out with a repair
        record: a torn intent replans, a torn commit replays."""
        if os.path.isdir(self._offsets_dir) or os.path.isdir(
            self._commits_dir
        ):
            raise ValueError(
                f"checkpoint dir {checkpoint_dir!r} was written in "
                "'files' WAL mode; pick a fresh dir for 'append' mode"
            )
        os.makedirs(checkpoint_dir, exist_ok=True)
        offsets_path = os.path.join(checkpoint_dir, "offsets.log")
        commits_path = os.path.join(checkpoint_dir, "commits.log")
        self._wal_ckpt_path = os.path.join(
            checkpoint_dir, "wal_checkpoint.json"
        )
        last, end, pending = -1, 0, {}
        if os.path.exists(self._wal_ckpt_path):
            core = storage_plane.load_sealed_json(self._wal_ckpt_path)
            last, end = int(core["last_committed"]), int(core["end"])
            pending = {int(k): v for k, v in core.get("pending", {}).items()}

        def read_log(path: str) -> dict:
            records, _repair = storage_plane.read_jsonl_tolerant(
                path, repair=True, artifact="wal_append",
                tenant=self.tenant, repair_dir=checkpoint_dir)
            return {int(rec["batch_id"]): rec for rec in records}

        pending.update(read_log(offsets_path))
        commits = read_log(commits_path)
        if commits and max(commits) > last:
            last = max(commits)
            end = commits[last]["end"]
        self._last_committed = last
        self._end_offset = end
        self._pending_intents = {
            bid: rec for bid, rec in pending.items() if bid > last
        }
        self._offsets_log = open(offsets_path, "a")  # storage: wal_append
        self._commits_log = open(commits_path, "a")  # storage: wal_append

    # -- checkpoint bookkeeping -------------------------------------------

    @staticmethod
    def _log_ids(d: str) -> List[int]:
        return sorted(
            int(os.path.splitext(os.path.basename(p))[0])
            for p in glob.glob(os.path.join(d, "*.json"))
        )

    def _scan_last_committed(self) -> int:
        ids = self._log_ids(self._commits_dir)
        while ids:
            path = os.path.join(self._commits_dir, f"{ids[-1]}.json")
            try:
                with open(path) as f:
                    json.load(f)
                return ids[-1]
            except ValueError:
                # a torn commit record is a commit that never landed:
                # its evidence is quarantined and the batch replays
                storage_plane.quarantine_blob(
                    path, artifact="wal_files",
                    detail="torn commit record at recovery",
                    root=self.checkpoint_dir, tenant=self.tenant)
                ids.pop()
        return -1

    def _read_committed_end(self, last: int) -> int:
        if last < 0:
            return 0
        with open(os.path.join(self._commits_dir, f"{last}.json")) as f:
            return json.load(f)["end"]

    def _emit(self, **fields) -> None:
        """The engine's events, tagged with its tenant when it serves
        one (the daemon reads the tag back out of the stream)."""
        if self.tenant is not None:
            fields["tenant"] = self.tenant
        emit_event(**fields)

    def last_committed(self) -> int:
        return self._last_committed

    def committed_end(self) -> int:
        """End offset of the last committed batch (the resume point)."""
        return self._end_offset

    def in_flight_count(self) -> int:
        return len(self._in_flight)

    def _pending_intent(self, batch_id: int) -> Optional[dict]:
        if self._pending_intents is not None:  # append mode: in memory
            return self._pending_intents.get(batch_id)
        path = os.path.join(self._offsets_dir, f"{batch_id}.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except ValueError:
            return None  # a torn intent: the batch was never planned

    def _append_log(self, attr: str, name: str):
        """The live append-WAL handle, reopened (in append mode) when a
        failed compaction left it closed."""
        f = getattr(self, attr)
        if f is None or f.closed:
            f = open(  # storage: wal_append
                os.path.join(self.checkpoint_dir, name), "a")
            setattr(self, attr, f)
        return f

    def _append_wal(self, attr: str, name: str, record: dict) -> None:
        """One append-WAL line at the ``storage.wal`` fault site, then
        fsynced: the line is durable before the batch moves on."""
        f = self._append_log(attr, name)
        storage_plane.append_line(f, json.dumps(record) + "\n",
                                  site="storage.wal", tenant=self.tenant)
        os.fsync(f.fileno())

    def _wal_intent(self, batch_id: int, intent: dict) -> None:
        # policy FAIL: a failed write fails the batch's round
        if self.wal_mode == "append":
            self._append_wal("_offsets_log", "offsets.log", intent)
            self._pending_intents[batch_id] = intent
        else:
            storage_plane.atomic_write_json(
                os.path.join(self._offsets_dir, f"{batch_id}.json"),
                intent, site="storage.wal", tenant=self.tenant,
                fsync=False)

    def _wal_commit(self, batch_id: int, intent: dict) -> None:
        if self.wal_mode == "append":
            self._append_wal("_commits_log", "commits.log", intent)
            self._pending_intents.pop(batch_id, None)
            self._maybe_compact_wal(batch_id, intent["end"])
        else:
            storage_plane.atomic_write_json(
                os.path.join(self._commits_dir, f"{batch_id}.json"),
                intent, site="storage.wal", tenant=self.tenant,
                fsync=False)
            self._prune_files_wal(batch_id)

    def _maybe_compact_wal(self, last_committed: int, end: int) -> None:
        """Every ``wal_compact_every`` commits, seal the recovered state
        (last committed batch, end offset, pending intents) into
        ``wal_checkpoint.json`` and truncate both logs.  A compaction
        that cannot write degrades (counted; the logs keep growing until
        the disk recovers): bounding storage never loses the WAL."""
        if self.wal_compact_every <= 0:
            return
        self._commits_since_compact += 1
        if self._commits_since_compact < self.wal_compact_every:
            return
        core = {
            "version": 1,
            "last_committed": last_committed,
            "end": end,
            "pending": {
                str(bid): rec for bid, rec in self._pending_intents.items()
            },
        }
        try:
            storage_plane.atomic_write_json(
                self._wal_ckpt_path, storage_plane.seal_record(core),
                site="storage.wal", tenant=self.tenant)
            # the checkpoint is durable: a crash before, between or in
            # the truncations replays the tails over it idempotently; a
            # failed reopen leaves a closed handle that _append_log
            # reopens
            for attr, name in (("_offsets_log", "offsets.log"),
                               ("_commits_log", "commits.log")):
                getattr(self, attr).close()
                setattr(self, attr, open(  # storage: wal_append
                    os.path.join(self.checkpoint_dir, name), "w"))
        except OSError as e:
            storage_plane.note_write_error("wal_append", self._wal_ckpt_path,
                                           e, tenant=self.tenant)
            return
        storage_plane.note_write_ok("wal_append", tenant=self.tenant)
        self._commits_since_compact = 0
        self.wal_compactions += 1
        inc("sntc_wal_compactions_total", **self._mlabels)

    def _prune_files_wal(self, batch_id: int) -> None:
        """Delete the committed intent/commit pairs below the
        ``wal_keep_commits`` horizon; uncommitted intents lie above it."""
        if self.wal_keep_commits <= 0:
            return
        horizon = batch_id - self.wal_keep_commits
        while self._prune_cursor <= horizon:
            bid = self._prune_cursor
            for d in (self._offsets_dir, self._commits_dir):
                try:
                    os.unlink(os.path.join(d, f"{bid}.json"))
                    self.wal_prunes += 1
                except OSError:
                    pass
            self._prune_cursor += 1

    # -- engine ------------------------------------------------------------

    def _plan_end(self, start: int, latest: int) -> int:
        """THE batch-range rule, shared by the planner and the prefetch
        hints (a hint by any other rule would never hit)."""
        end = latest
        if self.max_batch_offsets is not None:
            end = min(end, start + self.max_batch_offsets)
        return end

    def _device_domain(self):
        """The predictor's device fault domain (None when unarmed)."""
        return getattr(self.predictor, "device_domain", None)

    def _device_fault(self, dom, exc: BaseException, kind: str,
                      batch_id: int) -> None:
        """Note a device fault the predictor has not counted; raise once
        the domain has failed (the query stops, the batch's intent stays
        in the WAL)."""
        if dom.failed and getattr(exc, "device_kind", None) is not None:
            raise exc  # the failed domain's own DeviceExecError
        if not getattr(exc, "_sntc_device_counted", False):
            dom.note_fault(kind, site=self._sites["predict.dispatch"],
                           batch_id=batch_id)
        if dom.failed:
            try:
                dom.check()
            except Exception as failed:
                raise failed from exc

    def _quarantine_unread(self, batch_id: int, intent: dict,
                           frame: Optional[Frame], exc: BaseException,
                           site: str, t0: float) -> bool:
        """Dead-letter and commit a batch that failed before it entered
        the pipeline (its WAL intent, read or dispatch)."""
        self._quarantine(batch_id, intent, frame, exc, site=site)
        self._commit_batch(batch_id, intent, 0, t0, quarantined=True)
        self._next_start = max(self._next_start, intent["end"])
        return True

    def _dispatch_next(self) -> bool:
        """WAL, read and dispatch the next micro-batch (non-blocking);
        False when there is no new data or the batch deferred.  A batch
        that keeps failing before it enters the pipeline is quarantined
        here (True)."""
        batch_id = self._last_committed + 1 + len(self._in_flight)
        intent = self._pending_intent(batch_id)
        if intent is None:
            start = self._next_start
            latest = self.source.latest_offset()
            self._tick_latest = latest  # reused by the prefetch hint
            if latest <= start:
                return False
            intent = {"batch_id": batch_id, "start": start,
                      "end": self._plan_end(start, latest)}
            if self._sample_next is not None:
                # a sample shed's batch: the whole backlog at a row
                # stride, logged in the intent so a replay reads the same
                # sample
                intent["end"] = latest
                intent["sample_stride"] = self._sample_next
                self._sample_next = None
            try:
                fault_point("stream.wal", tenant=self.tenant)
                with span("stream.wal", batch=batch_id):
                    self._wal_intent(batch_id, intent)  # intent before work
            except Exception as e:
                fails = self._bump_failures(batch_id, "stream.wal")
                if self.max_batch_failures is None:
                    raise
                if fails < self.max_batch_failures or self._in_flight:
                    return False
                return self._quarantine_unread(
                    batch_id, intent, None, e, "stream.wal",
                    time.perf_counter())
        # stage the FOLLOWING range before this batch's read blocks
        pf = getattr(self.source, "prefetch", None)
        if pf is not None and self._tick_latest is not None:
            nxt = intent["end"]
            if self._tick_latest > nxt:
                pf(nxt, self._plan_end(nxt, self._tick_latest),
                   self._next_start)
        t0 = time.perf_counter()

        def _read() -> tuple:
            fault_point("stream.read", tenant=self.tenant)
            with span("stream.read", batch=batch_id):
                frame = self.source.get_batch(intent["start"],
                                              intent["end"])
            stride = intent.get("sample_stride", 1)
            if stride > 1:
                frame = frame.take(np.arange(0, frame.num_rows, stride))
            return self._admit(batch_id, intent, frame)

        frame = None
        stage = "stream.read"
        # while the predict breaker is open deferring is certain: do not
        # re-read the batch each round just to drop it
        br_predict = self.breakers.get("predict.dispatch")
        if br_predict is not None and br_predict.state == "open":
            return False
        try:
            frame, row_mask, rejects, coerced, batch_files = (
                with_retries(_read, self.retry_policy,
                             site=self._sites["stream.read"])
                if self.retry_policy is not None else _read())
            t1 = time.perf_counter()
            stage = "predict.dispatch"
            if br_predict is not None and not br_predict.allow():
                return False
            # idempotent per batch id: a replay or retry round rewrites
            # the evidence and counts it once
            if rejects:
                self._journal_rejected_rows(batch_id, intent, rejects,
                                            batch_files or [])
            if batch_id not in self._admission_counted:
                self._admission_counted.add(batch_id)
                if row_mask is not None:
                    self._batches_salvaged += 1
                self._rows_coerced_total += coerced
            try:
                with ledger_scope(self.transfer), span(
                        "predict.dispatch", batch=batch_id):
                    finalize = timed(self.ingest_meters["bucket"],
                                     self.predictor.predict_frame_async,
                                     frame, row_valid=row_mask)
            except Exception as de:
                # a device failure belongs to the platform, not the
                # batch: it releases a half-open probe slot instead of
                # scoring the breaker
                if br_predict is not None:
                    if (self._device_domain() is not None
                            and classify_device_error(de) is not None):
                        br_predict.release()
                    else:
                        br_predict.record_failure()
                raise
            if br_predict is not None:
                br_predict.record_success()
        except Exception as e:
            dom = self._device_domain()
            kind = classify_device_error(e) if dom is not None else None
            if kind is not None:
                # no failure round, no quarantine: the batch replays
                # next round on the card
                self._device_fault(dom, e, kind, batch_id)
                return False
            fails = self._bump_failures(batch_id, stage)
            if self.max_batch_failures is None:
                raise
            if fails < self.max_batch_failures or self._in_flight:
                # below the threshold, or older batches must commit
                # first: retry next round
                return False
            return self._quarantine_unread(batch_id, intent, frame, e,
                                           stage, t0)
        timing = {"readMs": (t1 - t0) * 1e3,
                  "dispatchMs": (time.perf_counter() - t1) * 1e3}
        self._in_flight.append((batch_id, intent, finalize, t0,
                                frame.num_rows, timing, frame, row_mask))
        # max(): a replayed intent may end below the planning cursor
        self._next_start = max(self._next_start, intent["end"])
        return True

    def _admit(self, batch_id: int, intent: dict, frame: Frame) -> tuple:
        """The ``stream.admit`` step of a read: drain the parse-time
        rejects of this batch's files, then admit the frame against the
        contract.  ``(frame, row_mask, rejects, coerced, batch_files)``;
        ``strict`` raises ``SchemaViolation`` here, failing the read."""
        files_for = getattr(self.source, "files_for_range", None)
        batch_files = (files_for(intent["start"], intent["end"])
                       if files_for is not None else None)
        take = getattr(self.source, "take_rejects", None)
        rejects = list(take(batch_files)) if take is not None else []
        if self.schema_contract is None:
            return frame, None, rejects, 0, batch_files
        with span("stream.admit", batch=batch_id):
            res = timed(self.ingest_meters["admit"],
                        self.schema_contract.admit, frame,
                        mode=self.row_policy)
        if res.rejects:
            # best-effort raw text: the row's 1-D values in column order
            # (the parser records the true line for what it excised)
            cols_1d = [to_host(frame[c]) for c in frame.columns
                       if frame[c].ndim == 1]
            for r in res.rejects:
                rec = dict(r)
                rec["raw"] = ",".join(str(a[rec["row"]]) for a in cols_1d)
                rejects.append(rec)
        mask = None if res.valid.all() else res.valid
        return res.frame, mask, rejects, res.coerced, batch_files

    def _bump_failures(self, batch_id: int, stage: str) -> int:
        """Failed rounds per (batch, stage): a read flake and a sink
        flake of one batch do not pool toward one threshold."""
        key = (batch_id, stage)
        self._batch_failures[key] = self._batch_failures.get(key, 0) + 1
        return self._batch_failures[key]

    def _clear_failures(self, batch_id: int) -> None:
        for key in [k for k in self._batch_failures if k[0] == batch_id]:
            del self._batch_failures[key]

    def _deliver_head(self, batch_id: int, finalize, timing: dict) -> None:
        """The retire stage's work: materialize the batch and hand it to
        the sink, under the retry policy.  On the engine thread serially,
        on the delivery thread in overlap mode; settled by
        :meth:`_settle_head` on the engine thread either way."""
        t0 = time.perf_counter()

        def _deliver() -> None:
            fault_point("sink.write", tenant=self.tenant)
            t_a = time.perf_counter()
            try:
                out = finalize()
                t_b = time.perf_counter()
                self.sink.add_batch(batch_id, out)
            except Exception as e:
                # a device error surfacing here, on the delivery thread,
                # carries its batch id to the settle
                raise annotate_batch(e, batch_id)
            timing["finalizeMs"] = (t_b - t_a) * 1e3
            timing["sinkMs"] = (time.perf_counter() - t_b) * 1e3

        try:
            with span("sink.deliver", batch=batch_id):
                if self.retry_policy is not None:
                    with_retries(_deliver, self.retry_policy,
                                 site=self._sites["sink.write"])
                else:
                    _deliver()
        finally:
            self._delivery_busy_s += time.perf_counter() - t0

    def _settle_head(self, exc: Optional[BaseException]) -> bool:
        """One retirement round's outcome for the head batch (``exc`` is
        the delivery's failure, or None): the breaker's outcome, the
        failure rounds, the quarantine at the threshold, the commit.  The
        batch leaves ``_in_flight`` only after its commit, so ids never
        shift.  True when it committed (normally or quarantined)."""
        (batch_id, intent, finalize, t0, n_rows, timing, frame,
         row_mask) = self._in_flight[0]
        breaker = self.breakers.get("sink.write")
        quarantined = False
        if exc is not None:
            dom = self._device_domain()
            kind = classify_device_error(exc) if dom is not None else None
            if kind is not None:
                # a device failure at finalize: the sink never failed,
                # so its breaker is not scored; the failure is memoized
                # in the old finalize, so only a fresh dispatch, from
                # this thread, can answer it
                if breaker is not None:
                    breaker.release()
                self._device_fault(dom, exc, kind, batch_id)
                self._redispatch_head()
                return False
            if breaker is not None:
                breaker.record_failure()
            fails = self._bump_failures(batch_id, "sink.write")
            if self.max_batch_failures is None:
                raise exc
            if fails < self.max_batch_failures:
                return False  # stays queued; retried next round
            if batch_id not in self._quarantined_ids:
                self._quarantine(batch_id, intent, frame, exc,
                                 site="sink.write")
                self._quarantined_ids.add(batch_id)
            quarantined = True
        elif breaker is not None:
            breaker.record_success()
        try:
            self._commit_batch(batch_id, intent, n_rows, t0,
                               quarantined=quarantined, timing=timing)
        except Exception as ce:
            # the sink has the batch, its commit record is missing: the
            # next round re-delivers (the sink dedupes) and commits
            fails = self._bump_failures(batch_id, "stream.commit")
            if (self.max_batch_failures is None
                    or fails >= self.max_batch_failures):
                raise ce
            return False
        self._in_flight.pop(0)
        self._quarantined_ids.discard(batch_id)
        self._delivered_batches += 1
        if not quarantined and self.lifecycle is not None:
            # the lifecycle observes the committed batch (finalize is
            # once-only: a cached read); its labels align with the
            # output on the admitted rows.  A failing hook degrades,
            # never kills, the loop
            try:
                lc_frame = frame if row_mask is None \
                    else frame.filter(row_mask)
                self.lifecycle.on_batch(batch_id, lc_frame, finalize)
            except Exception as e:
                self._emit(event="lifecycle_error", component="model",
                           batch_id=batch_id, error=repr(e))
        return True

    def _redispatch_head(self) -> None:
        """Replace the head batch's failed finalize with a fresh dispatch
        of its frame (the device response, an OOM split included, runs
        on a new dispatch only).  A failure keeps the old finalize: the
        next round classifies again; a failed domain raises."""
        (batch_id, intent, _old, t0, n_rows, timing, frame,
         row_mask) = self._in_flight[0]
        try:
            with ledger_scope(self.transfer):
                fin = self.predictor.predict_frame_async(
                    frame, row_valid=row_mask)
        except Exception as e:
            dom = self._device_domain()
            if dom is not None and dom.failed:
                raise
            self._emit(event="device_error", batch_id=batch_id,
                       error=repr(e), during="redispatch")
            return
        self._in_flight[0] = (batch_id, intent, fin, t0, n_rows, timing,
                              frame, row_mask)

    def _retire_oldest(self) -> bool:
        """Serial retire: deliver and settle the oldest in-flight batch
        on the engine thread; an open sink breaker defers it."""
        batch_id, _intent, finalize = self._in_flight[0][:3]
        breaker = self.breakers.get("sink.write")
        if breaker is not None and not breaker.allow():
            return False
        exc: Optional[BaseException] = None
        try:
            self._deliver_head(batch_id, finalize, self._in_flight[0][5])
        except Exception as e:
            exc = e
        return self._settle_head(exc)

    # -- overlapped retire (pipelined mode) ---------------------------------

    def _submit_delivery(self) -> bool:
        """Arm the delivery thread with the head batch's retire work; an
        open sink breaker defers it (one ``allow`` a round, its outcome
        recorded at the settle)."""
        batch_id, _intent, finalize = self._in_flight[0][:3]
        breaker = self.breakers.get("sink.write")
        if breaker is not None and not breaker.allow():
            return False
        if self._delivery_pool is None:
            self._delivery_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sntc-sink-delivery"
            )
        self._delivery = (
            batch_id,
            self._delivery_pool.submit(self._deliver_head, batch_id,
                                       finalize, self._in_flight[0][5]),
        )
        return True

    def _finish_delivery(self, wait: bool) -> bool:
        """Settle the in-air delivery (joining it when ``wait``) on the
        engine thread, the WAL's single writer; True when its batch
        committed."""
        if self._delivery is None:
            return False
        batch_id, fut = self._delivery
        if not wait and not fut.done():
            return False
        exc = fut.exception()  # joins the delivery when wait=True
        self._delivery = None
        if not self._in_flight or self._in_flight[0][0] != batch_id:
            raise RuntimeError(
                f"delivery settled for batch {batch_id} but the queue "
                "head moved — pipeline invariant violated"
            )
        return self._settle_head(exc)

    def _oversized_head(self) -> bool:
        """The head batch's finalize dispatches chunks: it retires on the
        engine thread, the only thread that launches work."""
        return self._in_flight[0][4] > self.predictor.chunk_rows

    def _pump_delivery(self) -> None:
        """Settle a completed delivery, then arm the delivery thread with
        the current head so its retire runs while this thread plans,
        reads and dispatches (an oversized head retires here)."""
        self._finish_delivery(wait=False)
        if self._delivery is None and self._in_flight:
            if self._oversized_head():
                self._retire_oldest()
            else:
                self._submit_delivery()

    def _maybe_prefetch(self) -> None:
        """Hint the source to stage the upcoming batches' reads: replayed
        intents with their logged ranges, then the planned ranges from
        this tick's offset read — the ranges ``_dispatch_next`` will ask
        for."""
        pf = getattr(self.source, "prefetch", None)
        if pf is None:
            return
        cursor = self._next_start
        capacity = max(1, int(getattr(self.source, "prefetch_batches", 1)))
        bid = self._last_committed + 1 + len(self._in_flight)
        start = self._next_start
        for _ in range(capacity):
            intent = self._pending_intent(bid)
            if intent is not None:
                pf(intent["start"], intent["end"], cursor)
                start = max(start, intent["end"])
                bid += 1
                continue
            latest = self._tick_latest
            if latest is None or latest <= start:
                break
            end = self._plan_end(start, latest)
            pf(start, end, cursor)
            start = end
            bid += 1

    def _commit_batch(self, batch_id: int, intent: dict, n_rows: int,
                      t0: float, quarantined: bool = False,
                      timing: Optional[dict] = None) -> None:
        """The one commit protocol (WAL commit, bookkeeping, metrics and
        the progress record) of normal and quarantined batches."""
        # stateful sources publish their operator-state snapshot before
        # the commit record: the two retained snapshots then bracket the
        # committed offset, so a crash in between restores the
        # exact-offset snapshot and the batch replays from it
        committed_hook = getattr(self.source, "on_batch_committed", None)
        if committed_hook is not None:
            committed_hook(batch_id, intent)
        fault_point("stream.commit", tenant=self.tenant)
        with span("stream.commit", batch=batch_id):
            self._wal_commit(batch_id, intent)
        self._clear_failures(batch_id)
        # a committed batch never re-reads in this process
        self._rows_journaled.discard(batch_id)
        self._admission_counted.discard(batch_id)
        self._last_committed = batch_id
        self._end_offset = intent["end"]
        if self.commit_listener is not None:
            try:
                self.commit_listener(batch_id, intent, n_rows)
            except Exception as e:
                emit_event(
                    event="commit_listener_error", tenant=self.tenant,
                    batch_id=batch_id, error=repr(e),
                )
        self.rows_served += n_rows
        now = time.perf_counter()
        dur = now - t0
        inc("sntc_batches_committed_total", **self._mlabels)
        if n_rows:
            inc("sntc_rows_committed_total", n_rows, **self._mlabels)
        observe("sntc_batch_duration_seconds", dur, **self._mlabels)
        progress = {
            "batchId": batch_id,
            "numInputRows": int(n_rows),
            "durationMs": dur * 1e3,
            "processedRowsPerSecond": (n_rows / dur) if dur > 0 else 0.0,
        }
        for key in ("readMs", "dispatchMs", "finalizeMs", "sinkMs"):
            if timing is not None and key in timing:
                progress[key] = timing[key]
        if "dispatchMs" in progress and "finalizeMs" in progress:
            progress["predictMs"] = (progress["dispatchMs"]
                                     + progress["finalizeMs"])
        progress["commitMs"] = (now - self._t_start) * 1e3
        if quarantined:
            progress["quarantined"] = True
            self.quarantined_batches.append(batch_id)
        self.recentProgress.append(progress)
        if len(self.recentProgress) > self._PROGRESS_KEEP:
            del self.recentProgress[0]

    def _quarantine(self, batch_id: int, intent: dict,
                    frame: Optional[Frame], exc: BaseException,
                    site: str) -> None:
        """Journal a poison batch to the dead-letter dir: one JSONL
        record (intent and error) always, and its raw 1-D input columns
        as a CSV when it was read (from the host frame the source
        returned, never from the card).  The caller commits it."""
        os.makedirs(self.dead_letter_dir, exist_ok=True)
        record = {
            "batch_id": batch_id,
            "intent": intent,
            "error": repr(exc),
            "failures": sum(v for k, v in self._batch_failures.items()
                            if k[0] == batch_id),
            "num_rows": int(frame.num_rows) if frame is not None else None,
            "ts": time.time(),
            "rows_file": None,
        }
        if frame is not None:
            try:
                CsvDirSink(self.dead_letter_dir,
                           durable=False).add_batch(batch_id, frame)
                record["rows_file"] = f"batch_{batch_id:06d}.csv"
            except Exception as dump_err:
                record["dump_error"] = repr(dump_err)
        # the journal rotates at its size cap and degrades on a failed
        # write: losing a record never fails the quarantine
        if self._dead_letter_writer is None:
            self._dead_letter_writer = storage_plane.RotatingJsonlWriter(
                os.path.join(self.dead_letter_dir, "dead_letter.jsonl"),
                artifact="dead_letter", site="storage.dead_letter",
                tenant=self.tenant)
        self._dead_letter_writer.write(record)
        if self.dead_letter_keep > 0:
            storage_plane.prune_dir_keep_newest(
                self.dead_letter_dir, self.dead_letter_keep,
                artifact="dead_letter", tenant=self.tenant,
                protect=tuple(f"dead_letter.jsonl{x}"
                              for x in ("", ".1", ".2")),
            )
        self._emit(event="quarantine", site=self._sites.get(site, site),
                   batch_id=batch_id, error=repr(exc))

    def _journal_rejected_rows(self, batch_id: int, intent: dict,
                               rejects: List[dict],
                               batch_files: List[str]) -> None:
        """The row dead letters of one batch (see the module docs): one
        record per excised row or line, written atomically to
        ``batch_NNNNNN.jsonl`` merged with what an earlier round or run
        journaled (never shrunk); the ``rows_rejected`` event and count
        once per batch.  A failed write sheds the evidence (counted), it
        never fails the batch."""
        def key(r):
            return (r.get("file"), r.get("line"), r.get("row"),
                    r.get("raw"), r.get("reason"))

        seen: set = set()
        records: List[dict] = []
        for r in rejects:
            if key(r) in seen:  # a retried read parses the same lines
                continue
            seen.add(key(r))
            rec = {
                "batch_id": batch_id,
                "file": r.get("file") or (
                    batch_files[0] if len(batch_files) == 1 else None),
                "line": r.get("line"),
                "row": r.get("row"),
                "raw": r.get("raw"),
                "reason": r.get("reason"),
                "column": r.get("column"),
                "value": r.get("value"),
                "detail": r.get("detail"),
                "ts": time.time(),
            }
            if rec["file"] is None and batch_files:
                rec["batch_files"] = batch_files
            records.append(rec)
        if not records:
            return
        first_journal = batch_id not in self._rows_journaled
        self._rows_journaled.add(batch_id)
        os.makedirs(self.row_dead_letter_dir, exist_ok=True)
        final = os.path.join(self.row_dead_letter_dir,
                             f"batch_{batch_id:06d}.jsonl")
        if os.path.exists(final):
            with open(final) as f:
                prior = [json.loads(line) for line in f if line.strip()]
            fresh = {key(r) for r in records}
            records = [r for r in prior if key(r) not in fresh] + records
        try:
            storage_plane.atomic_write_bytes(
                final,
                "".join(json.dumps(r) + "\n" for r in records).encode(),
                site="storage.dead_letter", tenant=self.tenant, fsync=False)
        except OSError as e:
            storage_plane.note_write_error("dead_letter_rows", final, e,
                                           tenant=self.tenant)
            return
        storage_plane.note_write_ok("dead_letter_rows", tenant=self.tenant)
        if self.dead_letter_keep > 0:
            storage_plane.prune_dir_keep_newest(
                self.row_dead_letter_dir, self.dead_letter_keep,
                artifact="dead_letter_rows", tenant=self.tenant)
        if not first_journal:
            return
        self._rows_rejected_total += len(records)
        reasons: dict = {}
        for rec in records:
            reasons[rec["reason"]] = reasons.get(rec["reason"], 0) + 1
        self._emit(event="rows_rejected", site=self._sites["source.parse"],
                   batch_id=batch_id, count=len(records), reasons=reasons)

    def admission_stats(self) -> Optional[dict]:
        """Row admission (None without a contract): the policy, rows
        rejected and coerced, batches that needed the salvage mask, and
        the row dead letters' directory."""
        if self.schema_contract is None:
            return None
        return {
            "policy": self.row_policy,
            "rows_rejected": self._rows_rejected_total,
            "rows_coerced": self._rows_coerced_total,
            "batches_salvaged": self._batches_salvaged,
            "row_dead_letter_dir": self.row_dead_letter_dir,
        }

    def storage_stats(self) -> dict:
        """The storage plane for this engine's checkpoint dir: the WAL's
        bounds and counters, the dead-letter journal writer, and the
        construction-time scan when it found something."""
        out = {
            "wal_mode": self.wal_mode,
            "wal_compact_every": self.wal_compact_every,
            "wal_keep_commits": self.wal_keep_commits,
            "dead_letter_keep": self.dead_letter_keep,
            "wal_compactions": self.wal_compactions,
            "wal_prunes": self.wal_prunes,
        }
        for name, writer in (("shed_journal", self._shed_writer),
                             ("dead_letter_journal",
                              self._dead_letter_writer)):
            if writer is not None:
                out[name] = writer.stats()
        scan = self.storage_scan
        if scan is not None and (scan["repaired"] or scan["errors"]
                                 or scan["cleaned"]):
            out["startup_scan"] = {k: scan[k] for k in
                                   ("repaired", "errors", "cleaned")}
        return out

    # -- model lifecycle (hot swap) ------------------------------------------

    def swap_model(self, model):
        """Replace the served model BETWEEN micro-batches, keeping the
        predictor's shape ledger and buckets; returns the replaced
        model.  A delivery in the air is settled first (commit, deferral
        or quarantine, under the old model); batches already dispatched
        finalize against the model they were dispatched with.  Call from
        the engine thread only."""
        if self._delivery is not None:
            self._finish_delivery(wait=True)
        if self._delivery is not None:  # pragma: no cover - invariant
            raise RuntimeError(
                "model swap attempted with a delivery still in air")
        old = self.predictor.swap_model(model)
        self.models_swapped += 1
        return old

    def _lifecycle_tick(self) -> None:
        """Once a round: the probation check, then any pending swap, at
        this between-batches safe point.  A failure emits
        ``lifecycle_error``; a swap taken but not applied is put back for
        the next round."""
        lc = self.lifecycle
        if lc is None:
            return
        pending = None
        try:
            on_tick = getattr(lc, "on_tick", None)
            if on_tick is not None:
                on_tick(self)
            take = getattr(lc, "take_pending_swap", None)
            pending = take() if take is not None else None
            if pending is not None:
                old = self.swap_model(pending)
                # the flip landed: a later failure must not re-arm it
                pending = None
                applied = getattr(lc, "on_swap_applied", None)
                if applied is not None:
                    applied(old)
        except Exception as e:
            if pending is not None:
                rearm = getattr(lc, "rearm_pending_swap", None)
                if rearm is not None:
                    rearm(pending)
            self._emit(event="lifecycle_error", component="model",
                       error=repr(e))

    def pipeline_stats(self) -> dict:
        """Pipelining evidence: overlap and bucket config, delivery-thread
        busy time, the predictor's shape ledger, this engine's transfer
        counters, the source's prefetch stats, the ingest graph's stage
        meters and the autotuner's decisions, the WAL's bounds and the
        journals, the device domain's stats and the lifecycle's."""
        stats = {
            "overlap_sink": self.overlap_sink,
            "pipeline_depth": self.pipeline_depth,
            "shape_buckets": self.shape_buckets,
            "delivery_busy_s": round(self._delivery_busy_s, 6),
            "delivered_batches": self._delivered_batches,
            "compile_events": self.predictor.compile_events,
            "bucket_hits": self.predictor.bucket_hits,
            "padded_rows_total": self.predictor.padded_rows_total,
            "transfers": self.transfer.snapshot(),
            "storage": self.storage_stats(),
        }
        admission = self.admission_stats()
        if admission is not None:
            stats["admission"] = admission
        src_stats = getattr(self.source, "prefetch_stats", None)
        if src_stats is not None:
            stats["prefetch"] = src_stats()
        ingest = {name: m.snapshot() for name, m in
                  getattr(self.source, "meters", {}).items()}
        ingest.update((name, m.snapshot())
                      for name, m in self.ingest_meters.items())
        stats["ingest"] = ingest
        if self.autotuner is not None:
            stats["autotune"] = self.autotuner.stats()
        dom = self._device_domain()
        if dom is not None:
            stats["device"] = dom.stats()
        if self.lifecycle is not None:
            lc_stats = getattr(self.lifecycle, "stats", None)
            stats["lifecycle"] = dict(
                lc_stats() if lc_stats is not None else {},
                models_swapped=self.models_swapped)
        return stats

    def _run_one_batch(self) -> bool:
        """Advance the pipeline by one round; False when no batch was
        committed.  Overlap mode pumps the delivery thread before the
        dispatch loop, between dispatches and after it."""
        before = self._last_committed
        self._lifecycle_tick()
        if self.autotuner is not None:
            # knob changes land between rounds; a tuner's failure
            # degrades, never kills the loop
            try:
                self.autotuner.on_tick(self)
            except Exception as e:
                self._emit(event="autotune_error", error=repr(e))
        if self.overlap_sink:
            self._pump_delivery()
            if self._tick_latest is None:
                # first round: one listing up front so the first
                # dispatches hit staged reads instead of parsing cold
                self._tick_latest = self.source.latest_offset()
            self._maybe_prefetch()
        while len(self._in_flight) < self.pipeline_depth:
            if not self._dispatch_next():
                break
            if self.overlap_sink:
                self._pump_delivery()
        self._maybe_prefetch()
        if self.overlap_sink:
            self._pump_delivery()
        elif self._in_flight:
            self._retire_oldest()
        return self._last_committed != before

    def process_available(self) -> int:
        """Drain all currently available data; returns the number of
        batches committed.  In overlap mode a round with nothing left to
        dispatch joins the in-air delivery, so the drained guarantee is
        the serial engine's."""
        start = self._last_committed
        while not self._stopped:
            if self._run_one_batch():
                continue
            if self.overlap_sink and self._delivery is not None:
                self._finish_delivery(wait=True)
                continue
            break
        return self._last_committed - start

    def drain(self) -> int:
        """Finish and commit every in-flight batch WITHOUT dispatching
        new ones; returns the batches committed.  Rounds that keep
        deferring (an open breaker, a threshold not reached) are bounded:
        what is left stays in the WAL for a restart, as after a crash."""
        before = self._last_committed
        stalled = 0
        max_stalled = ((self.max_batch_failures or 1) + 1) * (
            len(self._in_flight) + 1
        )
        while self._in_flight and stalled < max_stalled:
            if self._delivery is not None:
                committed = self._finish_delivery(wait=True)
            elif self.overlap_sink and not self._oversized_head():
                if not self._submit_delivery():
                    stalled += 1  # breaker open
                    continue
                committed = self._finish_delivery(wait=True)
            else:
                committed = self._retire_oldest()
            stalled = 0 if committed else stalled + 1
        return self._last_committed - before

    # -- supervision hooks (QuerySupervisor) --------------------------------

    @property
    def lastProgress(self) -> Optional[dict]:
        return self.recentProgress[-1] if self.recentProgress else None

    def planned_offset(self) -> int:
        """The planning cursor: offsets below it are committed or in
        flight."""
        return self._next_start

    def backlog_offsets(self, latest: Optional[int] = None) -> int:
        """Source offsets available but not yet planned."""
        if latest is None:
            latest = self.source.latest_offset()
        return max(0, latest - self._next_start)

    def shed_backlog(self, max_pending_batches: int, policy: str = "oldest",
                     latest: Optional[int] = None) -> Optional[dict]:
        """Admission control: when the backlog beyond the logged intents
        exceeds ``max_pending_batches`` micro-batches (of
        ``max_batch_offsets`` offsets; one when unset), shed down to the
        cap and return the journaled record, else None.

        ``oldest`` drops the oldest surplus offsets; ``sample`` makes the
        next intent cover the whole backlog at ``sample_stride``.  The
        record goes to ``<checkpoint>/shed.jsonl`` with a ``load_shed``
        event.  Shedding moves the planning cursor, not a commit: a crash
        before the next commit restores the backlog, and the supervisor
        sheds again after the restart."""
        if policy not in ("oldest", "sample"):
            raise ValueError("shed policy must be 'oldest' or 'sample'")
        if self._sample_next is not None:
            return None  # one sample decision waits for its batch
        unit = self.max_batch_offsets or 1
        if latest is None:
            latest = self.source.latest_offset()
        # offsets under uncommitted intents replay whatever happens: they
        # are not sheddable
        base = self._next_start
        bid = self._last_committed + 1 + len(self._in_flight)
        while True:
            replay = self._pending_intent(bid)
            if replay is None:
                break
            base = max(base, replay["end"])
            bid += 1
        pending = latest - base
        keep = max_pending_batches * unit
        if pending <= keep:
            return None
        record = {
            "ts": time.time(),
            "policy": policy,
            "backlog_offsets": pending,
            "max_pending_batches": max_pending_batches,
        }
        if self.tenant is not None:
            record["tenant"] = self.tenant  # which tenant paid for it
        if policy == "oldest":
            shed_end = latest - keep
            record.update(start=base, end=shed_end,
                          offsets_shed=shed_end - base)
            self._next_start = max(self._next_start, shed_end)
        else:
            stride = -(-pending // keep)  # keeps ~keep offsets' rows
            record.update(start=base, end=latest, sample_stride=stride,
                          offsets_shed=0)
            self._sample_next = stride
        # policy DEGRADE: a decision that cannot be journaled still sheds
        if self._shed_writer is None:
            self._shed_writer = storage_plane.RotatingJsonlWriter(
                os.path.join(self.checkpoint_dir, "shed.jsonl"),
                artifact="shed_journal", tenant=self.tenant)
        self._shed_writer.write(record)
        self._emit(event="load_shed", site=self._sites["stream.read"],
                   policy=policy,
                   start=record["start"], end=record["end"],
                   offsets_shed=record["offsets_shed"],
                   sample_stride=record.get("sample_stride"))
        return record

    def stop(self) -> None:
        """Stop the engine: a still-running delivery finishes but is not
        settled (its batch stays uncommitted and replays on restart —
        the crash contract); the append-WAL handles close."""
        self._stopped = True
        if self._delivery_pool is not None:
            self._delivery_pool.shutdown(wait=True)
            self._delivery_pool = None
            self._delivery = None
        if self.wal_mode == "append":
            for f in (self._offsets_log, self._commits_log):
                if f is not None:
                    f.close()
