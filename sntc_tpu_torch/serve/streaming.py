"""Micro-batch streaming inference with an exactly-once offset log.

Counterpart of ``sntc_tpu/serve/streaming.py`` (``FileStreamSource``,
``CsvDirSink`` and the serial form of ``StreamingQuery`` with its
append-mode WAL): the engine resolves the source's latest offset, logs
the intended batch range (one line of ``offsets.log``), runs the batch
through the predictor, hands it to the sink, then logs the commit (one
line of ``commits.log``).  On restart with the same checkpoint dir an
uncommitted intent is REPLAYED with its logged range and the sink
rewrites that batch's file — exactly-once batches with respect to the
offset log.

A source's offset is its count of files in sorted order (new files are
new data).  The JAX engine's pipelining, prefetch, admission, retries,
breakers, quarantine and WAL compaction are not ported.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import List, Optional

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data.ingest import load_csv
from sntc_tpu_torch.serve.transform import BatchPredictor


class FileStreamSource:
    """Directory of flow CSVs; offset = number of files, sorted by name."""

    def __init__(self, path: str, pattern: str = "*.csv"):
        self.path = path
        self.pattern = pattern

    def _files(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.path, self.pattern)))

    def latest_offset(self) -> int:
        return len(self._files())

    def get_batch(self, start: int, end: int) -> Frame:
        files = self._files()[start:end]
        if not files:
            raise ValueError(f"empty batch range [{start}, {end})")
        return Frame.concat_all([load_csv(p) for p in files])


class CsvDirSink:
    """One CSV per batch, published by fsync + rename: a crash never
    leaves a torn ``batch_*.csv``, and a replayed batch overwrites its
    file with the same rows."""

    def __init__(self, path: str, columns: Optional[List[str]] = None):
        self.path = path
        self.columns = columns
        os.makedirs(path, exist_ok=True)

    def add_batch(self, batch_id: int, frame: Frame) -> None:
        import pyarrow.csv as pacsv

        cols = self.columns or [
            c for c in frame.columns if frame[c].ndim == 1
        ]
        final = os.path.join(self.path, f"batch_{batch_id:06d}.csv")
        tmp = final + ".tmp"
        pacsv.write_csv(frame.select(cols).to_arrow(), tmp)
        _fsync(tmp)
        os.replace(tmp, final)
        _fsync(self.path)  # the rename is durable once the dirent is


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _read_log(path: str) -> dict:
    """``batch_id -> record`` of a JSONL log.  A torn final line (a crash
    mid-append) is a record that never landed: it is cut off, so the
    next append starts on a line of its own."""
    if not os.path.exists(path):
        return {}
    with open(path, "rb") as f:
        data = f.read()
    keep = data.rfind(b"\n") + 1
    if keep < len(data):
        with open(path, "r+b") as f:
            f.truncate(keep)
    return {
        int(rec["batch_id"]): rec
        for rec in (json.loads(line) for line in data[:keep].splitlines())
    }


class StreamingQuery:
    """Serial micro-batch engine over an append-mode WAL.

    One live query owns a checkpoint dir: the logs are read once at
    construction and tracked in memory afterwards."""

    def __init__(
        self,
        model,
        source: FileStreamSource,
        sink: CsvDirSink,
        checkpoint_dir: str,
        max_batch_offsets: Optional[int] = None,
        shape_buckets: int = 0,
        device="cuda",
    ):
        self.predictor = (
            model
            if isinstance(model, BatchPredictor)
            else BatchPredictor(model, bucket_rows=shape_buckets, device=device)
        )
        self.source = source
        self.sink = sink
        self.checkpoint_dir = checkpoint_dir
        self.max_batch_offsets = max_batch_offsets
        os.makedirs(checkpoint_dir, exist_ok=True)
        offsets_path = os.path.join(checkpoint_dir, "offsets.log")
        commits_path = os.path.join(checkpoint_dir, "commits.log")
        intents = _read_log(offsets_path)
        commits = _read_log(commits_path)
        self._last_committed = max(commits) if commits else -1
        self._end_offset = commits[self._last_committed]["end"] if commits else 0
        self._pending = {
            bid: rec for bid, rec in intents.items()
            if bid > self._last_committed
        }
        self._offsets_log = open(offsets_path, "a")
        self._commits_log = open(commits_path, "a")
        self.recentProgress: List[dict] = []
        self.rows_served = 0

    def last_committed(self) -> int:
        return self._last_committed

    @staticmethod
    def _append(f, record: dict) -> None:
        f.write(json.dumps(record) + "\n")
        f.flush()
        os.fsync(f.fileno())

    def _run_one_batch(self) -> bool:
        """Plan (or replay), read, predict, deliver and commit the next
        batch; False when there is nothing to do."""
        batch_id = self._last_committed + 1
        intent = self._pending.get(batch_id)
        if intent is None:
            start = self._end_offset
            latest = self.source.latest_offset()
            if latest <= start:
                return False
            end = latest
            if self.max_batch_offsets is not None:
                end = min(end, start + self.max_batch_offsets)
            intent = {"batch_id": batch_id, "start": start, "end": end}
            self._append(self._offsets_log, intent)  # intent before work
        t0 = time.perf_counter()
        frame = self.source.get_batch(intent["start"], intent["end"])
        out = self.predictor.predict_frame(frame)
        self.sink.add_batch(batch_id, out)
        self._append(self._commits_log, intent)
        self._pending.pop(batch_id, None)
        self._last_committed = batch_id
        self._end_offset = intent["end"]
        dur = time.perf_counter() - t0
        self.rows_served += frame.num_rows
        self.recentProgress.append({
            "batchId": batch_id,
            "numInputRows": frame.num_rows,
            "durationMs": dur * 1e3,
        })
        return True

    def process_available(self) -> int:
        """Drain all currently available data; returns the number of
        batches committed."""
        start = self._last_committed
        while self._run_one_batch():
            pass
        return self._last_committed - start

    def close(self) -> None:
        self._offsets_log.close()
        self._commits_log.close()
