"""The ingest source graph and the columnar float32 plane.

Counterpart of ``sntc_tpu/data/pipeline.py``.  Host ingest is one
operator graph, **read → parse → admit → bucket → stage**:

========  ==============================================================
stage     what it is in the port
========  ==============================================================
read      the engine-observed ``get_batch`` wait (a staged hit ≈ 0; a
          miss pays the parse inline)
parse     one source file decoded to a Frame (``load_csv`` or the
          columnar reader), on the source's ``read_workers`` pool for a
          multi-file batch
admit     the schema contract's row admission of the read batch
bucket    the predictor's dispatch: ``pad_assemble`` to the shape
          bucket, the upload and the launches
stage     a background prefetch of an upcoming range (the staging
          queue, ``prefetch_batches`` deep: queue and pool)
========  ==============================================================

Each stage carries a :class:`StageMeter` (EWMA latency, busy time,
count; each item observed into ``sntc_ingest_stage_seconds``), and the
graph's three pool and queue sizes are :class:`Knob` objects
(``read_workers``, ``prefetch_batches``, ``pipeline_depth``), resolved
live on a running engine by :func:`graph_knobs` for the autotuner
(``data.autotune``).  :func:`describe_graph` renders the structure for
status dumps.

The **columnar plane** (:func:`read_flows_columnar`,
:func:`load_flows_columnar`) casts every feature column to float32 once
inside Arrow at parse time, applies the NaN/Inf policy as one Arrow mask
pass and hands back numpy views over the Arrow buffers: the float32
block ``pad_assemble`` packs, with no host copy between the parse and
the pack.  Bitwise equal to ``load_csv`` → ``clean_flows``.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data.schema import LABEL_COLUMN, normalize_label
from sntc_tpu_torch.obs.metrics import observe

#: the operator graph, in data-flow order
STAGES = ("read", "parse", "admit", "bucket", "stage")

#: the graph's tunable pool and queue sizes: the autotuner's action
#: space, the serve flags and the ``sntc_ingest_knob_value`` labels
KNOB_NAMES = ("read_workers", "prefetch_batches", "pipeline_depth")


class StageMeter:
    """Latency and occupancy of one ingest stage.  :meth:`record` is the
    hot-path write, once per item (a file parse, a batch read), never per
    row.  ``tenant`` labels the series when the owning source or engine
    serves a tenant (the engine sets it on a source built without one)."""

    __slots__ = ("stage", "tenant", "count", "busy_s", "last_s", "ewma_s",
                 "_lock")

    #: EWMA smoothing: ~10 items of memory
    ALPHA = 0.2

    def __init__(self, stage: str, tenant: Optional[str] = None):
        self.stage = stage
        self.tenant = tenant
        self.count = 0
        self.busy_s = 0.0
        self.last_s = 0.0
        self.ewma_s = 0.0
        self._lock = threading.Lock()

    def record(self, elapsed_s: float) -> None:
        with self._lock:
            self.count += 1
            self.busy_s += elapsed_s
            self.last_s = elapsed_s
            self.ewma_s = (
                elapsed_s if self.count == 1
                else self.ALPHA * elapsed_s + (1 - self.ALPHA) * self.ewma_s
            )
        labels = {} if self.tenant is None else {"tenant": self.tenant}
        observe("sntc_ingest_stage_seconds", elapsed_s, stage=self.stage,
                **labels)

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "busy_s": round(self.busy_s, 6),
            "last_s": round(self.last_s, 6),
            "ewma_s": round(self.ewma_s, 6),
        }


def source_meters(tenant: Optional[str] = None) -> Dict[str, StageMeter]:
    """The source-side meters (read, parse, stage) of a
    ``DirStreamSource``."""
    return {s: StageMeter(s, tenant) for s in ("read", "parse", "stage")}


def engine_meters(tenant: Optional[str] = None) -> Dict[str, StageMeter]:
    """The engine-side meters (admit, bucket) of a ``StreamingQuery``."""
    return {s: StageMeter(s, tenant) for s in ("admit", "bucket")}


@dataclass
class Knob:
    """One live pool or queue size: ``get`` reads it, ``set`` resizes it,
    bounded to ``[lo, hi]``; a controller moves it ``step`` at a time."""

    name: str
    get: Callable[[], int]
    set: Callable[[int], None]
    lo: int
    hi: int
    step: int = 1

    def clamp(self, value: int) -> int:
        return max(self.lo, min(self.hi, int(value)))


#: the knobs' bounds: floors keep every pool alive, ceilings keep a
#: runaway signal from growing threads and queues without end
DEFAULT_BOUNDS = {
    "read_workers": (1, max(4, (os.cpu_count() or 4))),
    "prefetch_batches": (1, 8),
    "pipeline_depth": (1, 4),
}


def graph_knobs(engine, bounds: Optional[dict] = None) -> Dict[str, Knob]:
    """The knobs a live engine and its source expose
    (``set_read_workers`` / ``set_prefetch_batches`` on the source,
    ``pipeline_depth`` on the engine); a ``MemorySource`` engine has
    ``pipeline_depth`` alone."""
    bounds = dict(DEFAULT_BOUNDS, **(bounds or {}))
    knobs: Dict[str, Knob] = {}
    source = engine.source
    if hasattr(source, "set_read_workers"):
        lo, hi = bounds["read_workers"]
        knobs["read_workers"] = Knob(
            "read_workers", lambda: source.read_workers,
            source.set_read_workers, lo, hi)
    if hasattr(source, "set_prefetch_batches"):
        lo, hi = bounds["prefetch_batches"]
        knobs["prefetch_batches"] = Knob(
            "prefetch_batches", lambda: source.prefetch_batches,
            source.set_prefetch_batches, lo, hi)
    if hasattr(engine, "pipeline_depth"):
        lo, hi = bounds["pipeline_depth"]

        def _set_depth(n: int, _e=engine) -> None:
            _e.pipeline_depth = max(1, int(n))

        knobs["pipeline_depth"] = Knob(
            "pipeline_depth", lambda: engine.pipeline_depth, _set_depth,
            lo, hi)
    return knobs


def describe_graph(engine) -> Dict[str, dict]:
    """A live engine's source graph: stage → its meter's snapshot and,
    where it has them, its pool width, queue bound and queue depth."""
    source = engine.source
    src_meters = getattr(source, "meters", {})
    eng_meters = getattr(engine, "ingest_meters", {})
    staged = len(getattr(source, "_staged", ()) or ())
    desc: Dict[str, dict] = {}
    for stage in STAGES:
        meter = src_meters.get(stage) or eng_meters.get(stage)
        row: Dict[str, object] = {
            "meter": meter.snapshot() if meter is not None else None,
        }
        if stage == "parse":
            row["workers"] = getattr(source, "read_workers", None)
        elif stage == "stage":
            row["queue_bound"] = getattr(source, "prefetch_batches", None)
            row["queue_depth"] = staged
        elif stage == "read":
            stats = getattr(source, "prefetch_stats", None)
            row["prefetch"] = stats() if stats is not None else None
        elif stage == "bucket":
            row["queue_bound"] = getattr(engine, "pipeline_depth", None)
            in_flight = getattr(engine, "in_flight_count", None)
            row["queue_depth"] = (in_flight() if in_flight is not None
                                  else None)
        desc[stage] = row
    return desc


def timed(meter: Optional[StageMeter], fn, *args, **kwargs):
    """Run ``fn``, recording its wall time into ``meter`` (None runs it
    bare)."""
    if meter is None:
        return fn(*args, **kwargs)
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        meter.record(time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the columnar plane
# ---------------------------------------------------------------------------


def _columnar_table(table: pa.Table, label_col: str,
                    handle_invalid: Optional[str]):
    """One in-Arrow pass over a parsed flow table: every feature column
    cast to float32, the finite mask of each, and the NaN/Inf policy
    (``drop`` filters once, ``zero`` fills per cell, ``None`` keeps every
    row for the admission step).  ``(feature arrays, names, label or
    None)``."""
    feature_names = [c for c in table.column_names if c != label_col]
    f32 = pa.float32()
    arrays: List[pa.Array] = []
    finite_masks: List[pa.Array] = []
    for name in feature_names:
        col = table[name]
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        col = pc.cast(col, f32, safe=False)  # the one cast, in Arrow
        arrays.append(col)
        if handle_invalid is not None:
            # a null from the parse (an empty or "NaN" cell) is as
            # non-finite as an Infinity
            finite_masks.append(
                pc.coalesce(pc.is_finite(col), pa.scalar(False)))
    label = table[label_col] if label_col in table.column_names else None
    if handle_invalid == "zero":
        zero = pa.scalar(0.0, f32)
        arrays = [pc.if_else(mask, col, zero)
                  for col, mask in zip(arrays, finite_masks)]
    elif handle_invalid == "drop" and finite_masks:
        valid = finite_masks[0]
        for mask in finite_masks[1:]:
            valid = pc.and_(valid, mask)
        if not pc.all(valid).as_py():
            arrays = [col.filter(valid) for col in arrays]
            if label is not None:
                label = label.filter(valid)
    return arrays, feature_names, label


def _columnar_frame(arrays, feature_names, label, label_col) -> Frame:
    cols: Dict[str, np.ndarray] = {}
    for name, col in zip(feature_names, arrays):
        # a view when the buffer allows it (float32 without nulls); a
        # column with parse-time nulls materializes once (nulls as NaN)
        try:
            cols[name] = col.to_numpy(zero_copy_only=True)
        except pa.ArrowInvalid:
            cols[name] = col.to_numpy(zero_copy_only=False)
    if label is not None:
        if isinstance(label, pa.ChunkedArray):
            label = label.combine_chunks()
        cols[label_col] = np.array(
            [normalize_label(str(v)) for v in label.to_pylist()],
            dtype=object)
    return Frame(cols)


def read_flows_columnar(
    path: str,
    label_col: str = LABEL_COLUMN,
    handle_invalid: Optional[str] = "drop",
    *,
    salvage: bool = False,
    rejects: Optional[List[dict]] = None,
) -> Frame:
    """One flow CSV → a float32 columnar Frame of views over the Arrow
    buffers.  ``handle_invalid`` ``"drop"`` / ``"zero"`` equal
    ``clean_flows`` bitwise; ``None`` keeps every row (non-finite values
    as float32 NaN/Inf) for the serve path's admission step.
    ``salvage`` and ``rejects`` go to the parser as in ``load_csv``."""
    from sntc_tpu_torch.data.ingest import load_csv_table

    if handle_invalid not in (None, "drop", "zero"):
        raise ValueError("handle_invalid must be 'drop', 'zero', or None")
    table = load_csv_table(path, salvage=salvage, rejects=rejects)
    arrays, names, label = _columnar_table(table, label_col, handle_invalid)
    return _columnar_frame(arrays, names, label, label_col)


def load_flows_columnar(
    path: str,
    pattern: str = "*.csv",
    label_col: str = LABEL_COLUMN,
    handle_invalid: Optional[str] = "drop",
    max_workers: int = 8,
) -> Frame:
    """:func:`read_flows_columnar` over a directory (``load_csv_dir`` and
    ``clean_flows`` in one parse): files parse in a small thread pool and
    concatenate in sorted-filename order."""
    paths = sorted(glob.glob(os.path.join(path, pattern)))
    if not paths:
        raise FileNotFoundError(f"no {pattern} files under {path}")

    def load(p: str) -> Frame:
        return read_flows_columnar(p, label_col=label_col,
                                   handle_invalid=handle_invalid)

    if len(paths) == 1 or max_workers <= 1:
        return Frame.concat_all([load(p) for p in paths])
    with ThreadPoolExecutor(max_workers=min(max_workers, len(paths))) as pool:
        return Frame.concat_all(list(pool.map(load, paths)))
