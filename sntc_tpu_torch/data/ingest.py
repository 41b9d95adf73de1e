"""CICIDS2017 ingest + cleaning — the CSV-source analog.

Counterpart of ``sntc_tpu/data/ingest.py`` (``load_csv``,
``load_csv_table``, ``load_csv_dir`` and ``clean_flows``): pyarrow's
CSV reader parses in the span ``ingest.parse`` (``file``: the basename),
as in the JAX package, column names are whitespace-normalized and the
duplicated ``Fwd Header Length`` of real day files is renamed ``Fwd
Header Length.1``, so real day CSVs load unchanged.
:func:`load_csv_table` stops at the Arrow table, which the columnar
plane (``data.pipeline.read_flows_columnar``) casts in Arrow;
:func:`load_csv` materializes it into a Frame.  Each parse counts into
``sntc_ingest_files_parsed_total``, ``..._rows_parsed_total`` and
``..._bytes_read_total``.

Parse errors name the file, and for a ragged line its 1-based line
number and raw text.  ``salvage=True`` excises ragged lines instead:
the clean rows parse and each excised line is recorded in ``rejects``
as ``{"file", "line", "raw", "reason", "detail"}``, the row dead
letters' parse-time half.  The raw bytes pass through the
``source.parse`` fault site (``SNTC_FAULTS=source.parse:ragged:...``).
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data.schema import (
    LABEL_COLUMN,
    REASON_RAGGED_ROW,
    normalize_feature_name,
    normalize_label,
)
from sntc_tpu_torch.obs.metrics import inc
from sntc_tpu_torch.obs.trace import span
from sntc_tpu_torch.resilience.faults import data_fault_armed, fault_data


def _parse(path: str, data: Optional[bytes], salvage: bool,
           single_thread: bool, bad: List[tuple]) -> pa.Table:
    def on_invalid_row(row) -> str:
        # row.number, pyarrow's 1-based line number, is attributed on
        # single-threaded reads only
        bad.append((row.number, row.text, row.expected_columns,
                    row.actual_columns))
        return "skip" if salvage else "error"

    return pacsv.read_csv(
        pa.BufferReader(data) if data is not None else path,
        read_options=pacsv.ReadOptions(use_threads=not single_thread),
        parse_options=pacsv.ParseOptions(invalid_row_handler=on_invalid_row),
        convert_options=pacsv.ConvertOptions(
            # the raw files spell missing/infinite rates several ways
            null_values=["", "NaN", "nan"],
        ),
    )


def load_csv(
    path: str,
    *,
    salvage: bool = False,
    rejects: Optional[List[dict]] = None,
) -> Frame:
    """Read one flow CSV with pyarrow, normalizing column names (see the
    module docs for ``salvage`` and ``rejects``)."""
    return Frame.from_arrow(load_csv_table(path, salvage=salvage,
                                           rejects=rejects))


def load_csv_table(
    path: str,
    *,
    salvage: bool = False,
    rejects: Optional[List[dict]] = None,
) -> pa.Table:
    """:func:`load_csv`'s parse layer: the normalized, deduplicated Arrow
    table before any numpy materialization, shared by the Frame path and
    the columnar plane so the two cannot drift in parse behavior."""
    if data_fault_armed("source.parse"):
        # only when a DATA fault is armed: buffer the payload so it can
        # be mutated; otherwise pyarrow streams from the path
        with open(path, "rb") as f:
            data = fault_data("source.parse", f.read())
    else:
        data = None
    bad_rows: List[tuple] = []
    try:
        with span("ingest.parse", file=os.path.basename(path)):
            table = _parse(path, data, salvage, False, bad_rows)
    except pa.ArrowInvalid as e:
        # re-parse single-threaded so the error can name the line
        located: List[tuple] = []
        try:
            _parse(path, data, salvage, True, located)
        except pa.ArrowInvalid:
            pass
        reportable = located or bad_rows
        if reportable and not salvage:
            line, text, expected, actual = reportable[-1]
            where = f"line {line}" if line is not None else "unknown line"
            raise ValueError(
                f"{path}: {where}: ragged row ({actual} fields, expected "
                f"{expected}): {text!r}"
            ) from e
        raise ValueError(f"{path}: unparsable CSV: {e}") from e
    if salvage and bad_rows and rejects is not None:
        # the parallel parse cannot attribute line numbers: one
        # single-threaded re-parse journals each excised line's place
        located = []
        _parse(path, data, salvage, True, located)
        for line, text, expected, actual in located or bad_rows:
            rejects.append({
                "file": path,
                "line": line,
                "raw": text,
                "reason": REASON_RAGGED_ROW,
                "detail": f"{actual} fields, expected {expected}",
            })
    inc("sntc_ingest_files_parsed_total")
    inc("sntc_ingest_rows_parsed_total", table.num_rows)
    try:
        inc("sntc_ingest_bytes_read_total",
            len(data) if data is not None else os.path.getsize(path))
    except OSError:
        pass  # best-effort byte accounting
    names = [normalize_feature_name(c) for c in table.column_names]
    # real MachineLearningCVE day files hold 'Fwd Header Length' TWICE;
    # pandas-style dedup (second copy -> '.1') matches the schema
    seen: dict = {}
    deduped = []
    for n in names:
        if n in seen:
            seen[n] += 1
            deduped.append(f"{n}.{seen[n]}")
        else:
            seen[n] = 0
            deduped.append(n)
    return table.rename_columns(deduped)


def load_csv_dir(
    path: str,
    pattern: str = "*.csv",
    max_workers: int = 8,
    *,
    salvage: bool = False,
    rejects: Optional[List[dict]] = None,
) -> Frame:
    """Read and concatenate every CSV of a directory (a day file each, in
    the real dataset) in sorted-filename order; files parse in a small
    thread pool (pyarrow releases the GIL).  ``salvage`` and ``rejects``
    go to each :func:`load_csv` (one shared list: ``append`` is
    atomic)."""
    paths = sorted(glob.glob(os.path.join(path, pattern)))
    if not paths:
        raise FileNotFoundError(f"no {pattern} files under {path}")

    def load(p: str) -> Frame:
        return load_csv(p, salvage=salvage, rejects=rejects)

    if len(paths) == 1 or max_workers <= 1:
        return Frame.concat_all([load(p) for p in paths])
    with ThreadPoolExecutor(max_workers=min(max_workers, len(paths))) as pool:
        return Frame.concat_all(list(pool.map(load, paths)))


def clean_flows(
    frame: Frame,
    label_col: str = LABEL_COLUMN,
    handle_invalid: str = "drop",
) -> Frame:
    """Clean a raw flow Frame: every feature column to float32, label
    strings canonicalized, and non-finite values handled by the policy
    of :data:`~sntc_tpu_torch.data.schema.CICIDS2017_CONTRACT`: a
    non-finite value in any feature column poisons exactly its row,
    which ``handle_invalid="drop"`` excises (the contract's ``salvage``)
    and ``"zero"`` keeps with the value set to the contract's
    ``fill=0.0`` (``permissive``)."""
    if handle_invalid not in ("drop", "zero"):
        raise ValueError("handle_invalid must be 'drop' or 'zero'")
    feature_cols = [c for c in frame.columns if c != label_col]
    cleaned = {}
    scalar_cols = [c for c in feature_cols if frame[c].ndim == 1]
    # one float32 block, a row per scalar feature: one cast per column
    # and one finite mask over the block
    block = np.empty((len(scalar_cols), frame.num_rows), dtype=np.float32)
    for i, name in enumerate(scalar_cols):
        np.copyto(block[i], frame[name], casting="unsafe")
    finite = np.isfinite(block)
    if handle_invalid == "zero":
        block[~finite] = 0.0
        bad_mask = np.zeros(frame.num_rows, dtype=bool)
    else:
        bad_mask = ~finite.all(axis=0)
    scalar_index = {name: i for i, name in enumerate(scalar_cols)}
    for name in feature_cols:  # the frame's column order
        i = scalar_index.get(name)
        if i is not None:
            cleaned[name] = block[i]
            continue
        # a vector feature column (already assembled)
        col = np.asarray(frame[name]).astype(np.float32, copy=True)
        invalid = ~np.isfinite(col)
        if invalid.any():
            if handle_invalid == "drop":
                bad_mask = bad_mask | invalid.any(axis=1)
            else:
                col[invalid] = 0.0
        cleaned[name] = col
    if label_col in frame:
        cleaned[label_col] = np.array(
            [normalize_label(str(l)) for l in frame[label_col]], dtype=object
        )
    out = Frame(cleaned)
    if handle_invalid == "drop" and bad_mask.any():
        out = out.filter(~bad_mask)
    return out


def cache_parquet(frame: Frame, path: str) -> str:
    """Write a cleaned Frame to Parquet (zstd): the fast-reload cache."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pq.write_table(frame.to_arrow(), path, compression="zstd")
    return path


def load_parquet(path: str, memory_map: bool = True) -> Frame:
    """Reload a cached Frame.  ``memory_map=True`` (default) maps the
    file instead of buffering it, so uncompressed column pages land as
    views over the page cache."""
    return Frame.from_arrow(pq.read_table(path, memory_map=memory_map))
