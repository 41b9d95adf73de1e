"""CICIDS2017 ingest + cleaning — the CSV-source analog.

Counterpart of ``sntc_tpu/data/ingest.py`` (``load_csv``,
``load_csv_dir`` and ``clean_flows``), without the JAX package's metrics, tracing, fault
injection and per-line salvage hooks: pyarrow's CSV reader parses, column
names are whitespace-normalized and the duplicated ``Fwd Header Length``
of real day files is renamed ``Fwd Header Length.1``, so real day CSVs
load unchanged.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data.schema import (
    LABEL_COLUMN,
    normalize_feature_name,
    normalize_label,
)


def load_csv(path: str) -> Frame:
    """Read one flow CSV with pyarrow, normalizing column names.  Parse
    errors name the offending file."""
    try:
        table = pacsv.read_csv(
            path,
            convert_options=pacsv.ConvertOptions(
                # the raw files spell missing/infinite rates several ways
                null_values=["", "NaN", "nan"],
            ),
        )
    except pa.ArrowInvalid as e:
        raise ValueError(f"{path}: unparsable CSV: {e}") from e
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
    return Frame.from_arrow(table.rename_columns(deduped))


def load_csv_dir(path: str, pattern: str = "*.csv") -> Frame:
    """Read and concatenate every CSV of a directory (a day file each, in
    the real dataset) in sorted-filename order."""
    paths = sorted(glob.glob(os.path.join(path, pattern)))
    if not paths:
        raise FileNotFoundError(f"no {pattern} files under {path}")
    return Frame.concat_all([load_csv(p) for p in paths])


def clean_flows(
    frame: Frame,
    label_col: str = LABEL_COLUMN,
    handle_invalid: str = "drop",
) -> Frame:
    """Clean a raw flow Frame: every feature column to float32,
    non-finite values drop their row (``"drop"``) or become 0
    (``"zero"``), label strings canonicalized."""
    if handle_invalid not in ("drop", "zero"):
        raise ValueError("handle_invalid must be 'drop' or 'zero'")
    feature_cols = [c for c in frame.columns if c != label_col]
    cleaned = {}
    bad_mask = np.zeros(frame.num_rows, dtype=bool)
    for name in feature_cols:
        col = np.asarray(frame[name]).astype(np.float32, copy=True)
        invalid = ~np.isfinite(col)
        if invalid.any():
            if handle_invalid == "drop":
                bad_mask |= invalid if col.ndim == 1 else invalid.any(axis=1)
            else:
                col[invalid] = 0.0
        cleaned[name] = col
    if label_col in frame:
        cleaned[label_col] = np.array(
            [normalize_label(str(l)) for l in frame[label_col]], dtype=object
        )
    out = Frame(cleaned)
    if bad_mask.any():
        out = out.filter(~bad_mask)
    return out
