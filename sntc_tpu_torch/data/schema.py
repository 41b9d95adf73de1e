"""CICIDS2017 flow schema — column names, label vocabulary, name
normalization, and the :class:`SchemaContract` of row admission.

Counterpart of ``sntc_tpu/data/schema.py`` (the port keeps its own copy):
78 numeric flow features + a 15-value label column, feature names as the
CICFlowMeter export writes them (whitespace normalized by the ingest
layer).

**Schema contracts**: the serve path admits rows through an explicit
per-column contract.  A :class:`SchemaContract` declares dtype and arity
plus NaN/Inf/range/domain policies per column and admits a Frame in one
of three modes:

* ``strict`` — any violation raises :class:`SchemaViolation` (the whole
  batch fails; the engine's poison-batch machinery takes over);
* ``salvage`` — valid rows proceed, poison rows are excised through a
  row-validity mask (the batch keeps its shape, so the shape-bucketed
  dispatch sees no new shape);
* ``permissive`` — per-value coercion first (numeric strings parse,
  non-finite values take the column's ``fill``), then salvage of what is
  still poison.

:data:`CICIDS2017_CONTRACT` is the contract of the 78-column flow schema;
``clean_flows`` (training-time cleaning) is the same policy:
``handle_invalid="drop"`` is ``salvage``, ``"zero"`` is ``permissive``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

CICIDS2017_FEATURES: List[str] = [
    "Destination Port",
    "Flow Duration",
    "Total Fwd Packets",
    "Total Backward Packets",
    "Total Length of Fwd Packets",
    "Total Length of Bwd Packets",
    "Fwd Packet Length Max",
    "Fwd Packet Length Min",
    "Fwd Packet Length Mean",
    "Fwd Packet Length Std",
    "Bwd Packet Length Max",
    "Bwd Packet Length Min",
    "Bwd Packet Length Mean",
    "Bwd Packet Length Std",
    "Flow Bytes/s",
    "Flow Packets/s",
    "Flow IAT Mean",
    "Flow IAT Std",
    "Flow IAT Max",
    "Flow IAT Min",
    "Fwd IAT Total",
    "Fwd IAT Mean",
    "Fwd IAT Std",
    "Fwd IAT Max",
    "Fwd IAT Min",
    "Bwd IAT Total",
    "Bwd IAT Mean",
    "Bwd IAT Std",
    "Bwd IAT Max",
    "Bwd IAT Min",
    "Fwd PSH Flags",
    "Bwd PSH Flags",
    "Fwd URG Flags",
    "Bwd URG Flags",
    "Fwd Header Length",
    "Bwd Header Length",
    "Fwd Packets/s",
    "Bwd Packets/s",
    "Min Packet Length",
    "Max Packet Length",
    "Packet Length Mean",
    "Packet Length Std",
    "Packet Length Variance",
    "FIN Flag Count",
    "SYN Flag Count",
    "RST Flag Count",
    "PSH Flag Count",
    "ACK Flag Count",
    "URG Flag Count",
    "CWE Flag Count",
    "ECE Flag Count",
    "Down/Up Ratio",
    "Average Packet Size",
    "Avg Fwd Segment Size",
    "Avg Bwd Segment Size",
    "Fwd Header Length.1",
    "Fwd Avg Bytes/Bulk",
    "Fwd Avg Packets/Bulk",
    "Fwd Avg Bulk Rate",
    "Bwd Avg Bytes/Bulk",
    "Bwd Avg Packets/Bulk",
    "Bwd Avg Bulk Rate",
    "Subflow Fwd Packets",
    "Subflow Fwd Bytes",
    "Subflow Bwd Packets",
    "Subflow Bwd Bytes",
    "Init_Win_bytes_forward",
    "Init_Win_bytes_backward",
    "act_data_pkt_fwd",
    "min_seg_size_forward",
    "Active Mean",
    "Active Std",
    "Active Max",
    "Active Min",
    "Idle Mean",
    "Idle Std",
    "Idle Max",
    "Idle Min",
]

NUM_FEATURES = len(CICIDS2017_FEATURES)
assert NUM_FEATURES == 78, NUM_FEATURES

LABEL_COLUMN = "Label"

#: the 15 CICIDS2017 classes: benign + 14 attack types (SURVEY.md §0.1)
CICIDS2017_LABELS: List[str] = [
    "BENIGN",
    "DoS Hulk",
    "PortScan",
    "DDoS",
    "DoS GoldenEye",
    "FTP-Patator",
    "SSH-Patator",
    "DoS slowloris",
    "DoS Slowhttptest",
    "Bot",
    "Web Attack - Brute Force",
    "Web Attack - XSS",
    "Infiltration",
    "Web Attack - Sql Injection",
    "Heartbleed",
]
assert len(CICIDS2017_LABELS) == 15

#: approximate class priors of the real dataset (benign-heavy imbalance);
#: used by the synthetic generator so imbalance behavior is exercised.
CLASS_PRIORS: Dict[str, float] = {
    "BENIGN": 0.803,
    "DoS Hulk": 0.0816,
    "PortScan": 0.0561,
    "DDoS": 0.0452,
    "DoS GoldenEye": 0.00364,
    "FTP-Patator": 0.00280,
    "SSH-Patator": 0.00208,
    "DoS slowloris": 0.00205,
    "DoS Slowhttptest": 0.00194,
    "Bot": 0.000694,
    "Web Attack - Brute Force": 0.000532,
    "Web Attack - XSS": 0.000230,
    "Infiltration": 0.0000127,
    "Web Attack - Sql Injection": 0.0000074,
    "Heartbleed": 0.0000039,
}

#: raw-CSV label spellings seen in the wild (en-dash mojibake etc.) -> canonical
LABEL_ALIASES: Dict[str, str] = {
    "Web Attack \x96 Brute Force": "Web Attack - Brute Force",
    "Web Attack – Brute Force": "Web Attack - Brute Force",
    "Web Attack \x96 XSS": "Web Attack - XSS",
    "Web Attack – XSS": "Web Attack - XSS",
    "Web Attack \x96 Sql Injection": "Web Attack - Sql Injection",
    "Web Attack – Sql Injection": "Web Attack - Sql Injection",
}


def normalize_feature_name(name: str) -> str:
    """Strip the erratic leading/trailing whitespace of raw CICIDS2017 CSVs."""
    return name.strip()


def normalize_label(label: str) -> str:
    label = label.strip()
    return LABEL_ALIASES.get(label, label)


# ---------------------------------------------------------------------------
# schema contracts: row admission
# ---------------------------------------------------------------------------

#: machine-readable reason codes carried by rejects, dead-letter rows,
#: and :class:`SchemaViolation`.
#: The parser layer contributes ``ragged_row`` (CSV line with the wrong
#: field count), ``unparsable_file`` (a file no salvage can read), and
#: ``truncated`` (binary capture cut mid-record).
REASON_MISSING_COLUMN = "missing_column"
REASON_BAD_ARITY = "bad_arity"
REASON_NOT_NUMERIC = "not_numeric"
REASON_NON_FINITE = "non_finite"
REASON_OUT_OF_RANGE = "out_of_range"
REASON_OUT_OF_DOMAIN = "out_of_domain"
REASON_RAGGED_ROW = "ragged_row"
REASON_UNPARSABLE_FILE = "unparsable_file"
REASON_TRUNCATED = "truncated"

ADMISSION_MODES = ("strict", "salvage", "permissive")


class SchemaViolation(ValueError):
    """A batch violated its :class:`SchemaContract` in a way the active
    mode does not repair row-by-row: any violation under ``strict``, or
    a batch-granular defect (missing column, wrong column rank) under
    every mode.  ``reasons`` is a machine-readable list of
    ``{"column", "reason", "count"}`` dicts."""

    def __init__(self, reasons: List[dict]):
        self.reasons = reasons
        parts = ", ".join(
            f"{r['column']}: {r['reason']} x{r.get('count', 1)}"
            for r in reasons[:8]
        )
        more = f" (+{len(reasons) - 8} more)" if len(reasons) > 8 else ""
        super().__init__(f"schema contract violated — {parts}{more}")


@dataclass(frozen=True)
class ColumnSpec:
    """Per-column expectations: dtype/arity plus NaN/Inf/range/domain
    policy.  ``fill`` is the permissive-mode replacement for values that
    are non-finite (or unparsable text) — ``None`` means such values
    stay row-poison even under ``permissive``."""

    dtype: str = "float32"  # numpy dtype name, or "str" for text columns
    arity: int = 1  # column rank: 1 = scalar, 2 = fixed-width vector
    allow_nan: bool = False
    allow_inf: bool = False
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    domain: Optional[Tuple[str, ...]] = None  # allowed values (text cols)
    fill: Optional[float] = None

    @property
    def is_text(self) -> bool:
        return self.dtype == "str"


def _truncate_repr(value, limit: int = 120) -> str:
    if isinstance(value, np.generic):
        value = value.item()  # 'nan', not 'np.float64(nan)'
    text = repr(value)
    return text if len(text) <= limit else text[: limit - 3] + "..."


@dataclass
class AdmissionResult:
    """Outcome of :meth:`SchemaContract.admit` in a row-granular mode.

    ``frame`` keeps the input's SHAPE: contract columns are cast to
    their declared dtypes, coercions applied, and every excised row's
    values replaced with a copy of a surviving row (so downstream
    device compute stays numerically in-domain — as bucket padding
    repeats the last row).  ``valid`` marks the
    rows that really belong in the output; ``rejects`` carries one
    record per excised row with its first violation; ``coerced`` counts
    values permissive mode repaired in place."""

    frame: "object"
    valid: np.ndarray
    rejects: List[dict] = field(default_factory=list)
    coerced: int = 0

    @property
    def num_rejected(self) -> int:
        return int(self.valid.size - np.count_nonzero(self.valid))


@dataclass(frozen=True)
class SchemaContract:
    """Declarative admission contract for a Frame (see module docs).

    ``require_all=True`` makes a missing contract column a batch-level
    :class:`SchemaViolation` in every mode (absence cannot be salvaged
    row-by-row); ``allow_extra=True`` lets columns outside the contract
    (labels, engine bookkeeping) pass through untouched."""

    columns: Dict[str, ColumnSpec]
    mode: str = "strict"
    require_all: bool = True
    allow_extra: bool = True

    def __post_init__(self):
        if self.mode not in ADMISSION_MODES:
            raise ValueError(
                f"mode must be one of {ADMISSION_MODES}, got {self.mode!r}"
            )

    def with_mode(self, mode: str) -> "SchemaContract":
        """The same contract under a different admission mode (the CLI
        arms one canonical contract with ``--row-policy``)."""
        if mode == self.mode:
            return self
        return replace(self, mode=mode)

    # -- per-column checking ------------------------------------------------

    def _numeric_values(
        self, name: str, col: np.ndarray, mode: str,
        cell_reasons: Dict[int, Tuple[str, str]],
    ) -> Tuple[np.ndarray, int]:
        """Float64 working copy of a TEXT contract column plus the
        number of values that required repair/parsing (native numeric
        columns never reach this — ``admit`` validates them in place,
        copy-free).  Text cells are parsed where possible (reading
        "1.5" is not mutation) and the rest are NaN-marked with a
        ``not_numeric`` reason — ``permissive`` additionally repairs
        those with the declared fill."""
        values = np.full(col.shape[0], np.nan, np.float64)
        for i, raw in enumerate(col):
            try:
                values[i] = float(raw)
            except (TypeError, ValueError):
                cell_reasons.setdefault(
                    i, (REASON_NOT_NUMERIC, _truncate_repr(raw))
                )
        # parsing text is only COUNTED as coercion under permissive —
        # salvage/strict read numeric strings without claiming a repair.
        # Count FINITE parses only: a cell that parsed to NaN/Inf is the
        # bulk non-finite repair's to count (once), not ours
        coerced = (
            int(np.count_nonzero(np.isfinite(values)))
            if mode == "permissive"
            else 0
        )
        if mode == "permissive":
            # unparsable text is repairable when the column declares a
            # fill — the cell takes it and the row survives
            spec = self.columns[name]
            if spec.fill is not None:
                for i in list(cell_reasons):
                    if cell_reasons[i][0] == REASON_NOT_NUMERIC:
                        values[i] = spec.fill
                        del cell_reasons[i]
                        coerced += 1
        return values, coerced

    # -- admission ----------------------------------------------------------

    def admit(self, frame, mode: Optional[str] = None) -> AdmissionResult:
        """Validate ``frame`` against the contract.

        ``strict``: raises :class:`SchemaViolation` on ANY violation
        (current engine machinery then treats the batch as poison).
        ``salvage``/``permissive``: returns an :class:`AdmissionResult`
        whose frame has the input's shape and whose ``valid`` mask
        excises the poison rows — ride it through the shape-bucketed
        predict path and the dispatch never sees a new shape.
        Batch-granular defects (missing column, wrong rank) raise in
        every mode."""
        mode = mode or self.mode
        if mode not in ADMISSION_MODES:
            raise ValueError(
                f"mode must be one of {ADMISSION_MODES}, got {mode!r}"
            )
        batch_problems: List[dict] = []
        for name, spec in self.columns.items():
            if name not in frame:
                if self.require_all:
                    batch_problems.append(
                        {"column": name, "reason": REASON_MISSING_COLUMN,
                         "count": 1}
                    )
                continue
            if frame[name].ndim != spec.arity:
                batch_problems.append(
                    {"column": name, "reason": REASON_BAD_ARITY,
                     "count": 1,
                     "detail": f"rank {frame[name].ndim} != {spec.arity}"}
                )
        if batch_problems:
            raise SchemaViolation(batch_problems)

        n = frame.num_rows
        valid = np.ones(n, dtype=bool)
        # row -> (column, reason, value-repr): the FIRST violation wins
        row_reasons: Dict[int, Tuple[str, str, str]] = {}
        coerced_total = 0
        out_cols: Dict[str, np.ndarray] = {}

        for name, spec in self.columns.items():
            if name not in frame:
                continue  # require_all=False tolerated absence
            col = frame[name]
            if not isinstance(col, np.ndarray):
                from sntc_tpu_torch.core.frame import to_host

                col = to_host(col)
            if spec.is_text:
                text = np.array([str(v) for v in col], dtype=object)
                if spec.domain is not None:
                    domain = frozenset(spec.domain)
                    for i, v in enumerate(text):
                        if v not in domain:
                            row_reasons.setdefault(
                                i, (name, REASON_OUT_OF_DOMAIN,
                                    _truncate_repr(v)),
                            )
                            valid[i] = False
                out_cols[name] = text
                continue

            cell_reasons: Dict[int, Tuple[str, str]] = {}
            if col.dtype.kind in "fiub":
                # native numeric column: validate IN PLACE — no working
                # copy, so an all-clean batch (the hot-path common case)
                # costs one vectorized scan per column and zero copies
                flat = col
            else:
                flat, coerced_here = self._numeric_values(
                    name, col, mode, cell_reasons
                )
                coerced_total += coerced_here
            if flat.dtype.kind == "f":
                nan_mask = np.isnan(flat)
                inf_mask = np.isinf(flat)
            else:  # integer/bool columns cannot hold NaN/Inf
                nan_mask = np.zeros(flat.shape, dtype=bool)
                inf_mask = nan_mask
            if mode == "permissive" and spec.fill is not None:
                # _numeric_values already repaired unparsable text under
                # this configuration, so every remaining NaN/Inf is a
                # genuinely non-finite value — repairable in bulk
                repair = np.zeros(flat.shape, dtype=bool)
                if not spec.allow_nan:
                    repair |= nan_mask
                if not spec.allow_inf:
                    repair |= inf_mask
                if repair.any():
                    coerced_total += int(np.count_nonzero(repair))
                    flat = np.where(
                        repair, flat.dtype.type(spec.fill), flat
                    )
                    nan_mask = np.isnan(flat)
                    inf_mask = np.isinf(flat)
            bad = np.zeros(flat.shape, dtype=bool)
            if not spec.allow_nan:
                bad |= nan_mask
            if not spec.allow_inf:
                bad |= inf_mask
            finite = ~(nan_mask | inf_mask)
            if spec.min_value is not None:
                bad |= finite & (flat < spec.min_value)
            if spec.max_value is not None:
                bad |= finite & (flat > spec.max_value)
            bad_rows = bad.any(axis=-1) if bad.ndim > 1 else bad
            for i in np.flatnonzero(bad_rows):
                i = int(i)
                if i in cell_reasons:
                    reason, shown = cell_reasons[i]
                else:
                    if spec.arity == 1:
                        v = flat[i]
                    else:
                        v = flat[i][
                            int(np.flatnonzero(bad[i])[0])
                        ]
                    reason = (
                        REASON_NON_FINITE
                        if not np.isfinite(v)
                        else REASON_OUT_OF_RANGE
                    )
                    shown = _truncate_repr(v)
                row_reasons.setdefault(i, (name, reason, shown))
            for i in cell_reasons:  # unparsable text NOT caught above
                reason, shown = cell_reasons[i]
                row_reasons.setdefault(i, (name, reason, shown))
            valid &= ~bad_rows
            for i in cell_reasons:
                valid[i] = False
            target = np.dtype(spec.dtype)
            out_arr = (
                flat if flat.dtype == target
                else flat.astype(target, copy=False)
            )
            if out_arr is not col:  # unchanged columns stay shared
                out_cols[name] = out_arr

        if mode == "strict" and row_reasons:
            per_column: Dict[Tuple[str, str], int] = {}
            for col_name, reason, _ in row_reasons.values():
                key = (col_name, reason)
                per_column[key] = per_column.get(key, 0) + 1
            raise SchemaViolation(
                [
                    {"column": c, "reason": r, "count": k}
                    for (c, r), k in sorted(per_column.items())
                ]
            )

        out = frame
        for name, arr in out_cols.items():
            out = out.with_column(name, arr)
        rejects = [
            {
                "row": int(i),
                "column": col_name,
                "reason": reason,
                "value": shown,
            }
            for i, (col_name, reason, shown) in sorted(row_reasons.items())
        ]
        if not valid.all():
            # neutralize excised rows: copy a surviving row over them so
            # the (shape-preserving) dispatch stays numerically in-domain
            out = out.fill_invalid_rows(valid)
        return AdmissionResult(
            frame=out, valid=valid, rejects=rejects, coerced=coerced_total
        )


#: The canonical CICIDS2017 admission contract: all 78 flow features
#: are finite float32 scalars; non-finite values (the infamous
#: ``Flow Bytes/s``/``Flow Packets/s`` Infinity/NaN cells) are poison,
#: repairable with 0.0 under ``permissive``.  ``clean_flows`` is
#: defined against this constant — training-time cleaning
#: (``handle_invalid="drop"``/``"zero"``) and serve-time admission
#: (``salvage``/``permissive``) are the SAME policy at two call sites
#: (tests assert the equivalence row-for-row).
CICIDS2017_CONTRACT = SchemaContract(
    columns={
        name: ColumnSpec(dtype="float32", fill=0.0)
        for name in CICIDS2017_FEATURES
    },
    mode="salvage",
)
