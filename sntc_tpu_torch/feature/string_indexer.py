"""StringIndexer / IndexToString — label string <-> index encoding.

Counterpart of ``sntc_tpu/feature/string_indexer.py`` (Spark's
``StringIndexer``): the fit orders the vocabulary — by default
``frequencyDesc``, descending frequency with ties broken by the string
ascending, exactly as the JAX package; the fitted model maps strings to
float64 indices in that order, ``handleInvalid`` is ``error`` | ``skip``
(drop unseen rows) | ``keep`` (unseen -> index ``len(labels)``);
``IndexToString`` maps a prediction index back to its label.  All run on
the host.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np

from sntc_tpu_torch.core.base import Estimator, Model, Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators


def _order_labels(values: np.ndarray, order: str) -> List[str]:
    counts = Counter(str(v) for v in values)
    if order == "frequencyDesc":
        return [l for l, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))]
    if order == "frequencyAsc":
        return [l for l, _ in sorted(counts.items(), key=lambda kv: (kv[1], kv[0]))]
    if order == "alphabetDesc":
        return sorted(counts, reverse=True)
    if order == "alphabetAsc":
        return sorted(counts)
    raise ValueError(f"unknown stringOrderType {order!r}")


class _StringIndexerParams:
    inputCol = Param("input string column", default="label")
    outputCol = Param("output index column", default="labelIndex")
    inputCols = Param(
        "multi-column mode (Spark 3.0): input columns", default=None
    )
    outputCols = Param(
        "multi-column mode: output columns (same length)", default=None
    )
    stringOrderType = Param(
        "label ordering: frequencyDesc | frequencyAsc | alphabetDesc | alphabetAsc",
        default="frequencyDesc",
        validator=validators.one_of(
            "frequencyDesc", "frequencyAsc", "alphabetDesc", "alphabetAsc"
        ),
    )
    handleInvalid = Param(
        "unseen labels at transform: error | skip | keep",
        default="error",
        validator=validators.one_of("error", "skip", "keep"),
    )


def _resolve_cols(stage) -> tuple:
    """(ins, outs) for single- or multi-column mode (exactly one of
    inputCol/inputCols drives)."""
    multi_in = stage.getInputCols()
    if multi_in:
        outs = stage.getOutputCols()
        if not outs or len(outs) != len(multi_in):
            raise ValueError(
                "outputCols must be set and match inputCols in length"
            )
        return list(multi_in), list(outs)
    return [stage.getInputCol()], [stage.getOutputCol()]


def _index_values(values: np.ndarray, labels: List[str]):
    """Vocabulary lookup through one hash-factorize of the column.
    Returns ``(indices f64 with len(labels) marking unseen, bad mask)``."""
    import pandas as pd

    unseen_idx = float(len(labels))
    if values.dtype == object:
        # NA-ish values (None, nan) index by their str() form, as the fit
        # saw them — factorize would collapse None into the NaN unique
        na = pd.isna(values)
        if na.any():
            values = values.copy()
            values[na] = np.array([str(v) for v in values[na]], dtype=object)
    codes, uniques = pd.factorize(values, use_na_sentinel=False)
    index = {l: float(i) for i, l in enumerate(labels)}
    lut = np.array(
        [index.get(str(u), unseen_idx) for u in uniques], dtype=np.float64
    )
    out = lut[codes] if len(lut) else np.full(len(codes), unseen_idx)
    return values, out, out == unseen_idx


class StringIndexer(_StringIndexerParams, Estimator):
    def _fit(self, frame: Frame) -> "StringIndexerModel":
        ins, _ = _resolve_cols(self)
        order = self.getStringOrderType()
        labels_array = [_order_labels(to_host(frame[c]), order) for c in ins]
        model = StringIndexerModel(labelsArray=labels_array)
        model.setParams(**self.paramValues())
        return model


class StringIndexerModel(_StringIndexerParams, Model):
    def __init__(self, labels: List[str] = None, labelsArray=None, **kwargs):
        super().__init__(**kwargs)
        if labelsArray is None:
            labelsArray = [list(labels or [])]
        self.labelsArray = [list(ls) for ls in labelsArray]

    @property
    def labels(self) -> List[str]:
        return self.labelsArray[0]

    def _save_extra(self):
        return {"labelsArray": self.labelsArray}, {}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        if "labelsArray" in extra:
            m = cls(labelsArray=extra["labelsArray"])
        else:  # models persisted before multi-column support
            m = cls(labels=extra["labels"])
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        ins, outs = _resolve_cols(self)
        if len(ins) != len(self.labelsArray):
            raise ValueError(
                f"model was fitted on {len(self.labelsArray)} columns, "
                f"transform asked for {len(ins)}"
            )
        mode = self.getHandleInvalid()
        results, bad_any = [], np.zeros(frame.num_rows, bool)
        for c, labels in zip(ins, self.labelsArray):
            values, out, bad = _index_values(to_host(frame[c]), labels)
            if bad.any() and mode == "error":
                unseen = sorted({str(v) for v in np.asarray(values)[bad]})
                raise ValueError(
                    f"StringIndexer: unseen labels {unseen} in column "
                    f"{c!r} (handleInvalid='error')"
                )
            results.append(out)
            bad_any |= bad
        if mode == "skip" and bad_any.any():
            keep = ~bad_any  # a row with any unseen value is dropped
            frame = frame.filter(keep)
            results = [r[keep] for r in results]
        for name, out in zip(outs, results):
            frame = frame.with_column(name, out)
        return frame


class IndexToString(Transformer):
    """Inverse map: index column -> label strings."""

    inputCol = Param("input index column", default="prediction")
    outputCol = Param("output string column", default="predictedLabel")
    labels = Param("label vocabulary, index order")

    def transform(self, frame: Frame) -> Frame:
        labels = self.getLabels()
        idx = to_host(frame[self.getInputCol()]).astype(np.int64)
        if (idx < 0).any() or (idx >= len(labels)).any():
            raise ValueError("IndexToString: index out of label range")
        out = np.asarray(labels, dtype=object)[idx]
        return frame.with_column(self.getOutputCol(), out)
