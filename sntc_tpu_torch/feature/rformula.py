"""RFormula: R-style model formulas.

Counterpart of ``sntc_tpu/feature/rformula.py`` (Spark's ``RFormula``):
``label ~ term + term + ...`` where a term is a column, ``.`` (every
column but the label), an interaction ``a:b`` (the product; string
factors cross their dummy encodings), and ``- term`` removes a term
(``- 1`` is refused: the estimator's ``fitIntercept`` says that).
String columns become their frequencyDesc levels (the port's
``string_indexer._order_labels``) dummy-encoded with the LAST level
dropped (R's reference level, as Spark); numeric columns pass through; a
string label is indexed.  ``fit`` captures the encodings, ``transform``
emits ``featuresCol`` and ``labelCol``.  Host work.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param
from sntc_tpu_torch.feature.string_indexer import _order_labels


def _parse(formula: str, columns: List[str]):
    if "~" not in formula:
        raise ValueError("formula must contain '~' (label ~ terms)")
    lhs, rhs = (s.strip() for s in formula.split("~", 1))
    terms: List[str] = []
    removed: List[str] = []
    for raw in rhs.replace("-", "+-").split("+"):
        t = raw.strip()
        if not t:
            continue
        if t.startswith("-"):
            removed.append(t[1:].strip())
        elif t == ".":
            terms.extend(c for c in columns if c != lhs and c not in terms)
        elif t not in terms:  # Spark's RFormulaParser dedups (.distinct)
            terms.append(t)
    for r in removed:
        if r == "1":
            raise ValueError(
                "'- 1' (intercept suppression) is not a feature term "
                "here — set fitIntercept=False on the estimator instead"
            )
        if r not in terms:
            raise ValueError(
                f"formula removes {r!r}, which is not among the selected "
                f"terms {terms}"
            )
    terms = [t for t in terms if t not in removed]
    if not terms:
        raise ValueError(f"formula {formula!r} selects no feature terms")
    return lhs, terms


def _indices(arr, levels: List[str]) -> np.ndarray:
    """Each value's index in ``levels`` (−1: unseen), looked up once per
    distinct value."""
    vals, inv = np.unique(np.asarray(arr).astype(str), return_inverse=True)
    lut = {v: i for i, v in enumerate(levels)}
    val_idx = np.array([lut.get(str(v), -1) for v in vals], np.int64)
    return val_idx[inv]


class _RfParams:
    formula = Param("R formula: label ~ t1 + t2 + a:b + . - drop",
                    default=None)
    featuresCol = Param("output feature vector column", default="features")
    labelCol = Param("output label column", default="label")


class RFormula(_RfParams, Estimator):
    def _fit(self, frame: Frame) -> "RFormulaModel":
        if not self.getFormula():
            raise ValueError("formula must be set")
        label, terms = _parse(self.getFormula(), frame.columns)
        # per-column encodings: numeric passthrough, string -> ordered
        # category list in StringIndexer's frequencyDesc order
        encodings: Dict[str, List[str]] = {}

        def want(col: str):
            if col in encodings or col not in frame:
                return
            arr = to_host(frame[col])
            if arr.dtype.kind in "OUS":
                encodings[col] = _order_labels(arr, "frequencyDesc")

        for t in terms:
            for c in (t.split(":") if ":" in t else [t]):
                if c not in frame:
                    raise ValueError(f"formula references unknown column {c!r}")
                want(c)
        label_levels = None
        if label in frame and to_host(frame[label]).dtype.kind in "OUS":
            want(label)
            label_levels = encodings.pop(label)
        model = RFormulaModel(
            label=label, terms=terms, encodings=encodings,
            labelLevels=label_levels,
        )
        model.setParams(**self.paramValues())
        return model


class RFormulaModel(_RfParams, Model):
    def __init__(self, label: str, terms: List[str],
                 encodings: Dict[str, List[str]], labelLevels=None, **kwargs):
        super().__init__(**kwargs)
        self.label = label
        self.terms = list(terms)
        self.encodings = {k: list(v) for k, v in encodings.items()}
        self.labelLevels = list(labelLevels) if labelLevels else None

    def _save_extra(self):
        return (
            {
                "label": self.label, "terms": self.terms,
                "encodings": self.encodings,
                "labelLevels": self.labelLevels,
            },
            {},
        )

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(
            label=extra["label"], terms=extra["terms"],
            encodings=extra["encodings"],
            labelLevels=extra["labelLevels"],
        )
        m.setParams(**params)
        return m

    def _column_block(self, frame: Frame, col: str) -> np.ndarray:
        """[N, w] numeric block for one column: passthrough or dummies
        (last reference level dropped, R/Spark convention)."""
        arr = to_host(frame[col])
        levels = self.encodings.get(col)
        if levels is None:
            return np.asarray(arr, np.float32).reshape(len(arr), -1)
        idx = _indices(arr, levels)
        if (idx < 0).any():
            raise ValueError(
                f"unseen category in column {col!r} at transform"
            )
        out = np.zeros((len(arr), max(len(levels) - 1, 1)), np.float32)
        keep = idx < len(levels) - 1
        out[np.nonzero(keep)[0], idx[keep]] = 1.0
        return out

    def transform(self, frame: Frame) -> Frame:
        blocks = []
        for t in self.terms:
            if ":" in t:
                parts = [self._column_block(frame, c) for c in t.split(":")]
                cross = parts[0]
                for p in parts[1:]:
                    # full interaction: outer product per row
                    cross = (
                        cross[:, :, None] * p[:, None, :]
                    ).reshape(len(p), -1)
                blocks.append(cross)
            else:
                blocks.append(self._column_block(frame, t))
        X = np.concatenate(blocks, axis=1).astype(np.float32)
        out = frame.with_column(self.getFeaturesCol(), X)
        if self.label in frame:
            y = to_host(frame[self.label])
            if self.labelLevels is not None:
                y = _indices(y, self.labelLevels).astype(np.float64)
                if (y < 0).any():
                    raise ValueError("unseen label value at transform")
            else:
                y = np.asarray(y, np.float64)
            out = out.with_column(self.getLabelCol(), y)
        return out
