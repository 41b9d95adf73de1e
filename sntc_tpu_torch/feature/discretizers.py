"""Bucketizer / QuantileDiscretizer / Imputer.

Counterpart of ``sntc_tpu/feature/discretizers.py`` (Spark's stages of
the same names):

  * Bucketizer: a scalar column mapped to float64 bucket indices by
    explicit ``splits`` (len >= 3, strictly increasing, ±inf allowed);
    buckets are ``[s_i, s_{i+1})`` with the last one closed.
    ``handleInvalid`` governs NaN only: error (default) / keep (an extra
    bucket) / skip; a value outside ``[splits[0], splits[-1]]`` always
    raises.  Multi-column mode: ``inputCols``/``outputCols``/
    ``splitsArray``.
  * QuantileDiscretizer: fit learns ``numBuckets`` quantile splits of the
    column on the host (``np.quantile``, duplicates collapsed, open
    ends) and returns a Bucketizer.
  * Imputer: fit learns each column's mean, median or mode of the
    non-missing values; transform replaces ``missingValue`` (default
    NaN) with it.

The fits and Imputer are host column work, as in the JAX package (a
tensor column is read back first).  Bucketizer runs where its input
lives: a numpy column on the host (:func:`_bucketize`, the JAX
package's), a tensor column on its device (:func:`bucketize_tensor`:
``torch.searchsorted(..., right=True)`` with the host's last-edge and
NaN rules; a NaN's verdict, and an out-of-range value's, is one read
back).  In ``keep`` mode with open ends no value can raise, and the
fused segment (``fuse.registry``) runs :func:`bucketize_tensor` with no
read at all.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.feature.encoders import const_on
from sntc_tpu_torch.utils.profiling import record_movement


def _missing_mask(v: np.ndarray, mv: float) -> np.ndarray:
    """True where a value counts as missing: Imputer's fit (complement)
    and transform share it."""
    return np.isnan(v) if np.isnan(mv) else (v == mv) | np.isnan(v)


def _out_of_range_error(what: str, splits) -> ValueError:
    return ValueError(
        f"{what}: value outside the splits range "
        f"[{splits[0]}, {splits[-1]}] (use -inf/+inf end splits for "
        "open-ended buckets)"
    )


def _nan_error(what: str) -> ValueError:
    return ValueError(
        f"{what}: NaN values in the input column (set "
        "handleInvalid='keep' or 'skip')"
    )


def _bucketize(
    values: np.ndarray, splits: np.ndarray, handle_invalid: str, what: str
):
    """(indices f64, keep-mask) under Spark Bucketizer semantics: buckets
    are [s_i, s_{i+1}) with the LAST bucket closed on the right;
    ``handleInvalid`` applies to NaN only, and out-of-range values
    always raise."""
    n_buckets = len(splits) - 1
    idx = np.searchsorted(splits, values, side="right") - 1.0
    idx = np.where(values == splits[-1], n_buckets - 1.0, idx)
    nan = np.isnan(values)
    out_of_range = (~nan) & ((values < splits[0]) | (values > splits[-1]))
    if out_of_range.any():
        raise _out_of_range_error(what, splits)
    if nan.any():
        if handle_invalid == "error":
            raise _nan_error(what)
        if handle_invalid == "keep":
            return np.where(nan, float(n_buckets), idx), None
        return idx, ~nan  # skip
    return idx, None


def bucketize_tensor(v: torch.Tensor, splits_t: torch.Tensor,
                     last: float) -> torch.Tensor:
    """Float64 bucket indices of ``v`` on its device, NaN in the extra
    bucket: the host's ``searchsorted(side="right") - 1``, the last
    edge's value in the last bucket.  ``last`` is ``splits[-1]``."""
    v = v.to(torch.float64).contiguous()
    n_buckets = splits_t.numel() - 1
    idx = torch.searchsorted(splits_t, v, right=True).to(torch.float64) - 1.0
    idx = torch.where(v == last, torch.full_like(idx, n_buckets - 1.0), idx)
    return torch.where(torch.isnan(v), torch.full_like(idx, n_buckets), idx)


class Bucketizer(Model):
    """Explicit-splits binning, stateless (a Model so QuantileDiscretizer
    can return it from fit, as Spark does)."""

    inputCol = Param("input scalar column", default="input")
    outputCol = Param("output bucket-index column", default="bucketed")
    inputCols = Param("multi-column mode: input columns", default=None)
    outputCols = Param("multi-column mode: output columns", default=None)
    splitsArray = Param(
        "multi-column mode: one splits list per input column", default=None
    )
    splits = Param(
        "strictly-increasing bucket boundaries (len >= 3; use -inf/+inf "
        "for open ends)",
        default=None,
    )
    handleInvalid = Param(
        "NaN handling: error | keep (extra bucket) | skip (drop rows); "
        "out-of-range values always error (Spark semantics)",
        default="error",
        validator=validators.one_of("error", "keep", "skip"),
    )

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._on = {}

    @staticmethod
    def _check_splits(s, what: str) -> np.ndarray:
        if s is None or len(s) < 3:
            raise ValueError(f"{what} must have at least 3 boundaries")
        arr = np.asarray(s, np.float64)
        if not np.all(np.diff(arr) > 0):
            raise ValueError(f"{what} must be strictly increasing")
        return arr

    def _splits(self) -> np.ndarray:
        return self._check_splits(self.getSplits(), "splits")

    def splits_on(self, splits: np.ndarray, device) -> torch.Tensor:
        return const_on(self._on, splits, device)

    def _bucketize_device(self, v: torch.Tensor, splits: np.ndarray,
                          mode: str):
        """:func:`_bucketize` of a tensor column on its device: the
        indices, and the keep-mask (host) in ``skip`` mode.  Whether any
        value is out of range or NaN is one read back, made only when
        either can change the result."""
        v64 = v.to(torch.float64)
        idx = bucketize_tensor(v64, self.splits_on(splits, v.device),
                               float(splits[-1]))
        closed = not (np.isneginf(splits[0]) and np.isposinf(splits[-1]))
        if not closed and mode == "keep":
            return idx, None
        nan = torch.isnan(v64)
        bad = (~nan) & ((v64 < splits[0]) | (v64 > splits[-1]))
        any_bad, any_nan = (bool(b) for b in torch.stack(
            [bad.any(), nan.any()]).cpu())
        record_movement(syncs=1)
        if any_bad:
            raise _out_of_range_error("Bucketizer", splits)
        if any_nan:
            if mode == "error":
                raise _nan_error("Bucketizer")
            if mode == "skip":
                keep = ~nan.cpu().numpy()
                record_movement(syncs=1)
                return idx, keep
        return idx, None

    def transform(self, frame: Frame) -> Frame:
        multi = self.getInputCols()
        if multi:
            outs = self.getOutputCols()
            sa = self.getSplitsArray()
            if not outs or len(outs) != len(multi):
                raise ValueError(
                    "outputCols must be set and match inputCols in length"
                )
            if not sa or len(sa) != len(multi):
                raise ValueError(
                    "splitsArray must be set and match inputCols in length"
                )
            triples = [
                (c, o, self._check_splits(s, f"splitsArray[{i}]"))
                for i, (c, o, s) in enumerate(zip(multi, outs, sa))
            ]
        else:
            triples = [(self.getInputCol(), self.getOutputCol(),
                        self._splits())]
        mode = self.getHandleInvalid()
        keep_all = None
        results = []
        for c, o, splits in triples:
            col = frame[c]
            if isinstance(col, torch.Tensor):
                idx, keep = self._bucketize_device(col, splits, mode)
            else:
                values = np.asarray(col, np.float64)
                idx, keep = _bucketize(values, splits, mode, "Bucketizer")
            results.append((o, idx))
            if keep is not None:
                keep_all = keep if keep_all is None else (keep_all & keep)
        for o, idx in results:
            frame = frame.with_column(o, idx)
        if keep_all is not None:
            # skip: a row drops when ANY bucketized column is NaN (Spark)
            frame = frame.filter(keep_all)
        return frame


class QuantileDiscretizer(Estimator):
    inputCol = Param("input scalar column", default="input")
    outputCol = Param("output bucket-index column", default="bucketed")
    inputCols = Param("multi-column mode: input columns", default=None)
    outputCols = Param("multi-column mode: output columns", default=None)
    numBuckets = Param(
        "number of quantile buckets", default=2, validator=validators.gt(1)
    )
    handleInvalid = Param(
        "out-of-range/NaN handling: error | keep | skip",
        default="error",
        validator=validators.one_of("error", "keep", "skip"),
    )

    @staticmethod
    def _column_splits(frame: Frame, col: str, n_buckets: int):
        values = to_host(frame[col]).astype(np.float64)
        values = values[~np.isnan(values)]
        if values.size == 0:
            raise ValueError(
                f"QuantileDiscretizer: column {col!r} has no non-NaN "
                "values to fit quantiles on"
            )
        qs = np.linspace(0.0, 1.0, n_buckets + 1)[1:-1]
        inner = np.unique(np.quantile(values, qs))
        return [float(v) for v in
                np.concatenate([[-np.inf], inner, [np.inf]])]

    def _fit(self, frame: Frame) -> "Bucketizer":
        n_buckets = self.getNumBuckets()
        multi = self.getInputCols()
        if multi:
            outs = self.getOutputCols()
            if not outs or len(outs) != len(multi):
                raise ValueError(
                    "outputCols must be set and match inputCols in length"
                )
            return Bucketizer(
                inputCols=list(multi), outputCols=list(outs),
                splitsArray=[
                    self._column_splits(frame, c, n_buckets) for c in multi
                ],
                handleInvalid=self.getHandleInvalid(),
            )
        return Bucketizer(
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol(),
            splits=self._column_splits(
                frame, self.getInputCol(), n_buckets
            ),
            handleInvalid=self.getHandleInvalid(),
        )


class _ImputerParams:
    inputCols = Param("input scalar columns", default=None)
    outputCols = Param("output columns (same length)", default=None)
    strategy = Param(
        "mean | median | mode (Spark 3.1; mode ties -> smallest value)",
        default="mean",
        validator=validators.one_of("mean", "median", "mode"),
    )
    missingValue = Param(
        "the value treated as missing (NaN compares by isnan)",
        default=float("nan"),
    )


class Imputer(_ImputerParams, Estimator):
    def _cols(self):
        ins = self.getInputCols()
        outs = self.getOutputCols()
        if not ins:
            raise ValueError("inputCols is required")
        outs = outs or ins
        if len(ins) != len(outs):
            raise ValueError("inputCols and outputCols lengths differ")
        return ins, outs

    def _fit(self, frame: Frame) -> "ImputerModel":
        ins, outs = self._cols()
        mv = float(self.getMissingValue())
        surrogates = []
        for c in ins:
            v = to_host(frame[c]).astype(np.float64)
            good = v[~_missing_mask(v, mv)]
            if good.size == 0:
                raise ValueError(f"Imputer: column {c!r} has no valid values")
            strat = self.getStrategy()
            if strat == "mean":
                surrogates.append(float(np.mean(good)))
            elif strat == "median":
                surrogates.append(float(np.median(good)))
            else:  # mode: most frequent; ties -> smallest (Spark 3.1)
                vals, counts = np.unique(good, return_counts=True)
                surrogates.append(float(vals[np.argmax(counts)]))
        model = ImputerModel(surrogates=surrogates)
        model.setParams(**self.paramValues())
        return model


class ImputerModel(_ImputerParams, Model):
    def __init__(self, surrogates: Sequence[float] = (), **kwargs):
        super().__init__(**kwargs)
        self.surrogates = [float(v) for v in surrogates]

    def _save_extra(self):
        return {"surrogates": self.surrogates}, {}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(surrogates=extra["surrogates"])
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        ins = self.getOrDefault("inputCols")
        outs = self.getOrDefault("outputCols") or ins
        mv = float(self.getOrDefault("missingValue"))
        out = frame
        for c, o, s in zip(ins, outs, self.surrogates):
            v = to_host(out[c]).astype(np.float64)
            miss = _missing_mask(v, mv)
            out = out.with_column(o, np.where(miss, s, v))
        return out
