"""VectorIndexer + VectorSizeHint.

Counterpart of ``sntc_tpu/feature/vector_indexer.py`` (Spark's stages of
the same names):

  * VectorIndexer: fit declares every feature with at most
    ``maxCategories`` distinct values CATEGORICAL and re-indexes its
    values to ``0..k−1`` in ascending order, 0.0 first when present
    (Spark's sparsity rule); other features pass through.
    ``handleInvalid`` error | skip | keep (an unseen value maps to k).
    The output is float32.
  * VectorSizeHint: stateless width check: error | skip | optimistic.

The fit runs on the estimator's ``device`` (default ``cuda``): one sort
of every column, the distinct count of each column (NaNs count once, as
``np.unique`` counts them) read back once, then the categorical columns'
distinct values read back once.  The transform runs where its input
lives: a numpy column on the host (the JAX package's per-feature
``searchsorted``), a tensor column on its device with the same lookups
(an unseen value's verdict is one read back, made unless ``keep``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model, Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.utils.profiling import record_movement, upload


class _ViParams:
    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="indexed")
    maxCategories = Param(
        "features with <= this many distinct values become categorical",
        default=20, validator=validators.gt(1),
    )
    handleInvalid = Param(
        "error | skip | keep for unseen categorical values", default="error",
        validator=validators.one_of("error", "skip", "keep"),
    )


def column_distinct(xs: torch.Tensor, max_cat: int) -> Dict[int, np.ndarray]:
    """The ascending distinct values (float64, host) of every column of
    ``xs [N, F]`` with at most ``max_cat`` of them: ``np.unique`` of each
    column, NaNs collapsed to one.  Two reads back: the counts, then the
    values."""
    n, f = xs.shape
    if n == 0:
        return {}
    s = torch.sort(xs, dim=0).values
    nan = torch.isnan(s)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = (s[1:] != s[:-1]) & ~(nan[1:] & nan[:-1])
    counts = first.sum(dim=0).cpu().numpy()
    record_movement(syncs=1)
    cat = np.flatnonzero(counts <= max_cat)
    if not len(cat):
        return {}
    cat_t = torch.from_numpy(cat).to(xs.device)
    vals = s.index_select(1, cat_t).t()[first.index_select(1, cat_t).t()]
    vals = vals.cpu().numpy().astype(np.float64)
    record_movement(downloads=1, download_bytes=vals.nbytes)
    ends = np.cumsum(counts[cat])
    return {int(j): v for j, v in zip(cat, np.split(vals, ends[:-1]))}


class VectorIndexer(_ViParams, Estimator):
    """Fits on ``device`` (default ``cuda``)."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _fit(self, frame: Frame) -> "VectorIndexerModel":
        X = frame[self.getInputCol()]
        if X.ndim != 2:
            raise ValueError("inputCol must be a vector column")
        xs = (X.to(self.device) if isinstance(X, torch.Tensor)
              else upload(np.ascontiguousarray(X), self.device))
        maps = {}
        for j, vals in column_distinct(
                xs, int(self.getMaxCategories())).items():
            # Spark maps value 0.0 to index 0 when present (sparsity
            # preservation); the other values keep ascending order
            if 0.0 in vals:
                vals = np.concatenate(([0.0], vals[vals != 0.0]))
            maps[j] = vals
        model = VectorIndexerModel(numFeatures=X.shape[1], categoryMaps=maps)
        model.setParams(**self.paramValues())
        return model


class VectorIndexerModel(_ViParams, Model):
    def __init__(self, numFeatures: int, categoryMaps: Dict[int, np.ndarray],
                 **kwargs):
        super().__init__(**kwargs)
        self.numFeatures = int(numFeatures)
        self.categoryMaps = {
            int(j): np.asarray(v, np.float64) for j, v in categoryMaps.items()
        }
        self._on = {}

    def _save_extra(self):
        return (
            {"numFeatures": self.numFeatures,
             "catKeys": sorted(self.categoryMaps)},
            {f"cat_{j}": v for j, v in self.categoryMaps.items()},
        )

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        maps = {int(j): arrays[f"cat_{j}"] for j in extra["catKeys"]}
        m = cls(numFeatures=int(extra["numFeatures"]), categoryMaps=maps)
        m.setParams(**params)
        return m

    def _lookups(self):
        """Per categorical feature: (the stable order of its values,
        the values in that order), as the host transform builds them."""
        out = {}
        for j, vals in self.categoryMaps.items():
            order = np.argsort(vals, kind="stable")
            out[j] = (order, vals[order])
        return out

    def _lookups_on(self, device):
        """:meth:`_lookups` on ``device``, each with its value count k;
        the sorted values lose a trailing NaN (``torch.searchsorted``
        mis-searches a sequence holding one, and a NaN value is unseen
        on the host all the same)."""
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = {
                j: (torch.from_numpy(order).to(device),
                    torch.from_numpy(
                        sorted_vals[~np.isnan(sorted_vals)]).to(device),
                    len(sorted_vals))
                for j, (order, sorted_vals) in self._lookups().items()}
        return t

    def _transform_device(self, X: torch.Tensor, mode: str):
        out = X.to(torch.float64).clone()
        unseen = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
        for j, (order, finite, k) in self._lookups_on(X.device).items():
            x = out[:, j].contiguous()
            if finite.numel():
                pos_c = torch.searchsorted(finite, x).clamp(
                    0, finite.numel() - 1)
                known = finite[pos_c] == x
                col = order[pos_c].to(torch.float64)
            else:  # only NaN was seen: every value is unseen
                known = torch.zeros_like(x, dtype=torch.bool)
                col = torch.zeros_like(x)
            if mode == "keep":
                col = torch.where(known, col, torch.full_like(col, float(k)))
            out[:, j] = col
            unseen |= ~known
        bad = None
        if mode != "keep" and self.categoryMaps:
            any_unseen = bool(unseen.any())
            record_movement(syncs=1)
            if any_unseen:
                if mode == "error":
                    raise ValueError(
                        "unseen categorical value (handleInvalid='error')")
                bad = unseen.cpu().numpy()
                record_movement(syncs=1)
        return out.to(torch.float32), bad

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        if X.shape[1] != self.numFeatures:
            raise ValueError(
                f"expected {self.numFeatures} features, got {X.shape[1]}"
            )
        mode = self.getHandleInvalid()
        if isinstance(X, torch.Tensor):
            out, bad_rows = self._transform_device(X, mode)
        else:
            X = np.asarray(X, np.float64)
            out = X.copy()
            bad_rows = np.zeros(len(X), bool)
            for j, (order, sorted_vals) in self._lookups().items():
                # vals need not be ascending (0.0 is pinned to index 0):
                # search a sorted view, then permute back to category ids
                pos = np.searchsorted(sorted_vals, X[:, j])
                pos_c = np.clip(pos, 0, len(sorted_vals) - 1)
                known = sorted_vals[pos_c] == X[:, j]
                out[:, j] = order[pos_c]
                if not known.all():
                    if mode == "error":
                        raise ValueError(
                            f"unseen categorical value in feature {j} "
                            "(handleInvalid='error')"
                        )
                    if mode == "keep":
                        # Spark: unseen -> extra bucket k
                        out[~known, j] = len(sorted_vals)
                    else:
                        bad_rows |= ~known
            out = out.astype(np.float32)
        g = frame.with_column(self.getOutputCol(), out)
        if mode == "skip" and bad_rows is not None and bad_rows.any():
            g = g.filter(~bad_rows)
        return g


class VectorSizeHint(Transformer):
    """Stateless vector-width contract: error (raise) | skip (drop the
    rows) | optimistic (trust and pass through)."""

    inputCol = Param("vector column to check", default="features")
    size = Param("required width", default=None)
    handleInvalid = Param(
        "error | skip | optimistic", default="error",
        validator=validators.one_of("error", "skip", "optimistic"),
    )

    def transform(self, frame: Frame) -> Frame:
        size = self.getSize()
        if size is None:
            raise ValueError("size must be set")
        mode = self.getHandleInvalid()
        if mode == "optimistic":
            return frame
        X = frame[self.getInputCol()]
        width = X.shape[1] if X.ndim == 2 else 1
        if width == int(size):
            return frame
        if mode == "error":
            raise ValueError(
                f"column {self.getInputCol()!r} has width {width}, "
                f"required {int(size)}"
            )
        # fixed-width columns disagree as a whole: skip drops everything
        return frame.slice(0, 0)
