"""UnivariateFeatureSelector — score-function feature selection.

Counterpart of ``sntc_tpu/feature/univariate_selector.py`` (Spark's
``UnivariateFeatureSelector``): the score function follows the
(featureType, labelType) pair —

  * categorical/categorical → χ² test,
  * continuous/categorical  → ANOVA F-test (``f_classif``),
  * continuous/continuous   → F-regression (``f_regression``),

with ``selectionMode`` ∈ {numTopFeatures, percentile, fpr, fdr, fwe} and
one numeric ``selectionThreshold`` (defaults 50 / 0.1 / 0.05 / 0.05 /
0.05), validated before any scoring.

The χ² score is the port's ``chi2_scores``: the features quantile-binned
and the contingency built by one ``tree_hist`` launch on the card.  The
ANOVA and F-regression moments (:func:`anova_moments`,
:func:`regression_moments`) are one pass on the estimator's device in
full float32, about a pilot row (the statistics are shift-invariant, and
raw f32 squares cancel on large-mean features); the F statistics and
p-values are host scipy on ``[F]`` arrays, copied.  With a ``mesh=`` of
more than one shard the rows are laid out by ``shard_batch``: χ² launches
``tree_hist`` once a shard and sums the tables, and each moment pass is
one ``make_tree_aggregate`` (the pilots given whole to every shard, the
padding weighted 0), summed in shard order.  The model is a column
select; on a tensor it runs on the tensor's device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.feature.chisq_selector import chi2_scores
from sntc_tpu_torch.feature.selection import (
    select_columns,
    select_features_by_mode,
)
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
)


_CHUNK_ROWS = 4096  # rows a partial product of the ANOVA moments sums


def _rows_on(X: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)


def chunked_t_matmul(a: torch.Tensor, b: torch.Tensor,
                     chunk: int = _CHUNK_ROWS) -> torch.Tensor:
    """``aᵀ b`` over the rows of ``a [N, F]`` and ``b [N, C]`` as a sum of
    per-chunk products, as the JAX package sums per shard.  One product
    over all N rows accumulates each cell along N: on an NVIDIA H100 that
    lay 3.4e-5 of the largest ANOVA statistic from the float64 sums at
    199 800 flow rows, where the CPU's product lay 2.9e-6."""
    n = a.shape[0]
    if n <= chunk:
        return a.t() @ b
    pad = (-n) % chunk
    if pad:
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    a = a.reshape(-1, chunk, a.shape[1])
    b = b.reshape(-1, chunk, b.shape[1])
    return torch.bmm(a.transpose(1, 2), b).sum(dim=0)


def _anova_block(xs, ys, w, pilot, n_classes: int) -> torch.Tensor:
    """A block's weighted ``[count, Σ(x−p), Σ(x−p)²]``, flat (unit
    weights multiply exactly: one device's rows weigh 1, sharded rows'
    padding 0)."""
    xs = xs - pilot[None, :]
    oh = (torch.nn.functional.one_hot(ys, n_classes).to(torch.float32)
          * w[:, None])
    return torch.cat([oh.sum(dim=0), chunked_t_matmul(xs, oh).flatten(),
                      chunked_t_matmul(xs * xs, oh).flatten()])


def anova_moments(X: np.ndarray, y: np.ndarray, n_classes: int, device,
                  mesh=None):
    """Per-(feature, class) ``(count [C], Σ(x−p) [F, C], Σ(x−p)² [F,
    C])`` about the pilot row ``p = X[0]``, one pass on ``device`` or one
    aggregate over ``mesh``; float32 host arrays."""
    y = np.asarray(y).astype(np.int64)
    with full_f32():
        if mesh is None:
            xs = _rows_on(X, device)
            out = _anova_block(xs, torch.from_numpy(y).to(device),
                               torch.ones(len(y), device=device), xs[0],
                               n_classes)
        else:
            xs, ys, w = shard_batch(mesh, np.ascontiguousarray(X, np.float32),
                                    y)
            out = make_tree_aggregate(
                lambda x, yy, ww, p: _anova_block(x, yy, ww, p, n_classes),
                mesh, replicated_args=(3,), op="anova.moments",
            )(xs, ys, w, torch.from_numpy(np.array(X[0], np.float32)))
        out = out.cpu().numpy()
    c, f = n_classes, X.shape[1]
    return (out[:c], out[c:c + f * c].reshape(f, c),
            out[c + f * c:].reshape(f, c))


def _regression_block(xs, ys, w, px, py) -> torch.Tensor:
    """A block's weighted ``[Σw, Σx, Σx², Σy, Σy², Σxy]`` about the
    pilots, flat (unit weights multiply exactly)."""
    xs = xs - px[None, :]
    ys = ys - py
    wx = xs * w[:, None]
    return torch.cat([w.sum().reshape(1), wx.sum(dim=0),
                      (xs * wx).sum(dim=0), (ys * w).sum().reshape(1),
                      (ys * ys * w).sum().reshape(1),
                      (ys[:, None] * wx).sum(dim=0)])


def regression_moments(X: np.ndarray, y: np.ndarray, device, mesh=None):
    """Per-feature ``(n, Σx, Σx², Σy, Σy², Σxy)`` about the pilots
    ``X[0]`` and ``y[0]``, one pass on ``device`` or one aggregate over
    ``mesh``; float32 host values."""
    y = np.asarray(y, np.float32)
    with full_f32():
        if mesh is None:
            xs = _rows_on(X, device)
            ys = torch.from_numpy(y).to(device)
            out = _regression_block(xs, ys, torch.ones_like(ys), xs[0],
                                    ys[0])
        else:
            xs, ys, w = shard_batch(mesh, np.ascontiguousarray(X, np.float32),
                                    y)
            out = make_tree_aggregate(
                _regression_block, mesh, replicated_args=(3, 4),
                op="fregression.moments",
            )(xs, ys, w, torch.from_numpy(np.array(X[0], np.float32)),
              torch.tensor(float(y[0]), dtype=torch.float32))
        out = out.cpu().numpy()
    f = X.shape[1]
    return (out[0], out[1:1 + f], out[1 + f:1 + 2 * f], out[1 + 2 * f],
            out[2 + 2 * f], out[3 + 2 * f:])


def f_classif(X_moments, eps: float = 1e-12):
    """ANOVA F per feature from per-class moments ``(cnt [C], s [F,C],
    sq [F,C])`` — the sklearn ``f_classif`` statistic."""
    from scipy.stats import f as f_dist

    cnt, s, sq = (np.asarray(a, np.float64) for a in X_moments)
    nz = cnt > 0
    k = int(nz.sum())
    n = float(cnt.sum())
    if k < 2 or n <= k:
        F = np.zeros(s.shape[0])
        return F, np.ones_like(F)
    mean_c = s[:, nz] / cnt[nz]
    grand = s.sum(axis=1) / n
    ss_between = (cnt[nz] * (mean_c - grand[:, None]) ** 2).sum(axis=1)
    ss_within = (sq[:, nz] - cnt[nz] * mean_c**2).sum(axis=1)
    F = (ss_between / (k - 1)) / np.maximum(ss_within / (n - k), eps)
    p = f_dist.sf(F, k - 1, n - k)
    return F, p


def f_regression(moments, eps: float = 1e-12):
    """F statistic of the univariate linear fit per feature from
    ``(n, sx, sxx, sy, syy, sxy)`` — the sklearn ``f_regression`` form."""
    from scipy.stats import f as f_dist

    n, sx, sxx, sy, syy, sxy = (np.asarray(a, np.float64) for a in moments)
    n = float(n)
    if n <= 2:
        F = np.zeros(sx.shape[0])
        return F, np.ones_like(F)
    cov = sxy - sx * sy / n
    var_x = sxx - sx**2 / n
    var_y = syy - sy**2 / n
    r2 = cov**2 / np.maximum(var_x * var_y, eps)
    r2 = np.clip(r2, 0.0, 1.0 - eps)
    F = r2 / (1.0 - r2) * (n - 2)
    p = f_dist.sf(F, 1, n - 2)
    return F, p


class _UfsParams:
    featuresCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="selectedFeatures")
    labelCol = Param("label column", default="label")
    featureType = Param(
        "categorical | continuous",
        default=None,
        validator=lambda v: v in (None, "categorical", "continuous"),
    )
    labelType = Param(
        "categorical | continuous",
        default=None,
        validator=lambda v: v in (None, "categorical", "continuous"),
    )
    selectionMode = Param(
        "numTopFeatures | percentile | fpr | fdr | fwe",
        default="numTopFeatures",
        validator=validators.one_of(
            "numTopFeatures", "percentile", "fpr", "fdr", "fwe"
        ),
    )
    selectionThreshold = Param(
        "k for numTopFeatures, fraction for percentile, p-cutoff otherwise "
        "(None -> Spark's per-mode default)",
        default=None,
    )
    maxBins = Param(
        "quantile bins when categorical features must be derived from "
        "continuous flows (rebuild-specific)",
        default=32,
        validator=validators.gt(1),
    )


_MODE_DEFAULTS = {
    "numTopFeatures": 50,
    "percentile": 0.1,
    "fpr": 0.05,
    "fdr": 0.05,
    "fwe": 0.05,
}


class UnivariateFeatureSelector(_UfsParams, Estimator):
    """Scores on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _score(self, X, y):
        if X.shape[0] == 0:
            raise ValueError(
                "UnivariateFeatureSelector requires a non-empty dataset"
            )
        ftype, ltype = self.getFeatureType(), self.getLabelType()
        mesh = fit_mesh(self.mesh)
        if ftype is None or ltype is None:
            raise ValueError(
                "featureType and labelType must both be set (Spark "
                "requires them; they choose the score function)"
            )
        if ftype == "categorical" and ltype == "categorical":
            # χ² on the binned contingency — ChiSqSelector's one pipeline
            return chi2_scores(X, y, self.getMaxBins(), self.device, mesh)
        if ltype == "categorical":  # continuous features, ANOVA F
            n_classes = int(y.max()) + 1 if len(y) else 1
            return f_classif(anova_moments(X, y.astype(np.int32), n_classes,
                                           self.device, mesh))
        if ftype == "categorical":
            raise ValueError(
                "categorical features with a continuous label have no "
                "Spark score function (Spark rejects this combination too)"
            )
        return f_regression(regression_moments(X, y.astype(np.float32),
                                               self.device, mesh))

    def _resolved_threshold(self):
        """The mode's threshold, validated BEFORE any scoring (its
        meaning depends on the mode, so a mode-blind Param validator
        cannot check it)."""
        mode = self.getSelectionMode()
        threshold = self.getSelectionThreshold()
        if threshold is None:
            threshold = _MODE_DEFAULTS[mode]
        if mode == "numTopFeatures":
            if float(threshold) != int(threshold):
                raise ValueError(
                    f"selectionThreshold={threshold!r} must be an integer "
                    "feature count for numTopFeatures (Spark IntParam)"
                )
            if int(threshold) < 1:
                raise ValueError(
                    f"selectionThreshold={threshold!r} must be a positive "
                    "feature count for numTopFeatures"
                )
        elif not 0.0 <= float(threshold) <= 1.0:
            raise ValueError(
                f"selectionThreshold={threshold!r} must be in [0, 1] for "
                f"selectionMode={mode!r}"
            )
        return mode, threshold

    def _fit(self, frame: Frame) -> "UnivariateFeatureSelectorModel":
        mode, threshold = self._resolved_threshold()  # fail fast
        X = np.asarray(to_host(frame[self.getFeaturesCol()]), np.float32)
        y = np.asarray(to_host(frame[self.getLabelCol()]))
        stats, p_values = self._score(X, y)
        selected = select_features_by_mode(
            np.asarray(stats), np.asarray(p_values), mode, threshold,
            X.shape[1],
        )
        model = UnivariateFeatureSelectorModel(selected_features=selected)
        model.setParams(**self.paramValues())
        return model


class UnivariateFeatureSelectorModel(_UfsParams, Model):
    def __init__(self, selected_features: List[int] = (), **kwargs):
        super().__init__(**kwargs)
        self.selected_features = list(selected_features)
        self._index_on = {}  # device -> index tensor

    def _save_extra(self):
        return {"selected_features": self.selected_features}, {}

    @classmethod
    def _load_from(cls, params, extra, arrays, device=None):
        m = cls(selected_features=extra["selected_features"])
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        out = select_columns(frame[self.getFeaturesCol()],
                             self.selected_features, self._index_on)
        return frame.with_column(self.getOutputCol(), out)
