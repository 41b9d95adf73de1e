"""``sntc_tpu_torch.stat`` — the ``pyspark.ml.stat`` surface.

Counterpart of ``sntc_tpu/stat/__init__.py`` (Spark's ``ml/stat``:
``Correlation``, ``ChiSquareTest``, ``ANOVATest``, ``FValueTest``,
``KolmogorovSmirnovTest``, ``Summarizer``).  Each result is a one-row
:class:`~sntc_tpu_torch.core.frame.Frame` whose 2-D columns are the
vectors (for ``Correlation`` an ``[F, F]`` frame of matrix rows), as in
the JAX package.  Each entry point takes ``device`` (default ``cuda``)
and ``mesh``: with a mesh of more than one shard the rows are laid out
by ``shard_batch`` and each pass below is one ``make_tree_aggregate``
(the pilot row given whole to every shard, the padding weighted 0),
summed in shard order — ``ChiSquareTest``'s contingency one
``tree_hist`` launch a shard, the Summarizer's min and max reduced as
min and max:

* ``Correlation``: pearson is one pass on the device (Σw, Σ(x−p) and the
  Gram ``(x−p)ᵀ(x−p)`` about a pilot row, in full float32); spearman is
  the same pass on average-tie ranks taken on the host.
* ``ChiSquareTest``: the feature values are factorised on the host
  (Spark's ``distinct`` stage, with its ``MAX_CATEGORIES`` guard), then
  the (feature, value, class) contingency is ONE ``tree_hist`` launch
  through ``binned_contingency`` on the card.  Its bins are the widest
  feature's cardinality, up to 10 000.
* ``ANOVATest`` and ``FValueTest`` reuse the selector's moments
  (``feature/univariate_selector``).
* ``KolmogorovSmirnovTest`` runs on the host in float64 end to end.
* ``Summarizer``: count, weight sums, moments about a pilot row, L1/L2,
  non-zeros, min and max in one pass on the device; min and max are the
  plain masked reductions (the JAX package's one-hot-by-``axis_index``
  stack is how a ``psum`` carries them across a mesh).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
    shard_weights,
)
from sntc_tpu_torch.feature.univariate_selector import (
    anova_moments,
    f_classif,
    f_regression,
    regression_moments,
)
from sntc_tpu_torch.ops.histogram import binned_contingency, chi_square
from sntc_tpu_torch.ops.lbfgs import full_f32

__all__ = [
    "ANOVATest",
    "ChiSquareTest",
    "Correlation",
    "FValueTest",
    "KolmogorovSmirnovTest",
    "Summarizer",
]


def _features_matrix(frame: Frame, col: str) -> np.ndarray:
    X = to_host(frame[col])
    if X.ndim == 1:
        X = np.asarray(X)[:, None]
    return X


# ---------------------------------------------------------------------------
# Correlation
# ---------------------------------------------------------------------------


def _corr_block(xs, w, pilot) -> torch.Tensor:
    """A block's ``(Σw, Σw(x−p), (x−p)ᵀ diag(w) (x−p))``, flat (unit
    weights multiply exactly)."""
    xc = xs - pilot[None, :]
    wx = xc * w[:, None]
    return torch.cat([w.sum().reshape(1), wx.sum(dim=0),
                      (xc.t() @ wx).flatten()])


def _corr_moments(X: np.ndarray, device, mesh=None):
    """``(n, Σ(x−p) [F], (x−p)ᵀ(x−p) [F, F])`` about the pilot row ``p =
    X[0]``, one pass on ``device`` or one aggregate over ``mesh``;
    float32 host values."""
    f = X.shape[1]
    with full_f32():
        if mesh is None:
            xs = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
                device)
            out = _corr_block(xs, torch.ones(len(X), device=device), xs[0])
        else:
            xs, w = shard_batch(mesh, np.ascontiguousarray(X, np.float32))
            out = make_tree_aggregate(
                _corr_block, mesh, replicated_args=(2,),
                op="correlation.moments",
            )(xs, w, torch.from_numpy(np.array(X[0], np.float32)))
        out = out.cpu().numpy()
    return float(out[0]), out[1:1 + f], out[1 + f:].reshape(f, f)


def _rank_columns(X: np.ndarray) -> np.ndarray:
    """Average-tie ranks per column (Spark's Spearman rank stage: ties
    share the mean of their positional ranks)."""
    from scipy.stats import rankdata

    return np.stack(
        [rankdata(X[:, j], method="average") for j in range(X.shape[1])],
        axis=1,
    ).astype(np.float32)


class Correlation:
    """``ml.stat.Correlation.corr``: the F×F correlation matrix of a
    vector column, as an ``[F, F]`` Frame (row ``i`` = matrix row ``i``)
    under the method-name column."""

    @staticmethod
    def corr(
        frame: Frame,
        column: str,
        method: str = "pearson",
        device=None,
        mesh=None,
    ) -> Frame:
        if method not in ("pearson", "spearman"):
            raise ValueError(
                f"method must be 'pearson' or 'spearman', got {method!r}"
            )
        device = fit_device(device, mesh)
        X = _features_matrix(frame, column).astype(np.float32)
        if X.shape[0] < 1:
            raise ValueError("Correlation requires a non-empty dataset")
        if method == "spearman":
            X = _rank_columns(X)
        n, s, gram = _corr_moments(X, device, fit_mesh(mesh))
        s = np.asarray(s, np.float64)
        cov = np.asarray(gram, np.float64) - np.outer(s, s) / n
        d = np.sqrt(np.maximum(np.diag(cov), 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            m = cov / np.outer(d, d)
        # Spark yields NaN for zero-variance features; the diagonal is 1
        m[np.isinf(m)] = np.nan
        np.fill_diagonal(m, 1.0)
        return Frame({method: np.clip(m, -1.0, 1.0)})


# ---------------------------------------------------------------------------
# Hypothesis tests
# ---------------------------------------------------------------------------


def _test_frame(stats, pvals, dofs, flatten: bool) -> Frame:
    stats = np.asarray(stats, np.float64)
    pvals = np.asarray(pvals, np.float64)
    dofs = np.asarray(dofs, np.int64)
    if flatten:
        return Frame(
            {
                "featureIndex": np.arange(stats.shape[0], dtype=np.int64),
                "pValue": pvals,
                "degreesOfFreedom": dofs,
                "statistic": stats,
            }
        )
    return Frame(
        {
            "pValues": pvals[None, :],
            "degreesOfFreedom": dofs[None, :],
            "statistics": stats[None, :],
        }
    )


def factorize(X: np.ndarray, y: np.ndarray, max_categories: int):
    """Host factorisation of categorical features and labels: ``(binned
    [N, F] int32 value ids, n_bins = the widest feature's cardinality,
    y_idx [N], n_classes)``; a feature with more than ``max_categories``
    distinct values is refused."""
    classes, y_idx = np.unique(y, return_inverse=True)
    cols, cards = [], []
    for j in range(X.shape[1]):
        vals, idx = np.unique(X[:, j], return_inverse=True)
        if len(vals) > max_categories:
            raise ValueError(
                f"feature {j} has {len(vals)} distinct values "
                f"(> {max_categories}); χ² requires "
                "categorical features — bin or discretize first"
            )
        cols.append(idx)
        cards.append(len(vals))
    binned = np.stack(cols, axis=1).astype(np.int32)
    return binned, max(cards), y_idx.astype(np.int64), len(classes)


def contingency(binned: np.ndarray, y_idx: np.ndarray, n_bins: int,
                n_classes: int, device, mesh=None) -> torch.Tensor:
    """The (feature, value, class) counts ``[F, n_bins, C]`` f32 on
    ``device``: one ``tree_hist`` launch on the card — or, over
    ``mesh``, one a shard on that shard's rows and padding mask, the
    shards' whole counts summed."""
    if mesh is not None:
        def table(b, y, w):
            return binned_contingency(b.t().contiguous(), y, w,
                                      n_bins=n_bins, n_classes=n_classes)

        return make_tree_aggregate(table, mesh, op="chisq_test.contingency")(
            *shard_batch(mesh, np.ascontiguousarray(binned), y_idx))
    binned_t = torch.from_numpy(np.ascontiguousarray(binned.T)).to(device)
    yd = torch.from_numpy(y_idx).to(device)
    w = torch.ones(len(y_idx), dtype=torch.float32, device=device)
    return binned_contingency(binned_t, yd, w, n_bins=n_bins,
                              n_classes=n_classes)


class ChiSquareTest:
    """``ml.stat.ChiSquareTest``: Pearson χ² independence test of every
    categorical feature against a categorical label."""

    #: Spark's ChiSqTest "maxCategories" guard: a feature with more
    #: distinct values than this is almost surely continuous — reject it
    #: rather than build a degenerate table.
    MAX_CATEGORIES = 10_000

    @staticmethod
    def test(
        frame: Frame,
        featuresCol: str,
        labelCol: str,
        flatten: bool = False,
        device=None,
        mesh=None,
    ) -> Frame:
        device = fit_device(device, mesh)
        X = _features_matrix(frame, featuresCol)
        y = np.asarray(to_host(frame[labelCol]))
        binned, n_bins, y_idx, n_classes = factorize(
            X, y, ChiSquareTest.MAX_CATEGORIES)
        observed = contingency(binned, y_idx, n_bins, n_classes,
                               device, fit_mesh(mesh)).cpu().numpy()
        stats, pvals, dofs = chi_square(observed)
        return _test_frame(stats, pvals, dofs, flatten)


class ANOVATest:
    """``ml.stat.ANOVATest``: one-way ANOVA F-test of continuous
    features against a categorical label — the selector's
    continuous/categorical score as a standalone test."""

    @staticmethod
    def test(
        frame: Frame,
        featuresCol: str,
        labelCol: str,
        flatten: bool = False,
        device=None,
        mesh=None,
    ) -> Frame:
        device = fit_device(device, mesh)
        X = _features_matrix(frame, featuresCol).astype(np.float32)
        y = np.asarray(to_host(frame[labelCol])).astype(np.int32)
        if X.shape[0] == 0:
            raise ValueError("ANOVATest requires a non-empty dataset")
        cnt, s, sq = anova_moments(X, y, int(y.max()) + 1, device,
                                   fit_mesh(mesh))
        F, p = f_classif((cnt, s, sq))
        k = int((np.asarray(cnt) > 0).sum())
        n = float(np.asarray(cnt).sum())
        dof = np.full(F.shape[0], max(int(n) - k, 0), dtype=np.int64)
        return _test_frame(F, p, dof, flatten)


class FValueTest:
    """``ml.stat.FValueTest``: univariate linear-fit F-test of
    continuous features against a continuous label."""

    @staticmethod
    def test(
        frame: Frame,
        featuresCol: str,
        labelCol: str,
        flatten: bool = False,
        device=None,
        mesh=None,
    ) -> Frame:
        device = fit_device(device, mesh)
        X = _features_matrix(frame, featuresCol).astype(np.float32)
        y = np.asarray(to_host(frame[labelCol])).astype(np.float32)
        if X.shape[0] == 0:
            raise ValueError("FValueTest requires a non-empty dataset")
        m = regression_moments(X, y, device, fit_mesh(mesh))
        F, p = f_regression(m)
        n = float(np.asarray(m[0]))
        dof = np.full(F.shape[0], max(int(n) - 2, 0), dtype=np.int64)
        return _test_frame(F, p, dof, flatten)


class KolmogorovSmirnovTest:
    """``ml.stat.KolmogorovSmirnovTest``: one-sample, two-sided KS test
    of a sample column against a normal distribution, on the host in
    float64 (Spark delegates to commons-math, which computes in double;
    the asymptotic Kolmogorov p-value)."""

    @staticmethod
    def test(
        frame: Frame,
        sampleCol: str,
        distName: str = "norm",
        *params: float,
    ) -> Frame:
        from scipy import stats as sps

        if distName != "norm":
            raise ValueError(
                "only distName='norm' is supported (the one distribution "
                "Spark's KolmogorovSmirnovTest ships)"
            )
        x = np.asarray(to_host(frame[sampleCol])).astype(np.float64).ravel()
        n = x.shape[0]
        if n == 0:
            raise ValueError("KolmogorovSmirnovTest requires a non-empty sample")
        if len(params) not in (0, 2):
            raise ValueError(
                "distName='norm' takes zero params (standard normal) or "
                f"exactly (mean, std); got {len(params)}"
            )
        mean, std = (params if len(params) == 2 else (0.0, 1.0))
        x_sorted = np.sort(x)
        cdf = sps.norm.cdf(x_sorted, loc=mean, scale=std)
        i = np.arange(1, n + 1, dtype=np.float64)
        d = float(np.max(np.maximum(cdf - (i - 1) / n, i / n - cdf)))
        p = float(sps.kstwobign.sf(d * np.sqrt(n)))
        return Frame(
            {"pValue": np.array([p]), "statistic": np.array([d])}
        )


# ---------------------------------------------------------------------------
# Summarizer
# ---------------------------------------------------------------------------

_SUMMARY_METRICS = (
    "mean",
    "sum",
    "variance",
    "std",
    "count",
    "numNonZeros",
    "max",
    "min",
    "normL1",
    "normL2",
    "weightSum",
)


def _summary_block(xs, wr, pilot) -> tuple:
    """A block's ``(sums, min, max)``: the count and weight sums, the
    moments about ``pilot``, norms and non-zeros flat in ``sums``; min
    and max over its rows of positive weight."""
    xc = xs - pilot[None, :]
    wx = xc * wr[:, None]
    live = wr[:, None] > 0
    big = torch.finfo(torch.float32).max
    sums = torch.cat([
        (wr > 0).sum().to(torch.float32).reshape(1),
        wr.sum().reshape(1), (wr * wr).sum().reshape(1),
        wx.sum(dim=0), (xc * wx).sum(dim=0),
        (xs.abs() * wr[:, None]).sum(dim=0),
        (xs * xs * wr[:, None]).sum(dim=0),
        ((xs != 0) * wr[:, None]).sum(dim=0),
    ])
    return (sums, torch.where(live, xs, big).min(dim=0).values,
            torch.where(live, xs, -big).max(dim=0).values)


def _summary_moments(X: np.ndarray, w: np.ndarray, device,
                     mesh=None) -> dict:
    """Every Summarizer sum in one pass on ``device`` (or one aggregate
    over ``mesh``): moments about the pilot row ``X[0]`` (f32
    cancellation), norms and non-zeros of the raw values, min and max
    over the rows of positive weight (Spark's SummarizerBuffer skips
    weight-0 instances, and so the padding); float64 host values."""
    f = X.shape[1]
    with full_f32():
        if mesh is None:
            xs = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
                device)
            wr = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(
                device)
            parts = _summary_block(xs, wr, xs[0])
        else:
            xs, _ = shard_batch(mesh, np.ascontiguousarray(X, np.float32))
            wr = shard_weights(mesh, w, xs.shape[0])
            parts = make_tree_aggregate(
                _summary_block, mesh, replicated_args=(2,),
                op="summarizer.moments", combine=("sum", "min", "max"),
            )(xs, wr, torch.from_numpy(np.array(X[0], np.float32)))
        out = torch.cat(parts).cpu().numpy().astype(np.float64)
    m = {"count": out[0], "wsum": out[1], "w2sum": out[2]}
    for i, key in enumerate(("s1", "s2", "l1", "l2sq", "nnz", "mn", "mx")):
        m[key] = out[3 + i * f:3 + (i + 1) * f]
    return m


class SummaryBuilder:
    """What ``Summarizer.metrics(...)`` returns.  ``summary`` computes the
    requested metrics eagerly."""

    def __init__(self, metrics):
        unknown = [m for m in metrics if m not in _SUMMARY_METRICS]
        if unknown:
            raise ValueError(
                f"unknown summary metrics {unknown}; choose from "
                f"{_SUMMARY_METRICS}"
            )
        self._metrics = tuple(metrics)

    def summary(
        self,
        frame: Frame,
        col: str = "features",
        weightCol: Optional[str] = None,
        device=None,
        weightNorm: str = "reliability",
        mesh=None,
    ) -> Frame:
        """``weightNorm`` (an extension; Spark has no knob):
        "reliability" (default) is Spark's unbiased denominator Σw −
        Σw²/Σw; "frequency" uses Σw − 1, under which ``weightCol`` ≡
        integer row replication.  Unweighted they coincide."""
        device = fit_device(device, mesh)
        X = _features_matrix(frame, col).astype(np.float32)
        if X.shape[0] == 0:
            raise ValueError("Summarizer requires a non-empty dataset")
        w = (np.asarray(to_host(frame[weightCol])).astype(np.float32)
             if weightCol is not None
             else np.ones(X.shape[0], np.float32))
        m = _summary_moments(X, w, device, fit_mesh(mesh))
        wsum, pilot = m["wsum"], X[0].astype(np.float64)
        if wsum <= 0:
            raise ValueError(
                "Summarizer: total weight is zero (all rows weight-0)"
            )
        mean = pilot + m["s1"] / wsum
        if weightNorm not in ("reliability", "frequency"):
            raise ValueError(
                f"weightNorm must be 'reliability' or 'frequency', got "
                f"{weightNorm!r}"
            )
        denom = float(
            wsum - m["w2sum"] / wsum
            if weightNorm == "reliability"
            else wsum - 1.0
        )
        # Spark: a non-positive denominator (a single row, one dominant
        # weight) gives zero variance, not a division blow-up
        if denom > 0:
            var = np.maximum(
                (m["s2"] - m["s1"] ** 2 / wsum) / denom, 0.0
            )
        else:
            var = np.zeros_like(mean)
        values = {
            "mean": mean,
            "sum": mean * wsum,
            "variance": var,
            "std": np.sqrt(var),
            "count": np.int64(round(float(m["count"]))),
            "numNonZeros": m["nnz"],
            "max": m["mx"],
            "min": m["mn"],
            "normL1": m["l1"],
            "normL2": np.sqrt(m["l2sq"]),
            "weightSum": float(wsum),
        }
        out = {}
        for name in self._metrics:
            v = values[name]
            out[name] = (
                np.asarray(v)[None, :] if np.ndim(v) == 1
                else np.asarray([v])
            )
        return Frame(out)


class Summarizer:
    """``ml.stat.Summarizer``: vector-column summary statistics in one
    pass.  ``Summarizer.metrics("mean", "variance").summary(df,
    "features", weightCol)`` — the Spark call shape, eager result."""

    @staticmethod
    def metrics(*names: str) -> SummaryBuilder:
        if not names:
            raise ValueError("Summarizer.metrics requires at least one metric")
        return SummaryBuilder(names)

    # Spark's single-metric shorthands
    @staticmethod
    def mean(frame, col="features", weightCol=None, device=None, mesh=None):
        return SummaryBuilder(("mean",)).summary(frame, col, weightCol,
                                                 device, mesh=mesh)

    @staticmethod
    def variance(frame, col="features", weightCol=None, device=None,
                 mesh=None):
        return SummaryBuilder(("variance",)).summary(
            frame, col, weightCol, device, mesh=mesh
        )
