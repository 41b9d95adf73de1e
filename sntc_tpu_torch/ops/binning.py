"""Quantile binning — Spark's ``findSplits`` analog.

Counterpart of ``sntc_tpu/ops/binning.py``.  Continuous features are
binned once into integer bin ids, so every later pass of the tree
grower and the chi-square selector is integer histogramming.

:func:`quantile_bin_edges` computes the edges from a seeded row sample.
A numpy matrix takes the JAX package's host path, copied: the same
numpy calls give the same edges.  A tensor takes the device path: the
sample's row indices are the host path's draw (numpy
``default_rng(seed).choice``; the JAX device path draws with
``jax.random``, which a torch program cannot reproduce), gathered on the
tensor's device, and the quantiles are numpy's linear interpolation op
for op (:func:`column_quantiles_np`: a float32 sort, the neighbours'
float32 difference, the blend in float64, the edges rounded to
float32), so the two paths give the same edges from the same sample,
bitwise.  The JAX ``_edges_device`` blends in float32
(``jnp.quantile``); with every row in the sample the port's edges lie
within float32 rounding of its.  :func:`bin_features` maps features to
bins with ``torch.searchsorted`` on the features' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _default_sample_rows(max_bins: int) -> int:
    # Spark findSplits: max(maxBins * maxBins, 10000), with headroom
    return max(10_000, 4 * max_bins * max_bins)


def column_quantiles_np(xs: torch.Tensor, qs: np.ndarray) -> torch.Tensor:
    """Per-column quantiles ``[len(qs), F]`` float32 of float32 ``xs
    [N, F]`` on its device, as ``np.quantile(xs, qs, axis=0)`` (method
    ``linear``) computes them and ``astype(np.float32)`` rounds them: the
    virtual index ``(n-1)·q`` and its weight on the host in float64,
    the neighbours' difference in float32, the blend ``a + d·t`` (``b -
    d·(1-t)`` from ``t >= 0.5`` on) in float64.  A column holding a NaN
    gives NaN."""
    n = xs.shape[0]
    vi = (n - 1) * np.asarray(qs, np.float64)
    prev = np.floor(vi)
    nxt = prev + 1
    above = vi >= n - 1
    prev[above], nxt[above] = -1, -1
    gamma = vi - prev
    dev = xs.device
    srt = torch.sort(xs, dim=0).values
    a = srt[torch.from_numpy(prev.astype(np.int64)).to(dev)]
    b = srt[torch.from_numpy(nxt.astype(np.int64)).to(dev)]
    d = (b - a).to(torch.float64)
    t = torch.from_numpy(gamma).to(dev)[:, None]
    out = torch.where(t >= 0.5, b.to(torch.float64) - d * (1.0 - t),
                      a.to(torch.float64) + d * t)
    nan = torch.isnan(srt[-1])
    out = torch.where(nan[None, :], torch.full_like(out, float("nan")), out)
    return out.to(torch.float32)


def quantile_bin_edges(
    X: np.ndarray,
    max_bins: int = 32,
    sample_rows: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Per-feature quantile split thresholds ``[F, max_bins - 1]`` float32,
    from a ``seed``-driven random sample of ``sample_rows`` rows (all rows
    when there are fewer).  A numpy matrix gives numpy edges from the
    host; a tensor gives tensor edges computed on its device."""
    n, _ = X.shape
    if sample_rows is None:
        sample_rows = _default_sample_rows(max_bins)
    idx = None
    if n > sample_rows:
        idx = np.random.default_rng(seed).choice(n, size=sample_rows, replace=False)
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
    if isinstance(X, torch.Tensor):
        sample = X if idx is None else X.index_select(
            0, torch.from_numpy(idx).to(X.device))
        return column_quantiles_np(sample.to(torch.float32), qs).t() \
            .contiguous()
    sample = X if idx is None else X[idx]
    edges = np.quantile(sample, qs, axis=0).T.astype(np.float32)  # [F, B-1]
    return np.ascontiguousarray(edges)


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin ids ``[N, F]`` int32 in ``[0, B-1]`` of float32 ``X [N, F]``
    given float32 ``edges [F, B-1]``: ``bin = #edges <= x``
    (right-closed, Spark-style), on ``X``'s device.

    The result is the transpose of a contiguous ``[F, N]`` tensor, the
    layout the histogram kernel reads: ``bin_features(X, e).t()`` is
    contiguous and costs no copy."""
    binned_t = torch.searchsorted(
        edges.contiguous(), X.t().contiguous(), right=True
    ).to(torch.int32)
    return binned_t.t()
