"""Quantile binning — Spark's ``findSplits`` analog.

Counterpart of ``sntc_tpu/ops/binning.py``.  Continuous features are
binned once into integer bin ids, so every later pass of the tree
grower and the chi-square selector is integer histogramming.

:func:`quantile_bin_edges` computes the edges on the host from a
seeded row sample (the JAX package's host path, copied: the same numpy
calls give the same edges).  :func:`bin_features` maps features to bins
with ``torch.searchsorted`` on the features' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _default_sample_rows(max_bins: int) -> int:
    # Spark findSplits: max(maxBins * maxBins, 10000), with headroom
    return max(10_000, 4 * max_bins * max_bins)


def quantile_bin_edges(
    X: np.ndarray,
    max_bins: int = 32,
    sample_rows: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Per-feature quantile split thresholds ``[F, max_bins - 1]`` float32,
    from a ``seed``-driven random sample of ``sample_rows`` rows (all rows
    when there are fewer).  Host numpy in, host numpy out."""
    if isinstance(X, torch.Tensor):
        raise TypeError(
            "quantile_bin_edges takes a numpy matrix; the device-resident "
            "path is not ported"
        )
    n, _ = X.shape
    if sample_rows is None:
        sample_rows = _default_sample_rows(max_bins)
    if n > sample_rows:
        idx = np.random.default_rng(seed).choice(n, size=sample_rows, replace=False)
        sample = X[idx]
    else:
        sample = X
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
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
