"""Binned contingency and the chi-square statistic.

Counterpart of ``sntc_tpu/ops/histogram.py``: the (feature, bin, class)
contingency of the chi-square selector is the ``tree_hist`` level
histogram with a single node and one-hot class stats (the JAX package's
``binned_contingency_onehot``); the statistic itself is host-side scipy
arithmetic on the tiny ``[F, B, C]`` table, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.kernels.histogram import level_histogram


def binned_contingency(
    binned_t: torch.Tensor,  # [F, N] int32 bin ids
    y: torch.Tensor,  # [N] int64 class ids
    w: torch.Tensor,  # [N] f32 row weights
    *,
    n_bins: int,
    n_classes: int,
) -> torch.Tensor:
    """Weighted (feature, bin, class) counts ``[F, B, C]`` f32, through
    one ``tree_hist`` launch on a CUDA tensor."""
    yoh = torch.nn.functional.one_hot(y, n_classes).to(torch.float32) * w[:, None]
    node0 = torch.zeros(y.shape[0], dtype=torch.int32, device=y.device)
    return level_histogram(binned_t, node0, yoh.contiguous(), n_nodes=1,
                           n_bins=n_bins)


def chi_square(observed: np.ndarray) -> tuple:
    """Pearson χ² per feature from contingency ``[F, B, C]``.

    Returns ``(stats [F], p_values [F], dof [F])``, with Spark's
    ``ChiSqTest`` semantics on categorical data: expected counts from
    row/column marginals, dof = (#nonempty bins - 1) * (#nonempty
    classes - 1)."""
    from scipy.stats import chi2 as chi2_dist

    observed = np.asarray(observed, dtype=np.float64)
    f = observed.shape[0]
    stats = np.zeros(f)
    dofs = np.zeros(f, dtype=np.int64)
    for j in range(f):
        table = observed[j]
        table = table[table.sum(axis=1) > 0][:, table.sum(axis=0) > 0]
        if table.size == 0 or 1 in table.shape:
            stats[j], dofs[j] = 0.0, 0
            continue
        total = table.sum()
        expected = np.outer(table.sum(axis=1), table.sum(axis=0)) / total
        stats[j] = ((table - expected) ** 2 / expected).sum()
        dofs[j] = (table.shape[0] - 1) * (table.shape[1] - 1)
    p_values = np.where(dofs > 0, chi2_dist.sf(stats, np.maximum(dofs, 1)), 1.0)
    return stats, p_values, dofs
