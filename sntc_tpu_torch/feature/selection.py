"""Shared univariate feature-selection modes.

A copy of ``sntc_tpu/feature/selection.py`` (the port imports nothing
from that package): Spark's five ``selectorType`` semantics
(upstream ``ml/feature/ChiSqSelector.scala``): rank by p-value ascending
(stat descending, index ascending on ties) and keep

  * ``numTopFeatures`` — the best k,
  * ``percentile``     — the best ``ceil-free int(F * fraction)`` (min 1),
  * ``fpr``            — every feature with ``p < threshold``,
  * ``fdr``            — Benjamini-Hochberg step-up at ``threshold``,
  * ``fwe``            — Bonferroni: ``p < threshold / F``.

:func:`select_columns` is the selectors' shared transform.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def select_features_by_mode(
    stats: np.ndarray,
    p_values: np.ndarray,
    mode: str,
    threshold,
    n_features: int,
) -> List[int]:
    """Sorted selected feature indices; ``threshold`` is the mode's knob
    (k / fraction / p-cutoff)."""
    order = np.lexsort((np.arange(len(stats)), -stats, p_values))
    if mode == "numTopFeatures":
        chosen = order[: min(int(threshold), n_features)]
    elif mode == "percentile":
        chosen = order[: max(1, int(n_features * float(threshold)))]
    elif mode == "fpr":
        chosen = np.flatnonzero(p_values < float(threshold))
    elif mode == "fdr":
        # Benjamini-Hochberg step-up: largest k with p_(k) <= k/F * fdr,
        # then every feature at or below that cutoff
        sorted_p = p_values[order]
        cuts = (np.arange(1, n_features + 1) / n_features) * float(threshold)
        below = np.flatnonzero(sorted_p <= cuts)
        chosen = order[: below[-1] + 1] if below.size else order[:0]
    elif mode == "fwe":
        chosen = np.flatnonzero(p_values < float(threshold) / n_features)
    else:
        raise ValueError(f"unknown selection mode {mode!r}")
    return sorted(int(i) for i in chosen)


def select_columns(X, idx: List[int], cache: dict):
    """The selectors' transform, ``X[:, idx]``: ``index_select`` on a
    tensor's device (the index uploaded once per device, kept in
    ``cache``), a contiguous numpy gather otherwise."""
    if isinstance(X, torch.Tensor):
        t = cache.get(X.device)
        if t is None:
            t = cache[X.device] = torch.tensor(idx, dtype=torch.long,
                                               device=X.device)
        return X.index_select(1, t)
    return np.ascontiguousarray(np.asarray(X)[:, idx])
