"""ChiSqSelector — χ² flow-feature selection.

Counterpart of ``sntc_tpu/feature/chisq_selector.py`` (Spark's
``ChiSqSelector``): rank features by χ² p-value against the label and
keep the top ``numTopFeatures`` / ``percentile`` / those below ``fpr``,
``fdr`` or ``fwe``.  Continuous flow features are quantile-binned first.

The fit bins the features and builds the (feature, bin, class)
contingency on the estimator's device — one ``tree_hist`` launch on the
card, or with a ``mesh=`` one launch a shard on that shard's rows, the
shards' tables summed (exact: whole counts) — then computes the
statistics and the selection on the host.  The
fitted model is a column select of ``selected_features``; on a tensor
the select runs on the tensor's device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
)
from sntc_tpu_torch.feature.selection import (
    select_columns,
    select_features_by_mode,
)
from sntc_tpu_torch.ops.binning import bin_features, quantile_bin_edges
from sntc_tpu_torch.ops.histogram import binned_contingency, chi_square


class _SelectorParams:
    featuresCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="selectedFeatures")
    labelCol = Param("label index column", default="label")
    selectorType = Param(
        "selection mode: numTopFeatures | percentile | fpr | fdr | fwe",
        default="numTopFeatures",
        validator=validators.one_of(
            "numTopFeatures", "percentile", "fpr", "fdr", "fwe"
        ),
    )
    numTopFeatures = Param(
        "number of features to keep", default=50, validator=validators.gt(0)
    )
    percentile = Param(
        "fraction of features to keep", default=0.1, validator=validators.in_range(0, 1)
    )
    fpr = Param(
        "highest p-value to keep", default=0.05, validator=validators.in_range(0, 1)
    )
    fdr = Param(
        "upper bound on the expected false-discovery rate "
        "(Benjamini-Hochberg)",
        default=0.05,
        validator=validators.in_range(0, 1),
    )
    fwe = Param(
        "upper bound on the family-wise error rate: keep p < fwe / F "
        "(Bonferroni)",
        default=0.05,
        validator=validators.in_range(0, 1),
    )
    maxBins = Param(
        "quantile bins for continuous features",
        default=32,
        validator=validators.gt(1),
    )


def chi2_scores(X: np.ndarray, y: np.ndarray, n_bins: int, device,
                mesh=None):
    """``(stats [F], p_values [F])`` of the binned χ² test of float32
    ``X [N, F]`` against integer labels ``y``, the contingency built on
    ``device`` — or, with ``mesh``, one ``tree_hist`` launch a shard on
    that shard's rows and padding mask, summed over the shards."""
    y = np.asarray(y).astype(np.int64)
    n_classes = int(y.max()) + 1 if len(y) else 1
    edges = quantile_bin_edges(X, max_bins=n_bins)

    def contingency(xs, ys, w, e):
        binned_t = bin_features(xs, e).t()
        return binned_contingency(binned_t, ys, w, n_bins=n_bins,
                                  n_classes=n_classes)

    if mesh is None:
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
        yd = torch.from_numpy(y).to(device)
        w = torch.ones(len(y), dtype=torch.float32, device=device)
        observed = contingency(Xd, yd, w, torch.from_numpy(edges).to(device))
    else:
        xs, ys, w = shard_batch(mesh, np.ascontiguousarray(X, np.float32), y)
        observed = make_tree_aggregate(
            contingency, mesh, replicated_args=(3,), op="chisq.contingency",
        )(xs, ys, w, torch.from_numpy(edges))
    observed = observed.cpu().numpy()
    stats, p_values, _ = chi_square(observed)
    return stats, p_values


class ChiSqSelector(_SelectorParams, Estimator):
    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "ChiSqSelectorModel":
        X = to_host(frame[self.getFeaturesCol()]).astype(np.float32)
        y = to_host(frame[self.getLabelCol()])
        stats, p_values = chi2_scores(X, y, self.getMaxBins(), self.device,
                                      fit_mesh(self.mesh))
        mode = self.getSelectorType()
        threshold = {
            "numTopFeatures": self.getNumTopFeatures(),
            "percentile": self.getPercentile(),
            "fpr": self.getFpr(),
            "fdr": self.getFdr(),
            "fwe": self.getFwe(),
        }[mode]
        selected = select_features_by_mode(
            stats, p_values, mode, threshold, X.shape[1]
        )
        model = ChiSqSelectorModel(selected_features=selected)
        model.setParams(**self.paramValues())
        return model


class ChiSqSelectorModel(_SelectorParams, Model):
    def __init__(self, selected_features: List[int], **kwargs):
        super().__init__(**kwargs)
        self.selected_features = list(selected_features)
        self._index_on = {}  # device -> index tensor, uploaded once

    def _save_extra(self):
        return {"selected_features": self.selected_features}, {}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(selected_features=extra["selected_features"])
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        out = select_columns(frame[self.getFeaturesCol()],
                             self.selected_features, self._index_on)
        return frame.with_column(self.getOutputCol(), out)
