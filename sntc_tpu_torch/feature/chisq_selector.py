"""ChiSqSelectorModel — the fitted χ² flow-feature selector.

Counterpart of ``ChiSqSelectorModel`` in
``sntc_tpu/feature/chisq_selector.py``: the fitted model is a column
select of ``selected_features`` from the feature vector.  On a tensor
the select runs on the tensor's device.  The fit (binning + contingency
histograms) comes with the fit-side slice and its ``tree_hist`` kernel.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sntc_tpu_torch.core.base import Model
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators


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
        X = frame[self.getFeaturesCol()]
        if isinstance(X, torch.Tensor):
            idx = self._index_on.get(X.device)
            if idx is None:
                idx = torch.tensor(
                    self.selected_features, dtype=torch.long, device=X.device
                )
                self._index_on[X.device] = idx
            out = X.index_select(1, idx)
        else:
            out = np.ascontiguousarray(X[:, self.selected_features])
        return frame.with_column(self.getOutputCol(), out)
