"""VarianceThresholdSelector — drop (near-)constant features.

Counterpart of ``sntc_tpu/feature/variance_selector.py`` (Spark's
``VarianceThresholdSelector``): keep the features whose SAMPLE variance
is strictly greater than ``varianceThreshold`` (default 0.0 — drop
constants).

The variances come from the StandardScaler's one-pass moments
(``standardization_moments``) on the estimator's device, or with a
``mesh=`` of more than one shard as one aggregate over ``shard_batch``'s
rows; the model is a column select, on a tensor on the tensor's device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.feature.selection import select_columns
from sntc_tpu_torch.feature.standard_scaler import standardization_moments
from sntc_tpu_torch.parallel.collectives import fit_device, fit_mesh, shard_batch


class _VtsParams:
    featuresCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="selectedFeatures")
    varianceThreshold = Param(
        "keep features with sample variance > this", default=0.0,
        validator=validators.gteq(0),
    )


class VarianceThresholdSelector(_VtsParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "VarianceThresholdSelectorModel":
        X = frame[self.getFeaturesCol()]
        if X.ndim != 2:
            raise ValueError("featuresCol must be a vector column")
        X = np.asarray(to_host(X), np.float32)
        n = X.shape[0]
        mesh = fit_mesh(self.mesh)
        if mesh is None:
            xs = torch.from_numpy(np.ascontiguousarray(X)).to(self.device)
            ws = torch.ones(n, dtype=torch.float32, device=self.device)
        else:
            xs, ws = shard_batch(mesh, X)
        _, _, var = standardization_moments(
            xs, ws, np.asarray(X[0]) if n else np.zeros(X.shape[1]), mesh
        )
        # standardization_moments returns the population form; Spark
        # compares the UNBIASED sample variance
        var = np.asarray(var, np.float64) * (n / max(n - 1, 1))
        selected = [
            int(j) for j in range(X.shape[1])
            if var[j] > float(self.getVarianceThreshold())
        ]
        model = VarianceThresholdSelectorModel(selectedFeatures=selected)
        model.setParams(**self.paramValues())
        return model


class VarianceThresholdSelectorModel(_VtsParams, Model):
    def __init__(self, selectedFeatures: List[int] = (), **kwargs):
        super().__init__(**kwargs)
        self.selectedFeatures = [int(j) for j in selectedFeatures]
        self._index_on = {}  # device -> index tensor

    def _save_extra(self):
        return {"selectedFeatures": self.selectedFeatures}, {}

    @classmethod
    def _load_from(cls, params, extra, arrays, device=None):
        m = cls(selectedFeatures=extra["selectedFeatures"])
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        out = select_columns(frame[self.getFeaturesCol()],
                             self.selectedFeatures, self._index_on)
        return frame.with_column(self.getOutputCol(), out)
