"""RandomForestRegressor — an averaged variance-impurity CART forest.

Counterpart of ``sntc_tpu/models/tree/random_forest_regressor.py``
(Spark's ``RandomForestRegressor``): the classification forest's
machinery (quantile binning, Poisson bagging, level-wise growth of all
trees per pass, ``featureSubsetStrategy``, whose ``auto`` is onethird
for regression) with the variance impurity over the stats ``[w, wy,
wy²]``, shared by every tree and weighted per tree by its bagging
counts inside the ``tree_hist`` kernel.  The prediction is the mean over
trees of each tree's leaf mean: one ``forest_traversal`` launch and a
mean on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.kernels.forest import forest_leaf_stats as _traverse
from sntc_tpu_torch.parallel.collectives import fit_device, fit_mesh
from sntc_tpu_torch.models.tree.grower import (
    Forest,
    ForestPersistenceMixin,
    RegressionForestMixin,
    extract_regression,
    grow_forest,
    layout_rows,
    make_bagging_weights,
    resolve_feature_subset_k,
    validate_forest,
)
from sntc_tpu_torch.models.tree.random_forest import _TreeEnsembleParams
from sntc_tpu_torch.ops.binning import bin_features, quantile_bin_edges


class _RfRegParams(_TreeEnsembleParams):
    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("target column", default="label")
    predictionCol = Param("output prediction column", default="prediction")
    numTrees = Param("number of trees", default=20, validator=validators.gt(0))
    impurity = Param(
        "variance", default="variance", validator=validators.one_of("variance")
    )
    featureSubsetStrategy = Param(
        "auto | all | sqrt | log2 | onethird | int | fraction string",
        default="auto",
    )
    bootstrap = Param("Poisson bootstrap bagging", default=True,
                      validator=validators.is_bool())


class RandomForestRegressor(_RfRegParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    forest lives on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "RandomForestRegressionModel":
        X, y = extract_regression(self, frame)
        n, F = X.shape
        T = self.getNumTrees()
        n_bins = self.getMaxBins()
        seed = self.getSeed()
        dev = self.device

        edges = quantile_bin_edges(X, max_bins=n_bins, seed=seed)
        mesh = fit_mesh(self.mesh)
        if mesh is None:
            binned_t = bin_features(
                torch.from_numpy(X).to(dev), torch.from_numpy(edges).to(dev)
            ).t()
        else:
            binned_t = layout_rows(mesh, X, edges)
        yd = torch.from_numpy(y).to(dev)
        ws = torch.ones(n, dtype=torch.float32, device=dev)
        row_stats = torch.stack([ws, ws * yd, ws * yd * yd], dim=1)
        rng = np.random.default_rng(seed)
        w_trees = torch.from_numpy(make_bagging_weights(
            rng, self.getBootstrap(), self.getSubsamplingRate(), T, n,
        )).to(dev)
        subset_k = resolve_feature_subset_k(
            self.getFeatureSubsetStrategy(), F, T, is_classification=False
        )
        forest = grow_forest(
            binned_t, row_stats, w_trees, edges,
            n_bins=n_bins,
            max_depth=self.getMaxDepth(),
            min_instances_per_node=float(self.getMinInstancesPerNode()),
            min_info_gain=float(self.getMinInfoGain()),
            subset_k=subset_k,
            impurity="variance",
            rng=rng,
        )
        model = RandomForestRegressionModel(forest=forest, n_features=F,
                                            device=dev)
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items()
               if model.hasParam(k2)}
        )
        return model


def _rf_reg_predict(X, feature, threshold, leaf_stats, *, max_depth,
                    traverse=_traverse):
    """The mean over trees of each tree's leaf mean, ``[N]`` f32."""
    stats = traverse(X, feature, threshold, leaf_stats,
                     max_depth=max_depth)  # [T, N, 3] = [w, wy, wy²]
    means = stats[:, :, 1] / stats[:, :, 0].clamp_min(1e-12)
    return means.mean(dim=0)


class RandomForestRegressionModel(
    _RfRegParams, ForestPersistenceMixin, RegressionForestMixin, Model
):
    def __init__(self, forest: Forest, n_features: int = 0, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        validate_forest(forest, n_features)
        self.forest = forest
        self._n_features = int(n_features)
        self._upload_forest(resolve_device(device))

    @property
    def trees(self) -> Forest:
        return self.forest

    @classmethod
    def _from_forest(cls, forest, extra, device):
        return cls(forest=forest, n_features=int(extra.get("n_features", 0)),
                   device=device)

    def _predict_dev(self, X) -> torch.Tensor:
        return _rf_reg_predict(
            self._features_on_device(X), *self._device_forest(),
            max_depth=self.forest.max_depth,
        )
