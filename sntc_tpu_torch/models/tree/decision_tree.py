"""DecisionTreeClassifier / DecisionTreeRegressor — single CART trees.

Counterpart of ``sntc_tpu/models/tree/decision_tree.py`` (Spark's
``DecisionTreeClassifier`` and ``DecisionTreeRegressor``): the shared
dense-heap grower with ``T=1``, every feature considered at every node
and no bagging.  Classification leaves hold class-count vectors:
``rawPrediction`` is the leaf's counts, probability the normalized
counts, and one packed ``[N, 2K+1]`` tensor comes back per batch.
Regression leaves hold ``[w, wy, wy²]`` (variance impurity), and the
prediction is the leaf mean ``wy / w``.  The fit's histograms are the
``tree_hist`` kernel on the card, the walk the ``forest_traversal``
kernel; the rest is PyTorch on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.kernels.forest import forest_leaf_stats as _traverse
from sntc_tpu_torch.models.base import (
    ClassificationModel,
    ClassifierEstimator,
    pack_serve_outputs,
)
from sntc_tpu_torch.parallel.collectives import fit_device, fit_mesh
from sntc_tpu_torch.models.tree.grower import (
    Forest,
    ForestDeviceMixin,
    ForestPersistenceMixin,
    RegressionForestMixin,
    extract_regression,
    grow_forest,
    layout_rows,
    validate_forest,
)
from sntc_tpu_torch.ops.binning import bin_features, quantile_bin_edges


def _grow_single_tree(estimator, X: np.ndarray, y: np.ndarray,
                      w: np.ndarray, device, impurity: str) -> Forest:
    """Bin on ``device`` (or over the estimator's mesh) and grow one
    tree over every feature: from the
    one-hot class stats × row weight, or for ``variance`` from the
    regression stats ``[w, wy, wy²]`` of the float targets ``y``."""
    n, F = X.shape
    n_bins = estimator.getMaxBins()
    edges = quantile_bin_edges(X, max_bins=n_bins, seed=estimator.getSeed())
    mesh = fit_mesh(estimator.mesh)
    if mesh is None:
        binned_t = bin_features(
            torch.from_numpy(X).to(device), torch.from_numpy(edges).to(device)
        ).t()
    else:
        binned_t = layout_rows(mesh, X, edges)
    wd = torch.from_numpy(w).to(device)
    if impurity == "variance":
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
        row_stats = torch.stack([wd, wd * yd, wd * yd * yd], dim=1)
    else:
        k = max(int(y.max()) + 1 if n else 2, 2)
        row_stats = torch.nn.functional.one_hot(
            torch.from_numpy(y.astype(np.int64)).to(device), k
        ).to(torch.float32) * wd[:, None]
    return grow_forest(
        binned_t, row_stats, torch.ones((1, n), device=device), edges,
        n_bins=n_bins,
        max_depth=estimator.getMaxDepth(),
        min_instances_per_node=float(estimator.getMinInstancesPerNode()),
        min_info_gain=float(estimator.getMinInfoGain()),
        subset_k=F,  # a single Spark decision tree considers every feature
        impurity=impurity,
    )


class _SingleTreeParams:
    """Spark's DecisionTree params — not the ensemble block: a single
    decision tree has no subsamplingRate or bagging."""

    maxDepth = Param(
        "max tree depth", default=5, validator=validators.in_range(0, 15)
    )
    maxBins = Param(
        "max feature bins", default=32, validator=validators.in_range(2, 256)
    )
    minInstancesPerNode = Param(
        "min (weighted) rows per child", default=1, validator=validators.gteq(1)
    )
    minInfoGain = Param("min split gain", default=0.0, validator=validators.gteq(0))
    seed = Param("binning sample seed", default=0)


def _realized_depth(forest: Forest) -> int:
    """Depth of the deepest materialized node (Spark ``DecisionTreeModel.
    depth``), not the heap capacity ``maxDepth``."""
    exists = np.flatnonzero(forest.feature[0] >= -1)  # leaf or internal
    if exists.size == 0:
        return 0
    return int(np.floor(np.log2(exists[-1] + 1)))


class _DtClassifierParams(_SingleTreeParams):
    impurity = Param(
        "gini | entropy", default="gini",
        validator=validators.one_of("gini", "entropy"),
    )


class DecisionTreeClassifier(_DtClassifierParams, ClassifierEstimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    tree lives on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "DecisionTreeClassificationModel":
        X, y, w = self._extract(frame)
        forest = _grow_single_tree(self, X, y, w, self.device,
                                   self.getImpurity())
        k = max(int(y.max()) + 1 if len(y) else 2, 2)
        model = DecisionTreeClassificationModel(
            forest=forest, n_classes=k, n_features=X.shape[1],
            device=self.device,
        )
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items() if model.hasParam(k2)}
        )
        return model


def _dt_serve(X, feature, threshold, leaf_stats, thr, *, max_depth, mode,
              traverse=_traverse):
    """Traverse + normalize + predict, packed ``[N, 2C+1]``; raw is the
    leaf's class counts.  A check against the plain version passes
    ``forest_leaf_stats_reference`` as ``traverse``."""
    raw = traverse(X, feature, threshold, leaf_stats, max_depth=max_depth)[0]
    prob = raw / raw.sum(dim=1, keepdim=True).clamp_min(1e-12)
    return pack_serve_outputs(raw, prob, thr, mode)


class DecisionTreeClassificationModel(
    _DtClassifierParams, ForestPersistenceMixin, ForestDeviceMixin,
    ClassificationModel,
):
    def __init__(self, forest: Forest, n_classes: int, n_features: int = 0,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        validate_forest(forest, n_features)
        self.forest = forest
        self._n_classes = int(n_classes)
        self._n_features = int(n_features)
        self._upload_forest(resolve_device(device))

    @property
    def num_classes(self) -> int:
        return self._n_classes

    @property
    def depth(self) -> int:
        return _realized_depth(self.forest)

    def _extra_meta(self):
        return {"n_classes": self._n_classes}

    @classmethod
    def _from_forest(cls, forest, extra, device):
        return cls(
            forest=forest,
            n_classes=int(extra["n_classes"]),
            n_features=int(extra.get("n_features", 0)),
            device=device,
        )

    def _predict_all_dev(self, X) -> torch.Tensor:
        mode, thr = self._serve_args()
        return _dt_serve(
            self._features_on_device(X), *self._device_forest(), thr,
            max_depth=self.forest.max_depth, mode=mode,
        )


class _DtRegressorParams(_SingleTreeParams):
    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("target column", default="label")
    predictionCol = Param("output prediction column", default="prediction")
    impurity = Param(
        "variance", default="variance", validator=validators.one_of("variance")
    )


class DecisionTreeRegressor(_DtRegressorParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    tree lives on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "DecisionTreeRegressionModel":
        X, y = extract_regression(self, frame)
        forest = _grow_single_tree(self, X, y, np.ones(len(y), np.float32),
                                   self.device, "variance")
        model = DecisionTreeRegressionModel(
            forest=forest, n_features=X.shape[1], device=self.device)
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items() if model.hasParam(k2)}
        )
        return model


def _dt_reg_predict(X, feature, threshold, leaf_stats, *, max_depth,
                    traverse=_traverse):
    """The leaf mean ``wy / w`` of the one tree, ``[N]`` f32."""
    stats = traverse(X, feature, threshold, leaf_stats,
                     max_depth=max_depth)[0]  # [N, 3] = [w, wy, wy²]
    return stats[:, 1] / stats[:, 0].clamp_min(1e-12)


class DecisionTreeRegressionModel(
    _DtRegressorParams, ForestPersistenceMixin, RegressionForestMixin, Model
):
    def __init__(self, forest: Forest, n_features: int = 0, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        validate_forest(forest, n_features)
        self.forest = forest
        self._n_features = int(n_features)
        self._upload_forest(resolve_device(device))

    @property
    def depth(self) -> int:
        return _realized_depth(self.forest)

    @classmethod
    def _from_forest(cls, forest, extra, device):
        return cls(forest=forest, n_features=int(extra.get("n_features", 0)),
                   device=device)

    def _predict_dev(self, X) -> torch.Tensor:
        return _dt_reg_predict(
            self._features_on_device(X), *self._device_forest(),
            max_depth=self.forest.max_depth,
        )
