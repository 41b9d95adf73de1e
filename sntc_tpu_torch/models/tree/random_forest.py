"""RandomForestClassifier — histogram CART forest, fit and serve.

Counterpart of ``sntc_tpu/models/tree/random_forest.py`` (Spark's
``RandomForestClassifier``): quantile binning (``maxBins``),
Poisson(subsamplingRate) bootstrap bagging, level-wise growth of all
trees per pass (``grower.grow_forest``, whose histograms are the
``tree_hist`` kernel on the card), gini/entropy impurity and a
per-node ``featureSubsetStrategy``.

The model's ``rawPrediction`` is the sum over trees of each tree's leaf
class counts normalized per tree, probability the normalized raw.  The
walk runs through the ``forest_traversal`` kernel on the card; the sums
and the prediction are PyTorch on the same device, and one packed
``[N, 2K+1]`` tensor comes back per batch.  A fitted model carries the
training summary (``model.summary``), computed lazily.
"""

from __future__ import annotations

import numpy as np
import torch

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
    grow_forest,
    layout_rows,
    make_bagging_weights,
    resolve_feature_subset_k,
    validate_forest,
)
from sntc_tpu_torch.models.summary import (
    BinaryClassificationTrainingSummary,
    ClassificationTrainingSummary,
)
from sntc_tpu_torch.ops.binning import bin_features, quantile_bin_edges


class _TreeEnsembleParams:
    maxDepth = Param("max tree depth", default=5, validator=validators.in_range(0, 15))
    maxBins = Param("max feature bins", default=32, validator=validators.in_range(2, 256))
    minInstancesPerNode = Param(
        "min (weighted) rows per child", default=1, validator=validators.gteq(1)
    )
    minInfoGain = Param("min split gain", default=0.0, validator=validators.gteq(0))
    subsamplingRate = Param(
        "row sampling rate per tree", default=1.0, validator=validators.in_range(0, 1)
    )
    seed = Param("sampling seed", default=0)


class _RfParams(_TreeEnsembleParams):
    numTrees = Param("number of trees", default=20, validator=validators.gt(0))
    impurity = Param(
        "gini | entropy", default="gini", validator=validators.one_of("gini", "entropy")
    )
    featureSubsetStrategy = Param(
        "auto | all | sqrt | log2 | onethird | int | fraction string",
        default="auto",
    )
    bootstrap = Param("Poisson bootstrap bagging", default=True,
                      validator=validators.is_bool())


class RandomForestClassifier(_RfParams, ClassifierEstimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    forest lives on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "RandomForestClassificationModel":
        X, y, w = self._extract(frame)
        n, F = X.shape
        k = max(int(y.max()) + 1 if n else 2, 2)
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
        yd = torch.from_numpy(y.astype(np.int64)).to(dev)
        row_stats = (torch.nn.functional.one_hot(yd, k).to(torch.float32)
                     * torch.from_numpy(w).to(dev)[:, None])
        rng = np.random.default_rng(seed)
        w_trees = torch.from_numpy(make_bagging_weights(
            rng, self.getBootstrap(), self.getSubsamplingRate(), T, n,
        )).to(dev)
        subset_k = resolve_feature_subset_k(
            self.getFeatureSubsetStrategy(), F, T, is_classification=True
        )
        forest = grow_forest(
            binned_t, row_stats, w_trees, edges,
            n_bins=n_bins,
            max_depth=self.getMaxDepth(),
            min_instances_per_node=float(self.getMinInstancesPerNode()),
            min_info_gain=float(self.getMinInfoGain()),
            subset_k=subset_k,
            impurity=self.getImpurity(),
            rng=rng,
        )
        model = RandomForestClassificationModel(
            forest=forest, n_classes=k, n_features=F, device=dev
        )
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items() if model.hasParam(k2)}
        )
        # Spark's RandomForestClassificationTrainingSummary: the training
        # predictions' metrics, lazily (a forest has no objective
        # history); a binary fit gets the threshold curves too
        summary_cls = (BinaryClassificationTrainingSummary if k == 2
                       else ClassificationTrainingSummary)
        model.summary = summary_cls([], 0, model, frame,
                                    labelCol=self.getLabelCol())
        return model


def _rf_raw(X, feature, threshold, leaf_stats, *, max_depth,
            traverse=_traverse):
    """Summed per-tree normalized leaf votes ``[N, C]``."""
    stats = traverse(
        X, feature, threshold, leaf_stats, max_depth=max_depth
    )  # [T, N, C]
    totals = stats.sum(dim=2, keepdim=True)
    probs = stats / totals.clamp_min(1e-12)
    return probs.sum(dim=0)


def _rf_serve(X, feature, threshold, leaf_stats, thr, *, max_depth, mode,
              traverse=_traverse):
    """Traverse + normalize + predict, packed ``[N, 2C+1]``.  ``traverse``
    is the dispatching kernel wrapper; a check against the plain version
    passes ``forest_leaf_stats_reference`` instead."""
    raw = _rf_raw(X, feature, threshold, leaf_stats, max_depth=max_depth,
                  traverse=traverse)
    prob = raw / raw.sum(dim=1, keepdim=True).clamp_min(1e-12)
    return pack_serve_outputs(raw, prob, thr, mode)


class RandomForestClassificationModel(
    _RfParams, ForestPersistenceMixin, ForestDeviceMixin, ClassificationModel
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
    def trees(self) -> Forest:
        return self.forest

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

        self._upload_forest(resolve_device(device))
    def _predict_all_dev(self, X) -> torch.Tensor:
        mode, thr = self._serve_args()
        fa, ta, ls = self._device_forest()
        return _rf_serve(
            self._features_on_device(X), fa, ta, ls, thr,
            max_depth=self.forest.max_depth, mode=mode,
        )


def from_numpy_forest(feature, threshold, leaf_stats, max_depth: int,
                      n_classes: int, device="cuda", n_features: int = 0,
                      **params) -> RandomForestClassificationModel:
    """A serving model from dense-heap numpy arrays (no fit needed): the
    way to stand up a forest of any width from a seed."""
    forest = Forest(
        np.ascontiguousarray(feature, np.int32),
        np.ascontiguousarray(threshold, np.float32),
        np.ascontiguousarray(leaf_stats, np.float32),
        int(max_depth),
    )
    m = RandomForestClassificationModel(
        forest=forest, n_classes=n_classes, n_features=n_features,
        device=device,
    )
    m.setParams(maxDepth=int(max_depth), numTrees=int(forest.feature.shape[0]),
                **params)
    return m
