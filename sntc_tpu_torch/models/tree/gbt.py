"""GBTClassifier — gradient-boosted trees, binary logistic loss.

Counterpart of ``sntc_tpu/models/tree/gbt.py`` (Spark's
``GBTClassifier``): labels map to {-1, +1}; the first tree is a plain
regression fit to the signed labels (weight 1.0); each later round fits
a variance-impurity regression tree to the Friedman pseudo-residuals
``2y / (1 + exp(2·y·F))`` and adds it with ``stepSize`` shrinkage.
Binary only: OneVsRest wraps it for 15 classes, and
:func:`fit_gbt_ovr_vectorized` grows the K classes as K trees a round
from per-class stats ``[K, N, 3]``.  ``rawPrediction`` is
``[-2F, 2F]`` and probability the logistic of it.

The binned features and the margins stay on the fit's device across
rounds.  Each round's histograms are the ``tree_hist`` kernel on the
card (per-tree stats in the one-vs-rest fit), and its margins one
``forest_leaf_stats`` launch over the round's trees; the stats and
margin updates are PyTorch on the same device.  Serving walks all trees
in one ``forest_traversal`` launch.  A binary fit carries Spark's
training summary (``model.summary``, computed lazily); the vectorized
one-vs-rest fit's sub-models carry none, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.kernels.forest import forest_leaf_stats as _traverse
from sntc_tpu_torch.models.base import (
    CheckpointParams,
    ClassificationModel,
    ClassifierEstimator,
    pack_serve_outputs,
)
from sntc_tpu_torch.parallel.collectives import fit_device, fit_mesh
from sntc_tpu_torch.models.tree.grower import (
    Forest,
    ForestDeviceMixin,
    grow_forest,
    layout_rows,
    resolve_feature_subset_k,
    validate_forest,
)
from sntc_tpu_torch.models.summary import BinaryClassificationTrainingSummary
from sntc_tpu_torch.models.tree.random_forest import _TreeEnsembleParams
from sntc_tpu_torch.ops.binning import bin_features, quantile_bin_edges


def _residual_stats(y_signed, ws, margin):
    """Friedman pseudo-residuals for logistic loss -> variance stats
    ``[..., N, 3]``."""
    r = 2.0 * y_signed / (1.0 + torch.exp(2.0 * y_signed * margin))
    ws = ws.expand_as(r)
    return torch.stack([ws, ws * r, ws * r * r], dim=-1)


def _label_stats(y_signed, ws):
    ws = ws.expand_as(y_signed)
    return torch.stack([ws, ws * y_signed, ws * y_signed * y_signed], dim=-1)


def _tree_values(X, feature, threshold, leaf_stats, *, max_depth,
                 traverse=_traverse):
    """Every tree's leaf value (mean residual) for every row, ``[M, N]``:
    one walk of all ``M`` trees."""
    stats = traverse(X, feature, threshold, leaf_stats, max_depth=max_depth)
    return stats[..., 1] / stats[..., 0].clamp_min(1e-12)


def _forest_margins(X, forest: Forest):
    """Leaf values ``[T, N]`` of a round's host-side trees (tree t is
    class t's tree in the one-vs-rest fit): one ``forest_leaf_stats``
    launch on the card."""
    dev = X.device
    return _tree_values(
        X, *(torch.from_numpy(a).to(dev) for a in (
            forest.feature, forest.threshold, forest.leaf_stats)),
        max_depth=forest.max_depth,
    )


def _prepare_boosting(classifier: "GBTClassifier", X: np.ndarray, w, device,
                      mesh=None):
    """Shared boosting setup of the sequential (binary, checkpointable)
    and the vectorized one-vs-rest fits — one place for the bin edges,
    the grower's arguments and the per-round subsample mask, so that the
    two grow the same trees.  The histograms run over ``mesh`` (default
    the classifier's)."""
    n, F = X.shape
    n_bins = classifier.getMaxBins()
    seed = classifier.getSeed()
    rate = classifier.getSubsamplingRate()

    edges = quantile_bin_edges(X, max_bins=n_bins, seed=seed)
    Xd = torch.from_numpy(np.ascontiguousarray(X)).to(device)
    mesh = fit_mesh(classifier.mesh if mesh is None else mesh)
    if mesh is None:
        binned_t = bin_features(Xd, torch.from_numpy(edges).to(device)).t()
    else:
        # the margins stay whole on the first device; the histograms
        # run per shard on rows laid out once
        binned_t = layout_rows(mesh, X, edges)
    ws = torch.from_numpy(np.asarray(w, np.float32)).to(device)

    subset_k = resolve_feature_subset_k(
        classifier.getFeatureSubsetStrategy(), F, 1, is_classification=False
    )
    grow_kwargs = dict(
        n_bins=n_bins,
        max_depth=classifier.getMaxDepth(),
        min_instances_per_node=float(classifier.getMinInstancesPerNode()),
        min_info_gain=float(classifier.getMinInfoGain()),
        subset_k=subset_k,
        impurity="variance",
    )

    def round_mask(i: int) -> np.ndarray:
        """Host ``[n]`` subsample mask of boosting round ``i``, seeded per
        round so that a resumed fit draws the same masks."""
        if rate < 1.0:
            r = np.random.default_rng(seed + 7919 * (i + 1))
            return (r.random(n) < rate).astype(np.float32)
        return np.ones(n, np.float32)

    def round_rng(i: int):
        """The feature-subset draws of round ``i`` (none at the default
        ``featureSubsetStrategy="all"``)."""
        return np.random.default_rng(seed + i) if subset_k < F else None

    return edges, Xd, ws, binned_t, grow_kwargs, round_mask, round_rng


class _GbtParams(_TreeEnsembleParams):
    maxIter = Param("boosting rounds (trees)", default=20, validator=validators.gt(0))
    stepSize = Param("shrinkage", default=0.1, validator=validators.in_range(0, 1))
    lossType = Param(
        "boosting loss", default="logistic", validator=validators.one_of("logistic")
    )
    featureSubsetStrategy = Param("feature subset per node", default="all")
    validationIndicatorCol = Param(
        "boolean column marking validation rows; when set, boosting stops "
        "early on validation-loss plateau (Spark runWithValidation)",
        default=None,
    )
    validationTol = Param(
        "early-stop threshold on validation-loss improvement",
        default=0.01,
        validator=validators.gteq(0),
    )


def _validation_error(margin, y_signed, w):
    """Spark ``LogLoss.computeError``: weighted mean of
    ``2·log1p(exp(-2·y·F))`` over the validation rows."""
    loss = 2.0 * np.logaddexp(
        0.0,
        -2.0 * np.asarray(y_signed, np.float64) * np.asarray(margin, np.float64),
    )
    w = np.asarray(w, np.float64)
    return np.sum(w * loss, axis=-1) / np.sum(w)


class _ValidationTracker:
    """Spark ``GradientBoostedTrees.boost`` validated-stop bookkeeping.

    After round 0 the first error seeds ``best``; for each later round,
    stop when the improvement over ``best`` falls below
    ``tol * max(current, 0.01)``, else record a new best.  The final model
    keeps ``best_m`` trees (the stopping round's tree is discarded).
    ``k > 1`` tracks one-vs-rest classes independently (per-class stop,
    global loop end when all classes are done).
    """

    def __init__(self, tol: float, k: int = 1):
        self.tol = float(tol)
        self.best_err = np.full(k, np.inf)
        self.best_m = np.zeros(k, np.int64)
        self.done = np.zeros(k, bool)

    def update(self, round_idx: int, errs) -> bool:
        errs = np.atleast_1d(np.asarray(errs, np.float64))
        for i, err in enumerate(errs):
            if self.done[i]:
                continue
            if round_idx == 0:
                self.best_err[i] = err
                self.best_m[i] = 1
            elif self.best_err[i] - err < self.tol * max(err, 0.01):
                self.done[i] = True
            elif err < self.best_err[i]:
                self.best_err[i] = err
                self.best_m[i] = round_idx + 1
        return bool(self.done.all())


def _split_validation(X, y, w, val_mask):
    """(train X, y, w, validation X, y, w) for a validation mask."""
    val_mask = np.asarray(val_mask).astype(bool)
    if not val_mask.any() or val_mask.all():
        raise ValueError(
            "validationIndicatorCol must mark a non-empty proper subset "
            "of rows"
        )
    return (X[~val_mask], y[~val_mask], w[~val_mask],
            X[val_mask], y[val_mask], w[val_mask])


def _stack_forests(forests, c: int, max_depth: int) -> Forest:
    """The ``c``-th tree of every round's forest, as one forest."""
    return Forest(
        feature=np.stack([f.feature[c] for f in forests]),
        threshold=np.stack([f.threshold[c] for f in forests]),
        leaf_stats=np.stack([f.leaf_stats[c] for f in forests]),
        max_depth=max_depth,
        gain=np.stack([f.gain[c] for f in forests]),
        count=np.stack([f.count[c] for f in forests]),
    )


class GBTClassifier(_GbtParams, CheckpointParams, ClassifierEstimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    trees live on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "GBTClassificationModel":
        # here, not at the top: mlio's package imports the models
        from sntc_tpu_torch.mlio import optimizer_checkpoint as _ckpt

        dev = self.device
        X, y, w = self._extract(frame)
        val_col = self.getValidationIndicatorCol()
        if val_col:
            X, y, w, X_val, y_val, w_val = _split_validation(
                X, y, w, to_host(frame[val_col]))
        n, F = X.shape
        y_max = int(y.max(initial=0))
        if val_col:
            # validation rows must satisfy the binary contract too
            y_max = max(y_max, int(y_val.max(initial=0)))
        if y_max > 1:
            raise ValueError(
                "GBTClassifier is binary-only (Spark parity); wrap in "
                "OneVsRest for multiclass"
            )
        n_rounds = self.getMaxIter()
        step = self.getStepSize()
        (edges, Xd, ws, binned_t, grow_kwargs, round_mask,
         round_rng) = _prepare_boosting(self, X, w, dev)
        y_signed = torch.from_numpy(2.0 * y.astype(np.float32) - 1.0).to(dev)

        # round checkpoints: a resume skips the completed rounds,
        # restoring their trees and margins
        ckpt_dir = self.getCheckpointDir()
        interval = self.getCheckpointInterval()
        checkpointing = bool(ckpt_dir) and interval > 0
        fingerprint = {
            "algo": "gbt", "maxIter": n_rounds, "maxDepth": self.getMaxDepth(),
            "stepSize": step, "seed": self.getSeed(), "n_rows": n,
            "maxBins": self.getMaxBins(),
            "subsamplingRate": float(self.getSubsamplingRate()),
            "minInstancesPerNode": float(self.getMinInstancesPerNode()),
            "minInfoGain": float(self.getMinInfoGain()),
            "featureSubsetStrategy": str(self.getFeatureSubsetStrategy()),
            "validation": bool(val_col),
            "validationTol": float(self.getValidationTol()),
        }
        tracker = _ValidationTracker(self.getValidationTol()) if val_col else None
        if val_col:
            X_val_d = torch.from_numpy(np.ascontiguousarray(X_val)).to(dev)
            y_signed_val = 2.0 * y_val.astype(np.float64) - 1.0
            margin_val = np.zeros(len(y_val), np.float64)
        forests, weights = [], []
        margin = torch.zeros(n, dtype=torch.float32, device=dev)
        start_round = 0
        saved = _ckpt.load_state(ckpt_dir, fingerprint) if checkpointing else None
        if saved is not None and int(saved["round"]) > 0 and (
                not val_col or "val_done" in saved):
            start_round = int(saved["round"])
            forests = [
                Forest(saved["feature"][i][None], saved["threshold"][i][None],
                       saved["leaf_stats"][i][None], self.getMaxDepth(),
                       saved["gain"][i][None], saved["count"][i][None])
                for i in range(start_round)
            ]
            weights = [float(v) for v in saved["tree_weights"]]
            margin = torch.from_numpy(saved["margin"]).to(dev)
            if val_col:
                margin_val = np.asarray(saved["val_margin"], np.float64)
                tracker.best_err = np.asarray(
                    saved["val_best_err"], np.float64).reshape(1)
                tracker.best_m = np.asarray(
                    saved["val_best_m"], np.int64).reshape(1)
                tracker.done = np.asarray(saved["val_done"], bool).reshape(1)
                if tracker.done[0]:
                    start_round = n_rounds
        for m in range(start_round, n_rounds):
            if m == 0:
                row_stats = _label_stats(y_signed, ws)
                tree_weight = 1.0
            else:
                row_stats = _residual_stats(y_signed, ws, margin)
                tree_weight = step
            forest = grow_forest(
                binned_t, row_stats,
                torch.from_numpy(round_mask(m)[None]).to(dev), edges,
                rng=round_rng(m), **grow_kwargs,
            )
            margin = margin + tree_weight * _forest_margins(Xd, forest)[0]
            forests.append(forest)
            weights.append(tree_weight)
            stopped = False
            if val_col:
                contrib = _forest_margins(X_val_d, forest)[0]
                margin_val = margin_val + tree_weight * contrib.cpu().numpy(
                ).astype(np.float64)
                err = _validation_error(margin_val, y_signed_val, w_val)
                stopped = tracker.update(m, err)
            if checkpointing and (m + 1) % interval == 0:
                one = _stack_forests(forests, 0, self.getMaxDepth())
                state = {
                    "round": m + 1,
                    "feature": one.feature, "threshold": one.threshold,
                    "leaf_stats": one.leaf_stats, "gain": one.gain,
                    "count": one.count,
                    "tree_weights": np.asarray(weights, np.float32),
                    "margin": margin.cpu().numpy(),
                }
                if val_col:
                    state.update(val_margin=margin_val,
                                 val_best_err=tracker.best_err,
                                 val_best_m=tracker.best_m,
                                 val_done=tracker.done)
                _ckpt.save_state(ckpt_dir, state, fingerprint)
            if stopped:
                break

        if val_col:
            keep = int(tracker.best_m[0])
            forests, weights = forests[:keep], weights[:keep]
        if checkpointing:
            _ckpt.clear_state(ckpt_dir)
        model = GBTClassificationModel(
            forest=_stack_forests(forests, 0, self.getMaxDepth()),
            tree_weights=np.asarray(weights, np.float32),
            n_features=F, device=dev,
        )
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items() if model.hasParam(k2)}
        )
        # Spark's BinaryGBTClassifierTrainingSummary: no objective
        # history, the trees kept as its iteration count
        model.summary = BinaryClassificationTrainingSummary(
            [], len(weights), model, frame, labelCol=self.getLabelCol())
        return model


def _gbt_margin(X, feature, threshold, leaf_stats, tree_weights, *,
                max_depth, traverse=_traverse):
    """The boosted margin ``F [N]``: the tree-weighted sum of leaf
    values."""
    values = _tree_values(X, feature, threshold, leaf_stats,
                          max_depth=max_depth, traverse=traverse)
    return torch.einsum("m,mn->n", tree_weights, values)


def _ovr_fused_raw(X, feature, threshold, leaf_stats, sel, *, max_depth,
                   traverse=_traverse):
    """Fused OneVsRest(GBT) raw scores ``[N, K]``: ONE walk of all K
    classes' trees (concatenated on the tree axis), then the ``[K, M]``
    class-selection product of their leaf values."""
    values = _tree_values(X, feature, threshold, leaf_stats,
                          max_depth=max_depth, traverse=traverse)
    margins = sel @ values  # [K, N]
    return (2.0 * margins).t()  # raw class-1 score = 2F


def _gbt_serve(X, feature, threshold, leaf_stats, tree_weights, thr, *,
               max_depth, mode, traverse=_traverse):
    """Traverse + margin + sigmoid + predict, packed ``[N, 5]``.  A
    check against the plain version passes
    ``forest_leaf_stats_reference`` as ``traverse``."""
    m = _gbt_margin(X, feature, threshold, leaf_stats, tree_weights,
                    max_depth=max_depth, traverse=traverse)
    raw = torch.stack([-2.0 * m, 2.0 * m], dim=1)
    p1 = torch.sigmoid(2.0 * m)
    prob = torch.stack([1.0 - p1, p1], dim=1)
    return pack_serve_outputs(raw, prob, thr, mode)


class GBTClassificationModel(_GbtParams, ForestDeviceMixin, ClassificationModel):
    def __init__(self, forest: Forest, tree_weights: np.ndarray,
                 n_features: int = 0, device="cuda", **kwargs):
        super().__init__(**kwargs)
        validate_forest(forest, n_features)
        self.forest = forest
        self.treeWeights = np.asarray(tree_weights, np.float32)
        self._n_features = int(n_features)
        self._upload_forest(resolve_device(device))
        self._dev_tree_weights = torch.from_numpy(self.treeWeights).to(
            self.device)

    @property
    def num_classes(self) -> int:
        return 2

    @property
    def numTrees(self) -> int:
        """Trees kept — ``< maxIter`` after a validated-boosting stop."""
        return int(len(self.treeWeights))

    def _save_extra(self):
        return (
            {"max_depth": self.forest.max_depth,
             "n_features": self._n_features},
            {
                "feature": self.forest.feature,
                "threshold": self.forest.threshold,
                "leaf_stats": self.forest.leaf_stats,
                "gain": self.forest.gain,
                "count": self.forest.count,
                "tree_weights": self.treeWeights,
            },
        )

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        forest = Forest(
            arrays["feature"], arrays["threshold"], arrays["leaf_stats"],
            int(extra["max_depth"]),
            arrays.get("gain"), arrays.get("count"),
        )
        m = cls(
            forest=forest,
            tree_weights=arrays["tree_weights"],
            n_features=int(extra.get("n_features", 0)),
            device=device,
        )
        m.setParams(**params)
        return m

    @property
    def featureImportances(self) -> np.ndarray:
        n = self._n_features or int(self.forest.feature.max()) + 1
        # Spark's GBTClassificationModel passes perTreeNormalization=false
        return self.forest.feature_importances(
            n, per_tree_normalization=False
        )

    def margin(self, X) -> torch.Tensor:
        """The boosted margin ``F [N]`` on the model's device."""
        return _gbt_margin(
            self._features_on_device(X), *self._device_forest(),
            self._dev_tree_weights, max_depth=self.forest.max_depth,
        )

    def _predict_all_dev(self, X) -> torch.Tensor:
        mode, thr = self._serve_args()
        return _gbt_serve(
            self._features_on_device(X), *self._device_forest(),
            self._dev_tree_weights, thr, max_depth=self.forest.max_depth,
            mode=mode,
        )


def fit_gbt_ovr_vectorized(
    classifier: GBTClassifier,
    X: np.ndarray,
    y: np.ndarray,
    w: np.ndarray,
    num_classes: int,
    mesh=None,
    val_mask: Optional[np.ndarray] = None,
) -> list:
    """All K one-vs-rest binary GBT fits in ONE boosting loop, its
    histograms over ``mesh`` (default the classifier's).

    The class axis rides the grower's tree axis: every round grows K
    trees over the SAME binned features with per-class residual stats
    ``[K, N, 3]`` (one ``tree_hist`` launch per node group for all K),
    and takes their margins in one ``forest_leaf_stats`` launch.

    It grows the sequential fits' trees when ``featureSubsetStrategy=
    "all"`` (the GBT default): the per-round subsample mask is shared by
    the classes, as the sequential sub-fits, which carry one seed, share
    it.  With feature subsets the per-class draws differ from the
    sequential fits'.

    Validated boosting (``val_mask`` rows held out, Spark
    ``runWithValidation``): each class keeps its own ``best_m`` trees,
    while the joint loop runs until every class has stopped (the trees
    grown for a class after its stop are dropped), as the sequential
    per-class sub-fits do.

    Returns a list of K fitted :class:`GBTClassificationModel`.
    """
    dev = classifier.device
    if val_mask is not None:
        X, y, w, X_val, y_val, w_val = _split_validation(X, y, w, val_mask)
    n, F = X.shape
    K = int(num_classes)
    n_rounds = classifier.getMaxIter()
    step = classifier.getStepSize()
    max_depth = classifier.getMaxDepth()

    (edges, Xd, ws, binned_t, grow_kwargs, round_mask,
     round_rng) = _prepare_boosting(classifier, X, w, dev, mesh)
    tracker = None
    if val_mask is not None:
        tracker = _ValidationTracker(classifier.getValidationTol(), k=K)
        X_val_d = torch.from_numpy(np.ascontiguousarray(X_val)).to(dev)
        y_signed_val = (
            2.0 * (y_val[None, :] == np.arange(K)[:, None]) - 1.0
        ).astype(np.float64)  # [K, Nv]
        margins_val = np.zeros((K, len(y_val)), np.float64)
    yd = torch.from_numpy(y.astype(np.int64)).to(dev)
    y_signed = (
        2.0 * (yd[None, :] == torch.arange(K, device=dev)[:, None]) - 1.0
    ).to(torch.float32)  # [K, N]

    margins = torch.zeros((K, n), dtype=torch.float32, device=dev)
    forests, weights = [], []
    for m in range(n_rounds):
        if m == 0:
            row_stats = _label_stats(y_signed, ws)  # [K, N, 3]
            tree_weight = 1.0
        else:
            row_stats = _residual_stats(y_signed, ws, margins)
            tree_weight = step
        # one [n] upload; the K-way copy is a broadcast view on the device
        mask = torch.from_numpy(round_mask(m)).to(dev)
        forest = grow_forest(
            binned_t, row_stats, mask[None].expand(K, n).contiguous(), edges,
            rng=round_rng(m), **grow_kwargs,
        )
        margins = margins + tree_weight * _forest_margins(Xd, forest)
        forests.append(forest)
        weights.append(tree_weight)
        if tracker is not None:
            contribs = _forest_margins(X_val_d, forest)  # [K, Nv]
            margins_val = margins_val + tree_weight * contribs.cpu().numpy(
            ).astype(np.float64)
            if tracker.update(m, _validation_error(margins_val, y_signed_val,
                                                   w_val)):
                break

    tree_weights = np.asarray(weights, np.float32)
    models = []
    for c in range(K):
        keep = int(tracker.best_m[c]) if tracker is not None else len(forests)
        model = GBTClassificationModel(
            forest=_stack_forests(forests[:keep], c, max_depth),
            tree_weights=tree_weights[:keep], n_features=F, device=dev,
        )
        model.setParams(
            **{k2: v for k2, v in classifier.paramValues().items()
               if model.hasParam(k2)}
        )
        models.append(model)
    return models
