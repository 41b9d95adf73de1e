"""GBTRegressor — gradient-boosted regression trees.

Counterpart of ``sntc_tpu/models/tree/gbt_regressor.py`` (Spark's
``GBTRegressor``): the first tree fits the residuals of the constant
mean ``init`` with weight 1.0 for both losses; each later round fits a
variance-impurity tree to the loss's negative gradient — squared loss
``r = y − F`` (leaf = mean residual), absolute loss ``r = sign(y − F)``
(mean-of-sign leaves, Spark's treatment) — and adds it with
``stepSize`` shrinkage.  ``validationIndicatorCol`` / ``validationTol``
stop boosting on a validation plateau (the classifier's
``runWithValidation`` bookkeeping), and ``checkpointInterval`` /
``checkpointDir`` save npz round checkpoints that a re-run fit resumes.

The binned features and the boosted prediction stay on the fit's device
across rounds: each round's histograms are the ``tree_hist`` kernel on
the card over the residual stats ``[w, wr, wr²]``, and its update one
``forest_traversal`` launch.  Serving walks all trees in one launch and
takes the tree-weighted sum of their leaf means.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.parallel.collectives import fit_device
from sntc_tpu_torch.models.base import CheckpointParams
from sntc_tpu_torch.models.tree.gbt import (
    _ValidationTracker,
    _forest_margins,
    _prepare_boosting,
    _stack_forests,
    _tree_values,
)
from sntc_tpu_torch.models.tree.grower import (
    Forest,
    ForestPersistenceMixin,
    RegressionForestMixin,
    extract_regression,
    grow_forest,
    validate_forest,
)
from sntc_tpu_torch.models.tree.random_forest import _TreeEnsembleParams


def _residual_stats(ys, ws, pred, loss: str):
    """Variance stats ``[N, 3]`` of the loss's negative gradient."""
    r = ys - pred
    if loss == "absolute":
        r = torch.sign(r)
    return torch.stack([ws, ws * r, ws * r * r], dim=1)


def _gbt_reg_predict(X, feature, threshold, leaf_stats, tree_weights, *,
                     max_depth):
    """``Σ_m w_m · tree_m(x)`` ``[N]`` f32: one walk of all M trees and
    a weighted contraction."""
    values = _tree_values(X, feature, threshold, leaf_stats,
                          max_depth=max_depth)
    return torch.einsum("m,mn->n", tree_weights, values)


class _GbtRegParams(_TreeEnsembleParams):
    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("target column", default="label")
    predictionCol = Param("output prediction column", default="prediction")
    maxIter = Param("boosting rounds (trees)", default=20, validator=validators.gt(0))
    stepSize = Param("shrinkage", default=0.1, validator=validators.in_range(0, 1))
    lossType = Param(
        "squared | absolute", default="squared",
        validator=validators.one_of("squared", "absolute"),
    )
    featureSubsetStrategy = Param("feature subset per node", default="all")
    validationIndicatorCol = Param(
        "boolean column marking validation rows; when set, boosting stops "
        "early on validation-loss plateau (Spark runWithValidation)",
        default=None,
    )
    validationTol = Param(
        "relative validation-improvement threshold", default=0.01,
        validator=validators.gteq(0),
    )


class GBTRegressor(_GbtRegParams, CheckpointParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    trees live on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "GBTRegressionModel":
        # here, not at the top: mlio's package imports the models
        from sntc_tpu_torch.mlio import optimizer_checkpoint as _ckpt

        dev = self.device
        X, y = extract_regression(self, frame)
        val_col = self.getValidationIndicatorCol()
        if val_col:
            val_mask = to_host(frame[val_col]).astype(bool)
            if not val_mask.any() or val_mask.all():
                raise ValueError(
                    "validationIndicatorCol must mark a non-empty proper "
                    "subset of rows"
                )
            X, y, X_val, y_val = (X[~val_mask], y[~val_mask], X[val_mask],
                                  y[val_mask])
        n, F = X.shape
        n_rounds = self.getMaxIter()
        step = self.getStepSize()
        loss = self.getLossType()
        max_depth = self.getMaxDepth()
        (edges, Xd, ws, binned_t, grow_kwargs, round_mask,
         round_rng) = _prepare_boosting(self, X, np.ones(n, np.float32), dev)
        yd = torch.from_numpy(y).to(dev)

        ckpt_dir = self.getCheckpointDir()
        interval = self.getCheckpointInterval()
        checkpointing = bool(ckpt_dir) and interval > 0
        fingerprint = {
            "algo": "gbt_reg", "maxIter": n_rounds, "maxDepth": max_depth,
            "stepSize": step, "seed": self.getSeed(), "n_rows": n,
            "maxBins": self.getMaxBins(), "loss": loss,
            "subsamplingRate": float(self.getSubsamplingRate()),
            "minInstancesPerNode": float(self.getMinInstancesPerNode()),
            "minInfoGain": float(self.getMinInfoGain()),
            "featureSubsetStrategy": str(self.getFeatureSubsetStrategy()),
            "validation": bool(val_col),
            "validationTol": float(self.getValidationTol()),
        }
        init = float(np.mean(y)) if n else 0.0
        tracker = _ValidationTracker(self.getValidationTol()) if val_col else None
        if val_col:
            X_val_d = torch.from_numpy(np.ascontiguousarray(X_val)).to(dev)
            pred_val = np.full(len(y_val), init, np.float64)
        forests, weights = [], []
        pred = torch.full((n,), init, dtype=torch.float32, device=dev)
        start_round = 0
        saved = _ckpt.load_state(ckpt_dir, fingerprint) if checkpointing else None
        if saved is not None and int(saved["round"]) > 0:
            start_round = int(saved["round"])
            forests = [
                Forest(saved["feature"][i][None], saved["threshold"][i][None],
                       saved["leaf_stats"][i][None], max_depth,
                       saved["gain"][i][None], saved["count"][i][None])
                for i in range(start_round)
            ]
            weights = [float(v) for v in saved["tree_weights"]]
            pred = torch.from_numpy(saved["pred"]).to(dev)
            if val_col:
                pred_val = np.asarray(saved["val_pred"], np.float64)
                tracker.best_err = np.asarray(
                    saved["val_best_err"], np.float64).reshape(1)
                tracker.best_m = np.asarray(
                    saved["val_best_m"], np.int64).reshape(1)
                tracker.done = np.asarray(saved["val_done"], bool).reshape(1)
                if tracker.done[0]:
                    start_round = n_rounds
        for m in range(start_round, n_rounds):
            # Spark fits the FIRST tree to the labels for both losses:
            # the squared residuals of the constant init (variance
            # splits are shift-invariant, the leaf means shift by init)
            row_stats = _residual_stats(yd, ws, pred,
                                        "squared" if m == 0 else loss)
            forest = grow_forest(
                binned_t, row_stats,
                torch.from_numpy(round_mask(m)[None]).to(dev), edges,
                rng=round_rng(m), **grow_kwargs,
            )
            tree_weight = 1.0 if m == 0 else step
            pred = pred + tree_weight * _forest_margins(Xd, forest)[0]
            forests.append(forest)
            weights.append(tree_weight)
            stopped = False
            if val_col:
                contrib = _forest_margins(X_val_d, forest)[0]
                pred_val = pred_val + tree_weight * contrib.cpu().numpy(
                ).astype(np.float64)
                resid = y_val - pred_val
                err = float(np.mean(resid ** 2) if loss == "squared"
                            else np.mean(np.abs(resid)))
                stopped = tracker.update(m, err)
            # saved before the stop is honored, so a resume sees it
            if checkpointing and (m + 1) % interval == 0:
                one = _stack_forests(forests, 0, max_depth)
                state = {
                    "round": m + 1,
                    "feature": one.feature, "threshold": one.threshold,
                    "leaf_stats": one.leaf_stats, "gain": one.gain,
                    "count": one.count,
                    "tree_weights": np.asarray(weights, np.float64),
                    "pred": pred.cpu().numpy(),
                }
                if val_col:
                    state.update(val_pred=pred_val,
                                 val_best_err=tracker.best_err,
                                 val_best_m=tracker.best_m,
                                 val_done=tracker.done)
                _ckpt.save_state(ckpt_dir, state, fingerprint)
            if stopped:
                break

        # a completed fit owns no checkpoint
        if checkpointing:
            _ckpt.clear_state(ckpt_dir)
        # validated boosting keeps the best round's trees (Spark's bestM)
        keep = int(tracker.best_m[0]) if tracker else len(forests)
        model = GBTRegressionModel(
            forest=_stack_forests(forests[:keep], 0, max_depth),
            init_prediction=init, treeWeights=weights[:keep],
            n_features=F, device=dev,
        )
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items()
               if model.hasParam(k2)}
        )
        return model


class GBTRegressionModel(
    _GbtRegParams, ForestPersistenceMixin, RegressionForestMixin, Model
):
    def __init__(self, forest: Forest, init_prediction: float = 0.0,
                 treeWeights=(), n_features: int = 0, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        validate_forest(forest, n_features)
        self.forest = forest
        self.init_prediction = float(init_prediction)
        self.treeWeights = [float(v) for v in treeWeights]
        self._n_features = int(n_features)
        self._upload_forest(resolve_device(device))
        self._dev_tree_weights = torch.tensor(
            self.treeWeights, dtype=torch.float32, device=self.device)

    @property
    def numTrees(self) -> int:
        return self.forest.feature.shape[0]

    @property
    def featureImportances(self) -> np.ndarray:
        n = self._n_features or int(self.forest.feature.max()) + 1
        # boosted ensembles do not normalize per tree (Spark)
        return self.forest.feature_importances(
            n, per_tree_normalization=False)

    def _extra_meta(self):
        return {"init_prediction": self.init_prediction,
                "treeWeights": self.treeWeights}

    @classmethod
    def _from_forest(cls, forest, extra, device):
        return cls(
            forest=forest,
            init_prediction=float(extra.get("init_prediction", 0.0)),
            treeWeights=extra.get("treeWeights", []),
            n_features=int(extra.get("n_features", 0)),
            device=device,
        )

    def _predict_dev(self, X) -> torch.Tensor:
        return _gbt_reg_predict(
            self._features_on_device(X), *self._device_forest(),
            self._dev_tree_weights, max_depth=self.forest.max_depth,
        )

    def _to_prediction(self, host: np.ndarray) -> np.ndarray:
        return self.init_prediction + host.astype(np.float64)
