"""OneVsRest — K binary reductions of a multiclass problem.

Counterpart of ``sntc_tpu/models/one_vs_rest.py`` (Spark's
``OneVsRest``): fit one copy of the base classifier per class on
relabeled {rest=0, class=1} data; the prediction is the argmax over the
per-class raw class-1 scores.  ``parallelism`` is accepted for API
parity.

As in the JAX package, two base classifiers fit all K classes at once:
LogisticRegression as K binary lanes of one LBFGS loop
(``LogisticRegression._fit_ovr_lanes``, while
``supports_vectorized_ovr`` holds), GBT in one boosting loop
(``gbt.fit_gbt_ovr_vectorized``) unless mid-fit checkpoints are asked
for; any other port classifier (LinearSVC among them), and those two
outside their gates, fits per class.
Serving fuses homogeneous sub-models on their device: LinearSVC models,
and binomial LogisticRegression models, stack into one ``[D, K]`` f32
weight matrix (the raw score is one f32 product plus bias; an LR
margin is its class-1 row minus its class-0 row); GBT sub-models of one
depth serve as one ``forest_traversal`` launch over all K classes'
trees and a ``[K, M]`` selection product.  Other sub-models serve one
by one.  The features are cast to float32 first, as the JAX package's
``transform`` casts them.

``mesh=`` is resolved as the JAX package resolves it: the OneVsRest's
own mesh, else the classifier's.  An own mesh fits through a copy of the
classifier on that mesh (its device the mesh's first), so LR's lanes,
GBT's boosting loop and the per-class sub-fits all shard over it; with
neither the fits stay on the classifier's device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.utils.profiling import active_ledgers, record_movement
from sntc_tpu_torch.models.base import (
    ClassificationModel,
    ClassifierEstimator,
    ClassifierParams,
)
from sntc_tpu_torch.kernels.forest import forest_leaf_stats as _traverse
from sntc_tpu_torch.models.linear_svc import LinearSVCModel
from sntc_tpu_torch.parallel.collectives import fit_device
from sntc_tpu_torch.models.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)
from sntc_tpu_torch.models.tree.gbt import (
    GBTClassificationModel,
    GBTClassifier,
    _ovr_fused_raw,
    fit_gbt_ovr_vectorized,
)


def _on(dev, X) -> torch.Tensor:
    """``X`` (numpy or a tensor) as a contiguous float32 tensor on
    ``dev``."""
    if isinstance(X, torch.Tensor):
        return X.to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)


def _linear_fused(WT: np.ndarray, b: np.ndarray, dev):
    """``f(X) = X @ WT + b``: one f32 product on ``dev``."""
    WT_d = torch.from_numpy(np.ascontiguousarray(WT, np.float32)).to(dev)
    b_d = torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(dev)

    def linear_fused(X):
        return _on(dev, X) @ WT_d + b_d[None, :]

    return linear_fused


def _build_fused_ovr(models, traverse=_traverse):
    """A ``f(X) -> [N, K]`` fused raw-score closure for homogeneous
    sub-models (all LinearSVC, all binomial LogisticRegression, or all
    GBT of one depth), or None (see ``OneVsRestModel._fused_raw``).  A
    check against the plain version passes
    ``forest_leaf_stats_reference`` as ``traverse``."""
    if not models:
        return None
    dev = models[0].device
    if all(isinstance(m, LinearSVCModel) for m in models):
        return _linear_fused(
            np.stack([m.coefficients for m in models]).T,
            np.asarray([m.intercept for m in models]), dev)
    if all(isinstance(m, LogisticRegressionModel) and m.is_binomial
           for m in models):
        # the class-1 row minus the class-0 row, as the per-model raw(1)
        # takes it (row 0 need not be zero in a model built elsewhere)
        return _linear_fused(
            np.stack([m.coefficientMatrix[1] - m.coefficientMatrix[0]
                      for m in models]).T,
            np.asarray([m.interceptVector[1] - m.interceptVector[0]
                        for m in models]), dev)
    if not all(isinstance(m, GBTClassificationModel) for m in models) or \
            len({m.forest.max_depth for m in models}) != 1:
        return None
    feature = np.concatenate([m.forest.feature for m in models])
    threshold = np.concatenate([m.forest.threshold for m in models])
    leaf_stats = np.concatenate([m.forest.leaf_stats for m in models])
    sel = np.zeros((len(models), feature.shape[0]), np.float32)
    off = 0
    for c, m in enumerate(models):
        t = m.forest.feature.shape[0]
        sel[c, off: off + t] = m.treeWeights
        off += t
    max_depth = models[0].forest.max_depth
    arrays = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (feature, threshold, leaf_stats, sel)]
    internal = feature[feature >= 0]
    max_feature = int(internal.max()) if internal.size else -1

    def gbt_fused(X):
        X = _on(dev, X)
        if X.shape[1] <= max_feature:
            raise ValueError(
                f"a batch of {X.shape[1]} features does not fit trees "
                f"splitting on index {max_feature}"
            )
        return _ovr_fused_raw(X, *arrays, max_depth=max_depth,
                              traverse=traverse)

    return gbt_fused


class _OvrParams(ClassifierParams):
    parallelism = Param(
        "API parity only; the sub-fits run one after another unless the "
        "classifier fits all classes at once",
        default=1,
        validator=validators.gteq(1),
    )


class OneVsRest(_OvrParams, ClassifierEstimator):
    def __init__(self, classifier=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        if classifier is None:
            raise ValueError("OneVsRest requires a classifier estimator")
        self.classifier = classifier
        self.mesh = mesh

    def _classifier_on_mesh(self):
        """``(classifier, mesh)``: the classifier, or with an own mesh a
        copy of it fitting over that mesh; the mesh the fits shard over
        (None: the classifier's device)."""
        clf = self.classifier
        if self.mesh is None:
            return clf, getattr(clf, "mesh", None)
        if not hasattr(clf, "mesh"):
            raise ValueError(
                f"{type(clf).__name__} takes no mesh; OneVsRest(mesh=...) "
                "needs a classifier that does")
        clf = clf.copy()
        clf.mesh = self.mesh
        clf.device = fit_device(None, self.mesh)
        return clf, self.mesh

    def _fit(self, frame: Frame) -> "OneVsRestModel":
        X, y, w = self._extract(frame)
        k = int(y.max()) + 1
        bin_col = f"ovr_label_{self.uid}"
        overrides = {
            "labelCol": bin_col,
            "featuresCol": self.getFeaturesCol(),
        }
        # forward sample weights to every binary sub-fit (Spark parity)
        if self.getWeightCol() and self.classifier.hasParam("weightCol"):
            overrides["weightCol"] = self.getWeightCol()
        clf, mesh = self._classifier_on_mesh()
        models: Optional[List[ClassificationModel]] = self._fit_vectorized(
            clf, mesh, X, y, w, k, frame
        )
        if models is not None:
            # saved metadata must not depend on the path: vectorized
            # sub-models carry the column overrides the sequential
            # sub-fits get through classifier.copy(overrides)
            for sub in models:
                sub.setParams(
                    **{k2: v for k2, v in overrides.items() if sub.hasParam(k2)}
                )
        else:
            models = []
            for c in range(k):
                sub = frame.with_column(bin_col, (y == c).astype(np.float64))
                models.append(clf.copy(overrides).fit(sub))
        model = OneVsRestModel(models=models)
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items() if model.hasParam(k2)}
        )
        return model

    def _fit_vectorized(self, clf, mesh, X, y, w, k, frame):
        """All classes at once, over ``mesh``, for a LogisticRegression
        (K binary lanes relabeled on the device) or GBT base classifier
        (K trees a boosting round over the same binned features), or
        None: another classifier, a weightCol set on the classifier
        itself (it names a column of the relabeled sub-frame, which only
        the sequential path builds), an LR outside
        ``supports_vectorized_ovr``, or GBT with mid-fit checkpoints
        (the sequential path owns them)."""
        if not isinstance(clf, (LogisticRegression, GBTClassifier)):
            return None
        if clf.getWeightCol() and not self.getWeightCol():
            return None
        if isinstance(clf, LogisticRegression):
            if not clf.supports_vectorized_ovr():
                return None
            return clf._fit_ovr_lanes(X, y, w, k, mesh)
        if clf.getCheckpointInterval() > 0 and clf.getCheckpointDir():
            return None
        vcol = clf.getValidationIndicatorCol()
        val_mask = to_host(frame[vcol]).astype(bool) if vcol else None
        return fit_gbt_ovr_vectorized(clf, X, y, w, k, mesh,
                                      val_mask=val_mask)

    def _sub_stages(self):
        return [self.classifier]

    @classmethod
    def _from_sub_stages(cls, stages, params, extra=None):
        obj = cls(classifier=stages[0])
        obj.setParams(**params)
        return obj


class OneVsRestModel(_OvrParams, ClassificationModel):
    def __init__(self, models: Optional[List[ClassificationModel]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.models = list(models or [])
        # (models, closure or False), rebuilt when the public ``models``
        # list changes, so that no stale fused weights are served
        self._fused = None

    @property
    def num_classes(self) -> int:
        return len(self.models)

    def _sub_stages(self):
        return self.models

    @classmethod
    def _from_sub_stages(cls, stages, params, extra=None):
        obj = cls(models=stages)
        obj.setParams(**params)
        return obj

    def _fused_raw(self):
        """The fused raw-score closure when every sub-model is a GBT of
        one depth, else None (the per-model loop)."""
        models = tuple(self.models)
        if self._fused is None or len(self._fused[0]) != len(models) or any(
            a is not b for a, b in zip(self._fused[0], models)
        ):
            self._fused = (models, _build_fused_ovr(self.models) or False)
        return self._fused[1] or None

    def _raw_predict(self, X) -> torch.Tensor:
        """Per-class raw class-1 scores ``[N, K]`` on the sub-models'
        device."""
        fused = self._fused_raw()
        if fused is not None:
            return fused(X)
        # Spark takes each sub-model's rawPrediction(1)
        return torch.stack([m._raw_predict(X)[:, 1] for m in self.models],
                           dim=1)

    def transform_async(self, frame: Frame):
        """Enqueue raw scores and their argmax as one packed ``[N, K+1]``
        tensor; finalize copies it to the host once.  No probability
        column: Spark's OneVsRest emits none.  The features are cast to
        float32 first, for every kind of sub-model."""
        X = frame[self.getFeaturesCol()]
        X = (X.to(torch.float32) if isinstance(X, torch.Tensor)
             else np.asarray(X).astype(np.float32, copy=False))
        raw = self._raw_predict(X)
        packed = torch.cat(
            [raw, torch.argmax(raw, dim=1)[:, None].to(raw.dtype)], dim=1
        )

        ledgers = active_ledgers()

        def finalize():
            host = packed.cpu().numpy()
            record_movement(ledgers, downloads=1, download_bytes=host.nbytes)
            k = self.num_classes
            out = frame
            if self.getRawPredictionCol():
                out = out.with_column(self.getRawPredictionCol(), host[:, :k])
            if self.getPredictionCol():
                out = out.with_column(self.getPredictionCol(),
                                      host[:, k].astype(np.float64))
            return out

        return finalize
