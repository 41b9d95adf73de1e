"""BisectingKMeans — divisive hierarchical clustering.

Counterpart of ``sntc_tpu/models/bisecting_kmeans.py`` (Spark's
``BisectingKMeans``): start from one root cluster and repeatedly bisect
the largest divisible leaf with a local 2-means (``maxIter`` Lloyd steps
a split, the split centers the parent ± a tiny seeded perturbation)
until ``k`` leaves; ``minDivisibleClusterSize`` (≥1: a count, <1: a
fraction of the rows) gates which leaves may split, so the result can
hold FEWER than ``k`` clusters; ``predict`` descends the binary tree
root → leaf by the nearest child center.

Every bisection runs KMeans's Lloyd loop (``kmeans.lloyd`` with k=2) on
the device over all the rows, uploaded once: cluster membership rides
the row weights (non-members weigh 0).  The perturbations are numpy
draws from the seed, as in the JAX package; the host drives the tree
loop (≤ k−1 splits), assigns each split's members and computes the
training cost in float64, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.models.kmeans import (
    _normalize_rows,
    _sq_dists,
    local_lloyd_fns,
    lloyd,
    vector_rows,
)
from sntc_tpu_torch.models.summary import TrainingSummary


class _BisectingParams:
    featuresCol = Param("input vector column", default="features")
    predictionCol = Param("output cluster column", default="prediction")
    k = Param("desired number of leaf clusters", default=4,
              validator=validators.gt(1))
    maxIter = Param("Lloyd steps per bisection", default=20,
                    validator=validators.gt(0))
    minDivisibleClusterSize = Param(
        "min size for a leaf to be split (>=1: count, <1: fraction)",
        default=1.0, validator=validators.gt(0),
    )
    distanceMeasure = Param(
        "euclidean | cosine", default="euclidean",
        validator=validators.one_of("euclidean", "cosine"),
    )
    seed = Param("random seed", default=0)


class BisectingKMeans(_BisectingParams, Estimator):
    """Fits on ``device`` (default ``cuda``)."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _fit(self, frame: Frame) -> "BisectingKMeansModel":
        X = vector_rows(frame, self.getFeaturesCol())
        n = X.shape[0]
        k = int(self.getK())
        cosine = self.getDistanceMeasure() == "cosine"
        Xw = _normalize_rows(X).astype(np.float32) if cosine else X
        mds = float(self.getMinDivisibleClusterSize())
        min_size = mds if mds >= 1.0 else mds * n
        rng = np.random.default_rng(self.getSeed())
        dev = self.device
        xs = torch.from_numpy(np.ascontiguousarray(Xw)).to(dev)
        reads = 0

        # tree arrays: center / left / right (-1 = leaf) per node
        centers = [Xw.mean(axis=0)]
        left, right = [-1], [-1]
        members = {0: np.ones(n, bool)}  # leaf -> row membership
        frozen = set()  # leaves whose split degenerated: never retried

        while len(members) < k:
            divisible = [
                (m.sum(), node) for node, m in members.items()
                if node not in frozen and m.sum() >= max(min_size, 2)
            ]
            if not divisible:
                break  # fewer than k clusters — Spark's documented case
            _, node = max(divisible)
            mask = members[node]
            # split centers: parent ± tiny seeded perturbation (Spark's
            # splitCenter)
            c = centers[node]
            noise = rng.normal(size=c.shape).astype(np.float32)
            noise *= 1e-4 * max(float(np.linalg.norm(c)), 1e-12) / max(
                float(np.linalg.norm(noise)), 1e-12
            )
            c0 = np.stack([c - noise, c + noise]).astype(np.float32)
            ws = torch.from_numpy(mask.astype(np.float32)).to(dev)
            new_centers, _, _, r = lloyd(
                *local_lloyd_fns(xs, ws, cosine),
                torch.from_numpy(c0).to(dev), 1e-4,
                max_iter=int(self.getMaxIter()), cosine=cosine,
            )
            new_centers = new_centers.cpu().numpy()
            reads += r + 1
            # this split's final ownership: one [M, 2] argmin on the host
            sub = Xw[mask]
            owner = _sq_dists(sub, new_centers, cosine).argmin(axis=1)
            if (owner == 0).all() or (owner == 1).all():
                # degenerate split (all identical points, say): keep the
                # leaf and never retry it
                frozen.add(node)
                continue
            li, ri = len(centers), len(centers) + 1
            centers.extend([new_centers[0], new_centers[1]])
            left.extend([-1, -1])
            right.extend([-1, -1])
            left[node], right[node] = li, ri
            idx = np.nonzero(mask)[0]
            m_l = np.zeros(n, bool)
            m_r = np.zeros(n, bool)
            m_l[idx[owner == 0]] = True
            m_r[idx[owner == 1]] = True
            del members[node]
            members[li], members[ri] = m_l, m_r

        model = BisectingKMeansModel(
            centers=np.asarray(centers, np.float64),
            left=np.asarray(left, np.int64),
            right=np.asarray(right, np.int64),
        )
        model.setParams(**self.paramValues())
        # training cost: Σ distance² (or cosine distance) to the leaf
        assign = model.predict(X)
        d = _sq_dists(
            _normalize_rows(X.astype(np.float64)) if cosine
            else X.astype(np.float64),
            model.clusterCenters, cosine,
        )
        cost = float(d[np.arange(n), assign.astype(int)].sum())
        n_splits = (len(centers) - 1) // 2  # bisections performed
        model.summary = TrainingSummary([cost], n_splits)
        model.summary.trainingCost = cost
        model.fit_stats = {"splits": n_splits, "host_reads": reads}
        return model


class BisectingKMeansModel(_BisectingParams, Model):
    """The fitted binary tree.  ``clusterCenters`` lists LEAF centers in
    discovery order; ``predict`` descends the tree (Spark semantics)."""

    def __init__(self, centers, left, right, **kwargs):
        super().__init__(**kwargs)
        self._centers = np.asarray(centers, np.float64)
        self._left = np.asarray(left, np.int64)
        self._right = np.asarray(right, np.int64)
        leaves = np.nonzero(self._left < 0)[0]
        self._leaf_nodes = leaves
        self._leaf_id = {int(nd): i for i, nd in enumerate(leaves)}
        self.summary = None
        self.fit_stats = None

    @property
    def clusterCenters(self) -> np.ndarray:
        return self._centers[self._leaf_nodes]

    def _save_extra(self):
        return {}, {
            "centers": self._centers,
            "left": self._left,
            "right": self._right,
        }

    @classmethod
    def _load_from(cls, params, extra, arrays, device=None):
        m = cls(
            centers=arrays["centers"],
            left=arrays["left"],
            right=arrays["right"],
        )
        m.setParams(**params)
        return m

    def predict(self, X) -> np.ndarray:
        X = np.asarray(to_host(X), np.float64)
        cosine = self.getDistanceMeasure() == "cosine"
        if cosine:
            X = _normalize_rows(X)
        node = np.zeros(len(X), np.int64)
        # vectorised root → leaf descent: depth ≤ the number of splits
        for _ in range(len(self._centers)):
            internal = self._left[node] >= 0
            if not internal.any():
                break
            idx = np.nonzero(internal)[0]
            l_nodes = self._left[node[idx]]
            r_nodes = self._right[node[idx]]
            if cosine:
                dl = 1.0 - (X[idx] * _normalize_rows(self._centers[l_nodes])).sum(axis=1)
                dr = 1.0 - (X[idx] * _normalize_rows(self._centers[r_nodes])).sum(axis=1)
            else:
                dl = ((X[idx] - self._centers[l_nodes]) ** 2).sum(axis=1)
                dr = ((X[idx] - self._centers[r_nodes]) ** 2).sum(axis=1)
            node[idx] = np.where(dl <= dr, l_nodes, r_nodes)
        return np.array(
            [self._leaf_id[int(v)] for v in node], np.float64
        )

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getFeaturesCol()]
        return frame.with_column(self.getPredictionCol(), self.predict(X))

    def computeCost(self, frame: Frame) -> float:
        X = np.asarray(to_host(frame[self.getFeaturesCol()]), np.float64)
        cosine = self.getDistanceMeasure() == "cosine"
        if cosine:
            X = _normalize_rows(X)
        assign = self.predict(X).astype(int)
        d = _sq_dists(X, self.clusterCenters, cosine)
        return float(d[np.arange(len(X)), assign].sum())
