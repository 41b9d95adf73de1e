"""ClusteringEvaluator — silhouette.

Counterpart of ``sntc_tpu/evaluation/clustering.py`` (Spark's
``ClusteringEvaluator``): ``metricName='silhouette'`` with
``distanceMeasure`` squaredEuclidean (default) | cosine, in Spark's
O(N·k) closed form — per-cluster (count, Σx, Σ‖x‖²) statistics give
every point's mean distance to every cluster without a pairwise pass:

  Σ_q∈c ‖p − q‖² = n_c‖p‖² − 2 p·Σx_c + Σ‖x‖²_c

``a(i)`` divides by ``n_c − 1`` (own cluster, excluding the point);
``b(i)`` is the min over the other occurring clusters of the mean;
singleton clusters score 0; the metric is the unweighted mean of
``(b−a)/max(a,b)``.  ``isLargerBetter`` is True.

Host numpy in float64, as in the JAX package (the same operations in the
same order: the values are bitwise equal); tensor columns are copied to
the host first.
"""

from __future__ import annotations

import numpy as np

from sntc_tpu_torch.core.base import Evaluator
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators


def _silhouette(X, labels, k, cosine):
    n = len(labels)
    if k < 2:
        raise ValueError("silhouette requires at least 2 clusters")
    if cosine:
        norms = np.linalg.norm(X, axis=1, keepdims=True)
        X = X / np.maximum(norms, 1e-12)
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    sums = np.zeros((k, X.shape[1]), np.float64)
    np.add.at(sums, labels, X)
    if cosine:
        # mean cosine distance from p to cluster c: 1 − p·Σx̂_c / n_c
        cross = X @ sums.T  # [N, k]
        mean_d = 1.0 - cross / np.maximum(counts, 1.0)[None, :]
        own_excl = np.maximum(counts - 1.0, 1.0)
        # own cluster, excluding self (self cosine distance is 0)
        own_sum = counts[labels] * mean_d[np.arange(n), labels]
        a = own_sum / own_excl[labels]
    else:
        sqn = (X**2).sum(axis=1)
        sq_sums = np.zeros(k, np.float64)
        np.add.at(sq_sums, labels, sqn)
        cross = X @ sums.T
        # Σ_q∈c ‖p−q‖² for every (point, cluster)
        tot = (
            counts[None, :] * sqn[:, None]
            - 2.0 * cross
            + sq_sums[None, :]
        )
        mean_d = tot / np.maximum(counts, 1.0)[None, :]
        own_excl = np.maximum(counts - 1.0, 1.0)
        a = tot[np.arange(n), labels] / own_excl[labels]
    other = mean_d.copy()
    other[np.arange(n), labels] = np.inf
    # cluster ids never predicted must not contribute a fake zero
    # distance: Spark iterates only over occurring clusters
    other[:, counts == 0] = np.inf
    b = other.min(axis=1)
    s = np.where(
        counts[labels] <= 1.0,
        0.0,
        (b - a) / np.maximum(np.maximum(a, b), 1e-12),
    )
    return float(s.mean())


class ClusteringEvaluator(Evaluator):
    _METRICS = ("silhouette",)

    metricName = Param("metric to compute", default="silhouette",
                       validator=validators.one_of(*_METRICS))
    featuresCol = Param("feature vector column", default="features")
    predictionCol = Param("cluster-id column", default="prediction")
    distanceMeasure = Param(
        "squaredEuclidean | cosine", default="squaredEuclidean",
        validator=validators.one_of("squaredEuclidean", "cosine"),
    )

    def evaluate(self, frame: Frame) -> float:
        X = np.asarray(to_host(frame[self.getFeaturesCol()]), np.float64)
        labels = np.asarray(to_host(frame[self.getPredictionCol()]),
                            np.int64)
        k = int(labels.max()) + 1 if len(labels) else 0
        return _silhouette(
            X, labels, k, self.getDistanceMeasure() == "cosine"
        )
