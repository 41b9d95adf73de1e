"""KMeans — Lloyd's iterations on the estimator's device, k-means|| init.

Counterpart of ``sntc_tpu/models/kmeans.py`` (Spark's ``KMeans``):
``k``, ``maxIter`` (20), ``tol`` (1e-4, on center movement — the squared
shift against tol²), ``initMode`` random | k-means|| (default,
``initSteps=2``), ``distanceMeasure`` euclidean | cosine, ``seed``; the
model exposes ``clusterCenters``, ``predict`` = nearest center and
``summary.trainingCost``.

The init runs on a host sample in numpy, as in the JAX package (the same
draws from the same seed: both packages start from the same centers).
Lloyd's loop (:func:`lloyd`) runs on the device in full float32: one
``[N, k]`` distance product, the argmin, and the new centers as a
one-hot product; empty clusters keep their centers, cosine renormalises
them.  The loop is the same with or without a mesh; only where an
iteration's sums, counts and cost come from differs.  The JAX package runs the loop as one XLA ``while_loop``; here it
is a Python loop that reads the card once an iteration, for the squared
shift it tests against tol².  The cost is computed once, after the loop.
With a ``mesh=`` of more than one shard, each iteration's sums and
counts are one ``make_tree_aggregate`` over the sharded rows (op
``kmeans.lloyd``) and the cost another (``kmeans.cost``): the port
counts a ``kmeans.lloyd`` dispatch an iteration, where the JAX package,
whose whole loop is one program, counts one a fit.
``KMeansModel.predict`` runs in float64: in numpy on a numpy column (the
JAX package's host code), on the tensor's device on a tensor column.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
)
from sntc_tpu_torch.models.summary import TrainingSummary
from sntc_tpu_torch.ops.lbfgs import full_f32


def _normalize_rows(X, eps=1e-12):
    n = np.linalg.norm(X, axis=1, keepdims=True)
    return X / np.maximum(n, eps)


def _distances(xs, c, cosine, xn=None):
    """``[N, k]`` distances of the rows ``xs`` to the centers ``c``:
    ‖x−c‖² = ‖x‖² − 2 x·cᵀ + ‖c‖² (``xn`` = ‖x‖², when precomputed), the
    cross term a product; ``1 − x·cᵀ`` on normalised cosine rows."""
    cross = xs @ c.t()
    if cosine:
        return 1.0 - cross
    if xn is None:
        xn = (xs * xs).sum(dim=1)
    return xn[:, None] - 2.0 * cross + (c * c).sum(dim=1)[None, :]


def _assign_sums(xs, ws, c, cosine, xn=None):
    """One Lloyd step's ``(sums [k, D], counts [k])``: every row's
    weight on its nearest center."""
    assign = _distances(xs, c, cosine, xn).argmin(dim=1)
    oh = torch.nn.functional.one_hot(assign, c.shape[0]).to(xs.dtype)
    oh = oh * ws[:, None]
    return oh.t() @ xs, oh.sum(dim=0)


def _cost(xs, ws, c, cosine, xn=None):
    return (ws * _distances(xs, c, cosine, xn).min(dim=1).values).sum()


def local_lloyd_fns(xs: torch.Tensor, ws: torch.Tensor, cosine: bool):
    """:func:`lloyd`'s ``(sums_fn, cost_fn)`` over the rows ``xs [N, D]``
    weighted by ``ws [N]`` (weight 0 leaves a row out) on one device."""
    with full_f32():
        xn = None if cosine else (xs * xs).sum(dim=1)
    return (lambda c: _assign_sums(xs, ws, c, cosine, xn),
            lambda c: _cost(xs, ws, c, cosine, xn))


def mesh_lloyd_fns(mesh, xs, ws, cosine: bool):
    """:func:`lloyd`'s ``(sums_fn, cost_fn)`` over ``shard_batch``'s rows
    ``xs`` and weights ``ws``: each call one aggregate over the shards
    (ops ``kmeans.lloyd`` and ``kmeans.cost``), the centers replicated."""
    sums_agg = make_tree_aggregate(
        lambda x, w, c: _assign_sums(x, w, c, cosine), mesh,
        replicated_args=(2,), op="kmeans.lloyd")
    cost_agg = make_tree_aggregate(
        lambda x, w, c: _cost(x, w, c, cosine), mesh,
        replicated_args=(2,), op="kmeans.cost")
    return (lambda c: sums_agg(xs, ws, c), lambda c: cost_agg(xs, ws, c))


def lloyd(sums_fn, cost_fn, centers0: torch.Tensor, tol: float, *,
          max_iter: int, cosine: bool):
    """Lloyd's loop from ``centers0 [k, D]`` (cosine rows and centers
    arrive L2-normalised): ``sums_fn(centers)`` gives an iteration's
    ``(sums, counts)``, ``cost_fn(centers)`` the weighted cost, both from
    :func:`local_lloyd_fns` or :func:`mesh_lloyd_fns`.  Returns
    ``(centers, iterations, cost, host_reads)``, the centers and the
    cost on the device."""
    # Spark's isCenterConverged: movement <= tol, i.e. SQUARED <= tol²,
    # in float32 as the JAX loop compares it
    tol2 = float(np.float32(tol) * np.float32(tol))
    with full_f32():
        centers, it, reads = centers0, 0, 0
        while it < max_iter:
            sums, counts = sums_fn(centers)
            new = sums / counts.clamp_min(1e-12)[:, None]
            # empty clusters keep their previous center (Spark)
            new = torch.where((counts > 0)[:, None], new, centers)
            if cosine:
                norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
                new = new / norm.clamp_min(1e-12)
            shift = ((new - centers) ** 2).sum(dim=1).max()
            centers, it = new, it + 1
            reads += 1
            if float(shift) <= tol2:
                break
        # the cost once, after the loop
        cost = cost_fn(centers)
    return centers, it, cost, reads


def _kmeans_parallel_init(X, k, seed, steps, cosine):
    """k-means|| (Bahmani et al.) on the host sample, Spark's init:
    oversample ~2k candidates a step by distance-weighted sampling, then
    weight the candidates by the points they own and reduce them to k by
    k-means++."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    centers = X[rng.integers(0, n)][None, :]
    for _ in range(steps):
        d = _min_sq_dist(X, centers, cosine)
        total = d.sum()
        if total <= 0:
            break
        p = np.minimum(2.0 * k * d / total, 1.0)
        new = X[rng.random(n) < p]
        if len(new):
            centers = np.concatenate([centers, new], axis=0)
    d_all = _sq_dists(X, centers, cosine)
    owner = d_all.argmin(axis=1)
    wts = np.bincount(owner, minlength=len(centers)).astype(np.float64)
    return _kmeans_pp(centers, wts, k, rng, cosine)


def _sq_dists(X, C, cosine):
    if cosine:
        return 1.0 - X @ C.T
    return (
        (X**2).sum(axis=1)[:, None]
        - 2.0 * X @ C.T
        + (C**2).sum(axis=1)[None, :]
    )


def _sq_dists_t(X: torch.Tensor, C: torch.Tensor, cosine: bool):
    """:func:`_sq_dists` on tensors."""
    if cosine:
        return 1.0 - X @ C.t()
    return ((X * X).sum(dim=1)[:, None] - 2.0 * X @ C.t()
            + (C * C).sum(dim=1)[None, :])


def _normalize_rows_t(X: torch.Tensor, eps=1e-12) -> torch.Tensor:
    return X / torch.linalg.vector_norm(X, dim=1, keepdim=True).clamp_min(eps)


def _min_sq_dist(X, C, cosine):
    return np.maximum(_sq_dists(X, C, cosine).min(axis=1), 0.0)


def _kmeans_pp(cand, wts, k, rng, cosine):
    """Weighted k-means++ over the (small) candidate set."""
    if len(cand) <= k:
        out = cand
        while len(out) < k:  # degenerate: duplicate to k
            out = np.concatenate([out, cand[: k - len(out)]], axis=0)
        return out
    centers = [cand[rng.choice(len(cand), p=wts / wts.sum())]]
    for _ in range(1, k):
        d = _min_sq_dist(cand, np.stack(centers), cosine) * wts
        total = d.sum()
        if total <= 0:
            idx = rng.integers(0, len(cand))
        else:
            idx = rng.choice(len(cand), p=d / total)
        centers.append(cand[idx])
    return np.stack(centers)


def vector_rows(frame: Frame, col: str) -> np.ndarray:
    """``frame[col]`` as float32 host rows, refusing a scalar column."""
    X = frame[col]
    if X.ndim != 2:
        raise ValueError(
            f"featuresCol {col!r} must be a vector column (use "
            "VectorAssembler)"
        )
    return np.asarray(to_host(X), np.float32)


class _KMeansParams:
    featuresCol = Param("feature vector column", default="features")
    predictionCol = Param("output cluster-index column", default="prediction")
    k = Param("number of clusters", default=2, validator=validators.gt(1))
    maxIter = Param("max Lloyd iterations", default=20, validator=validators.gt(0))
    tol = Param(
        "convergence tolerance on center MOVEMENT (Spark compares the "
        "squared shift to tol²)", default=1e-4,
        validator=validators.gteq(0),
    )
    initMode = Param(
        "k-means|| | random", default="k-means||",
        validator=validators.one_of("k-means||", "random"),
    )
    initSteps = Param("k-means|| sampling rounds", default=2,
                      validator=validators.gt(0))
    distanceMeasure = Param(
        "euclidean | cosine", default="euclidean",
        validator=validators.one_of("euclidean", "cosine"),
    )
    seed = Param("init seed", default=0)


class KMeans(_KMeansParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "KMeansModel":
        X = vector_rows(frame, self.getFeaturesCol())
        k = self.getK()
        if X.shape[0] < k:
            raise ValueError(f"k={k} exceeds the row count {X.shape[0]}")
        cosine = self.getDistanceMeasure() == "cosine"
        Xw = _normalize_rows(X).astype(np.float32) if cosine else X

        rng = np.random.default_rng(self.getSeed())
        sample = Xw
        if len(sample) > 100_000:
            sample = Xw[rng.choice(len(Xw), 100_000, replace=False)]
        if self.getInitMode() == "random":
            centers0 = sample[rng.choice(len(sample), k, replace=False)]
        else:
            centers0 = _kmeans_parallel_init(
                sample, k, self.getSeed(), int(self.getInitSteps()), cosine
            ).astype(np.float32)

        dev = self.device
        c0 = torch.from_numpy(np.ascontiguousarray(centers0)).to(dev)
        mesh = fit_mesh(self.mesh)
        if mesh is None:
            xs = torch.from_numpy(np.ascontiguousarray(Xw)).to(dev)
            ws = torch.ones(xs.shape[0], dtype=torch.float32, device=dev)
            fns = local_lloyd_fns(xs, ws, cosine)
        else:
            xs, ws = shard_batch(mesh, np.ascontiguousarray(Xw))
            fns = mesh_lloyd_fns(mesh, xs, ws, cosine)
        centers, iters, cost, reads = lloyd(
            *fns, c0, self.getTol(), max_iter=int(self.getMaxIter()),
            cosine=cosine,
        )
        # centers and cost come back in one read
        out = torch.cat([centers.flatten(), cost.reshape(1)]).cpu().numpy()
        centers_np, cost = out[:-1].reshape(centers.shape), float(out[-1])
        model = KMeansModel(clusterCenters=centers_np.astype(np.float64))
        model.setParams(**self.paramValues())
        model.summary = TrainingSummary([cost], iters)
        model.summary.trainingCost = cost
        model.fit_stats = {"iterations": iters, "host_reads": reads + 1}
        return model


class KMeansModel(_KMeansParams, Model):
    def __init__(self, clusterCenters: np.ndarray = None, **kwargs):
        super().__init__(**kwargs)
        self.clusterCenters = np.asarray(clusterCenters, np.float64)
        self.summary = None
        self.fit_stats = None

    def _save_extra(self):
        return {}, {"clusterCenters": self.clusterCenters}

    @classmethod
    def _load_from(cls, params, extra, arrays, device=None):
        m = cls(clusterCenters=arrays["clusterCenters"])
        m.setParams(**params)
        return m

    def predict(self, X):
        """Nearest center per row, as float64 cluster ids: in numpy on a
        numpy array, on the tensor's device on a tensor."""
        cosine = self.getDistanceMeasure() == "cosine"
        if isinstance(X, torch.Tensor):
            Xd = X.to(torch.float64)
            if cosine:
                Xd = _normalize_rows_t(Xd)
            C = torch.from_numpy(self.clusterCenters).to(X.device)
            return _sq_dists_t(Xd, C, cosine).argmin(dim=1).to(torch.float64)
        X = np.asarray(X, np.float64)
        if cosine:
            X = _normalize_rows(X)
        return _sq_dists(X, self.clusterCenters, cosine).argmin(axis=1).astype(
            np.float64
        )

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getFeaturesCol()]
        return frame.with_column(self.getPredictionCol(), self.predict(X))
