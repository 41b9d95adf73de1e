"""GaussianMixture — full-covariance EM clustering.

Counterpart of ``sntc_tpu/models/gaussian_mixture.py`` (Spark's
``GaussianMixture``): ``k`` full-covariance gaussians fit by EM,
``weights`` / ``gaussians`` (mean, cov) on the model, ``predict`` = the
argmax posterior, ``probabilityCol`` with the posterior vector, ``tol``
on the change of the mean log-likelihood, a seeded init.

The init is the JAX package's: means from a short run of the port's
KMeans (k-means|| and 10 Lloyd steps), the pooled diagonal covariance
from ``X.var(axis=0)`` in float32 numpy, uniform weights.  EM
(:func:`em`) runs on the estimator's device in full float32: the
E-step's log-densities through the K Cholesky factors and one batched
triangular solve, ``logsumexp``, the M-step's means and weighted
scatters as batched products plus ``_REG``·I.  The JAX package runs the
loop as one XLA ``while_loop``; here the host reads the mean
log-likelihood and its change once an iteration and stops when the
change is at most ``tol``.  With a ``mesh=`` of more than one shard the
KMeans seeding runs over the mesh, the rows are laid out by
``shard_batch`` (weight 0 on the padding) and each iteration sums the
shards' parts in shard order: ``Σ norm·w``, ``nk`` and ``respᵀ·x``,
then, about the means they give, the ``[K, D, D]`` scatter as a second
reduction (the JAX M-step's two passes; one pass of ``Σ r·x·xᵀ −
nk·μμᵀ`` would cancel on flow features).  The model's posterior runs in
float32 on the model's device (a tensor column on its own device).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.models.kmeans import KMeans, vector_rows
from sntc_tpu_torch.models.summary import TrainingSummary
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.parallel.collectives import (
    ShardedArray,
    fit_device,
    fit_mesh,
    shard_batch,
)
from sntc_tpu_torch.parallel.mesh import reduce_at

_REG = 1e-6


def _log_gaussians(X, means, covs):
    """``[N, K]`` log N(x | μ_k, Σ_k) through each component's Cholesky
    factor."""
    d = X.shape[1]
    L = torch.linalg.cholesky(covs)  # [K, D, D]
    diff = (X[None, :, :] - means[:, None, :]).transpose(1, 2)  # [K, D, N]
    z = torch.linalg.solve_triangular(L, diff, upper=False)
    maha = (z * z).sum(dim=1)  # [K, N]
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(dim=1)
    return (-0.5 * (d * math.log(2.0 * math.pi) + logdet[:, None]
                    + maha)).t()


def em(xs, ws, means, covs, weights, *, max_iter: int, tol: float):
    """EM from ``(means [K, D], covs [K, D, D], weights [K])`` over rows
    ``xs [N, D]`` weighted by ``ws``, or over ``shard_batch``'s rows:
    each block's E-step on its device (its responsibilities kept there
    for the scatter), the parts summed in shard order onto the
    parameters' device.  Returns ``(means, covs, weights, iterations,
    mean log-likelihood, host_reads)``."""
    tol32 = np.float32(tol)
    dev = means.device
    k, d = means.shape
    if isinstance(xs, ShardedArray):
        mesh, blocks = xs.mesh, list(zip(xs.blocks, ws.blocks))
    else:
        mesh, blocks = None, [(xs, ws)]

    def reduce(parts):
        return reduce_at(parts, mesh=mesh).to(dev)

    eye = torch.eye(d, dtype=means.dtype, device=dev)
    big = float(np.finfo(np.float32).max)
    with full_f32():
        n_eff = reduce([w.sum() for _, w in blocks]).clamp_min(1e-12)
        prev = torch.tensor(-big, dtype=means.dtype, device=dev)
        it, loglik, reads = 0, -big, 0
        while it < max_iter:
            # E-step: Σ norm·w, nk and respᵀ·x over the blocks
            parts, resps = [], []
            for x, w in blocks:
                logp = (_log_gaussians(x, means.to(x.device),
                                       covs.to(x.device))
                        + torch.log(weights.to(x.device))[None])
                norm = torch.logsumexp(logp, dim=1)
                resp = torch.exp(logp - norm[:, None]) * w[:, None]
                resps.append(resp)
                parts.append(torch.cat([(norm * w).sum().reshape(1),
                                        resp.sum(dim=0),
                                        (resp.t() @ x).reshape(-1)]))
            tot = reduce(parts)
            ll = tot[0] / n_eff
            # M-step: the means, then the scatter about them (two passes)
            nk = tot[1:1 + k].clamp_min(1e-12)
            means = tot[1 + k:].reshape(k, d) / nk[:, None]
            scatters = []
            for (x, _), resp in zip(blocks, resps):
                diff = x[None, :, :] - means.to(x.device)[:, None, :]
                scatters.append(
                    (diff * resp.t()[:, :, None]).transpose(1, 2) @ diff)
            covs = reduce(scatters) / nk[:, None, None] + _REG * eye[None]
            weights = nk / nk.sum()
            delta = (ll - prev).abs()
            prev, it = ll, it + 1
            got = torch.stack([ll, delta]).cpu().numpy()
            reads += 1
            loglik = float(got[0])
            if not got[1] > tol32:
                break
    return means, covs, weights, it, loglik, reads


class _GmmParams:
    featuresCol = Param("feature vector column", default="features")
    predictionCol = Param("output cluster-id column", default="prediction")
    probabilityCol = Param("output posterior column", default="probability")
    k = Param("number of components", default=2, validator=validators.gt(1))
    maxIter = Param("max EM iterations", default=100,
                    validator=validators.gt(0))
    tol = Param("mean log-likelihood convergence delta", default=0.01,
                validator=validators.gteq(0))
    seed = Param("init seed", default=0)


class GaussianMixture(_GmmParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device); the model serves there."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "GaussianMixtureModel":
        X = vector_rows(frame, self.getFeaturesCol())
        n, d = X.shape
        k = int(self.getK())
        if n < k:
            raise ValueError(f"need at least k={k} rows, have {n}")
        # means from a short run of the port's KMeans (k-means|| + a few
        # Lloyd steps): random-point seeding regularly drops two means
        # into one cluster (sklearn seeds from k-means for this reason)
        km = KMeans(
            device=self.device, mesh=self.mesh, k=k, maxIter=10,
            seed=self.getSeed(),
            featuresCol=self.getFeaturesCol(),
        ).fit(frame)
        means0 = np.asarray(km.clusterCenters, np.float32)
        pooled = np.diag(np.maximum(X.var(axis=0), _REG)).astype(np.float32)
        covs0 = np.broadcast_to(pooled, (k, d, d)).copy()
        weights0 = np.full(k, 1.0 / k, np.float32)

        dev = self.device
        mesh = fit_mesh(self.mesh)
        if mesh is None:
            xs = torch.from_numpy(np.ascontiguousarray(X)).to(dev)
            ws = torch.ones(n, dtype=torch.float32, device=dev)
        else:
            xs, ws = shard_batch(mesh, np.ascontiguousarray(X))
        means, covs, weights, n_iter, loglik, reads = em(
            xs, ws, torch.from_numpy(means0).to(dev),
            torch.from_numpy(covs0).to(dev),
            torch.from_numpy(weights0).to(dev),
            max_iter=int(self.getMaxIter()), tol=float(self.getTol()),
        )
        model = GaussianMixtureModel(
            weights=weights.cpu().numpy().astype(np.float64),
            means=means.cpu().numpy().astype(np.float64),
            covs=covs.cpu().numpy().astype(np.float64),
            device=dev,
        )
        model.setParams(**self.paramValues())
        model.summary = TrainingSummary([loglik], n_iter)
        model.summary.logLikelihood = loglik
        model.fit_stats = {
            "iterations": n_iter,
            "host_reads": km.fit_stats["host_reads"] + reads + 3,
        }
        return model


class GaussianMixtureModel(_GmmParams, Model):
    def __init__(self, weights=None, means=None, covs=None, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        self.weights = np.asarray(
            weights if weights is not None else [], np.float64
        )
        self.means = np.asarray(means if means is not None else [], np.float64)
        self.covs = np.asarray(covs if covs is not None else [], np.float64)
        self.device = resolve_device(device)
        self.summary: Optional[TrainingSummary] = None
        self.fit_stats = None

    @property
    def gaussians(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(mean, cov)] per component (Spark ``gaussians``)."""
        return [
            (self.means[i], self.covs[i]) for i in range(len(self.weights))
        ]

    def _save_extra(self):
        return {}, {
            "weights": self.weights, "means": self.means, "covs": self.covs,
        }

    @classmethod
    def _load_from(cls, params, extra, arrays, device="cuda"):
        m = cls(weights=arrays["weights"], means=arrays["means"],
                covs=arrays["covs"], device=device)
        m.setParams(**params)
        return m

    def posterior(self, X: torch.Tensor) -> torch.Tensor:
        """``[N, K]`` float32 posteriors of the rows ``X`` on X's
        device."""
        dev = X.device

        def on(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        with full_f32():
            logp = (_log_gaussians(X.to(torch.float32), on(self.means),
                                   on(self.covs))
                    + torch.log(on(self.weights))[None])
            return torch.exp(logp - torch.logsumexp(logp, dim=1,
                                                    keepdim=True))

    def predictProbability(self, X) -> np.ndarray:
        """Posteriors as float64 host values; a numpy array runs on the
        model's device."""
        if not isinstance(X, torch.Tensor):
            X = torch.from_numpy(
                np.ascontiguousarray(X, np.float32)).to(self.device)
        return self.posterior(X).cpu().numpy().astype(np.float64)

    def predict(self, X) -> np.ndarray:
        return np.argmax(self.predictProbability(X), axis=1).astype(
            np.float64
        )

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getFeaturesCol()]
        if not isinstance(X, torch.Tensor):
            X = np.asarray(to_host(X), np.float32)
        prob = self.predictProbability(X)
        out = frame
        if self.getProbabilityCol():
            out = out.with_column(self.getProbabilityCol(), prob)
        return out.with_column(
            self.getPredictionCol(),
            np.argmax(prob, axis=1).astype(np.float64),
        )
