"""PCA: principal component projection.

Counterpart of ``sntc_tpu/feature/pca.py`` (Spark's ``PCA``): the fit
eigen-decomposes the sample covariance of the input vectors and keeps
the top-``k`` components (descending eigenvalue); ``transform``
multiplies the RAW (uncentered) vector by the component matrix, as Spark
does; ``explainedVariance`` is the kept eigenvalues' fraction of the
total variance.  A component's sign is arbitrary (as in Spark and
sklearn).

The fit runs on the estimator's ``device`` (default ``cuda``): the
moments about a pilot row ``p`` (the first), ``Σ(x-p)``,
``(x-p)ᵀ(x-p)`` and ``n``, come out of one float32 product
``[x-p | 1]ᵀ [x-p | 1]`` in full float32.  The shift matters: an
uncentered float32 ``XᵀX`` cancels catastrophically when feature means
dwarf their spread (flow byte counts near 1e7); the covariance is
shift-invariant.  With a ``mesh=`` of more than one shard the same
moments are one ``make_tree_aggregate`` over the sharded rows, each
shard's product weighted by its padding mask, as in the JAX package.
The covariance and ``np.linalg.eigh`` are float64 on the host, in the
JAX package's order.  The transform is one full-f32
product (:func:`pca_project`, shared with the fused segment), run where
a tensor column lives or, for a host column, on the model's device with
one round trip.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.feature.dct import device_round_trip
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
)


def pilot_moments(xs: torch.Tensor, pilot: np.ndarray):
    """``(Σ(x-p) [D], (x-p)ᵀ(x-p) [D, D], n)`` of float32 ``xs [N, D]``
    about ``pilot``, from one full-f32 product, as float64 host values."""
    p = torch.from_numpy(np.asarray(pilot, np.float32)).to(xs.device)
    a = torch.cat([xs - p[None, :],
                   torch.ones(xs.shape[0], 1, dtype=torch.float32,
                              device=xs.device)], dim=1)
    with full_f32():
        m = to_host(a.t() @ a).astype(np.float64)
    d = xs.shape[1]
    return m[d, :d], m[:d, :d], float(m[d, d])


def _shard_moments(xs, w, p):
    """One shard's ``[x-p | 1]ᵀ diag(w) [x-p | 1]``."""
    a = torch.cat([xs - p[None, :],
                   torch.ones(xs.shape[0], 1, dtype=torch.float32,
                              device=xs.device)], dim=1)
    return (a * w[:, None]).t() @ a


def sharded_pilot_moments(mesh, xs, w, pilot: np.ndarray):
    """:func:`pilot_moments` of ``shard_batch``'s rows ``xs`` and
    padding mask ``w``, summed over the mesh's shards."""
    agg = make_tree_aggregate(_shard_moments, mesh, replicated_args=(2,),
                              op="pca.moments")
    with full_f32():
        m = to_host(agg(xs, w, torch.from_numpy(
            np.asarray(pilot, np.float32)))).astype(np.float64)
    d = xs.shape[1]
    return m[d, :d], m[:d, :d], float(m[d, d])


def pca_project(x: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """``x @ pc`` in full float32 (raw, uncentered): the one product of
    the staged and the fused PCA."""
    with full_f32():
        return torch.matmul(x.to(torch.float32), pc)


class _PcaParams:
    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="pcaFeatures")
    k = Param("number of principal components", default=2,
              validator=validators.gt(0))


class PCA(_PcaParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "PCAModel":
        X = frame[self.getInputCol()]
        d = X.shape[1]
        k = self.getK()
        if k > d:
            raise ValueError(f"k={k} exceeds the feature width {d}")
        if X.shape[0] == 0:
            raise ValueError("PCA requires a non-empty dataset")
        mesh = fit_mesh(self.mesh)
        if mesh is not None:
            X = (X.to(torch.float32) if isinstance(X, torch.Tensor)
                 else np.asarray(X).astype(np.float32, copy=False))
            xs, w = shard_batch(mesh, X)
            s, xxt, n = sharded_pilot_moments(mesh, xs, w, to_host(X[0]))
        else:
            if isinstance(X, torch.Tensor):
                xs = X.to(device=self.device, dtype=torch.float32)
                pilot = to_host(xs[0])
            else:
                X = np.asarray(X).astype(np.float32, copy=False)
                xs = torch.from_numpy(np.ascontiguousarray(X)).to(
                    self.device)
                pilot = X[0]
            s, xxt, n = pilot_moments(xs, pilot)
        # moments are about the pilot; the covariance is shift-invariant
        mean_s = s / n
        cov = (xxt - n * np.outer(mean_s, mean_s)) / max(n - 1.0, 1.0)
        eigvals, eigvecs = np.linalg.eigh(cov)  # ascending
        order = np.argsort(eigvals)[::-1]
        eigvals = np.maximum(eigvals[order], 0.0)
        pc = eigvecs[:, order[:k]]
        total = eigvals.sum()
        explained = eigvals[:k] / total if total > 0 else np.zeros(k)
        model = PCAModel(
            pc=pc.astype(np.float32),
            explainedVariance=explained.astype(np.float64),
            device=self.device,
        )
        model.setParams(**self.paramValues())
        return model


class PCAModel(_PcaParams, Model):
    """Projects a host column on ``device`` (default ``cuda``)."""

    def __init__(self, pc: np.ndarray, explainedVariance: np.ndarray,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.pc = np.asarray(pc, np.float32)  # [D, k]
        self.explainedVariance = np.asarray(explainedVariance, np.float64)
        self.device = resolve_device(device)
        self._on = {}

    def _save_extra(self):
        return {}, {"pc": self.pc, "explainedVariance": self.explainedVariance}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(pc=arrays["pc"], explainedVariance=arrays["explainedVariance"],
                device=device)
        m.setParams(**params)
        return m

    def pc_on(self, device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.from_numpy(self.pc).to(device)
        return t

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        if isinstance(X, torch.Tensor):
            out = pca_project(X, self.pc_on(X.device))
        else:
            out = device_round_trip(
                lambda x: pca_project(x, self.pc_on(x.device)), X,
                self.device)
        return frame.with_column(self.getOutputCol(), out)
