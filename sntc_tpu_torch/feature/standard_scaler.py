"""StandardScaler — feature standardization.

Counterpart of ``sntc_tpu/feature/standard_scaler.py`` (Spark's
``StandardScaler``): fit computes per-feature mean and **unbiased**
(ddof 1) std; transform applies ``(x - mean) * (1/std)`` per the
``withMean``/``withStd`` flags, with constant features (std == 0)
mapped to 0.

The fit is one pass over the rows on the estimator's device: weighted
``(Σx, Σx², Σw)`` about a pilot row (the first), in full float32, with
the mean and variance finished in float64 on the host.  With a ``mesh=``
of more than one shard the pass is one ``make_tree_aggregate`` over the
sharded rows, the pilot row a replicated argument, as in the JAX
package; without one (or with one shard in one process) it is the same
reduction on one device, unpadded.  Transform runs where its input
lives: a numpy column on the host, a tensor column on the tensor's
device.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
)


class _ScalerParams:
    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="scaledFeatures")
    withMean = Param("center to zero mean", default=False, validator=validators.is_bool())
    withStd = Param("scale to unit std", default=True, validator=validators.is_bool())


def _moments(xs, w, pilot):
    shifted = xs - pilot[None, :]
    return torch.cat([w @ shifted, w @ (shifted * shifted),
                      w.sum().reshape(1)])


def standardization_moments(xs, w, pilot: np.ndarray, mesh=None):
    """``(count, mean, BIASED 1/n variance about the mean)`` of ``xs``
    ``[N, D]`` weighted by ``w``, accumulated about ``pilot`` (raw f32
    Σx² cancels catastrophically on features whose mean dwarfs their
    spread; the variance is shift-invariant).  With ``mesh``, ``xs`` and
    ``w`` are ``shard_batch``'s and the pass is one aggregate over the
    shards.  Returns float64 host values; callers apply their own ddof
    correction."""
    pilot = np.asarray(pilot, np.float32)
    with full_f32():
        if mesh is None:
            out = _moments(xs, w, torch.from_numpy(pilot).to(xs.device))
        else:
            agg = make_tree_aggregate(_moments, mesh, replicated_args=(2,))
            out = agg(xs, w, torch.from_numpy(pilot))
        out = out.cpu().numpy()
    d = xs.shape[1]
    n = float(out[2 * d])
    mean_sh = out[:d].astype(np.float64) / max(n, 1e-300)
    mean = pilot.astype(np.float64) + mean_sh
    var = out[d:2 * d].astype(np.float64) / max(n, 1e-300) - mean_sh**2
    return n, mean, np.maximum(var, 0.0)


class StandardScaler(_ScalerParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "StandardScalerModel":
        X = to_host(frame[self.getInputCol()]).astype(np.float32, copy=False)
        pilot = X[0] if X.shape[0] else np.zeros(X.shape[1])
        mesh = fit_mesh(self.mesh)
        if mesh is None:
            xs = torch.from_numpy(np.require(X, requirements=["C", "W"]))
            xs = xs.to(self.device)
            w = torch.ones(X.shape[0], dtype=torch.float32,
                           device=self.device)
        else:
            xs, w = shard_batch(mesh, X)
        n, mean, var_biased = standardization_moments(xs, w, pilot, mesh)
        # unbiased variance (Spark ddof=1)
        var = var_biased * n / max(n - 1, 1)
        std = np.sqrt(np.maximum(var, 0.0))
        model = StandardScalerModel(
            mean=mean.astype(np.float32), std=std.astype(np.float32)
        )
        model.setParams(**self.paramValues())
        return model


class StandardScalerModel(_ScalerParams, Model):
    def __init__(self, mean: np.ndarray, std: np.ndarray, **kwargs):
        super().__init__(**kwargs)
        self.mean = np.asarray(mean)
        self.std = np.asarray(std)
        self._on_device = {}  # device -> (mu, f) float32 tensors

    def _save_extra(self):
        return {}, {"mean": self.mean, "std": self.std}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(mean=arrays["mean"], std=arrays["std"])
        m.setParams(**params)
        return m

    def affine(self):
        """``(mu, f)`` of the map ``x' = (x - mu) * f`` this model applies
        (float64; honors withMean/withStd, constant features get f=0)."""
        std = self.std.astype(np.float64)
        f = (
            np.divide(1.0, std, out=np.zeros_like(std), where=std > 0)
            if self.getWithStd()
            else np.ones_like(std)
        )
        mu = (
            self.mean.astype(np.float64)
            if self.getWithMean()
            else np.zeros_like(self.mean, dtype=np.float64)
        )
        return mu, f

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        mu, f = self.affine()
        if isinstance(X, torch.Tensor):
            if X.device not in self._on_device:
                self._on_device[X.device] = tuple(
                    torch.from_numpy(a.astype(np.float32)).to(X.device)
                    for a in (mu, f)
                )
            mu_t, f_t = self._on_device[X.device]
            X = X.to(torch.float32)
            if self.getWithMean():
                X = X - mu_t
            if self.getWithStd():
                X = X * f_t
            return frame.with_column(self.getOutputCol(), X)
        X = np.asarray(X).astype(np.float32)
        if self.getWithMean():
            X = X - mu.astype(np.float32)
        if self.getWithStd():
            X = X * f.astype(np.float32)
        return frame.with_column(self.getOutputCol(), X)
