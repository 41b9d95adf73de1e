"""MinMaxScaler / MaxAbsScaler / RobustScaler / Normalizer / Binarizer.

Counterpart of ``sntc_tpu/feature/scalers.py`` (Spark's stages of the
same names):

  * MinMaxScaler: fit per-feature (Emin, Emax); transform rescales to
    ``[min, max]``; constant features map to ``(min + max) / 2``.
  * MaxAbsScaler: fit per-feature max |x|; transform ``x / maxAbs``
    (maxAbs = 0 gives 0).
  * RobustScaler: fit the per-feature (lower, median, upper) quantiles;
    transform ``(x - median) / (upper - lower)`` per the
    ``withCentering`` / ``withScaling`` flags, a zero range giving 0.
  * Normalizer: stateless row p-norm scaling (p >= 1, ``inf`` too);
    zero-norm rows pass unchanged.
  * Binarizer: stateless ``x > threshold -> 1.0 else 0.0``.

The fits run on the estimator's device (default ``cuda``): the extrema
and max-abs are torch reductions over the float32 matrix (MinMaxScaler
and MaxAbsScaler also over a ``mesh=``: a min and a max, or a max |x|,
per shard, reduced across the shards; the row-0 padding leaves them
unchanged); RobustScaler's
quantiles are one column sort on the device with ``jnp.quantile``'s
linear interpolation, op for op (``torch.quantile`` refuses inputs above
2^24 elements, and a config-scale matrix is above that).  Transforms run
where their input lives: a numpy column on the host (the JAX package's
numpy arithmetic), a tensor column on its device, with the same float32
operations in the same order, so the two give the same bits and a fused
segment (``fuse.registry``) equals the staged stage.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model, Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
)


def _matrix_on(X, device: torch.device) -> torch.Tensor:
    """A fit's input as a float32 ``[N, F]`` tensor on ``device``."""
    if isinstance(X, torch.Tensor):
        return X.to(device=device, dtype=torch.float32)
    X = np.asarray(X).astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(X)).to(device)


def _const(cache: dict, key, a: np.ndarray) -> torch.Tensor:
    """``a`` as a tensor on the device ``key`` ends with, made once per
    ``key`` (which names what ``a`` was computed from)."""
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
            key[-1])
    return t


def column_quantiles(xs: torch.Tensor, qs) -> torch.Tensor:
    """Per-column quantiles ``[len(qs), F]`` of float32 ``xs [N, F]``:
    ``jnp.quantile(xs, qs, axis=0)`` (method ``linear``) op for op: one
    sort of every column, the positions ``q * (n - 1)`` in float32, the
    floor and ceiling rows blended as ``lo * (1 - w) + hi * w``.  A
    column holding a NaN gives NaN."""
    n = xs.shape[0]
    srt = torch.sort(xs, dim=0).values
    q = torch.as_tensor(np.asarray(qs, np.float32), device=xs.device)
    pos = q * torch.tensor(float(n - 1), dtype=torch.float32,
                           device=xs.device)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    top = float(n - 1)
    lo_i = low.clamp(0.0, top).long()
    hi_i = high.clamp(0.0, top).long()
    out = srt[lo_i] * low_w[:, None] + srt[hi_i] * high_w[:, None]
    nan = torch.isnan(xs).any(dim=0)
    return torch.where(nan[None, :], torch.full_like(out, float("nan")), out)


class _MinMaxParams:
    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="scaledFeatures")
    min = Param("lower bound of the output range", default=0.0)
    max = Param("upper bound of the output range", default=1.0)


def _extrema(xs, _w=None):
    return tuple(torch.aminmax(xs, dim=0))


class MinMaxScaler(_MinMaxParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "MinMaxScalerModel":
        if self.getMin() >= self.getMax():
            raise ValueError("min must be < max")
        mesh = fit_mesh(self.mesh)
        X = frame[self.getInputCol()]
        if mesh is None:
            lo, hi = _extrema(_matrix_on(X, self.device))
        else:
            if not isinstance(X, torch.Tensor):
                X = np.asarray(X).astype(np.float32, copy=False)
            xs, w = shard_batch(mesh, X.to(torch.float32)
                                if isinstance(X, torch.Tensor) else X)
            lo, hi = make_tree_aggregate(
                _extrema, mesh, op="minmax_scaler",
                combine=("min", "max"))(xs, w)
        model = MinMaxScalerModel(originalMin=to_host(lo),
                                  originalMax=to_host(hi))
        model.setParams(**self.paramValues())
        return model


class MinMaxScalerModel(_MinMaxParams, Model):
    def __init__(self, originalMin, originalMax, **kwargs):
        super().__init__(**kwargs)
        self.originalMin = np.asarray(originalMin, np.float32)
        self.originalMax = np.asarray(originalMax, np.float32)
        self._on = {}

    def _save_extra(self):
        return {}, {"min": self.originalMin, "max": self.originalMax}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(originalMin=arrays["min"], originalMax=arrays["max"])
        m.setParams(**params)
        return m

    def constants(self):
        """``(lo, scale, ok, out_lo, mid)``: the float32 constants of
        ``(x - lo) * scale + out_lo`` where ``ok``, else ``mid`` (one
        source for the staged and the fused transform)."""
        lo, hi = self.originalMin, self.originalMax
        span = hi - lo
        out_lo, out_hi = float(self.getMin()), float(self.getMax())
        scale = np.divide(
            out_hi - out_lo, span, out=np.zeros_like(span), where=span > 0
        )
        return lo, scale, span > 0, out_lo, 0.5 * (out_lo + out_hi)

    def scale_tensor(self, X: torch.Tensor) -> torch.Tensor:
        """The transform of a tensor, on its device (the staged and the
        fused transform both run this)."""
        lo, scale, ok, out_lo, mid = self.constants()
        dev, rng = X.device, (self.getMin(), self.getMax())
        x = X.to(torch.float32)
        scaled = ((x - _const(self._on, ("lo", dev), lo)[None, :])
                  * _const(self._on, ("scale", rng, dev), scale)[None, :]
                  + out_lo)
        return torch.where(_const(self._on, ("ok", dev), ok)[None, :],
                           scaled, mid)

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        if isinstance(X, torch.Tensor):
            return frame.with_column(self.getOutputCol(),
                                     self.scale_tensor(X))
        lo, scale, ok, out_lo, mid = self.constants()
        X = np.asarray(X).astype(np.float32, copy=False)
        scaled = (X - lo) * scale + out_lo
        # Spark: constant features map to the midpoint of the output range
        scaled = np.where(ok, scaled, mid).astype(np.float32)
        return frame.with_column(self.getOutputCol(), scaled)


class _MaxAbsParams:
    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="scaledFeatures")


def _max_abs(xs, _w=None) -> torch.Tensor:
    return xs.abs().amax(dim=0)


class MaxAbsScaler(_MaxAbsParams, Estimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device): each shard's ``max |x|``,
    the maxima's max (the padding repeats a real row; a max is
    order-free, so every mesh size gives the same bits)."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "MaxAbsScalerModel":
        mesh = fit_mesh(self.mesh)
        X = frame[self.getInputCol()]
        if mesh is None:
            m = _max_abs(_matrix_on(X, self.device))
        else:
            X = (X.to(torch.float32) if isinstance(X, torch.Tensor)
                 else np.asarray(X).astype(np.float32, copy=False))
            m = make_tree_aggregate(_max_abs, mesh, op="maxabs_scaler",
                                    combine="max")(*shard_batch(mesh, X))
        model = MaxAbsScalerModel(maxAbs=to_host(m))
        model.setParams(**self.paramValues())
        return model


class MaxAbsScalerModel(_MaxAbsParams, Model):
    def __init__(self, maxAbs, **kwargs):
        super().__init__(**kwargs)
        self.maxAbs = np.asarray(maxAbs, np.float32)
        self._on = {}

    def _save_extra(self):
        return {}, {"maxAbs": self.maxAbs}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(maxAbs=arrays["maxAbs"])
        m.setParams(**params)
        return m

    def inverse(self) -> np.ndarray:
        """The float32 factor ``1 / maxAbs`` (0 where maxAbs is 0)."""
        return np.divide(1.0, self.maxAbs, out=np.zeros_like(self.maxAbs),
                         where=self.maxAbs > 0)

    def scale_tensor(self, X: torch.Tensor) -> torch.Tensor:
        """The transform of a tensor, on its device (the staged and the
        fused transform both run this)."""
        return X.to(torch.float32) * _const(self._on, ("inv", X.device),
                                            self.inverse())[None, :]

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        if isinstance(X, torch.Tensor):
            return frame.with_column(self.getOutputCol(),
                                     self.scale_tensor(X))
        X = np.asarray(X).astype(np.float32, copy=False)
        return frame.with_column(self.getOutputCol(), X * self.inverse())


class _RobustParams:
    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="scaledFeatures")
    lower = Param(
        "lower quantile of the scaling range",
        default=0.25,
        validator=validators.in_range(0.0, 1.0),
    )
    upper = Param(
        "upper quantile of the scaling range",
        default=0.75,
        validator=validators.in_range(0.0, 1.0),
    )
    withCentering = Param("subtract the median", default=False)
    withScaling = Param("divide by the quantile range", default=True)


class RobustScaler(_RobustParams, Estimator):
    """Scale by the (lower, upper) quantile range, optionally centred on
    the median.  The fit is one column sort on ``device`` (default
    ``cuda``), unpadded (padding rows would bias order statistics)."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _fit(self, frame: Frame) -> "RobustScalerModel":
        lo_q, hi_q = float(self.getLower()), float(self.getUpper())
        if lo_q >= hi_q:
            raise ValueError("lower must be < upper")
        xs = _matrix_on(frame[self.getInputCol()], self.device)
        stats = to_host(column_quantiles(xs, [lo_q, 0.5, hi_q]))
        model = RobustScalerModel(median=stats[1], range=stats[2] - stats[0])
        model.setParams(**self.paramValues())
        return model


class RobustScalerModel(_RobustParams, Model):
    def __init__(self, median, range, **kwargs):
        super().__init__(**kwargs)
        self.median = np.asarray(median, np.float32)
        self.range = np.asarray(range, np.float32)
        self._on = {}

    def _save_extra(self):
        return {}, {"median": self.median, "range": self.range}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(median=arrays["median"], range=arrays["range"])
        m.setParams(**params)
        return m

    def inverse(self) -> np.ndarray:
        """The float32 factor ``1 / range`` (0 where the range is 0,
        Spark's std=0 rule)."""
        return np.divide(1.0, self.range, out=np.zeros_like(self.range),
                         where=self.range > 0)

    def scale_tensor(self, X: torch.Tensor) -> torch.Tensor:
        """The transform of a tensor, on its device (the staged and the
        fused transform both run this)."""
        x = X.to(torch.float32)
        if self.getWithCentering():
            x = x - _const(self._on, ("median", x.device),
                           self.median)[None, :]
        if self.getWithScaling():
            x = x * _const(self._on, ("inv", x.device),
                           self.inverse())[None, :]
        return x

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        if isinstance(X, torch.Tensor):
            return frame.with_column(self.getOutputCol(),
                                     self.scale_tensor(X))
        X = np.asarray(X).astype(np.float32, copy=False)
        if self.getWithCentering():
            X = X - self.median
        if self.getWithScaling():
            X = X * self.inverse()
        return frame.with_column(self.getOutputCol(), X.astype(np.float32))


class Normalizer(Transformer):
    """Row p-norm scaling, stateless.  The norms are float64 (numpy on
    the host, torch on a tensor's device)."""

    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="normFeatures")
    p = Param(
        "norm order (>= 1; float('inf') supported)",
        default=2.0,
        validator=validators.gteq(1.0),
    )

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        p = float(self.getP())
        if isinstance(X, torch.Tensor):
            x = X.to(torch.float32)
            x64 = x.to(torch.float64)
            if np.isinf(p):
                norm = x.abs().amax(dim=1).to(torch.float64)
            elif p == 2.0:
                norm = torch.sqrt((x64 ** 2).sum(dim=1))
            elif p == 1.0:
                norm = x64.abs().sum(dim=1)
            else:
                norm = (x64.abs() ** p).sum(dim=1) ** (1.0 / p)
            pos = norm > 0
            inv = torch.where(pos, 1.0 / torch.where(pos, norm, 1.0), 0.0)
            out = x * inv[:, None].to(torch.float32)
            out = torch.where(pos[:, None], out, x)
            return frame.with_column(self.getOutputCol(), out)
        X = np.asarray(X).astype(np.float32, copy=False)
        if np.isinf(p):
            norm = np.abs(X).max(axis=1)
        elif p == 2.0:
            norm = np.sqrt((X.astype(np.float64) ** 2).sum(axis=1))
        elif p == 1.0:
            norm = np.abs(X.astype(np.float64)).sum(axis=1)
        else:
            norm = (np.abs(X.astype(np.float64)) ** p).sum(axis=1) ** (1.0 / p)
        inv = np.divide(
            1.0, norm, out=np.zeros_like(norm, dtype=np.float64),
            where=norm > 0,
        )
        out = (X * inv[:, None].astype(np.float32)).astype(np.float32)
        # Spark leaves zero-norm rows unchanged
        out = np.where((norm > 0)[:, None], out, X)
        return frame.with_column(self.getOutputCol(), out)


class Binarizer(Transformer):
    """Thresholding, stateless: a vector column gives float32, a scalar
    column float64."""

    inputCol = Param("input column (scalar or vector)", default="features")
    outputCol = Param("output column", default="binarized")
    threshold = Param("values > threshold become 1.0, else 0.0", default=0.0)

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        thr = float(self.getThreshold())
        if isinstance(X, torch.Tensor):
            out = (X.to(torch.float32) > thr).to(
                torch.float64 if X.ndim == 1 else torch.float32)
            return frame.with_column(self.getOutputCol(), out)
        out = (np.asarray(X, np.float32) > thr).astype(
            np.float64 if X.ndim == 1 else np.float32)
        return frame.with_column(self.getOutputCol(), out)
