"""OneHotEncoder / VectorSlicer / ElementwiseProduct.

Counterpart of ``sntc_tpu/feature/encoders.py`` (Spark's stages of the
same names):

  * OneHotEncoder: fit learns each input column's category count (max
    index + 1); transform maps index ``i`` to a one-hot float32 vector.
    ``dropLast`` (default True) drops the final category;
    ``handleInvalid`` error (default) / keep (an extra "invalid"
    category).  Multi-column; one output vector a column.
  * VectorSlicer: stateless gather of ``indices`` from a vector column.
  * ElementwiseProduct: stateless Hadamard product with ``scalingVec``
    (float32), cast to float32.

OneHotEncoder is host work, as in the JAX package (a tensor column is
read back first).  The two stateless stages run where their input
lives: a numpy column on the host (the JAX package's numpy arithmetic),
a tensor column on its device with the same operations (a gather;
:func:`scale_tensor`, which the fused segment in ``fuse.registry``
calls too), so the staged and the fused stage give the same bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model, Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators


def const_on(cache: dict, a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, copied there once per value and
    device (a stage's params may be set again between calls)."""
    key = (a.dtype.str, a.tobytes(), device)
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device)
    return t


def check_indices(idx: np.ndarray, width: int) -> None:
    if len(idx) and (idx.min() < 0 or idx.max() >= width):
        raise ValueError(f"indices out of range for vector width {width}")


def scale_tensor(x: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
    """``(x * w).astype(float32)`` on ``x``'s device, the host
    transform's two operations: ElementwiseProduct's device map."""
    return (x * w32[None, :]).to(torch.float32)


class _OheParams:
    inputCols = Param("input index columns", default=None)
    outputCols = Param("output vector columns (same length)", default=None)
    dropLast = Param(
        "drop the last category (all-zeros encoding)", default=True,
        validator=validators.is_bool(),
    )
    handleInvalid = Param(
        "unseen-index handling: error | keep (extra category)",
        default="error",
        validator=validators.one_of("error", "keep"),
    )

    def _cols(self):
        ins = self.getInputCols()
        outs = self.getOutputCols()
        if not ins:
            raise ValueError("inputCols is required")
        outs = outs or [c + "_ohe" for c in ins]
        if len(ins) != len(outs):
            raise ValueError("inputCols and outputCols lengths differ")
        return ins, outs


class OneHotEncoder(_OheParams, Estimator):
    def _fit(self, frame: Frame) -> "OneHotEncoderModel":
        ins, _ = self._cols()
        sizes = []
        for c in ins:
            v = to_host(frame[c]).astype(np.float64)
            if len(v) and ((v < 0) | (v != np.floor(v))).any():
                raise ValueError(
                    f"OneHotEncoder: column {c!r} must hold non-negative "
                    "integer indices"
                )
            sizes.append(int(v.max()) + 1 if len(v) else 0)
        model = OneHotEncoderModel(categorySizes=sizes)
        model.setParams(**self.paramValues())
        return model


class OneHotEncoderModel(_OheParams, Model):
    def __init__(self, categorySizes: Sequence[int] = (), **kwargs):
        super().__init__(**kwargs)
        self.categorySizes = [int(s) for s in categorySizes]

    def _save_extra(self):
        return {"categorySizes": self.categorySizes}, {}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(categorySizes=extra["categorySizes"])
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        ins, outs = self._cols()
        drop = self.getDropLast()
        keep_invalid = self.getHandleInvalid() == "keep"
        out = frame
        for c, o, size in zip(ins, outs, self.categorySizes):
            idx = to_host(frame[c]).astype(np.int64)
            n = len(idx)
            invalid = (idx < 0) | (idx >= size)
            if invalid.any() and not keep_invalid:
                raise ValueError(
                    f"OneHotEncoder: column {c!r} has indices outside "
                    f"[0, {size}) (set handleInvalid='keep')"
                )
            # width: size (+1 invalid slot when keeping) (-1 when dropLast)
            width = size + (1 if keep_invalid else 0) - (1 if drop else 0)
            enc = np.zeros((n, max(width, 0)), np.float32)
            slot = np.where(invalid, size if keep_invalid else 0, idx)
            ok = slot < width  # dropLast: the last category stays all-zero
            rows = np.flatnonzero(ok)
            enc[rows, slot[rows]] = 1.0
            out = out.with_column(o, enc)
        return out


class VectorSlicer(Transformer):
    """Column gather from a vector column, stateless."""

    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="sliced")
    indices = Param("indices to keep, in output order", default=None)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._on = {}

    def transform(self, frame: Frame) -> Frame:
        idx = self.getIndices()
        if not idx:
            raise ValueError("indices is required")
        X = frame[self.getInputCol()]
        idx = np.asarray(idx, np.int64)
        check_indices(idx, X.shape[1])
        if isinstance(X, torch.Tensor):
            out = X.index_select(1, const_on(self._on, idx, X.device))
        else:
            out = np.ascontiguousarray(np.asarray(X)[:, idx])
        return frame.with_column(self.getOutputCol(), out)


class ElementwiseProduct(Transformer):
    """Hadamard product with a fixed scaling vector, stateless."""

    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="scaled")
    scalingVec = Param("the per-dimension multiplier vector", default=None)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._on = {}

    def transform(self, frame: Frame) -> Frame:
        w = self.getScalingVec()
        if w is None:
            raise ValueError("scalingVec is required")
        X = frame[self.getInputCol()]
        w = np.asarray(w, np.float32)
        if w.shape != (X.shape[1],):
            raise ValueError(
                f"scalingVec length {w.shape[0]} != vector width {X.shape[1]}"
            )
        if isinstance(X, torch.Tensor):
            out = scale_tensor(X, const_on(self._on, w, X.device))
        else:
            out = (np.asarray(X) * w[None, :]).astype(np.float32)
        return frame.with_column(self.getOutputCol(), out)
