"""DCT: the discrete cosine transform feature stage.

Counterpart of ``sntc_tpu/feature/dct.py`` (Spark's ``DCT``): DCT-II
with the orthonormal normalization along each row vector; ``inverse``
runs DCT-III.  Matches ``scipy.fft.dct(x, type=2, norm='ortho')``.

At feature widths (tens to hundreds) the transform is one ``[N, F] @
[F, F]`` product against the float32 orthonormal basis
(:func:`_dct_basis`; the inverse is its transpose), in full float32,
never TF32 (the JAX package's ``Precision.HIGHEST``).  A tensor column
is transformed on its device; a host column is uploaded to the stage's
``device`` (default ``cuda``), transformed there and copied back, one
round trip as the JAX package's staged stage pays.  The fused segment
(``fuse.registry``) runs the same :func:`dct_apply`, so on one device
at one shape the two give the same bits.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.utils.profiling import record_movement, upload


@lru_cache(maxsize=None)
def _dct_basis(f: int, inverse: bool) -> np.ndarray:
    """Orthonormal DCT-II basis ``B`` with ``y = x @ B``; the inverse
    (DCT-III) is its transpose."""
    n = np.arange(f)
    k = n[:, None]
    B = np.cos(np.pi * (2 * n[None, :] + 1) * k / (2 * f))  # [k, n]
    B *= np.sqrt(2.0 / f)
    B[0] *= np.sqrt(0.5)
    basis = B.T.astype(np.float32)
    return np.ascontiguousarray(basis.T if inverse else basis)


def dct_apply(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``x @ basis`` in full float32: the one product of the staged and
    the fused DCT."""
    with full_f32():
        return torch.matmul(x.to(torch.float32), basis)


def device_round_trip(fn, X, device: torch.device) -> np.ndarray:
    """``fn`` of a host matrix run on ``device``: one upload, one copy
    back (both in the transfer ledger)."""
    X = np.ascontiguousarray(np.asarray(X).astype(np.float32, copy=False))
    out = fn(upload(X, device)).cpu().numpy()
    record_movement(downloads=1, download_bytes=out.nbytes)
    return out


class DCT(Transformer):
    """Runs a host column on ``device`` (default ``cuda``)."""

    inputCol = Param("input vector column", default="features")
    outputCol = Param("output vector column", default="dct")
    inverse = Param("run the inverse transform (DCT-III)", default=False,
                    validator=validators.is_bool())

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self._on = {}

    def basis_on(self, f: int, device) -> torch.Tensor:
        key = (f, bool(self.getInverse()), device)
        b = self._on.get(key)
        if b is None:
            b = self._on[key] = torch.from_numpy(
                _dct_basis(f, key[1])).to(device)
        return b

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        if X.ndim != 2:
            raise ValueError("inputCol must be a vector column")
        f = X.shape[1]
        if isinstance(X, torch.Tensor):
            out = dct_apply(X, self.basis_on(f, X.device))
        else:
            out = device_round_trip(
                lambda x: dct_apply(x, self.basis_on(f, x.device)), X,
                self.device)
        return frame.with_column(self.getOutputCol(), out)
