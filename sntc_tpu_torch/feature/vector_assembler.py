"""VectorAssembler — concatenate numeric columns into one feature vector.

Counterpart of ``sntc_tpu/feature/vector_assembler.py`` (Spark's
``VectorAssembler``): dense concatenation in declared column order into
an ``(N, D)`` float32 column; ``handleInvalid`` is ``error`` (raise on
NaN/Inf), ``skip`` (drop rows) or ``keep`` (pass them through).

Host columns assemble on the host, as in the JAX package.  When any
input column is a tensor (the bucket-padded feature block already on the
card), the stack and the float32 cast run on that tensor's device and
the assembled features stay there; host columns among them are uploaded
there, and each upload is recorded in the transfer ledger, as is the
one device→host read of the row-validity verdict in ``error`` and
``skip`` modes.  A batch with rows to skip costs one more read (the row
mask) and one more upload (the kept rows' indices, gathered from every
device column at once).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.utils.profiling import record_movement, upload


def _assemble_host(cols, n_rows: int) -> np.ndarray:
    if cols and all(c.ndim == 1 for c in cols):
        # one C-level stack+cast; (N, 1) 2-D columns take the assign loop
        return np.array(cols, dtype=np.float32).T
    widths = [1 if c.ndim == 1 else c.shape[1] for c in cols]
    X = np.empty((n_rows, sum(widths)), np.float32)
    off = 0
    for col, w in zip(cols, widths):
        X[:, off : off + w] = col if col.ndim == 2 else col[:, None]
        off += w
    return X


def _assemble_device(cols, device: torch.device) -> torch.Tensor:
    parts = [
        c.to(device) if isinstance(c, torch.Tensor)
        else upload(np.asarray(c), device)
        for c in cols
    ]
    if all(p.ndim == 1 and p.dtype == parts[0].dtype for p in parts):
        # one stack and one cast, whatever the column count
        return torch.stack(parts, dim=1).to(torch.float32)
    return torch.cat(
        [(p if p.ndim == 2 else p[:, None]).to(torch.float32) for p in parts],
        dim=1,
    )


class VectorAssembler(Transformer):
    inputCols = Param("input column names, concatenated in order")
    outputCol = Param("output vector column", default="features")
    handleInvalid = Param(
        "how to handle NaN/Inf rows: error | skip | keep",
        default="error",
        validator=validators.one_of("error", "skip", "keep"),
    )

    def transform(self, frame: Frame) -> Frame:
        names: List[str] = self.getInputCols()
        cols = [frame[name] for name in names]
        mode = self.getHandleInvalid()
        device = next(
            (c.device for c in cols if isinstance(c, torch.Tensor)), None
        )
        if device is None:
            X = _assemble_host(cols, frame.num_rows)
            bad = None if mode == "keep" else ~np.isfinite(X).all(axis=1)
            any_bad = bad is not None and bool(bad.any())
        else:
            X = _assemble_device(cols, device)
            bad = None if mode == "keep" else ~torch.isfinite(X).all(dim=1)
            # one device→host sync per batch, for the validity verdict
            any_bad = bad is not None and bool(bad.any())
            if bad is not None:
                record_movement(syncs=1)
            if any_bad:
                bad = bad.cpu().numpy()
                record_movement(syncs=1)
        if any_bad:
            if mode == "error":
                raise ValueError(
                    f"VectorAssembler: {int(bad.sum())} rows contain "
                    "NaN/Inf (handleInvalid='error'); clean the data "
                    "or use handleInvalid='skip'"
                )
            # one gather of every column, X among them: a device frame
            # uploads the kept rows' indices once
            return frame.with_column(self.getOutputCol(), X).filter(~bad)
        return frame.with_column(self.getOutputCol(), X)
